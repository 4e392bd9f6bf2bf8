"""PyTorch port of ``repro`` for NVIDIA Hopper GPUs.

Each subpackage mirrors the ``repro`` subpackage of the same name, so
every ported module has one obvious reference.  The port imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``: what it
needs from a host-only module of the reference it keeps as its own copy.
Importing the package builds no kernel; a CUDA kernel is compiled at its
first launch (:mod:`repro_torch.kernels.build`).

Kernels are chosen by the device of the tensors they are given: a CPU
tensor runs the kernel's plain PyTorch version, a CUDA tensor launches
the hand-written kernel or raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU.  Asking for CUDA where there is none raises.

    On CUDA this also turns TF32 off for float32 matrix products and
    convolutions, so the port's float32 path is full float32, as the
    reference's is."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} was asked for, but CUDA is "
                               "not available (pass device='cpu' to run on "
                               "the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"the port runs on cuda or cpu, not {device}")
    return device
