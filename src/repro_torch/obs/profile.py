"""Profiler hooks: labelled device timelines and opt-in trace capture.

The port of ``repro/obs/profile.py``, with the same scope names:

* :func:`scope` and :func:`annotation` — ``torch.profiler.record_function``
  under the given name, with an NVTX range beside it while CUDA is
  initialised.  The reference's ``scope`` names HLO at trace time and its
  ``annotation`` marks host rows; PyTorch has no trace time, so both
  label the ops and launches issued inside the ``with`` body on the
  profiler timeline (a no-op cost when no profiler is recording, beyond
  the call itself).
* :func:`capture` — run ``torch.profiler`` over the ``with`` body (CPU,
  and CUDA where a card is present) and write a Chrome / Perfetto trace
  into the given directory; ``capture(None)`` is a no-op.  The shape
  behind ``launch/train.py --profile-dir``.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import ContextManager, Iterator, Optional

import torch


@contextmanager
def _labelled(name: str) -> Iterator[None]:
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def scope(name: str) -> ContextManager:
    """Label the ops issued inside the ``with`` body ``name`` (e.g.
    ``fedlay_mix/round0``, ``codec/int8-block/encode``)."""
    return _labelled(name)


def annotation(name: str, **kwargs) -> ContextManager:
    """Label a host-side block ``name`` (step and swap boundaries);
    ``kwargs`` are appended to the label as ``key=value``, as the
    reference's ``TraceAnnotation`` shows them."""
    if kwargs:
        name = name + "#" + ",".join(f"{k}={v}" for k, v in kwargs.items()) + "#"
    return _labelled(name)


@contextmanager
def capture(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the ``with`` body into ``log_dir`` (a Chrome trace,
    ``trace.json``, that Perfetto opens); no-op when ``log_dir`` is
    None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


__all__ = ["annotation", "capture", "scope"]
