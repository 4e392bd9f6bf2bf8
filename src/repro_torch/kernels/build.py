"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
``sm_90a`` into its own shared library, named by a hash of its source,
under ``kernels/_build/`` (listed in ``.gitignore``).  A build happens at
first use and is reused while the source is unchanged; :func:`build`
starts one ``nvcc`` per source, all at once.  Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: IEEE f32 arithmetic (nvcc's defaults, stated): subnormals kept, true
#: division and square root.  The wire codec's kernels are held bit-equal
#: to their reference, so ``--use_fast_math`` is never set.
IEEE_FLAGS = ("-ftz=false", "-prec-div=true", "-prec-sqrt=true")
#: Every kernel source of the port, by name (``csrc/<name>.cu``).
SOURCES = ("flash_decode", "gather_mix", "mix_accumulate", "quantize_block",
           "dequantize_block", "dequant_accumulate", "gather_mix_int8",
           "ssd_scan", "weighted_mix")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path, verbose: bool) -> list:
    cmd = [nvcc_path(), *ARCH_FLAGS, *IEEE_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(out), str(CSRC / f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build(names: Sequence[str], verbose: bool = False) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns each compiler's output
    (``-Xptxas -v`` register and shared-memory report when ``verbose``);
    raises ``RuntimeError`` naming the source if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists() and not verbose:
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)        # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
