"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds); the ``csrc/*.cuh`` headers are shared between them.  Libraries go
to ``build/torch_kernels/`` at the repository root, named by a hash of their
source and the headers, so an edited kernel rebuilds.  Nothing here
runs at import: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc for ``csrc/<name>.cu``; returns (target, process) or
    (target, None) when the library is already built."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (tmp, proc)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return ""
    tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)        # atomic: a concurrent builder sees all or none
    return log


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build the named kernels in parallel (one nvcc each, all started
    together); returns each one's compiler log (empty when cached)."""
    names = list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        return {n: _finish(n, *jobs[n]) for n in names}


def all_kernels():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """``symbol`` of the library for ``csrc/<name>.cu`` (built on first
    call), with its ctypes ``argtypes`` and an int (cudaError) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
