"""Build the C++ host runtime (``wordpiece.cc``, ``image_ops.cc``) at first
use with the host's ``g++``.

One shared library with a plain C interface, compiled with the JAX
package's ``Makefile`` flags (``-O3 -fPIC -std=c++17 -shared``: no
``-march=native``, no fast math, no FMA contraction), so that one compiler
gives both packages the same pixels bit for bit.  It goes to
``build/torch_native/`` at the repository root, named by a hash of the
sources, the flags and the compiler, and is written under a temporary
name and renamed, so concurrent builders (several test processes) see a
whole library or none.  Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent
SOURCES = ("wordpiece.cc", "image_ops.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX = "g++"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()


def target() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXXFLAGS)).encode())
    for name in SOURCES:
        h.update((SRC / name).read_bytes())
    return BUILD_DIR / f"libmtvaf_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first where it is not built yet.
    Raises RuntimeError naming the compiler's failure (or its absence)."""
    out = target()
    with _lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [CXX, *CXXFLAGS, "-o", str(tmp),
               *(str(SRC / name) for name in SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"no C++ compiler {CXX!r}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed (exit {proc.returncode}):\n"
                               f"{proc.stderr or proc.stdout}")
        os.replace(tmp, out)
        return out
