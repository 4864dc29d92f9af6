"""Build and load the host-side C++ runtime libraries (port of ``runtime/_native.py``).

Each component is one C++ translation unit under ``csrc/``, compiled with
``g++`` at first use into a shared library with a plain C interface that
``ctypes`` loads. The library goes under ``build/runtime/<name>/<hash>/`` at
the repo root, keyed by a hash of the source and the flags, as
``ops.nl_cuda`` keys the kernels: a changed source rebuilds and an
unchanged one does not. ``serving.persistent_compile_cache`` moves
``BUILD_DIR``.

The JAX module rebuilds next to its source and falls back to a shipped
binary; here nothing is read from or written under the repo's
``runtime/``, and a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG_DIR.parent / "build" / "runtime"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
compiles = 0  # g++ runs in this process, for callers that check a warm cache


def source(name: str) -> Path:
    return _PKG_DIR / "csrc" / f"{name}.cc"


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(src.name.encode())
    h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str, build_dir=None) -> Path:
    """Compile ``csrc/<name>.cc`` unless a library for this source exists
    under ``build_dir`` (default ``BUILD_DIR``); returns its path. The build
    writes a temporary file and renames it into place, so processes that
    build at once never see a partial library."""
    global compiles
    src = source(name)
    out_dir = Path(build_dir or BUILD_DIR) / name / _digest(src)
    lib = out_dir / f"lib{name}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, str(src), "-o", str(tmp)]
    compiles += 1
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, check=False)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler for {name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}: {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, loaded once per process."""
    return ctypes.CDLL(str(build(name)))


def fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
