"""Build and bind the hand-written CUDA kernels of ``csrc/nl_kernels.cu``.

The sources are compiled at first use by ``nvcc`` alone, into a shared
library with a plain C interface that ``ctypes`` loads: no PyTorch headers,
no ``torch.utils.cpp_extension`` and no ``ninja``. The library goes under
``build/nl_kernels/<hash>/`` at the repo root, keyed by a hash of the sources
and the flags, so a changed source rebuilds and an unchanged one does not.

Nothing here falls back to a plain version: a failed build raises with
nvcc's output, and a refused launch raises with ``cudaGetErrorString``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCES = (_PKG_DIR / "csrc" / "nl_kernels.cu",)
BUILD_DIR = _PKG_DIR.parent / "build" / "nl_kernels"
NVCC_FLAGS = (
    "-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libnl_kernels.so"


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the toolkit's default path."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin)")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels if no library for these sources exists; returns its path.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``build.log``.
    """
    out_dir = Path(build_dir) / _digest()
    lib = out_dir / _LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{_LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n{proc.stderr}"
        )
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name in ("nl_forward_launch", "nl_head_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lib.nl_error_string.argtypes = [ctypes.c_int]
    lib.nl_error_string.restype = ctypes.c_char_p
    return lib


def check_operands(tensors, device: torch.device) -> None:
    """Every operand a contiguous float32 tensor on ``device``; raises otherwise."""
    for i, t in enumerate(tensors):
        if not (t.is_cuda and t.device == device):
            raise ValueError(f"operand {i} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"operand {i} has dtype {t.dtype}, expected torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"operand {i} is not contiguous")


def launch(name: str, tensors, dims) -> None:
    """Launch ``name`` on the current stream of the tensors' device.

    ``tensors`` are the kernel's pointer operands in the order its C
    launcher documents, ``dims`` its integer dimensions.
    """
    device = tensors[0].device
    check_operands(tensors, device)
    lib = library()
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    ints = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(ptrs, len(tensors), ints, len(dims), stream)
    if code != 0:
        msg = lib.nl_error_string(code).decode()
        raise RuntimeError(f"{name} failed: {msg} (cudaError {code}; dims {list(dims)})")
