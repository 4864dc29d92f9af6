"""Build and bind the hand-written CUDA kernels of ``csrc/nl_kernels.cu``.

The sources are compiled at first use by ``nvcc`` alone, into a shared
library with a plain C interface that ``ctypes`` loads: no PyTorch headers,
no ``torch.utils.cpp_extension`` and no ``ninja``. The library goes under
``build/nl_kernels/<hash>/`` at the repo root, keyed by a hash of the sources
and the flags, so a changed source rebuilds and an unchanged one does not
(``serving.persistent_compile_cache`` moves ``BUILD_DIR``).

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
import types
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
compiles = 0  # nvcc runs in this process, for callers that check a warm cache


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


def build(build_dir=None) -> Path:
    """Compile the kernels if no library for these sources exists under
    ``build_dir`` (default ``BUILD_DIR``, which
    ``serving.persistent_compile_cache`` moves); returns its path.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``build.log``.
    """
    global compiles
    out_dir = Path(build_dir or BUILD_DIR) / _digest()
    lib = out_dir / _LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{_LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    compiles += 1
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
    lib.nl_init.argtypes = []
    lib.nl_init.restype = ctypes.c_int
    for name in ("nl_forward_smem_bytes", "nl_head_smem_bytes"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        fn.restype = ctypes.c_longlong
    lib.nl_forward_plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.nl_forward_plan.restype = ctypes.c_int
    lib.nl_error_string.argtypes = [ctypes.c_int]
    lib.nl_error_string.restype = ctypes.c_char_p
    return lib


_READY: set[int] = set()  # devices on which nl_init has run


def _check(lib, name: str, code: int, dims=()) -> None:
    if code != 0:
        msg = lib.nl_error_string(code).decode()
        raise RuntimeError(f"{name} failed: {msg} (cudaError {code}; dims {list(dims)})")


def _init(lib, index: int) -> None:
    """``nl_init`` once per device, with it current: the kernels' shared-memory
    limit and the resident kernel's clusters that fit on the card."""
    if index not in _READY:
        with torch.cuda.device(index):
            _check(lib, "nl_init", lib.nl_init())
        _READY.add(index)


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
    _init(lib, device.index)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, name, getattr(lib, name)(ptrs, len(tensors), ints, len(dims), stream), dims)


FORWARD_VARIANTS = ("resident", "streamed")
_REFUSALS = {
    -1: "the dims are malformed or the buffer's length is not the layout's",
    -2: "the buffer is in the resident layout, which needs more shared memory than a block has at these "
        "dims; repack_nl_forward(..., actions=A) packs the wide layout where that is so",
    -3: "an offset of the weight buffer or of the scratch would overflow a 32-bit int",
}


@functools.lru_cache(maxsize=256)
def forward_plan(dims: tuple) -> types.MappingProxyType:
    """The kernel library's plan of a forward launch with these ``dims`` (as
    ``nl_forward_launch`` takes them) on the current device, read-only:
    ``variant``, ``"resident"`` (``nl_forward_kernel`` up to width 128: from
    11,000 rows clusters whose CTAs keep the weights, split by stage, for
    the whole launch while they walk row tiles; below, one 8-row tile a
    CTA) or ``"streamed"`` (the chain of stage kernels past it); ``tile``,
    the GRU stage's tile as batch rows by output columns (the resident
    kernel's 8 or 16 rows by every column, 0); ``trunk_rows`` and
    ``head_rows``, the streamed chain's rows a CTA of trunk layer 2 and of
    the head; ``launches``, device launches per forward (1, or 2 A + 4);
    ``smem_bytes``, the largest dynamic shared memory of a launch;
    ``scratch_floats``, the scratch the chain needs; ``ctas``, the resident
    launch's CTAs, each of which copies its weights once (0 streamed);
    ``cluster``, its CTAs a cluster (1 for one tile a CTA, 0 streamed).
    Raises ``ValueError`` with the reason for dims that neither variant
    takes."""
    lib = library()
    _init(lib, torch.cuda.current_device())
    ints = (ctypes.c_int * len(dims))(*dims)
    info = (ctypes.c_longlong * 10)()
    code = lib.nl_forward_plan(ints, len(dims), info)
    if code < 0:
        raise ValueError(f"the forward kernel does not take dims {list(dims)}: {_REFUSALS[code]}")
    return types.MappingProxyType({
        "variant": FORWARD_VARIANTS[code], "tile": (info[0], info[1]), "trunk_rows": info[2],
        "head_rows": info[3], "launches": info[4], "smem_bytes": info[5], "scratch_floats": info[6],
        "ctas": info[7], "cluster": info[8]})


def smem_bytes(kernel: str, dims) -> int:
    """Dynamic shared memory, in bytes, of a launch of ``kernel`` ("nl_forward" or
    "nl_head") with the integer ``dims`` its launcher takes; raises if it refuses them."""
    ints = (ctypes.c_int * len(dims))(*dims)
    nbytes = getattr(library(), f"{kernel}_smem_bytes")(ints, len(dims))
    if nbytes < 0:
        raise ValueError(f"{kernel} does not take dims {list(dims)}")
    return int(nbytes)
