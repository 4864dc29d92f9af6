"""The native replay-buffer file (port of ``runtime/__init__.py``), bound with ``ctypes``.

``csrc/replaybuf.cc`` stores the four transition arrays (s0, a0, sn, ts) of
a replay buffer as one page-aligned float32 file that opens as a read-only
mmap in O(1); ``ReplayBuffer.gather`` pulls shuffled rows on worker
threads. The format is the JAX package's, byte for byte. The library is
built with ``g++`` at first use (``runtime._native``); ``get_lib`` raises
with the compiler's output when it cannot be built, and
``data.replay`` then keeps to the ``.npz``, with a warning.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from . import _native
from ._native import fptr as _fptr


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The replay-buffer library, built if needed; raises ``RuntimeError`` if it cannot be built."""
    lib = _native.load("replaybuf")
    lib.rb_write.restype = ctypes.c_int
    lib.rb_write.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.rb_open.restype = ctypes.c_void_p
    lib.rb_open.argtypes = [ctypes.c_char_p]
    lib.rb_rows.restype = ctypes.c_uint64
    lib.rb_rows.argtypes = [ctypes.c_void_p]
    lib.rb_dim.restype = ctypes.c_uint64
    lib.rb_dim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rb_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.rb_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rb_gather.restype = ctypes.c_int
    lib.rb_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.rb_close.restype = None
    lib.rb_close.argtypes = [ctypes.c_void_p]
    return lib


class ReplayBuffer:
    """Zero-copy view over an mmap'd replay-buffer file.

    ``arrays`` are numpy views onto the mapping; they, and any tensor made
    from them with ``torch.from_numpy`` or ``torch.as_tensor`` on the CPU,
    alias pages that ``close()`` unmaps. ``copy_arrays`` returns copies
    that outlive the buffer.
    """

    NAMES = ("s0", "a0", "sn", "ts")

    def __init__(self, path: str, shapes: dict):
        self._lib = get_lib()
        self._h = self._lib.rb_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open replay buffer {path}")
        self.n = int(self._lib.rb_rows(self._h))
        self.shapes = shapes
        self.arrays = {}
        for i, name in enumerate(self.NAMES):
            d = int(self._lib.rb_dim(self._h, i))
            flat = np.ctypeslib.as_array(self._lib.rb_data(self._h, i), shape=(self.n * d,))
            self.arrays[name] = flat.reshape((self.n,) + tuple(shapes[name]))

    def copy_arrays(self) -> dict:
        """Heap copies of all arrays, safe to use after ``close()``."""
        return {k: np.array(v, copy=True) for k, v in self.arrays.items()}

    def gather(self, name: str, idx: np.ndarray, n_threads: int = 8) -> np.ndarray:
        """Rows ``idx`` of array ``name``, copied on ``n_threads`` threads;
        an index out of range raises."""
        i = self.NAMES.index(name)
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        d = int(np.prod(self.shapes[name], dtype=np.int64)) if self.shapes[name] else 1
        out = np.empty((idx.shape[0], d), dtype=np.float32)
        rc = self._lib.rb_gather(self._h, i, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                 idx.shape[0], _fptr(out), n_threads)
        if rc != 0:
            raise RuntimeError(f"rb_gather failed: {rc}")
        return out.reshape((idx.shape[0],) + tuple(self.shapes[name]))

    def close(self):
        if self._h:
            self._lib.rb_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def write_buffer(path: str, s0, a0, sn, ts) -> None:
    """Write the native file from four numpy arrays with one row count
    (cast to float32); raises if the library cannot be built or the write fails."""
    lib = get_lib()
    arrs = [np.ascontiguousarray(np.asarray(x), dtype=np.float32) for x in (s0, a0, sn, ts)]
    n = arrs[0].shape[0]
    if any(a.shape[0] != n for a in arrs):
        raise ValueError(f"row-count mismatch: {[a.shape[0] for a in arrs]}")
    dims = (ctypes.c_uint64 * 4)(*[int(np.prod(a.shape[1:], dtype=np.int64)) if a.ndim > 1 else 1 for a in arrs])
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    rc = lib.rb_write(str(path).encode(), n, dims, *[_fptr(a) for a in arrs])
    if rc != 0:
        raise IOError(f"rb_write {path} failed: {rc}")


def open_buffer(path: str, shapes: dict) -> ReplayBuffer:
    return ReplayBuffer(path, shapes)
