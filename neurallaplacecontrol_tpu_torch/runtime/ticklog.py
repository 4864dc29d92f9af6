"""The native tick-telemetry ring log (port of ``runtime/ticklog.py``), bound with ``ctypes``.

``TickLog`` appends one fixed-width float32 record per serving tick into an
mmap'd ring file (``csrc/ticklog.cc``): a memcpy plus a release-ordered
cursor store, no syscalls. The records survive a process crash (the pages
belong to the OS once written), and a monitoring process can
``TickLog.open`` the same file and tail it live. The file format is the
JAX package's, byte for byte.

The record schema is the caller's (``width`` floats); the serving layout is
``[t_rel_s, tick_ms, action..., obs...]``, with seconds relative to an
epoch kept beside the log (an absolute unix time would alias to a 128 s
grid in float32); see ``scripts/serve_demo_torch.py``. The library is built
with ``g++`` at first use (``runtime._native``) and a failed build raises.
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
    """The tick-log library, built if needed; raises ``RuntimeError`` if it cannot be built."""
    lib = _native.load("ticklog")
    lib.tl_create.restype = ctypes.c_void_p
    lib.tl_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.tl_open.restype = ctypes.c_void_p
    lib.tl_open.argtypes = [ctypes.c_char_p]
    for name in ("tl_count", "tl_capacity", "tl_width"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    lib.tl_append.restype = ctypes.c_uint64
    lib.tl_append.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.tl_read.restype = ctypes.c_int
    lib.tl_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float)]
    lib.tl_last.restype = ctypes.c_uint64
    lib.tl_last.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float)]
    lib.tl_sync.restype = ctypes.c_int
    lib.tl_sync.argtypes = [ctypes.c_void_p]
    lib.tl_close.restype = None
    lib.tl_close.argtypes = [ctypes.c_void_p]
    return lib


class TickLog:
    """A fixed-width float32 ring log over an mmap'd file.

    ``TickLog.create(path, capacity, width)`` creates a new log, or resumes
    an existing one of the same dimensions; ``TickLog.open(path)`` attaches
    to whatever is there (a live controller's log, from a monitoring
    process). One writer, any number of readers.
    """

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        self.capacity = int(lib.tl_capacity(handle))
        self.width = int(lib.tl_width(handle))

    @classmethod
    def create(cls, path: str, capacity: int, width: int) -> "TickLog":
        lib = get_lib()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        h = lib.tl_create(str(path).encode(), capacity, width)
        if not h:
            raise IOError(f"cannot create tick log {path} (existing file with different capacity/width?)")
        return cls(h, lib)

    @classmethod
    def open(cls, path: str) -> "TickLog":
        lib = get_lib()
        h = lib.tl_open(str(path).encode())
        if not h:
            raise IOError(f"cannot open tick log {path}")
        return cls(h, lib)

    @property
    def count(self) -> int:
        """Records ever appended (monotone; the ring keeps the last ``capacity``)."""
        return int(self._lib.tl_count(self._h))

    def append(self, record) -> int:
        rec = np.ascontiguousarray(record, dtype=np.float32).reshape(-1)
        if rec.shape[0] != self.width:
            raise ValueError(f"record has {rec.shape[0]} floats, log width is {self.width}")
        n = int(self._lib.tl_append(self._h, _fptr(rec)))
        if n == 0:
            raise RuntimeError("tl_append failed")
        return n

    def read(self, start: int, k: int) -> np.ndarray:
        """Records [start, start+k) by absolute index; raises if any of them
        was already evicted from the ring (or not yet written)."""
        out = np.empty((k, self.width), dtype=np.float32)
        if self._lib.tl_read(self._h, start, k, _fptr(out)) != 0:
            raise IndexError(f"records [{start}, {start + k}) unavailable "
                             f"(count={self.count}, capacity={self.capacity})")
        return out

    def last(self, k: int) -> np.ndarray:
        """The newest min(k, retained) records, oldest first."""
        out = np.empty((k, self.width), dtype=np.float32)
        n = int(self._lib.tl_last(self._h, k, _fptr(out)))
        return out[:n]

    def sync(self):
        """msync the mapping (for a machine crash; appends already survive a process crash)."""
        if self._lib.tl_sync(self._h) != 0:
            raise OSError("msync failed")

    def close(self):
        if self._h:
            self._lib.tl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _main(argv=None):
    """Monitoring CLI: ``python -m neurallaplacecontrol_tpu_torch.runtime.ticklog
    <path> [--last N] [--follow]`` prints records as JSON lines (one float
    list per record, the writer's schema order). ``--follow`` tails a live
    log from another process."""
    import argparse
    import json
    import sys
    import time as _time

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("path")
    p.add_argument("--last", type=int, default=10)
    p.add_argument("--follow", action="store_true")
    p.add_argument("--poll_s", type=float, default=0.2)
    args = p.parse_args(argv)

    log = TickLog.open(args.path)
    # the cursor before the dump: records appended while it prints are the
    # follow loop's
    cursor = log.count
    print(f"# {args.path}: {cursor} records, width {log.width}, ring capacity {log.capacity}", file=sys.stderr)
    k = min(args.last, cursor, log.capacity)
    if k > 0:
        try:
            rows = log.read(cursor - k, k)
        except IndexError:  # the writer lapped the ring between count and read
            rows = []
        for row in rows:
            print(json.dumps([round(float(x), 6) for x in row]))
    while args.follow:
        new = log.count
        if new > cursor:
            start = max(cursor, new - log.capacity)  # skip lapped records
            try:
                rows = log.read(start, new - start)
            except IndexError:  # lapped between count and read
                cursor = new
                continue
            for row in rows:
                print(json.dumps([round(float(x), 6) for x in row]), flush=True)
            cursor = new
        else:
            _time.sleep(args.poll_s)


if __name__ == "__main__":
    _main()
