"""The port's native runtime (neurallaplacecontrol_tpu_torch.runtime) and
its replay-buffer files (data.replay) against the JAX package's: ``.rbuf``
and tick-log files written by either package open in the other with equal
contents, the two tick-log CLIs print the same, and loading prefers a
usable ``.rbuf`` and falls back to the ``.npz`` on every kind of unusable one.
"""

import gc
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu import runtime as jruntime
from neurallaplacecontrol_tpu.data.replay import load_replay_buffer as jax_load
from neurallaplacecontrol_tpu.data.replay import save_replay_buffer as jax_save
from neurallaplacecontrol_tpu.runtime.ticklog import TickLog as JaxTickLog
from neurallaplacecontrol_tpu_torch import runtime
from neurallaplacecontrol_tpu_torch.data import replay
from neurallaplacecontrol_tpu_torch.data.replay import load_replay_buffer, save_replay_buffer
from neurallaplacecontrol_tpu_torch.runtime import _native
from neurallaplacecontrol_tpu_torch.runtime.ticklog import TickLog

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SHAPES = {"s0": (3,), "a0": (4, 1), "sn": (3,), "ts": (1,)}


def buffer(n=50, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n,) + SHAPES[k]).astype(dtype) for k in ("s0", "a0", "sn", "ts")]


def test_rbuf_crosses_between_the_packages(tmp_path):
    """A .rbuf the port writes opens in the JAX runtime, and one JAX writes
    opens in the port's, with equal arrays and equal gathers."""
    arrays = buffer()
    runtime.write_buffer(str(tmp_path / "port.rbuf"), *arrays)
    assert jruntime.write_buffer(str(tmp_path / "jax.rbuf"), *arrays)
    assert (tmp_path / "port.rbuf").read_bytes() == (tmp_path / "jax.rbuf").read_bytes()
    idx = np.array([3, 0, 49, 7])
    for name, open_ in (("port.rbuf", jruntime.open_buffer), ("jax.rbuf", runtime.open_buffer)):
        rb = open_(str(tmp_path / name), SHAPES)
        try:
            for k, a in zip(rb.NAMES, arrays):
                np.testing.assert_array_equal(rb.arrays[k], a)
                np.testing.assert_array_equal(rb.gather(k, idx), a[idx])
        finally:
            rb.close()


def test_replay_files_cross_between_the_packages(tmp_path):
    """``save_replay_buffer`` of each package writes the .npz and its .rbuf;
    the other package's ``load_replay_buffer`` reads them back equal."""
    arrays = buffer(seed=1)
    save_replay_buffer(tmp_path / "port.npz", *(torch.from_numpy(a) for a in arrays))
    jax_save(tmp_path / "jax.npz", *arrays)
    assert (tmp_path / "port.rbuf").exists() and (tmp_path / "jax.rbuf").exists()
    for got in (jax_load(tmp_path / "port.npz"), load_replay_buffer(tmp_path / "jax.npz", device="cpu")):
        for g, a in zip(got, arrays):
            np.testing.assert_array_equal(np.asarray(g), a)


def test_rbuf_is_preferred_and_tensors_outlive_the_mapping(tmp_path):
    """Where the .rbuf is usable the loader reads it (a sibling holding other
    values of the same shapes wins over the .npz), and the tensors stay valid
    after the mapping is closed and collected."""
    path = tmp_path / "b.npz"
    arrays = buffer(seed=2)
    save_replay_buffer(path, *arrays)
    other = [a + 1.0 for a in arrays]
    runtime.write_buffer(str(tmp_path / "b.rbuf"), *other)
    got = load_replay_buffer(path, device="cpu")
    gc.collect()
    for g, a in zip(got, other):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), a)


@pytest.mark.parametrize("fault", ["stale", "float64", "truncated", "corrupt"])
def test_unusable_rbuf_falls_back_to_the_npz(tmp_path, fault):
    """A sibling with another row count, float64 data (no sibling is
    written; a stray one is not read), a truncated file and a bad magic all
    load from the .npz."""
    path, rb = tmp_path / "b.npz", tmp_path / "b.rbuf"
    arrays = buffer(seed=3, dtype=np.float64 if fault == "float64" else np.float32)
    save_replay_buffer(path, *arrays)
    assert rb.exists() == (fault != "float64")
    if fault in ("stale", "float64"):
        runtime.write_buffer(str(rb), *buffer(n=40 if fault == "stale" else 50, seed=9))
    elif fault == "truncated":
        rb.write_bytes(rb.read_bytes()[:-8])
    else:
        rb.write_bytes(b"\0" * 8 + rb.read_bytes()[8:])
    got = load_replay_buffer(path, device="cpu")
    gc.collect()
    for g, a in zip(got, arrays):
        assert g.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(g.numpy(), a)


def test_save_without_the_native_library_warns_and_writes_the_npz(tmp_path, monkeypatch, caplog):
    def unavailable():
        raise RuntimeError("g++ failed with exit code 1")

    monkeypatch.setattr(runtime, "get_lib", unavailable)
    (tmp_path / "b.rbuf").write_bytes(b"stale")
    arrays = buffer(seed=4)
    with caplog.at_level(logging.WARNING):
        save_replay_buffer(tmp_path / "b.npz", *arrays)
    assert not (tmp_path / "b.rbuf").exists()
    assert any("no native .rbuf sibling" in r.getMessage() for r in caplog.records)
    for g, a in zip(load_replay_buffer(tmp_path / "b.npz", device="cpu"), arrays):
        np.testing.assert_array_equal(g.numpy(), a)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "source", lambda name: bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native.build("broken", build_dir=tmp_path / "build")
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_goes_under_the_build_directory_keyed_by_the_source(tmp_path):
    """The library lands in <build_dir>/<name>/<hash>/, never under the repo's
    runtime/; a second build finds it and runs no compiler."""
    before = _native.compiles
    lib = _native.build("ticklog", build_dir=tmp_path)
    assert lib.parent.parent == tmp_path / "ticklog" and lib.name == "libticklog.so"
    assert _native.build("ticklog", build_dir=tmp_path) == lib and _native.compiles == before + 1


def test_gather_refuses_rows_out_of_range(tmp_path):
    runtime.write_buffer(str(tmp_path / "b.rbuf"), *buffer(n=10))
    rb = runtime.open_buffer(str(tmp_path / "b.rbuf"), SHAPES)
    try:
        with pytest.raises(RuntimeError, match="rb_gather"):
            rb.gather("s0", np.array([0, 10]))
        big = np.random.default_rng(0).integers(0, 10, 5000)  # the threaded path
        np.testing.assert_array_equal(rb.gather("a0", big, n_threads=4), rb.arrays["a0"][big])
    finally:
        rb.close()


def test_ticklogs_cross_between_the_packages(tmp_path):
    """A log the port writes reads back in the JAX runtime and one JAX writes
    in the port's, across a wrap of the ring; ``last`` and ``read`` agree."""
    rows = np.random.default_rng(5).standard_normal((13, 6)).astype(np.float32)
    for writer, reader, name in ((TickLog, JaxTickLog, "port.log"), (JaxTickLog, TickLog, "jax.log")):
        log = writer.create(str(tmp_path / name), 8, 6)
        for r in rows:
            log.append(r)
        log.sync()
        log.close()
        other = reader.open(str(tmp_path / name))
        assert (other.count, other.capacity, other.width) == (13, 8, 6)
        np.testing.assert_array_equal(other.last(20), rows[-8:])
        np.testing.assert_array_equal(other.read(7, 4), rows[7:11])
        with pytest.raises(IndexError):
            other.read(2, 3)  # evicted
        other.close()
    assert (tmp_path / "port.log").read_bytes() == (tmp_path / "jax.log").read_bytes()


def test_ticklog_resumes_and_refuses_other_dimensions(tmp_path):
    path = str(tmp_path / "t.log")
    log = TickLog.create(path, 4, 2)
    log.append([1.0, 2.0])
    log.close()
    log = TickLog.create(path, 4, 2)
    assert log.count == 1 and log.append([3.0, 4.0]) == 2
    with pytest.raises(ValueError, match="width"):
        log.append([1.0])
    log.close()
    with pytest.raises(IOError):
        TickLog.create(path, 8, 2)


def test_ticklog_clis_print_the_same(tmp_path):
    path = str(tmp_path / "t.log")
    log = TickLog.create(path, 16, 4)
    for r in np.random.default_rng(6).standard_normal((20, 4)):
        log.append(r)
    log.close()
    outs = [subprocess.run([sys.executable, "-m", f"{pkg}.runtime.ticklog", path, "--last", "5"], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
            for pkg in ("neurallaplacecontrol_tpu_torch", "neurallaplacecontrol_tpu")]
    for o in outs:
        assert o.returncode == 0, o.stderr[-2000:]
    assert outs[0].stdout == outs[1].stdout and outs[0].stderr == outs[1].stderr
    assert len(outs[0].stdout.splitlines()) == 5
