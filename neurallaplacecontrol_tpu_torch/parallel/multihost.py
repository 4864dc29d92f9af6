"""Multi-host orchestration (port of ``parallel/multihost.py``) over
``torch.distributed``.

The reference's outer experiment grid fans out over a local process pool
(run_exp_multi.py:103-165). Here every host (or every process of one host)
runs the same program, ``initialize`` joins them in one process group, and
the embarrassingly-parallel outer grid (seeds, cells) splits by process
index; the processes exchange nothing but the barrier's rendezvous.

A process that never called ``initialize`` is process 0 of 1, and every
helper passes it through unchanged.

Under ``python -m torch.distributed.run`` (torchrun), ``initialize()`` takes
the group from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), one
process per device: a host is then the ``LOCAL_WORLD_SIZE`` ranks of one
node (``host_index``, ``host_ranks``), where a group given by address and
count has one rank per host.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Optional, Sequence

import numpy as np

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# Recorded by initialize() so that barrier() can rendezvous on
# coordinator_port + 1 without asking the process group for its address, and
# the ranks per host (torchrun's LOCAL_WORLD_SIZE; 1 for a group given by
# address and count).
_coordinator_address: Optional[str] = None
_ranks_per_host = 1


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda", backend: Optional[str] = None) -> None:
    """Join this process to the group: ``torch.distributed.init_process_group``
    at ``tcp://<coordinator_address>`` (``host:port``; process 0 listens
    there) with ``num_processes`` ranks, this one ``process_id``. With no
    address and no count, under torchrun the group is torchrun's
    (``env://``), and otherwise this does nothing: a single process.

    The backend follows ``device``: nccl for CUDA, gloo for the CPU; with no
    CUDA, ``device="cuda"`` raises. ``backend`` names another one explicitly
    (gloo on CUDA tensors lets two ranks share one card, which nccl
    refuses); nothing switches backend on its own, and a failed group
    raises. On CUDA each process takes card ``local rank % device_count``
    as its current device (the process id for a group given by address).
    The JAX module's ``auto`` (the cluster found by the runtime) has no
    counterpart. Joining twice is a no-op."""
    global _coordinator_address, _ranks_per_host
    from_env = coordinator_address is None and num_processes is None
    if from_env and "WORLD_SIZE" not in os.environ:
        return
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if from_env:
        world = int(os.environ["WORLD_SIZE"])
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        if world % per_host:
            raise ValueError(f"LOCAL_WORLD_SIZE={per_host} does not divide WORLD_SIZE={world}: "
                             "every host must run as many ranks")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
        _coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        _ranks_per_host = per_host
        dist.init_process_group(backend, init_method="env://")
        return
    if dev.type == "cuda":
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    _coordinator_address = coordinator_address
    _ranks_per_host = 1
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id)


def under_torchrun() -> bool:
    """Whether torchrun's environment names a group for ``initialize()``."""
    return "WORLD_SIZE" in os.environ


def process_index() -> int:
    """This process's rank in the group; 0 outside one."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The group's size; 1 outside one."""
    return _group_size()


def _group_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_index() -> int:
    """This process's host: its rank over the ranks per host."""
    return process_index() // _ranks_per_host


def host_count() -> int:
    return process_count() // _ranks_per_host


def host_ranks() -> list:
    """The global ranks of this process's host, this one among them."""
    h = host_index()
    return list(range(h * _ranks_per_host, (h + 1) * _ranks_per_host))


def process_slice(items: Sequence, process_id: Optional[int] = None, process_count: Optional[int] = None) -> list:
    """This process's share of an embarrassingly-parallel work list (seed
    grid, cell grid), the replacement for the reference's Pool fan-out:
    round-robin, so uneven lists stay balanced. The process and the count
    default to this process's in its group."""
    pid = process_index() if process_id is None else process_id
    n = _group_size() if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % n == pid]


def barrier(name: str, timeout_s: float = 3600.0, coordinator_address: Optional[str] = None) -> None:
    """Cross-process rendezvous barrier on ``coordinator_port + 1``.

    For synchronization at run time ("every process finished its grid
    cells"), where the processes may be minutes apart: a collective of the
    process group (``dist.barrier``) runs under the group's own timeout and
    on nccl occupies the card. This is the JAX module's TCP rendezvous:
    process 0 listens on the coordinator host's ``port + 1`` (the group's
    store holds ``port``), every other process connects, sends ``name`` and
    blocks until process 0 has heard from all N-1 peers and acks. A name
    that differs fails loudly: the processes' control flow diverged. A
    single process returns at once. ``coordinator_address`` defaults to the
    one ``initialize()`` recorded."""
    n = process_count()
    if n == 1:
        return
    addr = coordinator_address or _coordinator_address
    if addr is None:
        raise RuntimeError("barrier() needs initialize() with a coordinator address first")
    host, _, port = addr.rpartition(":")
    bport = int(port) + 1
    deadline = time.monotonic() + timeout_s
    tag = f"{name}\n".encode()
    if process_index() == 0:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        conns = []
        try:
            srv.bind(("", bport))
            srv.listen(n - 1)
            for _ in range(n - 1):
                srv.settimeout(max(0.1, deadline - time.monotonic()))
                conn, _ = srv.accept()
                conns.append(conn)
                conn.settimeout(max(0.1, deadline - time.monotonic()))
                got = conn.makefile("rb").readline()
                if got != tag:
                    raise RuntimeError(f"barrier name mismatch: waiting at {name!r}, a peer sent {got!r}: "
                                       "the processes' control flow diverged")
            for conn in conns:  # everyone arrived: release all at once
                conn.sendall(tag)
        except socket.timeout:
            raise TimeoutError(f"barrier {name!r}: only {len(conns)}/{n - 1} peers arrived within "
                               f"{timeout_s:.0f}s") from None
        finally:
            for conn in conns:
                conn.close()
            srv.close()
    else:
        while True:  # process 0 may not be listening yet: retry to the deadline
            try:
                conn = socket.create_connection((host, bport), timeout=max(0.1, deadline - time.monotonic()))
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"barrier {name!r}: could not reach process 0 at {host}:{bport} within "
                                       f"{timeout_s:.0f}s") from None
                time.sleep(0.5)
        try:
            conn.settimeout(max(0.1, deadline - time.monotonic()))
            conn.sendall(tag)
            got = conn.makefile("rb").readline()
            if got != tag:
                raise TimeoutError(f"barrier {name!r}: process 0 closed without ack (got {got!r}); it likely "
                                   "timed out waiting for another peer")
        except socket.timeout:
            raise TimeoutError(f"barrier {name!r}: no ack from process 0 within {timeout_s:.0f}s") from None
        finally:
            conn.close()


def global_mesh(axis_names=("dp",), shape: Optional[tuple] = None, device="cuda"):
    """A mesh over every rank of every host (``parallel.sharding.Mesh``).
    Default is one flat axis; ``shape`` factors it, for example
    (host_count(), ranks per host) for ("dp", "tp")."""
    from .sharding import Mesh

    n = process_count()
    shape = tuple(shape or (n,))
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not hold the {n} ranks")
    return Mesh(np.arange(n).reshape(shape), axis_names[: len(shape)], device=device)
