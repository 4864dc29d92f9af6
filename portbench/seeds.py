"""Streams of random numbers derived from a run's ``--seed``.

Every draw the benchmark makes comes from a ``torch.Generator`` seeded with
``stream_seed(seed, *parts)``, where the parts name the stream (a batch, an
episode, the widening, the check's sample). Any whole number works as a seed,
also one past 32 bits.
"""

from __future__ import annotations

import hashlib


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit seed for the stream ``parts`` of the run seeded ``seed``."""
    text = "/".join([str(int(seed))] + [str(p) for p in parts]).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1
