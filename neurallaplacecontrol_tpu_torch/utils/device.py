"""Device selection shared by the port's entry points.

Entry points default to ``device="cuda"`` and never drop to the CPU on
their own: with no CUDA, a caller that wants the CPU passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
