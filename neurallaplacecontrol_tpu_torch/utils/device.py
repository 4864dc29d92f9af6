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


def card(device) -> dict:
    """The card a measurement ran on, as bench lines record it: ``device``
    (``nvidia-smi``'s name, or ``"cpu"``) and ``power_limit_w`` (its power
    limit in watts, None on the CPU). A card may run below its maximum, and
    then slower under load."""
    if torch.device(device).type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    index = torch.device(device).index or 0
    name, limit = (x.strip() for x in out.stdout.strip().splitlines()[index].rsplit(",", 1))
    return {"device": name, "power_limit_w": float(limit)}
