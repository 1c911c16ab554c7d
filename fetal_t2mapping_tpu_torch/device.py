"""Device selection for the public entry points.

Every entry point takes ``device`` (default ``"cuda"``) and resolves it
here. A CUDA request on a machine without a usable GPU raises: nothing
moves to the CPU unless the caller asked for ``"cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` / a ``torch.device`` ->
    ``torch.device``; raises for an unavailable GPU or another type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain CPU path")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         "(expected 'cuda' or 'cpu')")
    return dev
