"""Timing with an honest device synchronization (counterpart of
``porous_cfd_tpu/utils/profiling.py``): PyTorch returns before the card has
finished, so a host clock must end in ``torch.cuda.synchronize()``."""
from __future__ import annotations

import torch


def sync(device=None) -> None:
    """Wait for all work queued on ``device`` (no-op on the CPU)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)

