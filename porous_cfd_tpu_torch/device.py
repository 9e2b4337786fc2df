"""Device selection: the CUDA card by default, the CPU only when asked."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device; without one this raises instead of
    continuing on the CPU. ``"cpu"`` (or any explicit device) is taken as given.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: porous_cfd_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())

