"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch

_SMS = {}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if the card is wanted and absent (the
    port never falls back to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card behind ``device`` (read once
    per card)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]
