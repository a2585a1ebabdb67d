"""Where the port runs: the card unless the caller asks for the CPU.

Under a camera mesh each process owns one card: ``launch.mesh`` calls
``torch.cuda.set_device(LOCAL_RANK)``, so ``cuda`` is the rank's card.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

_SMS = {}

# set by ``analysis.trace_cost`` while it traces: called with (kernel
# name, FLOPs, bytes) for each launch a kernel's stand-in stands for
KERNEL_RECORDER: Optional[Callable[[str, float, float], None]] = None


def is_fake(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``FakeTensor`` (a traced call: a
    kernel's dispatcher then takes its stand-in)."""
    return any(isinstance(t, FakeTensor) for t in tensors)


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """One launch of the hand-written kernel ``name`` that does ``flops``
    and moves ``nbytes``, in the running trace (none: nothing)."""
    if KERNEL_RECORDER is not None:
        KERNEL_RECORDER(name, flops, nbytes)


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


def upload(array, device, dtype=None) -> torch.Tensor:
    """A copy of host data (array-like) on ``device`` that leaves the host
    free: a CUDA upload goes through pinned memory as an asynchronous
    copy, so it never waits on the card (the caching host allocator keeps
    the pinned block until the copy is done)."""
    host = torch.from_numpy(np.array(array, dtype=dtype))
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)
