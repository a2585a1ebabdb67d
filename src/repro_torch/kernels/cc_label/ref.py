"""Plain PyTorch version of the cc_label kernel: min-label propagation
over the 4-neighbourhood under the mask until fixpoint, batched over
cameras.  Sweeps past the fixpoint change nothing, so the loop reads a
fixpoint flag on the host every ``CHECK_EVERY`` sweeps and stops there: the
labels are the JAX package's (``repro.core.cc.label_and_boxes``) exactly.
That host read is why the slot step on the card runs the kernel instead."""
from __future__ import annotations

import torch

INF = 2 ** 30
CHECK_EVERY = 4


def _propagate(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    p = torch.nn.functional.pad(labels, (1, 1, 1, 1), value=INF)
    neigh = torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                          torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))
    return torch.where(mask, torch.minimum(labels, neigh), INF)


def cc_label_ref(mask: torch.Tensor) -> torch.Tensor:
    """mask (C, M, N) bool -> labels (C, M, N) int32: each component's
    least row-major cell index, INF on the background."""
    C, M, N = mask.shape
    idx = torch.arange(M * N, dtype=torch.int32,
                       device=mask.device).reshape(1, M, N)
    labels = torch.where(mask, idx, INF)
    for it in range(0, M * N, CHECK_EVERY):
        prev = labels
        for _ in range(min(CHECK_EVERY, M * N - it)):
            labels = _propagate(labels, mask)
        if torch.equal(labels, prev):
            break
    return labels
