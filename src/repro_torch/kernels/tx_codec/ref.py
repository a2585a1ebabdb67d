"""Plain PyTorch version of the tx_codec kernel: per camera, the selected
blur branch, quantisation, the fused noise add and the clip."""
from __future__ import annotations

import torch

from repro_torch.core import codec


def tx_codec_ref(frames: torch.Tensor, noise: torch.Tensor,
                 levels: torch.Tensor, sigma: torch.Tensor,
                 kcam: torch.Tensor) -> torch.Tensor:
    """frames/noise (C, N, H, W); levels/sigma (C,) f32; kcam (C,) int32
    pool factor per camera (1 = identity) -> decoded (C, N, H, W)."""
    out = torch.empty_like(frames)
    for c, k in enumerate(kcam.tolist()):
        out[c] = codec.quantize_noise(codec.blur(frames[c], k), levels[c],
                                      sigma[c], noise[c])
    return out
