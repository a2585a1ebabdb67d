"""Plain single-token GQA decode attention with the kernel's statistics.

q (B, 1, H, hd), k/v (B, S, KV, hd), valid length -> out (B, 1, H, hd) in
q's dtype, m and l (B, KV, G, 1) float32: the function of the TPU kernel
``flash_decode_pallas`` (``repro/kernels/flash_decode/flash_decode.py``)
and of its CUDA counterpart (``csrc/flash_decode.cu``).  Scores
``q . k / sqrt(hd)`` in float32; positions ``>= valid_len`` score -1e30
(never -inf, so with ``valid_len = 0`` every position weighs alike and
``out`` is the mean of V, ``m = -1e30``, ``l = S``, as on the TPU);
``m`` is the row max, ``l = sum exp(s - m)`` and
``out = (exp(s - m) @ v) / max(l, 1e-30)``.  CPU tensors take this
version, and the card compares the kernel with it.  ``round_p=True``
models the bf16 kernel's arithmetic instead: float32 scores of the bf16
q and k (each product exact in float32, as on the tensor cores), P
rounded to bf16 before P.V, P.V accumulated in float32, l summing the
unrounded P.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NEG = -1e30


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_valid_len: int, round_p: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32)) * scale
    pos = torch.arange(k.shape[1], device=k.device)
    s = torch.where(pos < kv_valid_len, s, torch.full_like(s, NEG))
    m = torch.amax(s, dim=-1, keepdim=True)                   # (B,KV,G,1)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if round_p:
        p = p.to(torch.bfloat16).to(torch.float32)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype), m, l
