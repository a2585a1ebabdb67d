"""Flash-decode dispatch: the plain version for CPU tensors, the CUDA kernel
(``csrc/flash_decode.cu``) for CUDA tensors, nothing else; plus the merge
of one fresh (k1, v1) token outside the kernel.

The JAX dispatcher's shape rule ``_kernel_ok`` (G >= 4 and S a multiple of
the block) chose between the TPU's matrix unit and its vector unit; it
has no counterpart here.  The kernel takes any G >= 1 and any S, masking
the ragged edge itself, so the device alone decides.  Unlike the JAX
``ops.flash_decode``, which returns ``out`` only, ``flash_decode`` returns
the kernel's ``(out, m, l)``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref

# kernel launches since the last reset (one per call of flash_decode_cuda,
# which may run the range kernel and the merge kernel)
LAUNCHES = 0

# shared memory one block may use on the H100 (227 KB)
MAX_SMEM_BYTES = 232448
TILE = 32             # positions per tile (csrc/flash_decode.cu: kTS)
BLOCKS_PER_SM = 4     # ranges are cut so about this many blocks share an SM

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def split_plan(n_pos: int, blocks: int, sms: int) -> Tuple[int, int]:
    """(tiles per range, ranges) for ``n_pos`` positions over ``blocks``
    (b, kv head) pairs: enough ranges for ~BLOCKS_PER_SM blocks per SM,
    never an empty one."""
    tiles = -(-n_pos // TILE)
    want = max(1, -(-BLOCKS_PER_SM * sms // blocks))
    per = -(-tiles // min(tiles, want))
    return per, -(-tiles // per)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_valid_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: q (B, 1, H, hd), k and v
    (B, S, KV, hd), one dtype (float32 or bfloat16), contiguous on one
    card, H a multiple of KV, hd a multiple of 16 bytes, valid length >= 0
    -> (out (B, 1, H, hd) in q's dtype, m, l (B, KV, G, 1) float32)."""
    global LAUNCHES
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4:
        raise ValueError(f"need q (B, 1, H, hd) and k (B, S, KV, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != tuple(k.shape)
            or S < 1 or KV < 1 or H % KV):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    vec = 16 // q.element_size()
    if hd % vec:
        raise ValueError(f"head_dim {hd} must be a multiple of {vec} for "
                         f"{q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_decode_cuda needs q, k and v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    n = int(kv_valid_len)
    if n < 0:
        raise ValueError(f"valid length must be >= 0, got {n}")
    G = H // KV
    # two stages of K and V tiles and the G query rows in q's dtype; the
    # accumulator, p rows and (m, l, alpha) in float32 (as the .cu sizes it)
    smem = ((4 * TILE * hd + G * hd) * q.element_size()
            + 4 * (G * hd + G * (TILE + 1) + 3 * G))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash_decode needs {smem} bytes of shared memory "
                         f"for G={G}, hd={hd}; a block has {MAX_SMEM_BYTES}")
    n_pos = min(n, S) if n > 0 else S
    per, nsplit = split_plan(n_pos, B * KV, _sm_count(dev))
    out = torch.empty_like(q)
    m = torch.empty((B, KV, G, 1), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    if nsplit > 1:
        part_m = torch.empty((B * KV, nsplit, G), dtype=torch.float32,
                             device=dev)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((B * KV, nsplit, G, hd), dtype=torch.float32,
                               device=dev)
        parts = (part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr())
    else:
        parts = (None, None, None)
    fn = build.library("flash_decode").flash_decode_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), m.data_ptr(), l.data_ptr(), *parts, B, S, KV, G,
             hd, n, n_pos, per, nsplit, float(np.float32(1.0 / np.sqrt(hd))),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return out, m, l


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_valid_len: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode attention over the valid prefix: plain version on the CPU,
    kernel on CUDA -> (out, m, l)."""
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, kv_valid_len=int(kv_valid_len))
    return flash_decode_cuda(q, k, v, int(kv_valid_len))


def merge_new(q: torch.Tensor, k1: torch.Tensor, v1: torch.Tensor,
              out_old: torch.Tensor, m_old: torch.Tensor,
              l_old: torch.Tensor) -> torch.Tensor:
    """Fold one fresh (k1, v1) token (B, 1, KV, hd) into the decode over
    the old cache, given its (out, m, l)."""
    B, _, H, hd = q.shape
    KV = k1.shape[2]
    G = H // KV
    f32 = torch.float32
    qg = q.reshape(B, KV, G, hd).to(f32)
    scale = 1.0 / np.sqrt(hd)
    s_new = torch.einsum("bkgd,bkd->bkg", qg,
                         k1.reshape(B, KV, hd).to(f32))[..., None] * scale
    m = torch.maximum(m_old, s_new)                      # (B,KV,G,1)
    alpha = torch.exp(m_old - m)
    p_new = torch.exp(s_new - m)
    denom = l_old * alpha + p_new
    out = (out_old.reshape(B, KV, G, hd).to(f32) * (l_old * alpha)
           + p_new * v1.reshape(B, KV, 1, hd).to(f32)) / denom
    return out.reshape(B, 1, H, hd).to(q.dtype)


def flash_decode_with_new(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k1: torch.Tensor, v1: torch.Tensor, *,
                          kv_valid_len: int) -> torch.Tensor:
    """Attention over the old cache (< kv_valid_len) plus one fresh (k1, v1)
    token: the kernel's (m, l) merge with the new token's score outside
    it, so the cache itself is only read."""
    return merge_new(q, k1, v1,
                     *flash_decode(q, k, v, kv_valid_len=kv_valid_len))
