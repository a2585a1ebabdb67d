"""Flash-decode dispatch: the plain version for CPU tensors, the CUDA kernel
(``csrc/flash_decode.cu``) for CUDA tensors, nothing else; plus the merge
of one fresh (k1, v1) token outside the kernel.

The JAX dispatcher's shape rule ``_kernel_ok`` (G >= 4 and S a multiple of
the block) chose between the TPU's matrix unit and its vector unit; it
has no counterpart here.  The kernel takes any G from 1 to 16 and any S,
masking the ragged edge itself, so the device alone decides.  Unlike the JAX
``ops.flash_decode``, which returns ``out`` only, ``flash_decode`` returns
the kernel's ``(out, m, l)``.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.common.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref

# kernel launches since the last reset (one per call of flash_decode_cuda)
LAUNCHES = 0

TILE = 64             # positions per tile (csrc/flash_decode.cu: kTile)
STAGES = 3            # ring stages a block is planned with (fewer if its
                      # range has fewer tiles, or the tiles do not fit)
MAX_G = 16            # query rows per kv head the kernel takes
MAX_HD = 256
MAX_SPLITS = 128      # ranges per (b, kv head)
PARTIAL_SHARE = 0.1   # float32 partials at most this share of K/V bytes
MAX_SMEM_BYTES = 232448     # shared memory one block may use (227 KB)
SM_SMEM_BYTES = 233472      # shared memory of one SM (228 KB)
MAP_CACHE_SIZE = 4096       # tensor maps kept (128 bytes each)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAPS: "OrderedDict[tuple, ctypes.Array]" = OrderedDict()
_WORKSPACE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_FNS = None


def smem_bytes(elem_bytes: int, hd: int, stages: int) -> int:
    """Dynamic shared memory of one block (``csrc/flash_decode.cu``:
    ``layout`` plus 1024 bytes to align its base): the ring of K and V
    tiles (or the merge area, if larger), barriers, the query rows, merge
    scalars and, in float32, the per-warp P rows."""
    bf16 = elem_bytes == 2
    hdp = -(-hd // 64) * 64 if bf16 else -(-hd // 32) * 32
    tile = (hdp // 64) * TILE * 64 * 2 if bf16 else TILE * hd * 4
    region = max(stages * 2 * tile, 4 * MAX_G * hd * 4, MAX_SPLITS * MAX_G * 8)
    p_rows = 0 if bf16 else 4 * TILE * MAX_G * 4
    return region + 128 + MAX_G * (hdp + 8) * 4 + 1024 + p_rows + 1024


def split_plan(n_pos: int, blocks: int, sms: int, G: int = 4,
               hd: int = 128, elem_bytes: int = 2) -> Tuple[int, int, int]:
    """(tiles per range, ranges, ring stages) for ``n_pos`` positions over
    ``blocks`` (b, kv head) pairs: whole 64-position tiles, ranges enough
    for every block slot of the card to hold one block (slots per SM from
    the shared memory a block needs), never an empty range, and no more
    ranges than keep the float32 partials (G x (hd + 2) per range) within
    PARTIAL_SHARE of the K and V bytes."""
    tiles = -(-n_pos // TILE)
    stages = STAGES
    while stages > 1 and smem_bytes(elem_bytes, hd, stages) > MAX_SMEM_BYTES:
        stages -= 1
    per_sm = max(1, SM_SMEM_BYTES // (smem_bytes(elem_bytes, hd, stages)
                                      + 1024))
    per = max(1, -(-tiles * blocks // (sms * per_sm)))
    kv_bytes = 2 * n_pos * hd * elem_bytes
    cap = max(1, min(MAX_SPLITS, int(PARTIAL_SHARE * kv_bytes
                                      // (G * (hd + 2) * 4))))
    per = max(per, -(-tiles // cap))
    nsplit = -(-tiles // per)
    return per, nsplit, min(stages, per)


def map_key(t: torch.Tensor) -> tuple:
    """What a tensor map of a contiguous cache depends on."""
    return (t.data_ptr(), tuple(t.shape), t.dtype)


def workspace_key(device: torch.device) -> tuple:
    return (device.type, device.index)


def workspace(device: torch.device, n_floats: int, n_counters: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device's float32 partials and int32 counters, allocated once
    and grown when a call needs more; the counters start at 0 and every
    launch leaves them at 0."""
    key = workspace_key(device)
    parts, counts = _WORKSPACE.get(key, (None, None))
    if parts is None or parts.numel() < n_floats:
        parts = torch.empty(max(n_floats, 1), dtype=torch.float32,
                            device=device)
    if counts is None or counts.numel() < n_counters:
        counts = torch.zeros(max(n_counters, 1), dtype=torch.int32,
                             device=device)
    _WORKSPACE[key] = (parts, counts)
    return parts, counts


def _fns():
    """The library's C entry points, their argument types bound once."""
    global _FNS
    if _FNS is None:
        lib = build.library("flash_decode")
        enc = lib.flash_decode_encode_map
        enc.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        enc.restype = ctypes.c_int
        smem = lib.flash_decode_smem
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_int
        run = lib.flash_decode_launch
        run.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                        + [ctypes.c_int] * 9
                        + [ctypes.c_float, ctypes.c_void_p])
        run.restype = ctypes.c_int
        _FNS = (enc, smem, run)
    return _FNS


def tensor_map(t: torch.Tensor) -> ctypes.Array:
    """The 128-byte TMA map of a contiguous (B, S, KV, hd) cache on the
    card, encoded once per ``map_key``."""
    key = map_key(t)
    blob = _MAPS.get(key)
    if blob is None:
        blob = ctypes.create_string_buffer(128)
        B, S, KV, hd = t.shape
        err = _fns()[0](_DTYPES[t.dtype], t.data_ptr(), B, S, KV, hd, blob)
        if err != 0:
            raise RuntimeError(f"flash_decode tensor map encoding failed: "
                               f"error {err}")
        _MAPS[key] = blob
        if len(_MAPS) > MAP_CACHE_SIZE:
            _MAPS.popitem(last=False)
    else:
        _MAPS.move_to_end(key)
    return blob


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_valid_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: q (B, 1, H, hd), k and v
    (B, S, KV, hd), one dtype (float32 or bfloat16), contiguous on one
    card, H a multiple of KV with G = H / KV <= 16, hd a multiple of 16
    (bfloat16) or 4 (float32) up to 256, valid length >= 0 -> (out
    (B, 1, H, hd) in q's dtype, m, l (B, KV, G, 1) float32)."""
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
    step = 16 if q.dtype == torch.bfloat16 else 4
    if hd % step or hd > MAX_HD:
        raise ValueError(f"head_dim {hd} must be a multiple of {step} up to "
                         f"{MAX_HD} for {q.dtype}")
    G = H // KV
    if G > MAX_G:
        raise ValueError(f"{G} query heads per kv head; the kernel takes "
                         f"at most {MAX_G}")
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
    n_pos = min(n, S) if n > 0 else S
    per, nsplit, stages = split_plan(n_pos, B * KV, sm_count(dev), G, hd,
                                     q.element_size())
    out = torch.empty_like(q)
    m = torch.empty((B, KV, G, 1), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    n_part = B * KV * nsplit * G * hd if nsplit > 1 else 0
    parts, counts = workspace(dev, n_part + 2 * n_part // hd, B * KV)
    kmap, vmap = tensor_map(k), tensor_map(v)
    err = _fns()[2](_DTYPES[q.dtype], kmap, vmap, q.data_ptr(), out.data_ptr(),
              m.data_ptr(), l.data_ptr(), parts.data_ptr(),
              parts.data_ptr() + 4 * n_part, counts.data_ptr(), B, KV, G, hd,
              n, n_pos, per, nsplit, stages,
              float(np.float32(1.0 / np.sqrt(hd))),
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
