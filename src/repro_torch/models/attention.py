"""GQA attention with a chunked (flash-style) prefill and a one-token
decode over a read-only KV cache (``repro.models.attention`` in PyTorch).

``chunked_attention`` is the plain online-softmax over query and KV
chunks with float32 accumulators (no Pallas kernel in JAX either).  The
decode reads the cache below ``pos`` and merges the fresh token's (k1,
v1) outside it: through ``decode_attention_with_new`` (plain), or with
``use_kernel=True`` through ``kernels/flash_decode`` (the CUDA kernel on
the card, its plain version on the CPU).  Layouts are JAX's: q
``(B, 1, H, hd)``, a cache view ``(B, S, KV, hd)``, the cache itself
``k``/``v`` of shape ``(B, S, KV*hd)``.  The int8 cache
(``kv_cache_dtype="int8"``) stores int8 ``k``/``v`` with one bfloat16
scale per (position, kv head) in ``k_scale``/``v_scale`` (B, S, KV); the
decode dequantises the whole cache in the model dtype and attends over
that view, through the kernel too.  ``cross_attention`` (the vlm's image
layers, the audio decoder) is not causal and has no rope; its decode
(``decode_cross_attention``) attends over a fixed cross cache, every
position valid; ``decode_cross_attention_split`` does so over a rank's
range of the positions (JAX's long-context layout cuts them over
"data"), the ranges merged.

On the LM mesh the ``*_tp`` functions run a dense block's attention with
tensor parallelism over "model" (``TP``).  Training and prefill run on
this rank's heads when the q and kv heads both divide over "model";
otherwise q, k and v are gathered over "model" (backward: reduce-scatter)
and every rank attends over all heads, keeping its own columns for the
row-parallel ``o``, whose product is summed over "model".  The decode
keeps JAX's cache layout (``launch/specs.py::cache_shardings``): the
sequence is cut over "model", each rank holds positions [r S/n, (r+1)
S/n) of every kv head.  q and the fresh k1/v1 are gathered over "model",
each rank runs flash-decode over its slice with the valid length
``clamp(pos - r S/n, 0, S/n)``, the ranks' (out, m, l) are merged over
"model" (``flash_decode.ops.merge_ranges``) and the fresh token is added
once (``merge_new``); the rank that owns position ``pos`` writes it.
Prefill writes each rank its slice of the positions.

Cross-attention under tensor parallelism (``cross_attention_tp``: the
vlm's image layers, the audio decoder) takes this rank's q heads from x
and its kv heads from ``kv_src`` (gathered when the heads do not divide),
with ``o`` row-parallel.  Its fixed cross cache keeps JAX's layout, which
``cache_shardings`` picks by shape: the kv features cut over "model"
when the cache's length is not the call's ``max_seq`` (each rank decodes
over its kv heads with flash-decode, ``decode_cross_attention_tp``), its
positions cut when it is (flash-decode over each rank's range, merged),
whole otherwise.  ``take`` reads the columns (or rows) a rank needs of a
weight that is cut over "model" or held whole: its own piece as held, or
the weight gathered (backward: reduce-scatter) or read through
Megatron's f, so that the gradient of every column is summed over the
ranks that used it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.models.layers import (apply_rope, dtype_of, linear,
                                       linear_defs)
from repro_torch.sharding import comm

NEG_INF = -1e30
F32 = torch.float32


def attn_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """q/k/v/o projections; cross-attention takes the same (its keys and
    values come from d_model-wide states too)."""
    d, hd, dt, b = cfg.d_model, cfg.resolved_head_dim, dtype_of(cfg), \
        cfg.qkv_bias
    qf, kvf = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return {"q": linear_defs(d, qf, dt, bias=b, axes=("embed", "heads"),
                             bias_axis="heads"),
            "k": linear_defs(d, kvf, dt, bias=b, axes=("embed", "kv_heads"),
                             bias_axis="kv_heads"),
            "v": linear_defs(d, kvf, dt, bias=b, axes=("embed", "kv_heads"),
                             bias_axis="kv_heads"),
            "o": linear_defs(qf, d, dt, axes=("heads", "embed"))}


# -- chunked attention core ------------------------------------------------------

def _pad_to(x: torch.Tensor, axis: int, mult: int) -> Tuple[torch.Tensor, int]:
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x, size
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), size


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0,
                      kv_valid_len: Optional[int] = None,
                      q_chunk: int = 512, kv_chunk: int = 2048
                      ) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd) -> (B,Sq,H,hd).

    Online softmax over KV chunks for each query chunk; GQA grouping via
    a (KV, G) head split; float32 scores and accumulators."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    q, true_sq = _pad_to(q, 1, qc)
    k, true_skv = _pad_to(k, 1, kc)
    v, _ = _pad_to(v, 1, kc)
    nq, nk = q.shape[1] // qc, k.shape[1] // kc
    valid_len = true_skv if kv_valid_len is None else kv_valid_len
    dev = q.device
    outs = []
    for iq in range(nq):
        qi = q[:, iq * qc:(iq + 1) * qc].reshape(B, qc, KV, G, hd).to(F32)
        q_pos = q_offset + iq * qc + torch.arange(qc, device=dev)
        m = torch.full((B, qc, KV, G), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((B, qc, KV, G), dtype=F32, device=dev)
        acc = torch.zeros((B, qc, KV, G, hd), dtype=F32, device=dev)
        for ik in range(nk):
            ki = k[:, ik * kc:(ik + 1) * kc].to(F32)
            vi = v[:, ik * kc:(ik + 1) * kc].to(F32)
            kv_pos = ik * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqkgd,bskd->bqkgs", qi, ki) * scale
            mask = kv_pos[None, :] < valid_len            # (1,kc) padding
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            s = torch.where(mask[None, :, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgs,bskd->bqkgd", p, vi)
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=1).reshape(B, nq * qc, H, hd)
    return out[:, :true_sq]


def _mask_scores(s: torch.Tensor, kv_valid_len: int) -> torch.Tensor:
    pos = torch.arange(s.shape[-1], device=s.device)
    return torch.where(pos < kv_valid_len, s, torch.full_like(s, NEG_INF))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_valid_len: int) -> torch.Tensor:
    """Single-position attention: q (B,1,H,hd), k/v (B,S,KV,hd).  q and p
    are rounded to the cache dtype and the products summed in float32
    (JAX's ``preferred_element_type``); softmax in float32."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).to(k.dtype).to(F32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.to(F32)) * scale
    p = torch.softmax(_mask_scores(s, kv_valid_len), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).to(F32), v.to(F32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_with_new(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, k1: torch.Tensor,
                              v1: torch.Tensor, *, kv_valid_len: int
                              ) -> torch.Tensor:
    """Decode attention over the old cache (< kv_valid_len) plus one fresh
    (k1, v1) token, without writing it into the cache.
    q (B,1,H,hd); k/v (B,S,KV,hd); k1/v1 (B,1,KV,hd)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).to(k.dtype).to(F32)
    s_old = _mask_scores(
        torch.einsum("bkgd,bskd->bkgs", qg, k.to(F32)) * scale, kv_valid_len)
    s_new = torch.einsum("bkgd,bskd->bkgs", qg,
                         k1.to(k.dtype).to(F32)) * scale     # (B,KV,G,1)
    m = torch.maximum(torch.amax(s_old, dim=-1, keepdim=True), s_new)
    p_old = torch.exp(s_old - m)
    p_new = torch.exp(s_new - m)
    denom = torch.sum(p_old, dim=-1, keepdim=True) + p_new
    out = (torch.einsum("bkgs,bskd->bkgd",
                        (p_old / denom).to(v.dtype).to(F32), v.to(F32))
           + (p_new / denom) * v1.reshape(B, KV, 1, hd).to(F32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


# -- attention layer (projections + rope + cache) ------------------------------

def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _qkv(cfg: ModelConfig, params, x: torch.Tensor, positions: torch.Tensor):
    hd = cfg.resolved_head_dim
    q = _split_heads(linear(params["q"], x), cfg.num_heads, hd)
    k = _split_heads(linear(params["k"], x), cfg.num_kv_heads, hd)
    v = _split_heads(linear(params["v"], x), cfg.num_kv_heads, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def self_attention(cfg: ModelConfig, params, x: torch.Tensor, *,
                   positions: Optional[torch.Tensor] = None,
                   causal: bool = True, q_chunk: int = 512,
                   kv_chunk: int = 2048) -> torch.Tensor:
    """Full-sequence self attention."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(cfg, params, x, positions)
    out = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
    return linear(params["o"], out.reshape(B, S, -1))


def cross_attention(cfg: ModelConfig, params, x: torch.Tensor,
                    kv_src: torch.Tensor, *, q_chunk: int = 512,
                    kv_chunk: int = 2048) -> torch.Tensor:
    """x (B, S, d) attends to kv_src (B, Skv, d): encoder states or image
    patch embeddings."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _split_heads(linear(params["q"], x), cfg.num_heads, hd)
    k = _split_heads(linear(params["k"], kv_src), cfg.num_kv_heads, hd)
    v = _split_heads(linear(params["v"], kv_src), cfg.num_kv_heads, hd)
    out = chunked_attention(q, k, v, causal=False, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
    return linear(params["o"], out.reshape(B, S, -1))


def decode_cross_attention(cfg: ModelConfig, params, x: torch.Tensor,
                           cache: Dict[str, torch.Tensor],
                           use_kernel: bool = False) -> torch.Tensor:
    """One query position x (B, 1, d) over a fixed cross cache k/v
    (B, Skv, KV*hd), every position valid: ``decode_attention`` (plain,
    JAX's route) or the flash-decode kernel."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = _split_heads(linear(params["q"], x), cfg.num_heads, hd)
    k = cache["k"].reshape(B, -1, cfg.num_kv_heads, hd)
    v = cache["v"].reshape(B, -1, cfg.num_kv_heads, hd)
    if use_kernel:
        out = fd_ops.flash_decode(q, k, v, kv_valid_len=k.shape[1])[0]
    else:
        out = decode_attention(q, k, v, kv_valid_len=k.shape[1])
    return linear(params["o"], out.reshape(B, 1, -1))


def decode_cross_attention_split(cfg: ModelConfig, params, x: torch.Tensor,
                                 cache: Dict[str, torch.Tensor], split,
                                 use_kernel: bool = False) -> torch.Tensor:
    """``decode_cross_attention`` over this rank's range of a cross cache
    whose positions are cut over ``split``'s axis (JAX's long-context
    layout cuts them over "data"), every position valid: flash-decode
    (the kernel, or its plain version) over the range, the ranges merged
    over the axis (``fd_ops.merge_ranges``)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = _split_heads(linear(params["q"], x), cfg.num_heads, hd)
    k = cache["k"].reshape(B, -1, cfg.num_kv_heads, hd)
    v = cache["v"].reshape(B, -1, cfg.num_kv_heads, hd)
    stats = fd_ops.flash_decode if use_kernel else fd_ref.flash_decode_ref
    out, m, l = stats(q, k, v, kv_valid_len=k.shape[1])
    out, m, l = fd_ops.merge_ranges(
        out, m, l, lambda t: comm.all_max(t, split.group),
        lambda t: comm.all_reduce(t, split.group))
    out = out.reshape(q.shape).to(q.dtype)
    return linear(params["o"], out.reshape(B, 1, -1))


def kv_cache_defs(cfg: ModelConfig, batch: int, max_seq: int
                  ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{"k", "v"}: ((batch, max_seq, KV*hd), the model dtype); the int8
    cache: int8 ``k``/``v`` and bfloat16 ``k_scale``/``v_scale`` of shape
    (batch, max_seq, KV)."""
    kvf = cfg.num_kv_heads * cfg.resolved_head_dim
    if cfg.kv_cache_dtype == "int8":
        q = ((batch, max_seq, kvf), torch.int8)
        s = ((batch, max_seq, cfg.num_kv_heads), torch.bfloat16)
        return {"k": q, "v": q, "k_scale": s, "v_scale": s}
    spec = ((batch, max_seq, kvf), dtype_of(cfg))
    return {"k": spec, "v": spec}


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, KV, hd) -> (int8 values, per-(token, head) bfloat16
    scales): divided by the float32 scale, rounded half to even."""
    x = x.to(F32)
    scale = torch.amax(torch.abs(x), dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, kv_heads: int,
                   hd: int, dt: torch.dtype) -> torch.Tensor:
    """(B, S, kvf) int8 and (B, S, KV) scales -> (B, S, KV, hd), the
    product taken in ``dt`` (the model dtype)."""
    B, S, _ = q.shape
    return q.reshape(B, S, kv_heads, hd).to(dt) * scale[..., None].to(dt)


def _cache_entries(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """Cache entries of k/v (B, S, KV, hd): flat (B, S, kvf), quantised
    with their scales for the int8 cache."""
    B, S = k.shape[:2]
    if cfg.kv_cache_dtype == "int8":
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        return {"k": kq.reshape(B, S, -1), "v": vq.reshape(B, S, -1),
                "k_scale": ks, "v_scale": vs}
    return {"k": k.reshape(B, S, -1), "v": v.reshape(B, S, -1)}


def prefill_self_attention(cfg: ModelConfig, params, x: torch.Tensor,
                           max_seq: int, **chunks
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal self-attention over the prompt; returns the output and the
    prompt's cache entries zero-padded to ``max_seq``."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(cfg, params, x, positions)
    out = chunked_attention(q, k, v, causal=True, **chunks)
    out = linear(params["o"], out.reshape(B, S, -1))
    cache = {}
    for name, t in _cache_entries(cfg, k, v).items():
        buf = t.new_zeros((B, max_seq) + tuple(t.shape[2:]))
        buf[:, :S] = t
        cache[name] = buf
    return out, cache


def _cache_kv(cfg: ModelConfig, cache: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache's k and v as (B, S, KV, hd) in the model dtype (the int8
    cache dequantised)."""
    B, S = cache["k"].shape[:2]
    hd = cfg.resolved_head_dim
    if cfg.kv_cache_dtype == "int8":
        dt = dtype_of(cfg)
        return (_dequantize_kv(cache["k"], cache["k_scale"],
                               cfg.num_kv_heads, hd, dt),
                _dequantize_kv(cache["v"], cache["v_scale"],
                               cfg.num_kv_heads, hd, dt))
    return (cache["k"].reshape(B, S, cfg.num_kv_heads, hd),
            cache["v"].reshape(B, S, cfg.num_kv_heads, hd))


def decode_self_attention_read(cfg: ModelConfig, params, x: torch.Tensor,
                               cache: Dict[str, torch.Tensor], pos: int,
                               use_kernel: bool = False
                               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode that only READS the cache: attends over the cache
    below ``pos`` plus the fresh token, and returns the fresh (k1, v1)
    cache entries for the caller to write.

    x (B,1,d); cache k/v (B,S,kvf) (and the int8 cache's scales, the
    whole cache dequantised first).  Returns (attn_out, {"k": k1
    (B,1,kvf), "v": v1, and for the int8 cache their scales})."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    positions = torch.full((B, 1), pos, device=x.device)
    q, k1, v1 = _qkv(cfg, params, x, positions)
    k, v = _cache_kv(cfg, cache)
    attend = (fd_ops.flash_decode_with_new if use_kernel
              else decode_attention_with_new)
    out = attend(q, k, v, k1, v1, kv_valid_len=pos)
    out = linear(params["o"], out.reshape(B, 1, -1))
    return out, _cache_entries(cfg, k1, v1)


def decode_self_attention(cfg: ModelConfig, params, x: torch.Tensor,
                          cache: Dict[str, torch.Tensor], pos: int,
                          use_kernel: bool = False
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """As ``decode_self_attention_read``, then writes the fresh token into
    ``cache`` at ``pos`` in place and returns it."""
    out, new_tok = decode_self_attention_read(cfg, params, x, cache, pos,
                                              use_kernel)
    for name, t in new_tok.items():
        cache[name][:, pos] = t[:, 0].to(cache[name].dtype)
    return out, cache


# -- tensor parallelism over "model" (the LM mesh) ---------------------------------

class TP(NamedTuple):
    """One rank's place in a dense block's tensor parallelism."""
    group: Any            # the "model" process group (None: one rank)
    n: int                # ranks of "model"
    r: int                # this rank's index on "model"
    local_heads: bool     # q and kv heads divide over n


def _merged(ranges) -> list:
    out: list = []
    for lo, hi in ranges:
        if hi <= lo:
            continue
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def cols(t: torch.Tensor, dim: int, ranges) -> torch.Tensor:
    """The elements of ``ranges`` ([lo, hi) pairs, in order) along
    ``dim``: a view when they are one range, ``t`` itself when that range
    is all of it."""
    ranges = _merged(ranges)
    if ranges == [(0, t.shape[dim])]:
        return t
    parts = [t.narrow(dim, lo, hi - lo) for lo, hi in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def take(w: torch.Tensor, dim: int, ranges, full: int, tp: TP
         ) -> torch.Tensor:
    """``cols`` of a weight whose ``dim`` (``full`` wide) is cut over
    "model" when this rank holds less of it: the rank's own piece as
    held when the ranges are just that, else the weight gathered over
    "model" (backward: reduce-scatter) or, held whole, read through f
    (backward: the sum over "model")."""
    ranges = _merged(ranges)
    if w.shape[dim] != full:
        k = w.shape[dim]
        if ranges == [(tp.r * k, (tp.r + 1) * k)]:
            return w
        w = comm.gather_dim(w, dim, tp.group)
    else:
        w = comm.copy_to_model(w, tp.group)
    return cols(w, dim, ranges)


def heads_of(H: int, tp: TP) -> Tuple[int, int]:
    """This rank's heads [h0, h1) of ``H``: its ``H / n`` when they divide
    over "model", else every head (each rank computes all of them)."""
    if H % tp.n:
        return 0, H
    k = H // tp.n
    return tp.r * k, (tp.r + 1) * k


def share_of(F: int, tp: TP) -> Tuple[int, int]:
    """This rank's features [lo, hi) of ``F`` for a row-parallel product
    (``F / n`` each when they divide)."""
    return F * tp.r // tp.n, F * (tp.r + 1) // tp.n


def whole_heads(t: torch.Tensor, dim: int, H: int, tp: TP) -> torch.Tensor:
    """A tensor of this rank's heads along ``dim`` (``heads_of(H)``) ->
    every head (an all-gather over "model" when the heads are cut)."""
    return t if H % tp.n else comm.all_gather(t, dim, tp.group)


def _qkv_tp(cfg: ModelConfig, params, x: torch.Tensor,
            positions: torch.Tensor, tp: TP):
    """q, k, v (B, S, heads, hd) with rope: this rank's heads, or every
    head (gathered over "model") when the heads do not divide."""
    hd = cfg.resolved_head_dim
    xf = comm.copy_to_model(x, tp.group)
    q, k, v = (linear(params[n], xf) for n in ("q", "k", "v"))
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if tp.local_heads:
        H, KV = H // tp.n, KV // tp.n
    else:
        q, k, v = (comm.gather_dim(t, -1, tp.group) for t in (q, k, v))
    q, k, v = _split_heads(q, H, hd), _split_heads(k, KV, hd), \
        _split_heads(v, KV, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _o_tp(params, out: torch.Tensor, tp: TP, whole: bool) -> torch.Tensor:
    """The row-parallel ``o`` over this rank's columns of ``out``
    (``whole``: out holds every head, keep this rank's share), summed over
    "model"."""
    if whole and tp.n > 1:
        f = out.shape[-1] // tp.n
        out = out[..., tp.r * f:(tp.r + 1) * f]
    return comm.reduce_from_model(linear(params["o"], out), tp.group)


def self_attention_tp(cfg: ModelConfig, params, x: torch.Tensor, tp: TP, *,
                      causal: bool = True) -> torch.Tensor:
    """``self_attention`` with tensor parallelism over "model"."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv_tp(cfg, params, x, positions, tp)
    out = chunked_attention(q, k, v, causal=causal)
    return _o_tp(params, out.reshape(B, S, -1), tp, not tp.local_heads)


def _all_heads(t: torch.Tensor, tp: TP) -> torch.Tensor:
    """(B, S, heads, hd) of this rank's heads -> every head."""
    return comm.all_gather(t, 2, tp.group) if tp.local_heads else t


class Split(NamedTuple):
    """A cache's positions cut over one mesh axis: this rank holds
    positions [r S/n, (r+1) S/n) of every kv head.  The axis is "model"
    under tensor parallelism, and "data" when the data-parallel axes do
    not divide the cache's batch (JAX's long-context layout)."""
    group: Any
    n: int
    r: int


def split_of(tp: TP) -> Split:
    """The positions cut over "model" of tensor parallelism ``tp``."""
    return Split(tp.group, tp.n, tp.r)


def prefill_self_attention_split(cfg: ModelConfig, params, x: torch.Tensor,
                                 max_seq: int, split: Split,
                                 tp: Optional[TP] = None
                                 ) -> Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """``prefill_self_attention`` (with tensor parallelism over "model"
    when ``tp``); the cache entries of every kv head at this rank's
    positions of ``split``."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    if tp is None:
        q, k, v = _qkv(cfg, params, x, positions)
        out = chunked_attention(q, k, v, causal=True)
        out = linear(params["o"], out.reshape(B, S, -1))
    else:
        q, k, v = _qkv_tp(cfg, params, x, positions, tp)
        out = chunked_attention(q, k, v, causal=True)
        out = _o_tp(params, out.reshape(B, S, -1), tp, not tp.local_heads)
        k, v = _all_heads(k, tp), _all_heads(v, tp)
    n_loc = max_seq // split.n
    r0 = split.r * n_loc
    lo, hi = min(r0, S), min(r0 + n_loc, S)
    cache = {}
    for name, t in _cache_entries(cfg, k, v).items():
        buf = t.new_zeros((B, n_loc) + tuple(t.shape[2:]))
        if hi > lo:
            buf[:, lo - r0:hi - r0] = t[:, lo:hi]
        cache[name] = buf
    return out, cache


def decode_self_attention_read_split(cfg: ModelConfig, params,
                                     x: torch.Tensor,
                                     cache: Dict[str, torch.Tensor],
                                     pos: int, split: Split,
                                     tp: Optional[TP] = None,
                                     use_kernel: bool = False):
    """``decode_self_attention_read`` over this rank's positions of the
    cache (``split``; every head, gathered over "model" under tensor
    parallelism ``tp``): flash-decode (the kernel, or its plain version)
    over the slice's valid positions, the ranges merged over the split's
    axis, the fresh token merged once.  Returns (attn_out, the fresh
    cache entries, the local position to write them at: None on a rank
    that does not own ``pos``)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    if tp is None:
        q, k1, v1 = _qkv(cfg, params, x, positions)
    else:
        q, k1, v1 = (_all_heads(t, tp)
                     for t in _qkv_tp(cfg, params, x, positions, tp))
    k, v = _cache_kv(cfg, cache)
    n_loc = k.shape[1]
    r0 = split.r * n_loc
    stats = fd_ops.flash_decode if use_kernel else fd_ref.flash_decode_ref
    out, m, l = stats(q, k, v, kv_valid_len=min(max(pos - r0, 0), n_loc))
    out, m, l = fd_ops.merge_ranges(
        out, m, l, lambda t: comm.all_max(t, split.group),
        lambda t: comm.all_reduce(t, split.group))
    out = fd_ops.merge_new(q, k1, v1, out.reshape(q.shape), m, l)
    out = out.reshape(B, 1, -1)
    out = (linear(params["o"], out) if tp is None
           else _o_tp(params, out, tp, True))
    local = pos - r0 if 0 <= pos - r0 < n_loc else None
    return out, _cache_entries(cfg, k1, v1), local


def cross_attention_tp(cfg: ModelConfig, params, x: torch.Tensor,
                       kv_src: torch.Tensor, tp: TP) -> torch.Tensor:
    """``cross_attention`` with tensor parallelism over "model": this
    rank's q heads of x and kv heads of ``kv_src`` (every head, gathered,
    when they do not divide), ``o`` row-parallel."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    xf = comm.copy_to_model(x, tp.group)
    kf = comm.copy_to_model(kv_src, tp.group)
    q = linear(params["q"], xf)
    k, v = linear(params["k"], kf), linear(params["v"], kf)
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if tp.local_heads:
        H, KV = H // tp.n, KV // tp.n
    else:
        q, k, v = (comm.gather_dim(t, -1, tp.group) for t in (q, k, v))
    out = chunked_attention(_split_heads(q, H, hd), _split_heads(k, KV, hd),
                            _split_heads(v, KV, hd), causal=False)
    return _o_tp(params, out.reshape(B, S, -1), tp, not tp.local_heads)


def cross_cut(shape, max_seq: int, tp: TP) -> Optional[int]:
    """The dim of a per-layer cache leaf (batch first) that JAX's
    ``cache_shardings`` cuts over "model": the last dim of length
    ``max_seq`` when there is one (cut when ``max_seq`` divides), else the
    last one that "model" divides; None when none is cut."""
    seq = next((i for i in range(len(shape) - 1, 0, -1)
                if shape[i] == max_seq), None)
    if seq is not None:
        return seq if max_seq % tp.n == 0 else None
    return next((i for i in range(len(shape) - 1, 0, -1)
                 if shape[i] % tp.n == 0 and shape[i] >= tp.n), None)


def cross_kv_tp(cfg: ModelConfig, params, kv_src: torch.Tensor,
                max_seq: int, tp: TP) -> Dict[str, torch.Tensor]:
    """This rank's piece of the fixed cross cache of ``kv_src`` (B, Skv,
    d): k and v (B, Skv, KV*hd) laid out as ``cross_cut`` says (the
    features cut: this rank's columns of k and v, as computed)."""
    kvf = cfg.num_kv_heads * cfg.resolved_head_dim
    B, Skv = kv_src.shape[:2]
    cut = cross_cut((B, Skv, kvf), max_seq, tp)
    out = {}
    for name in ("k", "v"):
        t = linear(params[name], kv_src)
        if cut != 2:
            t = comm.all_gather(t, 2, tp.group)
            if cut is not None:
                k = t.shape[cut] // tp.n
                t = t.narrow(cut, tp.r * k, k)
        out[name] = t
    return out


def decode_cross_attention_tp(cfg: ModelConfig, params, x: torch.Tensor,
                              cache: Dict[str, torch.Tensor], max_seq: int,
                              tp: TP, use_kernel: bool = False
                              ) -> torch.Tensor:
    """``decode_cross_attention`` over this rank's piece of a cross cache
    laid out for ``max_seq`` (``cross_kv_tp``): over its kv heads with its
    q heads (flash-decode on the local heads), over its range of
    positions (the ranges merged over "model"), or over the whole cache
    gathered; ``o`` row-parallel.  The piece says the layout: its kv
    features are cut, or else (under tensor parallelism "model" divides
    both the features and ``max_seq``) its positions are."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    kvf = cfg.num_kv_heads * hd
    xf = comm.copy_to_model(x, tp.group)
    q = linear(params["q"], xf)
    H = cfg.num_heads
    if tp.local_heads:
        H //= tp.n
    else:
        q = comm.gather_dim(q, -1, tp.group)
    q = _split_heads(q, H, hd)
    k, v = cache["k"], cache["v"]
    cut = (2 if k.shape[-1] != kvf
           else cross_cut((B, k.shape[1] * tp.n, kvf), max_seq, tp))
    local = cut == 2 and tp.local_heads     # its kv heads, its q heads'
    if not local:
        q = _all_heads(q, tp)
        if cut == 1:
            k, v = (t.reshape(B, -1, cfg.num_kv_heads, hd) for t in (k, v))
            stats = (fd_ops.flash_decode if use_kernel
                     else fd_ref.flash_decode_ref)
            out, m, l = stats(q, k, v, kv_valid_len=k.shape[1])
            out, m, l = fd_ops.merge_ranges(
                out, m, l, lambda t: comm.all_max(t, tp.group),
                lambda t: comm.all_reduce(t, tp.group))
            out = out.reshape(q.shape).to(q.dtype)
            return _o_tp(params, out.reshape(B, 1, -1), tp, True)
        if cut is not None:
            k, v = (comm.all_gather(t, cut, tp.group) for t in (k, v))
    k, v = (t.reshape(B, -1, t.shape[-1] // hd, hd) for t in (k, v))
    if use_kernel:
        out = fd_ops.flash_decode(q, k, v, kv_valid_len=k.shape[1])[0]
    else:
        out = decode_attention(q, k, v, kv_valid_len=k.shape[1])
    return _o_tp(params, out.reshape(B, 1, -1), tp, not local)
