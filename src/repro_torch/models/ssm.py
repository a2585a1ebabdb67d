"""Mamba-2 (SSD) block: the chunked parallel form for training and
prefill, the recurrent step for decode (``repro.models.ssm`` in PyTorch).

Scalar decay A per head, a per-step dt, shared B/C projections (one
group), a causal depthwise conv on the SSM input and a gated output.
The chunked form keeps the quadratic term at O(chunk^2) and carries an
(H, N, P) state across chunks; JAX's ``lax.scan`` over chunks is a
Python loop.  Two roundings are JAX's and kept: the full-sequence conv
(``_causal_conv``) sums its taps in float32 and rounds to the model dtype
before the SiLU; the decode's conv (``decode_mamba2``) does not round.

Under tensor parallelism over "model" (``*_tp``) the weights stay in
JAX's layout: ``in_proj``'s output features ``[z | x | B | C | dt]`` cut
over "model" (a cut that crosses the segments), ``out_proj``'s rows cut
at head boundaries.  Each rank gathers ``in_proj``'s cut (backward:
reduce-scatter), computes B and C and its own heads' z, x and dt, runs
the conv and ``ssd_chunked`` on its heads only, and ``out_proj`` is
row-parallel, one all-reduce a layer.  When the heads do not divide over
"model" every rank computes every head and keeps its share of the
features for the row-parallel product.  The recurrent states (full
sequence or decode) come back whole: the heads' pieces all-gathered.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import ParamDef
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.sharding import comm

F32 = torch.float32


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.head_dim, s.state_size


def mamba2_defs(cfg: ModelConfig) -> Dict[str, Any]:
    s = cfg.ssm
    d, dt = cfg.d_model, L.dtype_of(cfg)
    d_in, H, Pd, N = _dims(cfg)
    # in_proj emits [z (d_in), x (d_in), B (N), C (N), dt (H)]
    d_proj = 2 * d_in + 2 * N + H
    return {
        "in_proj": ParamDef((d, d_proj), "normal", dtype=dt,
                            logical_axes=("embed", "mlp")),
        "conv_w": ParamDef((s.conv_width, d_in + 2 * N), "normal", 0.5, dt,
                           ("conv", None)),
        "A_log": ParamDef((H,), "zeros", dtype=F32, logical_axes=("state",)),
        "D": ParamDef((H,), "ones", dtype=F32, logical_axes=("state",)),
        "dt_bias": ParamDef((H,), "zeros", dtype=F32,
                            logical_axes=("state",)),
        "out_proj": ParamDef((d_in, d), "normal", dtype=dt,
                             logical_axes=("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,C), w (K,C); float32 taps, rounded
    to x's dtype."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S, :].to(F32) * w[i].to(F32)
    return out.to(x.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q) lower-triangular pairwise sums."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full_like(diff, -float("inf")))


def _proj_split(params, x: torch.Tensor, dims):
    d_in, H, Pd, N = dims
    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * N, H], dim=-1)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"]).to(F32))
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = F.softplus(dt.to(F32) + params["dt_bias"])             # (B,S,H)
    A = -torch.exp(params["A_log"])                              # (H,)
    return z, xs, Bm, Cm, dt, A


def ssd_chunked(xs, Bm, Cm, dt, A, *, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD.  xs (B,S,H,P); Bm/Cm (B,S,N); dt (B,S,H); A (H,).
    Returns y (B,S,H,P) float32 and the final state (B,H,N,P)."""
    B, S, H, Pd = xs.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm, Cm, dt = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm, dt))
    nc, Q = xs.shape[1] // chunk, chunk
    xs = xs.reshape(B, nc, Q, H, Pd)
    Bm = Bm.reshape(B, nc, Q, N)
    Cm = Cm.reshape(B, nc, Q, N)
    dt = dt.reshape(B, nc, Q, H)
    dA = dt * A                                                  # (B,nc,Q,H)
    dA_cs = torch.cumsum(dA, dim=2)                              # within-chunk
    # diagonal (within-chunk) term
    Lmat = torch.exp(_segsum(dA.transpose(-1, -2)))              # (B,nc,H,Q,Q)
    CB = torch.einsum("bcqn,bckn->bcqk", Cm, Bm)                 # (B,nc,Q,Q)
    xdt = xs * dt[..., None]                                     # (B,nc,Q,H,P)
    y_diag = torch.einsum("bcqk,bchqk,bckhp->bcqhp", CB, Lmat, xdt)
    # chunk-final states
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)        # (B,nc,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bm, dt * decay_to_end,
                          xs)
    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                  # (B,nc,H)
    s = (torch.zeros((B, H, N, Pd), dtype=F32, device=xs.device)
         if init_state is None else init_state.to(F32))
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c].to(F32)
    s_in = torch.stack(s_in, dim=1)                              # (B,nc,H,N,P)
    decay_from_start = torch.exp(dA_cs)                          # (B,nc,Q,H)
    y_off = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cm, decay_from_start, s_in)
    y = (y_diag + y_off).reshape(B, nc * Q, H, Pd)
    return y[:, :S], s


def _gated_out(params, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
               dt: torch.dtype, share=None) -> torch.Tensor:
    """y + D x, gated by silu(z), through out_proj (the features
    [lo, hi) of ``share`` only)."""
    B, S = y.shape[:2]
    y = y + params["D"][None, None, :, None] * xs.to(F32)
    y = y.reshape(B, S, -1) * F.silu(z.to(F32))
    if share is not None:
        y = y[..., share[0]:share[1]]
    return y.to(dt) @ params["out_proj"]


def apply_mamba2_with_state(cfg: ModelConfig, params, x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass x (B,S,d) -> (out, final SSD state)."""
    d_in, H, Pd, N = _dims(cfg)
    B, S, _ = x.shape
    z, xs, Bm, Cm, dt, A = _proj_split(params, x, _dims(cfg))
    xs = xs.reshape(B, S, H, Pd)
    y, s_fin = ssd_chunked(xs, Bm, Cm, dt, A, chunk=cfg.ssm.chunk_size)
    return _gated_out(params, y, xs, z, x.dtype), s_fin


def apply_mamba2(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Training / prefill-style full-sequence pass.  x: (B,S,d)."""
    return apply_mamba2_with_state(cfg, params, x)[0]


def conv_tail(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """The conv input of the last K-1 positions of x (B,S,d) for a decode
    that continues it, zero-padded in front when S < K-1."""
    return _tail(cfg, params, x, _dims(cfg))


def _tail(cfg: ModelConfig, params, x: torch.Tensor, dims) -> torch.Tensor:
    d_in, H, Pd, N = dims
    K = cfg.ssm.conv_width
    xbc = (x @ params["in_proj"])[..., d_in:2 * d_in + 2 * N]
    S = x.shape[1]
    tail = (xbc[:, -(K - 1):, :] if S >= K - 1
            else F.pad(xbc, (0, 0, K - 1 - S, 0)))
    return tail.to(L.dtype_of(cfg))


# -- decode --------------------------------------------------------------------

def mamba2_cache_defs(cfg: ModelConfig, batch: int
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    d_in, H, Pd, N = _dims(cfg)
    K = cfg.ssm.conv_width
    return {"state": ((batch, H, N, Pd), F32),
            "conv": ((batch, K - 1, d_in + 2 * N), L.dtype_of(cfg))}


def decode_mamba2(cfg: ModelConfig, params, x: torch.Tensor, cache
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step.  x: (B,1,d) -> (out, the new state and conv
    window); the cache is only read."""
    return _decode_step(params, x, cache, _dims(cfg))


def _decode_step(params, x: torch.Tensor, cache, dims, share=None):
    d_in, H, Pd, N = dims
    B = x.shape[0]
    zxbcdt = x @ params["in_proj"]                               # (B,1,Dp)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * N, H], dim=-1)
    # rolling conv window
    win = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", win.to(F32),
                            params["conv_w"].to(F32))[:, None, :]
    xbc = F.silu(conv_out)
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = F.softplus(dt[:, 0].to(F32) + params["dt_bias"])       # (B,H)
    A = -torch.exp(params["A_log"])
    xs = xs.reshape(B, H, Pd)
    dA = torch.exp(dt * A)                                       # (B,H)
    upd = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0], dt, xs)
    state = cache["state"] * dA[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0], state)
    y = y + params["D"][None, :, None] * xs
    y = y.reshape(B, 1, d_in) * F.silu(z.to(F32))
    if share is not None:
        y = y[..., share[0]:share[1]]
    out = y.to(x.dtype) @ params["out_proj"]
    return out, {"state": state, "conv": win[:, 1:]}


# -- tensor parallelism over "model" -----------------------------------------------

def _tp_params(cfg: ModelConfig, params, tp: A.TP):
    """(this rank's parameters of a layer: its heads' columns of
    ``in_proj``, ``conv_w`` and the per-head vectors, its rows of
    ``out_proj``; their dims; its share of the features when every rank
    computes every head, else None)."""
    d_in, H, Pd, N = _dims(cfg)
    h0, h1 = A.heads_of(H, tp)
    xc = (h0 * Pd, h1 * Pd)
    e = 2 * d_in + 2 * N
    p = {"in_proj": A.take(params["in_proj"], 1, [
            xc, (d_in + xc[0], d_in + xc[1]), (2 * d_in, e),
            (e + h0, e + h1)], e + H, tp),
         "conv_w": A.take(params["conv_w"], 1, [xc, (d_in, d_in + 2 * N)],
                          d_in + 2 * N, tp)}
    for k in ("A_log", "D", "dt_bias"):
        p[k] = A.take(params[k], 0, [(h0, h1)], H, tp)
    share = None if H % tp.n == 0 else A.share_of(d_in, tp)
    p["out_proj"] = A.take(params["out_proj"], 0, [share or xc], d_in, tp)
    return p, ((h1 - h0) * Pd, h1 - h0, Pd, N), share


def _whole_conv(cfg: ModelConfig, win: torch.Tensor, d_loc: int,
                tp: A.TP) -> torch.Tensor:
    """A conv window of this rank's x channels then B and C -> every
    channel (x gathered over "model")."""
    H = _dims(cfg)[1]
    return torch.cat([A.whole_heads(win[..., :d_loc], 2, H, tp),
                      win[..., d_loc:]], dim=-1)


def apply_mamba2_tp(cfg: ModelConfig, params, x: torch.Tensor, tp: A.TP,
                    with_state: bool = False):
    """``apply_mamba2`` with tensor parallelism over "model"; with
    ``with_state`` also the whole final state and conv tail (prefill)."""
    p, dims, share = _tp_params(cfg, params, tp)
    d_loc, H, Pd, N = dims
    B, S, _ = x.shape
    xf = comm.copy_to_model(x, tp.group)
    z, xs, Bm, Cm, dt, A_ = _proj_split(p, xf, dims)
    xs = xs.reshape(B, S, H, Pd)
    y, s_fin = ssd_chunked(xs, Bm, Cm, dt, A_, chunk=cfg.ssm.chunk_size)
    out = comm.reduce_from_model(_gated_out(p, y, xs, z, x.dtype, share),
                                 tp.group)
    if not with_state:
        return out
    H_all = _dims(cfg)[1]
    return out, A.whole_heads(s_fin, 1, H_all, tp), _whole_conv(
        cfg, _tail(cfg, p, xf, dims), d_loc, tp)


def decode_mamba2_tp(cfg: ModelConfig, params, x: torch.Tensor, cache,
                     tp: A.TP):
    """``decode_mamba2`` on this rank's heads of the whole state and conv
    window in ``cache``; the new state and window come back whole."""
    d_in, H_all, Pd, N = _dims(cfg)
    p, dims, share = _tp_params(cfg, params, tp)
    d_loc = dims[0]
    h0, h1 = A.heads_of(H_all, tp)
    loc = {"state": A.cols(cache["state"], 1, [(h0, h1)]),
           "conv": A.cols(cache["conv"], 2, [(h0 * Pd, h1 * Pd),
                                             (d_in, d_in + 2 * N)])}
    out, st = _decode_step(p, comm.copy_to_model(x, tp.group), loc, dims,
                           share)
    return comm.reduce_from_model(out, tp.group), {
        "state": A.whole_heads(st["state"], 1, H_all, tp),
        "conv": _whole_conv(cfg, st["conv"], d_loc, tp)}
