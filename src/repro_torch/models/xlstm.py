"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with a
block-diagonal recurrence), per Beck et al. 2024 (``repro.models.xlstm``
in PyTorch).

Both use the stabilised exponential-gating recurrences.  Training and
prefill run the mLSTM chunkwise (``_mlstm_chunkwise``: an attention-like
masked product inside a chunk, the (C, n, m) state carried across
chunks); decode runs one step of the recurrence (``_mlstm_scan``).  The
sLSTM is a step loop over the sequence.  JAX's ``lax.scan`` loops are
Python loops.  Kept as JAX computes them: ``k`` is divided by sqrt(hd)
in float32 (a numpy scalar promotes bfloat16 to float32) and q is scaled
again in the scan; with bfloat16 inputs the chunkwise form rounds q, k,
v and the weighted scores to bfloat16 before its products (float32
sums); padded steps of the last chunk get ``i = -1e30``, ``f = 30``.

Under tensor parallelism over "model" (``parallelism="2d"``, ``*_tp``)
the weights stay in JAX's layout.  The mLSTM's ``up`` (``[x | z]`` cut
over "model" on its output features) is gathered and each rank takes the
whole x branch (every head's q, k and v read all of it) and its own
heads' z; ``q``, ``k`` and ``v`` are column cuts that are head-local when
the heads divide, the gates' columns are read for its heads, and
``down`` is row-parallel.  The sLSTM's recurrence reads its (B, H, 4hd)
product as four d-wide gates, so a feature's update needs other heads'
states: every rank runs the whole recurrence on the gathered ``w`` and
``out`` is row-parallel over its share of the features.  When the
mLSTM's heads do not divide every rank computes all of them and keeps its
share.  The states come back whole.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import ParamDef
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.sharding import comm

F32 = torch.float32


# -- mLSTM ---------------------------------------------------------------------

def _mdims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = int(cfg.d_model * cfg.xlstm.proj_factor)
    H = cfg.num_heads
    return d_in, H, d_in // H


def mlstm_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, dt = cfg.d_model, L.dtype_of(cfg)
    d_in, H, hd = _mdims(cfg)
    return {
        "up": ParamDef((d, 2 * d_in), "normal", dtype=dt,
                       logical_axes=("embed", "mlp")),
        "q": ParamDef((d_in, d_in), "normal", dtype=dt,
                      logical_axes=(None, "heads")),
        "k": ParamDef((d_in, d_in), "normal", dtype=dt,
                      logical_axes=(None, "heads")),
        "v": ParamDef((d_in, d_in), "normal", dtype=dt,
                      logical_axes=(None, "heads")),
        "gates": ParamDef((d_in, 2 * H), "normal", 0.1, F32, (None, None)),
        "gate_bias": ParamDef((2 * H,), "zeros", dtype=F32,
                              logical_axes=(None,)),
        "down": ParamDef((d_in, d), "normal", dtype=dt,
                         logical_axes=("mlp", "embed")),
    }


def _mlstm_scan(q, k, v, i_raw, f_raw, state):
    """q,k,v: (B,S,H,hd); i_raw,f_raw: (B,S,H); state: (C,n,m)."""
    S, hd = q.shape[1], q.shape[3]
    logf = F.logsigmoid(f_raw.to(F32))
    i_raw = i_raw.to(F32)
    scale = 1.0 / np.sqrt(hd)
    C, n, m = state                           # (B,H,hd,hd),(B,H,hd),(B,H)
    hs = []
    for t in range(S):
        qt = q[:, t].to(F32) * scale
        kt, vt = k[:, t].to(F32), v[:, t].to(F32)
        it, lft = i_raw[:, t], logf[:, t]
        m_new = torch.maximum(lft + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(lft + m - m_new)
        C = C * fp[..., None, None] + ip[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * fp[..., None] + ip[..., None] * kt
        num = torch.einsum("bhk,bhkv->bhv", qt, C)
        # |n^T q| floored at 1 in unstabilised space = exp(-m) stabilised
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", qt, n)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)             # (B,S,H,hd)


def _mlstm_chunkwise(q, k, v, i_raw, f_raw, state, *, chunk: int):
    """Chunkwise-parallel mLSTM (stabilised), equivalent to
    ``_mlstm_scan``: within a chunk an attention-like (Q x Q) masked
    product, across chunks only the (C, n, m) state."""
    B, S, H, hd = q.shape
    pad = (-S) % chunk
    if pad:
        def padf(x_, val=0.0):
            return F.pad(x_, (0, 0) * (x_.dim() - 2) + (0, pad), value=val)
        q, k, v = padf(q), padf(k), padf(v)
        i_raw = padf(i_raw, -1e30)      # padded steps never contribute
        f_raw = padf(f_raw, 30.0)       # forget ~ 1 keeps the state
    nc, Q = q.shape[1] // chunk, chunk
    scale = 1.0 / np.sqrt(hd)

    def resh(x_):
        return x_.reshape(B, nc, Q, *x_.shape[2:])

    # bfloat16 inputs keep the (B,Q,Q,H) operands in bfloat16; the gating
    # math stays float32
    cdt = q.dtype if q.dtype == torch.bfloat16 else F32
    qs = resh((q.to(F32) * scale).to(cdt))
    ks, vs = resh(k.to(cdt)), resh(v.to(cdt))
    logi = resh(i_raw.to(F32))                                   # (B,nc,Q,H)
    logf = resh(F.logsigmoid(f_raw.to(F32)))
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    C, n, m = state                           # (B,H,hk,hv),(B,H,hk),(B,H)
    hs = []
    for c in range(nc):
        qc32, kc32, vc32 = (t[:, c].to(F32) for t in (qs, ks, vs))
        lic, lfc = logi[:, c], logf[:, c]
        Fc = torch.cumsum(lfc, dim=1)                            # (B,Q,H)
        # D[t,j] = F_t - F_j + logi_j   (valid j<=t)
        D = Fc[:, :, None, :] - Fc[:, None, :, :] + lic[:, None, :, :]
        D = torch.where(tri[None, :, :, None], D,
                        torch.full_like(D, -float("inf")))       # (B,Q,Q,H)
        b = Fc + m[:, None, :]                                   # (B,Q,H)
        m_t = torch.maximum(torch.amax(D, dim=2), b)             # (B,Q,H)
        W = torch.exp(D - m_t[:, :, None, :])
        g = torch.exp(b - m_t)                                   # (B,Q,H)
        S_ = torch.einsum("bqhd,bjhd->bqjh", qc32, kc32)         # (B,Q,Q,H)
        WS = W * S_
        num = torch.einsum("bqjh,bjhv->bqhv", WS.to(cdt).to(F32), vc32)
        num = num + g[..., None] * torch.einsum("bqhk,bhkv->bqhv", qc32, C)
        den = torch.sum(WS, dim=2) + g * torch.einsum("bqhk,bhk->bqh",
                                                      qc32, n)
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])
        # the state into the next chunk
        FQ = Fc[:, -1, :]                                        # (B,H)
        d_end = FQ[:, None, :] - Fc + lic                        # (B,Q,H)
        m_out = torch.maximum(FQ + m, torch.amax(d_end, dim=1))
        w_end = torch.exp(d_end - m_out[:, None, :])
        decay = torch.exp(FQ + m - m_out)
        C = decay[..., None, None] * C + torch.einsum(
            "bjh,bjhk,bjhv->bhkv", w_end, kc32, vc32)
        n = decay[..., None] * n + torch.einsum("bjh,bjhk->bhk", w_end, kc32)
        m = m_out
    h = torch.stack(hs, dim=1).reshape(B, nc * Q, H, hd)
    return h[:, :S], (C, n, m)


def _mlstm_qkvg(cfg: ModelConfig, params, x: torch.Tensor):
    d_in, H, hd = _mdims(cfg)
    H = params["q"].shape[1] // hd            # this rank's heads under TP
    B, S, _ = x.shape
    xm, z = torch.split(x @ params["up"], [d_in, params["up"].shape[1] - d_in],
                        dim=-1)
    q = (xm @ params["q"]).reshape(B, S, H, hd)
    k = (xm @ params["k"]).reshape(B, S, H, hd).to(F32) / float(
        np.float32(np.sqrt(hd)))
    v = (xm @ params["v"]).reshape(B, S, H, hd)
    g = xm.to(F32) @ params["gates"] + params["gate_bias"]
    i_raw, f_raw = torch.chunk(g, 2, dim=-1)                    # (B,S,H)
    return q, k, v, i_raw, f_raw, z


def mlstm_state_defs(cfg: ModelConfig, batch: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    d_in, H, hd = _mdims(cfg)
    return {"C": ((batch, H, hd, hd), F32), "n": ((batch, H, hd), F32),
            "m": ((batch, H), F32)}


def _zeros_state(cfg: ModelConfig, batch: int, device):
    s = mlstm_state_defs(cfg, batch)
    return tuple(torch.zeros(s[k][0], dtype=F32, device=device)
                 for k in ("C", "n", "m"))


def _mlstm_out(params, h: torch.Tensor, z: torch.Tensor, dt: torch.dtype,
               share=None) -> torch.Tensor:
    B, S = h.shape[:2]
    y = h.reshape(B, S, -1).to(F32) * F.silu(z.to(F32))
    if share is not None:
        y = y[..., share[0]:share[1]]
    return y.to(dt) @ params["down"]


def apply_mlstm_with_state(cfg: ModelConfig, params, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence chunkwise pass x (B,S,d) -> (out, final {C, n, m})."""
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(cfg, params, x)
    h, (C, n, m) = _mlstm_chunkwise(
        q, k, v, i_raw, f_raw, _zeros_state(cfg, x.shape[0], x.device),
        chunk=cfg.xlstm.chunk_size)
    return _mlstm_out(params, h, z, x.dtype), {"C": C, "n": n, "m": m}


def apply_mlstm(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    return apply_mlstm_with_state(cfg, params, x)[0]


def decode_mlstm(cfg: ModelConfig, params, x: torch.Tensor, cache
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step x (B,1,d) -> (out, the new {C, n, m}); the cache is only
    read."""
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(cfg, params, x)
    h, (C, n, m) = _mlstm_scan(q, k, v, i_raw, f_raw,
                               (cache["C"], cache["n"], cache["m"]))
    return _mlstm_out(params, h, z, x.dtype), {"C": C, "n": n, "m": m}


# -- sLSTM ---------------------------------------------------------------------

def slstm_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, dt = cfg.d_model, L.dtype_of(cfg)
    H = cfg.num_heads
    hd = d // H
    return {
        "w": ParamDef((d, 4 * d), "normal", dtype=dt,
                      logical_axes=("embed", "mlp")),
        "r": ParamDef((H, hd, 4 * hd), "normal", 0.5, F32,
                      (None, None, None)),
        "bias": ParamDef((4 * d,), "zeros", dtype=F32, logical_axes=(None,)),
        "out": ParamDef((d, d), "normal", dtype=dt,
                        logical_axes=("mlp", "embed")),
    }


def slstm_state_defs(cfg: ModelConfig, batch: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    return {k: ((batch, cfg.d_model), F32) for k in ("c", "n", "h", "m")}


def _slstm_scan(cfg: ModelConfig, params, wx: torch.Tensor, state):
    """wx: (B,S,4d) input contributions; state (c, n, h, m), each
    (B, d)."""
    H, d = cfg.num_heads, cfg.d_model
    hd = d // H
    c, n, h, m = state
    hs = []
    for t in range(wx.shape[1]):
        rec = torch.einsum("bhk,hkf->bhf", h.reshape(-1, H, hd),
                           params["r"]).reshape(-1, 4 * d)
        pre = wx[:, t].to(F32) + rec + params["bias"]
        zi, ii, fi, oi = torch.chunk(pre, 4, dim=-1)
        zt, ot = torch.tanh(zi), torch.sigmoid(oi)
        logf = F.logsigmoid(fi)
        m_new = torch.maximum(logf + m, ii)
        ip = torch.exp(ii - m_new)
        fp = torch.exp(logf + m - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        h = ot * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


def apply_slstm_with_state(cfg: ModelConfig, params, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence pass x (B,S,d) -> (out, final {c, n, h, m})."""
    B, S, d = x.shape
    zero = tuple(torch.zeros((B, d), dtype=F32, device=x.device)
                 for _ in range(4))
    hs, (c, n, h, m) = _slstm_scan(cfg, params, x @ params["w"], zero)
    return hs.to(x.dtype) @ params["out"], {"c": c, "n": n, "h": h, "m": m}


def apply_slstm(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    return apply_slstm_with_state(cfg, params, x)[0]


def decode_slstm(cfg: ModelConfig, params, x: torch.Tensor, cache
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    state = (cache["c"], cache["n"], cache["h"], cache["m"])
    hs, (c, n, h, m) = _slstm_scan(cfg, params, x @ params["w"], state)
    return hs.to(x.dtype) @ params["out"], {"c": c, "n": n, "h": h, "m": m}


# -- tensor parallelism over "model" -----------------------------------------------

def _mlstm_tp_params(cfg: ModelConfig, params, tp: A.TP):
    """(this rank's mLSTM parameters: the whole x branch and its heads' z
    of ``up``, its heads' q/k/v columns and gates, its rows of ``down``;
    its share of the features when every rank computes every head)."""
    d_in, H, hd = _mdims(cfg)
    h0, h1 = A.heads_of(H, tp)
    hc = (h0 * hd, h1 * hd)
    p = {"up": A.take(params["up"], 1, [(0, d_in), (d_in + hc[0],
                                                     d_in + hc[1])],
                      2 * d_in, tp)}
    for k in ("q", "k", "v"):
        p[k] = A.take(params[k], 1, [hc], d_in, tp)
    gi = [(h0, h1), (H + h0, H + h1)]
    p["gates"] = A.take(params["gates"], 1, gi, 2 * H, tp)
    p["gate_bias"] = A.take(params["gate_bias"], 0, gi, 2 * H, tp)
    share = None if H % tp.n == 0 else A.share_of(d_in, tp)
    p["down"] = A.take(params["down"], 0, [share or hc], d_in, tp)
    return p, share


def _whole_mlstm(cfg: ModelConfig, st: Dict[str, torch.Tensor], tp: A.TP
                 ) -> Dict[str, torch.Tensor]:
    H = _mdims(cfg)[1]
    return {k: A.whole_heads(v, 1, H, tp) for k, v in st.items()}


def apply_mlstm_tp(cfg: ModelConfig, params, x: torch.Tensor, tp: A.TP,
                   with_state: bool = False):
    """``apply_mlstm`` with tensor parallelism over "model"; with
    ``with_state`` also the whole final {C, n, m}."""
    p, share = _mlstm_tp_params(cfg, params, tp)
    xf = comm.copy_to_model(x, tp.group)
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(cfg, p, xf)
    h, (C, n, m) = _mlstm_chunkwise(
        q, k, v, i_raw, f_raw, tuple(t.narrow(1, 0, q.shape[2]) for t in
                                     _zeros_state(cfg, x.shape[0],
                                                  x.device)),
        chunk=cfg.xlstm.chunk_size)
    out = comm.reduce_from_model(_mlstm_out(p, h, z, x.dtype, share),
                                 tp.group)
    if not with_state:
        return out
    return out, _whole_mlstm(cfg, {"C": C, "n": n, "m": m}, tp)


def decode_mlstm_tp(cfg: ModelConfig, params, x: torch.Tensor, cache,
                    tp: A.TP):
    """``decode_mlstm`` on this rank's heads of the whole state in
    ``cache``; the new state comes back whole."""
    p, share = _mlstm_tp_params(cfg, params, tp)
    h0, h1 = A.heads_of(_mdims(cfg)[1], tp)
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(
        cfg, p, comm.copy_to_model(x, tp.group))
    h, (C, n, m) = _mlstm_scan(q, k, v, i_raw, f_raw, tuple(
        A.cols(cache[name], 1, [(h0, h1)]) for name in ("C", "n", "m")))
    out = comm.reduce_from_model(_mlstm_out(p, h, z, x.dtype, share),
                                 tp.group)
    return out, _whole_mlstm(cfg, {"C": C, "n": n, "m": m}, tp)


def _slstm_tp_params(cfg: ModelConfig, params, tp: A.TP):
    d = cfg.d_model
    share = A.share_of(d, tp)
    p = {"w": A.take(params["w"], 1, [(0, 4 * d)], 4 * d, tp),
         "out": A.take(params["out"], 0, [share], d, tp)}
    for k in ("r", "bias"):
        p[k] = A.take(params[k], 0, [(0, params[k].shape[0])],
                      params[k].shape[0], tp)
    return p, share


def _slstm_tp(cfg: ModelConfig, params, x: torch.Tensor, state, tp: A.TP):
    p, (lo, hi) = _slstm_tp_params(cfg, params, tp)
    xf = comm.copy_to_model(x, tp.group)
    hs, (c, n, h, m) = _slstm_scan(cfg, p, xf @ p["w"], state)
    out = comm.reduce_from_model(hs[..., lo:hi].to(x.dtype) @ p["out"],
                                 tp.group)
    return out, {"c": c, "n": n, "h": h, "m": m}


def apply_slstm_tp(cfg: ModelConfig, params, x: torch.Tensor, tp: A.TP,
                   with_state: bool = False):
    """``apply_slstm`` with tensor parallelism over "model" (the
    recurrence whole on every rank, ``out`` row-parallel)."""
    B, S, d = x.shape
    zero = tuple(torch.zeros((B, d), dtype=F32, device=x.device)
                 for _ in range(4))
    out, st = _slstm_tp(cfg, params, x, zero, tp)
    return (out, st) if with_state else out


def decode_slstm_tp(cfg: ModelConfig, params, x: torch.Tensor, cache,
                    tp: A.TP):
    return _slstm_tp(cfg, params, x, tuple(cache[k] for k in
                                           ("c", "n", "h", "m")), tp)
