"""Shared layers of the LM (``repro.models.layers`` in PyTorch).

Each layer is a ``*_defs`` function declaring its ParamDefs and a plain
function of (params, x).  Linear weights keep the JAX layout
``(d_in, d_out)`` and apply as ``x @ w``.  The training loss is the mean
token cross-entropy in float32 with the padded vocab rows masked out of
the partition function; ``chunked_cross_entropy`` unembeds a chunk of
positions at a time and recomputes each chunk's logits in backward
(``torch.utils.checkpoint``, JAX's ``@jax.checkpoint``), so only one
(B, chunk, V) block of logits is alive.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import ParamDef

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# -- RMSNorm -----------------------------------------------------------------

def rmsnorm_defs(d: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((d,), "ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


# -- rotary position embeddings ------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a float32 base tensor (as in JAX; a Python-float base rounds some
    # entries differently), filled on the device: no host-to-device copy
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)             # (hd/2,)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- projections and MLP -------------------------------------------------------

def linear_defs(d_in: int, d_out: int, dtype: torch.dtype,
                bias: bool = False) -> Dict[str, ParamDef]:
    out = {"w": ParamDef((d_in, d_out), "normal", dtype=dtype)}
    if bias:
        out["b"] = ParamDef((d_out,), "zeros", dtype=dtype)
    return out


def linear(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def swiglu_defs(cfg: ModelConfig, d_ff: Optional[int] = None
                ) -> Dict[str, Any]:
    d, dt = cfg.d_model, dtype_of(cfg)
    ff = d_ff if d_ff is not None else cfg.d_ff
    return {"up": linear_defs(d, ff, dt), "gate": linear_defs(d, ff, dt),
            "down": linear_defs(ff, d, dt)}


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(linear(params["gate"], x)) * linear(
        params["up"], x)
    return linear(params["down"], h)


# -- embedding -----------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    dt = dtype_of(cfg)
    v = cfg.padded_vocab
    out = {"tok": ParamDef((v, cfg.d_model), "embed", dtype=dt)}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((cfg.d_model, v), "normal", dtype=dt)
    return out


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["tok"].T


# -- recomputation -------------------------------------------------------------

def recomputed(fn, **kw):
    """``fn`` whose activations are recomputed in backward (non-reentrant
    ``torch.utils.checkpoint``; ``kw``: its ``context_fn``)."""
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


# -- training loss ---------------------------------------------------------------

def _token_ce(logits: torch.Tensor, labels: torch.Tensor,
              logical_vocab: Optional[int]) -> torch.Tensor:
    """Per-token ``logsumexp - logit[label]`` in float32, padded vocab
    rows (>= ``logical_vocab``) masked to -1e30."""
    logits = logits.to(torch.float32)
    if logical_vocab is not None and logical_vocab < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= logical_vocab
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - tgt


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  logical_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy of logits (..., V) against labels (...)."""
    return torch.mean(_token_ce(logits, labels, logical_vocab))


def chunked_cross_entropy(embed_params, x: torch.Tensor,
                          labels: torch.Tensor, logical_vocab: int,
                          chunk: int) -> torch.Tensor:
    """Unembed + cross-entropy over sequence chunks of ``chunk``
    positions (the last one may be shorter), each chunk's logits
    recomputed in backward; the sum over every token / (B * S)."""
    B, S, _ = x.shape

    def one(xc: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
        return torch.sum(_token_ce(unembed(embed_params, xc), lc,
                                   logical_vocab))

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    one = recomputed(one)
    for i in range(0, S, chunk):
        total = total + one(x[:, i:i + chunk], labels[:, i:i + chunk])
    return total / float(B * S)
