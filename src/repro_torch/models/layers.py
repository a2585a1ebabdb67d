"""Shared layers of the LM (``repro.models.layers`` in PyTorch).

Each layer is a ``*_defs`` function declaring its ParamDefs and a plain
function of (params, x).  Linear weights keep the JAX layout
``(d_in, d_out)`` and apply as ``x @ w``.  The cross-entropy functions
belong to training and are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

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
