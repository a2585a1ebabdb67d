"""Shared layers of the LM (``repro.models.layers`` in PyTorch).

Each layer is a ``*_defs`` function declaring its ParamDefs and a plain
function of (params, x).  Linear weights keep the JAX layout
``(d_in, d_out)`` and apply as ``x @ w``.  The training loss is the mean
token cross-entropy in float32 with the padded vocab rows masked out of
the partition function; ``chunked_cross_entropy`` unembeds a chunk of
positions at a time and recomputes each chunk's logits in backward
(``torch.utils.checkpoint``, JAX's ``@jax.checkpoint``), so only one
(B, chunk, V) block of logits is alive.

On the LM mesh (``models.model.LM(cfg, mesh)``) the ``*_tp`` variants
run Megatron's tensor parallelism over "model" (``sharding.comm``): the
SwiGLU on local ``mlp`` columns with its row-parallel ``down`` summed over
"model"; the embedding as a vocab-parallel lookup (the rank that owns a
token's row gives it, the others zeros, summed over "model"); the logits
vocab-parallel; and ``token_ce_vocab_parallel``, the cross-entropy over
vocab shards: the logsumexp from a max and a sum over "model", the padded
rows masked, the label logit from the rank that owns the label.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import ParamDef
from repro_torch.sharding import comm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# -- RMSNorm -----------------------------------------------------------------

def rmsnorm_defs(d: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((d,), "ones", logical_axes=("norm",))}


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
                bias: bool = False,
                axes: Tuple[Optional[str], Optional[str]] = (None, None),
                bias_axis: Optional[str] = None) -> Dict[str, ParamDef]:
    out = {"w": ParamDef((d_in, d_out), "normal", dtype=dtype,
                         logical_axes=axes)}
    if bias:
        out["b"] = ParamDef((d_out,), "zeros", dtype=dtype,
                            logical_axes=(bias_axis,))
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
    return {"up": linear_defs(d, ff, dt, axes=("embed", "mlp")),
            "gate": linear_defs(d, ff, dt, axes=("embed", "mlp")),
            "down": linear_defs(ff, d, dt, axes=("mlp", "embed"))}


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(linear(params["gate"], x)) * linear(
        params["up"], x)
    return linear(params["down"], h)


# -- embedding -----------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    dt = dtype_of(cfg)
    v = cfg.padded_vocab
    out = {"tok": ParamDef((v, cfg.d_model), "embed", dtype=dt,
                           logical_axes=("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((cfg.d_model, v), "normal", dtype=dt,
                                  logical_axes=("embed", "vocab"))
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
                          chunk: int, *, token_ce=None,
                          denom: Optional[float] = None) -> torch.Tensor:
    """Unembed + cross-entropy over sequence chunks of ``chunk``
    positions (the last one may be shorter), each chunk's logits
    recomputed in backward; the sum over every token / ``denom`` (B * S
    by default).  ``token_ce(x_chunk, labels_chunk)`` replaces the
    unembed and per-token loss (the mesh's vocab-parallel pair)."""
    B, S, _ = x.shape
    if token_ce is None:
        def token_ce(xc, lc):
            return _token_ce(unembed(embed_params, xc), lc, logical_vocab)

    def one(xc: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
        return torch.sum(token_ce(xc, lc))

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    one = recomputed(one)
    for i in range(0, S, chunk):
        total = total + one(x[:, i:i + chunk], labels[:, i:i + chunk])
    return total / float(B * S if denom is None else denom)


# -- tensor parallelism over "model" ---------------------------------------------

def swiglu_tp(params, x: torch.Tensor, group) -> torch.Tensor:
    """SwiGLU on this rank's ``mlp`` columns (``up`` / ``gate``
    column-parallel, ``down`` row-parallel, summed over "model")."""
    xf = comm.copy_to_model(x, group)
    h = torch.nn.functional.silu(linear(params["gate"], xf)) * linear(
        params["up"], xf)
    return comm.reduce_from_model(linear(params["down"], h), group)


def embed_tp(params, tokens: torch.Tensor, group, lo: int) -> torch.Tensor:
    """Vocab-parallel lookup: this rank holds rows [lo, lo + V_loc) of the
    table; a token's row comes from its owner, zeros elsewhere, summed
    over "model"."""
    tok = params["tok"]
    idx = tokens.long() - lo
    inside = (idx >= 0) & (idx < tok.shape[0])
    rows = tok[idx.clamp(0, tok.shape[0] - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return comm.reduce_from_model(rows, group)


def unembed_tp(params, x: torch.Tensor, group) -> torch.Tensor:
    """Vocab-parallel logits: this rank's vocab columns."""
    return unembed(params, comm.copy_to_model(x, group))


def mask_vocab(logits: torch.Tensor, logical_vocab: int, lo: int = 0,
               fill: float = -1e30) -> torch.Tensor:
    """Columns whose global index (``lo`` + local) is a padded vocab row
    set to ``fill``."""
    col = lo + torch.arange(logits.shape[-1], device=logits.device)
    if lo + logits.shape[-1] <= logical_vocab:
        return logits
    return torch.where(col >= logical_vocab, torch.full_like(logits, fill),
                       logits)


def token_ce_vocab_parallel(logits: torch.Tensor, labels: torch.Tensor,
                            logical_vocab: int, lo: int, group
                            ) -> torch.Tensor:
    """Per-token ``logsumexp - logit[label]`` in float32 over vocab
    shards: this rank's logits are columns [lo, lo + V_loc).  The max
    is taken over "model" (no gradient: the logsumexp does not depend on
    it), the sum of exponentials and the label logit are summed over
    "model" (Megatron's g)."""
    logits = mask_vocab(logits.to(torch.float32), logical_vocab, lo)
    m = comm.all_max(torch.amax(logits.detach(), dim=-1), group)
    se = comm.reduce_from_model(
        torch.sum(torch.exp(logits - m[..., None]), dim=-1), group)
    idx = labels.long() - lo
    inside = (idx >= 0) & (idx < logits.shape[-1])
    tgt = torch.gather(logits, -1, idx.clamp(0, logits.shape[-1] - 1)
                       [..., None])[..., 0]
    tgt = comm.reduce_from_model(
        torch.where(inside, tgt, torch.zeros_like(tgt)), group)
    return m + torch.log(se) - tgt
