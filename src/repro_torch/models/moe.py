"""Mixture-of-experts FFN (``repro.models.moe`` in PyTorch).

The router (float32 logits, softmax, top-k, renormalised gates and the
Switch load-balance loss) picks ``top_k`` experts per token; the (token,
expert) pairs are partitioned into a fixed-capacity buffer (overflow
dropped and counted), grouped by expert, run through each expert's
SwiGLU and scatter-added back with their gate weights.  JAX's
``ragged_dot`` (a library op there, not a Pallas kernel) becomes one
matrix product per non-empty expert group, which needs the group sizes
on the host: one host read per layer call.

Only the branch of ``apply_moe`` that keeps every expert on each device
is ported.  JAX runs it on one device and, through GSPMD, on a mesh whose
"model" axis has one rank; there the router's statistics and the capacity
are the whole batch's.  The port's ``apply_moe(..., rows=Rows(...))`` does
the same on a data-parallel mesh (``models.model.LM(cfg, mesh)``): the
per-expert sums of the router's probabilities and assignments and the
drop count are summed over the data-parallel group, and the capacity is
taken of the global token count, each rank keeping the pairs of its
tokens that fall under it in the global pair order.  The ``ep_psum``
branch (experts sharded over "model" through ``shard_map``) is not
ported yet.  The capacity is at least n * top_k whenever
``capacity_factor >= 1``, so nothing is dropped; the rule stays and
``drop_frac`` reports it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import ParamDef
from repro_torch.models import layers as L
from repro_torch.sharding import comm

F32 = torch.float32


class Rows(NamedTuple):
    """Where this rank's tokens sit in the global batch of a data-parallel
    mesh: its (B, S) rows are rows [lo, lo + B) of ``global_rows``, and
    the batch's rows are spread over ``group`` (ranks that hold the same
    rows count them once each; None: one rank)."""
    group: Any
    lo: int
    global_rows: int


def moe_defs(cfg: ModelConfig) -> Dict[str, Any]:
    m = cfg.moe
    d, dt = cfg.d_model, L.dtype_of(cfg)
    E, ff = m.num_experts, m.expert_d_ff
    out: Dict[str, Any] = {
        "router": ParamDef((d, E), "normal", dtype=F32,
                           logical_axes=("embed", None)),
        "w_gate": ParamDef((E, d, ff), "normal", dtype=dt,
                           logical_axes=("experts", "embed", None)),
        "w_up": ParamDef((E, d, ff), "normal", dtype=dt,
                         logical_axes=("experts", "embed", None)),
        "w_down": ParamDef((E, ff, d), "normal", dtype=dt,
                           logical_axes=("experts", None, "embed")),
    }
    if m.num_shared_experts > 0:
        out["shared"] = L.swiglu_defs(
            cfg, d_ff=m.shared_d_ff * m.num_shared_experts)
    return out


def _capacity(n_tokens: int, top_k: int, num_shards: int, cf: float) -> int:
    c = int(np.ceil(cf * n_tokens * top_k / num_shards))
    return max(8, int(np.ceil(c / 8)) * 8)


def _grouped(x: torch.Tensor, w: torch.Tensor, sizes) -> torch.Tensor:
    """``ragged_dot``: rows of x (sorted by group) times their group's
    matrix w[g]; ``sizes`` the rows per group (host ints).  With no row
    at all the empty product still reads ``w``, so its gradient (zero)
    reaches w's FSDP gather on every rank alike."""
    parts = [xg @ w[g] for g, xg in enumerate(torch.split(x, sizes))
             if xg.shape[0]]
    return torch.cat(parts) if parts else x[:0] @ w[0]


def _local_moe(x: torch.Tensor, p: Dict[str, Any], *, top_k: int,
               num_experts: int, keep: int, group=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route and run every expert on one device, keeping the first
    ``keep`` (token, expert) pairs.  x (n, d) -> (out (n, d) float32,
    aux_loss, drops); with ``group`` the aux loss and the drops are the
    group's (the per-expert sums and the drop count summed over it)."""
    n, d = x.shape
    logits = x.to(F32) @ p["router"]                               # (n, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, top_k, dim=-1)              # (n, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e / k
    hits = F.one_hot(gate_i, num_experts).to(F32).sum(1)           # (n, E)
    if group is None:
        me = torch.mean(probs, dim=0)
        ce = torch.mean(hits, dim=0)
    else:
        # the means over the group's tokens; the probabilities' sum is
        # Megatron's g (each rank's backward: its own tokens' share)
        count = n * comm.group_size(group)
        me = comm.reduce_from_model(torch.sum(probs, dim=0), group) / count
        ce = comm.all_reduce(torch.sum(hits, dim=0), group) / count
    aux = num_experts * torch.sum(me * ce) / top_k

    flat_i = gate_i.reshape(-1)                                    # (n*k,)
    flat_w = gate_w.reshape(-1)
    tok_of = torch.arange(n * top_k, device=x.device) // top_k
    # every expert is local: the stable partition keeps pair order, and
    # the first ``keep`` pairs are taken
    sel = torch.arange(keep, device=x.device)
    # audit: allow(host-sync) static counts (rows, top_k, capacity)
    drops = torch.full((), float(n * top_k - keep), dtype=F32,
                       device=x.device)
    if group is not None:
        drops = comm.all_reduce(drops, group)

    e_loc = flat_i[sel]
    tok = tok_of[sel]
    xs = x[tok]                                                    # (C, d)

    # group by expert id
    g_order = torch.argsort(e_loc, stable=True)
    xs_g = xs[g_order]
    # (bincount would read the largest id on the host as well)
    # audit: allow(host-sync) the group sizes: one designed read a layer
    sizes = torch.zeros(num_experts, dtype=torch.long, device=x.device
                        ).index_add_(0, e_loc, torch.ones_like(e_loc)
                                     ).tolist()                    # host

    gate = _grouped(xs_g, p["w_gate"], sizes)
    up = _grouped(xs_g, p["w_up"], sizes)
    h = (F.silu(gate.to(F32)) * up.to(F32)).to(x.dtype)
    y_g = _grouped(h, p["w_down"], sizes)                          # (C, d)

    inv = torch.argsort(g_order, stable=True)
    y = y_g[inv].to(F32) * flat_w[sel][:, None]
    out = torch.zeros((n, d), dtype=F32, device=x.device).index_add_(
        0, tok, y)
    return out, aux, drops


def apply_moe(cfg: ModelConfig, params, x: torch.Tensor,
              rows: Optional[Rows] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (B, S, d), stats {aux_loss, drop_frac}: of x's
    tokens, or with ``rows`` of the global batch they belong to."""
    m = cfg.moe
    B, S, d = x.shape
    n = B * S
    if rows is None:
        rows = Rows(None, 0, B)
    # the capacity of the global batch, in its pair order: this rank's
    # pairs start at pair lo * S * top_k
    cap = _capacity(rows.global_rows * S, m.top_k, 1, m.capacity_factor)
    keep = min(max(cap - rows.lo * S * m.top_k, 0), n * m.top_k)
    out, aux, drops = _local_moe(x.reshape(n, d), params, top_k=m.top_k,
                                 num_experts=m.num_experts, keep=keep,
                                 group=rows.group)
    y = out.reshape(B, S, d).to(x.dtype)
    if m.num_shared_experts > 0:
        y = y + L.swiglu(params["shared"], x)
    pairs = n * m.top_k * comm.group_size(rows.group)
    return y, {"aux_loss": aux, "drop_frac": drops / pairs}
