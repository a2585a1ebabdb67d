"""Mixture-of-experts FFN (``repro.models.moe`` in PyTorch).

The router (float32 logits, softmax, top-k, renormalised gates and the
Switch load-balance loss) picks ``top_k`` experts per token; the (token,
expert) pairs are partitioned into a fixed-capacity buffer (overflow
dropped and counted), grouped by expert, run through each expert's
SwiGLU and scatter-added back with their gate weights.  JAX's
``ragged_dot`` (a library op there, not a Pallas kernel) becomes one
matrix product per non-empty expert group, which needs the group sizes
on the host: one host read per layer call.

Both branches of JAX's ``apply_moe`` are ported.  JAX picks by the mesh
alone: its ``ep_psum`` branch whenever the mesh's "model" axis has more
than one rank, whatever the parallelism policy, else the branch that
keeps every expert on each device.

**The local branch** (no mesh, or "model" of one rank): JAX runs it on
one device and, through GSPMD, on a data-parallel mesh, where the
router's statistics and the capacity are the whole batch's.  The port's
``apply_moe(..., rows=Rows(...))`` does the same: the per-expert sums of
the router's probabilities and assignments and the drop count are summed
over the data-parallel group, and the capacity is taken of the global
token count, each rank keeping the pairs of its tokens that fall under
it in the global pair order.

**The expert-parallel branch** (``apply_moe_ep``, JAX's ``shard_map``
body, run per rank): the experts are cut over "model", rank r owning
``[r E/n, (r+1) E/n)``; each rank routes its block of tokens (JAX's
``in_specs``: the rows over the non-model axes when they divide the
batch, else every row), keeps the pairs routed to its experts in a
stable partition up to a capacity taken per rank and per block
(``_capacity(n_loc, top_k, n, cf)``), runs them and the outputs are
summed over "model" (Megatron's g).  The aux loss is averaged over
"model" and the drops summed over it; both differ over the data blocks,
and JAX's ``out_specs`` ``P()`` returns the first device's: the first
data block's aux loss and its drops over the whole batch's pairs
(``comm.first_rank``; kept for parity with JAX, a caveat of it).  The
gradients follow ``shard_map``'s transpose: the replicated router's is
the sum over the mesh of each rank's, the aux loss's seen by each rank
divided by the mesh's size.  ``EP`` says how a call's rows reach the
block: gathered over the axes that cut them and JAX's block does not
(over "model" under ``parallelism="fsdp"``, whose output is then
reduce-scattered back), or read as they are.

The capacity is at least n * top_k whenever ``capacity_factor >= 1``,
so nothing is dropped; the rule stays and ``drop_frac`` reports it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import is_fake
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


class EP(NamedTuple):
    """One rank's place in the expert parallelism over "model", and how a
    call's rows reach JAX's ``shard_map`` block."""
    group: Any            # the "model" group
    n: int                # ranks of "model"
    r: int                # this rank's index on "model"
    dp_group: Any         # the non-model axes (the data blocks), or None
    size: int             # ranks of the whole mesh
    model_grads: bool     # "model" is no data-parallel axis ("2d"): a
                          # replicated input's gradient sums over it here


class Block(NamedTuple):
    """A call's rows against JAX's block: ``rows`` tokens-rows per block,
    ``global_rows`` in the batch, this rank's rows all-gathered over
    ``gather`` (None: its rows are the block), ``over_model`` when that
    gather is over "model"."""
    rows: int
    global_rows: int
    gather: Any
    over_model: bool
    index: int            # this rank's position in ``gather``


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


def _combine(y: torch.Tensor, sel: torch.Tensor, n: int, top_k: int
             ) -> torch.Tensor:
    """JAX's scatter-add of the pairs' outputs y (C, d) onto their tokens,
    ``sel`` the pairs' indices (token * top_k + k, distinct): each pair
    written to its own slot, then each token's ``top_k`` slots summed in
    k order.  No atomic adds, so the card's sum does not depend on the
    order its threads run in (``index_add_`` on a CUDA tensor does)."""
    buf = y.new_zeros((n * top_k, y.shape[1]))
    buf[sel] = y
    return buf.view(n, top_k, -1).sum(1)


def _local_moe(x: torch.Tensor, p: Dict[str, Any], router: torch.Tensor,
               *, top_k: int, num_experts: int, e_start: int, e_local: int,
               capacity: int, group=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's ``_local_moe``: route x (n, d) and run the experts in
    ``[e_start, e_start + e_local)`` on the first ``capacity`` of this
    rank's pairs in pair order (a stable partition; the unused slots go
    to the last local group with zero input) -> (out (n, d) float32,
    aux_loss, drops).  With ``group`` (the local branch on a
    data-parallel mesh) the aux loss and the drops are the group's: the
    per-expert sums and the drop count summed over it."""
    n, d = x.shape
    logits = x.to(F32) @ router                                    # (n, E)
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
    mine = (flat_i >= e_start) & (flat_i < e_start + e_local)
    # stable partition: my pairs first, the first ``capacity`` taken
    order = torch.argsort((~mine).to(torch.uint8), stable=True)
    sel = order[:capacity]
    valid = mine[sel]
    drops = torch.clamp(mine.sum() - valid.sum(), min=0).to(F32)
    if group is not None:
        drops = comm.all_reduce(drops, group)
    e_loc = torch.where(valid, flat_i[sel] - e_start,
                        torch.full_like(flat_i[sel], e_local - 1))
    tok = tok_of[sel]
    xs = torch.where(valid[:, None], x[tok], torch.zeros_like(x[tok]))

    # group by local expert id
    g_order = torch.argsort(e_loc, stable=True)
    xs_g = xs[g_order]
    if is_fake(x):
        # a trace on fake tensors has no values to read: the one value it
        # stands in for is the group sizes, the ``capacity`` rows split
        # evenly over the local experts (``_grouped``'s products and
        # bytes depend only on their total)
        rows = xs_g.shape[0]
        sizes = [rows // e_local + (e < rows % e_local)
                 for e in range(e_local)]
    else:
        # (bincount would read the largest id on the host as well)
        # audit: allow(host-sync) the group sizes: one designed read a layer
        sizes = torch.zeros(e_local, dtype=torch.long, device=x.device
                            ).index_add_(0, e_loc, torch.ones_like(e_loc)
                                         ).tolist()                # host
    gate = _grouped(xs_g, p["w_gate"], sizes)
    up = _grouped(xs_g, p["w_up"], sizes)
    h = (F.silu(gate.to(F32)) * up.to(F32)).to(x.dtype)
    y_g = _grouped(h, p["w_down"], sizes)                          # (C, d)

    inv = torch.argsort(g_order, stable=True)
    y = y_g[inv].to(F32) * (flat_w[sel] * valid)[:, None]
    return _combine(y, sel, n, top_k), aux, drops


def _experts(w: torch.Tensor, ep: EP, e_local: int) -> torch.Tensor:
    """This rank's experts of an expert leaf: the leaf as held when it is
    cut over "model", else its slice."""
    if w.shape[0] == e_local:
        return w
    return w.narrow(0, ep.r * e_local, e_local)


def apply_moe_ep(cfg: ModelConfig, params, x: torch.Tensor, ep: EP,
                 block: Block, shared=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """JAX's ``ep_psum`` branch on this rank: x (b, S, d), this rank's
    rows -> (its rows of the output, {aux_loss, drop_frac}); ``shared``
    applies the shared experts' SwiGLU (default ``layers.swiglu``)."""
    m = cfg.moe
    b, S, d = x.shape
    E = m.num_experts
    if E % ep.n:
        raise ValueError(f"{E} experts do not divide over {ep.n} 'model' "
                         "ranks")
    e_local = E // ep.n
    router = params["router"]
    if block.over_model:
        xb = comm.gather_dim(x, 0, ep.group)
    else:
        xb = comm.gather_dim(x, 0, block.gather)
        xb = (comm.copy_to_model(xb, ep.group) if ep.model_grads
              else comm.grad_mean(xb, ep.group))
    if ep.model_grads:
        router = comm.copy_to_model(router, ep.group)
    w = {k: _experts(params[k], ep, e_local)
         for k in ("w_gate", "w_up", "w_down")}
    cap = _capacity(block.rows * S, m.top_k, ep.n, m.capacity_factor)
    out, aux, drops = _local_moe(
        xb.reshape(-1, d), w, router, top_k=m.top_k, num_experts=E,
        e_start=ep.r * e_local, e_local=e_local, capacity=cap)
    aux = comm.first_rank(comm.pmean(aux, ep.group), ep.dp_group, ep.size)
    drops = comm.first_rank(comm.count_sum(drops, ep.group), ep.dp_group,
                            ep.size)
    out = out.reshape(xb.shape)
    if block.over_model:
        out = comm.scatter_sum(out, 0, ep.group)
    else:
        out = (comm.reduce_from_model(out, ep.group) if ep.model_grads
               else comm.psum(out, ep.group))
        if block.gather is not None:
            out = out.narrow(0, block.index * b, b)
    y = out.to(x.dtype)
    if m.num_shared_experts > 0:
        y = y + (shared or L.swiglu)(params["shared"], x)
    pairs = block.global_rows * S * m.top_k
    return y, {"aux_loss": aux, "drop_frac": drops / pairs}


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
    out, aux, drops = _local_moe(
        x.reshape(n, d), params, params["router"], top_k=m.top_k,
        num_experts=m.num_experts, e_start=0, e_local=m.num_experts,
        capacity=keep, group=rows.group)
    y = out.reshape(B, S, d).to(x.dtype)
    if m.num_shared_experts > 0:
        y = y + L.swiglu(params["shared"], x)
    pairs = n * m.top_k * comm.group_size(rows.group)
    return y, {"aux_loss": aux, "drop_frac": drops / pairs}
