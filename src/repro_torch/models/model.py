"""The LM (``repro.models.model.LM``) for every family: training and
serving.

Parameters are a nested dict of tensors with the JAX tree's names and
layout: the per-layer parameters stacked on a leading layer axis,
linear weights ``(d_in, d_out)``.  Heterogeneous families stack
homogeneous superblocks: xLSTM ``blocks.mlstm`` (n_super, n_m, ...) and
``blocks.slstm`` (n_super, ...); the Mamba-2 hybrid ``blocks``
(n_super, n_m, ...), one unstacked ``shared_attn`` block and a ``tail``
of Mamba-2 layers; the vlm ``blocks.self`` (n_super, n_s, ...) and
``blocks.cross`` (n_super, ...) with a tanh gate; the audio family
``enc_blocks``, ``dec_blocks`` and ``enc_norm``.  The cache mirrors
that nesting: k/v of shape (..., B, S, KV*hd) per attention layer (int8
with bfloat16 scales for ``kv_cache_dtype="int8"``), the recurrent
states of the mLSTM (C, n, m), the sLSTM (c, n, h, m) and Mamba-2
(state, conv), and fixed cross caches (B, Skv, KV*hd).  JAX's
``lax.scan`` over stacked layers is a Python loop over views.

``LM(cfg, mesh)`` runs on a ``launch.mesh.LMMesh`` (one process per
card): each rank stores its pieces of the parameters under
``rules.param_pspecs``, a layer gathers its FSDP cuts before it runs
(``_g``, planned per stack when the model is made), every family's
blocks run with tensor parallelism over "model" under ``"2d"`` (the
attention, MLP, cross-attention, Mamba-2 and xLSTM blocks: ``A.TP``),
the MoE takes JAX's expert-parallel branch whenever "model" has a group
(``MOE.EP``, under any policy), and the entry points check the rows a
rank holds at every block boundary (``_constrain``, JAX's sharding
constraint, given the call's ``Rows``).  Every cache leaf a rank holds
is its piece under JAX's ``cache_shardings`` (``rules.cache_leaf_spec``,
which finds the batch and sequence dims by length): the rows over the
data-parallel axes, the attention caches' positions cut over "model"
under tensor parallelism, or over "data" when the data-parallel axes do
not divide the cache's rows (the long-context layout, ``_split``), B4
running on each rank's positions with the ranges merged; the audio
family's cross cache cut over "data" too when it spans ``max_seq``
positions (B4 on each rank's range, merged); a recurrent state or a
cross cache under tensor parallelism cut on the dim JAX's rule picks
(``A.cross_cut``); a decode gathers a state's cut, steps its heads and
keeps its piece of the new state.  Where a dim's length happens to equal
the batch's or ``max_seq`` (a smoke config's 2 layers at batch 2, its 32
kv features at ``max_seq`` 32), JAX's rule cuts another dim than the one
the decode computes over; ``_layouts`` finds such leaves and the decode,
a prefill and ``splice`` re-cut them (gathered whole, cut again) around
the call.

Training: ``forward`` (final hidden states and the aux metrics: the MoE
``moe_aux_loss`` and ``moe_drop_frac``, means over layers), ``logits``
and ``loss`` (``ce`` plus 0.01 times the MoE aux loss; through
``chunked_cross_entropy`` when ``cfg.loss_chunk > 0``); gradients come
from autograd.  ``_remat`` wraps each outer scanned body where JAX wraps
it (a superblock's inner layers are not wrapped on their own):
``"none"`` keeps every activation, ``"dots"`` saves the outputs of the
matrix products with no batch dimension (``aten.mm``) and recomputes the
rest, anything else (``"minimal"``) saves only the body's inputs.

``decode`` takes the flash-decode kernel route (``use_kernel=True``) for
the self-attention layers and for the cross-attention over the fixed
cross cache (JAX computes both with plain attention), and writes every
layer's fresh entries and recurrent states in place, in the rows asked
for; the JAX ``LM.decode`` returns a new cache with every row written.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch.common.config import ModelConfig
from repro_torch.common.params import (ParamDef, init_params_generator,
                                       map_defs)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.sharding import comm
from repro_torch.sharding import rules as R

Spec = Tuple[Tuple[int, ...], torch.dtype]     # a cache leaf: shape, dtype


def _stack(defs: Any, n: int) -> Any:
    return map_defs(lambda d: ParamDef((n,) + d.shape, d.init, d.scale,
                                       d.dtype,
                                       ("layers",) + d.logical_axes), defs)


def _stack_specs(specs: Any, n: int) -> Any:
    if isinstance(specs, tuple):
        return ((n,) + specs[0], specs[1])
    return {k: _stack_specs(v, n) for k, v in specs.items()}


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a nested dict of stacked tensors (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}


def _layers(tree: Any) -> List[Any]:
    """Every layer of a nested dict of stacked tensors, in order."""
    n = _first(tree).shape[0]
    return [_index(tree, i) for i in range(n)]


def _first(tree: Any) -> torch.Tensor:
    return tree if isinstance(tree, torch.Tensor) else _first(
        next(iter(tree.values())))


def _inner(specs: Any) -> Any:
    """The specs of one layer of a stack (its leading layer dim dropped)."""
    if isinstance(specs, tuple):
        return specs[1:]
    return {k: _inner(v) for k, v in specs.items()}


def _stacked(trees: List[Any]) -> Any:
    """A list of same-structured trees -> one tree stacked on axis 0."""
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees)
    return {k: _stacked([t[k] for t in trees]) for k in trees[0]}


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``checkpoint_dots_with_no_batch_dims``: keep the products of 2-D
    operands (``x @ w`` is ``mm``; a batched einsum is ``bmm``), recompute
    the rest."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        return L.recomputed(fn, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    return L.recomputed(fn)


def _put_token(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
               pos: int, rows: Optional[torch.Tensor]) -> None:
    """Write one position's fresh cache entries (B, 1, ...) at ``pos`` in
    place, in ``rows`` (every row when None)."""
    for name, t in new.items():
        if rows is None:
            cache[name][:, pos] = t[:, 0]
        elif len(rows):
            cache[name][rows, pos] = t[rows, 0]


def _put_state(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
               rows: Optional[torch.Tensor]) -> None:
    """Replace recurrent states (B, ...) in place, in ``rows``."""
    for name, t in new.items():
        if rows is None:
            cache[name].copy_(t)
        elif len(rows):
            cache[name][rows] = t[rows]


def splice_rows(big: Any, small: Any, slot: int) -> None:
    """Copy ``small`` (one row) into row ``slot`` of ``big`` along each
    leaf's batch axis (the axis on which the two shapes differ; with one
    row they are the same shape and the row is the leaf), in place."""
    if isinstance(big, torch.Tensor):
        axis = next((i for i, (a, b) in enumerate(zip(big.shape, small.shape))
                     if a != b), None)
        (big if axis is None else big.narrow(axis, slot, 1)).copy_(small)
        return
    for k in big:
        splice_rows(big[k], small[k], slot)


class Rows(NamedTuple):
    """An entry call's rows on a mesh: this rank holds rows [lo, lo + b)
    of a global batch of ``B`` rows, cut over the data-parallel axes
    ``part`` (a spec entry; ``rules.fit_batch_axes``)."""
    B: int
    lo: int
    part: Any


class LM:
    def __init__(self, cfg: ModelConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.specs = None
        self.tp = None
        self.ep = None
        self.n_dp, self.dp_group = 1, None
        # per parameter stack: (one layer's specs, whether a layer
        # gathers any cut before it runs)
        self._plans: Dict[str, Tuple[Any, bool]] = {}
        self._max_seq: Optional[int] = None
        self._enc_seq: Optional[int] = None
        self._layout_memo: Dict[Tuple, Tuple[Any, Any, bool]] = {}
        if mesh is None:
            return
        pol = cfg.parallelism
        # "2d" keeps the "model" cuts (tensor parallelism); "fsdp" and
        # "dp" gather every cut
        self.keep_model = pol == "2d"
        self.specs = R.param_pspecs(self.param_defs(), mesh,
                                    cfg.fsdp_over_pod, pol)
        self.dp_axes = R.batch_axes(mesh, pol)
        self.dp_group = mesh.group(self.dp_axes)
        self.n_dp = mesh.size(self.dp_axes)
        self._plans = self._gather_plans()
        # tensor and expert parallelism wherever "model" has a group to
        # talk over: more than one rank, or one rank with
        # ``one_rank_groups``
        group = mesh.group("model")
        if group is None:
            return
        n, r = mesh.shape["model"], mesh.index("model")
        if cfg.family == "moe":
            blocks = tuple(a for a in mesh.axis_names if a != "model")
            self.ep = MOE.EP(group, n, r, mesh.group(blocks), mesh.size(),
                             self.keep_model)
        if not self.keep_model:
            return
        cuts = []
        for path, keys in self._tp_leaves().items():
            spec = self._plans[path][0]
            for key, dim in keys:
                leaf = spec
                for k in key.split("."):
                    leaf = leaf[k]
                cuts.append((f"{path}.{key}", leaf[dim]))
        bad = [name for name, c in cuts if c != "model"]
        if bad:
            raise ValueError(
                f"tensor parallelism over {n} 'model' ranks needs "
                "num_heads * head_dim, num_kv_heads * head_dim and d_ff "
                f"divisible by {n} ({cfg.arch_id}: not cut: {bad})")
        self.tp = A.TP(group, n, r,
                       cfg.num_heads % n == 0 and cfg.num_kv_heads % n == 0)

    def _tp_leaves(self) -> Dict[str, List[Tuple[str, int]]]:
        """The leaves (key, dim) whose "model" cut the tensor-parallel
        attention and MLP blocks read as their own heads or features, per
        parameter stack."""
        attn = [("attn.q.w", 1), ("attn.k.w", 1), ("attn.o.w", 0)]
        mlp = [("mlp.up.w", 1), ("mlp.down.w", 0)]
        f = self.cfg.family
        if f == "dense":
            return {"blocks": attn + mlp}
        if f == "moe":
            shared = ([("moe.shared.up.w", 1), ("moe.shared.down.w", 0)]
                      if self.cfg.moe.num_shared_experts else [])
            return {"blocks": attn + shared}
        if f == "hybrid":
            return {"shared_attn": attn + mlp}
        if f == "vlm":
            return {"blocks.self": attn + mlp, "blocks.cross": [
                ("xattn.q.w", 1), ("xattn.k.w", 1), ("xattn.o.w", 0)] + mlp}
        if f == "audio":
            return {"enc_blocks": attn + mlp, "dec_blocks": attn + mlp + [
                ("xattn.q.w", 1), ("xattn.k.w", 1), ("xattn.o.w", 0)]}
        return {}

    # -- the mesh: layout, rows, collectives -------------------------------------

    @property
    def _tp_on(self) -> bool:
        return self.tp is not None

    @property
    def _vocab_cut(self) -> bool:
        """Whether the embedding (and the logits) are vocab-parallel."""
        return self._tp_on and self.specs["embed"]["tok"][0] == "model"

    def _gather_plans(self) -> Dict[str, Tuple[Any, bool]]:
        """For each parameter stack (a path of keys joined by dots, with
        its leading stack dims) and each unstacked block: the specs of one
        layer and whether any of its cuts is gathered."""
        lay = self._layout()
        depth = {"embed": 0, "final_norm": 0}
        if "main" in lay:
            depth["blocks"] = 1
        if "super_ssm" in lay:
            depth.update({"blocks.mlstm": 2, "blocks.slstm": 1})
        if "super_hybrid" in lay:
            depth.update({"blocks": 2, "shared_attn": 0})
            if lay["tail_mamba"]:
                depth["tail"] = 1
        if "super_vlm" in lay:
            depth.update({"blocks.self": 2, "blocks.cross": 1})
        if "enc" in lay:
            depth.update({"enc_blocks": 1, "dec_blocks": 1, "enc_norm": 0})
        plans = {}
        for path, k in depth.items():
            spec = self.specs
            for key in path.split("."):
                spec = spec[key]
            for _ in range(k):
                spec = _inner(spec)
            plans[path] = (spec, any(
                self.mesh.group(self.gathered_axes(x)) is not None
                for x in R.spec_leaves(spec)))
        return plans

    def _g(self, p: Any, path: str) -> Any:
        """``p``, one layer of the stack ``path`` (or an unstacked block),
        with the cuts a layer gathers before it runs all-gathered
        (backward: reduce-scatter): every cut but "model" under "2d",
        every cut otherwise.  ``p`` itself unsharded, or when no cut has
        a group to gather over."""
        if self.mesh is None:
            return p
        spec, gathers = self._plans[path]
        return self._gather(p, spec) if gathers else p

    def _gather(self, p: Any, spec: Any) -> Any:
        if not torch.is_tensor(p):
            return {k: self._gather(v, spec[k]) for k, v in p.items()}
        for dim, e in enumerate(spec):
            group = self.mesh.group(self.gathered_axes((e,)))
            if group is not None:
                p = comm.gather_dim(p, dim, group)
        return p

    def _gfn(self, fn, path: str):
        """``fn(p, *a)`` on ``p`` gathered first: inside a recomputed body
        the gather is redone in backward, so one layer's whole weights
        live at a time."""
        if self.mesh is None:
            return fn
        return lambda p, *a: fn(self._g(p, path), *a)

    def gathered_axes(self, spec) -> Tuple[str, ...]:
        """The mesh axes a leaf with ``spec`` is all-gathered over before
        its layer runs (and its gradient reduce-scattered over)."""
        axes = tuple(a for e in spec for a in R.spec_axes(e))
        if self.keep_model:
            axes = tuple(a for a in axes if a != "model")
        return axes

    def _leaf_spec(self, d: ParamDef):
        return R.safe_spec(d.shape, R.spec_for(
            d, self.mesh, self.cfg.fsdp_over_pod, self.cfg.parallelism),
            self.mesh)

    def shard(self, params: Any) -> Any:
        """Whole parameters (or any tree of their layout: the AdamW
        moments) -> this rank's pieces (views); themselves unsharded."""
        if self.mesh is None:
            return params

        def one(t, spec):
            if torch.is_tensor(t):
                return R.local_slice(t, spec, self.mesh)
            return {k: one(t[k], spec[k]) for k in t}
        return one(params, self.specs)

    def unshard(self, params: Any) -> Any:
        """This rank's pieces -> whole parameters on every rank (each cut
        all-gathered; no gradient)."""
        if self.mesh is None:
            return params

        def one(t, spec):
            if torch.is_tensor(t):
                return comm.whole(t, spec, self.mesh)
            return {k: one(t[k], spec[k]) for k in t}
        return one(params, self.specs)

    def batch_rows(self, global_batch: int) -> Tuple[int, int]:
        """[lo, hi) of the global batch's rows this rank holds
        (``rules.data_spec``: the rows over the longest prefix of the
        data-parallel axes that divides the batch; all rows unsharded)."""
        if self.mesh is None:
            return 0, global_batch
        return R.rows_of(self.mesh, global_batch, self.cfg.parallelism)

    def _enter(self, b_local: int, global_batch: Optional[int]
               ) -> Optional[Rows]:
        """The rows of an entry call that holds ``b_local`` rows of a
        global batch of ``global_batch`` (default: the rows over every
        data-parallel axis), checked against ``batch_rows``; None
        unsharded."""
        if self.mesh is None:
            return None
        B = b_local * self.n_dp if global_batch is None else int(global_batch)
        lo, hi = self.batch_rows(B)
        if hi - lo != b_local:
            raise ValueError(f"{b_local} rows on this rank do not match the "
                             f"global batch {B} ({hi - lo} a rank); pass "
                             "global_batch")
        ba = R.fit_batch_axes(self.mesh, B, self.cfg.parallelism)
        return Rows(B, lo, R.spec_part(ba))

    def _constrain(self, x: torch.Tensor, rows: Optional[Rows]
                   ) -> torch.Tensor:
        """JAX's constraint of a block's output, (batch over the DP axes,
        None, None): this rank's rows, every feature."""
        if rows is None or x.dim() != 3:
            return x
        return R.constrain(x, (rows.part, None, None), self.mesh,
                           (rows.B, x.shape[1], self.cfg.d_model))

    def next_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        """argmax over the vocabulary of (b, V) logits, vocab-parallel on
        a mesh: each rank's max and its global index, gathered over
        "model", ties to the lowest index (``torch.argmax``'s rule)."""
        if not self._vocab_cut:
            return torch.argmax(logits, dim=-1)
        lo = self.tp.r * logits.shape[-1]
        val, idx = torch.max(logits, dim=-1)
        vals = comm.all_gather(val[:, None], 1, self.tp.group)
        idxs = comm.all_gather(idx[:, None] + lo, 1, self.tp.group)
        best = torch.amax(vals, dim=-1, keepdim=True)
        big = torch.full_like(idxs, torch.iinfo(idxs.dtype).max)
        return torch.amin(torch.where(vals == best, idxs, big), dim=-1)

    def gather_rows(self, x: torch.Tensor, global_batch: int) -> torch.Tensor:
        """This rank's rows of a (global_batch, ...) tensor -> every row
        (an all-gather over the data-parallel axes that cut it)."""
        if self.mesh is None:
            return x
        ba = R.fit_batch_axes(self.mesh, global_batch, self.cfg.parallelism)
        return comm.all_gather(x, 0, self.mesh.group(ba))

    def full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Vocab-parallel logits -> every vocabulary column (no
        gradient)."""
        if not self._vocab_cut:
            return logits
        return comm.all_gather(logits, logits.dim() - 1, self.tp.group)

    def _mask_pad(self, logits: torch.Tensor) -> torch.Tensor:
        """Mask padded vocab rows so sampling never emits them."""
        lo = self.tp.r * logits.shape[-1] if self._vocab_cut else 0
        return L.mask_vocab(logits, self.cfg.vocab_size, lo)

    # -- construction ----------------------------------------------------------

    def _block_defs(self, kind: str) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        if kind == "dense":
            return {"ln1": L.rmsnorm_defs(d), "attn": A.attn_defs(cfg),
                    "ln2": L.rmsnorm_defs(d), "mlp": L.swiglu_defs(cfg)}
        if kind == "moe":
            return {"ln1": L.rmsnorm_defs(d), "attn": A.attn_defs(cfg),
                    "ln2": L.rmsnorm_defs(d), "moe": MOE.moe_defs(cfg)}
        if kind == "mamba2":
            return {"ln": L.rmsnorm_defs(d), "mamba": SSM.mamba2_defs(cfg)}
        if kind == "mlstm":
            return {"ln": L.rmsnorm_defs(d), "mlstm": XL.mlstm_defs(cfg)}
        if kind == "slstm":
            return {"ln": L.rmsnorm_defs(d), "slstm": XL.slstm_defs(cfg)}
        if kind == "cross":
            return {"ln1": L.rmsnorm_defs(d), "xattn": A.attn_defs(cfg),
                    "ln2": L.rmsnorm_defs(d), "mlp": L.swiglu_defs(cfg),
                    "gate": ParamDef((1,), "zeros", logical_axes=(None,))}
        if kind == "encdec_dec":
            return {"ln1": L.rmsnorm_defs(d), "attn": A.attn_defs(cfg),
                    "lnx": L.rmsnorm_defs(d), "xattn": A.attn_defs(cfg),
                    "ln2": L.rmsnorm_defs(d), "mlp": L.swiglu_defs(cfg)}
        raise ValueError(kind)

    def _layout(self) -> Dict[str, Any]:
        """Family layout: how many scanned units of what inner structure."""
        cfg = self.cfg
        f = cfg.family
        if f in ("dense", "moe"):
            return {"main": (f, cfg.num_layers)}
        if f == "ssm":              # xlstm: k-1 mlstm + 1 slstm a superblock
            k = cfg.xlstm.slstm_every
            return {"super_ssm": (cfg.num_layers // k, k - 1)}
        if f == "hybrid":           # zamba2
            k = cfg.shared_attn_every
            n_super = cfg.num_layers // k
            return {"super_hybrid": (n_super, k - 1),
                    "tail_mamba": cfg.num_layers - n_super * k}
        if f == "vlm":
            k = cfg.vlm.cross_attn_every
            return {"super_vlm": (cfg.num_layers // k, k - 1)}
        if f == "audio":
            return {"enc": cfg.encdec.enc_layers, "dec": cfg.encdec.dec_layers}
        raise ValueError(f)

    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        lay = self._layout()
        bd = self._block_defs
        out: Dict[str, Any] = {"embed": L.embed_defs(cfg),
                               "final_norm": L.rmsnorm_defs(cfg.d_model)}
        if "main" in lay:
            kind, n = lay["main"]
            out["blocks"] = _stack(bd(kind), n)
        if "super_ssm" in lay:
            n_super, n_m = lay["super_ssm"]
            out["blocks"] = _stack({"mlstm": _stack(bd("mlstm"), n_m),
                                    "slstm": bd("slstm")}, n_super)
        if "super_hybrid" in lay:
            n_super, n_m = lay["super_hybrid"]
            out["blocks"] = _stack(_stack(bd("mamba2"), n_m), n_super)
            out["shared_attn"] = bd("dense")
            if lay["tail_mamba"]:
                out["tail"] = _stack(bd("mamba2"), lay["tail_mamba"])
        if "super_vlm" in lay:
            n_super, n_s = lay["super_vlm"]
            out["blocks"] = _stack({"self": _stack(bd("dense"), n_s),
                                    "cross": bd("cross")}, n_super)
        if "enc" in lay:
            out["enc_blocks"] = _stack(bd("dense"), lay["enc"])
            out["dec_blocks"] = _stack(bd("encdec_dec"), lay["dec"])
            out["enc_norm"] = L.rmsnorm_defs(cfg.d_model)
        return out

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded random weights on ``generator.device``; on a mesh every
        rank draws the unsharded model's numbers and keeps its piece."""
        defs = self.param_defs()
        if self.mesh is None:
            return init_params_generator(defs, generator)

        def keep(d: ParamDef, t: torch.Tensor) -> torch.Tensor:
            piece = R.local_slice(t, self._leaf_spec(d), self.mesh)
            return piece if piece.shape == t.shape else piece.clone()
        return init_params_generator(defs, generator, keep)

    # -- block applications (full sequence) --------------------------------------

    def _emb(self, params) -> Dict[str, torch.Tensor]:
        return self._g(params["embed"], "embed")

    def _embed(self, params, tokens: torch.Tensor, rows: Optional[Rows]
               ) -> torch.Tensor:
        emb = self._emb(params)
        if self._vocab_cut:
            x = L.embed_tp(emb, tokens, self.tp.group,
                           self.tp.r * emb["tok"].shape[0])
        else:
            x = L.embed(emb, tokens)
        return self._constrain(x.to(L.dtype_of(self.cfg)), rows)

    def _unembed(self, emb, x: torch.Tensor) -> torch.Tensor:
        if self._vocab_cut:
            return L.unembed_tp(emb, x, self.tp.group)
        return L.unembed(emb, x)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        x = self._norm(self._g(params["final_norm"], "final_norm"), x)
        return self._mask_pad(self._unembed(self._emb(params), x))

    def _norm(self, p, x: torch.Tensor) -> torch.Tensor:
        return L.rmsnorm(p, x, self.cfg.norm_eps)

    def _mlp(self, p, x: torch.Tensor) -> torch.Tensor:
        if self._tp_on:
            return L.swiglu_tp(p, x, self.tp.group)
        return L.swiglu(p, x)

    def _attn(self, p, hn: torch.Tensor, causal: bool = True
              ) -> torch.Tensor:
        if self._tp_on:
            return A.self_attention_tp(self.cfg, p, hn, self.tp,
                                       causal=causal)
        return A.self_attention(self.cfg, p, hn, causal=causal)

    def _xattn(self, p, hn: torch.Tensor, kv_src: torch.Tensor
               ) -> torch.Tensor:
        if self._tp_on:
            return A.cross_attention_tp(self.cfg, p, hn, kv_src, self.tp)
        return A.cross_attention(self.cfg, p, hn, kv_src)

    def _moe(self, p, x: torch.Tensor, rows: Optional[Rows]):
        """The MoE FFN: JAX's expert-parallel branch when "model" has a
        group; else, on a mesh, its router statistics and capacity are
        the global batch's, as JAX's GSPMD computes them."""
        if self.ep is not None:
            return MOE.apply_moe_ep(self.cfg, p, x, self.ep,
                                    self._ep_block(rows), shared=self._mlp)
        dp = None if rows is None else MOE.Rows(self.dp_group, rows.lo,
                                                rows.B)
        return MOE.apply_moe(self.cfg, p, x, dp)

    def _ep_block(self, rows: Rows) -> MOE.Block:
        """How this call's rows reach JAX's ``shard_map`` block: the rows
        over the non-model axes when they divide the batch, else every
        row; this rank's rows gathered over the axes that cut them and
        the block does not."""
        mesh = self.mesh
        blocks = tuple(a for a in mesh.axis_names if a != "model")
        dp = mesh.size(blocks)
        whole = rows.B % dp != 0
        gathered = tuple(a for a in R.spec_axes(rows.part)
                         if whole or a not in blocks)
        over_model = "model" in gathered
        if over_model and gathered != ("model",):
            raise ValueError(f"rows cut over {gathered} do not gather into "
                             "an expert-parallel block")
        return MOE.Block(rows.B if whole else rows.B // dp, rows.B,
                         None if over_model or not gathered
                         else mesh.group(gathered), over_model,
                         mesh.index(gathered) if gathered else 0)

    def _apply_dense(self, p, x: torch.Tensor, rows: Optional[Rows],
                     causal: bool = True) -> torch.Tensor:
        h = self._constrain(x + self._attn(p["attn"], self._norm(p["ln1"], x),
                                           causal), rows)
        return self._constrain(h + self._mlp(p["mlp"], self._norm(p["ln2"],
                                                                   h)), rows)

    def _apply_moe(self, p, x: torch.Tensor, rows: Optional[Rows]):
        h = self._constrain(x + self._attn(p["attn"],
                                           self._norm(p["ln1"], x)), rows)
        y, stats = self._moe(p["moe"], self._norm(p["ln2"], h), rows)
        return self._constrain(h + y, rows), stats

    def _apply_mamba(self, p, x: torch.Tensor, rows: Optional[Rows]
                     ) -> torch.Tensor:
        hn = self._norm(p["ln"], x)
        y = (SSM.apply_mamba2_tp(self.cfg, p["mamba"], hn, self.tp)
             if self._tp_on else SSM.apply_mamba2(self.cfg, p["mamba"], hn))
        return self._constrain(x + y, rows)

    def _apply_cross(self, p, x: torch.Tensor, kv_src: torch.Tensor,
                     rows: Optional[Rows]) -> torch.Tensor:
        g = torch.tanh(p["gate"]).to(x.dtype)
        h = x + g * self._xattn(p["xattn"], self._norm(p["ln1"], x), kv_src)
        return self._constrain(h + self._mlp(p["mlp"], self._norm(p["ln2"],
                                                                   h)), rows)

    def _mlstm(self, p, hn: torch.Tensor, with_state: bool = False):
        if self._tp_on:
            return XL.apply_mlstm_tp(self.cfg, p, hn, self.tp, with_state)
        if with_state:
            return XL.apply_mlstm_with_state(self.cfg, p, hn)
        return XL.apply_mlstm(self.cfg, p, hn)

    def _slstm(self, p, hn: torch.Tensor, with_state: bool = False):
        if self._tp_on:
            return XL.apply_slstm_tp(self.cfg, p, hn, self.tp, with_state)
        if with_state:
            return XL.apply_slstm_with_state(self.cfg, p, hn)
        return XL.apply_slstm(self.cfg, p, hn)

    def _super_ssm(self, p, h: torch.Tensor, rows: Optional[Rows]
                   ) -> torch.Tensor:
        for pm in _layers(p["mlstm"]):
            pm = self._g(pm, "blocks.mlstm")
            h = self._constrain(h + self._mlstm(
                pm["mlstm"], self._norm(pm["ln"], h)), rows)
        ps = self._g(p["slstm"], "blocks.slstm")
        return self._constrain(h + self._slstm(
            ps["slstm"], self._norm(ps["ln"], h)), rows)

    def _super_hybrid(self, p, h: torch.Tensor, shared, rows: Optional[Rows]
                      ) -> torch.Tensor:
        for pm in _layers(p):
            h = self._apply_mamba(self._g(pm, "blocks"), h, rows)
        return self._apply_dense(self._g(shared, "shared_attn"), h, rows)

    def _super_vlm(self, p, h: torch.Tensor, kv_src: torch.Tensor,
                   rows: Optional[Rows]) -> torch.Tensor:
        for ps in _layers(p["self"]):
            h = self._apply_dense(self._g(ps, "blocks.self"), h, rows)
        return self._apply_cross(self._g(p["cross"], "blocks.cross"), h,
                                 kv_src, rows)

    def _dec_block(self, p, h: torch.Tensor, enc: torch.Tensor,
                   rows: Optional[Rows]) -> torch.Tensor:
        h = h + self._attn(p["attn"], self._norm(p["ln1"], h))
        h = h + self._xattn(p["xattn"], self._norm(p["lnx"], h), enc)
        return self._constrain(h + self._mlp(p["mlp"],
                                             self._norm(p["ln2"], h)), rows)

    def _encode(self, params, enc_embeds: torch.Tensor, rows: Optional[Rows]
                ) -> torch.Tensor:
        enc = enc_embeds.to(L.dtype_of(self.cfg))
        block = _remat(self.cfg, self._gfn(
            functools.partial(self._apply_dense, causal=False),
            "enc_blocks"))
        for p in _layers(params["enc_blocks"]):
            enc = block(p, enc, rows)
        return self._norm(self._g(params["enc_norm"], "enc_norm"), enc)

    # -- training: full-sequence forward and loss --------------------------------

    def forward(self, params, batch: Dict[str, torch.Tensor],
                global_batch: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Final hidden states (B, S, d) after the final norm, and aux
        metrics (the MoE's ``moe_aux_loss`` and ``moe_drop_frac``, means
        over layers, of the global batch).  On a mesh ``batch`` holds this
        rank's rows of a batch of ``global_batch`` rows (default: the rows
        cut over every data-parallel axis)."""
        cfg = self.cfg
        lay = self._layout()
        dt = L.dtype_of(cfg)
        rows = self._enter(batch["tokens"].shape[0], global_batch)
        x = self._embed(params, batch["tokens"], rows)
        aux: Dict[str, torch.Tensor] = {}
        if "main" in lay and lay["main"][0] == "dense":
            block = _remat(cfg, self._gfn(self._apply_dense, "blocks"))
            for p in _layers(params["blocks"]):
                x = block(p, x, rows)
        elif "main" in lay:
            block = _remat(cfg, self._gfn(self._apply_moe, "blocks"))
            stats = []
            for p in _layers(params["blocks"]):
                x, st = block(p, x, rows)
                stats.append(st)
            for k in ("aux_loss", "drop_frac"):
                aux[f"moe_{k}"] = torch.mean(torch.stack([s[k]
                                                          for s in stats]))
        elif "super_ssm" in lay:
            block = _remat(cfg, self._super_ssm)
            for p in _layers(params["blocks"]):
                x = block(p, x, rows)
        elif "super_hybrid" in lay:
            block = _remat(cfg, self._super_hybrid)
            for p in _layers(params["blocks"]):
                x = block(p, x, params["shared_attn"], rows)
            if "tail" in params:
                block = _remat(cfg, self._gfn(self._apply_mamba, "tail"))
                for p in _layers(params["tail"]):
                    x = block(p, x, rows)
        elif "super_vlm" in lay:
            kv_src = batch["img_embeds"].to(dt)
            block = _remat(cfg, self._super_vlm)
            for p in _layers(params["blocks"]):
                x = block(p, x, kv_src, rows)
        else:
            enc = self._encode(params, batch["enc_embeds"], rows)
            block = _remat(cfg, self._gfn(self._dec_block, "dec_blocks"))
            for p in _layers(params["dec_blocks"]):
                x = block(p, x, enc, rows)
        return self._norm(self._g(params["final_norm"], "final_norm"),
                          x), aux

    def logits(self, params, batch, global_batch: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict]:
        """(B, S, V) logits; on a mesh this rank's rows and, under "2d"
        with the vocabulary cut over "model", this rank's vocab columns
        (``full_logits`` gathers them)."""
        x, aux = self.forward(params, batch, global_batch)
        return self._mask_pad(self._unembed(self._emb(params), x)), aux

    def _token_ce(self, emb, x: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
        """Per-token cross-entropy of hidden states ``x`` against
        ``labels`` (vocab-parallel when the vocabulary is cut)."""
        v = self.cfg.vocab_size
        if self._vocab_cut:
            return L.token_ce_vocab_parallel(
                self._unembed(emb, x), labels, v,
                self.tp.r * emb["tok"].shape[0], self.tp.group)
        return L._token_ce(L.unembed(emb, x), labels, v)

    def loss(self, params, batch, global_batch: Optional[int] = None
             ) -> Tuple[torch.Tensor, Dict]:
        """(mean token cross-entropy, plus 0.01 x the MoE aux loss; aux
        with ``ce``), through ``chunked_cross_entropy`` when
        ``cfg.loss_chunk > 0``.  On a mesh both are the global batch's, on
        every rank; each rank's gradient is its own rows' share (the
        data-parallel sum is ``train.steps``')."""
        cfg = self.cfg
        x, aux = self.forward(params, batch, global_batch)
        emb, labels = self._emb(params), batch["labels"]
        # this rank's share of the global mean: its rows' sum over the
        # global token count (rows repeated on data-parallel ranks that
        # do not cut the batch count once each)
        denom = float(labels.numel() * self.n_dp)
        if cfg.loss_chunk > 0:
            ce = L.chunked_cross_entropy(
                emb, x, labels, cfg.vocab_size, cfg.loss_chunk,
                token_ce=functools.partial(self._token_ce, emb), denom=denom)
        else:
            ce = torch.sum(self._token_ce(emb, x, labels)) / denom
        ce = comm.reduce_from_model(ce, self.dp_group)
        total = ce
        if "moe_aux_loss" in aux:
            total = total + 0.01 * aux["moe_aux_loss"]
        aux["ce"] = ce
        return total, aux

    # -- serving: cache protocol -------------------------------------------------

    def cache_defs(self, batch: int, max_seq: int,
                   enc_seq: Optional[int] = None) -> Dict[str, Any]:
        """The cache's nested dict of (shape, dtype) leaves (the audio
        family's cross cache ``enc_seq`` positions long, by default
        ``max_seq * enc_seq_factor``)."""
        cfg = self.cfg
        lay = self._layout()
        kv = A.kv_cache_defs(cfg, batch, max_seq)
        kvf = cfg.num_kv_heads * cfg.resolved_head_dim
        dt = L.dtype_of(cfg)

        def cross(n_pos: int) -> Dict[str, Spec]:
            return {"k": ((batch, n_pos, kvf), dt),
                    "v": ((batch, n_pos, kvf), dt)}

        out: Dict[str, Any] = {}
        if "main" in lay:
            out["blocks"] = _stack_specs(kv, lay["main"][1])
        if "super_ssm" in lay:
            n_super, n_m = lay["super_ssm"]
            out["blocks"] = _stack_specs(
                {"mlstm": _stack_specs(XL.mlstm_state_defs(cfg, batch), n_m),
                 "slstm": XL.slstm_state_defs(cfg, batch)}, n_super)
        if "super_hybrid" in lay:
            n_super, n_m = lay["super_hybrid"]
            mamba = SSM.mamba2_cache_defs(cfg, batch)
            out["blocks"] = _stack_specs(
                {"mamba": _stack_specs(mamba, n_m), "attn": kv}, n_super)
            if lay["tail_mamba"]:
                out["tail"] = _stack_specs(mamba, lay["tail_mamba"])
        if "super_vlm" in lay:
            n_super, n_s = lay["super_vlm"]
            out["blocks"] = _stack_specs(
                {"self": _stack_specs(kv, n_s),
                 "cross": cross(cfg.vlm.num_image_tokens)}, n_super)
        if "enc" in lay:
            if enc_seq is None:
                enc_seq = int(max_seq * cfg.encdec.enc_seq_factor)
            out["dec_blocks"] = _stack_specs(
                {"self": kv, "cross": cross(enc_seq)}, lay["dec"])
        return out

    def _split(self, cache_batch: int, max_seq: Optional[int] = None
               ) -> Optional[A.Split]:
        """How this rank's attention caches cut their positions (JAX's
        ``cache_shardings``): over "model" under tensor parallelism, else
        over "data" when the data-parallel axes do not divide the cache's
        ``cache_batch`` rows and "data" divides ``max_seq`` (JAX's
        long-context layout; the rows are then whole on every rank);
        None when the positions are whole."""
        if self.mesh is None:
            return None
        if self._tp_on:
            if max_seq is not None and max_seq % self.tp.n:
                raise ValueError(f"max_seq {max_seq} must divide over the "
                                 f"{self.tp.n} 'model' ranks that cut the "
                                 "cache")
            return A.split_of(self.tp)
        if R.fit_batch_axes(self.mesh, cache_batch, self.cfg.parallelism):
            return None
        max_seq = self._decode_seq() if max_seq is None else max_seq
        group, n = self.mesh.group("data"), self.mesh.shape["data"]
        if group is None or max_seq % n:
            return None
        return A.Split(group, n, self.mesh.index("data"))

    def _cache_stacks(self) -> Dict[str, Tuple[int, str]]:
        """Per cache stack (a path of keys): its stack depth and its kind,
        "attn" (attention caches, their positions cut by ``_split``),
        "state" (recurrent states) or "cross" (fixed cross caches)."""
        lay = self._layout()
        if "main" in lay:
            return {"blocks": (1, "attn")}
        if "super_ssm" in lay:
            return {"blocks.mlstm": (2, "state"), "blocks.slstm": (1, "state")}
        if "super_hybrid" in lay:
            return {"blocks.mamba": (2, "state"), "blocks.attn": (1, "attn"),
                    "tail": (1, "state")}
        if "super_vlm" in lay:
            return {"blocks.self": (2, "attn"), "blocks.cross": (1, "cross")}
        return {"dec_blocks.self": (1, "attn"),
                "dec_blocks.cross": (1, "cross")}

    def _cross_len(self, max_seq: int) -> int:
        """Positions of the cross cache this model's decode reads: the
        vlm's image tokens, the audio family's encoder positions (the
        last prefill's, else ``max_seq * enc_seq_factor``)."""
        if self.cfg.family == "vlm":
            return self.cfg.vlm.num_image_tokens
        if self._enc_seq is not None:
            return self._enc_seq
        return int(max_seq * self.cfg.encdec.enc_seq_factor)

    def _layouts(self, batch: int, max_seq: int
                 ) -> Tuple[Dict[str, Any], Dict[str, Any], bool]:
        """(the cache's layout as JAX's rule gives it, ``rules.
        cache_leaf_spec``; the layout the decode computes in; whether they
        differ) as spec trees of a cache of ``batch`` rows for
        ``max_seq``.  The compute layout holds this rank's rows
        (``batch_rows``), an attention cache's positions as ``_split``
        cuts them, a cross cache's positions over "data" under the
        long-context layout when they number ``max_seq``, and under tensor
        parallelism the dim ``A.cross_cut`` picks of a state or a cross
        cache over "model": JAX's rule on the dims' roles.  The two differ
        only where a dim's length happens to equal the batch's or
        ``max_seq`` (JAX finds the dims by length)."""
        enc = (self._cross_len(max_seq) if self.cfg.family == "audio"
               else None)
        key = (batch, max_seq, enc)
        if key in self._layout_memo:
            return self._layout_memo[key]
        defs = self.cache_defs(batch, max_seq, enc)
        policy, mesh = self.cfg.parallelism, self.mesh
        rows = R.spec_part(R.fit_batch_axes(mesh, batch, policy))
        split = self._split(batch, max_seq)
        axis = None if split is None else ("model" if self._tp_on else "data")

        def mine(shape, depth: int, kind: str) -> tuple:
            parts: list = [None] * len(shape)
            parts[depth] = rows
            per = shape[depth:]
            if kind == "attn":
                parts[depth + 1] = axis
            elif self._tp_on:
                c = A.cross_cut(per, max_seq, self.tp)
                if c is not None:
                    parts[depth + c] = "model"
            elif kind == "cross" and axis == "data" and per[1] == max_seq:
                parts[depth + 1] = "data"
            return tuple(parts)

        def walk(d, fn):
            if isinstance(d, tuple):
                return fn(d[0])
            return {k: walk(v, fn) for k, v in d.items()}
        jax_specs = walk(defs, lambda shape: R.cache_leaf_spec(
            shape, batch, max_seq, mesh, policy))
        compute = walk(defs, lambda shape: None)
        for path, (depth, kind) in self._cache_stacks().items():
            *up, last = path.split(".")
            node, out = defs, compute
            for k in up:
                node, out = node[k], out[k]
            if last in node:
                out[last] = {name: mine(shape, depth, kind)
                             for name, (shape, _) in node[last].items()}
        differ = any(R.effective(a, mesh) != R.effective(b, mesh)
                     for a, b in zip(R.spec_leaves(jax_specs),
                                     R.spec_leaves(compute)))
        self._layout_memo[key] = jax_specs, compute, differ
        return self._layout_memo[key]

    def _relayout(self, cache: Dict[str, Any], src: Dict[str, Any],
                  dst: Dict[str, Any], into: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
        """A cache whose leaves are laid out by the specs ``src`` -> laid
        out by ``dst``: a leaf whose specs differ is gathered whole and
        re-cut (every rank calls this, for the gathers), the others are
        themselves; with ``into``, each re-cut leaf is copied into its
        tensor there, in place."""
        mesh = self.mesh

        def walk(t, s, d, o):
            if not torch.is_tensor(t):
                return {k: walk(t[k], s[k], d[k], None if o is None else o[k])
                        for k in t}
            if R.effective(s, mesh) == R.effective(d, mesh):
                return t
            piece = R.local_slice(comm.whole(t, s, mesh), d, mesh)
            if o is None:
                return piece.contiguous()
            return o.copy_(piece)
        return walk(cache, src, dst, into)

    def init_cache(self, batch: int, max_seq: int, device) -> Dict[str, Any]:
        """A zero cache; on a mesh this rank's piece of it, every leaf
        laid out by JAX's ``cache_shardings`` (``launch.specs.
        cache_specs``): its shape is ``rules.local_shape`` of the leaf's
        under that spec."""
        self._max_seq, self._enc_seq = max_seq, None
        defs = self.cache_defs(batch, max_seq)
        if self.mesh is not None:
            specs = self._layouts(batch, max_seq)[0]

            def local(d, sp):
                if isinstance(d, tuple):
                    return R.local_shape(d[0], sp, self.mesh), d[1]
                return {k: local(d[k], sp[k]) for k in d}
            defs = local(defs, specs)

        def zeros(specs):
            if isinstance(specs, tuple):
                return torch.zeros(specs[0], dtype=specs[1], device=device)
            return {k: zeros(v) for k, v in specs.items()}
        return zeros(defs)

    def splice(self, cache: Dict[str, Any], part: Dict[str, Any], slot: int,
               batch: int) -> None:
        """Copy a request's prefilled cache ``part`` (one row, from
        ``prefill(..., cache_batch=batch)``) into row ``slot`` of
        ``cache`` (``init_cache(batch, ...)``), in place, along each
        leaf's batch axis.  On a mesh every rank calls it: the rank that
        holds the slot's row writes it, and a leaf whose JAX layout is not
        the compute layout is re-cut around the write."""
        if self.mesh is None:
            splice_rows(cache, part, slot)
            return
        jax_specs, compute, differ = self._layouts(batch, self._decode_seq())
        mine = (self._relayout(cache, jax_specs, compute) if differ
                else cache)
        lo, hi = self.batch_rows(batch)
        if lo <= slot < hi:
            splice_rows(mine, part, slot - lo)
        if differ:
            self._relayout(mine, compute, jax_specs, into=cache)

    def _piece(self, tree: Dict[str, torch.Tensor], max_seq: int
               ) -> Dict[str, torch.Tensor]:
        """Whole per-layer cache leaves (batch first) -> this rank's
        pieces under JAX's layout (``A.cross_cut``); themselves without
        tensor parallelism."""
        if not self._tp_on:
            return tree
        out = {}
        for name, t in tree.items():
            c = A.cross_cut(t.shape, max_seq, self.tp)
            if c is not None:
                k = t.shape[c] // self.tp.n
                t = t.narrow(c, self.tp.r * k, k)
            out[name] = t
        return out

    def _whole(self, tree: Dict[str, torch.Tensor], defs: Dict[str, Spec]
               ) -> Dict[str, torch.Tensor]:
        """This rank's pieces of per-layer cache leaves whose whole
        shapes are ``defs`` -> the whole leaves (gathered over
        "model")."""
        out = {}
        for name, t in tree.items():
            c = A.cross_cut(defs[name][0], self._decode_seq(), self.tp)
            out[name] = (t if c is None
                         else comm.all_gather(t, c, self.tp.group))
        return out

    def _decode_seq(self) -> int:
        if self._max_seq is None:
            raise ValueError("the cache's layout is JAX's for the max_seq it "
                             "was made with: init_cache or prefill first")
        return self._max_seq

    def _cross_kv(self, p, kv_src: torch.Tensor, max_seq: int,
                  split: Optional[A.Split] = None) -> Dict[str, torch.Tensor]:
        """This rank's piece of a fixed cross cache of ``kv_src``: as
        ``A.cross_kv_tp`` lays it out under tensor parallelism, else its
        range of the positions when ``split`` cuts them over "data" and
        they number ``max_seq`` (the long-context layout), else whole."""
        if self._tp_on:
            return A.cross_kv_tp(self.cfg, p, kv_src, max_seq, self.tp)
        if split is not None and kv_src.shape[1] == max_seq:
            n_loc = max_seq // split.n
            kv_src = kv_src.narrow(1, split.r * n_loc, n_loc)
        return {"k": L.linear(p["k"], kv_src), "v": L.linear(p["v"], kv_src)}

    # -- prefill -----------------------------------------------------------------

    def _prefill_self(self, p, h: torch.Tensor, max_seq: int,
                      rows: Optional[Rows], split: Optional[A.Split]):
        """A block's self-attention over the prompt: (h plus it, its
        cache entries, this rank's positions of ``split``)."""
        hn = self._norm(p["ln1"], h)
        if split is not None:
            a, kv = A.prefill_self_attention_split(self.cfg, p["attn"], hn,
                                                   max_seq, split, self.tp)
        else:
            a, kv = A.prefill_self_attention(self.cfg, p["attn"], hn, max_seq)
        return self._constrain(h + a, rows), kv

    def _prefill_attn(self, p, h: torch.Tensor, max_seq: int,
                      rows: Optional[Rows], split: Optional[A.Split]):
        """A dense block over the prompt: (h, its cache entries)."""
        h, kv = self._prefill_self(p, h, max_seq, rows, split)
        return self._constrain(h + self._mlp(p["mlp"],
                                             self._norm(p["ln2"], h)),
                               rows), kv

    def _prefill_mamba(self, pm, h: torch.Tensor, max_seq: int,
                       rows: Optional[Rows]):
        cfg = self.cfg
        hn = self._norm(pm["ln"], h)
        if self._tp_on:
            y, s_fin, tail = SSM.apply_mamba2_tp(cfg, pm["mamba"], hn, self.tp,
                                                 with_state=True)
        else:
            y, s_fin = SSM.apply_mamba2_with_state(cfg, pm["mamba"], hn)
            tail = SSM.conv_tail(cfg, pm["mamba"], hn)
        return self._constrain(h + y, rows), self._piece(
            {"state": s_fin, "conv": tail}, max_seq)

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int,
                global_batch: Optional[int] = None,
                cache_batch: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process the prompt ``batch["tokens"]`` (B, S): last-position
        logits (B, 1, V) and the cache filled up to S (zero beyond), the
        recurrent states after the prompt and the cross caches (on a mesh,
        this rank's piece in ``init_cache``'s layout of a cache of
        ``cache_batch`` rows, default the call's global batch: the engine
        prefills one request into its cache of every slot;
        ``global_batch`` as ``forward``)."""
        cfg = self.cfg
        lay = self._layout()
        dt = L.dtype_of(cfg)
        rows = self._enter(batch["tokens"].shape[0], global_batch)
        cache_rows = (None if rows is None else
                      rows.B if cache_batch is None else cache_batch)
        split = None if rows is None else self._split(cache_rows, max_seq)
        self._max_seq = max_seq
        self._enc_seq = (batch["enc_embeds"].shape[1] if "enc" in lay
                         else None)
        x = self._embed(params, batch["tokens"], rows)
        g = self._g
        if "main" in lay and lay["main"][0] == "dense":
            kvs = []
            for p in _layers(params["blocks"]):
                x, kv = self._prefill_attn(g(p, "blocks"), x, max_seq, rows,
                                           split)
                kvs.append(kv)
            cache = {"blocks": _stacked(kvs)}
        elif "main" in lay:
            kvs = []
            for p in _layers(params["blocks"]):
                p = g(p, "blocks")
                x, kv = self._prefill_self(p, x, max_seq, rows, split)
                x = self._constrain(x + self._moe(
                    p["moe"], self._norm(p["ln2"], x), rows)[0], rows)
                kvs.append(kv)
            cache = {"blocks": _stacked(kvs)}
        elif "super_ssm" in lay:
            supers = []
            for p in _layers(params["blocks"]):
                mc = []
                for pm in _layers(p["mlstm"]):
                    pm = g(pm, "blocks.mlstm")
                    y, st = self._mlstm(pm["mlstm"], self._norm(pm["ln"], x),
                                        with_state=True)
                    x = self._constrain(x + y, rows)
                    mc.append(self._piece(st, max_seq))
                ps = g(p["slstm"], "blocks.slstm")
                y, sc = self._slstm(ps["slstm"], self._norm(ps["ln"], x),
                                    with_state=True)
                x = self._constrain(x + y, rows)
                supers.append({"mlstm": _stacked(mc),
                               "slstm": self._piece(sc, max_seq)})
            cache = {"blocks": _stacked(supers)}
        elif "super_hybrid" in lay:
            shared = g(params["shared_attn"], "shared_attn")
            supers = []
            for p in _layers(params["blocks"]):
                mc = []
                for pm in _layers(p):
                    x, st = self._prefill_mamba(g(pm, "blocks"), x, max_seq,
                                                rows)
                    mc.append(st)
                x, kv = self._prefill_attn(shared, x, max_seq, rows, split)
                supers.append({"mamba": _stacked(mc), "attn": kv})
            cache = {"blocks": _stacked(supers)}
            if "tail" in params:
                tc = []
                for pm in _layers(params["tail"]):
                    x, st = self._prefill_mamba(g(pm, "tail"), x, max_seq,
                                                rows)
                    tc.append(st)
                cache["tail"] = _stacked(tc)
        elif "super_vlm" in lay:
            kv_src = batch["img_embeds"].to(dt)
            supers = []
            for p in _layers(params["blocks"]):
                kvs = []
                for ps in _layers(p["self"]):
                    x, kv = self._prefill_attn(g(ps, "blocks.self"), x,
                                               max_seq, rows, split)
                    kvs.append(kv)
                pc = g(p["cross"], "blocks.cross")
                x = self._apply_cross(pc, x, kv_src, rows)
                supers.append({"self": _stacked(kvs), "cross": self._cross_kv(
                    pc["xattn"], kv_src, max_seq, split)})
            cache = {"blocks": _stacked(supers)}
        else:
            enc = self._encode(params, batch["enc_embeds"], rows)
            decs = []
            for p in _layers(params["dec_blocks"]):
                p = g(p, "dec_blocks")
                x, kv = self._prefill_self(p, x, max_seq, None, split)
                x = x + self._xattn(p["xattn"], self._norm(p["lnx"], x), enc)
                x = self._constrain(x + self._mlp(p["mlp"],
                                                  self._norm(p["ln2"], x)),
                                    rows)
                decs.append({"self": kv,
                             "cross": self._cross_kv(p["xattn"], enc,
                                                     max_seq, split)})
            cache = {"dec_blocks": _stacked(decs)}
        if rows is not None and cache_rows == rows.B:
            jax_specs, compute, differ = self._layouts(cache_rows, max_seq)
            if differ:
                cache = self._relayout(cache, compute, jax_specs)
        return self._logits(params, x[:, -1:]), cache

    # -- decode ------------------------------------------------------------------

    def decode(self, params, tokens: torch.Tensor, cache: Dict[str, Any],
               pos: int, *, rows: Optional[Iterable[int]] = None,
               use_kernel: bool = True, global_batch: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step: tokens (B, 1) at position ``pos`` (an int, the
        same for every row).  Each attention layer attends over its cache
        below ``pos`` plus the fresh token, each recurrent layer steps its
        state; then the fresh entries (at ``pos``) and the new states are
        written in place for ``rows`` (every row when None, none when
        empty): the other rows' cache is left as it was, every leaf.
        Returns (logits (B, 1, V), cache).  On a mesh ``tokens``,
        ``cache`` and ``rows`` are this rank's (local row indices), the
        attention layers decode over this rank's positions of the cache,
        a recurrent layer over its heads of the gathered state, and every
        rank calls each decode, with or without rows of its own."""
        cfg = self.cfg
        pos = int(pos)   # audit: allow(host-sync) the caller's host position
        held = self._enter(tokens.shape[0], global_batch)
        x = self._embed(params, tokens, held)
        if rows is not None:
            rows = torch.as_tensor(list(rows), dtype=torch.long,
                                   device=x.device)
        norm, g, tp = self._norm, self._g, self.tp
        b = x.shape[0]
        split = None if held is None else self._split(held.B)
        ours = cache
        layouts = (None if held is None
                   else self._layouts(held.B, self._decode_seq()))
        if layouts is not None and layouts[2]:
            cache = self._relayout(cache, layouts[0], layouts[1])

        def attn(p, c, h):
            hn = norm(p["ln1"], h)
            if split is not None:
                a, ntok, at = A.decode_self_attention_read_split(
                    cfg, p["attn"], hn, c, pos, split, tp,
                    use_kernel=use_kernel)
                if at is not None:
                    _put_token(c, ntok, at, rows)
                return h + a
            a, ntok = A.decode_self_attention_read(
                cfg, p["attn"], hn, c, pos, use_kernel=use_kernel)
            _put_token(c, ntok, pos, rows)
            return h + a

        def dense(p, c, h):
            h = attn(p, c, h)
            return h + self._mlp(p["mlp"], norm(p["ln2"], h))

        def step(c, fn, p, hn, defs):
            """A recurrent layer's step: on this rank's heads of the
            gathered state under tensor parallelism, its piece of the new
            state written back."""
            if not self._tp_on:
                y, st = fn(cfg, p, hn, c)
            else:
                y, st = fn(cfg, p, hn, self._whole(c, defs), tp)
                st = self._piece(st, self._decode_seq())
            _put_state(c, st, rows)
            return y

        def mamba(pm, c, h):
            fn = SSM.decode_mamba2_tp if self._tp_on else SSM.decode_mamba2
            return h + step(c, fn, pm["mamba"], norm(pm["ln"], h),
                            SSM.mamba2_cache_defs(cfg, b))

        def cross(p, c, hn):
            if self._tp_on:
                return A.decode_cross_attention_tp(
                    cfg, p, hn, c, self._decode_seq(), tp, use_kernel)
            if (split is not None
                    and self._cross_len(self._decode_seq())
                    == self._decode_seq()):
                return A.decode_cross_attention_split(cfg, p, hn, c, split,
                                                      use_kernel)
            return A.decode_cross_attention(cfg, p, hn, c, use_kernel)

        lay = self._layout()
        if "main" in lay:
            for p, c in zip(_layers(params["blocks"]),
                            _layers(cache["blocks"])):
                p = g(p, "blocks")
                if lay["main"][0] == "dense":
                    x = dense(p, c, x)
                else:
                    x = attn(p, c, x)
                    x = x + self._moe(p["moe"], norm(p["ln2"], x),
                                      held)[0]
        elif "super_ssm" in lay:
            mfn = XL.decode_mlstm_tp if self._tp_on else XL.decode_mlstm
            sfn = XL.decode_slstm_tp if self._tp_on else XL.decode_slstm
            for p, c in zip(_layers(params["blocks"]),
                            _layers(cache["blocks"])):
                for pm, cm in zip(_layers(p["mlstm"]), _layers(c["mlstm"])):
                    pm = g(pm, "blocks.mlstm")
                    x = x + step(cm, mfn, pm["mlstm"], norm(pm["ln"], x),
                                 XL.mlstm_state_defs(cfg, b))
                ps = g(p["slstm"], "blocks.slstm")
                x = x + step(c["slstm"], sfn, ps["slstm"], norm(ps["ln"], x),
                             XL.slstm_state_defs(cfg, b))
        elif "super_hybrid" in lay:
            shared = g(params["shared_attn"], "shared_attn")
            for p, c in zip(_layers(params["blocks"]),
                            _layers(cache["blocks"])):
                for pm, cm in zip(_layers(p), _layers(c["mamba"])):
                    x = mamba(g(pm, "blocks"), cm, x)
                x = dense(shared, c["attn"], x)
            if "tail" in params:
                for pm, cm in zip(_layers(params["tail"]),
                                  _layers(cache["tail"])):
                    x = mamba(g(pm, "tail"), cm, x)
        elif "super_vlm" in lay:
            for p, c in zip(_layers(params["blocks"]),
                            _layers(cache["blocks"])):
                for ps, cc in zip(_layers(p["self"]), _layers(c["self"])):
                    x = dense(g(ps, "blocks.self"), cc, x)
                pc = g(p["cross"], "blocks.cross")
                gate = torch.tanh(pc["gate"]).to(x.dtype)
                x = x + gate * cross(pc["xattn"], c["cross"],
                                     norm(pc["ln1"], x))
                x = x + self._mlp(pc["mlp"], norm(pc["ln2"], x))
        else:
            for p, c in zip(_layers(params["dec_blocks"]),
                            _layers(cache["dec_blocks"])):
                p = g(p, "dec_blocks")
                x = attn(p, c["self"], x)
                x = x + cross(p["xattn"], c["cross"], norm(p["lnx"], x))
                x = x + self._mlp(p["mlp"], norm(p["ln2"], x))
        if layouts is not None and layouts[2]:
            self._relayout(cache, layouts[1], layouts[0], into=ours)
        return self._logits(params, x), ours
