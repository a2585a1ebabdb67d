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
``_constrain`` and the mesh have no counterpart: the port runs on one
card, where nothing is sharded.

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
from typing import Any, Dict, Iterable, List, Optional, Tuple

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

Spec = Tuple[Tuple[int, ...], torch.dtype]     # a cache leaf: shape, dtype


def _stack(defs: Any, n: int) -> Any:
    return map_defs(lambda d: ParamDef((n,) + d.shape, d.init, d.scale,
                                       d.dtype), defs)


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


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- construction ----------------------------------------------------------

    def _mask_pad(self, logits: torch.Tensor) -> torch.Tensor:
        """Mask padded vocab rows so sampling never emits them."""
        v = self.cfg.vocab_size
        if logits.shape[-1] > v:
            pad = torch.arange(logits.shape[-1], device=logits.device) >= v
            logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
        return logits

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
                    "gate": ParamDef((1,), "zeros")}
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
        """Seeded random weights on ``generator.device``."""
        return init_params_generator(self.param_defs(), generator)

    # -- block applications (full sequence) --------------------------------------

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed(params["embed"], tokens).to(L.dtype_of(self.cfg))

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return self._mask_pad(L.unembed(params["embed"], x))

    def _norm(self, p, x: torch.Tensor) -> torch.Tensor:
        return L.rmsnorm(p, x, self.cfg.norm_eps)

    def _apply_dense(self, p, x: torch.Tensor, causal: bool = True
                     ) -> torch.Tensor:
        cfg = self.cfg
        h = x + A.self_attention(cfg, p["attn"], self._norm(p["ln1"], x),
                                 causal=causal)
        return h + L.swiglu(p["mlp"], self._norm(p["ln2"], h))

    def _apply_moe(self, p, x: torch.Tensor):
        cfg = self.cfg
        h = x + A.self_attention(cfg, p["attn"], self._norm(p["ln1"], x))
        y, stats = MOE.apply_moe(cfg, p["moe"], self._norm(p["ln2"], h))
        return h + y, stats

    def _apply_mamba(self, p, x: torch.Tensor) -> torch.Tensor:
        return x + SSM.apply_mamba2(self.cfg, p["mamba"],
                                    self._norm(p["ln"], x))

    def _apply_cross(self, p, x: torch.Tensor, kv_src: torch.Tensor
                     ) -> torch.Tensor:
        g = torch.tanh(p["gate"]).to(x.dtype)
        h = x + g * A.cross_attention(self.cfg, p["xattn"],
                                      self._norm(p["ln1"], x), kv_src)
        return h + L.swiglu(p["mlp"], self._norm(p["ln2"], h))

    def _super_ssm(self, p, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        for pm in _layers(p["mlstm"]):
            h = h + XL.apply_mlstm(cfg, pm["mlstm"], self._norm(pm["ln"], h))
        ps = p["slstm"]
        return h + XL.apply_slstm(cfg, ps["slstm"], self._norm(ps["ln"], h))

    def _super_hybrid(self, p, h: torch.Tensor, shared) -> torch.Tensor:
        for pm in _layers(p):
            h = self._apply_mamba(pm, h)
        return self._apply_dense(shared, h)

    def _super_vlm(self, p, h: torch.Tensor, kv_src: torch.Tensor
                   ) -> torch.Tensor:
        for ps in _layers(p["self"]):
            h = self._apply_dense(ps, h)
        return self._apply_cross(p["cross"], h, kv_src)

    def _dec_block(self, p, h: torch.Tensor, enc: torch.Tensor
                   ) -> torch.Tensor:
        cfg = self.cfg
        h = h + A.self_attention(cfg, p["attn"], self._norm(p["ln1"], h))
        h = h + A.cross_attention(cfg, p["xattn"], self._norm(p["lnx"], h),
                                  enc)
        return h + L.swiglu(p["mlp"], self._norm(p["ln2"], h))

    def _encode(self, params, enc_embeds: torch.Tensor) -> torch.Tensor:
        enc = enc_embeds.to(L.dtype_of(self.cfg))
        block = _remat(self.cfg, functools.partial(self._apply_dense,
                                                   causal=False))
        for p in _layers(params["enc_blocks"]):
            enc = block(p, enc)
        return self._norm(params["enc_norm"], enc)

    # -- training: full-sequence forward and loss --------------------------------

    def forward(self, params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Final hidden states (B, S, d) after the final norm, and aux
        metrics (the MoE's ``moe_aux_loss`` and ``moe_drop_frac``)."""
        cfg = self.cfg
        lay = self._layout()
        dt = L.dtype_of(cfg)
        x = self._embed(params, batch["tokens"])
        aux: Dict[str, torch.Tensor] = {}
        if "main" in lay and lay["main"][0] == "dense":
            block = _remat(cfg, self._apply_dense)
            for p in _layers(params["blocks"]):
                x = block(p, x)
        elif "main" in lay:
            block = _remat(cfg, self._apply_moe)
            stats = []
            for p in _layers(params["blocks"]):
                x, st = block(p, x)
                stats.append(st)
            for k in ("aux_loss", "drop_frac"):
                aux[f"moe_{k}"] = torch.mean(torch.stack([s[k]
                                                          for s in stats]))
        elif "super_ssm" in lay:
            block = _remat(cfg, self._super_ssm)
            for p in _layers(params["blocks"]):
                x = block(p, x)
        elif "super_hybrid" in lay:
            block = _remat(cfg, self._super_hybrid)
            for p in _layers(params["blocks"]):
                x = block(p, x, params["shared_attn"])
            if "tail" in params:
                block = _remat(cfg, self._apply_mamba)
                for p in _layers(params["tail"]):
                    x = block(p, x)
        elif "super_vlm" in lay:
            kv_src = batch["img_embeds"].to(dt)
            block = _remat(cfg, self._super_vlm)
            for p in _layers(params["blocks"]):
                x = block(p, x, kv_src)
        else:
            enc = self._encode(params, batch["enc_embeds"])
            block = _remat(cfg, self._dec_block)
            for p in _layers(params["dec_blocks"]):
                x = block(p, x, enc)
        return self._norm(params["final_norm"], x), aux

    def logits(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        x, aux = self.forward(params, batch)
        return self._mask_pad(L.unembed(params["embed"], x)), aux

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """(mean token cross-entropy, plus 0.01 x the MoE aux loss; aux
        with ``ce``)."""
        cfg = self.cfg
        if cfg.loss_chunk > 0:
            x, aux = self.forward(params, batch)
            ce = L.chunked_cross_entropy(params["embed"], x, batch["labels"],
                                         cfg.vocab_size, cfg.loss_chunk)
        else:
            logits, aux = self.logits(params, batch)
            ce = L.cross_entropy(logits, batch["labels"], cfg.vocab_size)
        total = ce
        if "moe_aux_loss" in aux:
            total = total + 0.01 * aux["moe_aux_loss"]
        aux["ce"] = ce
        return total, aux

    # -- serving: cache protocol -------------------------------------------------

    def cache_defs(self, batch: int, max_seq: int) -> Dict[str, Any]:
        """The cache's nested dict of (shape, dtype) leaves."""
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
            enc_seq = int(max_seq * cfg.encdec.enc_seq_factor)
            out["dec_blocks"] = _stack_specs(
                {"self": kv, "cross": cross(enc_seq)}, lay["dec"])
        return out

    def init_cache(self, batch: int, max_seq: int, device) -> Dict[str, Any]:
        def zeros(specs):
            if isinstance(specs, tuple):
                return torch.zeros(specs[0], dtype=specs[1], device=device)
            return {k: zeros(v) for k, v in specs.items()}
        return zeros(self.cache_defs(batch, max_seq))

    def _cross_kv(self, p, kv_src: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"k": L.linear(p["k"], kv_src), "v": L.linear(p["v"], kv_src)}

    # -- prefill -----------------------------------------------------------------

    def _prefill_attn(self, p, h: torch.Tensor, max_seq: int):
        """A dense block over the prompt: (h, its cache entries)."""
        a, kv = A.prefill_self_attention(self.cfg, p["attn"],
                                         self._norm(p["ln1"], h), max_seq)
        h = h + a
        return h + L.swiglu(p["mlp"], self._norm(p["ln2"], h)), kv

    def _prefill_mamba(self, pm, h: torch.Tensor):
        cfg = self.cfg
        hn = self._norm(pm["ln"], h)
        y, s_fin = SSM.apply_mamba2_with_state(cfg, pm["mamba"], hn)
        return h + y, {"state": s_fin,
                       "conv": SSM.conv_tail(cfg, pm["mamba"], hn)}

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process the prompt ``batch["tokens"]`` (B, S): last-position
        logits (B, 1, V) and the cache filled up to S (zero beyond), the
        recurrent states after the prompt and the cross caches."""
        cfg = self.cfg
        lay = self._layout()
        dt = L.dtype_of(cfg)
        x = self._embed(params, batch["tokens"])
        if "main" in lay:
            kind = lay["main"][0]
            kvs = []
            for p in _layers(params["blocks"]):
                a, kv = A.prefill_self_attention(
                    cfg, p["attn"], self._norm(p["ln1"], x), max_seq)
                x = x + a
                h2 = self._norm(p["ln2"], x)
                x = x + (L.swiglu(p["mlp"], h2) if kind == "dense"
                         else MOE.apply_moe(cfg, p["moe"], h2)[0])
                kvs.append(kv)
            cache = {"blocks": _stacked(kvs)}
        elif "super_ssm" in lay:
            supers = []
            for p in _layers(params["blocks"]):
                mc = []
                for pm in _layers(p["mlstm"]):
                    y, st = XL.apply_mlstm_with_state(
                        cfg, pm["mlstm"], self._norm(pm["ln"], x))
                    x = x + y
                    mc.append(st)
                ps = p["slstm"]
                y, sc = XL.apply_slstm_with_state(cfg, ps["slstm"],
                                                  self._norm(ps["ln"], x))
                x = x + y
                supers.append({"mlstm": _stacked(mc), "slstm": sc})
            cache = {"blocks": _stacked(supers)}
        elif "super_hybrid" in lay:
            shared = params["shared_attn"]
            supers = []
            for p in _layers(params["blocks"]):
                mc = []
                for pm in _layers(p):
                    x, st = self._prefill_mamba(pm, x)
                    mc.append(st)
                x, kv = self._prefill_attn(shared, x, max_seq)
                supers.append({"mamba": _stacked(mc), "attn": kv})
            cache = {"blocks": _stacked(supers)}
            if "tail" in params:
                tc = []
                for pm in _layers(params["tail"]):
                    x, st = self._prefill_mamba(pm, x)
                    tc.append(st)
                cache["tail"] = _stacked(tc)
        elif "super_vlm" in lay:
            kv_src = batch["img_embeds"].to(dt)
            supers = []
            for p in _layers(params["blocks"]):
                kvs = []
                for ps in _layers(p["self"]):
                    x, kv = self._prefill_attn(ps, x, max_seq)
                    kvs.append(kv)
                x = self._apply_cross(p["cross"], x, kv_src)
                supers.append({"self": _stacked(kvs), "cross": self._cross_kv(
                    p["cross"]["xattn"], kv_src)})
            cache = {"blocks": _stacked(supers)}
        else:
            enc = self._encode(params, batch["enc_embeds"])
            decs = []
            for p in _layers(params["dec_blocks"]):
                a, kv = A.prefill_self_attention(
                    cfg, p["attn"], self._norm(p["ln1"], x), max_seq)
                x = x + a
                x = x + A.cross_attention(cfg, p["xattn"],
                                          self._norm(p["lnx"], x), enc)
                x = x + L.swiglu(p["mlp"], self._norm(p["ln2"], x))
                decs.append({"self": kv,
                             "cross": self._cross_kv(p["xattn"], enc)})
            cache = {"dec_blocks": _stacked(decs)}
        return self._logits(params, x[:, -1:]), cache

    # -- decode ------------------------------------------------------------------

    def decode(self, params, tokens: torch.Tensor, cache: Dict[str, Any],
               pos: int, *, rows: Optional[Iterable[int]] = None,
               use_kernel: bool = True
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step: tokens (B, 1) at position ``pos`` (an int, the
        same for every row).  Each attention layer attends over its cache
        below ``pos`` plus the fresh token, each recurrent layer steps its
        state; then the fresh entries (at ``pos``) and the new states are
        written in place for ``rows`` (every row when None, none when
        empty): the other rows' cache is left as it was, every leaf.
        Returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        pos = int(pos)
        x = self._embed(params, tokens)
        if rows is not None:
            rows = torch.as_tensor(list(rows), dtype=torch.long,
                                   device=x.device)
        norm = self._norm

        def attn(p, c, h):
            a, ntok = A.decode_self_attention_read(
                cfg, p["attn"], norm(p["ln1"], h), c, pos,
                use_kernel=use_kernel)
            _put_token(c, ntok, pos, rows)
            return h + a

        def dense(p, c, h):
            h = attn(p, c, h)
            return h + L.swiglu(p["mlp"], norm(p["ln2"], h))

        def mamba(pm, c, h):
            y, st = SSM.decode_mamba2(cfg, pm["mamba"], norm(pm["ln"], h), c)
            _put_state(c, st, rows)
            return h + y

        lay = self._layout()
        if "main" in lay:
            for p, c in zip(_layers(params["blocks"]),
                            _layers(cache["blocks"])):
                if lay["main"][0] == "dense":
                    x = dense(p, c, x)
                else:
                    x = attn(p, c, x)
                    x = x + MOE.apply_moe(cfg, p["moe"],
                                          norm(p["ln2"], x))[0]
        elif "super_ssm" in lay:
            for p, c in zip(_layers(params["blocks"]),
                            _layers(cache["blocks"])):
                for pm, cm in zip(_layers(p["mlstm"]), _layers(c["mlstm"])):
                    y, st = XL.decode_mlstm(cfg, pm["mlstm"],
                                            norm(pm["ln"], x), cm)
                    _put_state(cm, st, rows)
                    x = x + y
                ps = p["slstm"]
                y, st = XL.decode_slstm(cfg, ps["slstm"], norm(ps["ln"], x),
                                        c["slstm"])
                _put_state(c["slstm"], st, rows)
                x = x + y
        elif "super_hybrid" in lay:
            shared = params["shared_attn"]
            for p, c in zip(_layers(params["blocks"]),
                            _layers(cache["blocks"])):
                for pm, cm in zip(_layers(p), _layers(c["mamba"])):
                    x = mamba(pm, cm, x)
                x = dense(shared, c["attn"], x)
            if "tail" in params:
                for pm, cm in zip(_layers(params["tail"]),
                                  _layers(cache["tail"])):
                    x = mamba(pm, cm, x)
        elif "super_vlm" in lay:
            for p, c in zip(_layers(params["blocks"]),
                            _layers(cache["blocks"])):
                for ps, cs in zip(_layers(p["self"]), _layers(c["self"])):
                    x = dense(ps, cs, x)
                pc = p["cross"]
                g = torch.tanh(pc["gate"]).to(x.dtype)
                x = x + g * A.decode_cross_attention(
                    cfg, pc["xattn"], norm(pc["ln1"], x), c["cross"],
                    use_kernel)
                x = x + L.swiglu(pc["mlp"], norm(pc["ln2"], x))
        else:
            for p, c in zip(_layers(params["dec_blocks"]),
                            _layers(cache["dec_blocks"])):
                x = attn(p, c["self"], x)
                x = x + A.decode_cross_attention(
                    cfg, p["xattn"], norm(p["lnx"], x), c["cross"],
                    use_kernel)
                x = x + L.swiglu(p["mlp"], norm(p["ln2"], x))
        return self._logits(params, x), cache
