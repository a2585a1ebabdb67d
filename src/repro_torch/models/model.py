"""The LM (``repro.models.model.LM``), dense family: training and serving.

Parameters are a nested dict of tensors with the JAX tree's names and
layout: the per-layer parameters stacked on a leading layer axis under
``"blocks"``, linear weights ``(d_in, d_out)``.  The cache is
``{"blocks": {"k", "v"}}`` of shape ``(L, B, S, KV*hd)``.  JAX's
``lax.scan`` over the stacked layers becomes a Python loop over views of
the stacked tensors.  ``_constrain`` and the mesh have no counterpart:
the port runs on one card, where nothing is sharded.

Training: ``forward`` (final hidden states), ``logits`` and ``loss``
(``(total, aux)`` with ``aux["ce"]``, through ``chunked_cross_entropy``
when ``cfg.loss_chunk > 0``); gradients come from autograd.  Each layer
is wrapped by ``_remat`` as JAX wraps its scan body: ``"none"`` keeps
every activation, ``"dots"`` saves the outputs of the matrix products
with no batch dimension (``aten.mm``: the projections and the MLP) and
recomputes the rest, anything else (``"minimal"``) saves only the
layer's input and recomputes the layer in backward.

``decode`` takes the flash-decode kernel route (``use_kernel=True``, the
JAX option of ``decode_self_attention_read``) and writes each layer's
fresh token into the cache in place, in the rows asked for; the JAX
``LM.decode`` returns a new cache with every row written.  Other families
(moe, ssm, hybrid, vlm, audio) are not ported yet, nor is the int8
cache, which raises where a cache is made, so an int8-cache config still
trains (``ROADMAP.md``, Queue A item 7).
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


def _stack(defs: Any, n: int) -> Any:
    return map_defs(lambda d: ParamDef((n,) + d.shape, d.init, d.scale,
                                       d.dtype), defs)


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a nested dict of stacked tensors (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}


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


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md, Queue "
                f"A item 7); the port's LM runs the dense family")
        self.cfg = cfg

    # -- construction ----------------------------------------------------------

    def _mask_pad(self, logits: torch.Tensor) -> torch.Tensor:
        """Mask padded vocab rows so sampling never emits them."""
        v = self.cfg.vocab_size
        if logits.shape[-1] > v:
            pad = torch.arange(logits.shape[-1], device=logits.device) >= v
            logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
        return logits

    def _block_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {"ln1": L.rmsnorm_defs(cfg.d_model), "attn": A.attn_defs(cfg),
                "ln2": L.rmsnorm_defs(cfg.d_model), "mlp": L.swiglu_defs(cfg)}

    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {"embed": L.embed_defs(cfg),
                "final_norm": L.rmsnorm_defs(cfg.d_model),
                "blocks": _stack(self._block_defs(), cfg.num_layers)}

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded random weights on ``generator.device``."""
        return init_params_generator(self.param_defs(), generator)

    def _layers(self, params) -> List[Dict[str, Any]]:
        return [_index(params["blocks"], i)
                for i in range(self.cfg.num_layers)]

    # -- serving: cache protocol -------------------------------------------------

    def cache_defs(self, batch: int, max_seq: int) -> Dict[str, Any]:
        n = self.cfg.num_layers
        return {"blocks": {k: ((n,) + shape, dt) for k, (shape, dt) in
                           A.kv_cache_defs(self.cfg, batch, max_seq).items()}}

    def init_cache(self, batch: int, max_seq: int, device) -> Dict[str, Any]:
        return {"blocks": {k: torch.zeros(shape, dtype=dt, device=device)
                           for k, (shape, dt) in
                           self.cache_defs(batch, max_seq)["blocks"].items()}}

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed(params["embed"], tokens).to(L.dtype_of(self.cfg))

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return self._mask_pad(L.unembed(params["embed"], x))

    # -- training: full-sequence forward and loss --------------------------------

    def _apply_dense(self, p, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = x + A.self_attention(cfg, p["attn"],
                                 L.rmsnorm(p["ln1"], x, cfg.norm_eps))
        return h + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], h, cfg.norm_eps))

    def forward(self, params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Final hidden states (B, S, d) after the final norm, and aux
        metrics (none for the dense family)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        block = _remat(cfg, self._apply_dense)
        for p in self._layers(params):
            x = block(p, x)
        return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), {}

    def logits(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        x, aux = self.forward(params, batch)
        return self._mask_pad(L.unembed(params["embed"], x)), aux

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """(mean token cross-entropy, aux with ``ce``)."""
        cfg = self.cfg
        if cfg.loss_chunk > 0:
            x, aux = self.forward(params, batch)
            ce = L.chunked_cross_entropy(params["embed"], x, batch["labels"],
                                         cfg.vocab_size, cfg.loss_chunk)
        else:
            logits, aux = self.logits(params, batch)
            ce = L.cross_entropy(logits, batch["labels"], cfg.vocab_size)
        aux["ce"] = ce
        return ce, aux

    # -- prefill -----------------------------------------------------------------

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process the prompt ``batch["tokens"]`` (B, S): last-position
        logits (B, 1, V) and the cache filled up to S, zero beyond."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        ks, vs = [], []
        for p in self._layers(params):
            a, kv = A.prefill_self_attention(
                cfg, p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), max_seq)
            x = x + a
            x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
            ks.append(kv["k"])
            vs.append(kv["v"])
        cache = {"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        return self._logits(params, x[:, -1:]), cache

    # -- decode ------------------------------------------------------------------

    def decode(self, params, tokens: torch.Tensor, cache: Dict[str, Any],
               pos: int, *, rows: Optional[Iterable[int]] = None,
               use_kernel: bool = True
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step: tokens (B, 1) at position ``pos`` (an int, the
        same for every row).  Each layer attends over its cache below
        ``pos`` plus the fresh token, then writes the fresh k/v at ``pos``
        in place for ``rows`` (every row when None, none when empty).
        Returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        pos = int(pos)
        x = self._embed(params, tokens)
        blocks = cache["blocks"]
        if rows is not None:
            rows = torch.as_tensor(list(rows), dtype=torch.long,
                                   device=x.device)
        for i, p in enumerate(self._layers(params)):
            c = {"k": blocks["k"][i], "v": blocks["v"][i]}
            a, ntok = A.decode_self_attention_read(
                cfg, p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), c, pos,
                use_kernel=use_kernel)
            x = x + a
            x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
            for name, t in ntok.items():
                if rows is None:
                    c[name][:, pos] = t[:, 0]
                elif len(rows):
                    c[name][rows, pos] = t[rows, 0]
        return self._logits(params, x), cache
