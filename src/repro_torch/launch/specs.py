"""Which (arch, shape cell) pairs run, each pair's run config, and its
batch as shapes and dtypes on the meta device.

The counterpart of ``repro.launch.specs``: ``FULL_ATTENTION_ARCHS``,
``SUBQUADRATIC_ARCHS``, ``cell_supported``, ``arch_run_config`` (each
config module's ``MICROBATCHES`` and ``MOMENT_DTYPE``) and
``batch_abstract`` (tensors on ``torch.device("meta")`` in place of
``jax.ShapeDtypeStruct``: a shape and a dtype, nothing allocated).

On the LM mesh ``batch_specs`` / ``cache_specs`` give JAX's
PartitionSpecs of a cell's batch and of an LM's cache as spec tuples
(``sharding.rules``), and ``batch_shardings`` / ``cache_shardings`` the
same as DTensor placements (``rules.param_placements``; JAX returns
NamedShardings).  The port's LM holds its caches as these say
(``LM.init_cache``), leaf by leaf, the dims found by length as in JAX;
where that is not the layout its decode computes in (a dim whose length
happens to equal the batch's or ``max_seq``), the decode re-cuts the
leaf around the call.
``build_cell`` is JAX's: a cell's step function and one rank's
arguments on an LM mesh (``launch.mesh.fake_world`` for JAX's production
mesh), the arguments as ``FakeTensor``s at the rank's local shapes (JAX
gives ``ShapeDtypeStruct``s and their shardings), for
``analysis.trace_cost.trace`` to run (JAX lowers and compiles them).
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.common.config import (ModelConfig, OptimizerConfig,
                                       RunConfig, ShapeCell)
from repro_torch.common.device import resolve_device
from repro_torch.configs import canonical
from repro_torch.sharding import rules as R

FULL_ATTENTION_ARCHS = {
    "seamless_m4t_large_v2", "llama3_405b", "qwen1_5_4b", "granite_8b",
    "yi_34b", "olmoe_1b_7b", "kimi_k2_1t_a32b", "llama_3_2_vision_90b",
}
SUBQUADRATIC_ARCHS = {"xlstm_125m", "zamba2_7b"}


def cell_supported(arch_id: str, shape_name: str) -> Tuple[bool, str]:
    a = canonical(arch_id)
    if shape_name == "long_500k" and a in FULL_ATTENTION_ARCHS:
        return False, "long_500k skipped: full quadratic attention (see DESIGN.md Arch-applicability)"
    return True, ""


def arch_run_config(arch_id: str, shape_name: str,
                    mesh_kind: str = "single") -> RunConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    cfg: ModelConfig = mod.CONFIG
    mb = getattr(mod, "MICROBATCHES", {}).get(shape_name, 1)
    if isinstance(mb, dict):   # per-mesh counts (DP width differs)
        mb = mb.get(mesh_kind, 1)
    opt = OptimizerConfig(moment_dtype=getattr(mod, "MOMENT_DTYPE", "float32"))
    return RunConfig(model=cfg, opt=opt, microbatches=mb)


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_abstract(cfg: ModelConfig, cell: ShapeCell
                   ) -> Dict[str, torch.Tensor]:
    """The cell's batch on the meta device: tokens (and labels for a
    train cell; one token a row for decode), the vlm's image embeddings
    and the audio family's encoder embeddings."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        return {"tokens": _meta((B, 1), torch.int32)}
    out = {"tokens": _meta((B, S), torch.int32)}
    if cell.kind == "train":
        out["labels"] = _meta((B, S), torch.int32)
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        out["img_embeds"] = _meta((B, cfg.vlm.num_image_tokens, cfg.d_model),
                                  dt)
    if cfg.family == "audio":
        enc_s = int(S * cfg.encdec.enc_seq_factor)
        out["enc_embeds"] = _meta((B, enc_s, cfg.d_model), dt)
    return out


def batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh) -> Dict[str, tuple]:
    """JAX's ``batch_shardings`` as specs: each input's batch dim over the
    longest DP-axis prefix that divides it."""
    return {k: R.data_spec(mesh, v.shape[0], *([None] * (v.dim() - 1)),
                           policy=cfg.parallelism)
            for k, v in batch_abstract(cfg, cell).items()}


def batch_shardings(cfg: ModelConfig, cell: ShapeCell, mesh
                    ) -> Dict[str, list]:
    """``batch_specs`` as DTensor placements."""
    return {k: R.param_placements(sp, mesh)
            for k, sp in batch_specs(cfg, cell, mesh).items()}


def cache_specs(lm, batch: int, max_seq: int, mesh) -> Dict:
    """JAX's ``cache_shardings`` as specs, leaf by leaf
    (``rules.cache_leaf_spec``): the batch dim over DP when it divides,
    the attention caches' sequence over "model" under "2d" (each rank
    holds a slice of the positions of every kv head), else the sequence
    over "data" for an undivided batch, and a cache with no sequence (the
    recurrent states) cut over "model" on its last trailing dim that
    divides.  The dims are found by their lengths, as JAX finds them."""
    policy = lm.cfg.parallelism

    def walk(defs):
        if isinstance(defs, tuple):
            return R.cache_leaf_spec(defs[0], batch, max_seq, mesh, policy)
        return {k: walk(v) for k, v in defs.items()}
    return walk(lm.cache_defs(batch, max_seq))


def cache_shardings(lm, batch: int, max_seq: int, mesh) -> Dict:
    """``cache_specs`` as DTensor placements."""
    def walk(specs):
        if isinstance(specs, tuple):
            return R.param_placements(specs, mesh)
        return {k: walk(v) for k, v in specs.items()}
    return walk(cache_specs(lm, batch, max_seq, mesh))


def _fake(shape, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def build_cell(arch_id: str, shape_name: str, mesh, *, device=None,
               run: Optional[RunConfig] = None,
               cell: Optional[ShapeCell] = None
               ) -> Tuple[Callable, Tuple[Any, ...], Dict[str, Any]]:
    """(fn, args, meta) of one cell on ``mesh`` (an ``LMMesh``; this
    rank's view), JAX's ``build_cell`` without the shardings: ``args``
    are ``FakeTensor``s of one ``FakeTensorMode`` at this rank's local
    shapes (parameters under ``rules.param_pspecs``, the batch under
    ``batch_specs``, the cache under ``init_cache``'s layout, which is
    ``cache_specs``'), on ``device`` (default: the card's type; raises
    without a card unless ``device`` is ``"cpu"``; nothing is
    allocated).  ``fn`` is the
    train step with the parameters and AdamW state updated in place
    (``make_train_step(..., donate=True)``: JAX's ``donate_argnums=(0,
    1)``), ``make_serve_prefill``, or ``make_serve_decode`` writing the
    cache in place (JAX's ``(2,)``) at position ``seq_len - 1`` (a host
    int in the port; JAX's is an argument).  ``run`` and ``cell``
    replace the config's run and the named shape cell (the tests' small
    cells).  ``meta`` carries JAX's keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.common.config import SHAPES_BY_NAME
    from repro_torch.common.params import param_count
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.steps import (make_serve_decode,
                                         make_serve_prefill, make_train_step)
    cell = cell or SHAPES_BY_NAME[shape_name]
    kind = "multi" if "pod" in mesh.axis_names else "single"
    run = run or arch_run_config(arch_id, shape_name, kind)
    cfg = run.model
    device = resolve_device(device)
    lm = LM(cfg, mesh)
    defs = lm.param_defs()
    meta = {"arch": arch_id, "shape": shape_name, "kind": cell.kind,
            "microbatches": run.microbatches,
            "param_count": param_count(defs)}
    B = cell.global_batch
    with FakeTensorMode():
        params = _local_tree(defs, lm.specs, mesh, device)
        batch = {k: _fake(R.local_shape(v.shape, sp, mesh), v.dtype, device)
                 for (k, v), sp in zip(batch_abstract(cfg, cell).items(),
                                       batch_specs(cfg, cell, mesh).values())}
        if cell.kind == "train":
            opt = init_opt_state(run.opt, params)
            return (make_train_step(lm, run, donate=True),
                    (params, opt, batch), meta)
        if cell.kind == "prefill":
            return (make_serve_prefill(lm, cell.seq_len, global_batch=B),
                    (params, batch), meta)
        cache = lm.init_cache(B, cell.seq_len, device)
    meta["pos"] = pos = cell.seq_len - 1
    decode = make_serve_decode(lm, global_batch=B)
    return ((lambda p, tokens, c: decode(p, tokens, c, pos)),
            (params, batch["tokens"], cache), meta)


def _local_tree(defs, specs, mesh, device):
    """Every ``ParamDef`` of ``defs`` as an empty tensor of this rank's
    piece under ``specs``."""
    from repro_torch.common.params import ParamDef
    if isinstance(defs, ParamDef):
        return _fake(R.local_shape(defs.shape, specs, mesh), defs.dtype,
                     device)
    return {k: _local_tree(defs[k], specs[k], mesh, device)
            for k in sorted(defs)}
