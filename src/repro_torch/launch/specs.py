"""Which (arch, shape cell) pairs run, each pair's run config, and its
batch as shapes and dtypes on the meta device.

The counterpart of ``repro.launch.specs``: ``FULL_ATTENTION_ARCHS``,
``SUBQUADRATIC_ARCHS``, ``cell_supported``, ``arch_run_config`` (each
config module's ``MICROBATCHES`` and ``MOMENT_DTYPE``) and
``batch_abstract`` (tensors on ``torch.device("meta")`` in place of
``jax.ShapeDtypeStruct``: a shape and a dtype, nothing allocated).
``batch_shardings``, ``cache_shardings`` and ``build_cell`` place the
cell on a TPU mesh for the XLA dry run and have no counterpart on one
card.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

from repro_torch.common.config import (ModelConfig, OptimizerConfig,
                                       RunConfig, ShapeCell)
from repro_torch.configs import canonical

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
