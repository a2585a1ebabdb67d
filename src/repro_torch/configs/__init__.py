"""Architecture config registry (a copy of the JAX package's).

``get_config(arch_id)`` returns the full published config;
``smoke_config(arch_id)`` returns a structurally identical reduced config
(same family/block pattern, tiny dims) for CPU tests.  The port's ``LM``
runs every one of them, with a bfloat16, float32 or int8 KV cache.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.common.config import (EncDecConfig, ModelConfig, MoEConfig,
                                       SSMConfig, VLMConfig, XLSTMConfig)

ARCH_IDS: List[str] = [
    "seamless_m4t_large_v2",
    "llama3_405b",
    "qwen1_5_4b",
    "granite_8b",
    "yi_34b",
    "olmoe_1b_7b",
    "kimi_k2_1t_a32b",
    "xlstm_125m",
    "llama_3_2_vision_90b",
    "zamba2_7b",
]

# hyphenated ids -> module names
ALIASES: Dict[str, str] = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llama3-405b": "llama3_405b",
    "qwen1.5-4b": "qwen1_5_4b",
    "granite-8b": "granite_8b",
    "yi-34b": "yi_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "xlstm-125m": "xlstm_125m",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "zamba2-7b": "zamba2_7b",
}


def canonical(arch_id: str) -> str:
    return ALIASES.get(arch_id, arch_id)


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ARCH_IDS)


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced config of the same family / block pattern for CPU tests."""
    cfg = get_config(arch_id)
    kw = dict(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=257, head_dim=None, remat_policy="none",
    )
    if cfg.family == "moe":
        kw["moe"] = MoEConfig(num_experts=8, top_k=2, expert_d_ff=32,
                              num_shared_experts=cfg.moe.num_shared_experts,
                              shared_d_ff=32 if cfg.moe.num_shared_experts else 0)
    if cfg.family in ("ssm",):
        kw.update(num_layers=4, num_kv_heads=4)  # one full superblock (3 mlstm + 1 slstm)
        kw["xlstm"] = XLSTMConfig(slstm_every=4, chunk_size=16, proj_factor=2.0)
    if cfg.family == "hybrid":
        kw.update(num_layers=7, num_kv_heads=4)  # 2 superblocks of 3 + tail 1
        kw["ssm"] = SSMConfig(state_size=16, head_dim=16, conv_width=4, chunk_size=16, expand=2)
        kw["shared_attn_every"] = 3
    if cfg.family == "vlm":
        kw.update(num_layers=4)
        kw["vlm"] = VLMConfig(cross_attn_every=2, num_image_tokens=16)
    if cfg.family == "audio":
        kw["encdec"] = EncDecConfig(enc_layers=2, dec_layers=2, enc_seq_factor=1.0)
    return cfg.replace(**kw)
