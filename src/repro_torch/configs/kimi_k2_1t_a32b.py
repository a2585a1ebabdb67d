"""Kimi K2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2; unverified]."""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    moe=MoEConfig(num_experts=384, top_k=8, expert_d_ff=2048,
                  num_shared_experts=1, shared_d_ff=2048),
    rope_theta=50_000.0, fsdp_over_pod=True,
    notes="1T total / 32B active; expert weights FSDP-extended over the pod axis "
          "(does not fit fp32-opt on 256 chips — see EXPERIMENTS Dry-run section).",
)
MICROBATCHES = {"train_4k": {"single": 16, "multi": 8}}
MOMENT_DTYPE = "bfloat16"
