"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060; hf]."""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, expert_d_ff=1024),
    rope_theta=10_000.0,
    notes="64 experts, top-8, 1B active / 7B total.",
)
MICROBATCHES = {"train_4k": 2}
MOMENT_DTYPE = "float32"
