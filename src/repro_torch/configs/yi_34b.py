"""Yi-34B — llama-arch GQA [arXiv:2403.04652; hf]."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-34b", family="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    rope_theta=5_000_000.0,
    notes="56 q-heads (not divisible by model=16: sharding constraints stay on flattened features).",
)
MICROBATCHES = {"train_4k": 4}
MOMENT_DTYPE = "float32"
