"""Qwen1.5-4B — dense with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab_size=151936, qkv_bias=True,
    rope_theta=1_000_000.0, kv_cache_dtype="int8",
    notes="MHA (kv=20) with attention bias, 152k vocab.",
)
MICROBATCHES = {"train_4k": 2}
MOMENT_DTYPE = "float32"
