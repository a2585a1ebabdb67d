"""Llama-3 405B — dense GQA decoder [arXiv:2407.21783; unverified]."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    rope_theta=500_000.0, kv_cache_dtype="int8",
    notes="GQA kv=8, 128k vocab; bf16 moments + 16 microbatches to fit v5e-256.",
)

# dry-run execution knobs (memory fitting at 256x16GB)
MICROBATCHES = {"train_4k": {"single": 16, "multi": 8}}
MOMENT_DTYPE = "bfloat16"
