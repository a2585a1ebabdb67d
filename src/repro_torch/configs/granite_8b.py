"""Granite-8B (code) — llama-arch GQA [arXiv:2405.04324; hf]."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=49152,
    rope_theta=10_000_000.0,
    notes="llama-arch, code-tuned tokenizer (49k vocab).",
)
MICROBATCHES = {"train_4k": 2}
MOMENT_DTYPE = "float32"
