"""Llama-3.2-Vision-90B — cross-attn image layers [hf:meta-llama; unverified]."""
from repro_torch.common.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    vlm=VLMConfig(cross_attn_every=5, num_image_tokens=4096),
    rope_theta=500_000.0, kv_cache_dtype="int8",
    notes="20 superblocks of 4 self-attn + 1 gated cross-attn; vision frontend is a "
          "stub (input_specs provides precomputed patch embeddings).",
)
MICROBATCHES = {"train_4k": 8}
MOMENT_DTYPE = "bfloat16"
