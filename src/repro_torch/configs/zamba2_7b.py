"""Zamba2-7B — Mamba2 + shared attention blocks [arXiv:2411.15242; unverified]."""
from repro_torch.common.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm=SSMConfig(state_size=64, head_dim=64, conv_width=4, chunk_size=256, expand=2),
    shared_attn_every=6,
    notes="13 superblocks of 5 Mamba2 + 1 shared-attn application, 3 tail Mamba2; "
          "sub-quadratic: runs long_500k (attn KV seq-sharded).",
)
MICROBATCHES = {"train_4k": 4}
MOMENT_DTYPE = "float32"
