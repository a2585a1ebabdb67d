"""SeamlessM4T-large-v2 backbone — enc-dec multimodal [arXiv:2308.11596; hf]."""
from repro_torch.common.config import ModelConfig, EncDecConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2", family="audio",
    num_layers=48, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    encdec=EncDecConfig(enc_layers=24, dec_layers=24, enc_seq_factor=1.0),
    rope_theta=10_000.0,
    pad_vocab_to_multiple=256, loss_chunk=512,
    notes="24 enc + 24 dec transformer backbone; audio frontend is a stub "
          "(input_specs provides precomputed frame embeddings).",
)
MICROBATCHES = {"train_4k": 4}
MOMENT_DTYPE = "float32"
