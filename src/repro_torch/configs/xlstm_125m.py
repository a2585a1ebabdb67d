"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
from repro_torch.common.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=4, chunk_size=256, proj_factor=2.0),
    parallelism="dp",
    notes="Linear-attention family: O(1) decode state; runs long_500k.",
)
MICROBATCHES = {"train_4k": 1}
MOMENT_DTYPE = "float32"
