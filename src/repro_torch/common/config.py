"""Model configuration dataclasses (the JAX package's ``ModelConfig`` and
its sub-configs, copied so the port imports nothing of ``repro``).

One ``ModelConfig`` describes every architecture family (dense / moe /
ssm / hybrid / vlm / audio enc-dec); ``repro_torch/configs/`` instantiates
it with the published hyper-parameters.  ``OptimizerConfig`` is copied as
data for ``train/optimizer.py`` and ``RunConfig`` for the LM trainer
(``train/steps.py``, ``launch/train.py``).  The four shape cells
(``ShapeCell``, ``SHAPE_CELLS``, ``SHAPES_BY_NAME``) and ``HWConfig`` with
``TPU_V5E`` are copied field for field for the one-card dry run
(``launch/dryrun.py``) and the analytic roofline (``roofline/``);
``H100_SXM`` is the card's instance beside them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Input shapes (the four assigned shape cells).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    """One assigned (workload) input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPE_CELLS}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # shared expert (dense path always applied), used by kimi-style MoE
    num_shared_experts: int = 0
    shared_d_ff: int = 0


@dataclass(frozen=True)
class SSMConfig:
    state_size: int = 64          # N (per-head state width)
    head_dim: int = 64            # P (channels per head)
    conv_width: int = 4
    chunk_size: int = 256         # SSD chunk length
    expand: int = 2               # d_inner = expand * d_model


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4          # every k-th layer is an sLSTM block
    chunk_size: int = 256         # mLSTM chunkwise-parallel chunk
    proj_factor: float = 2.0      # mLSTM up-projection factor


@dataclass(frozen=True)
class VLMConfig:
    cross_attn_every: int = 5     # every k-th layer is a cross-attn layer
    num_image_tokens: int = 4_096 # stub patch-embedding count per sample


@dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 24
    dec_layers: int = 24
    # stub audio frontend: precomputed frame embeddings of this length factor
    enc_seq_factor: float = 1.0   # enc_seq = factor * seq_len


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    qkv_bias: bool = False                  # qwen-style attention bias
    tie_embeddings: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    vlm: Optional[VLMConfig] = None
    encdec: Optional[EncDecConfig] = None
    # hybrid (zamba2): one shared attention block applied every k layers
    shared_attn_every: int = 0
    # distribution / numerics knobs
    dtype: str = "bfloat16"
    remat_policy: str = "minimal"            # none | minimal | full
    scan_layers: bool = True
    fsdp_over_pod: bool = False              # extend FSDP onto the pod axis
    parallelism: str = "2d"                  # "2d" = TP x FSDP (default),
                                             # "fsdp" = ZeRO-3 over all axes (no TP
                                             #          — right for ~1-10B archs),
                                             # "dp"   = fully replicated weights
                                             #          (right for <1B archs)
    pad_vocab_to_multiple: int = 0           # pad embedding/unembed rows so the
                                             # vocab axis shards over TP (Megatron-
                                             # style); 0 = no padding
    loss_chunk: int = 0                      # seq-chunked cross-entropy window
                                             # (0 = whole sequence at once)
    kv_cache_dtype: str = "bfloat16"         # "int8": quantized KV cache with
                                             # per-(token, head) scales — halves
                                             # the decode memory floor

    @property
    def dp_only(self) -> bool:
        return self.parallelism == "dp"

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to_multiple
        if m <= 0:
            return self.vocab_size
        return ((self.vocab_size + m - 1) // m) * m
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Rough parameter counts (used for MODEL_FLOPS = 6*N*D roofline math).
    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qf = self.num_heads * hd
        kvf = self.num_kv_heads * hd
        attn = d * qf + 2 * d * kvf + qf * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "moe":
            m = self.moe
            expert = 3 * d * m.expert_d_ff
            shared = 3 * d * m.shared_d_ff * m.num_shared_experts
            router = d * m.num_experts
            per_layer = attn + m.num_experts * expert + shared + router + 2 * d
            return self.num_layers * per_layer + emb
        if self.family == "ssm":  # xlstm
            x = self.xlstm
            d_in = int(d * x.proj_factor)
            mlstm = 4 * d * d_in + d_in * d  # q,k,v,up(+gates) and down
            return self.num_layers * (mlstm + 2 * d) + emb
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            mamba = 2 * d * d_in + d_in * d + d_in * (2 * s.state_size)
            n_attn = self.num_layers // max(self.shared_attn_every, 1)
            n_mamba = self.num_layers - n_attn
            shared_blk = attn + 3 * d * ff  # one shared param set
            return n_mamba * (mamba + 2 * d) + shared_blk + emb
        # dense / vlm / audio: swiglu mlp = 3*d*ff
        mlp = 3 * d * ff
        per_layer = attn + mlp + 2 * d
        n_layers = self.num_layers
        if self.family == "audio" and self.encdec is not None:
            n_layers = self.encdec.enc_layers + self.encdec.dec_layers
            per_layer += attn // 2  # decoder cross-attn (rough)
        if self.family == "vlm" and self.vlm is not None:
            pass  # cross-attn layers ~= self-attn layers in size; keep estimate
        return n_layers * per_layer + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        m = self.moe
        hd = self.resolved_head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        expert = 3 * d * m.expert_d_ff
        shared = 3 * d * m.shared_d_ff * m.num_shared_experts
        per_layer = attn + m.top_k * expert + shared + d * m.num_experts + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + emb


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # bf16 for the giant archs
    compress_grads: bool = False    # int8 error-feedback DP all-reduce


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    opt: OptimizerConfig = field(default_factory=OptimizerConfig)
    microbatches: int = 1           # grad-accumulation steps per train_step
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# Hardware constants (roofline denominators).  The defaults are TPU v5e's,
# as in the JAX package; H100_SXM is the card the port runs on.
@dataclass(frozen=True)
class HWConfig:
    peak_flops: float = 197e12       # bf16 FLOP/s per chip
    hbm_bw: float = 819e9            # bytes/s per chip
    ici_bw: float = 50e9             # bytes/s per link (~per-chip injection)
    hbm_bytes: float = 16e9          # HBM capacity per chip (v5e)


TPU_V5E = HWConfig()

# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, HBM3, 80 GB;
# ici_bw is NVLink 4's 450 GB/s a direction (the collective term is 0 on
# one card)
H100_SXM = HWConfig(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                    hbm_bytes=80e9)
