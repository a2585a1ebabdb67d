"""Analytic roofline terms with correct loop trip counts.

``compiled.cost_analysis()`` on the CPU backend counts each ``while``/scan
body ONCE — for scanned-layer models that undercounts FLOPs/bytes by
O(layers x microbatches) (measured: llama3-405B train HLO FLOPs ~1000x below
6ND).  The structure of the program (which collectives, which buffers) still
comes from the compiled HLO; this module supplies the *scale*: closed-form
per-chip traffic with trip counts from the config.

Assumptions (documented per term):
  * 2d policy: TP over model axis (tp), FSDP+DP over data (x pod) (dp);
    "fsdp"/"dp" policies degenerate tp=1.
  * train: fwd + 2x bwd matmul FLOPs (6 N_active tokens) + causal attention
    quadratic; remat "minimal" recomputes fwd (counted in memory traffic,
    not in useful FLOPs).
  * weights are re-gathered (FSDP) per microbatch and re-read per pass:
    3 passes (fwd, remat-fwd, bwd) x microbatches.
  * TP inserts ~4 activation all-reduces per layer per microbatch per pass
    (attn out + mlp out, fwd & bwd), ring traffic 2x payload.
  * decode: every weight shard + the KV-cache shard is read once per token.

The counterpart of ``repro.roofline.analytic``, copied term for term so
that it returns JAX's numbers exactly on equal configs.  ``hw`` defaults
to ``TPU_V5E`` as in JAX; the port's callers pass ``common.config.H100_SXM``
and ``MeshDims(1, 1, 1)`` (one card: the collective term is 0).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.common.config import HWConfig, ModelConfig, ShapeCell, TPU_V5E


@dataclass(frozen=True)
class MeshDims:
    chips: int = 256
    tp: int = 16
    dp: int = 16          # data (x pod) product


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // max(cfg.shared_attn_every, 1)
    if cfg.family == "ssm":
        return 0
    if cfg.family == "audio":
        return cfg.encdec.enc_layers + 2 * cfg.encdec.dec_layers  # self+cross
    return cfg.num_layers


def analytic_terms(cfg: ModelConfig, cell: ShapeCell, microbatches: int = 1,
                   mesh: MeshDims = MeshDims(), hw: HWConfig = TPU_V5E
                   ) -> Dict[str, float]:
    B, S = cell.global_batch, cell.seq_len
    N = cfg.param_count()
    Na = cfg.active_param_count()
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    d = cfg.d_model
    tp = 1 if cfg.parallelism in ("dp", "fsdp") else mesh.tp
    dp = mesh.chips // tp
    chips = mesh.chips
    L_attn = _attn_layers(cfg)

    w_bytes = 2 * N                    # bf16 weights, global
    mdt = 2 if N > 5e10 else 4         # moment dtype policy (configs)

    if cell.kind == "train":
        T = B * S
        flops = 6 * Na * T + 3 * L_attn * 2 * B * S * S * H * hd  # causal 0.5 x qk+pv(2)
        # HBM per chip: weights re-read 3 passes x microbatches (gathered
        # shard = N*2/tp), optimizer state r/w, saved activations w+r
        weight_traffic = 3 * microbatches * w_bytes / tp
        opt_traffic = N * (2 + 2 + 4 + 4 * mdt) / chips   # p r/w, g, m/v r/w
        act_saved = cfg.num_layers * (B / dp) * S * d * 2
        mem_bytes = weight_traffic + opt_traffic + 2 * act_saved
        # collectives per chip: TP activation ARs + FSDP weight AGs + grad RS
        act_mb = (B / (dp * microbatches)) * S * d * 2
        tp_ar = (4 * cfg.num_layers * microbatches * 2 * act_mb) if tp > 1 else 0
        if cfg.parallelism == "dp":      # weights replicated: only grad AR
            fsdp_ag = 0.0
            grad_rs = 2 * 4 * N * (dp - 1) / dp
        else:
            fsdp_ag = 3 * microbatches * w_bytes / tp * (dp - 1) / dp
            grad_rs = 2 * (4 * N / tp) * (dp - 1) / dp    # fp32 grads RS+AG
        coll_bytes = tp_ar + fsdp_ag + grad_rs
    elif cell.kind == "prefill":
        T = B * S
        flops = 2 * Na * T + L_attn * 2 * B * S * S * H * hd
        weight_traffic = w_bytes / tp
        act_traffic = 2 * cfg.num_layers * (B / dp) * S * d * 2
        cache_write = L_attn * (B / dp) * S * cfg.num_kv_heads * hd * 2 * 2 / tp
        mem_bytes = weight_traffic + act_traffic + cache_write
        act_b = (B / dp) * S * d * 2
        tp_ar = (4 * cfg.num_layers * 2 * act_b) if tp > 1 else 0
        coll_bytes = tp_ar + (w_bytes / tp) * (dp - 1) / dp
    else:  # decode: one token against the cache
        T = B
        flops = 2 * Na * B + L_attn * 2 * B * S * cfg.num_kv_heads * hd * 2
        cache_bytes = L_attn * B * S * cfg.num_kv_heads * hd * 2 * 2  # k+v bf16
        if cfg.family in ("ssm", "hybrid"):
            # recurrent state instead of (for hybrid: plus) KV
            if cfg.family == "ssm":
                din = int(d * cfg.xlstm.proj_factor)
                # mLSTM matrix state C: (B, H, hd, hd) fp32 per layer
                cache_bytes = cfg.num_layers * 4 * B * H * (din // H) ** 2
            else:
                din = cfg.ssm.expand * d
                nh = din // cfg.ssm.head_dim
                state = cfg.num_layers * B * nh * cfg.ssm.state_size * cfg.ssm.head_dim * 4
                kv = (cfg.num_layers // cfg.shared_attn_every) * B * S * \
                    cfg.num_kv_heads * hd * 2 * 2
                cache_bytes = state + kv
        mem_bytes = w_bytes / chips * tp + cache_bytes / chips  # weight shard read
        # decode TP all-reduces on (B,1,d) activations are tiny; MoE decode
        # re-gathers expert weights (the kimi decode bottleneck)
        coll_bytes = 2 * cfg.num_layers * (B / dp) * d * 2 * 2 if tp > 1 else 0
        if cfg.family == "moe":
            coll_bytes += (w_bytes / tp) * (dp - 1) / dp   # expert FSDP gather

    compute_s = flops / (chips * hw.peak_flops)
    memory_s = mem_bytes / hw.hbm_bw
    coll_s = coll_bytes / hw.ici_bw
    step = max(compute_s, memory_s, coll_s)
    return {
        "a_compute_s": compute_s, "a_memory_s": memory_s,
        "a_collective_s": coll_s,
        "a_bottleneck": max((("compute", compute_s), ("memory", memory_s),
                             ("collective", coll_s)), key=lambda kv: kv[1])[0],
        "a_step_s": step,
        "a_fraction": compute_s / step if step > 0 else 0.0,
        "model_flops": float(flops),
    }
