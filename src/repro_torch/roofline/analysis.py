"""Roofline terms from a traced step: the collectives' link traffic, the
three per-card times and MODEL_FLOPS.

The counterpart of ``repro.roofline.analysis``.  JAX reads a compiled
SPMD executable: ``cost_analysis()`` for the per-device FLOPs and bytes,
and the partitioned HLO text for the collectives.  The port reads one
rank's step traced on fake tensors (``analysis.trace_cost.trace``): its
``cost`` block in place of ``cost_analysis()``, and the c10d records of
the trace in place of the HLO's collective instructions
(``parse_collectives``), under JAX's kind names and keys.  Result sizes
turn into per-card link traffic with JAX's ring factors (``_traffic``:
all-reduce 2X(N-1)/N, all-gather X(N-1)/N, reduce-scatter shard*(N-1),
all-to-all X(N-1)/N, collective-permute X), and ``roofline_terms`` gives
JAX's three terms with the ``H100_SXM`` constants (989 TFLOP/s, 3.35
TB/s, 450 GB/s of NVLink a direction).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from repro_torch.common.config import H100_SXM, HWConfig

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def _traffic(kind: str, out_bytes: int, n: int) -> float:
    """Per-chip link traffic estimate (ring algorithms)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * out_bytes * (n - 1) / n
    if kind == "all-gather":
        return out_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)          # out is the shard
    if kind == "all-to-all":
        return out_bytes * (n - 1) / n
    return float(out_bytes)                  # collective-permute


def parse_collectives(records: Iterable[Tuple[str, int, int]]
                      ) -> Dict[str, Dict[str, float]]:
    """JAX's ``parse_collectives`` over a trace's c10d records, each
    (kind, result bytes, group size): per kind its ``count``, the sum of
    its ``result_bytes`` and of its ``traffic_bytes``."""
    stats = {k: {"count": 0, "result_bytes": 0, "traffic_bytes": 0.0}
             for k in COLLECTIVE_KINDS}
    for kind, b, n in records:
        stats[kind]["count"] += 1
        stats[kind]["result_bytes"] += b
        stats[kind]["traffic_bytes"] += _traffic(kind, b, n)
    return stats


def roofline_terms(cost: Dict[str, float],
                   collectives: Dict[str, Dict[str, float]],
                   hw: HWConfig = H100_SXM) -> Dict[str, float]:
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    traffic = sum(v["traffic_bytes"] for v in collectives.values())
    terms = {
        "compute_s": flops / hw.peak_flops,
        "memory_s": bytes_acc / hw.hbm_bw,
        "collective_s": traffic / hw.ici_bw,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_acc,
        "collective_traffic_per_chip": traffic,
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["bottleneck"] = dom
    step = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["roofline_step_s"] = step
    terms["roofline_fraction"] = terms["compute_s"] / step if step > 0 else 0.0
    return terms


def model_flops(param_count: int, active_param_count: int, tokens: int,
                kind: str) -> float:
    """MODEL_FLOPS = 6*N*D for train (fwd+bwd), 2*N*D for inference."""
    n = active_param_count
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
