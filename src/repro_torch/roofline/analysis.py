"""MODEL_FLOPS for the roofline and the MFU lines.

The counterpart of ``repro.roofline.analysis``'s ``model_flops``.  The
rest of that module (``parse_collectives``, ``roofline_terms``) reads the
partitioned HLO text and ``cost_analysis()`` of an XLA executable compiled
for a TPU mesh, and ``repro.roofline.report`` renders tables from the TPU
dry run's ``artifacts/dryrun/``: the port compiles no XLA program and has
no mesh on one card, so those three have no counterpart.
"""
from __future__ import annotations


def model_flops(param_count: int, active_param_count: int, tokens: int,
                kind: str) -> float:
    """MODEL_FLOPS = 6*N*D for train (fwd+bwd), 2*N*D for inference."""
    n = active_param_count
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
