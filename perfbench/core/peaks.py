"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), the benchmark's own copy."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "float32": 67e12,       # CUDA cores, outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}


def bound_s(nbytes: float, ops: float, precision: str = "float32") -> float:
    """The least time the card needs for ``nbytes`` of memory traffic and
    ``ops`` operations: the larger of the two over their peaks."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS_PER_S[precision])
