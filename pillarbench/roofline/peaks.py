"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity), at its full 700 W power limit; a run prints the card's limit
beside every share it reports."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "float32": 67e12,        # outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}


def bound_s(n_bytes: float, n_ops: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the dtype's peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S[dtype])
