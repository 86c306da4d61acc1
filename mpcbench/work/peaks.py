"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

F32_FLOPS = 67e12        # float32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float):
    """(seconds, "operations" or "bytes"): the least time the card could
    take for the work, the larger of its two times."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
