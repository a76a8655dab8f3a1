"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the roofline bound."""

#: HBM3 bandwidth, bytes/s
HBM_BYTES_S = 3.35e12
#: 32-bit integer operations a second: 132 SMs x 64 lanes x 1.98 GHz
INT32_OPS_S = 132 * 64 * 1.98e9


def bound_s(n_bytes: float, int_ops: float = 0.0) -> float:
    """The least time the card could take: bytes at full bandwidth or
    int32 operations at the peak rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_S, int_ops / INT32_OPS_S)
