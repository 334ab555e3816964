"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full power limit of 700 W). A card set below that limit
runs slower under load: a roofline share is stated against these peaks,
with the card's power limit beside it."""

FP32_FLOP_PER_S = 67e12      # outside the tensor cores
BF16_FLOP_PER_S = 989.4e12   # dense, on the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, op_rate: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at ``op_rate`` and the bytes at the HBM bandwidth."""
    return max(ops / op_rate, nbytes / HBM_BYTES_PER_S)
