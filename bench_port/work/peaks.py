"""The chip's published peaks: one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates, at the full 700 W power limit)."""
PEAK_BF16 = 989e12     # FLOP/s on the tensor cores, bf16 and fp16
PEAK_FP32 = 67e12      # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM3 bytes/s


def least_s(tc_flops: float, fp32_flops: float, nbytes: float):
    """(the least time, seconds, and what bounds it): the larger of the
    operations at their peaks and the bytes at the memory rate."""
    ops = tc_flops / PEAK_BF16 + fp32_flops / PEAK_FP32
    mem = nbytes / PEAK_BYTES
    return (ops, "operations") if ops >= mem else (mem, "bytes")
