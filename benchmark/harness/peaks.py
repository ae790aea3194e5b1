"""Published peaks of the card the benchmark runs on, and the least time a
frozen work count can take at them."""

# NVIDIA's data sheet for the H100 SXM part (dense rates): HBM3 bytes/s,
# and float32 operations/s outside the tensor cores counting a fused
# multiply-add as two; a kernel built without FMA contraction retires one
# add or multiply a lane a cycle, half of that
PEAKS = {
    'hbm_bytes_per_s': 3.35e12,
    'fp32_ops_per_s': 67e12,
    'fp32_nofma_ops_per_s': 33.5e12,
}


def bound_seconds(roofline: dict, samples: float) -> float:
    """The larger of the operations and the bytes of ``samples`` samples
    over their peaks (``roofline['ops_peak']`` names the operations')."""
    ops = roofline['ops_per_sample'] * samples
    nbytes = roofline['bytes_per_sample'] * samples
    return max(ops / PEAKS[roofline['ops_peak']],
               nbytes / PEAKS['hbm_bytes_per_s'])
