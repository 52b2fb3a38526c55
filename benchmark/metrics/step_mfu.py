"""``step_mfu``: the whole sweep's share of the card's float32 peak:
the matrix-product FLOPs that the window's configs need (joint fit,
inference fits, sentiment fit and scoring, counted from shapes by
``benchmark.flops.config_flops``) over the window's seconds and 67
TFLOP/s."""

from benchmark.flops import PEAK_F32_FLOPS


def read(record):
    return 100.0 * record["flops"] / (record["window_s"] * PEAK_F32_FLOPS)
