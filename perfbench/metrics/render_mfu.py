"""A rendered view's operations by the geometry's counts, times the traced window's views/s, over the H100's 67 TFLOP/s FP32 (%)."""

from perfbench.readers import mfu_pct


def read(t):
    return mfu_pct(t, "render")
