"""The whole step's share of the card's f32 peak, in %: the window's
useful SGNS operations (``counts.sgns_flops`` of its batches: both
products and both updates of every (context, output) pair) over the
window's seconds at 67 TFLOP/s."""
from w2vbench import peaks


def read(rec):
    if "flops" not in rec:
        return None
    return 100.0 * rec["flops"] / (rec["window_s"] * peaks.F32_FLOPS)
