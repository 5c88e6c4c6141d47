"""The whole scoring step's share of the card's float32 peak: the model's
operations in the traced window (counted from shapes: dense products and
causal attention) over the window's seconds at 67 TFLOP/s, in %."""

from portbench.yardstick import PEAKS


def read(run):
    return 100.0 * run.work["model_flops"] * run.calls / (run.window_s * PEAKS["float32_flops"])
