"""The whole step's share of the card's fp32 peak, in percent: the model
FLOPs of the window's scheduler steps and evaluations
(``portbench/counts.py``, from shapes) over the window's seconds on the
host's clock (the run's unprofiled window), against 67 TFLOP/s, the H100
SXM datasheet's fp32 rate outside the tensor cores (the cells run fp32
with TF32 off; the card's own clocks and power limit are not read)."""

from portbench import counts


def read(run):
    if run.window_s <= 0:
        return None
    return 100.0 * run.window_flops / run.window_s / counts.FP32_FLOPS
