"""Three times the forward's model FLOPs of the window's steps' real tokens
(forward and backward) at the TF32 rate, over the window's time."""

from benchmark.harness import step_mfu
from benchmark.rooflines import peaks, verdict_model


def read(run):
    return step_mfu(run, lambda w: 3 * verdict_model.forward_flops(w) / peaks.TF32_FLOPS)
