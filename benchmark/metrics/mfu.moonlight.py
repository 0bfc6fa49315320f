"""Model FLOPs of the window's requests' real tokens (``rooflines/
moonlight_model.py``) at the bf16 rate, over the window's time."""

from benchmark.harness import step_mfu
from benchmark.rooflines import moonlight_model, peaks


def read(run):
    return step_mfu(run, lambda w: moonlight_model.forward_flops(w) / peaks.BF16_FLOPS)
