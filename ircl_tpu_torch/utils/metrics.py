"""Training metrics: JSONL scalar log with optional TensorBoard mirroring.

Counterpart of ``ircl_tpu/utils/metrics.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

The reference logs train_loss / grad_norm through torch's SummaryWriter
(``src/train.py:184-185``). Here the primary sink is an append-only JSONL
file (machine-readable for the bench/judge harness); TensorBoard event files
are written too when torch's writer is importable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, logdir: str, run_name: str = "run", tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"{run_name}.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(logdir, run_name))
            except Exception:
                self._tb = None

    def scalar(self, name: str, value: float, step: int) -> None:
        self._f.write(
            json.dumps(
                {"t": time.time(), "step": step, name: float(value)}
            )
            + "\n"
        )
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(name, float(value), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
