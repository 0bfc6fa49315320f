"""Faults planted in the Moonlight verdict body, and readings of the cell's
``prob_gap_pNN`` percentiles over many seeds, for their limits.

    python3 -m benchmark.moonlight_faults --seeds 101,102 --seconds 6 \\
        [--control | --fault five_of_six | --witness]

Each fault leaves out or changes one piece of the model's mathematics under
the timed path, where the program computes it. In every pair:
``five_of_six`` (one routed expert fewer a token), ``no_shared`` (the
shared experts left out), ``no_scale`` (the routed weights without
``routed_scaling_factor``) and ``bidirectional`` (the pad mask alone, no
causal mask). In some of the pairs: ``full_rows_early`` (the pairs cut at
the pinned length, which have no pads, pooled at their next-to-last token)
and ``last_quarter_early`` (the last quarter of a batch's rows pooled so).
``--control`` runs the configuration's control (the reference with fp8
expert products) in the program's place; with neither flag the program runs
as it is. ``--witness`` runs the program and, on its compared pairs, the
reference a second time with every sum in f64: the gaps between the two
references are those of two correct forwards that sum in another order.
Runs the cell once a seed in this one process and prints one JSON line a
seed, like ``calibrate.py``, with every compared pair's gap, its slot in
its request and its real length. Each limit lies between the program's
largest reading over a dozen seeds or more and the smallest reading of the
control or of the faults it is there for (PERF.md lists them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FAULTS = ("five_of_six", "no_shared", "no_scale", "bidirectional", "full_rows_early",
          "last_quarter_early")


def plant(fault: str) -> Callable[[], None]:
    """Patch the program's module attributes for ``fault``; returns the
    function that takes the patch away."""
    import torch

    from ircl_tpu_torch.models import mla_moe, moe_dropless

    route = moe_dropless.route
    if fault == "five_of_six":
        obj, name = moe_dropless, "route"
        new = lambda x, w, b, k, s, n=True: route(x, w, b, k - 1, s, n)  # noqa: E731
    elif fault == "no_scale":
        obj, name = moe_dropless, "route"
        new = lambda x, w, b, k, s, n=True: route(x, w, b, k, 1.0, n)  # noqa: E731
    elif fault == "no_shared":
        obj, name = mla_moe, "shared_experts"
        new = lambda x, p: torch.zeros_like(x)  # noqa: E731
    elif fault == "bidirectional":
        obj, name = mla_moe, "attention_mask"
        new = lambda real: real[:, None, None, :].expand(-1, 1, real.shape[1], -1)  # noqa: E731
    elif fault == "full_rows_early":
        obj, name = mla_moe, "last_token"

        def new(mask):
            n = mask.sum(1).long()
            return torch.where(n == mask.shape[1], n - 2, n - 1).clamp(min=0)
    elif fault == "last_quarter_early":
        obj, name = mla_moe, "last_token"

        def new(mask):
            B = mask.shape[0]
            late = torch.arange(B, device=mask.device) >= B - B // 4
            return (mask.sum(1).long() - 1 - late.long()).clamp(min=0)
    else:
        raise ValueError(f"no fault {fault!r}; one of {FAULTS}")
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def _watch(witness: bool):
    """Keeps each run's cell (its compared pairs and their gaps) and, with
    ``witness``, the gaps between the f32 and the f64 reference on the
    compared pairs (of a two-label head, alike for either label); returns
    them and the function that takes the watch away."""
    import numpy as np
    import torch

    from benchmark.reference import moonlight
    from benchmark.traffic import verify_moe

    seen = {"cells": [], "witness": []}
    build, probabilities = verify_moe.build, moonlight.probabilities

    def keep(run):
        seen["cells"].append(build(run))
        return seen["cells"][-1]

    def twice(c, seed, seqs, device, **kw):
        p32 = probabilities(c, seed, seqs, device, **kw)
        p64 = probabilities(c, seed, seqs, device, accumulate=torch.float64, **kw)
        seen["witness"].append(np.abs(p64[:, 0] - p32[:, 0]))
        return p32

    verify_moe.build = keep
    if witness:
        moonlight.probabilities = twice

    def undo():
        verify_moe.build, moonlight.probabilities = build, probabilities
    return seen, undo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="moonlight16b.verify")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=FAULTS)
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    from benchmark import run  # noqa: F401  (sets the cache directories)
    from benchmark import harness

    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    cell = harness.find_cell(args.workload,
                             harness.load_json(os.path.join(REPO, "BENCHMARK.json")))
    for seed in (int(s) for s in args.seeds.split(",")):
        seen, unwatch = _watch(args.witness)
        undo = plant(args.fault) if args.fault else None
        try:
            out = harness.run_cell(cell, seed, args.seconds, False, "cuda", control=args.control)
        finally:
            if undo:
                undo()
            unwatch()
        line = {"workload": cell.name, "seed": seed, "control": args.control,
                "fault": args.fault, "correct": out["correct"], "checks": out["checks"],
                "metrics": out["metrics"],
                "memory_peak_bytes": out["device"]["memory_peak_bytes"]}
        state = seen["cells"][-1] if seen["cells"] else None
        if state is not None and hasattr(state, "gaps"):
            rows = state.compared
            line.update(gaps=[float(f"{g:.5g}") for g in state.gaps],
                        slots=(rows % state.batch).tolist(),
                        lengths=state.lengths[rows].tolist())
        if seen["witness"]:
            line["witness_gaps"] = [float(f"{g:.5g}") for g in seen["witness"][-1]]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
