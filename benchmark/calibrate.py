"""Readings of a cell's compared numbers over many seeds, for its limits.

    python3 -m benchmark.calibrate --workload fever50k.verify \\
        --seeds 101,102,103 --seconds 3 [--control | --fault half [--after 3]]

Runs the cell once a seed in this one process (the kernels load once), with
a short window at the cell's own sizes, and prints one JSON line a seed:
the numbers compared and whether they passed. ``--control`` puts the
configuration's control in the program's place: the ranker's TF32 scoring
GEMM, or the plain reference in TF32. ``--fault`` plants one of
``faults.py``'s faults under the timed path. A limit lies between the
largest reading of the program over a dozen seeds or more and the smallest
of the control's and, for a training cell, of its faults' (PERF.md lists
them).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("answer", "half", "unchanged"))
    ap.add_argument("--after", type=int, default=0,
                    help="calls of the patched function that stay sound (a fault after set-up)")
    args = ap.parse_args(argv)
    from benchmark import run  # noqa: F401  (sets the cache directories)
    from benchmark import faults, harness

    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    cell = harness.find_cell(args.workload,
                             harness.load_json(os.path.join(REPO, "BENCHMARK.json")))
    for seed in (int(s) for s in args.seeds.split(",")):
        undo = faults.plant(cell.mix["kind"], args.fault, args.after) if args.fault else None
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda", control=args.control)
        if undo:
            undo()
        print(json.dumps({"workload": cell.name, "seed": seed, "control": args.control,
                          "fault": args.fault, "after": args.after,
                          "correct": out["correct"], "checks": out["checks"],
                          "setup_s": out["metrics"]["setup_s"]["value"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
