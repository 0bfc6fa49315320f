"""Runs one cell of the benchmark of ``ircl_tpu_torch`` once, on the card.

    python3 -m benchmark.run --workload fever50k.retrieve --seed 7 \\
        --seconds 30 --trace 0

Sets the cell up from ``--seed``, warms its shapes, measures for
``--seconds``, compares what the window produced with the plain reference,
and prints one JSON line last on stdout: ``correct``, ``attempted``,
``failed``, ``metrics`` (with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics and ``breakdown``), ``device`` and
``checks`` (each number compared and its limit, which are also the last
lines on stderr). Exits non-zero without a result where there is no card,
or fewer cards than the cell asks for, or where a module of JAX or of the
JAX package is loaded once the window has closed.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:  # run as a file, not as a module
    sys.path.insert(0, REPO)

# Caches of the program's builds stay inside the checkout, at fixed paths.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(HERE, ".cache", sub)
os.environ["USE_FLAX"] = "0"
# One process with few threads: the host's thread pools at a fixed size.
HOST_THREADS = 4
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = str(HOST_THREADS)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark import harness

    bench = harness.load_json(os.path.join(REPO, "BENCHMARK.json"))
    cell = harness.find_cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} CUDA device(s); "
                    f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    harness.log(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {harness.power_limit()}")
    torch.set_num_threads(HOST_THREADS)
    harness.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                f"{torch.get_num_threads()} host threads")
    out = harness.run_cell(cell, args.seed % 2 ** 63, args.seconds, bool(args.trace), "cuda",
                           t0=T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
