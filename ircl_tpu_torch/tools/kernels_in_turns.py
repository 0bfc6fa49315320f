"""Kernels #6a and #4 of this checkout against another's, in turns on one card.

    python3 -m ircl_tpu_torch.tools.kernels_in_turns --parent-root DIR [--out FILE]

DIR is another checkout of this repository (for example ``git archive`` of
the parent commit, unpacked into a gitignored directory such as
``chip_archive/parent``). The kernels of each checkout are built from its
own sources and called through their C entry points, into one output
buffer a checkout, and timed by CUDA events in the order parent, this,
this, parent:

- #6a, the flash-attention forward, at ``chip_smoke.py`` phase 10's shape
  ``[32, 12, 512, 64]`` (``profile_verdict_train.forward_in_turns``);
- #4, the dense chunk maxima, at ``bench_dense.py``'s shape (1024 unit
  queries of 128 against 1,000,000 unit corpus rows padded to 1,007,616
  columns, chunk 32, ``m_tile`` 8192), fold/high3 and loop/highest: each
  checkout's call goes to the kernel its wrapper would route it to (a
  checkout without ``ircl_dense_cmax_mma`` has the SIMT kernel only), with
  the largest difference between the two checkouts' chunk maxima.

Prints one JSON report, with the card's name and power limit as
``nvidia-smi`` gives them, and writes it to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from ircl_tpu_torch.ops.dense_topk_cuda import _mode, chunk_max_route, pad_corpus_t
from ircl_tpu_torch.tools.profile_verdict_train import (
    _in_turns,
    _load_other,
    forward_in_turns,
)
from ircl_tpu_torch.utils.kernel_build import load_kernels

DENSE_M, DENSE_D, DENSE_B = 1_000_000, 128, 1024  # bench_dense.py's shape
DENSE_TILE, DENSE_CHUNK = 8192, 32


def dense_in_turns(parent, this, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn(DENSE_M, DENSE_D, device=dev, generator=gen)
    corpus /= corpus.norm(dim=1, keepdim=True)
    queries = torch.randn(DENSE_B, DENSE_D, device=dev, generator=gen)
    queries /= queries.norm(dim=1, keepdim=True)
    ct, m_real = pad_corpus_t(corpus, DENSE_TILE)
    del corpus
    m = ct.shape[1]
    nc = m // DENSE_CHUNK
    report = {"queries": [DENSE_B, DENSE_D], "corpus_t": [DENSE_D, m], "m_real": m_real,
              "chunk": DENSE_CHUNK, "m_tile": DENSE_TILE}
    for label, precision, epilogue in (("fold/high3", "high3", "fold"),
                                       ("loop/highest", "highest", "loop")):
        mode, fold = _mode(precision, ct.dtype), int(epilogue == "fold")

        def direct(kern):
            out = torch.empty(DENSE_B, nc, device=dev)
            has_mma = hasattr(kern.lib, "ircl_dense_cmax_mma")
            route = (chunk_max_route(mode, DENSE_D, DENSE_CHUNK, DENSE_TILE, epilogue)
                     if has_mma else "simt")

            def call():
                stream = torch.cuda.current_stream().cuda_stream
                if route == "mma":
                    rc = kern.lib.ircl_dense_cmax_mma(
                        queries.data_ptr(), DENSE_B, DENSE_D, ct.data_ptr(), 0, m,
                        DENSE_CHUNK, DENSE_TILE, m_real, mode, fold, out.data_ptr(),
                        stream)
                else:
                    rc = kern.lib.ircl_dense_cmax(
                        queries.data_ptr(), DENSE_B, DENSE_D, ct.data_ptr(), m,
                        DENSE_CHUNK, DENSE_TILE, m_real, mode, fold, out.data_ptr(),
                        stream)
                kern.check(rc, f"dense chunk-max launch ({route})")
            return call, out, route

        p_call, p_out, p_route = direct(parent)
        t_call, t_out, t_route = direct(this)
        p_call()
        t_call()
        torch.cuda.synchronize()
        fin = torch.isfinite(p_out)
        report[label] = {
            "routes": {"parent": p_route, "this": t_route},
            "same_pads": bool(torch.equal(fin, torch.isfinite(t_out))),
            "max_abs_difference_parent_this": float((p_out[fin] - t_out[fin]).abs().max()),
            "ms_in_turns": _in_turns(p_call, t_call),
        }
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-root", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures the card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    parent, this = _load_other(args.parent_root), load_kernels()
    report = {"device": smi, "torch": torch.__version__,
              "parent_root": args.parent_root,
              "flash_forward_in_turns": forward_in_turns(parent, this, dev),
              "dense_chunk_max_in_turns": dense_in_turns(parent, this, dev)}
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
