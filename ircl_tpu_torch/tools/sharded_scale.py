"""Pod-sharded hybrid at scale on 8 ranks.

    python3 -m ircl_tpu_torch.tools.sharded_scale [--docs 40000 --terms 96
        --vocab 400000 --batch 64 --df-threshold 64 --stats-only
        --ref {scipy,hybrid} --device cpu]

The port of ``scripts/sharded_scale.py``, with its arguments, defaults and
order of work. Two demonstrations for the FEVER full-wiki (5.4M doc) pod
story (``parallel/sharded_hybrid.py``):

1. execution: build a synthetic Zipf index (``--docs``; ``--ref scipy``
   checks parity against an exact host CSR matvec, ``--ref hybrid`` against
   the one-device hybrid engine), shard the heavy ELL over the 8 ranks of
   a ``corpus`` mesh, route light pools, run the exact sharded top-5 and
   check per-returned-doc score parity;
2. memory math: print the per-shard device budget (heavy slab bytes +
   transient scores) for this corpus and extrapolated to 5.4M docs
   (``--stats-only --docs 5400000`` measures them on a real 5.4M split
   instead of extrapolating).

The script's 8 devices are 8 ranks of ``parallel/launch.py``: gloo on the
CPU where ``--device cpu`` names it; NCCL, one rank a card, where the host
has 8 cards; otherwise gloo ranks on CUDA tensors that share the cards (NCCL
cannot put two ranks on one card). The JSON line names the backend and the
rank count. The script's ``--slab-impl`` has no counterpart: as
``parallel/sharded_hybrid.py`` says, CPU tensors take the plain slab and
CUDA tensors the kernel (#2 for each rank's doc slab, #1 for the query
slab). Runs on the card unless ``--device`` names another device; progress
goes to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

from ircl_tpu_torch.index.build import CountIndex, scipy_query_scores, to_scipy
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.split import gather_light_pools, split_index
from ircl_tpu_torch.ops.membership_cuda import pad_for_slab
from ircl_tpu_torch.parallel.launch import backend_for, launch
from ircl_tpu_torch.tools.scale_index import synth_index, synth_queries
from ircl_tpu_torch.utils.device import resolve_device

RANKS = 8  # the script's virtual devices
K = 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def shard_budget(split, n_shards: int, batch: int) -> dict:
    """Per-shard device bytes for the sharded hybrid layout."""
    k_h = split.heavy.k_width
    n = split.num_docs
    rows = -(-n // (n_shards * 256)) * 256
    slab = 2 * k_h * rows * 4  # terms int32 + vals f32, [K_h, rows]
    scores = batch * rows * 4  # transient h [B, rows] f32
    return {
        "docs_per_shard": rows,
        "heavy_width": int(k_h),
        "slab_bytes": int(slab),
        "transient_scores_bytes": int(scores),
        "total_gb": round((slab + scores) / 2**30, 3),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=40_000)
    ap.add_argument("--terms", type=int, default=96)
    ap.add_argument("--vocab", type=int, default=400_000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--df-threshold", type=int, default=64)
    ap.add_argument("--stats-only", action="store_true")
    ap.add_argument(
        "--ref", choices=("scipy", "hybrid"), default="scipy",
        help="parity reference: exact host CSR matvec (any scale) or the "
             "one-device hybrid engine",
    )
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks (default: the CUDA card)")
    return ap.parse_args(argv)


def load_index(docs: int, terms: int, vocab: int):
    """The synthetic index, from the script's cache file where one exists
    (its name in the temporary directory), else built."""
    cache = os.path.join(tempfile.gettempdir(), f"ircl_scale_{docs}_{terms}_{vocab}.npz")
    if os.path.exists(cache):
        return CountIndex.load(cache)
    return synth_index(docs, terms, vocab, 1 << 24)


def stats_record(index, docs: int, df_threshold: int, batch: int) -> dict:
    """``--stats-only``'s line: the per-shard budget of this corpus's split
    and its light postings, which stay on the host."""
    split = split_index(index, df_threshold=df_threshold)
    budget = shard_budget(split, RANKS, batch)
    budget["light_postings_host"] = int(split.light_indptr[-1])
    return {"docs": docs, "per_shard": budget}


def scipy_reference(index, qb, qw, k: int):
    """Exact host reference: per-query sparse matvec over the full CSR
    (``index/build.py::scipy_query_scores``), fast at any corpus size and
    independent of every device engine. ``(scores, ids, dense [B, N])``."""
    ref_dense = scipy_query_scores(to_scipy(index), qb, qw, index.hash_size)
    o = np.argsort(-ref_dense, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(ref_dense, o, axis=1), o, ref_dense


def hybrid_reference(single, qb, qw, k: int):
    """The one-device hybrid engine's top-k. ``(scores, ids, None)``."""
    s, i = single.hybrid_from_vectors(qb, qw, k)
    return s, i, None


def sharded_inputs(single, qb, qw) -> dict:
    """The host half of the sharded top-k, as the script builds it: the
    heavy union, the heavy query slab's operands and the light pools."""
    split = single._split
    heavy_q = split.doc_freqs[qb] > split.df_threshold
    hw = np.where(heavy_q, qw, 0.0).astype(np.float32)
    qb_t, qw_t = pad_for_slab(
        np.ascontiguousarray(qb.T.astype(np.int32)),
        np.ascontiguousarray(hw.T),
        d_tile=128,
    )
    light_docs, light_contribs, _ = gather_light_pools(split, qb, qw)
    return dict(u_pad=single._union_slots(qb, hw, floor=512), qb_t=qb_t, qw_t=qw_t,
                light_docs=light_docs, light_contribs=light_contribs)


def heavy_part(split):
    """What a rank reads of the split: the heavy ELL and the sizes. The
    light postings and the df vector stay on the host, which routes the
    pools."""
    return dataclasses.replace(
        split, light_indptr=split.light_indptr[:1], light_docs=split.light_docs[:0],
        light_vals=split.light_vals[:0], doc_freqs=split.doc_freqs[:0])


def rank_topk(split, inputs: dict, k: int, device: str):
    """One rank: its shard of the heavy ELL on a ``corpus`` mesh of every
    rank, the exact local hybrid top-k over its docs and the merge.
    ``(scores [B_pad, k], ids [B_pad, k])``, the same on every rank, and
    this rank's seconds."""
    from ircl_tpu_torch.parallel.mesh import make_mesh
    from ircl_tpu_torch.parallel.sharded_hybrid import ShardedHybridIndex

    sharded = ShardedHybridIndex(split, make_mesh(("corpus",), device=device))
    t0 = time.perf_counter()
    s, i = sharded.topk(inputs["u_pad"], inputs["qb_t"], inputs["qw_t"],
                        inputs["light_docs"], inputs["light_contribs"], k=k)
    return s, i, time.perf_counter() - t0


def sharded_topk(split, inputs: dict, k: int, device, ranks: int = RANKS):
    """``rank_topk`` in ``ranks`` ranks on ``device``'s type: rank 0's
    ``(scores, ids, seconds)`` and the backend that ran."""
    backend = backend_for(device, ranks)
    s, i, seconds = launch(rank_topk, ranks, heavy_part(split), inputs, k,
                           resolve_device(device).type, device=device, backend=backend)
    return s, i, seconds, backend


def parity_failures(s, i, ref_s, ref_i, ref_dense) -> int:
    """Queries whose sorted top-k scores miss the reference's (rtol 1e-4,
    atol 1e-6), or, against scipy, whose returned ids do not carry their
    own exact scores."""
    bad = 0
    for b in range(len(ref_s)):
        n = int((ref_i[b] >= 0).sum())
        ok = np.allclose(
            np.sort(s[b][:n]), np.sort(ref_s[b][:n]), rtol=1e-4, atol=1e-6
        )
        if ok and ref_dense is not None:
            # each returned doc id must carry its own exact reference score
            for j in range(n):
                if i[b][j] >= 0 and not np.isclose(
                    s[b][j], ref_dense[b][i[b][j]], rtol=1e-4, atol=1e-6
                ):
                    ok = False
                    break
        if not ok:
            bad += 1
    return bad


def result_line(docs: int, batch: int, bad: int, split, backend: str) -> dict:
    """The script's JSON line, with the backend and the rank count."""
    budget = shard_budget(split, RANKS, 1024)
    # extrapolate the slab linearly in docs (heavy width is df-threshold-
    # driven and roughly scale-free for Zipf corpora; measured directly via
    # --stats-only --docs 5400000)
    scale = 5_400_000 / docs
    extrap_gb = round(
        (budget["slab_bytes"] * scale + 1024 * budget["docs_per_shard"] * scale * 4)
        / 2**30,
        2,
    )
    return {
        "docs": docs,
        "parity": f"{batch - bad}/{batch}",
        "per_shard": budget,
        "extrapolated_5.4M_per_shard_gb": extrap_gb,
        "backend": backend,
        "ranks": RANKS,
    }


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.time()
    index = load_index(args.docs, args.terms, args.vocab)
    log(f"index: {index.num_docs} docs, {index.nnz} postings ({time.time()-t0:.0f}s)")

    if args.stats_only:
        record = stats_record(index, args.docs, args.df_threshold, args.batch)
        print(json.dumps(record), flush=True)
        return record

    B = args.batch
    single = TfidfRanker(index, device, mode="hybrid", df_threshold=args.df_threshold,
                         fixed_max_terms=24)
    qb, qw = synth_queries(index, B)

    t0 = time.time()
    if args.ref == "hybrid":
        ref_s, ref_i, ref_dense = hybrid_reference(single, qb, qw, K)
        log(f"one-device hybrid done in {time.time()-t0:.0f}s")
    else:
        ref_s, ref_i, ref_dense = scipy_reference(index, qb, qw, K)
        log(f"scipy reference done in {time.time()-t0:.0f}s")

    inputs = sharded_inputs(single, qb, qw)
    s, i, t_shard, backend = sharded_topk(single._split, inputs, K, device)
    s, i = s[:B], i[:B]
    log(f"sharded ({RANKS} {backend} ranks on {device.type}) done in {t_shard:.1f}s "
        f"(rank 0's top-k)")

    bad = parity_failures(s, i, ref_s, ref_i, ref_dense)
    log(f"parity: {B - bad}/{B}")
    if bad:
        raise SystemExit(f"sharded parity failed on {bad} queries")
    line = result_line(args.docs, B, bad, single._split, backend)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    # through the package's name, so that the ranks unpickle ``rank_topk``
    # from it and not from ``__main__``
    from ircl_tpu_torch.tools.sharded_scale import main as _main

    _main()
