"""Kernels of this checkout against another's, in turns on one card.

    python3 -m ircl_tpu_torch.tools.kernels_in_turns --parent-root DIR
        [--only flash,dense,slab,onepass,lightadd,dotlight] [--out FILE]

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
  the largest difference between the two checkouts' chunk maxima;
- #2 and #1, the membership slabs, at the judged configuration's shapes
  (``bench.py``: 50,000 docs, 4096 claims; both width buckets into one
  slab, the query slab through both wrappers, and #1's ELL-docs slab of
  ``chip_smoke.py`` phase 2: the ELL index of the first 20,000 docs and the
  union of 256 claims) and at ``bench_scale.py``'s (1M docs, 1024
  queries): each checkout's call is what its wrapper does, so a checkout
  whose entry point has no output column offset zero-fills a slab a
  bucket and concatenates them, and one with a separate entry point for
  the windowed wrapper calls it there; for the two buckets and the ELL
  docs, this checkout's time with no ELL row (the stores alone) and with a
  union that no term matches (the terms read and searched), beside
  ``torch.zeros`` of the same slab;
- #5, the one-pass fused hybrid kernel, on both buckets of the 1M-doc
  index at ``chip_smoke.py`` phase 18's shapes, as given and with two
  ablations that show where its time goes: every ELL term a pad (the light
  pools and the top-k alone) and a union that no term matches (the
  searches added, no hit);
- #3, the light add + tile top-k, on ``chip_smoke.py`` phase 2's scores
  (the judged configuration's ``H_T [51200, 4096]``, its pools, k=5,
  ``d_tile`` 1024), as given and with three ablations: all-zero scores (the
  list filled once and then rarely touched), empty pools (no run add), and
  scores of -inf with empty pools (the stream alone: no row enters a list);
  ``torch.amax`` over the same tiles beside them, as the card's rate of
  plain reads;
- #7, the fused dot + light add, on ``chip_smoke.py`` phase 16's operands
  (the judged slabs split into bf16 halves), as given and with empty pools.

Each part reports the largest difference between the two checkouts'
outputs. Prints one JSON report, with the card's name and power limit as
``nvidia-smi`` gives them, and writes it to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

import numpy as np

from ircl_tpu_torch.ops.dense_topk_cuda import _mode, chunk_max_route, pad_corpus_t
from ircl_tpu_torch.tools.profile_verdict_train import (
    _in_turns,
    _load_other,
    _ms,
    forward_in_turns,
)
from ircl_tpu_torch.utils.kernel_build import load_kernels

DENSE_M, DENSE_D, DENSE_B = 1_000_000, 128, 1024  # bench_dense.py's shape
DENSE_TILE, DENSE_CHUNK = 8192, 32
HASH_SIZE = 1 << 24
JUDGED_DOCS, JUDGED_CLAIMS = 50_000, 4096  # bench.py's configuration
JUDGED_RANKER = dict(mode="hybrid", df_threshold=24, width_buckets=2,
                     fixed_union_cap=4096, fixed_max_terms=64, precision="high",
                     union_round=512)
ELL_DOCS, ELL_CLAIMS = 20_000, 256  # chip_smoke.py phase 2's ELL slab
ELL_RANKER = dict(mode="ell", fixed_max_terms=24, fixed_union_cap=4096, union_round=512)
SCALE_DOCS, SCALE_TERMS, SCALE_VOCAB, SCALE_B = 1_000_000, 96, 2_000_000, 1024
SCALE_RANKER = dict(mode="hybrid", df_threshold=256, width_buckets=2,
                    precision="high", fixed_max_terms=24, d_tile=512)
K = 5


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


def judged_inputs(dev):
    """bench.py's ranker and one batch of its 4096 claims on the card:
    (ranker, [u_pad, qb_t, qw_t, light docs, light contribs], ELL docs),
    ELL docs being chip_smoke.py phase 2's (union, terms, values) of the
    ELL index over the first 20,000 docs and 256 claims."""
    from ircl_tpu_torch.corpus.store import MemoryDocStore
    from ircl_tpu_torch.corpus.synthetic import generate
    from ircl_tpu_torch.index.build import build_count_index
    from ircl_tpu_torch.index.ranker import TfidfRanker
    from ircl_tpu_torch.index.tfidf import tfidf_transform

    wiki = generate(num_docs=JUDGED_DOCS, num_claims=JUDGED_CLAIMS, seed=11)
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    ranker = TfidfRanker(index, dev, **JUDGED_RANKER)
    claims = [c.claim for c in wiki.claims]
    buckets, weights = ranker._vectorize(claims)
    host = ranker.hybrid_host_inputs(buckets, weights)
    index_ell = tfidf_transform(build_count_index(
        store, ngram=2, hash_size=HASH_SIZE, doc_ids=store.get_doc_ids()[:ELL_DOCS]))
    ell = TfidfRanker(index_ell, dev, **ELL_RANKER)
    eb, ew = ell._vectorize(claims[:ELL_CLAIMS])
    eu = torch.tensor(ell._union_slots(eb, ew, floor=4096), device=dev)
    return (ranker, [torch.tensor(np.ascontiguousarray(x), device=dev) for x in host],
            (eu, ell._ell_terms_t, ell._ell_vals_t))


def scale_inputs(dev):
    """bench_scale.py's ranker and its 1024 queries on the card."""
    from ircl_tpu_torch.index.ranker import TfidfRanker
    from ircl_tpu_torch.tools.scale_index import synth_index, synth_queries

    index = synth_index(SCALE_DOCS, SCALE_TERMS, SCALE_VOCAB, HASH_SIZE)
    qb, qw = synth_queries(index, SCALE_B)
    ranker = TfidfRanker(index, dev, **SCALE_RANKER)
    host = ranker.hybrid_host_inputs(qb, qw)
    return ranker, [torch.tensor(np.ascontiguousarray(x), device=dev) for x in host]


def _slab_call(kern, u, parts, windowed):
    """What a checkout's slab wrapper does for the column parts
    ``[(terms, vals), ...]`` side by side: one buffer and a launch a part
    into its columns where the entry point takes an output column offset,
    else a zero-filled slab a part (the launch adds into it), concatenated."""
    lib = kern.lib
    offsets = len(lib.ircl_membership_slab.argtypes) == 10
    entry = lib.ircl_membership_slab
    if windowed and offsets and hasattr(lib, "ircl_membership_slab_windowed"):
        entry = lib.ircl_membership_slab_windowed
    n_all = sum(t.shape[1] for t, _ in parts)

    def launch(terms, vals, out, *ld_col):
        rc = entry(u.data_ptr(), u.shape[0], terms.data_ptr(), vals.data_ptr(),
                   terms.shape[0], terms.shape[1], out.data_ptr(), *ld_col,
                   torch.cuda.current_stream().cuda_stream)
        kern.check(rc, "membership slab launch")

    def call():
        if offsets:
            out = torch.empty(u.shape[0], n_all, device=u.device)
            col = 0
            for terms, vals in parts:
                launch(terms, vals, out, n_all, col)
                col += terms.shape[1]
            return out
        slabs = []
        for terms, vals in parts:
            slabs.append(torch.zeros(u.shape[0], terms.shape[1], device=u.device))
            launch(terms, vals, slabs[-1])
        return slabs[0] if len(slabs) == 1 else torch.cat(slabs, dim=1)
    return call


def slab_in_turns(parent, this, ranker, dev_in, ell=None) -> dict:
    u, qb_t, qw_t = dev_in[:3]
    cases = {
        "buckets a + b, windowed": (u, [ranker._heavy_a, ranker._heavy_b], True),
        "query, windowed": (u, [(qb_t, qw_t)], True),
        "query, membership_slab": (u, [(qb_t, qw_t)], False),
    }
    report = {"U": u.shape[0], "buckets": [list(ranker._heavy_a[0].shape),
                                           list(ranker._heavy_b[0].shape)],
              "query": list(qb_t.shape)}
    if ell is not None:  # #1's main launch
        cases["ELL docs, membership_slab"] = (ell[0], [ell[1:]], False)
        report["ELL docs"] = {"U": ell[0].shape[0], "terms": list(ell[1].shape)}
    for label, (u_in, parts, windowed) in cases.items():
        p_call = _slab_call(parent, u_in, parts, windowed)
        t_call = _slab_call(this, u_in, parts, windowed)
        p_out, t_out = p_call(), t_call()
        torch.cuda.synchronize()
        report[label] = {
            "bit_equal": bool(torch.equal(p_out, t_out)),
            "max_abs_difference_parent_this": float((p_out - t_out).abs().max()),
            "ms_in_turns": _in_turns(p_call, t_call),
        }
        del p_out, t_out
        torch.cuda.empty_cache()
    # where this checkout's time goes on the two buckets (and #1's ELL
    # docs): the stores alone (no ELL row: every cell a 0), and the terms
    # read and searched with no hit (a union above every term); torch.zeros
    # of the same slab beside them, as the card's rate of plain writes
    for label in ("buckets a + b, windowed", "ELL docs, membership_slab"):
        if label not in cases:
            continue
        u_in, parts, windowed = cases[label]
        n_all = sum(t.shape[1] for t, _ in parts)
        report[label.split(",")[0] + ", this checkout's parts"] = {
            "ms_stores_only": _ms(_slab_call(
                this, u_in, [(t[:0], v[:0]) for t, v in parts], windowed)),
            "ms_no_hit": _ms(_slab_call(this, u_in + (1 << 30), parts, windowed)),
            "ms_as_given": _ms(_slab_call(this, u_in, parts, windowed)),
            "ms_torch_zeros": _ms(
                lambda: torch.zeros(u_in.shape[0], n_all, device=u_in.device)),
        }
    return report


def onepass_in_turns(parent, this, ranker, dev_in) -> dict:
    """#5 on both buckets at phase 18's shapes, as given and ablated."""
    from ircl_tpu_torch.ops import hybrid as hy

    u, qb_t, qw_t, ld, lc = dev_in
    B = ld.shape[0]
    wt = hy._query_slab(u, qb_t, qw_t, hy._u_tile(u.shape[0]), True)[:, :B].contiguous()
    sd_t, sv_t = ld.T.contiguous(), lc.T.contiguous()
    na = ranker._heavy_a[0].shape[1]
    never = u + (1 << 30)  # ascending, above every term: searches, no hit
    report = {"U": u.shape[0], "B": B, "P": sd_t.shape[0]}
    for label, (terms, vals), base in (("bucket a", ranker._heavy_a, 0),
                                       ("bucket b", ranker._heavy_b, na)):
        d_tile = next(t for t in (1024, 512, 256) if terms.shape[1] % t == 0)
        n_dt = terms.shape[1] // d_tile
        pads = torch.full_like(terms, -1)
        part = {"ell": list(terms.shape), "d_tile": d_tile}
        for variant, t_in, u_in in (("as given", terms, u), ("all pads", pads, u),
                                    ("no hit", terms, never)):
            def direct(kern):
                out_s = torch.empty(n_dt * 8, B, device=u.device)
                out_i = torch.empty(n_dt * 8, B, dtype=torch.int32, device=u.device)

                def call():
                    rc = kern.lib.ircl_fused_hybrid(
                        t_in.data_ptr(), vals.data_ptr(), t_in.shape[0], t_in.shape[1],
                        u_in.data_ptr(), u_in.shape[0], wt.data_ptr(), B,
                        sd_t.data_ptr(), sv_t.data_ptr(), sd_t.shape[0], d_tile, base,
                        K, out_s.data_ptr(), out_i.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    kern.check(rc, "fused hybrid launch")
                return call, out_s, out_i

            (p_call, ps, pi), (t_call, ts, ti) = direct(parent), direct(this)
            p_call()
            t_call()
            torch.cuda.synchronize()
            part[variant] = {
                "bit_equal": bool(torch.equal(ps, ts) and torch.equal(pi, ti)),
                "max_abs_difference_parent_this": float((ps - ts).abs().max()),
                "positions_that_differ": int((pi != ti).sum()),
                "ms_in_turns": _in_turns(p_call, t_call),
            }
        report[label] = part
        del pads
        torch.cuda.empty_cache()
    return report


def _top_k_call(kern, entry, args, n_rows, B, d_tile):
    """A checkout's light_add_topk_t-shaped C entry on ``args`` (everything
    before d_tile, k and the outputs), into one pair of output buffers."""
    n_dt, k8 = n_rows // d_tile, -(-K // 8) * 8
    out_s = torch.empty(n_dt * k8, B, device="cuda")
    out_i = torch.empty(n_dt * k8, B, dtype=torch.int32, device="cuda")

    def call():
        rc = getattr(kern.lib, entry)(*args, d_tile, K, out_s.data_ptr(), out_i.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
        kern.check(rc, f"{entry} launch")
    return call, out_s, out_i


def _compare(p, t, bit_equal=True, compare=True) -> dict:
    """Both checkouts' calls in turns, with the difference between their
    outputs (``compare=False`` for an ablation whose outputs are arbitrary)."""
    (p_call, ps, pi), (t_call, ts, ti) = p, t
    out = {}
    if compare:
        p_call()
        t_call()
        torch.cuda.synchronize()
        out = {"max_abs_difference_parent_this": float((ps - ts).abs().max()),
               "positions_that_differ": int((pi != ti).sum())}
        if bit_equal:
            out["bit_equal"] = bool(torch.equal(ps, ts) and torch.equal(pi, ti))
    out["ms_in_turns"] = _in_turns(p_call, t_call)
    return out


def _judged_scores(ranker, dev_in):
    """Phase 2's operands: the judged slab M [U, N_pad] and query slab
    [U, B] f32, the pools [P, B]."""
    from ircl_tpu_torch.ops import hybrid as hy

    u, qb_t, qw_t, ld, lc = dev_in
    m, u_tile = hy._bucketed_membership(u, *ranker._heavy_a, *ranker._heavy_b,
                                        ranker.d_tile)
    wt = hy._query_slab(u, qb_t, qw_t, u_tile, True)[:, : ld.shape[0]].contiguous()
    return m, wt, ld.T.contiguous(), lc.T.contiguous()


def light_add_in_turns(parent, this, ranker, dev_in) -> dict:
    """#3 on phase 2's H_T, as given and ablated (see the module note)."""
    from ircl_tpu_torch.ops.membership_cuda import scores_matmul

    m, wt, sd, sv = _judged_scores(ranker, dev_in)
    h_t = scores_matmul(m.T, wt).contiguous()
    del m, wt
    n, B = h_t.shape
    d_tile = next(t for t in (1024, 512, 256) if n % t == 0)
    report = {"H_T": [n, B], "P": sd.shape[0], "d_tile": d_tile, "k": K}
    zeros, never = torch.zeros_like(h_t), torch.full_like(h_t, float("-inf"))
    for label, h, d, c in (("as given", h_t, sd, sv), ("zero H_T", zeros, sd, sv),
                           ("empty pools", h_t, sd[:0], sv[:0]),
                           ("stream only", never, sd[:0], sv[:0])):
        args = (h.data_ptr(), d.data_ptr(), c.data_ptr(), n, B, d.shape[0])
        report[label] = _compare(  # with no score above -inf, any rows are a top-k
            _top_k_call(parent, "ircl_light_add_topk", args, n, B, d_tile),
            _top_k_call(this, "ircl_light_add_topk", args, n, B, d_tile),
            compare=label != "stream only")
    report["ms_torch_amax_of_the_tiles"] = _ms(
        lambda: torch.amax(h_t.view(n // d_tile, d_tile, B), dim=1))
    return report


def dot_light_in_turns(parent, this, ranker, dev_in) -> dict:
    """#7 on phase 16's operands, as given and with empty pools. The two
    checkouts sum in other orders: the largest difference is reported, and
    for each, how much of the probe's bound (rtol 2e-5, atol 1e-5) its
    scores use against the plain version's."""
    from ircl_tpu_torch.ops.fused_dot_light_cuda import (
        fused_dot_light_topk_ref, split_hi_lo,
    )

    m, wt, sd, sv = _judged_scores(ranker, dev_in)
    (mh, ml), (wh, wl) = split_hi_lo(m), split_hi_lo(wt)
    del m, wt
    (U, n), B = mh.shape, wh.shape[1]
    d_tile = next(t for t in (1024, 512, 256) if n % t == 0)
    report = {"m": [U, n], "w": [U, B], "P": sd.shape[0], "d_tile": d_tile, "k": K}
    for label, d, c in (("as given", sd, sv), ("empty pools", sd[:0], sv[:0])):
        args = (mh.data_ptr(), ml.data_ptr(), U, n, wh.data_ptr(), wl.data_ptr(), B,
                d.data_ptr(), c.data_ptr(), d.shape[0])
        calls = [_top_k_call(kern, "ircl_fused_dot_light", args, n, B, d_tile)
                 for kern in (parent, this)]
        report[label] = _compare(*calls, bit_equal=False)
        if label == "as given":
            ref_s, ref_i = fused_dot_light_topk_ref(mh, ml, wh, wl, d, c, k=K,
                                                    d_tile=d_tile)
            live = ref_i >= 0
            for name, (_, got_s, _) in zip(("parent", "this"), calls):
                gap = (got_s - ref_s).abs()
                report[label][f"{name}_against_plain"] = {
                    "max_abs_difference": float(gap[live].max()),
                    "share_of_tolerance": float(
                        (gap / (1e-5 + 2e-5 * ref_s.abs()))[live].max()),
                }
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-root", required=True)
    ap.add_argument("--only", default="flash,dense,slab,onepass,lightadd,dotlight",
                    help="comma-separated parts to run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    parts = set(args.only.split(","))
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures the card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    parent, this = _load_other(args.parent_root), load_kernels()
    report = {"device": smi, "torch": torch.__version__,
              "parent_root": args.parent_root}
    if "flash" in parts:
        report["flash_forward_in_turns"] = forward_in_turns(parent, this, dev)
    if "dense" in parts:
        report["dense_chunk_max_in_turns"] = dense_in_turns(parent, this, dev)
        torch.cuda.empty_cache()
    if parts & {"slab", "lightadd", "dotlight"}:
        ranker, dev_in, ell = judged_inputs(dev)
        if "slab" in parts:
            report["membership_slab_50k_in_turns"] = slab_in_turns(parent, this, ranker,
                                                                   dev_in, ell)
        if "lightadd" in parts:
            report["light_add_topk_in_turns"] = light_add_in_turns(parent, this, ranker,
                                                                   dev_in)
        if "dotlight" in parts:
            report["fused_dot_light_in_turns"] = dot_light_in_turns(parent, this, ranker,
                                                                    dev_in)
        del ranker, dev_in, ell
        torch.cuda.empty_cache()
    if parts & {"slab", "onepass"}:
        ranker, dev_in = scale_inputs(dev)
        if "slab" in parts:
            report["membership_slab_1m_in_turns"] = slab_in_turns(parent, this, ranker,
                                                                  dev_in)
        if "onepass" in parts:
            report["fused_hybrid_1m_in_turns"] = onepass_in_turns(parent, this, ranker,
                                                                  dev_in)
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
