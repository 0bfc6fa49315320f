"""Smoke run of the PyTorch + CUDA port (``ircl_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Drives the port's sparse stage-1 retrieval at the repository's judged
configuration (``bench.py``: 50,000 synthetic docs from ``generate(seed=11)``,
4096 claims, bigrams hashed into 2^24 buckets) and never imports JAX.
Phases, each printed as it runs:

0. device: the card, its power limit, the kernel build, the host library;
1. corpus and index, saved with ``CountIndex.save`` (50K docs, and the
   first 20K docs for the ELL engine);
2. every CUDA kernel against its plain PyTorch version on the card, at the
   shapes of the main path, with CUDA-event times for both;
3. the served path, hybrid: ``make_service`` + ``serve_stdin`` over JSONL,
   every reply held against scipy's top-k;
4. the served path, ELL (20K docs, ``mode="auto"``), checked the same way;
5. the judged ranker (``bench.py``'s settings) on all 4096 claims, held to
   the bench's full-batch scipy gate, then q/s and a per-stage split.

Kernel launch counts are zeroed before phase 3 and read after phase 5;
every kernel must have run there. The script exits non-zero at the first
failure, and when no CUDA device is present. The line before the last is a
JSON object of the kernels' numbers; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_DOCS = 50_000
ELL_DOCS = 20_000
NUM_CLAIMS = 4096
HASH_SIZE = 1 << 24
K = 5
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def scipy_topk(mat, buckets, weights, k):
    """Per query: (scipy's top-k positive scores, descending; dense row)."""
    from ircl_tpu_torch.index.build import scipy_query_scores

    dense = scipy_query_scores(mat, buckets, weights, HASH_SIZE)
    out = []
    for row in dense:
        top = np.sort(row[row > 0])[::-1][:k]
        out.append((top, row))
    return out


def check_replies(replies, requests, index, label):
    """Every doc-search reply against scipy: the same number of hits, the
    sorted scores within rtol 1e-4, and each doc carrying its own score."""
    from ircl_tpu_torch.index.build import to_scipy
    from ircl_tpu_torch.index.ranker import vectorize_queries

    mat = to_scipy(index)
    doc2idx = index.doc2idx
    checked = 0
    for req, rep in zip(requests, replies):
        if req is None:  # a malformed line
            if "error" not in rep:
                fail(f"{label}: malformed line answered without an error: {rep}")
            continue
        if "results" not in rep:
            fail(f"{label}: request failed: {rep}")
        queries, k = req
        b, w = vectorize_queries(
            queries, HASH_SIZE, 2, index.doc_freqs, index.num_docs, max_terms=24
        )
        refs = scipy_topk(mat, b, w, k)
        if len(rep["results"]) != len(queries):
            fail(f"{label}: {len(rep['results'])} results for {len(queries)} queries")
        for hits, (top, dense) in zip(rep["results"], refs):
            got = np.array([h["score"] for h in hits], np.float32)
            if len(got) != len(top) or not np.allclose(
                np.sort(got)[::-1], top, rtol=1e-4
            ):
                fail(f"{label}: scores {got} != scipy {top}")
            own = np.array([dense[doc2idx[h["doc_id"]]] for h in hits])
            if not np.allclose(got, own, rtol=1e-4):
                fail(f"{label}: returned docs do not carry their own scores")
            checked += 1
    return checked


def serve_lines(service, lines):
    from ircl_tpu_torch.serve import serve_stdin

    out = io.StringIO()
    served = serve_stdin(service, io.StringIO("\n".join(lines) + "\n"), out)
    replies = [json.loads(x) for x in out.getvalue().splitlines()]
    if len(replies) != len(lines):
        fail(f"{len(replies)} replies for {len(lines)} lines")
    return served, replies


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs only on a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import ircl_tpu_torch
    except ImportError as e:
        fail(f"ircl_tpu_torch is not importable next to {__file__}: {e}")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ircl_tpu_torch.__file__)))
    if pkg_root != root:  # the kernels must build from this checkout's sources
        fail(f"ircl_tpu_torch was imported from {pkg_root}, not from {root}")

    from ircl_tpu.corpus.hashing import native_available
    from ircl_tpu.corpus.store import MemoryDocStore
    from ircl_tpu.corpus.synthetic import generate
    from ircl_tpu_torch.index.build import CountIndex, build_count_index, to_scipy
    from ircl_tpu_torch.index.ranker import TfidfRanker, vectorize_queries
    from ircl_tpu_torch.index.tfidf import tfidf_transform
    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops.light_add_cuda import (
        light_add_topk_t,
        light_add_topk_t_ref,
    )
    from ircl_tpu_torch.ops.membership_cuda import (
        membership_slab,
        membership_slab_ref,
        membership_slab_windowed,
        pad_for_slab,
        scores_matmul,
    )
    from ircl_tpu_torch.serve import make_service
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    dev = torch.device(DEVICE)
    put = lambda x: torch.tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731

    # ---- phase 0: device -------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 0: device {kind}, {torch.cuda.device_count()} visible; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"phase 0: nvidia-smi: {smi}")
    kern = load_kernels()
    log(f"phase 0: kernels built in {kern.build_seconds:.2f} s -> {kern.path}")
    for line in kern.build_log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log(f"  {line.strip()}")
    log(f"phase 0: native host library loaded: {native_available()}")

    # ---- phase 1: corpus and index ----------------------------------------
    t0 = time.perf_counter()
    wiki = generate(num_docs=NUM_DOCS, num_claims=NUM_CLAIMS, seed=11)
    claims = [c.claim for c in wiki.claims]
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    log(f"phase 1: corpus generated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    index_ell = tfidf_transform(build_count_index(
        store, ngram=2, hash_size=HASH_SIZE,
        doc_ids=store.get_doc_ids()[:ELL_DOCS],
    ))
    log(f"phase 1: indexes built in {time.perf_counter() - t0:.1f} s: "
        f"{index.num_docs} docs / {index.nnz} postings; "
        f"{index_ell.num_docs} docs / {index_ell.nnz} postings")
    tmp = tempfile.TemporaryDirectory(prefix="ircl_smoke_")
    path = os.path.join(tmp.name, "index.npz")
    path_ell = os.path.join(tmp.name, "index_ell.npz")
    index.save(path)
    index_ell.save(path_ell)
    if CountIndex.load(path).nnz != index.nnz:
        fail("saved index does not load back")

    # ---- phase 2: kernels vs plain versions --------------------------------
    t0 = time.perf_counter()
    ranker = TfidfRanker(
        index, dev, mode="hybrid", df_threshold=24, width_buckets=2,
        fixed_union_cap=4096, fixed_max_terms=64, precision="high",
        union_round=512,
    )
    log(f"phase 2: judged ranker built in {time.perf_counter() - t0:.1f} s "
        f"(d_tile {ranker.d_tile})")
    buckets, weights = ranker._vectorize(claims)
    u_pad, qb_t, qw_t, ld, lc = (
        put(x) for x in ranker.hybrid_host_inputs(buckets, weights)
    )
    slab_cases = {
        "bucket a": (u_pad, *ranker._heavy_a),
        "bucket b": (u_pad, *ranker._heavy_b),
        "query": (u_pad, qb_t, qw_t),
    }
    results = {}

    def compare_slabs(name, fn, cases):
        err, ms, plain_ms = 0.0, 0.0, 0.0
        for label, args in cases.items():
            got = fn(*args)
            ref = membership_slab_ref(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                fail(f"{name} ({label}) differs from its plain version")
            err = max(err, float((got - ref).abs().max()))
            t_k = cuda_ms(lambda: fn(*args))
            t_p = cuda_ms(lambda: membership_slab_ref(*args), reps=2)
            ms, plain_ms = ms + t_k, plain_ms + t_p
            log(f"phase 2: {name} {label}: U={args[0].shape[0]} "
                f"K={args[1].shape[0]} N={args[1].shape[1]}: equal; "
                f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    compare_slabs("membership_slab_windowed", membership_slab_windowed, slab_cases)

    m, _ = hy._bucketed_membership(u_pad, *ranker._heavy_a, *ranker._heavy_b, 1024)
    wt = hy._query_slab(u_pad, qb_t, qw_t, 256, True)
    gemm_ms = cuda_ms(lambda: scores_matmul(m.T, wt), reps=3)
    h_t = scores_matmul(m.T, wt)[:, : ld.shape[0]].contiguous()  # [N_pad, B]
    del m, wt
    d_lt = next(t for t in (1024, 512, 256) if h_t.shape[0] % t == 0)
    sd, sv = ld.T.contiguous(), lc.T.contiguous()
    s1, i1 = light_add_topk_t(h_t, sd, sv, k=K, d_tile=d_lt)
    s2, i2 = light_add_topk_t_ref(h_t, sd, sv, k=K, d_tile=d_lt)
    torch.cuda.synchronize()
    if not torch.allclose(s1, s2, rtol=1e-6, atol=0.0):
        fail("light_add_topk_t scores differ from its plain version")
    tie_ok = (i1 == i2) | (s1 == s2)
    if not bool(tie_ok.all()):
        fail("light_add_topk_t ids differ from its plain version off a tie")
    results["light_add_topk_t"] = dict(
        max_abs_err=float((s1 - s2).abs().max()),
        ms=cuda_ms(lambda: light_add_topk_t(h_t, sd, sv, k=K, d_tile=d_lt)),
        plain_ms=cuda_ms(
            lambda: light_add_topk_t_ref(h_t, sd, sv, k=K, d_tile=d_lt), reps=2
        ),
    )
    log(f"phase 2: light_add_topk_t H_T={tuple(h_t.shape)} P={sd.shape[0]} "
        f"d_tile={d_lt}: scores within rtol 1e-6 ({int((i1 != i2).sum())} "
        f"ids differ, all at ties); kernel {results['light_add_topk_t']['ms']:.3f}"
        f" ms, plain {results['light_add_topk_t']['plain_ms']:.3f} ms")
    log(f"phase 2: scoring GEMM [{h_t.shape[0]} x {u_pad.shape[0]}] @ "
        f"[{u_pad.shape[0]} x {h_t.shape[1]}] fp32: {gemm_ms:.3f} ms")
    del h_t, s1, i1, s2, i2

    ell = TfidfRanker(
        index_ell, dev, mode="auto", fixed_max_terms=24,
        fixed_union_cap=4096, union_round=512,
    )
    if ell.mode != "ell":
        fail(f"mode='auto' at {ELL_DOCS} docs resolved to {ell.mode}")
    eb, ew = ell._vectorize(claims[:256])
    eq_t, ew_t = pad_for_slab(
        np.ascontiguousarray(eb.T), np.ascontiguousarray(ew.T), d_tile=128
    )
    eu = put(ell._union_slots(eb, ew, floor=4096))
    compare_slabs("membership_slab", membership_slab, {
        "ELL docs": (eu, ell._ell_terms_t, ell._ell_vals_t),
        "ELL query": (eu, put(eq_t), put(ew_t)),
    })
    del ell

    # ---- the main path: phases 3-5, with fresh launch counts ---------------
    kernels = {
        "membership_slab": membership_slab,
        "membership_slab_windowed": membership_slab_windowed,
        "light_add_topk_t": light_add_topk_t,
    }
    for fn in kernels.values():
        fn.launches = 0

    # ---- phase 3: served path, hybrid --------------------------------------
    t0 = time.perf_counter()
    svc = make_service(path, device=dev)
    log(f"phase 3: make_service in {time.perf_counter() - t0:.1f} s: mode "
        f"{svc.ranker.mode}, df_threshold {svc.ranker.df_threshold}, "
        f"width buckets {1 if svc.ranker._bucketed is None else 2}")
    if svc.ranker.mode != "hybrid" or svc.ranker._bucketed is not None:
        fail("the default service at 50K docs is not the one-bucket hybrid")
    before = membership_slab_windowed.launches
    requests = [
        ([claims[0]], 5),
        (claims[1:301], 5),
        (claims[301:311], 3),
        None,
        None,
    ]
    lines = [
        json.dumps({"query": claims[0]}),
        json.dumps({"queries": claims[1:301]}),
        json.dumps({"queries": claims[301:311], "k": 3}),
        json.dumps({"queries": "not a list"}),
        "[1, 2]",
    ]
    t0 = time.perf_counter()
    served, replies = serve_lines(svc, lines)
    log(f"phase 3: served {served} requests in {time.perf_counter() - t0:.2f} s; "
        f"metrics {svc.metrics.snapshot()}")
    n = check_replies(replies, requests, index, "phase 3")
    if membership_slab_windowed.launches == before:
        fail("phase 3 did not launch the slab kernel")
    log(f"phase 3: {n} query results match scipy (rtol 1e-4); 2 malformed "
        f"lines got error replies")
    del svc

    # ---- phase 4: served path, ELL -----------------------------------------
    svc = make_service(path_ell, device=dev)
    if svc.ranker.mode != "ell":
        fail(f"mode='auto' at {ELL_DOCS} docs served {svc.ranker.mode}")
    before = membership_slab.launches
    requests = [([claims[0]], 5), (claims[1:41], 5), (claims[41:49], 2), None]
    lines = [
        json.dumps({"query": claims[0]}),
        json.dumps({"queries": claims[1:41]}),
        json.dumps({"queries": claims[41:49], "k": 2}),
        json.dumps({"queries": [claims[0]], "k": 0}),
    ]
    served, replies = serve_lines(svc, lines)
    n = check_replies(replies, requests, index_ell, "phase 4")
    if membership_slab.launches == before:
        fail("phase 4 did not launch the slab kernel")
    log(f"phase 4: ELL service at {ELL_DOCS} docs: {n} query results match "
        f"scipy (rtol 1e-4); the malformed line got an error reply")
    del svc

    # ---- phase 5: the judged configuration ---------------------------------
    before = {name: fn.launches for name, fn in kernels.items()}
    t0 = time.perf_counter()
    results5 = ranker.closest_docs_batch(claims, k=K)
    first_s = time.perf_counter() - t0
    mat = to_scipy(index)
    b_ref, w_ref = vectorize_queries(
        claims, HASH_SIZE, 2, index.doc_freqs, index.num_docs
    )
    import scipy.sparse as sp

    doc2idx = index.doc2idx
    mismatches = 0
    for b in range(NUM_CLAIMS):  # bench.py's full-batch gate
        nz = w_ref[b] != 0
        spvec = sp.csr_matrix(
            (w_ref[b][nz], b_ref[b][nz], [0, int(nz.sum())]),
            shape=(1, HASH_SIZE),
        )
        res = spvec * mat
        if len(res.data) <= K:
            o = np.argsort(-res.data)
        else:
            o = np.argpartition(-res.data, K)[:K]
            o = o[np.argsort(-res.data[o])]
        ref_scores = res.data[o]
        got_ids = np.array([doc2idx[d] for d in results5[b][0]])
        got_scores = results5[b][1]
        n = min(len(o), len(got_ids))
        if not np.allclose(
            np.sort(ref_scores[:n]), np.sort(got_scores[:n]), rtol=1e-4
        ):
            mismatches += 1
    log(f"phase 5: parity {NUM_CLAIMS - mismatches}/{NUM_CLAIMS} queries "
        f"match scipy (rtol 1e-4); first batch {first_s:.2f} s")
    if mismatches:
        fail(f"phase 5: top-k parity failed on {mismatches} queries")
    for name in ("membership_slab_windowed", "light_add_topk_t"):
        if kernels[name].launches == before[name]:
            fail(f"phase 5 did not launch {name}")
    launches = {name: fn.launches for name, fn in kernels.items()}
    for name, count in launches.items():
        if count == 0:
            fail(f"{name} was not launched on the main path")
    log(f"phases 3-5: kernel launches {launches}")

    qps = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ranker.closest_docs_batch(claims, k=K)
        qps.append(NUM_CLAIMS / (time.perf_counter() - t0))
    log(f"phase 5: end to end at B={NUM_CLAIMS}: "
        f"{', '.join(f'{q:.1f}' for q in qps)} q/s "
        f"(median {float(np.median(qps)):.1f})")

    # per-stage split of one batch
    t0 = time.perf_counter()
    buckets, weights = ranker._vectorize(claims)
    host = ranker.hybrid_host_inputs(buckets, weights)
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_pad, qb_t, qw_t, ld, lc = (put(x) for x in host)
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    m, u_tile = hy._bucketed_membership(
        u_pad, *ranker._heavy_a, *ranker._heavy_b, ranker.d_tile
    )
    wt = hy._query_slab(u_pad, qb_t, qw_t, u_tile, True)
    ev[1].record()
    h_t = scores_matmul(m.T, wt)[:, : ld.shape[0]].contiguous()
    ev[2].record()
    ts, ti = light_add_topk_t(
        h_t, ld.T.contiguous(), lc.T.contiguous(), k=K, d_tile=d_lt
    )
    top_s, top_pos = torch.topk(ts.T, K, dim=1)
    ev[3].record()
    torch.cuda.synchronize()
    log(f"phase 5: split of one batch: host vectorize + pool gather "
        f"{host_ms:.2f} ms, upload {upload_ms:.2f} ms, slabs "
        f"{ev[0].elapsed_time(ev[1]):.3f} ms, GEMM "
        f"{ev[1].elapsed_time(ev[2]):.3f} ms, light-add + top-k "
        f"{ev[2].elapsed_time(ev[3]):.3f} ms")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    tmp.cleanup()
    if "jax" in sys.modules:
        fail("JAX was imported")

    sources = {
        "membership_slab": (
            "ircl_tpu_torch/csrc/membership_slab.cu",
            "ircl_tpu/ops/membership_pallas.py:34",
        ),
        "membership_slab_windowed": (
            "ircl_tpu_torch/csrc/membership_slab.cu",
            "ircl_tpu/ops/membership_pallas.py:101",
        ),
        "light_add_topk_t": (
            "ircl_tpu_torch/csrc/light_add_topk.cu",
            "ircl_tpu/ops/light_add_pallas.py:54",
        ),
    }
    report = []
    for name, (src, replaces) in sources.items():
        report.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], **results[name],
        ))
    log(smi)
    log(json.dumps({"kernels": report}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
