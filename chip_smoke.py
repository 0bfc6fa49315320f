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
   shapes of the main path, with CUDA-event times for both; the slab
   kernel also with both width buckets launched into one shared buffer,
   and on seeded edge cases (runs of equal union slots, repeated terms,
   terms out of order, a wide union, unaligned column offsets); the light
   add on seeded edge cases, bit for bit (k on and above its register
   lists, ties across its row groups, one column's pool in one d-tile,
   empty pools, other d_tile, B off its column block and odd);
3. the served path, hybrid: ``make_service`` + ``serve_stdin`` over JSONL,
   every reply held against scipy's top-k;
4. the served path, ELL (20K docs, ``mode="auto"``), checked the same way;
5. the judged ranker (``bench.py``'s settings) on all 4096 claims, held to
   the bench's full-batch scipy gate, then q/s and a per-stage split;
6. the dense chunk-max kernels (``cosine_topk_fused``'s phase 1; the bf16
   tensor-core kernel and the SIMT kernel, as ``chunk_max_route`` routes a
   call) against their plain version at ``bench_dense.py``'s shape and on a
   small ragged shape, for fold/high3, loop/high3, loop/highest and a bf16
   corpus with slack chunks, each route launched;
7. ``bench_dense.py``'s configuration on the port (1M x 128 corpus, 1024
   queries, top-5): the fused, two-phase and scan engines, the fused one
   held to the bench's full-batch numpy gate, then q/s;
8. the sentence encoder at full width (12-layer 768-wide transformer over a
   WordPiece vocab trained on 5,000 docs, BiLSTM 3 x 256 -> 128), random
   weights from a seed: the card against the CPU, rows against their batch,
   then every sentence of those docs embedded;
9. served sentence search over those docs (``make_service`` with a
   precomputed sentence table, ``serve_stdin``), every reply checked, and
   the dense top-k over the sentence table against numpy;
10. the flash-attention kernel against its plain version (in full fp32, and
    with its products split into TF32 halves as the kernel takes them) at
    the verdict model's shape, ``[32, 12, 512, 64]``, with segment ids from
    tokenized claim/evidence pairs, a batch with no pads and a row of one
    real token;
11. the verdict classifier at roberta-base width (12 layers, 768 wide,
    50,265-word embedding table, one token type, L=512, flash attention),
    random weights from a seed: the card against the CPU, flash against the
    "xla" path, a row against its batch, then pairs/s through
    ``VerdictClassifier.classify`` at batch 32;
12. served claim verification: the classifier saved and loaded back as a
    checkpoint, ``make_service`` over phase 9's index and sentence table,
    claim lines through ``serve_stdin``, every reply checked;
13. the two flash-attention backward kernels against their plain version
    (in full fp32, and with its products split into TF32 halves as the
    kernels take them) and against autograd through the plain forward at the
    training shape, ``[8, 12, 512, 64]``: the forward's softmax statistics,
    then dq, dk, dv, each launched twice for equal bits, under four sets of
    segment ids (tokenized pairs, no pads, key ids that differ from the
    query ids with a query that matches no key, short pairs whose empty
    tiles are skipped), with CUDA-event times of each beside PyTorch's own
    fused attention as a yardstick;
14. the verdict train step at roberta-base width, B=8, L=512: flash against
    "xla" on the card (loss and every gradient leaf), one step of two pairs
    on the card against the CPU, the body frozen bit for bit until
    ``warmup_steps``, then 20 timed steps of each attention path: steps/s,
    device ms a step, peak memory, kernel launches a step;
15. the trainer end to end: ``train_verdict`` on 256 seeded pairs for 2
    epochs with a validation split, its checkpoint loaded by
    ``VerdictClassifier`` and held to ``predict_in_batches``, whose
    examples/s at batch 64 is printed;
16. the two probe kernels against their plain versions: the fused dot +
    light add on seeded edge cases (U off its stages and empty, B off its
    column block, other d_tile, k above its register lists) and on phase
    5's 50K-doc operands (slabs split into bf16 halves), also held to the
    fused engine's top-5; the pre-split dense chunk-max on
    phase 7's 1M x 128 corpus, bit for bit equal to the "high3" kernel, and
    ``cosine_topk_fused_presplit`` through ``bench_dense.py``'s gate;
17. sparse retrieval at scale, ``bench_scale.py``'s configuration: a
    synthetic 1M-doc index, 1024 queries of 24 terms, the staged bucketed
    engine, ``select_rescore=16`` and (on 32 queries) the ragged engine, each
    held to the bench's scipy gate, then q/s, ms by stage and peak memory,
    and the slab kernel against its plain version on this index's slabs;
18. the one-pass fused hybrid kernel against its plain version on both
    buckets of that index, and ``hybrid_topk_onepass`` on phase 17's inputs
    held to the staged engine's top-5 and to the scipy gate, with its ms a
    batch and peak memory beside the staged engine's;
19. ``ChunkedHybridRanker`` over the same index in two chunks of 500K docs,
    held to the single ranker's scores and ids, then q/s;
20. contrastive training, ``bench_train.py``'s compiled step: ``TrainConfig()``
    (BiLSTM 3 x 256 bidirectional over 768-d hash features -> 128, 128 x 2
    micro-batches, queue 12,544, Adam) on ``bench_train.py``'s seeded ids:
    one step on the card against the CPU from one state (loss, grad norm,
    both encoders, Adam's moments, the queue, pointer and step), the queue
    term switching on at ``queue_start_steps``, a bfloat16 step, then 30
    timed steps (steps/s, device ms, peak memory), their CUDA launches and
    idle share by ``torch.profiler``, and one step's device time by stage;
21. ``bench_train.py --e2e``: ``ContrastiveTrainer`` over 2,000 synthetic
    docs with augment pairs, 200 timed steps; its checkpoint restored bit
    for bit and resumed; stage 2's claim/evidence cosine from the trained
    state; then ProtoNCE at (4096, 6144, 8192) clusters over 20,000 docs,
    refreshed twice by k-means on the card, its centroids and densities
    checked.

Kernel launch counts are zeroed before phase 3 and read after phase 5 (the
sparse path), zeroed again before phase 7 and read after phase 9 (the
dense path), before phase 11 and read after phase 12 (the verdict path),
before phase 14 and read after phase 15 (the training path), inside phase
16 after its comparisons (the probes' paths) and before phase 17, read after
phase 19 (the scale path); every kernel must have run on its path, and
launches made to compare a kernel with its plain version are not counted.
No kernel lies on the contrastive training path: every count is zeroed
before phase 20 and must still be 0 after phase 21.
The script exits non-zero at the first
failure, and when no CUDA device is present. The line before the last is a
JSON object of the kernels' numbers, each with the least time the card could
take for the same work (``bound_ms``: its tensors moved once at 3.35 TB/s
against its operations at the card's published peak for their type); the
last line is ``{"ok": true, "device": {...}}``.
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
# bench_dense.py's configuration
DENSE_M, DENSE_D, DENSE_B = 1_000_000, 128, 1024
DENSE_TILE, DENSE_CHUNK = 8192, 32
DENSE_SCAN_BLOCK = 200_000  # divides M; the scan engine's corpus rows per step
CMAX_ATOL = 1e-6  # chunk maxima: unit cosines; bf16 products are exact in fp32,
# so only the order of the fp32 sums differs (the tensor cores' or the lanes')
# the encoder phases
ENC_DOCS = 5_000
ENC_BATCH = 256
ENC_SEED = 0  # the BiLSTM head's generator (the transformer uses its config's)
ENC_DEVICE_ATOL = 1e-4  # card against CPU: fp32 through 12 layers, TF32 off
# the verdict phases: bench_verdict.py's roberta-base shape, cli serve's batch
VERDICT_L, VERDICT_BATCH, VERDICT_SEED = 512, 32, 3
VERDICT_ENCODER = dict(  # bench_verdict.py:83-97, f32, flash attention
    vocab_size=50265, hidden=768, layers=12, heads=12, intermediate=3072,
    max_positions=512, type_vocab=1, position_offset=2, layernorm_eps=1e-5,
    attention="flash",
)
VERDICT_PAIRS = 1024  # pairs through classify for pairs/s
FLASH_ATOL = 1e-5  # kernel against plain version: split-TF32 products (hi.hi +
# (lo.hi + hi.lo), lo.lo left out: 2^-22 of a product) and the fp32 summation order
VERDICT_DEVICE_ATOL = 1e-4  # logits, card against CPU and flash against xla
# the training phases: bench_verdict.py's train batch, a short warmup
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_LR, TRAIN_TIMED_STEPS = 8, 3, 1e-5, 20
TRAIN_GRAD_ATOL = 1e-5  # gradient leaves, flash against xla: fp32 through 12 layers
TRAIN_GRAD_RTOL = 1e-2  # and of each leaf's largest element
TRAINER_PAIRS, TRAINER_EPOCHS, PREDICT_BATCH = 256, 2, 64
# the contrastive training phases: bench_train.py's two shapes, TrainConfig()
CT_FEAT = dict(dim=768, max_len=64)  # HashEmbedFeaturizer: a 2^18 x 768 table
CT_TRAIN = {}  # TrainConfig's defaults: BiLSTM 3 x 256 bi over 768-d -> 128
CT_WARMUP, CT_TIMED_STEPS, CT_PROFILED_STEPS = 3, 30, 3
CT_E2E_DOCS, CT_E2E_WARMUP, CT_E2E_STEPS, CT_E2E_CLAIMS = 2000, 20, 200, 256
CT_STAGED_STEPS = 20
CT_PROTO_DOCS, CT_PROTO_STEPS, CT_PROTO_EVERY, CT_PROTO_LOG = 20_000, 20, 10, 5
CT_RTOL = 1e-5  # loss and gradient norm, card against CPU: fp32, TF32 off
CT_QUEUE_ATOL = 1e-5  # the enqueued keys: unit vectors, card against CPU
CT_MOMENT_RTOL = (1e-4, 2e-4)  # mu, nu: of each leaf's largest element
# the scale phases: bench_scale.py's configuration
SCALE_DOCS, SCALE_TERMS, SCALE_VOCAB, SCALE_B = 1_000_000, 96, 2_000_000, 1024
SCALE_RANKER = dict(mode="hybrid", df_threshold=256, width_buckets=2,
                    precision="high", fixed_max_terms=24, d_tile=512)
SCALE_PARITY, SCALE_RAGGED, SCALE_SELECT, SCALE_CHUNK = 256, 32, 16, 500_000
FUSED_DOT_RTOL, FUSED_DOT_ATOL = 2e-5, 1e-5  # the probe's own bound
ONEPASS_RTOL = 1e-5  # against the slab GEMM: another summation order
# published peaks of one H100 SXM (NVIDIA's data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores; one FMA is two
BF16_FLOPS = 989e12  # tensor cores, dense
TF32_FLOPS = 495e12  # tensor cores, dense; an f32-accurate product is three passes


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


def least_time(tensors, operations, rate):
    """``bound_ms`` and ``bound_by`` of one kernel call: the larger of its
    tensors moved once at the card's memory rate and its operations at the
    card's peak ``rate`` for their type."""
    moved = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes, t_ops = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * operations / rate
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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


def _topk_ref_blocked(queries, corpus, k, block=125_000):
    """Exact numpy f32 top-k over the full query batch, corpus-blocked so
    the score matrix transient stays ~0.5GB. Returns (sorted scores [B,k],
    list of B id sets). Copied from ``bench_dense.py``, which imports JAX."""
    B = queries.shape[0]
    m = corpus.shape[0]
    best_s = np.full((B, k), -np.inf, np.float32)
    best_i = np.full((B, k), -1, np.int64)
    for lo in range(0, m, block):
        s = queries @ corpus[lo : lo + block].T  # [B, <=block]
        part = np.argpartition(-s, k - 1, axis=1)[:, :k]
        ps = np.take_along_axis(s, part, axis=1)
        cat_s = np.concatenate([best_s, ps], axis=1)
        cat_i = np.concatenate([best_i, part + lo], axis=1)
        sel = np.argpartition(-cat_s, k - 1, axis=1)[:, :k]
        best_s = np.take_along_axis(cat_s, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    order = np.argsort(-best_s, axis=1, kind="stable")
    best_s = np.take_along_axis(best_s, order, axis=1)
    best_i = np.take_along_axis(best_i, order, axis=1)
    return best_s, [set(row.tolist()) for row in best_i]


def unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def same_topk(s1, i1, s2, i2, rtol):
    """Scores within rtol; ids equal except where the scores tie."""
    import torch

    if not torch.allclose(s1, s2, rtol=rtol, atol=0.0):
        return False
    return bool(((i1 == i2) | (s1 == s2)).all())


def phase6_dense_kernel(dev, q_d, ct_d, rows_d, m_real, results):
    """Kernel #4 against its plain version, at the bench shape and on a small
    ragged shape. Chunk maxima within CMAX_ATOL (with the same -inf pads);
    the final top-k of both phase 1s equal, ids up to exact ties."""
    import torch

    from ircl_tpu_torch.ops.dense_topk_cuda import (
        _mode, chunk_max, chunk_max_ref, chunk_max_route, pad_corpus_t, select_rescore,
    )

    rng = np.random.default_rng(6)
    sq = torch.tensor(unit_rows(rng, 37, DENSE_D), device=dev)
    s_ct, s_m = pad_corpus_t(torch.tensor(unit_rows(rng, 5000, DENSE_D), device=dev),
                             1024)  # 5000 real columns of 5120
    s_rows = s_ct.T.contiguous()
    shapes = {
        "bench": (q_d, ct_d, rows_d, m_real, DENSE_TILE),
        "ragged": (sq, s_ct, s_rows, s_m, 1024),
    }
    configs = [  # (label, precision, epilogue, extra_chunks, bf16 corpus)
        ("fold/high3", "high3", "fold", 0, False),
        ("loop/high3", "high3", "loop", 0, False),
        ("loop/highest", "highest", "loop", 0, False),
        ("bf16 corpus/extra 2", "default", "fold", 2, True),
    ]
    routes = {"mma": 0, "simt": 0}
    for shape, (q, ct, rows, m, tile) in shapes.items():
        for label, prec, epi, extra, bf16 in configs:
            c = ct.to(torch.bfloat16) if bf16 else ct
            args = (q, c, DENSE_CHUNK, tile, m, prec, epi)
            route = chunk_max_route(_mode(prec, c.dtype), q.shape[1], DENSE_CHUNK, tile,
                                    epi)
            before = chunk_max.launches_by_route[route]
            got = chunk_max(*args)
            if chunk_max.launches_by_route[route] != before + 1:
                fail(f"phase 6: {shape} {label} did not launch the {route} kernel")
            routes[route] += 1
            ref = chunk_max_ref(*args)
            torch.cuda.synchronize()
            fin = torch.isfinite(ref)
            if not torch.equal(torch.isfinite(got), fin):
                fail(f"phase 6: {shape} {label}: the -inf pads differ")
            err = float((got[fin] - ref[fin]).abs().max())
            if err > CMAX_ATOL:
                fail(f"phase 6: {shape} {label}: chunk maxima differ by {err}")
            s1, i1 = select_rescore(q, c, got, K, DENSE_CHUNK, tile, m, extra,
                                    epi, rows)
            s2, i2 = select_rescore(q, c, ref, K, DENSE_CHUNK, tile, m, extra,
                                    epi, rows)
            if not same_topk(s1, i1, s2, i2, 1e-6):
                fail(f"phase 6: {shape} {label}: top-{K} differs from the plain path")
            t_k = cuda_ms(lambda: chunk_max(*args))
            t_p = cuda_ms(lambda: chunk_max_ref(*args), reps=2)
            log(f"phase 6: {shape} B={q.shape[0]} M_pad={c.shape[1]} "
                f"(m_real {m}) {label}, {route} kernel: chunk maxima within {err:.3g} "
                f"(bound {CMAX_ATOL}), top-{K} equal ({int((i1 != i2).sum())} ids "
                f"differ, all at ties); kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
            if shape == "bench" and label == "fold/high3":
                # high3 is three products of bf16 halves summed in f32:
                # the tensor cores' bf16 rate is the card's peak for them
                results["cosine_topk_fused"] = dict(
                    max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=None,
                    **least_time((q, c, got), 3 * 2 * q.shape[0] * q.shape[1] * m,
                                 BF16_FLOPS),
                )
            if shape == "bench" and label == "loop/highest":
                results["cosine_topk_fused"]["simt_loop_highest_ms"] = t_k
            results["cosine_topk_fused"]["max_abs_err"] = max(
                results["cosine_topk_fused"]["max_abs_err"], err)
            del got, ref
    if not all(routes.values()):
        fail(f"phase 6: a route of the chunk-max kernels was not exercised: {routes}")
    log(f"phase 6: calls by route {routes}")


def timed_qps(fn, batch, reps=10):
    """Queries per second of ``fn`` by the host clock around synchronized
    runs (one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return batch * reps / (time.perf_counter() - t0)


def phase7_dense_bench(dev, queries, corpus, q_d, ct_d, rows_d, m_real):
    """bench_dense.py on the port: the engines, the full-batch numpy gate on
    the fused one, q/s."""
    import torch

    from ircl_tpu_torch.dense.scorer import cosine_topk_scan, cosine_topk_twophase
    from ircl_tpu_torch.ops.dense_topk_cuda import cosine_topk_fused

    corpus_d = torch.tensor(corpus, device=dev)
    fused = lambda prec: lambda: cosine_topk_fused(  # noqa: E731
        q_d, ct_d, k=K, chunk=DENSE_CHUNK, m_tile=DENSE_TILE, m_real=m_real,
        epilogue="fold", precision=prec, corpus_rows=rows_d,
    )
    engines = {
        "fused_fold_high3": fused("high3"),
        "twophase_highest": lambda: cosine_topk_twophase(
            q_d, corpus_d, k=K, chunk=128, precision="highest"),
        "scan_highest": lambda: cosine_topk_scan(
            q_d, corpus_d, k=K, chunk=64, block=DENSE_SCAN_BLOCK, precision="highest"),
        "fused_fold_None (informational)": fused(None),
    }
    t0 = time.perf_counter()
    ref_s, ref_sets = _topk_ref_blocked(queries, corpus, K)
    log(f"phase 7: full-batch numpy f32 reference (bench_dense.py's) in "
        f"{time.perf_counter() - t0:.1f} s on the host")
    torch.cuda.reset_peak_memory_stats()
    for name, fn in engines.items():
        s, i = (x.cpu().numpy() for x in fn())
        bad_s = sum(
            not np.allclose(s[b], ref_s[b], rtol=1e-5) for b in range(DENSE_B)
        )
        bad_i = sum(set(i[b].tolist()) != ref_sets[b] for b in range(DENSE_B))
        qps = timed_qps(fn, DENSE_B)
        log(f"phase 7: {name}: full-batch score parity {DENSE_B - bad_s}/"
            f"{DENSE_B} (rtol 1e-5; id-set tie swaps {bad_i}); {qps:.1f} q/s")
        if name == "fused_fold_high3" and bad_s:
            fail(f"phase 7: the fused engine failed the full-batch gate on "
                 f"{bad_s} queries")
    log(f"phase 7: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB (engines and data)")
    del corpus_d
    return ref_s, ref_sets


def phase8_encoder(dev, wiki, doc_ids):
    """The encoder at full width: the card against the CPU on 16 sentences,
    a row alone against the same row in a full batch, then every sentence
    of the docs embedded."""
    import torch

    from ircl_tpu_torch.contrastive.state import TrainConfig, init_train_state
    from ircl_tpu_torch.contrastive.train import make_embed_fn
    from ircl_tpu_torch.dense.embed import embed_corpus
    from ircl_tpu_torch.models.featurizer import FeaturizerConfig, TransformerFeaturizer
    from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
    from ircl_tpu_torch.utils.convert import to_device

    t0 = time.perf_counter()
    fcfg = FeaturizerConfig(kind="transformer")
    tok = WordPieceTokenizer.train(
        [wiki.docs[d]["text"] for d in doc_ids], vocab_size=fcfg.wp_vocab
    )
    feat = TransformerFeaturizer.random_init(tok, fcfg, device=dev)
    tcfg = TrainConfig()
    state = init_train_state(ENC_SEED, tcfg, device=dev)  # its encoder drawn first
    params = state.params_q
    embed_fn = make_embed_fn(tcfg, feat)
    n_tf = sum(t.numel() for t in _leaves(feat.params))
    n_enc = sum(t.numel() for t in _leaves(params))
    log(f"phase 8: vocab {tok.vocab_size}, transformer {feat.tcfg.layers} x "
        f"{feat.tcfg.hidden} ({n_tf / 1e6:.1f}M params), BiLSTM "
        f"{tcfg.encoder.num_layers} x {tcfg.encoder.hidden_size} -> "
        f"{tcfg.encoder.output_size} ({n_enc / 1e6:.2f}M); built in "
        f"{time.perf_counter() - t0:.1f} s")
    doc_sentences = {d: wiki.sentences[d] for d in doc_ids}
    sents = [s for d in doc_ids for s in doc_sentences[d] if s]

    # the card against the CPU, same weights
    feat_cpu = TransformerFeaturizer(tok, feat.tcfg, to_device(feat.params, "cpu"),
                                     fcfg, device="cpu")
    ids, mask = feat.encode_host(sents[:16])
    e_dev = embed_fn(params, ids, mask).cpu()
    e_cpu = make_embed_fn(tcfg, feat_cpu)(to_device(params, "cpu"), ids, mask)
    err = float((e_dev - e_cpu).abs().max())
    if err > ENC_DEVICE_ATOL:
        fail(f"phase 8: the card and the CPU differ by {err}")
    log(f"phase 8: 16 sentences on the card and on the CPU agree within "
        f"{err:.3g} (bound {ENC_DEVICE_ATOL})")
    del feat_cpu

    # rows do not depend on their batch position or the padding
    batch = sents[:ENC_BATCH]
    inside = embed_corpus(embed_fn, params, feat, batch, ENC_BATCH)[37]
    alone = embed_corpus(embed_fn, params, feat, [batch[37]], ENC_BATCH)[0]
    moved = embed_corpus(embed_fn, params, feat, [batch[37]] + batch[:-1],
                         ENC_BATCH)[0]
    d_alone = float(np.abs(inside - alone).max())
    d_moved = float(np.abs(inside - moved).max())
    if max(d_alone, d_moved) > 1e-6:
        fail(f"phase 8: a row depends on its batch ({d_alone}, {d_moved})")
    log(f"phase 8: row 37 alone ({ENC_BATCH - 1} pad rows) differs by {d_alone:.3g}, at "
        f"position 0 of a full batch by {d_moved:.3g}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = embed_corpus(embed_fn, params, feat, sents, ENC_BATCH)
    dt = time.perf_counter() - t0
    norms = np.linalg.norm(table, axis=1)
    if table.shape != (len(sents), tcfg.encoder.output_size):
        fail(f"phase 8: table shape {table.shape}")
    if not np.isfinite(table).all() or not np.allclose(norms, 1.0, atol=1e-5):
        fail("phase 8: sentence embeddings are not finite unit rows")
    log(f"phase 8: embedded {len(sents)} sentences of {len(doc_ids)} docs at "
        f"batch {ENC_BATCH} in {dt:.2f} s: {len(sents) / dt:.1f} sentences/s "
        f"(host tokenization included); all finite, unit norm within 1e-5")
    return tcfg, feat, state, doc_sentences, table


def _leaves(tree):
    return [leaf for _, leaf in named_leaves(tree)]


def same_keys_up_to_ties(a, b, atol=1e-6):
    """Two score-desc hit lists with the same (doc_id, sent_id) sequence,
    except where the scores of the differing places tie within atol."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        same = (x["doc_id"], x["sent_id"]) == (y["doc_id"], y["sent_id"])
        if not same and abs(x["score"] - y["score"]) > atol:
            return False
    return True


def phase9_sentence_search(dev, store, wiki, claims, doc_ids, tcfg, feat, state,
                           doc_sentences, table, tmpdir):
    """Served sentence search over the encoder docs, each reply checked; then
    the dense top-k over the sentence table against numpy."""
    import torch

    from ircl_tpu_torch.index.build import build_count_index
    from ircl_tpu_torch.index.tfidf import tfidf_transform
    from ircl_tpu_torch.ops.dense_topk_cuda import chunk_max, cosine_topk_fused, pad_corpus_t
    from ircl_tpu_torch.pipeline.dense_scorer import (
        ContrastiveSentenceScorer, PrecomputedSentenceScorer,
    )
    from ircl_tpu_torch.pipeline.retrieve import gather_candidates
    from ircl_tpu_torch.serve import RetrievalService, make_service

    index = tfidf_transform(build_count_index(
        store, ngram=2, hash_size=HASH_SIZE, doc_ids=doc_ids
    ))
    path = os.path.join(tmpdir, "index_sentences.npz")
    index.save(path)
    fly = ContrastiveSentenceScorer(tcfg, feat, state, batch_size=ENC_BATCH)
    pre = PrecomputedSentenceScorer(fly.embed, doc_sentences, table=table)
    svc = make_service(path, device=dev, doc_sentences=doc_sentences,
                       sentence_scorer=pre)
    svc.warmup()
    row_of = {}
    for d in doc_ids:
        for si, s in enumerate(doc_sentences[d]):
            if s:
                row_of[(d, si)] = len(row_of)
    own = set(doc_ids)
    mine = [c.claim for c in wiki.claims if set(c.evidences) & own]
    if len(mine) < 111:
        fail(f"phase 9: {len(mine)} claims have evidence in these docs; 111 needed")
    log(f"phase 9: index of {index.num_docs} docs, {table.shape[0]} table rows; "
        f"{len(mine)} of the claims have evidence in these docs")
    requests = [
        ([mine[0]], 5, 5),
        (mine[1:101], 5, 3),
        (mine[101:111], 2, 7),
        None,
    ]
    lines = [
        json.dumps({"query": mine[0], "sentences": True}),
        json.dumps({"queries": mine[1:101], "k_sents": 3}),
        json.dumps({"queries": mine[101:111], "k": 2, "k_sents": 7}),
        json.dumps({"queries": [mine[0]], "k_sents": -1}),
    ]
    t0 = time.perf_counter()
    served, replies = serve_lines(svc, lines)
    log(f"phase 9: served {served} sentence requests in "
        f"{time.perf_counter() - t0:.2f} s; metrics {svc.metrics.snapshot()}")
    svc_fly = RetrievalService(svc.ranker, batch_size=svc.batch_size,
                               doc_sentences=doc_sentences, sentence_scorer=fly)
    checked = 0
    for req, rep in zip(requests, replies):
        if req is None:
            if "error" not in rep:
                fail(f"phase 9: malformed line answered without an error: {rep}")
            continue
        if "results" not in rep:
            fail(f"phase 9: request failed: {rep}")
        queries, k, k_sents = req
        docs = svc.search(queries, k=k)
        check_replies([{"results": docs}], [(queries, k)], index, "phase 9 docs")
        doc_lists = [[h["doc_id"] for h in hits] for hits in docs]
        _, cand_keys = gather_candidates(doc_lists, doc_sentences)
        claim_emb = fly.embed(queries)
        for q, hits in enumerate(rep["results"]):
            rows = table[[row_of[key] for key in cand_keys[q]]]
            all_scores = np.sort(rows @ claim_emb[q])[::-1][:k_sents]
            got = np.array([h["score"] for h in hits], np.float32)
            if len(got) != len(all_scores) or not np.allclose(got, all_scores,
                                                              rtol=1e-5):
                fail(f"phase 9: sentences are not the top {k_sents} of their "
                     f"candidates: {got} != {all_scores}")
            for h in hits:
                if h["doc_id"] not in doc_lists[q]:
                    fail(f"phase 9: {h['doc_id']} is not among the top {k} docs")
                want = float(table[row_of[(h["doc_id"], h["sent_id"])]] @ claim_emb[q])
                if not np.isclose(h["score"], want, rtol=1e-5, atol=0.0):
                    fail(f"phase 9: score {h['score']} != table dot {want}")
                if h["sentence"] != doc_sentences[h["doc_id"]][h["sent_id"]]:
                    fail("phase 9: a reply names the wrong sentence")
            checked += 1
        on_the_fly = svc_fly.search_sentences(queries, k=k, k_sents=k_sents)
        for a, b in zip(rep["results"], on_the_fly):
            if not same_keys_up_to_ties(a, b):
                fail("phase 9: the precomputed and on-the-fly services differ")
    log(f"phase 9: {checked} sentence results checked: docs against scipy "
        f"(rtol 1e-4), every score the table row's dot with the claim (rtol "
        f"1e-5), the top k_sents of the candidates, and the same (doc, sent) "
        f"lists from the on-the-fly scorer; the malformed line got an error")

    # dense search over the sentence table with the claims' embeddings
    before = chunk_max.launches
    q_emb = fly.embed(claims[:DENSE_B])
    tab_d = torch.tensor(table, device=dev)
    ct, m = pad_corpus_t(tab_d, DENSE_TILE)
    rows = ct.T.contiguous()
    s, i = cosine_topk_fused(
        torch.tensor(q_emb, device=dev), ct, k=K, chunk=DENSE_CHUNK,
        m_tile=DENSE_TILE, m_real=m, epilogue="fold", precision="high3",
        corpus_rows=rows,
    )
    if chunk_max.launches == before:
        fail("phase 9: the dense top-k did not launch the chunk-max kernel")
    ref = q_emb @ table.T
    ref_s = -np.sort(-ref, axis=1)[:, :K]
    s, i = s.cpu().numpy(), i.cpu().numpy()
    # the table repeats some sentences, so equal rows tie: every returned id
    # must carry its own numpy score, and the scores be numpy's top-K
    own = np.take_along_axis(ref, i.astype(np.int64), axis=1)
    bad = (~np.isclose(s, ref_s, rtol=1e-5, atol=0.0)).any(axis=1) | (
        ~np.isclose(own, s, rtol=1e-5, atol=0.0)).any(axis=1)
    if bad.any() or i.max() >= m or any(len(set(r)) < K for r in i):
        fail(f"phase 9: dense top-{K} over the sentence table differs from "
             f"numpy on {int(bad.sum())} claims")
    log(f"phase 9: dense top-{K} of {DENSE_B} claims over {m} sentence rows "
        f"(fold/high3) equals numpy's exact top-{K} (rtol 1e-5; distinct ids, "
        f"each carrying its own score)")
    return path, pre, mine


def verdict_pairs(wiki, doc_ids, claims, n):
    """``n`` (claim, evidence text) pairs of mixed lengths: pair i's evidence
    is the doc-id words and sentences of ``i % 6`` docs (none for 0), so
    most pairs pad, each to its own length, and the longest are cut at L."""
    pairs = []
    for i in range(n):
        docs = doc_ids[i % len(doc_ids):][: i % 6]
        parts = []
        for d in docs:
            parts.extend(d.split("_"))
            parts.extend(s for s in wiki.sentences[d] if s)
        pairs.append((claims[i % len(claims)], " ".join(parts)))
    return pairs


def phase10_flash_kernel(dev, tok, pairs, results):
    """Kernel #6a against its plain version at [32, 12, 512, 64], in full
    fp32 and with split-TF32 products: segment ids of 32 tokenized pairs
    (one row cut to a single real token), then of a batch with no pads."""
    import torch

    from ircl_tpu_torch.ops.flash_attention_cuda import (
        SegmentIds, flash_attention, flash_attention_fwd_ref, flash_attention_ref,
    )

    B = VERDICT_BATCH
    H = VERDICT_ENCODER["heads"]
    hd = VERDICT_ENCODER["hidden"] // H
    scale = 1.0 / np.sqrt(hd)
    rng = np.random.default_rng(10)
    q, k, v = (torch.tensor(rng.normal(size=(B, H, VERDICT_L, hd)).astype(np.float32),
                            device=dev) for _ in range(3))
    _, mask, _ = tok.encode_batch(pairs[:B], VERDICT_L)
    seg = mask.astype(np.int32)
    seg[B - 1] = 0
    seg[B - 1, 0] = 1  # one real token
    lengths = seg.sum(axis=1)
    cases = {
        "tokenized pairs": torch.tensor(seg, device=dev),
        "no pads": torch.ones(B, VERDICT_L, dtype=torch.int32, device=dev),
    }
    err_all = 0.0
    for label, s in cases.items():
        ids = SegmentIds(q=s, kv=s)
        got = flash_attention(q, k, v, segment_ids=ids, sm_scale=scale)
        ref = flash_attention_ref(q, k, v, ids, scale)
        split = flash_attention_fwd_ref(q, k, v, ids, scale, products="tf32x3")[0]
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"phase 10: {label}: the kernel wrote non-finite values")
        err = float((got - ref).abs().max())
        err3 = float((got - split).abs().max())
        if max(err, err3) > FLASH_ATOL:
            fail(f"phase 10: {label}: the kernel differs from the plain version by {err}, "
                 f"from the plain version with split TF32 products by {err3}")
        err_all = max(err_all, err)
        log(f"phase 10: {label}: every row within {err:.3g} of the plain version, "
            f"{err3:.3g} of the plain version with split TF32 products (bound "
            f"{FLASH_ATOL})")
        del got, ref, split
    ids = SegmentIds(q=cases["tokenized pairs"], kv=cases["tokenized pairs"])
    t_k = cuda_ms(lambda: flash_attention(q, k, v, segment_ids=ids, sm_scale=scale),
                  reps=10)
    t_p = cuda_ms(lambda: flash_attention_ref(q, k, v, ids, scale), reps=5)
    s = cases["tokenized pairs"]
    t_lib = cuda_ms(lambda: sdpa(q, k, v, s, scale), reps=10)
    e_lib = float((sdpa(q, k, v, s, scale) - flash_attention(
        q, k, v, segment_ids=ids, sm_scale=scale)).abs().max())
    if e_lib > 1e-4:
        fail(f"phase 10: the library yardstick computes another function ({e_lib})")
    # two products, three TF32 passes each, on the tensor cores; the bound of
    # the same products as f32 FMAs beside it
    tensors = (q, k, v, s, s, q)
    results["flash_attention"] = dict(
        max_abs_err=err_all, ms=t_k, plain_ms=t_p, library_ms=t_lib,
        **attention_bounds(s, H, hd, 2, tensors, TF32_FLOPS, passes=3),
        bound_f32_fma_ms=attention_bounds(s, H, hd, 2, tensors)["bound_ms"])
    every_pair = 3 * 2 * 2 * hd * B * H * VERDICT_L ** 2
    log(f"phase 10: q, k, v [{B}, {H}, {VERDICT_L}, {hd}] f32, real lengths "
        f"{int(lengths.min())}-{int(lengths.max())} (median "
        f"{int(np.median(lengths))}): kernel {t_k:.3f} ms (bound "
        f"{results['flash_attention']['bound_ms']:.3f} ms at three TF32 passes a "
        f"product for the pairs these masks leave, "
        f"{least_time((), every_pair, TF32_FLOPS)['bound_ms']:.3f} ms for all, "
        f"{results['flash_attention']['bound_f32_fma_ms']:.3f} ms for f32 FMAs), "
        f"plain {t_p:.3f} ms, scaled_dot_product_attention (f32, boolean mask, "
        f"within {e_lib:.3g}) {t_lib:.3f} ms")


def phase11_verdict(dev, tok, pairs):
    """The verdict classifier at full width: card against CPU, flash against
    xla, a row against its batch, then pairs/s through ``classify``."""
    import dataclasses

    import torch

    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.ops.flash_attention_cuda import flash_attention
    from ircl_tpu_torch.utils.convert import to_device
    from ircl_tpu_torch.verdict.infer import VerdictClassifier
    from ircl_tpu_torch.verdict.model import (
        VerdictConfig, init_verdict_params, verdict_apply,
    )

    t0 = time.perf_counter()
    enc = TransformerConfig(**VERDICT_ENCODER)
    cfg = VerdictConfig(encoder=enc, max_length=VERDICT_L)
    params = init_verdict_params(torch.Generator().manual_seed(VERDICT_SEED), cfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    clf = VerdictClassifier(cfg, params, tok, batch_size=VERDICT_BATCH)
    log(f"phase 11: verdict model {enc.layers} x {enc.hidden}, {enc.heads} heads, "
        f"vocab {enc.vocab_size}, type_vocab {enc.type_vocab}, L={VERDICT_L} "
        f"({n_params / 1e6:.1f}M params), tokenizer vocab {tok.vocab_size}; built "
        f"in {time.perf_counter() - t0:.1f} s")

    def logits(c, p, batch, device):
        ids, mask, types = (torch.as_tensor(x, device=device)
                            for x in tok.encode_batch(batch, VERDICT_L))
        return verdict_apply(p, c, ids.long(), mask, types.long())

    # the card against the CPU, 4 pairs (type ids 1 past the first [SEP])
    four = [pairs[i] for i in (0, 5, 16, 33)]
    t0 = time.perf_counter()
    l_dev = logits(cfg, params, four, dev).cpu()
    l_cpu = logits(cfg, to_device(params, "cpu"), four, "cpu")
    err = float((l_dev - l_cpu).abs().max())
    if not torch.isfinite(l_dev).all() or err > VERDICT_DEVICE_ATOL:
        fail(f"phase 11: logits on the card and the CPU differ by {err}")
    log(f"phase 11: logits of 4 pairs on the card and on the CPU agree within "
        f"{err:.3g} (bound {VERDICT_DEVICE_ATOL}; {time.perf_counter() - t0:.1f} s)")

    # flash against xla on the card, 32 pairs: logits and labels of real rows
    batch = pairs[:VERDICT_BATCH]
    xla = dataclasses.replace(cfg, encoder=dataclasses.replace(enc, attention="xla"))
    l_flash, l_xla = logits(cfg, params, batch, dev), logits(xla, params, batch, dev)
    d = float((l_flash - l_xla).abs().max())
    margin = (l_xla[:, 1] - l_xla[:, 0]).abs()
    clear = margin > 2 * VERDICT_DEVICE_ATOL
    same = l_flash.argmax(-1) == l_xla.argmax(-1)
    if d > VERDICT_DEVICE_ATOL or not bool(same[clear].all()):
        fail(f"phase 11: flash and xla differ: logits by {d}, labels "
             f"{int((~same).sum())}")
    log(f"phase 11: flash and xla attention on the card, {VERDICT_BATCH} pairs: "
        f"logits within {d:.3g}, labels equal on {int(same.sum())}/{VERDICT_BATCH} "
        f"({int(clear.sum())} with a margin over {2 * VERDICT_DEVICE_ATOL})")

    # a row alone against the same row in its batch
    inside = clf.classify([c for c, _ in batch], [e for _, e in batch])
    rows = (3, VERDICT_BATCH // 2)
    for i in rows:
        (alone,) = clf.classify([batch[i][0]], [batch[i][1]])
        dc = abs(alone["confidence"] - inside[i]["confidence"])
        if alone["label_id"] != inside[i]["label_id"] or dc > 1e-6:
            fail(f"phase 11: row {i} alone differs from its batch: {alone} "
                 f"against {inside[i]}")
    log(f"phase 11: rows {rows} alone ({VERDICT_BATCH - 1} pad rows) classify "
        f"as inside their batch (confidence within 1e-6)")

    # pairs/s through classify, host tokenization included
    sweep = (pairs * (VERDICT_PAIRS // len(pairs) + 1))[:VERDICT_PAIRS]
    clf.warmup()
    before = flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = clf.classify([c for c, _ in sweep], [e for _, e in sweep])
    dt = time.perf_counter() - t0
    batches = -(-VERDICT_PAIRS // VERDICT_BATCH)
    per_batch = (flash_attention.launches - before) / batches
    if per_batch != enc.layers:
        fail(f"phase 11: {per_batch} flash launches per batch, not {enc.layers}")
    conf = np.array([r["confidence"] for r in out])
    if len(out) != VERDICT_PAIRS or not (np.isfinite(conf).all() and
                                         (conf >= 0.5).all() and (conf <= 1).all()):
        fail("phase 11: classify returned wrong or non-finite verdicts")
    log(f"phase 11: classified {VERDICT_PAIRS} pairs in {batches} batches of "
        f"{VERDICT_BATCH} x {VERDICT_L} in {dt:.2f} s: {VERDICT_PAIRS / dt:.1f} "
        f"pairs/s (host tokenization included); {int(per_batch)} flash launches a "
        f"batch; labels {np.bincount([r['label_id'] for r in out], minlength=2)}")
    return cfg, params


def phase12_verdict_service(dev, tok, cfg, params, index_path, doc_sentences, pre,
                            claims, tmpdir):
    """Served claim verification from a saved checkpoint: every reply's
    evidence is the sentence search for its claims, and its verdicts are
    ``classify`` of the evidence text assembled here."""
    from ircl_tpu_torch.serve import make_service
    from ircl_tpu_torch.verdict.infer import VerdictClassifier, save_verdict_checkpoint

    t0 = time.perf_counter()
    ckpt = os.path.join(tmpdir, "verdict_ckpt")
    save_verdict_checkpoint(ckpt, cfg, params, tok)
    clf = VerdictClassifier.from_checkpoint(ckpt, batch_size=VERDICT_BATCH, device=dev)
    if clf.cfg != cfg:
        fail("phase 12: the checkpoint's config does not load back")
    svc = make_service(index_path, device=dev, doc_sentences=doc_sentences,
                       sentence_scorer=pre, verdict_classifier=clf)
    svc.warmup()
    log(f"phase 12: checkpoint saved and loaded, service built and warmed in "
        f"{time.perf_counter() - t0:.1f} s")
    requests = [
        ([claims[0]], None, None),
        (claims[1:9], 3, 2),
        (claims[9:49], None, 4),
        None,
    ]
    lines = [
        json.dumps({"claim": claims[0]}),
        json.dumps({"claims": claims[1:9], "k": 3, "k_sents": 2}),
        json.dumps({"claims": claims[9:49], "k_sents": 4}),
        json.dumps({"claims": [claims[0], 7]}),
    ]
    t0 = time.perf_counter()
    served, replies = serve_lines(svc, lines)
    snap = svc.metrics.snapshot()
    log(f"phase 12: served {served} claim requests in {time.perf_counter() - t0:.2f} "
        f"s; metrics {snap}")
    checked = 0
    for req, rep in zip(requests, replies):
        if req is None:
            if "error" not in rep:
                fail(f"phase 12: malformed line answered without an error: {rep}")
            continue
        if "results" not in rep:
            fail(f"phase 12: request failed: {rep}")
        queries, k, k_sents = req
        evidence = svc.search_sentences(queries, k=k, k_sents=k_sents)
        texts = []
        for hits in evidence:  # serve.py:363-374's assembly
            by_doc = {}
            for h in hits:
                by_doc.setdefault(h["doc_id"], []).append(h.get("sentence", ""))
            parts = []
            for doc_id, sents in by_doc.items():
                parts.extend(doc_id.split("_"))
                parts.extend(x for x in sents if x)
            texts.append(" ".join(parts))
        want = clf.classify(queries, texts)
        if len(rep["results"]) != len(queries):
            fail(f"phase 12: {len(rep['results'])} verdicts for {len(queries)} claims")
        for got, ev, w in zip(rep["results"], evidence, want):
            if got["evidence"] != ev:
                fail("phase 12: a reply's evidence is not the sentence search")
            if (got["label"], got["label_id"]) != (w["label"], w["label_id"]) or abs(
                    got["confidence"] - w["confidence"]) > 1e-6:
                fail(f"phase 12: verdict {got['label']} {got['confidence']} != "
                     f"classify's {w['label']} {w['confidence']}")
            checked += 1
    log(f"phase 12: {checked} verdicts checked: evidence equal to search_sentences, "
        f"label and confidence equal to classify on the assembled evidence (1e-6); "
        f"the malformed line got an error; p50 {snap['latency_p50_ms']} ms over "
        f"{snap['requests']} requests")


def attention_bounds(seg, H, hd, products, tensors, flops=F32_FLOPS, passes=1):
    """The least time one attention kernel could take on this card, ms:
    ``products`` matrix products of 2 * hd FLOP for every (query, key) pair
    of one segment (what this batch's masks need; masked pairs need none),
    ``passes`` times each, at the rate ``flops``, against its tensors moved
    once."""
    pairs = H * int((seg[:, :, None] == seg[:, None, :]).sum())
    return least_time(tensors, passes * products * 2 * hd * pairs, flops)


def sdpa(q, k, v, seg, scale):
    """The yardstick: the one PyTorch call that computes the same function,
    f32 with a boolean mask. Timed here; the port never calls it."""
    import torch.nn.functional as F

    same = (seg[:, None, :, None] == seg[:, None, None, :])
    return F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=scale)


def phase13_flash_backward(dev, tok, pairs, results):
    """Kernels #6b and #6c against their plain version at the training shape
    [8, 12, 512, 64]: the forward's statistics, then dq, dk, dv, with
    segment ids of 8 tokenized pairs (one row cut to a single real token),
    of a batch with no pads, of key ids that differ from the query ids
    (a query with no key at all, keys with no query) and of short pairs."""
    import torch

    from ircl_tpu_torch.ops.flash_attention_cuda import (
        DEFAULT_MASK_VALUE, SegmentIds, flash_attention, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_bwd_ref, flash_attention_fwd,
        flash_attention_fwd_ref, flash_attention_ref,
    )

    B, H = TRAIN_BATCH, VERDICT_ENCODER["heads"]
    hd = VERDICT_ENCODER["hidden"] // H
    scale = 1.0 / np.sqrt(hd)
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.tensor(rng.normal(size=(B, H, VERDICT_L, hd)).astype(np.float32),
                                device=dev) for _ in range(4))
    _, mask, _ = tok.encode_batch(pairs[:B], VERDICT_L)
    seg = mask.astype(np.int32)
    seg[B - 1] = 0
    seg[B - 1, 0] = 1  # one real token
    # other ids on the keys than on the queries: the keys' real part ends
    # earlier; query 5 of pair 0 matches no key at all (its p is 1 / Lk on
    # every key, so none of its tiles is empty); the last 64 keys of pair 1
    # match no query, and no query of pair 1 is without a key (dk = dv = 0)
    seg_q_odd, seg_kv_odd = seg.copy(), seg.copy()
    for b in range(B):
        seg_kv_odd[b, int(seg[b].sum()) // 2:] = 0
    seg_q_odd[0, 5] = 7
    seg_kv_odd[1, -64:] = 9
    short = np.zeros((B, VERDICT_L), np.int32)
    short_lengths = rng.integers(12, 128, size=B)
    for b, n in enumerate(short_lengths):
        short[b, :n] = 1
    put = lambda x: torch.tensor(x, device=dev)  # noqa: E731
    cases = {
        "tokenized pairs": SegmentIds(q=put(seg), kv=put(seg)),
        "no pads": SegmentIds(*(torch.ones(B, VERDICT_L, dtype=torch.int32, device=dev)
                                for _ in range(2))),
        "other key ids, a query with no key": SegmentIds(q=put(seg_q_odd),
                                                         kv=put(seg_kv_odd)),
        "short pairs": SegmentIds(q=put(short), kv=put(short)),
    }
    # autograd hands the backward a transposed view (the head merge)
    do_view = do.transpose(1, 2).contiguous().transpose(1, 2)
    worst = {"dkv": 0.0, "dq": 0.0}
    for label, ids in cases.items():
        o, stats = flash_attention_fwd(q, k, v, ids, scale)
        o_ref, stats_ref = flash_attention_fwd_ref(q, k, v, ids, scale)
        torch.cuda.synchronize()
        e_o = float((o - o_ref).abs().max())
        e_l = float(((stats.l - stats_ref.l).abs() / stats_ref.l).max())
        # a row with no key has m at the mask value, where one ulp is 2e31:
        # those rows are held to a relative bound, the others as before
        no_key = stats_ref.m < 0.5 * DEFAULT_MASK_VALUE
        d_m = (stats.m - stats_ref.m).abs()
        e_m = float(d_m[~no_key].max())
        e_m_no_key = float((d_m[no_key] / stats_ref.m[no_key].abs()).max()) if (
            no_key.any()) else 0.0
        if max(e_o, e_l, e_m, e_m_no_key) > FLASH_ATOL or not (
                torch.isfinite(stats.l).all()):
            fail(f"phase 13: {label}: forward with statistics: o {e_o}, l {e_l} "
                 f"(relative), m {e_m} ({int(no_key.sum())} rows with no key: "
                 f"{e_m_no_key} relative)")
        dk, dv = flash_attention_bwd_dkv(q, k, v, ids, o, stats, do, scale)
        dq = flash_attention_bwd_dq(q, k, v, ids, o, stats, do, scale)
        again = (flash_attention_bwd_dq(q, k, v, ids, o, stats, do, scale),
                 *flash_attention_bwd_dkv(q, k, v, ids, o, stats, do, scale))
        want = flash_attention_bwd_ref(q, k, v, ids, o, stats, do, scale)
        split = flash_attention_bwd_ref(q, k, v, ids, o, stats, do, scale,
                                        products="tf32x3")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention_ref(*leaves, ids, scale).backward(do)
        through = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention(*through, segment_ids=ids, sm_scale=scale).backward(do_view)
        torch.cuda.synchronize()
        errs = {}
        for name, got, second, w, w3, auto, fn in zip(
                ("dq", "dk", "dv"), (dq, dk, dv), again, want, split, leaves, through):
            if not torch.isfinite(got).all():
                fail(f"phase 13: {label}: {name} has non-finite values")
            if not torch.equal(second, got):
                fail(f"phase 13: {label}: two launches gave different bits of {name}")
            if not torch.equal(fn.grad, got):
                fail(f"phase 13: {label}: {name} through autograd.Function differs "
                     f"from the kernel wrapper's")
            errs[name] = (float((got - w).abs().max()),
                          float((got - auto.grad).abs().max()),
                          float((got - w3).abs().max()))
            if max(errs[name]) > FLASH_ATOL:
                fail(f"phase 13: {label}: {name} differs from the plain version by "
                     f"{errs[name][0]}, from autograd by {errs[name][1]}, from the "
                     f"plain version with split TF32 products by {errs[name][2]}")
        if label.startswith("other key ids") and (
                dk[1, :, -64:].any() or dv[1, :, -64:].any()):
            fail("phase 13: keys that match no query got a gradient")
        worst["dq"] = max(worst["dq"], *errs["dq"])
        worst["dkv"] = max(worst["dkv"], *errs["dk"], *errs["dv"])
        log(f"phase 13: {label}: o within {e_o:.3g}, l within {e_l:.3g} (relative), "
            f"m within {e_m:.3g} ({int(no_key.sum())} rows with no key); (plain f32, "
            "autograd, plain tf32x3) "
            + "; ".join(f"{n} " + ", ".join(f"{x:.3g}" for x in errs[n])
                        for n in ("dq", "dk", "dv"))
            + f" (bound {FLASH_ATOL}); two launches gave equal bits; the "
            f"autograd.Function's gradients equal the wrappers'")
        del leaves, through, want, split, again

    def backward_ms(ids):
        o, stats = flash_attention_fwd(q, k, v, ids, scale)
        a = (q, k, v, ids, o, stats, do, scale)
        return (cuda_ms(lambda: flash_attention_bwd_dkv(*a), reps=20),
                cuda_ms(lambda: flash_attention_bwd_dq(*a), reps=20))

    ids = cases["tokenized pairs"]
    s = ids.q
    o, stats = flash_attention_fwd(q, k, v, ids, scale)
    args = (q, k, v, ids, o, stats, do, scale)
    t_fwd = cuda_ms(lambda: flash_attention_fwd(q, k, v, ids, scale), reps=10)
    t_dkv, t_dq = backward_ms(ids)
    t_full = backward_ms(cases["no pads"])
    t_short = backward_ms(cases["short pairs"])
    if sum(t_short) >= sum(t_full):
        fail(f"phase 13: the short pairs' backward ({t_short} ms) is not faster than "
             f"the backward with no pads ({t_full} ms): no step was skipped")
    t_plain = cuda_ms(lambda: flash_attention_bwd_ref(*args), reps=5)
    # the yardstick: autograd through the library call, one grad call each
    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
    lo = sdpa(lq, lk, lv, s, scale)
    lib = lambda wrt: lambda: torch.autograd.grad(lo, wrt, do, retain_graph=True)  # noqa: E731
    e_lib = float((lo - o).abs().max())
    if e_lib > 1e-4:
        fail(f"phase 13: the library yardstick computes another function ({e_lib})")
    t_lib_fwd = cuda_ms(lambda: sdpa(q, k, v, s, scale), reps=10)
    t_lib_dkv = cuda_ms(lib((lk, lv)), reps=5)
    t_lib_dq = cuda_ms(lib((lq,)), reps=5)
    t_lib_all = cuda_ms(lib((lq, lk, lv)), reps=10)
    stat_t = (stats.l, stats.m, stats.l)  # l, m and di: [B, H, L] f32 each
    for name, t_k, t_lib, worst_err, products, outs in (
            ("flash_attention_bwd_dkv", t_dkv, t_lib_dkv, worst["dkv"], 4, (k, v)),
            ("flash_attention_bwd_dq", t_dq, t_lib_dq, worst["dq"], 3, (q,))):
        tensors = (q, k, v, do, *stat_t, s, s, *outs)
        results[name] = dict(
            max_abs_err=worst_err, ms=t_k, plain_ms=t_plain, library_ms=t_lib,
            library_pair_ms=t_lib_all,  # the one call for dq, dk and dv
            **attention_bounds(s, H, hd, products, tensors, TF32_FLOPS, passes=3),
            bound_f32_fma_ms=attention_bounds(s, H, hd, products, tensors)["bound_ms"])
    r_dkv, r_dq = results["flash_attention_bwd_dkv"], results["flash_attention_bwd_dq"]
    live = float((s[:, :, None] == s[:, None, :]).float().mean())
    log(f"phase 13: q, k, v, do [{B}, {H}, {VERDICT_L}, {hd}] f32, real lengths "
        f"{seg.sum(axis=1).tolist()}, {live:.3f} of the "
        f"pairs live: forward with statistics {t_fwd:.3f} ms, dK/dV {t_dkv:.3f} ms "
        f"(bound {r_dkv['bound_ms']:.3f} at three TF32 passes a product, "
        f"{r_dkv['bound_f32_fma_ms']:.3f} for f32 FMAs), dQ {t_dq:.3f} ms (bound "
        f"{r_dq['bound_ms']:.3f}, {r_dq['bound_f32_fma_ms']:.3f}), the pair "
        f"{t_dkv + t_dq:.3f} ms against {t_lib_all:.3f} ms for the library's one call "
        f"for dq, dk and dv; plain backward (both) {t_plain:.3f} ms")
    log(f"phase 13: no pads: dK/dV {t_full[0]:.3f} ms, dQ {t_full[1]:.3f} ms; short "
        f"pairs (real lengths {int(short_lengths.min())}-{int(short_lengths.max())}, "
        f"pads attend to pads): dK/dV {t_short[0]:.3f} ms, dQ {t_short[1]:.3f} ms")
    log(f"phase 13: library yardstick (scaled_dot_product_attention, f32, boolean "
        f"mask; output within {e_lib:.3g} of the kernel's): forward {t_lib_fwd:.3f} "
        f"ms, backward for k, v {t_lib_dkv:.3f} ms, for q {t_lib_dq:.3f} ms, for all "
        f"three {t_lib_all:.3f} ms")


def train_batch(tok, pairs, rows, seed):
    """Token arrays of ``rows`` pairs and seeded labels."""
    ids, mask, types = tok.encode_batch([pairs[i] for i in rows], VERDICT_L)
    labels = np.random.default_rng(seed).integers(0, 2, size=len(rows))
    return ids, mask, types, labels.astype(np.int32)


def phase14_train_step(dev, tok, pairs):
    """The train step at roberta-base width, B=8, L=512: flash against "xla"
    on the card (loss and every gradient leaf), one step of a cut batch on
    the card against the CPU, the freeze, then timed steps of both paths."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.ops.flash_attention_cuda import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    )
    from ircl_tpu_torch.utils.convert import to_device
    from ircl_tpu_torch.utils.tree import tree_leaves, tree_map
    from ircl_tpu_torch.verdict.model import (
        VerdictConfig, init_verdict_params, make_verdict_train_step,
        value_and_grad, verdict_apply_with_aux,
    )

    enc = TransformerConfig(**VERDICT_ENCODER)
    cfg = VerdictConfig(encoder=enc, max_length=VERDICT_L, learning_rate=TRAIN_LR,
                        warmup_steps=TRAIN_WARMUP, total_steps=200)
    xla = dataclasses.replace(cfg, encoder=dataclasses.replace(enc, attention="xla"))
    init = init_verdict_params(torch.Generator().manual_seed(VERDICT_SEED), cfg, "cpu")
    names = [n for n, _ in named_leaves(init)]
    batch = train_batch(tok, pairs, range(3, 3 + TRAIN_BATCH), 14)
    real = batch[1].sum(axis=1).astype(int)
    log(f"phase 14: train step of the verdict model {enc.layers} x {enc.hidden}, "
        f"B={TRAIN_BATCH}, L={VERDICT_L}, real lengths {real.tolist()}, "
        f"warmup_steps {TRAIN_WARMUP}, learning rate {TRAIN_LR}")

    def loss_and_grads(c, params, b, device):
        ids, mask, types, labels = b

        def loss_fn(p, *t):
            logits, _ = verdict_apply_with_aux(p, c, t[0], t[1], t[2])
            return F.cross_entropy(logits, t[3]), logits

        loss, _, grads = value_and_grad(
            loss_fn, params, torch.as_tensor(ids, device=device).long(),
            torch.as_tensor(mask, device=device),
            torch.as_tensor(types, device=device).long(),
            torch.as_tensor(labels, device=device).long())
        return float(loss), grads

    # flash against xla on the card: loss and every gradient leaf
    params = to_device(init, dev)
    l_flash, g_flash = loss_and_grads(cfg, params, batch, dev)
    l_xla, g_xla = loss_and_grads(xla, params, batch, dev)
    worst_abs, worst_rel = (0.0, ""), (0.0, "")
    for name, a, b in zip(names, tree_leaves(g_flash), tree_leaves(g_xla)):
        if not torch.isfinite(a).all():
            fail(f"phase 14: the flash gradient of {name} is not finite")
        d, size = float((a - b).abs().max()), float(b.abs().max())
        worst_abs = max(worst_abs, (d, name))
        if size > 1e-6:  # k/b is zero in exact arithmetic: noise on both paths
            worst_rel = max(worst_rel, (d / size, name))
    if abs(l_flash - l_xla) > 1e-5 or worst_abs[0] > TRAIN_GRAD_ATOL or (
            worst_rel[0] > TRAIN_GRAD_RTOL):
        fail(f"phase 14: flash and xla differ: loss {l_flash} against {l_xla}, "
             f"gradients by {worst_abs} absolute, {worst_rel} of a leaf's largest")
    log(f"phase 14: flash and xla on the card: loss {l_flash:.6f} against "
        f"{l_xla:.6f}; {len(names)} gradient leaves within {worst_abs[0]:.3g} "
        f"({worst_abs[1]}; bound {TRAIN_GRAD_ATOL}) and within {worst_rel[0]:.3g} "
        f"of each leaf's largest element ({worst_rel[1]}; bound {TRAIN_GRAD_RTOL})")
    del g_flash, g_xla

    # one step at B=2, from a count past the warmup: the card against the CPU
    t0 = time.perf_counter()
    small = train_batch(tok, pairs, (5, 16), 15)
    outs = {}
    for device in (dev, "cpu"):
        p = tree_map(lambda t: t.to(device, copy=True), init)  # updated in place
        step, tx = make_verdict_train_step(cfg, device=device)
        state = dict(tx.init(p), count=TRAIN_WARMUP)
        _, _, loss, preds = step(p, state, TRAIN_WARMUP, *small)
        outs[str(device)] = (float(loss), preds.cpu(), to_device(p, "cpu"))
    (l_d, p_d, w_d), (l_c, p_c, w_c) = outs[str(dev)], outs["cpu"]
    far, frac = (0.0, ""), (0.0, "")
    moved = 0.0
    for name, a, b, start in zip(names, tree_leaves(w_d), tree_leaves(w_c),
                                 tree_leaves(init)):
        d = (a - b).abs()
        far = max(far, (float(d.max()), name))
        moved = max(moved, float((a - start).abs().max()))
        if not name.endswith("/k/b"):
            frac = max(frac, (float((d > 0.1 * TRAIN_LR).float().mean()), name))
    if abs(l_d - l_c) > 1e-5 or not torch.equal(p_d, p_c) or (
            far[0] > 2.1 * TRAIN_LR or frac[0] > 1e-2 or moved < 0.25 * TRAIN_LR):
        fail(f"phase 14: one step on the card and the CPU differ: loss {l_d} "
             f"against {l_c}, parameters by {far}, share over lr/10 {frac}")
    log(f"phase 14: one step at B=2 on the card and on the CPU: loss {l_d:.6f} "
        f"against {l_c:.6f}, predictions equal; parameters moved by up to "
        f"{moved:.3g} and differ by at most {far[0]:.3g} ({far[1]}; Adam turns a "
        f"gradient's rounding noise into a step of the learning rate {TRAIN_LR}, "
        f"bound 2.1 of it), the share of a leaf's elements that differ by more than "
        f"a tenth of it at most {frac[0]:.3g} ({frac[1]}; bound 1e-2, k/b leaves "
        f"apart); {time.perf_counter() - t0:.1f} s")
    del outs, w_d, w_c

    # the freeze: body bit-unchanged before warmup_steps, changed after
    counters = (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    step, tx = make_verdict_train_step(cfg, device=dev)
    state = tx.init(params)
    start = tree_map(torch.clone, params)
    rows = lambda s: [(7 * s + i) % len(pairs) for i in range(TRAIN_BATCH)]  # noqa: E731
    losses = []
    for s in range(TRAIN_WARMUP + 2):
        before = [fn.launches for fn in counters]
        _, _, loss, _ = step(params, state, s, *train_batch(tok, pairs, rows(s), s))
        per_step = [fn.launches - b for fn, b in zip(counters, before)]
        if per_step != [enc.layers] * 3:
            fail(f"phase 14: step {s} launched {per_step} (forward, dK/dV, dQ), not "
                 f"{enc.layers} each")
        losses.append(float(loss))
        body_same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params["body"]), tree_leaves(start["body"])))
        head_same = torch.equal(params["head_out"]["w"], start["head_out"]["w"])
        if s < TRAIN_WARMUP and not body_same:
            fail(f"phase 14: the frozen body changed at step {s}")
        if s >= TRAIN_WARMUP and body_same:
            fail(f"phase 14: the body did not change at step {s}")
        if head_same != (s == 0):  # the first learning rate is exactly 0
            fail(f"phase 14: the head at step {s}: unchanged is {head_same}")
    if not np.isfinite(losses).all():
        fail(f"phase 14: losses {losses}")
    log(f"phase 14: steps 0-{TRAIN_WARMUP + 1}: the body keeps its bits while "
        f"frozen (steps 0-{TRAIN_WARMUP - 1}) and moves after; the head moves from "
        f"step 1 (the first learning rate is 0); {enc.layers} forward, dK/dV and dQ "
        f"launches a step; losses {', '.join(f'{x:.4f}' for x in losses)}")
    del start

    # timed steps, both paths in turns, past the warmup (every leaf updated)
    fixed = train_batch(tok, pairs, rows(1), 1)
    timings = {}
    for label, c in (("flash", cfg), ("xla", xla), ("xla", xla), ("flash", cfg)):
        p = to_device(init, dev)
        step, tx = make_verdict_train_step(c, device=dev)
        state = dict(tx.init(p), count=TRAIN_WARMUP)
        step(p, state, TRAIN_WARMUP, *fixed)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = [fn.launches for fn in counters]
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        for s in range(TRAIN_TIMED_STEPS):
            _, _, loss, _ = step(p, state, TRAIN_WARMUP + 1 + s, *fixed)
        e1.record()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per_step = [(fn.launches - b) / TRAIN_TIMED_STEPS
                    for fn, b in zip(counters, before)]
        want = [enc.layers] * 3 if label == "flash" else [0] * 3
        if per_step != want or not np.isfinite(float(loss)):
            fail(f"phase 14: {label}: {per_step} launches a step (want {want}), "
                 f"loss {float(loss)}")
        timings.setdefault(label, []).append(
            (TRAIN_TIMED_STEPS / dt, e0.elapsed_time(e1) / TRAIN_TIMED_STEPS,
             torch.cuda.max_memory_allocated() / 2**30))
        del p, state
    for label, runs in timings.items():
        log(f"phase 14: {label}: {TRAIN_TIMED_STEPS} steps, two runs: "
            + "; ".join(f"{sps:.2f} steps/s, {ms:.2f} ms of device time a step, "
                        f"peak {gib:.2f} GiB" for sps, ms, gib in runs))
    return cfg


def phase15_trainer(dev, tok, cfg, pairs, tmpdir):
    """The trainer end to end: ``train_verdict`` on seeded pairs, its
    checkpoint served by ``VerdictClassifier``, ``predict_in_batches``."""
    import dataclasses

    import torch

    from ircl_tpu_torch.verdict.data import VerdictExample, encode_examples
    from ircl_tpu_torch.verdict.infer import VerdictClassifier
    from ircl_tpu_torch.verdict.train import predict_in_batches, train_verdict

    labels = np.random.default_rng(15).integers(0, 2, size=TRAINER_PAIRS)
    examples = [VerdictExample(c, e, int(y))
                for (c, e), y in zip(pairs[:TRAINER_PAIRS], labels)]
    ids, mask, types, y = encode_examples(examples, tok, VERDICT_L)
    n_val = int(TRAINER_PAIRS * 0.1)
    steps = TRAINER_EPOCHS * ((TRAINER_PAIRS - n_val) // TRAIN_BATCH)
    cfg = dataclasses.replace(cfg, total_steps=steps)
    ckpt = os.path.join(tmpdir, "trained_ckpt")
    t0 = time.perf_counter()
    params, history = train_verdict(
        cfg, ids, mask, types, y, epochs=TRAINER_EPOCHS, batch_size=TRAIN_BATCH,
        val_fraction=0.1, seed=1009, save_path=ckpt, tokenizer=tok, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if len(history) != TRAINER_EPOCHS or any(
            h["train_loss"] is None or not np.isfinite(h["train_loss"])
            or h["val_macro_f1"] is None or not 0.0 <= h["val_macro_f1"] <= 1.0
            for h in history):
        fail(f"phase 15: history {history}")
    log(f"phase 15: train_verdict on {TRAINER_PAIRS} pairs ({n_val} held out), "
        f"{TRAINER_EPOCHS} epochs, {steps} steps of {TRAIN_BATCH} x {VERDICT_L} in "
        f"{dt:.1f} s ({steps / dt:.2f} steps/s, validation and the checkpoint "
        f"included): " + "; ".join(
            f"epoch {h['epoch']} loss {h['train_loss']:.4f}, macro-F1 "
            f"{h['val_macro_f1']:.3f}" for h in history))

    run = lambda: predict_in_batches(  # noqa: E731
        params, cfg, ids, mask, types, PREDICT_BATCH, device=dev)
    preds = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = run()
    dt = time.perf_counter() - t0
    clf = VerdictClassifier.from_checkpoint(ckpt, batch_size=PREDICT_BATCH, device=dev)
    served = clf.classify([e.claim for e in examples],
                          [e.evidence_text for e in examples])
    got = np.array([r["label_id"] for r in served])
    if preds.shape != (TRAINER_PAIRS,) or not np.array_equal(preds, again) or (
            not np.array_equal(got, preds)):
        fail(f"phase 15: the served checkpoint gives {int((got != preds).sum())} "
             f"other labels than predict_in_batches")
    log(f"phase 15: the checkpoint loaded by VerdictClassifier classifies the "
        f"{TRAINER_PAIRS} pairs as predict_in_batches does (labels "
        f"{np.bincount(preds, minlength=2)}); predict_in_batches at batch "
        f"{PREDICT_BATCH}: {TRAINER_PAIRS / dt:.1f} examples/s")


def tiles_agree(got, ref, rtol, atol=0.0, own=None):
    """Per-tile top-k outputs: scores within the tolerance and positions
    equal. With ``own(rows, cols, positions)``, which gives the plain total
    of each named position (NaN where it may not stand in that output row),
    a position may differ where it carries its own total within the
    tolerance: a tie, or two docs the tolerance cannot tell apart. Returns
    (ok, max abs score difference, positions that differ)."""
    import torch

    (s1, i1), (s2, i2) = got, ref
    ok = bool(torch.isclose(s1, s2, rtol=rtol, atol=atol).all())
    r, c = (i1 != i2).nonzero(as_tuple=True)
    if r.numel():
        ok = ok and own is not None and bool(
            torch.isclose(own(r, c, i1[r, c]), s1[r, c], rtol=rtol, atol=atol).all())
    return ok, float((s1 - s2).abs().max()), int(r.numel())


def plain_totals_at(h_t, docs_t, contribs_t, pos, cols):
    """Heavy score plus light pool entries of doc ``pos[j]`` for column
    ``cols[j]``, from the plain transposed scores ``h_t [N_pad, B]`` and the
    pools ``[P, B]``; NaN for a negative position."""
    import torch

    light = (contribs_t[:, cols] * (docs_t[:, cols] == pos)).sum(0)
    total = h_t[pos.long().clamp(min=0), cols] + light
    return torch.where(pos >= 0, total, torch.nan)


def ids_carry_scores(s, i, ref_i, cpu_results, rtol=1e-4):
    """Top-k rows against another engine's: the (query, slot) places whose
    id differs from ``ref_i`` and whose doc does NOT have the reported score
    in the scipy matvec (so a differing id that passes is a real tie)."""
    bad = 0
    for b, j in zip(*np.nonzero(i != ref_i)):
        _, _, all_ids, all_scores = cpu_results[b]
        pos = min(np.searchsorted(all_ids, i[b, j]), len(all_ids) - 1)
        if i[b, j] < 0 or not len(all_ids) or all_ids[pos] != i[b, j] or not np.isclose(
                all_scores[pos], s[b, j], rtol=rtol, atol=0.0):
            bad += 1
    return bad


def scale_gate(s, i, cpu_results, n):
    """``bench_scale.py:190-200``: queries whose sorted top-k scores differ
    from the scipy matvec's at rtol 1e-4. Beyond the bench's gate, every
    returned doc must carry its own scipy score (the top-k here is full of
    exact ties, so ids cannot be compared, but a shifted id would show)."""
    bad = 0
    for b in range(n):
        ref_ids, ref_scores, all_ids, all_scores = cpu_results[b]
        m = min(len(ref_ids), int((i[b] >= 0).sum()))
        if not np.allclose(np.sort(ref_scores[:m]), np.sort(s[b][:m]), rtol=1e-4):
            bad += 1
            continue
        got = i[b][i[b] >= 0]
        pos = np.minimum(np.searchsorted(all_ids, got), len(all_ids) - 1)
        if not (all_ids[pos] == got).all() or not np.allclose(
                all_scores[pos], s[b][i[b] >= 0], rtol=1e-4):
            bad += 1
    return bad


def compare_slabs(phase, name, fn, cases):
    """Slab kernel ``fn`` against ``membership_slab_ref`` on each case, bit
    for bit, with CUDA-event times; the kernels line's numbers summed over
    the cases, and each case's own beside them."""
    import torch

    from ircl_tpu_torch.ops.membership_cuda import membership_slab_ref

    err, ms, plain_ms, bound_ms, by = 0.0, 0.0, 0.0, 0.0, (0.0, "")
    per_case = {}
    for label, args in cases.items():
        got = fn(*args)
        ref = membership_slab_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"{phase}: {name} ({label}) differs from its plain version")
        err = max(err, float((got - ref).abs().max()))
        del ref
        # every real term: a binary search of the union and one add, integer
        # and f32 steps at one a lane and cycle; the slab written once
        steps = int(np.ceil(np.log2(max(args[0].shape[0], 2)))) + 1
        least = least_time((*args, got), int((args[1] >= 0).sum()) * steps,
                           F32_FLOPS / 2)
        del got
        torch.cuda.empty_cache()
        bound_ms += least["bound_ms"]
        by = max(by, (least["bound_ms"], least["bound_by"]))
        t_k = cuda_ms(lambda: fn(*args))
        t_p = cuda_ms(lambda: membership_slab_ref(*args), reps=2)
        ms, plain_ms = ms + t_k, plain_ms + t_p
        per_case[label] = dict(shape=[args[0].shape[0], *args[1].shape], ms=t_k,
                               plain_ms=t_p, bound_ms=least["bound_ms"])
        log(f"{phase}: {name} {label}: U={args[0].shape[0]} "
            f"K={args[1].shape[0]} N={args[1].shape[1]}: equal; "
            f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {least['bound_ms']:.3f} "
            f"ms by {least['bound_by']}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by[1], library_ms=None, cases=per_case)


def shared_buffer_check(phase, u_pad, ranker):
    """``_bucketed_membership``: both buckets launched into one [U, Na + Nb]
    buffer, bit-equal to the two plain slabs side by side; its time beside
    that of the two slabs alone."""
    import torch

    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops.membership_cuda import (
        membership_slab_ref,
        membership_slab_windowed,
    )

    (ta, va), (tb, vb) = ranker._heavy_a, ranker._heavy_b
    m, _ = hy._bucketed_membership(u_pad, ta, va, tb, vb, ranker.d_tile)
    ref_a = membership_slab_ref(u_pad, ta, va)
    same_a = torch.equal(m[:, : ta.shape[1]], ref_a)
    del ref_a
    same_b = torch.equal(m[:, ta.shape[1]:], membership_slab_ref(u_pad, tb, vb))
    torch.cuda.synchronize()
    if not (same_a and same_b) or m.shape[1] != ta.shape[1] + tb.shape[1]:
        fail(f"{phase}: the shared bucketed buffer differs from the plain slabs")
    del m
    t_shared = cuda_ms(lambda: hy._bucketed_membership(u_pad, ta, va, tb, vb,
                                                       ranker.d_tile))
    t_alone = cuda_ms(lambda: (membership_slab_windowed(u_pad, ta, va),
                               membership_slab_windowed(u_pad, tb, vb)))
    log(f"{phase}: _bucketed_membership: both buckets in one [{u_pad.shape[0]}, "
        f"{ta.shape[1] + tb.shape[1]}] buffer, bit-equal to the plain slabs side by "
        f"side; {t_shared:.3f} ms (two slabs alone {t_alone:.3f} ms)")
    torch.cuda.empty_cache()


def slab_edge_cases(dev):
    """Both slab wrappers (one kernel) on seeded inputs that the judged
    shapes do not reach, bit for bit against the plain version: a union
    padded with copies of its last value (a run of 101 equal slots across
    row chunks) and docs that repeat its terms; terms out of order (the
    kernel checks each doc's order: the windowed wrapper's contract is
    ascending terms, but its slab is right for any); a union past the
    kernel's shared-memory stage; ragged N into an unaligned column range of
    a larger buffer (``out=`` of the windowed wrapper); K = 0."""
    import torch

    from ircl_tpu_torch.ops.membership_cuda import (
        membership_slab,
        membership_slab_ref,
        membership_slab_windowed,
    )

    rng = np.random.default_rng(2)
    n_checked = 0
    for U, K, N, vocab, ascending, col0 in (
            (200, 30, 900, 220, True, 0), (200, 30, 900, 220, False, 0),
            (20000, 40, 700, 80000, True, 0), (512, 24, 1001, 2048, False, 3),
            (300, 17, 1001, 1200, True, 5), (100, 0, 300, 400, True, 0)):
        u = np.sort(rng.choice(vocab, size=U, replace=False)).astype(np.int32)
        if vocab < 2 * U:
            u[U // 2:] = u[U // 2 - 1]
        t = rng.integers(0, vocab, size=(K, N)).astype(np.int32)
        t[rng.random((K, N)) < 0.3] = -1
        if ascending:
            t = np.sort(np.where(t < 0, np.iinfo(np.int32).max, t), axis=0)
            t[t == np.iinfo(np.int32).max] = -1
        v = rng.random((K, N)).astype(np.float32) * (t >= 0)
        args = [torch.tensor(x, device=dev) for x in (u, t, v)]
        ref = membership_slab_ref(*args)
        out = torch.full((U, N + col0 + 7), 7.0, device=dev)
        got = membership_slab_windowed(*args, out=out, col_offset=col0)
        for name, ok in (
                ("membership_slab", torch.equal(membership_slab(*args), ref)),
                ("membership_slab_windowed",
                 torch.equal(got, ref) and torch.equal(membership_slab_windowed(*args), ref)
                 and bool((out[:, :col0] == 7).all())
                 and bool((out[:, col0 + N:] == 7).all()))):
            if not ok:
                fail(f"phase 2: {name} differs from its plain version at U={U}, "
                     f"K={K}, N={N}, ascending {ascending}, col_offset {col0}")
            n_checked += 1
    log(f"phase 2: slab edge cases: {n_checked} calls bit-equal to the plain version "
        f"(copies of the last union value with repeated terms, terms out of order, "
        f"U=20000, ragged N at unaligned column offsets, K=0)")


def seeded_pools(rng, n_pad, B, P, one_tile=None):
    """Doc-ascending pools [P, B] as the ranker gathers them: a random
    share of each column real, the tail padded with ``n_pad``; column 0
    held inside ``one_tile = (lo, hi)`` when given."""
    docs = np.sort(rng.integers(0, n_pad, size=(P, B)), axis=0)
    if one_tile is not None:
        docs[:, 0] = np.sort(rng.integers(*one_tile, size=P))
    fill = rng.integers(P // 2, P + 1, size=B)
    docs = np.where(np.arange(P)[:, None] < fill[None, :], docs, n_pad).astype(np.int32)
    contribs = np.where(docs < n_pad, rng.integers(1, 4, size=(P, B)) * 0.5, 0.0)
    return docs, contribs.astype(np.float32)


def light_add_edge_cases(dev):
    """``light_add_topk_t`` on seeded inputs that the judged shapes do not
    reach, each bit for bit against the plain version (ids equal off exact
    ties): scores of small integers (many exact ties), k = 1, 5, 8 on the
    register lists and k = 9 above them, runs of equal scores across the
    row groups' borders, a column whose whole pool falls in one d-tile,
    empty pools, d_tile 256, 512 and 1024, B off the kernel's 64-column
    block (200) and odd (37: the column kernel)."""
    import torch

    from ircl_tpu_torch.ops.light_add_cuda import light_add_topk_t, light_add_topk_t_ref

    rng = np.random.default_rng(3)
    n_checked = 0
    for n_pad, B, P, k, d_tile, case in (
            (4096, 256, 48, 1, 256, "ties"), (4096, 256, 48, 5, 512, "ties"),
            (4096, 256, 48, 8, 1024, "ties"), (4096, 256, 48, 9, 1024, "ties"),
            (4096, 192, 40, 5, 256, "straddle"), (4096, 200, 40, 5, 512, "one tile"),
            (4096, 128, 40, 8, 256, "empty pools"), (2048, 37, 24, 5, 256, "ties")):
        h = rng.integers(0, 6, size=(n_pad, B)).astype(np.float32)
        h *= rng.random((n_pad, B)) < 0.5
        if case == "straddle":  # equal scores on both sides of every border
            h[:] = 0.0
            border = np.arange(d_tile // 8, n_pad, d_tile // 8)
            for off in (-2, -1, 0, 1):
                h[border + off] = 3.0
        docs, contribs = seeded_pools(rng, n_pad, B, P, (512, 512 + d_tile)
                                      if case == "one tile" else None)
        if case == "empty pools":
            docs, contribs = docs[:0], contribs[:0]
        args = [torch.tensor(np.ascontiguousarray(x), device=dev)
                for x in (h, docs, contribs)]
        s1, i1 = light_add_topk_t(*args, k=k, d_tile=d_tile)
        s2, i2 = light_add_topk_t_ref(*args, k=k, d_tile=d_tile)
        torch.cuda.synchronize()
        if not torch.equal(s1, s2) or not bool(((i1 == i2) | (s1 == s2)).all()):
            fail(f"phase 2: light_add_topk_t ({case}, B={B}, k={k}, d_tile={d_tile}) "
                 f"differs from its plain version")
        n_checked += 1
    log(f"phase 2: light add edge cases: {n_checked} calls bit-equal to the plain "
        f"version (k = 1, 5, 8, 9; ties across row groups; one column's pool in one "
        f"d-tile; empty pools; d_tile 256, 512, 1024; B = 200 and 37)")


def fused_dot_light_edge_cases(dev):
    """``fused_dot_light_topk`` on seeded sparse slabs that phase 16's shape
    does not reach, each within the probe's bound of the plain version,
    every differing position carrying its own plain total: U off the
    kernel's 32-row stage (100, 1000) and empty, B off its 256-column block
    (64, 320), d_tile 128, 256 and 1024, k = 12 (above the register list)."""
    import torch

    from ircl_tpu_torch.ops.fused_dot_light_cuda import (
        fused_dot_light_topk, fused_dot_light_topk_ref, high3_scores_t_ref, split_hi_lo,
    )

    rng = np.random.default_rng(16)
    n_checked = 0
    for U, n, B, P, k, d_tile in ((100, 1024, 320, 16, 5, 256),
                                  (1000, 2048, 64, 24, 5, 128),
                                  (256, 2048, 256, 20, 5, 1024),
                                  (0, 512, 128, 8, 5, 256),
                                  (300, 2048, 192, 20, 12, 1024)):
        m = (rng.random((U, n)) < 0.05) * rng.random((U, n))
        w = (rng.random((U, B)) < 0.05) * rng.random((U, B))
        (mh, ml), (wh, wl) = (split_hi_lo(torch.tensor(x, dtype=torch.float32, device=dev))
                              for x in (m, w))
        sd, sv = (torch.tensor(x, device=dev) for x in seeded_pools(rng, n, B, P))
        args = (mh, ml, wh, wl, sd, sv)
        got = fused_dot_light_topk(*args, k=k, d_tile=d_tile)
        ref = fused_dot_light_topk_ref(*args, k=k, d_tile=d_tile)
        h_t = high3_scores_t_ref(mh, ml, wh, wl)
        k8 = -(-k // 8) * 8

        def own(rows, cols, pos):
            totals = plain_totals_at(h_t, sd, sv, pos, cols)
            return torch.where(pos // d_tile == rows // k8, totals, torch.nan)

        ok, err, _ = tiles_agree(got, ref, FUSED_DOT_RTOL, FUSED_DOT_ATOL, own)
        if not ok:
            fail(f"phase 16: fused_dot_light_topk (U={U}, N={n}, B={B}, k={k}, "
                 f"d_tile={d_tile}) leaves the probe's bound of its plain version "
                 f"({err})")
        n_checked += 1
    log(f"phase 16: fused dot + light add edge cases: {n_checked} calls within the "
        f"probe's bound of the plain version (U = 100, 1000, 0; B = 64, 320, 192; "
        f"d_tile 128, 256, 1024; k = 12)")


def phase16_probe_kernels(dev, index, claims, dense_queries, dense_corpus, dense_ref,
                          results, launches):
    """Kernels #7 and #8 against their plain versions, then each driven
    through its entry point with fresh launch counts."""
    import torch

    from ircl_tpu_torch.index.ranker import TfidfRanker
    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops.dense_topk_cuda import (
        chunk_max, chunk_max_presplit, chunk_max_presplit_ref,
        cosine_topk_fused_presplit, pad_corpus_t,
    )
    from ircl_tpu_torch.ops.fused_dot_light_cuda import (
        fused_dot_light_topk, fused_dot_light_topk_ref, high3_scores_t_ref, split_hi_lo,
    )

    put = lambda x: torch.tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    fused_dot_light_edge_cases(dev)
    # ---- #7 on the judged configuration's operands (phase 5's) -------------
    ranker = TfidfRanker(
        index, dev, mode="hybrid", df_threshold=24, width_buckets=2,
        fixed_union_cap=4096, fixed_max_terms=64, precision="high", union_round=512,
    )
    buckets, weights = ranker._vectorize(claims)
    host = [put(x) for x in ranker.hybrid_host_inputs(buckets, weights)]
    u_pad, qb_t, qw_t, ld, lc = host
    m, u_tile = hy._bucketed_membership(u_pad, *ranker._heavy_a, *ranker._heavy_b,
                                        ranker.d_tile)
    wt = hy._query_slab(u_pad, qb_t, qw_t, u_tile, True)[:, : ld.shape[0]].contiguous()
    t_split = cuda_ms(lambda: (split_hi_lo(m), split_hi_lo(wt)), reps=2)
    (m_hi, m_lo), (w_hi, w_lo) = split_hi_lo(m), split_hi_lo(wt)
    del m, wt
    sd, sv = ld.T.contiguous(), lc.T.contiguous()
    d_lt = next(t for t in (1024, 512, 256) if m_hi.shape[1] % t == 0)
    args = (m_hi, m_lo, w_hi, w_lo, sd, sv)
    got = fused_dot_light_topk(*args, k=K, d_tile=d_lt)
    ref = fused_dot_light_topk_ref(*args, k=K, d_tile=d_lt)
    torch.cuda.synchronize()
    h_t = high3_scores_t_ref(m_hi, m_lo, w_hi, w_lo)  # what a differing id is held to
    k8 = got[0].shape[0] // (m_hi.shape[1] // d_lt)

    def own(rows, cols, pos):  # a position stands only in its own tile's rows
        totals = plain_totals_at(h_t, sd, sv, pos, cols)
        return torch.where(pos // d_lt == rows // k8, totals, torch.nan)

    ok, err, n_ids = tiles_agree(got, ref, FUSED_DOT_RTOL, FUSED_DOT_ATOL, own)
    if not ok:
        fail(f"phase 16: fused_dot_light_topk differs from its plain version: scores "
             f"by {err}, or one of {n_ids} differing positions does not carry its "
             f"own plain total")
    live = ref[1] >= 0  # how much of the bound the scores use
    used = float(((got[0] - ref[0]).abs() / (FUSED_DOT_ATOL + FUSED_DOT_RTOL
                                             * ref[0].abs()))[live].max())
    t_k = cuda_ms(lambda: fused_dot_light_topk(*args, k=K, d_tile=d_lt), reps=2)
    t_p = cuda_ms(lambda: fused_dot_light_topk_ref(*args, k=K, d_tile=d_lt), reps=1)
    U, n_pad = m_hi.shape
    B = w_hi.shape[1]
    results["fused_dot_light_topk"] = dict(
        max_abs_err=err, share_of_tolerance=used, ms=t_k, plain_ms=t_p, library_ms=None,
        **least_time((*args, *got), 3 * 2 * U * n_pad * B, BF16_FLOPS))
    log(f"phase 16: fused_dot_light_topk m [{U}, {n_pad}] x w [{U}, {B}] bf16 halves, "
        f"P={sd.shape[0]}, d_tile={d_lt}: per-tile scores within {err:.3g} of the "
        f"plain version, {used:.3f} of the bound at most (rtol {FUSED_DOT_RTOL}, "
        f"atol {FUSED_DOT_ATOL}; {n_ids} "
        f"positions differ, each carrying its own plain total inside it); kernel {t_k:.3f} ms "
        f"({3 * 2 * U * n_pad * B / t_k / 1e9:.1f} TFLOP/s), plain {t_p:.3f} ms, bound "
        f"{results['fused_dot_light_topk']['bound_ms']:.3f} ms; the split of both "
        f"slabs {t_split:.3f} ms")
    del got, ref

    # its path: the fused engine's top-5 with the dot inside the kernel
    fused_dot_light_topk.launches = 0

    def fused_top5():
        ts, ti = fused_dot_light_topk(*args, k=K, d_tile=d_lt)
        top_s, top_pos = torch.topk(ts.T, K, dim=1)
        return top_s, torch.gather(ti.T, 1, top_pos)

    engine = lambda: hy.hybrid_topk_bucketed_fused(  # noqa: E731
        *ranker._heavy_a, *ranker._heavy_b, *host, k=K, precision="high",
        queries_sorted=True, pools_sorted=True, d_tile=ranker.d_tile)
    s, i = fused_top5()
    rs, ri = engine()
    live = ri >= 0
    close = torch.isclose(s, rs, rtol=FUSED_DOT_RTOL, atol=FUSED_DOT_ATOL)
    r, c = ((i != ri) & live).nonzero(as_tuple=True)  # c: slot; the claim is r
    tied = torch.isclose(plain_totals_at(h_t, sd, sv, i[r, c], r), s[r, c],
                         rtol=FUSED_DOT_RTOL, atol=FUSED_DOT_ATOL)
    if not bool((close | ~live).all()) or not bool(tied.all()):
        fail(f"phase 16: the fused dot + light add top-{K} leaves the probe's bound: "
             f"scores by {float((s - rs)[live].abs().max())}, {int((~tied).sum())} of "
             f"{r.numel()} differing ids without their own plain total")
    t_new = cuda_ms(fused_top5, reps=2)
    t_old = cuda_ms(engine, reps=2)
    launches["fused_dot_light_topk"] = fused_dot_light_topk.launches
    log(f"phase 16: top-{K} of {B} claims through the fused dot + light add equals "
        f"hybrid_topk_bucketed_fused's within the probe's bound (max "
        f"{float((s - rs)[live].abs().max()):.3g}, {int(((i != ri) & live).sum())} ids "
        f"differ, each carrying its own plain total inside it): {t_new:.3f} ms from split slabs against {t_old:.3f} ms for "
        f"the whole fused engine (slabs, fp32 GEMM, light add); "
        f"{launches['fused_dot_light_topk']} launches")
    del ranker, host, args, m_hi, m_lo, w_hi, w_lo, sd, sv, s, i, rs, ri, h_t
    torch.cuda.empty_cache()

    # ---- #8 on bench_dense.py's corpus (phase 7's) -------------------------
    q_d = torch.tensor(dense_queries, device=dev)
    ct_d, m_real = pad_corpus_t(torch.tensor(dense_corpus, device=dev), DENSE_TILE)
    rows_d = ct_d.T.contiguous()
    ct_hi, ct_lo = split_hi_lo(ct_d)
    pargs = (q_d, ct_hi, ct_lo, DENSE_CHUNK, DENSE_TILE, m_real, "fold")
    high3 = lambda: chunk_max(  # noqa: E731
        q_d, ct_d, DENSE_CHUNK, DENSE_TILE, m_real, "high3", "fold")
    got = chunk_max_presplit(*pargs)
    ref = chunk_max_presplit_ref(*pargs)
    same = high3()
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    err = float((got[fin] - ref[fin]).abs().max())
    if not torch.equal(torch.isfinite(got), fin) or err > CMAX_ATOL:
        fail(f"phase 16: chunk_max_presplit differs from its plain version by {err}")
    if not torch.equal(got, same):
        fail("phase 16: chunk_max_presplit is not chunk_max high3/fold bit for bit")
    t_k = cuda_ms(lambda: chunk_max_presplit(*pargs), reps=3)
    t_p = cuda_ms(lambda: chunk_max_presplit_ref(*pargs), reps=2)
    t_h3 = cuda_ms(high3, reps=3)
    results["chunk_max_presplit"] = dict(
        max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=None,
        **least_time((q_d, ct_hi, ct_lo, got),
                     3 * 2 * q_d.shape[0] * q_d.shape[1] * m_real, BF16_FLOPS))
    log(f"phase 16: chunk_max_presplit B={q_d.shape[0]} M_pad={ct_hi.shape[1]} (m_real "
        f"{m_real}) fold: chunk maxima within {err:.3g} of the plain version (bound "
        f"{CMAX_ATOL}) and equal to chunk_max high3/fold bit for bit; kernel {t_k:.3f} "
        f"ms, high3 kernel on the f32 corpus {t_h3:.3f} ms, plain {t_p:.3f} ms")
    del got, ref, same

    chunk_max_presplit.launches = 0
    chunk_max_presplit.launches_by_route = {"mma": 0, "simt": 0}
    fn = lambda: cosine_topk_fused_presplit(  # noqa: E731
        q_d, ct_hi, ct_lo, rows_d, k=K, chunk=DENSE_CHUNK, m_tile=DENSE_TILE,
        m_real=m_real, epilogue="fold")
    s, i = (x.cpu().numpy() for x in fn())
    ref_s, ref_sets = dense_ref
    bad_s = sum(not np.allclose(s[b], ref_s[b], rtol=1e-5) for b in range(DENSE_B))
    bad_i = sum(set(i[b].tolist()) != ref_sets[b] for b in range(DENSE_B))
    if bad_s:
        fail(f"phase 16: cosine_topk_fused_presplit failed the full-batch gate on "
             f"{bad_s} queries")
    qps = timed_qps(fn, DENSE_B, reps=5)
    launches["chunk_max_presplit"] = chunk_max_presplit.launches
    results["chunk_max_presplit"]["launches_by_route"] = dict(
        chunk_max_presplit.launches_by_route)
    log(f"phase 16: cosine_topk_fused_presplit: full-batch score parity "
        f"{DENSE_B - bad_s}/{DENSE_B} (rtol 1e-5; id-set tie swaps {bad_i}); "
        f"{qps:.1f} q/s; {launches['chunk_max_presplit']} launches, by route "
        f"{chunk_max_presplit.launches_by_route}")


def phase17_scale(dev, results):
    """bench_scale.py's configuration on the port: index, rankers, the scipy
    gate for the staged engine, select_rescore and the ragged engine, q/s,
    ms by stage, peak memory. Returns what phases 18 and 19 reuse."""
    import scipy.sparse as sp
    import torch

    from ircl_tpu_torch.index.build import to_scipy
    from ircl_tpu_torch.index.ranker import TfidfRanker
    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops import ragged
    from ircl_tpu_torch.ops.membership_cuda import scores_matmul
    from ircl_tpu_torch.tools.scale_index import synth_index, synth_queries

    put = lambda x: torch.tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    t0 = time.perf_counter()
    index = synth_index(SCALE_DOCS, SCALE_TERMS, SCALE_VOCAB, HASH_SIZE)
    t_index = time.perf_counter() - t0
    qb, qw = synth_queries(index, SCALE_B)
    log(f"phase 17: synthetic index of {index.num_docs} docs, {index.nnz} postings "
        f"(bench_scale.py's {SCALE_DOCS} docs, no cut) built in {t_index:.1f} s on the "
        f"host; {SCALE_B} queries of {qb.shape[1]} terms")

    # the CPU reference: per-query scipy matvec (bench_scale.py:138-159)
    t0 = time.perf_counter()
    mat = to_scipy(index)

    def cpu_closest(b):
        nz = qw[b] != 0
        spvec = sp.csr_matrix(
            (qw[b][nz], qb[b][nz], [0, int(nz.sum())]), shape=(1, HASH_SIZE)
        )
        res = spvec * mat
        o = np.argpartition(-res.data, min(K, max(len(res.data) - 1, 0)))[:K]
        o = o[np.argsort(-res.data[o])]
        by_id = np.argsort(res.indices)  # every scored doc, for scale_gate
        return res.indices[o], res.data[o], res.indices[by_id], res.data[by_id]

    t1 = time.perf_counter()  # the gate reads the first SCALE_PARITY; id checks, all
    cpu_results = [cpu_closest(b) for b in range(SCALE_B)]
    cpu_qps = SCALE_B / (time.perf_counter() - t1)
    log(f"phase 17: scipy reference for {SCALE_B} queries in "
        f"{time.perf_counter() - t0:.1f} s ({cpu_qps:.1f} q/s on the host)")
    del mat

    t0 = time.perf_counter()
    ranker = TfidfRanker(index, dev, **SCALE_RANKER)
    t_build = time.perf_counter() - t0
    split = ranker._split
    log(f"phase 17: staged ranker built in {t_build:.1f} s (df-split, width buckets, "
        f"upload): K_h={split.heavy.k_width}, buckets "
        f"{tuple(ranker._heavy_a[0].shape)} and {tuple(ranker._heavy_b[0].shape)}, "
        f"d_tile {ranker.d_tile}")
    t0 = time.perf_counter()
    sel = TfidfRanker(index, dev, split=split, select_rescore=SCALE_SELECT,
                      **{k: v for k, v in SCALE_RANKER.items() if k != "df_threshold"})
    rag = TfidfRanker(index, dev, mode="ragged", fixed_max_terms=24)
    log(f"phase 17: select_rescore={SCALE_SELECT} ranker (the same split) and the "
        f"ragged ranker built in {time.perf_counter() - t0:.1f} s")

    out = {}
    for name, r in (("staged", ranker), (f"select_rescore={SCALE_SELECT}", sel)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        s, i = r.hybrid_from_vectors(qb, qw, K)
        first = time.perf_counter() - t0
        bad = scale_gate(s, i, cpu_results, SCALE_PARITY)
        peak = torch.cuda.max_memory_allocated()
        log(f"phase 17: {name}: parity {SCALE_PARITY - bad}/{SCALE_PARITY} queries "
            f"match scipy (sorted top-{K} scores, rtol 1e-4, each doc its own score); "
            f"first batch {first:.2f} s; "
            f"peak device memory {peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} "
            f"GiB above the resident indexes)")
        if bad:
            fail(f"phase 17: {name} failed the scipy gate on {bad} queries")
        out[name] = (s, i)
        rounds = []
        for _ in range(4):  # bench_scale.py:202-218, 5 batches in flight a round
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            outs = [r.hybrid_from_vectors_async(qb, qw, K) for _ in range(5)]
            e1.record()
            torch.cuda.synchronize()
            outs[-1][0].cpu()
            rounds.append((5 * SCALE_B / (time.perf_counter() - t0),
                           e0.elapsed_time(e1) / 5))
            del outs
        best = max(q for q, _ in rounds)
        log(f"phase 17: {name}: B={SCALE_B}, 5 batches a round: "
            + ", ".join(f"{q:.1f}" for q, _ in rounds)
            + f" q/s (best {best:.1f}; {best / cpu_qps:.1f}x the host's scipy); "
            + ", ".join(f"{m:.1f}" for _, m in rounds)
            + " ms a batch between CUDA events (host half included)")
    (s_st, i_st), (s_se, i_se) = out["staged"], out[f"select_rescore={SCALE_SELECT}"]
    same = sum(np.allclose(np.sort(s_st[b]), np.sort(s_se[b]), rtol=1e-5)
               for b in range(SCALE_B))
    log(f"phase 17: select_rescore={SCALE_SELECT} returns the staged engine's sorted "
        f"top-{K} scores on {same}/{SCALE_B} queries (rtol 1e-5; its selection is "
        f"approximate, the gate above certifies the {SCALE_PARITY} checked)")

    # the ragged validation engine on 32 queries
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    docs, contribs, cap = rag._gather_ragged_vectors(qb[:SCALE_RAGGED], qw[:SCALE_RAGGED])
    rs, ri = ragged.segment_topk(docs, contribs, k=K)
    rs, ri = rs.cpu().numpy(), ri.cpu().numpy()
    t_rag = time.perf_counter() - t0
    bad = scale_gate(rs, ri, cpu_results, SCALE_RAGGED)
    if bad:
        fail(f"phase 17: the ragged engine failed the scipy gate on {bad} queries")
    dense = ragged.dense_scores(docs, contribs, num_docs=index.num_docs)
    own = torch.gather(dense, 1, put(np.maximum(ri, 0)).long()).cpu().numpy()
    if not np.allclose(np.where(ri >= 0, own, 0.0), rs, rtol=1e-5):
        fail("phase 17: dense_scores disagrees with the ragged top-k")
    log(f"phase 17: ragged engine, {SCALE_RAGGED} queries, pools [{SCALE_RAGGED}, {cap}]: "
        f"parity {SCALE_RAGGED - bad}/{SCALE_RAGGED} against scipy; dense_scores "
        f"[{SCALE_RAGGED}, {index.num_docs}] carries each returned doc's score; "
        f"{t_rag:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del docs, contribs, dense, rag, sel
    torch.cuda.empty_cache()

    # ms by stage of one staged batch
    t0 = time.perf_counter()
    host = ranker.hybrid_host_inputs(qb, qw)
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_in = [put(x) for x in host]
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    u_pad, qb_t, qw_t, ld, lc = dev_in
    # the batch twice: the first pays the allocator for its buffers (the
    # 2 GB slab among them), the second reuses them, so its split holds the
    # kernels alone
    splits = []
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        m, u_tile = hy._bucketed_membership(u_pad, *ranker._heavy_a,
                                            *ranker._heavy_b, ranker.d_tile)
        wt = hy._query_slab(u_pad, qb_t, qw_t, u_tile, True)
        ev[1].record()
        h = scores_matmul(wt.T, m)[: ld.shape[0]]
        ev[2].record()
        hy._merge_light(h, ld, lc, K, h.shape[1], pools_sorted=True)
        ev[3].record()
        del h
        h_sel = torch.matmul(wt[:, : ld.shape[0]].T.to(torch.bfloat16),
                             m.to(torch.bfloat16))
        ev[4].record()
        hy._select_rescore_topk(m, wt, h_sel, ld, lc, K, SCALE_SELECT, h_sel.shape[1],
                                True)
        ev[5].record()
        torch.cuda.synchronize()
        splits.append([ev[j].elapsed_time(ev[j + 1]) for j in range(5)])
        slab_shape = list(m.shape)
        del m, wt, h_sel
    first, ms = splits
    log(f"phase 17: one batch by stage: host pool gather and query prep {host_ms:.2f} "
        f"ms, upload {upload_ms:.2f} ms (pools [{ld.shape[0]}, {ld.shape[1]}]); slabs "
        f"{slab_shape} {ms[0]:.3f} ms (the first batch, which allocates the "
        f"buffers: {first[0]:.3f} ms), fp32 GEMM {ms[1]:.3f} ms, "
        f"top-k + light merge {ms[2]:.3f} ms; select_rescore: bf16 casts + GEMM "
        f"{ms[3]:.3f} ms, selection + exact rescore {ms[4]:.3f} ms")
    torch.cuda.empty_cache()

    # kernel #2 at this index's shapes, where 197 of its 206 launches run
    from ircl_tpu_torch.ops.membership_cuda import membership_slab_windowed

    before = membership_slab_windowed.launches
    results["membership_slab_windowed"]["scale"] = compare_slabs(
        "phase 17", "membership_slab_windowed", membership_slab_windowed, {
            "bucket a": (u_pad, *ranker._heavy_a),
            "bucket b": (u_pad, *ranker._heavy_b),
            "query": (u_pad, qb_t, qw_t),
        })
    membership_slab_windowed.launches = before  # comparisons are not the path
    return index, qb, qw, cpu_results, ranker, dev_in, (s_st, i_st)


def phase18_onepass(dev, ranker, cpu_results, dev_in, staged, results):
    """Kernel #5 against its plain version on both buckets of phase 17's
    index, then ``hybrid_topk_onepass`` on phase 17's inputs."""
    import torch

    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops.fused_hybrid_cuda import (
        fused_hybrid_tile_topk, fused_hybrid_tile_topk_ref, hybrid_topk_onepass,
    )

    u_pad, qb_t, qw_t, ld, lc = dev_in
    B = ld.shape[0]
    wt = hy._query_slab(u_pad, qb_t, qw_t, hy._u_tile(u_pad.shape[0]), True)
    wt = wt[:, :B].contiguous()
    sd_t, sv_t = ld.T.contiguous(), lc.T.contiguous()
    na = ranker._heavy_a[0].shape[1]
    before = fused_hybrid_tile_topk.launches
    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 bound_dense_ms=0.0, library_ms=None)
    by = (0.0, "")
    for label, (terms, vals), base in (("bucket a", ranker._heavy_a, 0),
                                       ("bucket b", ranker._heavy_b, na)):
        d_tile = next(t for t in (1024, 512, 256) if terms.shape[1] % t == 0)
        args = (terms, vals, u_pad, wt, sd_t, sv_t)
        kw = dict(k=K, d_tile=d_tile, base=base)
        got = fused_hybrid_tile_topk(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = fused_hybrid_tile_topk_ref(*args, **kw)
        torch.cuda.synchronize()
        t_p = 1e3 * (time.perf_counter() - t0)  # one run: it takes seconds
        ok, err, n_ids = tiles_agree(got, ref, ONEPASS_RTOL)  # ids: equal outright
        if not ok:
            fail(f"phase 18: fused_hybrid_tile_topk ({label}) differs from its plain "
                 f"version: scores by {err}, {n_ids} positions")
        del ref
        torch.cuda.empty_cache()
        t_k = cuda_ms(lambda: fused_hybrid_tile_topk(*args, **kw), reps=3)
        # the work the function needs: one multiply-add a (hit, column) and
        # every input once (the kernel itself reads the ELL rows once a block
        # of 128 columns: that is its cost, not the function's)
        hits = int(torch.isin(terms, u_pad).sum())
        need = least_time((*args, *got), 2 * hits * B, F32_FLOPS)
        # the dense work the TPU kernel did: the slab product over every slot
        dense = least_time((), 2 * u_pad.shape[0] * terms.shape[1] * B, F32_FLOPS)
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["ms"] += t_k
        total["plain_ms"] += t_p
        total["bound_ms"] += need["bound_ms"]
        total["bound_dense_ms"] += dense["bound_ms"]
        by = max(by, (need["bound_ms"], need["bound_by"]))
        log(f"phase 18: fused_hybrid_tile_topk {label}: ELL [{terms.shape[0]}, "
            f"{terms.shape[1]}], U={u_pad.shape[0]}, B={B}, P={sd_t.shape[0]}, d_tile "
            f"{d_tile}, base {base}: per-tile scores within {err:.3g} of the plain "
            f"version (rtol {ONEPASS_RTOL}) and every position equal; "
            f"{hits} of {int((terms >= 0).sum())} ELL terms are in the union; kernel "
            f"{t_k:.3f} ms, plain {t_p:.1f} ms (one run), bound {need['bound_ms']:.3f} "
            f"ms by {need['bound_by']} for the work the function needs, "
            f"{dense['bound_ms']:.3f} ms for the TPU kernel's dense slab product")
        del got
    results["fused_hybrid_tile_topk"] = dict(total, bound_by=by[1])
    fused_hybrid_tile_topk.launches = before  # comparisons are not the path

    heavy = (*ranker._heavy_a, *ranker._heavy_b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    s, i = hybrid_topk_onepass(*heavy, *dev_in, k=K)
    s_np, i_np = ranker._finish_hybrid((s, i), B)
    peak = torch.cuda.max_memory_allocated() - base_mem
    s_st, i_st = staged
    close = np.isclose(s_np, s_st, rtol=ONEPASS_RTOL, atol=0.0)
    untied = ids_carry_scores(s_np, i_np, i_st, cpu_results)
    if not close.all() or untied:
        fail(f"phase 18: hybrid_topk_onepass leaves the staged engine's top-{K}: scores "
             f"by {np.abs(s_np - s_st).max()}, {untied} differing ids off a tie")
    bad = scale_gate(s_np, i_np, cpu_results, SCALE_PARITY)
    if bad:
        fail(f"phase 18: hybrid_topk_onepass failed the scipy gate on {bad} queries")
    t_one = cuda_ms(lambda: hybrid_topk_onepass(*heavy, *dev_in, k=K), reps=5)
    kw = dict(k=K, precision="high", queries_sorted=True, pools_sorted=True,
              d_tile=ranker.d_tile)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_staged = cuda_ms(lambda: hy.hybrid_topk_bucketed(*heavy, *dev_in, **kw), reps=5)
    peak_staged = torch.cuda.max_memory_allocated() - base_mem
    log(f"phase 18: hybrid_topk_onepass on phase 17's inputs: top-{K} equal to the "
        f"staged engine's (scores rtol {ONEPASS_RTOL}, max "
        f"{np.abs(s_np - s_st).max():.3g}; {int((i_np != i_st).sum())} ids differ, each "
        f"with its own scipy score: ties), scipy gate {SCALE_PARITY - bad}/"
        f"{SCALE_PARITY}; device ms a batch {t_one:.3f} against the staged engine's {t_staged:.3f}; peak memory "
        f"above the resident index {peak / 2**20:.1f} MiB against "
        f"{peak_staged / 2**20:.1f} MiB")


def phase19_chunked(dev, index, qb, qw, staged, cpu_results):
    """``ChunkedHybridRanker`` in two chunks against the single ranker."""
    import torch

    from ircl_tpu_torch.index.chunked import ChunkedHybridRanker

    t0 = time.perf_counter()
    chunked = ChunkedHybridRanker(
        index, dev, chunk_docs=SCALE_CHUNK,
        **{k: v for k, v in SCALE_RANKER.items() if k != "mode"})
    t_build = time.perf_counter() - t0
    if len(chunked.chunks) != -(-index.num_docs // SCALE_CHUNK):
        fail(f"phase 19: {len(chunked.chunks)} chunks")
    s, i = chunked.hybrid_from_vectors(qb, qw, K)
    s_st, i_st = staged
    close = np.isclose(s, s_st, rtol=1e-5, atol=0.0)
    untied = ids_carry_scores(s, i, i_st, cpu_results)
    if not close.all() or untied:
        fail(f"phase 19: the chunked ranker leaves the single ranker's top-{K}: "
             f"scores by {np.abs(s - s_st).max()}, {untied} differing ids off a tie")
    rounds = []
    for _ in range(3):  # bench_scale.py's chunked timing: 2 batches a round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            chunked.hybrid_from_vectors(qb, qw, K)
        rounds.append(2 * SCALE_B / (time.perf_counter() - t0))
    log(f"phase 19: ChunkedHybridRanker, {len(chunked.chunks)} chunks of {SCALE_CHUNK} "
        f"docs built in {t_build:.1f} s: top-{K} equal to the single ranker's (scores "
        f"rtol 1e-5, max {np.abs(s - s_st).max():.3g}; {int((i != i_st).sum())} ids "
        f"differ, each with its own scipy score: ties); "
        + ", ".join(f"{q:.1f}" for q in rounds) + " q/s")


def state_to(st, device):
    """A copy of a contrastive ``TrainState`` on ``device``."""
    from ircl_tpu_torch.contrastive.state import TrainState
    from ircl_tpu_torch.utils.tree import tree_map

    move = lambda x: x.to(device, copy=True) if hasattr(x, "to") else x  # noqa: E731
    return TrainState(**tree_map(move, vars(st)))


def profile_steps(step, st, batch, n):
    """``n`` steps under ``torch.profiler``: (state, launches a step, the
    device's idle share over the steps' span, device ms by kernel name, top
    first), or (state, None, None, {}) where the profiler saw no device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            st, _, _ = step(st, *batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return st, None, None, {}
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return st, len(kernels) / n, 1.0 - busy / span, top


def contrastive_stage_split(cfg, feat, st, batch):
    """Device ms of one train step by stage, from CUDA events between the
    stages that ``make_train_step`` runs, in its order (featurizer, BiLSTM
    forward of q with autograd and of k without, loss, backward, enqueue a
    micro-batch; then optimizer, EMA)."""
    import torch

    from ircl_tpu_torch.contrastive.losses import nt_xent_loss
    from ircl_tpu_torch.contrastive.state import global_norm, make_optimizer
    from ircl_tpu_torch.contrastive.train import _enqueue, ema_update
    from ircl_tpu_torch.models.encoder import seq2vec
    from ircl_tpu_torch.utils.precision import float32_precision
    from ircl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    eff = cfg.micro_batch * cfg.accum_steps
    flag = float(st.step >= cfg.queue_start_steps)
    with float32_precision():
        mark("start")
        views = tree_map(lambda t: t.detach().requires_grad_(), st.params_q)
        queue, ptr, grads = st.queue.clone(), st.queue_ptr, None
        for a in range(cfg.accum_steps):
            ids_a, mask_a, ids_k, mask_k = (x[a] for x in batch)
            with torch.no_grad():
                fa = feat.apply(feat.params, ids_a, mask_a)
                fk = feat.apply(feat.params, ids_k, mask_k)
            mark("featurizer")
            with torch.enable_grad():
                q = seq2vec(views, cfg.encoder, fa, mask_a)
            mark("BiLSTM forward, q")
            with torch.no_grad():
                k = seq2vec(st.params_k, cfg.encoder, fk, mask_k)
            mark("BiLSTM forward, k")
            with torch.enable_grad():
                loss = nt_xent_loss(q, k, cfg.temperature, queue, flag) / eff
            mark("loss")
            g = torch.autograd.grad(loss, tree_leaves(views))
            mark("backward")
            queue, ptr = _enqueue(queue, ptr, k, cfg.queue_size)
            mark("enqueue")
            grads = list(g) if grads is None else torch._foreach_add(grads, g)
        pq, _ = make_optimizer(cfg).update(st.params_q, tree_unflatten(st.params_q, grads),
                                           st.opt_state, global_norm(grads))
        mark("optimizer")
        ema_update(st.params_k, pq, cfg.momentum)
        mark("EMA")
    torch.cuda.synchronize()
    ms = {}
    for (_, e0), (name, e1) in zip(marks, marks[1:]):
        ms[name] = ms.get(name, 0.0) + e0.elapsed_time(e1)
    return ms


def phase20_contrastive_step(dev):
    """bench_train.py's compiled step on the card: one step against the CPU
    from one state, the queue switching on at ``queue_start_steps``, a
    bfloat16 step, then timed steps, their launches, idle share and stages."""
    import dataclasses

    import torch

    from ircl_tpu_torch.contrastive.state import TrainConfig, init_train_state
    from ircl_tpu_torch.contrastive.train import make_train_step
    from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer

    cfg = TrainConfig(**CT_TRAIN)
    enc = cfg.encoder
    t0 = time.perf_counter()
    fcfg = FeaturizerConfig(**CT_FEAT)
    feat_cpu = HashEmbedFeaturizer(fcfg, device="cpu")
    feat = HashEmbedFeaturizer(fcfg, device=dev, params=feat_cpu.params)
    rng = np.random.default_rng(0)  # bench_train.py:141-148
    shape = (cfg.accum_steps, cfg.micro_batch, fcfg.max_len)
    ids = rng.integers(0, fcfg.vocab_buckets, size=shape).astype(np.int32)
    ids_k = rng.integers(0, fcfg.vocab_buckets, size=shape).astype(np.int32)
    mask = (rng.random(shape) < 0.8).astype(np.float32)
    batch = (ids, mask, ids_k, mask)
    init = init_train_state(0, cfg, device="cpu")
    n_enc = sum(t.numel() for t in _leaves(init.params_q))
    log(f"phase 20: TrainConfig(): BiLSTM {enc.num_layers} x {enc.hidden_size} bi over "
        f"{enc.input_size}-d -> {enc.output_size} ({n_enc / 1e6:.2f}M params), "
        f"micro-batch {cfg.micro_batch} x {cfg.accum_steps}, L={fcfg.max_len}, queue "
        f"{cfg.queue_size}, T={cfg.temperature}, {cfg.optimizer} {cfg.learning_rate}, "
        f"clip {cfg.grad_clip}; hash featurizer table {tuple(feat.params['table'].shape)}; "
        f"set up in {time.perf_counter() - t0:.1f} s")

    # one step from one state on the card and on the CPU
    step = make_train_step(cfg, feat)
    t0 = time.perf_counter()
    s_d, l_d, n_d = step(state_to(init, dev), *batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_c, l_c, n_c = make_train_step(cfg, feat_cpu)(init, *batch)
    cpu_s = time.perf_counter() - t0
    del feat_cpu
    l_d, n_d, l_c, n_c = float(l_d), float(n_d), float(l_c), float(n_c)
    lr = cfg.learning_rate
    far, frac, moved = (0.0, ""), (0.0, ""), 0.0
    for tree in ("params_q", "params_k"):
        for (name, a), (_, b), (_, start) in zip(
                named_leaves(getattr(s_d, tree)), named_leaves(getattr(s_c, tree)),
                named_leaves(getattr(init, tree))):
            d = (a.cpu() - b).abs()
            far = max(far, (float(d.max()), tree + name))
            frac = max(frac, (float((d > 0.1 * lr).float().mean()), tree + name))
            moved = max(moved, float((a.cpu() - start).abs().max()))
    worst_m = [(0.0, ""), (0.0, "")]
    for i, key in enumerate(("mu", "nu")):
        for (name, a), (_, b) in zip(named_leaves(s_d.opt_state[key]),
                                     named_leaves(s_c.opt_state[key])):
            size = float(b.abs().max())
            worst_m[i] = max(worst_m[i], (float((a.cpu() - b).abs().max()) / max(size, 1e-30),
                                          key + name))
    q_err = float((s_d.queue.cpu() - s_c.queue).abs().max())
    if not (abs(l_d - l_c) <= CT_RTOL * abs(l_c) and abs(n_d - n_c) <= CT_RTOL * abs(n_c)
            and far[0] <= 2.1 * lr and frac[0] <= 1e-2 and moved >= 0.5 * lr
            and worst_m[0][0] <= CT_MOMENT_RTOL[0] and worst_m[1][0] <= CT_MOMENT_RTOL[1]
            and q_err <= CT_QUEUE_ATOL and s_d.queue_ptr == s_c.queue_ptr
            and s_d.step == s_c.step == 1
            and s_d.opt_state["count"] == s_c.opt_state["count"] == 1):
        fail(f"phase 20: one step on the card and on the CPU differ: loss {l_d} against "
             f"{l_c}, grad norm {n_d} against {n_c}, parameters by {far}, share over "
             f"lr/10 {frac}, moved {moved}, moments {worst_m}, queue {q_err}, pointer "
             f"{s_d.queue_ptr}/{s_c.queue_ptr}, step {s_d.step}/{s_c.step}")
    log(f"phase 20: one step on the card ({first_s:.2f} s, the first) and on the CPU "
        f"({cpu_s:.2f} s): loss {l_d:.7f} against {l_c:.7f}, grad norm {n_d:.6f} against "
        f"{n_c:.6f} (rtol {CT_RTOL}); params_q and params_k moved by up to {moved:.3g} "
        f"and differ by at most {far[0]:.3g} ({far[1]}; bound 2.1 x lr {lr}), the share "
        f"of a leaf's elements over lr/10 at most {frac[0]:.3g} ({frac[1]}; bound 1e-2); "
        f"mu within {worst_m[0][0]:.3g} and nu within {worst_m[1][0]:.3g} of each leaf's "
        f"largest element (bounds {CT_MOMENT_RTOL}); queue within {q_err:.3g} (bound "
        f"{CT_QUEUE_ATOL}); pointer {s_d.queue_ptr}, step {s_d.step} on both")
    del s_c

    # the queue term switches on at queue_start_steps
    dbatch = tuple(torch.as_tensor(x, device=dev) for x in batch)

    def two_losses(st):
        out = []
        for _ in range(2):
            st, loss, _ = step(st, *dbatch)
            out.append(float(loss))
        return out

    on = two_losses(dataclasses.replace(s_d, step=cfg.queue_start_steps - 1))
    off = two_losses(dataclasses.replace(s_d, step=0))
    if not (abs(on[0] - off[0]) <= 1e-6 * abs(off[0]) and on[1] > off[1]):
        fail(f"phase 20: queue activation: losses {on} with it at the second step, "
             f"{off} without")
    log(f"phase 20: from step {cfg.queue_start_steps - 1}, the queue term switches on "
        f"at the second step: losses {on[0]:.6f}, {on[1]:.6f} against {off[0]:.6f}, "
        f"{off[1]:.6f} without it (equal, then higher, as test_queue_activation_raises_loss "
        f"expects)")

    # a bfloat16 step from the same state
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    s_b, l_b, n_b = make_train_step(bcfg, feat)(state_to(init, dev), *dbatch)
    l_b, n_b = float(l_b), float(n_b)
    finite = all(bool(torch.isfinite(t).all()) for t in _leaves(s_b.params_q))
    if not (np.isfinite(l_b) and np.isfinite(n_b) and finite
            and s_b.queue.dtype == torch.float32 and bool(torch.isfinite(s_b.queue).all())):
        fail(f"phase 20: the bfloat16 step: loss {l_b}, grad norm {n_b}, params finite "
             f"{finite}, queue {s_b.queue.dtype}")
    log(f"phase 20: a bfloat16 step: loss {l_b:.6f} ({abs(l_b - l_d) / l_d:.3g} of the "
        f"f32 step's from the same state), grad norm {n_b:.6f}; finite, the queue float32")
    del s_b

    # timed steps: bench_train.py's 30 after warm-ups, on pre-staged batches
    st = s_d
    for _ in range(CT_WARMUP):
        st, loss, _ = step(st, *dbatch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    for _ in range(CT_TIMED_STEPS):
        st, loss, norm = step(st, *dbatch)
    e1.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dev_ms = e0.elapsed_time(e1) / CT_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (np.isfinite(float(loss)) and np.isfinite(float(norm))):
        fail(f"phase 20: timed steps end at loss {float(loss)}, grad norm {float(norm)}")
    st, launches, idle, top = profile_steps(step, st, dbatch, CT_PROFILED_STEPS)
    # the work a step needs: 4 passes of 2 x 2 FLOP a weight and token through
    # the BiLSTM and the projection (q and k forward, q backward twice), the
    # loss's products, at the f32 rate
    tokens = cfg.accum_steps * cfg.micro_batch * fcfg.max_len
    lstm_weights = sum(t.numel() for name, t in named_leaves(init.params_q)
                       if name.endswith(("w_ih", "w_hh", "proj_w")))
    flops = 4 * 2 * tokens * lstm_weights
    bound_ms = 1e3 * flops / F32_FLOPS
    log(f"phase 20: {CT_TIMED_STEPS} steps after {CT_WARMUP} warm-ups: "
        f"{CT_TIMED_STEPS / dt:.2f} steps/s ({CT_TIMED_STEPS / dt * tokens / fcfg.max_len:.0f}"
        f" pairs/s), {dev_ms:.2f} ms of device time a step (CUDA events), peak "
        f"{peak:.2f} GiB; the step's {flops / 1e12:.3f} TFLOP at the f32 rate: "
        f"{bound_ms:.2f} ms")
    if launches is None:
        log("phase 20: torch.profiler saw no device work: launches and idle share not "
            "measured")
    else:
        log(f"phase 20: torch.profiler over {CT_PROFILED_STEPS} steps: {launches:.0f} "
            f"CUDA kernel launches a step, device idle share {idle:.3f}; ms a step by "
            f"kernel: " + "; ".join(f"{k[:60]} {v:.2f}" for k, v in top.items()))
    first = sum(contrastive_stage_split(cfg, feat, st, dbatch).values())
    split = contrastive_stage_split(cfg, feat, st, dbatch)
    log(f"phase 20: one step by stage (CUDA events, ms; the second of two): " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()) + f"; sum {sum(split.values()):.2f} "
        f"(the first: {first:.2f})")
    return feat, dict(steps_per_s=CT_TIMED_STEPS / dt, device_ms=dev_ms, peak_gib=peak,
                      launches=launches, idle=idle)


def phase21_contrastive_trainer(dev, feat, tmpdir):
    """bench_train.py --e2e: ContrastiveTrainer over 2,000 synthetic docs with
    augment pairs, timed; its checkpoint round trip and resume; stage 2 from
    the trained state; then ProtoNCE at the reference's granularities over
    20,000 docs with two k-means refreshes on the card."""
    import dataclasses

    import torch

    from ircl_tpu_torch.contrastive.cluster import run_kmeans
    from ircl_tpu_torch.contrastive.state import TrainConfig, init_train_state
    from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
    from ircl_tpu_torch.corpus.synthetic import generate
    from ircl_tpu_torch.data.pairs import DocPairSampler
    from ircl_tpu_torch.dense.embed import embed_corpus
    from ircl_tpu_torch.pipeline.dense_scorer import ContrastiveSentenceScorer
    from ircl_tpu_torch.pipeline.intrinsic import mean_claim_evidence_cosine
    from ircl_tpu_torch.utils.checkpoint import latest_checkpoint, restore_state, save_state

    cfg = TrainConfig(**CT_TRAIN)
    t0 = time.perf_counter()
    # the docs come first from the generator, so they are num_claims=1's
    wiki = generate(num_docs=CT_E2E_DOCS, num_claims=CT_E2E_CLAIMS, seed=11)
    docs = list(wiki.sentences.values())
    kw = dict(ckptdir=os.path.join(tmpdir, "ct_ckpt"), logdir=os.path.join(tmpdir, "ct_log"),
              device=dev)
    tr = ContrastiveTrainer(cfg, feat, DocPairSampler(docs, sample="augment", seed=7), **kw)
    tr.train(total_steps=CT_E2E_WARMUP, log_step=10**9)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = tr.train(total_steps=CT_E2E_WARMUP + CT_E2E_STEPS, log_step=10**9)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(t).all()) for t in _leaves(state.params_q))
    if state.step != CT_E2E_WARMUP + CT_E2E_STEPS or not finite:
        fail(f"phase 21: the trainer ended at step {state.step}, params finite {finite}")
    e2e_sps = CT_E2E_STEPS / dt
    # the trainer's step alone, at once after, on the sampler's next batches
    # staged on the card: what the trainer's host work adds is the gap
    staged = [tuple(torch.as_tensor(x, device=dev) for x in b[1:])
              for b in tr.sampler.batches(feat, cfg.accum_steps, cfg.micro_batch,
                                          CT_STAGED_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = state
    for b in staged:
        st, _, _ = tr.step_fn(st, *b)
    torch.cuda.synchronize()
    staged_sps = CT_STAGED_STEPS / (time.perf_counter() - t0)
    del st, staged
    log(f"phase 21: ContrastiveTrainer over {len(docs)} docs (augment pairs): "
        f"{CT_E2E_WARMUP} warm-up steps in {warm_s:.1f} s (corpus and trainer built), "
        f"then {CT_E2E_STEPS} steps in {dt:.1f} s: {e2e_sps:.2f} steps/s, host pair "
        f"sampling and tokenization included; the same step on {CT_STAGED_STEPS} of "
        f"the sampler's batches staged on the card at once after: {staged_sps:.2f} "
        f"steps/s (the trainer's host work: {1 - e2e_sps / staged_sps:.3f} of its time)")

    # checkpoint: save, find, restore into a fresh state, resume
    path = save_state(kw["ckptdir"], tr.tag, state)
    if latest_checkpoint(kw["ckptdir"], tr.tag) != path:
        fail(f"phase 21: latest_checkpoint does not find {path}")
    back = restore_state(path, init_train_state(1, cfg, device=dev))
    for (name, a), (_, b) in zip(named_leaves(vars(back)), named_leaves(vars(state))):
        same = torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b
        if not same or (isinstance(b, torch.Tensor) and a.device != b.device):
            fail(f"phase 21: the restored {name} differs")
    fresh = ContrastiveTrainer(cfg, feat, DocPairSampler(docs, sample="augment"), **kw)
    if fresh.maybe_resume() != state.step:
        fail(f"phase 21: maybe_resume returned {fresh.state.step}, not {state.step}")
    log(f"phase 21: checkpoint {os.path.basename(path)} ({os.path.getsize(path) / 2**20:.1f}"
        f" MiB) restored bit for bit; a fresh trainer resumes at step {state.step}")
    del fresh, back

    # stage 2 from the trained state, against the untrained one
    for label, st in (("trained", state), ("untrained", init_train_state(1337, cfg, device=dev))):
        scorer = ContrastiveSentenceScorer(cfg, feat, st, batch_size=ENC_BATCH)
        res = mean_claim_evidence_cosine(scorer.embed, wiki.claims, wiki.sentences)
        log(f"phase 21: stage 2 from the {label} state: mean claim/evidence cosine "
            f"{res['mean_cosine']:.4f} over {res['pairs']} pairs, shuffled control "
            f"{res['shuffled_cosine']:.4f} (reported, not gated)")
    del tr, state

    # ProtoNCE at the reference's granularities, refreshed twice on the card
    t0 = time.perf_counter()
    pwiki = generate(num_docs=CT_PROTO_DOCS, num_claims=1, seed=11)
    pdocs = list(pwiki.sentences.values())
    pcfg = dataclasses.replace(cfg, loss="ProtoNCE", cluster_start_steps=0,
                               cluster_update_steps=CT_PROTO_EVERY)
    pkw = dict(kw, ckptdir=os.path.join(tmpdir, "ct_ckpt_proto"))
    ptr = ContrastiveTrainer(pcfg, feat, DocPairSampler(pdocs, sample="augment", seed=7),
                             **pkw)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pstate = ptr.train(total_steps=CT_PROTO_STEPS, log_step=CT_PROTO_LOG)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = [r["train_loss"] for r in map(json.loads, open(ptr.metrics.path))
              if "train_loss" in r]
    cr = ptr.cluster_result
    bad = []
    for g, (c, d, a) in enumerate(zip(cr.centroids, cr.density, cr.emb2cluster)):
        norms = torch.linalg.vector_norm(c, dim=1)
        if c.shape[0] != pcfg.num_clusters[g] or a.shape[0] != len(pdocs):
            bad.append(f"granularity {g}: shapes {tuple(c.shape)}, {tuple(a.shape)}")
        if float((norms - 1).abs().max()) > 1e-5:
            bad.append(f"granularity {g}: centroid norms off by {float((norms - 1).abs().max())}")
        if not bool(torch.isfinite(d).all()) or not bool((d > 0).all()) or (
                abs(float(d.mean()) - pcfg.temperature) > 1e-5):
            bad.append(f"granularity {g}: densities mean {float(d.mean())}")
    if (pstate.step != CT_PROTO_STEPS or ptr.refresh_count != 2
            or len(losses) != CT_PROTO_STEPS // CT_PROTO_LOG
            or not np.isfinite(losses).all() or bad):
        fail(f"phase 21: ProtoNCE: step {pstate.step}, refreshes {ptr.refresh_count}, "
             f"losses {losses}, {bad}")
    # one refresh's split, timed again on the trained state
    texts = [doc[0] if doc else "" for doc in ptr.sampler.docs]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    emb = embed_corpus(ptr.embed_fn, pstate.params_q, feat, texts)
    t2 = time.perf_counter()
    run_kmeans(emb, pcfg.num_clusters, pcfg.temperature, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"phase 21: ProtoNCE over {len(pdocs)} docs at num_clusters "
        f"{pcfg.num_clusters}, {pcfg.num_neg_proto} negative prototypes: "
        f"{CT_PROTO_STEPS} steps in {dt:.1f} s (set-up {setup_s:.1f} s) with "
        f"{ptr.refresh_count} refreshes, refresh_seconds {ptr.refresh_seconds:.2f}; "
        f"losses every {CT_PROTO_LOG} steps {', '.join(f'{x:.3f}' for x in losses)}; "
        f"centroids of unit norm, densities finite, positive, mean {pcfg.temperature} "
        f"within 1e-5")
    log(f"phase 21: one refresh again: embed {len(texts)} docs {t2 - t1:.2f} s, "
        f"run_kmeans {t3 - t2:.2f} s ({(t3 - t2) / (t3 - t1):.3f} of the refresh)")
    return e2e_sps, staged_sps, ptr.refresh_seconds


def named_leaves(tree, prefix=""):
    """(path, leaf) in ``utils/tree.py``'s order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


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

    from ircl_tpu_torch.corpus.hashing import native_available
    from ircl_tpu_torch.corpus.store import MemoryDocStore
    from ircl_tpu_torch.corpus.synthetic import generate
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
    t_sparse = time.perf_counter()
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

    results["membership_slab_windowed"] = compare_slabs(
        "phase 2", "membership_slab_windowed", membership_slab_windowed, slab_cases)
    shared_buffer_check("phase 2", u_pad, ranker)
    slab_edge_cases(dev)

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
        # one compare a row and column, one add a pool entry, at one a lane
        # and cycle
        **least_time((h_t, sd, sv, s1, i1), h_t.numel() + sd.numel(), F32_FLOPS / 2),
        library_ms=None,
    )
    log(f"phase 2: light_add_topk_t H_T={tuple(h_t.shape)} P={sd.shape[0]} "
        f"d_tile={d_lt}: scores within rtol 1e-6 ({int((i1 != i2).sum())} "
        f"ids differ, all at ties); kernel {results['light_add_topk_t']['ms']:.3f}"
        f" ms, plain {results['light_add_topk_t']['plain_ms']:.3f} ms")
    light_add_edge_cases(dev)
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
    results["membership_slab"] = compare_slabs("phase 2", "membership_slab",
                                               membership_slab, {
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
    splits = []
    for _ in range(2):  # the second batch reuses the first one's buffers
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
        splits.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
        if len(splits) == 1:
            del m, wt, h_t, ts, ti, top_s, top_pos
    first, ms = splits[0][0], splits[1]
    log(f"phase 5: split of one batch: host vectorize + pool gather "
        f"{host_ms:.2f} ms, upload {upload_ms:.2f} ms, slabs {ms[0]:.3f} ms (the "
        f"first batch, which allocates the buffers: {first:.3f} ms), GEMM "
        f"{ms[1]:.3f} ms, light-add + top-k {ms[2]:.3f} ms")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phases 1-5: {time.perf_counter() - t_sparse:.1f} s")
    del ranker, m, wt, h_t, ts, ti, top_s, top_pos, u_pad, qb_t, qw_t, ld, lc
    torch.cuda.empty_cache()

    # ---- phase 6: kernel #4 against its plain version ----------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)  # bench_dense.py's data, in its order
    dense_corpus = unit_rows(rng, DENSE_M, DENSE_D)
    dense_queries = unit_rows(rng, DENSE_B, DENSE_D)
    from ircl_tpu_torch.ops.dense_topk_cuda import chunk_max, pad_corpus_t

    q_d = torch.tensor(dense_queries, device=dev)
    ct_d, m_real = pad_corpus_t(torch.tensor(dense_corpus, device=dev), DENSE_TILE)
    rows_d = ct_d.T.contiguous()  # [M_pad, D] f32 rescore rows
    phase6_dense_kernel(dev, q_d, ct_d, rows_d, m_real, results)
    log(f"phase 6: {time.perf_counter() - t_phase:.1f} s")

    # ---- the dense path: phases 7-9, with fresh launch counts --------------
    kernels["cosine_topk_fused"] = chunk_max  # launches kernel #4
    for fn in kernels.values():
        fn.launches = 0
    chunk_max.launches_by_route = {"mma": 0, "simt": 0}

    # ---- phase 7: bench_dense.py's configuration ---------------------------
    t_phase = time.perf_counter()
    dense_ref = phase7_dense_bench(dev, dense_queries, dense_corpus, q_d, ct_d,
                                   rows_d, m_real)
    del q_d, ct_d, rows_d
    torch.cuda.empty_cache()
    log(f"phase 7: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 8: the encoder at full width --------------------------------
    t_phase = time.perf_counter()
    enc_docs = store.get_doc_ids()[:ENC_DOCS]
    tcfg, feat, enc_state, doc_sentences, table = phase8_encoder(dev, wiki, enc_docs)
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 9: served sentence search -----------------------------------
    t_phase = time.perf_counter()
    index_path, pre, mine = phase9_sentence_search(
        dev, store, wiki, claims, enc_docs, tcfg, feat, enc_state, doc_sentences,
        table, tmp.name)
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    if chunk_max.launches == 0:
        fail("cosine_topk_fused was not launched on the dense path")
    launches["cosine_topk_fused"] = chunk_max.launches
    dense_routes = dict(chunk_max.launches_by_route)
    if dense_routes["mma"] == 0:
        fail("the dense path did not launch the tensor-core chunk-max kernel")
    log(f"phases 7-9: kernel launches {{'cosine_topk_fused': {chunk_max.launches}}}, "
        f"by route {dense_routes}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(phases 7-9)")
    del table, enc_state
    torch.cuda.empty_cache()

    # ---- phase 10: kernel #6a against its plain version --------------------
    from ircl_tpu_torch.ops.flash_attention_cuda import flash_attention

    t_phase = time.perf_counter()
    vtok = feat.tokenizer  # the WordPiece vocab trained on phase 8's docs
    pairs = verdict_pairs(wiki, enc_docs, mine, 256)
    phase10_flash_kernel(dev, vtok, pairs, results)
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")

    # ---- the verdict path: phases 11-12, with fresh launch counts ----------
    kernels["flash_attention"] = flash_attention
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 11: the verdict classifier at full width --------------------
    t_phase = time.perf_counter()
    vcfg, vparams = phase11_verdict(dev, vtok, pairs)
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 12: served claim verification -------------------------------
    t_phase = time.perf_counter()
    phase12_verdict_service(dev, vtok, vcfg, vparams, index_path, doc_sentences, pre,
                            mine, tmp.name)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    if flash_attention.launches == 0:
        fail("flash_attention was not launched on the verdict path")
    launches["flash_attention"] = flash_attention.launches
    log(f"phases 11-12: kernel launches {{'flash_attention': "
        f"{flash_attention.launches}}}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(phases 11-12)")
    del vparams
    torch.cuda.empty_cache()

    # ---- phase 13: kernels #6b and #6c against their plain version ---------
    from ircl_tpu_torch.ops.flash_attention_cuda import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    t_phase = time.perf_counter()
    phase13_flash_backward(dev, vtok, pairs, results)
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")

    # ---- the training path: phases 14-15, with fresh launch counts ---------
    kernels["flash_attention_bwd_dkv"] = flash_attention_bwd_dkv
    kernels["flash_attention_bwd_dq"] = flash_attention_bwd_dq
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 14: the train step at full width ----------------------------
    t_phase = time.perf_counter()
    train_cfg = phase14_train_step(dev, vtok, pairs)
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 15: the trainer end to end ----------------------------------
    t_phase = time.perf_counter()
    phase15_trainer(dev, vtok, train_cfg, pairs, tmp.name)
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    train_launches = {
        name: kernels[name].launches
        for name in ("flash_attention", "flash_attention_bwd_dkv",
                     "flash_attention_bwd_dq")
    }
    for name, count in train_launches.items():
        if count == 0:
            fail(f"{name} was not launched on the training path")
    launches["flash_attention_bwd_dkv"] = train_launches["flash_attention_bwd_dkv"]
    launches["flash_attention_bwd_dq"] = train_launches["flash_attention_bwd_dq"]
    log(f"phases 14-15: kernel launches {train_launches}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(phases 14-15)")
    torch.cuda.empty_cache()

    # ---- phase 16: kernels #7 and #8, against plain versions and driven ----
    t_phase = time.perf_counter()
    phase16_probe_kernels(dev, index, claims, dense_queries, dense_corpus, dense_ref,
                          results, launches)
    for name in ("fused_dot_light_topk", "chunk_max_presplit"):
        if launches[name] == 0:
            fail(f"{name} was not launched on its path")
    del dense_corpus, dense_ref
    torch.cuda.empty_cache()
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")

    # ---- the scale path: phases 17-19, with fresh launch counts ------------
    from ircl_tpu_torch.ops.fused_hybrid_cuda import fused_hybrid_tile_topk

    kernels["fused_hybrid_tile_topk"] = fused_hybrid_tile_topk
    for fn in kernels.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    s_index, s_qb, s_qw, cpu_results, s_ranker, s_dev_in, s_staged = phase17_scale(
        dev, results)
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase18_onepass(dev, s_ranker, cpu_results, s_dev_in, s_staged, results)
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    del s_ranker, s_dev_in
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    phase19_chunked(dev, s_index, s_qb, s_qw, s_staged, cpu_results)
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    scale_launches = {
        name: kernels[name].launches
        for name in ("membership_slab_windowed", "fused_hybrid_tile_topk")
    }
    for name, count in scale_launches.items():
        if count == 0:
            fail(f"{name} was not launched on the scale path")
    launches["fused_hybrid_tile_topk"] = scale_launches["fused_hybrid_tile_topk"]
    log(f"phases 17-19: kernel launches {scale_launches}")

    # ---- the contrastive training path: phases 20-21 -------------------------
    # no kernel of the kernels line lies on it: every count must stay at 0
    from ircl_tpu_torch.ops.dense_topk_cuda import chunk_max_presplit
    from ircl_tpu_torch.ops.fused_dot_light_cuda import fused_dot_light_topk

    counted = dict(kernels, fused_dot_light_topk=fused_dot_light_topk,
                   chunk_max_presplit=chunk_max_presplit)
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    ct_feat, ct = phase20_contrastive_step(dev)
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    e2e_sps, staged_sps, refresh_s = phase21_contrastive_trainer(dev, ct_feat, tmp.name)
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    moved = {name: fn.launches for name, fn in counted.items() if fn.launches}
    if moved:
        fail(f"kernels of the kernels line launched on the training path: {moved}")
    launches_txt = "not measured" if ct["launches"] is None else f"{ct['launches']:.0f}"
    log(f"phases 20-21: steps/s {ct['steps_per_s']:.2f} (device {ct['device_ms']:.2f} ms "
        f"a step, {launches_txt} launches a step, peak {ct['peak_gib']:.2f} GiB), e2e "
        f"steps/s {e2e_sps:.2f} (staged {staged_sps:.2f}), refresh_seconds "
        f"{refresh_s:.2f}; no kernel of the "
        f"kernels line launched")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(phases 20-21)")
    del ct_feat

    tmp.cleanup()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu"))
    if loaded:
        fail(f"JAX or the JAX package was imported: {loaded}")

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
        "cosine_topk_fused": (
            "ircl_tpu_torch/csrc/dense_cmax.cu",
            "ircl_tpu/ops/dense_topk_pallas.py:59",
        ),
        "flash_attention": (
            "ircl_tpu_torch/csrc/flash_attention.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:331",
        ),
        "flash_attention_bwd_dkv": (
            "ircl_tpu_torch/csrc/flash_attention_bwd.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:796",
        ),
        "flash_attention_bwd_dq": (
            "ircl_tpu_torch/csrc/flash_attention_bwd.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1146",
        ),
        "fused_hybrid_tile_topk": (
            "ircl_tpu_torch/csrc/fused_hybrid.cu",
            "ircl_tpu/ops/fused_hybrid_pallas.py:35",
        ),
        "fused_dot_light_topk": (
            "ircl_tpu_torch/csrc/fused_dot_light.cu",
            "scripts/probe_fused_dot_light.py:135",
        ),
        "chunk_max_presplit": (
            "ircl_tpu_torch/csrc/dense_cmax.cu",
            "scripts/probe_dense_presplit.py:35",
        ),
    }
    report = []
    for name, (src, replaces) in sources.items():
        report.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], **results[name],
        ))
        if name == "cosine_topk_fused":  # the dense path's launches, by kernel
            report[-1]["launches_by_route"] = dense_routes
        if name == "flash_attention":  # it also runs on the training path
            report[-1]["launches_training_path"] = train_launches[name]
        if name == "membership_slab_windowed":  # and on the scale path
            report[-1]["launches_scale_path"] = scale_launches[name]
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
