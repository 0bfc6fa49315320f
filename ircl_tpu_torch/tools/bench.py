"""Judged sparse retrieval benchmark: queries/s per card at full-batch parity.

    python3 -m ircl_tpu_torch.tools.bench [--d-tile N] [--df-threshold 24]
        [--claims 4096] [--union-round 512] [--select-rescore 0]
        [--trace DIR] [--device cpu]
    python3 -m ircl_tpu_torch.cli bench      # the same run at the defaults

The port of the root ``bench.py``, with its configuration, its flags and its
order of work: 50,000 synthetic docs from ``generate(seed=11)``, bigrams
hashed into 2^24 buckets, 4096 claims through the judged hybrid ranker
(two width buckets, ``fixed_union_cap`` 4096, ``fixed_max_terms`` 64,
exact fp32 scores), every claim's sorted top-5 scores held to scipy's at
rtol 1e-4, then rounds of 10 pipelined batches until the throughput
plateaus. The baseline is the reference pipeline's per-query scipy CSR
matvec + argpartition top-k on the host.

Prints ONE JSON line on stdout, the reference's:

    {"metric": "sparse_tfidf_retrieval_qps_per_chip", "value": best q/s,
     "unit": "queries/s", "vs_baseline": ratio, "median": q/s, "rounds": n}

then single-batch latency lines at B=4096, 512 and 128 on stderr, within
``IRCL_BENCH_LAT_BUDGET`` seconds (600). A round is wall time from a
synchronized start to the host read of its last batch's top-k, host
included; on the card each round also logs its device time (CUDA events
around each batch's device half) and the busy share that follows.

As in the reference, the work runs on a worker thread while the main thread
waits, so that SIGTERM, SIGINT and ``IRCL_BENCH_DEADLINE``'s SIGALRM always
print the best line so far. Unlike the reference, no failure exits 0: a
parity failure, a worker exception or a signal before a gated line prints
the reference's ``note`` line and exits 1, and a failed latency probe or
``--trace`` exits 1 after the judged line. Exit 0 means a parity-gated value
was printed. The reference's TPU workarounds (backend probe, compilation
cache, cold-cache fallback to a smaller batch) have no counterpart: the
kernels build once, at first use. Runs on the card unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.index.build import build_count_index, to_scipy
from ircl_tpu_torch.index.ranker import TfidfRanker, vectorize_queries
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.utils.device import resolve_device

METRIC = "sparse_tfidf_retrieval_qps_per_chip"
NUM_DOCS = 50_000
NUM_CLAIMS = 4096
HASH_SIZE = 1 << 24  # reference default (build_tfidf.py hash-size 2^24)
K = 5
REPS = 10  # batches in flight a round
MAX_ROUNDS = 16
PLATEAU_MIN_ROUNDS = 6
PARITY_RTOL = 1e-4
CPU_BASELINE_CLAIMS = 128
LATENCY_CALLS, LATENCY_BURN_IN = 20, 2


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class BenchFailure(RuntimeError):
    """The run failed after printing its line (the parity gate)."""


class _State:
    """Best-so-far shared between the worker and the signal handlers."""

    def __init__(self):
        self.lock = threading.RLock()  # a handler may interrupt an emit
        self.cpu_qps = 0.0
        self.parity_ok = False
        self.best_qps = 0.0
        self.rounds: list[float] = []
        self.phase = "startup"
        self.printed = False
        self.line: dict | None = None
        self.done = threading.Event()

    @property
    def gated(self) -> bool:
        """Whether the line is (or would be) a parity-gated value."""
        return self.parity_ok and self.best_qps > 0

    def emit(self, note: str | None = None) -> dict | None:
        """Print the single judged JSON line (idempotent); the line, or
        None where it was printed before."""
        with self.lock:
            if self.printed:
                return None
            self.printed = True
            if self.gated:
                line = {
                    "metric": METRIC,
                    "value": round(self.best_qps, 1),
                    "unit": "queries/s",
                    "vs_baseline": (
                        round(self.best_qps / self.cpu_qps, 2)
                        if self.cpu_qps
                        else None
                    ),
                }
                # value is best-of; the median is the expected throughput
                if self.rounds:
                    line["median"] = round(float(np.median(self.rounds)), 1)
                    line["rounds"] = len(self.rounds)
            else:
                # no parity-gated number: the CPU baseline, with the phase
                line = {
                    "metric": METRIC,
                    "value": round(self.cpu_qps, 1),
                    "unit": "queries/s",
                    "vs_baseline": 1.0 if self.cpu_qps else None,
                    "note": f"incomplete at phase={self.phase}"
                    + (f": {note}" if note else ""),
                }
            if note and "note" not in line:
                line["note"] = note
            self.line = line
            print(json.dumps(line), flush=True)
            return line


@dataclass
class JudgedRun:
    """What ``run_judged`` measured. ``scipy_top``: each claim's scipy top-k
    scores; ``latency``: {B: (p50 ms, p95 ms)}; ``failures``: what failed
    after the judged line (latency probe, trace)."""

    line: dict
    scipy_top: list
    rounds: list
    ranker: TfidfRanker
    latency: dict = field(default_factory=dict)
    failures: list = field(default_factory=list)


def build(num_docs: int, num_claims: int, state: _State | None = None):
    """The corpus and tf-idf index of ``bench.py:154-175``: (index, claims)."""
    state = state or _State()
    state.phase = "corpus_gen"
    t0 = time.perf_counter()
    wiki = generate(num_docs=num_docs, num_claims=num_claims, seed=11)
    claims = [c.claim for c in wiki.claims]
    log(f"corpus generated in {time.perf_counter()-t0:.1f}s")

    state.phase = "index_build"
    t0 = time.perf_counter()
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    log(f"index built in {time.perf_counter()-t0:.1f}s: {index.num_docs} docs, "
        f"{index.nnz} postings")
    return index, claims


def plateau(rounds: list[float]) -> bool:
    """``bench.py:300-303``: converged once at least 6 rounds ran and the
    last 3 are within 3% of the best seen."""
    best = max(rounds)
    return len(rounds) >= PLATEAU_MIN_ROUNDS and all(
        q >= 0.97 * best for q in rounds[-3:])


def run_rounds(one_round, state: _State, max_rounds: int = MAX_ROUNDS) -> list[float]:
    """Calls ``one_round(r)`` (its q/s) until ``plateau`` or ``max_rounds``."""
    rounds = []
    for r in range(max_rounds):
        qps = one_round(r)
        rounds.append(qps)
        with state.lock:
            state.rounds.append(qps)
            state.best_qps = max(state.best_qps, qps)
        if plateau(rounds):
            log(f"plateau after {r + 1} rounds")
            break
    return rounds


def dispatch(ranker: TfidfRanker, claims):
    """One batch as ``TfidfRanker._closest_hybrid_async`` runs it: the host
    half, then the device half, bracketed by CUDA events on the card.
    ``(pending, events)``; events None on another device."""
    buckets, weights = ranker._vectorize(claims)
    host = ranker.hybrid_host_inputs(buckets, weights)
    if ranker.device.type != "cuda":
        return ranker.hybrid_from_host_async(host, K), None
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    pending = ranker.hybrid_from_host_async(host, K)
    end.record()
    return pending, (start, end)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cpu_baseline(index, claims, state: _State):
    """The reference pipeline on the host (``bench.py:198-229``): per-query
    scipy CSR matvec + argpartition top-k. Times the first 128 claims into
    ``state.cpu_qps``; every claim's (ids, scores)."""
    import scipy.sparse as sp

    mat = to_scipy(index)  # (H x N) CSR
    buckets, weights = vectorize_queries(
        claims, index.hash_size, index.ngram, index.doc_freqs, index.num_docs
    )

    def cpu_closest(b):
        nz = weights[b] != 0
        spvec = sp.csr_matrix(
            (weights[b][nz], buckets[b][nz], [0, int(nz.sum())]),
            shape=(1, index.hash_size),
        )
        res = spvec * mat
        if len(res.data) <= K:
            o = np.argsort(-res.data)
        else:
            o = np.argpartition(-res.data, K)[:K]
            o = o[np.argsort(-res.data[o])]
        return res.indices[o], res.data[o]

    n_cpu = min(CPU_BASELINE_CLAIMS, len(claims))
    t0 = time.perf_counter()
    refs = [cpu_closest(b) for b in range(n_cpu)]
    state.cpu_qps = n_cpu / (time.perf_counter() - t0)
    log(f"cpu baseline: {state.cpu_qps:.1f} q/s")
    # the full-batch parity reference, while the first batch runs
    t0 = time.perf_counter()
    refs += [cpu_closest(b) for b in range(n_cpu, len(claims))]
    log(f"full-batch scipy reference in {time.perf_counter()-t0:.1f}s")
    return refs


def parity_mismatches(results, refs) -> int:
    """``bench.py:246-264``: claims whose sorted top-k scores differ from
    scipy's beyond rtol 1e-4 (over the shorter of the two lists)."""
    mismatches = 0
    for (got_ids, got_scores), (ref_ids, ref_scores) in zip(results, refs):
        n = min(len(ref_ids), len(got_ids))
        if not np.allclose(
            np.sort(ref_scores[:n]), np.sort(got_scores[:n]), rtol=PARITY_RTOL
        ):
            mismatches += 1
    return mismatches


def _trace(ranker, claims, path: str) -> None:
    """One ``torch.profiler`` trace of 2 batches into ``path``/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if ranker.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        pending = [dispatch(ranker, claims)[0] for _ in range(2)]
        pending[-1][0].cpu()
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "trace.json")
    prof.export_chrome_trace(out)
    log(f"profiler trace written to {out}")


def _latency(ranker, claims, device, budget: float) -> dict:
    """Single-batch round trips at B = all claims, 512 and 128 (those not
    above the batch), after 2 burn-in calls a size; {B: (p50, p95) ms}."""
    out = {}
    t_lat = time.perf_counter()
    for B in dict.fromkeys((len(claims), 512, 128)):
        if B > len(claims):
            continue
        if B != len(claims) and time.perf_counter() - t_lat > budget:
            log(f"latency B={B}: {budget:.0f}s budget spent, skipping")
            continue
        sub = claims[:B]
        for _ in range(LATENCY_BURN_IN):
            dispatch(ranker, sub)[0][0].cpu()
        lat = []
        for _ in range(LATENCY_CALLS):
            _sync(device)
            t0 = time.perf_counter()
            dispatch(ranker, sub)[0][0].cpu()
            lat.append(time.perf_counter() - t0)
        lat = np.sort(np.array(lat))
        out[B] = (lat[len(lat) // 2] * 1e3, lat[int(len(lat) * 0.95)] * 1e3)
        log(f"single-batch latency (B={B}): p50 {out[B][0]:.1f} ms, "
            f"p95 {out[B][1]:.1f} ms")
    return out


def run_judged(index, claims, *, d_tile=None, df_threshold=24, union_round=512,
               select_rescore=0, trace=None, device=None, state=None) -> JudgedRun:
    """The bench's worker body (``bench.py:176-346``) on a built index.

    Prints the judged line (``state.emit``) after the plateau and returns
    what was measured. Raises ``BenchFailure`` after printing the line where
    the parity gate fails.
    """
    device = resolve_device(device)
    state = state or _State()
    n = len(claims)

    # the first batch is dispatched first; the host reference runs beside it
    state.phase = "first_batch"
    t0 = time.perf_counter()
    ranker = TfidfRanker(
        index, device, mode="hybrid", df_threshold=df_threshold, width_buckets=2,
        fixed_union_cap=4096, fixed_max_terms=64, precision="high",
        d_tile=d_tile, union_round=union_round, select_rescore=select_rescore,
    )
    log(f"ranker built in {time.perf_counter()-t0:.1f}s (d_tile {ranker.d_tile})")
    t_first = time.perf_counter()
    pending_first, _ = dispatch(ranker, claims)
    refs = cpu_baseline(index, claims, state)
    results = ranker.finalize_closest(pending_first, n)
    log(f"{device.type} first batch in {time.perf_counter()-t_first:.1f}s "
        "(the host reference beside it)")

    state.phase = "parity"
    mismatches = parity_mismatches(results, refs)
    log(f"parity: {n - mismatches}/{n} queries match")
    if mismatches:
        note = f"top-k parity failed on {mismatches} queries"
        state.emit(note)
        raise BenchFailure(note)
    state.parity_ok = True
    failures = []

    state.phase = "steady_state"
    if trace:  # one traced pair of batches, excluded from timing
        try:
            _trace(ranker, claims, trace)
        except Exception as e:  # noqa: BLE001 — reported after the line
            log(f"profiler trace failed: {e!r}")
            failures.append(f"trace: {e!r}")

    def one_round(r):
        _sync(device)
        t0 = time.perf_counter()
        batches = [dispatch(ranker, claims) for _ in range(REPS)]
        batches[-1][0][0].cpu()  # the host read of the last batch's top-k
        wall = time.perf_counter() - t0
        qps = REPS * n / wall
        if device.type == "cuda":
            _sync(device)
            busy = sum(s.elapsed_time(e) for _, (s, e) in batches)
            log(f"steady-state round {r}: {qps:.1f} q/s; device {busy:.1f} of "
                f"{wall * 1e3:.1f} ms, busy share {busy / (wall * 1e3):.3f}")
        else:
            log(f"steady-state round {r}: {qps:.1f} q/s")
        return qps

    rounds = run_rounds(one_round, state, MAX_ROUNDS)
    state.emit()  # the judged line first; the rest is stderr diagnostics

    state.phase = "latency"
    latency = {}
    try:
        latency = _latency(ranker, claims, device,
                           float(os.environ.get("IRCL_BENCH_LAT_BUDGET", "600")))
    except Exception as e:  # noqa: BLE001 — reported after the line
        log(f"latency probe failed: {e!r}")
        failures.append(f"latency: {e!r}")
    return JudgedRun(state.line, [s for _, s in refs], rounds, ranker, latency,
                     failures)


def describe_device(device: torch.device) -> None:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        log(f"device {device}")
        return
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e!r}"
    log(f"device {torch.cuda.get_device_name(device)}; nvidia-smi: {smi}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # None = the ranker's resolution (1024 below the fused engine's gate)
    ap.add_argument("--d-tile", type=int, default=None)
    ap.add_argument("--df-threshold", type=int, default=24)
    ap.add_argument("--claims", type=int, default=NUM_CLAIMS)
    # union width: ceil to a 512-multiple (None: pow2 padding)
    ap.add_argument("--union-round", type=int, default=512)
    # >0: the staged engine with a bf16 selection + exact rescore of that
    # many candidates a query; the parity gate certifies (or fails) the run
    ap.add_argument("--select-rescore", type=int, default=0)
    ap.add_argument(
        "--trace", type=str, default=None,
        help="write a torch.profiler trace of 2 batches (untimed) into this dir",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """The bench in a worker thread; 0 only where a parity-gated line was
    printed and nothing failed after it."""
    args = parse_args(argv)
    device = resolve_device(args.device)  # no card: raises before any work
    state = _State()
    outcome: dict = {}

    def salvage(signum, frame):  # noqa: ARG001 — signal handler signature
        log(f"signal {signum} at phase={state.phase}: emitting best-so-far")
        state.emit(f"killed by signal {signum}")
        os._exit(0 if state.gated else 1)

    handled = (signal.SIGTERM, signal.SIGINT, signal.SIGALRM)
    previous = {s: signal.signal(s, salvage) for s in handled}
    # Optional self-deadline (seconds): emit and exit before an external
    # timeout would SIGKILL.
    deadline = float(os.environ.get("IRCL_BENCH_DEADLINE", "0") or 0)
    if deadline > 0:
        signal.alarm(max(1, int(deadline)))

    def run():
        try:
            describe_device(device)
            index, claims = build(NUM_DOCS, args.claims, state)
            outcome["run"] = run_judged(
                index, claims, d_tile=args.d_tile, df_threshold=args.df_threshold,
                union_round=args.union_round, select_rescore=args.select_rescore,
                trace=args.trace, device=device, state=state,
            )
        except BenchFailure:
            pass  # the line carries the note
        except Exception as e:  # noqa: BLE001 — must still print a line
            log(f"bench worker failed at phase={state.phase}: {e!r}")
            traceback.print_exc(file=sys.stderr)
            state.emit(f"{type(e).__name__} at phase={state.phase}")
        finally:
            state.done.set()

    try:
        th = threading.Thread(target=run, daemon=True, name="bench-worker")
        th.start()
        # the main thread stays free, so the handlers run promptly
        while not state.done.wait(timeout=0.5):
            pass
        state.emit()  # no-op if the worker printed
    finally:
        if deadline > 0:
            signal.alarm(0)
        for s, h in previous.items():
            signal.signal(s, signal.SIG_DFL if h is None else h)
    judged = outcome.get("run")
    if judged is None or not state.gated:
        return 1
    for f in judged.failures:
        log(f"failed after the judged line: {f}")
    return 1 if judged.failures else 0


if __name__ == "__main__":
    sys.exit(main())
