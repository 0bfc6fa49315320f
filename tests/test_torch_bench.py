"""``ircl_tpu_torch/tools/bench.py``: the judged sparse benchmark, on the CPU.

The line is held to the root ``bench.py``'s ``_State.emit`` (its top level
imports no JAX), the plateau rule to the reference's round loop
(``bench.py:286-303``) on ``BENCH_r05.json``'s recorded rounds, and the run
to the bench's own full-batch scipy gate on ``generate(2000, 64, seed=11)``
at the bench's ranker settings. The depth is cut for the CPU: one batch a
round, one round, one latency call; the corpus and claims are narrowed
through the module's constants, as ``cli bench`` cannot pass them.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as ref_bench
from ircl_tpu_torch.index.build import scipy_query_scores, to_scipy
from ircl_tpu_torch.index.ranker import TfidfRanker, vectorize_queries
from ircl_tpu_torch.tools import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS, CLAIMS = 2000, 64
# low enough at 2,000 docs that both width buckets hold docs and the claims'
# light pools hold postings
DF_THRESHOLD = 8
LINE_KEYS = ["metric", "value", "unit", "vs_baseline", "median", "rounds"]
# BENCH_r05.json's steady-state rounds (the reference's judged run)
RECORDED = [27853.1, 29444.7, 29658.9, 30688.9, 30205.0, 30382.6]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The plain slab dominates a CPU batch; four threads a worker keep the
    suite's workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def shallow(mp):
    """One batch a round, one round, one latency call and no burn-in."""
    mp.setattr(bench, "REPS", 1)
    mp.setattr(bench, "MAX_ROUNDS", 1)
    mp.setattr(bench, "LATENCY_CALLS", 1)
    mp.setattr(bench, "LATENCY_BURN_IN", 0)


def run_main(argv):
    """``bench.main(argv)``: (exit code, stdout lines, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


@pytest.fixture(scope="module")
def corpus():
    return bench.build(DOCS, CLAIMS)


@pytest.fixture(scope="module")
def judged(corpus, tmp_path_factory):
    """One ``main`` run with ``--trace`` on the module's corpus, its
    ``run_judged`` result recorded."""
    trace = tmp_path_factory.mktemp("trace")
    runs = []
    run_judged = bench.run_judged
    with pytest.MonkeyPatch.context() as mp:
        shallow(mp)
        mp.setattr(bench, "build", lambda n, c, state=None: corpus)
        mp.setattr(bench, "run_judged",
                   lambda *a, **kw: runs.append(run_judged(*a, **kw)) or runs[-1])
        rc, out, err = run_main(["--claims", str(CLAIMS), "--device", "cpu",
                                 "--df-threshold", str(DF_THRESHOLD),
                                 "--trace", str(trace)])
    return dict(rc=rc, out=out, err=err, run=runs[0], trace=trace)


# ---- the line against the reference's ------------------------------------------


STATES = {
    "gated": dict(parity_ok=True, best_qps=30688.94, cpu_qps=632.5, rounds=RECORDED),
    "gated_no_rounds": dict(parity_ok=True, best_qps=123.456, cpu_qps=7.0),
    "gated_no_baseline": dict(parity_ok=True, best_qps=1000.0, rounds=[999.0, 1000.0]),
    "incomplete": dict(cpu_qps=632.5, phase="parity"),
    "incomplete_no_baseline": dict(phase="startup"),
    "parity_ok_no_round": dict(parity_ok=True, cpu_qps=632.5, phase="steady_state"),
}
NOTES = [None, "top-k parity failed on 3 queries", "killed by signal 15"]


def _emitted(state_cls, fields, note):
    st = state_cls()
    for k, v in fields.items():
        setattr(st, k, list(v) if isinstance(v, list) else v)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        st.emit(note)
        st.emit("a second call prints nothing")
    return out.getvalue()


@pytest.mark.parametrize("note", NOTES)
@pytest.mark.parametrize("name", sorted(STATES))
def test_emit_matches_reference(name, note):
    want = _emitted(ref_bench._State, STATES[name], note)
    got = _emitted(bench._State, STATES[name], note)
    assert got == want
    assert len(got.splitlines()) == 1


def test_emit_returns_the_line_and_says_whether_it_is_gated():
    st = bench._State()
    st.parity_ok, st.best_qps, st.cpu_qps, st.rounds = True, 10.0, 5.0, [10.0]
    assert st.gated
    with contextlib.redirect_stdout(io.StringIO()) as out:
        line = st.emit()
        assert st.emit() is None
    assert json.loads(out.getvalue()) == line == st.line
    assert not bench._State().gated


# ---- the plateau rule ------------------------------------------------------------


def _reference_rounds(seq, max_rounds=16):
    """The reference's loop (``bench.py:289-303``) over recorded q/s."""
    rounds, best = [], 0.0
    for r in range(max_rounds):
        qps = seq[r]
        rounds.append(qps)
        best = max(best, qps)
        if r >= 5 and all(q >= 0.97 * best for q in rounds[-3:]):
            break
    return rounds


def _port_rounds(seq, max_rounds=16):
    state = bench._State()
    with contextlib.redirect_stderr(io.StringIO()):
        rounds = bench.run_rounds(lambda r: seq[r], state, max_rounds)
    assert state.rounds == rounds and state.best_qps == max(rounds)
    return rounds


def test_plateau_after_six_recorded_rounds():
    seq = RECORDED + [1.0] * 10  # never reached
    assert _port_rounds(seq) == RECORDED == _reference_rounds(seq)


def test_rounds_that_never_settle_run_sixteen():
    seq = [1000.0 * 1.05**i for i in range(20)]  # a new best 5% up each round
    assert len(_port_rounds(seq)) == 16 == len(_reference_rounds(seq))


@pytest.mark.parametrize("seed", range(6))
def test_plateau_matches_reference_on_noisy_rounds(seed):
    rng = np.random.default_rng(seed)
    seq = list(27000.0 + 3000.0 * rng.random(16))
    assert _port_rounds(seq) == _reference_rounds(seq)
    assert _port_rounds(seq, max_rounds=7) == _reference_rounds(seq, max_rounds=7)


# ---- the judged run ---------------------------------------------------------------


def test_judged_run_prints_one_line_and_exits_0(judged):
    assert judged["rc"] == 0, judged["err"]
    (line,) = judged["out"]
    got = json.loads(line)
    assert list(got) == LINE_KEYS
    assert got["metric"] == "sparse_tfidf_retrieval_qps_per_chip"
    assert got["unit"] == "queries/s"
    assert got["rounds"] == 1 and got["value"] == got["median"] > 0
    # the plain versions on a loaded CPU may round to 0.0 against scipy
    assert isinstance(got["vs_baseline"], float) and got["vs_baseline"] >= 0
    assert got == judged["run"].line


def test_judged_run_passes_the_full_batch_gate(judged):
    assert f"parity: {CLAIMS}/{CLAIMS} queries match" in judged["err"]
    assert "device cpu" in judged["err"]


def test_judged_run_uses_both_buckets_and_the_light_pools(judged, corpus):
    ranker = judged["run"].ranker
    assert ranker.mode == "hybrid" and ranker.df_threshold == DF_THRESHOLD
    bk = ranker._bucketed
    assert bk is not None
    assert len(bk.ell_a.terms) > 0 and len(bk.ell_b.terms) > 0
    host = ranker.hybrid_host_inputs(*ranker._vectorize(corpus[1]))
    assert np.count_nonzero(host[4]) > 0  # light contributions


def test_judged_run_returns_each_claims_scipy_top(judged, corpus):
    index, claims = corpus
    run = judged["run"]
    assert len(run.scipy_top) == CLAIMS
    qb, qw = vectorize_queries(claims, index.hash_size, index.ngram,
                               index.doc_freqs, index.num_docs)
    dense = scipy_query_scores(to_scipy(index), qb, qw, index.hash_size)
    for row, want in zip(dense, run.scipy_top):
        top = -np.sort(-row[row > 0])[: bench.K]
        np.testing.assert_allclose(np.sort(want), np.sort(top), rtol=1e-6)


def test_judged_run_logs_rounds_and_latency(judged):
    run = judged["run"]
    assert len(run.rounds) == 1 and run.failures == []
    assert list(run.latency) == [CLAIMS]  # 512 and 128 exceed the batch
    assert f"single-batch latency (B={CLAIMS}): p50" in judged["err"]
    assert "steady-state round 0:" in judged["err"]


def test_trace_is_written(judged):
    path = judged["trace"] / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert events
    assert f"profiler trace written to {path}" in judged["err"]


def test_parity_failure_prints_the_note_and_exits_1(corpus, monkeypatch):
    finalize = TfidfRanker.finalize_closest

    def perturbed(self, pending, n):
        out = finalize(self, pending, n)
        ids, scores = out[0]
        out[0] = (ids, scores * np.float32(1.01))
        return out

    monkeypatch.setattr(TfidfRanker, "finalize_closest", perturbed)
    monkeypatch.setattr(bench, "build", lambda n, c, state=None: corpus)
    rc, out, err = run_main(["--claims", str(CLAIMS), "--device", "cpu",
                             "--df-threshold", str(DF_THRESHOLD)])
    assert rc == 1
    (line,) = out
    got = json.loads(line)
    assert list(got) == ["metric", "value", "unit", "vs_baseline", "note"]
    assert got["note"] == ("incomplete at phase=parity: top-k parity failed "
                           "on 1 queries")
    assert got["vs_baseline"] == 1.0 and got["value"] > 0
    assert f"parity: {CLAIMS - 1}/{CLAIMS} queries match" in err


def test_worker_exception_prints_the_note_and_exits_1(monkeypatch):
    def broken(n, c, state=None):
        state.phase = "corpus_gen"
        raise ValueError("no corpus")

    monkeypatch.setattr(bench, "build", broken)
    rc, out, err = run_main(["--device", "cpu"])
    assert rc == 1
    (line,) = out
    assert json.loads(line)["note"] == (
        "incomplete at phase=corpus_gen: ValueError at phase=corpus_gen")
    assert "ValueError('no corpus')" in err


def test_failed_trace_and_latency_probe_exit_1_after_the_judged_line(
        corpus, monkeypatch, tmp_path):
    shallow(monkeypatch)
    monkeypatch.setattr(bench, "build", lambda n, c, state=None: corpus)

    def broken(what):
        def fail(*a, **kw):
            raise RuntimeError(f"{what} broke")
        return fail

    monkeypatch.setattr(bench, "_trace", broken("trace"))
    monkeypatch.setattr(bench, "_latency", broken("probe"))
    rc, out, err = run_main(["--claims", str(CLAIMS), "--device", "cpu",
                             "--df-threshold", str(DF_THRESHOLD),
                             "--trace", str(tmp_path)])
    assert rc == 1
    (line,) = out
    assert list(json.loads(line)) == LINE_KEYS
    assert "profiler trace failed: RuntimeError('trace broke')" in err
    assert "latency probe failed: RuntimeError('probe broke')" in err
    assert err.index("steady-state round 0") > err.index("profiler trace failed")


def test_deadline_signal_before_parity_prints_the_note_and_exits_1():
    """``IRCL_BENCH_DEADLINE``'s SIGALRM in a fresh process whose corpus
    never comes: the salvage line, exit 1."""
    script = ("import time\n"
              "from ircl_tpu_torch.tools import bench\n"
              "bench.build = lambda n, c, state=None: time.sleep(60)\n"
              "bench.main(['--device', 'cpu'])\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["IRCL_BENCH_DEADLINE"] = "1"
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["note"] == (
        f"incomplete at phase=startup: killed by signal {int(bench.signal.SIGALRM)}")


def _flags(help_text):
    return {w.split("=")[0].strip("[],") for w in help_text.split() if w.startswith(("--", "[--"))}


def test_flags_and_defaults_are_the_references(monkeypatch):
    """The reference's flags plus ``--device``; its defaults, but
    ``--claims`` 4096 where the reference falls back to a warmed batch."""
    monkeypatch.setattr(sys, "argv", ["bench.py", "--help"])
    with contextlib.redirect_stdout(io.StringIO()) as ref_help:
        with pytest.raises(SystemExit) as e:
            ref_bench.main()
    assert e.value.code == 0
    with contextlib.redirect_stdout(io.StringIO()) as port_help:
        with pytest.raises(SystemExit):
            bench.parse_args(["--help"])
    assert _flags(port_help.getvalue()) == _flags(ref_help.getvalue()) | {"--device"}
    args = bench.parse_args([])
    assert (args.d_tile, args.df_threshold, args.claims, args.union_round,
            args.select_rescore, args.trace, args.device) == (
        None, 24, 4096, 512, 0, None, None)
