"""The port's configuration and ``python -m ircl_tpu_torch.cli`` against
``ircl_tpu.config`` and ``ircl_tpu.cli``.

Mirrors ``tests/test_cli.py``, ``test_cli_chain.py``, ``test_cli_verdict.py``
and the CLI half of ``test_end_to_end.py``: both packages run the same
commands (``--device cpu`` for the port) with the same JSON config, each into
a workspace of its own, on a 40-doc synthetic corpus and on the FEVER-format
fixtures fetched from a localhost server. Checks: equal config objects and
error strings; equal prepared files and indexes; equal recall and retrieval
output; served replies equal (doc ids and sentence keys exactly, scores rtol
1e-5: the encoder sums in another order); equal classification reports
from the same verdict weights. Where the packages draw their initial weights
from different generators (``TrainState``, the hash featurizer's table, the
verdict model), the port's stage is given the JAX package's weights,
carried across with ``utils/convert.py``, before the outputs are compared.
The reference's ``test_cli_train_dp`` runs the port's ``train --dp`` over
8 gloo ranks on the CPU; ``test_train_verdict_cli_pp_dp_mesh`` runs the
port's ``train-verdict --pp 2 --layers 2 --pp-micro 4`` over the fixture's
2 ranks (its ``--dp 2`` would need 4).
"""

import dataclasses
import hashlib
import http.client
import http.server
import io
import json
import os
import signal
import subprocess
import sys
import threading
import zipfile

import jax
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu import cli as j_cli
from ircl_tpu import config as j_config
from ircl_tpu import serve as j_serve
from ircl_tpu import serve_native as j_native
from ircl_tpu.contrastive.state import init_train_state as j_init_train_state
from ircl_tpu.corpus import fever as j_fever
from ircl_tpu.index.build import CountIndex as JCountIndex
from ircl_tpu.index.ranker import TfidfRanker as JRanker
from ircl_tpu.models import featurizer as j_feat
from ircl_tpu.utils.checkpoint import restore_state as j_restore_state
from ircl_tpu.verdict import infer as j_infer
from ircl_tpu_torch import cli as t_cli
from ircl_tpu_torch import config as t_config
from ircl_tpu_torch.index.build import CountIndex
from ircl_tpu_torch.models import featurizer as t_feat
from ircl_tpu_torch.models.transformer import TransformerConfig
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.utils.checkpoint import save_state
from ircl_tpu_torch.verdict import infer as t_infer
from ircl_tpu_torch.verdict import model as t_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "fever")
TIMEOUT = 120

TINY = [  # the reference's tiny contrastive shapes (tests/test_cli.py)
    "--set", "train.micro_batch=8",
    "--set", "train.accum_steps=1",
    "--set", "train.queue_size=16",
    "--set", "featurizer.dim=16",
    "--set", "featurizer.max_len=8",
    "--set", "train.encoder.input_size=16",
    "--set", "train.encoder.hidden_size=8",
    "--set", "train.encoder.output_size=8",
    "--set", "train.encoder.num_layers=1",
]
VERDICT_FLAGS = ["--vocab-size", "512", "--hidden", "32", "--layers", "1",
                 "--heads", "2"]


def run_t(argv):
    """The port's CLI on the CPU."""
    return t_cli.main(["--device", "cpu", *argv])


# ---- configuration ----------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    {},
    {"train.loss": "ProtoNCE"},
    {"index.hash_size": "65536"},
    {"train.encoder.hidden_size": "8", "train.num_clusters": "3,5"},
    {"featurizer.kind": "transformer", "retrieval.k_docs": "3",
     "data.synthetic": "false", "verdict.learning_rate": "0.001"},
])
def test_load_config_matches_reference(overrides):
    got = dataclasses.asdict(t_config.load_config(None, overrides))
    want = dataclasses.asdict(j_config.load_config(None, overrides))
    assert got == want


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_config_files_match_reference(tmp_path, fmt):
    raw = {"index": {"hash_size": 1024, "ngram": 1}, "data": {"synthetic_docs": 12},
           "train": {"loss": "ProtoNCE", "encoder": {"num_layers": 1}},
           "ckptdir": "c"}
    good = tmp_path / f"c.{fmt}"
    bad = tmp_path / f"bad.{fmt}"
    if fmt == "json":
        good.write_text(json.dumps(raw))
        bad.write_text(json.dumps({"index": {"hash_sizee": 1024}}))
    else:
        good.write_text("index:\n  hash_size: 1024\n  ngram: 1\n"
                        "data:\n  synthetic_docs: 12\n"
                        "train:\n  loss: ProtoNCE\n  encoder:\n    num_layers: 1\n"
                        "ckptdir: c\n")
        bad.write_text("index:\n  hash_sizee: 1024\n")
    got = t_config.load_config(str(good))
    assert dataclasses.asdict(got) == dataclasses.asdict(j_config.load_config(str(good)))
    assert got.index.hash_size == 1024 and got.train.encoder.num_layers == 1
    for path, dotted in ((str(bad), None), (None, "index.nonexistent")):
        over = {dotted: 1} if dotted else None
        with pytest.raises(ValueError) as want:
            j_config.load_config(path, over)
        with pytest.raises(ValueError) as have:
            t_config.load_config(path, over)
        assert str(have.value) == str(want.value)


# ---- the chain on a synthetic corpus -----------------------------------------


def _write_config(ws):
    cfg = {
        "data": {"data_dir": f"{ws}/data", "wiki_json": f"{ws}/data/small_wiki.json",
                 "dev_jsonl": f"{ws}/data/shared_task_dev.jsonl", "synthetic": True,
                 "synthetic_docs": 40, "synthetic_claims": 20},
        "index": {"hash_size": 262144},
        "verdict": {"epochs": 2, "batch_size": 8, "val_fraction": 0.1,
                    "warmup_steps": 2, "max_length": 48, "learning_rate": 0.001},
        "ckptdir": f"{ws}/ckpt", "logdir": f"{ws}/log",
    }
    path = os.path.join(ws, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    """A prepared and indexed workspace for each package."""
    out = {}
    for name, run in (("j", j_cli.main), ("t", run_t)):
        ws = str(tmp_path_factory.mktemp(f"{name}ws"))
        cfg = _write_config(ws)
        run(["--config", cfg, "prepare"])
        run(["--config", cfg, "build-index"])
        out[name] = (ws, cfg)
    return out


def test_prepare_and_build_index_match(workspaces):
    (jws, _), (tws, _) = workspaces["j"], workspaces["t"]
    for rel in ("data/small_wiki.json", "data/shared_task_dev.jsonl",
                "data/docs_sentence.pkl", "data/docs_sentence_dict.pkl"):
        with open(f"{jws}/{rel}", "rb") as a, open(f"{tws}/{rel}", "rb") as b:
            assert a.read() == b.read(), rel
    for rel in ("count_matrix.npz", "tfidf-ngram=2-hash=262144.npz"):
        want = CountIndex.load(f"{jws}/data/index/{rel}")
        got = CountIndex.load(f"{tws}/data/index/{rel}")
        assert got.doc_ids == want.doc_ids
        for field in ("indptr", "post_docs", "post_vals", "doc_freqs"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def same_retrieval(got, want, cfg_path):
    """``retrieve``'s outputs: equal recall; per claim the doc lists equal
    except across exact ties (judged by the reference ranker's own scores,
    rtol 1e-5), and the sentence lists equal where the doc lists are."""
    (g_metrics, g_rows), (w_metrics, w_rows) = got, want
    assert g_metrics == w_metrics
    assert [r["id"] for r in g_rows] == [r["id"] for r in w_rows]
    cfg = j_config.load_config(cfg_path)
    index = JCountIndex.load(os.path.join(
        cfg.data.data_dir, "index",
        f"tfidf-ngram={cfg.index.ngram}-hash={cfg.index.hash_size}.npz"))
    claims = j_fever.parse_claims_jsonl(cfg.data.dev_jsonl, drop_nei=True)
    dense = JRanker(index).dense_scores_batch([c.claim for c in claims])
    for row_s, g, w in zip(dense, g_rows, w_rows):
        if g == w:
            continue
        score = lambda d: float(row_s[index.doc2idx[d]])  # noqa: E731
        gs, ws = [score(d) for d in g["docs"]], [score(d) for d in w["docs"]]
        np.testing.assert_allclose(gs, ws, rtol=1e-5)
        cut = min(ws) * (1 + 1e-5)
        assert {d for d, s in zip(g["docs"], gs) if s > cut} == {
            d for d, s in zip(w["docs"], ws) if s > cut}
        if set(g["docs"]) == set(w["docs"]):
            assert g["sentences"] == w["sentences"]


def _retrieve(run, ws, cfg, capsys, sets=(), flags=(), out="results.jsonl"):
    capsys.readouterr()
    run(["--config", cfg, *sets, "retrieve", *flags, "--out", f"{ws}/{out}"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(f"{ws}/{out}") as f:
        return metrics, [json.loads(line) for line in f]


def test_retrieve_matches_reference(workspaces, capsys):
    """The sparse sentence scorer: equal recall and equal output rows."""
    want, got = (_retrieve(run, *workspaces[name], capsys)
                 for name, run in (("j", j_cli.main), ("t", run_t)))
    same_retrieval(got, want, workspaces["j"][1])
    assert got[0]["doc_recall@k"] >= 0.8


@pytest.fixture(scope="module")
def trained(workspaces):
    """``cli train`` in both packages; the reference's state and featurizer
    carried into the port as a checkpoint and a featurizer factory."""
    for name, run in (("j", j_cli.main), ("t", run_t)):
        _, cfg = workspaces[name]
        run(["--config", cfg, *TINY, "train", "--steps", "3", "--log-step", "3",
             "--seed", "7"])
    jws, jcfg = workspaces["j"]
    tws, _ = workspaces["t"]
    assert os.listdir(f"{tws}/ckpt") == ["uniform_InfoNCE_LSTM_3"]
    cfg = j_config.load_config(jcfg, {kv.split("=")[0]: kv.split("=")[1]
                                      for kv in TINY[1::2]})
    j_state = j_restore_state(f"{jws}/ckpt/uniform_InfoNCE_LSTM_3",
                              j_init_train_state(jax.random.PRNGKey(0), cfg.train))
    np_ = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    adam = j_state.opt_state[1][0]
    t_state = convert.train_state_from_numpy(
        np_(j_state.params_q), np_(j_state.params_k), np.asarray(j_state.queue),
        int(j_state.queue_ptr), int(j_state.step), count=int(adam.count),
        mu=np_(adam.mu), nu=np_(adam.nu), device="cpu")
    carried = save_state(f"{tws}/carried", "uniform_InfoNCE_LSTM", t_state)
    j_params = np_(j_feat.make_featurizer(cfg.featurizer).params)

    def featurizer(cfg, device, corpus_texts=None):
        return t_feat.HashEmbedFeaturizer(
            t_feat.FeaturizerConfig(**dataclasses.asdict(cfg.featurizer)), device=device,
            params=convert.hash_featurizer_params_from_numpy(j_params, device))

    return f"{jws}/ckpt/uniform_InfoNCE_LSTM_3", carried, featurizer


def test_retrieve_dense_ckpt_matches_reference(workspaces, trained, capsys, monkeypatch):
    j_ckpt, t_ckpt, featurizer = trained
    monkeypatch.setattr(t_cli, "_featurizer", featurizer)
    want, got = (
        _retrieve(run, *workspaces[name], capsys, sets=TINY,
                  flags=["--dense-ckpt", ckpt], out="dense.jsonl")
        for name, run, ckpt in (("j", j_cli.main, j_ckpt), ("t", run_t, t_ckpt)))
    same_retrieval(got, want, workspaces["j"][1])


def _serve_stdin(run, argv, lines, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    capsys.readouterr()
    run(argv)
    return [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()
            if ln.startswith("{")]


def test_serve_two_stage_stdin_matches_reference(workspaces, trained, monkeypatch,
                                                 capsys):
    """``serve --stdin --dense-ckpt``: a doc, a two-stage and a malformed
    line; the table is built and cached at ``--sent-table`` on the first
    boot and loaded on the second."""
    j_ckpt, t_ckpt, featurizer = trained
    monkeypatch.setattr(t_cli, "_featurizer", featurizer)
    lines = [json.dumps({"queries": ["vamu pufo heno"], "sentences": True}),
             json.dumps({"query": "vamu pufo heno", "k": 2}),
             '{"bad json']
    replies = []
    for name, run, ckpt in (("j", j_cli.main, j_ckpt), ("t", run_t, t_ckpt)):
        ws, cfg = workspaces[name]
        argv = ["--config", cfg, *TINY, "serve", "--stdin", "--batch-size", "8",
                "--k", "3", "--k-sents", "2", "--dense-ckpt", ckpt,
                "--sent-table", f"{ws}/sent_table.npy"]
        first = _serve_stdin(run, argv, lines, monkeypatch, capsys)
        assert os.path.exists(f"{ws}/sent_table.npy")
        assert _serve_stdin(run, argv, lines, monkeypatch, capsys) == first
        replies.append(first)
    want, got = replies
    assert got[2] == want[2] and "error" in got[2]
    assert [[h["doc_id"] for h in r] for r in got[1]["results"]] == [
        [h["doc_id"] for h in r] for r in want[1]["results"]]
    for g, w in zip(got[0]["results"], want[0]["results"]):
        assert [(h["doc_id"], h["sent_id"], h["sentence"]) for h in g] == [
            (h["doc_id"], h["sent_id"], h["sentence"]) for h in w]
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w],
                                   rtol=1e-5, atol=1e-6)
    assert len(got[0]["results"][0]) == 2


def test_train_and_eval_verdict(workspaces, capsys):
    """``train-verdict`` then ``eval-verdict`` over gold and retrieved
    evidence in the port; then both packages evaluate the reference's trained
    weights (carried into the port's checkpoint) to the same report."""
    reports = {}
    for name, run in (("j", j_cli.main), ("t", run_t)):
        ws, cfg = workspaces[name]
        run(["--config", cfg, "train-verdict", *VERDICT_FLAGS])
        history = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert [h["epoch"] for h in history] == [0, 1]
        assert all(np.isfinite(h["train_loss"]) for h in history)
    tws, tcfg = workspaces["t"]
    for f in ("verdict_config.json", "verdict_vocab.txt", "verdict_params.pt"):
        assert os.path.exists(f"{tws}/ckpt/{f}")
    run_t(["--config", tcfg, "eval-verdict"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= rep["macro_f1"] <= 1.0 and rep["per_class"]

    jws, _ = workspaces["j"]
    j_cfg, j_params, tok = j_infer.load_verdict_checkpoint(f"{jws}/ckpt")
    t_cfg = t_model.VerdictConfig(
        encoder=TransformerConfig(**{
            k: v for k, v in dataclasses.asdict(j_cfg.encoder).items() if k != "dtype"}),
        num_labels=j_cfg.num_labels, max_length=j_cfg.max_length)
    tok.save_vocab(f"{tws}/vocab.txt")
    t_infer.save_verdict_checkpoint(
        f"{tws}/ckpt", t_cfg,
        convert.verdict_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu"),
        WordPieceTokenizer.from_vocab_file(f"{tws}/vocab.txt"))
    for name, run in (("j", j_cli.main), ("t", run_t)):
        ws, cfg = workspaces[name]
        run(["--config", cfg, "retrieve", "--out", f"{ws}/res.jsonl"])
        capsys.readouterr()
        run(["--config", cfg, "eval-verdict"])
        gold = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        run(["--config", cfg, "eval-verdict", "--retrieved", f"{ws}/res.jsonl"])
        retrieved = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        reports[name] = (gold, retrieved)
    assert reports["t"] == reports["j"]


def test_serve_native_front_answers_and_stops_on_a_signal(workspaces):
    """``serve --native-front --batch-wait-ms 5 --port 0`` in a fresh
    process: its replies equal the reference's native front's over the same
    index, and SIGINT stops it with exit code 0."""
    ws, cfg = workspaces["t"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "ircl_tpu_torch.cli", "--device", "cpu", "--config", cfg,
         "serve", "--native-front", "--batch-wait-ms", "5", "--port", "0",
         "--batch-size", "8"],
        cwd=ROOT, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
        env={k: v for k, v in os.environ.items() if not k.startswith("XLA_")})
    ref = None
    try:
        port = None
        for line in proc.stderr:
            if line.startswith("serving on http://"):
                port = int(line.split(":")[2].split(" ")[0])
                break
        assert port, "the server never said where it listens"
        index = f"{workspaces['j'][0]}/data/index/tfidf-ngram=2-hash=262144.npz"
        ref = j_native.serve_native_http(
            j_serve.make_service(index, batch_size=8), port=0, batch_wait_ms=5.0)
        claims = [json.loads(ln)["claim"] for ln in open(f"{ws}/data/shared_task_dev.jsonl")]
        for body in [json.dumps({"queries": claims[:3]}), json.dumps({"query": claims[4]}),
                     '{"queries": 3}']:
            got = []
            for p in (port, ref.port):
                c = http.client.HTTPConnection("127.0.0.1", p, timeout=TIMEOUT)
                c.request("POST", "/search", body=body.encode())
                r = c.getresponse()
                got.append((r.status, json.loads(r.read())))
                c.close()
            (ts, tb), (js, jb) = got
            assert ts == js
            if ts != 200:
                assert tb == jb
                continue
            for g, w in zip(tb["results"], jb["results"]):
                assert [h["doc_id"] for h in g] == [h["doc_id"] for h in w]
                np.testing.assert_allclose([h["score"] for h in g],
                                           [h["score"] for h in w], rtol=1e-5)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if ref is not None:
            ref.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)


# ---- bench: the judged sparse benchmark -------------------------------------------


def test_bench_raises_item_4(monkeypatch, capsys):
    """``cli bench`` runs ``tools/bench.py``'s judged run at its defaults
    and exits with its code; no argument of the CLI's command line reaches
    the tool's parser. The corpus, the claims and the depth are narrowed
    through the tool's constants (one batch a round, one round, one latency
    call), on four torch threads."""
    from ircl_tpu_torch.tools import bench

    for name, value in (("NUM_DOCS", 2000), ("NUM_CLAIMS", 64), ("REPS", 1),
                        ("MAX_ROUNDS", 1), ("LATENCY_CALLS", 1),
                        ("LATENCY_BURN_IN", 0)):
        monkeypatch.setattr(bench, name, value)
    argvs = []
    parse_args = bench.parse_args
    monkeypatch.setattr(bench, "parse_args",
                        lambda argv=None: argvs.append(argv) or parse_args(argv))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        rc = run_t(["bench"])
    finally:
        torch.set_num_threads(threads)
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert argvs == [["--device", "cpu"]]
    (line,) = out.splitlines()
    got = json.loads(line)
    assert list(got) == ["metric", "value", "unit", "vs_baseline", "median", "rounds"]
    assert got["metric"] == "sparse_tfidf_retrieval_qps_per_chip" and got["rounds"] == 1
    assert "index built" in err and "2000 docs" in err
    assert "parity: 64/64 queries match" in err


def test_reference_bench_refuses_its_own_subcommand(monkeypatch, capsys):
    """The reference's ``cli bench`` hands ``sys.argv`` on to ``bench.py``'s
    parser, which refuses the subcommand before any work (exit 2); the
    port's passes the tool an argument list of its own."""
    monkeypatch.setattr(sys, "argv", ["cli.py", "bench"])
    with pytest.raises(SystemExit) as e:
        j_cli.main(["bench"])
    assert e.value.code == 2
    assert "unrecognized arguments: bench" in capsys.readouterr().err


def test_bench_help_stays_in_the_cli(capsys):
    """``--device cpu bench --help`` is the CLI's help of a command without
    flags, not the tool's."""
    with pytest.raises(SystemExit) as e:
        t_cli.main(["--device", "cpu", "bench", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--claims" not in out and "--df-threshold" not in out


# ---- what once raised, naming its item --------------------------------------------


def test_cli_train_dp_raises_item_12_over_several_devices(workspaces, capsys, tmp_path):
    """Once a raise naming ROADMAP.md queue 1 item 12, now the reference's
    ``test_cli_train_dp``: the reference trains over its 8-device mesh, the
    port's ``train --dp`` over 8 gloo ranks on the CPU (each running
    ``cli.main`` as ``torchrun`` would start it). Both print the same lines;
    only rank 0 writes, and its checkpoint equals the port's single-device
    run of the same seed (``tests/test_dp.py``'s 1e-5)."""
    from _torch_ranks import cli_main
    from ircl_tpu_torch.parallel.launch import launch

    argv = [*TINY, "train", "--steps", "2", "--log-step", "2", "--seed", "11"]
    configs = {}
    for name in ("j", "dp", "single"):
        own = json.load(open(workspaces["t" if name != "j" else "j"][1]))
        own["ckptdir"], own["logdir"] = f"{tmp_path}/{name}ckpt", f"{tmp_path}/{name}log"
        configs[name] = f"{tmp_path}/{name}cfg.json"
        json.dump(own, open(configs[name], "w"))
    j_cli.main(["--config", configs["j"], *argv, "--dp"])
    want = capsys.readouterr().out
    got = launch(cli_main, 8, ["--device", "cpu", "--config", configs["dp"], *argv,
                               "--dp"], device="cpu")
    for out in (want, got):
        assert "data-parallel training over 8 devices" in out
        assert "finished at step 2" in out
    assert got.count("finished at step 2") == 1
    run_t(["--config", configs["single"], *argv])
    assert "finished at step 2" in capsys.readouterr().out
    (dp_file,), (single_file,) = (os.listdir(f"{tmp_path}/{n}ckpt") for n in ("dp", "single"))
    assert dp_file == single_file and dp_file.endswith("_2")
    dp, single = (torch.load(f"{tmp_path}/{n}ckpt/{dp_file}", weights_only=True)
                  for n in ("dp", "single"))
    assert dp["step"] == single["step"] == 2 and dp["queue_ptr"] == single["queue_ptr"]
    for a, b in zip(jax.tree.leaves(dp["params_q"]), jax.tree.leaves(single["params_q"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dp["queue"].numpy(), single["queue"].numpy(), rtol=0,
                               atol=1e-5)


def test_cli_train_dp_starts_a_rank_per_card(workspaces, monkeypatch):
    """Outside a process group, ``train --dp`` with several CUDA devices
    starts one rank per device through ``parallel/launch.py``, each
    running ``cmd_train`` with the same arguments."""
    from ircl_tpu_torch.parallel import launch as t_launch

    _, cfg = workspaces["t"]
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(t_launch, "launch",
                        lambda fn, n, *a, **kw: calls.append((fn, n, a, kw)))
    t_cli.main(["--device", "cuda", "--config", cfg, *TINY, "train", "--dp"])
    ((fn, n, (args,), kw),) = calls
    assert fn is t_cli.cmd_train and n == 4 and args.dp and args.command == "train"
    assert kw == {"device": torch.device("cuda")}


@pytest.mark.parametrize("flags,ranks", [(["--dp", "2", "--tp", "2"], 4),
                                         (["--moe-experts", "4", "--ep", "2"], 2)])
def test_cli_train_verdict_starts_dp_tp_ep_ranks(workspaces, monkeypatch, flags, ranks):
    """Outside a process group, ``train-verdict --dp/--tp/--ep`` starts
    ``dp * tp * ep`` ranks through ``parallel/launch.py``, each running
    ``cmd_train_verdict`` with the same arguments, and refuses more ranks
    than there are devices with the reference's message."""
    from ircl_tpu_torch.parallel import launch as t_launch

    _, cfg = workspaces["t"]
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(t_launch, "launch",
                        lambda fn, n, *a, **kw: calls.append((fn, n, a, kw)))
    t_cli.main(["--device", "cuda", "--config", cfg, "train-verdict", *flags])
    ((fn, n, (args,), kw),) = calls
    assert fn is t_cli.cmd_train_verdict and n == ranks
    assert kw == {"device": torch.device("cuda")}
    with pytest.raises(SystemExit, match="dp\\*tp\\*ep=8 exceeds 4 devices"):
        t_cli.main(["--device", "cuda", "--config", cfg, "train-verdict", *flags,
                    "--dp", "4"])


def test_cli_train_dp_on_one_device_trains_single_device(workspaces, capsys):
    _, cfg = workspaces["t"]
    run_t(["--config", cfg, *TINY, "train", "--steps", "2", "--log-step", "2",
           "--seed", "11", "--dp"])
    out = capsys.readouterr().out
    assert "--dp requested but only 1 device visible; single-device" in out
    assert "finished at step 2" in out


MESH_FLAGS = {"flags0": ["--pp", "2", "--layers", "2", "--pp-micro", "4"],
              "flags1": ["--dp", "2"], "flags2": ["--tp", "2"],
              "flags4": ["--moe-experts", "4", "--ep", "2"]}
RANK_FLAGS = ("--dp", "--tp", "--ep", "--pp")  # and their values: the mesh


def _own_config(workspace_cfg, root, name):
    """A copy of a workspace's config writing into ``root/name``."""
    own = json.load(open(workspace_cfg))
    own["ckptdir"], own["logdir"] = f"{root}/{name}ckpt", f"{root}/{name}log"
    path = f"{root}/{name}cfg.json"
    json.dump(own, open(path, "w"))
    return path


@pytest.fixture(scope="module")
def verdict_ranks(workspaces, tmp_path_factory):
    """``train-verdict`` with each of ``MESH_FLAGS`` over 2 gloo ranks on the
    CPU (each rank runs ``cli.main`` as ``torchrun`` would start it), in
    one launch; every rank's standard output by case, and the configs."""
    from _torch_ranks import cli_mains
    from ircl_tpu_torch.parallel.launch import launch

    root = str(tmp_path_factory.mktemp("verdict_ranks"))
    configs = {name: _own_config(workspaces["t"][1], root, name) for name in MESH_FLAGS}
    argvs = [["--device", "cpu", "--config", configs[name], "train-verdict",
              *VERDICT_FLAGS, *flags] for name, flags in MESH_FLAGS.items()]
    outs = launch(cli_mains, 2, argvs, device="cpu", timeout=300.0)
    return dict(zip(MESH_FLAGS, outs)), configs, root


@pytest.mark.parametrize("flags,match", [
    (MESH_FLAGS["flags0"], "ranks"),
    (["--dp", "2"], "ranks"),
    (["--tp", "2"], "ranks"),
    (["--moe-experts", "4"], None),  # runs: the MoE FFN is ported
    (["--moe-experts", "4", "--ep", "2"], "ranks"),
], ids=[  # the cases' names from when --moe-experts raised item 9
    "flags0-item 12", "flags1-item 12", "flags2-item 12", "flags3-item 9",
    "flags4-item 9",
])
def test_train_verdict_mesh_and_moe_raise(workspaces, flags, match, tmp_path, capsys,
                                          request):
    """``--pp 2 --layers 2 --pp-micro 4``, ``--dp 2``, ``--tp 2`` and
    ``--moe-experts 4 --ep 2`` (each once item 12's raise) train over 2
    ranks, as the reference trains over its mesh: one history line, from
    rank 0, of the reference's epochs; the reference's
    ``verdict_config.json``; and the history and the checkpoint of the
    port's single-device run of the same command without the mesh's flags
    (train loss rtol 2e-5, validation F1 equal, parameters rtol 5e-4, atol
    5e-6). ``--moe-experts 4`` trains in both packages, into checkpoints of
    their own: equal ``verdict_config.json`` files, the port's checkpoint
    evaluates, and with the reference's trained MoE weights carried into
    it both packages report alike."""
    if match == "ranks":
        name = request.node.callspec.id.split("-")[0]
        outs, configs, root = request.getfixturevalue("verdict_ranks")
        printed = [o.strip().splitlines() for o in outs[name]]
        assert [len(p) for p in printed] == [1, 0]  # rank 0 alone prints
        history = json.loads(printed[0][0])
        j_cfg = _own_config(workspaces["j"][1], root, f"j{name}")
        j_cli.main(["--config", j_cfg, "train-verdict", *VERDICT_FLAGS, *flags])
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        single_flags = [f for i, f in enumerate(flags)
                        if f not in RANK_FLAGS and (i == 0 or flags[i - 1] not in RANK_FLAGS)]
        t_cfg = _own_config(workspaces["t"][1], root, f"single{name}")
        run_t(["--config", t_cfg, "train-verdict", *VERDICT_FLAGS, *single_flags])
        single = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert [h["epoch"] for h in history] == [h["epoch"] for h in want] == [0, 1]
        for g, s in zip(history, single):
            np.testing.assert_allclose(g["train_loss"], s["train_loss"], rtol=2e-5)
            assert g["val_macro_f1"] == s["val_macro_f1"]
        metas = [json.load(open(f"{root}/{n}ckpt/verdict_config.json"))
                 for n in (name, f"j{name}")]
        assert metas[0] == metas[1]
        mine, ref = (torch.load(f"{root}/{n}ckpt/verdict_params.pt", weights_only=True)
                     for n in (name, f"single{name}"))
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=5e-6)
        return
    metas, configs = {}, {}
    for name, run in (("j", j_cli.main), ("t", run_t)):
        own = json.load(open(workspaces[name][1]))
        own["ckptdir"], own["logdir"] = f"{tmp_path}/{name}ckpt", f"{tmp_path}/{name}log"
        configs[name] = f"{tmp_path}/{name}cfg.json"
        json.dump(own, open(configs[name], "w"))
        run(["--config", configs[name], "train-verdict", *VERDICT_FLAGS, *flags])
        history = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert all(np.isfinite(h["train_loss"]) for h in history)
        metas[name] = json.load(open(f"{tmp_path}/{name}ckpt/verdict_config.json"))
    assert metas["t"] == metas["j"]
    assert metas["t"]["encoder"]["moe"] == {"num_experts": 4, "top_k": 2,
                                            "capacity_factor": 1.25, "group_size": None}
    run_t(["--config", configs["t"], "eval-verdict"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= rep["macro_f1"] <= 1.0 and rep["per_class"]

    t_cfg, _, t_tok = t_infer.load_verdict_checkpoint(f"{tmp_path}/tckpt", "cpu")
    _, j_params, _ = j_infer.load_verdict_checkpoint(f"{tmp_path}/jckpt")
    t_infer.save_verdict_checkpoint(
        f"{tmp_path}/tckpt", t_cfg,
        convert.verdict_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu"),
        t_tok)
    reports = {}
    for name, run in (("j", j_cli.main), ("t", run_t)):
        run(["--config", configs[name], "eval-verdict"])
        reports[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert reports["t"] == reports["j"]


@pytest.mark.parametrize("flags", [["--pp", "2", "--tp", "2"],
                                   ["--pp", "2", "--layers", "3"]])
def test_train_verdict_rejects_bad_axes_like_the_reference(workspaces, flags):
    msgs = []
    for name, run in (("j", j_cli.main), ("t", run_t)):
        _, cfg = workspaces[name]
        with pytest.raises(SystemExit) as e:
            run(["--config", cfg, "train-verdict", *flags])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_no_device_named_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["bench"])


def test_help_lists_every_command(capsys):
    with pytest.raises(SystemExit) as e:
        t_cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for cmd in ("fetch", "prepare", "build-index", "train", "retrieve",
                "train-verdict", "eval-verdict", "bench", "serve", "--device"):
        assert cmd in out
    want = {a.dest for a in j_cli.build_parser()._actions}
    got = {a.dest for a in t_cli.build_parser()._actions}
    assert got == want | {"device"}


# ---- the FEVER-format chain: fetch -> prepare -> build-index -> retrieve ------


@pytest.fixture(scope="module")
def archive_server(tmp_path_factory):
    """wiki-pages.zip and the train/dev jsonl in the reference's layout,
    served from localhost."""
    root = tmp_path_factory.mktemp("release")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for name in ("wiki-001.jsonl", "wiki-002.jsonl"):
            zf.write(os.path.join(FIX, name), f"wiki-pages/{name}")
    (root / "wiki-pages.zip").write_bytes(buf.getvalue())
    for name in ("train.jsonl", "shared_task_dev.jsonl"):
        (root / name).write_bytes(open(os.path.join(FIX, name), "rb").read())

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(root), **kw)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield root, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=TIMEOUT)


def test_full_chain_fetch_prepare_index_retrieve(archive_server, tmp_path, capsys):
    root, base = archive_server
    sha = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()  # noqa: E731
    table = {"resources": {"wiki_pages": f"{base}/wiki-pages.zip",
                           "train": f"{base}/train.jsonl",
                           "dev": f"{base}/shared_task_dev.jsonl"},
             "checksums": {"wiki_pages": sha(root / "wiki-pages.zip"),
                           "train": sha(root / "train.jsonl"),
                           "dev": sha(root / "shared_task_dev.jsonl")}}
    outs = []
    for name, run in (("j", j_cli.main), ("t", run_t)):
        data = tmp_path / name / "data"
        cfg = tmp_path / name / "cfg.json"
        cfg.parent.mkdir()
        cfg.write_text(json.dumps({
            "data": {"data_dir": str(data), "wiki_json": f"{data}/small_wiki.json",
                     "train_jsonl": f"{data}/train.jsonl",
                     "dev_jsonl": f"{data}/shared_task_dev.jsonl", "synthetic": False},
            "index": {"hash_size": 1048576},
            "retrieval": {"k_docs": 3, "k_sents": 3, "batch_size": 8}}))
        resources = tmp_path / name / "resources.json"
        resources.write_text(json.dumps(table))
        run(["--config", str(cfg), "fetch", "--resources", str(resources)])
        fetched = capsys.readouterr().out
        assert os.path.exists(data / "wiki-pages" / "wiki-001.jsonl")
        run(["--config", str(cfg), "prepare"])
        run(["--config", str(cfg), "build-index"])
        capsys.readouterr()
        retrieved = _retrieve(run, str(tmp_path / name), str(cfg), capsys)
        with open(data / "small_wiki.json", "rb") as f:
            wiki = f.read()
        outs.append((fetched.replace(str(tmp_path / name), ""), wiki, retrieved))
    assert outs[1][:2] == outs[0][:2]
    same_retrieval(outs[1][2], outs[0][2], str(tmp_path / "j" / "cfg.json"))
    assert outs[1][2][0] == {"doc_recall@k": 1.0, "sentence_recall@k": 1.0}
