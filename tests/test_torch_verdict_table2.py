"""``ircl_tpu_torch/tools/verdict_table2.py`` against
``scripts/verdict_table2.py``.

Both ``main()``s run in this process on the same seeds (150 docs, 60 train
and 20 dev claims, 2 restarts), the port's on the CPU in a thread while the
reference runs on JAX's CPU backend, once with the default phase-C
retrieval replay and once with the sampled phase C (val trap and gold-first
on, so every branch of ``build_aug`` runs). ``train_verdict`` and
``predict_in_batches`` are recorders in both: training returns a token and a
history whose val F1 depends on the seed (so the restart selection is
exercised), prediction returns labels computed from the encoded rows.
Checks: every phase's encoded arrays, the phase-C replay included, and every
dev variant's, equal bit for bit; the same training calls (configuration,
epochs, criteria, seeds, split seed, warm starts) and prediction calls (the
best restart's params); ``tfidf_sentence_recall@1/@5``, the restart val F1s
and the whole table equal; the written section's markers and rows equal
the reference's.
"""

import concurrent.futures
import json
import types

import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from _torch_tools import load_script, reference_argv, section, table_rows
from ircl_tpu.verdict import train as j_train
from ircl_tpu_torch.tools import verdict_table2 as tool

ARGV = ["--docs", "150", "--train-claims", "60", "--dev-claims", "20",
        "--epochs", "2", "--restarts", "2"]
PHASE_C = {"retrieved": [],
           "sampled": ["--no-phase-c-retrieved", "--phase-c-trap", "0.5",
                       "--phase-c-gold-first", "0.5"]}
MODEL_FIELDS = ("vocab_size", "hidden", "layers", "heads", "intermediate",
                "max_positions", "attention")
VERDICT_FIELDS = ("learning_rate", "warmup_steps", "freeze_body_until_warmup",
                  "max_length")


def recorders(train_calls, predict_calls):
    def train_verdict(cfg, ids, mask, types, labels, epochs=3, batch_size=8,
                      val_fraction=0.01, seed=1009, init_params=None,
                      stop_at_val_f1=None, keep_best=False, split_seed=None, **_):
        train_calls.append(dict(
            model={f: getattr(cfg.encoder, f) for f in MODEL_FIELDS},
            verdict={f: getattr(cfg, f) for f in VERDICT_FIELDS},
            arrays=(ids, mask, types, labels),
            kwargs=dict(epochs=epochs, batch_size=batch_size, val_fraction=val_fraction,
                        seed=seed, init_params=init_params, stop_at_val_f1=stop_at_val_f1,
                        keep_best=keep_best, split_seed=split_seed)))
        params = f"params-{seed}-{len(train_calls)}"
        f1 = 0.5 + (seed % 13) / 100
        return params, [{"epoch": e, "train_loss": 0.5, "val_macro_f1": f1 - 0.01 * e}
                        for e in range(epochs)]

    def predict_in_batches(params, cfg, ids, mask, types, batch_size=32, **_):
        predict_calls.append(dict(params=params, arrays=(ids, mask, types)))
        return (ids.astype(np.int64).sum(axis=1) % 2).astype(np.int64)

    return train_verdict, predict_in_batches


@pytest.fixture(scope="module", params=sorted(PHASE_C))
def runs(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"table2_{request.param}")
    ref = load_script("verdict_table2")
    argv = ARGV + PHASE_C[request.param]
    calls = {side: ([], []) for side in ("j", "t")}
    printed = []

    def dumps(obj, *a, **kw):
        printed.append(obj)
        return json.dumps(obj, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        j_tv, j_pb = recorders(*calls["j"])
        t_tv, t_pb = recorders(*calls["t"])
        mp.setattr(j_train, "train_verdict", j_tv)
        mp.setattr(j_train, "predict_in_batches", j_pb)
        mp.setattr(tool, "train_verdict", t_tv)
        mp.setattr(tool, "predict_in_batches", t_pb)
        mp.setattr(ref, "json", types.SimpleNamespace(dumps=dumps))
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            port = pool.submit(tool.main, [*argv, "--device", "cpu",
                                           "--out", str(d / "port.md")])
            with reference_argv(mp, [*argv, "--out", str(d / "ref.md")]):
                ref.main()
            t_res, t_table = port.result()
    return types.SimpleNamespace(d=d, t_res=t_res, t_table=t_table, calls=calls,
                                 j_res=printed[-1]["results"], j_table=printed[-1]["table2"])


def same_arrays(got, want):
    return len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
        for g, w in zip(got, want))


def test_encoded_phases_equal_reference(runs):
    got, want = runs.calls["t"][0], runs.calls["j"][0]
    assert len(got) == len(want) == 6  # 3 phases x 2 restarts
    for g, w in zip(got, want):
        assert same_arrays(g["arrays"], w["arrays"])
        assert g["model"] == w["model"] and g["verdict"] == w["verdict"]
        assert g["kwargs"] == w["kwargs"]
    assert got[0]["model"]["attention"] == "xla" and got[0]["model"]["hidden"] == 128
    assert [g["kwargs"]["seed"] for g in got] == [1009] * 3 + [1110] * 3
    assert {g["kwargs"]["split_seed"] for g in got} == {1009}
    # phase C differs from phases A and B (the replay or the sampled window)
    assert not same_arrays(got[2]["arrays"][:1], got[0]["arrays"][:1])


def test_dev_variants_equal_reference(runs):
    got, want = runs.calls["t"][1], runs.calls["j"][1]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert same_arrays(g["arrays"], w["arrays"])
        assert g["params"] == w["params"]
    assert runs.t_table == runs.j_table
    assert list(runs.t_table) == ["ground_truth", "tfidf_retrieval", "tfidf_retrieval_k3",
                                  "tfidf_retrieval_k1", "claim_only", "random_evidence"]


def test_results_equal_reference(runs):
    for key in ("tfidf_sentence_recall@1", "tfidf_sentence_recall@5", "restart_val_f1s",
                "final_val_macro_f1", "phase_c", "docs", "train_claims", "dev_claims",
                "train_distractors"):
        assert runs.t_res[key] == runs.j_res[key], key
    assert list(runs.t_res) == list(runs.j_res)
    assert 0.0 < runs.t_res["tfidf_sentence_recall@5"] <= 1.0


def test_section_matches_reference(runs):
    got = section(runs.d / "port.md", tool.MARK_BEGIN, tool.MARK_END)
    want = section(runs.d / "ref.md", tool.MARK_BEGIN, tool.MARK_END)
    assert table_rows(got, None) == table_rows(want, None)
    assert "Device: cpu" in got
    assert got.splitlines()[4] == want.splitlines()[2]  # the "##" title
