"""``ircl_tpu_torch/tools/similarity_ab.py`` against
``scripts/similarity_ab.py``.

Both ``main()``s run in this process on the same seeds (250 inflected docs,
30 claims), the port's on the CPU in a thread while the reference runs on
JAX's CPU backend, with the contrastive encoder narrowed alike and
``ContrastiveTrainer.train`` a recorder that returns the trainer's initial
state (as in ``tests/test_torch_eval_e2e.py``). Checks: the two divergence
counts equal; both trained runs asked for with the reference's similarity
lists, steps and configuration; the section's markers and metrics equal the
reference's, and writing it beside another tool's section leaves that one
untouched.
"""

import concurrent.futures
import types

import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from _torch_tools import (load_script, narrow_contrastive, reference_argv, section,
                          table_rows, untrained)
from ircl_tpu.contrastive import trainer as j_trainer
from ircl_tpu.models import encoder as j_encoder
from ircl_tpu.models import featurizer as j_featurizer
from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
from ircl_tpu_torch.tools import eval_e2e
from ircl_tpu_torch.tools import similarity_ab as tool

ARGV = ["--docs", "250", "--claims", "30", "--steps", "2"]


def metrics(path):
    return {r[0]: r[1] for r in table_rows(section(path, tool.MARK_BEGIN, tool.MARK_END),
                                           None) if r[0] != "metric"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("similarity_ab")
    ref = load_script("similarity_ab")
    j_calls, t_calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        narrow_contrastive(mp, j_featurizer, j_encoder)
        narrow_contrastive(mp, tool, tool)
        mp.setattr(j_trainer.ContrastiveTrainer, "train", untrained(j_calls))
        mp.setattr(ContrastiveTrainer, "train", untrained(t_calls))
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            port = pool.submit(tool.main, [*ARGV, "--device", "cpu",
                                           "--out", str(d / "port.md")])
            with reference_argv(mp, [*ARGV, "--out", str(d / "ref.md")]):
                ref.main()
            t_res = port.result()
    return types.SimpleNamespace(d=d, t_res=t_res, j_res=metrics(d / "ref.md"),
                                 j_calls=j_calls, t_calls=t_calls)


def test_divergence_counts_equal_reference(runs):
    for key in ("docs_top_pair_changed", "docs_ordering_changed"):
        assert str(runs.t_res[key]) == runs.j_res[key], key
    assert 0.0 < runs.t_res["docs_ordering_changed"] <= 1.0


def test_trained_runs_ask_for_the_reference_runs(runs):
    assert [c["sample"] for c in runs.t_calls] == ["tf_idf", "tf_idf"]
    assert len(runs.j_calls) == 2
    for got, want in zip(runs.t_calls, runs.j_calls):
        assert got == want
    assert runs.t_calls[0]["similarity"] != runs.t_calls[1]["similarity"]


def test_section_matches_reference(runs):
    got = metrics(runs.d / "port.md")
    assert list(got) == list(runs.j_res)
    for key in ("docs", "claims", "inflect_prob", "steps", "docs_top_pair_changed",
                "docs_ordering_changed"):
        assert got[key] == runs.j_res[key], key
    assert "Device: cpu" in section(runs.d / "port.md", tool.MARK_BEGIN, tool.MARK_END)


def test_section_beside_another_tool(runs, tmp_path):
    path = str(tmp_path / "r.md")
    eval_e2e.write_results(path, types.SimpleNamespace(
        docs=10, claims=2, steps=1, featurizer="hash"), {"a": 1},
        {"doc_tfidf": {k: 0.5 for k in eval_e2e.KS}}, "cpu")
    other = section(path, *eval_e2e.marks("hash"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ContrastiveTrainer, "train", untrained([]))
        narrow_contrastive(mp, tool, tool)
        for steps in ("1", "2"):
            tool.main(["--docs", "60", "--claims", "5", "--steps", steps,
                       "--device", "cpu", "--out", path])
    assert section(path, *eval_e2e.marks("hash")) == other
    assert "| steps | 2 |" in section(path, tool.MARK_BEGIN, tool.MARK_END)
