"""``ircl_tpu_torch/tools/eval_e2e.py`` against ``scripts/eval_e2e.py``.

Both ``main()``s run in this process on the same seeds, 200 docs and 30
claims, every trained variant (stem A/B, ProtoNCE, HProtoNCE), the port's
on the CPU in a thread while the reference runs on JAX's CPU backend. The
contrastive encoder is narrowed alike in both (featurizer 16 wide over 4096
buckets, one BiLSTM layer of 8) and ``ContrastiveTrainer.train`` is a
recorder that returns the trainer's initial state: a train step compiles
for seconds in JAX for every trainer, and the trained rows draw from
different generators in the two packages, so only their configuration is
compared. Checks: the stage-1 (``doc_tfidf``) and ``sparse`` rows equal;
``dense_untrained`` equal once the reference's state and hash-embedding
table are carried across (``utils/convert.py``), its cosines within 1e-5;
every trained variant asked for with the reference's sampler, similarity
lists, step count and configuration (the ProtoNCE cluster sizing); the
written section's markers, metrics and recall@k columns equal the
reference's; rewriting one section leaves the others untouched.
"""

import concurrent.futures
import types

import jax
import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from _torch_tools import (NARROW_ENCODER, config_fields, load_script, narrow_contrastive,
                          reference_argv, section, table_rows, untrained)
from ircl_tpu.contrastive import trainer as j_trainer
from ircl_tpu.models import encoder as j_encoder
from ircl_tpu.models import featurizer as j_featurizer
from ircl_tpu.pipeline import dense_scorer as j_dense_scorer
from ircl_tpu.pipeline.intrinsic import mean_claim_evidence_cosine as j_cosine
from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer
from ircl_tpu_torch.pipeline.dense_scorer import ContrastiveSentenceScorer
from ircl_tpu_torch.tools import eval_e2e as tool
from ircl_tpu_torch.tools.results import TITLE
from ircl_tpu_torch.utils import convert

ARGV = ["--docs", "200", "--claims", "30", "--steps", "3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_e2e")
    ref = load_script("eval_e2e")
    j_calls, t_calls, scorers, written = [], [], [], []

    class RecordingScorer(j_dense_scorer.ContrastiveSentenceScorer):
        def __init__(self, config, featurizer, state, *a, **kw):
            scorers.append((config, featurizer, state))
            super().__init__(config, featurizer, state, *a, **kw)

    def record_results(path, args, results, sweep):
        written.append((results, sweep))
        return write(path, args, results, sweep)

    write = ref.write_results
    with pytest.MonkeyPatch.context() as mp:
        narrow_contrastive(mp, j_featurizer, j_encoder)
        narrow_contrastive(mp, tool, tool)
        mp.setattr(j_trainer.ContrastiveTrainer, "train", untrained(j_calls))
        mp.setattr(ContrastiveTrainer, "train", untrained(t_calls))
        mp.setattr(j_dense_scorer, "ContrastiveSentenceScorer", RecordingScorer)
        mp.setattr(ref, "write_results", record_results)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            port = pool.submit(tool.main, [*ARGV, "--device", "cpu",
                                           "--out", str(d / "port.md")])
            with reference_argv(mp, [*ARGV, "--out", str(d / "ref.md")]):
                ref.main()
            t_results, t_sweep = port.result()
    j_results, j_sweep = written[0]
    return types.SimpleNamespace(
        d=d, j_results=j_results, j_sweep=j_sweep, t_results=t_results,
        t_sweep=t_sweep, j_calls=j_calls, t_calls=t_calls, j_untrained=scorers[0])


def test_stage1_and_sparse_rows_equal_reference(runs):
    for tag in ("doc_tfidf", "sparse"):
        assert runs.t_sweep[tag] == runs.j_sweep[tag], tag
    for key in ("doc_recall@5", "sentence_recall@5_sparse", "corpus_docs", "claims"):
        assert runs.t_results[key] == runs.j_results[key], key
    assert 0.0 < runs.t_sweep["doc_tfidf"][100] <= 1.0


def test_dense_untrained_equals_reference_on_carried_weights(runs):
    j_cfg, j_feat, j_state = runs.j_untrained
    np_ = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    adam = j_state.opt_state[1][0]
    state = convert.train_state_from_numpy(
        np_(j_state.params_q), np_(j_state.params_k), np.asarray(j_state.queue),
        int(j_state.queue_ptr), int(j_state.step), count=int(adam.count),
        mu=np_(adam.mu), nu=np_(adam.nu), device="cpu")
    feat = HashEmbedFeaturizer(
        FeaturizerConfig(**config_fields(j_feat.config)), device="cpu",
        params=convert.hash_featurizer_params_from_numpy(np_(j_feat.params), "cpu"))
    t_cfg = tool.TrainConfig(
        encoder=tool.EncoderConfig(**NARROW_ENCODER, masked_mean=True), micro_batch=128,
        accum_steps=2, queue_start_steps=300, learning_rate=2.5e-4)
    assert config_fields(t_cfg) == config_fields(j_cfg)
    wiki, claims_text, ranker, _ = tool.build_corpus(200, 30, "cpu")
    scorer = ContrastiveSentenceScorer(t_cfg, feat, state)
    row, cos = tool.stage2(wiki, claims_text, ranker, scorer)
    assert row == runs.j_sweep["dense_untrained"]
    want = j_cosine(j_dense_scorer.ContrastiveSentenceScorer(j_cfg, j_feat, j_state).embed,
                    wiki.claims, wiki.sentences)
    for key in ("mean_cosine", "shuffled_cosine"):
        assert abs(cos[key] - want[key]) <= 1e-5, key


def test_trained_variants_ask_for_the_reference_runs(runs):
    assert [c["sample"] for c in runs.t_calls] == [
        "augment", "uniform", "tf_idf", "tf_idf", "uniform", "uniform"]
    assert len(runs.t_calls) == len(runs.j_calls)
    for got, want in zip(runs.t_calls, runs.j_calls):
        assert got["sample"] == want["sample"] and got["steps"] == want["steps"] == 3
        assert got["config"] == want["config"]
        assert got["similarity"] == want["similarity"]
    proto = runs.t_calls[4]["config"]
    assert proto["loss"] == "ProtoNCE" and proto["num_clusters"] == (32, 48, 64)
    assert (proto["cluster_start_steps"], proto["cluster_update_steps"]) == (1, 1)
    assert runs.t_calls[5]["config"]["loss"] == "HProtoNCE"


def test_section_matches_reference(runs):
    begin, end = tool.marks("hash")
    got = section(runs.d / "port.md", begin, end)
    want = section(runs.d / "ref.md", begin, end)
    assert "Device: cpu" in got
    assert open(runs.d / "port.md").read().startswith(TITLE)
    metric = lambda text: [r[0] for r in table_rows(text, None)  # noqa: E731
                           if r[0] not in runs.t_sweep and r[0] != "variant"]
    assert metric(got) == metric(want)
    header = [r for r in table_rows(got, {"variant"})]
    assert header == table_rows(want, {"variant"})
    assert header[0][1:] == [f"k={k}" for k in tool.KS]
    rows = table_rows(got, set(runs.t_sweep))
    assert [r[0] for r in rows] == [r[0] for r in table_rows(want, set(runs.j_sweep))]
    for r in rows[:2]:  # doc_tfidf and sparse: the reference's cells
        assert r in table_rows(want, {r[0]})


def test_rewriting_one_section_leaves_the_others(tmp_path):
    path = str(tmp_path / "r.md")
    sweep = {"doc_tfidf": {k: 0.5 for k in tool.KS}}
    args = lambda f: types.SimpleNamespace(  # noqa: E731
        docs=10, claims=2, steps=1, featurizer=f)
    tool.write_results(path, args("hash"), {"a": 1}, sweep, "cpu")
    tool.write_results(path, args("transformer"), {"b": 2}, sweep, "cpu")
    other = section(path, *tool.marks("transformer"))
    tool.write_results(path, args("hash"), {"a": 3}, sweep, "cpu")
    text = open(path).read()
    assert section(path, *tool.marks("transformer")) == other
    assert "| a | 3 |" in section(path, *tool.marks("hash")) and "| a | 1 |" not in text
    assert text.index(tool.marks("hash")[0]) < text.index(tool.marks("transformer")[0])
    assert text.startswith("# RESULTS_TORCH") and "Device of the last run: cpu" in text


def test_transformer_featurizer_takes_the_reference_config(monkeypatch):
    """``--featurizer transformer``: the script's frozen 12-layer featurizer
    config (768 wide, ``max_len`` 32, an 8,192-piece WordPiece vocab) built
    from the corpus texts, its training time reported; the featurizer
    itself is recorded, not built."""
    made = []
    monkeypatch.setattr(tool, "make_featurizer",
                        lambda cfg, texts=None, device=None: made.append((cfg, texts)))
    wiki = types.SimpleNamespace(docs={"a": {"text": "one two"}, "b": {"text": "three"}})
    results = {}
    _, cfg = tool.featurizer_and_config("transformer", wiki, "cpu", results)
    (fcfg, texts), = made
    assert (fcfg.kind, fcfg.dim, fcfg.max_len, fcfg.wp_vocab) == ("transformer", 768, 32, 8192)
    assert texts == ["one two", "three"] and "wordpiece_train_s" in results
    assert cfg.encoder.masked_mean and (cfg.micro_batch, cfg.accum_steps) == (128, 2)
    assert tool.marks("transformer") == ("<!-- eval-transformer:begin -->",
                                         "<!-- eval-transformer:end -->")
