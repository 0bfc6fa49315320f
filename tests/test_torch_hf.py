"""HuggingFace checkpoints on the port (``featurizer.kind=hf``) against the
JAX package, which reads them through ``transformers``.

The port reads the checkpoint directory and tokenizes by itself
(``models/hf_checkpoint.py``, ``models/hf_tokenizer.py``,
``models/hf_unicode.py``). Every checkpoint here is written offline by
``transformers`` and ``tokenizers`` at tiny widths (64 hidden, 2 layers, as
``tests/test_hf_loading.py``): BERT and RoBERTa in safetensors (F32, BF16,
F16, sharded) and ``.bin`` forms, a ``BertForPreTraining`` save, a ``.bin``
with ``bert.``-prefixed ``gamma``/``beta`` names, and a hub-cache layout.
Checks: equal ``TransformerConfig`` fields; every parameter leaf bit-equal to
the reference's ``from_huggingface``; ``transformer_apply`` on the CPU
within ``ATOL`` of the reference's; token ids, masks and types exactly equal
to ``_HFTokenizerAdapter(AutoTokenizer.from_pretrained(dir))``'s on fixed hard
strings and on derandomized ``hypothesis`` text; the character classes equal
to the Rust library's over every code point; the featurizer, the factory and
the CLI chain (``train``, ``retrieve`` and ``serve --dense-ckpt``) with
``featurizer.kind=hf`` against the reference's.
"""

import dataclasses
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from tokenizers import BertWordPieceTokenizer, ByteLevelBPETokenizer  # noqa: E402
from transformers import (  # noqa: E402
    AutoTokenizer,
    BertConfig,
    BertForPreTraining,
    BertModel,
    RobertaConfig,
    RobertaModel,
)

from _torch_unicode_tables import rust_tables  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401
from test_torch_cli import same_retrieval  # noqa: E402
from ircl_tpu import cli as j_cli  # noqa: E402
from ircl_tpu.contrastive.state import init_train_state as j_init_train_state  # noqa: E402
from ircl_tpu.models import featurizer as j_feat  # noqa: E402
from ircl_tpu.models import transformer as j_tf  # noqa: E402
from ircl_tpu.utils.checkpoint import restore_state as j_restore_state  # noqa: E402
from ircl_tpu_torch import cli as t_cli  # noqa: E402
from ircl_tpu_torch.corpus.synthetic import generate  # noqa: E402
from ircl_tpu_torch.models import featurizer as t_feat  # noqa: E402
from ircl_tpu_torch.models import hf_checkpoint  # noqa: E402
from ircl_tpu_torch.models import hf_unicode  # noqa: E402
from ircl_tpu_torch.models import transformer as t_tf  # noqa: E402
from ircl_tpu_torch.models.hf_tokenizer import from_pretrained_dir  # noqa: E402
from ircl_tpu_torch.utils import convert  # noqa: E402
from ircl_tpu_torch.utils.checkpoint import save_state  # noqa: E402

ATOL = 1e-5  # tests/test_torch_encoder.py's
WIDTHS = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=128, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
BERT = dict(WIDTHS, vocab_size=120, max_position_embeddings=32, type_vocab_size=2)
ROBERTA = dict(WIDTHS, vocab_size=120, max_position_embeddings=34, type_vocab_size=1,
               pad_token_id=1)
HARD = [
    "",
    " ",
    "Hello, World!! It's a TEST...",
    "Ünïcödé façade naïve café Ångström Ωmega ΑΣ Σ İstanbul",
    "東京タワー 北京欢迎你 서울 こんにちは",
    "tab\tnew\nline\rret \x0bvt \x0cff \x85nel \x00nul �rep ​zw ﻿bom",
    "a b c　d \x1c\x1d\x1e\x1f e",
    "!!!...,,,???---(((]]]}}}@@@###$$$%%%^^^&&&***",
    "¿Qué? ¡Sí! «quote» „low“ “curly” ‘single’ — – … · § ¶ † ‡",
    "x" * 101 + " " + "y" * 100 + " " + "z" * 99,
    "they'll we've I'm you're it's he'd 'S 'LL 's 'tis",
    "spaces     runs   \t\t  and\n\n\n  trailing   ",
    "numbers 12345 3.14 1,000 ١٢٣ ⅫⅢ ²³ 🥰🫠 emoji",
    "[MASK] is [SEP] not [mask] <mask> <s> </s> <pad> [CLS][UNK]",
    "x̖̀y ȩ́ \U00011938 ୕ ⹒ \U00016fe2 \U00010d50",
    "control \x01\x02\x7f\x9f format ‎⁦ private  end",
]


@pytest.fixture(autouse=True, scope="module")
def offline():
    """The reference's loaders read only local files: ``transformers`` and
    ``huggingface_hub`` fix their offline flag when first imported, so the
    flag is set on both modules here, and the reference is only ever given
    a directory."""
    import huggingface_hub.constants
    import transformers.utils.hub

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformers.utils.hub, "_is_offline_mode", True)
        mp.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
        yield


def _save(tmp, name, model_cls, hc, **kw):
    path = tmp / name
    torch.manual_seed(7)
    model_cls(hc).save_pretrained(path, **kw)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Every weight form, by name: a directory each."""
    tmp = tmp_path_factory.mktemp("hf")
    bert, roberta = BertConfig(**BERT), RobertaConfig(**ROBERTA)
    out = {
        "bert-safetensors": _save(tmp, "bs", BertModel, bert),
        "bert-bin": _save(tmp, "bb", BertModel, bert, safe_serialization=False),
        "bert-sharded": _save(tmp, "bsh", BertModel, bert, max_shard_size="40KB"),
        "roberta-safetensors": _save(tmp, "rs", RobertaModel, roberta),
        "roberta-bin": _save(tmp, "rb", RobertaModel, roberta, safe_serialization=False),
        "bert-pretraining": _save(tmp, "bp", BertForPreTraining, bert),
    }
    for dtype, name in ((torch.bfloat16, "bert-bf16"), (torch.float16, "bert-f16")):
        torch.manual_seed(7)
        path = tmp / name
        BertModel(bert).to(dtype).save_pretrained(path)
        out[name] = str(path)
    # the original bert-base-uncased layout: BertForPreTraining's names with
    # TensorFlow's LayerNorm gamma/beta, pickled
    path = tmp / "gamma"
    torch.manual_seed(7)
    model = BertForPreTraining(bert)
    model.config.save_pretrained(path)
    sd = {k.replace("LayerNorm.weight", "LayerNorm.gamma").replace(
        "LayerNorm.bias", "LayerNorm.beta"): v for k, v in model.state_dict().items()}
    assert any(k.startswith("bert.") and k.endswith(".gamma") for k in sd)
    torch.save(sd, path / "pytorch_model.bin")
    out["bert-gamma-beta-bin"] = str(path)
    assert os.path.exists(os.path.join(out["bert-sharded"], "model.safetensors.index.json"))
    return out


def _hub_cache(tmp, source, name):
    """``source`` copied into a hub cache under ``name``; the cache's root."""
    cache = tmp / "hub"
    repo = cache / ("models--" + name.replace("/", "--"))
    shutil.copytree(source, repo / "snapshots" / "0123abcd")
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("0123abcd")
    return str(cache)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _same_config(got, want):
    shared = {f.name for f in dataclasses.fields(want)} & {
        f.name for f in dataclasses.fields(got)}
    for name in shared - {"dtype"}:
        assert getattr(got, name) == getattr(want, name), name


def _same_load(name, pad_id=0, ref_dir=None):
    """The port's ``from_huggingface(name)`` against the reference's on the
    directory it resolves to."""
    want_cfg, want = j_tf.from_huggingface(ref_dir or name)
    got_cfg, got = t_tf.from_huggingface(name)
    _same_config(got_cfg, want_cfg)
    # row-major leaves, as init_transformer_params makes them: a transposed
    # view would send the card's GEMMs down another path
    assert all(t.is_contiguous() for t in jax.tree.leaves(got))
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for key, w in want_leaves.items():
        g = got_leaves[key]
        assert g.dtype == np.float32 and w.dtype == np.float32, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    # the forward on the CPU, real and pad positions
    rng = np.random.default_rng(3)
    B, L = 3, 12
    lens = rng.integers(L // 2, L + 1, size=B)
    ids = np.full((B, L), pad_id, np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(3, want_cfg.vocab_size, size=n)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    types = np.zeros((B, L), np.int32)
    types[:, L // 2:] = want_cfg.type_vocab - 1
    ref = np.asarray(jax.jit(lambda p, i, m, t: j_tf.transformer_apply(p, want_cfg, i, m, t))(
        want, ids, mask, types))
    out = t_tf.transformer_apply(got, got_cfg, torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask), torch.from_numpy(types).long())
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    return got_cfg


@pytest.mark.parametrize("form", [
    "bert-safetensors", "bert-bin", "bert-sharded", "bert-bf16", "bert-f16",
    "roberta-safetensors", "roberta-bin", "bert-pretraining", "bert-gamma-beta-bin",
])
def test_from_huggingface_matches_reference(checkpoints, form):
    cfg = _same_load(checkpoints[form], pad_id=1 if form.startswith("roberta") else 0)
    assert cfg.hidden == 64 and cfg.layers == 2
    assert (cfg.position_offset, cfg.max_positions) == (
        (2, 32) if form.startswith("roberta") else (0, 32))


def test_from_huggingface_reads_the_hub_cache(checkpoints, tmp_path, monkeypatch):
    cache = _hub_cache(tmp_path, checkpoints["bert-pretraining"], "some-org/tiny-bert")
    snapshot = os.path.join(cache, "models--some-org--tiny-bert", "snapshots", "0123abcd")
    monkeypatch.setenv("HF_HUB_CACHE", cache)
    assert hf_checkpoint.resolve_checkpoint("some-org/tiny-bert") == snapshot
    _same_load("some-org/tiny-bert", ref_dir=snapshot)
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", os.path.dirname(cache))
    os.rename(cache, os.path.join(os.path.dirname(cache), "hub2"))
    with pytest.raises(FileNotFoundError):
        hf_checkpoint.resolve_checkpoint("some-org/tiny-bert")
    os.rename(os.path.join(os.path.dirname(cache), "hub2"), cache)
    assert hf_checkpoint.resolve_checkpoint("some-org/tiny-bert") == snapshot


def test_both_raise_on_a_missing_name(tmp_path, monkeypatch):
    """A directory that does not exist (the reference's own case), and, in
    the port, a name the hub cache does not hold."""
    missing = str(tmp_path / "nonexistent-model")
    with pytest.raises((OSError, ValueError)):  # the hub's repo-id check
        j_tf.from_huggingface(missing)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    for name in (missing, "some-org/not-cached"):
        with pytest.raises(FileNotFoundError, match="searched") as e:
            t_tf.from_huggingface(name)
        assert os.path.join(str(tmp_path / "empty"), "models--" + name.replace("/", "--"),
                            "refs", "main") in str(e.value)


# ---- tokenizers ---------------------------------------------------------------


def _corpus():
    wiki = generate(num_docs=40, num_claims=10, seed=5)
    return [r["text"] for r in wiki.docs.values()] + [c.claim for c in wiki.claims]


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    """Tokenizer directories by name, each with its reference adapter."""
    tmp = tmp_path_factory.mktemp("tok")
    texts = _corpus() + HARD * 3
    out = {}
    for lower in (True, False):
        wp = BertWordPieceTokenizer(lowercase=lower)
        wp.train_from_iterator(texts, vocab_size=700, min_frequency=1)
        path = tmp / f"bert-{lower}"
        path.mkdir()
        wp.save_model(str(path))
        (path / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "BertTokenizer", "do_lower_case": lower}))
        out["bert-uncased" if lower else "bert-cased"] = str(path)
    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(texts, vocab_size=700, min_frequency=1,
                            special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    path = tmp / "roberta"
    path.mkdir()
    bpe.save_model(str(path))
    RobertaConfig(vocab_size=bpe.get_vocab_size()).save_pretrained(path)
    out["roberta"] = str(path)
    # the fast tokenizers' own saves: tokenizer.json beside the vocab files
    for name in ("bert-uncased", "roberta"):
        path = tmp / f"{name}-json"
        AutoTokenizer.from_pretrained(out[name]).save_pretrained(path)
        if name == "roberta":
            shutil.copy(os.path.join(out[name], "config.json"), path)
        assert (path / "tokenizer.json").exists()
        out[f"{name}-json"] = str(path)
    return {name: (path, j_feat._HFTokenizerAdapter(AutoTokenizer.from_pretrained(path)),
                   from_pretrained_dir(path)) for name, path in out.items()}


TOKENIZERS = ["bert-uncased", "bert-cased", "bert-uncased-json", "roberta", "roberta-json"]


def _same_encoding(ref, port, pairs, max_length):
    try:
        want = ref.encode_batch(pairs, max_length)
    except ValueError:
        with pytest.raises(ValueError):
            port.encode_batch(pairs, max_length)
        return
    got = port.encode_batch(pairs, max_length)
    for w, g, what in zip(want, got, ("ids", "mask", "types")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=f"{what} of {pairs} at {max_length}")


@pytest.mark.parametrize("name", TOKENIZERS)
def test_tokenizer_matches_reference_on_hard_strings(tokenizer_dirs, name):
    _, ref, port = tokenizer_dirs[name]
    assert port.vocab_size == ref.vocab_size
    singles = [(t, None) for t in HARD]
    pairs = [(a, HARD[(3 * i + 5) % len(HARD)]) for i, a in enumerate(HARD)]
    for max_length in (64, 16, 9, 5):
        _same_encoding(ref, port, singles, max_length)
        _same_encoding(ref, port, pairs, max_length)
    # pair truncation at equal and unequal lengths, around the budget
    words = "one two three four five six seven eight".split()
    for n_a in range(0, 8):
        for n_b in (0, 1, 3, 6, 8):
            rows = [(" ".join(words[:n_a]), " ".join(words[:n_b]))]
            for max_length in range(1, 14):
                _same_encoding(ref, port, rows, max_length)


@pytest.mark.parametrize("name", TOKENIZERS)
@settings(derandomize=True, database=None, max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(data=st.data())
def test_tokenizer_matches_reference_on_unicode_text(tokenizer_dirs, name, data):
    _, ref, port = tokenizer_dirs[name]
    text = st.text(max_size=30) | st.lists(st.sampled_from(
        list("abcdefghij '\"!?.,-éüßΣσ東京") + ["'s", "'ll", " \t", "\n", "  ", "[MASK]",
                                                 "<mask>", "<s>"]), max_size=16).map("".join)
    n = data.draw(st.integers(1, 3))
    a = data.draw(st.lists(text, min_size=n, max_size=n))
    b = data.draw(st.one_of(st.none(), st.lists(text, min_size=n, max_size=n)))
    pairs = list(zip(a, b if b is not None else [None] * n))
    _same_encoding(ref, port, pairs, data.draw(st.integers(1, 24)))


def test_character_classes_match_the_rust_library():
    """``hf_unicode``'s tables equal the ones read back from ``tokenizers``
    over every code point (``tests/_torch_unicode_tables.py``)."""
    for name, rows in rust_tables().items():
        assert tuple(map(tuple, getattr(hf_unicode, name))) == rows, name


# ---- the featurizer, the factory and the CLI -----------------------------------


@pytest.fixture(scope="module")
def featurizer_dirs(tokenizer_dirs, tmp_path_factory):
    """A checkpoint with its tokenizer for each model: weights sized to the
    tokenizer's vocabulary."""
    tmp = tmp_path_factory.mktemp("feat")
    out = {}
    for name, model_cls, cfg_cls, widths in (
            ("bert-uncased", BertModel, BertConfig, BERT),
            ("roberta", RobertaModel, RobertaConfig, ROBERTA)):
        path, ref, _ = tokenizer_dirs[name]
        dest = _save(tmp, name, model_cls, cfg_cls(**dict(widths, vocab_size=ref.vocab_size)))
        for f in os.listdir(path):
            if f != "config.json":
                shutil.copy(os.path.join(path, f), dest)
        out[name] = dest
    return out


@pytest.mark.parametrize("name", ["bert-uncased", "roberta"])
def test_featurizer_and_factory_match_reference(featurizer_dirs, name):
    path = featurizer_dirs[name]
    texts = HARD[2:7] + _corpus()[:5]
    j_cfg = j_feat.FeaturizerConfig(kind="hf", hf_name=path, max_len=16)
    t_cfg = t_feat.FeaturizerConfig(kind="hf", hf_name=path, max_len=16)
    for j, t in ((j_feat.TransformerFeaturizer.from_huggingface(path, j_cfg),
                  t_feat.TransformerFeaturizer.from_huggingface(path, t_cfg, device="cpu")),
                 (j_feat.make_featurizer(j_cfg), t_feat.make_featurizer(t_cfg, device="cpu"))):
        assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
        assert t.config.dim == 64 and t.device == torch.device("cpu")
        ids, mask = t.encode_host(texts)
        j_ids, j_mask = j.encode_host(texts)
        np.testing.assert_array_equal(ids, j_ids)
        np.testing.assert_array_equal(mask, j_mask)
        np.testing.assert_allclose(t.features(ids, mask).numpy(),
                                   np.asarray(j.features(j_ids, j_mask)), rtol=0, atol=ATOL)


HF_TINY = [
    "--set", "featurizer.kind=hf",
    "--set", "featurizer.max_len=8",
    "--set", "train.micro_batch=8",
    "--set", "train.accum_steps=1",
    "--set", "train.queue_size=16",
    "--set", "train.encoder.input_size=64",
    "--set", "train.encoder.hidden_size=8",
    "--set", "train.encoder.output_size=8",
    "--set", "train.encoder.num_layers=1",
]


def _cli_workspace(root, run):
    os.makedirs(root)
    cfg = {
        "data": {"data_dir": f"{root}/data", "wiki_json": f"{root}/data/small_wiki.json",
                 "dev_jsonl": f"{root}/data/shared_task_dev.jsonl", "synthetic": True,
                 "synthetic_docs": 40, "synthetic_claims": 20},
        "index": {"hash_size": 262144},
        "ckptdir": f"{root}/ckpt", "logdir": f"{root}/log",
    }
    path = os.path.join(root, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    run(["--config", path, "prepare"])
    run(["--config", path, "build-index"])
    return path


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_train_retrieve_and_serve_with_hf(featurizer_dirs, tmp_path, capsys,
                                             monkeypatch):
    """``train`` 2 steps, ``retrieve --dense-ckpt`` and ``serve --stdin
    --dense-ckpt`` with ``featurizer.kind=hf`` in both packages; the port's
    retrieve and serve also from the reference's state carried across, whose
    outputs must equal the reference's (doc lists up to exact ties, as
    ``tests/test_torch_cli.py`` holds them)."""
    sets = HF_TINY + ["--set", f"featurizer.hf_name={featurizer_dirs['bert-uncased']}"]
    run_t = lambda argv: t_cli.main(["--device", "cpu", *argv])  # noqa: E731
    out = {}
    for name, run in (("j", j_cli.main), ("t", run_t)):
        cfg = _cli_workspace(str(tmp_path / name), run)
        run(["--config", cfg, *sets, "train", "--steps", "2", "--log-step", "2",
             "--seed", "7"])
        ckpt = str(tmp_path / name / "ckpt" / "uniform_InfoNCE_LSTM_2")
        assert os.path.exists(ckpt)
        capsys.readouterr()
        run(["--config", cfg, *sets, "retrieve", "--dense-ckpt", ckpt,
             "--out", str(tmp_path / name / "dense.jsonl")])
        out[name] = (cfg, ckpt, _last_json(capsys))
    assert set(out["t"][2]) == {"doc_recall@k", "sentence_recall@k"}
    # the reference's state in the port's format
    j_cfg = j_cli._load(j_cli.build_parser().parse_args(
        ["--config", out["j"][0], *sets, "retrieve"]))
    j_state = j_restore_state(out["j"][1], j_init_train_state(jax.random.PRNGKey(0),
                                                              j_cfg.train))
    np_ = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    adam = j_state.opt_state[1][0]
    carried = save_state(str(tmp_path / "carried"), "uniform_InfoNCE_LSTM", convert.train_state_from_numpy(
        np_(j_state.params_q), np_(j_state.params_k), np.asarray(j_state.queue),
        int(j_state.queue_ptr), int(j_state.step), count=int(adam.count), mu=np_(adam.mu),
        nu=np_(adam.nu), device="cpu"))
    run_t(["--config", out["t"][0], *sets, "retrieve", "--dense-ckpt", carried,
           "--out", str(tmp_path / "t" / "carried.jsonl")])
    rows = {}
    for name, f in (("j", "dense.jsonl"), ("t", "carried.jsonl")):
        with open(tmp_path / name / f) as lines:
            rows[name] = [json.loads(x) for x in lines]
    same_retrieval((_last_json(capsys), rows["t"]), (out["j"][2], rows["j"]), out["j"][0])
    line = json.dumps({"queries": ["vamu pufo heno"], "sentences": True, "k_sents": 2})
    replies = []
    for run, cfg, ckpt in ((j_cli.main, out["j"][0], out["j"][1]),
                           (run_t, out["t"][0], carried)):
        monkeypatch.setattr("sys.stdin", io.StringIO(line + "\n"))
        capsys.readouterr()
        run(["--config", cfg, *sets, "serve", "--stdin", "--batch-size", "8", "--k", "3",
             "--dense-ckpt", ckpt])
        replies.append(_last_json(capsys))
    want, got = replies
    for g, w in zip(got["results"], want["results"]):
        assert [(h["doc_id"], h["sent_id"], h["sentence"]) for h in g] == [
            (h["doc_id"], h["sent_id"], h["sentence"]) for h in w]
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w],
                                   rtol=1e-5, atol=1e-6)
    assert len(got["results"][0]) == 2
