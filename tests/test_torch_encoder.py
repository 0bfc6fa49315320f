"""The port's sentence encoder against ``ircl_tpu``'s on the same weights.

Each JAX function's parameters are carried across with
``ircl_tpu_torch/utils/convert.py`` (``np.asarray`` on the JAX side), and
the same seeded inputs go through both packages: the BiLSTM, the encoder
head (both ``masked_mean`` values, every activation), the transformer
(2 layers, 64 hidden, 4 heads, L=16 with real positions and pads), both
featurizers, ``make_embed_fn`` and ``embed_corpus``. Tolerance: 1e-5
absolute on activations and unit embeddings (fp32 everywhere, sums in
another order); host arrays (token ids, masks, vocabularies) exactly.
Initializers draw from other generators in the two packages, so they are
held to the reference's shapes and distributions, not its values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from ircl_tpu.contrastive.state import TrainConfig as JTrainConfig
from ircl_tpu.contrastive.train import make_embed_fn as j_make_embed_fn
from ircl_tpu.dense.embed import embed_corpus as j_embed_corpus
from ircl_tpu.models import encoder as j_enc
from ircl_tpu.models import featurizer as j_feat
from ircl_tpu.models import transformer as j_tf
from ircl_tpu.models.wordpiece import WordPieceTokenizer as JWordPiece
from ircl_tpu.ops import bilstm as j_lstm
from ircl_tpu_torch.contrastive.state import TrainConfig
from ircl_tpu_torch.contrastive.train import make_embed_fn
from ircl_tpu_torch.dense.embed import embed_corpus
from ircl_tpu_torch.models import encoder as t_enc
from ircl_tpu_torch.models import featurizer as t_feat
from ircl_tpu_torch.models import transformer as t_tf
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.ops import bilstm as t_lstm
from ircl_tpu_torch.ops.flash_attention_cuda import flash_attention
from ircl_tpu_torch.utils import convert

ATOL = 1e-5

TEXTS = [
    "Nikolaj Coster-Waldau worked with the Fox Broadcasting Company.",
    "Roman Atwood is a content creator.",
    "",
    "The Ten Commandments is an epic film.",
    "Café au lait, naïve résumé: non-ASCII text takes the Python path.",
    "History of art includes architecture, dance, sculpture, music, painting, "
    "poetry literature, theatre, narrative, film, photography and graphic arts.",
    "Tokyo",
]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("layers", [1, 2])
def test_bilstm_matches_jax(bidirectional, layers):
    rng = np.random.default_rng(0)
    j_params = j_lstm.init_bilstm_params(
        jax.random.PRNGKey(1), 12, 8, layers, bidirectional
    )
    # a non-zero bias, so the folded bias is exercised
    j_params = [{d: dict(p, b=jnp.asarray(rng.normal(size=32), jnp.float32))
                 for d, p in lp.items()} for lp in j_params]
    x = rng.normal(size=(3, 7, 12)).astype(np.float32)
    want = np.asarray(j_lstm.bilstm_apply(j_params, jnp.asarray(x)))
    t_params = convert.encoder_params_from_numpy(
        {"lstm": _np_tree(j_params), "proj_w": np.zeros((1, 1)), "proj_b": np.zeros(1)},
        device="cpu",
    )["lstm"]
    got = t_lstm.bilstm_apply(t_params, _t(x)).numpy()
    assert got.shape == want.shape == (3, 7, 8 * (2 if bidirectional else 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bilstm_init_has_the_reference_shapes_and_laws():
    j_params = j_lstm.init_bilstm_params(jax.random.PRNGKey(0), 24, 16, 2, True)
    gen = torch.Generator().manual_seed(0)
    t_params = t_lstm.init_bilstm_params(gen, 24, 16, 2, True, device="cpu")
    assert jax.tree.structure(_np_tree(j_params)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), t_params)
    )
    for jl, tl in zip(j_params, t_params):
        for d in ("fwd", "bwd"):
            for name in ("w_ih", "w_hh", "b"):
                assert tuple(tl[d][name].shape) == jl[d][name].shape
            w_ih, w_hh = tl[d]["w_ih"], tl[d]["w_hh"]
            limit = (6.0 / sum(w_ih.shape)) ** 0.5
            assert float(w_ih.abs().max()) <= limit
            np.testing.assert_allclose(  # orthonormal columns, as the reference's
                (w_hh.T @ w_hh).numpy(), np.eye(16), atol=1e-5
            )
            np.testing.assert_allclose(
                np.asarray(jl[d]["w_hh"]).T @ np.asarray(jl[d]["w_hh"]),
                np.eye(16), atol=1e-5,
            )
            assert not tl[d]["b"].any()
    # the same seed draws the same weights on every call
    again = t_lstm.init_bilstm_params(torch.Generator().manual_seed(0), 24, 16, 2,
                                      device="cpu")
    assert torch.equal(again[1]["bwd"]["w_hh"], t_params[1]["bwd"]["w_hh"])


def _small_encoder(**kw):
    return dict(input_size=12, hidden_size=8, output_size=6, num_layers=2, **kw)


@pytest.mark.parametrize("masked_mean", [False, True])
@pytest.mark.parametrize("activation", ["identity", "tanh", "relu", "gelu"])
def test_encoder_and_seq2vec_match_jax(masked_mean, activation):
    kw = _small_encoder(activation=activation, masked_mean=masked_mean)
    j_cfg, t_cfg = j_enc.EncoderConfig(**kw), t_enc.EncoderConfig(**kw)
    j_params = j_enc.init_encoder_params(jax.random.PRNGKey(3), j_cfg)
    t_params = convert.encoder_params_from_numpy(_np_tree(j_params), device="cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 9, 12)).astype(np.float32)
    mask = np.zeros((4, 9), np.float32)
    for b, n in enumerate([9, 5, 1, 0]):  # a full row, pads, an empty row
        mask[b, :n] = 1.0
    x = x * mask[:, :, None]
    np.testing.assert_allclose(
        t_enc.encoder_apply(t_params, t_cfg, _t(x)).numpy(),
        np.asarray(j_enc.encoder_apply(j_params, j_cfg, jnp.asarray(x))),
        rtol=0, atol=ATOL,
    )
    want = np.asarray(j_enc.seq2vec(j_params, j_cfg, jnp.asarray(x), jnp.asarray(mask)))
    got = t_enc.seq2vec(t_params, t_cfg, _t(x), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_seq2vec_keeps_the_norm_floor():
    """An all-zero embedding stays zero (norm floored at 1e-12), as in the
    reference; no NaN."""
    cfg = t_enc.EncoderConfig(**_small_encoder())
    params = t_enc.init_encoder_params(torch.Generator().manual_seed(0), cfg,
                                       device="cpu")
    params["proj_w"] = torch.zeros_like(params["proj_w"])
    out = t_enc.seq2vec(params, cfg, torch.zeros(2, 3, 12))
    assert torch.equal(out, torch.zeros(2, 6))


def test_encoder_init_matches_the_reference_layout():
    cfg = t_enc.EncoderConfig()
    j_params = j_enc.init_encoder_params(jax.random.PRNGKey(0), j_enc.EncoderConfig())
    t_params = t_enc.init_encoder_params(torch.Generator().manual_seed(0), cfg,
                                       device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: tuple(np.shape(a)), tree)
    assert shapes(jax.tree.map(lambda t: t.numpy(), t_params)) == shapes(j_params)
    assert tuple(t_params["proj_w"].shape) == (128, 512)


def test_configs_keep_the_reference_fields_and_defaults():
    pairs = [
        (t_enc.EncoderConfig, j_enc.EncoderConfig),
        (t_feat.FeaturizerConfig, j_feat.FeaturizerConfig),
        (TrainConfig, JTrainConfig),
    ]
    for t_cls, j_cls in pairs:
        t_fields = {f.name: f.default for f in dataclasses.fields(t_cls)}
        j_fields = {f.name: f.default for f in dataclasses.fields(j_cls)}
        assert t_fields.keys() == j_fields.keys(), t_cls
        for name in t_fields:
            if name == "encoder":
                assert dataclasses.asdict(t_fields[name]) == dataclasses.asdict(
                    j_fields[name]
                )
            else:
                assert t_fields[name] == j_fields[name], (t_cls, name)
    t_tf_fields = {f.name: f.default for f in dataclasses.fields(t_tf.TransformerConfig)}
    j_tf_fields = {f.name: f.default for f in dataclasses.fields(j_tf.TransformerConfig)}
    assert t_tf_fields.keys() == j_tf_fields.keys()
    for name in t_tf_fields:
        if name != "dtype":
            assert t_tf_fields[name] == j_tf_fields[name], name
    assert t_tf.TransformerConfig().dtype == torch.float32


TF_KW = dict(vocab_size=50, hidden=64, layers=2, heads=4, intermediate=96,
             max_positions=32)


@pytest.fixture(scope="module")
def tf_pair():
    j_cfg, t_cfg = j_tf.TransformerConfig(**TF_KW), t_tf.TransformerConfig(**TF_KW)
    j_params = j_tf.init_transformer_params(jax.random.PRNGKey(5), j_cfg)
    # LayerNorm scales and biases off their init values, so both are used
    rng = np.random.default_rng(7)
    j_params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.normal(size=a.shape),
                              jnp.float32),
        j_params,
    )
    t_params = convert.transformer_params_from_numpy(_np_tree(j_params), device="cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 50, size=(3, 16)).astype(np.int32)
    mask = np.zeros((3, 16), np.float32)
    for b, n in enumerate([16, 9, 2]):
        mask[b, :n] = 1.0
    return j_cfg, t_cfg, j_params, t_params, ids, mask


def test_transformer_matches_jax(tf_pair):
    j_cfg, t_cfg, j_params, t_params, ids, mask = tf_pair
    np.testing.assert_allclose(
        t_tf.transformer_embed(t_params, t_cfg, _t(ids).long()).numpy(),
        np.asarray(j_tf.transformer_embed(j_params, j_cfg, jnp.asarray(ids))),
        rtol=0, atol=ATOL,
    )
    np.testing.assert_array_equal(
        t_tf.attention_mask_inputs(t_cfg, _t(mask)).numpy(),
        np.asarray(j_tf.attention_mask_inputs(j_cfg, jnp.asarray(mask))),
    )
    want = np.asarray(j_tf.transformer_apply(j_params, j_cfg, jnp.asarray(ids),
                                             jnp.asarray(mask)))
    got = t_tf.transformer_apply(t_params, t_cfg, _t(ids).long(), _t(mask)).numpy()
    assert got.shape == (3, 16, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_transformer_block_and_sublayer_match_jax(tf_pair):
    j_cfg, t_cfg, j_params, t_params, ids, mask = tf_pair
    x = np.random.default_rng(4).normal(size=(3, 16, 64)).astype(np.float32)
    j_ctx = j_tf.attention_mask_inputs(j_cfg, jnp.asarray(mask))
    t_ctx = t_tf.attention_mask_inputs(t_cfg, _t(mask))
    lp_j, lp_t = j_params["layers"][1], t_params["layers"][1]
    np.testing.assert_allclose(
        t_tf.attention_sublayer(_t(x), lp_t, t_cfg, t_ctx).numpy(),
        np.asarray(j_tf.attention_sublayer(jnp.asarray(x), lp_j, j_cfg, j_ctx)),
        rtol=0, atol=ATOL,
    )
    np.testing.assert_allclose(
        t_tf.transformer_block(_t(x), lp_t, t_cfg, t_ctx).numpy(),
        np.asarray(j_tf.transformer_block(jnp.asarray(x), lp_j, j_cfg, j_ctx)),
        rtol=0, atol=ATOL,
    )


def test_transformer_real_positions_ignore_the_pads(tf_pair):
    """A real position's output does not depend on what the pads hold."""
    _, t_cfg, _, t_params, ids, mask = tf_pair
    other = ids.copy()
    other[mask == 0] = 7
    a = t_tf.transformer_apply(t_params, t_cfg, _t(ids).long(), _t(mask)).numpy()
    b = t_tf.transformer_apply(t_params, t_cfg, _t(other).long(), _t(mask)).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(a[real], b[real], rtol=0, atol=ATOL)


def test_transformer_init_matches_the_reference_layout():
    j_params = j_tf.init_transformer_params(
        jax.random.PRNGKey(0), j_tf.TransformerConfig(**TF_KW)
    )
    t_params = t_tf.init_transformer_params(
        torch.Generator().manual_seed(0), t_tf.TransformerConfig(**TF_KW),
        device="cpu",
    )
    shapes = lambda tree: jax.tree.map(lambda a: tuple(np.shape(a)), tree)
    assert shapes(jax.tree.map(lambda t: t.numpy(), t_params)) == shapes(j_params)
    w = t_params["layers"][0]["ff1"]["w"]
    assert abs(float(w.std()) - 0.02) < 0.002


@pytest.mark.parametrize("make", [
    # flash attention is ported for the served float32 path; bf16 comes
    # with verdict training
    lambda: flash_attention(*(torch.zeros(1, 1, 128, 16, dtype=torch.bfloat16),) * 3),
    lambda: t_tf.TransformerConfig(moe=object()),
], ids=["flash", "moe"])
def test_unported_transformer_options_raise(make):
    with pytest.raises(NotImplementedError, match="item (9|11)"):
        make()


@pytest.mark.parametrize("axis", ["model_axis", "expert_axis", "seq_axis"])
def test_explicit_collective_axes_wait_for_item_12(tf_pair, axis):
    _, t_cfg, _, t_params, ids, mask = tf_pair
    x = torch.zeros(1, 4, 64)
    ctx = t_tf.attention_mask_inputs(t_cfg, torch.ones(1, 4))
    with pytest.raises(NotImplementedError, match="item 12"):
        t_tf.transformer_block(x, t_params["layers"][0], t_cfg, ctx, **{axis: "x"})


def test_from_huggingface_names_the_missing_files():
    with pytest.raises(NotImplementedError, match="bert-base-uncased"):
        t_tf.from_huggingface()
    with pytest.raises(NotImplementedError, match="local"):
        t_feat.make_featurizer(t_feat.FeaturizerConfig(kind="hf"))


HASH_CFG = dict(dim=16, max_len=8, vocab_buckets=1 << 10)


def _hash_pair():
    j = j_feat.HashEmbedFeaturizer(j_feat.FeaturizerConfig(**HASH_CFG))
    t = t_feat.HashEmbedFeaturizer(
        t_feat.FeaturizerConfig(**HASH_CFG),
        device="cpu",
        params=convert.hash_featurizer_params_from_numpy(_np_tree(j.params), device="cpu"),
    )
    return j, t


def test_hash_featurizer_matches_jax():
    j, t = _hash_pair()
    ids, mask = t.encode_host(TEXTS)
    j_ids, j_mask = j.encode_host(TEXTS)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(mask, j_mask)
    assert mask[2].sum() == 0 and mask[5].sum() == 8  # empty text; truncated
    np.testing.assert_array_equal(
        t.features(ids, mask).numpy(),
        np.asarray(j.features(jnp.asarray(ids), jnp.asarray(mask))),
    )
    # its own draw: the reference's positions, a unit-normal table
    own = t_feat.HashEmbedFeaturizer(t_feat.FeaturizerConfig(**HASH_CFG), device="cpu")
    np.testing.assert_allclose(own.params["pos"].numpy(), np.asarray(j.pos), atol=1e-7)
    assert own.params["table"].shape == (1 << 10, 16)
    assert abs(float(own.params["table"].std()) - 1.0) < 0.05


WP_CFG = dict(kind="transformer", dim=64, max_len=16, tf_layers=2, tf_heads=4,
              tf_intermediate=96, wp_vocab=300)


@pytest.fixture(scope="module")
def tf_featurizers():
    from ircl_tpu.corpus.synthetic import generate

    texts = [r["text"] for r in generate(num_docs=40, num_claims=2, seed=3).docs.values()]
    j = j_feat.TransformerFeaturizer.train_from_corpus(
        texts, j_feat.FeaturizerConfig(**WP_CFG)
    )
    t_cfg = t_feat.FeaturizerConfig(**WP_CFG)
    tok = WordPieceTokenizer.train(texts, vocab_size=300)
    t = t_feat.TransformerFeaturizer(
        tok, t_tf.TransformerConfig(**{
            f.name: getattr(j.tcfg, f.name)
            for f in dataclasses.fields(j.tcfg) if f.name not in ("dtype",)
        }),
        convert.transformer_params_from_numpy(_np_tree(j.params), device="cpu"), t_cfg,
        device="cpu",
    )
    return texts, j, t


def test_wordpiece_is_the_reference_tokenizer(tf_featurizers, tmp_path):
    texts, j, t = tf_featurizers
    assert t.tokenizer.vocab == j.tokenizer.vocab
    for text in TEXTS + texts[:5]:
        assert t.tokenizer.tokenize(text) == j.tokenizer.tokenize(text)
    pairs = [(TEXTS[0], TEXTS[1]), (TEXTS[3], None), ("", "")]
    for got, want in zip(t.tokenizer.encode_batch(pairs, 12),
                         j.tokenizer.encode_batch(pairs, 12)):
        np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "vocab.txt")
    t.tokenizer.save_vocab(path)
    assert JWordPiece.from_vocab_file(path).vocab == t.tokenizer.vocab


def test_transformer_featurizer_matches_jax(tf_featurizers):
    _, j, t = tf_featurizers
    ids, mask = t.encode_host(TEXTS)
    j_ids, j_mask = j.encode_host(TEXTS)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(mask, j_mask)
    got = t.features(ids, mask).numpy()
    want = np.asarray(j.features(ids, j_mask))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not got[mask == 0].any()  # pads zeroed


def test_transformer_featurizer_random_init_and_factory(tf_featurizers):
    texts, j, _ = tf_featurizers
    cfg = t_feat.FeaturizerConfig(**WP_CFG)
    a = t_feat.make_featurizer(cfg, corpus_texts=texts, device="cpu")
    b = t_feat.TransformerFeaturizer.train_from_corpus(texts, cfg, device="cpu")
    assert a.tcfg == b.tcfg and a.tcfg.vocab_size == j.tcfg.vocab_size
    assert torch.equal(a.params["layers"][1]["q"]["w"], b.params["layers"][1]["q"]["w"])
    with pytest.raises(ValueError, match="corpus_texts"):
        t_feat.make_featurizer(cfg)
    with pytest.raises(ValueError, match="unknown featurizer"):
        t_feat.make_featurizer(t_feat.FeaturizerConfig(kind="bow"))
    assert isinstance(
        t_feat.make_featurizer(t_feat.FeaturizerConfig(**HASH_CFG), device="cpu"),
        t_feat.HashEmbedFeaturizer,
    )


def _embed_pair(j_featurizer, t_featurizer, input_size):
    enc = dict(input_size=input_size, hidden_size=8, output_size=8, num_layers=2)
    j_cfg = JTrainConfig(encoder=j_enc.EncoderConfig(**enc))
    t_cfg = TrainConfig(encoder=t_enc.EncoderConfig(**enc))
    j_params = j_enc.init_encoder_params(jax.random.PRNGKey(11), j_cfg.encoder)
    t_params = convert.encoder_params_from_numpy(_np_tree(j_params), device="cpu")
    return (j_make_embed_fn(j_cfg, j_featurizer), j_params,
            make_embed_fn(t_cfg, t_featurizer), t_params)


@pytest.mark.parametrize("kind", ["hash", "transformer"])
def test_make_embed_fn_and_embed_corpus_match_jax(kind, tf_featurizers):
    if kind == "hash":
        j, t = _hash_pair()
        dim = HASH_CFG["dim"]
    else:
        _, j, t = tf_featurizers
        dim = WP_CFG["dim"]
    j_fn, j_params, t_fn, t_params = _embed_pair(j, t, dim)
    ids, mask = t.encode_host(TEXTS)
    got = t_fn(t_params, ids, mask)
    assert isinstance(got, torch.Tensor) and not got.requires_grad
    want = np.asarray(j_fn(j_params, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    texts = TEXTS * 3  # 21 texts: batches of 8, a ragged tail of 5
    got_c = embed_corpus(t_fn, t_params, t, texts, batch_size=8)
    want_c = j_embed_corpus(j_fn, j_params, j, texts, batch_size=8)
    assert got_c.shape == want_c.shape == (21, 8) and got_c.dtype == np.float32
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=ATOL)
    # unit rows, but for a hash-featurized empty text: zero features give a
    # zero embedding (the 1e-12 norm floor), as in the reference
    empty = np.array([t == "" and kind == "hash" for t in texts])
    norms = np.linalg.norm(got_c, axis=1)
    np.testing.assert_allclose(norms[~empty], 1.0, atol=1e-5)
    assert not got_c[empty].any()
    # rows do not depend on their batch-mates or position
    alone = embed_corpus(t_fn, t_params, t, [texts[9]], batch_size=8)
    np.testing.assert_allclose(alone[0], got_c[9], rtol=0, atol=1e-6)


def test_embed_corpus_edges():
    _, t = _hash_pair()
    cfg = TrainConfig(encoder=t_enc.EncoderConfig(**_small_encoder() | {"input_size": 16}))
    params = t_enc.init_encoder_params(torch.Generator().manual_seed(0), cfg.encoder,
                                       device="cpu")
    fn = make_embed_fn(cfg, t)
    assert embed_corpus(fn, params, t, []).shape == (0, 0)
    with pytest.raises(NotImplementedError, match="item 12"):
        embed_corpus(fn, params, t, TEXTS, mesh=object())
