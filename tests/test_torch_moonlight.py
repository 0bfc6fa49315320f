"""The Moonlight-16B-A3B verdict body (``models/mla_moe.py``,
``models/moe_dropless.py``, ``ops/moe_grouped_gemm_cuda.py``) against the
plain reference (``tests/_torch_moonlight_ref.py``) at a tiny size on the CPU:
hidden 64, 4 heads, nope/rope/v 16/8/16, kv rank 32, 8 experts of width 32,
3 a token, 1 shared, one dense and two MoE layers, vocab 128. Weights are
drawn at a larger scale than the model's (0.08) so that every sublayer moves
the logits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_moonlight_ref as ref
from ircl_tpu_torch.models import mla_moe, moe_dropless
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.ops.moe_grouped_gemm_cuda import (
    grouped_gemm,
    interleave_gate_up,
    swiglu_interleaved,
)
from ircl_tpu_torch.verdict.infer import VerdictClassifier
from ircl_tpu_torch.verdict.model import VerdictConfig, verdict_apply

TINY = {"vocab_size": 128, "hidden_size": 64, "num_hidden_layers": 3,
        "first_k_dense_replace": 1, "intermediate_size": 128, "num_attention_heads": 4,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
        "n_routed_experts": 8, "num_experts_per_tok": 3, "n_shared_experts": 1,
        "moe_intermediate_size": 32, "routed_scaling_factor": 2.446, "norm_topk_prob": True,
        "rms_norm_eps": 1e-5, "rope_theta": 50000, "scoring_func": "sigmoid",
        "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1, "q_lora_rank": None,
        "hidden_act": "silu", "moe_layer_freq": 1, "attention_bias": False,
        "verdict": {"num_labels": 2}, "assumed_init": {"init_std": 0.08, "bias_std": 0.05}}
CFG = mla_moe.MLAMoEConfig.from_hf(TINY, num_labels=2, **TINY["assumed_init"])
# the program's probabilities against the reference's: both round at the same
# points, so only the order of f32 sums differs (a bf16 rounding that tips
# moves a probability by about 1e-3 at this size); each planted fault moves
# one by 0.03 or more
PROB_TOL = 2e-3
SEEDS = [3, 2 ** 31 + 17, 12345678901]


def _batch(seed, rows=6, L=24):
    g = np.random.default_rng(seed)
    lens = g.integers(3, L + 1, size=rows)
    lens[0] = L  # one row without pads
    ids = g.integers(5, TINY["vocab_size"], size=(rows, L))
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    return torch.tensor(ids), torch.tensor(mask), [ids[i, :n] for i, n in enumerate(lens)]


def _probs(params, ids, mask):
    return torch.softmax(mla_moe.score_logits(params, CFG, ids, mask).double(), -1).numpy()


@pytest.fixture(scope="module")
def drawn():
    return {seed: mla_moe.init_mla_moe_params(CFG, seed, "cpu") for seed in SEEDS}


def test_config_from_the_published_keys():
    pub = dict(TINY, num_hidden_layers=27, hidden_size=2048)
    c = mla_moe.MLAMoEConfig.from_hf(pub)
    assert (c.layers, c.hidden, c.experts_per_token, c.routed_scaling) == (27, 2048, 3, 2.446)
    assert c.softmax_scale == pytest.approx(1 / np.sqrt(24))
    for key, bad in [("scoring_func", "softmax"), ("n_group", 8), ("q_lora_rank", 1536),
                     ("rope_scaling", {"type": "yarn"})]:
        with pytest.raises(ValueError, match=key):
            mla_moe.MLAMoEConfig.from_hf(dict(TINY, **{key: bad}))


def test_draw_equals_the_references_draw(drawn):
    seed = SEEDS[1]
    p, W = drawn[seed], ref.Weights(ref.Body(TINY), seed, "cpu")
    assert torch.equal(p["embed"].float(), W("embed"))
    assert torch.equal(p["score"].float(), W("score"))
    for n, lp in enumerate(p["layers"]):
        for name in ("q", "kv_a", "kv_norm", "kv_b", "o"):
            assert torch.equal(lp["attn"][name].float(), W(n, name)), (n, name)
        if n == 0:
            gate, up = lp["mlp"]["gate_up"].float().chunk(2)
            assert torch.equal(gate, W(0, "gate")) and torch.equal(up, W(0, "up"))
            continue
        m = lp["moe"]
        assert m["bias"].dtype == torch.float32 and torch.equal(m["bias"], W(n, "bias"))
        assert torch.equal(m["router"].float(), W(n, "router"))
        w13 = interleave_gate_up(W(n, "gate"), W(n, "up"))
        assert torch.equal(m["w13"].float(), w13) and torch.equal(m["down"].float(), W(n, "down"))
        gate, up = m["shared"]["gate_up"].float().chunk(2)
        assert torch.equal(gate, W(n, "shared_gate")) and torch.equal(up, W(n, "shared_up"))


def test_rms_norm_and_rope_equal_the_reference():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 7, 64, generator=g).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(64, generator=g)).to(torch.bfloat16)
    got = mla_moe.rms_norm(x, w, 1e-5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), ref.rms_norm(x.float(), w.float(), 1e-5))
    cos, sin = mla_moe.rope_tables(CFG, 7, "cpu")
    q = torch.randn(5, 4, 7, 8, generator=g).to(torch.bfloat16)
    assert torch.equal(mla_moe.apply_rope(q, cos, sin).float(),
                       ref.rope(q.float(), cos.float(), sin.float()))
    # position 0 is the identity, after the de-interleave of the pairs
    de = q[..., 0, :].reshape(5, 4, 4, 2).transpose(-1, -2).reshape(5, 4, 8)
    assert torch.equal(mla_moe.apply_rope(q, cos, sin)[..., 0, :], de)


def test_mla_equals_the_reference_on_real_rows(drawn):
    seed = SEEDS[0]
    p, W, b = drawn[seed], ref.Weights(ref.Body(TINY), seed, "cpu"), ref.Body(TINY)
    ids, mask, seqs = _batch(seed)
    x = p["embed"][ids]
    h = mla_moe.rms_norm(x, p["layers"][0]["input_norm"], CFG.rms_eps)
    cos, sin = mla_moe.rope_tables(CFG, ids.shape[1], "cpu")
    got = mla_moe.mla_attention(h, p["layers"][0]["attn"], CFG, cos, sin,
                                mla_moe.attention_mask(mask > 0))
    lens = [len(s) for s in seqs]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = torch.cat([h[i, :n] for i, n in enumerate(lens)]).float()
    want = ref.attention(b, W, 0, flat, list(zip(starts.tolist(), lens)), cos.float(),
                         sin.float())
    got = torch.cat([got[i, :n] for i, n in enumerate(lens)]).float()
    assert (got - want).abs().max() <= 2 ** -7 * want.abs().max()
    assert (got != want).float().mean() < 0.01


def test_router_equals_the_reference_and_the_bias_moves_picks_not_weights(drawn):
    seed = SEEDS[2]
    lp = drawn[seed]["layers"][1]["moe"]
    x = torch.randn(300, 64, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    idx, w = moe_dropless.route(x, lp["router"], lp["bias"], 3, 2.446)
    scores = torch.sigmoid(x.float() @ lp["router"].float().T)
    want_idx = torch.topk(scores + lp["bias"], 3, dim=-1)[1]
    assert torch.equal(idx, want_idx)
    picked = scores.gather(-1, idx)
    assert torch.allclose(w, picked / picked.sum(-1, keepdim=True) * 2.446, rtol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((300,), 2.446), rtol=1e-6)
    # without the bias the picks differ for some tokens; the weights stay the
    # unbiased scores of whatever was picked
    idx0, w0 = moe_dropless.route(x, lp["router"], torch.zeros_like(lp["bias"]), 3, 2.446)
    moved = (idx0.sort(-1)[0] != idx.sort(-1)[0]).any(-1)
    assert 0 < int(moved.sum()) < 300
    same = ~moved
    assert torch.allclose(w0[same].sort(-1)[0], w[same].sort(-1)[0], rtol=1e-6)


def test_pads_route_nowhere_and_rows_are_k_times_real_tokens():
    T, E, k = 40, 8, 3
    g = torch.Generator().manual_seed(2)
    idx = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)])
    real = torch.rand(T, generator=g) < 0.6
    order, offsets = moe_dropless.dispatch(idx, real, E)
    assert offsets.dtype == torch.int32 and int(offsets[-1]) == k * int(real.sum())
    counts = torch.bincount(idx[real].reshape(-1), minlength=E)
    assert torch.equal(offsets.diff().long(), counts)
    tok = order // k
    assert bool(real[tok[: offsets[-1]]].all()) and not bool(real[tok[offsets[-1]:]].any())
    # within an expert, token order (a stable sort)
    for e in range(E):
        run = tok[offsets[e]:offsets[e + 1]]
        assert torch.equal(run, run.sort()[0]) and bool((idx[run] == e).any(-1).all())


def test_grouped_entry_point_equals_a_loop_over_experts():
    E, K, I, R = 6, 64, 32, 50
    g = torch.Generator().manual_seed(3)
    gate, up = (0.1 * torch.randn(E, I, K, generator=g)).to(torch.bfloat16), \
        (0.1 * torch.randn(E, I, K, generator=g)).to(torch.bfloat16)
    down = (0.1 * torch.randn(E, K, I, generator=g)).to(torch.bfloat16)
    x = torch.randn(R + 7, K, generator=g).to(torch.bfloat16)
    offsets = torch.tensor([0, 9, 9, 30, 31, 31, R], dtype=torch.int32)  # empty experts
    h = grouped_gemm(x, interleave_gate_up(gate, up), offsets, swiglu=True)
    y = grouped_gemm(h, down, offsets)
    assert h.shape == (R + 7, I) and y.shape == (R + 7, K)
    for e in range(E):
        lo, hi = int(offsets[e]), int(offsets[e + 1])
        xe = x[lo:hi].float()
        ge = (xe @ gate[e].float().T).to(torch.bfloat16)
        ue = (xe @ up[e].float().T).to(torch.bfloat16)
        he = torch.nn.functional.silu(ge) * ue
        assert torch.equal(h[lo:hi], he)
        assert torch.equal(y[lo:hi], (he.float() @ down[e].float().T).to(torch.bfloat16))
    assert not y[R:].any()  # rows past offsets[E] are not computed
    z = torch.randn(4, 32, generator=g)
    gu = swiglu_interleaved(z)
    zz = z.to(torch.bfloat16).reshape(4, 2, 2, 8)
    assert torch.equal(gu, (torch.nn.functional.silu(zz[:, :, 0]) * zz[:, :, 1]).reshape(4, 16))


@pytest.mark.parametrize("seed", SEEDS)
def test_whole_forward_equals_the_reference(seed, drawn):
    ids, mask, seqs = _batch(seed)
    got = _probs(drawn[seed], ids, mask)
    want = ref.probabilities(TINY, seed, seqs, "cpu")
    assert np.abs(got - want).max() <= PROB_TOL


def test_last_token_pooling(drawn):
    """The pooled state is the last real token's: pads change nothing, and a
    row alone at its real length gives what it gives in the padded batch."""
    p = drawn[SEEDS[0]]
    ids, mask, seqs = _batch(SEEDS[0])
    a = mla_moe.mla_moe_forward(p, CFG, ids, mask)
    other = torch.where(mask > 0, ids, (ids + 11) % TINY["vocab_size"])
    assert torch.equal(a, mla_moe.mla_moe_forward(p, CFG, other, mask))
    for i, s in enumerate(seqs[:3]):
        alone = mla_moe.mla_moe_forward(p, CFG, torch.tensor(s)[None], torch.ones(1, len(s)))
        assert (alone[0].float() - a[i].float()).abs().max() <= 2 ** -6 * a[i].abs().max()


def _plant(monkeypatch, fault):
    route = moe_dropless.route
    if fault == "five_of_six":  # one expert fewer a token
        monkeypatch.setattr(moe_dropless, "route",
                            lambda x, w, b, k, s, n=True: route(x, w, b, k - 1, s, n))
    elif fault == "no_scale":
        monkeypatch.setattr(moe_dropless, "route",
                            lambda x, w, b, k, s, n=True: route(x, w, b, k, 1.0, n))
    elif fault == "no_shared":
        monkeypatch.setattr(mla_moe, "shared_experts", lambda x, p: torch.zeros_like(x))
    else:  # bidirectional: the pad mask alone
        monkeypatch.setattr(mla_moe, "attention_mask",
                            lambda real: real[:, None, None, :].expand(-1, 1, real.shape[1], -1))


@pytest.mark.parametrize("fault", ["five_of_six", "no_shared", "no_scale", "bidirectional"])
def test_each_planted_fault_fails_the_comparison(fault, drawn, monkeypatch):
    for seed in SEEDS:
        ids, mask, seqs = _batch(seed)
        want = ref.probabilities(TINY, seed, seqs, "cpu")
        with monkeypatch.context() as m:
            _plant(m, fault)
            got = _probs(drawn[seed], ids, mask)
        assert np.abs(got - want).max() > 10 * PROB_TOL, (fault, seed)


def test_fp8_experts_are_not_the_reference():
    seed = SEEDS[0]
    _, _, seqs = _batch(seed)
    a = ref.probabilities(TINY, seed, seqs, "cpu")
    b = ref.probabilities(TINY, seed, seqs, "cpu", experts_fp8=True)
    assert np.abs(a - b).max() > 5 * PROB_TOL


def test_classifier_serves_the_body_and_counts_routed_rows(drawn):
    texts = ["the cat sat on the mat", "a dog ran in the park", "birds fly south in winter"]
    tok = WordPieceTokenizer.train(texts * 3, vocab_size=100, min_count=1)
    cfg = VerdictConfig(encoder=CFG, num_labels=2, max_length=16)
    clf = VerdictClassifier(cfg, drawn[SEEDS[0]], tok, batch_size=4)
    assert clf.device.type == "cpu"
    claims, evidence = texts, ["evidence " + t for t in reversed(texts)]
    out = clf.classify(claims, evidence)
    ids, mask, types = tok.encode_batch(list(zip(claims, evidence)) + [("", "")], 16)
    want = torch.softmax(verdict_apply(drawn[SEEDS[0]], cfg, torch.tensor(ids),
                                       torch.tensor(mask), torch.tensor(types)), -1).numpy()
    assert [o["label_id"] for o in out] == want[:3].argmax(-1).tolist()
    assert [o["confidence"] for o in out] == pytest.approx(want[:3].max(-1).tolist(), abs=1e-6)
    c = clf.expert_counters
    assert c.batches == 1 and c.routed_rows == CFG.experts_per_token * int(mask.sum())
    assert 1.0 <= c.load_max_over_mean <= CFG.experts


def test_the_encoder_classifier_still_finds_its_device():
    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.verdict.model import init_verdict_params

    enc = TransformerConfig(vocab_size=64, hidden=16, layers=1, heads=2, intermediate=32,
                            max_positions=32)
    cfg = VerdictConfig(encoder=enc, max_length=16)
    params = init_verdict_params(torch.Generator().manual_seed(0), cfg, "cpu")
    clf = VerdictClassifier(cfg, params, WordPieceTokenizer.train(["a b c"] * 3, 40, 1))
    assert clf.device.type == "cpu" and clf.expert_counters is None
    assert len(clf.classify(["a b"], ["c"])) == 1
