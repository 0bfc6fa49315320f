"""The port's counterpart of ``__graft_entry__.py``: a one-device forward
and a multi-rank dry run.

    python3 -m ircl_tpu_torch.graft_entry [entry | dryrun N] [--device cpu]

``entry()`` returns the contrastive forward loss of the flagship retrieval
model (frozen hash featurizer -> BiLSTM head -> NT-Xent) and its example
arguments. ``dryrun_multichip(n)`` runs the reference's twelve sections, in
its order, on ``n`` ranks of ``parallel/launch.py`` at tiny shapes:

1. ``dp``: one data-parallel contrastive step;
2. ``dense``: the corpus-sharded dense top-k and its merge;
3. ``ell``: the corpus-sharded ELL engine (kernel #1 on each shard);
4. ``hybrid``: the corpus-sharded hybrid engine with light-pool routing
   (kernel #2 on each shard, #1 for the query slab);
5. ``tp``: a TP x DP verdict step; 6. ``sp``: a sequence-parallel step on
   that state; 7. ``pp``: PP x DP (x TP where ``n`` is a multiple of 8);
   8. ``pp_moe``: the same pipeline over MoE blocks; 9. ``pp_ep_tp``: PP x
   EP x TP (``n`` a multiple of 8); 10. ``ep``: DP x EP (x TP where ``n``
   is a multiple of 8);
11. ``checkpoint``: the TP x DP state after step 1 saved sharded, restored
    onto the transposed layout, and one step there;
12. ``cp``: a context-parallel forward and step.

Each mesh takes the reference's layout for ``n``. The inputs are drawn in
the reference's order (``dryrun_inputs``): the batches from one numpy
generator, the parameters from ``torch.Generator`` seeds equal to the
reference's PRNG keys (one seed gives other bits in the two packages, so
the tests hand the reference's parameters in). The ranks are gloo ranks on
the CPU where the caller names it; NCCL, one rank a card, where the host
has ``n`` cards; otherwise gloo ranks sharing the cards. Inside a process
group (``torchrun``) the sections run in its ranks. The reference's forced
virtual CPU mesh and its re-run in a subprocess have no counterpart: the
launcher starts the ranks itself. ``dryrun_multichip`` returns rank 0's
numbers by section and the backend (the reference returns nothing); the
command prints them as one JSON line. Both run on the card unless the
caller names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ircl_tpu_torch.contrastive.losses import nt_xent_loss
from ircl_tpu_torch.contrastive.state import TrainConfig, init_train_state
from ircl_tpu_torch.corpus.store import MemoryDocStore
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.dense.scorer import sharded_cosine_topk
from ircl_tpu_torch.index.build import build_count_index
from ircl_tpu_torch.index.ell import to_ell
from ircl_tpu_torch.index.ranker import TfidfRanker
from ircl_tpu_torch.index.tfidf import tfidf_transform
from ircl_tpu_torch.models.encoder import EncoderConfig, seq2vec
from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer
from ircl_tpu_torch.models.moe import MoEConfig
from ircl_tpu_torch.models.transformer import TransformerConfig
from ircl_tpu_torch.ops.membership_cuda import pad_for_slab
from ircl_tpu_torch.parallel import cp, ep, pp, tp
from ircl_tpu_torch.parallel.dp import make_dp_train_step
from ircl_tpu_torch.parallel.launch import backend_for, launch
from ircl_tpu_torch.parallel.mesh import make_mesh
from ircl_tpu_torch.parallel.sharded_hybrid import ShardedHybridIndex
from ircl_tpu_torch.parallel.sharded_index import ShardedEllIndex
from ircl_tpu_torch.tools.sharded_scale import sharded_inputs
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.utils.checkpoint import restore_sharded, save_sharded
from ircl_tpu_torch.utils.device import resolve_device
from ircl_tpu_torch.utils.tree import tree_map
from ircl_tpu_torch.verdict.model import (
    VerdictConfig,
    init_verdict_params,
    make_verdict_train_step,
)


def _tiny_config():
    return TrainConfig(
        encoder=EncoderConfig(
            input_size=64, hidden_size=32, output_size=16, num_layers=2
        ),
        queue_size=64,
        queue_start_steps=1,
        micro_batch=16,
        accum_steps=2,
        learning_rate=1e-3,
    )


def _featurizer(dim=64, max_len=16, device=None, params=None):
    return HashEmbedFeaturizer(
        FeaturizerConfig(dim=dim, max_len=max_len, vocab_buckets=1 << 12),
        device=device, params=params,
    )


def _example_batch(cfg, feat, seed=0, device=None):
    """``[accum, micro, L]`` ids and masks of both views, as tensors on
    ``device`` (by default the featurizer's)."""
    rng = np.random.default_rng(seed)
    n = cfg.accum_steps * cfg.micro_batch
    texts_a = [f"ent{rng.integers(64)} alpha beta gamma" for _ in range(n)]
    texts_k = [f"delta ent{rng.integers(64)} epsilon" for _ in range(n)]
    ids_a, mask_a = feat.encode_host(texts_a)
    ids_k, mask_k = feat.encode_host(texts_k)
    shp = (cfg.accum_steps, cfg.micro_batch, feat.config.max_len)
    device = feat.device if device is None else device
    return tuple(
        torch.as_tensor(a.reshape(shp), device=device)
        for a in (ids_a, mask_a, ids_k, mask_k)
    )


def entry(device=None):
    """``(forward, example_args)``: the contrastive forward loss on the
    flagship retrieval model (frozen featurizer -> BiLSTM head -> NT-Xent)
    over one micro-batch, on ``device`` (by default the card). The
    features are detached and the key encoder runs without a graph, so a
    backward reaches ``params_q`` only."""
    device = resolve_device(device)
    cfg = _tiny_config()
    feat = _featurizer(device=device)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, device)
    ids_a, mask_a, ids_k, mask_k = _example_batch(cfg, feat)

    def forward(params_q, params_k, ids_a, mask_a, ids_k, mask_k):
        feats_a = feat.features(ids_a, mask_a).detach()
        feats_k = feat.features(ids_k, mask_k).detach()
        q = seq2vec(params_q, cfg.encoder, feats_a, mask_a)
        with torch.no_grad():
            k = seq2vec(params_k, cfg.encoder, feats_k, mask_k)
        return nt_xent_loss(q, k, cfg.temperature)

    # a single micro-batch: anchor and key views
    return forward, (state.params_q, state.params_k, ids_a[0], mask_a[0], ids_k[0],
                     mask_k[0])


# ---- the dry run's configurations and layouts ------------------------------------

SECTIONS = ("dp", "dense", "ell", "hybrid", "tp", "sp", "pp", "pp_moe", "pp_ep_tp", "ep",
            "checkpoint", "cp")


def _dp_config(n: int) -> TrainConfig:
    # micro_batch must divide over the data axis.
    return dataclasses.replace(_tiny_config(), micro_batch=max(n, (16 // n) * n))


def _verdict_config(layers: int = 2, moe=None) -> VerdictConfig:
    return VerdictConfig(
        encoder=TransformerConfig(
            vocab_size=64, hidden=16, layers=layers, heads=4, intermediate=32,
            max_positions=16, moe=moe,
        ),
        warmup_steps=0, total_steps=10, freeze_body_until_warmup=False,
        max_length=16,
    )


def layouts(n: int) -> dict:
    """The reference's mesh sizes for ``n`` devices."""
    model_ax = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    pp_model = 2 if n % 8 == 0 else 1
    pp_data = 2 if n % 2 == 0 and n >= 4 else 1
    cp_seq = 4 if n % 4 == 0 else 2
    return dict(model_ax=model_ax, pp_model=pp_model, pp_data=pp_data,
                pp_stages=n // (pp_data * pp_model), use_3axis=n % 8 == 0,
                cp_seq=cp_seq, cp_data=max(n // cp_seq, 1))


def _ep_moe(n: int) -> MoEConfig:
    lay = layouts(n)
    n_experts = 2 if lay["use_3axis"] else max(2, lay["model_ax"])
    return MoEConfig(num_experts=n_experts, top_k=2, capacity_factor=2.0)


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def dryrun_inputs(n_devices: int) -> dict:
    """Every section's inputs, as numpy arrays, in the reference's order of
    draws: one ``default_rng(0)`` gives the dense queries and corpus, then
    the TP, the PP and the CP batches; the parameters come from generators
    seeded as the reference's PRNG keys, drawn on the CPU."""
    n = n_devices
    lay = layouts(n)
    cfg = _dp_config(n)
    feat = _featurizer(device="cpu")
    st = init_train_state(_gen(0), cfg, "cpu")
    out = {"dp": dict(feat=_np(feat.params), state=dict(
        params_q=_np(st.params_q), params_k=_np(st.params_k), queue=st.queue.numpy(),
        queue_ptr=st.queue_ptr, step=st.step, count=st.opt_state["count"],
        mu=_np(st.opt_state["mu"]), nu=_np(st.opt_state["nu"])))}

    rng = np.random.default_rng(0)
    Q = rng.normal(size=(8, 16)).astype(np.float32)
    C = rng.normal(size=(n * 8 + 3, 16)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    C /= np.linalg.norm(C, axis=1, keepdims=True)
    out["dense"] = dict(q=Q, c=C)

    def batch(rows):
        ids = rng.integers(0, 64, size=(rows, 16)).astype(np.int32)
        mask = np.ones((rows, 16), np.float32)
        types = np.zeros((rows, 16), np.int32)
        labels = rng.integers(0, 2, size=(rows,)).astype(np.int32)
        return ids, mask, types, labels

    vbatch = batch(2 * (n // lay["model_ax"]))
    out["tp"] = dict(params=_np(init_verdict_params(_gen(3), _verdict_config(), "cpu")),
                     batch=vbatch)
    pbatch = batch(8)
    stages = lay["pp_stages"]
    pp_cases = {"pp": (5, stages, None), "pp_moe": (9, stages, MoEConfig(4, 2))}
    if n % 8 == 0:
        pp_cases["pp_ep_tp"] = (11, 2, MoEConfig(4, 2))
    for name, (seed, layers, moe) in pp_cases.items():
        full = init_verdict_params(_gen(seed), _verdict_config(layers, moe), "cpu")
        out[name] = dict(params=_np(pp.pp_verdict_params(full, layers)), batch=pbatch)
    out["ep"] = dict(params=_np(init_verdict_params(
        _gen(7), _verdict_config(moe=_ep_moe(n)), "cpu")), batch=vbatch)
    out["cp"] = dict(params=_np(init_verdict_params(_gen(11), _verdict_config(), "cpu")),
                     batch=batch(2 * lay["cp_data"]))
    return out


# ---- the sections, each run in every rank ----------------------------------------


def _num(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def dp_step(n: int, inp: dict, device: str) -> dict:
    """1: one DP contrastive step over a ``data`` mesh of every rank."""
    cfg = _dp_config(n)
    feat = _featurizer(device=device, params=convert.hash_featurizer_params_from_numpy(
        inp["feat"], device))
    step, place_state, place_batch, _ = make_dp_train_step(
        cfg, feat, make_mesh(("data",), device=device))
    state = place_state(convert.train_state_from_numpy(**inp["state"], device=device))
    batch = place_batch(*_example_batch(cfg, feat, device="cpu"))
    _, loss, grad_norm = step(state, *batch)
    return dict(loss=_num(loss), grad_norm=_num(grad_norm))


def dense_topk(inp: dict, device: str) -> dict:
    """2: the corpus-sharded dense top-5 of 8 queries."""
    s, i = sharded_cosine_topk(inp["q"], inp["c"], 5, make_mesh(("corpus",), device=device))
    return dict(scores=s, ids=i)


def _sparse_corpus(n: int, device: str):
    """The sparse sections' corpus (4 docs a rank) and its claims' query
    vectors."""
    wiki = generate(num_docs=4 * n, num_claims=6, seed=1)
    store = MemoryDocStore({d: r["text"] for d, r in wiki.docs.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=1 << 18))
    ranker = TfidfRanker(index, device, mode="ell")
    b, w = ranker._vectorize([c.claim for c in wiki.claims])
    return index, ranker, b, w


def sharded_ell(corpus, device: str) -> dict:
    """3: the doc-sharded ELL engine's top-3."""
    index, ranker, b, w = corpus
    u_pad = ranker._union_slots(b, w, floor=512)
    qb_t, qw_t = pad_for_slab(
        np.ascontiguousarray(b.T.astype(np.int32)),
        np.ascontiguousarray(w.T),
        d_tile=128,
    )
    sharded = ShardedEllIndex(to_ell(index), make_mesh(("corpus",), device=device))
    s, i = sharded.topk(u_pad, qb_t, qw_t, k=3)
    return dict(scores=s, ids=i)


def sharded_hybrid(corpus, device: str) -> dict:
    """4: the df-split index sharded over the ranks, light pools routed to
    the shard of each doc (``tools/sharded_scale.py``'s host half)."""
    index, _, b, w = corpus
    hyb = TfidfRanker(index, device, mode="hybrid", df_threshold=4)
    inp = sharded_inputs(hyb, b, w)
    sh = ShardedHybridIndex(hyb._split, make_mesh(("corpus",), device=device))
    s, i = sh.topk(inp["u_pad"], inp["qb_t"], inp["qw_t"], inp["light_docs"],
                   inp["light_contribs"], k=3)
    return dict(scores=s, ids=i)


def tp_step(n: int, inp: dict, device: str):
    """5: one TP x DP verdict step; its loss, and the sharded run that
    sections 6 and 11 go on from."""
    model_ax = layouts(n)["model_ax"]
    mesh = tp.make_tp_mesh(model=model_ax, data=n // model_ax, device=device)
    vcfg = _verdict_config()
    step, tx = make_verdict_train_step(vcfg, mesh=mesh)
    full = convert.verdict_params_from_numpy(inp["params"], device)
    specs = tp.verdict_param_specs(full)
    params = tp.shard_tree(full, specs, mesh)
    opt = tp.init_sharded_opt_state(tx, params, mesh, specs)
    params, opt, loss, _ = step(params, opt, 0, *tp.shard_batch(mesh, *inp["batch"]))
    run = dict(mesh=mesh, params=params, opt=opt, specs=specs, tx=tx, inputs=inp)
    return dict(loss=_num(loss)), run


def sp_step(run: dict) -> dict:
    """6: sequence parallelism on the TP x DP mesh, one step from section
    5's state."""
    mesh = run["mesh"]
    step, _ = make_verdict_train_step(_verdict_config(), tp.make_sp_constrainer(mesh),
                                      mesh=mesh)
    _, _, loss, _ = step(run["params"], run["opt"], 1,
                         *tp.shard_batch(mesh, *run["inputs"]["batch"]))
    return dict(loss=_num(loss))


def _pp_step(cfg, mesh, inp: dict, device: str) -> dict:
    """One GPipe step of 4 microbatches from the pipeline layout's numpy
    parameters."""
    step, tx = pp.make_pp_verdict_train_step(cfg, mesh, n_micro=4)
    full = convert.pp_verdict_params_from_numpy(inp["params"], device)
    specs = pp.pp_verdict_specs(full, mesh)
    params = tp.shard_tree(full, specs, mesh)
    opt = tp.init_sharded_opt_state(tx, params, mesh, specs)
    _, _, loss, _ = step(params, opt, 0, *tp.shard_batch(mesh, *inp["batch"]))
    return dict(loss=_num(loss))


def pp_steps(n: int, inputs: dict, device: str) -> dict:
    """7-9: PP x DP (x TP where ``n`` is a multiple of 8), the same mesh
    over MoE blocks, and PP x EP x TP where ``n`` is a multiple of 8."""
    lay = layouts(n)
    stages = lay["pp_stages"]
    mesh = pp.make_pp_mesh(stages, data=lay["pp_data"], model=lay["pp_model"], device=device)
    out = {"pp": _pp_step(_verdict_config(stages), mesh, inputs["pp"], device),
           "pp_moe": _pp_step(_verdict_config(stages, MoEConfig(4, 2)), mesh,
                              inputs["pp_moe"], device)}
    if n % 8 == 0:
        mesh4 = pp.make_pp_mesh(2, expert=2, model=2, device=device)
        out["pp_ep_tp"] = _pp_step(_verdict_config(2, MoEConfig(4, 2)), mesh4,
                                   inputs["pp_ep_tp"], device)
    return out


def ep_step(n: int, inp: dict, device: str) -> dict:
    """10: the MoE verdict model over DP x EP x TP where ``n`` is a multiple
    of 8, else over DP x EP."""
    lay = layouts(n)
    if lay["use_3axis"]:
        mesh = ep.make_ep_tp_mesh(expert=2, model=2, data=n // 4, device=device)
    else:
        mesh = ep.make_ep_mesh(expert=lay["model_ax"], data=n // lay["model_ax"],
                               device=device)
    ecfg = _verdict_config(moe=_ep_moe(n))
    step, tx = make_verdict_train_step(ecfg, ep_constrain=ep.make_ep_constrainer(mesh),
                                       mesh=mesh)
    full = convert.verdict_params_from_numpy(inp["params"], device)
    specs = ep.moe_verdict_param_specs(full, tp=lay["use_3axis"])
    params = tp.shard_tree(full, specs, mesh)
    opt = tp.init_sharded_opt_state(tx, params, mesh, specs)
    _, _, loss, _ = step(params, opt, 0, *tp.shard_batch(mesh, *inp["batch"]))
    return dict(loss=_num(loss))


def checkpoint_step(n: int, run: dict, device: str) -> dict:
    """11: section 6's sharded state saved without a gather, restored onto
    the transposed TP x DP layout, and step 2 taken there. Rank 0 makes
    the directory, every rank writes its shards into it, and rank 0
    removes it once every rank is done."""
    model_ax = layouts(n)["model_ax"]
    mesh, specs, tx = run["mesh"], run["specs"], run["tx"]
    made = [tempfile.mkdtemp(prefix="ircl_dryrun_ckpt_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(made, src=0)
    ckpt_dir = made[0]
    try:
        saved = {"params": specs, "opt": tp.state_specs(run["opt"], run["params"], specs)}
        path = save_sharded(os.path.join(ckpt_dir, "ckpt"),
                            {"params": run["params"], "opt": run["opt"]},
                            mesh=mesh, specs=saved)
        elastic = tp.make_tp_mesh(model=n // model_ax, data=model_ax, device=device)
        like = tp.shard_tree(convert.verdict_params_from_numpy(
            run["inputs"]["params"], device), specs, elastic)
        like_opt = tp.init_sharded_opt_state(tx, like, elastic, specs)
        restored = restore_sharded(
            path, {"params": like, "opt": like_opt}, mesh=elastic,
            specs={"params": specs, "opt": tp.state_specs(like_opt, like, specs)})
        step, _ = make_verdict_train_step(_verdict_config(), mesh=elastic)
        _, _, loss, _ = step(restored["params"], restored["opt"], 2,
                             *tp.shard_batch(elastic, *run["inputs"]["batch"]))
        dist.barrier()
    finally:
        if dist.get_rank() == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(loss=_num(loss))


def cp_step(n: int, inp: dict, device: str) -> dict:
    """12: the sequence over a ``("data", "seq")`` mesh, attention as ring
    attention: one forward and one train step."""
    lay = layouts(n)
    mesh = cp.make_cp_mesh(seq=lay["cp_seq"], data=lay["cp_data"], device=device)
    vcfg = _verdict_config()
    params = convert.verdict_params_from_numpy(inp["params"], device)
    ids, mask, types, labels = inp["batch"]
    logits = cp.make_cp_verdict_forward(vcfg, mesh)(params, ids, mask, types)
    step, tx = cp.make_cp_verdict_train_step(vcfg, mesh)
    _, _, loss = step(params, tx.init(params), ids, mask, types, labels)
    return dict(logits=_num(logits), loss=_num(loss))


def dryrun_rank(n: int, inputs: dict, device: str) -> dict:
    """Every section in the reference's order, in this rank: rank 0's
    numbers by section."""
    out = {"dp": dp_step(n, inputs["dp"], device),
           "dense": dense_topk(inputs["dense"], device)}
    corpus = _sparse_corpus(n, device)
    out["ell"] = sharded_ell(corpus, device)
    out["hybrid"] = sharded_hybrid(corpus, device)
    out["tp"], run = tp_step(n, inputs["tp"], device)
    out["sp"] = sp_step(run)
    out.update(pp_steps(n, inputs, device))
    out["ep"] = ep_step(n, inputs["ep"], device)
    out["checkpoint"] = checkpoint_step(n, run, device)
    out["cp"] = cp_step(n, inputs["cp"], device)
    return out


def dryrun_multichip(n_devices: int, device=None, inputs=None) -> dict:
    """The reference's multi-chip dry run on ``n_devices`` ranks on
    ``device``'s type (by default the card) from ``inputs`` (by default
    ``dryrun_inputs(n_devices)``): rank 0's numbers by section (losses,
    gradient norm, top-k scores and ids, CP's logits) and the backend."""
    device = resolve_device(device)
    if inputs is None:
        inputs = dryrun_inputs(n_devices)
    backend = backend_for(device, n_devices)
    out = launch(dryrun_rank, n_devices, n_devices, inputs, device.type, device=device,
                 backend=backend)
    return dict(out, backend=backend)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", nargs="?", choices=("entry", "dryrun"), default="entry")
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="ranks of the dry run (default 8)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.what == "entry":
        fn, example = entry(args.device)
        line = {"entry": {"loss": float(fn(*example)),
                          "args": [list(a.shape) for a in example[2:]]}}
    else:
        out = dryrun_multichip(args.n, args.device)
        line = {"dryrun": args.n, "backend": out["backend"], "sections": {
            name: {k: _num(v).tolist() for k, v in out[name].items()}
            for name in SECTIONS if name in out}}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    # through the package's name, so that the ranks unpickle the sections
    # from it and not from ``__main__``
    from ircl_tpu_torch.graft_entry import main as _main

    _main()
