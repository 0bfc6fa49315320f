"""Rank targets of the port's multi-rank parity tests.

``ircl_tpu_torch.parallel.launch`` runs these in spawned ranks of a gloo
group on the CPU, which import this module afresh: so it imports neither
JAX nor the JAX package (``tests/conftest.py`` is not loaded there), and
the test modules, which import JAX at their top, hand it numpy inputs.
Each target checks that every rank returned rank 0's bits, then returns
rank 0's results as numpy arrays; where the ranks hold different shards,
it returns every rank's digests for the test to compare instead.
"""

import contextlib
import io
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist


def _no_tensorflow():
    """The trainer's MetricsLogger mirrors to TensorBoard, whose import
    loads TensorFlow where it is installed (tens of seconds a rank); hidden,
    the writer takes tensorboard's own stub."""
    sys.modules["tensorflow"] = None


def _same_on_every_rank(out):
    """Rank 0's ``out``, after checking every rank holds its bits."""
    blobs = [None] * dist.get_world_size()
    dist.all_gather_object(blobs, pickle.dumps(out))
    if any(b != blobs[0] for b in blobs):
        raise AssertionError("the ranks returned different results")
    return out


def _np(tree):
    from ircl_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)


def state_np(st):
    return dict(params_q=_np(st.params_q), params_k=_np(st.params_k),
                opt_state=_np(st.opt_state), queue=st.queue.numpy(),
                queue_ptr=st.queue_ptr, step=st.step)


# ---- corpus-sharded scoring ----------------------------------------------------


def sharded_scoring(cases):
    """Every sharded scorer on one ``corpus`` mesh; ``embed_corpus`` on a
    ``data`` mesh of the same ranks."""
    from ircl_tpu_torch.dense.scorer import sharded_cosine_topk
    from ircl_tpu_torch.parallel.mesh import make_mesh
    from ircl_tpu_torch.parallel.sharded_hybrid import ShardedHybridIndex
    from ircl_tpu_torch.parallel.sharded_index import ShardedEllIndex

    mesh = make_mesh(("corpus",), device="cpu")
    out = {}
    for name, c in cases.get("ell", {}).items():
        out[name] = ShardedEllIndex(c["ell"], mesh).topk(
            c["u"], c["qb_t"], c["qw_t"], k=c["k"])
    if "hybrid" in cases:
        c = cases["hybrid"]
        idx = ShardedHybridIndex(c["split"], mesh)
        out["hybrid"] = idx.topk(c["u"], c["qb_t"], c["qw_t"], c["light_docs"],
                                 c["light_contribs"], k=c["k"])
        out["hybrid_routed"] = idx.route_light(c["light_docs"], c["light_contribs"])
    for name, (q, corpus, k) in cases.get("dense", {}).items():
        out[name] = sharded_cosine_topk(q, corpus, k, mesh)
    if "embed" in cases:
        out["embed"] = _embed(**cases["embed"])
    return _same_on_every_rank(out)


def _embed(cfg, feat_cfg, feat_params, params_q, texts, batch_size):
    from ircl_tpu_torch.contrastive.train import make_embed_fn
    from ircl_tpu_torch.dense.embed import embed_corpus
    from ircl_tpu_torch.parallel.mesh import make_mesh
    from ircl_tpu_torch.utils import convert

    feat = _featurizer(feat_cfg, feat_params)
    params = convert.encoder_params_from_numpy(params_q, device="cpu")
    return embed_corpus(make_embed_fn(cfg, feat), params, feat, texts,
                        batch_size=batch_size, mesh=make_mesh(("data",), device="cpu"))


def dense_functions(q, corpus, k):
    """``shard_corpus``, ``make_sharded_topk`` and ``sharded_cosine_topk``
    one by one: each rank's block of rows, the merged top-k of the shards,
    and the wrapper's result."""
    from ircl_tpu_torch.dense import scorer
    from ircl_tpu_torch.parallel.common import all_gather_rows
    from ircl_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(("corpus",), device="cpu")
    shard, m = scorer.shard_corpus(corpus, mesh)
    blocks = torch.cat(all_gather_rows(shard, mesh, "corpus")).numpy()
    s, i = scorer.make_sharded_topk(mesh, k, true_m=m)(q, shard)
    return _same_on_every_rank(dict(
        shard_corpus=(blocks, m),
        make_sharded_topk=(s.numpy(), i.numpy()),
        sharded_cosine_topk=scorer.sharded_cosine_topk(q, corpus, k, mesh),
    ))


# ---- data-parallel training ----------------------------------------------------


def _featurizer(feat_cfg, feat_params):
    from ircl_tpu_torch.models.featurizer import HashEmbedFeaturizer
    from ircl_tpu_torch.utils import convert

    return HashEmbedFeaturizer(feat_cfg, device="cpu",
                               params=convert.hash_featurizer_params_from_numpy(
                                   feat_params, device="cpu"))


def dp_runs(step_cases, trainer_cases):
    """The DP step cases and the trainer cases on one ``data`` mesh."""
    _no_tensorflow()
    from ircl_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(("data",), device="cpu")
    return _same_on_every_rank(dict(
        placed=_placed(mesh, **step_cases["nt-xent"]),
        steps={name: _dp_steps(mesh, **c) for name, c in step_cases.items()},
        trainers={name: _dp_trainers(mesh, **c) for name, c in trainer_cases.items()},
    ))


def _placed(mesh, cfg, feat_cfg, feat_params, **_):
    """``place_state`` of a state whose values differ by rank (rank r's is
    ``init_train_state(r)``): rank 0's values on every rank, each leaf in
    its own layout (``init_train_state``'s recurrent weights are transposed
    views)."""
    from ircl_tpu_torch.contrastive.state import init_train_state
    from ircl_tpu_torch.parallel.dp import make_dp_train_step
    from ircl_tpu_torch.utils.tree import tree_leaves

    place_state = make_dp_train_step(cfg, _featurizer(feat_cfg, feat_params), mesh)[1]
    mine = init_train_state(dist.get_rank(), cfg, device="cpu")
    placed = place_state(mine)

    def leaves(st):
        return tree_leaves(st.params_q) + tree_leaves(st.params_k) + [st.queue]

    return dict(values=state_np(placed),
                same_layout=all(a.stride() == b.stride()
                                for a, b in zip(leaves(placed), leaves(mine))),
                transposed=sum(not a.is_contiguous() for a in leaves(placed)))


def _dp_steps(mesh, cfg, feat_cfg, feat_params, state, steps):
    """``make_dp_train_step`` from a carried state over ``steps``; per step
    the loss and gradient norm, then the state."""
    from ircl_tpu_torch.parallel.dp import make_dp_train_step
    from ircl_tpu_torch.utils import convert

    step, place_state, place_batch, place_proto = make_dp_train_step(
        cfg, _featurizer(feat_cfg, feat_params), mesh)
    st = place_state(convert.train_state_from_numpy(**state, device="cpu"))
    hist = []
    for batch, proto in steps:
        st, loss, norm = step(st, *place_batch(*batch), place_proto(proto))
        hist.append((float(loss), float(norm)))
    return dict(hist=hist, state=state_np(st))


def _rank_dependent(run):
    """``run`` whose results move by this rank's number, as float atomics
    can make the ranks' k-means differ on the card: rank 0's stay as they
    are."""
    from ircl_tpu_torch.contrastive.cluster import ClusterResult

    def wrapped(*args, **kwargs):
        cr, r = run(*args, **kwargs), dist.get_rank()
        return ClusterResult([(e + r) % c.shape[0] for e, c in zip(cr.emb2cluster, cr.centroids)],
                             [c + r for c in cr.centroids], [d + r for d in cr.density])

    return wrapped


def _dp_trainers(mesh, cfg, feat_cfg, feat_params, docs, steps, log_step, ckptdir,
                 logdir, rank_dependent_refresh=False):
    """``ContrastiveTrainer(mesh=)`` for ``steps`` steps and a fresh one that
    resumes from rank 0's checkpoint; beside them the single-device trainer
    (in a directory of each rank's own); with ``rank_dependent_refresh``,
    also the DP trainer whose ranks' cluster refreshes differ."""
    from unittest import mock

    from ircl_tpu_torch.contrastive import trainer as trainer_module
    from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
    from ircl_tpu_torch.data.pairs import DocPairSampler

    feat = _featurizer(feat_cfg, feat_params)

    def trainer(mesh, sub):
        return ContrastiveTrainer(
            cfg, feat, DocPairSampler(docs, sample="uniform", seed=3),
            ckptdir=f"{ckptdir}/{sub}", logdir=f"{logdir}/{sub}", seed=5, mesh=mesh,
            device="cpu")

    out = {}
    for sub, m in (("dp", mesh), (f"single{dist.get_rank()}", None)):
        t = trainer(m, sub)
        st = t.train(total_steps=steps, log_step=log_step)
        out[sub] = dict(state=state_np(st), refreshes=t.refresh_count)
    if rank_dependent_refresh:
        with mock.patch.object(trainer_module, "run_kmeans",
                               _rank_dependent(trainer_module.run_kmeans)):
            t = trainer(mesh, "rank_dependent")
            st = t.train(total_steps=steps, log_step=log_step)
        out["rank_dependent"] = dict(state=state_np(st), refreshes=t.refresh_count)
    resumed = trainer(mesh, "dp")
    out["dp"].update(
        resumed_at=resumed.maybe_resume(),
        resumed_equal=pickle.dumps(state_np(resumed.state)) == pickle.dumps(
            out["dp"]["state"]),
        checkpoints=sorted(f[len(resumed.tag):] for f in os.listdir(f"{ckptdir}/dp")),
    )
    out["single"] = out.pop(f"single{dist.get_rank()}")
    return out


def cli_main(argv):
    """``python -m ircl_tpu_torch.cli`` in this rank; its standard output."""
    _no_tensorflow()
    from ircl_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def loaded_jax_modules():
    """A 2-rank ``sharded_cosine_topk``, a 2-rank TP forward of a tiny
    transformer (``parallel/tp.py``, ``parallel/ep.py`` imported), a 2-stage
    pipeline forward of it (``parallel/pp.py``) and a 2-rank context-parallel
    forward of a tiny verdict model (``parallel/cp.py``, the ring of
    ``ops/ring_attention.py``); the JAX modules each rank loaded."""
    from ircl_tpu_torch.dense.scorer import sharded_cosine_topk
    from ircl_tpu_torch.models.transformer import (
        TransformerConfig,
        init_transformer_params,
        transformer_apply,
    )
    from ircl_tpu_torch.parallel import ep, tp  # noqa: F401
    from ircl_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    c = rng.normal(size=(13, 8)).astype(np.float32)
    sharded_cosine_topk(c[:3], c, 5, make_mesh(("corpus",), device="cpu"))
    cfg = TransformerConfig(vocab_size=16, hidden=8, layers=1, heads=2,
                            intermediate=16, max_positions=8)
    mesh = tp.make_tp_mesh(device="cpu")
    full = init_transformer_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ids, mask = tp.shard_batch(mesh, np.zeros((2, 8), np.int64), np.ones((2, 8), np.float32))
    transformer_apply(tp.shard_tree(full, tp.transformer_param_specs(full), mesh), cfg,
                      ids, mask, mesh=mesh)
    from ircl_tpu_torch.parallel import cp, pp
    from ircl_tpu_torch.verdict.model import VerdictConfig, init_verdict_params

    two = TransformerConfig(vocab_size=16, hidden=8, layers=2, heads=2, intermediate=16,
                            max_positions=8)
    full = init_transformer_params(torch.Generator().manual_seed(1), two, "cpu")
    mesh = pp.make_pp_mesh(2, device="cpu")
    stacked = pp.stack_layer_params(full["layers"], 2)
    pp.make_pp_transformer_apply(two, mesh, n_micro=2)(
        {k: v for k, v in full.items() if k != "layers"},
        tp.shard_tree(stacked, pp.stage_specs(stacked), mesh), *tp.shard_batch(
            mesh, np.zeros((2, 8), np.int64), np.ones((2, 8), np.float32)))
    vcfg = VerdictConfig(encoder=two, max_length=8)
    cp.make_cp_verdict_forward(vcfg, cp.make_cp_mesh(device="cpu"))(
        init_verdict_params(torch.Generator().manual_seed(2), vcfg, "cpu"),
        np.zeros((2, 8), np.int64), np.ones((2, 8), np.float32), np.zeros((2, 8), np.int64))
    mine = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu"))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def raise_on_rank(bad):
    """Rank ``bad`` raises; the others wait for it in a collective."""
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} was told to fail")
    dist.barrier()


# ---- tensor, sequence and expert parallelism of the verdict model ---------------


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _layout_report(mesh, params, specs):
    """Every rank's (coordinates on the sharded axes, digest of its local
    shards, digest of its replicated leaves): ranks that share coordinates
    must hold equal shards, and every rank the same replicated leaves."""
    from ircl_tpu_torch.parallel.mesh import axis_rank
    from ircl_tpu_torch.utils.tree import tree_leaves, tree_leaves_like

    leaves, spec_leaves = tree_leaves(params), tree_leaves_like(params, specs)
    coords = tuple(axis_rank(mesh, a) for a in mesh.mesh_dim_names if a != "data")
    mine = (coords, _digest(leaves),
            _digest([x for x, s in zip(leaves, spec_leaves) if not any(s.axes)]))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def _verdict_specs(kind, params):
    from ircl_tpu_torch.parallel import ep, tp

    if kind == "tp":
        return tp.verdict_param_specs(params)
    if kind in ("ep", "ep_tp"):
        return ep.moe_verdict_param_specs(params, tp=kind == "ep_tp")
    return tp.replicated_specs(params)


def _mesh(shape):
    """``("data", "model")``, ``("data", "expert")``, ``("data",
    "expert", "model")`` or, with a ``"stage"`` key, ``make_pp_mesh``'s
    ``("data", "stage"[, "expert"][, "model"])`` by ``shape``'s keys, on
    the CPU."""
    from ircl_tpu_torch.parallel import ep, pp, tp

    if "stage" in shape:
        return pp.make_pp_mesh(shape["stage"], shape.get("data", 1), shape.get("model", 1),
                               shape.get("expert", 1), device="cpu")
    if "expert" in shape and "model" in shape:
        return ep.make_ep_tp_mesh(shape["expert"], shape["model"], shape["data"],
                                  device="cpu")
    if "expert" in shape:
        return ep.make_ep_mesh(shape["expert"], shape["data"], device="cpu")
    return tp.make_tp_mesh(shape["model"], shape["data"], device="cpu")


def verdict_sharded_steps(cfg, params0, batches, shape, kind, sp=False, grads=False):
    """``make_verdict_train_step(mesh=)`` over ``batches`` from the numpy
    ``params0`` in layout ``kind`` on a mesh of ``shape``: per step the
    loss, then the whole parameters; with ``grads`` also the whole
    gradients of the first batch (``make_verdict_grad_fn``); and every
    rank's layout report."""
    from ircl_tpu_torch.parallel import ep, tp
    from ircl_tpu_torch.utils import convert
    from ircl_tpu_torch.verdict.model import make_verdict_grad_fn, make_verdict_train_step

    mesh = _mesh(shape)
    full = convert.verdict_params_from_numpy(params0, "cpu")
    specs = _verdict_specs(kind, full)
    constrain = tp.make_sp_constrainer(mesh) if sp else None
    ep_constrain = ep.make_ep_constrainer(mesh) if kind.startswith("ep") else None
    out = {}
    p = tp.shard_tree(full, specs, mesh)
    if grads:
        fn = make_verdict_grad_fn(cfg, constrain, ep_constrain, mesh=mesh)
        loss, _, g = fn(p, *tp.shard_batch(mesh, *batches[0]))
        out["grads"] = _np(tp.gather_tree(g, specs, mesh))
        out["grad_loss"] = float(loss)
    step, tx = make_verdict_train_step(cfg, constrain, ep_constrain, mesh=mesh)
    o = tp.init_sharded_opt_state(tx, p, mesh, specs)
    losses = []
    for i, b in enumerate(batches):
        p, o, loss, _ = step(p, o, i, *tp.shard_batch(mesh, *b))
        losses.append(float(loss))
    out.update(losses=losses, params=_np(tp.gather_tree(p, specs, mesh)),
               layout=_layout_report(mesh, p, specs))
    return out


def verdict_local_shapes(cfg, params0, shape, kind):
    """The local shapes of a few sharded leaves and of their Adam moments."""
    from ircl_tpu_torch.parallel import tp
    from ircl_tpu_torch.utils import convert
    from ircl_tpu_torch.utils.tree import tree_map
    from ircl_tpu_torch.verdict.model import make_verdict_optimizer

    mesh = _mesh(shape)
    full = convert.verdict_params_from_numpy(params0, "cpu")
    specs = _verdict_specs(kind, full)
    p = tp.shard_tree(full, specs, mesh)
    o = tp.init_sharded_opt_state(make_verdict_optimizer(cfg), p, mesh, specs)
    shapes = lambda t: tree_map(lambda x: tuple(x.shape), t)  # noqa: E731
    return dict(params=shapes(p), mu=shapes(o["mu"]), count=o["count"])


def verdict_sharded_forward(cfg, params0, arrays, shape, kind, what):
    """``verdict_predict(mesh=)``, ``verdict_apply_with_aux(mesh=)`` (this
    rank's logits and the aux) or ``transformer_apply(mesh=)`` on this
    rank's rows of ``arrays``."""
    from ircl_tpu_torch.models.transformer import transformer_apply
    from ircl_tpu_torch.parallel import ep, tp
    from ircl_tpu_torch.parallel.common import all_gather_rows
    from ircl_tpu_torch.utils import convert
    from ircl_tpu_torch.verdict.model import verdict_apply_with_aux, verdict_predict

    mesh = _mesh(shape)
    if what == "transformer_apply":
        full = convert.transformer_params_from_numpy(params0, "cpu")
        p = tp.shard_tree(full, tp.transformer_param_specs(full), mesh)
        ids, mask = tp.shard_batch(mesh, *arrays)
        with torch.no_grad():
            return transformer_apply(p, cfg, ids.long(), mask, mesh=mesh).numpy()
    full = convert.verdict_params_from_numpy(params0, "cpu")
    p = tp.shard_tree(full, _verdict_specs(kind, full), mesh)
    ids, mask, types = tp.shard_batch(mesh, *arrays)
    if what == "predict":
        return verdict_predict(p, cfg, ids.long(), mask, types.long(), mesh=mesh).numpy()
    ep_constrain = ep.make_ep_constrainer(mesh) if kind.startswith("ep") else None
    with torch.no_grad():
        logits, aux = verdict_apply_with_aux(p, cfg, ids.long(), mask, types.long(),
                                             ep_constrain=ep_constrain, mesh=mesh)
    return dict(logits=torch.cat(all_gather_rows(logits, mesh, "data")).numpy(),
                aux=float(aux))


def parallel_runs(cases):
    """Each case ``(target name, kwargs)`` in turn on this group's ranks;
    rank 0's results by case name (the meshes of the cases are made anew,
    in the same order, on every rank)."""
    out = {}
    for name, (target, kwargs) in cases.items():
        try:
            out[name] = globals()[target](**kwargs)
        except (ValueError, TypeError, NotImplementedError) as e:
            out[name] = ("raised", type(e).__name__, str(e))
    return out


def sharded_checkpoint(cfg, params0, batches, path, pp_case):
    """``tests/test_sharded_checkpoint.py``'s runs: TP(4) x DP(2) for every
    batch; again for all but the last, ``save_sharded``, then the last batch
    from ``restore_sharded`` onto the same layout, onto TP(2) x DP(4) and
    onto replicated DP(8) parameters. Each run's last loss, whole
    parameters and a local shard's shape. Then ``pp_case`` (params0,
    batches, path), the pipeline's run (``_pp_checkpoint``)."""
    from ircl_tpu_torch.parallel import tp
    from ircl_tpu_torch.utils import convert
    from ircl_tpu_torch.utils.checkpoint import restore_sharded, save_sharded
    from ircl_tpu_torch.verdict.model import make_verdict_train_step

    full = convert.verdict_params_from_numpy(params0, "cpu")

    def start(shape, kind):
        mesh = _mesh(shape)
        specs = _verdict_specs(kind, full)
        step, tx = make_verdict_train_step(cfg, mesh=mesh)
        p = tp.shard_tree(full, specs, mesh)
        o = tp.init_sharded_opt_state(tx, p, mesh, specs)
        return mesh, step, p, o, {"params": specs, "opt": tp.state_specs(o, p, specs)}

    def run(mesh, step, p, o, todo, first=0):
        for i, b in enumerate(todo):
            p, o, loss, _ = step(p, o, first + i, *tp.shard_batch(mesh, *b))
        return p, o, float(loss)

    def result(mesh, specs, p, o, loss):
        return dict(loss=loss, count=o["count"],
                    params=_np(tp.gather_tree(p, specs["params"], mesh)),
                    ff1_w=tuple(p["body"]["layers"][0]["ff1"]["w"].shape))

    out = {}
    mesh, step, p, o, specs = start(dict(data=2, model=4), "tp")
    out["uninterrupted"] = result(mesh, specs, *run(mesh, step, p, o, batches))
    mesh, step, p, o, specs = start(dict(data=2, model=4), "tp")
    p, o, _ = run(mesh, step, p, o, batches[:-1])
    save_sharded(path, {"params": p, "opt": o}, mesh=mesh, specs=specs)
    for name, shape, kind in (("same", dict(data=2, model=4), "tp"),
                              ("tp2_dp4", dict(data=4, model=2), "tp"),
                              ("dp8", dict(data=8, model=1), "dp")):
        mesh, step, p, o, specs = start(shape, kind)
        back = restore_sharded(path, {"params": p, "opt": o}, mesh=mesh, specs=specs)
        restored_count = back["opt"]["count"]  # the step counts on in place
        out[name] = result(mesh, specs, *run(mesh, step, back["params"], back["opt"],
                                             batches[-1:], first=len(batches) - 1))
        out[name]["restored_count"] = restored_count
    out["pp"] = _pp_checkpoint(cfg, **pp_case)
    return out


def _pp_checkpoint(cfg, params0, batches, path):
    """``test_pp_sharded_save_restore_resumes_training``'s run: PP(2) x
    DP(2), 4 microbatches, over every batch; again for all but the last,
    ``save_sharded`` of the stage-stacked shards, ``restore_sharded`` into
    a fresh layout, its restacking onto one stage, and the last batch from
    the restored state. The losses, whole parameters in the standard
    layout, the restored stage shard's local shape, the restacked shape and
    whether the restacking kept every layer's bits."""
    from ircl_tpu_torch.parallel import pp, tp
    from ircl_tpu_torch.utils import convert
    from ircl_tpu_torch.utils.checkpoint import restore_sharded, save_sharded
    from ircl_tpu_torch.utils.tree import tree_leaves

    mesh = _mesh(dict(stage=2, data=2))
    pp0 = pp.pp_verdict_params(convert.verdict_params_from_numpy(params0, "cpu"), 2)
    specs = pp.pp_verdict_specs(pp0, mesh)
    step, tx = pp.make_pp_verdict_train_step(cfg, mesh, n_micro=4)

    def start():
        p = tp.shard_tree(pp0, specs, mesh)
        o = tp.init_sharded_opt_state(tx, p, mesh, specs)
        return p, o, {"params": specs, "opt": tp.state_specs(o, p, specs)}

    def run(p, o, todo, first=0):
        for i, b in enumerate(todo):
            p, o, loss, _ = step(p, o, first + i, *tp.shard_batch(mesh, *b))
        return p, o, float(loss)

    def std(p):
        return _np(pp.verdict_params_from_pp(tp.gather_tree(p, specs, mesh)))

    p, o, _ = start()
    p_full, o_full, loss_full = run(p, o, batches)
    p, o, both = start()
    p, o, _ = run(p, o, batches[:-1])
    save_sharded(path, {"params": p, "opt": o}, mesh=mesh, specs=both)
    p, o, both = start()
    back = restore_sharded(path, {"params": p, "opt": o}, mesh=mesh, specs=both)
    whole = tp.gather_tree(back["params"], specs, mesh)
    restacked = pp.restack_pp_params(whole, 1)
    kept = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(pp.unstack_layer_params(restacked["stages"])),
        tree_leaves(pp.unstack_layer_params(whole["stages"]))))
    local = tuple(back["params"]["stages"]["ff1"]["w"].shape)
    count = back["opt"]["count"]
    p3, o3, loss3 = run(back["params"], back["opt"], batches[-1:], first=len(batches) - 1)
    return dict(loss_full=loss_full, params_full=std(p_full), loss=loss3, params=std(p3),
                count=o3["count"], full_count=o_full["count"], restored_count=count,
                local=local, restacked=tuple(restacked["stages"]["ff1"]["w"].shape),
                layers_kept=kept)


def train_verdict_runs(cases, data, out_dir):
    """``train_verdict(mesh=)`` for each case ``(cfg, params0, mesh shape,
    kwargs)``: rank 0's history and returned parameters, and whether every
    rank returned the same; a ``("stage", "model")`` mesh's refusal."""
    from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
    from ircl_tpu_torch.parallel.mesh import make_mesh
    from ircl_tpu_torch.utils import convert
    from ircl_tpu_torch.utils.tree import tree_leaves
    from ircl_tpu_torch.verdict.train import train_verdict

    _no_tensorflow()
    out = {}
    for name, (cfg, params0, shape, kw) in cases.items():
        if kw.pop("save", False):
            kw.update(save_path=f"{out_dir}/{name}/ckpt", logdir=f"{out_dir}/{name}/log",
                      tokenizer=WordPieceTokenizer.train(["a claim", "its evidence"],
                                                         vocab_size=64))
        params, history = train_verdict(
            cfg, *data, epochs=2, batch_size=8, val_fraction=0.1, seed=7,
            mesh=_mesh(shape), init_params=convert.verdict_params_from_numpy(params0, "cpu"),
            **kw)
        mine = dict(history=history, params=_np(params))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, _digest(tree_leaves(params)))
        out[name] = dict(mine, same_on_every_rank=len(set(every)) == 1)
    try:
        train_verdict(cases["tp_dp"][0], *data, epochs=1, batch_size=8, val_fraction=0.0,
                      mesh=make_mesh(("stage", "model"), (2, 4), device="cpu"))
    except ValueError as e:
        out["stage_model"] = str(e)
    return out


def layer_parity(cases):
    """Each case runs one sharded layer on a mesh of every rank and returns,
    the same on every rank: its output (and the MoE aux), the gradient of
    ``sum(output * w)`` with respect to the input, and with respect to the
    parameters, gathered whole. A case is ``dict(layer="block" | "moe",
    cfg, params, specs, axes, kwargs, x, mask, w)``: ``specs`` is
    ``"tp"``/``"ep"``/``"ep_tp"``/``"tp_moe"``, or ``"rep"`` (every leaf
    replicated), ``axes`` the mesh's axis names and sizes, ``kwargs`` what
    the layer is called with (the hook ``"ep_constrain"`` made from the
    mesh). Under ``kwargs["seq_axis"]`` each rank takes its block of the
    sequence of ``x``, ``mask`` and ``w``; the output and the input's
    gradient are gathered along the sequence, and the parameters'
    gradients, partial on each rank, summed over the axis."""
    from ircl_tpu_torch.models import moe as t_moe
    from ircl_tpu_torch.models import transformer as t_tf
    from ircl_tpu_torch.parallel import ep, tp
    from ircl_tpu_torch.parallel.mesh import make_mesh
    from ircl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    out = {}
    for name, c in cases.items():
        mesh = make_mesh(tuple(c["axes"]), tuple(c["axes"].values()), device="cpu")
        full = tree_map(torch.as_tensor, c["params"])
        if c["specs"] == "rep":
            specs = tp.replicated_specs(full)
        elif c["specs"] == "tp":
            specs = tp.transformer_param_specs({"layers": [None]})["layers"][0]
        elif c["layer"] == "block":
            specs = dict(ep.moe_transformer_param_specs({"layers": [None]},
                                                        c["specs"] == "ep_tp")["layers"][0])
        elif c["specs"] == "tp_moe":  # every expert on every rank, TP-sharded
            P = tp.P
            specs = {"router": {"w": P()},
                     "ff1": {"w": P(None, None, "model"), "b": P(None, "model")},
                     "ff2": {"w": P(None, "model", None), "b": P()}}
        else:
            specs = ep.moe_layer_specs(c["specs"] == "ep_tp")
        local = tp.shard_tree(full, specs, mesh)
        kwargs = dict(c["kwargs"])
        if kwargs.get("ep_constrain") == "hook":
            kwargs["ep_constrain"] = ep.make_ep_constrainer(mesh)
        else:
            kwargs["mesh"] = mesh
        views = tree_map(lambda t: t.detach().requires_grad_(), local)
        x, mask, w = (torch.as_tensor(c[k]) for k in ("x", "mask", "w"))
        seq = kwargs.get("seq_axis")
        if seq:
            n, r = mesh[seq].size(), mesh.get_local_rank(seq)
            x, mask, w = (t.chunk(n, dim=1)[r].contiguous() for t in (x, mask, w))
        x = x.requires_grad_()
        if c["layer"] == "block":
            cfg = c["cfg"]
            ctx = t_tf.attention_mask_inputs(cfg, mask)
            y = t_tf.transformer_block(x, views, cfg, ctx, moe_mask=mask, **kwargs)
        else:
            y = t_moe.moe_ffn(x, views, c["cfg"], mask=mask, **kwargs)
        y, aux = y if isinstance(y, tuple) else (y, None)
        loss = (y * w).sum() + (0.0 if aux is None else aux)
        grads = list(torch.autograd.grad(loss, [x] + tree_leaves(views)))
        if seq:
            from ircl_tpu_torch.parallel.common import all_gather_rows

            def along(t):
                return torch.cat(all_gather_rows(t.detach().movedim(1, 0).contiguous(),
                                                 mesh, seq)).movedim(0, 1)

            y, grads[0] = along(y), along(grads[0])
            for g in grads[1:]:
                dist.all_reduce(g, group=mesh.get_group(seq))
        whole = tp.gather_tree(tree_unflatten(views, grads[1:]), specs, mesh)
        res = dict(y=y.detach().numpy(), aux=None if aux is None else float(aux),
                   grad_x=grads[0].numpy(), grads=_np(whole),
                   local=tuple(local["ff1"]["w"].shape) if "ff1" in local else
                   tuple(local["moe"]["ff1"]["w"].shape))
        out[name] = _same_on_every_rank(res)
    return out


def cli_mains(argvs):
    """``cli.main(argv)`` for each argv in turn, in every rank; each argv's
    standard output of every rank, in rank order."""
    out = []
    for argv in argvs:
        mine = cli_main(argv)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        out.append(every)
    return out


# ---- pipeline and context parallelism of the verdict model ----------------------


def _stacked(full, shape, moe):
    """``full``'s layers stacked over ``shape["stage"]`` stages and the spec
    tree that places them (``P("stage")``, or the TP/EP layout where the
    mesh has those axes)."""
    from ircl_tpu_torch.parallel import pp

    stacked = pp.stack_layer_params(full["layers"], shape["stage"])
    if "model" in shape or "expert" in shape:
        return stacked, pp.stacked_stage_specs(moe=moe, tp="model" in shape,
                                               ep="expert" in shape)
    return stacked, pp.stage_specs(stacked)


def pp_forward(cfg, params, arrays, shape, n_micro):
    """``make_pp_transformer_apply`` on this rank's rows of ``arrays`` (ids,
    mask, types): the whole batch's last hidden state (and the aux of an
    MoE encoder), the same on every rank."""
    from ircl_tpu_torch.parallel import pp, tp
    from ircl_tpu_torch.parallel.common import gather_data_rows
    from ircl_tpu_torch.utils import convert

    mesh = _mesh(shape)
    full = convert.transformer_params_from_numpy(params, "cpu")
    embed = {k: v for k, v in full.items() if k != "layers"}
    stacked, specs = _stacked(full, shape, cfg.moe is not None)
    apply = pp.make_pp_transformer_apply(cfg, mesh, n_micro)
    out = apply(embed, tp.shard_tree(stacked, specs, mesh), *tp.shard_batch(mesh, *arrays))
    hidden, aux = out if isinstance(out, tuple) else (out, None)
    return _same_on_every_rank(dict(hidden=gather_data_rows(hidden, mesh).numpy(),
                                    aux=None if aux is None else float(aux)))


def pp_refusal(cfg, shape):
    """``make_pp_transformer_apply`` of ``cfg`` on a mesh of ``shape``."""
    from ircl_tpu_torch.parallel import pp

    pp.make_pp_transformer_apply(cfg, _mesh(shape), n_micro=2)


def pp_steps(cfg, params0, batches, shape, n_micro, remat=False, grads=True):
    """``make_pp_verdict_train_step`` over ``batches`` from the numpy
    ``params0`` on a ``make_pp_mesh`` of ``shape``: per step the loss, then
    the whole parameters in the standard layout, the local shapes of the
    stage-sharded ``ff1`` (or MoE ``ff1``) weight and of its Adam moment;
    with ``grads`` the whole gradients of the first batch
    (``make_pp_verdict_grad_fn``); and every rank's layout report."""
    from ircl_tpu_torch.parallel import pp, tp
    from ircl_tpu_torch.utils import convert

    mesh = _mesh(shape)
    pp0 = pp.pp_verdict_params(convert.verdict_params_from_numpy(params0, "cpu"),
                               shape["stage"])
    specs = pp.pp_verdict_specs(pp0, mesh)
    p = tp.shard_tree(pp0, specs, mesh)
    out = {}
    if grads:
        fn = pp.make_pp_verdict_grad_fn(cfg, mesh, n_micro, remat)
        loss, _, g = fn(p, *tp.shard_batch(mesh, *batches[0]))
        out.update(grads=_np(pp.verdict_params_from_pp(tp.gather_tree(g, specs, mesh))),
                   grad_loss=float(loss))
    step, tx = pp.make_pp_verdict_train_step(cfg, mesh, n_micro, remat)
    o = tp.init_sharded_opt_state(tx, p, mesh, specs)
    losses = []
    for i, b in enumerate(batches):
        p, o, loss, _ = step(p, o, i, *tp.shard_batch(mesh, *b))
        losses.append(float(loss))
    ff1 = lambda t: t["moe"]["ff1"]["w"] if "moe" in t else t["ff1"]["w"]  # noqa: E731
    out.update(losses=losses,
               params=_np(pp.verdict_params_from_pp(tp.gather_tree(p, specs, mesh))),
               local=(tuple(ff1(p["stages"]).shape), tuple(ff1(o["mu"]["stages"]).shape)))
    layout = _layout_report(mesh, p, specs)
    return dict(_same_on_every_rank(out), layout=layout)


def cp_forward(cfg, params0, arrays, shape):
    """``make_cp_verdict_forward`` on the whole batch: its logits, the same
    on every rank."""
    from ircl_tpu_torch.parallel import cp
    from ircl_tpu_torch.utils import convert

    mesh = cp.make_cp_mesh(seq=shape["seq"], data=shape["data"], device="cpu")
    params = convert.verdict_params_from_numpy(params0, "cpu")
    return _same_on_every_rank(cp.make_cp_verdict_forward(cfg, mesh)(params, *arrays).numpy())


def cp_steps(cfg, params0, batches, shape):
    """The first batch's gradients (``make_cp_verdict_grad_fn``), then
    ``make_cp_verdict_train_step`` with its default Adam(1e-3) over
    ``batches``: the losses and the parameters, the same on every rank."""
    from ircl_tpu_torch.parallel import cp
    from ircl_tpu_torch.utils import convert

    mesh = cp.make_cp_mesh(seq=shape["seq"], data=shape["data"], device="cpu")
    p = convert.verdict_params_from_numpy(params0, "cpu")
    loss, g = cp.make_cp_verdict_grad_fn(cfg, mesh)(p, *batches[0])
    out = dict(grads=_np(g), grad_loss=float(loss))
    step, tx = cp.make_cp_verdict_train_step(cfg, mesh)
    o = tx.init(p)
    losses = []
    for b in batches:
        p, o, loss = step(p, o, *b)
        losses.append(float(loss))
    return _same_on_every_rank(dict(out, losses=losses, params=_np(p)))


def ring_parity(q, k, v, bias, w, seq):
    """``ring_attention`` over a ``("data", "seq")`` mesh of ``seq`` ranks,
    each holding its block of the sequence: the whole output and the whole
    gradients of ``sum(out * w)`` in q, k and v, gathered in rank order."""
    from ircl_tpu_torch.ops.ring_attention import ring_attention
    from ircl_tpu_torch.parallel import cp
    from ircl_tpu_torch.parallel.common import all_gather_rows
    from ircl_tpu_torch.parallel.mesh import axis_rank

    mesh = cp.make_cp_mesh(seq=seq, data=1, device="cpu")
    r = axis_rank(mesh, "seq")

    def mine(a):  # [B, H, L, D]: this rank's block of L
        return torch.as_tensor(a).chunk(seq, dim=2)[r]

    ql, kl, vl = (mine(a).clone().requires_grad_() for a in (q, k, v))
    out = ring_attention(ql, kl, vl, torch.as_tensor(bias).chunk(seq, dim=-1)[r], "seq",
                         mesh=mesh)
    grads = torch.autograd.grad((out * mine(w)).sum(), (ql, kl, vl))

    def whole(t):
        return torch.cat(all_gather_rows(t.detach().movedim(2, 0).contiguous(), mesh,
                                         "seq")).movedim(0, 2).numpy()

    return _same_on_every_rank(dict(out=whole(out), dq=whole(grads[0]), dk=whole(grads[1]),
                                    dv=whole(grads[2])))
