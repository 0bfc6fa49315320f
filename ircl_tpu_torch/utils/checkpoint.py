"""Checkpoint save and restore for the contrastive train state.

Counterpart of ``ircl_tpu/utils/checkpoint.py``, which covers the
reference's ``save_model`` / ``load_model`` (``src/model.py:76-99``): the
whole state — query parameters, EMA key parameters, the optimizer state,
the negative queue and its pointer (registered buffers in the reference's
``state_dict``) and the step. Names follow the reference's
``{sample}_{loss}_{model}_{step}`` convention. Where the JAX package writes
an orbax directory, the port writes one ``torch.save`` file of tensors and
ints under the same name, and reads it back with ``weights_only=True``; it
cannot read the JAX package's orbax checkpoints.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ircl_tpu_torch.contrastive.state import TrainState
from ircl_tpu_torch.utils.tree import tree_map

_FIELDS = ("params_q", "params_k", "opt_state", "queue", "queue_ptr", "step")


def _ckpt_path(ckptdir: str, tag: str, step: int) -> str:
    return os.path.abspath(os.path.join(ckptdir, f"{tag}_{step}"))


def save_state(ckptdir: str, tag: str, state: TrainState) -> str:
    """Write ``state`` to ``{ckptdir}/{tag}_{step}`` (a finished file is
    renamed into place) and return the path."""
    path = _ckpt_path(ckptdir, tag, state.step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tree = {f: getattr(state, f) for f in _FIELDS}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree_map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                        tree), tmp)
    os.replace(tmp, path)
    return path


def restore_state(path: str, template: TrainState) -> TrainState:
    """Restore into the structure of ``template`` (built from the same
    TrainConfig — the reference analogously rebuilds the model from pickled
    Args before loading the state dict), on the template's devices. A
    checkpoint whose tree or shapes differ from the template's raises
    ``ValueError``."""
    loaded = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)

    def leaf(want, got):
        if isinstance(want, torch.Tensor):
            if not isinstance(got, torch.Tensor) or got.shape != want.shape or (
                    got.dtype != want.dtype):
                raise ValueError(f"{path}: {getattr(got, 'shape', got)} where the "
                                 f"template has {tuple(want.shape)} {want.dtype}")
            return got.to(want.device)
        if type(got) is not type(want):
            raise ValueError(f"{path}: {got!r} where the template has {want!r}")
        return got

    try:
        restored = tree_map(leaf, {f: getattr(template, f) for f in _FIELDS}, loaded)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"{path} does not hold the template's tree: {e!r}") from e
    return TrainState(**restored)


# ---------------------------------------------------------------------------
# Sharded (multi-device) checkpoints: each rank writes only its own shards,
# with no gather onto one host, and a restore puts the state into the
# target layout, which may differ from the one it was saved from (an elastic
# resume). torch.distributed.checkpoint does both over DTensor views of the
# local shards; its directory format is not orbax's (ROADMAP.md queue 3).
# The pipeline's stage-stacked layout (parallel/pp.py::pp_verdict_specs)
# saves and restores like any other; parallel/pp.py::restack_pp_params
# re-cuts the whole restored tree onto another stage count.
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    """``{"a/b/0/c": leaf}`` in ``utils/tree.py``'s order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _views(tree, mesh, specs):
    """The flat state dict of ``tree``: each tensor a DTensor view of this
    rank's shard under its spec (whole tensors without a mesh)."""
    flat = _flat(tree)
    if mesh is None:
        return flat
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = mesh.mesh_dim_names
    flat_specs = _flat(specs)

    def view(key, x):
        if not isinstance(x, torch.Tensor):
            return x
        axes = flat_specs[key].axes
        placements = [Shard(axes.index(n)) if n in axes else Replicate() for n in names]
        return DTensor.from_local(x, mesh, placements, run_check=False)

    return {k: view(k, v) for k, v in flat.items()}


def save_sharded(path: str, tree, *, mesh=None, specs=None) -> str:
    """Save a tree of this rank's shards, ``specs`` (``parallel/tp.py``'s
    ``P`` trees; ``parallel.tp.state_specs`` for an optimizer state) saying
    how each shards over ``mesh``. Every rank calls it; each writes its own
    shards (a replicated tensor once), with no gather onto one host.
    Without a mesh, a tree of whole tensors in this process alone."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    dcp.save(_views(tree, mesh, specs), checkpoint_id=path, no_dist=mesh is None)
    return path


def restore_sharded(path: str, like, *, mesh=None, specs=None):
    """A tree of ``like``'s structure holding the checkpoint's values in the
    layout that ``like``, ``specs`` and ``mesh`` describe: this rank's
    shards, read from the shards that hold them. The layout may differ
    from the saved one (TP(4) x DP(2) restores onto TP(2) x DP(4), or onto
    replicated parameters). ``like`` is left as it is."""
    import torch.distributed.checkpoint as dcp

    fresh = tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
                     like)
    state = _views(fresh, mesh, specs)
    dcp.load(state, checkpoint_id=os.path.abspath(path), no_dist=mesh is None)
    values = iter(state.values())

    def leaf(x):
        v = next(values)
        if not isinstance(x, torch.Tensor):
            return v
        return x  # loaded in place, through its view

    return tree_map(leaf, fresh)


def latest_checkpoint(ckptdir: str, tag: str) -> Optional[str]:
    if not os.path.isdir(ckptdir):
        return None
    best: Tuple[int, Optional[str]] = (-1, None)
    prefix = f"{tag}_"
    for name in os.listdir(ckptdir):
        if name.startswith(prefix):
            try:
                step = int(name[len(prefix):])
            except ValueError:
                continue
            if step > best[0]:
                best = (step, os.path.join(ckptdir, name))
    return best[1]
