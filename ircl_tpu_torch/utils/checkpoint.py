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


def save_sharded(path: str, tree) -> str:
    """Sharded (multi-device) checkpoints are not ported yet (ROADMAP.md
    queue 1 item 12)."""
    raise NotImplementedError(
        "save_sharded is not ported yet (ROADMAP.md queue 1 item 12)"
    )


def restore_sharded(path: str, like):
    """Sharded (multi-device) checkpoints are not ported yet (ROADMAP.md
    queue 1 item 12)."""
    raise NotImplementedError(
        "restore_sharded is not ported yet (ROADMAP.md queue 1 item 12)"
    )


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
