"""The port's entry points run on the card unless the caller names a device.

``utils/device.py::default_device`` is the one default: ``cuda``, or an
error where no CUDA device is present. No entry point falls back to the CPU
on its own; the tests pass ``device="cpu"``. Here (no card) every entry
point called without a device must raise, and with ``device="cpu"`` put its
tensors there.
"""

import inspect

import numpy as np
import pytest
import torch

from ircl_tpu_torch import graft_entry
from ircl_tpu_torch.contrastive import cluster as t_cluster
from ircl_tpu_torch.contrastive import state as t_state
from ircl_tpu_torch.models import encoder as t_enc
from ircl_tpu_torch.models import featurizer as t_feat
from ircl_tpu_torch.models import transformer as t_tf
from ircl_tpu_torch.ops import bilstm as t_lstm
from ircl_tpu_torch.utils import convert
from ircl_tpu_torch.utils.device import default_device, resolve_device
from ircl_tpu_torch.utils.tree import tree_leaves
from ircl_tpu_torch.verdict import model as t_model
from ircl_tpu_torch.verdict import train as t_train

TF = t_tf.TransformerConfig(vocab_size=20, hidden=8, layers=1, heads=2,
                            intermediate=8, max_positions=8)
VCFG = t_model.VerdictConfig(encoder=TF, max_length=8)
ENC = t_enc.EncoderConfig(input_size=4, hidden_size=4, output_size=4, num_layers=1)
HASH = t_feat.FeaturizerConfig(dim=4, max_len=4, vocab_buckets=16)


def _gen():
    return torch.Generator().manual_seed(0)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.numpy()


def _verdict_np():
    return _np(t_model.init_verdict_params(_gen(), VCFG, "cpu"))


ROWS = np.zeros((2, 8), np.int32)
TCFG = t_state.TrainConfig(encoder=ENC, queue_size=8, micro_batch=4)
EMB = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)


def _train_state_np():
    st = t_state.init_train_state(0, TCFG, device="cpu")
    return dict(params_q=_np(st.params_q), params_k=_np(st.params_k),
                queue=st.queue.numpy(), queue_ptr=4, step=1)

# name -> a call that takes ``device`` as a keyword
ENTRY_POINTS = {
    "init_transformer_params": lambda **kw: t_tf.init_transformer_params(_gen(), TF, **kw),
    "init_bilstm_params": lambda **kw: t_lstm.init_bilstm_params(_gen(), 4, 4, 1, **kw),
    "init_encoder_params": lambda **kw: t_enc.init_encoder_params(_gen(), ENC, **kw),
    "init_verdict_params": lambda **kw: t_model.init_verdict_params(_gen(), VCFG, **kw),
    "HashEmbedFeaturizer": lambda **kw: t_feat.HashEmbedFeaturizer(HASH, **kw).params,
    "make_featurizer": lambda **kw: t_feat.make_featurizer(HASH, **kw).params,
    "TransformerFeaturizer": lambda **kw: t_feat.TransformerFeaturizer(
        None, TF, t_tf.init_transformer_params(_gen(), TF, "cpu"), HASH, **kw).params,
    "transformer_params_from_numpy": lambda **kw: convert.transformer_params_from_numpy(
        _verdict_np()["body"], **kw),
    "verdict_params_from_numpy": lambda **kw: convert.verdict_params_from_numpy(
        _verdict_np(), **kw),
    "encoder_params_from_numpy": lambda **kw: convert.encoder_params_from_numpy(
        _np(t_enc.init_encoder_params(_gen(), ENC, "cpu")), **kw),
    "hash_featurizer_params_from_numpy":
        lambda **kw: convert.hash_featurizer_params_from_numpy(
            _np(t_feat.HashEmbedFeaturizer(HASH, "cpu").params), **kw),
    "verdict_opt_state_from_numpy": lambda **kw: [
        v for k, v in convert.verdict_opt_state_from_numpy(
            3, _verdict_np(), _verdict_np(), **kw).items() if k != "count"],
    "make_verdict_train_step": lambda **kw: t_model.make_verdict_train_step(
        VCFG, **kw)[0](
            (p := t_model.init_verdict_params(_gen(), VCFG, "cpu")),
            t_model.make_verdict_optimizer(VCFG).init(p), 0, ROWS,
            np.ones((2, 8), np.float32), ROWS, np.zeros(2, np.int32))[0],
    "predict_in_batches": lambda **kw: torch.from_numpy(t_train.predict_in_batches(
        t_model.init_verdict_params(_gen(), VCFG, "cpu"), VCFG, ROWS,
        np.ones((2, 8), np.float32), ROWS, 2, **kw)),
    "init_train_state": lambda **kw: (
        lambda st: [st.params_q, st.queue])(t_state.init_train_state(0, TCFG, **kw)),
    "train_state_from_numpy": lambda **kw: (
        lambda st: [st.params_q, st.queue, st.opt_state["trace"]])(
        convert.train_state_from_numpy(**_train_state_np(), count=1,
                                       trace=_train_state_np()["params_q"], **kw)),
    "run_kmeans": lambda **kw: t_cluster.run_kmeans(EMB, (2,), 0.05, num_iters=2,
                                                    num_redo=1, **kw).centroids,
    "run_hierarchical": lambda **kw: t_cluster.run_hierarchical(EMB, (2,), 0.05,
                                                                **kw).density,
    "graft_entry.entry": lambda **kw: list(graft_entry.entry(**kw)[1]),
    "train_verdict": lambda **kw: t_train.train_verdict(
        VCFG, np.zeros((4, 8), np.int32), np.ones((4, 8), np.float32),
        np.zeros((4, 8), np.int32), np.zeros(4, np.int32), epochs=1, batch_size=2,
        val_fraction=0, **kw)[0],
}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device exists")


def test_default_device_is_the_card_or_an_error():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("meta")) == torch.device("meta")
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_device_raises_where_there_is_no_card(name):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_with_a_named_device_uses_it(name):
    out = ENTRY_POINTS[name](device="cpu")
    leaves = tree_leaves(out) if isinstance(out, (dict, list)) else [out]
    assert leaves and all(t.device == torch.device("cpu") for t in leaves)


def test_no_port_function_defaults_to_the_cpu():
    import importlib
    import os
    import pkgutil

    import ircl_tpu_torch

    offenders = []
    root = os.path.dirname(ircl_tpu_torch.__file__)
    for mod in pkgutil.walk_packages([root], "ircl_tpu_torch."):
        module = importlib.import_module(mod.name)
        for _, obj in inspect.getmembers(module):
            fns = [obj] if inspect.isfunction(obj) else (
                [f for _, f in inspect.getmembers(obj, inspect.isfunction)]
                if inspect.isclass(obj) else [])
            for fn in fns:
                if getattr(fn, "__module__", "") != mod.name:
                    continue
                for p in inspect.signature(fn).parameters.values():
                    if p.name == "device" and p.default == "cpu":
                        offenders.append(f"{mod.name}.{fn.__qualname__}")
    assert not offenders, offenders
