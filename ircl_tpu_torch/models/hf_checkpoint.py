"""Find and read a local HuggingFace BERT or RoBERTa checkpoint, without
``transformers``, ``safetensors`` or ``huggingface_hub``.

The JAX package reads the checkpoint through ``AutoModel.from_pretrained``
(``ircl_tpu/models/transformer.py::from_huggingface``); the GPU machine has
none of those packages, so this module does their part by hand and fetches
nothing:

- ``resolve_checkpoint(name)``: an existing directory is used as it is;
  otherwise the hub cache that ``from_pretrained`` reads offline
  (``$HF_HUB_CACHE``, else ``$HUGGINGFACE_HUB_CACHE``, else ``$HF_HOME/hub``,
  else ``$XDG_CACHE_HOME/huggingface/hub`` or ``~/.cache/huggingface/hub``):
  ``models--{name with "/" -> "--"}/snapshots/<refs/main>``.
- ``read_config(path)``: the fields of ``config.json`` the encoder needs,
  with ``BertConfig``'s defaults for a field the file leaves out.
- ``read_weights(path)``: ``model.safetensors`` (parsed here: a
  little-endian u64 header length, a JSON header, raw F32/F16/BF16 data),
  else ``model.safetensors.index.json`` and its shards, else
  ``pytorch_model.bin`` (``torch.load(weights_only=True)``); every tensor
  upcast to float32, as ``AutoModel`` hands the reference float32 weights.
  Keys are normalised as ``AutoModel`` loads a base model: the ``bert.`` /
  ``roberta.`` prefix of a task checkpoint (the original
  ``bert-base-uncased`` files are ``BertForPreTraining``'s) is stripped,
  ``LayerNorm.gamma``/``.beta`` become ``.weight``/``.bias``, and the
  ``pooler.*``, ``cls.*``, ``lm_head.*`` and ``*.position_ids`` entries,
  which the encoder does not use, are dropped unread.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Dict, Optional

import torch

CONFIG_FIELDS = {  # config.json key -> BertConfig's default
    "model_type": "bert",
    "vocab_size": 30522,
    "hidden_size": 768,
    "num_hidden_layers": 12,
    "num_attention_heads": 12,
    "intermediate_size": 3072,
    "max_position_embeddings": 512,
    "type_vocab_size": 2,
    "layer_norm_eps": 1e-12,
}
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_BASE_PREFIXES = ("bert.", "roberta.")
_DROPPED_PREFIXES = ("pooler.", "cls.", "lm_head.")


def hub_cache_dir() -> str:
    """The hub cache ``huggingface_hub`` reads, from the same variables."""
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"),
        "huggingface",
    )
    cache = (os.environ.get("HF_HUB_CACHE") or os.environ.get("HUGGINGFACE_HUB_CACHE")
             or os.path.join(home, "hub"))
    return os.path.expandvars(os.path.expanduser(cache))


def resolve_checkpoint(name: str) -> str:
    """The directory that holds ``name``'s ``config.json``: ``name`` itself
    if it is a directory, else its snapshot in the hub cache at the revision
    ``refs/main`` names. ``FileNotFoundError`` names every path searched."""
    if os.path.isdir(name):
        if not os.path.isfile(os.path.join(name, "config.json")):
            raise FileNotFoundError(f"{name} holds no config.json")
        return name
    repo = os.path.join(hub_cache_dir(), "models--" + name.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    searched = [name, ref]
    if os.path.isfile(ref):
        with open(ref, encoding="utf-8") as f:
            snapshot = os.path.join(repo, "snapshots", f.read().strip())
        searched.append(os.path.join(snapshot, "config.json"))
        if os.path.isfile(searched[-1]):
            return snapshot
    raise FileNotFoundError(
        f"no local HuggingFace checkpoint {name!r} (nothing is downloaded); "
        f"searched: {', '.join(searched)}"
    )


def read_config(path: str) -> Dict:
    """``CONFIG_FIELDS`` of ``path/config.json``."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        hc = json.load(f)
    return {key: hc.get(key, default) for key, default in CONFIG_FIELDS.items()}


def base_model_key(key: str) -> Optional[str]:
    """A checkpoint key as ``AutoModel``'s base model names it, or ``None``
    for an entry the encoder does not use."""
    for prefix in _BASE_PREFIXES:
        if key.startswith(prefix):
            key = key[len(prefix):]
            break
    if key.startswith(_DROPPED_PREFIXES) or key.endswith("position_ids"):
        return None
    if key.endswith("LayerNorm.gamma"):
        return key[: -len("gamma")] + "weight"
    if key.endswith("LayerNorm.beta"):
        return key[: -len("beta")] + "bias"
    return key


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The kept tensors of one safetensors file, float32, by base-model key."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors data is little-endian; this host is not")
    with open(path, "rb") as f:
        (n_header,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n_header))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n_header)
        f.readinto(data)
    out = {}
    for key, entry in header.items():
        name = None if key == "__metadata__" else base_model_key(key)
        if name is None:
            continue
        dtype = _SAFETENSORS_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {key} is {entry['dtype']}; only F32, F16 and "
                             "BF16 weights are read")
        begin, end = entry["data_offsets"]
        shape = entry["shape"]
        count = (end - begin) // dtype.itemsize
        t = (torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape).to(torch.float32, copy=True)
    return out


def read_weights(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor the encoder uses, float32, by base-model key, from the
    first weight file found: ``model.safetensors``, the safetensors index
    and its shards, ``pytorch_model.bin``."""
    single = os.path.join(path, "model.safetensors")
    index = os.path.join(path, "model.safetensors.index.json")
    pickled = os.path.join(path, "pytorch_model.bin")
    if os.path.isfile(single):
        return read_safetensors(single)
    if os.path.isfile(index):
        with open(index, encoding="utf-8") as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out = {}
        for shard in shards:
            out.update(read_safetensors(os.path.join(path, shard)))
        return out
    if os.path.isfile(pickled):
        sd = torch.load(pickled, map_location="cpu", weights_only=True)
        return {name: t.to(torch.float32, copy=True) for key, t in sd.items()
                if (name := base_model_key(key)) is not None}
    raise FileNotFoundError(f"{path} holds no weights; looked for "
                            f"{', '.join([single, index, pickled])}")

