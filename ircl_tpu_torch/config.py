"""Typed configuration for the whole framework.

Counterpart of ``ircl_tpu/config.py``, carried over line for line over the
port's ``TrainConfig``, ``EncoderConfig`` and ``FeaturizerConfig``. A JSON
file needs nothing beyond the standard library; any other path is read as
YAML, which imports PyYAML only then.

Replaces the reference's single loosely-typed YAML (``config.yaml``) whose
quirks — duplicate ``optimizer:`` keys resolved by last-wins, a mis-nested
HProtoNCE block, stringly-typed floats eval()'d at use sites (see SURVEY.md
section 5) — are all structural hazards. Here every section is a frozen
dataclass with typed fields; YAML/JSON files load into them with unknown-key
errors instead of silent shadowing.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ircl_tpu_torch.contrastive.state import TrainConfig
from ircl_tpu_torch.models.encoder import EncoderConfig
from ircl_tpu_torch.models.featurizer import FeaturizerConfig


@dataclass(frozen=True)
class IndexConfig:
    hash_size: int = 1 << 24  # reference default (build_tfidf.py)
    ngram: int = 2
    mode: str = "auto"  # ell | ragged | auto
    binary_tf: bool = False  # True = the reference's "BM25" binary-tf variant


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = "data"
    wiki_json: str = "data/small_wiki.json"
    train_jsonl: str = "data/train.jsonl"
    dev_jsonl: str = "data/shared_task_dev.jsonl"
    # synthetic corpus knobs (offline default)
    synthetic: bool = True
    synthetic_docs: int = 1000
    synthetic_claims: int = 200
    seed: int = 0


@dataclass(frozen=True)
class RetrievalConfig:
    k_docs: int = 5
    k_sents: int = 5
    batch_size: int = 128


@dataclass(frozen=True)
class VerdictTrainConfig:
    epochs: int = 3
    batch_size: int = 8
    val_fraction: float = 0.01
    learning_rate: float = 1e-5
    warmup_steps: int = 5000
    max_length: int = 512
    seed: int = 1009


@dataclass(frozen=True)
class Config:
    data: DataConfig = DataConfig()
    index: IndexConfig = IndexConfig()
    featurizer: FeaturizerConfig = FeaturizerConfig()
    train: TrainConfig = TrainConfig()
    retrieval: RetrievalConfig = RetrievalConfig()
    verdict: VerdictTrainConfig = VerdictTrainConfig()
    ckptdir: str = "ckpt"
    logdir: str = "log"
    seed: int = 1337


_SECTIONS = {
    "data": DataConfig,
    "index": IndexConfig,
    "featurizer": FeaturizerConfig,
    "retrieval": RetrievalConfig,
    "verdict": VerdictTrainConfig,
}


def _build(dc_type, values: Dict[str, Any]):
    names = {f.name: f for f in dataclasses.fields(dc_type)}
    unknown = set(values) - set(names)
    if unknown:
        raise ValueError(f"unknown keys for {dc_type.__name__}: {sorted(unknown)}")
    kwargs = {}
    for k, v in values.items():
        f = names[k]
        if dataclasses.is_dataclass(f.type) or f.type in (
            EncoderConfig,
            TrainConfig,
        ):
            kwargs[k] = _build(f.type, v) if isinstance(v, dict) else v
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return dc_type(**kwargs)


def load_config(path: Optional[str] = None, overrides: Optional[Dict] = None) -> Config:
    """Load Config from a yaml/json file plus dotted-key overrides
    (e.g. {"train.loss": "ProtoNCE"})."""
    raw: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            if path.endswith(".json"):
                raw = json.load(f)
            else:
                import yaml

                raw = yaml.safe_load(f) or {}

    cfg = Config()
    for section, val in raw.items():
        if section in _SECTIONS:
            cfg = dataclasses.replace(cfg, **{section: _build(_SECTIONS[section], val)})
        elif section == "train":
            enc = val.pop("encoder", None)
            tc = _build(TrainConfig, val)
            if enc:
                tc = dataclasses.replace(tc, encoder=_build(EncoderConfig, enc))
            cfg = dataclasses.replace(cfg, train=tc)
        elif hasattr(cfg, section):
            cfg = dataclasses.replace(cfg, **{section: val})
        else:
            raise ValueError(f"unknown config section: {section}")

    for key, value in (overrides or {}).items():
        cfg = apply_override(cfg, key, value)
    return cfg


def apply_override(cfg: Config, dotted: str, value: Any) -> Config:
    parts = dotted.split(".")

    def rec(obj, parts):
        if len(parts) == 1:
            field_names = {f.name: f for f in dataclasses.fields(obj)}
            if parts[0] not in field_names:
                raise ValueError(f"unknown config field: {dotted}")
            current = getattr(obj, parts[0])
            if isinstance(current, bool):
                value2 = value in (True, "true", "True", "1", 1)
            elif isinstance(current, int) and not isinstance(current, bool):
                value2 = int(value)
            elif isinstance(current, float):
                value2 = float(value)
            elif isinstance(current, tuple):
                value2 = tuple(
                    type(current[0])(x) if current else x
                    for x in str(value).split(",")
                )
            else:
                value2 = value
            return dataclasses.replace(obj, **{parts[0]: value2})
        child = getattr(obj, parts[0])
        return dataclasses.replace(obj, **{parts[0]: rec(child, parts[1:])})

    return rec(cfg, parts)
