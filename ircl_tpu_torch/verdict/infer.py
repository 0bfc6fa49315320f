"""Verdict inference: load a checkpoint and classify claims.

Counterpart of ``ircl_tpu/verdict/infer.py``, the serving side of the
reference pipeline: retrieve evidence, then classify the claim against it
(``src/QA/evaluate.py``; labels per ``src/QA/dataset.py:77,90``).
``VerdictClassifier`` runs pinned-shape batches: every device call is
exactly ``(batch_size, max_length)``, the tail padded with empty pairs.

Checkpoints. ``cli train-verdict`` writes ``verdict_config.json``,
``verdict_vocab.txt`` and an orbax directory ``verdict/`` of params.
``load_verdict_checkpoint`` and ``save_verdict_checkpoint`` read and write
the first two unchanged, and keep the params in a file of the port's own
beside them, ``verdict_params.pt`` (``torch.save``; read back with
``torch.load(weights_only=True)``). The port does not read the orbax
directory: that needs orbax or tensorstore, which the machine with the card
does not have. A reference checkpoint crosses over once, on a host with
both packages: restore it with ``ircl_tpu``, convert the params with
``utils/convert.py::verdict_params_from_numpy`` and call
``save_verdict_checkpoint``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Sequence

import torch

from ircl_tpu_torch.models.moe import MoEConfig
from ircl_tpu_torch.models.transformer import TransformerConfig
from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
from ircl_tpu_torch.utils.convert import to_device, verdict_params_from_numpy
from ircl_tpu_torch.utils.profiling import span
from ircl_tpu_torch.verdict.model import VerdictConfig, verdict_apply

# inverse of corpus.fever.LABEL_MAP (SUPPORTS=1 / REFUTES=0)
LABEL_NAMES = {1: "SUPPORTS", 0: "REFUTES"}

CONFIG_FILE = "verdict_config.json"
VOCAB_FILE = "verdict_vocab.txt"
PARAMS_FILE = "verdict_params.pt"


def save_verdict_checkpoint(ckptdir: str, cfg: VerdictConfig, params, tokenizer):
    """Write the reference's ``verdict_config.json`` and
    ``verdict_vocab.txt`` (as ``cli train-verdict`` writes them: a MoE
    encoder's ``MoEConfig`` as a dict under ``"moe"``) and the params, on
    the CPU, to ``verdict_params.pt``."""
    os.makedirs(ckptdir, exist_ok=True)
    tokenizer.save_vocab(os.path.join(ckptdir, VOCAB_FILE))
    with open(os.path.join(ckptdir, CONFIG_FILE), "w") as f:
        json.dump(
            {
                "encoder": dataclasses.asdict(cfg.encoder) | {"dtype": None},
                "num_labels": cfg.num_labels,
                "max_length": cfg.max_length,
            },
            f,
        )
    torch.save(to_device(params, "cpu"), os.path.join(ckptdir, PARAMS_FILE))


def load_verdict_checkpoint(ckptdir: str, device):
    """(cfg, params on ``device``, tokenizer) from a directory that
    ``save_verdict_checkpoint`` wrote. The encoder's ``dtype`` is dropped,
    as the reference drops it: the served model runs in float32. A MoE
    encoder's ``MoEConfig`` is rebuilt from its dict."""
    with open(os.path.join(ckptdir, CONFIG_FILE)) as f:
        meta = json.load(f)
    enc_kwargs = {k: v for k, v in meta["encoder"].items() if k != "dtype"}
    if enc_kwargs.get("moe"):  # dataclasses.asdict flattened MoEConfig
        enc_kwargs["moe"] = MoEConfig(**enc_kwargs["moe"])
    cfg = VerdictConfig(
        encoder=TransformerConfig(**enc_kwargs),
        num_labels=meta["num_labels"],
        max_length=meta["max_length"],
    )
    tok = WordPieceTokenizer.from_vocab_file(os.path.join(ckptdir, VOCAB_FILE))
    params = torch.load(
        os.path.join(ckptdir, PARAMS_FILE), map_location="cpu", weights_only=True
    )
    return cfg, verdict_params_from_numpy(params, device), tok


def _probs_batch(params, cfg: VerdictConfig, ids, mask, types) -> torch.Tensor:
    return torch.softmax(verdict_apply(params, cfg, ids, mask, types), dim=-1)


class VerdictClassifier:
    """Pinned-shape claim classifier over (claim, evidence-text) pairs.

    ``classify`` accepts any number of pairs and always runs device batches
    of exactly ``batch_size`` (the tail padded with empty pairs, dropped
    from the output) at the checkpoint's ``max_length``, on the device that
    holds ``params``."""

    def __init__(self, cfg: VerdictConfig, params, tokenizer, batch_size: int = 32):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.params = params
        self.device = params["head_out"]["b"].device

    @classmethod
    def from_checkpoint(cls, ckptdir: str, batch_size: int = 32, *, device):
        cfg, params, tok = load_verdict_checkpoint(ckptdir, device)
        return cls(cfg, params, tok, batch_size=batch_size)

    def warmup(self) -> None:
        self.classify(["warmup"], ["warmup evidence"])

    def classify(
        self, claims: Sequence[str], evidence_texts: Sequence[str]
    ) -> List[dict]:
        """One ``{"label", "label_id", "confidence"}`` per claim;
        ``confidence`` is the softmax probability of the argmax label.

        Each device batch is traced as four spans: ``verdict.tokenize``
        (host WordPiece of the pairs), ``verdict.upload`` (ids, mask and
        types to the device), ``verdict.forward`` (the forward's launches)
        and ``verdict.readback`` (the wait for the device and the copy of
        the probabilities)."""
        if len(claims) != len(evidence_texts):
            raise ValueError(
                f"{len(claims)} claims vs {len(evidence_texts)} evidence texts"
            )
        out: List[dict] = []
        B = self.batch_size
        for lo in range(0, len(claims), B):
            pairs = list(zip(claims[lo : lo + B], evidence_texts[lo : lo + B]))
            n_real = len(pairs)
            pairs += [("", "")] * (B - n_real)
            with span("verdict.tokenize"):
                enc = self.tokenizer.encode_batch(pairs, self.cfg.max_length)
            with span("verdict.upload"):
                ids, mask, types = (
                    torch.as_tensor(x, device=self.device) for x in enc
                )
            with span("verdict.forward"):
                probs = _probs_batch(
                    self.params, self.cfg, ids.long(), mask, types.long()
                )
            with span("verdict.readback"):
                probs = probs.cpu().numpy()[:n_real]
            pred = probs.argmax(axis=-1)
            out.extend(
                {
                    "label": LABEL_NAMES.get(int(p), str(int(p))),
                    "label_id": int(p),
                    "confidence": float(probs[i, p]),
                }
                for i, p in enumerate(pred)
            )
        return out
