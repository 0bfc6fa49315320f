"""Text featurizers: frozen embedding producers feeding the encoder head.

Counterpart of ``ircl_tpu/models/featurizer.py``. The reference freezes a
pretrained ``bert-base-uncased`` and feeds its last hidden state to the
BiLSTM head (``src/contrastor/contrastive_module.py:32-41``):

- ``HashEmbedFeaturizer``: frozen random token embeddings addressed by
  murmur3 token hashes, plus sinusoidal positions. The table comes from a
  ``torch.Generator`` seeded with ``config.seed``; ``encode_host`` is the
  JAX package's, through the port's ``corpus`` copy and the native
  ``ircl_tokenize_hash_seq``.
- ``TransformerFeaturizer``: the reference's architecture, a frozen
  transformer over a corpus-trained WordPiece vocab, random-initialized.

``encode_host`` turns strings into padded ``(ids, mask)`` numpy arrays on
the host; ``features`` maps them to ``[B, L, D]`` on the featurizer's
device.

``kind="hf"`` is ``TransformerFeaturizer.from_huggingface``: a local
HuggingFace BERT or RoBERTa checkpoint (a directory, or a name in the hub
cache), its weights read by ``models/hf_checkpoint.py`` and its tokenizer by
``models/hf_tokenizer.py``, without ``transformers``; nothing is fetched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ircl_tpu_torch.corpus.filters import normalize
from ircl_tpu_torch.corpus.hashing import hash_tokens
from ircl_tpu_torch.corpus.tokenizer import default_tokenizer
from ircl_tpu_torch.utils.convert import to_device
from ircl_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class FeaturizerConfig:
    kind: str = "hash"  # hash | transformer | hf
    dim: int = 768
    max_len: int = 64
    vocab_buckets: int = 1 << 18
    seed: int = 1126  # reference loss-module seed, reused as a nod
    # Token signal must dominate position signal, or every sequence embeds to
    # nearly the same mean-pooled vector (representation collapse).
    token_scale: float = 1.0
    pos_scale: float = 0.1
    # transformer featurizer (reference: frozen bert-base-uncased); dim
    # doubles as hidden size
    tf_layers: int = 12
    tf_heads: int = 12
    tf_intermediate: int = 3072
    wp_vocab: int = 8192  # corpus-trained WordPiece vocab size (offline)
    vocab_file: str = ""  # optional cached vocab.txt
    hf_name: str = "bert-base-uncased"  # kind="hf" checkpoint name


def _native_seq_lib():
    import ctypes

    from ircl_tpu_torch.corpus.hashing import get_native

    return get_native(
        "ircl_tokenize_hash_seq",
        [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ],
        None,
    )


def sinusoidal_positions(config: FeaturizerConfig) -> np.ndarray:
    """[max_len, dim] sinusoidal positions scaled by ``pos_scale``."""
    pos = np.arange(config.max_len)[:, None]
    div = np.exp(np.arange(0, config.dim, 2) * (-np.log(10000.0) / config.dim))
    pe = np.zeros((config.max_len, config.dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe * np.float32(config.pos_scale)


class HashEmbedFeaturizer:
    """Deterministic frozen featurizer: hashed-token embeddings + positions.

    ``params`` (``{"table", "pos"}``) defaults to a fresh draw: a
    unit-normal ``[vocab_buckets, dim]`` table from a ``torch.Generator``
    seeded with ``config.seed`` (805 MB at the defaults), scaled by
    ``token_scale``. ``utils/convert.py`` supplies the JAX package's
    arrays instead."""

    def __init__(
        self, config: FeaturizerConfig = FeaturizerConfig(), device=None,
        params=None,
    ):
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(config.seed)
            table = torch.randn(
                (config.vocab_buckets, config.dim), generator=gen
            ) * config.token_scale
            params = {
                "table": table,
                "pos": torch.from_numpy(sinusoidal_positions(config)),
            }
        self.params = to_device(params, self.device)

    def encode_host(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Strings -> (ids [B, L] int32, mask [B, L] f32). ASCII texts go
        through the C++ sequence tokenizer in one pass; the others through
        the Python pipeline, bit-identically."""
        L = self.config.max_len
        B = len(texts)
        ids = np.zeros((B, L), dtype=np.int32)
        mask = np.zeros((B, L), dtype=np.float32)
        normed = [normalize(t) for t in texts]
        lib = _native_seq_lib()
        fallback_rows = range(B)
        if lib is not None:
            import ctypes

            ascii_idx = [b for b, t in enumerate(normed) if t.isascii()]
            if ascii_idx:
                encoded = [normed[b].encode("ascii") for b in ascii_idx]
                offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
                np.cumsum([len(e) for e in encoded], out=offsets[1:])
                packed = b"".join(encoded)
                sub_ids = np.zeros((len(encoded), L), dtype=np.int32)
                sub_mask = np.zeros((len(encoded), L), dtype=np.float32)
                lib.ircl_tokenize_hash_seq(
                    packed,
                    offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    len(encoded),
                    self.config.vocab_buckets,
                    L,
                    sub_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    sub_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                )
                ids[ascii_idx] = sub_ids
                mask[ascii_idx] = sub_mask
            ascii_set = set(ascii_idx)
            fallback_rows = [b for b in range(B) if b not in ascii_set]
        for b in fallback_rows:
            words = default_tokenizer().tokenize(normed[b]).words(uncased=True)
            if not words:
                continue
            hashed = hash_tokens(words[:L], self.config.vocab_buckets)
            n = len(hashed)
            ids[b, :n] = hashed
            mask[b, :n] = 1.0
        return ids, mask

    @staticmethod
    def apply(params, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(ids, mask) tensors -> frozen features [B, L, D]."""
        emb = params["table"][ids.long()] + params["pos"][None, : ids.shape[1]]
        return emb * mask[:, :, None]

    def features(self, ids, mask) -> torch.Tensor:
        return self.apply(self.params, *_on(self.device, ids, mask))


def _on(device, ids, mask):
    return (
        torch.as_tensor(ids, dtype=torch.int32, device=device),
        torch.as_tensor(mask, dtype=torch.float32, device=device),
    )


class TransformerFeaturizer:
    """Frozen transformer featurizer, the reference's central architecture:
    a transformer over a WordPiece tokenizer whose last hidden state, pads
    zeroed, feeds the BiLSTM head. ``params`` live on ``device``."""

    def __init__(self, tokenizer, tcfg, params, config: FeaturizerConfig,
                 device=None):
        self.tokenizer = tokenizer
        self.tcfg = tcfg
        self.config = config
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)

    @classmethod
    def random_init(
        cls,
        tokenizer,
        config: FeaturizerConfig = FeaturizerConfig(kind="transformer"),
        device=None,
    ) -> "TransformerFeaturizer":
        """Random-init transformer over a given (word-piece) tokenizer, from a
        ``torch.Generator`` seeded with ``config.seed``."""
        device = resolve_device(device)  # before the weights are drawn
        from ircl_tpu_torch.models.transformer import (
            TransformerConfig,
            init_transformer_params,
        )

        tcfg = TransformerConfig(
            vocab_size=tokenizer.vocab_size,
            hidden=config.dim,
            layers=config.tf_layers,
            heads=config.tf_heads,
            intermediate=config.tf_intermediate,
            max_positions=max(config.max_len, 512),
        )
        gen = torch.Generator().manual_seed(config.seed)
        params = init_transformer_params(gen, tcfg, "cpu")
        return cls(tokenizer, tcfg, params, config, device=device)

    @classmethod
    def train_from_corpus(
        cls,
        texts,
        config: FeaturizerConfig = FeaturizerConfig(kind="transformer"),
        device=None,
    ) -> "TransformerFeaturizer":
        """Train a WordPiece vocab from the corpus (or read
        ``config.vocab_file``), then random-init the transformer over it."""
        from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer

        if config.vocab_file:
            tok = WordPieceTokenizer.from_vocab_file(config.vocab_file)
        else:
            tok = WordPieceTokenizer.train(texts, vocab_size=config.wp_vocab)
        return cls.random_init(tok, config, device=device)

    @classmethod
    def from_huggingface(
        cls,
        name: str = "bert-base-uncased",
        config: FeaturizerConfig = FeaturizerConfig(kind="hf"),
        device=None,
    ) -> "TransformerFeaturizer":
        """Pretrained weights and tokenizer of a local HuggingFace checkpoint
        (``models.transformer.from_huggingface``,
        ``hf_tokenizer.from_pretrained_dir``); ``max_len`` is the caller's,
        the widths the checkpoint's."""
        device = resolve_device(device)  # before the weights are read
        from ircl_tpu_torch.models.hf_checkpoint import resolve_checkpoint
        from ircl_tpu_torch.models.hf_tokenizer import from_pretrained_dir
        from ircl_tpu_torch.models.transformer import from_huggingface

        path = resolve_checkpoint(name)
        tcfg, params = from_huggingface(path)
        cfg = FeaturizerConfig(
            kind="hf",
            dim=tcfg.hidden,
            max_len=config.max_len,
            tf_layers=tcfg.layers,
            tf_heads=tcfg.heads,
            tf_intermediate=tcfg.intermediate,
            hf_name=name,
        )
        return cls(from_pretrained_dir(path), tcfg, params, cfg, device=device)

    def encode_host(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Strings -> ([B, L] int32 ids, [B, L] f32 mask): [CLS] text [SEP]."""
        ids, mask, _ = self.tokenizer.encode_batch(
            [(t, None) for t in texts], max_length=self.config.max_len
        )
        return ids, mask

    def apply(self, params, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Frozen forward: last hidden state, padded positions zeroed."""
        from ircl_tpu_torch.models.transformer import transformer_apply

        h = transformer_apply(params, self.tcfg, ids.long(), mask)
        return h * mask[:, :, None].to(h.dtype)

    def features(self, ids, mask) -> torch.Tensor:
        return self.apply(self.params, *_on(self.device, ids, mask))


def make_featurizer(config: FeaturizerConfig, corpus_texts=None, device=None):
    """Config-driven featurizer factory."""
    if config.kind == "hash":
        return HashEmbedFeaturizer(config, device=device)
    if config.kind == "transformer":
        if config.vocab_file:
            return TransformerFeaturizer.train_from_corpus([], config, device)
        if corpus_texts is None:
            raise ValueError(
                "kind='transformer' needs corpus_texts to train a WordPiece "
                "vocab (or set featurizer.vocab_file)"
            )
        return TransformerFeaturizer.train_from_corpus(corpus_texts, config, device)
    if config.kind == "hf":
        return TransformerFeaturizer.from_huggingface(config.hf_name, config, device)
    raise ValueError(f"unknown featurizer kind: {config.kind!r}")
