"""The two tokenizers ``AutoTokenizer`` gives a BERT or RoBERTa checkpoint,
without ``transformers``, ``tokenizers`` or ``regex``.

The JAX package wraps ``AutoTokenizer.from_pretrained(name)`` in
``_HFTokenizerAdapter`` (``ircl_tpu/models/featurizer.py``); the GPU
machine has none of those packages. Each class here has the adapter's
contract: ``encode_batch(pairs, max_length)`` returns ``(ids int32, mask
f32, types int32)`` as the adapter does (``padding="max_length"``,
``truncation=True``; all rows are pairs if any row has a second text), and
``vocab_size`` is the tokenizer's ``vocab_size``. They follow the Rust
library's pipeline step by step:

- added tokens (the special tokens) are split out of the raw text first,
  leftmost and longest first, ``lstrip``/``rstrip`` eating whitespace
  beside them; tokens marked ``normalized`` are split out of the
  normalized text of what is left;
- ``BertTokenizer`` (``vocab.txt``): the BERT normalizer (drop control
  characters, NUL and U+FFFD and turn whitespace into spaces; spaces around
  CJK ideographs; strip accents by NFD, by default when lowercasing;
  lowercase), the BERT pre-tokenizer (split on whitespace, isolate each
  punctuation character), greedy WordPiece with ``##`` (``[UNK]`` past 100
  characters; ``models/wordpiece.py::greedy_pieces``), then ``[CLS] a [SEP]
  (b [SEP])`` with type ids 0 then 1;
- ``RobertaTokenizer`` (``vocab.json``, ``merges.txt``): GPT-2's pattern
  (``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``,
  scanned by hand), GPT-2's byte-to-unicode table, BPE by merge rank, then
  ``<s> a </s></s> b </s>``; no type ids, so the types are zeros;
- truncation is the Rust library's longest-first over the budget left
  after the special tokens; below that budget nothing is cut, as there.

Character classes are the Rust library's (``models/hf_unicode.py``).
Settings come from ``tokenizer_config.json`` (``do_lower_case``,
``strip_accents``, ``tokenize_chinese_chars``, ``add_prefix_space``, the
special tokens), which override ``tokenizer.json``'s as the fast
tokenizers' constructors do; where ``tokenizer.json`` is present its
vocabulary, merges and added tokens are read. ``from_pretrained_dir(path)``
picks the class by ``tokenizer_class``, else ``config.json``'s
``model_type``, else the files present, and raises on any other tokenizer.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ircl_tpu_torch.corpus.uniclass import check_unicode_version
from ircl_tpu_torch.models import hf_unicode as uni
from ircl_tpu_torch.models.wordpiece import greedy_pieces


def _read_json(path: str, name: str) -> Optional[dict]:
    full = os.path.join(path, name)
    if not os.path.isfile(full):
        return None
    with open(full, encoding="utf-8") as f:
        return json.load(f)


def _token(value, default: str) -> str:
    """A special token of ``tokenizer_config.json``: a string, or a
    serialized ``AddedToken``."""
    if value is None:
        return default
    return value["content"] if isinstance(value, dict) else value


class _AddedToken:
    def __init__(self, content: str, token_id: int, lstrip=False, rstrip=False,
                 normalized=False, single_word=False):
        if single_word:
            raise ValueError(f"added token {content!r}: single_word is not supported")
        self.content, self.id = content, token_id
        self.lstrip, self.rstrip, self.normalized = lstrip, rstrip, normalized


def _split(text: str, tokens: Dict[str, _AddedToken]) -> List[Tuple[str, Optional[int]]]:
    """``text`` cut at each added token, leftmost and longest first:
    ``(piece, None)`` for text between tokens, ``("", id)`` for a token."""
    if not tokens or not text:
        return [(text, None)]
    lengths = sorted({len(t) for t in tokens}, reverse=True)
    out, start, i, n = [], 0, 0, len(text)
    while i < n:
        tok = next((tokens[text[i:i + k]] for k in lengths if text[i:i + k] in tokens),
                   None)
        if tok is None:
            i += 1
            continue
        lo, hi = i, i + len(tok.content)
        if tok.lstrip:
            while lo > start and text[lo - 1] in uni.WHITESPACE:
                lo -= 1
        if tok.rstrip:
            while hi < n and text[hi] in uni.WHITESPACE:
                hi += 1
        if lo > start:
            out.append((text[start:lo], None))
        out.append(("", tok.id))
        start = i = hi
    if start < n:
        out.append((text[start:], None))
    return out


def _truncate(a: List[int], b: Optional[List[int]], budget: int):
    """The Rust library's longest-first truncation to ``budget`` tokens."""
    if budget < 0 or len(a) + len(b or ()) <= budget:
        return a, b
    if b is None:
        return a[:budget], None
    n1, n2 = len(a), len(b)
    swap = n1 > n2
    if swap:
        n1, n2 = n2, n1
    n2 = n1 if n1 > budget else max(n1, budget - n1)
    if n1 + n2 > budget:
        n1 = budget // 2
        n2 = n1 + budget % 2
    if swap:
        n1, n2 = n2, n1
    return a[:n1], b[:n2]


class _HFTokenizer:
    """The pipeline both tokenizers share; subclasses give the normalizer,
    the pre-tokenizer, the model and the special tokens' template."""

    n_special = (2, 3)  # special tokens around one text, around a pair

    def __init__(self, vocab: Dict[str, int], added: Sequence[_AddedToken], pad_token: str):
        check_unicode_version()
        self.vocab = vocab
        self._raw = {t.content: t for t in added if not t.normalized}
        self._normalized = {self.normalize(t.content): t for t in added if t.normalized}
        self._ids_of = {**vocab, **{t.content: t.id for t in added}}
        self.pad_id = self._ids_of[pad_token]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def normalize(self, text: str) -> str:
        return text

    def ids(self, text: str) -> List[int]:
        """Token ids of one text, without special tokens around it."""
        out: List[int] = []
        for raw, token_id in _split(text, self._raw):
            if token_id is not None:
                out.append(token_id)
                continue
            for piece, token_id in _split(self.normalize(raw), self._normalized):
                if token_id is not None:
                    out.append(token_id)
                    continue
                for word in self.pre_tokenize(piece):
                    out.extend(self.model(word))
        return out

    def encode_batch(self, pairs: Sequence[Tuple[str, Optional[str]]],
                     max_length: int = 128) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        is_pair = any(b is not None for _, b in pairs)
        rows = []
        for a, b in pairs:
            if is_pair and b is None:
                raise ValueError("a batch of pairs holds a row without a second text")
            ta, tb = _truncate(self.ids(a), self.ids(b) if is_pair else None,
                               max_length - self.n_special[is_pair])
            rows.append(self.template(ta, tb))
        lengths = {len(row_ids) for row_ids, _ in rows}
        width = max_length
        if max(lengths, default=0) > max_length:  # left uncut, below the budget
            if len(lengths) > 1:
                raise ValueError(f"rows over max_length={max_length} differ in length")
            width = lengths.pop()
        ids = np.full((len(rows), width), self.pad_id, np.int32)
        mask = np.zeros((len(rows), width), np.float32)
        types = np.zeros((len(rows), width), np.int32)
        for r, (row_ids, row_types) in enumerate(rows):
            ids[r, : len(row_ids)] = row_ids
            mask[r, : len(row_ids)] = 1.0
            types[r, : len(row_types)] = row_types
        return ids, mask, types


class BertTokenizer(_HFTokenizer):
    """``BertTokenizerFast``: BERT normalizer, BERT pre-tokenizer, WordPiece."""

    def __init__(self, vocab: Dict[str, int], added: Sequence[_AddedToken], *,
                 lowercase: bool = True, strip_accents: Optional[bool] = None,
                 handle_chinese_chars: bool = True, clean_text: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 prefix: str = "##", max_input_chars: int = 100):
        self.lowercase = lowercase
        self.strip_accents = lowercase if strip_accents is None else strip_accents
        self.handle_chinese_chars = handle_chinese_chars
        self.clean_text = clean_text
        self.unk_token, self.prefix, self.max_input_chars = unk_token, prefix, max_input_chars
        super().__init__(vocab, added, pad_token)
        self.unk_id = self._ids_of[unk_token]
        self.cls_id, self.sep_id = self._ids_of[cls_token], self._ids_of[sep_token]

    def normalize(self, text: str) -> str:
        if self.clean_text:
            text = "".join(" " if ch in uni.WHITESPACE else ch for ch in text
                           if not uni.is_removed(ch))
        if self.handle_chinese_chars:
            text = "".join(f" {ch} " if uni.is_chinese(ch) else ch for ch in text)
        if self.strip_accents:
            text = uni.strip_accents(text)
        if self.lowercase:
            text = uni.lower(text)
        return text

    def pre_tokenize(self, text: str) -> List[str]:
        words, word = [], []
        for ch in text:
            if ch in uni.WHITESPACE or uni.is_punctuation(ch):
                if word:
                    words.append("".join(word))
                    word = []
                if ch not in uni.WHITESPACE:
                    words.append(ch)
            else:
                word.append(ch)
        if word:
            words.append("".join(word))
        return words

    def model(self, word: str) -> List[int]:
        return [self.vocab.get(p, self.unk_id) for p in greedy_pieces(
            word, self.vocab, self.unk_token, self.prefix, self.max_input_chars)]

    def template(self, a: List[int], b: Optional[List[int]]):
        ids = [self.cls_id] + a + [self.sep_id]
        types = [0] * len(ids)
        if b is not None:
            ids += b + [self.sep_id]
            types += [1] * (len(b) + 1)
        return ids, types


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's table: printable bytes stand for themselves, the others for
    the code points from 256 up."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
            *range(ord("®"), ord("ÿ") + 1)]
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


_BYTE_CHARS = _bytes_to_unicode()
_CONTRACTIONS = ("re", "ve", "ll", "s", "t", "m", "d")


def gpt2_pieces(text: str) -> List[str]:
    """GPT-2's pattern matched left to right, as onig matches it."""
    out, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "'":
            tail = next((t for t in _CONTRACTIONS if text.startswith(t, i + 1)), None)
            if tail is not None:
                out.append(text[i:i + 1 + len(tail)])
                i += 1 + len(tail)
                continue
        # " ?\p{L}+", " ?\p{N}+", " ?[^\s\p{L}\p{N}]+", each with an
        # optional leading space
        j = i + 1 if ch == " " and i + 1 < n else i
        head = text[j]
        for cls in (uni.is_letter, uni.is_number, _is_other):
            if cls(head):
                k = j + 1
                while k < n and cls(text[k]):
                    k += 1
                out.append(text[i:k])
                i = k
                break
        else:
            if j == i and head not in uni.WHITESPACE:
                raise AssertionError(head)  # every character is L, N, \s or other
            # "\s+(?!\S)", else "\s+"
            k = i + 1
            while k < n and text[k] in uni.WHITESPACE:
                k += 1
            if k < n and k - i > 1:
                k -= 1
            out.append(text[i:k])
            i = k
    return out


def _is_other(ch: str) -> bool:
    return not (ch in uni.WHITESPACE or uni.is_letter(ch) or uni.is_number(ch))


class RobertaTokenizer(_HFTokenizer):
    """``RobertaTokenizerFast``: byte-level pre-tokenizer, BPE."""

    n_special = (2, 4)

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 added: Sequence[_AddedToken], *, add_prefix_space: bool = False,
                 bos_token: str = "<s>", eos_token: str = "</s>", pad_token: str = "<pad>",
                 ignore_merges: bool = False):
        super().__init__(vocab, added, pad_token)
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.add_prefix_space = add_prefix_space
        self.ignore_merges = ignore_merges
        self.cls_id, self.sep_id = self._ids_of[bos_token], self._ids_of[eos_token]
        self._cache: Dict[str, List[int]] = {}

    def pre_tokenize(self, text: str) -> List[str]:
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        return ["".join(_BYTE_CHARS[b] for b in piece.encode("utf-8"))
                for piece in gpt2_pieces(text)]

    def model(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._cache[word] = [self.vocab[s] for s in self._bpe(word)]
        return ids

    def _bpe(self, word: str) -> List[str]:
        if self.ignore_merges and word in self.vocab:
            return [word]
        # a character with no vocabulary entry is dropped before merging
        parts = [ch for ch in word if ch in self.vocab]
        while len(parts) > 1:
            ranked = [(self.ranks.get(pair, -1), k) for k, pair in
                      enumerate(zip(parts, parts[1:]))]
            rank = min((r for r, _ in ranked if r >= 0), default=-1)
            if rank < 0:
                break
            first, second = next((parts[k], parts[k + 1]) for r, k in ranked if r == rank)
            merged, k = [], 0
            while k < len(parts):
                if k + 1 < len(parts) and parts[k] == first and parts[k + 1] == second:
                    merged.append(first + second)
                    k += 2
                else:
                    merged.append(parts[k])
                    k += 1
            parts = merged
        return parts

    def template(self, a: List[int], b: Optional[List[int]]):
        ids = [self.cls_id] + a + [self.sep_id]
        if b is not None:
            ids += [self.sep_id] + b + [self.sep_id]
        return ids, [0] * len(ids)


_BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
_ROBERTA_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>", "<mask>")


def _added_tokens(tj: Optional[dict], tc: dict, vocab: Dict[str, int], specials,
                  default_flags) -> List[_AddedToken]:
    """``tokenizer.json``'s added tokens, else ``tokenizer_config.json``'s
    ``added_tokens_decoder``, else the tokenizer class's special tokens."""
    if tj is not None:
        rows = [(t["id"], t) for t in tj.get("added_tokens", [])]
    elif "added_tokens_decoder" in tc:
        rows = [(int(i), t) for i, t in tc["added_tokens_decoder"].items()]
    else:
        rows = [(vocab[s], dict(content=s, **default_flags(s))) for s in specials
                if s in vocab]
    return [_AddedToken(t["content"], i, t.get("lstrip", False), t.get("rstrip", False),
                        t.get("normalized", False), t.get("single_word", False))
            for i, t in rows]


def _load_bert(path: str, tc: dict, tj: Optional[dict]) -> BertTokenizer:
    if tj is not None:
        model = tj["model"]
        if model.get("type") != "WordPiece":
            raise ValueError(f"{path}/tokenizer.json: a {model.get('type')} model, not WordPiece")
        vocab = dict(model["vocab"])
        clean_text = (tj.get("normalizer") or {}).get("clean_text", True)
        prefix = model.get("continuing_subword_prefix", "##")
        max_chars = model.get("max_input_chars_per_word", 100)
    else:
        vocab = {}
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        clean_text, prefix, max_chars = True, "##", 100
    added = _added_tokens(tj, tc, vocab, _BERT_SPECIALS, lambda s: {})
    return BertTokenizer(
        vocab, added, lowercase=tc.get("do_lower_case", True),
        strip_accents=tc.get("strip_accents"),
        handle_chinese_chars=tc.get("tokenize_chinese_chars", True),
        clean_text=clean_text, unk_token=_token(tc.get("unk_token"), "[UNK]"),
        cls_token=_token(tc.get("cls_token"), "[CLS]"),
        sep_token=_token(tc.get("sep_token"), "[SEP]"),
        pad_token=_token(tc.get("pad_token"), "[PAD]"), prefix=prefix,
        max_input_chars=max_chars)


def _load_roberta(path: str, tc: dict, tj: Optional[dict]) -> RobertaTokenizer:
    if tj is not None:
        model = tj["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"{path}/tokenizer.json: a {model.get('type')} model, not BPE")
        vocab = dict(model["vocab"])
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        ignore_merges = model.get("ignore_merges", False)
    else:
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = [tuple(line.split()) for line in f
                      if line.strip() and not line.startswith("#version")]
        ignore_merges = False
    # RobertaTokenizer's defaults: <mask> eats the whitespace before it
    added = _added_tokens(tj, tc, vocab, _ROBERTA_SPECIALS, lambda s: (
        dict(lstrip=True) if s == "<mask>" else dict(normalized=True)))
    return RobertaTokenizer(
        vocab, merges, added, add_prefix_space=tc.get("add_prefix_space", False),
        bos_token=_token(tc.get("cls_token"), "<s>"),
        eos_token=_token(tc.get("sep_token"), "</s>"),
        pad_token=_token(tc.get("pad_token"), "<pad>"), ignore_merges=ignore_merges)


def from_pretrained_dir(path: str):
    """The tokenizer ``AutoTokenizer.from_pretrained(path)`` gives a BERT or
    RoBERTa checkpoint directory."""
    tc = _read_json(path, "tokenizer_config.json") or {}
    tj = _read_json(path, "tokenizer.json")
    kind = tc.get("tokenizer_class")
    if kind is not None:
        kind = {"BertTokenizer": "bert", "BertTokenizerFast": "bert",
                "RobertaTokenizer": "roberta", "RobertaTokenizerFast": "roberta"}.get(kind)
        if kind is None:
            raise ValueError(f"{path}: tokenizer_class {tc['tokenizer_class']!r} is neither "
                             "BERT's nor RoBERTa's")
    else:
        model_type = (_read_json(path, "config.json") or {}).get("model_type")
        if model_type in ("bert", "roberta"):
            kind = model_type
        elif model_type is not None:
            raise ValueError(f"{path}: no tokenizer for model_type {model_type!r}")
        elif os.path.isfile(os.path.join(path, "vocab.txt")):
            kind = "bert"
        elif all(os.path.isfile(os.path.join(path, f)) for f in ("vocab.json", "merges.txt")):
            kind = "roberta"
        else:
            raise FileNotFoundError(f"{path}: no tokenizer files (vocab.txt, or vocab.json "
                                    "and merges.txt)")
    return (_load_bert if kind == "bert" else _load_roberta)(path, tc, tj)
