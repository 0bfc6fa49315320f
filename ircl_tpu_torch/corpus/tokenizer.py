"""Regex tokenizer and ngram generation.

Counterpart of ``ircl_tpu/corpus/tokenizer.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package. The patterns are the reference's, matched by
``re`` instead of the ``regex`` package: ``corpus/uniclass.py`` spells out
their ``\\p{...}`` classes as ``regex`` reads them.

``SimpleTokenizer`` reproduces the token stream of the reference's live
tokenizer (``preprocessing/drqa/tokenizers/simple_tokenizer.py:18-57``):
alternation of unicode alphanumeric runs with single non-whitespace chars.
``Tokens.ngrams`` reproduces the 1..n-gram enumeration with filtering
(``preprocessing/drqa/tokenizers/tokenizer.py:79-104``). Together with
``filters`` and ``hashing`` this fixes the exact feature space of the sparse
index — any deviation breaks recall parity.

The index pipeline only ever needs word streams, so ``Tokens`` is a thin
list-of-strings wrapper; the linguistic annotations (pos/lemma/ner) the
reference's optional backends produce ride as optional parallel lists.
``SpacyTokenizer`` / ``CoreNLPTokenizer`` mirror the reference's backed
tokenizers (``tokenizers/spacy_tokenizer.py``, ``corenlp_tokenizer.py``)
with injectable backends so the mapping logic is testable without the
third-party models this environment lacks.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

from ircl_tpu_torch.corpus.uniclass import translate


class Tokens:
    """Tokenized text: word list plus character spans, with optional
    pos/lemma/entity annotations (parallel lists, ``None`` when the
    producing tokenizer did not annotate)."""

    __slots__ = ("_words", "_spans", "_pos", "_lemmas", "_ents")

    def __init__(
        self,
        words: List[str],
        spans: Optional[List[tuple]] = None,
        pos: Optional[List[str]] = None,
        lemmas: Optional[List[str]] = None,
        entities: Optional[List[str]] = None,
    ):
        self._words = words
        self._spans = spans
        self._pos = pos
        self._lemmas = lemmas
        self._ents = entities

    def pos(self) -> Optional[List[str]]:
        return list(self._pos) if self._pos is not None else None

    def lemmas(self) -> Optional[List[str]]:
        return list(self._lemmas) if self._lemmas is not None else None

    def entities(self) -> Optional[List[str]]:
        return list(self._ents) if self._ents is not None else None

    def __len__(self) -> int:
        return len(self._words)

    def words(self, uncased: bool = False) -> List[str]:
        if uncased:
            return [w.lower() for w in self._words]
        return list(self._words)

    def offsets(self) -> Optional[List[tuple]]:
        return list(self._spans) if self._spans is not None else None

    def ngrams(
        self,
        n: int = 1,
        uncased: bool = False,
        filter_fn: Optional[Callable[[Sequence[str]], bool]] = None,
        as_strings: bool = True,
    ):
        """All ngrams of length 1..n, space-joined when ``as_strings``.

        Matches reference ``Tokens.ngrams`` exactly, including enumeration
        order (by start position, then length).
        """
        words = self.words(uncased)
        L = len(words)
        out = []
        for s in range(L):
            for e in range(s, min(s + n, L)):
                gram = words[s : e + 1]
                if filter_fn is not None and filter_fn(gram):
                    continue
                out.append((s, e + 1))
        if as_strings:
            return [' '.join(words[s:e]) for (s, e) in out]
        return out


class SimpleTokenizer:
    """Unicode alphanumeric / single-char tokenizer (reference-compatible)."""

    ALPHA_NUM = r'[\p{L}\p{N}\p{M}]+'
    NON_WS = r'[^\p{Z}\p{C}]'

    def __init__(self):
        self._regexp = re.compile(
            translate('(%s)|(%s)' % (self.ALPHA_NUM, self.NON_WS)),
            flags=re.IGNORECASE + re.UNICODE + re.MULTILINE,
        )

    def tokenize(self, text: str) -> Tokens:
        words = []
        spans = []
        for m in self._regexp.finditer(text):
            words.append(m.group())
            spans.append(m.span())
        return Tokens(words, spans)


class RegexpTokenizer:
    """PTB-convention tokenizer (reference ``regexp_tokenizer.py`` provides
    an equivalent; the live index pipeline never uses it — it exists for
    users who want PTB-style tokens instead of ``simple`` ones).

    Built independently from PTB conventions: contractions and possessives
    split off ("don't" -> "do", "n't"), abbreviations and decimal numbers
    stay whole, multi-char punctuation runs (``...``, ``--``) group.
    """

    PATTERN = r"""(?x)
        \p{N}+(?:[.,]\p{N}+)*            # numbers incl. decimals/thousands
      | (?:[A-Za-z]\.){2,}               # abbreviations like U.S.
      | [\p{L}\p{M}]+(?='(?:[sSdDmM]|ll|LL|re|RE|ve|VE)\b)  # stem before 's 'll...
      | [\p{L}\p{M}]+(?=[nN]'[tT]\b)     # stem before the n't clitic
      | [nN]'[tT]\b                      # negation clitic
      | '(?:[sSdDmM]|ll|LL|re|RE|ve|VE)\b  # the clitics themselves
      | [\p{L}\p{M}\p{N}]+(?:[-'][\p{L}\p{M}\p{N}]+)*  # words w/ hyphens & inner apostrophes
      | \.\.\.+ | --+                     # ellipses, dashes
      | [^\p{Z}\p{C}]                     # any other visible char
    """

    def __init__(self):
        self._regexp = re.compile(
            translate(self.PATTERN), flags=re.UNICODE + re.MULTILINE
        )

    def tokenize(self, text: str) -> Tokens:
        words, spans = [], []
        for m in self._regexp.finditer(text):
            words.append(m.group())
            spans.append(m.span())
        return Tokens(words, spans)


class SpacyTokenizer:
    """spaCy-backed tokenizer (reference ``tokenizers/spacy_tokenizer.py``).

    The reference version hardcodes ``spacy.load('en_core_web_sm')`` and is
    broken by its own import path (``spacy_tokenizer.py:14`` imports a
    ``baseline.drqa`` package that doesn't exist); this one actually honors
    the ``model`` argument, disables unused pipeline components for speed,
    and accepts an injected ``nlp`` callable so the doc->Tokens mapping is
    unit-testable without the model download.

    ``annotators`` may include ``pos``/``lemma``/``ner``; like the
    reference, newlines are flattened to spaces before tokenizing and the
    non-entity tag is the empty string.
    """

    def __init__(
        self,
        model: str = "en_core_web_sm",
        annotators: Sequence[str] = (),
        nlp: Optional[Callable] = None,
    ):
        self.annotators = set(annotators)
        bad = self.annotators - {"pos", "lemma", "ner"}
        if bad:
            raise ValueError(f"unknown annotators: {sorted(bad)}")
        if nlp is None:
            import spacy  # deferred: absent in offline environments

            disable = ["parser"]
            if "ner" not in self.annotators:
                disable.append("ner")
            if not self.annotators:
                disable += ["tagger", "attribute_ruler", "lemmatizer"]
            nlp = spacy.load(model, disable=disable)
        self.nlp = nlp

    def tokenize(self, text: str) -> Tokens:
        doc = self.nlp(text.replace("\n", " "))
        toks = [t for t in doc]
        words = [t.text for t in toks]
        spans = [(t.idx, t.idx + len(t.text)) for t in toks]
        want = self.annotators
        return Tokens(
            words,
            spans,
            pos=[t.tag_ for t in toks] if "pos" in want else None,
            lemmas=[t.lemma_ for t in toks] if "lemma" in want else None,
            entities=[t.ent_type_ or "" for t in toks]
            if "ner" in want
            else None,
        )


class CoreNLPTokenizer:
    """Stanford CoreNLP-backed tokenizer (reference
    ``tokenizers/corenlp_tokenizer.py``): keeps one pipeline subprocess
    alive and feeds it text per ``tokenize`` call.

    Differences from the reference: plain ``subprocess`` pipes instead of a
    pexpect pseudo-terminal (no terminal buffer limits to work around, no
    pexpect dependency), and the full command is injectable (``cmd=``) so
    the JSON protocol handling is testable with a scripted backend — the
    java jars don't exist in this environment.
    """

    def __init__(
        self,
        classpath: Optional[str] = None,
        annotators: Sequence[str] = (),
        mem: str = "2g",
        cmd: Optional[List[str]] = None,
    ):
        import os

        self.annotators = set(annotators)
        if cmd is None:
            classpath = classpath or os.getenv("CLASSPATH")
            if not classpath:
                raise ValueError(
                    "CoreNLPTokenizer needs a classpath (arg or $CLASSPATH)"
                )
            pipeline = ["tokenize", "ssplit"]
            if "ner" in self.annotators:
                pipeline += ["pos", "lemma", "ner"]
            elif "lemma" in self.annotators:
                pipeline += ["pos", "lemma"]
            elif "pos" in self.annotators:
                pipeline += ["pos"]
            cmd = [
                "java", f"-mx{mem}", "-cp", classpath,
                "edu.stanford.nlp.pipeline.StanfordCoreNLP",
                "-annotators", ",".join(pipeline),
                "-tokenize.options", "untokenizable=noneDelete,invertible=true",
                "-outputFormat", "json", "-prettyPrint", "false",
            ]
        import subprocess

        self._proc = subprocess.Popen(
            cmd,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            text=True,
            bufsize=1,
        )

    def _read_json(self) -> dict:
        """Read one JSON object from the pipeline's stdout, skipping the
        banner/prompt noise CoreNLP interleaves. Brace-balanced scan that
        is string-aware: braces inside JSON string values (tokenized text
        can itself contain ``{``/``}``) must not affect the depth count."""
        import json

        buf, depth, started = [], 0, False
        in_str = escaped = False
        while True:
            ch = self._proc.stdout.read(1)
            if ch == "":
                raise IOError("CoreNLP pipeline terminated")
            if not started:
                if ch == "{":
                    started = True
                else:
                    continue
            buf.append(ch)
            if in_str:
                if escaped:
                    escaped = False
                elif ch == "\\":
                    escaped = True
                elif ch == '"':
                    in_str = False
            elif ch == '"':
                in_str = True
            elif ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    return json.loads("".join(buf))

    def tokenize(self, text: str) -> Tokens:
        clean = text.replace("\n", " ")
        self._proc.stdin.write(clean + "\n")
        self._proc.stdin.flush()
        reply = self._read_json()
        toks = [t for s in reply.get("sentences", []) for t in s["tokens"]]
        words = [t["word"] for t in toks]
        spans = [
            (t["characterOffsetBegin"], t["characterOffsetEnd"]) for t in toks
        ]
        want = self.annotators
        return Tokens(
            words,
            spans,
            pos=[t.get("pos", "") for t in toks] if "pos" in want else None,
            lemmas=[t.get("lemma", "") for t in toks]
            if "lemma" in want
            else None,
            entities=[
                "" if t.get("ner", "O") == "O" else t["ner"] for t in toks
            ]
            if "ner" in want
            else None,
        )

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.stdin.close()
            self._proc.terminate()
            self._proc.wait(timeout=5)

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


_REGISTRY = {
    "simple": SimpleTokenizer,
    "regexp": RegexpTokenizer,
    "spacy": SpacyTokenizer,
    "corenlp": CoreNLPTokenizer,
}


def get_tokenizer(name: str, **kwargs):
    """Name -> tokenizer instance (reference registry surface,
    ``tokenizers/__init__.py:31-41``). 'spacy'/'corenlp' raise at
    construction when their backends (the spacy model / java jars) are
    absent — the index pipeline itself only ever uses 'simple'."""
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(f"invalid tokenizer: {name}") from None


_DEFAULT_TOKENIZER: Optional[SimpleTokenizer] = None


def default_tokenizer() -> SimpleTokenizer:
    """Shared tokenizer instance (the reference re-instantiates per call in
    ``src/evaluation.py:58``; we deliberately do not)."""
    global _DEFAULT_TOKENIZER
    if _DEFAULT_TOKENIZER is None:
        _DEFAULT_TOKENIZER = SimpleTokenizer()
    return _DEFAULT_TOKENIZER
