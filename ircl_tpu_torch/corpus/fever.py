"""FEVER corpus parsing: wiki ``lines`` format, claim jsonl, sentence pairs.

Counterpart of ``ircl_tpu/corpus/fever.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

Covers the reference's L0 data layer (``preprocessing/extract_wiki.py``,
``preprocessing/docs_sentence_extraction.py``, ``src/dataset.py:21-70``) with
one unified normalization policy:

- doc ids from evidence annotations are NFKD-normalized
  (reference ``src/dataset.py:55``),
- doc ids used as store keys are NFD-normalized
  (reference ``docs_sentence_extraction.py:67``, ``doc_db.py``),
- wiki ``lines`` are parsed with the tab-split parser (the reference's second,
  simpler parser at ``src/dataset.py:26-31``); the heuristic parser
  (``docs_sentence_extraction.py:19-56``) is also provided for the contrastive
  sentence-pair corpus, which depends on its <=2-sentence document filter.
"""

from __future__ import annotations

import json
import re
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

_ARTIFACTS = {"-LRB-", "-RRB-", "-LSB-", "-RSB-", "''", "``", "--"}


def nfkd(text: str) -> str:
    return unicodedata.normalize("NFKD", text)


def nfd(text: str) -> str:
    return unicodedata.normalize("NFD", text)


def parse_lines_tab(lines: str) -> List[str]:
    """Tab-split parser for the FEVER wiki ``lines`` field.

    Each line is ``<sent_id>\\t<sentence>[\\t<anchor>...]``; we join all
    tab-fields after the id with spaces (reference ``src/dataset.py:26-31``).
    The returned list is indexed by FEVER ``sent_id``.
    """
    out = []
    for line in lines.split("\n"):
        parts = line.split("\t")
        out.append(" ".join(parts[1:]))
    return out


def _strip_artifacts(text: str) -> str:
    """Remove wiki markup artifacts (-LRB- etc.), word-wise."""
    return re.sub(
        r"[^ ]+", lambda m: "" if m.group() in _ARTIFACTS else m.group(), text
    )


def extract_sentences(lines: str) -> Optional[List[str]]:
    """Heuristic sentence extractor for the contrastive pair corpus.

    Reproduces reference ``sentence_extraction``
    (``preprocessing/docs_sentence_extraction.py:19-56``): requires a trailing
    sentence-count digit, strips markup artifacts, slices each sentence between
    its ``"<i>\\t"`` marker and the first of ``".\\t"`` / ``".\\n"`` /
    ``"<i+1>\\t"``, and drops documents with <= 2 surviving sentences.
    Returns None for rejected documents.
    """
    tail = lines[-3:].strip()
    if not tail.isdigit():
        return None
    length = int(tail)
    if length <= 2:
        return None

    text = _strip_artifacts(lines)

    doc = []
    for i in range(length):
        s = text[text.find("%d\t" % i):]
        candidates = [e for e in (s.find(".\t"), s.find(".\n"), s.find("%d\t" % (i + 1))) if e > 0]
        if not candidates:
            # The reference's min() over an empty list raises; a malformed doc
            # is simply rejected here.
            return None
        end_pos = min(candidates)
        s = s[len(str(i)):end_pos].strip() + "."
        if len(s) == 1:
            continue
        doc.append(s)

    if len(doc) <= 2:
        return None
    return doc


@dataclass
class Claim:
    """One FEVER claim with flattened evidence annotations."""

    id: int
    claim: str
    label: str
    # doc_id (NFKD) -> list of gold sentence ids (flattened across
    # annotations, matching the reference's process_jsonl)
    evidences: Dict[str, List[int]] = field(default_factory=dict)
    # Per-annotation structure [(doc_id NFKD, sent_id), ...] per annotation —
    # needed for faithful "full"-mode recall (the flattening above cannot
    # distinguish alternative annotations from multi-doc ones). None when the
    # producer has no annotation structure (synthetic corpus): recall then
    # conservatively treats ALL flattened evidence as one annotation.
    evidence_sets: Optional[List[List[Tuple[str, int]]]] = None


LABEL_MAP = {"SUPPORTS": 1, "REFUTES": 0}


def parse_claims_jsonl(
    path: str, drop_nei: bool = False
) -> List[Claim]:
    """Parse a FEVER train/dev jsonl into Claim records.

    Evidence flattening matches reference ``process_jsonl``
    (``src/dataset.py:37-70``): doc ids NFKD-normalized, sentence ids appended
    per doc across all evidence sets. ``drop_nei`` removes NOT ENOUGH INFO
    claims (reference ``src/dataset.py:120-121``).
    """
    claims: List[Claim] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            dic = json.loads(line)
            label = dic.get("label", "")
            if drop_nei and label == "NOT ENOUGH INFO":
                continue
            evidences: Dict[str, List[int]] = {}
            evidence_sets: List[List[Tuple[str, int]]] = []
            for evidence_set in dic.get("evidence", []):
                ann: List[Tuple[str, int]] = []
                for ev in evidence_set:
                    if ev[2] is not None:
                        doc_id = nfkd(ev[2])
                        evidences.setdefault(doc_id, []).append(ev[3])
                        ann.append((doc_id, ev[3]))
                if ann:
                    evidence_sets.append(ann)
            claims.append(
                Claim(
                    id=dic["id"],
                    claim=dic["claim"],
                    label=label,
                    evidences=evidences,
                    evidence_sets=evidence_sets or None,
                )
            )
    return claims


def iter_wiki_jsonl(path: str) -> Iterator[dict]:
    """Stream records from a FEVER ``wiki-*.jsonl`` shard."""
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                yield json.loads(line)


def load_wiki_json(path: str) -> Dict[str, dict]:
    """Load a consolidated wiki json ({doc_id: {text, lines}})."""
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def build_sentence_corpus(
    wiki: Dict[str, dict],
) -> tuple[List[List[str]], Dict[str, List[str]]]:
    """Extract per-document sentence lists for the contrastive pair corpus.

    Returns (docs, docs_dict): docs is a list of sentence-lists; docs_dict maps
    NFD doc_id -> sentences (reference ``extract_docs_sentence``,
    ``docs_sentence_extraction.py:59-69``).
    """
    docs: List[List[str]] = []
    docs_dict: Dict[str, List[str]] = {}
    for doc_id, rec in wiki.items():
        doc = extract_sentences(rec["lines"])
        if doc:
            docs.append(doc)
            docs_dict[nfd(doc_id)] = doc
    return docs, docs_dict


def evidence_doc_ids(claims: Iterable[Claim]) -> set:
    """All doc ids cited as evidence (used to build the small wiki subset,
    reference ``extract_wiki.py:74-99``)."""
    out = set()
    for c in claims:
        out.update(c.evidences.keys())
    return out
