"""Flat document stores.

Counterpart of ``ircl_tpu/corpus/store.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

Replaces the reference's sqlite DocDB (``preprocessing/drqa/retriever/
doc_db.py``) with columnar stores: document text lives in plain Python lists /
json on disk. sqlite buys nothing on the TPU path — the index builder streams
every document exactly once, and query time never touches raw text except via
doc_id -> sentences lookup.

Both stores expose the same protocol the reference's DB classes do
(``get_doc_ids`` / ``get_doc_text`` / ``get_doc_lines``), so the index builder
is store-agnostic (the reference's ``Simple`` in-memory fake,
``retriever/simple.py``, is subsumed by ``MemoryDocStore``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Union

from ircl_tpu_torch.corpus.fever import nfd


class MemoryDocStore:
    """In-memory store over a list of texts or a {doc_id: text} mapping."""

    def __init__(
        self,
        docs: Union[Sequence[str], Dict[str, str]],
        lines: Optional[Dict[str, str]] = None,
    ):
        if isinstance(docs, dict):
            self._ids = list(docs.keys())
            self._texts = dict(docs)
        else:
            self._ids = list(range(len(docs)))
            self._texts = {i: t for i, t in enumerate(docs)}
        self._lines = lines or {}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        pass

    def close(self):
        pass

    def get_doc_ids(self) -> List:
        return list(self._ids)

    def get_doc_text(self, doc_id) -> Optional[str]:
        return self._texts.get(doc_id)

    def get_doc_lines(self, doc_id) -> Optional[str]:
        return self._lines.get(doc_id)

    def __len__(self) -> int:
        return len(self._ids)


class FlatDocStore:
    """Disk-backed store: one json file {doc_id: {"text":..., "lines":...}}.

    Doc ids are NFD-normalized on both write and lookup, matching the
    reference DB convention (``doc_db.py:56-66``).
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "r", encoding="utf-8") as f:
            self._docs: Dict[str, dict] = json.load(f)

    @classmethod
    def write(cls, path: str, docs: Dict[str, dict]) -> "FlatDocStore":
        normalized = {nfd(k): v for k, v in docs.items()}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(normalized, f, ensure_ascii=False)
        return cls(path)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        pass

    def close(self):
        pass

    def get_doc_ids(self) -> List[str]:
        return list(self._docs.keys())

    def get_doc_text(self, doc_id: str) -> Optional[str]:
        rec = self._docs.get(nfd(doc_id))
        return rec.get("text") if rec else None

    def get_doc_lines(self, doc_id: str) -> Optional[str]:
        rec = self._docs.get(nfd(doc_id))
        return rec.get("lines") if rec else None

    def __len__(self) -> int:
        return len(self._docs)
