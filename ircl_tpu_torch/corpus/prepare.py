"""Corpus preparation pipeline (L0): raw FEVER files -> framework artifacts.

Counterpart of ``ircl_tpu/corpus/prepare.py``, carried over line for line
apart from imports.

Covers the reference's preprocessing stage (``fetch_data.py``,
``extract_wiki.py``, ``build_db.py``, ``docs_sentence_extraction.py``) as one
offline-friendly module:

- ``extract_wiki``: stream ``wiki-*.jsonl`` shards into a consolidated
  {doc_id: {text, lines}} json, optionally restricted to evidence-cited docs
  ("small wiki", reference ``extract_wiki.py:74-99``). The reference
  parallelizes with Ray remote tasks per shard; here shard reads stream
  sequentially (IO-bound; no Ray dependency).
- ``build_flat_store``: jsonl dir -> FlatDocStore (the sqlite ``build_db``
  replacement).
- ``prepare_sentence_corpus``: the heuristic sentence extraction + pair
  corpus for contrastive pretraining (``docs_sentence_extraction.py``).
- ``prepare_synthetic``: the no-network path that materializes a synthetic
  wiki + claims in the same file layout.

There is deliberately no downloader: this environment has no egress; users
with the real FEVER dumps drop them into ``data/`` in the documented layout.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Dict, Optional

from ircl_tpu_torch.corpus import fever
from ircl_tpu_torch.corpus.store import FlatDocStore


def extract_wiki(
    shard_glob: str,
    out_path: str,
    restrict_to: Optional[set] = None,
) -> int:
    """Consolidate wiki jsonl shards into one json map. Doc ids are
    NFKD-normalized (reference ``extract_wiki.py:21``)."""
    out: Dict[str, dict] = {}
    for path in sorted(glob.glob(shard_glob)):
        for rec in fever.iter_wiki_jsonl(path):
            doc_id = fever.nfkd(rec["id"])
            if not doc_id:
                continue
            if restrict_to is not None and doc_id not in restrict_to:
                continue
            out[doc_id] = {"text": rec.get("text", ""), "lines": rec.get("lines", "")}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(out, f, ensure_ascii=False)
    return len(out)


def small_wiki_doc_ids(*claim_jsonls: str) -> set:
    """Union of evidence-cited doc ids across claim files."""
    ids = set()
    for path in claim_jsonls:
        ids |= fever.evidence_doc_ids(fever.parse_claims_jsonl(path))
    return ids


def build_flat_store(wiki_json: str, out_path: str) -> FlatDocStore:
    wiki = fever.load_wiki_json(wiki_json)
    return FlatDocStore.write(out_path, wiki)


def prepare_sentence_corpus(
    wiki_json: str, out_pickle: str
) -> tuple:
    """Heuristic sentence extraction -> (docs, docs_dict) pickles
    (reference ``docs_sentence_extraction.py:72-104``)."""
    wiki = fever.load_wiki_json(wiki_json)
    docs, docs_dict = fever.build_sentence_corpus(wiki)
    os.makedirs(os.path.dirname(os.path.abspath(out_pickle)), exist_ok=True)
    with open(out_pickle, "wb") as f:
        pickle.dump(docs, f)
    # splitext, not str.replace: a name without ".pkl" would make replace a
    # no-op and silently overwrite the docs pickle just written above
    stem, ext = os.path.splitext(out_pickle)
    with open(f"{stem}_dict{ext or '.pkl'}", "wb") as f:
        pickle.dump(docs_dict, f)
    return docs, docs_dict


def prepare_synthetic(
    data_dir: str,
    num_docs: int = 1000,
    num_claims: int = 200,
    seed: int = 0,
    refute_fraction: float = 0.3,
):
    """Materialize a synthetic wiki + dev claims in the FEVER file layout.
    A fraction of claims is REFUTES (marker + corrupted content words; the
    entity tokens stay, so retrieval recall is unaffected) to give the
    verdict classifier a real 2-class problem."""
    from ircl_tpu_torch.corpus.synthetic import generate

    wiki = generate(
        num_docs=num_docs, num_claims=num_claims, seed=seed,
        refute_fraction=refute_fraction,
    )
    os.makedirs(data_dir, exist_ok=True)
    wiki_path = os.path.join(data_dir, "small_wiki.json")
    with open(wiki_path, "w", encoding="utf-8") as f:
        json.dump(wiki.docs, f, ensure_ascii=False)
    dev_path = os.path.join(data_dir, "shared_task_dev.jsonl")
    with open(dev_path, "w", encoding="utf-8") as f:
        for c in wiki.claims:
            f.write(
                json.dumps(
                    {
                        "id": c.id,
                        "claim": c.claim,
                        "label": c.label,
                        "evidence": [
                            [[None, None, d, s] for s in sids]
                            for d, sids in c.evidences.items()
                        ],
                    }
                )
                + "\n"
            )
    return wiki_path, dev_path
