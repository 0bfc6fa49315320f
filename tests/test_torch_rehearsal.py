"""``ircl_tpu_torch/tools/rehearsal_scale.py`` against
``scripts/rehearsal_scale.py``.

``write_release`` is a top-level function of the script that imports no
JAX: on the same corpus both write the same zip members and JSONL files,
byte for byte. The port's whole chain then runs on the CPU at 300 docs
(``--device cpu``: ``fetch`` from the localhost fixture server with sha256
checks, ``prepare``, ``build-index``, ``retrieve``, each a fresh ``python -m
ircl_tpu_torch.cli`` process; ``--skip-train``, as the chain's ``retrieve``
runs without a dense checkpoint, and ``--skip-serve`` for the time: the
``serve --stdin`` smoke runs in ``chip_smoke.py`` phase 29), and its summary's
``doc_recall@k`` must equal what the reference's library computes on the
files the chain prepared.
"""

import json
import os
import zipfile

import pytest

from _torch_tools import load_script
from ircl_tpu.corpus import fever as j_fever
from ircl_tpu.corpus.store import MemoryDocStore as JStore
from ircl_tpu.corpus.synthetic import generate as j_generate
from ircl_tpu.index.build import build_count_index as j_build
from ircl_tpu.index.ranker import TfidfRanker as JRanker
from ircl_tpu.index.tfidf import tfidf_transform as j_tfidf
from ircl_tpu.pipeline.recall import doc_recall_at_k as j_doc_recall
from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.tools import rehearsal_scale as tool


def release_files(root):
    with zipfile.ZipFile(os.path.join(root, "wiki-pages.zip")) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    files = {n: open(os.path.join(root, n), "rb").read()
             for n in ("train.jsonl", "shared_task_dev.jsonl")}
    return members, files


@pytest.mark.parametrize("docs, claims, shards", [(300, 40, 3), (57, 9, 20)])
def test_write_release_matches_reference(tmp_path, docs, claims, shards):
    ref = load_script("rehearsal_scale")
    n_j = ref.write_release(j_generate(num_docs=docs, num_claims=claims, seed=29),
                            str(tmp_path / "j"), shards, train_frac=0.75)
    n_t = tool.write_release(generate(num_docs=docs, num_claims=claims, seed=29),
                             str(tmp_path / "t"), shards, train_frac=0.75)
    assert n_t == n_j == claims - int(claims * 0.75)
    got, want = release_files(tmp_path / "t"), release_files(tmp_path / "j")
    assert list(got[0]) == list(want[0]) == [
        f"wiki-pages/wiki-{s + 1:03d}.jsonl" for s in range(shards)]
    assert got == want


def test_chain_on_the_cpu_matches_reference_library(tmp_path, capsys):
    ws = str(tmp_path / "ws")
    summary = tool.main(["--docs", "300", "--claims", "40", "--shards", "2",
                         "--skip-train", "--skip-serve", "--device", "cpu",
                         "--workdir", ws])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary and summary["ok"] is True
    assert list(summary["stages"]) == ["fetch", "prepare", "build-index", "retrieve"]
    assert all(s["peak_rss_mb"] > 0 for s in summary["stages"].values())

    data = os.path.join(ws, "data")
    wiki = j_fever.load_wiki_json(os.path.join(data, "small_wiki.json"))
    claims = j_fever.parse_claims_jsonl(os.path.join(data, "shared_task_dev.jsonl"),
                                        drop_nei=True)
    assert len(claims) == 10 and 0 < len(wiki) <= 300  # prepare keeps the cited docs
    index = j_tfidf(j_build(JStore({d: r.get("text", "") for d, r in wiki.items()}),
                            ngram=2, hash_size=1 << 24))
    docs = [ids for ids, _ in JRanker(index).closest_docs_batch(
        [c.claim for c in claims], k=5)]
    assert summary["doc_recall@k"] == j_doc_recall(claims, docs, k=5)
