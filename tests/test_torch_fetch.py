"""The port's ``corpus/fetch.py`` and ``corpus/prepare.py`` against
``ircl_tpu.corpus``'s, through a localhost fixture server: nothing is
downloaded from outside.

Mirrors ``tests/test_fetch.py``: streaming download, sha256 verification,
the atomic rename, the idempotent skip, zip extraction, and the refusal of
archive members that escape the destination; then the preparation of the
fetched dump. Both packages fetch into directories of their own: files,
returned names and error strings must be equal. The copies differ from the
originals in their imports and docstring notes only.
"""

import ast
import hashlib
import http.server
import io
import json
import os
import tarfile
import threading
import zipfile

import pytest

from ircl_tpu.corpus import fetch as j_fetch
from ircl_tpu.corpus import prepare as j_prepare
from ircl_tpu_torch.corpus import fetch as t_fetch
from ircl_tpu_torch.corpus import prepare as t_prepare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = [("j", j_fetch, j_prepare), ("t", t_fetch, t_prepare)]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("srv")
    shard = "\n".join(
        json.dumps({"id": f"Doc_{i}", "text": f"t{i} words here",
                    "lines": f"0\tt{i} words here\n1\tmore of t{i}"})
        for i in range(3)
    )
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("wiki-pages/wiki-001.jsonl", shard)
    (root / "wiki-pages.zip").write_bytes(buf.getvalue())
    (root / "train.jsonl").write_text(json.dumps(
        {"id": 1, "claim": "c", "label": "SUPPORTS",
         "evidence": [[[None, None, "Doc_1", 0]]]}) + "\n")

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(root), **kw)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield root, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=60)


def test_download_verify_and_skip(server, tmp_path):
    root, base = server
    want = hashlib.sha256((root / "train.jsonl").read_bytes()).hexdigest()
    errors = []
    for name, fetch, _ in PACKAGES:
        d = str(tmp_path / name)
        p = fetch.download_file(f"{base}/train.jsonl", d, sha256=want)
        assert os.path.exists(p) and not os.path.exists(p + ".part")
        assert open(p, "rb").read() == (root / "train.jsonl").read_bytes()
        mtime = os.path.getmtime(p)
        assert fetch.download_file(f"{base}/train.jsonl", d, sha256=want) == p
        assert os.path.getmtime(p) == mtime  # skipped, checksum still verified
        with pytest.raises(IOError) as e:
            fetch.download_file(f"{base}/train.jsonl", d, sha256="0" * 64)
        errors.append(str(e.value).replace(d, "D"))
    assert errors[1] == errors[0] and "sha256" in errors[1]


def test_fetch_all_extracts_and_prepares(server, tmp_path):
    """Fetch the dump, then ``extract_wiki``, ``small_wiki_doc_ids`` and
    ``prepare_sentence_corpus`` on it: equal files in both packages."""
    _, base = server
    outs = []
    for name, fetch, prepare in PACKAGES:
        d = tmp_path / name
        got = fetch.fetch_all(str(d), resources={"wiki_pages": f"{base}/wiki-pages.zip",
                                                 "train": f"{base}/train.jsonl"})
        assert set(got) == {"wiki_pages", "train"}
        shard = d / "wiki-pages" / "wiki-001.jsonl"
        # the second run skips present files and re-extracts nothing
        fetch.fetch_all(str(d), resources={"train": f"{base}/train.jsonl"})
        ids = prepare.small_wiki_doc_ids(str(d / "train.jsonl"))
        n = prepare.extract_wiki(str(d / "wiki-pages" / "*.jsonl"),
                                 str(d / "small_wiki.json"), restrict_to=ids)
        docs, docs_dict = prepare.prepare_sentence_corpus(str(d / "small_wiki.json"),
                                                          str(d / "sents.pkl"))
        outs.append((shard.read_bytes(), sorted(ids), n,
                     (d / "small_wiki.json").read_bytes(), docs, docs_dict,
                     (d / "sents.pkl").read_bytes(), (d / "sents_dict.pkl").read_bytes()))
    assert outs[1] == outs[0]
    assert outs[1][1] == ["Doc_1"] and outs[1][2] == 1


def test_missing_resource_errors(server, tmp_path):
    _, base = server
    errors = []
    for name, fetch, _ in PACKAGES:
        with pytest.raises(Exception) as e:
            fetch.download_file(f"{base}/nope.jsonl", str(tmp_path / name))
        errors.append((type(e.value), getattr(e.value, "code", None)))
    assert errors[1] == errors[0]


@pytest.mark.parametrize("member", ["../escape.txt", "/abs.txt", "a/../../b.txt"])
def test_zip_traversal_rejected(tmp_path, member):
    evil = tmp_path / "evil.zip"
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr(member, "x")
    evil.write_bytes(buf.getvalue())
    errors = []
    for name, fetch, _ in PACKAGES:
        with pytest.raises(IOError, match="escapes") as e:
            fetch.extract_archive(str(evil), str(tmp_path / name / "out"))
        errors.append(str(e.value))
    assert errors[1] == errors[0]
    assert not (tmp_path / "escape.txt").exists()


def test_tar_extraction_safe(tmp_path):
    src = tmp_path / "a.txt"
    src.write_text("hello")
    tgz = tmp_path / "bundle.tar.gz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(src, arcname="bundle/a.txt")
    evil = tmp_path / "evil.tar"
    with tarfile.open(evil, "w") as tf:
        tf.add(src, arcname="../outside.txt")
    for name, fetch, _ in PACKAGES:
        out = tmp_path / name
        fetch.extract_archive(str(tgz), str(out))
        assert (out / "bundle" / "a.txt").read_text() == "hello"
        with pytest.raises(tarfile.TarError):
            fetch.extract_archive(str(evil), str(out / "x"))
    assert not (tmp_path / "outside.txt").exists()


def test_synthetic_preparation_matches(tmp_path):
    outs = []
    for name, _, prepare in PACKAGES:
        wiki, dev = prepare.prepare_synthetic(str(tmp_path / name), 30, 12, seed=3)
        outs.append((open(wiki, "rb").read(), open(dev, "rb").read()))
    assert outs[1] == outs[0]


def _code(path):
    """A module's source after its docstring, the package name unified."""
    src = open(path).read()
    body = ast.parse(src).body
    start = body[1].lineno if ast.get_docstring(ast.Module(body, [])) else 1
    return [ln.replace("ircl_tpu_torch.", "ircl_tpu.")
            for ln in src.splitlines()[start - 1:]]


@pytest.mark.parametrize("module", ["corpus/fetch", "corpus/prepare", "config",
                                    "pipeline/recall"])
def test_copies_differ_in_imports_and_notes_only(module):
    """Below the module docstring (which names the original), the copy is
    the original line for line, its imports renamed."""
    assert _code(os.path.join(ROOT, "ircl_tpu_torch", module + ".py")) == _code(
        os.path.join(ROOT, "ircl_tpu", module + ".py")), module
