"""Dataset fetcher: FEVER release artifacts -> local data dir.

Counterpart of ``ircl_tpu/corpus/fetch.py``, carried over line for line
apart from imports.

Covers the reference's ``preprocessing/fetch_data.py`` (download the
fever.ai artifacts listed at ``fetch_data.py:35-40``, then unzip/untar,
``fetch_data.py:52-70``). Differences are deliberate:

- stdlib ``urllib`` streaming instead of requests+tqdm (no extra deps, and
  progress goes to stderr at a fixed byte interval instead of a live bar);
- downloads land in ``<name>.part`` and are atomically renamed, so an
  interrupted fetch never leaves a truncated file that a re-run would skip
  (the reference trusts whatever exists on disk);
- a short content-length check plus optional sha256 verification (the
  reference only warns on size mismatch and keeps the bad file);
- zip/tar extraction refuses path traversal (``..`` or absolute members) —
  the reference extracts unconditionally;
- the Elasticsearch tarball the reference fetches is dropped: this framework
  replaces the ES sentence store with its own index/engines, nothing
  consumes it.

This environment has no egress, so the real URL table is only exercised
against a localhost fixture server (``tests/test_fetch.py``); on machines
with network the same entry point fetches the real dump into the layout
``corpus/prepare.py`` documents.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tarfile
import urllib.request
import zipfile
from typing import Dict, Optional

# Public fever.ai artifact URLs (reference fetch_data.py:35-40).
FEVER_RESOURCES: Dict[str, str] = {
    "wiki_pages": "https://s3-eu-west-1.amazonaws.com/fever.public/wiki-pages.zip",
    "train": "https://s3-eu-west-1.amazonaws.com/fever.public/train.jsonl",
    "dev": "https://s3-eu-west-1.amazonaws.com/fever.public/shared_task_dev.jsonl",
}

_CHUNK = 1 << 16
_PROGRESS_EVERY = 64 << 20  # one stderr line per 64 MiB


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def download_file(
    url: str,
    dest_dir: str,
    sha256: Optional[str] = None,
    force: bool = False,
) -> str:
    """Stream ``url`` into ``dest_dir/<basename>``; returns the local path.

    Skips the download when the file already exists (unless ``force``), but
    always re-verifies ``sha256`` when one is given. Writes to ``.part`` and
    renames only after the size/checksum checks pass.
    """
    name = os.path.basename(url.split("?", 1)[0]) or "download"
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, name)
    if os.path.exists(dest) and not force:
        _verify(dest, sha256)
        _log(f"[fetch] skip {name}: already present")
        return dest

    part = dest + ".part"
    digest = hashlib.sha256()
    got = 0
    with urllib.request.urlopen(url) as resp:
        expect = int(resp.headers.get("Content-Length") or 0)
        _log(f"[fetch] {name} ({expect or '?'} bytes)")
        with open(part, "wb") as f:
            while True:
                chunk = resp.read(_CHUNK)
                if not chunk:
                    break
                f.write(chunk)
                digest.update(chunk)
                prev, got = got, got + len(chunk)
                if got // _PROGRESS_EVERY != prev // _PROGRESS_EVERY:
                    _log(f"[fetch] {name}: {got >> 20} MiB")
    if expect and got != expect:
        os.remove(part)
        raise IOError(
            f"{name}: truncated download ({got} of {expect} bytes)"
        )
    if sha256 is not None and digest.hexdigest() != sha256:
        os.remove(part)
        raise IOError(f"{name}: sha256 mismatch ({digest.hexdigest()})")
    os.replace(part, dest)
    return dest


def _verify(path: str, sha256: Optional[str]) -> None:
    if sha256 is None:
        return
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            digest.update(chunk)
    if digest.hexdigest() != sha256:
        raise IOError(f"{path}: sha256 mismatch ({digest.hexdigest()})")


def _safe_members(names, dest_dir: str):
    for n in names:
        if n.startswith(("/", "\\")) or ".." in n.split("/"):
            raise IOError(f"archive member escapes dest dir: {n!r}")
    return names


def extract_archive(path: str, dest_dir: Optional[str] = None) -> str:
    """Unpack a ``.zip`` / ``.tar[.gz]`` next to itself (or into
    ``dest_dir``); returns the extraction dir. Non-archives are a no-op
    (the reference's jsonl artifacts arrive unpacked)."""
    dest = dest_dir or os.path.dirname(os.path.abspath(path))
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            _safe_members(zf.namelist(), dest)
            zf.extractall(dest)
        _log(f"[fetch] extracted {os.path.basename(path)}")
    elif tarfile.is_tarfile(path):
        with tarfile.open(path) as tf:
            # the 'data' filter rejects absolute paths, traversal, and
            # special files (Python 3.12 stdlib)
            tf.extractall(dest, filter="data")
        _log(f"[fetch] extracted {os.path.basename(path)}")
    return dest


def fetch_all(
    data_dir: str,
    resources: Optional[Dict[str, str]] = None,
    checksums: Optional[Dict[str, str]] = None,
    force: bool = False,
) -> Dict[str, str]:
    """Fetch every resource (default: the FEVER table) and unpack archives.

    Returns {resource name: local path}. Idempotent: present files are
    skipped, archives re-extract only when (re-)downloaded.
    """
    resources = FEVER_RESOURCES if resources is None else resources
    out: Dict[str, str] = {}
    for name, url in resources.items():
        was_there = os.path.exists(
            os.path.join(data_dir, os.path.basename(url.split("?", 1)[0]))
        )
        local = download_file(
            url, data_dir, sha256=(checksums or {}).get(name), force=force
        )
        if not was_there or force:
            extract_archive(local)
        out[name] = local
    return out
