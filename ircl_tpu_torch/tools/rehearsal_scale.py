"""Reference-format scale rehearsal of the port: the whole CLI chain at 100K
docs.

    python3 -m ircl_tpu_torch.tools.rehearsal_scale [--docs 100000
        --claims 2000 --shards 20 --train-steps 200 --recall-floor 0.85
        --skip-train --skip-serve --workdir DIR --device cpu]

The port of ``scripts/rehearsal_scale.py``, with its arguments, defaults,
seeds and order of work. It generates a synthetic corpus, writes it in the
FEVER release's layout (``wiki-pages.zip`` holding
``wiki-pages/wiki-XXX.jsonl`` members of id/text/lines records, and
FEVER-schema ``train.jsonl`` / ``shared_task_dev.jsonl``), serves it from a
fixture server on localhost, and drives

    fetch -> prepare -> build-index -> train -> retrieve -> serve

as ``python -m ircl_tpu_torch.cli --device DEVICE`` processes, timing every
stage and recording its peak host RSS. It checks the doc recall@k of
``retrieve`` against ``--recall-floor`` and smoke-tests ``serve --stdin`` on
the built index. Runs on the card unless ``--device`` names another device.
Prints one JSON summary line on stdout; progress goes to stderr. Needs no
network: the server listens on 127.0.0.1.
"""

from __future__ import annotations

import argparse
import hashlib
import http.server
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zipfile

from ircl_tpu_torch.corpus.synthetic import generate
from ircl_tpu_torch.utils.device import resolve_device

# the directory that holds the ircl_tpu_torch package: each stage runs there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# Child wrapper: run the CLI as a grandchild and report ITS peak RSS (KB on
# Linux) on stderr, so every stage gets an independent high-water mark.
_WRAP = (
    "import resource,subprocess,sys; rc=subprocess.call(sys.argv[1:]); "
    "ru=resource.getrusage(resource.RUSAGE_CHILDREN); "
    "sys.stderr.write('@RSS_KB %d\\n' % ru.ru_maxrss); sys.exit(rc)"
)


def run_stage(name: str, cli_args, timeout_s: float, device, stdin_text=None):
    """One CLI command on ``device`` in a fresh process: its seconds and
    peak RSS, and its stdout. Exits unless the command exits 0."""
    cmd = [sys.executable, "-c", _WRAP, sys.executable, "-m", "ircl_tpu_torch.cli",
           "--device", str(device)]
    cmd += cli_args
    t0 = time.monotonic()
    proc = subprocess.run(
        cmd,
        input=stdin_text,
        capture_output=True,
        text=True,
        timeout=timeout_s,
        cwd=ROOT,
    )
    dt = time.monotonic() - t0
    rss_mb = None
    for line in proc.stderr.splitlines():
        if line.startswith("@RSS_KB "):
            rss_mb = round(int(line.split()[1]) / 1024, 1)
    if proc.returncode != 0:
        log(proc.stdout[-2000:])
        log(proc.stderr[-4000:])
        raise SystemExit(f"stage {name} failed (rc={proc.returncode})")
    log(f"stage {name}: {dt:.1f}s, peak RSS {rss_mb} MB")
    return {"seconds": round(dt, 1), "peak_rss_mb": rss_mb}, proc.stdout


def write_release(wiki, root: str, shards: int, train_frac: float):
    """Serialize the synthetic corpus in the reference dump layout."""
    os.makedirs(root, exist_ok=True)
    doc_ids = list(wiki.docs.keys())
    per = -(-len(doc_ids) // shards)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for s in range(shards):
            lines = []
            for d in doc_ids[s * per : (s + 1) * per]:
                rec = wiki.docs[d]
                lines.append(
                    json.dumps(
                        {"id": d, "text": rec["text"], "lines": rec["lines"]},
                        ensure_ascii=False,
                    )
                )
            zf.writestr(
                f"wiki-pages/wiki-{s + 1:03d}.jsonl", "\n".join(lines) + "\n"
            )
    with open(os.path.join(root, "wiki-pages.zip"), "wb") as f:
        f.write(buf.getvalue())

    n_train = int(len(wiki.claims) * train_frac)
    for name, claims in (
        ("train.jsonl", wiki.claims[:n_train]),
        ("shared_task_dev.jsonl", wiki.claims[n_train:]),
    ):
        with open(os.path.join(root, name), "w") as f:
            for c in claims:
                evidence = [
                    [[10_000 + c.id, 20_000 + c.id, d, si] for si in sids]
                    for d, sids in c.evidences.items()
                ]
                f.write(
                    json.dumps(
                        {
                            "id": c.id,
                            "claim": c.claim,
                            "label": c.label,
                            "evidence": evidence,
                        },
                        ensure_ascii=False,
                    )
                    + "\n"
                )
    return len(wiki.claims) - n_train


def serve_release(release: str):
    """A threaded HTTP server of ``release`` on 127.0.0.1 and its base URL."""

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=release, **kw)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def sha(p):
    h = hashlib.sha256()
    with open(p, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def write_resources(path: str, release: str, base: str):
    """``fetch --resources``'s URL table with the files' sha256 values."""
    with open(path, "w") as f:
        json.dump(
            {
                "resources": {
                    "wiki_pages": f"{base}/wiki-pages.zip",
                    "train": f"{base}/train.jsonl",
                    "dev": f"{base}/shared_task_dev.jsonl",
                },
                "checksums": {
                    "wiki_pages": sha(os.path.join(release, "wiki-pages.zip")),
                    "train": sha(os.path.join(release, "train.jsonl")),
                    "dev": sha(os.path.join(release, "shared_task_dev.jsonl")),
                },
            },
            f,
        )


def write_config(path: str, ws: str, data: str):
    """The chain's configuration: the script's keys and values. JSON, which
    the port's loader reads without PyYAML."""
    with open(path, "w") as f:
        json.dump(
            {
                "data": {
                    "data_dir": data,
                    "wiki_json": f"{data}/small_wiki.json",
                    "train_jsonl": f"{data}/train.jsonl",
                    "dev_jsonl": f"{data}/shared_task_dev.jsonl",
                    "synthetic": False,
                },
                "ckptdir": f"{ws}/ckpt",
                "logdir": f"{ws}/logs",
                "index": {"hash_size": 16777216},
                "retrieval": {"k_docs": 5, "k_sents": 5, "batch_size": 256},
            },
            f,
        )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--claims", type=int, default=2_000)
    ap.add_argument("--shards", type=int, default=20)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--recall-floor", type=float, default=0.85)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-serve", action="store_true")
    ap.add_argument(
        "--workdir", type=str, default=None,
        help="keep artifacts here instead of a deleted tempdir",
    )
    ap.add_argument("--device", default=None,
                    help="torch device of every stage (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    ws = args.workdir or tempfile.mkdtemp(prefix="ircl_rehearsal_")
    os.makedirs(ws, exist_ok=True)
    release = os.path.join(ws, "release")
    data = os.path.join(ws, "data")
    summary = {"docs": args.docs, "claims": args.claims, "stages": {}}

    t0 = time.monotonic()
    wiki = generate(num_docs=args.docs, num_claims=args.claims, seed=29)
    n_dev = write_release(wiki, release, args.shards, train_frac=0.75)
    zip_mb = os.path.getsize(os.path.join(release, "wiki-pages.zip")) / 2**20
    summary["generate_and_serialize_s"] = round(time.monotonic() - t0, 1)
    summary["archive_mb"] = round(zip_mb, 1)
    log(
        f"release written in {summary['generate_and_serialize_s']}s: "
        f"{zip_mb:.1f} MB archive, {n_dev} dev claims"
    )
    del wiki  # the chain must reload everything from the dump files

    httpd, base = serve_release(release)
    try:
        resources = os.path.join(ws, "resources.json")
        write_resources(resources, release, base)
        cfg = os.path.join(ws, "cfg.json")
        write_config(cfg, ws, data)

        C = ["--config", cfg]
        st = summary["stages"]
        st["fetch"], _ = run_stage(
            "fetch", C + ["fetch", "--resources", resources], 1200, device
        )
        st["prepare"], _ = run_stage("prepare", C + ["prepare"], 3600, device)
        st["build-index"], _ = run_stage("build-index", C + ["build-index"], 3600, device)
        if not args.skip_train:
            st["train"], _ = run_stage(
                "train",
                C + ["train", "--steps", str(args.train_steps), "--log-step",
                     str(args.train_steps)],
                3600, device,
            )
        out_jsonl = os.path.join(ws, "retrieved.jsonl")
        st["retrieve"], out = run_stage(
            "retrieve", C + ["retrieve", "--out", out_jsonl], 3600, device
        )
        report = json.loads(out.strip().splitlines()[-1])
        summary["doc_recall@k"] = report["doc_recall@k"]
        summary["sentence_recall@k"] = report.get("sentence_recall@k")
        log(f"retrieve report: {report}")

        if not args.skip_serve:
            req = json.dumps({"queries": ["rehearsal smoke query"], "k": 3}) + "\n"
            st["serve"], sout = run_stage(
                "serve",
                C + ["serve", "--stdin", "--batch-size", "256"],
                3600, device,
                stdin_text=req,
            )
            reply = json.loads(sout.strip().splitlines()[-1])
            if "results" not in reply:
                raise SystemExit(f"serve smoke failed: {reply}")
    finally:
        httpd.shutdown()
        httpd.server_close()

    summary["peak_rss_mb"] = max(s["peak_rss_mb"] or 0 for s in st.values())
    ok = summary["doc_recall@k"] >= args.recall_floor
    summary["ok"] = bool(ok)
    print(json.dumps(summary), flush=True)
    if args.workdir is None:
        shutil.rmtree(ws, ignore_errors=True)
    if not ok:
        raise SystemExit(
            f"doc recall {summary['doc_recall@k']} < floor {args.recall_floor}"
        )
    return summary


if __name__ == "__main__":
    main()
