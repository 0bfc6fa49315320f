"""Command-line interface of the port.

Counterpart of ``ircl_tpu/cli.py``, with the same subcommands, flags and
outputs:

    python -m ircl_tpu_torch.cli prepare        # corpus artifacts (synthetic/FEVER)
    python -m ircl_tpu_torch.cli build-index    # hashed-ngram count/tf-idf index
    python -m ircl_tpu_torch.cli train          # contrastive pretraining
    python -m ircl_tpu_torch.cli retrieve       # two-stage retrieval + recall@k
    python -m ircl_tpu_torch.cli train-verdict  # verdict classifier (extrinsic)
    python -m ircl_tpu_torch.cli eval-verdict   # its classification report
    python -m ircl_tpu_torch.cli serve          # HTTP/stdin retrieval endpoint

plus one top-level ``--device`` (by default the card, ``utils/device.py``;
``--device cpu`` runs the plain PyTorch versions on the host). Every command
builds its stage on that device and says which on standard error.

``train --dp`` trains data-parallel over every rank: under ``torchrun``
(or in a rank of ``parallel/launch.py``) it joins that group, on the CPU
too (``torchrun --nproc-per-node 8 -m ircl_tpu_torch.cli --device cpu ...
train --dp``); otherwise it starts one rank per visible CUDA device, and
with one device it trains on that one.

``train-verdict --dp/--tp/--ep/--pp`` trains the verdict model over a mesh
of ``dp * tp * ep * pp`` ranks in the reference's layouts (``--ep`` needs
``--moe-experts``; ``--pp`` composes with ``--dp`` only, runs the GPipe
schedule in ``--pp-micro`` microbatches and needs ``--layers`` to divide
into its stages): in a group of that many ranks it joins it; otherwise it
starts that many ranks, one a CUDA device, and refuses a count past the
devices with the reference's message. Only rank 0 prints the history line
and writes the checkpoint.

``bench`` runs the judged sparse benchmark (``tools/bench.py``) at its
defaults on ``--device``; the reference's ``bench`` hands the subcommand
on to ``bench.py``'s parser, which refuses it.

Where the JAX package writes orbax checkpoints, the port writes its own
(``utils/checkpoint.py``, ``verdict/infer.py``) under the same names.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _seed_everything(seed: int) -> None:
    # Determinism knobs (reference main.py:92-97): the host's random and
    # numpy draws and torch's default generator.
    import random

    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _load(args):
    from ircl_tpu_torch.config import load_config

    overrides = {}
    for kv in args.set or []:
        key, _, value = kv.partition("=")
        overrides[key] = value
    return load_config(args.config, overrides)


def cmd_fetch(args):
    """Download the FEVER release artifacts (reference fetch_data.py)."""
    cfg = _load(args)
    from ircl_tpu_torch.corpus.fetch import fetch_all

    resources = checksums = None
    if args.resources:
        # alternate URL table (mirror / fixture server): either a flat
        # {name: url} map or {"resources": {...}, "checksums": {...}}
        with open(args.resources) as f:
            tbl = json.load(f)
        if "resources" in tbl:
            resources, checksums = tbl["resources"], tbl.get("checksums")
        else:
            resources = tbl
    paths = fetch_all(
        cfg.data.data_dir,
        resources=resources,
        checksums=checksums,
        force=args.force,
    )
    for name, path in paths.items():
        print(f"{name} -> {path}")


def cmd_prepare(args):
    cfg = _load(args)
    from ircl_tpu_torch.corpus import prepare

    if cfg.data.synthetic:
        wiki_path, dev_path = prepare.prepare_synthetic(
            cfg.data.data_dir,
            cfg.data.synthetic_docs,
            cfg.data.synthetic_claims,
            cfg.data.seed,
        )
        print(f"synthetic wiki -> {wiki_path}\nclaims -> {dev_path}")
    else:
        ids = prepare.small_wiki_doc_ids(cfg.data.train_jsonl, cfg.data.dev_jsonl)
        n = prepare.extract_wiki(
            os.path.join(cfg.data.data_dir, "wiki-pages", "*.jsonl"),
            cfg.data.wiki_json,
            restrict_to=ids,
        )
        print(f"extracted {n} evidence docs -> {cfg.data.wiki_json}")
    prepare.prepare_sentence_corpus(
        cfg.data.wiki_json,
        os.path.join(cfg.data.data_dir, "docs_sentence.pkl"),
    )


def _tfidf_path(cfg) -> str:
    return os.path.join(
        cfg.data.data_dir,
        "index",
        f"tfidf-ngram={cfg.index.ngram}-hash={cfg.index.hash_size}.npz",
    )


def cmd_build_index(args):
    cfg = _load(args)
    from ircl_tpu_torch.corpus import fever
    from ircl_tpu_torch.corpus.store import MemoryDocStore
    from ircl_tpu_torch.index.build import build_count_index
    from ircl_tpu_torch.index.tfidf import tfidf_transform

    wiki = fever.load_wiki_json(cfg.data.wiki_json)
    store = MemoryDocStore({d: r.get("text", "") for d, r in wiki.items()})
    index = build_count_index(
        store, ngram=cfg.index.ngram, hash_size=cfg.index.hash_size
    )
    out = os.path.join(cfg.data.data_dir, "index", "count_matrix.npz")
    index.save(out)
    tfidf = tfidf_transform(index)
    out_t = _tfidf_path(cfg)
    tfidf.save(out_t)
    print(f"count index -> {out}\ntf-idf index -> {out_t} ({index.nnz} postings)")


def _featurizer(cfg, device, corpus_texts=None):
    """Config-selected featurizer (``featurizer.kind``: hash | transformer |
    hf) on ``device``. The transformer kind trains its WordPiece vocab from
    the wiki corpus, deterministically, so train and retrieve rebuild the
    same vocab."""
    from ircl_tpu_torch.models.featurizer import make_featurizer

    if cfg.featurizer.kind != "hash" and corpus_texts is None:
        from ircl_tpu_torch.corpus import fever

        wiki = fever.load_wiki_json(cfg.data.wiki_json)
        corpus_texts = [r.get("text", "") for r in wiki.values()]
    return make_featurizer(cfg.featurizer, corpus_texts, device=device)


def _restore_train_state(path, cfg, device):
    """A contrastive checkpoint of ``cli train``, restored into the
    structure that ``cfg.train`` gives, on ``device``."""
    from ircl_tpu_torch.contrastive.state import init_train_state
    from ircl_tpu_torch.utils.checkpoint import restore_state

    return restore_state(path, init_train_state(0, cfg.train, device=device))


def cmd_train(args):
    cfg = _load(args)
    _seed_everything(args.seed)
    train_cfg = cfg.train
    if args.loss:
        train_cfg = dataclasses.replace(train_cfg, loss=args.loss)
    if args.opt:
        train_cfg = dataclasses.replace(train_cfg, optimizer=args.opt)
    mesh = None
    if args.dp:
        import torch
        import torch.distributed as dist

        from ircl_tpu_torch.parallel.mesh import in_process_group, join_env_group, make_mesh

        in_group = in_process_group()
        if in_group:  # a rank of launch() or of torchrun
            join_env_group(args.device.type)
            n = dist.get_world_size()
        else:
            n = torch.cuda.device_count() if args.device.type == "cuda" else 1
        if n > 1 and not in_group:
            from ircl_tpu_torch.parallel.launch import launch

            return launch(cmd_train, n, args, device=args.device)
        if n > 1:
            mesh = make_mesh(("data",), device=args.device)
            if mesh.get_rank() == 0:
                print(f"data-parallel training over {n} devices")
        else:
            print("--dp requested but only 1 device visible; single-device")
    rank0 = mesh is None or mesh.get_rank() == 0

    from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
    from ircl_tpu_torch.corpus import fever
    from ircl_tpu_torch.data.pairs import DocPairSampler
    from ircl_tpu_torch.data.similarity import sentence_pair_similarity

    wiki = fever.load_wiki_json(cfg.data.wiki_json)
    docs = [fever.parse_lines_tab(r["lines"]) for r in wiki.values()]
    docs = [[s for s in d if s] for d in docs]
    sim = (
        sentence_pair_similarity(docs)
        if args.sample == "tf_idf"
        else None
    )
    sampler = DocPairSampler(
        docs, sample=args.sample, similarity=sim, seed=args.seed
    )
    trainer = ContrastiveTrainer(
        train_cfg,
        _featurizer(cfg, args.device),
        sampler,
        ckptdir=cfg.ckptdir,
        logdir=cfg.logdir,
        tag=f"{args.sample}_{train_cfg.loss}_LSTM",
        seed=args.seed,
        mesh=mesh,
        device=args.device,
    )
    if args.resume:
        step = trainer.maybe_resume()
        if rank0:
            print(f"resumed at step {step}")
    state = trainer.train(total_steps=args.steps, log_step=args.log_step)
    if rank0:
        print(f"finished at step {int(state.step)}")


def cmd_retrieve(args):
    cfg = _load(args)
    from ircl_tpu_torch.corpus import fever
    from ircl_tpu_torch.corpus.store import MemoryDocStore
    from ircl_tpu_torch.index.build import build_count_index
    from ircl_tpu_torch.index.ranker import TfidfRanker
    from ircl_tpu_torch.index.tfidf import tfidf_transform
    from ircl_tpu_torch.pipeline.recall import doc_recall_at_k, sentence_recall_at_k
    from ircl_tpu_torch.pipeline.retrieve import retrieve, sparse_sentence_scorer

    device = args.device
    wiki = fever.load_wiki_json(cfg.data.wiki_json)
    store = MemoryDocStore({d: r.get("text", "") for d, r in wiki.items()})
    index = tfidf_transform(
        build_count_index(store, ngram=cfg.index.ngram, hash_size=cfg.index.hash_size)
    )
    ranker = TfidfRanker(
        index, device, mode=cfg.index.mode, binary_tf=cfg.index.binary_tf
    )

    claims = fever.parse_claims_jsonl(cfg.data.dev_jsonl, drop_nei=True)
    doc_sents = {d: fever.parse_lines_tab(r["lines"]) for d, r in wiki.items()}

    if args.dense_ckpt:
        from ircl_tpu_torch.pipeline.dense_scorer import ContrastiveSentenceScorer

        state = _restore_train_state(args.dense_ckpt, cfg, device)
        scorer = ContrastiveSentenceScorer(
            cfg.train, _featurizer(cfg, device), state
        )
    else:

        def factory(sents):
            s = MemoryDocStore(list(sents))
            return TfidfRanker(
                tfidf_transform(build_count_index(s, ngram=2, hash_size=1 << 18)),
                device,
            )

        scorer = sparse_sentence_scorer(factory)

    result = retrieve(
        [c.claim for c in claims],
        ranker,
        doc_sents,
        scorer,
        k_docs=cfg.retrieval.k_docs,
        k_sents=cfg.retrieval.k_sents,
        batch_size=cfg.retrieval.batch_size,
    )
    dr = doc_recall_at_k(claims, result.doc_ids, k=cfg.retrieval.k_docs)
    sr = sentence_recall_at_k(claims, result.sentences, k=cfg.retrieval.k_sents)
    print(json.dumps({"doc_recall@k": dr, "sentence_recall@k": sr}))
    if args.out:
        with open(args.out, "w") as f:
            for c, docs, sents in zip(claims, result.doc_ids, result.sentences):
                f.write(
                    json.dumps(
                        {"id": c.id, "docs": docs, "sentences": sents}
                    )
                    + "\n"
                )


def cmd_train_verdict(args):
    cfg = _load(args)
    dp, tp, ep, pp = args.dp, args.tp, args.moe_ep, args.pp
    if pp > 1 and (tp > 1 or ep > 1):
        raise SystemExit(
            "--pp composes with --dp only (the pipeline's shard_map "
            "cannot host TP/EP GSPMD constraints)"
        )
    if pp > 1 and args.layers % pp:
        raise SystemExit(f"--layers {args.layers} not divisible by --pp {pp}")
    if ep > 1 and not args.moe_experts:
        raise SystemExit("--ep requires --moe-experts")
    mesh = None
    if dp > 1 or tp > 1 or ep > 1 or pp > 1:
        mesh = _verdict_mesh(args, dp, tp, ep, pp)
        if mesh is None:  # this process started the ranks, which have run
            return None

    from ircl_tpu_torch.corpus import fever
    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
    from ircl_tpu_torch.verdict.data import build_examples, encode_examples
    from ircl_tpu_torch.verdict.model import VerdictConfig
    from ircl_tpu_torch.verdict.train import train_verdict

    wiki = fever.load_wiki_json(cfg.data.wiki_json)
    doc_sents = {d: fever.parse_lines_tab(r["lines"]) for d, r in wiki.items()}
    claims = fever.parse_claims_jsonl(cfg.data.dev_jsonl, drop_nei=True)
    examples = build_examples(claims, doc_sents)

    tok = WordPieceTokenizer.train(
        [e.claim for e in examples] + [e.evidence_text for e in examples],
        vocab_size=args.vocab_size,
    )
    moe = None
    if args.moe_experts:
        from ircl_tpu_torch.models.moe import MoEConfig

        moe = MoEConfig(
            num_experts=args.moe_experts,
            top_k=min(args.moe_topk, args.moe_experts),
        )
    vcfg = VerdictConfig(
        encoder=TransformerConfig(
            vocab_size=tok.vocab_size,
            hidden=args.hidden,
            layers=args.layers,
            heads=args.heads,
            intermediate=4 * args.hidden,
            max_positions=cfg.verdict.max_length,
            moe=moe,
        ),
        learning_rate=cfg.verdict.learning_rate,
        warmup_steps=cfg.verdict.warmup_steps,
        max_length=cfg.verdict.max_length,
    )
    ids, mask, types, labels = encode_examples(examples, tok, cfg.verdict.max_length)
    # the port's checkpoint: verdict_config.json, verdict_vocab.txt and
    # verdict_params.pt in ckptdir, where eval-verdict and serve read them
    _, history = train_verdict(
        vcfg,
        ids,
        mask,
        types,
        labels,
        epochs=cfg.verdict.epochs,
        batch_size=cfg.verdict.batch_size,
        val_fraction=cfg.verdict.val_fraction,
        seed=cfg.verdict.seed,
        logdir=cfg.logdir,
        save_path=cfg.ckptdir,
        mesh=mesh,
        pp_micro=args.pp_micro,
        device=args.device,
        tokenizer=tok,
    )
    if mesh is None or mesh.get_rank() == 0:
        print(json.dumps(history))


def _verdict_mesh(args, dp, tp, ep, pp):
    """The reference's mesh for ``--dp/--tp/--ep/--pp``, over this
    process's group; ``None`` where this process is no rank: it starts
    that many ranks, each running ``cmd_train_verdict``, and returns once
    they have."""
    import torch
    import torch.distributed as dist

    from ircl_tpu_torch.parallel.ep import make_ep_mesh, make_ep_tp_mesh
    from ircl_tpu_torch.parallel.mesh import in_process_group, join_env_group
    from ircl_tpu_torch.parallel.pp import make_pp_mesh
    from ircl_tpu_torch.parallel.tp import make_tp_mesh

    want = dp * tp * ep * pp
    label = "dp*pp" if pp > 1 else "dp*tp*ep"
    in_group = in_process_group()
    if in_group:  # a rank of launch() or of torchrun
        join_env_group(args.device.type)
        n = dist.get_world_size()
    else:
        n = torch.cuda.device_count() if args.device.type == "cuda" else 1
    if n < want:
        raise SystemExit(f"{label}={want} exceeds {n} devices")
    if not in_group:
        from ircl_tpu_torch.parallel.launch import launch

        launch(cmd_train_verdict, want, args, device=args.device)
        return None
    if n != want:
        raise SystemExit(f"{label}={want} where the process group has {n} ranks")
    if pp > 1:
        return make_pp_mesh(stages=pp, data=dp, device=args.device)
    if ep > 1 and tp > 1:
        return make_ep_tp_mesh(expert=ep, model=tp, data=dp, device=args.device)
    if ep > 1:
        return make_ep_mesh(expert=ep, data=dp, device=args.device)
    return make_tp_mesh(model=tp, data=dp, device=args.device)


def cmd_eval_verdict(args):
    """Extrinsic evaluation (reference ``src/QA/evaluate.py``): classify dev
    claims over gold evidence or over retrieval output (--retrieved jsonl
    from ``retrieve --out``) and print the classification report."""
    cfg = _load(args)
    from ircl_tpu_torch.corpus import fever
    from ircl_tpu_torch.verdict.data import build_examples, encode_examples
    from ircl_tpu_torch.verdict.evaluate import classification_report, format_report
    from ircl_tpu_torch.verdict.infer import load_verdict_checkpoint
    from ircl_tpu_torch.verdict.train import predict_in_batches

    vcfg, params, tok = load_verdict_checkpoint(cfg.ckptdir, args.device)

    wiki = fever.load_wiki_json(cfg.data.wiki_json)
    doc_sents = {d: fever.parse_lines_tab(r["lines"]) for d, r in wiki.items()}
    claims = fever.parse_claims_jsonl(cfg.data.dev_jsonl, drop_nei=True)

    override = None
    if args.retrieved:
        by_id = {}
        with open(args.retrieved) as f:
            for line in f:
                rec = json.loads(line)
                by_id[rec["id"]] = [tuple(s) for s in rec["sentences"]]
        override = [by_id.get(c.id, []) for c in claims]

    examples = build_examples(claims, doc_sents, evidence_override=override)
    ids, mask, types, labels = encode_examples(examples, tok, vcfg.max_length)
    preds = predict_in_batches(params, vcfg, ids, mask, types, device=args.device)
    report = classification_report(labels, preds)
    print(format_report(report), file=sys.stderr)
    print(json.dumps(report))


def cmd_bench(args):
    """The judged sparse benchmark (``tools/bench.py``) at its defaults;
    its exit code. No argument of this command line reaches its parser."""
    from ircl_tpu_torch.tools import bench

    return bench.main(["--device", str(args.device)])


def cmd_serve(args):
    """Serve retrieval over HTTP (or stdin JSONL) with pinned shapes. The
    index path defaults to the tf-idf npz that ``build-index`` writes."""
    cfg = _load(args)
    from ircl_tpu_torch.serve import make_service, serve_http, serve_stdin

    device = args.device
    index_path = args.index or _tfidf_path(cfg)

    # Optional stage 2 (two-stage ``search_sentences``): restore the
    # contrastive encoder and embed every corpus sentence once into the
    # serving table (``PrecomputedSentenceScorer``; cached at --sent-table),
    # so that a request never re-embeds a sentence.
    doc_sentences = None
    scorer = None
    if args.dense_ckpt:
        import numpy as np

        from ircl_tpu_torch.corpus import fever
        from ircl_tpu_torch.pipeline.dense_scorer import (
            ContrastiveSentenceScorer,
            PrecomputedSentenceScorer,
        )

        wiki = fever.load_wiki_json(cfg.data.wiki_json)
        doc_sentences = {
            d: fever.parse_lines_tab(r["lines"]) for d, r in wiki.items()
        }
        state = _restore_train_state(args.dense_ckpt, cfg, device)
        embed = ContrastiveSentenceScorer(
            cfg.train, _featurizer(cfg, device), state, batch_size=args.batch_size
        ).embed
        table = None
        if args.sent_table and os.path.exists(args.sent_table):
            table = np.load(args.sent_table)
        try:
            scorer = PrecomputedSentenceScorer(embed, doc_sentences, table=table)
        except ValueError as e:  # stale cached table: rebuild
            print(f"ignoring --sent-table: {e}", file=sys.stderr)
            table = None
            scorer = PrecomputedSentenceScorer(embed, doc_sentences)
        if args.sent_table and table is None:
            np.save(args.sent_table, scorer.table)
            print(
                f"sentence table ({scorer.table.shape[0]} rows) -> "
                f"{args.sent_table}",
                file=sys.stderr,
            )

    # Optional stage 3 (claim verification, /verdict): the classifier that
    # ``train-verdict`` saved.
    verdict_classifier = None
    if args.verdict_ckpt:
        from ircl_tpu_torch.verdict.infer import VerdictClassifier

        verdict_classifier = VerdictClassifier.from_checkpoint(
            args.verdict_ckpt, batch_size=args.verdict_batch, device=device
        )

    service = make_service(
        index_path,
        batch_size=args.batch_size,
        default_k=args.k,
        max_terms=args.max_terms,
        union_cap=args.union_cap,
        split_path=args.split,
        mode=cfg.index.mode,
        doc_sentences=doc_sentences,
        sentence_scorer=scorer,
        default_k_sents=args.k_sents,
        verdict_classifier=verdict_classifier,
        chunk_docs=args.chunk_docs,
        device=device,
    )
    print(
        f"loaded {service.num_docs} docs from {index_path}; warming up "
        f"(kernel build + first batch)...",
        file=sys.stderr,
    )
    service.warmup()
    if args.stdin:
        n = serve_stdin(service, sys.stdin, sys.stdout)
        print(f"served {n} requests", file=sys.stderr)
        return
    if args.native_front:
        import threading

        from ircl_tpu_torch.serve_native import native_available, serve_native_http

        if native_available():
            native = serve_native_http(
                service,
                host=args.host,
                port=args.port,
                batch_wait_ms=args.batch_wait_ms,
            )
            print(
                f"serving on http://{args.host}:{native.port} "
                f"(native epoll front; POST /search, GET /healthz, "
                f"GET /metrics)",
                file=sys.stderr,
            )
            try:
                threading.Event().wait()  # workers run until interrupted
            except KeyboardInterrupt:
                print("interrupted; stopping", file=sys.stderr)
            finally:
                native.close()
            return
        print(
            "native front unavailable (libircl_http.so did not build); "
            "falling back to the stdlib transport",
            file=sys.stderr,
        )
    server = serve_http(
        service,
        host=args.host,
        port=args.port,
        batch_wait_ms=args.batch_wait_ms,
    )
    mode = (
        f", micro-batching {args.batch_wait_ms}ms"
        if args.batch_wait_ms is not None
        else ""
    )
    print(
        f"serving on http://{args.host}:{server.server_address[1]} "
        f"(POST /search, GET /healthz, GET /metrics{mode})",
        file=sys.stderr,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("interrupted; stopping", file=sys.stderr)
    finally:
        server.server_close()
        if server.batcher is not None:
            server.batcher.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ircl_tpu_torch", description=__doc__)
    p.add_argument("--config", type=str, default=None, help="yaml/json config path")
    p.add_argument(
        "--set", action="append", metavar="KEY=VALUE",
        help="dotted config override, e.g. --set train.loss=ProtoNCE",
    )
    p.add_argument(
        "--device", type=str, default=None,
        help="torch device for every stage (default: the CUDA card; "
        "'cpu' runs the plain PyTorch versions on the host)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    f = sub.add_parser("fetch")
    f.add_argument("--force", action="store_true", help="re-download")
    f.add_argument(
        "--resources", type=str, default=None,
        help="JSON file with an alternate URL table (mirror/fixture): "
        "{name: url} or {'resources': {...}, 'checksums': {...}}",
    )
    f.set_defaults(fn=cmd_fetch)

    sub.add_parser("prepare").set_defaults(fn=cmd_prepare)
    sub.add_parser("build-index").set_defaults(fn=cmd_build_index)

    t = sub.add_parser("train")
    t.add_argument("--loss", choices=["InfoNCE", "ProtoNCE", "HProtoNCE"])
    t.add_argument("--opt", choices=["adam", "sgd"])
    t.add_argument(
        "--sample", choices=["uniform", "tf_idf", "augment"], default="uniform"
    )
    t.add_argument("--seed", type=int, default=1337)
    t.add_argument("--steps", type=int, default=None)
    t.add_argument("--log-step", type=int, default=1000)
    t.add_argument(
        "--dp", action="store_true",
        help="data-parallel training over all visible devices",
    )
    t.add_argument("--resume", action="store_true")
    t.set_defaults(fn=cmd_train)

    r = sub.add_parser("retrieve")
    r.add_argument("--dense-ckpt", type=str, default=None)
    r.add_argument("--out", type=str, default=None)
    r.set_defaults(fn=cmd_retrieve)

    v = sub.add_parser("train-verdict")
    v.add_argument("--vocab-size", type=int, default=8192)
    v.add_argument("--hidden", type=int, default=256)
    v.add_argument("--layers", type=int, default=4)
    v.add_argument("--heads", type=int, default=4)
    v.add_argument(
        "--moe-experts", type=int, default=0,
        help="replace each FFN with a mixture of N experts (0 = dense)",
    )
    v.add_argument("--moe-topk", type=int, default=2)
    # multi-device training axes: --dp data parallel, --tp tensor
    # parallel, --ep expert parallel (requires --moe-experts)
    v.add_argument("--dp", type=int, default=1)
    v.add_argument("--tp", type=int, default=1)
    v.add_argument("--ep", dest="moe_ep", type=int, default=1)
    v.add_argument(
        "--pp", type=int, default=1,
        help="GPipe pipeline stages (composes with --dp; layers %% pp == 0)",
    )
    v.add_argument(
        "--pp-micro", dest="pp_micro", type=int, default=4,
        help="microbatches per step on a --pp mesh (batch %% micro == 0)",
    )
    v.set_defaults(fn=cmd_train_verdict)

    ev = sub.add_parser("eval-verdict")
    ev.add_argument(
        "--retrieved", type=str, default=None,
        help="results jsonl from `retrieve --out` (default: gold evidence)",
    )
    ev.set_defaults(fn=cmd_eval_verdict)

    sub.add_parser("bench").set_defaults(fn=cmd_bench)

    s = sub.add_parser("serve")
    s.add_argument("--index", type=str, default=None, help="tf-idf npz path")
    s.add_argument("--split", type=str, default=None, help="df-split npz (save_split)")
    s.add_argument("--host", type=str, default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--stdin", action="store_true", help="JSONL over stdin/stdout")
    s.add_argument("--k", type=int, default=5)
    s.add_argument("--batch-size", type=int, default=256, help="pinned device batch")
    s.add_argument("--max-terms", type=int, default=24)
    s.add_argument("--union-cap", type=int, default=4096)
    s.add_argument(
        "--dense-ckpt", type=str, default=None,
        help="contrastive ckpt: enables two-stage sentence search",
    )
    s.add_argument(
        "--sent-table", type=str, default=None,
        help="npy cache for the corpus sentence-embedding table",
    )
    s.add_argument("--k-sents", type=int, default=5)
    s.add_argument(
        "--chunk-docs", dest="chunk_docs", type=int, default=None,
        help="serve with the chunked engine (full-wiki scale); --split "
        "then names the per-chunk split-artifact DIRECTORY",
    )
    s.add_argument(
        "--verdict-ckpt", dest="verdict_ckpt", type=str, default=None,
        help="train-verdict output dir (verdict_config.json + vocab + "
        "params): enables the /verdict claim-verification endpoint",
    )
    s.add_argument(
        "--verdict-batch", dest="verdict_batch", type=int, default=32,
        help="pinned device batch for the verdict classifier",
    )
    s.add_argument(
        "--batch-wait-ms", type=float, default=None,
        help="coalesce concurrent requests into shared device batches, "
        "waiting up to this long for co-riders (HTTP transport only)",
    )
    s.add_argument(
        "--native-front", dest="native_front", action="store_true",
        help="serve HTTP through the native epoll front "
        "(native/libircl_http.so; keep-alive, C++ parse/IO) instead of "
        "the stdlib ThreadingHTTPServer",
    )
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    from ircl_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)
    print(f"ircl_tpu_torch.cli {args.command}: device {args.device.type}",
          file=sys.stderr, flush=True)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
