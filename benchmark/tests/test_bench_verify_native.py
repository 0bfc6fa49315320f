"""The verify cell's traffic and the program's WordPiece encoder: every pair
the mix draws is ASCII, so ``WordPieceTokenizer.encode_batch`` sends every
row to its native encoder (``native_rows``) and none to ``encode_pair``
(``python_rows``). A mix with non-ASCII text would run partly in Python."""

from __future__ import annotations

import os
import types

from benchmark import harness
from benchmark.traffic import _verdict


def test_every_verify_pair_takes_the_native_encoder():
    from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer

    cfg = harness.load_json(os.path.join(harness.ROOT, "configs", "fever50k.json"))
    mix = harness.load_json(os.path.join(harness.ROOT, "workloads", "verify_pairs32.json"))
    cfg["corpus"]["num_docs"] = 2000
    run = types.SimpleNamespace(config=cfg, mix=mix, seed=2**33 + 17)
    pairs = _verdict.Pairs(run, mix["batch"] * mix["pool_requests"])
    assert all(t.isascii() for t in pairs.claims + pairs.evidence)
    tok = WordPieceTokenizer.train(pairs.vocab_texts[:500],
                                   vocab_size=cfg["wordpiece"]["vocab_size"],
                                   min_count=cfg["wordpiece"]["min_count"])
    for lo in range(0, len(pairs.claims), mix["batch"]):
        tok.encode_batch(list(zip(*pairs.slice(lo, lo + mix["batch"]))),
                         cfg["verdict"]["max_length"])
    assert tok.python_rows == 0 and tok.native_rows == len(pairs.claims)
