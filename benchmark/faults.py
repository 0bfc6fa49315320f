"""Faults planted under the timed path, to show that ``correct`` catches
them: ``answer`` (an answer or an input token altered where it is
produced), ``half`` (half of the batch left out) and ``unchanged`` (a step
that leaves its state, or its answers, as they were). A cell runs on one
card, so no fault leaves out an exchange between cards.

``plant(kind, fault, after)`` patches the program's module attributes and
returns a function that takes the patch away; each patched function keeps
its sound behaviour for its first ``after`` calls (a fault that starts once
set-up's steps are done). The tests plant each fault in a tiny cell;
``calibrate.py --fault`` plants one at a cell's own size on the card.
"""

from __future__ import annotations

from typing import Callable, List, Tuple


def plant(kind: str, fault: str, after: int = 0) -> Callable[[], None]:
    patches = _PLANTERS[kind](fault)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for (obj, name, new), (_, _, old) in zip(patches, saved):
        setattr(obj, name, _late(old, new, after) if after else new)

    def undo():
        for obj, name, old in saved:
            setattr(obj, name, old)
    return undo


def _late(sound, faulty, after: int):
    """``sound`` for the first ``after`` calls, then ``faulty``."""
    calls = [0]

    def fn(*a, **kw):
        calls[0] += 1
        return (sound if calls[0] <= after else faulty)(*a, **kw)
    return fn


def _retrieve(fault: str) -> List[Tuple[object, str, object]]:
    from ircl_tpu_torch.index.ranker import TfidfRanker

    finalize = TfidfRanker.finalize_closest
    launch = TfidfRanker.hybrid_from_host_async
    if fault == "answer":  # the first query's best doc id altered, every batch
        def altered(self, pending, n):
            out = finalize(self, pending, n)
            ids, scores = out[0]
            other = self.dev.doc_ids[(self.dev.doc_ids.index(ids[0]) + 1) % self.dev.num_docs]
            out[0] = ([other] + ids[1:], scores)
            return out
        return [(TfidfRanker, "finalize_closest", altered)]
    if fault == "half":  # the second half of every batch scored as empty queries
        def half(self, host, k):
            u, qb, qw, ld, lc = (x.copy() for x in host)
            b = ld.shape[0]
            qw[:, b // 2:] = 0
            lc[b // 2:] = 0
            return launch(self, (u, qb, qw, ld, lc), k)
        return [(TfidfRanker, "hybrid_from_host_async", half)]
    held = []

    def stale(self, pending, n):  # every batch answered with the results of the one before it
        held.append(finalize(self, pending, n))
        return held.pop(0) if len(held) > 1 else held[0]
    return [(TfidfRanker, "finalize_closest", stale)]


def _verify(fault: str):
    import torch

    from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
    from ircl_tpu_torch.verdict import infer

    if fault == "answer":  # one token id altered where the pairs are encoded
        encode = WordPieceTokenizer.encode_batch

        def altered(self, pairs, max_length=128):
            ids, mask, types = encode(self, pairs, max_length)
            ids[0, 1] = (ids[0, 1] + 7) % self.vocab_size
            return ids, mask, types
        return [(WordPieceTokenizer, "encode_batch", altered)]
    if fault == "half":  # the second half of the rows left out of the forward
        probs = infer._probs_batch

        def half(params, cfg, ids, mask, types):
            b = ids.shape[0] // 2
            p = probs(params, cfg, ids[:b], mask[:b], types[:b])
            return torch.cat([p, p])
        return [(infer, "_probs_batch", half)]
    classify = infer.VerdictClassifier.classify
    held = []

    def stale(self, claims, evidence):  # every request answered with the one before it's results
        held.append(classify(self, claims, evidence))
        return held.pop(0) if len(held) > 1 else held[0]
    return [(infer.VerdictClassifier, "classify", stale)]


def _finetune(fault: str):
    from ircl_tpu_torch.verdict import data, model

    if fault == "answer":  # one label altered where the batch is encoded
        encode = data.encode_examples

        def altered(examples, tokenizer, max_length=512):
            ids, mask, types, labels = encode(examples, tokenizer, max_length)
            labels = labels.copy()
            labels[0] = 1 - labels[0]
            return ids, mask, types, labels
        return [(data, "encode_examples", altered)]
    if fault == "half":  # the loss's mean over the first half of the batch
        grad_fn = model.make_verdict_grad_fn

        def half_fn(*a, **kw):
            fn = grad_fn(*a, **kw)

            def run(params, ids, mask, type_ids, labels):
                b = len(labels) // 2
                return fn(params, ids[:b], mask[:b], type_ids[:b], labels[:b])
            return run
        return [(model, "make_verdict_grad_fn", half_fn)]

    def no_update(self, params, grads, state, body_on=True, body=("body",)):
        return None  # the optimizer's update withheld: the state stays as it was
    return [(model.VerdictOptimizer, "update_", no_update)]


_PLANTERS = {"retrieve": _retrieve, "verify": _verify, "finetune": _finetune}
FAULTS = ("answer", "half", "unchanged")
