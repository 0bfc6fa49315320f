"""Window driver of fine-tuning the verdict classifier: train steps, a
closed loop, each batch tokenized on the host as the trainer's loader does.

Set-up builds one step with its model and AdamW state (``make_verdict_
train_step``) and drives it through its first ``check_steps`` steps on
batches of rows that all differ, through the window's own call; the window
goes on with the same object, batch after batch of the pool. Each step's
loss stays on the card and the window reads them back together at its
end, as ``train_verdict`` reads an epoch's.

Two stretches are compared with the plain model and AdamW. The first
steps, from the seed's weights on the same rows: each step's loss, every
leaf's gradient norm at the first step (the program's from its first
moment, m_1 = (1 - b1) g_1) and every leaf's change after the steps. And
one step of the window, drawn from the seed: the program's parameters and
AdamW state are copied before it and after it (into room made in set-up),
and the reference takes
that step from the copy before, on the same rows at the same step count;
its loss, and the median leaf's gradient norm (the program's from its two
first moments, g = (m_after - b1 m_before) / (1 - b1)) and change in the
step. Every loss of the window has to be finite. The control is the
plain model and AdamW, in TF32, in the step's place.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import Check, Request, log
from benchmark.reference import roberta
from benchmark.reference import wordpiece as ref_wp
from benchmark.traffic import _verdict


class ProgramTrainer:
    def __init__(self, run, params, texts):
        from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
        from ircl_tpu_torch.verdict.model import make_verdict_train_step

        cfg = run.config
        wp = cfg["wordpiece"]
        self.tok = WordPieceTokenizer.train(texts, vocab_size=wp["vocab_size"],
                                            min_count=wp["min_count"])
        self.cfg = _verdict.program_config(cfg)
        self.params = params
        self.step_fn, tx = make_verdict_train_step(self.cfg, device=run.device)
        self.state = tx.init(params)
        self.count = 0

    def step(self, claims, evidence, labels):
        from ircl_tpu_torch.verdict.data import VerdictExample, encode_examples

        ids, mask, types, lab = encode_examples(
            [VerdictExample(c, e, int(y)) for c, e, y in zip(claims, evidence, labels)],
            self.tok, self.cfg.max_length)
        _, _, loss, _ = self.step_fn(self.params, self.state, self.count, ids, mask, types, lab)
        self.count += 1
        return loss

    def tree(self):
        return self.params

    def moments(self):
        """AdamW's first and second moments, as leaves, and its step count."""
        return (roberta.leaves(self.state["mu"]), roberta.leaves(self.state["nu"]),
                self.state["count"])


class ReferenceTrainer:
    """The control: the plain model and AdamW in TF32, in the step's place."""

    def __init__(self, run, params, texts):
        cfg = run.config
        wp = cfg["wordpiece"]
        self.vocab = ref_wp.train(texts, wp["vocab_size"], wp["min_count"])
        self.run = run
        self.ref = roberta.Trainer(cfg["roberta"], cfg["train"], params,
                                   cfg["verdict"]["position_offset"], tf32=True)

    def step(self, claims, evidence, labels):
        return _reference_step(self.run, self.ref, self.vocab, claims, evidence, labels)

    def tree(self):
        return self.ref.params

    def moments(self):
        return self.ref.opt.mu, self.ref.opt.nu, self.ref.opt.count


def _reference_step(run, trainer, vocab, claims, evidence, labels):
    import torch

    ids, mask, types = ref_wp.encode_pairs(list(zip(claims, evidence)), vocab,
                                           run.config["verdict"]["max_length"])
    dev = run.device
    return torch.tensor(trainer.step(*(torch.as_tensor(x, device=dev)
                                       for x in (ids, mask, types, np.asarray(labels)))))


def _copies(trainer, moments: bool = True) -> dict:
    """Room for a copy of the parameters and AdamW's first moment, and with
    ``moments`` its second moment and step count too: made in set-up, so
    that the window's copy allocates nothing."""
    mu, nu, _ = trainer.moments()
    out = {"params": roberta.clone(trainer.tree()), "mu": [m.clone() for m in mu]}
    if moments:
        out["nu"] = [v.clone() for v in nu]
    return out


def _copy_into(copy: dict, trainer) -> None:
    import torch

    mu, nu, count = trainer.moments()
    torch._foreach_copy_(roberta.leaves(copy["params"]), roberta.leaves(trainer.tree()))
    torch._foreach_copy_(copy["mu"], list(mu))
    if "nu" in copy:
        torch._foreach_copy_(copy["nu"], list(nu))
        copy["count"] = count


class FinetuneCell:
    def __init__(self, run):
        import torch

        cfg, mix = run.config, run.mix
        self.batch = cfg["train"]["batch"]
        self.b1 = cfg["train"]["b1"]
        self.pool = mix["pool_steps"]
        self.n_check = mix["check_steps"]
        self.pairs = _verdict.Pairs(run, self.batch * self.pool)
        t = time.perf_counter()
        params = _verdict.weights(run)
        cls = ReferenceTrainer if run.control else ProgramTrainer
        self.trainer = cls(run, params, self.pairs.vocab_texts)
        del params
        log(f"weights, vocabulary and optimizer in {time.perf_counter() - t:.2f}s")
        t = time.perf_counter()
        self.losses = [float(self._step(0))]
        mu = self.trainer.moments()[0]  # the state after one step
        self.grad_norms = _norms(m / (1.0 - self.b1) for m in mu)
        t1 = time.perf_counter()
        self.losses += [float(self._step(j)) for j in range(1, self.n_check)]
        per_step = (time.perf_counter() - t1) / max(self.n_check - 1, 1)
        self.change_norms = _norms(p - p0 for p, p0 in zip(
            roberta.leaves(self.trainer.tree()), roberta.leaves(_verdict.weights(run))))
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        log(f"first {self.n_check} steps in {time.perf_counter() - t:.2f}s; losses {self.losses}")
        # the window's step that is compared, among those the window reaches
        reach = max(1, int(0.9 * run.seconds / max(per_step, 1e-6)))
        self.compared = int(np.random.default_rng([run.seed, 5]).integers(reach))
        self.before, self.after = _copies(self.trainer), _copies(self.trainer, moments=False)

    def _step(self, j: int):
        lo = (j % self.pool) * self.batch
        claims, evidence = self.pairs.slice(lo, lo + self.batch)
        return self.trainer.step(claims, evidence, self.pairs.labels[lo:lo + self.batch])

    def _window_step(self, i: int):
        if i == self.compared:
            _copy_into(self.before, self.trainer)
        loss = self._step(self.n_check + i)
        if i == self.compared:
            _copy_into(self.after, self.trainer)
            self.compared_loss = loss
        return loss

    def window(self, run) -> None:
        import torch

        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        i, self.window_losses = 0, []
        while time.perf_counter() < deadline:
            if run.probe.due(i):
                if run.device.type == "cuda":
                    torch.cuda.synchronize()
                run.probe.toggle(i)
            start = time.perf_counter()
            run.attempted += 1
            with run.span("step"):
                self.window_losses.append(self._window_step(i))
            run.requests.append(Request(start, time.perf_counter(), self.batch))
            i += 1
        run.window_s = time.perf_counter() - t0
        run.probe.stop(i)
        run.failed = run.attempted - len(run.requests)
        run.info["ordinals"] = i
        while i <= self.compared:  # the window closed before the compared step
            self.window_losses.append(self._window_step(i))
            i += 1
        losses = torch.stack(self.window_losses).double().cpu().numpy()
        self.nonfinite = int((~np.isfinite(losses)).sum())
        log(f"window: {run.info['ordinals']} steps, mean loss {losses[:run.info['ordinals']].mean()}; "
            f"step {self.compared} compared ({i - run.info['ordinals']} after the window)")

    def release(self) -> None:
        del self.trainer

    def check(self, run):
        cfg = run.config
        limits = run.mix["limits"]
        t = time.perf_counter()
        vocab = self._vocab(run)
        offset = cfg["verdict"]["position_offset"]
        start = _verdict.weights(run)
        names = roberta.leaf_names(start)
        ref = roberta.Trainer(cfg["roberta"], cfg["train"], start, offset)
        for j in range(self.n_check):
            lo = j * self.batch
            claims, evidence = self.pairs.slice(lo, lo + self.batch)
            _reference_step(run, ref, vocab, claims, evidence, self.pairs.labels[lo:lo + self.batch])
        first = compare(self.losses, self.grad_norms, self.change_norms, ref.losses,
                        ref.first_grad_norms.numpy(),
                        _norms(p - p0 for p, p0 in zip(ref.flat, roberta.leaves(start))))
        log(f"reference first {self.n_check} steps: losses {ref.losses}; worst gradient leaf "
            f"{names[first['grad_leaf']]}, worst change leaf {names[first['update_leaf']]}, "
            f"{first['excluded']} leaves without a gradient")
        del ref, start
        # the window's step, from the program's state before it
        b, a = self.before, self.after
        grads = _norms((ma.double() - self.b1 * mb.double()) / (1.0 - self.b1)
                       for ma, mb in zip(a["mu"], b["mu"]))
        before = roberta.leaves(b["params"])
        change = _norms(p - p0 for p, p0 in zip(roberta.leaves(a["params"]), before))
        self.after = a = None
        ref = roberta.Trainer(cfg["roberta"], cfg["train"], b["params"], offset,
                              state=(b["mu"], b["nu"], b["count"]))
        lo = ((self.n_check + self.compared) % self.pool) * self.batch
        claims, evidence = self.pairs.slice(lo, lo + self.batch)
        _reference_step(run, ref, vocab, claims, evidence, self.pairs.labels[lo:lo + self.batch])
        step = compare([float(self.compared_loss)], grads, change, ref.losses,
                       ref.first_grad_norms.numpy(),
                       _norms(p - p0 for p, p0 in zip(ref.flat, before)))
        log(f"reference window step {self.compared} (step count {b['count']}): loss "
            f"{ref.losses[0]} against {float(self.compared_loss)}; worst gradient leaf "
            f"{names[step['grad_leaf']]} {step['grad_gap']!r}; worst change leaf "
            f"{names[step['update_leaf']]} {step['update_gap']!r}; compared in "
            f"{time.perf_counter() - t:.2f}s")
        del ref
        self.before = b = None
        checks = [Check(n, first[n], float(limits[n])) for n in ("loss_gap", "grad_gap", "update_gap")]
        # a window step by the median leaf: its worst leaf is one small leaf's
        # rounding (a 2-element bias whose gradient cancels, a LayerNorm leaf
        # turning under a grown AdamW state; PERF.md)
        checks += [Check("step_loss_gap", step["loss_gap"], float(limits["step_loss_gap"])),
                   Check("step_grad_gap", step["grad_gap_median"], float(limits["step_grad_gap"])),
                   Check("step_update_gap", step["update_gap_median"],
                         float(limits["step_update_gap"]))]
        return checks + [Check("nonfinite_losses", float(self.nonfinite), 0.0)]

    def work(self, run) -> None:
        lengths = []
        for j in range(self.pool):
            lo = j * self.batch
            _, mask, _ = ref_wp.encode_pairs(list(zip(*self.pairs.slice(lo, lo + self.batch))),
                                             self._vocab(run), run.config["verdict"]["max_length"])
            lengths.append(mask.sum(1).astype(np.int64))
        for i in range(run.info["ordinals"]):
            run.work[i] = _verdict.request_work(run, lengths[(self.n_check + i) % self.pool])

    def _vocab(self, run):
        if not hasattr(self, "vocab"):
            wp = run.config["wordpiece"]
            self.vocab = ref_wp.train(self.pairs.vocab_texts, wp["vocab_size"], wp["min_count"])
        return self.vocab


def compare(losses, grads, change, ref_losses, ref_grads, ref_change) -> dict:
    """The numbers compared, each taken by the worst step or leaf:
    ``loss_gap``, a step's loss against the reference's, relative;
    ``grad_gap``, a leaf's gradient norm against the reference's, over the
    larger of the reference's norm of that leaf and of the median leaf;
    ``update_gap``, a leaf's change over the steps alike, over the leaves
    whose reference gradient is at least a thousandth of the median leaf's
    (the others, such as a key projection's bias under softmax, move under
    Adam by rounding alone); ``grad_gap_median`` and ``update_gap_median``,
    the median leaf's gaps."""
    losses, ref_losses = np.asarray(losses, np.float64), np.asarray(ref_losses, np.float64)
    grad_gap = np.abs(grads - ref_grads) / np.maximum(ref_grads, np.median(ref_grads))
    moved = ref_grads >= 1e-3 * np.median(ref_grads)
    update_gap = np.where(moved, np.abs(change - ref_change)
                          / np.maximum(ref_change, np.median(ref_change[moved])), 0.0)
    return {"loss_gap": float((np.abs(losses - ref_losses) / np.abs(ref_losses)).max()),
            "grad_gap": float(grad_gap.max()), "grad_leaf": int(np.argmax(grad_gap)),
            "grad_gap_median": float(np.median(grad_gap)),
            "update_gap": float(update_gap.max()), "update_leaf": int(np.argmax(update_gap)),
            "update_gap_median": float(np.median(update_gap[moved])),
            "excluded": int((~moved).sum())}


def _norms(tensors) -> np.ndarray:
    """Each tensor's norm, taken in float64, on the host."""
    import torch

    return torch.stack([x.double().norm() for x in tensors]).cpu().numpy()


def build(run) -> FinetuneCell:
    return FinetuneCell(run)
