"""Plain PyTorch roberta-base sequence classifier, and its AdamW step.

The reference of the verdict cells, written from the published model
(huggingface.co/FacebookAI/roberta-base, ``RobertaForSequenceClassification``
with the verdict head of ``src/QA/model.py``): word + position (offset 2,
as roberta's padding index) + token-type embeddings, LayerNorm; post-LN
blocks of 12-head softmax attention over the real tokens, exact-GELU FFN;
the first token through a tanh dense layer and the output layer. Float32
with TF32 off; ``tf32=True`` runs every product in TF32 (the control), on
the CPU by rounding the operands as the card's TF32 does.

Token types are as the configuration's pair encoder writes them: 0 up to
the first ``[SEP]``, 1 after it. roberta has one type, and the
configuration's model reads an id past the table from the table's last row
and passes that row no gradient from it (a clamped gather whose transpose
drops what was out of range, as the model was written for JAX): so every
position reads row 0, and only the first segment trains it.

``init_params`` makes the weights on the device from the seed in one
normal draw: N(0, 0.02) for every matrix and table, zero biases, unit
LayerNorm scales, laid out as the program's parameter tree (dense weights
[in, out]). The benchmark hands the same tensors to the program and to this
reference.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F


def _shapes(c: dict) -> List[tuple]:
    """(path, shape, kind) of every leaf, kind in w (normal), b (zero), s (one)."""
    h, i, n = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    out = [(("body", "tok_emb"), (c["vocab_size"], h), "w"),
           (("body", "pos_emb"), (c["max_position_embeddings"], h), "w"),
           (("body", "type_emb"), (c["type_vocab_size"], h), "w"),
           (("body", "emb_ln", "scale"), (h,), "s"), (("body", "emb_ln", "bias"), (h,), "b")]
    for layer in range(n):
        p = ("body", "layers", layer)
        for name in ("q", "k", "v", "o"):
            out += [(p + (name, "w"), (h, h), "w"), (p + (name, "b"), (h,), "b")]
        for ln in ("attn_ln", "ff_ln"):
            out += [(p + (ln, "scale"), (h,), "s"), (p + (ln, "bias"), (h,), "b")]
        out += [(p + ("ff1", "w"), (h, i), "w"), (p + ("ff1", "b"), (i,), "b"),
                (p + ("ff2", "w"), (i, h), "w"), (p + ("ff2", "b"), (h,), "b")]
    out += [(("head_dense", "w"), (h, h), "w"), (("head_dense", "b"), (h,), "b"),
            (("head_out", "w"), (h, c["num_labels"]), "w"), (("head_out", "b"), (c["num_labels"],), "b")]
    return out


def init_params(c: dict, seed: int, device) -> Dict:
    shapes = _shapes(c)
    n = sum(math.prod(s) for _, s, k in shapes if k == "w")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(n, device=device).normal_(0.0, 0.02, generator=gen)
    tree: Dict = {}
    o = 0
    for path, shape, kind in shapes:
        if kind == "w":
            leaf = flat[o:o + math.prod(shape)].view(shape)
            o += math.prod(shape)
        else:
            leaf = (torch.ones if kind == "s" else torch.zeros)(shape, device=device)
        node = tree
        for key in path[:-1]:
            if key == "layers":
                node = node.setdefault("layers", [])
            elif isinstance(node, list):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaf_names(tree, prefix="") -> List[str]:
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its mantissa rounded to TF32's 10 bits (to nearest); the
    gradient passes through unrounded."""
    d = x.detach().contiguous()
    rounded = ((d.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - d)


class Model:
    """The classifier's forward over a parameter tree (read only)."""

    def __init__(self, c: dict, params: Dict, position_offset: int, tf32: bool = False):
        self.c, self.p, self.offset, self.tf32 = c, params, position_offset, tf32

    def mm(self, a, b):
        if self.tf32 and a.device.type == "cpu":
            a, b = _round_tf32(a), _round_tf32(b)
        return a @ b

    def dense(self, x, p):
        return self.mm(x, p["w"]) + p["b"]

    def ln(self, x, p):
        return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], self.c["layer_norm_eps"])

    def types(self, types: torch.Tensor) -> torch.Tensor:
        """The token-type rows: an id past the table reads its last row,
        which gets no gradient from it."""
        table = self.p["body"]["type_emb"]
        rows = table[types.clamp(0, table.shape[0] - 1)]
        past = (types >= table.shape[0])[..., None]
        return torch.where(past, rows.detach(), rows)

    def logits(self, ids: torch.Tensor, mask: torch.Tensor, types: torch.Tensor) -> torch.Tensor:
        c, body = self.c, self.p["body"]
        B, L = ids.shape
        heads = c["num_attention_heads"]
        hd = c["hidden_size"] // heads
        x = (body["tok_emb"][ids] + body["pos_emb"][torch.arange(L, device=ids.device) + self.offset]
             + self.types(types))
        x = self.ln(x, body["emb_ln"])
        pad = torch.zeros(B, 1, 1, L, device=ids.device).masked_fill(mask[:, None, None, :] == 0,
                                                                     float("-inf"))
        for lp in body["layers"]:
            def split(t):
                return t.view(B, L, heads, hd).transpose(1, 2)

            q, k, v = (split(self.dense(x, lp[n])) for n in ("q", "k", "v"))
            att = torch.softmax(self.mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + pad, dim=-1)
            ctx = self.mm(att, v).transpose(1, 2).reshape(B, L, heads * hd)
            x = self.ln(x + self.dense(ctx, lp["o"]), lp["attn_ln"])
            x = self.ln(x + self.dense(F.gelu(self.dense(x, lp["ff1"])), lp["ff2"]), lp["ff_ln"])
        cls = torch.tanh(self.dense(x[:, 0], self.p["head_dense"]))
        return self.dense(cls, self.p["head_out"])


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 products on the card only where asked: off for the reference."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def probabilities(c: dict, params, ids, mask, types, position_offset: int, tf32: bool = False,
                  block: int = 32) -> torch.Tensor:
    """Softmax of the logits, in blocks of rows, without autograd."""
    model = Model(c, params, position_offset, tf32)
    out = []
    with torch.no_grad(), precision(tf32):
        for lo in range(0, ids.shape[0], block):
            rows = slice(lo, lo + block)
            out.append(torch.softmax(model.logits(ids[rows], mask[rows], types[rows]), -1))
    return torch.cat(out)


class AdamW:
    """AdamW as the configuration states it (``src/QA/train.py``): moments
    b1, b2, eps added to the root of the second moment after bias
    correction, decoupled weight decay on every leaf, and the learning rate
    warmed up linearly from 0 over ``warmup_steps``, then decayed linearly
    to 0 over the rest of ``total_steps``."""

    def __init__(self, t: dict, params: List[torch.Tensor], state=None):
        """``state``: the moments and the step count ``(mu, nu, count)`` to
        go on from, taken over as they are; zeros and 0 without it."""
        self.t, self.params = t, params
        if state is None:
            state = ([torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params], 0)
        self.mu, self.nu, self.count = state

    def lr(self) -> float:
        t, n = self.t, self.count
        if n < t["warmup_steps"]:
            return t["learning_rate"] * n / t["warmup_steps"]
        rest = max(t["total_steps"] - t["warmup_steps"], 1)
        return t["learning_rate"] * (1.0 - min(n - t["warmup_steps"], rest) / rest)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        t = self.t
        lr = self.lr()
        self.count += 1
        bc1, bc2 = 1.0 - t["b1"] ** self.count, 1.0 - t["b2"] ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(t["b1"]).add_(g, alpha=1.0 - t["b1"])
            v.mul_(t["b2"]).addcmul_(g, g, value=1.0 - t["b2"])
            update = (m / bc1) / ((v / bc2).sqrt() + t["eps"]) + t["weight_decay"] * p
            p.sub_(lr * update)


class Trainer:
    """Steps of the mean cross-entropy under ``AdamW`` on its own copy of
    the parameters (or on ``params`` themselves with ``copy=False``); keeps
    each step's loss and the first step's gradient norms. ``state`` is
    ``AdamW``'s."""

    def __init__(self, c: dict, t: dict, params, position_offset: int, tf32: bool = False,
                 state=None, copy: bool = True):
        self.params = clone(params) if copy else params
        self.model = Model(c, self.params, position_offset, tf32)
        self.flat = leaves(self.params)
        self.opt = AdamW(t, self.flat, state)
        self.tf32 = tf32
        self.losses: List[float] = []
        self.first_grad_norms = None

    def step(self, ids, mask, types, labels) -> float:
        for p in self.flat:
            p.requires_grad_(True)
        with precision(self.tf32):
            loss = F.cross_entropy(self.model.logits(ids, mask, types), labels)
            grads = torch.autograd.grad(loss, self.flat)
        for p in self.flat:
            p.requires_grad_(False)
        if self.first_grad_norms is None:
            self.first_grad_norms = torch.stack([g.norm() for g in grads]).double().cpu()
        self.opt.step(grads)
        self.losses.append(float(loss.detach()))
        return self.losses[-1]


def clone(tree):
    """A copy of a parameter tree, detached."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.detach().clone()
