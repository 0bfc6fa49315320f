"""Where a verdict train step's time goes on the card, by kernel.

    python3 -m ircl_tpu_torch.tools.profile_verdict_train [--steps 8]
        [--parent-root DIR] [--out FILE]

Builds the roberta-base-width verdict model of ``chip_smoke.py`` phase 14
(vocab 50,265, hidden 768, 12 layers, 12 heads, FFN 3072, L=512, f32, B=8;
random weights from a seed, random token ids with pads) and, for the
"flash" and the "xla" attention path in turn:

1. times ``--steps`` unfrozen train steps without the profiler (CUDA events
   around the whole window, the host clock around it with a synchronize);
2. runs the same steps under ``torch.profiler`` and sums the kernels'
   device time by name into a few classes (matrix products, the three
   flash-attention kernels, the optimizer's ``foreach`` passes, LayerNorm,
   GELU, softmax, embedding gather and scatter, other elementwise work).

The device's idle share is one minus the profiled kernel time a step over
the unprofiled window a step: the profiler slows the host, so its own wall
clock is not used. With ``--parent-root`` (another checkout of this
repository) it also times the kernels of both checkouts in turns (parent,
this, this, parent), each built from its own sources: the forward
flash-attention kernel at ``[32, 12, 512, 64]``, and the two backward
kernels (dK/dV, dQ) at ``[8, 12, 512, 64]`` under the segment ids of
``chip_smoke.py`` phase 13's tokenized pairs, with the largest difference
between the two checkouts' gradients. Prints each part as JSON and, with
``--out``, writes the whole report there. Needs a CUDA device; there is no
CPU mode.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ircl_tpu_torch.models.transformer import TransformerConfig
from ircl_tpu_torch.ops.flash_attention_cuda import (
    SegmentIds,
    flash_attention,
    flash_attention_fwd,
)
from ircl_tpu_torch.utils.kernel_build import load_kernels
from ircl_tpu_torch.verdict.model import (
    VerdictConfig,
    init_verdict_params,
    make_verdict_train_step,
)

ENCODER = dict(  # bench_verdict.py:83-97, f32
    vocab_size=50265, hidden=768, layers=12, heads=12, intermediate=3072,
    max_positions=512, type_vocab=1, position_offset=2, layernorm_eps=1e-5,
)
B, L, WARMUP = 8, 512, 3
# real lengths of chip_smoke.py phase 13's eight tokenized pairs (the last
# cut to one real token), as that phase prints them
PHASE13_LENGTHS = (11, 87, 187, 325, 450, 512, 12, 1)
CLASSES = (  # first match wins
    ("flash forward", ("flash_attention_kernel",)),
    ("flash dK/dV", ("flash_attention_dkv_kernel",)),
    ("flash dQ", ("flash_attention_dq_kernel",)),
    ("matrix products", ("gemm", "cutlass", "xmma", "cublas", "gemv")),
    ("optimizer foreach", ("multi_tensor", "foreach")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("GELU", ("gelu", "Gelu")),
    ("softmax", ("softmax", "Softmax")),
    ("embedding gather/scatter", ("index", "embedding", "scatter", "gather")),
    ("reductions", ("reduce",)),
)


def _class_of(name: str) -> str:
    for label, needles in CLASSES:
        if any(n in name for n in needles):
            return label
    return "other elementwise and copies"


def _batch(rng):
    lengths = [325, 450, 512, 12, 158, 204, 334, 478]
    ids = rng.integers(5, ENCODER["vocab_size"], size=(B, L)).astype(np.int32)
    mask = np.zeros((B, L), np.float32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1.0
    ids *= mask.astype(np.int32)
    types = (np.arange(L)[None, :] >= 20).astype(np.int32) * mask.astype(np.int32)
    return ids, mask, types, rng.integers(0, 2, size=B).astype(np.int32)


def profile_path(attention: str, steps: int, dev) -> dict:
    cfg = VerdictConfig(
        encoder=TransformerConfig(**ENCODER, attention=attention), max_length=L,
        learning_rate=1e-5, warmup_steps=WARMUP, total_steps=200,
    )
    params = init_verdict_params(torch.Generator().manual_seed(3), cfg, dev)
    step, tx = make_verdict_train_step(cfg, device=dev)
    state = dict(tx.init(params), count=WARMUP)
    batch = _batch(np.random.default_rng(14))
    count = WARMUP

    def run(n):
        nonlocal count
        for _ in range(n):
            step(params, state, count, *batch)
            count += 1

    run(2)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    run(steps)
    e1.record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    window_ms = e0.elapsed_time(e1) / steps

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    by_kernel = {}
    for evt in prof.key_averages():
        if "cuda" not in str(getattr(evt, "device_type", "")).lower():
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3 / steps
    if not by_kernel:
        raise RuntimeError("torch.profiler recorded no device time")
    by_class = {}
    for name, ms in by_kernel.items():
        by_class[_class_of(name)] = by_class.get(_class_of(name), 0.0) + ms
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {
        "attention": attention, "steps": steps,
        "wall_ms_per_step": wall_ms, "device_window_ms_per_step": window_ms,
        "kernel_ms_per_step": busy_ms, "idle_share": 1.0 - busy_ms / window_ms,
        "ms_per_step_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": {k[:90]: v for k, v in top},
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def _load_other(root: str):
    """``load_kernels()`` of another checkout, from its own sources."""
    path = os.path.join(root, "ircl_tpu_torch", "utils", "kernel_build.py")
    spec = importlib.util.spec_from_file_location("other_kernel_build", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks its module up by name
    spec.loader.exec_module(mod)
    return mod.load_kernels()


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _in_turns(parent_call, this_call):
    turns = [("parent", parent_call), ("this", this_call), ("this", this_call),
             ("parent", parent_call)]
    return [[name, _ms(fn)] for name, fn in turns]


def forward_in_turns(parent, this, dev) -> dict:
    rng = np.random.default_rng(10)
    q, k, v = (torch.tensor(rng.normal(size=(32, 12, L, 64)).astype(np.float32),
                            device=dev) for _ in range(3))
    seg = torch.ones(32, L, dtype=torch.int32, device=dev)
    for b in range(32):
        seg[b, 16 * b + 1:] = 0
    ids = SegmentIds(q=seg, kv=seg)
    out = torch.empty_like(q)

    def direct(kern):  # the C entry point alone, into one output buffer
        def call():
            rc = kern.lib.ircl_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                seg.data_ptr(), 32, 12, L, L, 64, 0.125, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            kern.check(rc, "flash-attention launch")
        return call

    parent_call, this_call = direct(parent), direct(this)
    parent_call()
    mine = flash_attention(q, k, v, segment_ids=ids, sm_scale=0.125)
    return {"shape": [32, 12, L, 64], "bit_equal": bool(torch.equal(out, mine)),
            "max_abs_difference_parent_this": float((out - mine).abs().max()),
            "ms_in_turns": _in_turns(parent_call, this_call)}


def backward_in_turns(parent, this, dev) -> dict:
    """Kernels dK/dV and dQ of both checkouts at the train step's shape."""
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.tensor(rng.normal(size=(B, 12, L, 64)).astype(np.float32),
                                device=dev) for _ in range(4))
    seg = torch.zeros(B, L, dtype=torch.int32, device=dev)
    for b, n in enumerate(PHASE13_LENGTHS):
        seg[b, :n] = 1
    o, stats = flash_attention_fwd(q, k, v, SegmentIds(q=seg, kv=seg), 0.125)
    di = (o * do).sum(dim=-1)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), seg.data_ptr(),
              stats.l.data_ptr(), stats.m.data_ptr(), do.data_ptr(), di.data_ptr(),
              B, 12, L, L, 64, 0.125)

    def direct(kern):  # the C entry points alone, into this checkout's buffers
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))

        def dkv():
            rc = kern.lib.ircl_flash_attention_bwd_dkv(
                *inputs, dk.data_ptr(), dv.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            kern.check(rc, "flash-attention dK/dV launch")

        def dq_call():
            rc = kern.lib.ircl_flash_attention_bwd_dq(
                *inputs, dq.data_ptr(), torch.cuda.current_stream().cuda_stream)
            kern.check(rc, "flash-attention dQ launch")

        return dkv, dq_call, (dq, dk, dv)

    p_dkv, p_dq, p_out = direct(parent)
    t_dkv, t_dq, t_out = direct(this)
    for fn in (p_dkv, p_dq, t_dkv, t_dq):
        fn()
    torch.cuda.synchronize()
    apart = {name: float((a - b).abs().max())
             for name, a, b in zip(("dq", "dk", "dv"), p_out, t_out)}
    return {"shape": [B, 12, L, 64], "real_lengths": list(PHASE13_LENGTHS),
            "max_abs_difference_parent_this": apart,
            "dkv_ms_in_turns": _in_turns(p_dkv, t_dkv),
            "dq_ms_in_turns": _in_turns(p_dq, t_dq)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--parent-root", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures the card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    report = {"device": smi, "torch": torch.__version__, "paths": []}
    for attention in ("flash", "xla"):
        torch.cuda.reset_peak_memory_stats()
        report["paths"].append(profile_path(attention, args.steps, dev))
        print(json.dumps(report["paths"][-1], indent=1), flush=True)
        torch.cuda.empty_cache()
    if args.parent_root:
        parent, this = _load_other(args.parent_root), load_kernels()
        report["flash_forward_in_turns"] = forward_in_turns(parent, this, dev)
        report["flash_backward_in_turns"] = backward_in_turns(parent, this, dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    for part in ("flash_forward_in_turns", "flash_backward_in_turns"):
        print(json.dumps(report.get(part), indent=1))


if __name__ == "__main__":
    main()
