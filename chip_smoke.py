"""Smoke run of the PyTorch + CUDA port (``ircl_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Drives the port's sparse stage-1 retrieval at the repository's judged
configuration (``bench.py``: 50,000 synthetic docs from ``generate(seed=11)``,
4096 claims, bigrams hashed into 2^24 buckets) and never imports JAX.
Phases, each printed as it runs:

0. device: the card, its power limit, the kernel build, the host library;
1. corpus and index, saved with ``CountIndex.save`` (50K docs, and the
   first 20K docs for the ELL engine);
2. every CUDA kernel against its plain PyTorch version on the card, at the
   shapes of the main path, with CUDA-event times for both; the slab
   kernel also with both width buckets launched into one shared buffer,
   and on seeded edge cases (runs of equal union slots, repeated terms,
   terms out of order, a wide union, unaligned column offsets); the light
   add on seeded edge cases, bit for bit (k on and above its register
   lists, ties across its row groups, one column's pool in one d-tile,
   empty pools, other d_tile, B off its column block and odd);
3. the served path, hybrid: ``make_service`` + ``serve_stdin`` over JSONL,
   every reply held against scipy's top-k;
4. the served path, ELL (20K docs, ``mode="auto"``), checked the same way;
5. the judged benchmark, ``tools/bench.py``'s ``run_judged`` (the port of
   ``bench.py``) on phase 1's index and claims: its full-batch scipy gate
   (4096/4096), its plateau rounds (6-16) and its line, held to the
   reference's metric and unit, then latency at B=4096, 512 and 128 and a
   per-stage split of one batch;
6. the dense chunk-max kernels (``cosine_topk_fused``'s phase 1; the bf16
   tensor-core kernel and the SIMT kernel, as ``chunk_max_route`` routes a
   call) against their plain version at ``bench_dense.py``'s shape and on a
   small ragged shape, for fold/high3, loop/high3, loop/highest and a bf16
   corpus with slack chunks, each route launched;
7. ``bench_dense.py``'s configuration on the port (1M x 128 corpus, 1024
   queries, top-5): the fused, two-phase and scan engines, the fused one
   held to the bench's full-batch numpy gate, then q/s;
8. the sentence encoder at full width (12-layer 768-wide transformer over a
   WordPiece vocab trained on 5,000 docs, BiLSTM 3 x 256 -> 128), random
   weights from a seed: the card against the CPU, rows against their batch,
   then every sentence of those docs embedded;
9. served sentence search over those docs (``make_service`` with a
   precomputed sentence table, ``serve_stdin``), every reply checked, and
   the dense top-k over the sentence table against numpy;
31. (run right after phase 9) phase 8's transformer written as a
    ``bert-base-uncased``-shaped HuggingFace checkpoint (``config.json``,
    ``vocab.txt``, ``tokenizer_config.json``; the weights under the original
    names, ``bert.`` prefix, LayerNorm ``gamma``/``beta``, ``[out, in]``,
    pooler and ``cls`` heads, once as ``pytorch_model.bin`` and once as
    ``model.safetensors``) and once more in a temporary hub cache; each form
    loaded by ``TransformerFeaturizer.from_huggingface`` onto the card: the
    config equal to phase 8's, every parameter and ``features`` on 16
    sentences bit-equal to phase 8's, the card within ``ENC_DEVICE_ATOL``
    of the CPU; then about 2,000 sentences embedded through it with the
    port's BERT tokenizer, 4 request lines of served sentence search over
    phase 9's index with that table (replies checked as phase 9 checks its
    own) and the dense top-k over it against numpy;
10. the flash-attention kernel against its plain version (in full fp32, and
    with its products split into TF32 halves as the kernel takes them) at
    the verdict model's shape, ``[32, 12, 512, 64]``, with segment ids from
    tokenized claim/evidence pairs, a batch with no pads and a row of one
    real token;
11. the verdict classifier at roberta-base width (12 layers, 768 wide,
    50,265-word embedding table, one token type, L=512, flash attention),
    random weights from a seed: the card against the CPU, flash against the
    "xla" path, a row against its batch, then pairs/s through
    ``VerdictClassifier.classify`` at batch 32;
12. served claim verification: the classifier saved and loaded back as a
    checkpoint, ``make_service`` over phase 9's index and sentence table,
    claim lines through ``serve_stdin``, every reply checked;
13. the two flash-attention backward kernels against their plain version
    (in full fp32, and with its products split into TF32 halves as the
    kernels take them) and against autograd through the plain forward at the
    training shape, ``[8, 12, 512, 64]``: the forward's softmax statistics,
    then dq, dk, dv, each launched twice for equal bits, under four sets of
    segment ids (tokenized pairs, no pads, key ids that differ from the
    query ids with a query that matches no key, short pairs whose empty
    tiles are skipped), with CUDA-event times of each beside PyTorch's own
    fused attention as a yardstick;
14. the verdict train step at roberta-base width, B=8, L=512: flash against
    "xla" on the card (loss and every gradient leaf), one step of two pairs
    on the card against the CPU, the body frozen bit for bit until
    ``warmup_steps``, then 20 timed steps of each attention path: steps/s,
    device ms a step, peak memory, kernel launches a step;
15. the trainer end to end: ``train_verdict`` on 256 seeded pairs for 2
    epochs with a validation split, its checkpoint loaded by
    ``VerdictClassifier`` and held to ``predict_in_batches``, whose
    examples/s at batch 64 is printed;
16. the two probe kernels against their plain versions: the fused dot +
    light add on seeded edge cases (U off its stages and empty, B off its
    column block, other d_tile, k above its register lists) and on phase
    5's 50K-doc operands (slabs split into bf16 halves), also held to the
    fused engine's top-5; the pre-split dense chunk-max on
    phase 7's 1M x 128 corpus, bit for bit equal to the "high3" kernel, and
    ``cosine_topk_fused_presplit`` through ``bench_dense.py``'s gate;
17. sparse retrieval at scale, ``bench_scale.py``'s configuration: a
    synthetic 1M-doc index, 1024 queries of 24 terms, the staged bucketed
    engine, ``select_rescore=16`` and (on 32 queries) the ragged engine, each
    held to the bench's scipy gate, then q/s, ms by stage and peak memory,
    and the slab kernel against its plain version on this index's slabs;
18. the one-pass fused hybrid kernel against its plain version on both
    buckets of that index, and ``hybrid_topk_onepass`` on phase 17's inputs
    held to the staged engine's top-5 and to the scipy gate, with its ms a
    batch and peak memory beside the staged engine's;
19. ``ChunkedHybridRanker`` over the same index in two chunks of 500K docs,
    held to the single ranker's scores and ids, then q/s;
20. contrastive training, ``bench_train.py``'s compiled step: ``TrainConfig()``
    (BiLSTM 3 x 256 bidirectional over 768-d hash features -> 128, 128 x 2
    micro-batches, queue 12,544, Adam) on ``bench_train.py``'s seeded ids:
    one step on the card against the CPU from one state (loss, grad norm,
    both encoders, Adam's moments, the queue, pointer and step), the queue
    term switching on at ``queue_start_steps``, a bfloat16 step, then 15
    timed steps (steps/s, device ms, peak memory), their CUDA launches and
    idle share by ``torch.profiler``, and one step's device time by stage;
21. ``bench_train.py --e2e``: ``ContrastiveTrainer`` over 2,000 synthetic
    docs with augment pairs, 20 timed steps; its checkpoint restored bit
    for bit and resumed; stage 2's claim/evidence cosine from the trained
    state; then ProtoNCE at (4096, 6144, 8192) clusters over 10,000 docs,
    refreshed twice by k-means on the card, its centroids and densities
    checked;
22. served doc search under concurrent clients (``bench_serve.py``'s
    scenarios A and B, 2 s each): ``make_service`` at ``cli serve``'s defaults
    over the 50K-doc index, closed-loop one-query clients at 1, 8 and 64
    through ``RetrievalService.search``, ``BatchingService``, ``serve_http``
    and ``serve_native_http`` (keep-alive connections, each opened by an
    untimed request before the window); the judged ranker behind a
    ``BatchingService`` at 64 clients, with kernel #3 held to its plain
    version on the first served batch's inputs at ``k_max``; two-stage
    sentence search over phase 9's table at 64 clients through the native
    front. Every reply is held to the unbatched service's, a sample of the
    native front's and of the judged service's to scipy; the two fronts
    answer a fixed set of requests (400, 404 and 413 among them) alike; q/s,
    request p50/p95/p99, queries a device dispatch, the longest time without
    a reply and the cyclic collector's time for each scenario (the earlier
    phases' objects frozen out of the collector's walk);
23. the CLI chain on a 1,000-doc synthetic corpus, each command a fresh
    ``python -m ircl_tpu_torch.cli`` process on the card with a JSON config:
    ``prepare``, ``build-index``, ``train`` (``TrainConfig()``, 10 steps),
    ``retrieve --dense-ckpt``, ``train-verdict``, ``eval-verdict``,
    ``serve --stdin`` with all three stages and ``serve --native-front``
    stopped by SIGINT; recall, replies and evidence held to the port's API
    in this process, and each command's seconds;
24. the verdict model of phase 11 in bfloat16 (``bench_verdict.py``'s bf16
    cells, rounded where the reference rounds): the forward at B=32 on
    flash and "xla" beside the f32 forward on the same weights (the bf16
    logits must differ from the f32 ones, and within a bound; the flash
    kernels must receive f32 q, k and v), a cut batch's gradients and one
    step card against CPU, the freeze at B=8, and f32 and bf16 steps timed
    in turns;
25. the MoE verdict model (``MoEConfig()``: 8 experts, top-2, capacity
    factor 1.25, 160 slots an expert at L=512) on the same encoder, f32,
    flash: every layer's routes at B=8 (no expert over capacity, no pad
    dispatched, aux near 1 at init), one cut step card against CPU with
    the routes compared, a bf16 + MoE step, timed steps at B=8 and
    prediction at B=64 with peak memory;
26. data and corpus parallelism (``ircl_tpu_torch/parallel/``): (a) one
    NCCL rank in this process, at full size: ``ShardedEllIndex`` on phase
    4's 20,000 docs (1,024 claims) against the one-device ELL engine,
    ``ShardedHybridIndex`` on phase 5's 50K docs (4,096 claims, k=5)
    against the one-device ``hybrid_topk`` on the same split and against
    phase 5's scipy top-5 of every claim, ``sharded_cosine_topk`` on phase
    7's 1M x 128 corpus at B=1024 against its numpy gate, and
    ``make_dp_train_step`` at ``TrainConfig()`` bit for bit against
    ``make_train_step`` over 3 steps; (b) gloo ranks sharing the card (NCCL
    takes one rank a GPU; gloo takes the collectives on CUDA tensors, so
    every shard's kernels run on the card): the three sharded scorers on
    4 ranks, each holding a quarter, against the same gates and (a); then
    ``ContrastiveTrainer(mesh=)`` on 2 ranks, 10 steps over phase 21's
    corpus, against the one-device trainer (parameters 1e-5, logged losses
    rtol 1e-4, every rank's state bit-equal to rank 0's). Every rank
    reports its launches of #1 and #2 and fails if it loaded JAX; wall ms
    a batch of each engine at 1 and 4 ranks beside the one-device engine,
    and of the DP step at 1 and 2 ranks beside ``make_train_step``;
27. tensor and expert parallelism of the verdict model (phase 14's model,
    B=8, L=512, no freeze and no warmup, so every sharded body leaf moves):
    (a) one NCCL rank in this process on a (1, 1) ``("data", "model")``
    mesh, 3 steps of ``make_verdict_train_step(mesh=)`` bit-equal to the
    step without a mesh; (b) TP(2) on two gloo ranks sharing the card, each
    running the flash kernels on its 6 heads: 3 steps and one
    sequence-parallel step against the single-device step (losses rtol
    2e-5, each rank's shards rtol 5e-4 / atol 5e-6, ``tests/test_tp.py``'s
    gates), step 0's gradient slices within 1e-4 of each leaf's largest
    element, every rank's replicated leaves bit-equal; (c) EP(2) on phase
    25's MoE model (4 experts a rank), 2 steps and the aux held alike; (d)
    TP(2) x DP(2) on four ranks at 2 layers, 2 steps, then ``save_sharded``
    after step 1, ``restore_sharded`` onto a (4, 1) DP-only layout and
    step 2 from there, held to the uninterrupted run. Each rank counts its
    launches of #6a-#6c and fails if it loaded JAX; wall ms a step of each
    beside the single-device step, with the card's name and power limit.
28. pipeline and context parallelism of the verdict model (phase 14's model
    with the "xla" attention, which both refuse flash as the reference
    does; B=8, L=512, no freeze, no warmup): (a) one NCCL rank in this
    process, a (1, 1) ``("data", "stage")`` mesh for 2 GPipe steps of 4
    microbatches and a (1, 1) ``("data", "seq")`` mesh for one forward and
    2 steps; (b) PP(2) on two gloo ranks sharing the card, 6 layers a
    stage, and (c) CP(2), L_local = 256, the ring's blocks and gradients
    passed through the host (gloo), in the same launch; (d) PP(2) x DP(2)
    on four ranks at 2 layers, ``save_sharded`` after step 1,
    ``restore_sharded`` into a fresh layout, ``restack_pp_params`` onto one
    stage with every layer's bits, and step 2 from the restored state
    against the uninterrupted one. Each is held to the single-device step:
    step 0's gradient within 1e-4 of each leaf's largest element, losses
    rtol 1e-5, parameters rtol 5e-4 / atol 5e-6 apart from Adam's sign
    noise, and CP's logits to ``verdict_apply``'s (rtol 2e-5, atol 2e-6);
    wall ms a step of each, with the card's name and power limit.
29. the paper's measured experiments and the scale rehearsal through the
    port's tools (``ircl_tpu_torch/tools/``) at the scripts' widths and a
    cut depth: (a) ``eval_e2e`` (1,000 docs, 100 claims, 10 steps a trained
    variant) in this process, its ``doc_tfidf``, ``sparse`` and
    ``dense_untrained`` rows held to the same functions on the CPU: the
    card's stage-1 lists equal the CPU's but where an exact tie breaks
    otherwise (the card's top-k and the CPU's break them differently), and
    ``dense_untrained`` reruns on the card's doc lists with the untrained
    state and featurizer moved to the CPU (a stage-2 rank may move only
    among near-equal cosines, and the moves are logged); (b)
    ``similarity_ab`` (500 docs, 5 steps), its divergence counts against
    the CPU's; (c) ``verdict_table2`` (100 docs, 400 train claims, 1 epoch,
    1 restart, the phase-C replay), its retrievals equal to the CPU's up to
    exact ties, and on them every phase's encoded arrays and every dev
    variant's bit-equal to the CPU's, its retrieval recall equal, and its
    dev labels equal to ``predict_in_batches`` on the CPU with the trained
    parameters but where a logit margin is under 1e-5; (d)
    ``rehearsal_scale`` (2,000 docs, 200 claims, 2 shards, 5 train steps)
    in fresh processes started first, every one of them refusing JAX and
    the JAX package, its summary ``ok`` and its doc recall equal to the
    port's API in this process.
30. the graft entry points (``ircl_tpu_torch/graft_entry.py``) and the
    sharded-scale tool: (b) ``entry()`` on the card, its loss within 1e-5
    of the CPU's on the same arguments and its backward reaching
    ``params_q`` alone; (c) ``dryrun_multichip(8)`` on 8 gloo ranks sharing
    the card (NCCL takes one rank a card), every section's numbers finite in
    the reference's shapes; (a) ``tools/sharded_scale.py``'s ``main()`` at
    its defaults (40,000 docs, 64 queries, ``--ref scipy``) on 8 gloo ranks
    sharing the card, parity 64/64, its sharded top-k also 64/64 against
    ``--ref hybrid``'s one-device engine, and #2 on rank 0's shard bit for
    bit against its plain version. Every rank refuses JAX and the JAX
    package.
32. the grouped bf16 expert GEMM of the Moonlight-16B-A3B body (#9,
    ``csrc/moe_grouped_gemm.cu``) at its widths (64 experts, hidden 2,048,
    expert width 1,408): its registers, shared memory and spills as ptxas
    printed them (a spill fails the phase), then gate+up with the SwiGLU
    epilogue and down over 98,304 rows, 66,000 routed unevenly (three
    experts empty, one of 37 rows), each output within half a bf16 unit of the exact product plus
    2^-11 of its terms' magnitudes, under 1% of entries a rounding off the
    plain version, two launches bit-equal; times of the kernel, its plain
    version and ``torch._grouped_mm`` (the two products alone) where the
    card's PyTorch has it; then a 3-layer body at the published widths
    through ``VerdictClassifier.classify`` on 64 pairs.

Kernel launch counts are zeroed before phase 3 and read after phase 5 (the
sparse path), zeroed again before phase 7 and read after phase 9 (the
dense path), before phase 31 and read after it (the HuggingFace
checkpoint's path: #1 and #4 must run), before phase 11 and read after
phase 12 (the verdict path),
before phase 14 and read after phase 15 (the training path), inside phase
16 after its comparisons (the probes' paths) and before phase 17, read after
phase 19 (the scale path); every kernel must have run on its path, and
launches made to compare a kernel with its plain version are not counted.
No kernel lies on the contrastive training path: every count is zeroed
before phase 20 and must still be 0 after phase 21. They are zeroed again
before phase 22 (the serving path: #1, #2 and #3 must run) and phase 23's
commands count their own launches in their processes (#1 must run in
``retrieve`` and both ``serve`` commands). Before phase 24 and again before
phase 25 every count is zeroed; each of those phases must launch #6a, #6b
and #6c and nothing else. Before phase 26 every count is zeroed again: the
sharded scorers must launch #1 and #2 in this process and in every rank
(each rank counts its own and reports it), and nothing else. Before phase
27 every count is zeroed once more: #6a-#6c must run in (a)'s sharded steps
and in every rank of (b)-(d), and no other kernel anywhere in the phase.
Before phase 28 every count is zeroed again and must stay 0, in this
process and in every rank: its path runs no counted kernel.
Before phase 29 every count is zeroed again: (a)-(c) must launch #1 in this
process and nothing else, and (d)'s ``retrieve`` and ``serve`` processes
must launch #1 (each process of the chain writes its counts at exit).
Before phase 30 every count is zeroed again: every rank of (a) and of (c)
must launch #1 and #2 (each rank writes its counts at exit), and this
process nothing until (a)'s references and slab check. Phase 32 zeroes
#9's count after its comparisons: the 3-layer body's classify must launch it
twice a MoE layer and batch (8).
The script exits non-zero at the first
failure, and when no CUDA device is present. The line before the last is a
JSON object of the kernels' numbers, each with the least time the card could
take for the same work (``bound_ms``: its tensors moved once at 3.35 TB/s
against its operations at the card's published peak for their type); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_DOCS = 50_000
ELL_DOCS = 20_000
NUM_CLAIMS = 4096
HASH_SIZE = 1 << 24
K = 5
DEVICE = "cuda"
# bench_dense.py's configuration
DENSE_M, DENSE_D, DENSE_B = 1_000_000, 128, 1024
DENSE_TILE, DENSE_CHUNK = 8192, 32
DENSE_SCAN_BLOCK = 200_000  # divides M; the scan engine's corpus rows per step
CMAX_ATOL = 1e-6  # chunk maxima: unit cosines; bf16 products are exact in fp32,
# so only the order of the fp32 sums differs (the tensor cores' or the lanes')
# the encoder phases
ENC_DOCS = 5_000
ENC_BATCH = 256
ENC_SEED = 0  # the BiLSTM head's generator (the transformer uses its config's)
ENC_DEVICE_ATOL = 1e-4  # card against CPU: fp32 through 12 layers, TF32 off
HF_SENTENCES = 2_000  # phase 31: sentences embedded through the loaded checkpoint
HF_REPO = "smoke/bert-base-width"  # its name in phase 31's hub cache
HF_SEED = 31  # the pooler and pretraining heads the encoder drops
# the verdict phases: bench_verdict.py's roberta-base shape, cli serve's batch
VERDICT_L, VERDICT_BATCH, VERDICT_SEED = 512, 32, 3
VERDICT_ENCODER = dict(  # bench_verdict.py:83-97, f32, flash attention
    vocab_size=50265, hidden=768, layers=12, heads=12, intermediate=3072,
    max_positions=512, type_vocab=1, position_offset=2, layernorm_eps=1e-5,
    attention="flash",
)
VERDICT_PAIRS = 1024  # pairs through classify for pairs/s
FLASH_ATOL = 1e-5  # kernel against plain version: split-TF32 products (hi.hi +
# (lo.hi + hi.lo), lo.lo left out: 2^-22 of a product) and the fp32 summation order
VERDICT_DEVICE_ATOL = 1e-4  # logits, card against CPU and flash against xla
# the training phases: bench_verdict.py's train batch, a short warmup
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_LR, TRAIN_TIMED_STEPS = 8, 3, 1e-5, 20
TRAIN_GRAD_ATOL = 1e-5  # gradient leaves, flash against xla: fp32 through 12 layers
TRAIN_GRAD_RTOL = 1e-2  # and of each leaf's largest element
TRAINER_PAIRS, TRAINER_EPOCHS, PREDICT_BATCH = 256, 2, 64
# the contrastive training phases: bench_train.py's two shapes, TrainConfig()
CT_FEAT = dict(dim=768, max_len=64)  # HashEmbedFeaturizer: a 2^18 x 768 table
CT_TRAIN = {}  # TrainConfig's defaults: BiLSTM 3 x 256 bi over 768-d -> 128
CT_WARMUP, CT_TIMED_STEPS, CT_PROFILED_STEPS = 3, 15, 3  # 30 timed steps until PR 19
# bench_train.py --e2e times 200 steps; 20 here (30 until PR 19), for the script's
# time limit
CT_E2E_DOCS, CT_E2E_WARMUP, CT_E2E_STEPS, CT_E2E_CLAIMS = 2000, 10, 20, 256
CT_STAGED_STEPS = 10
# ProtoNCE's corpus: 10,000 docs (20,000 until the script's time limit cut it),
# above the largest granularity, 8192
CT_PROTO_DOCS, CT_PROTO_STEPS, CT_PROTO_EVERY, CT_PROTO_LOG = 10_000, 20, 10, 5
CT_RTOL = 1e-5  # loss and gradient norm, card against CPU: fp32, TF32 off
CT_QUEUE_ATOL = 1e-5  # the enqueued keys: unit vectors, card against CPU
CT_MOMENT_RTOL = (1e-4, 2e-4)  # mu, nu: of each leaf's largest element
# the scale phases: bench_scale.py's configuration
SCALE_DOCS, SCALE_TERMS, SCALE_VOCAB, SCALE_B = 1_000_000, 96, 2_000_000, 1024
SCALE_RANKER = dict(mode="hybrid", df_threshold=256, width_buckets=2,
                    precision="high", fixed_max_terms=24, d_tile=512)
SCALE_PARITY, SCALE_RAGGED, SCALE_SELECT, SCALE_CHUNK = 256, 32, 16, 500_000
FUSED_DOT_RTOL, FUSED_DOT_ATOL = 2e-5, 1e-5  # the probe's own bound
ONEPASS_RTOL = 1e-5  # against the slab GEMM: another summation order
# the serving phase: bench_serve.py's scenarios A and B through the port's fronts
SERVE_QUERIES, SERVE_SENT_QUERIES, SERVE_SAMPLE = 512, 64, 256
SERVE_CLIENTS = (1, 8, 64)
SERVE_SECONDS = 1.0  # bench_serve.py runs 8 s a scenario; cut to 1 for the time limit
SERVE_WAIT_MS, SERVE_WORKERS = 5.0, 2
SENT_RTOL = 1e-5  # a claim's embedding in another batch: fp32 sums in another order
# the CLI phase: a synthetic corpus through every command, each in a fresh process
CLI_DOCS, CLI_CLAIMS, CLI_TRAIN_STEPS, CLI_TIMEOUT = 1000, 200, 10, 600
# the experiment tools' phase: the scripts' widths, their depth cut
TOOLS_EVAL = ["--docs", "1000", "--claims", "100", "--steps", "10", "--skip-stem-ab",
              "--skip-proto"]
TOOLS_AB = ["--docs", "500", "--claims", "60", "--steps", "5"]
TOOLS_TABLE2 = ["--docs", "100", "--train-claims", "400", "--dev-claims", "100",
                "--epochs", "1", "--restarts", "1"]
TOOLS_REHEARSAL = ["--docs", "2000", "--claims", "200", "--shards", "2",
                   "--train-steps", "5"]
TOOLS_TIE_ATOL = 1e-5  # a stage-2 sentence may change rank, card against CPU, only
# among cosines this close (fp32 through the BiLSTM, sums in another order)
TOOLS_MARGIN = 1e-5  # a dev label may differ, card against CPU, only below this margin
TOOLS_SCORE_RTOL = 1e-5  # tf-idf scores, card against CPU: fp32 sums in another order
TOOLS_TIMEOUT = 900
# the bf16 and MoE verdict phases: bench_verdict.py's --dtypes bf16 and --moe-experts
BF16_QUARTER = 0.25  # tests/test_torch_bf16.py's bound, of the bf16-against-f32 distance
BF16_SHIFT_MIN, BF16_SHIFT_MAX = 1e-5, 0.05  # bf16 logits from the f32 ones (rel. L2):
# above fp32 noise, and at most a few bf16 roundings (2^-9) compounded
BF16_TIMED_STEPS, MOE_TIMED_STEPS = 10, 10
ROUTE_MARGIN = 1e-5  # a route may move only where its top-k gap is a near-tie
MOE_AUX_INIT = (1.0, 2.0)  # Switch's aux at init: 1 balanced, E (8) collapsed; a
# random router over a random encoder's alike tokens is unbalanced (1.46 at B=8 on
# a 2,000-doc vocabulary on an H100 80GB HBM3 at 700 W), far from collapse
F32_REL_NOISE = 1e-5  # relative L2, card against CPU, of what runs in f32 alone
BF16_LOSS_ATOL = 1e-3  # one bf16 step, card against CPU: the roundings that f32
# noise tips compound over 12 layers (hidden states ~1e-3 apart; blocks are held
# one by one to BF16_QUARTER)
# published peaks of one H100 SXM (NVIDIA's data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores; one FMA is two
BF16_FLOPS = 989e12  # tensor cores, dense
TF32_FLOPS = 495e12  # tensor cores, dense; an f32-accurate product is three passes


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def least_time(tensors, operations, rate):
    """``bound_ms`` and ``bound_by`` of one kernel call: the larger of its
    tensors moved once at the card's memory rate and its operations at the
    card's peak ``rate`` for their type."""
    moved = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes, t_ops = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * operations / rate
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def scipy_topk(mat, buckets, weights, k):
    """Per query: (scipy's top-k positive scores, descending; dense row)."""
    from ircl_tpu_torch.index.build import scipy_query_scores

    dense = scipy_query_scores(mat, buckets, weights, HASH_SIZE)
    out = []
    for row in dense:
        top = np.sort(row[row > 0])[::-1][:k]
        out.append((top, row))
    return out


def check_replies(replies, requests, index, label, max_terms=24):
    """Every doc-search reply against scipy: the same number of hits, the
    sorted scores within rtol 1e-4, and each doc carrying its own score.
    Queries keep ``max_terms`` terms, as the service's ranker does."""
    from ircl_tpu_torch.index.build import to_scipy
    from ircl_tpu_torch.index.ranker import vectorize_queries

    mat = to_scipy(index)
    doc2idx = index.doc2idx
    checked = 0
    for req, rep in zip(requests, replies):
        if req is None:  # a malformed line
            if "error" not in rep:
                fail(f"{label}: malformed line answered without an error: {rep}")
            continue
        if "results" not in rep:
            fail(f"{label}: request failed: {rep}")
        queries, k = req
        b, w = vectorize_queries(
            queries, HASH_SIZE, 2, index.doc_freqs, index.num_docs, max_terms=max_terms
        )
        refs = scipy_topk(mat, b, w, k)
        if len(rep["results"]) != len(queries):
            fail(f"{label}: {len(rep['results'])} results for {len(queries)} queries")
        for hits, (top, dense) in zip(rep["results"], refs):
            got = np.array([h["score"] for h in hits], np.float32)
            if len(got) != len(top) or not np.allclose(
                np.sort(got)[::-1], top, rtol=1e-4
            ):
                fail(f"{label}: scores {got} != scipy {top}")
            own = np.array([dense[doc2idx[h["doc_id"]]] for h in hits])
            if not np.allclose(got, own, rtol=1e-4):
                fail(f"{label}: returned docs do not carry their own scores")
            checked += 1
    return checked


def _topk_ref_blocked(queries, corpus, k, block=125_000):
    """Exact numpy f32 top-k over the full query batch, corpus-blocked so
    the score matrix transient stays ~0.5GB. Returns (sorted scores [B,k],
    list of B id sets). Copied from ``bench_dense.py``, which imports JAX."""
    B = queries.shape[0]
    m = corpus.shape[0]
    best_s = np.full((B, k), -np.inf, np.float32)
    best_i = np.full((B, k), -1, np.int64)
    for lo in range(0, m, block):
        s = queries @ corpus[lo : lo + block].T  # [B, <=block]
        part = np.argpartition(-s, k - 1, axis=1)[:, :k]
        ps = np.take_along_axis(s, part, axis=1)
        cat_s = np.concatenate([best_s, ps], axis=1)
        cat_i = np.concatenate([best_i, part + lo], axis=1)
        sel = np.argpartition(-cat_s, k - 1, axis=1)[:, :k]
        best_s = np.take_along_axis(cat_s, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    order = np.argsort(-best_s, axis=1, kind="stable")
    best_s = np.take_along_axis(best_s, order, axis=1)
    best_i = np.take_along_axis(best_i, order, axis=1)
    return best_s, [set(row.tolist()) for row in best_i]


def unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def same_topk(s1, i1, s2, i2, rtol):
    """Scores within rtol; ids equal except where the scores tie."""
    import torch

    if not torch.allclose(s1, s2, rtol=rtol, atol=0.0):
        return False
    return bool(((i1 == i2) | (s1 == s2)).all())


def phase6_dense_kernel(dev, q_d, ct_d, rows_d, m_real, results):
    """Kernel #4 against its plain version, at the bench shape and on a small
    ragged shape. Chunk maxima within CMAX_ATOL (with the same -inf pads);
    the final top-k of both phase 1s equal, ids up to exact ties."""
    import torch

    from ircl_tpu_torch.ops.dense_topk_cuda import (
        _mode, chunk_max, chunk_max_ref, chunk_max_route, pad_corpus_t, select_rescore,
    )

    rng = np.random.default_rng(6)
    sq = torch.tensor(unit_rows(rng, 37, DENSE_D), device=dev)
    s_ct, s_m = pad_corpus_t(torch.tensor(unit_rows(rng, 5000, DENSE_D), device=dev),
                             1024)  # 5000 real columns of 5120
    s_rows = s_ct.T.contiguous()
    shapes = {
        "bench": (q_d, ct_d, rows_d, m_real, DENSE_TILE),
        "ragged": (sq, s_ct, s_rows, s_m, 1024),
    }
    configs = [  # (label, precision, epilogue, extra_chunks, bf16 corpus)
        ("fold/high3", "high3", "fold", 0, False),
        ("loop/high3", "high3", "loop", 0, False),
        ("loop/highest", "highest", "loop", 0, False),
        ("bf16 corpus/extra 2", "default", "fold", 2, True),
    ]
    routes = {"mma": 0, "simt": 0}
    for shape, (q, ct, rows, m, tile) in shapes.items():
        for label, prec, epi, extra, bf16 in configs:
            c = ct.to(torch.bfloat16) if bf16 else ct
            args = (q, c, DENSE_CHUNK, tile, m, prec, epi)
            route = chunk_max_route(_mode(prec, c.dtype), q.shape[1], DENSE_CHUNK, tile,
                                    epi)
            before = chunk_max.launches_by_route[route]
            got = chunk_max(*args)
            if chunk_max.launches_by_route[route] != before + 1:
                fail(f"phase 6: {shape} {label} did not launch the {route} kernel")
            routes[route] += 1
            ref = chunk_max_ref(*args)
            torch.cuda.synchronize()
            fin = torch.isfinite(ref)
            if not torch.equal(torch.isfinite(got), fin):
                fail(f"phase 6: {shape} {label}: the -inf pads differ")
            err = float((got[fin] - ref[fin]).abs().max())
            if err > CMAX_ATOL:
                fail(f"phase 6: {shape} {label}: chunk maxima differ by {err}")
            s1, i1 = select_rescore(q, c, got, K, DENSE_CHUNK, tile, m, extra,
                                    epi, rows)
            s2, i2 = select_rescore(q, c, ref, K, DENSE_CHUNK, tile, m, extra,
                                    epi, rows)
            if not same_topk(s1, i1, s2, i2, 1e-6):
                fail(f"phase 6: {shape} {label}: top-{K} differs from the plain path")
            t_k = cuda_ms(lambda: chunk_max(*args))
            t_p = cuda_ms(lambda: chunk_max_ref(*args), reps=2)
            log(f"phase 6: {shape} B={q.shape[0]} M_pad={c.shape[1]} "
                f"(m_real {m}) {label}, {route} kernel: chunk maxima within {err:.3g} "
                f"(bound {CMAX_ATOL}), top-{K} equal ({int((i1 != i2).sum())} ids "
                f"differ, all at ties); kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
            if shape == "bench" and label == "fold/high3":
                # high3 is three products of bf16 halves summed in f32:
                # the tensor cores' bf16 rate is the card's peak for them
                results["cosine_topk_fused"] = dict(
                    max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=None,
                    **least_time((q, c, got), 3 * 2 * q.shape[0] * q.shape[1] * m,
                                 BF16_FLOPS),
                )
            if shape == "bench" and label == "loop/highest":
                results["cosine_topk_fused"]["simt_loop_highest_ms"] = t_k
            results["cosine_topk_fused"]["max_abs_err"] = max(
                results["cosine_topk_fused"]["max_abs_err"], err)
            del got, ref
    if not all(routes.values()):
        fail(f"phase 6: a route of the chunk-max kernels was not exercised: {routes}")
    log(f"phase 6: calls by route {routes}")


def timed_qps(fn, batch, reps=10):
    """Queries per second of ``fn`` by the host clock around synchronized
    runs (one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return batch * reps / (time.perf_counter() - t0)


def phase7_dense_bench(dev, queries, corpus, q_d, ct_d, rows_d, m_real):
    """bench_dense.py on the port: the engines, the full-batch numpy gate on
    the fused one, q/s."""
    import torch

    from ircl_tpu_torch.dense.scorer import cosine_topk_scan, cosine_topk_twophase
    from ircl_tpu_torch.ops.dense_topk_cuda import cosine_topk_fused

    corpus_d = torch.tensor(corpus, device=dev)
    fused = lambda prec: lambda: cosine_topk_fused(  # noqa: E731
        q_d, ct_d, k=K, chunk=DENSE_CHUNK, m_tile=DENSE_TILE, m_real=m_real,
        epilogue="fold", precision=prec, corpus_rows=rows_d,
    )
    engines = {
        "fused_fold_high3": fused("high3"),
        "twophase_highest": lambda: cosine_topk_twophase(
            q_d, corpus_d, k=K, chunk=128, precision="highest"),
        "scan_highest": lambda: cosine_topk_scan(
            q_d, corpus_d, k=K, chunk=64, block=DENSE_SCAN_BLOCK, precision="highest"),
        "fused_fold_None (informational)": fused(None),
    }
    t0 = time.perf_counter()
    ref_s, ref_sets = _topk_ref_blocked(queries, corpus, K)
    log(f"phase 7: full-batch numpy f32 reference (bench_dense.py's) in "
        f"{time.perf_counter() - t0:.1f} s on the host")
    torch.cuda.reset_peak_memory_stats()
    for name, fn in engines.items():
        s, i = (x.cpu().numpy() for x in fn())
        bad_s = sum(
            not np.allclose(s[b], ref_s[b], rtol=1e-5) for b in range(DENSE_B)
        )
        bad_i = sum(set(i[b].tolist()) != ref_sets[b] for b in range(DENSE_B))
        qps = timed_qps(fn, DENSE_B)
        log(f"phase 7: {name}: full-batch score parity {DENSE_B - bad_s}/"
            f"{DENSE_B} (rtol 1e-5; id-set tie swaps {bad_i}); {qps:.1f} q/s")
        if name == "fused_fold_high3" and bad_s:
            fail(f"phase 7: the fused engine failed the full-batch gate on "
                 f"{bad_s} queries")
    log(f"phase 7: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB (engines and data)")
    del corpus_d
    return ref_s, ref_sets


def phase8_encoder(dev, wiki, doc_ids):
    """The encoder at full width: the card against the CPU on 16 sentences,
    a row alone against the same row in a full batch, then every sentence
    of the docs embedded."""
    import torch

    from ircl_tpu_torch.contrastive.state import TrainConfig, init_train_state
    from ircl_tpu_torch.contrastive.train import make_embed_fn
    from ircl_tpu_torch.dense.embed import embed_corpus
    from ircl_tpu_torch.models.featurizer import FeaturizerConfig, TransformerFeaturizer
    from ircl_tpu_torch.models.wordpiece import WordPieceTokenizer
    from ircl_tpu_torch.utils.convert import to_device

    t0 = time.perf_counter()
    fcfg = FeaturizerConfig(kind="transformer")
    tok = WordPieceTokenizer.train(
        [wiki.docs[d]["text"] for d in doc_ids], vocab_size=fcfg.wp_vocab
    )
    feat = TransformerFeaturizer.random_init(tok, fcfg, device=dev)
    tcfg = TrainConfig()
    state = init_train_state(ENC_SEED, tcfg, device=dev)  # its encoder drawn first
    params = state.params_q
    embed_fn = make_embed_fn(tcfg, feat)
    n_tf = sum(t.numel() for t in _leaves(feat.params))
    n_enc = sum(t.numel() for t in _leaves(params))
    log(f"phase 8: vocab {tok.vocab_size}, transformer {feat.tcfg.layers} x "
        f"{feat.tcfg.hidden} ({n_tf / 1e6:.1f}M params), BiLSTM "
        f"{tcfg.encoder.num_layers} x {tcfg.encoder.hidden_size} -> "
        f"{tcfg.encoder.output_size} ({n_enc / 1e6:.2f}M); built in "
        f"{time.perf_counter() - t0:.1f} s")
    doc_sentences = {d: wiki.sentences[d] for d in doc_ids}
    sents = [s for d in doc_ids for s in doc_sentences[d] if s]

    # the card against the CPU, same weights
    feat_cpu = TransformerFeaturizer(tok, feat.tcfg, to_device(feat.params, "cpu"),
                                     fcfg, device="cpu")
    ids, mask = feat.encode_host(sents[:16])
    e_dev = embed_fn(params, ids, mask).cpu()
    e_cpu = make_embed_fn(tcfg, feat_cpu)(to_device(params, "cpu"), ids, mask)
    err = float((e_dev - e_cpu).abs().max())
    if err > ENC_DEVICE_ATOL:
        fail(f"phase 8: the card and the CPU differ by {err}")
    log(f"phase 8: 16 sentences on the card and on the CPU agree within "
        f"{err:.3g} (bound {ENC_DEVICE_ATOL})")
    del feat_cpu

    # rows do not depend on their batch position or the padding
    batch = sents[:ENC_BATCH]
    inside = embed_corpus(embed_fn, params, feat, batch, ENC_BATCH)[37]
    alone = embed_corpus(embed_fn, params, feat, [batch[37]], ENC_BATCH)[0]
    moved = embed_corpus(embed_fn, params, feat, [batch[37]] + batch[:-1],
                         ENC_BATCH)[0]
    d_alone = float(np.abs(inside - alone).max())
    d_moved = float(np.abs(inside - moved).max())
    if max(d_alone, d_moved) > 1e-6:
        fail(f"phase 8: a row depends on its batch ({d_alone}, {d_moved})")
    log(f"phase 8: row 37 alone ({ENC_BATCH - 1} pad rows) differs by {d_alone:.3g}, at "
        f"position 0 of a full batch by {d_moved:.3g}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = embed_corpus(embed_fn, params, feat, sents, ENC_BATCH)
    dt = time.perf_counter() - t0
    norms = np.linalg.norm(table, axis=1)
    if table.shape != (len(sents), tcfg.encoder.output_size):
        fail(f"phase 8: table shape {table.shape}")
    if not np.isfinite(table).all() or not np.allclose(norms, 1.0, atol=1e-5):
        fail("phase 8: sentence embeddings are not finite unit rows")
    log(f"phase 8: embedded {len(sents)} sentences of {len(doc_ids)} docs at "
        f"batch {ENC_BATCH} in {dt:.2f} s: {len(sents) / dt:.1f} sentences/s "
        f"(host tokenization included); all finite, unit norm within 1e-5")
    return tcfg, feat, state, doc_sentences, table


def _leaves(tree):
    return [leaf for _, leaf in named_leaves(tree)]


def same_keys_up_to_ties(a, b, atol=1e-6):
    """Two score-desc hit lists with the same (doc_id, sent_id) sequence,
    except where the scores of the differing places tie within atol."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        same = (x["doc_id"], x["sent_id"]) == (y["doc_id"], y["sent_id"])
        if not same and abs(x["score"] - y["score"]) > atol:
            return False
    return True


def phase9_sentence_search(dev, store, wiki, claims, doc_ids, tcfg, feat, state,
                           doc_sentences, table, tmpdir):
    """Served sentence search over the encoder docs, each reply checked; then
    the dense top-k over the sentence table against numpy."""
    from ircl_tpu_torch.index.build import build_count_index
    from ircl_tpu_torch.index.tfidf import tfidf_transform
    from ircl_tpu_torch.pipeline.dense_scorer import (
        ContrastiveSentenceScorer, PrecomputedSentenceScorer,
    )
    from ircl_tpu_torch.serve import make_service

    index = tfidf_transform(build_count_index(
        store, ngram=2, hash_size=HASH_SIZE, doc_ids=doc_ids
    ))
    path = os.path.join(tmpdir, "index_sentences.npz")
    index.save(path)
    fly = ContrastiveSentenceScorer(tcfg, feat, state, batch_size=ENC_BATCH)
    pre = PrecomputedSentenceScorer(fly.embed, doc_sentences, table=table)
    svc = make_service(path, device=dev, doc_sentences=doc_sentences,
                       sentence_scorer=pre)
    svc.warmup()
    own = set(doc_ids)
    mine = [c.claim for c in wiki.claims if set(c.evidences) & own]
    if len(mine) < 111:
        fail(f"phase 9: {len(mine)} claims have evidence in these docs; 111 needed")
    log(f"phase 9: index of {index.num_docs} docs, {table.shape[0]} table rows; "
        f"{len(mine)} of the claims have evidence in these docs")
    requests = [
        ([mine[0]], 5, 5),
        (mine[1:101], 5, 3),
        (mine[101:111], 2, 7),
        None,
    ]
    lines = [
        json.dumps({"query": mine[0], "sentences": True}),
        json.dumps({"queries": mine[1:101], "k_sents": 3}),
        json.dumps({"queries": mine[101:111], "k": 2, "k_sents": 7}),
        json.dumps({"queries": [mine[0]], "k_sents": -1}),
    ]
    t0 = time.perf_counter()
    served, replies = serve_lines(svc, lines)
    log(f"phase 9: served {served} sentence requests in "
        f"{time.perf_counter() - t0:.2f} s; metrics {svc.metrics.snapshot()}")
    checked = check_sentence_replies("phase 9", svc, fly, requests, replies, index,
                                     table, doc_sentences)
    log(f"phase 9: {checked} sentence results checked: docs against scipy "
        f"(rtol 1e-4), every score the table row's dot with the claim (rtol "
        f"1e-5), the top k_sents of the candidates, and the same (doc, sent) "
        f"lists from the on-the-fly scorer; the malformed line got an error")
    dense_table_topk("phase 9", dev, fly.embed(claims[:DENSE_B]), table)
    return path, pre, mine


def check_sentence_replies(label, svc, fly, requests, replies, index, table,
                           doc_sentences):
    """Each sentence-search reply: its docs against scipy, every score the
    table row's dot with the claim's embedding, the top ``k_sents`` of the
    candidates, and the same (doc, sent) lists as the on-the-fly scorer
    ``fly`` gives; a malformed line must get an error. Returns the number
    of results checked."""
    from ircl_tpu_torch.pipeline.retrieve import gather_candidates
    from ircl_tpu_torch.serve import RetrievalService

    row_of = {}
    for d, sents in doc_sentences.items():
        for si, sent in enumerate(sents):
            if sent:
                row_of[(d, si)] = len(row_of)
    svc_fly = RetrievalService(svc.ranker, batch_size=svc.batch_size,
                               doc_sentences=doc_sentences, sentence_scorer=fly)
    checked = 0
    for req, rep in zip(requests, replies):
        if req is None:
            if "error" not in rep:
                fail(f"{label}: malformed line answered without an error: {rep}")
            continue
        if "results" not in rep:
            fail(f"{label}: request failed: {rep}")
        queries, k, k_sents = req
        docs = svc.search(queries, k=k)
        check_replies([{"results": docs}], [(queries, k)], index, f"{label} docs")
        doc_lists = [[h["doc_id"] for h in hits] for hits in docs]
        _, cand_keys = gather_candidates(doc_lists, doc_sentences)
        claim_emb = fly.embed(queries)
        for q, hits in enumerate(rep["results"]):
            rows = table[[row_of[key] for key in cand_keys[q]]]
            all_scores = np.sort(rows @ claim_emb[q])[::-1][:k_sents]
            got = np.array([h["score"] for h in hits], np.float32)
            if len(got) != len(all_scores) or not np.allclose(got, all_scores,
                                                              rtol=1e-5):
                fail(f"{label}: sentences are not the top {k_sents} of their "
                     f"candidates: {got} != {all_scores}")
            for h in hits:
                if h["doc_id"] not in doc_lists[q]:
                    fail(f"{label}: {h['doc_id']} is not among the top {k} docs")
                want = float(table[row_of[(h["doc_id"], h["sent_id"])]] @ claim_emb[q])
                if not np.isclose(h["score"], want, rtol=1e-5, atol=0.0):
                    fail(f"{label}: score {h['score']} != table dot {want}")
                if h["sentence"] != doc_sentences[h["doc_id"]][h["sent_id"]]:
                    fail(f"{label}: a reply names the wrong sentence")
            checked += 1
        on_the_fly = svc_fly.search_sentences(queries, k=k, k_sents=k_sents)
        for a, b in zip(rep["results"], on_the_fly):
            if not same_keys_up_to_ties(a, b):
                fail(f"{label}: the precomputed and on-the-fly services differ")
    return checked


def dense_table_topk(label, dev, q_emb, table):
    """The dense top-K of the claims' embeddings ``q_emb`` over a sentence
    table through ``cosine_topk_fused`` (fold/high3), against numpy."""
    import torch

    from ircl_tpu_torch.ops.dense_topk_cuda import chunk_max, cosine_topk_fused, pad_corpus_t

    before = chunk_max.launches
    tab_d = torch.tensor(table, device=dev)
    ct, m = pad_corpus_t(tab_d, DENSE_TILE)
    rows = ct.T.contiguous()
    s, i = cosine_topk_fused(
        torch.tensor(q_emb, device=dev), ct, k=K, chunk=DENSE_CHUNK,
        m_tile=DENSE_TILE, m_real=m, epilogue="fold", precision="high3",
        corpus_rows=rows,
    )
    if chunk_max.launches == before:
        fail(f"{label}: the dense top-k did not launch the chunk-max kernel")
    ref = q_emb @ table.T
    ref_s = -np.sort(-ref, axis=1)[:, :K]
    s, i = s.cpu().numpy(), i.cpu().numpy()
    # the table repeats some sentences, so equal rows tie: every returned id
    # must carry its own numpy score, and the scores be numpy's top-K
    own = np.take_along_axis(ref, i.astype(np.int64), axis=1)
    bad = (~np.isclose(s, ref_s, rtol=1e-5, atol=0.0)).any(axis=1) | (
        ~np.isclose(own, s, rtol=1e-5, atol=0.0)).any(axis=1)
    if bad.any() or i.max() >= m or any(len(set(r)) < K for r in i):
        fail(f"{label}: dense top-{K} over the sentence table differs from "
             f"numpy on {int(bad.sum())} claims")
    log(f"{label}: dense top-{K} of {len(q_emb)} claims over {m} sentence rows "
        f"(fold/high3) equals numpy's exact top-{K} (rtol 1e-5; distinct ids, "
        f"each carrying its own score)")



def write_safetensors(path, tensors):
    """``tensors`` in the safetensors format (a little-endian u64 header
    length, a JSON header padded to 8 bytes, the raw data), written here:
    the card's machine has no ``safetensors`` package."""
    import struct

    import torch

    names = {torch.float32: "F32", torch.int64: "I64"}
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        size = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().numpy().tobytes())


def bert_checkpoint(params, tcfg):
    """Phase 8's transformer as the original ``bert-base-uncased`` files
    name it (``BertForPreTraining``: the ``bert.`` prefix, LayerNorm
    ``gamma``/``beta``, dense weights ``[out, in]``), with the pooler and
    pretraining heads, which the encoder drops, drawn from ``HF_SEED``."""
    import torch

    from ircl_tpu_torch.utils.convert import to_device

    p = to_device(params, "cpu")
    sd = {}

    def dense(name, tree):
        sd[name + ".weight"] = tree["w"].T.contiguous()
        sd[name + ".bias"] = tree["b"]

    def ln(name, tree):
        sd[name + ".gamma"] = tree["scale"]
        sd[name + ".beta"] = tree["bias"]

    sd["bert.embeddings.word_embeddings.weight"] = p["tok_emb"]
    sd["bert.embeddings.position_embeddings.weight"] = p["pos_emb"]
    sd["bert.embeddings.token_type_embeddings.weight"] = p["type_emb"]
    sd["bert.embeddings.position_ids"] = torch.arange(tcfg.max_positions)[None]
    ln("bert.embeddings.LayerNorm", p["emb_ln"])
    for i, lp in enumerate(p["layers"]):
        b = f"bert.encoder.layer.{i}."
        dense(b + "attention.self.query", lp["q"])
        dense(b + "attention.self.key", lp["k"])
        dense(b + "attention.self.value", lp["v"])
        dense(b + "attention.output.dense", lp["o"])
        ln(b + "attention.output.LayerNorm", lp["attn_ln"])
        dense(b + "intermediate.dense", lp["ff1"])
        dense(b + "output.dense", lp["ff2"])
        ln(b + "output.LayerNorm", lp["ff_ln"])
    gen = torch.Generator().manual_seed(HF_SEED)
    h = tcfg.hidden
    for name, shape in (("bert.pooler.dense.weight", (h, h)), ("bert.pooler.dense.bias", (h,)),
                        ("cls.predictions.transform.dense.weight", (h, h)),
                        ("cls.predictions.transform.dense.bias", (h,)),
                        ("cls.predictions.transform.LayerNorm.gamma", (h,)),
                        ("cls.predictions.transform.LayerNorm.beta", (h,)),
                        ("cls.predictions.bias", (tcfg.vocab_size,)),
                        ("cls.seq_relationship.weight", (2, h)),
                        ("cls.seq_relationship.bias", (2,))):
        sd[name] = torch.randn(shape, generator=gen) * 0.02
    return sd


def write_hf_checkpoints(root, feat):
    """Phase 8's featurizer as a BERT checkpoint directory in three forms:
    ``pytorch_model.bin``, ``model.safetensors``, and the latter in a hub
    cache under ``HF_REPO`` (snapshot files linked, as the hub links its
    blobs). Returns the two directories and the cache's root."""
    import torch

    tcfg = feat.tcfg
    config = {
        "architectures": ["BertForPreTraining"], "model_type": "bert",
        "vocab_size": tcfg.vocab_size, "hidden_size": tcfg.hidden,
        "num_hidden_layers": tcfg.layers, "num_attention_heads": tcfg.heads,
        "intermediate_size": tcfg.intermediate, "hidden_act": "gelu",
        "max_position_embeddings": tcfg.max_positions,
        "type_vocab_size": tcfg.type_vocab, "layer_norm_eps": tcfg.layernorm_eps,
        "pad_token_id": 0,
    }
    sd = bert_checkpoint(feat.params, tcfg)
    dirs = {}
    for form in ("bin", "safetensors"):
        d = os.path.join(root, form)
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config, f)
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True}, f)
        feat.tokenizer.save_vocab(os.path.join(d, "vocab.txt"))
        if form == "bin":
            torch.save(sd, os.path.join(d, "pytorch_model.bin"))
        else:
            write_safetensors(os.path.join(d, "model.safetensors"), sd)
        dirs[form] = d
    cache = os.path.join(root, "hub")
    repo = os.path.join(cache, "models--" + HF_REPO.replace("/", "--"))
    snapshot = os.path.join(repo, "snapshots", "0" * 40)
    os.makedirs(snapshot)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write("0" * 40)
    for name in os.listdir(dirs["safetensors"]):
        os.symlink(os.path.join(dirs["safetensors"], name), os.path.join(snapshot, name))
    return dirs["bin"], dirs["safetensors"], cache


def phase31_hf_checkpoint(dev, wiki, claims, doc_ids, train_cfg, feat, state,
                          doc_sentences, index_path, mine, tmpdir):
    """Phase 8's featurizer written as a HuggingFace checkpoint, loaded back
    in each form and held to it, then served: ``HF_SENTENCES`` sentences
    embedded through it, 4 request lines over phase 9's index, and the dense
    top-k over the new table."""
    import torch

    from ircl_tpu_torch.index.build import CountIndex
    from ircl_tpu_torch.models.featurizer import FeaturizerConfig, TransformerFeaturizer
    from ircl_tpu_torch.pipeline.dense_scorer import (
        ContrastiveSentenceScorer, PrecomputedSentenceScorer,
    )
    from ircl_tpu_torch.serve import make_service
    from ircl_tpu_torch.utils.convert import to_device

    root = os.path.join(tmpdir, "hf")
    t0 = time.perf_counter()
    bin_dir, st_dir, cache = write_hf_checkpoints(root, feat)
    sizes = {os.path.basename(os.path.dirname(f)): os.path.getsize(f) / 2**20 for f in (
        os.path.join(bin_dir, "pytorch_model.bin"), os.path.join(st_dir, "model.safetensors"))}
    log(f"phase 31: checkpoint written in {time.perf_counter() - t0:.2f} s: "
        f"pytorch_model.bin {sizes['bin']:.1f} MiB, model.safetensors "
        f"{sizes['safetensors']:.1f} MiB, and {HF_REPO} in a hub cache")

    sents = [s for d in doc_ids for s in doc_sentences[d] if s]
    ids, mask = feat.encode_host(sents[:16])
    want = feat.features(ids, mask)
    want_leaves = dict(named_leaves(feat.params))
    fcfg = FeaturizerConfig(kind="hf", max_len=feat.config.max_len)
    load_s = {}
    loaded = None
    for form, name in (("bin", bin_dir), ("safetensors", st_dir), ("hub cache", HF_REPO)):
        before = os.environ.get("HF_HUB_CACHE")
        os.environ["HF_HUB_CACHE"] = cache
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded = TransformerFeaturizer.from_huggingface(name, fcfg, device=dev)
            torch.cuda.synchronize()
            load_s[form] = time.perf_counter() - t0
        finally:
            if before is None:
                del os.environ["HF_HUB_CACHE"]
            else:
                os.environ["HF_HUB_CACHE"] = before
        if loaded.tcfg != feat.tcfg:
            fail(f"phase 31 ({form}): config {loaded.tcfg} != phase 8's {feat.tcfg}")
        got_leaves = dict(named_leaves(loaded.params))
        if got_leaves.keys() != want_leaves.keys():
            fail(f"phase 31 ({form}): the parameter tree differs from phase 8's")
        unequal = [n for n, w in want_leaves.items()
                   if got_leaves[n].device != w.device or not torch.equal(got_leaves[n], w)]
        if unequal:
            fail(f"phase 31 ({form}): parameters not bit-equal to phase 8's: {unequal[:5]}")
        if not torch.equal(loaded.features(ids, mask), want):
            fail(f"phase 31 ({form}): features of 16 sentences differ from phase 8's")
        if form != "hub cache":
            del loaded
    log(f"phase 31: loaded onto the card in "
        + ", ".join(f"{form} {s:.2f} s" for form, s in load_s.items())
        + f": config equal to phase 8's, all {len(want_leaves)} parameters and the "
        f"features of 16 sentences bit-equal")

    # the card against the CPU, on the new tokenizer's ids
    cpu = TransformerFeaturizer(loaded.tokenizer, loaded.tcfg,
                                to_device(loaded.params, "cpu"), loaded.config, device="cpu")
    ids, mask = loaded.encode_host(sents[:16])
    err = float((loaded.features(ids, mask).cpu() - cpu.features(ids, mask)).abs().max())
    if not err <= ENC_DEVICE_ATOL:
        fail(f"phase 31: the card and the CPU differ by {err}")
    del cpu

    # host tokenization, the port's BERT tokenizer beside phase 8's WordPiece
    batch = sents[:ENC_BATCH]
    tok_ms = {}
    for label, f in (("BERT", loaded), ("WordPiece", feat)):
        t0 = time.perf_counter()
        for _ in range(3):
            f.encode_host(batch)
        tok_ms[label] = 1e3 * (time.perf_counter() - t0) / 3
    same = int((loaded.encode_host(batch)[0] == feat.encode_host(batch)[0]).all(axis=1).sum())
    log(f"phase 31: card against CPU within {err:.3g} (bound {ENC_DEVICE_ATOL}); host "
        f"tokenization of {len(batch)} sentences: BERT {tok_ms['BERT']:.1f} ms, phase "
        f"8's WordPiece {tok_ms['WordPiece']:.1f} ms ({same} of {len(batch)} rows equal)")

    # about HF_SENTENCES sentences of the first docs, embedded through it
    sub, n = {}, 0
    for d in doc_ids:
        if n >= HF_SENTENCES:
            break
        sub[d] = doc_sentences[d]
        n += sum(1 for s in sub[d] if s)
    fly = ContrastiveSentenceScorer(train_cfg, loaded, state, batch_size=ENC_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = PrecomputedSentenceScorer(fly.embed, sub)
    dt = time.perf_counter() - t0
    table = pre.table
    if table.shape != (n, train_cfg.encoder.output_size):
        fail(f"phase 31: table shape {table.shape}")
    if not np.isfinite(table).all() or not np.allclose(np.linalg.norm(table, axis=1), 1.0,
                                                       atol=1e-5):
        fail("phase 31: sentence embeddings are not finite unit rows")
    sents_per_s = n / dt
    log(f"phase 31: embedded {n} sentences of {len(sub)} docs at batch {ENC_BATCH} in "
        f"{dt:.2f} s: {sents_per_s:.1f} sentences/s (host tokenization included); all "
        f"finite, unit norm within 1e-5")

    # served sentence search over phase 9's index with that table
    own = set(sub)
    queries = [c.claim for c in wiki.claims if set(c.evidences) & own]
    n_own, seen = len(queries), set(queries)
    queries += [c for c in mine if c not in seen]
    svc = make_service(index_path, device=dev, doc_sentences=sub, sentence_scorer=pre)
    svc.warmup()
    requests = [([queries[0]], 5, 5), (queries[1:21], 5, 3), (queries[21:25], 2, 7), None]
    lines = [
        json.dumps({"query": queries[0], "sentences": True}),
        json.dumps({"queries": queries[1:21], "k_sents": 3}),
        json.dumps({"queries": queries[21:25], "k": 2, "k_sents": 7}),
        json.dumps({"queries": [queries[0]], "k_sents": -1}),
    ]
    t0 = time.perf_counter()
    served, replies = serve_lines(svc, lines)
    serve_s = time.perf_counter() - t0
    checked = check_sentence_replies("phase 31", svc, fly, requests, replies,
                                     CountIndex.load(index_path), table, sub)
    hits = sum(len(hits) for rep in replies if "results" in rep for hits in rep["results"])
    if hits == 0:
        fail("phase 31: no request found a sentence of the embedded docs")
    log(f"phase 31: served {served} sentence requests in {serve_s:.2f} s over phase 9's "
        f"index ({len(sub)} docs with table rows; {n_own} claims have evidence in "
        f"them): {checked} results, "
        f"{hits} sentences, checked as phase 9 checks its own")
    dense_table_topk("phase 31", dev, fly.embed(claims[:DENSE_B]), table)
    shutil.rmtree(root)
    return dict(load_s=load_s, tok_ms=tok_ms, sents_per_s=sents_per_s)


def verdict_pairs(wiki, doc_ids, claims, n):
    """``n`` (claim, evidence text) pairs of mixed lengths: pair i's evidence
    is the doc-id words and sentences of ``i % 6`` docs (none for 0), so
    most pairs pad, each to its own length, and the longest are cut at L."""
    pairs = []
    for i in range(n):
        docs = doc_ids[i % len(doc_ids):][: i % 6]
        parts = []
        for d in docs:
            parts.extend(d.split("_"))
            parts.extend(s for s in wiki.sentences[d] if s)
        pairs.append((claims[i % len(claims)], " ".join(parts)))
    return pairs


def phase10_flash_kernel(dev, tok, pairs, results):
    """Kernel #6a against its plain version at [32, 12, 512, 64], in full
    fp32 and with split-TF32 products: segment ids of 32 tokenized pairs
    (one row cut to a single real token), then of a batch with no pads."""
    import torch

    from ircl_tpu_torch.ops.flash_attention_cuda import (
        SegmentIds, flash_attention, flash_attention_fwd_ref, flash_attention_ref,
    )

    B = VERDICT_BATCH
    H = VERDICT_ENCODER["heads"]
    hd = VERDICT_ENCODER["hidden"] // H
    scale = 1.0 / np.sqrt(hd)
    rng = np.random.default_rng(10)
    q, k, v = (torch.tensor(rng.normal(size=(B, H, VERDICT_L, hd)).astype(np.float32),
                            device=dev) for _ in range(3))
    _, mask, _ = tok.encode_batch(pairs[:B], VERDICT_L)
    seg = mask.astype(np.int32)
    seg[B - 1] = 0
    seg[B - 1, 0] = 1  # one real token
    lengths = seg.sum(axis=1)
    cases = {
        "tokenized pairs": torch.tensor(seg, device=dev),
        "no pads": torch.ones(B, VERDICT_L, dtype=torch.int32, device=dev),
    }
    err_all = 0.0
    for label, s in cases.items():
        ids = SegmentIds(q=s, kv=s)
        got = flash_attention(q, k, v, segment_ids=ids, sm_scale=scale)
        ref = flash_attention_ref(q, k, v, ids, scale)
        split = flash_attention_fwd_ref(q, k, v, ids, scale, products="tf32x3")[0]
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"phase 10: {label}: the kernel wrote non-finite values")
        err = float((got - ref).abs().max())
        err3 = float((got - split).abs().max())
        if max(err, err3) > FLASH_ATOL:
            fail(f"phase 10: {label}: the kernel differs from the plain version by {err}, "
                 f"from the plain version with split TF32 products by {err3}")
        err_all = max(err_all, err)
        log(f"phase 10: {label}: every row within {err:.3g} of the plain version, "
            f"{err3:.3g} of the plain version with split TF32 products (bound "
            f"{FLASH_ATOL})")
        del got, ref, split
    ids = SegmentIds(q=cases["tokenized pairs"], kv=cases["tokenized pairs"])
    t_k = cuda_ms(lambda: flash_attention(q, k, v, segment_ids=ids, sm_scale=scale),
                  reps=10)
    t_p = cuda_ms(lambda: flash_attention_ref(q, k, v, ids, scale), reps=5)
    s = cases["tokenized pairs"]
    t_lib = cuda_ms(lambda: sdpa(q, k, v, s, scale), reps=10)
    e_lib = float((sdpa(q, k, v, s, scale) - flash_attention(
        q, k, v, segment_ids=ids, sm_scale=scale)).abs().max())
    if e_lib > 1e-4:
        fail(f"phase 10: the library yardstick computes another function ({e_lib})")
    # two products, three TF32 passes each, on the tensor cores; the bound of
    # the same products as f32 FMAs beside it
    tensors = (q, k, v, s, s, q)
    results["flash_attention"] = dict(
        max_abs_err=err_all, ms=t_k, plain_ms=t_p, library_ms=t_lib,
        **attention_bounds(s, H, hd, 2, tensors, TF32_FLOPS, passes=3),
        bound_f32_fma_ms=attention_bounds(s, H, hd, 2, tensors)["bound_ms"])
    every_pair = 3 * 2 * 2 * hd * B * H * VERDICT_L ** 2
    log(f"phase 10: q, k, v [{B}, {H}, {VERDICT_L}, {hd}] f32, real lengths "
        f"{int(lengths.min())}-{int(lengths.max())} (median "
        f"{int(np.median(lengths))}): kernel {t_k:.3f} ms (bound "
        f"{results['flash_attention']['bound_ms']:.3f} ms at three TF32 passes a "
        f"product for the pairs these masks leave, "
        f"{least_time((), every_pair, TF32_FLOPS)['bound_ms']:.3f} ms for all, "
        f"{results['flash_attention']['bound_f32_fma_ms']:.3f} ms for f32 FMAs), "
        f"plain {t_p:.3f} ms, scaled_dot_product_attention (f32, boolean mask, "
        f"within {e_lib:.3g}) {t_lib:.3f} ms")


def phase11_verdict(dev, tok, pairs):
    """The verdict classifier at full width: card against CPU, flash against
    xla, a row against its batch, then pairs/s through ``classify``."""
    import dataclasses

    import torch

    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.ops.flash_attention_cuda import flash_attention
    from ircl_tpu_torch.utils.convert import to_device
    from ircl_tpu_torch.verdict.infer import VerdictClassifier
    from ircl_tpu_torch.verdict.model import (
        VerdictConfig, init_verdict_params, verdict_apply,
    )

    t0 = time.perf_counter()
    enc = TransformerConfig(**VERDICT_ENCODER)
    cfg = VerdictConfig(encoder=enc, max_length=VERDICT_L)
    params = init_verdict_params(torch.Generator().manual_seed(VERDICT_SEED), cfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    clf = VerdictClassifier(cfg, params, tok, batch_size=VERDICT_BATCH)
    log(f"phase 11: verdict model {enc.layers} x {enc.hidden}, {enc.heads} heads, "
        f"vocab {enc.vocab_size}, type_vocab {enc.type_vocab}, L={VERDICT_L} "
        f"({n_params / 1e6:.1f}M params), tokenizer vocab {tok.vocab_size}; built "
        f"in {time.perf_counter() - t0:.1f} s")

    def logits(c, p, batch, device):
        ids, mask, types = (torch.as_tensor(x, device=device)
                            for x in tok.encode_batch(batch, VERDICT_L))
        return verdict_apply(p, c, ids.long(), mask, types.long())

    # the card against the CPU, 4 pairs (type ids 1 past the first [SEP])
    four = [pairs[i] for i in (0, 5, 16, 33)]
    t0 = time.perf_counter()
    l_dev = logits(cfg, params, four, dev).cpu()
    l_cpu = logits(cfg, to_device(params, "cpu"), four, "cpu")
    err = float((l_dev - l_cpu).abs().max())
    if not torch.isfinite(l_dev).all() or err > VERDICT_DEVICE_ATOL:
        fail(f"phase 11: logits on the card and the CPU differ by {err}")
    log(f"phase 11: logits of 4 pairs on the card and on the CPU agree within "
        f"{err:.3g} (bound {VERDICT_DEVICE_ATOL}; {time.perf_counter() - t0:.1f} s)")

    # flash against xla on the card, 32 pairs: logits and labels of real rows
    batch = pairs[:VERDICT_BATCH]
    xla = dataclasses.replace(cfg, encoder=dataclasses.replace(enc, attention="xla"))
    l_flash, l_xla = logits(cfg, params, batch, dev), logits(xla, params, batch, dev)
    d = float((l_flash - l_xla).abs().max())
    margin = (l_xla[:, 1] - l_xla[:, 0]).abs()
    clear = margin > 2 * VERDICT_DEVICE_ATOL
    same = l_flash.argmax(-1) == l_xla.argmax(-1)
    if d > VERDICT_DEVICE_ATOL or not bool(same[clear].all()):
        fail(f"phase 11: flash and xla differ: logits by {d}, labels "
             f"{int((~same).sum())}")
    log(f"phase 11: flash and xla attention on the card, {VERDICT_BATCH} pairs: "
        f"logits within {d:.3g}, labels equal on {int(same.sum())}/{VERDICT_BATCH} "
        f"({int(clear.sum())} with a margin over {2 * VERDICT_DEVICE_ATOL})")

    # a row alone against the same row in its batch
    inside = clf.classify([c for c, _ in batch], [e for _, e in batch])
    rows = (3, VERDICT_BATCH // 2)
    for i in rows:
        (alone,) = clf.classify([batch[i][0]], [batch[i][1]])
        dc = abs(alone["confidence"] - inside[i]["confidence"])
        if alone["label_id"] != inside[i]["label_id"] or dc > 1e-6:
            fail(f"phase 11: row {i} alone differs from its batch: {alone} "
                 f"against {inside[i]}")
    log(f"phase 11: rows {rows} alone ({VERDICT_BATCH - 1} pad rows) classify "
        f"as inside their batch (confidence within 1e-6)")

    # pairs/s through classify, host tokenization included
    sweep = (pairs * (VERDICT_PAIRS // len(pairs) + 1))[:VERDICT_PAIRS]
    clf.warmup()
    before = flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = clf.classify([c for c, _ in sweep], [e for _, e in sweep])
    dt = time.perf_counter() - t0
    batches = -(-VERDICT_PAIRS // VERDICT_BATCH)
    per_batch = (flash_attention.launches - before) / batches
    if per_batch != enc.layers:
        fail(f"phase 11: {per_batch} flash launches per batch, not {enc.layers}")
    conf = np.array([r["confidence"] for r in out])
    if len(out) != VERDICT_PAIRS or not (np.isfinite(conf).all() and
                                         (conf >= 0.5).all() and (conf <= 1).all()):
        fail("phase 11: classify returned wrong or non-finite verdicts")
    log(f"phase 11: classified {VERDICT_PAIRS} pairs in {batches} batches of "
        f"{VERDICT_BATCH} x {VERDICT_L} in {dt:.2f} s: {VERDICT_PAIRS / dt:.1f} "
        f"pairs/s (host tokenization included); {int(per_batch)} flash launches a "
        f"batch; labels {np.bincount([r['label_id'] for r in out], minlength=2)}")
    return cfg, params


def phase12_verdict_service(dev, tok, cfg, params, index_path, doc_sentences, pre,
                            claims, tmpdir):
    """Served claim verification from a saved checkpoint: every reply's
    evidence is the sentence search for its claims, and its verdicts are
    ``classify`` of the evidence text assembled here."""
    from ircl_tpu_torch.serve import make_service
    from ircl_tpu_torch.verdict.infer import VerdictClassifier, save_verdict_checkpoint

    t0 = time.perf_counter()
    ckpt = os.path.join(tmpdir, "verdict_ckpt")
    save_verdict_checkpoint(ckpt, cfg, params, tok)
    clf = VerdictClassifier.from_checkpoint(ckpt, batch_size=VERDICT_BATCH, device=dev)
    if clf.cfg != cfg:
        fail("phase 12: the checkpoint's config does not load back")
    svc = make_service(index_path, device=dev, doc_sentences=doc_sentences,
                       sentence_scorer=pre, verdict_classifier=clf)
    svc.warmup()
    log(f"phase 12: checkpoint saved and loaded, service built and warmed in "
        f"{time.perf_counter() - t0:.1f} s")
    requests = [
        ([claims[0]], None, None),
        (claims[1:9], 3, 2),
        (claims[9:49], None, 4),
        None,
    ]
    lines = [
        json.dumps({"claim": claims[0]}),
        json.dumps({"claims": claims[1:9], "k": 3, "k_sents": 2}),
        json.dumps({"claims": claims[9:49], "k_sents": 4}),
        json.dumps({"claims": [claims[0], 7]}),
    ]
    t0 = time.perf_counter()
    served, replies = serve_lines(svc, lines)
    snap = svc.metrics.snapshot()
    log(f"phase 12: served {served} claim requests in {time.perf_counter() - t0:.2f} "
        f"s; metrics {snap}")
    checked = 0
    for req, rep in zip(requests, replies):
        if req is None:
            if "error" not in rep:
                fail(f"phase 12: malformed line answered without an error: {rep}")
            continue
        if "results" not in rep:
            fail(f"phase 12: request failed: {rep}")
        queries, k, k_sents = req
        evidence = svc.search_sentences(queries, k=k, k_sents=k_sents)
        texts = []
        for hits in evidence:  # serve.py:363-374's assembly
            by_doc = {}
            for h in hits:
                by_doc.setdefault(h["doc_id"], []).append(h.get("sentence", ""))
            parts = []
            for doc_id, sents in by_doc.items():
                parts.extend(doc_id.split("_"))
                parts.extend(x for x in sents if x)
            texts.append(" ".join(parts))
        want = clf.classify(queries, texts)
        if len(rep["results"]) != len(queries):
            fail(f"phase 12: {len(rep['results'])} verdicts for {len(queries)} claims")
        for got, ev, w in zip(rep["results"], evidence, want):
            if got["evidence"] != ev:
                fail("phase 12: a reply's evidence is not the sentence search")
            if (got["label"], got["label_id"]) != (w["label"], w["label_id"]) or abs(
                    got["confidence"] - w["confidence"]) > 1e-6:
                fail(f"phase 12: verdict {got['label']} {got['confidence']} != "
                     f"classify's {w['label']} {w['confidence']}")
            checked += 1
    log(f"phase 12: {checked} verdicts checked: evidence equal to search_sentences, "
        f"label and confidence equal to classify on the assembled evidence (1e-6); "
        f"the malformed line got an error; p50 {snap['latency_p50_ms']} ms over "
        f"{snap['requests']} requests")


def attention_bounds(seg, H, hd, products, tensors, flops=F32_FLOPS, passes=1):
    """The least time one attention kernel could take on this card, ms:
    ``products`` matrix products of 2 * hd FLOP for every (query, key) pair
    of one segment (what this batch's masks need; masked pairs need none),
    ``passes`` times each, at the rate ``flops``, against its tensors moved
    once."""
    pairs = H * int((seg[:, :, None] == seg[:, None, :]).sum())
    return least_time(tensors, passes * products * 2 * hd * pairs, flops)


def sdpa(q, k, v, seg, scale):
    """The yardstick: the one PyTorch call that computes the same function,
    f32 with a boolean mask. Timed here; the port never calls it."""
    import torch.nn.functional as F

    same = (seg[:, None, :, None] == seg[:, None, None, :])
    return F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=scale)


def phase13_flash_backward(dev, tok, pairs, results):
    """Kernels #6b and #6c against their plain version at the training shape
    [8, 12, 512, 64]: the forward's statistics, then dq, dk, dv, with
    segment ids of 8 tokenized pairs (one row cut to a single real token),
    of a batch with no pads, of key ids that differ from the query ids
    (a query with no key at all, keys with no query) and of short pairs."""
    import torch

    from ircl_tpu_torch.ops.flash_attention_cuda import (
        DEFAULT_MASK_VALUE, SegmentIds, flash_attention, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_bwd_ref, flash_attention_fwd,
        flash_attention_fwd_ref, flash_attention_ref,
    )

    B, H = TRAIN_BATCH, VERDICT_ENCODER["heads"]
    hd = VERDICT_ENCODER["hidden"] // H
    scale = 1.0 / np.sqrt(hd)
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.tensor(rng.normal(size=(B, H, VERDICT_L, hd)).astype(np.float32),
                                device=dev) for _ in range(4))
    _, mask, _ = tok.encode_batch(pairs[:B], VERDICT_L)
    seg = mask.astype(np.int32)
    seg[B - 1] = 0
    seg[B - 1, 0] = 1  # one real token
    # other ids on the keys than on the queries: the keys' real part ends
    # earlier; query 5 of pair 0 matches no key at all (its p is 1 / Lk on
    # every key, so none of its tiles is empty); the last 64 keys of pair 1
    # match no query, and no query of pair 1 is without a key (dk = dv = 0)
    seg_q_odd, seg_kv_odd = seg.copy(), seg.copy()
    for b in range(B):
        seg_kv_odd[b, int(seg[b].sum()) // 2:] = 0
    seg_q_odd[0, 5] = 7
    seg_kv_odd[1, -64:] = 9
    short = np.zeros((B, VERDICT_L), np.int32)
    short_lengths = rng.integers(12, 128, size=B)
    for b, n in enumerate(short_lengths):
        short[b, :n] = 1
    put = lambda x: torch.tensor(x, device=dev)  # noqa: E731
    cases = {
        "tokenized pairs": SegmentIds(q=put(seg), kv=put(seg)),
        "no pads": SegmentIds(*(torch.ones(B, VERDICT_L, dtype=torch.int32, device=dev)
                                for _ in range(2))),
        "other key ids, a query with no key": SegmentIds(q=put(seg_q_odd),
                                                         kv=put(seg_kv_odd)),
        "short pairs": SegmentIds(q=put(short), kv=put(short)),
    }
    # autograd hands the backward a transposed view (the head merge)
    do_view = do.transpose(1, 2).contiguous().transpose(1, 2)
    worst = {"dkv": 0.0, "dq": 0.0}
    for label, ids in cases.items():
        o, stats = flash_attention_fwd(q, k, v, ids, scale)
        o_ref, stats_ref = flash_attention_fwd_ref(q, k, v, ids, scale)
        torch.cuda.synchronize()
        e_o = float((o - o_ref).abs().max())
        e_l = float(((stats.l - stats_ref.l).abs() / stats_ref.l).max())
        # a row with no key has m at the mask value, where one ulp is 2e31:
        # those rows are held to a relative bound, the others as before
        no_key = stats_ref.m < 0.5 * DEFAULT_MASK_VALUE
        d_m = (stats.m - stats_ref.m).abs()
        e_m = float(d_m[~no_key].max())
        e_m_no_key = float((d_m[no_key] / stats_ref.m[no_key].abs()).max()) if (
            no_key.any()) else 0.0
        if max(e_o, e_l, e_m, e_m_no_key) > FLASH_ATOL or not (
                torch.isfinite(stats.l).all()):
            fail(f"phase 13: {label}: forward with statistics: o {e_o}, l {e_l} "
                 f"(relative), m {e_m} ({int(no_key.sum())} rows with no key: "
                 f"{e_m_no_key} relative)")
        dk, dv = flash_attention_bwd_dkv(q, k, v, ids, o, stats, do, scale)
        dq = flash_attention_bwd_dq(q, k, v, ids, o, stats, do, scale)
        again = (flash_attention_bwd_dq(q, k, v, ids, o, stats, do, scale),
                 *flash_attention_bwd_dkv(q, k, v, ids, o, stats, do, scale))
        want = flash_attention_bwd_ref(q, k, v, ids, o, stats, do, scale)
        split = flash_attention_bwd_ref(q, k, v, ids, o, stats, do, scale,
                                        products="tf32x3")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention_ref(*leaves, ids, scale).backward(do)
        through = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention(*through, segment_ids=ids, sm_scale=scale).backward(do_view)
        torch.cuda.synchronize()
        errs = {}
        for name, got, second, w, w3, auto, fn in zip(
                ("dq", "dk", "dv"), (dq, dk, dv), again, want, split, leaves, through):
            if not torch.isfinite(got).all():
                fail(f"phase 13: {label}: {name} has non-finite values")
            if not torch.equal(second, got):
                fail(f"phase 13: {label}: two launches gave different bits of {name}")
            if not torch.equal(fn.grad, got):
                fail(f"phase 13: {label}: {name} through autograd.Function differs "
                     f"from the kernel wrapper's")
            errs[name] = (float((got - w).abs().max()),
                          float((got - auto.grad).abs().max()),
                          float((got - w3).abs().max()))
            if max(errs[name]) > FLASH_ATOL:
                fail(f"phase 13: {label}: {name} differs from the plain version by "
                     f"{errs[name][0]}, from autograd by {errs[name][1]}, from the "
                     f"plain version with split TF32 products by {errs[name][2]}")
        if label.startswith("other key ids") and (
                dk[1, :, -64:].any() or dv[1, :, -64:].any()):
            fail("phase 13: keys that match no query got a gradient")
        worst["dq"] = max(worst["dq"], *errs["dq"])
        worst["dkv"] = max(worst["dkv"], *errs["dk"], *errs["dv"])
        log(f"phase 13: {label}: o within {e_o:.3g}, l within {e_l:.3g} (relative), "
            f"m within {e_m:.3g} ({int(no_key.sum())} rows with no key); (plain f32, "
            "autograd, plain tf32x3) "
            + "; ".join(f"{n} " + ", ".join(f"{x:.3g}" for x in errs[n])
                        for n in ("dq", "dk", "dv"))
            + f" (bound {FLASH_ATOL}); two launches gave equal bits; the "
            f"autograd.Function's gradients equal the wrappers'")
        del leaves, through, want, split, again

    def backward_ms(ids):
        o, stats = flash_attention_fwd(q, k, v, ids, scale)
        a = (q, k, v, ids, o, stats, do, scale)
        return (cuda_ms(lambda: flash_attention_bwd_dkv(*a), reps=20),
                cuda_ms(lambda: flash_attention_bwd_dq(*a), reps=20))

    ids = cases["tokenized pairs"]
    s = ids.q
    o, stats = flash_attention_fwd(q, k, v, ids, scale)
    args = (q, k, v, ids, o, stats, do, scale)
    t_fwd = cuda_ms(lambda: flash_attention_fwd(q, k, v, ids, scale), reps=10)
    t_dkv, t_dq = backward_ms(ids)
    t_full = backward_ms(cases["no pads"])
    t_short = backward_ms(cases["short pairs"])
    if sum(t_short) >= sum(t_full):
        fail(f"phase 13: the short pairs' backward ({t_short} ms) is not faster than "
             f"the backward with no pads ({t_full} ms): no step was skipped")
    t_plain = cuda_ms(lambda: flash_attention_bwd_ref(*args), reps=5)
    # the yardstick: autograd through the library call, one grad call each
    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
    lo = sdpa(lq, lk, lv, s, scale)
    lib = lambda wrt: lambda: torch.autograd.grad(lo, wrt, do, retain_graph=True)  # noqa: E731
    e_lib = float((lo - o).abs().max())
    if e_lib > 1e-4:
        fail(f"phase 13: the library yardstick computes another function ({e_lib})")
    t_lib_fwd = cuda_ms(lambda: sdpa(q, k, v, s, scale), reps=10)
    t_lib_dkv = cuda_ms(lib((lk, lv)), reps=5)
    t_lib_dq = cuda_ms(lib((lq,)), reps=5)
    t_lib_all = cuda_ms(lib((lq, lk, lv)), reps=10)
    stat_t = (stats.l, stats.m, stats.l)  # l, m and di: [B, H, L] f32 each
    for name, t_k, t_lib, worst_err, products, outs in (
            ("flash_attention_bwd_dkv", t_dkv, t_lib_dkv, worst["dkv"], 4, (k, v)),
            ("flash_attention_bwd_dq", t_dq, t_lib_dq, worst["dq"], 3, (q,))):
        tensors = (q, k, v, do, *stat_t, s, s, *outs)
        results[name] = dict(
            max_abs_err=worst_err, ms=t_k, plain_ms=t_plain, library_ms=t_lib,
            library_pair_ms=t_lib_all,  # the one call for dq, dk and dv
            **attention_bounds(s, H, hd, products, tensors, TF32_FLOPS, passes=3),
            bound_f32_fma_ms=attention_bounds(s, H, hd, products, tensors)["bound_ms"])
    r_dkv, r_dq = results["flash_attention_bwd_dkv"], results["flash_attention_bwd_dq"]
    live = float((s[:, :, None] == s[:, None, :]).float().mean())
    log(f"phase 13: q, k, v, do [{B}, {H}, {VERDICT_L}, {hd}] f32, real lengths "
        f"{seg.sum(axis=1).tolist()}, {live:.3f} of the "
        f"pairs live: forward with statistics {t_fwd:.3f} ms, dK/dV {t_dkv:.3f} ms "
        f"(bound {r_dkv['bound_ms']:.3f} at three TF32 passes a product, "
        f"{r_dkv['bound_f32_fma_ms']:.3f} for f32 FMAs), dQ {t_dq:.3f} ms (bound "
        f"{r_dq['bound_ms']:.3f}, {r_dq['bound_f32_fma_ms']:.3f}), the pair "
        f"{t_dkv + t_dq:.3f} ms against {t_lib_all:.3f} ms for the library's one call "
        f"for dq, dk and dv; plain backward (both) {t_plain:.3f} ms")
    log(f"phase 13: no pads: dK/dV {t_full[0]:.3f} ms, dQ {t_full[1]:.3f} ms; short "
        f"pairs (real lengths {int(short_lengths.min())}-{int(short_lengths.max())}, "
        f"pads attend to pads): dK/dV {t_short[0]:.3f} ms, dQ {t_short[1]:.3f} ms")
    log(f"phase 13: library yardstick (scaled_dot_product_attention, f32, boolean "
        f"mask; output within {e_lib:.3g} of the kernel's): forward {t_lib_fwd:.3f} "
        f"ms, backward for k, v {t_lib_dkv:.3f} ms, for q {t_lib_dq:.3f} ms, for all "
        f"three {t_lib_all:.3f} ms")


def train_batch(tok, pairs, rows, seed):
    """Token arrays of ``rows`` pairs and seeded labels."""
    ids, mask, types = tok.encode_batch([pairs[i] for i in rows], VERDICT_L)
    labels = np.random.default_rng(seed).integers(0, 2, size=len(rows))
    return ids, mask, types, labels.astype(np.int32)


def phase14_train_step(dev, tok, pairs):
    """The train step at roberta-base width, B=8, L=512: flash against "xla"
    on the card (loss and every gradient leaf), one step of a cut batch on
    the card against the CPU, the freeze, then timed steps of both paths."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.ops.flash_attention_cuda import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    )
    from ircl_tpu_torch.utils.convert import to_device
    from ircl_tpu_torch.utils.tree import tree_leaves, tree_map
    from ircl_tpu_torch.verdict.model import (
        VerdictConfig, init_verdict_params, make_verdict_train_step,
        value_and_grad, verdict_apply_with_aux,
    )

    enc = TransformerConfig(**VERDICT_ENCODER)
    cfg = VerdictConfig(encoder=enc, max_length=VERDICT_L, learning_rate=TRAIN_LR,
                        warmup_steps=TRAIN_WARMUP, total_steps=200)
    xla = dataclasses.replace(cfg, encoder=dataclasses.replace(enc, attention="xla"))
    init = init_verdict_params(torch.Generator().manual_seed(VERDICT_SEED), cfg, "cpu")
    names = [n for n, _ in named_leaves(init)]
    batch = train_batch(tok, pairs, range(3, 3 + TRAIN_BATCH), 14)
    real = batch[1].sum(axis=1).astype(int)
    log(f"phase 14: train step of the verdict model {enc.layers} x {enc.hidden}, "
        f"B={TRAIN_BATCH}, L={VERDICT_L}, real lengths {real.tolist()}, "
        f"warmup_steps {TRAIN_WARMUP}, learning rate {TRAIN_LR}")

    def loss_and_grads(c, params, b, device):
        ids, mask, types, labels = b

        def loss_fn(p, *t):
            logits, _ = verdict_apply_with_aux(p, c, t[0], t[1], t[2])
            return F.cross_entropy(logits, t[3]), logits

        loss, _, grads = value_and_grad(
            loss_fn, params, torch.as_tensor(ids, device=device).long(),
            torch.as_tensor(mask, device=device),
            torch.as_tensor(types, device=device).long(),
            torch.as_tensor(labels, device=device).long())
        return float(loss), grads

    # flash against xla on the card: loss and every gradient leaf
    params = to_device(init, dev)
    l_flash, g_flash = loss_and_grads(cfg, params, batch, dev)
    l_xla, g_xla = loss_and_grads(xla, params, batch, dev)
    worst_abs, worst_rel = (0.0, ""), (0.0, "")
    for name, a, b in zip(names, tree_leaves(g_flash), tree_leaves(g_xla)):
        if not torch.isfinite(a).all():
            fail(f"phase 14: the flash gradient of {name} is not finite")
        d, size = float((a - b).abs().max()), float(b.abs().max())
        worst_abs = max(worst_abs, (d, name))
        if size > 1e-6:  # k/b is zero in exact arithmetic: noise on both paths
            worst_rel = max(worst_rel, (d / size, name))
    if abs(l_flash - l_xla) > 1e-5 or worst_abs[0] > TRAIN_GRAD_ATOL or (
            worst_rel[0] > TRAIN_GRAD_RTOL):
        fail(f"phase 14: flash and xla differ: loss {l_flash} against {l_xla}, "
             f"gradients by {worst_abs} absolute, {worst_rel} of a leaf's largest")
    log(f"phase 14: flash and xla on the card: loss {l_flash:.6f} against "
        f"{l_xla:.6f}; {len(names)} gradient leaves within {worst_abs[0]:.3g} "
        f"({worst_abs[1]}; bound {TRAIN_GRAD_ATOL}) and within {worst_rel[0]:.3g} "
        f"of each leaf's largest element ({worst_rel[1]}; bound {TRAIN_GRAD_RTOL})")
    del g_flash, g_xla

    # one step at B=2, from a count past the warmup: the card against the CPU
    t0 = time.perf_counter()
    small = train_batch(tok, pairs, (5, 16), 15)
    outs = {}
    for device in (dev, "cpu"):
        p = tree_map(lambda t: t.to(device, copy=True), init)  # updated in place
        step, tx = make_verdict_train_step(cfg, device=device)
        state = dict(tx.init(p), count=TRAIN_WARMUP)
        _, _, loss, preds = step(p, state, TRAIN_WARMUP, *small)
        outs[str(device)] = (float(loss), preds.cpu(), to_device(p, "cpu"))
    (l_d, p_d, w_d), (l_c, p_c, w_c) = outs[str(dev)], outs["cpu"]
    far, frac = (0.0, ""), (0.0, "")
    moved = 0.0
    for name, a, b, start in zip(names, tree_leaves(w_d), tree_leaves(w_c),
                                 tree_leaves(init)):
        d = (a - b).abs()
        far = max(far, (float(d.max()), name))
        moved = max(moved, float((a - start).abs().max()))
        if not name.endswith("/k/b"):
            frac = max(frac, (float((d > 0.1 * TRAIN_LR).float().mean()), name))
    if abs(l_d - l_c) > 1e-5 or not torch.equal(p_d, p_c) or (
            far[0] > 2.1 * TRAIN_LR or frac[0] > 1e-2 or moved < 0.25 * TRAIN_LR):
        fail(f"phase 14: one step on the card and the CPU differ: loss {l_d} "
             f"against {l_c}, parameters by {far}, share over lr/10 {frac}")
    log(f"phase 14: one step at B=2 on the card and on the CPU: loss {l_d:.6f} "
        f"against {l_c:.6f}, predictions equal; parameters moved by up to "
        f"{moved:.3g} and differ by at most {far[0]:.3g} ({far[1]}; Adam turns a "
        f"gradient's rounding noise into a step of the learning rate {TRAIN_LR}, "
        f"bound 2.1 of it), the share of a leaf's elements that differ by more than "
        f"a tenth of it at most {frac[0]:.3g} ({frac[1]}; bound 1e-2, k/b leaves "
        f"apart); {time.perf_counter() - t0:.1f} s")
    del outs, w_d, w_c

    # the freeze: body bit-unchanged before warmup_steps, changed after
    counters = (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    step, tx = make_verdict_train_step(cfg, device=dev)
    state = tx.init(params)
    start = tree_map(torch.clone, params)
    rows = lambda s: [(7 * s + i) % len(pairs) for i in range(TRAIN_BATCH)]  # noqa: E731
    losses = []
    for s in range(TRAIN_WARMUP + 2):
        before = [fn.launches for fn in counters]
        _, _, loss, _ = step(params, state, s, *train_batch(tok, pairs, rows(s), s))
        per_step = [fn.launches - b for fn, b in zip(counters, before)]
        if per_step != [enc.layers] * 3:
            fail(f"phase 14: step {s} launched {per_step} (forward, dK/dV, dQ), not "
                 f"{enc.layers} each")
        losses.append(float(loss))
        body_same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params["body"]), tree_leaves(start["body"])))
        head_same = torch.equal(params["head_out"]["w"], start["head_out"]["w"])
        if s < TRAIN_WARMUP and not body_same:
            fail(f"phase 14: the frozen body changed at step {s}")
        if s >= TRAIN_WARMUP and body_same:
            fail(f"phase 14: the body did not change at step {s}")
        if head_same != (s == 0):  # the first learning rate is exactly 0
            fail(f"phase 14: the head at step {s}: unchanged is {head_same}")
    if not np.isfinite(losses).all():
        fail(f"phase 14: losses {losses}")
    log(f"phase 14: steps 0-{TRAIN_WARMUP + 1}: the body keeps its bits while "
        f"frozen (steps 0-{TRAIN_WARMUP - 1}) and moves after; the head moves from "
        f"step 1 (the first learning rate is 0); {enc.layers} forward, dK/dV and dQ "
        f"launches a step; losses {', '.join(f'{x:.4f}' for x in losses)}")
    del start

    # timed steps, both paths in turns, past the warmup (every leaf updated)
    fixed = train_batch(tok, pairs, rows(1), 1)
    timings = {}
    for label, c in (("flash", cfg), ("xla", xla), ("xla", xla), ("flash", cfg)):
        p = to_device(init, dev)
        step, tx = make_verdict_train_step(c, device=dev)
        state = dict(tx.init(p), count=TRAIN_WARMUP)
        step(p, state, TRAIN_WARMUP, *fixed)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = [fn.launches for fn in counters]
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        for s in range(TRAIN_TIMED_STEPS):
            _, _, loss, _ = step(p, state, TRAIN_WARMUP + 1 + s, *fixed)
        e1.record()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per_step = [(fn.launches - b) / TRAIN_TIMED_STEPS
                    for fn, b in zip(counters, before)]
        want = [enc.layers] * 3 if label == "flash" else [0] * 3
        if per_step != want or not np.isfinite(float(loss)):
            fail(f"phase 14: {label}: {per_step} launches a step (want {want}), "
                 f"loss {float(loss)}")
        timings.setdefault(label, []).append(
            (TRAIN_TIMED_STEPS / dt, e0.elapsed_time(e1) / TRAIN_TIMED_STEPS,
             torch.cuda.max_memory_allocated() / 2**30))
        del p, state
    for label, runs in timings.items():
        log(f"phase 14: {label}: {TRAIN_TIMED_STEPS} steps, two runs: "
            + "; ".join(f"{sps:.2f} steps/s, {ms:.2f} ms of device time a step, "
                        f"peak {gib:.2f} GiB" for sps, ms, gib in runs))
    return cfg


def phase15_trainer(dev, tok, cfg, pairs, tmpdir):
    """The trainer end to end: ``train_verdict`` on seeded pairs, its
    checkpoint served by ``VerdictClassifier``, ``predict_in_batches``."""
    import dataclasses

    import torch

    from ircl_tpu_torch.verdict.data import VerdictExample, encode_examples
    from ircl_tpu_torch.verdict.infer import VerdictClassifier
    from ircl_tpu_torch.verdict.train import predict_in_batches, train_verdict

    labels = np.random.default_rng(15).integers(0, 2, size=TRAINER_PAIRS)
    examples = [VerdictExample(c, e, int(y))
                for (c, e), y in zip(pairs[:TRAINER_PAIRS], labels)]
    ids, mask, types, y = encode_examples(examples, tok, VERDICT_L)
    n_val = int(TRAINER_PAIRS * 0.1)
    steps = TRAINER_EPOCHS * ((TRAINER_PAIRS - n_val) // TRAIN_BATCH)
    cfg = dataclasses.replace(cfg, total_steps=steps)
    ckpt = os.path.join(tmpdir, "trained_ckpt")
    t0 = time.perf_counter()
    params, history = train_verdict(
        cfg, ids, mask, types, y, epochs=TRAINER_EPOCHS, batch_size=TRAIN_BATCH,
        val_fraction=0.1, seed=1009, save_path=ckpt, tokenizer=tok, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if len(history) != TRAINER_EPOCHS or any(
            h["train_loss"] is None or not np.isfinite(h["train_loss"])
            or h["val_macro_f1"] is None or not 0.0 <= h["val_macro_f1"] <= 1.0
            for h in history):
        fail(f"phase 15: history {history}")
    log(f"phase 15: train_verdict on {TRAINER_PAIRS} pairs ({n_val} held out), "
        f"{TRAINER_EPOCHS} epochs, {steps} steps of {TRAIN_BATCH} x {VERDICT_L} in "
        f"{dt:.1f} s ({steps / dt:.2f} steps/s, validation and the checkpoint "
        f"included): " + "; ".join(
            f"epoch {h['epoch']} loss {h['train_loss']:.4f}, macro-F1 "
            f"{h['val_macro_f1']:.3f}" for h in history))

    run = lambda: predict_in_batches(  # noqa: E731
        params, cfg, ids, mask, types, PREDICT_BATCH, device=dev)
    preds = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = run()
    dt = time.perf_counter() - t0
    clf = VerdictClassifier.from_checkpoint(ckpt, batch_size=PREDICT_BATCH, device=dev)
    served = clf.classify([e.claim for e in examples],
                          [e.evidence_text for e in examples])
    got = np.array([r["label_id"] for r in served])
    if preds.shape != (TRAINER_PAIRS,) or not np.array_equal(preds, again) or (
            not np.array_equal(got, preds)):
        fail(f"phase 15: the served checkpoint gives {int((got != preds).sum())} "
             f"other labels than predict_in_batches")
    log(f"phase 15: the checkpoint loaded by VerdictClassifier classifies the "
        f"{TRAINER_PAIRS} pairs as predict_in_batches does (labels "
        f"{np.bincount(preds, minlength=2)}); predict_in_batches at batch "
        f"{PREDICT_BATCH}: {TRAINER_PAIRS / dt:.1f} examples/s")


def tiles_agree(got, ref, rtol, atol=0.0, own=None):
    """Per-tile top-k outputs: scores within the tolerance and positions
    equal. With ``own(rows, cols, positions)``, which gives the plain total
    of each named position (NaN where it may not stand in that output row),
    a position may differ where it carries its own total within the
    tolerance: a tie, or two docs the tolerance cannot tell apart. Returns
    (ok, max abs score difference, positions that differ)."""
    import torch

    (s1, i1), (s2, i2) = got, ref
    ok = bool(torch.isclose(s1, s2, rtol=rtol, atol=atol).all())
    r, c = (i1 != i2).nonzero(as_tuple=True)
    if r.numel():
        ok = ok and own is not None and bool(
            torch.isclose(own(r, c, i1[r, c]), s1[r, c], rtol=rtol, atol=atol).all())
    return ok, float((s1 - s2).abs().max()), int(r.numel())


def plain_totals_at(h_t, docs_t, contribs_t, pos, cols):
    """Heavy score plus light pool entries of doc ``pos[j]`` for column
    ``cols[j]``, from the plain transposed scores ``h_t [N_pad, B]`` and the
    pools ``[P, B]``; NaN for a negative position."""
    import torch

    light = (contribs_t[:, cols] * (docs_t[:, cols] == pos)).sum(0)
    total = h_t[pos.long().clamp(min=0), cols] + light
    return torch.where(pos >= 0, total, torch.nan)


def ids_carry_scores(s, i, ref_i, cpu_results, rtol=1e-4):
    """Top-k rows against another engine's: the (query, slot) places whose
    id differs from ``ref_i`` and whose doc does NOT have the reported score
    in the scipy matvec (so a differing id that passes is a real tie)."""
    bad = 0
    for b, j in zip(*np.nonzero(i != ref_i)):
        _, _, all_ids, all_scores = cpu_results[b]
        pos = min(np.searchsorted(all_ids, i[b, j]), len(all_ids) - 1)
        if i[b, j] < 0 or not len(all_ids) or all_ids[pos] != i[b, j] or not np.isclose(
                all_scores[pos], s[b, j], rtol=rtol, atol=0.0):
            bad += 1
    return bad


def scale_gate(s, i, cpu_results, n):
    """``bench_scale.py:190-200``: queries whose sorted top-k scores differ
    from the scipy matvec's at rtol 1e-4. Beyond the bench's gate, every
    returned doc must carry its own scipy score (the top-k here is full of
    exact ties, so ids cannot be compared, but a shifted id would show)."""
    bad = 0
    for b in range(n):
        ref_ids, ref_scores, all_ids, all_scores = cpu_results[b]
        m = min(len(ref_ids), int((i[b] >= 0).sum()))
        if not np.allclose(np.sort(ref_scores[:m]), np.sort(s[b][:m]), rtol=1e-4):
            bad += 1
            continue
        got = i[b][i[b] >= 0]
        pos = np.minimum(np.searchsorted(all_ids, got), len(all_ids) - 1)
        if not (all_ids[pos] == got).all() or not np.allclose(
                all_scores[pos], s[b][i[b] >= 0], rtol=1e-4):
            bad += 1
    return bad


def compare_slabs(phase, name, fn, cases):
    """Slab kernel ``fn`` against ``membership_slab_ref`` on each case, bit
    for bit, with CUDA-event times; the kernels line's numbers summed over
    the cases, and each case's own beside them."""
    import torch

    from ircl_tpu_torch.ops.membership_cuda import membership_slab_ref

    err, ms, plain_ms, bound_ms, by = 0.0, 0.0, 0.0, 0.0, (0.0, "")
    per_case = {}
    for label, args in cases.items():
        got = fn(*args)
        ref = membership_slab_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"{phase}: {name} ({label}) differs from its plain version")
        err = max(err, float((got - ref).abs().max()))
        del ref
        # every real term: a binary search of the union and one add, integer
        # and f32 steps at one a lane and cycle; the slab written once
        steps = int(np.ceil(np.log2(max(args[0].shape[0], 2)))) + 1
        least = least_time((*args, got), int((args[1] >= 0).sum()) * steps,
                           F32_FLOPS / 2)
        del got
        torch.cuda.empty_cache()
        bound_ms += least["bound_ms"]
        by = max(by, (least["bound_ms"], least["bound_by"]))
        t_k = cuda_ms(lambda: fn(*args))
        t_p = cuda_ms(lambda: membership_slab_ref(*args), reps=2)
        ms, plain_ms = ms + t_k, plain_ms + t_p
        per_case[label] = dict(shape=[args[0].shape[0], *args[1].shape], ms=t_k,
                               plain_ms=t_p, bound_ms=least["bound_ms"])
        log(f"{phase}: {name} {label}: U={args[0].shape[0]} "
            f"K={args[1].shape[0]} N={args[1].shape[1]}: equal; "
            f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {least['bound_ms']:.3f} "
            f"ms by {least['bound_by']}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by[1], library_ms=None, cases=per_case)


def shared_buffer_check(phase, u_pad, ranker):
    """``_bucketed_membership``: both buckets launched into one [U, Na + Nb]
    buffer, bit-equal to the two plain slabs side by side; its time beside
    that of the two slabs alone."""
    import torch

    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops.membership_cuda import (
        membership_slab_ref,
        membership_slab_windowed,
    )

    (ta, va), (tb, vb) = ranker._heavy_a, ranker._heavy_b
    m, _ = hy._bucketed_membership(u_pad, ta, va, tb, vb, ranker.d_tile)
    ref_a = membership_slab_ref(u_pad, ta, va)
    same_a = torch.equal(m[:, : ta.shape[1]], ref_a)
    del ref_a
    same_b = torch.equal(m[:, ta.shape[1]:], membership_slab_ref(u_pad, tb, vb))
    torch.cuda.synchronize()
    if not (same_a and same_b) or m.shape[1] != ta.shape[1] + tb.shape[1]:
        fail(f"{phase}: the shared bucketed buffer differs from the plain slabs")
    del m
    t_shared = cuda_ms(lambda: hy._bucketed_membership(u_pad, ta, va, tb, vb,
                                                       ranker.d_tile))
    t_alone = cuda_ms(lambda: (membership_slab_windowed(u_pad, ta, va),
                               membership_slab_windowed(u_pad, tb, vb)))
    log(f"{phase}: _bucketed_membership: both buckets in one [{u_pad.shape[0]}, "
        f"{ta.shape[1] + tb.shape[1]}] buffer, bit-equal to the plain slabs side by "
        f"side; {t_shared:.3f} ms (two slabs alone {t_alone:.3f} ms)")
    torch.cuda.empty_cache()


def slab_edge_cases(dev):
    """Both slab wrappers (one kernel) on seeded inputs that the judged
    shapes do not reach, bit for bit against the plain version: a union
    padded with copies of its last value (a run of 101 equal slots across
    row chunks) and docs that repeat its terms; terms out of order (the
    kernel checks each doc's order: the windowed wrapper's contract is
    ascending terms, but its slab is right for any); a union past the
    kernel's shared-memory stage; ragged N into an unaligned column range of
    a larger buffer (``out=`` of the windowed wrapper); K = 0."""
    import torch

    from ircl_tpu_torch.ops.membership_cuda import (
        membership_slab,
        membership_slab_ref,
        membership_slab_windowed,
    )

    rng = np.random.default_rng(2)
    n_checked = 0
    for U, K, N, vocab, ascending, col0 in (
            (200, 30, 900, 220, True, 0), (200, 30, 900, 220, False, 0),
            (20000, 40, 700, 80000, True, 0), (512, 24, 1001, 2048, False, 3),
            (300, 17, 1001, 1200, True, 5), (100, 0, 300, 400, True, 0)):
        u = np.sort(rng.choice(vocab, size=U, replace=False)).astype(np.int32)
        if vocab < 2 * U:
            u[U // 2:] = u[U // 2 - 1]
        t = rng.integers(0, vocab, size=(K, N)).astype(np.int32)
        t[rng.random((K, N)) < 0.3] = -1
        if ascending:
            t = np.sort(np.where(t < 0, np.iinfo(np.int32).max, t), axis=0)
            t[t == np.iinfo(np.int32).max] = -1
        v = rng.random((K, N)).astype(np.float32) * (t >= 0)
        args = [torch.tensor(x, device=dev) for x in (u, t, v)]
        ref = membership_slab_ref(*args)
        out = torch.full((U, N + col0 + 7), 7.0, device=dev)
        got = membership_slab_windowed(*args, out=out, col_offset=col0)
        for name, ok in (
                ("membership_slab", torch.equal(membership_slab(*args), ref)),
                ("membership_slab_windowed",
                 torch.equal(got, ref) and torch.equal(membership_slab_windowed(*args), ref)
                 and bool((out[:, :col0] == 7).all())
                 and bool((out[:, col0 + N:] == 7).all()))):
            if not ok:
                fail(f"phase 2: {name} differs from its plain version at U={U}, "
                     f"K={K}, N={N}, ascending {ascending}, col_offset {col0}")
            n_checked += 1
    log(f"phase 2: slab edge cases: {n_checked} calls bit-equal to the plain version "
        f"(copies of the last union value with repeated terms, terms out of order, "
        f"U=20000, ragged N at unaligned column offsets, K=0)")


def seeded_pools(rng, n_pad, B, P, one_tile=None):
    """Doc-ascending pools [P, B] as the ranker gathers them: a random
    share of each column real, the tail padded with ``n_pad``; column 0
    held inside ``one_tile = (lo, hi)`` when given."""
    docs = np.sort(rng.integers(0, n_pad, size=(P, B)), axis=0)
    if one_tile is not None:
        docs[:, 0] = np.sort(rng.integers(*one_tile, size=P))
    fill = rng.integers(P // 2, P + 1, size=B)
    docs = np.where(np.arange(P)[:, None] < fill[None, :], docs, n_pad).astype(np.int32)
    contribs = np.where(docs < n_pad, rng.integers(1, 4, size=(P, B)) * 0.5, 0.0)
    return docs, contribs.astype(np.float32)


def light_add_edge_cases(dev):
    """``light_add_topk_t`` on seeded inputs that the judged shapes do not
    reach, each bit for bit against the plain version (ids equal off exact
    ties): scores of small integers (many exact ties), k = 1, 5, 8 on the
    register lists and k = 9 above them, runs of equal scores across the
    row groups' borders, a column whose whole pool falls in one d-tile,
    empty pools, d_tile 256, 512 and 1024, B off the kernel's 64-column
    block (200) and odd (37: the column kernel)."""
    import torch

    from ircl_tpu_torch.ops.light_add_cuda import light_add_topk_t, light_add_topk_t_ref

    rng = np.random.default_rng(3)
    n_checked = 0
    for n_pad, B, P, k, d_tile, case in (
            (4096, 256, 48, 1, 256, "ties"), (4096, 256, 48, 5, 512, "ties"),
            (4096, 256, 48, 8, 1024, "ties"), (4096, 256, 48, 9, 1024, "ties"),
            (4096, 192, 40, 5, 256, "straddle"), (4096, 200, 40, 5, 512, "one tile"),
            (4096, 128, 40, 8, 256, "empty pools"), (2048, 37, 24, 5, 256, "ties")):
        h = rng.integers(0, 6, size=(n_pad, B)).astype(np.float32)
        h *= rng.random((n_pad, B)) < 0.5
        if case == "straddle":  # equal scores on both sides of every border
            h[:] = 0.0
            border = np.arange(d_tile // 8, n_pad, d_tile // 8)
            for off in (-2, -1, 0, 1):
                h[border + off] = 3.0
        docs, contribs = seeded_pools(rng, n_pad, B, P, (512, 512 + d_tile)
                                      if case == "one tile" else None)
        if case == "empty pools":
            docs, contribs = docs[:0], contribs[:0]
        args = [torch.tensor(np.ascontiguousarray(x), device=dev)
                for x in (h, docs, contribs)]
        s1, i1 = light_add_topk_t(*args, k=k, d_tile=d_tile)
        s2, i2 = light_add_topk_t_ref(*args, k=k, d_tile=d_tile)
        torch.cuda.synchronize()
        if not torch.equal(s1, s2) or not bool(((i1 == i2) | (s1 == s2)).all()):
            fail(f"phase 2: light_add_topk_t ({case}, B={B}, k={k}, d_tile={d_tile}) "
                 f"differs from its plain version")
        n_checked += 1
    log(f"phase 2: light add edge cases: {n_checked} calls bit-equal to the plain "
        f"version (k = 1, 5, 8, 9; ties across row groups; one column's pool in one "
        f"d-tile; empty pools; d_tile 256, 512, 1024; B = 200 and 37)")


def fused_dot_light_edge_cases(dev):
    """``fused_dot_light_topk`` on seeded sparse slabs that phase 16's shape
    does not reach, each within the probe's bound of the plain version,
    every differing position carrying its own plain total: U off the
    kernel's 32-row stage (100, 1000) and empty, B off its 256-column block
    (64, 320), d_tile 128, 256 and 1024, k = 12 (above the register list)."""
    import torch

    from ircl_tpu_torch.ops.fused_dot_light_cuda import (
        fused_dot_light_topk, fused_dot_light_topk_ref, high3_scores_t_ref, split_hi_lo,
    )

    rng = np.random.default_rng(16)
    n_checked = 0
    for U, n, B, P, k, d_tile in ((100, 1024, 320, 16, 5, 256),
                                  (1000, 2048, 64, 24, 5, 128),
                                  (256, 2048, 256, 20, 5, 1024),
                                  (0, 512, 128, 8, 5, 256),
                                  (300, 2048, 192, 20, 12, 1024)):
        m = (rng.random((U, n)) < 0.05) * rng.random((U, n))
        w = (rng.random((U, B)) < 0.05) * rng.random((U, B))
        (mh, ml), (wh, wl) = (split_hi_lo(torch.tensor(x, dtype=torch.float32, device=dev))
                              for x in (m, w))
        sd, sv = (torch.tensor(x, device=dev) for x in seeded_pools(rng, n, B, P))
        args = (mh, ml, wh, wl, sd, sv)
        got = fused_dot_light_topk(*args, k=k, d_tile=d_tile)
        ref = fused_dot_light_topk_ref(*args, k=k, d_tile=d_tile)
        h_t = high3_scores_t_ref(mh, ml, wh, wl)
        k8 = -(-k // 8) * 8

        def own(rows, cols, pos):
            totals = plain_totals_at(h_t, sd, sv, pos, cols)
            return torch.where(pos // d_tile == rows // k8, totals, torch.nan)

        ok, err, _ = tiles_agree(got, ref, FUSED_DOT_RTOL, FUSED_DOT_ATOL, own)
        if not ok:
            fail(f"phase 16: fused_dot_light_topk (U={U}, N={n}, B={B}, k={k}, "
                 f"d_tile={d_tile}) leaves the probe's bound of its plain version "
                 f"({err})")
        n_checked += 1
    log(f"phase 16: fused dot + light add edge cases: {n_checked} calls within the "
        f"probe's bound of the plain version (U = 100, 1000, 0; B = 64, 320, 192; "
        f"d_tile 128, 256, 1024; k = 12)")


def phase16_probe_kernels(dev, index, claims, dense_queries, dense_corpus, dense_ref,
                          results, launches):
    """Kernels #7 and #8 against their plain versions, then each driven
    through its entry point with fresh launch counts."""
    import torch

    from ircl_tpu_torch.index.ranker import TfidfRanker
    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops.dense_topk_cuda import (
        chunk_max, chunk_max_presplit, chunk_max_presplit_ref,
        cosine_topk_fused_presplit, pad_corpus_t,
    )
    from ircl_tpu_torch.ops.fused_dot_light_cuda import (
        fused_dot_light_topk, fused_dot_light_topk_ref, high3_scores_t_ref, split_hi_lo,
    )

    put = lambda x: torch.tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    fused_dot_light_edge_cases(dev)
    # ---- #7 on the judged configuration's operands (phase 5's) -------------
    ranker = TfidfRanker(
        index, dev, mode="hybrid", df_threshold=24, width_buckets=2,
        fixed_union_cap=4096, fixed_max_terms=64, precision="high", union_round=512,
    )
    buckets, weights = ranker._vectorize(claims)
    host = [put(x) for x in ranker.hybrid_host_inputs(buckets, weights)]
    u_pad, qb_t, qw_t, ld, lc = host
    m, u_tile = hy._bucketed_membership(u_pad, *ranker._heavy_a, *ranker._heavy_b,
                                        ranker.d_tile)
    wt = hy._query_slab(u_pad, qb_t, qw_t, u_tile, True)[:, : ld.shape[0]].contiguous()
    t_split = cuda_ms(lambda: (split_hi_lo(m), split_hi_lo(wt)), reps=2)
    (m_hi, m_lo), (w_hi, w_lo) = split_hi_lo(m), split_hi_lo(wt)
    del m, wt
    sd, sv = ld.T.contiguous(), lc.T.contiguous()
    d_lt = next(t for t in (1024, 512, 256) if m_hi.shape[1] % t == 0)
    args = (m_hi, m_lo, w_hi, w_lo, sd, sv)
    got = fused_dot_light_topk(*args, k=K, d_tile=d_lt)
    ref = fused_dot_light_topk_ref(*args, k=K, d_tile=d_lt)
    torch.cuda.synchronize()
    h_t = high3_scores_t_ref(m_hi, m_lo, w_hi, w_lo)  # what a differing id is held to
    k8 = got[0].shape[0] // (m_hi.shape[1] // d_lt)

    def own(rows, cols, pos):  # a position stands only in its own tile's rows
        totals = plain_totals_at(h_t, sd, sv, pos, cols)
        return torch.where(pos // d_lt == rows // k8, totals, torch.nan)

    ok, err, n_ids = tiles_agree(got, ref, FUSED_DOT_RTOL, FUSED_DOT_ATOL, own)
    if not ok:
        fail(f"phase 16: fused_dot_light_topk differs from its plain version: scores "
             f"by {err}, or one of {n_ids} differing positions does not carry its "
             f"own plain total")
    live = ref[1] >= 0  # how much of the bound the scores use
    used = float(((got[0] - ref[0]).abs() / (FUSED_DOT_ATOL + FUSED_DOT_RTOL
                                             * ref[0].abs()))[live].max())
    t_k = cuda_ms(lambda: fused_dot_light_topk(*args, k=K, d_tile=d_lt), reps=2)
    t_p = cuda_ms(lambda: fused_dot_light_topk_ref(*args, k=K, d_tile=d_lt), reps=1)
    U, n_pad = m_hi.shape
    B = w_hi.shape[1]
    results["fused_dot_light_topk"] = dict(
        max_abs_err=err, share_of_tolerance=used, ms=t_k, plain_ms=t_p, library_ms=None,
        **least_time((*args, *got), 3 * 2 * U * n_pad * B, BF16_FLOPS))
    log(f"phase 16: fused_dot_light_topk m [{U}, {n_pad}] x w [{U}, {B}] bf16 halves, "
        f"P={sd.shape[0]}, d_tile={d_lt}: per-tile scores within {err:.3g} of the "
        f"plain version, {used:.3f} of the bound at most (rtol {FUSED_DOT_RTOL}, "
        f"atol {FUSED_DOT_ATOL}; {n_ids} "
        f"positions differ, each carrying its own plain total inside it); kernel {t_k:.3f} ms "
        f"({3 * 2 * U * n_pad * B / t_k / 1e9:.1f} TFLOP/s), plain {t_p:.3f} ms, bound "
        f"{results['fused_dot_light_topk']['bound_ms']:.3f} ms; the split of both "
        f"slabs {t_split:.3f} ms")
    del got, ref

    # its path: the fused engine's top-5 with the dot inside the kernel
    fused_dot_light_topk.launches = 0

    def fused_top5():
        ts, ti = fused_dot_light_topk(*args, k=K, d_tile=d_lt)
        top_s, top_pos = torch.topk(ts.T, K, dim=1)
        return top_s, torch.gather(ti.T, 1, top_pos)

    engine = lambda: hy.hybrid_topk_bucketed_fused(  # noqa: E731
        *ranker._heavy_a, *ranker._heavy_b, *host, k=K, precision="high",
        queries_sorted=True, pools_sorted=True, d_tile=ranker.d_tile)
    s, i = fused_top5()
    rs, ri = engine()
    live = ri >= 0
    close = torch.isclose(s, rs, rtol=FUSED_DOT_RTOL, atol=FUSED_DOT_ATOL)
    r, c = ((i != ri) & live).nonzero(as_tuple=True)  # c: slot; the claim is r
    tied = torch.isclose(plain_totals_at(h_t, sd, sv, i[r, c], r), s[r, c],
                         rtol=FUSED_DOT_RTOL, atol=FUSED_DOT_ATOL)
    if not bool((close | ~live).all()) or not bool(tied.all()):
        fail(f"phase 16: the fused dot + light add top-{K} leaves the probe's bound: "
             f"scores by {float((s - rs)[live].abs().max())}, {int((~tied).sum())} of "
             f"{r.numel()} differing ids without their own plain total")
    t_new = cuda_ms(fused_top5, reps=2)
    t_old = cuda_ms(engine, reps=2)
    launches["fused_dot_light_topk"] = fused_dot_light_topk.launches
    log(f"phase 16: top-{K} of {B} claims through the fused dot + light add equals "
        f"hybrid_topk_bucketed_fused's within the probe's bound (max "
        f"{float((s - rs)[live].abs().max()):.3g}, {int(((i != ri) & live).sum())} ids "
        f"differ, each carrying its own plain total inside it): {t_new:.3f} ms from split slabs against {t_old:.3f} ms for "
        f"the whole fused engine (slabs, fp32 GEMM, light add); "
        f"{launches['fused_dot_light_topk']} launches")
    del ranker, host, args, m_hi, m_lo, w_hi, w_lo, sd, sv, s, i, rs, ri, h_t
    torch.cuda.empty_cache()

    # ---- #8 on bench_dense.py's corpus (phase 7's) -------------------------
    q_d = torch.tensor(dense_queries, device=dev)
    ct_d, m_real = pad_corpus_t(torch.tensor(dense_corpus, device=dev), DENSE_TILE)
    rows_d = ct_d.T.contiguous()
    ct_hi, ct_lo = split_hi_lo(ct_d)
    pargs = (q_d, ct_hi, ct_lo, DENSE_CHUNK, DENSE_TILE, m_real, "fold")
    high3 = lambda: chunk_max(  # noqa: E731
        q_d, ct_d, DENSE_CHUNK, DENSE_TILE, m_real, "high3", "fold")
    got = chunk_max_presplit(*pargs)
    ref = chunk_max_presplit_ref(*pargs)
    same = high3()
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    err = float((got[fin] - ref[fin]).abs().max())
    if not torch.equal(torch.isfinite(got), fin) or err > CMAX_ATOL:
        fail(f"phase 16: chunk_max_presplit differs from its plain version by {err}")
    if not torch.equal(got, same):
        fail("phase 16: chunk_max_presplit is not chunk_max high3/fold bit for bit")
    t_k = cuda_ms(lambda: chunk_max_presplit(*pargs), reps=3)
    t_p = cuda_ms(lambda: chunk_max_presplit_ref(*pargs), reps=2)
    t_h3 = cuda_ms(high3, reps=3)
    results["chunk_max_presplit"] = dict(
        max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=None,
        **least_time((q_d, ct_hi, ct_lo, got),
                     3 * 2 * q_d.shape[0] * q_d.shape[1] * m_real, BF16_FLOPS))
    log(f"phase 16: chunk_max_presplit B={q_d.shape[0]} M_pad={ct_hi.shape[1]} (m_real "
        f"{m_real}) fold: chunk maxima within {err:.3g} of the plain version (bound "
        f"{CMAX_ATOL}) and equal to chunk_max high3/fold bit for bit; kernel {t_k:.3f} "
        f"ms, high3 kernel on the f32 corpus {t_h3:.3f} ms, plain {t_p:.3f} ms")
    del got, ref, same

    chunk_max_presplit.launches = 0
    chunk_max_presplit.launches_by_route = {"mma": 0, "simt": 0}
    fn = lambda: cosine_topk_fused_presplit(  # noqa: E731
        q_d, ct_hi, ct_lo, rows_d, k=K, chunk=DENSE_CHUNK, m_tile=DENSE_TILE,
        m_real=m_real, epilogue="fold")
    s, i = (x.cpu().numpy() for x in fn())
    ref_s, ref_sets = dense_ref
    bad_s = sum(not np.allclose(s[b], ref_s[b], rtol=1e-5) for b in range(DENSE_B))
    bad_i = sum(set(i[b].tolist()) != ref_sets[b] for b in range(DENSE_B))
    if bad_s:
        fail(f"phase 16: cosine_topk_fused_presplit failed the full-batch gate on "
             f"{bad_s} queries")
    qps = timed_qps(fn, DENSE_B, reps=5)
    launches["chunk_max_presplit"] = chunk_max_presplit.launches
    results["chunk_max_presplit"]["launches_by_route"] = dict(
        chunk_max_presplit.launches_by_route)
    log(f"phase 16: cosine_topk_fused_presplit: full-batch score parity "
        f"{DENSE_B - bad_s}/{DENSE_B} (rtol 1e-5; id-set tie swaps {bad_i}); "
        f"{qps:.1f} q/s; {launches['chunk_max_presplit']} launches, by route "
        f"{chunk_max_presplit.launches_by_route}")


def phase17_scale(dev, results):
    """bench_scale.py's configuration on the port: index, rankers, the scipy
    gate for the staged engine, select_rescore and the ragged engine, q/s,
    ms by stage, peak memory. Returns what phases 18 and 19 reuse."""
    import scipy.sparse as sp
    import torch

    from ircl_tpu_torch.index.build import to_scipy
    from ircl_tpu_torch.index.ranker import TfidfRanker
    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops import ragged
    from ircl_tpu_torch.ops.membership_cuda import scores_matmul
    from ircl_tpu_torch.tools.scale_index import synth_index, synth_queries

    put = lambda x: torch.tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    t0 = time.perf_counter()
    index = synth_index(SCALE_DOCS, SCALE_TERMS, SCALE_VOCAB, HASH_SIZE)
    t_index = time.perf_counter() - t0
    qb, qw = synth_queries(index, SCALE_B)
    log(f"phase 17: synthetic index of {index.num_docs} docs, {index.nnz} postings "
        f"(bench_scale.py's {SCALE_DOCS} docs, no cut) built in {t_index:.1f} s on the "
        f"host; {SCALE_B} queries of {qb.shape[1]} terms")

    # the CPU reference: per-query scipy matvec (bench_scale.py:138-159)
    t0 = time.perf_counter()
    mat = to_scipy(index)

    def cpu_closest(b):
        nz = qw[b] != 0
        spvec = sp.csr_matrix(
            (qw[b][nz], qb[b][nz], [0, int(nz.sum())]), shape=(1, HASH_SIZE)
        )
        res = spvec * mat
        o = np.argpartition(-res.data, min(K, max(len(res.data) - 1, 0)))[:K]
        o = o[np.argsort(-res.data[o])]
        by_id = np.argsort(res.indices)  # every scored doc, for scale_gate
        return res.indices[o], res.data[o], res.indices[by_id], res.data[by_id]

    t1 = time.perf_counter()  # the gate reads the first SCALE_PARITY; id checks, all
    cpu_results = [cpu_closest(b) for b in range(SCALE_B)]
    cpu_qps = SCALE_B / (time.perf_counter() - t1)
    log(f"phase 17: scipy reference for {SCALE_B} queries in "
        f"{time.perf_counter() - t0:.1f} s ({cpu_qps:.1f} q/s on the host)")
    del mat

    t0 = time.perf_counter()
    ranker = TfidfRanker(index, dev, **SCALE_RANKER)
    t_build = time.perf_counter() - t0
    split = ranker._split
    log(f"phase 17: staged ranker built in {t_build:.1f} s (df-split, width buckets, "
        f"upload): K_h={split.heavy.k_width}, buckets "
        f"{tuple(ranker._heavy_a[0].shape)} and {tuple(ranker._heavy_b[0].shape)}, "
        f"d_tile {ranker.d_tile}")
    t0 = time.perf_counter()
    sel = TfidfRanker(index, dev, split=split, select_rescore=SCALE_SELECT,
                      **{k: v for k, v in SCALE_RANKER.items() if k != "df_threshold"})
    rag = TfidfRanker(index, dev, mode="ragged", fixed_max_terms=24)
    log(f"phase 17: select_rescore={SCALE_SELECT} ranker (the same split) and the "
        f"ragged ranker built in {time.perf_counter() - t0:.1f} s")

    out = {}
    for name, r in (("staged", ranker), (f"select_rescore={SCALE_SELECT}", sel)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        s, i = r.hybrid_from_vectors(qb, qw, K)
        first = time.perf_counter() - t0
        bad = scale_gate(s, i, cpu_results, SCALE_PARITY)
        peak = torch.cuda.max_memory_allocated()
        log(f"phase 17: {name}: parity {SCALE_PARITY - bad}/{SCALE_PARITY} queries "
            f"match scipy (sorted top-{K} scores, rtol 1e-4, each doc its own score); "
            f"first batch {first:.2f} s; "
            f"peak device memory {peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} "
            f"GiB above the resident indexes)")
        if bad:
            fail(f"phase 17: {name} failed the scipy gate on {bad} queries")
        out[name] = (s, i)
        rounds = []
        for _ in range(4):  # bench_scale.py:202-218, 5 batches in flight a round
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            outs = [r.hybrid_from_vectors_async(qb, qw, K) for _ in range(5)]
            e1.record()
            torch.cuda.synchronize()
            outs[-1][0].cpu()
            rounds.append((5 * SCALE_B / (time.perf_counter() - t0),
                           e0.elapsed_time(e1) / 5))
            del outs
        best = max(q for q, _ in rounds)
        log(f"phase 17: {name}: B={SCALE_B}, 5 batches a round: "
            + ", ".join(f"{q:.1f}" for q, _ in rounds)
            + f" q/s (best {best:.1f}; {best / cpu_qps:.1f}x the host's scipy); "
            + ", ".join(f"{m:.1f}" for _, m in rounds)
            + " ms a batch between CUDA events (host half included)")
    (s_st, i_st), (s_se, i_se) = out["staged"], out[f"select_rescore={SCALE_SELECT}"]
    same = sum(np.allclose(np.sort(s_st[b]), np.sort(s_se[b]), rtol=1e-5)
               for b in range(SCALE_B))
    log(f"phase 17: select_rescore={SCALE_SELECT} returns the staged engine's sorted "
        f"top-{K} scores on {same}/{SCALE_B} queries (rtol 1e-5; its selection is "
        f"approximate, the gate above certifies the {SCALE_PARITY} checked)")

    # the ragged validation engine on 32 queries
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    docs, contribs, cap = rag._gather_ragged_vectors(qb[:SCALE_RAGGED], qw[:SCALE_RAGGED])
    rs, ri = ragged.segment_topk(docs, contribs, k=K)
    rs, ri = rs.cpu().numpy(), ri.cpu().numpy()
    t_rag = time.perf_counter() - t0
    bad = scale_gate(rs, ri, cpu_results, SCALE_RAGGED)
    if bad:
        fail(f"phase 17: the ragged engine failed the scipy gate on {bad} queries")
    dense = ragged.dense_scores(docs, contribs, num_docs=index.num_docs)
    own = torch.gather(dense, 1, put(np.maximum(ri, 0)).long()).cpu().numpy()
    if not np.allclose(np.where(ri >= 0, own, 0.0), rs, rtol=1e-5):
        fail("phase 17: dense_scores disagrees with the ragged top-k")
    log(f"phase 17: ragged engine, {SCALE_RAGGED} queries, pools [{SCALE_RAGGED}, {cap}]: "
        f"parity {SCALE_RAGGED - bad}/{SCALE_RAGGED} against scipy; dense_scores "
        f"[{SCALE_RAGGED}, {index.num_docs}] carries each returned doc's score; "
        f"{t_rag:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del docs, contribs, dense, rag, sel
    torch.cuda.empty_cache()

    # ms by stage of one staged batch
    t0 = time.perf_counter()
    host = ranker.hybrid_host_inputs(qb, qw)
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_in = [put(x) for x in host]
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    u_pad, qb_t, qw_t, ld, lc = dev_in
    # the batch twice: the first pays the allocator for its buffers (the
    # 2 GB slab among them), the second reuses them, so its split holds the
    # kernels alone
    splits = []
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        m, u_tile = hy._bucketed_membership(u_pad, *ranker._heavy_a,
                                            *ranker._heavy_b, ranker.d_tile)
        wt = hy._query_slab(u_pad, qb_t, qw_t, u_tile, True)
        ev[1].record()
        h = scores_matmul(wt.T, m)[: ld.shape[0]]
        ev[2].record()
        hy._merge_light(h, ld, lc, K, h.shape[1], pools_sorted=True)
        ev[3].record()
        del h
        h_sel = torch.matmul(wt[:, : ld.shape[0]].T.to(torch.bfloat16),
                             m.to(torch.bfloat16))
        ev[4].record()
        hy._select_rescore_topk(m, wt, h_sel, ld, lc, K, SCALE_SELECT, h_sel.shape[1],
                                True)
        ev[5].record()
        torch.cuda.synchronize()
        splits.append([ev[j].elapsed_time(ev[j + 1]) for j in range(5)])
        slab_shape = list(m.shape)
        del m, wt, h_sel
    first, ms = splits
    log(f"phase 17: one batch by stage: host pool gather and query prep {host_ms:.2f} "
        f"ms, upload {upload_ms:.2f} ms (pools [{ld.shape[0]}, {ld.shape[1]}]); slabs "
        f"{slab_shape} {ms[0]:.3f} ms (the first batch, which allocates the "
        f"buffers: {first[0]:.3f} ms), fp32 GEMM {ms[1]:.3f} ms, "
        f"top-k + light merge {ms[2]:.3f} ms; select_rescore: bf16 casts + GEMM "
        f"{ms[3]:.3f} ms, selection + exact rescore {ms[4]:.3f} ms")
    torch.cuda.empty_cache()

    # kernel #2 at this index's shapes, where 197 of its 206 launches run
    from ircl_tpu_torch.ops.membership_cuda import membership_slab_windowed

    before = membership_slab_windowed.launches
    results["membership_slab_windowed"]["scale"] = compare_slabs(
        "phase 17", "membership_slab_windowed", membership_slab_windowed, {
            "bucket a": (u_pad, *ranker._heavy_a),
            "bucket b": (u_pad, *ranker._heavy_b),
            "query": (u_pad, qb_t, qw_t),
        })
    membership_slab_windowed.launches = before  # comparisons are not the path
    return index, qb, qw, cpu_results, ranker, dev_in, (s_st, i_st)


def phase18_onepass(dev, ranker, cpu_results, dev_in, staged, results):
    """Kernel #5 against its plain version on both buckets of phase 17's
    index, then ``hybrid_topk_onepass`` on phase 17's inputs."""
    import torch

    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops.fused_hybrid_cuda import (
        fused_hybrid_tile_topk, fused_hybrid_tile_topk_ref, hybrid_topk_onepass,
    )

    u_pad, qb_t, qw_t, ld, lc = dev_in
    B = ld.shape[0]
    wt = hy._query_slab(u_pad, qb_t, qw_t, hy._u_tile(u_pad.shape[0]), True)
    wt = wt[:, :B].contiguous()
    sd_t, sv_t = ld.T.contiguous(), lc.T.contiguous()
    na = ranker._heavy_a[0].shape[1]
    before = fused_hybrid_tile_topk.launches
    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 bound_dense_ms=0.0, library_ms=None)
    by = (0.0, "")
    for label, (terms, vals), base in (("bucket a", ranker._heavy_a, 0),
                                       ("bucket b", ranker._heavy_b, na)):
        d_tile = next(t for t in (1024, 512, 256) if terms.shape[1] % t == 0)
        args = (terms, vals, u_pad, wt, sd_t, sv_t)
        kw = dict(k=K, d_tile=d_tile, base=base)
        got = fused_hybrid_tile_topk(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = fused_hybrid_tile_topk_ref(*args, **kw)
        torch.cuda.synchronize()
        t_p = 1e3 * (time.perf_counter() - t0)  # one run: it takes seconds
        ok, err, n_ids = tiles_agree(got, ref, ONEPASS_RTOL)  # ids: equal outright
        if not ok:
            fail(f"phase 18: fused_hybrid_tile_topk ({label}) differs from its plain "
                 f"version: scores by {err}, {n_ids} positions")
        del ref
        torch.cuda.empty_cache()
        t_k = cuda_ms(lambda: fused_hybrid_tile_topk(*args, **kw), reps=3)
        # the work the function needs: one multiply-add a (hit, column) and
        # every input once (the kernel itself reads the ELL rows once a block
        # of 128 columns: that is its cost, not the function's)
        hits = int(torch.isin(terms, u_pad).sum())
        need = least_time((*args, *got), 2 * hits * B, F32_FLOPS)
        # the dense work the TPU kernel did: the slab product over every slot
        dense = least_time((), 2 * u_pad.shape[0] * terms.shape[1] * B, F32_FLOPS)
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["ms"] += t_k
        total["plain_ms"] += t_p
        total["bound_ms"] += need["bound_ms"]
        total["bound_dense_ms"] += dense["bound_ms"]
        by = max(by, (need["bound_ms"], need["bound_by"]))
        log(f"phase 18: fused_hybrid_tile_topk {label}: ELL [{terms.shape[0]}, "
            f"{terms.shape[1]}], U={u_pad.shape[0]}, B={B}, P={sd_t.shape[0]}, d_tile "
            f"{d_tile}, base {base}: per-tile scores within {err:.3g} of the plain "
            f"version (rtol {ONEPASS_RTOL}) and every position equal; "
            f"{hits} of {int((terms >= 0).sum())} ELL terms are in the union; kernel "
            f"{t_k:.3f} ms, plain {t_p:.1f} ms (one run), bound {need['bound_ms']:.3f} "
            f"ms by {need['bound_by']} for the work the function needs, "
            f"{dense['bound_ms']:.3f} ms for the TPU kernel's dense slab product")
        del got
    results["fused_hybrid_tile_topk"] = dict(total, bound_by=by[1])
    fused_hybrid_tile_topk.launches = before  # comparisons are not the path

    heavy = (*ranker._heavy_a, *ranker._heavy_b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    s, i = hybrid_topk_onepass(*heavy, *dev_in, k=K)
    s_np, i_np = ranker._finish_hybrid((s, i), B)
    peak = torch.cuda.max_memory_allocated() - base_mem
    s_st, i_st = staged
    close = np.isclose(s_np, s_st, rtol=ONEPASS_RTOL, atol=0.0)
    untied = ids_carry_scores(s_np, i_np, i_st, cpu_results)
    if not close.all() or untied:
        fail(f"phase 18: hybrid_topk_onepass leaves the staged engine's top-{K}: scores "
             f"by {np.abs(s_np - s_st).max()}, {untied} differing ids off a tie")
    bad = scale_gate(s_np, i_np, cpu_results, SCALE_PARITY)
    if bad:
        fail(f"phase 18: hybrid_topk_onepass failed the scipy gate on {bad} queries")
    t_one = cuda_ms(lambda: hybrid_topk_onepass(*heavy, *dev_in, k=K), reps=5)
    kw = dict(k=K, precision="high", queries_sorted=True, pools_sorted=True,
              d_tile=ranker.d_tile)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_staged = cuda_ms(lambda: hy.hybrid_topk_bucketed(*heavy, *dev_in, **kw), reps=5)
    peak_staged = torch.cuda.max_memory_allocated() - base_mem
    log(f"phase 18: hybrid_topk_onepass on phase 17's inputs: top-{K} equal to the "
        f"staged engine's (scores rtol {ONEPASS_RTOL}, max "
        f"{np.abs(s_np - s_st).max():.3g}; {int((i_np != i_st).sum())} ids differ, each "
        f"with its own scipy score: ties), scipy gate {SCALE_PARITY - bad}/"
        f"{SCALE_PARITY}; device ms a batch {t_one:.3f} against the staged engine's {t_staged:.3f}; peak memory "
        f"above the resident index {peak / 2**20:.1f} MiB against "
        f"{peak_staged / 2**20:.1f} MiB")


def phase19_chunked(dev, index, qb, qw, staged, cpu_results):
    """``ChunkedHybridRanker`` in two chunks against the single ranker."""
    import torch

    from ircl_tpu_torch.index.chunked import ChunkedHybridRanker

    t0 = time.perf_counter()
    chunked = ChunkedHybridRanker(
        index, dev, chunk_docs=SCALE_CHUNK,
        **{k: v for k, v in SCALE_RANKER.items() if k != "mode"})
    t_build = time.perf_counter() - t0
    if len(chunked.chunks) != -(-index.num_docs // SCALE_CHUNK):
        fail(f"phase 19: {len(chunked.chunks)} chunks")
    s, i = chunked.hybrid_from_vectors(qb, qw, K)
    s_st, i_st = staged
    close = np.isclose(s, s_st, rtol=1e-5, atol=0.0)
    untied = ids_carry_scores(s, i, i_st, cpu_results)
    if not close.all() or untied:
        fail(f"phase 19: the chunked ranker leaves the single ranker's top-{K}: "
             f"scores by {np.abs(s - s_st).max()}, {untied} differing ids off a tie")
    rounds = []
    for _ in range(3):  # bench_scale.py's chunked timing: 2 batches a round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            chunked.hybrid_from_vectors(qb, qw, K)
        rounds.append(2 * SCALE_B / (time.perf_counter() - t0))
    log(f"phase 19: ChunkedHybridRanker, {len(chunked.chunks)} chunks of {SCALE_CHUNK} "
        f"docs built in {t_build:.1f} s: top-{K} equal to the single ranker's (scores "
        f"rtol 1e-5, max {np.abs(s - s_st).max():.3g}; {int((i != i_st).sum())} ids "
        f"differ, each with its own scipy score: ties); "
        + ", ".join(f"{q:.1f}" for q in rounds) + " q/s")


def state_to(st, device):
    """A copy of a contrastive ``TrainState`` on ``device``."""
    from ircl_tpu_torch.contrastive.state import TrainState
    from ircl_tpu_torch.utils.tree import tree_map

    move = lambda x: x.to(device, copy=True) if hasattr(x, "to") else x  # noqa: E731
    return TrainState(**tree_map(move, vars(st)))


def profile_steps(step, st, batch, n):
    """``n`` steps under ``torch.profiler``: (state, launches a step, the
    device's idle share over the steps' span, device ms by kernel name, top
    first), or (state, None, None, {}) where the profiler saw no device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            st, _, _ = step(st, *batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return st, None, None, {}
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return st, len(kernels) / n, 1.0 - busy / span, top


def contrastive_stage_split(cfg, feat, st, batch):
    """Device ms of one train step by stage, from CUDA events between the
    stages that ``make_train_step`` runs, in its order (featurizer, BiLSTM
    forward of q with autograd and of k without, loss, backward, enqueue a
    micro-batch; then optimizer, EMA)."""
    import torch

    from ircl_tpu_torch.contrastive.losses import nt_xent_loss
    from ircl_tpu_torch.contrastive.state import global_norm, make_optimizer
    from ircl_tpu_torch.contrastive.train import _enqueue, ema_update
    from ircl_tpu_torch.models.encoder import seq2vec
    from ircl_tpu_torch.utils.precision import float32_precision
    from ircl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    eff = cfg.micro_batch * cfg.accum_steps
    flag = float(st.step >= cfg.queue_start_steps)
    with float32_precision():
        mark("start")
        views = tree_map(lambda t: t.detach().requires_grad_(), st.params_q)
        queue, ptr, grads = st.queue.clone(), st.queue_ptr, None
        for a in range(cfg.accum_steps):
            ids_a, mask_a, ids_k, mask_k = (x[a] for x in batch)
            with torch.no_grad():
                fa = feat.apply(feat.params, ids_a, mask_a)
                fk = feat.apply(feat.params, ids_k, mask_k)
            mark("featurizer")
            with torch.enable_grad():
                q = seq2vec(views, cfg.encoder, fa, mask_a)
            mark("BiLSTM forward, q")
            with torch.no_grad():
                k = seq2vec(st.params_k, cfg.encoder, fk, mask_k)
            mark("BiLSTM forward, k")
            with torch.enable_grad():
                loss = nt_xent_loss(q, k, cfg.temperature, queue, flag) / eff
            mark("loss")
            g = torch.autograd.grad(loss, tree_leaves(views))
            mark("backward")
            queue, ptr = _enqueue(queue, ptr, k, cfg.queue_size)
            mark("enqueue")
            grads = list(g) if grads is None else torch._foreach_add(grads, g)
        pq, _ = make_optimizer(cfg).update(st.params_q, tree_unflatten(st.params_q, grads),
                                           st.opt_state, global_norm(grads))
        mark("optimizer")
        ema_update(st.params_k, pq, cfg.momentum)
        mark("EMA")
    torch.cuda.synchronize()
    ms = {}
    for (_, e0), (name, e1) in zip(marks, marks[1:]):
        ms[name] = ms.get(name, 0.0) + e0.elapsed_time(e1)
    return ms


def phase20_contrastive_step(dev):
    """bench_train.py's compiled step on the card: one step against the CPU
    from one state, the queue switching on at ``queue_start_steps``, a
    bfloat16 step, then timed steps, their launches, idle share and stages."""
    import dataclasses

    import torch

    from ircl_tpu_torch.contrastive.state import TrainConfig, init_train_state
    from ircl_tpu_torch.contrastive.train import make_train_step
    from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer

    cfg = TrainConfig(**CT_TRAIN)
    enc = cfg.encoder
    t0 = time.perf_counter()
    fcfg = FeaturizerConfig(**CT_FEAT)
    feat_cpu = HashEmbedFeaturizer(fcfg, device="cpu")
    feat = HashEmbedFeaturizer(fcfg, device=dev, params=feat_cpu.params)
    rng = np.random.default_rng(0)  # bench_train.py:141-148
    shape = (cfg.accum_steps, cfg.micro_batch, fcfg.max_len)
    ids = rng.integers(0, fcfg.vocab_buckets, size=shape).astype(np.int32)
    ids_k = rng.integers(0, fcfg.vocab_buckets, size=shape).astype(np.int32)
    mask = (rng.random(shape) < 0.8).astype(np.float32)
    batch = (ids, mask, ids_k, mask)
    init = init_train_state(0, cfg, device="cpu")
    n_enc = sum(t.numel() for t in _leaves(init.params_q))
    log(f"phase 20: TrainConfig(): BiLSTM {enc.num_layers} x {enc.hidden_size} bi over "
        f"{enc.input_size}-d -> {enc.output_size} ({n_enc / 1e6:.2f}M params), "
        f"micro-batch {cfg.micro_batch} x {cfg.accum_steps}, L={fcfg.max_len}, queue "
        f"{cfg.queue_size}, T={cfg.temperature}, {cfg.optimizer} {cfg.learning_rate}, "
        f"clip {cfg.grad_clip}; hash featurizer table {tuple(feat.params['table'].shape)}; "
        f"set up in {time.perf_counter() - t0:.1f} s")

    # one step from one state on the card and on the CPU
    step = make_train_step(cfg, feat)
    t0 = time.perf_counter()
    s_d, l_d, n_d = step(state_to(init, dev), *batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_c, l_c, n_c = make_train_step(cfg, feat_cpu)(init, *batch)
    cpu_s = time.perf_counter() - t0
    del feat_cpu
    l_d, n_d, l_c, n_c = float(l_d), float(n_d), float(l_c), float(n_c)
    lr = cfg.learning_rate
    far, frac, moved = (0.0, ""), (0.0, ""), 0.0
    for tree in ("params_q", "params_k"):
        for (name, a), (_, b), (_, start) in zip(
                named_leaves(getattr(s_d, tree)), named_leaves(getattr(s_c, tree)),
                named_leaves(getattr(init, tree))):
            d = (a.cpu() - b).abs()
            far = max(far, (float(d.max()), tree + name))
            frac = max(frac, (float((d > 0.1 * lr).float().mean()), tree + name))
            moved = max(moved, float((a.cpu() - start).abs().max()))
    worst_m = [(0.0, ""), (0.0, "")]
    for i, key in enumerate(("mu", "nu")):
        for (name, a), (_, b) in zip(named_leaves(s_d.opt_state[key]),
                                     named_leaves(s_c.opt_state[key])):
            size = float(b.abs().max())
            worst_m[i] = max(worst_m[i], (float((a.cpu() - b).abs().max()) / max(size, 1e-30),
                                          key + name))
    q_err = float((s_d.queue.cpu() - s_c.queue).abs().max())
    if not (abs(l_d - l_c) <= CT_RTOL * abs(l_c) and abs(n_d - n_c) <= CT_RTOL * abs(n_c)
            and far[0] <= 2.1 * lr and frac[0] <= 1e-2 and moved >= 0.5 * lr
            and worst_m[0][0] <= CT_MOMENT_RTOL[0] and worst_m[1][0] <= CT_MOMENT_RTOL[1]
            and q_err <= CT_QUEUE_ATOL and s_d.queue_ptr == s_c.queue_ptr
            and s_d.step == s_c.step == 1
            and s_d.opt_state["count"] == s_c.opt_state["count"] == 1):
        fail(f"phase 20: one step on the card and on the CPU differ: loss {l_d} against "
             f"{l_c}, grad norm {n_d} against {n_c}, parameters by {far}, share over "
             f"lr/10 {frac}, moved {moved}, moments {worst_m}, queue {q_err}, pointer "
             f"{s_d.queue_ptr}/{s_c.queue_ptr}, step {s_d.step}/{s_c.step}")
    log(f"phase 20: one step on the card ({first_s:.2f} s, the first) and on the CPU "
        f"({cpu_s:.2f} s): loss {l_d:.7f} against {l_c:.7f}, grad norm {n_d:.6f} against "
        f"{n_c:.6f} (rtol {CT_RTOL}); params_q and params_k moved by up to {moved:.3g} "
        f"and differ by at most {far[0]:.3g} ({far[1]}; bound 2.1 x lr {lr}), the share "
        f"of a leaf's elements over lr/10 at most {frac[0]:.3g} ({frac[1]}; bound 1e-2); "
        f"mu within {worst_m[0][0]:.3g} and nu within {worst_m[1][0]:.3g} of each leaf's "
        f"largest element (bounds {CT_MOMENT_RTOL}); queue within {q_err:.3g} (bound "
        f"{CT_QUEUE_ATOL}); pointer {s_d.queue_ptr}, step {s_d.step} on both")
    del s_c

    # the queue term switches on at queue_start_steps
    dbatch = tuple(torch.as_tensor(x, device=dev) for x in batch)

    def two_losses(st):
        out = []
        for _ in range(2):
            st, loss, _ = step(st, *dbatch)
            out.append(float(loss))
        return out

    on = two_losses(dataclasses.replace(s_d, step=cfg.queue_start_steps - 1))
    off = two_losses(dataclasses.replace(s_d, step=0))
    if not (abs(on[0] - off[0]) <= 1e-6 * abs(off[0]) and on[1] > off[1]):
        fail(f"phase 20: queue activation: losses {on} with it at the second step, "
             f"{off} without")
    log(f"phase 20: from step {cfg.queue_start_steps - 1}, the queue term switches on "
        f"at the second step: losses {on[0]:.6f}, {on[1]:.6f} against {off[0]:.6f}, "
        f"{off[1]:.6f} without it (equal, then higher, as test_queue_activation_raises_loss "
        f"expects)")

    # a bfloat16 step from the same state
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    s_b, l_b, n_b = make_train_step(bcfg, feat)(state_to(init, dev), *dbatch)
    l_b, n_b = float(l_b), float(n_b)
    finite = all(bool(torch.isfinite(t).all()) for t in _leaves(s_b.params_q))
    if not (np.isfinite(l_b) and np.isfinite(n_b) and finite
            and s_b.queue.dtype == torch.float32 and bool(torch.isfinite(s_b.queue).all())):
        fail(f"phase 20: the bfloat16 step: loss {l_b}, grad norm {n_b}, params finite "
             f"{finite}, queue {s_b.queue.dtype}")
    log(f"phase 20: a bfloat16 step: loss {l_b:.6f} ({abs(l_b - l_d) / l_d:.3g} of the "
        f"f32 step's from the same state), grad norm {n_b:.6f}; finite, the queue float32")
    del s_b

    # timed steps: bench_train.py's 30 after warm-ups, on pre-staged batches
    st = s_d
    for _ in range(CT_WARMUP):
        st, loss, _ = step(st, *dbatch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    for _ in range(CT_TIMED_STEPS):
        st, loss, norm = step(st, *dbatch)
    e1.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dev_ms = e0.elapsed_time(e1) / CT_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (np.isfinite(float(loss)) and np.isfinite(float(norm))):
        fail(f"phase 20: timed steps end at loss {float(loss)}, grad norm {float(norm)}")
    st, launches, idle, top = profile_steps(step, st, dbatch, CT_PROFILED_STEPS)
    # the work a step needs: 4 passes of 2 x 2 FLOP a weight and token through
    # the BiLSTM and the projection (q and k forward, q backward twice), the
    # loss's products, at the f32 rate
    tokens = cfg.accum_steps * cfg.micro_batch * fcfg.max_len
    lstm_weights = sum(t.numel() for name, t in named_leaves(init.params_q)
                       if name.endswith(("w_ih", "w_hh", "proj_w")))
    flops = 4 * 2 * tokens * lstm_weights
    bound_ms = 1e3 * flops / F32_FLOPS
    log(f"phase 20: {CT_TIMED_STEPS} steps after {CT_WARMUP} warm-ups: "
        f"{CT_TIMED_STEPS / dt:.2f} steps/s ({CT_TIMED_STEPS / dt * tokens / fcfg.max_len:.0f}"
        f" pairs/s), {dev_ms:.2f} ms of device time a step (CUDA events), peak "
        f"{peak:.2f} GiB; the step's {flops / 1e12:.3f} TFLOP at the f32 rate: "
        f"{bound_ms:.2f} ms")
    if launches is None:
        log("phase 20: torch.profiler saw no device work: launches and idle share not "
            "measured")
    else:
        log(f"phase 20: torch.profiler over {CT_PROFILED_STEPS} steps: {launches:.0f} "
            f"CUDA kernel launches a step, device idle share {idle:.3f}; ms a step by "
            f"kernel: " + "; ".join(f"{k[:60]} {v:.2f}" for k, v in top.items()))
    first = sum(contrastive_stage_split(cfg, feat, st, dbatch).values())
    split = contrastive_stage_split(cfg, feat, st, dbatch)
    log(f"phase 20: one step by stage (CUDA events, ms; the second of two): " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()) + f"; sum {sum(split.values()):.2f} "
        f"(the first: {first:.2f})")
    return feat, dict(steps_per_s=CT_TIMED_STEPS / dt, device_ms=dev_ms, peak_gib=peak,
                      launches=launches, idle=idle)


def phase21_contrastive_trainer(dev, feat, tmpdir):
    """bench_train.py --e2e: ContrastiveTrainer over 2,000 synthetic docs with
    augment pairs, timed; its checkpoint round trip and resume; stage 2 from
    the trained state; then ProtoNCE at the reference's granularities over
    10,000 docs with two k-means refreshes on the card."""
    import dataclasses

    import torch

    from ircl_tpu_torch.contrastive.cluster import run_kmeans
    from ircl_tpu_torch.contrastive.state import TrainConfig, init_train_state
    from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
    from ircl_tpu_torch.corpus.synthetic import generate
    from ircl_tpu_torch.data.pairs import DocPairSampler
    from ircl_tpu_torch.dense.embed import embed_corpus
    from ircl_tpu_torch.pipeline.dense_scorer import ContrastiveSentenceScorer
    from ircl_tpu_torch.pipeline.intrinsic import mean_claim_evidence_cosine
    from ircl_tpu_torch.utils.checkpoint import latest_checkpoint, restore_state, save_state

    cfg = TrainConfig(**CT_TRAIN)
    t0 = time.perf_counter()
    # the docs come first from the generator, so they are num_claims=1's
    wiki = generate(num_docs=CT_E2E_DOCS, num_claims=CT_E2E_CLAIMS, seed=11)
    docs = list(wiki.sentences.values())
    kw = dict(ckptdir=os.path.join(tmpdir, "ct_ckpt"), logdir=os.path.join(tmpdir, "ct_log"),
              device=dev)
    tr = ContrastiveTrainer(cfg, feat, DocPairSampler(docs, sample="augment", seed=7), **kw)
    tr.train(total_steps=CT_E2E_WARMUP, log_step=10**9)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = tr.train(total_steps=CT_E2E_WARMUP + CT_E2E_STEPS, log_step=10**9)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(t).all()) for t in _leaves(state.params_q))
    if state.step != CT_E2E_WARMUP + CT_E2E_STEPS or not finite:
        fail(f"phase 21: the trainer ended at step {state.step}, params finite {finite}")
    e2e_sps = CT_E2E_STEPS / dt
    # the trainer's step alone, at once after, on the sampler's next batches
    # staged on the card: what the trainer's host work adds is the gap
    staged = [tuple(torch.as_tensor(x, device=dev) for x in b[1:])
              for b in tr.sampler.batches(feat, cfg.accum_steps, cfg.micro_batch,
                                          CT_STAGED_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = state
    for b in staged:
        st, _, _ = tr.step_fn(st, *b)
    torch.cuda.synchronize()
    staged_sps = CT_STAGED_STEPS / (time.perf_counter() - t0)
    del st, staged
    log(f"phase 21: ContrastiveTrainer over {len(docs)} docs (augment pairs): "
        f"{CT_E2E_WARMUP} warm-up steps in {warm_s:.1f} s (corpus and trainer built), "
        f"then {CT_E2E_STEPS} steps in {dt:.1f} s: {e2e_sps:.2f} steps/s, host pair "
        f"sampling and tokenization included; the same step on {CT_STAGED_STEPS} of "
        f"the sampler's batches staged on the card at once after: {staged_sps:.2f} "
        f"steps/s (the trainer's host work: {1 - e2e_sps / staged_sps:.3f} of its time)")

    # checkpoint: save, find, restore into a fresh state, resume
    path = save_state(kw["ckptdir"], tr.tag, state)
    if latest_checkpoint(kw["ckptdir"], tr.tag) != path:
        fail(f"phase 21: latest_checkpoint does not find {path}")
    back = restore_state(path, init_train_state(1, cfg, device=dev))
    for (name, a), (_, b) in zip(named_leaves(vars(back)), named_leaves(vars(state))):
        same = torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b
        if not same or (isinstance(b, torch.Tensor) and a.device != b.device):
            fail(f"phase 21: the restored {name} differs")
    fresh = ContrastiveTrainer(cfg, feat, DocPairSampler(docs, sample="augment"), **kw)
    if fresh.maybe_resume() != state.step:
        fail(f"phase 21: maybe_resume returned {fresh.state.step}, not {state.step}")
    log(f"phase 21: checkpoint {os.path.basename(path)} ({os.path.getsize(path) / 2**20:.1f}"
        f" MiB) restored bit for bit; a fresh trainer resumes at step {state.step}")
    del fresh, back

    # stage 2 from the trained state, against the untrained one
    for label, st in (("trained", state), ("untrained", init_train_state(1337, cfg, device=dev))):
        scorer = ContrastiveSentenceScorer(cfg, feat, st, batch_size=ENC_BATCH)
        res = mean_claim_evidence_cosine(scorer.embed, wiki.claims, wiki.sentences)
        log(f"phase 21: stage 2 from the {label} state: mean claim/evidence cosine "
            f"{res['mean_cosine']:.4f} over {res['pairs']} pairs, shuffled control "
            f"{res['shuffled_cosine']:.4f} (reported, not gated)")
    del tr, state

    # ProtoNCE at the reference's granularities, refreshed twice on the card
    t0 = time.perf_counter()
    pwiki = generate(num_docs=CT_PROTO_DOCS, num_claims=1, seed=11)
    pdocs = list(pwiki.sentences.values())
    pcfg = dataclasses.replace(cfg, loss="ProtoNCE", cluster_start_steps=0,
                               cluster_update_steps=CT_PROTO_EVERY)
    pkw = dict(kw, ckptdir=os.path.join(tmpdir, "ct_ckpt_proto"))
    ptr = ContrastiveTrainer(pcfg, feat, DocPairSampler(pdocs, sample="augment", seed=7),
                             **pkw)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pstate = ptr.train(total_steps=CT_PROTO_STEPS, log_step=CT_PROTO_LOG)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = [r["train_loss"] for r in map(json.loads, open(ptr.metrics.path))
              if "train_loss" in r]
    cr = ptr.cluster_result
    bad = []
    for g, (c, d, a) in enumerate(zip(cr.centroids, cr.density, cr.emb2cluster)):
        norms = torch.linalg.vector_norm(c, dim=1)
        if c.shape[0] != pcfg.num_clusters[g] or a.shape[0] != len(pdocs):
            bad.append(f"granularity {g}: shapes {tuple(c.shape)}, {tuple(a.shape)}")
        if float((norms - 1).abs().max()) > 1e-5:
            bad.append(f"granularity {g}: centroid norms off by {float((norms - 1).abs().max())}")
        if not bool(torch.isfinite(d).all()) or not bool((d > 0).all()) or (
                abs(float(d.mean()) - pcfg.temperature) > 1e-5):
            bad.append(f"granularity {g}: densities mean {float(d.mean())}")
    if (pstate.step != CT_PROTO_STEPS or ptr.refresh_count != 2
            or len(losses) != CT_PROTO_STEPS // CT_PROTO_LOG
            or not np.isfinite(losses).all() or bad):
        fail(f"phase 21: ProtoNCE: step {pstate.step}, refreshes {ptr.refresh_count}, "
             f"losses {losses}, {bad}")
    # one refresh's split, timed again on the trained state
    texts = [doc[0] if doc else "" for doc in ptr.sampler.docs]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    emb = embed_corpus(ptr.embed_fn, pstate.params_q, feat, texts)
    t2 = time.perf_counter()
    run_kmeans(emb, pcfg.num_clusters, pcfg.temperature, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"phase 21: ProtoNCE over {len(pdocs)} docs at num_clusters "
        f"{pcfg.num_clusters}, {pcfg.num_neg_proto} negative prototypes: "
        f"{CT_PROTO_STEPS} steps in {dt:.1f} s (set-up {setup_s:.1f} s) with "
        f"{ptr.refresh_count} refreshes, refresh_seconds {ptr.refresh_seconds:.2f}; "
        f"losses every {CT_PROTO_LOG} steps {', '.join(f'{x:.3f}' for x in losses)}; "
        f"centroids of unit norm, densities finite, positive, mean {pcfg.temperature} "
        f"within 1e-5")
    log(f"phase 21: one refresh again: embed {len(texts)} docs {t2 - t1:.2f} s, "
        f"run_kmeans {t3 - t2:.2f} s ({(t3 - t2) / (t3 - t1):.3f} of the refresh)")
    return e2e_sps, staged_sps, ptr.refresh_seconds


def named_leaves(tree, prefix=""):
    """(path, leaf) in ``utils/tree.py``'s order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def run_clients(call, n_clients, duration_s, queries, at_open=None):
    """``bench_serve.py::run_clients``: closed-loop clients, each sending
    one-query requests back to back until the deadline. Each client first
    sends one untimed request (an HTTP client opens its keep-alive
    connection there), and the window opens once every client has had its
    reply; ``at_open()``, where given, is read at that moment. Returns every
    (query, reply), the untimed ones included, and q/s with request
    p50/p95/p99 in ms (and ``opened``, what ``at_open`` returned). Two
    readings say where a tail comes from: ``max_gap_ms``, the longest time
    in the window in which no reply arrived (a stall of the whole server),
    and ``gc_ms``/``gc_max_ms``, the time Python's cyclic collector ran in
    the window, all of it and its longest pass (every thread waits on it)."""
    import threading

    lock = threading.Lock()
    lat, ends, replies, errors = [], [], [], []
    window = {}
    gc_start, gc_passes = [0.0], []

    def open_window():
        window["t0"] = time.monotonic()
        window["opened"] = at_open() if at_open else None

    def on_gc(phase, info):  # runs with the GIL held, in the collecting thread
        if phase == "start":
            gc_start[0] = time.monotonic()
        else:
            gc_passes.append((gc_start[0], time.monotonic() - gc_start[0]))

    gate = threading.Barrier(n_clients + 1, action=open_window)

    def client(seed):
        rng = np.random.default_rng(seed)
        mine_l, mine_e, mine_r = [], [], []
        try:
            q = queries[int(rng.integers(len(queries)))]
            mine_r.append((q, call([q])[0]))  # untimed: connects and warms
            gate.wait(timeout=duration_s + 120)
            stop = window["t0"] + duration_s
            while time.monotonic() < stop:
                q = queries[int(rng.integers(len(queries)))]
                t0 = time.monotonic()
                res = call([q])
                mine_e.append(time.monotonic())
                mine_l.append(mine_e[-1] - t0)
                mine_r.append((q, res[0]))
        except threading.BrokenBarrierError:
            pass  # another client failed first, and says why
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))
            gate.abort()
        with lock:
            lat.extend(mine_l)
            ends.extend(mine_e)
            replies.extend(mine_r)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    gc.callbacks.append(on_gc)
    try:
        for t in threads:
            t.start()
        try:
            gate.wait(timeout=duration_s + 120)
        except threading.BrokenBarrierError:
            pass  # a client failed or hung before the window: reported below
        for t in threads:
            t.join(timeout=duration_s + 120)
    finally:
        gc.callbacks.remove(on_gc)
    if any(t.is_alive() for t in threads):
        fail("phase 22: a client hung")
    if errors:
        fail(f"phase 22: {len(errors)} clients failed, e.g. {errors[0]}")
    if "t0" not in window:
        fail("phase 22: the clients' window never opened")
    dt = time.monotonic() - window["t0"]
    arr = np.sort(np.asarray(lat))
    pct = lambda p: 1e3 * float(arr[min(len(arr) - 1, int(p * len(arr)))])  # noqa: E731
    gaps = np.diff(np.sort(np.asarray([window["t0"], *ends])))
    in_window = [d for t, d in gc_passes if t >= window["t0"]]
    return replies, dict(clients=n_clients, requests=len(arr), qps=len(arr) / dt,
                         p50_ms=pct(0.5), p95_ms=pct(0.95), p99_ms=pct(0.99),
                         max_gap_ms=1e3 * float(gaps.max(initial=0.0)),
                         gc_ms=1e3 * sum(in_window), gc_max_ms=1e3 * max(in_window, default=0.0),
                         opened=window["opened"])


def http_caller(port, sentences=False):
    """A client's call over one keep-alive connection a thread."""
    import http.client
    import threading

    tls = threading.local()

    def call(qs):
        conn = getattr(tls, "conn", None)
        if conn is None:
            conn = tls.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        req = {"queries": qs, "sentences": True} if sentences else {"queries": qs}
        try:
            conn.request("POST", "/search", body=json.dumps(req).encode(),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            body = r.read()
        except Exception:
            tls.conn = None
            raise
        if r.status != 200:
            raise RuntimeError(f"HTTP {r.status}: {body[:200]!r}")
        return json.loads(body)["results"]

    return call


def http_exchange(port, method, path, body):
    """(status, body bytes) of one request on a fresh connection. A body of
    more than ``MAX_BODY_BYTES`` is announced and not sent: the client shuts
    its side after the headers, so each front answers 413 from the length."""
    import socket

    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        head = f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        if body is None:
            s.sendall(head.encode() + b"\r\n")
        elif isinstance(body, int):
            s.sendall(head.encode() + f"Content-Length: {body}\r\n\r\n".encode())
            s.shutdown(socket.SHUT_WR)
        else:
            s.sendall(head.encode() + f"Content-Length: {len(body)}\r\n\r\n".encode()
                      + body)
        buf = b""
        while True:
            got = s.recv(65536)
            if not got:
                break
            buf += got
    finally:
        s.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), rest


def same_doc_reply(got, want):
    """Doc results of one query: equal scores, bit for bit, and equal ids
    except among docs of exactly equal scores (which of them a top-k keeps,
    and in which order, may change with the batch)."""
    if [h["score"] for h in got] != [h["score"] for h in want]:
        return False
    by_score = lambda hits: {(h["score"], h["doc_id"]) for h in hits}  # noqa: E731
    last = want[-1]["score"] if want else None
    return ({x for x in by_score(got) if x[0] != last}
            == {x for x in by_score(want) if x[0] != last})


def same_sentence_reply(got, want):
    """Two-stage results of one query: equal (doc, sent) lists except across
    scores within SENT_RTOL of each other, scores within SENT_RTOL."""
    if len(got) != len(want):
        return False
    gs = np.array([h["score"] for h in got], np.float64)
    ws = np.array([h["score"] for h in want], np.float64)
    if not np.allclose(gs, ws, rtol=SENT_RTOL, atol=1e-7):
        return False
    if not len(ws):
        return True
    cut = ws.min() + SENT_RTOL * abs(ws.min()) + 1e-7
    key = lambda h: (h["doc_id"], h["sent_id"], h["sentence"])  # noqa: E731
    return ({key(h) for h in got if h["score"] > cut}
            == {key(h) for h in want if h["score"] > cut})


def profile_serving(service, call, clients, pool, seconds):
    """``run_clients`` under ``torch.profiler``: (device dispatches, device
    idle share over the window, device ms a dispatch, device ms a dispatch
    by kernel name, top first), or None where the profiler saw no device
    work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = service.metrics.snapshot()["device_batches"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_clients(call, clients, seconds, pool)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    d = service.metrics.snapshot()["device_batches"] - before
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels or not d:
        return None
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / d
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return d, 1.0 - busy / wall_us, busy / 1e3 / d, top


def phase22_serving(dev, path, index, claims, judged_ranker, sent_path, doc_sentences,
                    pre, mine, smi):
    """Served doc search under concurrent closed-loop clients (bench_serve.py's
    scenarios A and B) through the port's service, batcher and both HTTP fronts,
    and served sentence search under 64 clients; every reply checked."""
    import threading

    import torch

    import ircl_tpu_torch.ops.hybrid as hy
    from ircl_tpu_torch.ops.light_add_cuda import light_add_topk_t, light_add_topk_t_ref
    from ircl_tpu_torch.serve import BatchingService, RetrievalService, make_service, serve_http
    from ircl_tpu_torch.serve_native import native_available, serve_native_http

    if not native_available():
        fail("phase 22: native/libircl_http.so did not build or load")
    t0 = time.perf_counter()
    svc = make_service(path, batch_size=256, max_terms=24, union_cap=4096, mode="auto",
                       device=dev)  # cli serve's defaults
    if svc.ranker.mode != "hybrid":
        fail(f"phase 22: cli serve's defaults picked {svc.ranker.mode}, not hybrid")
    svc.warmup()
    queries = claims[:SERVE_QUERIES]
    want = {q: svc.search([q])[0] for q in queries}  # the unbatched answers
    log(f"phase 22: make_service at cli serve's defaults (hybrid, batch 256, max_terms "
        f"24, union_cap 4096), warmed, and {len(want)} unbatched answers in "
        f"{time.perf_counter() - t0:.1f} s")
    rows = []

    def scenario(name, service, call, clients, pool, answers, same=None):
        replies, stats = run_clients(
            call, clients, SERVE_SECONDS, pool,
            at_open=lambda: service.metrics.snapshot()["device_batches"])
        d = service.metrics.snapshot()["device_batches"] - stats.pop("opened")
        stats.update(scenario=name, device_batches=d,
                     queries_per_dispatch=stats["requests"] / d if d else None)
        same = same or same_doc_reply
        bad = [(q, r) for q, r in replies if not same(r, answers[q])]
        if bad:
            q, r = bad[0]
            fail(f"phase 22: {name} at {clients} clients: {len(bad)} of {len(replies)} "
                 f"replies differ from the unbatched service's, e.g. {q!r}: {r} against "
                 f"{answers[q]}")
        identical = sum(r == answers[q] for q, r in replies)
        rows.append(stats)
        log(f"phase 22: {name:>22} c={clients:>2}: {stats['qps']:9.1f} q/s, p50 "
            f"{stats['p50_ms']:.2f} p95 {stats['p95_ms']:.2f} p99 {stats['p99_ms']:.2f} ms, "
            f"{stats['queries_per_dispatch'] or 0:.2f} queries a dispatch, longest time "
            f"without a reply {stats['max_gap_ms']:.1f} ms, collector {stats['gc_ms']:.1f} "
            f"ms (longest pass {stats['gc_max_ms']:.1f}); "
            f"{len(replies)} replies equal the unbatched ones ({identical} identical, "
            f"the rest {'up to exact ties' if same is same_doc_reply else 'within rtol'})")
        return replies

    for c in SERVE_CLIENTS:
        scenario("service.search", svc, svc.search, c, queries, want)
    batcher = BatchingService(svc, max_wait_ms=SERVE_WAIT_MS)
    try:
        for c in SERVE_CLIENTS:
            scenario("BatchingService", svc, batcher.search, c, queries, want)
        prof = profile_serving(svc, batcher.search, SERVE_CLIENTS[-1], queries, 1.0)
    finally:
        batcher.close()
    if prof is None:
        log("phase 22: torch.profiler saw no device work: the idle share is not measured")
    else:
        d, idle, per, top = prof
        log(f"phase 22: BatchingService at {SERVE_CLIENTS[-1]} clients under "
            f"torch.profiler for 1 s: {d} dispatches, device idle share {idle:.3f}, "
            f"{per:.3f} ms of device time a dispatch; by kernel " +
            ", ".join(f"{k[:60]} {v:.3f}" for k, v in top.items()))
    want_json = {q: json.loads(json.dumps(r)) for q, r in want.items()}
    server = serve_http(svc, port=0, batch_wait_ms=SERVE_WAIT_MS)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    native = serve_native_http(svc, port=0, batch_wait_ms=SERVE_WAIT_MS,
                               workers=SERVE_WORKERS)
    try:
        ports = {"serve_http": server.server_address[1], "serve_native_http": native.port}
        sample = []
        for name, port in ports.items():
            for c in SERVE_CLIENTS:
                sample = scenario(name, svc, http_caller(port), c, queries, want_json)
        # a sample of the native front's replies at 64 clients against scipy
        t0 = time.perf_counter()
        rng = np.random.default_rng(22)
        picked = [sample[i] for i in rng.choice(len(sample), SERVE_SAMPLE, replace=False)]
        n = check_replies([{"results": [r for _, r in picked]}],
                          [([q for q, _ in picked], K)], index, "phase 22 sample")
        log(f"phase 22: {n} sampled replies of the native front match scipy (rtol 1e-4; "
            f"{time.perf_counter() - t0:.1f} s)")
        # the two fronts on a fixed set of requests, malformed ones included
        t0 = time.perf_counter()
        errors_before = svc.metrics.snapshot()["errors"]
        fixed = [
            ("POST", "/search", json.dumps({"queries": claims[:3], "k": 2}).encode(), 200),
            ("POST", "/search", json.dumps({"query": claims[3]}).encode(), 200),
            ("POST", "/search", b'{"queries": []}', 200),
            ("GET", "/healthz", None, 200),
            ("POST", "/search", b"{not json", 400),
            ("POST", "/search", b'{"queries": "a bare string"}', 400),
            ("POST", "/search", b"[1, 2]", 400),
            ("POST", "/search", json.dumps({"query": claims[4], "k": 0}).encode(), 400),
            ("POST", "/verdict", b'{"claims": ["x"]}', 400),  # no verdict stage
            ("POST", "/nope", b"{}", 404),
            ("GET", "/nope", None, 404),
            ("POST", "/search", 9 << 20, 413),
        ]
        malformed = 4  # the 400s that reach the shared handler (JSON decoded)
        for method, route, body, code in fixed:
            got = {name: http_exchange(port, method, route, body)
                   for name, port in ports.items()}
            (s1, b1), (s2, b2) = got.values()
            if not s1 == s2 == code:
                fail(f"phase 22: {method} {route}: status {s1} and {s2}, not {code}")
            if code != 413 and b1 != b2:
                fail(f"phase 22: {method} {route}: the fronts' bodies differ: {b1[:200]!r}"
                     f" against {b2[:200]!r}")
        errors = svc.metrics.snapshot()["errors"] - errors_before
        if errors != 2 * malformed or svc.metrics.snapshot()["errors"] != errors:
            fail(f"phase 22: ServiceMetrics.errors {svc.metrics.snapshot()['errors']}, "
                 f"{errors} in the fixed set; {2 * malformed} malformed requests sent")
        log(f"phase 22: the two fronts answer {len(fixed)} fixed requests with equal "
            f"status codes (200, 400, 404, 413) and equal bodies (the 413's body is the "
            f"C++ front's own); ServiceMetrics.errors {errors} = the malformed requests "
            f"({time.perf_counter() - t0:.1f} s)")
    finally:
        native.close()
        server.shutdown()
        server.server_close()
        server.batcher.close()
        th.join(timeout=60)
    del svc

    # the judged configuration served: its fused light path launches kernel #3
    t0 = time.perf_counter()
    jsvc = RetrievalService(judged_ranker, batch_size=256)
    jsvc.warmup()
    jwant = {q: jsvc.search([q])[0] for q in queries}
    log(f"phase 22: the judged ranker served, warmed and {len(jwant)} unbatched answers "
        f"in {time.perf_counter() - t0:.1f} s")
    served = []  # the first served batch's light-add inputs, copied

    def recording(h_t, docs_t, contribs_t, **kw):
        if not served:
            served.append((h_t.clone(), docs_t.clone(), contribs_t.clone(), kw))
        return light_add_topk_t(h_t, docs_t, contribs_t, **kw)

    batcher = BatchingService(jsvc, max_wait_ms=SERVE_WAIT_MS)
    hy.light_add_topk_t = recording
    try:
        jreplies = scenario("BatchingService, judged", jsvc, batcher.search,
                            SERVE_CLIENTS[-1], queries, jwant)
    finally:
        hy.light_add_topk_t = light_add_topk_t
        batcher.close()
    if not served:
        fail("phase 22: the judged service never reached light_add_topk_t")
    # a sample of its replies against scipy, vectorized as the ranker does
    t0 = time.perf_counter()
    rng = np.random.default_rng(23)
    picked = [jreplies[i] for i in rng.choice(len(jreplies), SERVE_SAMPLE, replace=False)]
    n = check_replies([{"results": [r for _, r in picked]}],
                      [([q for q, _ in picked], K)], index, "phase 22 judged sample",
                      max_terms=judged_ranker.fixed_max_terms)
    log(f"phase 22: {n} sampled replies of the judged service match scipy (rtol 1e-4; "
        f"{time.perf_counter() - t0:.1f} s)")
    # kernel #3 at the served shape and k_max against its plain version; these
    # launches are a comparison and do not count as the serving path's
    h_t, docs_t, contribs_t, kw = served[0]
    launched = light_add_topk_t.launches
    s1, i1 = light_add_topk_t(h_t, docs_t, contribs_t, **kw)
    ref_kw = {key: v for key, v in kw.items() if key != "b_tile"}
    s2, i2 = light_add_topk_t_ref(h_t, docs_t, contribs_t, **ref_kw)
    torch.cuda.synchronize()
    if not torch.allclose(s1, s2, rtol=1e-6, atol=0.0):
        fail(f"phase 22: light_add_topk_t at the served shape {tuple(h_t.shape)}, k="
             f"{kw['k']}: scores differ from its plain version")
    if not bool(((i1 == i2) | (s1 == s2)).all()):
        fail(f"phase 22: light_add_topk_t at the served shape {tuple(h_t.shape)}, k="
             f"{kw['k']}: ids differ from its plain version off a tie")
    lt_served = dict(
        h_t=list(h_t.shape), pool=docs_t.shape[0], k=kw["k"], d_tile=kw["d_tile"],
        body="column" if kw["k"] > 8 else "stream",  # light_add_topk.cu's kList
        max_abs_err=float((s1 - s2).abs().max()),
        ms=cuda_ms(lambda: light_add_topk_t(h_t, docs_t, contribs_t, **kw)),
        plain_ms=cuda_ms(lambda: light_add_topk_t_ref(h_t, docs_t, contribs_t, **ref_kw),
                         reps=2),
        **least_time((h_t, docs_t, contribs_t, s1, i1), h_t.numel() + docs_t.numel(),
                     F32_FLOPS / 2),
    )
    light_add_topk_t.launches = launched
    log(f"phase 22: light_add_topk_t at the judged service's first batch, H_T="
        f"{tuple(h_t.shape)} P={docs_t.shape[0]} k={kw['k']} (the {lt_served['body']} "
        f"body): within rtol 1e-6 of its plain version ({int((i1 != i2).sum())} ids "
        f"differ, all at ties); kernel {lt_served['ms']:.3f} ms, plain "
        f"{lt_served['plain_ms']:.3f} ms, bound {lt_served['bound_ms']:.3f} ms")
    del served, h_t, docs_t, contribs_t, s1, i1, s2, i2

    # served sentence search over phase 9's table, 64 clients through the native front
    ssvc = make_service(sent_path, device=dev, doc_sentences=doc_sentences,
                        sentence_scorer=pre)
    ssvc.warmup()
    pool = mine[:SERVE_SENT_QUERIES]
    t0 = time.perf_counter()
    swant = {q: json.loads(json.dumps(ssvc.search_sentences([q])[0])) for q in pool}
    log(f"phase 22: {len(swant)} unbatched sentence answers in "
        f"{time.perf_counter() - t0:.1f} s")
    native = serve_native_http(ssvc, port=0, batch_wait_ms=SERVE_WAIT_MS,
                               workers=SERVE_WORKERS)
    try:
        scenario("sentences, native", ssvc, http_caller(native.port, sentences=True),
                 SERVE_CLIENTS[-1], pool, swant, same=same_sentence_reply)
    finally:
        native.close()

    coalesced = {(r["scenario"], r["clients"]): r["queries_per_dispatch"] for r in rows}
    for name in ("BatchingService", "serve_http", "serve_native_http"):
        if not coalesced[(name, SERVE_CLIENTS[-1])] > 1.0:
            fail(f"phase 22: {name} did not coalesce at {SERVE_CLIENTS[-1]} clients: "
                 f"{coalesced[(name, SERVE_CLIENTS[-1])]} queries a dispatch")
    log(f"phase 22: {smi}; scenarios of {SERVE_SECONDS} s (bench_serve.py runs 8 s)")
    log("phase 22: serving " + json.dumps(rows))
    return lt_served


_CLI_WITH_COUNTS = r"""
import json, runpy, sys
from ircl_tpu_torch.ops.light_add_cuda import light_add_topk_t
from ircl_tpu_torch.ops.membership_cuda import membership_slab, membership_slab_windowed
from ircl_tpu_torch.ops.flash_attention_cuda import flash_attention

counted = dict(membership_slab=membership_slab,
               membership_slab_windowed=membership_slab_windowed,
               light_add_topk_t=light_add_topk_t, flash_attention=flash_attention)
try:
    runpy.run_module("ircl_tpu_torch.cli", run_name="__main__", alter_sys=True)
finally:
    print("KERNEL_LAUNCHES " + json.dumps({n: f.launches for n, f in counted.items()}),
          file=sys.stderr, flush=True)
"""


def cli_command(root, command, args, stdin=None):
    """``python -m ircl_tpu_torch.cli ARGS`` in a fresh process (run through
    runpy, so that the process can print its kernel launch counts after):
    (stdout, stderr, seconds, launches). Fails unless it exits 0 and says
    that ``command`` ran on the card."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_WITH_COUNTS, *args], cwd=root, input=stdin,
        capture_output=True, text=True, timeout=CLI_TIMEOUT,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 23: cli {' '.join(args)} exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    return proc.stdout, proc.stderr, seconds, cli_checks(command, proc.stderr)


def cli_checks(command, stderr):
    """The launch counts a CLI process printed; fails unless ``command``
    reported the device cuda."""
    if f"ircl_tpu_torch.cli {command}: device cuda" not in stderr:
        fail(f"phase 23: cli {command} did not report the device cuda: {stderr[-2000:]}")
    line = next(ln for ln in stderr.splitlines() if ln.startswith("KERNEL_LAUNCHES "))
    return json.loads(line.split(" ", 1)[1])


def phase23_cli(dev, root, tmpdir, smi):
    """The whole CLI chain on a synthetic corpus, each command in a fresh
    process on the card, its outputs checked against the port's API in this
    process."""
    import signal
    import threading

    import torch

    from ircl_tpu_torch.config import load_config
    from ircl_tpu_torch.contrastive.state import init_train_state
    from ircl_tpu_torch.corpus import fever
    from ircl_tpu_torch.corpus.store import MemoryDocStore
    from ircl_tpu_torch.index.build import CountIndex, build_count_index
    from ircl_tpu_torch.index.ranker import TfidfRanker
    from ircl_tpu_torch.index.tfidf import tfidf_transform
    from ircl_tpu_torch.models.featurizer import HashEmbedFeaturizer
    from ircl_tpu_torch.pipeline.dense_scorer import (
        ContrastiveSentenceScorer, PrecomputedSentenceScorer,
    )
    from ircl_tpu_torch.pipeline.recall import doc_recall_at_k, sentence_recall_at_k
    from ircl_tpu_torch.pipeline.retrieve import retrieve
    from ircl_tpu_torch.serve import make_service
    from ircl_tpu_torch.utils.checkpoint import restore_state

    ws = os.path.join(tmpdir, "cli")
    data = os.path.join(ws, "data")
    cfg_path = os.path.join(ws, "cfg.json")
    os.makedirs(ws)
    with open(cfg_path, "w") as f:
        json.dump({
            "data": {"data_dir": data, "wiki_json": f"{data}/small_wiki.json",
                     "dev_jsonl": f"{data}/shared_task_dev.jsonl", "synthetic": True,
                     "synthetic_docs": CLI_DOCS, "synthetic_claims": CLI_CLAIMS},
            "ckptdir": f"{ws}/ckpt", "logdir": f"{ws}/log",
        }, f)
    base = ["--config", cfg_path]
    verdict_sets = ["--set", "verdict.epochs=1", "--set", "verdict.warmup_steps=5"]
    seconds, launches = {}, {}

    def run(name, args, stdin=None):
        out, err, secs, counts = cli_command(root, name.split()[0], [*base, *args], stdin)
        seconds[name], launches[name] = round(secs, 2), counts
        log(f"phase 23: cli {name}: {secs:.1f} s, exit 0 on cuda; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        return out, err

    run("prepare", ["prepare"])
    run("build-index", ["build-index"])
    out, _ = run("train", ["train", "--steps", str(CLI_TRAIN_STEPS), "--log-step", "10"])
    if f"finished at step {CLI_TRAIN_STEPS}" not in out:
        fail(f"phase 23: train did not finish: {out[-500:]}")
    ckpt = f"{ws}/ckpt/uniform_InfoNCE_LSTM_{CLI_TRAIN_STEPS}"
    out, _ = run("retrieve", ["retrieve", "--dense-ckpt", ckpt, "--out", f"{ws}/res.jsonl"])
    recall = json.loads(out.strip().splitlines()[-1])
    out, _ = run("train-verdict", [*verdict_sets, "train-verdict"])
    history = json.loads(out.strip().splitlines()[-1])
    if not history or not all(np.isfinite(h["train_loss"]) for h in history):
        fail(f"phase 23: train-verdict history {history}")
    out, _ = run("eval-verdict", ["eval-verdict", "--retrieved", f"{ws}/res.jsonl"])
    report = json.loads(out.strip().splitlines()[-1])
    if not 0.0 <= report["macro_f1"] <= 1.0:
        fail(f"phase 23: eval-verdict report {report}")

    # retrieve's recall, recomputed in this process through the port's API
    cfg = load_config(cfg_path)
    wiki = fever.load_wiki_json(cfg.data.wiki_json)
    store = MemoryDocStore({d: r.get("text", "") for d, r in wiki.items()})
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=cfg.index.hash_size))
    claims = fever.parse_claims_jsonl(cfg.data.dev_jsonl, drop_nei=True)
    doc_sents = {d: fever.parse_lines_tab(r["lines"]) for d, r in wiki.items()}
    state = restore_state(ckpt, init_train_state(0, cfg.train, device=dev))
    scorer = ContrastiveSentenceScorer(cfg.train, HashEmbedFeaturizer(cfg.featurizer, dev),
                                       state)
    res = retrieve([c.claim for c in claims], TfidfRanker(index, dev, mode=cfg.index.mode),
                   doc_sents, scorer, k_docs=cfg.retrieval.k_docs,
                   k_sents=cfg.retrieval.k_sents, batch_size=cfg.retrieval.batch_size)
    mine = {"doc_recall@k": doc_recall_at_k(claims, res.doc_ids, k=cfg.retrieval.k_docs),
            "sentence_recall@k": sentence_recall_at_k(claims, res.sentences,
                                                      k=cfg.retrieval.k_sents)}
    if recall != mine:
        fail(f"phase 23: retrieve's recall {recall} != {mine} computed in this process")
    log(f"phase 23: retrieve's recall {recall} equals this process's; eval-verdict "
        f"macro F1 {report['macro_f1']:.3f}; train-verdict loss "
        f"{history[-1]['train_loss']:.4f}")

    # served stage 1, 2 and 3, stdin, against scipy and this process's service
    texts = [c.claim for c in claims]
    serve_args = ["serve", "--dense-ckpt", ckpt, "--verdict-ckpt", cfg.ckptdir]
    lines = [json.dumps({"queries": texts[:20]}), json.dumps({"query": texts[20], "k": 3}),
             json.dumps({"queries": texts[21:31], "sentences": True}),
             json.dumps({"claims": texts[31:39]}), '{"queries": 3}']
    out, _ = run("serve --stdin", [*serve_args, "--stdin"], stdin="\n".join(lines) + "\n")
    replies = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    tfidf = CountIndex.load(os.path.join(
        data, "index", f"tfidf-ngram=2-hash={cfg.index.hash_size}.npz"))
    n = check_replies(replies[:2] + [replies[4]],
                      [(texts[:20], 5), ([texts[20]], 3), None], tfidf, "phase 23 docs")
    embed = ContrastiveSentenceScorer(cfg.train, HashEmbedFeaturizer(cfg.featurizer, dev),
                                      state, batch_size=256).embed
    svc = make_service(os.path.join(data, "index",
                                    f"tfidf-ngram=2-hash={cfg.index.hash_size}.npz"),
                       doc_sentences=doc_sents,
                       sentence_scorer=PrecomputedSentenceScorer(embed, doc_sents),
                       device=dev)
    sents = json.loads(json.dumps(svc.search_sentences(texts[21:39])))
    got = replies[2]["results"] + [v["evidence"] for v in replies[3]["results"]]
    if len(got) != len(sents) or not all(
            same_sentence_reply(g, w) for g, w in zip(got, sents)):
        fail("phase 23: served sentences or claim evidence differ from search_sentences")
    if not all(v["label"] in ("SUPPORTS", "REFUTES") for v in replies[3]["results"]):
        fail(f"phase 23: claim replies {replies[3]}")
    log(f"phase 23: serve --stdin: {n} doc results match scipy (rtol 1e-4); 10 sentence "
        f"results and 8 claims' evidence equal search_sentences in this process")

    # the native front, stopped by a signal
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _CLI_WITH_COUNTS, *base, *serve_args, "--native-front",
         "--batch-wait-ms", "5", "--port", "0"],
        cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    err_lines, ready = [], threading.Event()

    def pump():
        for ln in proc.stderr:
            err_lines.append(ln)
            if ln.startswith("serving on http://") or "falling back" in ln:
                ready.set()

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    try:
        if not ready.wait(CLI_TIMEOUT):
            fail(f"phase 23: serve --native-front never listened: {''.join(err_lines)[-2000:]}")
        said = "".join(err_lines)
        if "falling back to the stdlib transport" in said or not any(
                ln.startswith("serving on http://") and "(native epoll front" in ln
                for ln in err_lines):
            fail(f"phase 23: serve --native-front did not serve through the native "
                 f"front: {said[-2000:]}")
        port = int(next(ln for ln in err_lines if ln.startswith("serving on"))
                   .split(":")[2].split(" ")[0])
        doc = http_exchange(port, "POST", "/search",
                            json.dumps({"queries": texts[40:50]}).encode())
        sent = http_exchange(port, "POST", "/search",
                             json.dumps({"query": texts[50], "sentences": True}).encode())
        verdict = http_exchange(port, "POST", "/verdict",
                                json.dumps({"claim": texts[51]}).encode())
        if (doc[0], sent[0], verdict[0]) != (200, 200, 200):
            fail(f"phase 23: native front answered {doc[0]}, {sent[0]}, {verdict[0]}")
        check_replies([json.loads(doc[1])], [(texts[40:50], 5)], tfidf, "phase 23 native")
        want = json.loads(json.dumps(svc.search_sentences([texts[50], texts[51]])))
        if not (same_sentence_reply(json.loads(sent[1])["results"][0], want[0]) and
                same_sentence_reply(json.loads(verdict[1])["results"][0]["evidence"],
                                    want[1])):
            fail("phase 23: the native front's sentences differ from search_sentences")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    pumper.join(timeout=60)
    if rc != 0:
        fail(f"phase 23: serve --native-front exited {rc} on SIGINT: "
             f"{''.join(err_lines)[-2000:]}")
    name = "serve --native-front"
    seconds[name] = round(time.perf_counter() - t0, 2)
    launches[name] = cli_checks("serve", "".join(err_lines))
    log(f"phase 23: cli {name}: answered a doc, a sentence and a claim request, stopped "
        f"by SIGINT with exit 0 in {seconds[name]:.1f} s; launches "
        f"{ {k: v for k, v in launches[name].items() if v} }")
    for name in ("retrieve", "serve --stdin", "serve --native-front"):
        if launches[name]["membership_slab"] == 0:
            fail(f"phase 23: cli {name} did not launch membership_slab")
    log(f"phase 23: {smi}; seconds by command {json.dumps(seconds)}")
    del svc, state, scorer
    torch.cuda.empty_cache()
    return seconds, launches


def rel_l2(a, b) -> float:
    """Relative L2 distance of tensor ``a`` from ``b``, in f64."""
    import torch

    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def spy_on(module, name, record):
    """Wrap ``module.name`` so that each call also runs ``record(args,
    result)``; returns the function that undoes it."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        record(args, out)
        return out

    setattr(module, name, spy)
    return lambda: setattr(module, name, real)


def batch_tensors(batch, device):
    """``train_batch``'s arrays as the step's tensors on ``device``."""
    import torch

    ids, mask, types, labels = batch
    return (torch.as_tensor(ids, device=device).long(),
            torch.as_tensor(mask, device=device),
            torch.as_tensor(types, device=device).long(),
            torch.as_tensor(labels, device=device).long())


def step_on(cfg, init, batch, device, count):
    """One train step from ``init`` (copied to ``device``) with the
    optimizer's count set: (loss, predictions, parameters on the CPU)."""
    from ircl_tpu_torch.utils.convert import to_device
    from ircl_tpu_torch.utils.tree import tree_map
    from ircl_tpu_torch.verdict.model import make_verdict_train_step

    p = tree_map(lambda t: t.to(device, copy=True), init)  # updated in place
    step, tx = make_verdict_train_step(cfg, device=device)
    state = dict(tx.init(p), count=count)
    _, _, loss, preds = step(p, state, count, *batch)
    return float(loss), preds.cpu(), to_device(p, "cpu")


def params_after_one_step_agree(names, got, want, start):
    """Phase 14's rule for one step's parameters from two devices: (ok,
    largest difference, largest share of a leaf over a tenth of the learning
    rate (k/b leaves apart), largest move)."""
    far, frac, moved = (0.0, ""), (0.0, ""), 0.0
    for name, a, b, s in zip(names, got, want, start):
        d = (a - b).abs()
        far = max(far, (float(d.max()), name))
        moved = max(moved, float((a - s).abs().max()))
        if not name.endswith("/k/b"):
            frac = max(frac, (float((d > 0.1 * TRAIN_LR).float().mean()), name))
    ok = far[0] <= 2.1 * TRAIN_LR and frac[0] <= 1e-2 and moved >= 0.25 * TRAIN_LR
    return ok, far, frac, moved


def timed_steps(cfg, init, batch, dev, counters, n):
    """``n`` steps past the warmup after one untimed: (steps/s, device ms a
    step, peak GiB, launches a step of each counter)."""
    import torch

    from ircl_tpu_torch.utils.convert import to_device
    from ircl_tpu_torch.verdict.model import make_verdict_train_step

    p = to_device(init, dev)
    step, tx = make_verdict_train_step(cfg, device=dev)
    state = dict(tx.init(p), count=TRAIN_WARMUP)
    step(p, state, TRAIN_WARMUP, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = [fn.launches for fn in counters]
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    for s in range(n):
        _, _, loss, _ = step(p, state, TRAIN_WARMUP + 1 + s, *batch)
    e1.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not np.isfinite(float(loss)):
        fail(f"timed steps: loss {float(loss)}")
    return (n / dt, e0.elapsed_time(e1) / n, torch.cuda.max_memory_allocated() / 2**30,
            [(fn.launches - b) / n for fn, b in zip(counters, before)])


def phase24_bf16_verdict(dev, tok, pairs):
    """The verdict model in bfloat16 at roberta-base width (``bench_verdict.py
    --dtypes bf16``): the forward at B=32 on flash and "xla" beside the f32
    forward on the same weights; the flash kernels fed f32 q, k and v; a cut
    batch's gradients and one step, card against CPU; the freeze; timed
    steps of f32 and bf16 in turns."""
    import dataclasses

    import torch

    import ircl_tpu_torch.models.transformer as tf_mod
    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.ops.flash_attention_cuda import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    )
    from ircl_tpu_torch.utils.convert import to_device
    from ircl_tpu_torch.utils.precision import float32_precision
    from ircl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
    from ircl_tpu_torch.verdict.model import (
        VerdictConfig, init_verdict_params, make_verdict_train_step, verdict_apply,
    )

    enc32 = TransformerConfig(**VERDICT_ENCODER)
    enc16 = dataclasses.replace(enc32, dtype=torch.bfloat16)
    kw = dict(max_length=VERDICT_L, learning_rate=TRAIN_LR,
              warmup_steps=TRAIN_WARMUP, total_steps=200)
    cfg16, cfg32 = VerdictConfig(encoder=enc16, **kw), VerdictConfig(encoder=enc32, **kw)
    xla16 = dataclasses.replace(cfg16, encoder=dataclasses.replace(enc16, attention="xla"))
    init = init_verdict_params(torch.Generator().manual_seed(VERDICT_SEED), cfg32, "cpu")
    names = [n for n, _ in named_leaves(init)]
    params = to_device(init, dev)
    counters = (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    log(f"phase 24: verdict model {enc16.layers} x {enc16.hidden} in bfloat16 "
        f"(the reference's roundings; f32 weights), L={VERDICT_L}")

    # the forward at B=32: bf16 flash (q, k, v recorded at the kernel's
    # wrapper), bf16 xla, f32 flash
    batch = pairs[:VERDICT_BATCH]
    ids, mask, types = (torch.as_tensor(x, device=dev)
                        for x in tok.encode_batch(batch, VERDICT_L))
    ids, types = ids.long(), types.long()
    seen = []
    undo = spy_on(tf_mod, "flash_attention",
                  lambda args, _: seen.append(tuple(t.dtype for t in args[:3])))
    try:
        before = flash_attention.launches
        l16 = verdict_apply(params, cfg16, ids, mask, types)
        launched = flash_attention.launches - before
    finally:
        undo()
    if seen != [(torch.float32,) * 3] * enc16.layers or launched != enc16.layers:
        fail(f"phase 24: the bf16 model's flash calls took {seen} and launched "
             f"{launched} kernels, not {enc16.layers} on f32 q, k and v")
    l16x = verdict_apply(params, xla16, ids, mask, types)
    l32 = verdict_apply(params, cfg32, ids, mask, types)
    # the two paths round at other places (xla rounds the probabilities,
    # flash only its output), so each is held to the f32 logits
    shift, shift_x = rel_l2(l16, l32), rel_l2(l16x, l32)
    if not (torch.isfinite(l16).all() and torch.isfinite(l16x).all()) or not all(
            BF16_SHIFT_MIN < d < BF16_SHIFT_MAX for d in (shift, shift_x)):
        fail(f"phase 24: bf16 logits {shift} (flash) and {shift_x} (xla) from the "
             f"f32 ones; bounds {BF16_SHIFT_MIN}, {BF16_SHIFT_MAX}")
    log(f"phase 24: {VERDICT_BATCH} pairs: {enc16.layers} flash launches on f32 q, k, "
        f"v; bf16 logits {shift:.3g} (flash) and {shift_x:.3g} (xla) from the f32 "
        f"ones on the same weights, relative L2 (bounds {BF16_SHIFT_MIN}, "
        f"{BF16_SHIFT_MAX}); bf16 flash {rel_l2(l16, l16x):.3g} from bf16 xla")
    fwd = {}
    for label, c in (("f32", cfg32), ("bf16", cfg16), ("bf16", cfg16), ("f32", cfg32)):
        fwd.setdefault(label, []).append(
            cuda_ms(lambda: verdict_apply(params, c, ids, mask, types), reps=5))
    log(f"phase 24: the forward at B={VERDICT_BATCH}, L={VERDICT_L}, in turns: "
        + "; ".join(f"{k} {', '.join(f'{v:.2f}' for v in vs)} ms"
                    for k, vs in fwd.items()))

    # each block, and the embedding, from the CPU's own input: forward and
    # backward (a seeded cotangent) on the card against the CPU, within a
    # quarter of the same block's bf16-against-f32 distance on the card. A
    # block is compared alone because the whole model is not: f32 noise tips
    # a few bf16 roundings in every layer, and the tips compound with depth
    # (after 12 layers the hidden states of card and CPU are ~0.3 of the
    # bf16-against-f32 distance apart on an H100 80GB HBM3 at 700 W)
    t0 = time.perf_counter()
    small = train_batch(tok, pairs, (5, 16), 15)
    s_ids, s_mask, s_types, _ = batch_tensors(small, "cpu")
    with torch.no_grad(), float32_precision():
        x = tf_mod.transformer_embed(init["body"], enc16, s_ids, s_types)
    g = torch.from_numpy(np.random.default_rng(24).standard_normal(
        x.shape).astype(np.float32))

    def vjp(fn, tree, x_in, device):
        """The output of ``fn(x, tree)`` and its gradients for ``x`` (if
        given) and every leaf of ``tree``, by the seeded cotangent."""
        leaves = [t.to(device).detach().requires_grad_() for t in tree_leaves(tree)]
        x_v = None if x_in is None else x_in.to(device).detach().requires_grad_()
        with torch.enable_grad(), float32_precision():
            y = fn(x_v, tree_unflatten(tree, leaves))
            grads = torch.autograd.grad(
                y, leaves if x_v is None else [x_v, *leaves], g.to(device))
        return [y.detach().cpu(), *(t.cpu() for t in grads)]

    emb = {k: init["body"][k] for k in ("tok_emb", "pos_emb", "type_emb", "emb_ln")}
    cases = [("embedding", emb, None)] + [
        (f"block {i}", lp, [n for n, _ in named_leaves(lp)])
        for i, lp in enumerate(init["body"]["layers"])]
    worst = (0.0, "")
    for label, tree, lp_names in cases:
        def fn(x_v, t, enc):
            if x_v is None:
                return tf_mod.transformer_embed(t, enc, s_ids.to(t["tok_emb"].device),
                                                s_types.to(t["tok_emb"].device))
            seg = tf_mod.attention_mask_inputs(enc, s_mask.to(x_v.device))
            return tf_mod.transformer_block(x_v, t, enc, seg)

        x_in = None if lp_names is None else x
        outs = {tag: vjp(lambda x_v, t: fn(x_v, t, enc), tree, x_in, device)
                for tag, enc, device in (("d", enc16, dev), ("c", enc16, "cpu"),
                                         ("f", enc32, dev))}
        names_j = ["output"] + (["x"] + lp_names if lp_names else
                                [n for n, _ in named_leaves(tree)])
        for name, a, b, f in zip(names_j, outs["d"], outs["c"], outs["f"]):
            if not torch.isfinite(a).all():
                fail(f"phase 24: {label}: {name} is not finite")
            if name == "/k/b":  # zero in exact arithmetic: noise on both
                continue
            # a gradient that no bf16 rounding reaches (ff_ln's bias is the
            # cotangent's sum) is held to f32 noise alone
            allowed = BF16_QUARTER * rel_l2(a, f) + F32_REL_NOISE
            worst = max(worst, (rel_l2(a, b) / allowed, f"{label} {name}"))
        x = outs["c"][0]  # the next block's input: the CPU's bf16 output
    if worst[0] > 1.0:
        fail(f"phase 24: a bf16 block on the card and the CPU differ by {worst} of "
             f"{BF16_QUARTER} of its bf16-against-f32 distance + {F32_REL_NOISE}")
    log(f"phase 24: the embedding and {enc16.layers} blocks, each from the CPU's "
        f"input, bf16 on the card against the CPU at B=2: outputs and every "
        f"gradient within {worst[0]:.3g} of their bound ({worst[1]}; bound "
        f"{BF16_QUARTER} of the bf16-against-f32 distance + {F32_REL_NOISE}); "
        f"{time.perf_counter() - t0:.1f} s")

    # one step of the cut batch from a count past the warmup
    t0 = time.perf_counter()
    (l_d, p_d, w_d), (l_c, p_c, w_c) = (
        step_on(cfg16, init, small, device, TRAIN_WARMUP) for device in (dev, "cpu"))
    ok, far, frac, moved = params_after_one_step_agree(
        names, tree_leaves(w_d), tree_leaves(w_c), tree_leaves(init))
    if abs(l_d - l_c) > BF16_LOSS_ATOL or not torch.equal(p_d, p_c) or not ok:
        fail(f"phase 24: one bf16 step on the card and the CPU differ: loss {l_d} "
             f"against {l_c}, parameters by {far}, share over lr/10 {frac}, "
             f"moved {moved}")
    log(f"phase 24: one bf16 step of 2 pairs, flash, card against CPU: loss {l_d:.6f} "
        f"against {l_c:.6f}, predictions equal, parameters apart by at most "
        f"{far[0]:.3g} ({far[1]}), share over lr/10 at most {frac[0]:.3g} "
        f"({frac[1]}; phase 14's bounds); {time.perf_counter() - t0:.1f} s")
    del w_d, w_c

    # the freeze, at B=8
    step, tx = make_verdict_train_step(cfg16, device=dev)
    state = tx.init(params)
    start = tree_map(torch.clone, params)
    rows = lambda s: [(7 * s + i) % len(pairs) for i in range(TRAIN_BATCH)]  # noqa: E731
    losses = []
    for s in range(TRAIN_WARMUP + 2):
        before = [fn.launches for fn in counters]
        _, _, loss, _ = step(params, state, s, *train_batch(tok, pairs, rows(s), s))
        per_step = [fn.launches - b for fn, b in zip(counters, before)]
        body_same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params["body"]), tree_leaves(start["body"])))
        if per_step != [enc16.layers] * 3 or body_same != (s < TRAIN_WARMUP):
            fail(f"phase 24: step {s}: launches {per_step}, body unchanged {body_same}")
        losses.append(float(loss))
    if not np.isfinite(losses).all():
        fail(f"phase 24: losses {losses}")
    log(f"phase 24: bf16 steps 0-{TRAIN_WARMUP + 1} at B={TRAIN_BATCH}: the body "
        f"frozen until step {TRAIN_WARMUP}, {enc16.layers} forward, dK/dV and dQ "
        f"launches a step; losses {', '.join(f'{x:.4f}' for x in losses)}")
    del params, state, start

    # timed steps, f32 and bf16 in turns
    fixed = train_batch(tok, pairs, rows(1), 1)
    runs = {}
    for label, c in (("f32", cfg32), ("bf16", cfg16), ("bf16", cfg16), ("f32", cfg32)):
        runs.setdefault(label, []).append(
            timed_steps(c, init, fixed, dev, counters, BF16_TIMED_STEPS))
    for label, rs in runs.items():
        if any(r[3] != [enc16.layers] * 3 for r in rs):
            fail(f"phase 24: {label}: launches a step {[r[3] for r in rs]}")
        log(f"phase 24: {label} train step, B={TRAIN_BATCH}, {BF16_TIMED_STEPS} "
            "steps, two runs in turns: " + "; ".join(
                f"{sps:.2f} steps/s, {ms:.2f} ms of device time a step, peak "
                f"{gib:.2f} GiB" for sps, ms, gib, _ in rs))


def route_margins(probs, top_k):
    """Each token's gap between its k-th and (k+1)-th router probability,
    relative to the k-th."""
    import torch

    top = torch.sort(probs.double(), dim=-1, descending=True).values
    return (top[..., top_k - 1] - top[..., top_k]) / top[..., top_k - 1]


def phase25_moe_verdict(dev, tok, pairs):
    """The MoE verdict model (``bench_verdict.py --moe-experts 8``:
    ``MoEConfig()``, 8 experts, top-2, capacity factor 1.25) on phase 11's
    encoder, f32, flash: its routes at B=8, one cut step card against CPU,
    a bf16 + MoE step, timed steps and prediction at B=64."""
    import dataclasses

    import torch

    import ircl_tpu_torch.models.moe as moe_mod
    from ircl_tpu_torch.models.moe import MoEConfig, moe_capacity
    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.ops.flash_attention_cuda import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    )
    from ircl_tpu_torch.utils.convert import to_device
    from ircl_tpu_torch.utils.tree import tree_leaves
    from ircl_tpu_torch.verdict.model import (
        VerdictConfig, init_verdict_params, verdict_apply_with_aux, verdict_predict,
    )

    t0 = time.perf_counter()
    enc = TransformerConfig(**VERDICT_ENCODER, moe=MoEConfig())
    cfg = VerdictConfig(encoder=enc, max_length=VERDICT_L, learning_rate=TRAIN_LR,
                        warmup_steps=TRAIN_WARMUP, total_steps=200)
    init = init_verdict_params(torch.Generator().manual_seed(VERDICT_SEED), cfg, "cpu")
    names = [n for n, _ in named_leaves(init)]
    params = to_device(init, dev)
    C, k = moe_capacity(VERDICT_L, enc.moe), enc.moe.top_k
    counters = (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    log(f"phase 25: MoE verdict model {enc.layers} x {enc.hidden}, "
        f"{enc.moe.num_experts} experts of {enc.intermediate}, top-{k}, capacity "
        f"factor {enc.moe.capacity_factor}: C = {C} slots an expert at L={VERDICT_L} "
        f"({sum(t.numel() for t in tree_leaves(init)) / 1e6:.1f}M params); built in "
        f"{time.perf_counter() - t0:.1f} s")
    if C != 160:
        fail(f"phase 25: capacity {C}, not 160")

    def record_routes(calls):
        return spy_on(moe_mod, "moe_route", lambda args, out: calls.append((
            torch.softmax(args[0].detach(), dim=-1).cpu(), out[0].detach().cpu())))

    # the routes of a B=8 batch on the card
    batch8 = train_batch(tok, pairs, range(3, 3 + TRAIN_BATCH), 14)
    calls = []
    undo = record_routes(calls)
    try:
        with torch.no_grad():
            logits, aux = verdict_apply_with_aux(params, cfg, *batch_tensors(batch8, dev)[:3])
    finally:
        undo()
    real = torch.as_tensor(batch8[1]) > 0
    kept = []
    for layer, (_, d) in enumerate(calls):
        per_expert, per_slot = d.sum(dim=(1, 3)), d.sum(dim=1)
        picks = d.sum(dim=(2, 3))
        if per_expert.max() > C or per_slot.max() > 1 or picks.max() > k or (
                d[~real].sum() != 0):
            fail(f"phase 25: layer {layer}: an expert takes {float(per_expert.max())} "
                 f"tokens (C = {C}), a slot {float(per_slot.max())}, a token "
                 f"{float(picks.max())} picks, pads {float(d[~real].sum())}")
        kept.append(float(picks[real].sum()) / (k * int(real.sum())))
    aux = float(aux)
    if len(calls) != enc.layers or not torch.isfinite(logits).all() or not (
            MOE_AUX_INIT[0] <= aux <= MOE_AUX_INIT[1]):
        fail(f"phase 25: {len(calls)} routed layers, aux {aux} (bounds {MOE_AUX_INIT})")
    log(f"phase 25: B={TRAIN_BATCH}, {int(real.sum())} real tokens: no expert over "
        f"its {C} slots, no slot taken twice, no pad dispatched; share of the top-{k} "
        f"picks kept by layer {min(kept):.4f}-{max(kept):.4f}; aux {aux:.4f} "
        f"(bounds {MOE_AUX_INIT}: 1 balanced, {enc.moe.num_experts} collapsed)")
    del calls

    # one step of a cut batch, card against CPU, routes compared
    t0 = time.perf_counter()
    small = train_batch(tok, pairs, (5, 16), 15)
    outs = {}
    for device in (dev, "cpu"):
        calls = []
        undo = record_routes(calls)
        try:
            outs[str(device)] = (*step_on(cfg, init, small, device, TRAIN_WARMUP), calls)
        finally:
            undo()
    (l_d, p_d, w_d, r_d), (l_c, p_c, w_c, r_c) = outs[str(dev)], outs["cpu"]
    real = torch.as_tensor(small[1]) > 0
    first = next((i for i, ((_, a), (_, b)) in enumerate(zip(r_d, r_c))
                  if not torch.equal(a, b)), None)
    if first is None:
        ok, far, frac, moved = params_after_one_step_agree(
            names, tree_leaves(w_d), tree_leaves(w_c), tree_leaves(init))
        if abs(l_d - l_c) > 1e-5 or not torch.equal(p_d, p_c) or not ok:
            fail(f"phase 25: one MoE step on the card and the CPU differ with equal "
                 f"routes: loss {l_d} against {l_c}, parameters by {far}, share "
                 f"over lr/10 {frac}, moved {moved}")
        routes = (f"routes equal in all {enc.layers} layers (smallest margin "
                  f"{min(float(route_margins(p, k)[real].min()) for p, _ in r_c):.3g}"
                  f"); parameters apart by at most {far[0]:.3g} ({far[1]}), share "
                  f"over lr/10 {frac[0]:.3g} ({frac[1]}; phase 14's bounds)")
    else:
        probs, (_, d_d), (_, d_c) = r_c[first][0], r_d[first], r_c[first]
        moved_tok = (d_d != d_c).flatten(2).any(-1)
        margin = float(route_margins(probs, k)[moved_tok].max())
        if margin >= ROUTE_MARGIN or d_d[~real].sum() or abs(l_d - l_c) > 1e-3 or (
                not torch.equal(p_d, p_c)):
            fail(f"phase 25: layer {first} routes {int(moved_tok.sum())} tokens "
                 f"elsewhere on the card, at a margin up to {margin}; loss {l_d} "
                 f"against {l_c}")
        routes = (f"layer {first} routes {int(moved_tok.sum())} tokens elsewhere, "
                  f"each at a near-tie (margin <= {margin:.3g}); later layers not "
                  f"compared")
    log(f"phase 25: one MoE step of 2 pairs, card against CPU: loss {l_d:.6f} "
        f"against {l_c:.6f}, predictions equal; {routes}; "
        f"{time.perf_counter() - t0:.1f} s")
    del outs, w_d, w_c, r_d, r_c, params

    # one bf16 + MoE step on the card
    cfg16 = dataclasses.replace(cfg, encoder=dataclasses.replace(enc, dtype=torch.bfloat16))
    before = [fn.launches for fn in counters]
    l16, _, _ = step_on(cfg16, init, batch8, dev, TRAIN_WARMUP)
    per_step = [fn.launches - b for fn, b in zip(counters, before)]
    if not np.isfinite(l16) or per_step != [enc.layers] * 3:
        fail(f"phase 25: the bf16 MoE step: loss {l16}, launches {per_step}")
    log(f"phase 25: one bf16 + MoE step at B={TRAIN_BATCH}: loss {l16:.6f}, "
        f"{enc.layers} forward, dK/dV and dQ launches")

    # timed steps at B=8, prediction at B=64
    torch.cuda.empty_cache()
    sps, ms, gib, per_step = timed_steps(cfg, init, batch8, dev, counters,
                                         MOE_TIMED_STEPS)
    if per_step != [enc.layers] * 3:
        fail(f"phase 25: launches a timed step {per_step}")
    log(f"phase 25: MoE train step, B={TRAIN_BATCH}, {MOE_TIMED_STEPS} steps: "
        f"{sps:.2f} steps/s, {ms:.2f} ms of device time a step, peak {gib:.2f} GiB")
    params = to_device(init, dev)
    big = train_batch(tok, pairs, [i % len(pairs) for i in range(PREDICT_BATCH)], 25)
    ids, mask, types, _ = batch_tensors(big, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    preds = verdict_predict(params, cfg, ids, mask, types)
    pred_ms = cuda_ms(lambda: verdict_predict(params, cfg, ids, mask, types), reps=3)
    if preds.shape != (PREDICT_BATCH,) or not bool(((preds == 0) | (preds == 1)).all()):
        fail(f"phase 25: predictions {preds}")
    log(f"phase 25: MoE prediction at B={PREDICT_BATCH}, L={VERDICT_L}: {pred_ms:.2f} "
        f"ms a batch ({1e3 * PREDICT_BATCH / pred_ms:.1f} pairs/s of device time), "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# ---- phase 26: data and corpus parallelism --------------------------------------

PAR_RANKS = 4  # corpus shards on the one card (gloo ranks)
DP_RANKS = 2  # data-parallel trainer ranks on the one card
PAR_ELL_CLAIMS = 1024  # the ELL engine's batch
PAR_DP_STEPS = 3  # make_dp_train_step against make_train_step, bit for bit
PAR_TRAIN_STEPS, PAR_TRAIN_LOG = 10, 5  # ContrastiveTrainer(mesh=), phase 21's corpus
# the trainer's two losses: TrainConfig() (InfoNCE), and ProtoNCE refreshed at
# steps 0 and 5 at phase 21's granularities cut by ten with its corpus
PAR_TRAINERS = {"InfoNCE": CT_TRAIN,
                "ProtoNCE": dict(CT_TRAIN, loss="ProtoNCE", cluster_start_steps=0,
                                 cluster_update_steps=PAR_TRAIN_LOG,
                                 num_clusters=(400, 600, 800))}
PAR_TIMED = 3  # timed calls of each engine; the median is reported
PAR_PARAM_ATOL, PAR_LOSS_RTOL = 1e-5, 1e-4  # tests/test_dp.py's tolerances
PAR_SCORE_RTOL = 1e-5  # a sharded engine against the one-device engine: another
#                        summation order (other GEMM shapes)


def jax_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ircl_tpu"))


def wall_ms(fn, reps=PAR_TIMED):
    """Median wall time of ``fn()`` in ms, synchronized (host work, the
    device's and, across ranks, the collectives' included)."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    out = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(out))


def sharded_engines(inp):
    """The three corpus-sharded scorers on a ``corpus`` mesh of every rank of
    this process's group, at phase 4's, phase 5's and phase 7's sizes: their
    results, median wall ms a batch, and the launches of #1 and #2."""
    from ircl_tpu_torch.dense.scorer import sharded_cosine_topk
    from ircl_tpu_torch.ops.membership_cuda import membership_slab, membership_slab_windowed
    from ircl_tpu_torch.parallel.mesh import make_mesh
    from ircl_tpu_torch.parallel.sharded_hybrid import ShardedHybridIndex
    from ircl_tpu_torch.parallel.sharded_index import ShardedEllIndex

    mesh = make_mesh(("corpus",), device=inp["device"])
    for fn in (membership_slab, membership_slab_windowed):
        fn.launches = 0
    ell = ShardedEllIndex(inp["ell"], mesh)
    hyb = ShardedHybridIndex(inp["split"], mesh)
    calls = {
        "ell": lambda: ell.topk(*inp["ell_q"], k=K),
        "hybrid": lambda: hyb.topk(*inp["hyb_q"], k=K),
        "dense": lambda: sharded_cosine_topk(inp["dense_q"], inp["dense_c"], K, mesh),
    }
    out = {name: fn() for name, fn in calls.items()}
    launches = {"membership_slab": membership_slab.launches,
                "membership_slab_windowed": membership_slab_windowed.launches}
    ms = {name: wall_ms(fn) for name, fn in calls.items()}
    return out, ms, launches


def rank_sharded(inp):
    """A rank of phase 26's corpus-sharded run: its launches of #1 and #2 and
    the JAX modules it loaded go to rank 0, which returns them with the
    results."""
    import torch.distributed as dist

    out, ms, launches = sharded_engines(inp)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (launches, ms, jax_modules()))
    return out, every


def logged(trainer, name):
    """The values of ``name`` in a trainer's metrics log, in step order."""
    with open(trainer.metrics.path) as f:
        return [r[name] for r in map(json.loads, f) if name in r]


def rank_trainer(spec):
    """A rank of phase 26's data-parallel run: ``ContrastiveTrainer(mesh=)``
    over phase 21's corpus with each of ``spec["trainers"]``' losses, then timed
    DP steps on phase 20's batch. Returns, by loss, the final state and rank
    0's logged losses and gradient norms; the step's median wall ms; and
    every rank's loaded JAX modules and state bits."""
    import hashlib
    import pickle

    import torch
    import torch.distributed as dist

    from ircl_tpu_torch.contrastive.state import TrainConfig
    from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
    from ircl_tpu_torch.data.pairs import DocPairSampler
    from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer
    from ircl_tpu_torch.parallel.mesh import make_mesh

    dev = spec["device"]
    mesh = make_mesh(("data",), device=dev)
    feat = HashEmbedFeaturizer(FeaturizerConfig(**spec["feat"]), device=dev)
    batch = tuple(torch.as_tensor(x) for x in spec["batch"])
    out = {}
    for loss, over in spec["trainers"].items():
        tr = ContrastiveTrainer(TrainConfig(**over), feat,
                                DocPairSampler(spec["docs"], sample="augment", seed=7),
                                ckptdir=f"{spec['dir']}/{loss}/ckpt",
                                logdir=f"{spec['dir']}/{loss}/log", mesh=mesh, device=dev)
        state = tr.train(total_steps=spec["steps"], log_step=spec["log_step"])
        tree = {k: [t.cpu().numpy() for t in _leaves(getattr(state, k))]
                for k in ("params_q", "params_k")}
        tree.update(queue=state.queue.cpu().numpy(), ptr=state.queue_ptr, step=state.step,
                    refreshes=tr.refresh_count)
        out[loss] = dict(tree=tree, losses=None, grad_norms=None)
        if dist.get_rank() == 0:
            out[loss].update(losses=logged(tr, "train_loss"),
                             grad_norms=logged(tr, "grad_norm"))
        if loss == "InfoNCE":  # the step at TrainConfig()
            ms = wall_ms(lambda: tr.step_fn(state, *batch))
    digest = hashlib.sha256(pickle.dumps([o["tree"] for o in out.values()])).hexdigest()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (digest, ms, jax_modules()))
    return out, every


def same_or_tied(s, i, want_s, want_i, rtol):
    """Row-wise top-k parity of numpy arrays, ``tests/_torch_parity.py``'s
    rule: scores within ``rtol``; the ids whose score lies above the row's
    last one (by more than ``rtol``) equal as sets, so near-ties may swap."""
    if not np.allclose(s, want_s, rtol=rtol, atol=0.0):
        return False
    for row, gi, wi in zip(want_s, i, want_i):
        live = wi >= 0
        if ((gi >= 0) != live).any():
            return False
        if live.any():
            last = row[live].min()
            above = live & (row > last + rtol * abs(last))
            if set(gi[above].tolist()) != set(wi[above].tolist()):
                return False
    return True


def phase26_parallel(dev, index, index_ell, claims, scipy_top, dense_queries,
                     dense_corpus, dense_ref, tmpdir, smi):
    """Data and corpus parallelism on the card: (a) one NCCL rank in this
    process at full size, against the one-device engines and the scipy and
    numpy gates, and the DP step bit for bit against ``make_train_step``;
    (b) four gloo ranks sharing the card for the sharded scorers and two
    for ``ContrastiveTrainer(mesh=)``, against (a) and the one-device
    trainer. Returns the launches of #1 and #2 in (a) and in every rank."""
    import tempfile as _tempfile

    import torch
    import torch.distributed as dist

    from ircl_tpu_torch.contrastive.state import TrainConfig, init_train_state
    from ircl_tpu_torch.contrastive.train import make_train_step
    from ircl_tpu_torch.contrastive.trainer import ContrastiveTrainer
    from ircl_tpu_torch.corpus.synthetic import generate
    from ircl_tpu_torch.data.pairs import DocPairSampler
    from ircl_tpu_torch.dense.scorer import cosine_topk_twophase
    from ircl_tpu_torch.index.build import to_scipy
    from ircl_tpu_torch.index.ell import to_ell
    from ircl_tpu_torch.index.ranker import TfidfRanker, vectorize_queries
    from ircl_tpu_torch.models.featurizer import FeaturizerConfig, HashEmbedFeaturizer
    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops.membership_cuda import membership_topk_fused, pad_for_slab
    from ircl_tpu_torch.parallel.dp import make_dp_train_step
    from ircl_tpu_torch.parallel.launch import launch
    from ircl_tpu_torch.parallel.mesh import make_mesh

    put = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    t_phase = time.perf_counter()
    # the inputs: phase 4's ELL engine on 1,024 claims, a one-bucket hybrid
    # ranker over phase 5's index (phase 3's engine, at the judged ranker's
    # union and term caps) on all 4,096 claims, phase 7's corpus and queries
    ell_r = TfidfRanker(index_ell, dev, mode="ell", fixed_max_terms=24,
                        fixed_union_cap=4096, union_round=512)
    eb, ew = ell_r._vectorize(claims[:PAR_ELL_CLAIMS])
    eq_t, ew_t = pad_for_slab(np.ascontiguousarray(eb.T.astype(np.int32)),
                              np.ascontiguousarray(ew.T), d_tile=128)
    ell_q = (ell_r._union_slots(eb, ew, floor=4096), eq_t, ew_t)
    hyb_r = TfidfRanker(index, dev, mode="hybrid", df_threshold=24,
                        fixed_union_cap=4096, fixed_max_terms=64, union_round=512)
    if hyb_r._bucketed is not None:
        fail("phase 26: the hybrid ranker is not the one-bucket engine")
    hyb_q = hyb_r.hybrid_host_inputs(*hyb_r._vectorize(claims))
    # scipy's top-K of the ELL engine's claims: a gate that shares no kernel
    # with the sharded engine (phase 4's, on the shards' padded shapes)
    ell_scipy = scipy_topk(to_scipy(index_ell), *vectorize_queries(
        claims[:PAR_ELL_CLAIMS], HASH_SIZE, 2, index_ell.doc_freqs, index_ell.num_docs,
        max_terms=24), K)
    inp = dict(ell=to_ell(index_ell), ell_q=ell_q, split=hyb_r._split, hyb_q=hyb_q,
               dense_q=dense_queries, dense_c=dense_corpus, device=dev)
    # the one-device engines on the same inputs
    one = {
        "ell": lambda: membership_topk_fused(
            ell_r._ell_terms_t, ell_r._ell_vals_t, *map(put, ell_q), k=K,
            num_real_docs=index_ell.num_docs),
        "hybrid": lambda: hy.hybrid_topk(
            hyb_r._heavy_terms_t, hyb_r._heavy_vals_t, *map(put, hyb_q), k=K,
            num_real_docs=index.num_docs, queries_sorted=True),
        "dense": lambda: cosine_topk_twophase(put(dense_queries), put(dense_corpus), K),
    }
    single = {name: tuple(x.cpu().numpy() for x in fn()) for name, fn in one.items()}
    single_ms = {name: wall_ms(fn) for name, fn in one.items()}
    log(f"phase 26: inputs and one-device engines in {time.perf_counter() - t_phase:.1f} s")

    def check(label, got):
        for name, (s, i) in got.items():
            want_s, want_i = single[name]
            if not same_or_tied(s[: want_s.shape[0]], i[: want_s.shape[0]], want_s, want_i,
                                PAR_SCORE_RTOL):
                fail(f"phase 26: {label}: the sharded {name} engine differs from the "
                     f"one-device engine")
        s, i = got["ell"]  # phase 4's gate on every claim: scores and own scores
        bad_e = 0
        for b, (top, dense) in enumerate(ell_scipy):
            hit = (i[b] >= 0) & (s[b] > 0)
            bad_e += not (hit.sum() == len(top)
                          and np.allclose(np.sort(s[b][hit])[::-1], top, rtol=1e-4)
                          and np.allclose(dense[i[b][hit]], s[b][hit], rtol=1e-4))
        s, i = got["hybrid"]  # bench.py's gate on every claim
        bad = sum(
            not np.allclose(np.sort(ref[: min(len(ref), int((i[b] >= 0).sum()))]),
                            np.sort(s[b][i[b] >= 0][: len(ref)]), rtol=1e-4)
            for b, ref in enumerate(scipy_top))
        s, i = got["dense"]  # bench_dense.py's gate on every query
        bad_d = sum(not np.allclose(s[b], dense_ref[0][b], rtol=1e-5)
                    for b in range(s.shape[0]))
        if bad_e or bad or bad_d:
            fail(f"phase 26: {label}: {bad_e} ELL and {bad} hybrid claims fail the scipy "
                 f"gate, {bad_d} queries the numpy gate")
        return (f"{len(ell_scipy)}/{len(ell_scipy)} ELL and {len(scipy_top)}/"
                f"{len(scipy_top)} hybrid claims match scipy (rtol 1e-4), "
                f"{s.shape[0]}/{s.shape[0]} queries numpy (rtol 1e-5)")

    # ---- (a) one NCCL rank in this process ----
    t0 = time.perf_counter()
    # phase 20's featurizer, drawn again from its seed
    ct_feat = HashEmbedFeaturizer(FeaturizerConfig(**CT_FEAT), device=dev)
    rdv = _tempfile.mkdtemp(prefix="ircl_nccl_", dir=tmpdir)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{rdv}/rendezvous", rank=0, world_size=1)
    try:
        got1, ms1, launches1 = sharded_engines(inp)
        gates = check("1 NCCL rank", got1)
        # the DP step at TrainConfig() against make_train_step, bit for bit
        cfg = TrainConfig(**CT_TRAIN)
        rng = np.random.default_rng(0)  # phase 20's batch
        shape = (cfg.accum_steps, cfg.micro_batch, CT_FEAT["max_len"])
        ids = rng.integers(0, ct_feat.config.vocab_buckets, size=shape).astype(np.int32)
        ids_k = rng.integers(0, ct_feat.config.vocab_buckets, size=shape).astype(np.int32)
        mask = (rng.random(shape) < 0.8).astype(np.float32)
        batch = tuple(put(x) for x in (ids, mask, ids_k, mask))
        dp_step, place_state, place_batch, _ = make_dp_train_step(
            cfg, ct_feat, make_mesh(("data",), device=dev))
        ref_step = make_train_step(cfg, ct_feat)
        s_dp = place_state(state_to(init_train_state(0, cfg, device="cpu"), dev))
        s_one = state_to(init_train_state(0, cfg, device="cpu"), dev)
        for n in range(PAR_DP_STEPS):
            s_dp, l_dp, g_dp = dp_step(s_dp, *place_batch(*batch))
            s_one, l_one, g_one = ref_step(s_one, *batch)
            same = (torch.equal(l_dp, l_one) and torch.equal(g_dp, g_one)
                    and torch.equal(s_dp.queue, s_one.queue)
                    and s_dp.queue_ptr == s_one.queue_ptr
                    and all(torch.equal(a, b) for t in ("params_q", "params_k")
                            for a, b in zip(_leaves(getattr(s_dp, t)),
                                            _leaves(getattr(s_one, t))))
                    and all(torch.equal(a, b) for a, b in zip(
                        _leaves(s_dp.opt_state), _leaves(s_one.opt_state))
                            if isinstance(a, torch.Tensor)))
            if not same:
                fail(f"phase 26: DP step {n} on 1 NCCL rank is not bit-equal to "
                     f"make_train_step (loss {float(l_dp)} against {float(l_one)})")
        dp_ms = wall_ms(lambda: dp_step(s_dp, *place_batch(*batch)))
        one_ms = wall_ms(lambda: ref_step(s_one, *batch))
    finally:
        dist.destroy_process_group()
    del s_dp, s_one
    log(f"phase 26: (a) 1 NCCL rank: the sharded ELL ({PAR_ELL_CLAIMS} claims, "
        f"{index_ell.num_docs} docs), hybrid ({len(claims)} claims, {index.num_docs} "
        f"docs) and dense ({dense_queries.shape[0]} x {dense_corpus.shape[0]}) engines "
        f"equal the one-device engines (rtol {PAR_SCORE_RTOL}, ids up to ties); {gates}; "
        f"{PAR_DP_STEPS} DP steps at TrainConfig() bit-equal to make_train_step; "
        f"launches {launches1}; {time.perf_counter() - t0:.1f} s")

    # ---- (b) several gloo ranks on the one card ----
    t0 = time.perf_counter()
    try:
        got4, every4 = launch(rank_sharded, PAR_RANKS, inp, device=dev, backend="gloo",
                              timeout=600)
    except RuntimeError as e:
        fail(f"phase 26: the {PAR_RANKS}-rank sharded run failed: {e}")
    gates4 = check(f"{PAR_RANKS} gloo ranks", got4)
    for name in got1:
        if not same_or_tied(*got4[name], *got1[name], PAR_SCORE_RTOL):
            fail(f"phase 26: the {name} engine on {PAR_RANKS} ranks differs from 1 rank")
    launches4 = [lc for lc, _, _ in every4]
    loaded = [m for _, _, m in every4 if m]
    if loaded or any(0 in lc.values() for lc in launches4):
        fail(f"phase 26: ranks launched {launches4}, loaded {loaded}")
    ms4 = every4[0][1]
    log(f"phase 26: (b) {PAR_RANKS} gloo ranks on the card: {gates4}; equal to 1 rank "
        f"(rtol {PAR_SCORE_RTOL}); launches by rank {launches4}; no rank loaded JAX; "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    wiki = generate(num_docs=CT_E2E_DOCS, num_claims=CT_E2E_CLAIMS, seed=11)
    docs = list(wiki.sentences.values())
    want = {}
    for loss, over in PAR_TRAINERS.items():
        tr = ContrastiveTrainer(TrainConfig(**over), ct_feat,
                                DocPairSampler(docs, sample="augment", seed=7),
                                ckptdir=f"{tmpdir}/par_one/{loss}/ckpt",
                                logdir=f"{tmpdir}/par_one/{loss}/log", device=dev)
        st = tr.train(total_steps=PAR_TRAIN_STEPS, log_step=PAR_TRAIN_LOG)
        want[loss] = dict(state=st, refreshes=tr.refresh_count,
                          losses=logged(tr, "train_loss"),
                          grad_norms=logged(tr, "grad_norm"))
    del tr, st, ct_feat
    try:
        got2, every2 = launch(rank_trainer, DP_RANKS, dict(
            docs=docs, dir=f"{tmpdir}/par_dp", batch=(ids, mask, ids_k, mask), device=dev,
            feat=CT_FEAT, trainers=PAR_TRAINERS, steps=PAR_TRAIN_STEPS, log_step=PAR_TRAIN_LOG), device=dev,
            backend="gloo", timeout=600)
    except RuntimeError as e:
        fail(f"phase 26: the {DP_RANKS}-rank trainer failed: {e}")
    if len(set(d for d, _, _ in every2)) != 1 or any(m for _, _, m in every2):
        fail(f"phase 26: the {DP_RANKS}-rank trainers' ranks differ or loaded JAX: "
             f"{every2}")
    trained = []
    for loss, w in want.items():
        g = got2[loss]
        far = max(float(np.abs(a - b.cpu().numpy()).max())
                  for t in ("params_q", "params_k")
                  for a, b in zip(g["tree"][t], _leaves(getattr(w["state"], t))))
        if (far > PAR_PARAM_ATOL or g["tree"]["step"] != w["state"].step
                or g["tree"]["refreshes"] != w["refreshes"]
                or len(g["losses"]) != PAR_TRAIN_STEPS // PAR_TRAIN_LOG
                or not np.allclose(g["losses"], w["losses"], rtol=PAR_LOSS_RTOL, atol=0)
                or not np.allclose(g["grad_norms"], w["grad_norms"], rtol=PAR_LOSS_RTOL,
                                   atol=0)):
            fail(f"phase 26: the {DP_RANKS}-rank {loss} trainer: params {far} apart, "
                 f"refreshes {g['tree']['refreshes']} against {w['refreshes']}, losses "
                 f"{g['losses']} against {w['losses']}, grad norms {g['grad_norms']} "
                 f"against {w['grad_norms']}")
        trained.append(f"{loss} ({w['refreshes']} refreshes): params within {far:.3g} "
                       f"(atol {PAR_PARAM_ATOL}), losses {g['losses']} against "
                       f"{w['losses']}, grad norms {g['grad_norms']} against "
                       f"{w['grad_norms']} (rtol {PAR_LOSS_RTOL})")
    log(f"phase 26: (b) {DP_RANKS} gloo ranks: ContrastiveTrainer(mesh=) over "
        f"{len(docs)} docs, {PAR_TRAIN_STEPS} steps, against the one-device trainer: "
        f"{'; '.join(trained)}; every rank's state bit-equal to rank 0's; "
        f"{time.perf_counter() - t0:.1f} s")

    log(f"phase 26: wall ms a batch ({smi}; {PAR_RANKS} ranks share one card, so "
        f"these times check overhead, not scaling):")
    for name in ("ell", "hybrid", "dense"):
        log(f"  {name}: one device {single_ms[name]:.2f}, sharded 1 rank {ms1[name]:.2f}, "
            f"{PAR_RANKS} ranks {ms4[name]:.2f}")
    log(f"  DP step at TrainConfig(): make_train_step {one_ms:.2f}, DP 1 rank "
        f"{dp_ms:.2f}, {DP_RANKS} ranks {every2[0][1]:.2f}")
    log(f"phase 26: {time.perf_counter() - t_phase:.1f} s")
    return launches1, launches4


# ---- phase 27: tensor and expert parallelism of the verdict model ----------------

MP_STEPS, MP_EP_STEPS, MP_TPDP_STEPS = 3, 2, 2  # sharded steps against one device
MP_TPDP_LAYERS = 2  # (d)'s model: phase 14's width, 2 layers
MP_LOSS_RTOL = 2e-5  # tests/test_tp.py's gates: losses,
MP_PARAM_RTOL, MP_PARAM_ATOL = 5e-4, 5e-6  # and parameters
MP_GRAD_RTOL = 1e-4  # step 0's gradient slices: of each leaf's largest element
MP_NOISE_ATOL = 1e-6  # the k/b leaves: zero in exact arithmetic, noise on both sides


MP_MODEL = dict(encoder=VERDICT_ENCODER, max_length=VERDICT_L, learning_rate=TRAIN_LR,
                seed=VERDICT_SEED)  # phase 14's model; the ranks get it in their spec


def mp_config(model, layers=None, moe=False):
    """Phase 14's verdict model (``VERDICT_ENCODER``: roberta-base width, f32,
    flash) by default, with every body leaf updated from the first step: no
    freeze and no warmup. ``moe``: phase 25's ``MoEConfig()``."""
    from ircl_tpu_torch.models.moe import MoEConfig
    from ircl_tpu_torch.models.transformer import TransformerConfig
    from ircl_tpu_torch.verdict.model import VerdictConfig

    enc = dict(model["encoder"], **({"layers": layers} if layers else {}))
    return VerdictConfig(encoder=TransformerConfig(**enc, moe=MoEConfig() if moe else None),
                         max_length=model["max_length"],
                         learning_rate=model["learning_rate"], warmup_steps=0,
                         total_steps=200, freeze_body_until_warmup=False)


def mp_init(cfg, seed):
    """The initial parameters on the CPU, drawn from ``seed`` (every rank
    draws the same bits)."""
    import torch

    from ircl_tpu_torch.verdict.model import init_verdict_params

    return init_verdict_params(torch.Generator().manual_seed(seed), cfg, "cpu")


def timed_step(step, p, o, i, batch):
    """One step, synchronized: (params, state, loss, wall ms)."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    p, o, loss, _ = step(p, o, i, *batch)
    sync()
    return p, o, float(loss), 1e3 * (time.perf_counter() - t0)


def mp_reference(cfg, seed, batch, dev, steps, path, grads=False, aux=False, keep=(),
                 logits=False):
    """The single-device step on the card from ``mp_init(cfg)``: written to
    ``path`` for the ranks (losses, the parameters after the last step and
    after each step in ``keep``, step 0's gradients, the aux and the
    logits at the start), with the median wall ms a step."""
    import torch

    from ircl_tpu_torch.utils.convert import to_device
    from ircl_tpu_torch.utils.tree import tree_map
    from ircl_tpu_torch.verdict.model import (
        make_verdict_grad_fn, make_verdict_train_step, verdict_apply, verdict_apply_with_aux,
    )

    p = to_device(mp_init(cfg, seed), dev)
    ref = {}
    if grads:
        loss, _, g = make_verdict_grad_fn(cfg, device=dev)(p, *batch)
        ref["grads"], ref["grad_loss"] = to_device(g, "cpu"), float(loss)
        del g
    if aux:
        with torch.no_grad():
            ref["aux"] = float(verdict_apply_with_aux(p, cfg, *batch[:3])[1])
    if logits:
        ref["logits"] = verdict_apply(p, cfg, *batch[:3]).cpu()
    step, tx = make_verdict_train_step(cfg, device=dev)
    o = tx.init(p)
    losses, ms = [], []
    for i in range(steps):
        p, o, loss, t = timed_step(step, p, o, i, batch)
        losses.append(loss)
        ms.append(t)
        if i + 1 in keep:  # a copy: the step updates p in place
            ref[f"params{i + 1}"] = tree_map(lambda t: t.to("cpu", copy=True), p)
    ref.update(losses=losses, params=to_device(p, "cpu"))
    del p, o
    torch.save(ref, path)
    torch.cuda.empty_cache()
    return losses, float(np.median(ms[1:] if len(ms) > 1 else ms))


def mp_param_gap(local, whole, specs, mesh, kb_atol):
    """This rank's shards against the same slices of the single-device
    parameters: (every element within MP_PARAM_RTOL/ATOL, largest
    difference). The k/b leaves apart, as phase 14 holds them: their
    gradient is zero in exact arithmetic, so each Adam step moves them by
    up to the learning rate in the direction of noise, and they are held
    to ``kb_atol`` (twice the learning rate a step)."""
    import torch

    from ircl_tpu_torch.parallel.tp import shard_tree

    want = shard_tree(whole, specs, mesh)
    ok, far = True, 0.0
    for (name, a), (_, b) in zip(named_leaves(local), named_leaves(want)):
        d = float((a - b).abs().max())
        if name.endswith("/k/b"):
            ok &= d <= kb_atol
            continue
        ok &= bool(torch.allclose(a, b, rtol=MP_PARAM_RTOL, atol=MP_PARAM_ATOL))
        far = max(far, d)
    return ok, far


def mp_grad_gap(local, whole, specs, mesh):
    """This rank's gradient slices against the single-device gradient's:
    the largest difference as a share of its leaf's largest element (the
    k/b leaves, zero in exact arithmetic, held to MP_NOISE_ATOL instead)."""
    from ircl_tpu_torch.parallel.tp import shard_tree

    want = shard_tree(whole, specs, mesh)
    worst, noise = (0.0, ""), 0.0
    for (name, a), (_, b) in zip(named_leaves(local), named_leaves(want)):
        d = float((a - b).abs().max())
        if name.endswith("/k/b"):
            noise = max(noise, d)
        else:
            worst = max(worst, (d / max(float(b.abs().max()), 1e-30), name))
    return worst, noise


def mp_rank_case(case, model, batch, dev):
    """One case of phase 27 on this rank: its losses, wall ms a step, the
    gaps of its shards (and gradient slices) from the single-device run's,
    and the digest of its replicated leaves."""
    import hashlib

    import torch

    from ircl_tpu_torch.parallel import ep, tp
    from ircl_tpu_torch.utils.checkpoint import restore_sharded, save_sharded
    from ircl_tpu_torch.utils.tree import tree_leaves, tree_leaves_like
    from ircl_tpu_torch.verdict.model import (
        make_verdict_grad_fn, make_verdict_train_step, verdict_apply_with_aux,
    )

    cfg = mp_config(model, **case["cfg"])
    init = mp_init(cfg, model["seed"])
    ref = torch.load(case["ref"], mmap=True, weights_only=True)
    kind, hook = case["kind"], None
    if kind == "ep":
        mesh = ep.make_ep_mesh(expert=2, data=1, device=dev)
        specs, hook = ep.moe_verdict_param_specs(init), ep.make_ep_constrainer(mesh)
    else:
        mesh = tp.make_tp_mesh(model=2, data=case.get("data", 1), device=dev)
        specs = tp.verdict_param_specs(init)
    placed = tp.shard_batch(mesh, *batch)
    out = {}
    if "grads" in ref:
        fn = make_verdict_grad_fn(cfg, ep_constrain=hook, mesh=mesh)
        loss, _, g = fn(tp.shard_tree(init, specs, mesh), *placed)
        out["grads"], out["grad_loss"] = mp_grad_gap(g, ref["grads"], specs, mesh), float(loss)
        del g
    if "aux" in ref:
        with torch.no_grad():
            out["aux"] = float(verdict_apply_with_aux(
                tp.shard_tree(init, specs, mesh), cfg, *placed[:3], ep_constrain=hook,
                mesh=mesh)[1])
    step, tx = make_verdict_train_step(cfg, ep_constrain=hook, mesh=mesh)
    p = tp.shard_tree(init, specs, mesh)
    o = tp.init_sharded_opt_state(tx, p, mesh, specs)
    losses, ms = [], []
    for i in range(case["steps"]):
        p, o, loss, t = timed_step(step, p, o, i, placed)
        losses.append(loss)
        ms.append(t)
        if case.get("save_after") == i + 1:
            save_sharded(case["ckpt"], {"params": p, "opt": o}, mesh=mesh,
                         specs={"params": specs, "opt": tp.state_specs(o, p, specs)})
    kb = 2 * cfg.learning_rate  # a step's bound on the k/b leaves
    out.update(losses=losses, ms=float(np.median(ms[1:])),
               params=mp_param_gap(p, ref["params"], specs, mesh, kb * case["steps"]))
    rep = [t for t, s in zip(tree_leaves(p), tree_leaves_like(p, specs))
           if not any(s.axes)]
    out["replicated"] = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for t in rep)).hexdigest()
    del p, o
    if case.get("sp"):  # one step under sequence parallelism
        sp_step, _ = make_verdict_train_step(cfg, tp.make_sp_constrainer(mesh), mesh=mesh)
        p = tp.shard_tree(init, specs, mesh)
        p, o, loss, t = timed_step(sp_step, p, tp.init_sharded_opt_state(tx, p, mesh, specs),
                                   0, placed)
        out["sp"] = dict(loss=loss, ms=t,
                         params=mp_param_gap(p, ref["params1"], specs, mesh, kb))
        del p, o
    if case.get("restore"):  # onto replicated parameters over 4 data ranks
        mesh2 = tp.make_tp_mesh(model=1, data=4, device=dev)
        specs2 = tp.replicated_specs(init)
        step2, tx2 = make_verdict_train_step(cfg, mesh=mesh2)
        p = tp.shard_tree(init, specs2, mesh2)
        o = tp.init_sharded_opt_state(tx2, p, mesh2, specs2)
        back = restore_sharded(case["ckpt"], {"params": p, "opt": o}, mesh=mesh2,
                               specs={"params": specs2, "opt": tp.state_specs(o, p, specs2)})
        del p, o
        start = case["save_after"]
        p, o = back["params"], back["opt"]
        losses2 = []
        for i in range(start, case["steps"]):
            p, o, loss, _ = timed_step(step2, p, o, i, tp.shard_batch(mesh2, *batch))
            losses2.append(loss)
        out["restored"] = dict(count=start, losses=losses2, params=mp_param_gap(
            p, ref["params"], specs2, mesh2, kb * case["steps"]))
        del p, o
    torch.cuda.empty_cache()
    return out


def rank_model_parallel(spec):
    """A rank of phase 27: its cases, and every rank's results, launches of
    #6a-#6c over its cases and loaded JAX modules, gathered to rank 0."""
    import torch
    import torch.distributed as dist

    from ircl_tpu_torch.ops.flash_attention_cuda import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    )

    counters = (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    for fn in counters:
        fn.launches = 0
    dev = (torch.device("cuda", torch.cuda.current_device()) if spec["device"] == "cuda"
           else torch.device("cpu"))
    batch = tuple(torch.as_tensor(x) for x in spec["batch"])
    out = {case["name"]: mp_rank_case(case, spec["model"], batch, dev)
           for case in spec["cases"]}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, ([fn.launches for fn in counters], out, jax_modules()))
    return every


def mp_check(label, got, want_losses, rtol=MP_LOSS_RTOL):
    """Fail unless ``got``'s losses meet ``want_losses`` and its parameter
    gap is within the gates."""
    ok, far = got["params"]
    if not np.allclose(got["losses"], want_losses, rtol=rtol, atol=0) or not ok:
        fail(f"phase 27: {label}: losses {got['losses']} against {want_losses} (rtol "
             f"{rtol}), parameters within the gates {ok} (largest difference {far})")
    return far


def phase27_model_parallel(dev, tok, pairs, tmpdir, smi, model=None):
    """Tensor and expert parallelism of the verdict model on the card: (a)
    one NCCL rank in this process on a (1, 1) ``("data", "model")`` mesh, 3
    steps bit-equal to the step without a mesh; (b) TP(2) on two gloo ranks
    sharing the card, 3 steps and one sequence-parallel step against the
    single-device step, step 0's gradient slices too; (c) EP(2) on phase
    25's MoE model, 2 steps; (d) TP(2) x DP(2) on four ranks at 2 layers, 2
    steps, then a sharded checkpoint after step 1 restored onto a (4, 1)
    DP-only layout and stepped once more. Returns the launches of #6a-#6c by
    rank: (b) and (c)'s ranks, then (d)'s."""
    import tempfile as _tempfile

    import torch
    import torch.distributed as dist

    from ircl_tpu_torch.ops.flash_attention_cuda import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    )
    from ircl_tpu_torch.parallel import tp
    from ircl_tpu_torch.parallel.launch import launch
    from ircl_tpu_torch.utils.tree import tree_map
    from ircl_tpu_torch.verdict.model import make_verdict_train_step

    model = model or MP_MODEL
    t_phase = time.perf_counter()
    np_batch = train_batch(tok, pairs, range(3, 3 + TRAIN_BATCH), 14)  # phase 14's
    batch = batch_tensors(np_batch, dev)
    cfg = mp_config(model)
    enc = cfg.encoder
    log(f"phase 27: verdict model {enc.layers} x {enc.hidden}, {enc.heads} heads, "
        f"{enc.attention}, B={TRAIN_BATCH}, L={np_batch[0].shape[1]}; no freeze, no warmup")
    counters = (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)

    # ---- (a) one NCCL rank in this process, a (1, 1) mesh ----
    rdv = _tempfile.mkdtemp(prefix="ircl_nccl_", dir=tmpdir)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{rdv}/rendezvous", rank=0, world_size=1)
    try:
        mesh = tp.make_tp_mesh(model=1, data=1, device=dev)
        init = mp_init(cfg, model["seed"])
        runs = {}
        for label, kw in (("one device", {"device": dev}), ("mesh", {"mesh": mesh})):
            step, tx = make_verdict_train_step(cfg, **kw)
            p = tree_map(lambda t: t.to(dev, copy=True), init)  # the step updates in place
            o = tx.init(p)
            before = [fn.launches for fn in counters]
            losses, ms = [], []
            for i in range(MP_STEPS):
                p, o, loss, t = timed_step(step, p, o, i, batch)
                losses.append(loss)
                ms.append(t)
            runs[label] = (losses, p, float(np.median(ms[1:])),
                           [fn.launches - b for fn, b in zip(counters, before)])
        (l1, p1, ms_one, _), (lm, pm, ms_a, launches_a) = runs["one device"], runs["mesh"]
        same = l1 == lm and all(torch.equal(a, b) for a, b in zip(_leaves(p1), _leaves(pm)))
        if not same or 0 in launches_a:
            fail(f"phase 27: (a) {MP_STEPS} steps on a (1, 1) mesh: losses {lm} against "
                 f"{l1}, bit-equal {same}; launches {launches_a}")
        del runs, p1, pm, init
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"phase 27: (a) 1 NCCL rank, (1, 1) mesh: {MP_STEPS} steps bit-equal to the step "
        f"without a mesh (losses {lm}); launches of #6a-#6c {launches_a}")

    # ---- the single-device references, written for the ranks ----
    ref_tp, ref_ep, ref_d = (f"{tmpdir}/mp_{n}.pt" for n in ("tp", "ep", "tpdp"))
    ref_losses = {"tp": mp_reference(cfg, model["seed"], batch, dev, MP_STEPS, ref_tp,
                                     grads=True, keep=(1,))}
    moe_cfg = mp_config(model, moe=True)
    ref_losses["ep"] = mp_reference(moe_cfg, model["seed"], batch, dev, MP_EP_STEPS,
                                    ref_ep, aux=True)
    ref_aux = torch.load(ref_ep, mmap=True, weights_only=True)["aux"]
    ref_losses["tpdp"] = mp_reference(mp_config(model, layers=MP_TPDP_LAYERS),
                                      model["seed"], batch, dev, MP_TPDP_STEPS, ref_d)
    log(f"phase 27: single-device references in {time.perf_counter() - t_phase:.1f} s")

    # ---- (b) TP(2) and (c) EP(2): two gloo ranks on the card ----
    t0 = time.perf_counter()
    spec = dict(device=dev.type, model=model, batch=np_batch, cases=[
        dict(name="tp", kind="tp", cfg={}, ref=ref_tp, steps=MP_STEPS, sp=True),
        dict(name="ep", kind="ep", cfg={"moe": True}, ref=ref_ep, steps=MP_EP_STEPS)])
    try:
        every2 = launch(rank_model_parallel, 2, spec, device=dev, backend="gloo",
                        timeout=600)
    except RuntimeError as e:
        fail(f"phase 27: the 2-rank TP and EP run failed: {e}")
    for r, (launches, out, loaded) in enumerate(every2):
        if loaded or 0 in launches:
            fail(f"phase 27: rank {r} of 2 launched {launches} and loaded {loaded}")
        want_l, _ = ref_losses["tp"]
        far_b = mp_check(f"(b) TP(2) rank {r}", out["tp"], want_l)
        (gap, leaf), noise = out["tp"]["grads"]
        if gap > MP_GRAD_RTOL or noise > MP_NOISE_ATOL:
            fail(f"phase 27: (b) rank {r}: step 0's gradient slices {gap} of {leaf}'s "
                 f"largest element (bound {MP_GRAD_RTOL}), k/b noise {noise}")
        sp = out["tp"]["sp"]
        far_sp = mp_check(f"(b) SP rank {r}", dict(sp, losses=[sp["loss"]]), want_l[:1])
        far_c = mp_check(f"(c) EP(2) rank {r}", out["ep"], ref_losses["ep"][0])
        if not np.isclose(out["ep"]["aux"], ref_aux, rtol=MP_LOSS_RTOL, atol=0):
            fail(f"phase 27: (c) rank {r}: aux {out['ep']['aux']} against {ref_aux}")
    for name in ("tp", "ep"):
        if len({out[name]["replicated"] for _, out, _ in every2}) != 1:
            fail(f"phase 27: the ranks' replicated leaves differ in ({name})")
    out2 = every2[0][1]
    log(f"phase 27: (b) TP(2), {enc.heads // 2} heads a rank: {MP_STEPS} steps' losses "
        f"{out2['tp']['losses']} against {ref_losses['tp'][0]} (rtol {MP_LOSS_RTOL}); "
        f"shards within rtol {MP_PARAM_RTOL}, atol {MP_PARAM_ATOL} (largest difference "
        f"{far_b:.3g}); step 0's gradient slices within {gap:.3g} of each leaf's largest "
        f"element ({leaf}; bound {MP_GRAD_RTOL}); one SP step within the same gates "
        f"({far_sp:.3g}); replicated leaves bit-equal on both ranks")
    log(f"phase 27: (c) EP(2), {moe_cfg.encoder.moe.num_experts // 2} experts a rank: "
        f"{MP_EP_STEPS} steps' losses "
        f"{out2['ep']['losses']} against {ref_losses['ep'][0]}, aux {out2['ep']['aux']:.6f} "
        f"against {ref_aux:.6f}; shards within the gates ({far_c:.3g}); "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- (d) TP(2) x DP(2) on four ranks, and the sharded checkpoint ----
    t0 = time.perf_counter()
    spec = dict(device=dev.type, model=model, batch=np_batch, cases=[dict(
        name="tpdp", kind="tp", data=2, cfg={"layers": MP_TPDP_LAYERS}, ref=ref_d,
        steps=MP_TPDP_STEPS, save_after=1, restore=True, ckpt=f"{tmpdir}/mp_ckpt")])
    try:
        every4 = launch(rank_model_parallel, 4, spec, device=dev, backend="gloo",
                        timeout=600)
    except RuntimeError as e:
        fail(f"phase 27: the 4-rank TP x DP run failed: {e}")
    want_l, _ = ref_losses["tpdp"]
    for r, (launches, out, loaded) in enumerate(every4):
        if loaded or 0 in launches:
            fail(f"phase 27: rank {r} of 4 launched {launches} and loaded {loaded}")
        far_d = mp_check(f"(d) TP(2) x DP(2) rank {r}", out["tpdp"], want_l)
        far_r = mp_check(f"(d) restored onto DP(4) rank {r}", out["tpdp"]["restored"],
                         want_l[1:])
    if len({out["tpdp"]["replicated"] for _, out, _ in every4}) != 1:
        fail("phase 27: the ranks' replicated leaves differ in (d)")
    out4 = every4[0][1]["tpdp"]
    log(f"phase 27: (d) TP(2) x DP(2), {MP_TPDP_LAYERS} layers: {MP_TPDP_STEPS} steps' "
        f"losses {out4['losses']} against {want_l} ({far_d:.3g}); saved sharded after "
        f"step 1, restored onto a (4, 1) DP-only layout, step 2's loss "
        f"{out4['restored']['losses']} and parameters within the gates ({far_r:.3g}); "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"phase 27: wall ms a step ({smi}; the ranks share one card and reduce through "
        f"gloo on the host, so these times check overhead, not scaling): one device "
        f"{ms_one:.1f}, (a) 1 NCCL rank {ms_a:.1f}, (b) TP(2) {out2['tp']['ms']:.1f} (one "
        f"SP step {out2['tp']['sp']['ms']:.1f}); MoE one device {ref_losses['ep'][1]:.1f}, "
        f"(c) EP(2) {out2['ep']['ms']:.1f}; {MP_TPDP_LAYERS} layers one device "
        f"{ref_losses['tpdp'][1]:.1f}, (d) TP(2) x DP(2) {out4['ms']:.1f}")
    log(f"phase 27: {time.perf_counter() - t_phase:.1f} s")
    return launches_a, [lc for lc, _, _ in every2] + [lc for lc, _, _ in every4]


# ---- phase 28: pipeline and context parallelism of the verdict model -------------

PC_STEPS, PC_MICRO = 2, 4  # steps against one device; microbatches a pipeline step
PC_DP_LAYERS = 2  # (d)'s model: phase 14's width, 2 layers
PC_LOSS_RTOL = 1e-5  # losses against the single-device step
PC_LOGIT_RTOL, PC_LOGIT_ATOL = 2e-5, 2e-6  # tests/test_cp.py's forward gate
PC_ADAM_SHARE = 1e-5  # of a leaf's elements may differ by Adam's sign noise (below)
PC_MODEL = dict(MP_MODEL, encoder=dict(VERDICT_ENCODER, attention="xla"))  # PP and CP
#   refuse flash, as the reference's do


def pc_loss_check(label, losses, want):
    if not np.allclose(losses, want, rtol=PC_LOSS_RTOL, atol=0):
        fail(f"phase 28: {label}: losses {losses} against {want} (rtol {PC_LOSS_RTOL})")


def pc_logit_gap(logits, want):
    """Fail-free: (within the forward gate, largest difference)."""
    import torch

    got = logits.detach().cpu()
    return (bool(torch.allclose(got, want, rtol=PC_LOGIT_RTOL, atol=PC_LOGIT_ATOL)),
            float((got - want).abs().max()))


def pc_pipeline(cfg, mesh, init, batch, ref, steps, save=None):
    """``steps`` pipeline steps on ``mesh`` from ``init`` (pipeline layout,
    this rank's shards and rows): losses, median wall ms a step, the gap of
    the shards from the single-device parameters ``ref["params"]``, and
    the state (with ``save``: written with ``save_sharded`` after that
    many steps to ``save[1]``)."""
    from ircl_tpu_torch.parallel import pp, tp
    from ircl_tpu_torch.utils.checkpoint import save_sharded

    stages = mesh["stage"].size()
    pp0 = pp.pp_verdict_params(init, stages)
    specs = pp.pp_verdict_specs(pp0, mesh)
    step, tx = pp.make_pp_verdict_train_step(cfg, mesh, PC_MICRO)
    p = tp.shard_tree(pp0, specs, mesh)
    o = tp.init_sharded_opt_state(tx, p, mesh, specs)
    placed = tp.shard_batch(mesh, *batch)
    grads, losses, ms = None, [], []
    for i in range(steps):
        if i == 0 and "grads" in ref:  # the step's two halves, to read its gradient
            loss, _, g = pp.make_pp_verdict_grad_fn(cfg, mesh, PC_MICRO)(p, *placed)
            grads = mp_grad_gap(g, pp.pp_verdict_params(ref["grads"], stages), specs, mesh)
            tx.update_(p, g, o, body=("embed", "stages"))  # no freeze (mp_config)
            losses.append(float(loss))
            ms.append(float("nan"))  # untimed, as every first step
            del g
            continue
        p, o, loss, t = timed_step(step, p, o, i, placed)
        losses.append(loss)
        ms.append(t)
        if save and save[0] == i + 1:
            save_sharded(save[1], {"params": p, "opt": o}, mesh=mesh,
                         specs={"params": specs, "opt": tp.state_specs(o, p, specs)})
    kb = 2 * cfg.learning_rate * steps  # the k/b leaves: noise under Adam (phase 27)
    gap = pc_param_gap(p, pp.pp_verdict_params(ref["params"], stages), specs, mesh, kb)
    return dict(losses=losses, ms=float(np.median(ms[1:] if len(ms) > 1 else ms)),
                params=gap, grads=grads), (p, o, specs, step, tx, placed)


def pc_context(cfg, mesh, init, batch, ref, steps, dev):
    """One context-parallel forward on the whole batch, then ``steps``
    steps with the verdict model's AdamW: the logits' gap from
    ``verdict_apply``'s, losses, median wall ms a step and the parameters'
    gap from the single-device step's."""
    import torch

    from ircl_tpu_torch.parallel import cp, tp
    from ircl_tpu_torch.utils.tree import tree_map
    from ircl_tpu_torch.verdict.model import make_verdict_optimizer

    p = tree_map(lambda t: t.to(dev, copy=True), init)
    logits = pc_logit_gap(cp.make_cp_verdict_forward(cfg, mesh)(p, *batch[:3]),
                          ref["logits"])
    step, tx = cp.make_cp_verdict_train_step(cfg, mesh, make_verdict_optimizer(cfg))
    o = tx.init(p)
    # step 0 in its two halves, to read its gradient through the reverse ring
    loss, g = cp.make_cp_verdict_grad_fn(cfg, mesh)(p, *batch)
    grads = mp_grad_gap(g, ref["grads"], tp.replicated_specs(p), mesh)
    tx.update_(p, g, o)
    del g
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    losses, ms = [float(loss)], []
    for _ in range(1, steps):
        sync()
        t0 = time.perf_counter()
        p, o, loss = step(p, o, *batch)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    kb = 2 * cfg.learning_rate * steps
    gap = pc_param_gap(p, ref["params"], tp.replicated_specs(p), mesh, kb)
    return dict(logits=logits, losses=losses, ms=float(np.median(ms)), params=gap,
                grads=grads)


def pc_rank_case(case, model, batch, dev, inits):
    """One case of phase 28 on this rank: ``"pp"`` (with ``restore``: the
    sharded checkpoint, its restacking onto one stage and the resumed step)
    or ``"cp"``. ``inits`` keeps the initial parameters drawn for a config,
    which the cases only read."""
    import torch

    from ircl_tpu_torch.parallel import cp, pp, tp
    from ircl_tpu_torch.utils.checkpoint import restore_sharded
    from ircl_tpu_torch.utils.tree import tree_leaves

    cfg = mp_config(model, **case["cfg"])
    key = tuple(sorted(case["cfg"].items()))
    if key not in inits:  # the parent's draw, where it wrote one
        inits[key] = (torch.load(case["init"], mmap=True, weights_only=True)
                      if case.get("init") else mp_init(cfg, model["seed"]))
    init = inits[key]
    ref = torch.load(case["ref"], mmap=True, weights_only=True)
    if case["kind"] == "cp":
        mesh = cp.make_cp_mesh(seq=case["seq"], data=1, device=dev)
        return pc_context(cfg, mesh, init, batch, ref, case["steps"], dev)
    mesh = pp.make_pp_mesh(case["stages"], data=case.get("data", 1), device=dev)
    save = (case["save_after"], case["ckpt"]) if case.get("restore") else None
    out, (p, o, specs, step, tx, placed) = pc_pipeline(cfg, mesh, init, batch, ref,
                                                       case["steps"], save)
    if case.get("restore"):  # a fresh layout, read back; then the remaining steps
        fresh = tp.shard_tree(pp.pp_verdict_params(init, case["stages"]), specs, mesh)
        state = tp.init_sharded_opt_state(tx, fresh, mesh, specs)
        back = restore_sharded(case["ckpt"], {"params": fresh, "opt": state}, mesh=mesh,
                               specs={"params": specs, "opt": tp.state_specs(state, fresh,
                                                                              specs)})
        whole = tp.gather_tree(back["params"], specs, mesh)
        one = pp.restack_pp_params(whole, 1)
        kept = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(pp.unstack_layer_params(one["stages"])),
            tree_leaves(pp.unstack_layer_params(whole["stages"]))))
        q, s = back["params"], back["opt"]
        count, losses = s["count"], []
        for i in range(case["save_after"], case["steps"]):
            q, s, loss, _ = timed_step(step, q, s, i, placed)
            losses.append(loss)
        far = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(q), tree_leaves(p)))
        out["restored"] = dict(count=count, losses=losses, largest=far, layers_kept=kept,
                               restacked=tuple(one["stages"]["q"]["w"].shape),
                               uninterrupted=out["losses"][case["save_after"]:])
    del p, o
    torch.cuda.empty_cache()
    return out


def rank_pipeline_context(spec):
    """A rank of phase 28: its cases, and every rank's results, launches of
    #6a-#6c (none: the pipeline and the ring run the "xla" attention) and
    loaded JAX modules, gathered to rank 0."""
    import torch
    import torch.distributed as dist

    from ircl_tpu_torch.ops.flash_attention_cuda import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    )

    started = time.time()  # the wall clock the parent shares: the ranks' start-up
    counters = (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    for fn in counters:
        fn.launches = 0
    dev = (torch.device("cuda", torch.cuda.current_device()) if spec["device"] == "cuda"
           else torch.device("cpu"))
    batch = tuple(torch.as_tensor(x) for x in spec["batch"])
    out, inits = {}, {}
    for case in spec["cases"]:
        t0 = time.perf_counter()
        out[case["name"]] = pc_rank_case(case, spec["model"], batch, dev, inits)
        out[case["name"]]["seconds"] = time.perf_counter() - t0
    out["started"] = started
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, ([fn.launches for fn in counters], out, jax_modules()))
    return every


def pc_param_gap(local, whole, specs, mesh, adam_atol):
    """This rank's shards against the same slices of the single-device
    parameters after the same steps: (ok, largest difference, the elements
    outside rtol MP_PARAM_RTOL, atol MP_PARAM_ATOL by leaf: (leaf, count,
    of, largest difference, its value)). Adam moves an element whose
    gradient is at the level of f32 noise by up to the learning rate a step
    whatever the noise's sign (phase 14's rule), so the gradient's summation
    order (microbatches, the ring) may move it by up to ``adam_atol``; at
    most PC_ADAM_SHARE of a leaf's elements (at least one) may do so, and
    the k/b leaves, whose gradient is zero in exact arithmetic, all of
    theirs, as phase 27 holds them. Every other element meets the gates."""
    import torch

    from ircl_tpu_torch.parallel.tp import shard_tree

    want = shard_tree(whole, specs, mesh)
    ok, far, outside = True, 0.0, []
    for (name, a), (_, b) in zip(named_leaves(local), named_leaves(want)):
        d = (a - b).abs()
        if name.endswith("/k/b"):
            ok &= float(d.max()) <= adam_atol
            continue
        far = max(far, float(d.max()))
        bad = d > MP_PARAM_ATOL + MP_PARAM_RTOL * b.abs()
        if bool(bad.any()):
            n = int(bad.sum())
            ok &= n <= max(1, int(PC_ADAM_SHARE * b.numel())) and float(d.max()) <= adam_atol
            i = int(torch.argmax(torch.where(bad, d, torch.zeros_like(d))))
            outside.append((name, n, b.numel(), float(d.flatten()[i]),
                            float(b.flatten()[i])))
    return ok, far, outside


def pc_params_check(label, gap):
    ok, far, outside = gap
    if not ok:
        fail(f"phase 28: {label}: parameters outside rtol {MP_PARAM_RTOL}, atol "
             f"{MP_PARAM_ATOL} of the single-device step's beyond Adam's sign noise "
             f"(largest difference {far}): {outside[:12]}")
    return far, outside


def pc_grads_check(label, gap):
    (worst, leaf), noise = gap
    if worst > MP_GRAD_RTOL or noise > MP_NOISE_ATOL:
        fail(f"phase 28: {label}: step 0's gradient {worst} of {leaf}'s largest element "
             f"(bound {MP_GRAD_RTOL}), k/b noise {noise} (bound {MP_NOISE_ATOL})")
    return worst


def phase28_pipeline_context(dev, tok, pairs, tmpdir, smi, model=None):
    """Pipeline and context parallelism of the verdict model on the card,
    phase 14's model with the "xla" attention (PP and CP refuse flash): (a)
    one NCCL rank in this process, a (1, 1) ``("data", "stage")`` mesh for
    2 pipeline steps of 4 microbatches and a (1, 1) ``("data", "seq")``
    mesh for one forward and 2 steps; (b) PP(2) on two gloo ranks sharing
    the card, 6 layers a stage, and (c) CP(2), L_local = 256, in the same
    launch; (d) PP(2) x DP(2) on four ranks at 2 layers, saved sharded after
    step 1, restored, restacked onto one stage and stepped once more. Each
    is held to the single-device step. Returns the launches of #6a-#6c by
    rank, which must all be 0."""
    import tempfile as _tempfile

    import torch
    import torch.distributed as dist

    from ircl_tpu_torch.parallel import cp, pp
    from ircl_tpu_torch.parallel.launch import launch

    model = model or PC_MODEL
    t_phase = time.perf_counter()
    np_batch = train_batch(tok, pairs, range(3, 3 + TRAIN_BATCH), 14)  # phase 14's
    batch = batch_tensors(np_batch, dev)
    cfg = mp_config(model)
    enc = cfg.encoder
    log(f"phase 28: verdict model {enc.layers} x {enc.hidden}, {enc.heads} heads, "
        f"{enc.attention}, B={TRAIN_BATCH}, L={np_batch[0].shape[1]}; no freeze, no warmup; "
        f"{PC_MICRO} microbatches a pipeline step")
    ref_path, ref_d = f"{tmpdir}/pc_ref.pt", f"{tmpdir}/pc_ref_d.pt"
    ref_losses, ms_one = mp_reference(cfg, model["seed"], batch, dev, PC_STEPS, ref_path,
                                      grads=True, logits=True)
    ref_losses_d, ms_one_d = mp_reference(mp_config(model, layers=PC_DP_LAYERS),
                                          model["seed"], batch, dev, PC_STEPS, ref_d)
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    t_a = time.perf_counter()
    log(f"phase 28: single-device references in {t_a - t_phase:.1f} s")

    # ---- (a) one NCCL rank in this process, (1, 1) meshes ----
    init = mp_init(cfg, model["seed"])
    init_path = f"{tmpdir}/pc_init.pt"  # read by (b)-(c)'s ranks in place of a draw each
    torch.save(init, init_path)
    rdv = _tempfile.mkdtemp(prefix="ircl_nccl_", dir=tmpdir)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{rdv}/rendezvous", rank=0, world_size=1)
    try:
        a_pp, _ = pc_pipeline(cfg, pp.make_pp_mesh(1, data=1, device=dev), init, batch, ref,
                              PC_STEPS)
        a_cp = pc_context(cfg, cp.make_cp_mesh(seq=1, data=1, device=dev), init, batch,
                          ref, PC_STEPS, dev)
        del init
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    pc_loss_check("(a) PP on a (1, 1) mesh", a_pp["losses"], ref_losses)
    g_a = pc_grads_check("(a) PP on a (1, 1) mesh", a_pp["grads"])
    far_a = pc_params_check("(a) PP on a (1, 1) mesh", a_pp["params"])
    if not a_cp["logits"][0]:
        fail(f"phase 28: (a) CP forward on a (1, 1) mesh: logits {a_cp['logits'][1]} from "
             f"verdict_apply's (rtol {PC_LOGIT_RTOL}, atol {PC_LOGIT_ATOL})")
    pc_loss_check("(a) CP on a (1, 1) mesh", a_cp["losses"], ref_losses)
    g_ac = pc_grads_check("(a) CP on a (1, 1) mesh", a_cp["grads"])
    far_ac = pc_params_check("(a) CP on a (1, 1) mesh", a_cp["params"])
    log(f"phase 28: (a) 1 NCCL rank: PP (1, 1) step 0's gradient within {g_a:.3g} of each "
        f"leaf's largest element (bound {MP_GRAD_RTOL}), {PC_STEPS} steps' losses "
        f"{a_pp['losses']} against {ref_losses} (rtol {PC_LOSS_RTOL}), parameters within "
        f"rtol {MP_PARAM_RTOL}, atol {MP_PARAM_ATOL} but for Adam's sign noise {far_a[1]} "
        f"(largest difference {far_a[0]:.3g}); CP (1, 1) logits within "
        f"{a_cp['logits'][1]:.3g} of verdict_apply's, gradient within {g_ac:.3g}, "
        f"{PC_STEPS} steps' losses {a_cp['losses']}, parameters within the gates "
        f"({far_ac[0]:.3g}; {far_ac[1]}); {time.perf_counter() - t_a:.1f} s")

    # ---- (b) PP(2) and (c) CP(2): two gloo ranks on the card ----
    t0 = time.perf_counter()
    spec = dict(device=dev.type, model=model, batch=np_batch, cases=[
        dict(name="pp", kind="pp", cfg={}, ref=ref_path, init=init_path, stages=2,
             steps=PC_STEPS),
        dict(name="cp", kind="cp", cfg={}, ref=ref_path, init=init_path, seq=2,
             steps=PC_STEPS)])
    t_launch = time.time()
    try:
        every2 = launch(rank_pipeline_context, 2, spec, device=dev, backend="gloo",
                        timeout=600)
    except RuntimeError as e:
        fail(f"phase 28: the 2-rank PP and CP run failed: {e}")
    start2 = max(out["started"] for _, out, _ in every2) - t_launch
    for r, (launches, out, loaded) in enumerate(every2):
        if loaded or any(launches):
            fail(f"phase 28: rank {r} of 2 launched {launches} and loaded {loaded}")
        pc_loss_check(f"(b) PP(2) rank {r}", out["pp"]["losses"], ref_losses)
        g_b = pc_grads_check(f"(b) PP(2) rank {r}", out["pp"]["grads"])
        far_b = pc_params_check(f"(b) PP(2) rank {r}", out["pp"]["params"])
        if not out["cp"]["logits"][0]:
            fail(f"phase 28: (c) CP(2) rank {r}: logits {out['cp']['logits'][1]} from "
                 f"verdict_apply's (rtol {PC_LOGIT_RTOL}, atol {PC_LOGIT_ATOL})")
        pc_loss_check(f"(c) CP(2) rank {r}", out["cp"]["losses"], ref_losses)
        g_c = pc_grads_check(f"(c) CP(2) rank {r}", out["cp"]["grads"])
        far_c = pc_params_check(f"(c) CP(2) rank {r}", out["cp"]["params"])
    out2 = every2[0][1]
    log(f"phase 28: (b) PP(2), {enc.layers // 2} layers a stage: step 0's gradient slices "
        f"within {g_b:.3g} of each leaf's largest element, {PC_STEPS} steps' losses "
        f"{out2['pp']['losses']} against {ref_losses}; each rank's stage within the gates "
        f"({far_b[0]:.3g}; Adam's sign noise {far_b[1]}); (c) CP(2), L_local = "
        f"{np_batch[0].shape[1] // 2}: logits within {out2['cp']['logits'][1]:.3g} of "
        f"verdict_apply's, gradient within {g_c:.3g}, {PC_STEPS} steps' losses "
        f"{out2['cp']['losses']}, parameters within the gates ({far_c[0]:.3g}; "
        f"{far_c[1]}); {time.perf_counter() - t0:.1f} s (the ranks up after {start2:.1f} "
        f"s, (b) {out2['pp']['seconds']:.1f} s, (c) {out2['cp']['seconds']:.1f} s)")

    # ---- (d) PP(2) x DP(2) on four ranks, the sharded checkpoint and restacking ----
    t0 = time.perf_counter()
    spec = dict(device=dev.type, model=model, batch=np_batch, cases=[dict(
        name="ppdp", kind="pp", cfg={"layers": PC_DP_LAYERS}, ref=ref_d, stages=2, data=2,
        steps=PC_STEPS, save_after=1, restore=True, ckpt=f"{tmpdir}/pc_ckpt")])
    t_launch = time.time()
    try:
        every4 = launch(rank_pipeline_context, 4, spec, device=dev, backend="gloo",
                        timeout=600)
    except RuntimeError as e:
        fail(f"phase 28: the 4-rank PP x DP run failed: {e}")
    start4 = max(out["started"] for _, out, _ in every4) - t_launch
    for r, (launches, out, loaded) in enumerate(every4):
        if loaded or any(launches):
            fail(f"phase 28: rank {r} of 4 launched {launches} and loaded {loaded}")
        d = out["ppdp"]
        pc_loss_check(f"(d) PP(2) x DP(2) rank {r}", d["losses"], ref_losses_d)
        far_d = pc_params_check(f"(d) PP(2) x DP(2) rank {r}", d["params"])[0]
        back = d["restored"]
        if (back["count"] != 1 or not back["layers_kept"]
                or back["restacked"][:2] != (1, PC_DP_LAYERS)
                or not np.allclose(back["losses"], back["uninterrupted"],
                                   rtol=PC_LOSS_RTOL, atol=0)
                or back["largest"] > MP_PARAM_ATOL + 2 * cfg.learning_rate):
            fail(f"phase 28: (d) rank {r}: restored {back}")
    out4 = every4[0][1]["ppdp"]
    log(f"phase 28: (d) PP(2) x DP(2), {PC_DP_LAYERS} layers: {PC_STEPS} steps' losses "
        f"{out4['losses']} against {ref_losses_d} ({far_d:.3g}); saved sharded after step 1, "
        f"restored (count {out4['restored']['count']}), restacked onto one stage "
        f"{out4['restored']['restacked']} with every layer's bits, step 2's loss "
        f"{out4['restored']['losses']} against the uninterrupted "
        f"{out4['restored']['uninterrupted']}, parameters within "
        f"{out4['restored']['largest']:.3g} of it; {time.perf_counter() - t0:.1f} s (the "
        f"ranks up after {start4:.1f} s, the case {out4['seconds']:.1f} s)")
    log(f"phase 28: wall ms a step ({smi}; the ranks share one card and move activations, "
        f"blocks and gradients through gloo on the host, so these times check overhead, not "
        f"scaling): one device {ms_one:.1f}, (a) PP (1, 1) {a_pp['ms']:.1f}, CP (1, 1) "
        f"{a_cp['ms']:.1f}, (b) PP(2) {out2['pp']['ms']:.1f}, (c) CP(2) "
        f"{out2['cp']['ms']:.1f}; {PC_DP_LAYERS} layers one device {ms_one_d:.1f}, (d) "
        f"PP(2) x DP(2) {out4['ms']:.1f}")
    log(f"phase 28: {time.perf_counter() - t_phase:.1f} s")
    return [lc for lc, _, _ in every2] + [lc for lc, _, _ in every4]


# Every process of the rehearsal (the tool, its RSS wrappers and each CLI
# command) starts with this as its sitecustomize: an import of JAX or of the
# JAX package fails there, and at exit a process that loaded the port's
# kernel wrappers writes their launch counts into SMOKE_LAUNCH_DIR. A
# sitecustomize it shadows still runs.
_TOOL_PROCESS_SITE = r"""
import atexit, importlib.abc, importlib.machinery, importlib.util, json, os, sys

class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ircl_tpu"):
            raise ImportError(f"{name}: a process of the port's tools imported it")
        return None

sys.meta_path.insert(0, _Refuse())

def _report():
    out = os.environ.get("SMOKE_LAUNCH_DIR")
    kernels = {"ircl_tpu_torch.ops.membership_cuda": ("membership_slab",
                                                      "membership_slab_windowed"),
               "ircl_tpu_torch.ops.light_add_cuda": ("light_add_topk_t",),
               "ircl_tpu_torch.ops.flash_attention_cuda": ("flash_attention",)}
    counts = {n: getattr(sys.modules[m], n).launches
              for m, names in kernels.items() if m in sys.modules for n in names}
    if out and counts:
        with open(os.path.join(out, f"{os.getpid()}.json"), "w") as f:
            json.dump({"argv": sys.argv, "rank": os.environ.get("RANK"),
                       "launches": counts}, f)

atexit.register(_report)
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
"""


def moved_off_ties(card, cpu):
    """Sentences a claim's card ranking places elsewhere than the CPU's:
    ``(moved, worst)``, where ``worst`` is the largest gap between a moved
    sentence's card cosine and the card's cosine at the CPU's rank (or at
    the list's end, where the CPU dropped it)."""
    moved, worst = 0, 0.0
    for keys_a, s_a, keys_b in zip(card.sentences, card.sentence_scores, cpu.sentences):
        if keys_a == keys_b:
            continue
        at_b = {k: p for p, k in enumerate(keys_b)}
        for j, k in enumerate(keys_a):
            p = at_b.get(k, len(keys_a) - 1)
            if p != j:
                moved += 1
                worst = max(worst, abs(float(s_a[j]) - float(s_a[min(p, len(s_a) - 1)])))
    return moved, worst


def tied_lists_agree(card, cpu, rtol):
    """Two devices' ranked ``(ids, scores)`` lists, claim by claim: scores
    within ``rtol``, and the ids equal as sets within every group of tied
    scores but the last, which a tie at the cut may fill with other docs
    (the card's top-k and the CPU's break exact ties differently). Returns
    how many claims' ids differ, or None where a pair breaks the rule."""
    differ = 0
    for (ia, sa), (ib, sb) in zip(card, cpu):
        sa, sb = np.asarray(sa, np.float64), np.asarray(sb, np.float64)
        if len(ia) != len(ib) or not np.allclose(sa, sb, rtol=rtol, atol=0.0):
            return None
        if list(ia) == list(ib):
            continue
        differ += 1
        start = 0
        for j in range(1, len(sb)):
            if sb[j] < sb[j - 1] - rtol * abs(sb[j - 1]):
                if set(ia[start:j]) != set(ib[start:j]):
                    return None
                start = j
    return differ if len(card) == len(cpu) else None


class FixedRanker:
    """A stage-1 ranker that hands out given ``(ids, scores)`` rows in
    order: the CPU side of phase 29 reruns a stage on the card's doc lists,
    so that the check meets the stage and not the card's tie breaks."""

    def __init__(self, rows):
        self.rows = list(rows)

    def closest_docs_batch(self, queries, k=5):
        out, self.rows = self.rows[:len(queries)], self.rows[len(queries):]
        return out


def tool_eval_on_cpu(corpus_args, cfg, feat, state, card_deep, card_docs, out):
    """(a)'s CPU side, on a thread: the stage-1 sweep and the sparse row
    through the tool's own functions, the card's stage-1 lists against the
    CPU's, and the untrained dense stage 2 on the card's doc lists with the
    card's state and featurizer moved to the CPU."""
    try:
        from ircl_tpu_torch.models.featurizer import HashEmbedFeaturizer
        from ircl_tpu_torch.pipeline.dense_scorer import ContrastiveSentenceScorer
        from ircl_tpu_torch.pipeline.recall import sentence_recall_at_k
        from ircl_tpu_torch.pipeline.retrieve import host_sparse_scorer, retrieve
        from ircl_tpu_torch.tools import eval_e2e
        from ircl_tpu_torch.utils.convert import to_device

        ks = eval_e2e.KS
        wiki, claims_text, ranker, _ = eval_e2e.build_corpus(*corpus_args, "cpu")
        out["doc_tfidf"] = eval_e2e.stage1_sweep(wiki, claims_text, ranker)
        out["deep_ties"] = tied_lists_agree(
            card_deep, ranker.closest_docs_batch(claims_text, k=max(ks)), TOOLS_SCORE_RTOL)
        out["sparse"] = eval_e2e.stage2(wiki, claims_text, ranker, host_sparse_scorer())[0]
        k20 = ranker.closest_docs_batch(claims_text, k=20)
        out["k20_ties"] = tied_lists_agree(card_docs, k20, TOOLS_SCORE_RTOL)
        feat_cpu = HashEmbedFeaturizer(feat.config, device="cpu",
                                       params=to_device(feat.params, "cpu"))
        scorer = ContrastiveSentenceScorer(cfg, feat_cpu, state_to(state, "cpu"))
        res = retrieve(claims_text, FixedRanker(card_docs), wiki.sentences, scorer,
                       k_docs=20, k_sents=max(ks), batch_size=256)
        out["dense_untrained"] = {
            k: round(sentence_recall_at_k(wiki.claims, res.sentences, k=k), 4) for k in ks}
        out["dense_result"] = res
    except Exception:  # the thread's boundary: the main thread fails with it
        import traceback

        out["error"] = traceback.format_exc()


def tool_launches(launch_dir):
    """The rehearsal's CLI processes' launch counts, by command."""
    by_command = {}
    for name in sorted(os.listdir(launch_dir)):
        rec = json.load(open(os.path.join(launch_dir, name)))
        command = next((a for a in rec["argv"] if a in (
            "fetch", "prepare", "build-index", "train", "retrieve", "serve")), "other")
        total = by_command.setdefault(command, {})
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
    return by_command


def phase29_tools(dev, root, tmpdir, smi, counted):
    """The paper's measured experiments and the scale rehearsal through the
    port's tools at a cut depth: (a) eval_e2e, (b) similarity_ab and (c)
    verdict_table2 in this process, each held to its deterministic part on
    the CPU; (d) rehearsal_scale in fresh processes, started first and held
    to the port's API in this process. Returns this process's launches on
    (a)-(c) and the rehearsal's by command."""
    import threading

    import torch

    from ircl_tpu_torch.corpus import fever
    from ircl_tpu_torch.corpus.store import MemoryDocStore
    from ircl_tpu_torch.corpus.synthetic import generate
    from ircl_tpu_torch.data.similarity import sentence_pair_similarity
    from ircl_tpu_torch.index.build import build_count_index
    from ircl_tpu_torch.index.ranker import TfidfRanker
    from ircl_tpu_torch.index.tfidf import tfidf_transform
    from ircl_tpu_torch.pipeline.recall import doc_recall_at_k
    from ircl_tpu_torch.tools import eval_e2e, similarity_ab, verdict_table2
    from ircl_tpu_torch.utils.convert import to_device
    from ircl_tpu_torch.verdict.model import verdict_apply
    from ircl_tpu_torch.verdict.train import predict_in_batches

    out_md = os.path.join(tmpdir, "RESULTS_TORCH.md")
    seconds = {}
    t_phase = time.perf_counter()

    # (d) first: the CLI chain in fresh processes, beside (a)-(c)
    reh_ws, launch_dir, site = (os.path.join(tmpdir, n) for n in (
        "rehearsal", "rehearsal_launches", "rehearsal_site"))
    os.makedirs(launch_dir)
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(_TOOL_PROCESS_SITE)
    env = dict(os.environ, SMOKE_LAUNCH_DIR=launch_dir, PYTHONPATH=os.pathsep.join(
        p for p in (site, root, os.environ.get("PYTHONPATH")) if p))
    reh = subprocess.Popen(
        [sys.executable, "-m", "ircl_tpu_torch.tools.rehearsal_scale", *TOOLS_REHEARSAL,
         "--workdir", reh_ws], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        # (a) eval_e2e on the card, its corpus, untrained state and stage-2
        # results recorded; the CPU side on a thread while (b) and (c) run
        rec = {"corpus": [], "scorer": [], "retrieved": []}
        undo = [spy_on(eval_e2e, "build_corpus", lambda a, o: rec["corpus"].append(o)),
                spy_on(eval_e2e, "ContrastiveSentenceScorer",
                       lambda a, o: rec["scorer"].append(a)),
                spy_on(eval_e2e, "retrieve", lambda a, o: rec["retrieved"].append(o))]
        t0 = time.perf_counter()
        try:
            results, sweep = eval_e2e.main([*TOOLS_EVAL, "--out", out_md])
        finally:
            for u in undo:
                u()
        seconds["eval_e2e"] = round(time.perf_counter() - t0, 2)
        cfg, feat, state0 = rec["scorer"][0]
        ea = eval_e2e.parse_args(TOOLS_EVAL)
        wiki_a, claims_a, ranker_a, _ = rec["corpus"][0]
        card_deep = ranker_a.closest_docs_batch(claims_a, k=max(eval_e2e.KS))
        card_docs = list(zip(rec["retrieved"][1].doc_ids, rec["retrieved"][1].doc_scores))
        del wiki_a, ranker_a
        cpu_a = {}
        worker = threading.Thread(target=tool_eval_on_cpu, args=(
            (ea.docs, ea.claims), cfg, feat, state0, card_deep, card_docs, cpu_a),
            daemon=True)
        worker.start()

        # (b) similarity_ab; its divergence counts against the CPU's
        t0 = time.perf_counter()
        res_ab = similarity_ab.main([*TOOLS_AB, "--out", out_md])
        seconds["similarity_ab"] = round(time.perf_counter() - t0, 2)
        ab = similarity_ab.parse_args(TOOLS_AB)
        docs = list(generate(num_docs=ab.docs, num_claims=ab.claims,
                             inflect_prob=ab.inflect, seed=42).sentences.values())
        want = similarity_ab.divergence(sentence_pair_similarity(docs),
                                        sentence_pair_similarity(docs, stem=True))
        got = (res_ab["docs_top_pair_changed"], res_ab["docs_ordering_changed"])
        if got != want:
            fail(f"phase 29 (b): divergence counts {got} on the card, {want} on the CPU")

        # (c) verdict_table2; every encoded array, the retrieval recall and
        # the dev labels against the CPU
        rec_c = {"train": [], "predict": [], "retrieved": []}
        undo = [spy_on(verdict_table2, "train_verdict",
                       lambda a, o: rec_c["train"].append(a[1:5])),
                spy_on(verdict_table2, "predict_in_batches",
                       lambda a, o: rec_c["predict"].append((a, o))),
                spy_on(verdict_table2, "retrieve",
                       lambda a, o: rec_c["retrieved"].append(o))]
        t0 = time.perf_counter()
        try:
            res_c, table = verdict_table2.main([*TOOLS_TABLE2, "--out", out_md])
        finally:
            for u in undo:
                u()
        seconds["verdict_table2"] = round(time.perf_counter() - t0, 2)
        launches = {name: fn.launches for name, fn in counted.items()}
        t0 = time.perf_counter()
        va = verdict_table2.parse_args([*TOOLS_TABLE2, "--device", "cpu"])
        wiki_c, train_c, dev_c = verdict_table2.build_corpus(va)
        # the card's retrievals (the phase-C replay, the dev claims) against
        # the CPU's; then the CPU reruns the rest on the card's, so that the
        # arrays meet the curriculum and the encoding, not the tie breaks
        retr = verdict_table2.SentenceRetriever(wiki_c, "cpu")
        cpu_retrieved = [retr(train_c), retr(dev_c)]
        ties_c = [tied_lists_agree(list(zip(card.doc_ids, card.doc_scores)),
                                   list(zip(cpu.doc_ids, cpu.doc_scores)), TOOLS_SCORE_RTOL)
                  for card, cpu in zip(rec_c["retrieved"], cpu_retrieved)]
        if len(rec_c["retrieved"]) != 2 or None in ties_c:
            fail(f"phase 29 (c): the card's retrievals differ from the CPU's beyond exact "
                 f"ties ({ties_c})")
        card_retrieved = iter(rec_c["retrieved"])
        phases, tok_corpus = verdict_table2.curriculum(
            va, train_c, wiki_c.sentences,
            verdict_table2.make_build_aug(train_c, wiki_c.sentences, va.train_distractors),
            lambda claims: next(card_retrieved))
        tok = verdict_table2.train_tokenizer(tok_corpus)
        encoded = verdict_table2.encode_phases(phases, tok, va.max_length)
        if len(rec_c["train"]) != len(encoded) or not all(
                all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, enc[0]))
                for got, enc in zip(rec_c["train"], encoded)):
            fail("phase 29 (c): the card run's encoded phases differ from the CPU's")
        res_cpu = {}
        verdict_table2.dev_variants(dev_c, wiki_c.sentences, lambda c: cpu_retrieved[1],
                                    res_cpu)
        variants = verdict_table2.dev_variants(dev_c, wiki_c.sentences,
                                               lambda claims: next(card_retrieved), {})
        for key in ("tfidf_sentence_recall@1", "tfidf_sentence_recall@5"):
            if res_c[key] != res_cpu[key]:
                fail(f"phase 29 (c): {key} {res_c[key]} on the card, {res_cpu[key]} on "
                     f"the CPU")
        moved_labels = 0
        for (args, preds), override in zip(rec_c["predict"], variants.values()):
            arrays = verdict_table2.encode_variant(dev_c, wiki_c.sentences, override, tok,
                                                   va.max_length)
            if not all(np.array_equal(g, w) for g, w in zip(args[2:5], arrays[:3])):
                fail("phase 29 (c): a dev variant's encoded arrays differ from the CPU's")
            params, vcfg = to_device(args[0], "cpu"), args[1]
            want = predict_in_batches(params, vcfg, *arrays[:3], device="cpu")
            with torch.no_grad():
                logits = verdict_apply(params, vcfg, torch.as_tensor(arrays[0]).long(),
                                       torch.as_tensor(arrays[1], dtype=torch.float32),
                                       torch.as_tensor(arrays[2]).long())
            margin = (logits[:, 1] - logits[:, 0]).abs().numpy()
            moved = preds != want
            if (margin[moved] >= TOOLS_MARGIN).any():
                fail(f"phase 29 (c): dev labels differ from the CPU's at margins "
                     f"{margin[moved].tolist()}")
            moved_labels += int(moved.sum())
        if len(rec_c["predict"]) != len(variants):
            fail(f"phase 29 (c): {len(rec_c['predict'])} predictions for "
                 f"{len(variants)} evidence sources")
        seconds["verdict_table2_cpu_check"] = round(time.perf_counter() - t0, 2)
        log(f"phase 29 (c): verdict_table2 {' '.join(TOOLS_TABLE2)}: the card's doc lists "
            f"equal the CPU's but where exact ties break otherwise ({ties_c[0]} of "
            f"{len(train_c)} train and {ties_c[1]} of {len(dev_c)} dev claims); on them "
            f"{len(encoded)} encoded phases and {len(variants)} dev variants bit-equal to "
            f"the CPU's, "
            f"tfidf sentence recall@1/@5 {res_c['tfidf_sentence_recall@1']}/"
            f"{res_c['tfidf_sentence_recall@5']} equal; {moved_labels} dev labels moved "
            f"(all under a {TOOLS_MARGIN} margin); restart val F1 "
            f"{res_c['restart_val_f1s']}; macro F1 by source "
            f"{ {k: v['f1'] for k, v in table.items()} }")

        # (a)'s CPU side
        t0 = time.perf_counter()
        worker.join(TOOLS_TIMEOUT)
        if worker.is_alive() or "error" in cpu_a:
            fail(f"phase 29 (a): the CPU side failed: {cpu_a.get('error', 'timed out')}")
        seconds["eval_e2e_cpu_wait"] = round(time.perf_counter() - t0, 2)
        for tag in ("doc_tfidf", "sparse", "dense_untrained"):
            if sweep[tag] != cpu_a[tag]:
                fail(f"phase 29 (a): the {tag} row {sweep[tag]} on the card, "
                     f"{cpu_a[tag]} on the CPU")
        if cpu_a["deep_ties"] is None or cpu_a["k20_ties"] is None:
            fail("phase 29 (a): the card's stage-1 doc lists differ from the CPU's beyond "
                 "exact ties")
        card_res = rec["retrieved"][1]  # sparse, then dense_untrained
        moved, worst = moved_off_ties(card_res, cpu_a["dense_result"])
        if worst > TOOLS_TIE_ATOL:
            fail(f"phase 29 (a): a stage-2 sentence moved {worst:.3g} off its CPU rank's "
                 f"cosine")
        gap = max((float(np.abs(np.sort(a) - np.sort(b)).max()) for a, b in zip(
            card_res.sentence_scores, cpu_a["dense_result"].sentence_scores) if len(a)),
            default=0.0)
        log(f"phase 29 (a): eval_e2e {' '.join(TOOLS_EVAL)}: doc_tfidf, sparse and "
            f"dense_untrained (on the card's doc lists) rows equal the CPU's; the card's "
            f"stage-1 lists equal the CPU's but where exact ties break otherwise "
            f"({cpu_a['deep_ties']} claims at k=100, {cpu_a['k20_ties']} at k=20); "
            f"{moved} stage-2 ranks moved, all within "
            f"{TOOLS_TIE_ATOL} of their CPU rank's cosine; cosines card against CPU within "
            f"{gap:.3g}; recall@5 by variant "
            f"{ {k: v[5] for k, v in sweep.items()} }; train s "
            f"{ {k: v for k, v in results.items() if k.startswith('train_')} }")
        log(f"phase 29 (b): similarity_ab {' '.join(TOOLS_AB)}: divergence {got} equals "
            f"the CPU's; recall@5 surface {res_ab['sentence_recall@5_surface']}, stem "
            f"{res_ab['sentence_recall@5_stem']}")

        # (d): the chain's summary, its recall against this process's API
        t0 = time.perf_counter()
        stdout, stderr = reh.communicate(timeout=TOOLS_TIMEOUT)
        seconds["rehearsal_wait"] = round(time.perf_counter() - t0, 2)
        if reh.returncode != 0:
            fail(f"phase 29 (d): rehearsal_scale exited {reh.returncode}: {stderr[-3000:]}")
    finally:
        if reh.poll() is None:
            reh.kill()
            reh.wait(timeout=60)
    summary = json.loads(stdout.strip().splitlines()[-1])
    if summary.get("ok") is not True:
        fail(f"phase 29 (d): rehearsal summary {summary}")
    data = os.path.join(reh_ws, "data")
    wiki = fever.load_wiki_json(os.path.join(data, "small_wiki.json"))
    claims = fever.parse_claims_jsonl(os.path.join(data, "shared_task_dev.jsonl"),
                                      drop_nei=True)
    ranker = TfidfRanker(tfidf_transform(build_count_index(
        MemoryDocStore({d: r.get("text", "") for d, r in wiki.items()}), ngram=2,
        hash_size=1 << 24)), dev)
    texts = [c.claim for c in claims]
    doc_lists = [ids for i in range(0, len(texts), 256)
                 for ids, _ in ranker.closest_docs_batch(texts[i:i + 256], k=5)]
    mine = doc_recall_at_k(claims, doc_lists, k=5)
    if summary["doc_recall@k"] != mine:
        fail(f"phase 29 (d): the chain's doc recall {summary['doc_recall@k']} != {mine} "
             f"computed in this process")
    reh_launches = tool_launches(launch_dir)
    for command in ("retrieve", "serve"):
        if not reh_launches.get(command, {}).get("membership_slab"):
            fail(f"phase 29 (d): {command} did not launch membership_slab: {reh_launches}")
    log(f"phase 29 (d): rehearsal_scale {' '.join(TOOLS_REHEARSAL)}: ok, doc recall@5 "
        f"{summary['doc_recall@k']} (equal to this process's), sentence recall@5 "
        f"{summary['sentence_recall@k']}; seconds and peak RSS MB by stage "
        f"{ {k: (v['seconds'], v['peak_rss_mb']) for k, v in summary['stages'].items()} }; "
        f"launches by "
        f"command {reh_launches}; no process loaded JAX or the JAX package")
    seconds["phase"] = round(time.perf_counter() - t_phase, 2)
    log(f"phase 29: {smi}; seconds {json.dumps(seconds)}")
    del state0, feat, cfg
    torch.cuda.empty_cache()
    return launches, reh_launches


# ---- phase 30: the graft entry points and the sharded-scale tool ---------------

ENTRY_RANKS = 8  # the reference's dry run and scripts/sharded_scale.py: 8 devices
ENTRY_LOSS_RTOL = 1e-5  # entry()'s loss, card against CPU: fp32, TF32 off
# the shapes of the reference's numbers in its dry run at 8 devices, which
# tests/test_torch_graft_entry.py holds the port's to on the CPU
DRYRUN_SHAPES = dict(
    dp=dict(loss=(), grad_norm=()), dense=dict(scores=(8, 5), ids=(8, 5)),
    ell=dict(scores=(128, 3), ids=(128, 3)), hybrid=dict(scores=(6, 3), ids=(6, 3)),
    cp=dict(logits=(4, 2), loss=()),
    **{s: dict(loss=()) for s in ("tp", "sp", "pp", "pp_moe", "pp_ep_tp", "ep", "checkpoint")})


def rank_launches(launch_dir):
    """The launch counts of #1 and #2 in each rank that wrote into
    ``launch_dir`` (the processes that ``parallel/launch.py`` gave a
    ``RANK``), in rank order."""
    ranks = {}
    for name in os.listdir(launch_dir):
        rec = json.load(open(os.path.join(launch_dir, name)))
        if rec.get("rank") is not None:
            ranks[int(rec["rank"])] = [rec["launches"].get(k, 0)
                                       for k in ("membership_slab", "membership_slab_windowed")]
    return [ranks[r] for r in sorted(ranks)]


def shard0_slab_equal(dev, split, u_pad):
    """#2 on rank 0's block of the heavy ELL of 8 ranks (the block
    ``parallel/common.py::pad_and_shard_ell_t`` cuts: K padded to 8 with -1
    terms, docs to 8 x 256) with the tool's heavy union, against its plain
    version: bit for bit, and the slab's shape."""
    import torch

    from ircl_tpu_torch.ops.hybrid import _u_tile
    from ircl_tpu_torch.ops.membership_cuda import (membership_slab_ref,
                                                    membership_slab_windowed)

    n, k_w = split.heavy.terms.shape
    rows = -(-n // (ENTRY_RANKS * 256)) * 256
    terms = np.full((-(-k_w // 8) * 8, rows), -1, np.int32)
    vals = np.zeros(terms.shape, np.float32)
    m = min(rows, n)
    terms[:k_w, :m] = split.heavy.terms[:m].T
    vals[:k_w, :m] = split.heavy.vals[:m].T
    u, t, v = (torch.as_tensor(x, device=dev) for x in (u_pad, terms, vals))
    got = membership_slab_windowed(u, t, v, u_tile=_u_tile(u.shape[0], 256), d_tile=256)
    return torch.equal(got, membership_slab_ref(u, t, v)), tuple(got.shape)


@contextlib.contextmanager
def reporting_ranks(site_path, launch_dir):
    """While open, the ranks this process spawns start with the
    ``sitecustomize`` in ``site_path``, which refuses JAX and writes each
    rank's launch counts into ``launch_dir`` at its exit."""
    saved = {k: os.environ.get(k) for k in ("PYTHONPATH", "SMOKE_LAUNCH_DIR")}
    os.environ.update(PYTHONPATH=site_path, SMOKE_LAUNCH_DIR=launch_dir)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase30_graft_entry(dev, root, tmpdir, smi, counted):
    """The graft entry points and the sharded-scale tool on the card:
    (b) ``entry()`` card against CPU, and one backward; (c)
    ``dryrun_multichip(8)`` on 8 gloo ranks sharing the card; (a)
    ``tools/sharded_scale.py``'s ``main()`` at its defaults (``--ref
    scipy``) on 8 gloo ranks sharing the card, its sharded top-k also held
    to the ``--ref hybrid`` reference, and #2 on rank 0's shard against its
    plain version. The ranks are spawned from this process one launch at a
    time (beside each other, ranks' start-ups and collectives slowed each
    other down); each refuses JAX and writes its launches at exit. Returns
    the launches of #1 and #2 by rank, by run."""
    import torch

    from ircl_tpu_torch import graft_entry
    from ircl_tpu_torch.tools import sharded_scale
    from ircl_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    seconds, launches = {}, {}
    site = os.path.join(tmpdir, "graft_site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(_TOOL_PROCESS_SITE)
    site_path = os.pathsep.join(p for p in (site, root, os.environ.get("PYTHONPATH")) if p)

    # (b) entry() on the card against the CPU; a backward reaches params_q only
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    fn_cpu, args_cpu = graft_entry.entry("cpu")
    for a, b in zip(tree_leaves(list(args)), tree_leaves(list(args_cpu))):
        if not torch.equal(a.cpu(), b):
            fail("phase 30 (b): entry()'s arguments on the card differ from the CPU's")
    q_leaves, k_leaves = tree_leaves(args[0]), tree_leaves(args[1])
    for leaf in q_leaves + k_leaves:
        leaf.requires_grad_()
    loss = fn(*args)
    loss.backward()
    loss, loss_cpu = float(loss.detach()), float(fn_cpu(*args_cpu))
    if not np.isclose(loss, loss_cpu, rtol=ENTRY_LOSS_RTOL, atol=0.0):
        fail(f"phase 30 (b): entry()'s loss {loss} on the card, {loss_cpu} on the CPU")
    if any(x.grad is not None for x in k_leaves) or any(
            x.grad is None for x in q_leaves) or not any(
            bool(x.grad.abs().max() > 0) for x in q_leaves):
        fail("phase 30 (b): the backward of entry()'s loss reached params_k or "
             "missed params_q")
    launched = {name: fn_.launches for name, fn_ in counted.items() if fn_.launches}
    if launched:
        fail(f"phase 30 (b): entry() launched {launched}: its path runs no counted kernel")
    seconds["entry"] = round(time.perf_counter() - t0, 2)
    log(f"phase 30 (b): entry() on the card: loss {loss!r} against {loss_cpu!r} on the "
        f"CPU (rtol {ENTRY_LOSS_RTOL}); the backward reaches the {len(q_leaves)} "
        f"leaves of params_q and none of params_k")

    # (c) the dry run on 8 gloo ranks sharing the card
    t0 = time.perf_counter()
    dry_dir = os.path.join(tmpdir, "graft_dryrun")
    os.makedirs(dry_dir)
    try:
        with reporting_ranks(site_path, dry_dir):
            dry = graft_entry.dryrun_multichip(ENTRY_RANKS)
    except Exception as e:
        fail(f"phase 30 (c): dryrun_multichip({ENTRY_RANKS}) failed: {e}")
    seconds["dryrun"] = round(time.perf_counter() - t0, 2)
    if dry.pop("backend") != "gloo" or set(dry) != set(DRYRUN_SHAPES):
        fail(f"phase 30 (c): the dry run returned sections {sorted(dry)}")
    for name, want in DRYRUN_SHAPES.items():
        for key, shape in want.items():
            value = np.asarray(dry[name][key])
            if value.shape != shape or not np.isfinite(value).all():
                fail(f"phase 30 (c): {name}'s {key} {value} is not finite of shape {shape}")
    launches["dryrun"] = rank_launches(dry_dir)
    if len(launches["dryrun"]) != ENTRY_RANKS or not all(
            n1 and n2 for n1, n2 in launches["dryrun"]):
        fail(f"phase 30 (c): #1 and #2 did not run on every shard: {launches['dryrun']}")
    log(f"phase 30 (c): dryrun_multichip({ENTRY_RANKS}) on {ENTRY_RANKS} gloo ranks "
        f"sharing the card: every section finite in the reference's shapes; losses "
        f"{ {n: float(dry[n]['loss']) for n in DRYRUN_SHAPES if 'loss' in dry[n]} }, "
        f"grad norm {float(dry['dp']['grad_norm'])!r}; launches of (#1, #2) by rank "
        f"{launches['dryrun']}; {seconds['dryrun']} s")

    # (a) the tool's main() at its defaults; its host inputs and sharded top-k
    # are kept for the hybrid reference and the slab check
    t0 = time.perf_counter()
    scale_dir = os.path.join(tmpdir, "graft_scale")
    os.makedirs(scale_dir)
    kept = {}
    undo = [spy_on(sharded_scale, "sharded_inputs",
                   lambda a, out: kept.update(single=a[0], qb=a[1], qw=a[2], inputs=out)),
            spy_on(sharded_scale, "sharded_topk", lambda a, out: kept.update(topk=out))]
    printed = io.StringIO()
    try:
        with reporting_ranks(site_path, scale_dir), contextlib.redirect_stdout(printed):
            line = sharded_scale.main([])
    except (Exception, SystemExit) as e:
        fail(f"phase 30 (a): sharded_scale failed: {e!r}")
    finally:
        for u in undo:
            u()
    seconds["sharded_scale"] = round(time.perf_counter() - t0, 2)
    launched = {name: fn_.launches for name, fn_ in counted.items() if fn_.launches}
    if launched:
        fail(f"phase 30 (a): main() launched {launched} in this process, where its "
             f"kernels run in the ranks")
    opts = sharded_scale.parse_args([])
    want = dict(docs=opts.docs, parity=f"{opts.batch}/{opts.batch}", backend="gloo",
                ranks=ENTRY_RANKS)
    if json.loads(printed.getvalue().strip().splitlines()[-1]) != line or any(
            line.get(k) != v for k, v in want.items()):
        fail(f"phase 30 (a): sharded_scale printed {printed.getvalue()!r}, returned {line}")
    launches["sharded_scale"] = rank_launches(scale_dir)
    if len(launches["sharded_scale"]) != ENTRY_RANKS or not all(
            n1 and n2 for n1, n2 in launches["sharded_scale"]):
        fail(f"phase 30 (a): #1 and #2 did not run on every shard: "
             f"{launches['sharded_scale']}")
    # --ref hybrid: the one-device hybrid engine's top-k (its launches here are
    # the reference's, not the path's), the tool's gate
    t0 = time.perf_counter()
    single, (s, i, shard_s, _) = kept["single"], kept["topk"]
    ref = sharded_scale.hybrid_reference(single, kept["qb"], kept["qw"], sharded_scale.K)
    bad = sharded_scale.parity_failures(s[:opts.batch], i[:opts.batch], *ref)
    hybrid_line = sharded_scale.result_line(opts.docs, opts.batch, bad, single._split, "gloo")
    if hybrid_line != line:
        fail(f"phase 30 (a): against the one-device hybrid engine {hybrid_line}")
    # #2 on rank 0's shard of the tool's index, against its plain version
    equal, slab_shape = shard0_slab_equal(dev, single._split, kept["inputs"]["u_pad"])
    if not equal:
        fail("phase 30 (a): membership_slab_windowed on rank 0's shard differs from its "
             "plain version")
    seconds["hybrid_ref_and_slab"] = round(time.perf_counter() - t0, 2)
    log(f"phase 30 (a): sharded_scale at its defaults: {json.dumps(line)}; the same top-k "
        f"against the one-device hybrid engine: parity {hybrid_line['parity']}; rank 0's "
        f"top-k {shard_s:.2f} s; membership_slab_windowed on rank 0's shard "
        f"{list(slab_shape)} bit-equal to its plain version; launches of (#1, #2) by rank "
        f"{launches['sharded_scale']}")
    del single, kept
    seconds["phase"] = round(time.perf_counter() - t_phase, 2)
    log(f"phase 30: {smi}; seconds {json.dumps(seconds)}")
    torch.cuda.empty_cache()
    return launches


# phase 32: the grouped expert GEMM of the Moonlight cell (models/mla_moe.py)
GROUPED_ROWS, GROUPED_ROUTED = 98_304, 66_000  # 6 x 32 x 512 routed places; the
# cell's ~66K real ones (6 x ~11K real tokens), the rest past offsets[E]


def grouped_offsets(E, rows, gen):
    """Skewed counts of ``rows`` rows over ``E`` experts: experts 3, 17 and
    40 empty, expert 5 shorter than a tile."""
    import torch

    w = torch.rand(E, generator=gen) ** 3
    w[[3, 17, 40]] = 0.0
    counts = torch.floor(w / w.sum() * rows).long()
    counts[5] = 37
    counts[0] += rows - int(counts.sum())
    return torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)]).to(torch.int32)


def grouped_within_rounding(label, got, a, w, offsets):
    """Each expert's rows of ``got`` within half a bf16 unit of the exact
    (f64) product plus 2^-11 of the sum of the terms' magnitudes; a wrong
    row, column or expert is off by about the product itself."""
    off = offsets.tolist()
    worst = 0.0
    for e in range(len(off) - 1):
        lo, hi = off[e], off[e + 1]
        if hi == lo:
            continue
        exact = a[lo:hi].double() @ w[e].double().T
        scale = a[lo:hi].double().abs() @ w[e].double().abs().T
        over = ((got[lo:hi].double() - exact).abs() - 2 ** -8 * exact.abs()) / scale
        worst = max(worst, float(over.max()))
        del exact, scale, over
    if worst > 2 ** -11:
        fail(f"phase 32: {label} off the exact product by {worst:.3g} of the terms' "
             f"magnitudes past half a bf16 unit (at most 2^-11)")
    return worst


def ptxas_resources(build_log, name):
    """``-Xptxas -v``'s lines (registers, shared memory, spills) for each
    kernel whose mangled name holds ``name``: [(entry, [lines])]."""
    found, lines = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            lines = [] if name in line else None
            if lines is not None:
                found.append((line.split("'")[1], lines))
        elif lines is not None and ("registers" in line or "spill" in line
                                    or "smem" in line):
            lines.append(line.replace("ptxas info    :", "").strip())
    return found


def phase32_grouped_gemm(dev, tok, pairs, results):
    """#9, the grouped bf16 expert GEMM (``csrc/moe_grouped_gemm.cu``), at
    the Moonlight cell's widths: ptxas's resource lines for its kernels,
    then (a) gate+up with its SwiGLU epilogue and down over ``GROUPED_ROWS``
    rows, ``GROUPED_ROUTED`` of them routed unevenly over the 64 experts
    (three empty, one shorter than a tile),
    each held to the exact product and to its plain version, timed against
    the plain version and ``torch._grouped_mm`` where the card's PyTorch
    has it; (b) a 3-layer body at the published widths (one dense, two MoE
    layers) through ``VerdictClassifier.classify`` on 64 pairs: two
    launches a MoE layer and batch, routed rows 6 x the real tokens. Its
    launch count is zeroed before (b); (a)'s comparisons are not counted."""
    import torch

    from ircl_tpu_torch.models.mla_moe import ExpertCounters, MLAMoEConfig, init_mla_moe_params
    from ircl_tpu_torch.ops.moe_grouped_gemm_cuda import (
        grouped_gemm, grouped_gemm_ref, interleave_gate_up, swiglu_interleaved,
    )
    from ircl_tpu_torch.utils.kernel_build import load_kernels
    from ircl_tpu_torch.utils.precision import float32_precision
    from ircl_tpu_torch.verdict.infer import VerdictClassifier
    from ircl_tpu_torch.verdict.model import VerdictConfig

    t0 = time.perf_counter()
    resources = ptxas_resources(load_kernels().build_log, "moe_grouped_gemm_kernel")
    for entry, lines in resources:
        log(f"phase 32: {entry}: {'; '.join(lines)}")
    if not resources:
        log("phase 32: no ptxas lines (the kernels were built by an earlier process)")
    if any("0 bytes spill stores" not in " ".join(lines) for _, lines in resources):
        fail("phase 32: the grouped kernel spills registers")
    cfg = MLAMoEConfig()
    E, H, I = cfg.experts, cfg.hidden, cfg.expert_width
    offsets = grouped_offsets(E, GROUPED_ROUTED, torch.Generator().manual_seed(32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(32)
    x = torch.randn(GROUPED_ROWS, H, generator=g, device=dev).to(torch.bfloat16)
    gate = (0.02 * torch.randn(E, I, H, generator=g, device=dev)).to(torch.bfloat16)
    up = (0.02 * torch.randn(E, I, H, generator=g, device=dev)).to(torch.bfloat16)
    down = (0.02 * torch.randn(E, H, I, generator=g, device=dev)).to(torch.bfloat16)
    w13 = interleave_gate_up(gate, up).contiguous()
    del gate, up
    end = GROUPED_ROUTED
    raw = grouped_gemm(x, w13, offsets)
    h = grouped_gemm(x, w13, offsets, swiglu=True)
    y = grouped_gemm(h, down, offsets)
    torch.cuda.synchronize()
    err_up = grouped_within_rounding("gate+up", raw, x, w13, offsets)
    err_down = grouped_within_rounding("down", y, h, down, offsets)
    want = swiglu_interleaved(raw[:end]).float()
    if not bool(((h[:end].float() - want).abs() <= 2 ** -7 * want.abs()).all()):
        fail("phase 32: the SwiGLU epilogue is not silu(gate) * up of the kernel's products")
    del want
    with float32_precision():
        plain_h = grouped_gemm_ref(x, w13, offsets, swiglu=True)
        plain_y = grouped_gemm_ref(h, down, offsets)
    moved = {name: float((a[:end] != b[:end]).float().mean())
             for name, a, b in (("gate+up", h, plain_h), ("down", y, plain_y))}
    if max(moved.values()) > 0.01:
        fail(f"phase 32: the kernel and its plain version differ on {moved} of the entries "
             f"(rounding ties allow under 1%)")
    if not torch.equal(grouped_gemm(h, down, offsets)[:end], y[:end]):
        fail("phase 32: two launches of the down product gave different bits")
    t_up = cuda_ms(lambda: grouped_gemm(x, w13, offsets, swiglu=True), reps=10)
    t_down = cuda_ms(lambda: grouped_gemm(h, down, offsets), reps=10)
    with float32_precision():
        t_plain = (cuda_ms(lambda: grouped_gemm_ref(x, w13, offsets, swiglu=True), reps=2)
                   + cuda_ms(lambda: grouped_gemm_ref(h, down, offsets), reps=2))
    # torch._grouped_mm (bf16, sm90): the raw gate+up product and down, a
    # yardstick of the same products (the epilogue's silu * u not included)
    t_lib, lib_note = None, "torch._grouped_mm absent"
    mm = getattr(torch, "_grouped_mm", None)
    if mm is not None:
        ends = offsets[1:].contiguous()
        try:
            lib_up = mm(x[:end], w13.transpose(-2, -1), offs=ends, out_dtype=torch.bfloat16)
            lib_down = mm(h[:end], down.transpose(-2, -1), offs=ends, out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            grouped_within_rounding("torch._grouped_mm gate+up", lib_up, x, w13, offsets)
            grouped_within_rounding("torch._grouped_mm down", lib_down, h, down, offsets)
            t_lib = (cuda_ms(lambda: mm(x[:end], w13.transpose(-2, -1), offs=ends,
                                        out_dtype=torch.bfloat16), reps=10)
                     + cuda_ms(lambda: mm(h[:end], down.transpose(-2, -1), offs=ends,
                                          out_dtype=torch.bfloat16), reps=10))
            lib_note = "torch._grouped_mm, the two products without the epilogue"
            del lib_up, lib_down
        except (RuntimeError, TypeError) as e:
            lib_note = f"torch._grouped_mm refused the shapes: {str(e).splitlines()[0][:160]}"
    ops = 2 * end * H * (2 * I) + 2 * end * I * H
    bound = least_time((x[:end], w13, h[:end], h[:end], down, y[:end]), ops, BF16_FLOPS)
    results["moe_grouped_gemm"] = dict(
        max_rounding_over=max(err_up, err_down), ms=t_up + t_down, gate_up_ms=t_up,
        down_ms=t_down, plain_ms=t_plain, library_ms=t_lib, library=lib_note,
        ptxas={entry: lines for entry, lines in resources}, **bound)
    log(f"phase 32 (a): {end} routed rows of {GROUPED_ROWS} over {E} experts (3 empty, one "
        f"of 37 rows): gate+up with SwiGLU {t_up:.3f} ms, down {t_down:.3f} ms, "
        f"{ops / (t_up + t_down) / 1e9:.1f} TFLOP/s (bound {bound['bound_ms']:.3f} ms by "
        f"{bound['bound_by']}, {100 * bound['bound_ms'] / (t_up + t_down):.1f}% of it); "
        f"plain {t_plain:.3f} ms; library "
        f"{'not measured' if t_lib is None else f'{t_lib:.3f} ms'} ({lib_note}); within "
        f"the exact product's bound (worst {max(err_up, err_down):.3g} of 2^-11), "
        f"entries off the plain version {moved}")
    del x, w13, h, y, raw, plain_h, plain_y, down
    torch.cuda.empty_cache()

    body = MLAMoEConfig(layers=3)
    params = init_mla_moe_params(body, 32, dev)
    clf = VerdictClassifier(VerdictConfig(encoder=body, max_length=VERDICT_L), params, tok,
                            batch_size=VERDICT_BATCH)
    del params
    batch = pairs[: 2 * VERDICT_BATCH]
    clf.classify([c for c, _ in batch[:VERDICT_BATCH]], [e for _, e in batch[:VERDICT_BATCH]])
    grouped_gemm.launches = 0
    clf.expert_counters = ExpertCounters()
    out = clf.classify([c for c, _ in batch], [e for _, e in batch])
    counters = clf.expert_counters
    want_launches = 2 * (body.layers - body.first_dense) * 2
    _, mask, _ = tok.encode_batch(batch, VERDICT_L)
    real = int(np.asarray(mask).sum())
    if len(out) != len(batch) or grouped_gemm.launches != want_launches:
        fail(f"phase 32 (b): {len(out)} answers, {grouped_gemm.launches} grouped launches "
             f"(want {len(batch)}, {want_launches})")
    if counters.routed_rows != body.experts_per_token * real:
        fail(f"phase 32 (b): {counters.routed_rows} routed rows, not "
             f"{body.experts_per_token} x {real} real tokens")
    results["moe_grouped_gemm"]["launches_path"] = grouped_gemm.launches
    log(f"phase 32 (b): a {body.layers}-layer body at the published widths through classify: "
        f"{len(out)} answers, {grouped_gemm.launches} grouped launches, "
        f"{counters.routed_rows} routed rows (6 x {real} real tokens); "
        f"{time.perf_counter() - t0:.1f} s")
    del clf
    torch.cuda.empty_cache()


def serve_lines(service, lines):
    from ircl_tpu_torch.serve import serve_stdin

    out = io.StringIO()
    served = serve_stdin(service, io.StringIO("\n".join(lines) + "\n"), out)
    replies = [json.loads(x) for x in out.getvalue().splitlines()]
    if len(replies) != len(lines):
        fail(f"{len(replies)} replies for {len(lines)} lines")
    return served, replies


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs only on a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import ircl_tpu_torch
    except ImportError as e:
        fail(f"ircl_tpu_torch is not importable next to {__file__}: {e}")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ircl_tpu_torch.__file__)))
    if pkg_root != root:  # the kernels must build from this checkout's sources
        fail(f"ircl_tpu_torch was imported from {pkg_root}, not from {root}")

    from ircl_tpu_torch.corpus.hashing import native_available
    from ircl_tpu_torch.corpus.store import MemoryDocStore
    from ircl_tpu_torch.corpus.synthetic import generate
    from ircl_tpu_torch.index.build import CountIndex, build_count_index
    from ircl_tpu_torch.index.ranker import TfidfRanker
    from ircl_tpu_torch.index.tfidf import tfidf_transform
    from ircl_tpu_torch.ops import hybrid as hy
    from ircl_tpu_torch.ops.light_add_cuda import (
        light_add_topk_t,
        light_add_topk_t_ref,
    )
    from ircl_tpu_torch.ops.membership_cuda import (
        membership_slab,
        membership_slab_ref,
        membership_slab_windowed,
        pad_for_slab,
        scores_matmul,
    )
    from ircl_tpu_torch.serve import make_service
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    dev = torch.device(DEVICE)
    put = lambda x: torch.tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731

    # ---- phase 0: device -------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 0: device {kind}, {torch.cuda.device_count()} visible; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"phase 0: nvidia-smi: {smi}")
    kern = load_kernels()
    log(f"phase 0: kernels built in {kern.build_seconds:.2f} s -> {kern.path}")
    for line in kern.build_log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log(f"  {line.strip()}")
    log(f"phase 0: native host library loaded: {native_available()}")

    # ---- phase 1: corpus and index ----------------------------------------
    t_sparse = time.perf_counter()
    t0 = time.perf_counter()
    wiki = generate(num_docs=NUM_DOCS, num_claims=NUM_CLAIMS, seed=11)
    claims = [c.claim for c in wiki.claims]
    store = MemoryDocStore({d: rec["text"] for d, rec in wiki.docs.items()})
    log(f"phase 1: corpus generated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    index = tfidf_transform(build_count_index(store, ngram=2, hash_size=HASH_SIZE))
    index_ell = tfidf_transform(build_count_index(
        store, ngram=2, hash_size=HASH_SIZE,
        doc_ids=store.get_doc_ids()[:ELL_DOCS],
    ))
    log(f"phase 1: indexes built in {time.perf_counter() - t0:.1f} s: "
        f"{index.num_docs} docs / {index.nnz} postings; "
        f"{index_ell.num_docs} docs / {index_ell.nnz} postings")
    tmp = tempfile.TemporaryDirectory(prefix="ircl_smoke_")
    path = os.path.join(tmp.name, "index.npz")
    path_ell = os.path.join(tmp.name, "index_ell.npz")
    index.save(path)
    index_ell.save(path_ell)
    if CountIndex.load(path).nnz != index.nnz:
        fail("saved index does not load back")

    # ---- phase 2: kernels vs plain versions --------------------------------
    t0 = time.perf_counter()
    ranker = TfidfRanker(
        index, dev, mode="hybrid", df_threshold=24, width_buckets=2,
        fixed_union_cap=4096, fixed_max_terms=64, precision="high",
        union_round=512,
    )
    log(f"phase 2: judged ranker built in {time.perf_counter() - t0:.1f} s "
        f"(d_tile {ranker.d_tile})")
    buckets, weights = ranker._vectorize(claims)
    u_pad, qb_t, qw_t, ld, lc = (
        put(x) for x in ranker.hybrid_host_inputs(buckets, weights)
    )
    slab_cases = {
        "bucket a": (u_pad, *ranker._heavy_a),
        "bucket b": (u_pad, *ranker._heavy_b),
        "query": (u_pad, qb_t, qw_t),
    }
    results = {}

    results["membership_slab_windowed"] = compare_slabs(
        "phase 2", "membership_slab_windowed", membership_slab_windowed, slab_cases)
    shared_buffer_check("phase 2", u_pad, ranker)
    slab_edge_cases(dev)

    m, _ = hy._bucketed_membership(u_pad, *ranker._heavy_a, *ranker._heavy_b, 1024)
    wt = hy._query_slab(u_pad, qb_t, qw_t, 256, True)
    gemm_ms = cuda_ms(lambda: scores_matmul(m.T, wt), reps=3)
    h_t = scores_matmul(m.T, wt)[:, : ld.shape[0]].contiguous()  # [N_pad, B]
    del m, wt
    d_lt = next(t for t in (1024, 512, 256) if h_t.shape[0] % t == 0)
    sd, sv = ld.T.contiguous(), lc.T.contiguous()
    s1, i1 = light_add_topk_t(h_t, sd, sv, k=K, d_tile=d_lt)
    s2, i2 = light_add_topk_t_ref(h_t, sd, sv, k=K, d_tile=d_lt)
    torch.cuda.synchronize()
    if not torch.allclose(s1, s2, rtol=1e-6, atol=0.0):
        fail("light_add_topk_t scores differ from its plain version")
    tie_ok = (i1 == i2) | (s1 == s2)
    if not bool(tie_ok.all()):
        fail("light_add_topk_t ids differ from its plain version off a tie")
    results["light_add_topk_t"] = dict(
        max_abs_err=float((s1 - s2).abs().max()),
        ms=cuda_ms(lambda: light_add_topk_t(h_t, sd, sv, k=K, d_tile=d_lt)),
        plain_ms=cuda_ms(
            lambda: light_add_topk_t_ref(h_t, sd, sv, k=K, d_tile=d_lt), reps=2
        ),
        # one compare a row and column, one add a pool entry, at one a lane
        # and cycle
        **least_time((h_t, sd, sv, s1, i1), h_t.numel() + sd.numel(), F32_FLOPS / 2),
        library_ms=None,
    )
    log(f"phase 2: light_add_topk_t H_T={tuple(h_t.shape)} P={sd.shape[0]} "
        f"d_tile={d_lt}: scores within rtol 1e-6 ({int((i1 != i2).sum())} "
        f"ids differ, all at ties); kernel {results['light_add_topk_t']['ms']:.3f}"
        f" ms, plain {results['light_add_topk_t']['plain_ms']:.3f} ms")
    light_add_edge_cases(dev)
    log(f"phase 2: scoring GEMM [{h_t.shape[0]} x {u_pad.shape[0]}] @ "
        f"[{u_pad.shape[0]} x {h_t.shape[1]}] fp32: {gemm_ms:.3f} ms")
    del h_t, s1, i1, s2, i2

    ell = TfidfRanker(
        index_ell, dev, mode="auto", fixed_max_terms=24,
        fixed_union_cap=4096, union_round=512,
    )
    if ell.mode != "ell":
        fail(f"mode='auto' at {ELL_DOCS} docs resolved to {ell.mode}")
    eb, ew = ell._vectorize(claims[:256])
    eq_t, ew_t = pad_for_slab(
        np.ascontiguousarray(eb.T), np.ascontiguousarray(ew.T), d_tile=128
    )
    eu = put(ell._union_slots(eb, ew, floor=4096))
    results["membership_slab"] = compare_slabs("phase 2", "membership_slab",
                                               membership_slab, {
        "ELL docs": (eu, ell._ell_terms_t, ell._ell_vals_t),
        "ELL query": (eu, put(eq_t), put(ew_t)),
    })
    del ell

    # ---- the main path: phases 3-5, with fresh launch counts ---------------
    kernels = {
        "membership_slab": membership_slab,
        "membership_slab_windowed": membership_slab_windowed,
        "light_add_topk_t": light_add_topk_t,
    }
    for fn in kernels.values():
        fn.launches = 0

    # ---- phase 3: served path, hybrid --------------------------------------
    t0 = time.perf_counter()
    svc = make_service(path, device=dev)
    log(f"phase 3: make_service in {time.perf_counter() - t0:.1f} s: mode "
        f"{svc.ranker.mode}, df_threshold {svc.ranker.df_threshold}, "
        f"width buckets {1 if svc.ranker._bucketed is None else 2}")
    if svc.ranker.mode != "hybrid" or svc.ranker._bucketed is not None:
        fail("the default service at 50K docs is not the one-bucket hybrid")
    before = membership_slab_windowed.launches
    requests = [
        ([claims[0]], 5),
        (claims[1:301], 5),
        (claims[301:311], 3),
        None,
        None,
    ]
    lines = [
        json.dumps({"query": claims[0]}),
        json.dumps({"queries": claims[1:301]}),
        json.dumps({"queries": claims[301:311], "k": 3}),
        json.dumps({"queries": "not a list"}),
        "[1, 2]",
    ]
    t0 = time.perf_counter()
    served, replies = serve_lines(svc, lines)
    log(f"phase 3: served {served} requests in {time.perf_counter() - t0:.2f} s; "
        f"metrics {svc.metrics.snapshot()}")
    n = check_replies(replies, requests, index, "phase 3")
    if membership_slab_windowed.launches == before:
        fail("phase 3 did not launch the slab kernel")
    log(f"phase 3: {n} query results match scipy (rtol 1e-4); 2 malformed "
        f"lines got error replies")
    del svc

    # ---- phase 4: served path, ELL -----------------------------------------
    svc = make_service(path_ell, device=dev)
    if svc.ranker.mode != "ell":
        fail(f"mode='auto' at {ELL_DOCS} docs served {svc.ranker.mode}")
    before = membership_slab.launches
    requests = [([claims[0]], 5), (claims[1:41], 5), (claims[41:49], 2), None]
    lines = [
        json.dumps({"query": claims[0]}),
        json.dumps({"queries": claims[1:41]}),
        json.dumps({"queries": claims[41:49], "k": 2}),
        json.dumps({"queries": [claims[0]], "k": 0}),
    ]
    served, replies = serve_lines(svc, lines)
    n = check_replies(replies, requests, index_ell, "phase 4")
    if membership_slab.launches == before:
        fail("phase 4 did not launch the slab kernel")
    log(f"phase 4: ELL service at {ELL_DOCS} docs: {n} query results match "
        f"scipy (rtol 1e-4); the malformed line got an error reply")
    del svc

    # ---- phase 5: the judged configuration, through tools/bench.py --------
    from ircl_tpu_torch.tools import bench as judged_bench

    t_phase = time.perf_counter()
    del ranker  # phase 2's judged ranker: the bench builds its own
    before = {name: fn.launches for name, fn in kernels.items()}
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            bench_run = judged_bench.run_judged(index, claims, device=dev)
    except judged_bench.BenchFailure as e:
        fail(f"phase 5: {e}")
    line = bench_run.line
    log(f"phase 5: tools/bench.py's judged run: {json.dumps(line)}")
    if printed.getvalue() != json.dumps(line) + "\n":
        fail(f"phase 5: the bench printed {printed.getvalue()!r}, returned {line}")
    if bench_run.failures:
        fail(f"phase 5: the bench failed after its line: {bench_run.failures}")
    if len(bench_run.scipy_top) != NUM_CLAIMS:
        fail(f"phase 5: {len(bench_run.scipy_top)} scipy top-{K} lists")
    if (line["metric"], line["unit"]) != ("sparse_tfidf_retrieval_qps_per_chip",
                                          "queries/s"):
        fail(f"phase 5: the line's metric and unit are {line['metric']}, {line['unit']}")
    if not (6 <= line.get("rounds", 0) <= 16
            and line["value"] >= line["median"] > 0 and line["vs_baseline"] > 1):
        fail(f"phase 5: the line is not a plateaued gated run: {line}")
    if sorted(bench_run.latency) != [128, 512, NUM_CLAIMS]:
        fail(f"phase 5: latency at B={sorted(bench_run.latency)}")
    scipy_top = bench_run.scipy_top  # per claim, scipy's top-K scores (phase 26 too)
    log(f"phase 5: parity {NUM_CLAIMS}/{NUM_CLAIMS} queries match scipy "
        f"(rtol 1e-4); {line['rounds']} rounds "
        f"{', '.join(f'{q:.1f}' for q in bench_run.rounds)} q/s; latency p50/p95 ms "
        + ", ".join(f"B={b}: {p50:.1f}/{p95:.1f}"
                    for b, (p50, p95) in bench_run.latency.items()))
    for name in ("membership_slab_windowed", "light_add_topk_t"):
        if kernels[name].launches == before[name]:
            fail(f"phase 5 did not launch {name}")
    launches = {name: fn.launches for name, fn in kernels.items()}
    for name, count in launches.items():
        if count == 0:
            fail(f"{name} was not launched on the main path")
    in_phase5 = {name: launches[name] - before[name] for name in launches}
    log(f"phases 3-5: kernel launches {launches} (phase 5: {in_phase5})")
    ranker = bench_run.ranker
    del bench_run

    # per-stage split of one batch
    t0 = time.perf_counter()
    buckets, weights = ranker._vectorize(claims)
    host = ranker.hybrid_host_inputs(buckets, weights)
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_pad, qb_t, qw_t, ld, lc = (put(x) for x in host)
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    splits = []
    for _ in range(2):  # the second batch reuses the first one's buffers
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        m, u_tile = hy._bucketed_membership(
            u_pad, *ranker._heavy_a, *ranker._heavy_b, ranker.d_tile
        )
        wt = hy._query_slab(u_pad, qb_t, qw_t, u_tile, True)
        ev[1].record()
        h_t = scores_matmul(m.T, wt)[:, : ld.shape[0]].contiguous()
        ev[2].record()
        ts, ti = light_add_topk_t(
            h_t, ld.T.contiguous(), lc.T.contiguous(), k=K, d_tile=d_lt
        )
        top_s, top_pos = torch.topk(ts.T, K, dim=1)
        ev[3].record()
        torch.cuda.synchronize()
        splits.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
        if len(splits) == 1:
            del m, wt, h_t, ts, ti, top_s, top_pos
    first, ms = splits[0][0], splits[1]
    log(f"phase 5: split of one batch: host vectorize + pool gather "
        f"{host_ms:.2f} ms, upload {upload_ms:.2f} ms, slabs {ms[0]:.3f} ms (the "
        f"first batch, which allocates the buffers: {first:.3f} ms), GEMM "
        f"{ms[1]:.3f} ms, light-add + top-k {ms[2]:.3f} ms")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phase 5: {time.perf_counter() - t_phase:.1f} s")
    log(f"phases 1-5: {time.perf_counter() - t_sparse:.1f} s")
    del ranker, m, wt, h_t, ts, ti, top_s, top_pos, u_pad, qb_t, qw_t, ld, lc
    torch.cuda.empty_cache()

    # ---- phase 6: kernel #4 against its plain version ----------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)  # bench_dense.py's data, in its order
    dense_corpus = unit_rows(rng, DENSE_M, DENSE_D)
    dense_queries = unit_rows(rng, DENSE_B, DENSE_D)
    from ircl_tpu_torch.ops.dense_topk_cuda import chunk_max, pad_corpus_t

    q_d = torch.tensor(dense_queries, device=dev)
    ct_d, m_real = pad_corpus_t(torch.tensor(dense_corpus, device=dev), DENSE_TILE)
    rows_d = ct_d.T.contiguous()  # [M_pad, D] f32 rescore rows
    phase6_dense_kernel(dev, q_d, ct_d, rows_d, m_real, results)
    log(f"phase 6: {time.perf_counter() - t_phase:.1f} s")

    # ---- the dense path: phases 7-9, with fresh launch counts --------------
    kernels["cosine_topk_fused"] = chunk_max  # launches kernel #4
    for fn in kernels.values():
        fn.launches = 0
    chunk_max.launches_by_route = {"mma": 0, "simt": 0}

    # ---- phase 7: bench_dense.py's configuration ---------------------------
    t_phase = time.perf_counter()
    dense_ref = phase7_dense_bench(dev, dense_queries, dense_corpus, q_d, ct_d,
                                   rows_d, m_real)
    del q_d, ct_d, rows_d
    torch.cuda.empty_cache()
    log(f"phase 7: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 8: the encoder at full width --------------------------------
    t_phase = time.perf_counter()
    enc_docs = store.get_doc_ids()[:ENC_DOCS]
    tcfg, feat, enc_state, doc_sentences, table = phase8_encoder(dev, wiki, enc_docs)
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 9: served sentence search -----------------------------------
    t_phase = time.perf_counter()
    index_path, pre, mine = phase9_sentence_search(
        dev, store, wiki, claims, enc_docs, tcfg, feat, enc_state, doc_sentences,
        table, tmp.name)
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    if chunk_max.launches == 0:
        fail("cosine_topk_fused was not launched on the dense path")
    launches["cosine_topk_fused"] = chunk_max.launches
    dense_routes = dict(chunk_max.launches_by_route)
    if dense_routes["mma"] == 0:
        fail("the dense path did not launch the tensor-core chunk-max kernel")
    log(f"phases 7-9: kernel launches {{'cosine_topk_fused': {chunk_max.launches}}}, "
        f"by route {dense_routes}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(phases 7-9)")

    # ---- phase 31: a HuggingFace checkpoint of phase 8's encoder, served ----
    for fn in kernels.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    hf = phase31_hf_checkpoint(dev, wiki, claims, enc_docs, tcfg, feat, enc_state,
                               doc_sentences, index_path, mine, tmp.name)
    hf_launches = {name: kernels[name].launches
                   for name in ("membership_slab", "cosine_topk_fused")}
    if 0 in hf_launches.values():
        fail(f"the HuggingFace checkpoint's path launched {hf_launches}")
    others = {name: fn.launches for name, fn in kernels.items()
              if fn.launches and name not in hf_launches}
    log(f"phase 31: {time.perf_counter() - t_phase:.1f} s; kernel launches {hf_launches}"
        + (f", and {others}" if others else "") + f"; {json.dumps(hf)}")
    del table, enc_state
    torch.cuda.empty_cache()

    # ---- phase 10: kernel #6a against its plain version --------------------
    from ircl_tpu_torch.ops.flash_attention_cuda import flash_attention

    t_phase = time.perf_counter()
    vtok = feat.tokenizer  # the WordPiece vocab trained on phase 8's docs
    pairs = verdict_pairs(wiki, enc_docs, mine, 256)
    phase10_flash_kernel(dev, vtok, pairs, results)
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")

    # ---- the verdict path: phases 11-12, with fresh launch counts ----------
    kernels["flash_attention"] = flash_attention
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 11: the verdict classifier at full width --------------------
    t_phase = time.perf_counter()
    vcfg, vparams = phase11_verdict(dev, vtok, pairs)
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 12: served claim verification -------------------------------
    t_phase = time.perf_counter()
    phase12_verdict_service(dev, vtok, vcfg, vparams, index_path, doc_sentences, pre,
                            mine, tmp.name)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    if flash_attention.launches == 0:
        fail("flash_attention was not launched on the verdict path")
    launches["flash_attention"] = flash_attention.launches
    log(f"phases 11-12: kernel launches {{'flash_attention': "
        f"{flash_attention.launches}}}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(phases 11-12)")
    del vparams
    torch.cuda.empty_cache()

    # ---- phase 13: kernels #6b and #6c against their plain version ---------
    from ircl_tpu_torch.ops.flash_attention_cuda import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    t_phase = time.perf_counter()
    phase13_flash_backward(dev, vtok, pairs, results)
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")

    # ---- the training path: phases 14-15, with fresh launch counts ---------
    kernels["flash_attention_bwd_dkv"] = flash_attention_bwd_dkv
    kernels["flash_attention_bwd_dq"] = flash_attention_bwd_dq
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 14: the train step at full width ----------------------------
    t_phase = time.perf_counter()
    train_cfg = phase14_train_step(dev, vtok, pairs)
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 15: the trainer end to end ----------------------------------
    t_phase = time.perf_counter()
    phase15_trainer(dev, vtok, train_cfg, pairs, tmp.name)
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    train_launches = {
        name: kernels[name].launches
        for name in ("flash_attention", "flash_attention_bwd_dkv",
                     "flash_attention_bwd_dq")
    }
    for name, count in train_launches.items():
        if count == 0:
            fail(f"{name} was not launched on the training path")
    launches["flash_attention_bwd_dkv"] = train_launches["flash_attention_bwd_dkv"]
    launches["flash_attention_bwd_dq"] = train_launches["flash_attention_bwd_dq"]
    log(f"phases 14-15: kernel launches {train_launches}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(phases 14-15)")
    torch.cuda.empty_cache()

    # ---- phase 16: kernels #7 and #8, against plain versions and driven ----
    t_phase = time.perf_counter()
    phase16_probe_kernels(dev, index, claims, dense_queries, dense_corpus, dense_ref,
                          results, launches)
    for name in ("fused_dot_light_topk", "chunk_max_presplit"):
        if launches[name] == 0:
            fail(f"{name} was not launched on its path")
    torch.cuda.empty_cache()
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")

    # ---- the scale path: phases 17-19, with fresh launch counts ------------
    from ircl_tpu_torch.ops.fused_hybrid_cuda import fused_hybrid_tile_topk

    kernels["fused_hybrid_tile_topk"] = fused_hybrid_tile_topk
    for fn in kernels.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    s_index, s_qb, s_qw, cpu_results, s_ranker, s_dev_in, s_staged = phase17_scale(
        dev, results)
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase18_onepass(dev, s_ranker, cpu_results, s_dev_in, s_staged, results)
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    del s_ranker, s_dev_in
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    phase19_chunked(dev, s_index, s_qb, s_qw, s_staged, cpu_results)
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    scale_launches = {
        name: kernels[name].launches
        for name in ("membership_slab_windowed", "fused_hybrid_tile_topk")
    }
    for name, count in scale_launches.items():
        if count == 0:
            fail(f"{name} was not launched on the scale path")
    launches["fused_hybrid_tile_topk"] = scale_launches["fused_hybrid_tile_topk"]
    log(f"phases 17-19: kernel launches {scale_launches}")

    # ---- the contrastive training path: phases 20-21 -------------------------
    # no kernel of the kernels line lies on it: every count must stay at 0
    from ircl_tpu_torch.ops.dense_topk_cuda import chunk_max_presplit
    from ircl_tpu_torch.ops.fused_dot_light_cuda import fused_dot_light_topk

    counted = dict(kernels, fused_dot_light_topk=fused_dot_light_topk,
                   chunk_max_presplit=chunk_max_presplit)
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    ct_feat, ct = phase20_contrastive_step(dev)
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    e2e_sps, staged_sps, refresh_s = phase21_contrastive_trainer(dev, ct_feat, tmp.name)
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    moved = {name: fn.launches for name, fn in counted.items() if fn.launches}
    if moved:
        fail(f"kernels of the kernels line launched on the training path: {moved}")
    launches_txt = "not measured" if ct["launches"] is None else f"{ct['launches']:.0f}"
    log(f"phases 20-21: steps/s {ct['steps_per_s']:.2f} (device {ct['device_ms']:.2f} ms "
        f"a step, {launches_txt} launches a step, peak {ct['peak_gib']:.2f} GiB), e2e "
        f"steps/s {e2e_sps:.2f} (staged {staged_sps:.2f}), refresh_seconds "
        f"{refresh_s:.2f}; no kernel of the "
        f"kernels line launched")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(phases 20-21)")
    del ct_feat

    # ---- the serving path: phase 22, with fresh launch counts --------------
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    judged = TfidfRanker(
        index, dev, mode="hybrid", df_threshold=24, width_buckets=2,
        fixed_union_cap=4096, fixed_max_terms=64, precision="high", union_round=512,
    )
    # This process still holds every earlier phase's Python objects, which a
    # served process would not; a full pass of the cyclic collector over them
    # takes seconds and stalls every front. Frozen, the collector walks only
    # what serving makes (each window reports its collector time).
    gc.collect()
    gc.freeze()
    try:
        lt_served = phase22_serving(dev, path, index, claims, judged, index_path,
                                    doc_sentences, pre, mine, smi)
    finally:
        gc.unfreeze()
    del judged
    serve_launches = {name: fn.launches for name, fn in counted.items()}
    for name in ("membership_slab", "membership_slab_windowed", "light_add_topk_t"):
        if serve_launches[name] == 0:
            fail(f"{name} was not launched on the serving path")
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s; kernel launches "
        f"{ {k: v for k, v in serve_launches.items() if v} }")
    torch.cuda.empty_cache()

    # ---- the CLI chain: phase 23, each command counting its own launches ---
    t_phase = time.perf_counter()
    _, cli_launches = phase23_cli(dev, root, tmp.name, smi)
    cli_total = {name: sum(c.get(name, 0) for c in cli_launches.values())
                 for name in ("membership_slab", "membership_slab_windowed",
                              "light_add_topk_t", "flash_attention")}
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s; kernel launches "
        f"{ {k: v for k, v in cli_total.items() if v} }")

    # ---- the bf16 and MoE verdict paths: phases 24-25, each with fresh counts
    flash_names = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    path_launches = {}
    for label, phase in (("bf16", phase24_bf16_verdict), ("moe", phase25_moe_verdict)):
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_phase = time.perf_counter()
        phase(dev, vtok, pairs)
        path_launches[label] = {name: kernels[name].launches for name in flash_names}
        others = {name: fn.launches for name, fn in counted.items()
                  if fn.launches and name not in flash_names}
        if 0 in path_launches[label].values() or others:
            fail(f"the {label} verdict path launched {path_launches[label]}, and "
                 f"{others} off it")
        log(f"phase {24 if label == 'bf16' else 25}: {time.perf_counter() - t_phase:.1f} s; "
            f"kernel launches {path_launches[label]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()

    # ---- the parallel path: phase 26, with fresh launch counts -------------
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    par_launches, par_rank_launches = phase26_parallel(
        dev, index, index_ell, claims, scipy_top, dense_queries, dense_corpus,
        dense_ref, tmp.name, smi)
    others = {name: fn.launches for name, fn in counted.items()
              if fn.launches and name not in par_launches}
    if 0 in par_launches.values() or others:
        fail(f"the parallel path launched {par_launches}, and {others} off it")
    del dense_corpus, dense_ref

    # ---- tensor and expert parallelism: phase 27, with fresh launch counts ---
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    mp_launches, mp_rank_launches = phase27_model_parallel(dev, vtok, pairs, tmp.name, smi)
    others = {name: fn.launches for name, fn in counted.items()
              if fn.launches and name not in flash_names}
    if others:
        fail(f"phase 27 launched {others}, off the verdict model's kernels")

    # ---- pipeline and context parallelism: phase 28, with fresh launch counts ---
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    pc_rank_launches = phase28_pipeline_context(dev, vtok, pairs, tmp.name, smi)
    launches_28 = {name: fn.launches for name, fn in counted.items()}
    launched = {name: n for name, n in launches_28.items() if n}
    if launched:
        fail(f"phase 28 launched {launched}: its path runs none of the counted kernels")

    # ---- the experiment tools: phase 29, with fresh launch counts -----------
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    tools_launches, reh_launches = phase29_tools(dev, root, tmp.name, smi, counted)
    others = {name: n for name, n in tools_launches.items()
              if n and name != "membership_slab"}
    if not tools_launches["membership_slab"] or others:
        fail(f"phase 29 launched {tools_launches}: its path runs membership_slab and no "
             f"other counted kernel")
    log(f"phase 29: kernel launches in this process "
        f"{ {k: v for k, v in tools_launches.items() if v} }")

    # ---- the graft entry points and the sharded-scale tool: phase 30 --------
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    graft_launches = phase30_graft_entry(dev, root, tmp.name, smi, counted)

    # ---- the Moonlight body's grouped expert GEMM: phase 32 -----------------
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    phase32_grouped_gemm(dev, vtok, pairs, results)
    log(f"phase 32: {time.perf_counter() - t_phase:.1f} s")

    tmp.cleanup()
    loaded = jax_modules()
    if loaded:
        fail(f"JAX or the JAX package was imported: {loaded}")

    sources = {
        "membership_slab": (
            "ircl_tpu_torch/csrc/membership_slab.cu",
            "ircl_tpu/ops/membership_pallas.py:34",
        ),
        "membership_slab_windowed": (
            "ircl_tpu_torch/csrc/membership_slab.cu",
            "ircl_tpu/ops/membership_pallas.py:101",
        ),
        "light_add_topk_t": (
            "ircl_tpu_torch/csrc/light_add_topk.cu",
            "ircl_tpu/ops/light_add_pallas.py:54",
        ),
        "cosine_topk_fused": (
            "ircl_tpu_torch/csrc/dense_cmax.cu",
            "ircl_tpu/ops/dense_topk_pallas.py:59",
        ),
        "flash_attention": (
            "ircl_tpu_torch/csrc/flash_attention.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:331",
        ),
        "flash_attention_bwd_dkv": (
            "ircl_tpu_torch/csrc/flash_attention_bwd.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:796",
        ),
        "flash_attention_bwd_dq": (
            "ircl_tpu_torch/csrc/flash_attention_bwd.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1146",
        ),
        "fused_hybrid_tile_topk": (
            "ircl_tpu_torch/csrc/fused_hybrid.cu",
            "ircl_tpu/ops/fused_hybrid_pallas.py:35",
        ),
        "fused_dot_light_topk": (
            "ircl_tpu_torch/csrc/fused_dot_light.cu",
            "scripts/probe_fused_dot_light.py:135",
        ),
        "chunk_max_presplit": (
            "ircl_tpu_torch/csrc/dense_cmax.cu",
            "scripts/probe_dense_presplit.py:35",
        ),
        "moe_grouped_gemm": (
            "ircl_tpu_torch/csrc/moe_grouped_gemm.cu",
            "none (ircl_tpu/models/moe.py: one-hot einsums)",
        ),
    }
    launches["moe_grouped_gemm"] = results["moe_grouped_gemm"].pop("launches_path")
    report = []
    for name, (src, replaces) in sources.items():
        report.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], **results[name],
        ))
        if name == "cosine_topk_fused":  # the dense path's launches, by kernel
            report[-1]["launches_by_route"] = dense_routes
        if name in hf_launches:  # phase 31, through the loaded checkpoint
            report[-1]["launches_hf_path"] = hf_launches[name]
        if name == "flash_attention":  # it also runs on the training path
            report[-1]["launches_training_path"] = train_launches[name]
        if name in flash_names:  # and on the bf16 and MoE verdict paths
            report[-1]["launches_bf16_path"] = path_launches["bf16"][name]
            report[-1]["launches_moe_path"] = path_launches["moe"][name]
        if name == "membership_slab_windowed":  # and on the scale path
            report[-1]["launches_scale_path"] = scale_launches[name]
        if serve_launches.get(name):  # the serving path (phase 22)
            report[-1]["launches_serving_path"] = serve_launches[name]
        if name == "light_add_topk_t":  # at the judged service's shape and k_max
            report[-1]["serving_case"] = lt_served
        if cli_total.get(name):  # the CLI chain (phase 23)
            report[-1]["launches_cli_path"] = cli_total[name]
        if name in par_launches:  # the parallel path (phase 26): 1 rank, then by rank
            report[-1]["launches_parallel_path"] = par_launches[name]
            report[-1]["launches_parallel_ranks"] = [lc[name] for lc in par_rank_launches]
        if name in flash_names:  # phase 27: (a)'s rank, then by rank, (b)-(c), (d)
            k = flash_names.index(name)
            report[-1]["launches_tp_path"] = [mp_launches[k]] + [
                lc[k] for lc in mp_rank_launches]
            # phase 28: this process, then by rank, (b)-(c), (d): none
            report[-1]["launches_pp_cp_path"] = [launches_28[name]] + [
                lc[k] for lc in pc_rank_launches]
        if name in ("membership_slab", "membership_slab_windowed"):
            # phase 29: (a)-(c) in this process, then (d)'s CLI commands
            report[-1]["launches_tools_path"] = tools_launches[name]
            report[-1]["launches_rehearsal_path"] = {
                command: c.get(name, 0) for command, c in reh_launches.items()}
            # phase 30: by run, each rank's launches
            k = ("membership_slab", "membership_slab_windowed").index(name)
            report[-1]["launches_graft_entry_path"] = {
                run: [rank[k] for rank in ranks] for run, ranks in graft_launches.items()}
    log(smi)
    log(json.dumps({"kernels": report}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
