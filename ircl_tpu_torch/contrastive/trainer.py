"""Host training loop: sampling, train steps, clustering refresh,
checkpointing, metrics.

Counterpart of ``ircl_tpu/contrastive/trainer.py``: the host orchestration
around ``make_train_step`` that replaces the reference's Python inner loop
(``src/train.py:86-199``): per-step pair sampling, the ProtoNCE/HProtoNCE
cluster refresh schedule (``src/train.py:96-122``: every
``cluster_update_steps`` from ``cluster_start_steps``), negative-prototype
sampling, a checkpoint and metrics every ``log_step``, and resume. Queue
activation needs no host logic: the step computes its flag from
``state.step``.

The step counter lives on the host and the device is read once a
``log_step`` (the mean loss and the last gradient norm), so sampling and
tokenizing the next batch overlap the device's work on the last one.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ircl_tpu_torch.contrastive.cluster import ClusterResult, run_hierarchical, run_kmeans
from ircl_tpu_torch.contrastive.losses import sample_negative_prototypes
from ircl_tpu_torch.contrastive.state import TrainConfig, init_train_state
from ircl_tpu_torch.contrastive.train import make_embed_fn, make_train_step
from ircl_tpu_torch.data.pairs import DocPairSampler
from ircl_tpu_torch.dense.embed import embed_corpus
from ircl_tpu_torch.parallel.common import replicate
from ircl_tpu_torch.parallel.dp import make_dp_train_step
from ircl_tpu_torch.parallel.mesh import check_mesh
from ircl_tpu_torch.utils.checkpoint import latest_checkpoint, restore_state, save_state
from ircl_tpu_torch.utils.device import resolve_device
from ircl_tpu_torch.utils.metrics import MetricsLogger


class ContrastiveTrainer:
    """Trains on ``device`` (by default the card), where the featurizer must
    lie. ``seed`` draws the initial state; ``seed + 1`` seeds the generator
    of negative prototypes.

    ``mesh`` (a ``DeviceMesh`` with a ``data`` axis, ``parallel/mesh.py``):
    every rank runs this loop through the data-parallel step
    (``parallel/dp.py``). Each rank draws the same global batch from a
    sampler of the same seed and keeps its rows; the draws of the initial
    state and of the negative prototypes are seeded per trainer, never per
    rank; a cluster refresh runs on every rank, and every rank keeps rank
    0's result. Only rank 0 writes checkpoints and metrics; every rank resumes."""

    def __init__(
        self,
        config: TrainConfig,
        featurizer,
        sampler: DocPairSampler,
        ckptdir: str = "ckpt",
        logdir: str = "log",
        tag: Optional[str] = None,
        seed: int = 1337,
        mesh=None,
        device=None,
    ):
        self.device = resolve_device(device)
        if featurizer.device.type != self.device.type:
            raise ValueError(f"the featurizer lies on {featurizer.device}, the "
                             f"trainer runs on {self.device}")
        self.config = config
        self.featurizer = featurizer
        self.sampler = sampler
        self.ckptdir = ckptdir
        self.tag = tag or f"{sampler.sample}_{config.loss}_LSTM"
        self.mesh = mesh
        self._place_state = lambda s: s
        if mesh is not None:
            check_mesh(mesh, "data")
            dp_step, self._place_state, place_batch, place_proto = (
                make_dp_train_step(config, featurizer, mesh)
            )

            def step_fn(state, ids_a, mask_a, ids_k, mask_k, proto=None):
                return dp_step(state, *place_batch(ids_a, mask_a, ids_k, mask_k),
                               place_proto(proto))

            self.step_fn = step_fn
        else:
            self.step_fn = make_train_step(config, featurizer)
        self.writer = mesh is None or mesh.get_rank() == 0
        self.metrics = MetricsLogger(logdir, self.tag) if self.writer else None
        self.embed_fn = make_embed_fn(config, featurizer)
        self.state = self._place_state(init_train_state(seed, config, device=self.device))
        self._proto_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.cluster_result: Optional[ClusterResult] = None
        # cumulative cluster-refresh cost (full-corpus embed + clustering,
        # the device's work included); the reference never measures this
        # (src/train.py:96-122)
        self.refresh_seconds = 0.0
        self.refresh_count = 0

    # -- resume -------------------------------------------------------------

    def maybe_resume(self) -> int:
        path = latest_checkpoint(self.ckptdir, self.tag)
        if path:
            self.state = self._place_state(restore_state(path, self.state))
        return self.state.step

    # -- clustering ---------------------------------------------------------

    def _refresh_clusters(self) -> None:
        t0 = time.time()
        cfg = self.config
        # Embed one anchor sentence per document, in document order, so
        # emb2cluster[doc_idx] is well-defined. (The reference embeds both
        # random views of every item and indexes the stacked list by dataset
        # idx — an index/embedding mismatch we do not reproduce.) Docs with
        # no sentences (kept in sampler.docs for index stability; never
        # sampled) embed the empty string rather than crashing.
        texts = [doc[0] if doc else "" for doc in self.sampler.docs]
        emb = embed_corpus(
            self.embed_fn, self.state.params_q, self.featurizer, texts
        )
        if cfg.loss == "HProtoNCE":
            self.cluster_result = run_hierarchical(
                emb, cfg.num_clusters, cfg.temperature, device=self.device
            )
        else:
            self.cluster_result = run_kmeans(
                emb, cfg.num_clusters, cfg.temperature, device=self.device
            )
        if self.mesh is not None:
            # On the card the k-means sums with float atomics (index_add_),
            # so the ranks' refreshes may differ in their last bits: every
            # rank takes rank 0's.
            cr = self.cluster_result
            self.cluster_result = ClusterResult(*(
                [replicate(t, self.mesh, "data") for t in ts]
                for ts in (cr.emb2cluster, cr.centroids, cr.density)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the clustering's device time counts
        self.refresh_seconds += time.time() - t0
        self.refresh_count += 1

    def _proto_inputs(self, doc_idx: np.ndarray):
        """Per-granularity batch cluster ids + sampled negative prototypes."""
        if self.cluster_result is None:
            return None
        cr = self.cluster_result
        doc_idx = torch.as_tensor(doc_idx, device=self.device)
        ids, negs = [], []
        for g in range(cr.num_granularities):
            batch_ids = cr.emb2cluster[g][doc_idx]
            ids.append(batch_ids)
            num_neg = min(
                self.config.num_neg_proto, cr.centroids[g].shape[0] - 1
            )
            negs.append(
                sample_negative_prototypes(
                    self._proto_gen,
                    cr.centroids[g].shape[0],
                    batch_ids.reshape(-1),
                    num_neg,
                )
            )
        return (ids, cr.centroids, cr.density, negs)

    # -- main loop ----------------------------------------------------------

    def train(self, total_steps: Optional[int] = None, log_step: int = 100):
        cfg = self.config
        total = total_steps or cfg.total_steps
        start = self.state.step
        uses_proto = cfg.loss in ("ProtoNCE", "HProtoNCE")

        # Resume: an uninterrupted Proto run past cluster_start_steps always
        # has live prototypes, but a restart leaves cluster_result None until
        # the next update boundary — up to cluster_update_steps-1 steps of
        # silently proto-free training. Refresh immediately instead.
        if (
            uses_proto
            and self.cluster_result is None
            and start >= cfg.cluster_start_steps
            and start % cfg.cluster_update_steps != 0  # loop refreshes then
        ):
            self._refresh_clusters()

        losses = []
        t0 = time.time()
        batch_iter = self.sampler.batches(
            self.featurizer, cfg.accum_steps, cfg.micro_batch, total - start
        )
        for i, (doc_idx, ids_a, mask_a, ids_k, mask_k) in enumerate(
            batch_iter
        ):
            step = start + i
            # Reference schedule (src/train.py:96-122): refresh when
            # step >= cluster_start_steps and step % update_steps == 0.
            if (
                uses_proto
                and step >= cfg.cluster_start_steps
                and step % cfg.cluster_update_steps == 0
            ):
                self._refresh_clusters()

            proto = self._proto_inputs(doc_idx) if uses_proto else None
            self.state, loss, grad_norm = self.step_fn(
                self.state, ids_a, mask_a, ids_k, mask_k, proto
            )
            # the loss stays on the device: reading it here would wait for
            # every step, serializing batch assembly behind the device
            losses.append(loss)

            new_step = step + 1
            if new_step % log_step == 0:
                avg = float(torch.stack(losses).mean())  # one read an interval
                losses = []
                sps = log_step / max(time.time() - t0, 1e-9)
                t0 = time.time()
                if self.writer:
                    self.metrics.scalar("train_loss", avg, new_step)
                    self.metrics.scalar("grad_norm", float(grad_norm), new_step)
                    self.metrics.scalar("steps_per_sec", sps, new_step)
                    save_state(self.ckptdir, self.tag, self.state)
                if self.mesh is not None:  # no rank resumes from a half-written step
                    dist.barrier(group=self.mesh.get_group("data"))
        return self.state

