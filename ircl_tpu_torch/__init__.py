"""ircl_tpu_torch — the PyTorch + CUDA port of ``ircl_tpu``.

The port mirrors ``ircl_tpu``'s layout; each module names its counterpart.
Ported so far: sparse stage-1 retrieval, the dense stage 2, served claim
verification and verdict training.

- ``corpus``       the host-side text layer (tokenizer, hashing, filters, doc
                   stores, the synthetic corpus, FEVER parsing), carried over.
- ``index``        host-side index build, tf-idf, df split (numpy, carried
                   over) and ``TfidfRanker`` with the ``"ell"`` and
                   ``"hybrid"`` engines.
- ``ops``          the device engines, the BiLSTM, and the hand-written CUDA
                   kernels that replace the TPU's Pallas kernels (sources in
                   ``csrc/``, built by ``utils/kernel_build.py`` with nvcc at
                   first use).
- ``dense``        exact cosine top-k and the corpus embedding sweep.
- ``models``       the featurizers (hashed tokens, or a transformer over a
                   WordPiece vocab) and the contrastive encoder head.
- ``contrastive``  ``TrainConfig`` and the embed function.
- ``pipeline``     two-stage retrieval and the dense sentence scorers.
- ``verdict``      the claim-verdict classifier, its AdamW train step and
                   ``train_verdict``, dataset prep and the classification
                   report, pinned-shape ``VerdictClassifier`` and its
                   checkpoint files.
- ``serve``        ``RetrievalService`` (doc and sentence search, claim
                   verification), ``make_service`` and the JSONL stdin loop.
- ``utils``        the kernel build, the host library's build, the default
                   device, full-fp32 matmuls, parameter trees, the metrics
                   log, and the weights and optimizer state carried across
                   from the JAX package.
- ``tools``        one-off measurement scripts for the card.

The package imports torch, never JAX, and nothing of ``ircl_tpu``: what it
needs of a JAX-free module there it keeps as a copy of its own. Only the
C++ host library ``native/libircl_native.so`` is shared with the reference.
Every entry point that takes a ``device`` runs on the card by default
(``utils/device.py``) and raises where there is none; CUDA tensors run the
kernels, CPU tensors the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
