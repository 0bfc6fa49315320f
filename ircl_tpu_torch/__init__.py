"""ircl_tpu_torch — the PyTorch + CUDA port of ``ircl_tpu``.

The port mirrors ``ircl_tpu``'s layout; each module names its counterpart.
Ported so far: sparse stage-1 retrieval, the dense stage 2 and served claim
verification.

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
- ``verdict``      the claim-verdict classifier's forward, pinned-shape
                   ``VerdictClassifier`` and its checkpoint files.
- ``serve``        ``RetrievalService`` (doc and sentence search, claim
                   verification), ``make_service`` and the JSONL stdin loop.
- ``utils``        the kernel build, full-fp32 matmuls, and the weights
                   carried across from the JAX package.

The package imports torch and never JAX. It shares ``ircl_tpu.corpus`` (the
tokenizer, hashing and doc stores, which are JAX-free) with the reference.
Every ranker, featurizer and service takes an explicit ``device``: CUDA
tensors run the kernels, CPU tensors the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
