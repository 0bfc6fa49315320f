"""ircl_tpu_torch — the PyTorch + CUDA port of ``ircl_tpu``.

The port mirrors ``ircl_tpu``'s layout; each module names its counterpart.
This first slice is sparse stage-1 retrieval, the path ``bench.py``
measures and the search service answers:

- ``index``  host-side index build, tf-idf, df split (numpy, carried over)
             and ``TfidfRanker`` with the ``"ell"`` and ``"hybrid"`` engines.
- ``ops``    the device engines, and the hand-written CUDA kernels that
             replace the TPU's Pallas kernels (sources in ``csrc/``, built by
             ``utils/kernel_build.py`` with nvcc at first use).
- ``serve``  ``RetrievalService``, ``make_service`` and the JSONL stdin loop.

The package imports torch and never JAX. It shares ``ircl_tpu.corpus`` (the
tokenizer, hashing and doc stores, which are JAX-free) with the reference.
Every ranker and service takes an explicit ``device``: CUDA tensors run
the kernels, CPU tensors the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
