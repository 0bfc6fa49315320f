"""Dense top-k with a fused chunk-max phase 1: a CUDA kernel and its plain version.

Counterpart of ``ircl_tpu/ops/dense_topk_pallas.py``. Phase 1 scores the
queries against the transposed corpus ``corpus_t [D, M_pad]`` and keeps
only each chunk's maximum, so the ``[B, M]`` score matrix never reaches
device memory; phase 2 takes the top-(k + extra) chunks, gathers their
corpus rows, rescores them in fp32 and takes the top-k.

Exactness is the reference's argument: the true top-k lie in at most k
distinct chunks, each with a maximum at least the k-th score, so the top-k
chunks by maximum hold the answer. It holds for any fixed partition of the
columns into chunks: "loop" takes contiguous chunks, "fold" takes chunk j
of a corpus tile as the columns congruent to j modulo ``m_tile / chunk``.
Selection is as good as phase 1's dot; the returned scores are phase 2's
fp32 rescore.

``chunk_max`` is phase 1 and ``select_rescore`` phase 2. On CUDA tensors
``chunk_max`` launches ``csrc/dense_cmax.cu`` (see the note there); on CPU
tensors it runs ``chunk_max_ref``, the same products as PyTorch matrix
products with TF32 off, in corpus blocks. Precisions, as on the TPU:

- ``"highest"``: fp32.
- ``"high3"`` (the default): bf16_3x by hand, ``hi.hi + (lo.hi + hi.lo)``
  over hi = bf16(x), lo = bf16(x - hi); about 1e-6 on unit cosines.
- ``None`` / ``"default"``: the bf16 1-pass dot, both sides rounded to
  bf16; measurably inexact selection, opt-in only.
- a bf16 ``corpus_t``: the bf16 1-pass dot whatever ``precision`` says, so
  ``"high3"``/``"highest"`` then need ``extra_chunks`` slack.

A bf16 product is exact in fp32, so kernel and plain version agree up to
the fp32 summation order. Phase 2 is plain PyTorch (XLA in the reference),
its rescore in full fp32.

``chunk_max_presplit`` and ``cosine_topk_fused_presplit`` are the
counterpart of ``scripts/probe_dense_presplit.py`` (``make_presplit_topk``):
the corpus is split once, when it is built, into two bf16 arrays
(``split_hi_lo``), so a call reads the same bytes and splits only the
queries. The dots and their grouping are "high3"'s; on the halves of an f32
corpus the chunk maxima equal ``chunk_max(precision="high3")``'s bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ircl_tpu_torch.utils.precision import float32_precision

_PRECISIONS = (None, "default", "high", "highest", "high3")
_KERNEL_CHUNKS_PER_BLOCK = 128  # threads per block in dense_cmax.cu
_REF_BLOCK_COLS = 1 << 16  # corpus columns per plain-version step


def _mode(precision, corpus_dtype) -> int:
    """The kernel's dot: 0 fp32, 1 bf16_3x, 2 bf16 1-pass, 3 bf16 corpus."""
    if corpus_dtype == torch.bfloat16:
        return 3
    if precision == "highest":
        return 0
    if precision == "high3":
        return 1
    return 2


def _check_chunk_args(queries, corpus_t, chunk, m_tile, m_real, precision,
                      epilogue) -> int:
    """Validate phase 1's arguments; returns m_real."""
    if queries.dim() != 2 or corpus_t.dim() != 2:
        raise ValueError(
            f"queries must be [B, D] and corpus_t [D, M_pad]; got "
            f"{tuple(queries.shape)} and {tuple(corpus_t.shape)}"
        )
    if queries.shape[1] != corpus_t.shape[0]:
        raise ValueError(
            f"queries have D={queries.shape[1]}, corpus_t has D={corpus_t.shape[0]}"
        )
    if queries.dtype != torch.float32 or corpus_t.dtype not in (
        torch.float32, torch.bfloat16
    ):
        raise TypeError(
            f"expected float32 queries and a float32 or bfloat16 corpus_t, "
            f"got {queries.dtype} and {corpus_t.dtype}"
        )
    if queries.device != corpus_t.device:
        raise ValueError("queries and corpus_t lie on different devices")
    m = corpus_t.shape[1]
    if chunk <= 0 or m_tile <= 0 or m % m_tile or m_tile % chunk:
        raise ValueError(
            f"M_pad={m} must be a multiple of m_tile={m_tile}, and m_tile a "
            f"multiple of chunk={chunk}"
        )
    if precision not in _PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; use None/'default' (bf16 "
            "1-pass fast mode), 'high3' (bf16_3x by hand), or 'highest' "
            "(fp32)"
        )
    if precision == "high":
        raise ValueError(
            "precision='high' is refused, as in the reference: use 'high3' "
            "(bf16_3x by hand, the same accuracy class)"
        )
    if epilogue not in ("loop", "fold"):
        raise ValueError(f"epilogue must be 'loop' or 'fold', got {epilogue!r}")
    if epilogue == "fold":
        npt = m_tile // chunk
        if chunk & (chunk - 1) or npt & (npt - 1):
            raise ValueError(
                f"fold epilogue needs power-of-two chunk and m_tile//chunk, "
                f"got chunk={chunk}, m_tile//chunk={npt}"
            )
    return m if m_real is None else m_real


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), held in fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def chunk_max_ref(
    queries: torch.Tensor,  # [B, D] f32
    corpus_t: torch.Tensor,  # [D, M_pad] f32 or bf16
    chunk: int,
    m_tile: int,
    m_real: int = None,
    precision: str = "high3",
    epilogue: str = "loop",
) -> torch.Tensor:
    """Plain version of phase 1: ``[B, M_pad / chunk]`` chunk maxima, pad
    columns (>= ``m_real``) at -inf. Scores a block of whole corpus tiles at
    a time (``[B, 65536]`` per product at most), so the bench's
    ``[1024, 1,007,616]`` score matrix (4.1 GB per product) never exists."""
    m_real = _check_chunk_args(
        queries, corpus_t, chunk, m_tile, m_real, precision, epilogue
    )
    mode = _mode(precision, corpus_t.dtype)
    q = queries if mode in (0, 1) else _bf16(queries)
    if mode == 1:
        q_hi = _bf16(q)
        q_lo = _bf16(q - q_hi)

    def block_scores(lo, hi):
        c = corpus_t[:, lo:hi].to(torch.float32)
        if mode == 1:
            c_hi = _bf16(c)
            c_lo = _bf16(c - c_hi)
            return q_hi @ c_hi + (q_lo @ c_hi + q_hi @ c_lo)
        return q @ (_bf16(c) if mode == 2 else c)

    return _chunk_max_blocks(
        block_scores, queries, corpus_t.shape[1], chunk, m_tile, m_real, epilogue
    )


def _chunk_max_blocks(block_scores, queries, m, chunk, m_tile, m_real, epilogue):
    """The plain versions' shared sweep: ``block_scores(lo, hi)`` gives the
    ``[B, hi - lo]`` scores of a block of whole corpus tiles; pad columns go
    to -inf and each chunk keeps its maximum."""
    B = queries.shape[0]
    npt = m_tile // chunk
    out = torch.empty((B, m // chunk), dtype=torch.float32, device=queries.device)
    span = max(1, _REF_BLOCK_COLS // m_tile) * m_tile
    with float32_precision():
        for lo in range(0, m, span):
            hi = min(m, lo + span)
            s = block_scores(lo, hi)
            cols = torch.arange(lo, hi, device=s.device)
            s = s.masked_fill(cols[None, :] >= m_real, float("-inf"))
            if epilogue == "fold":
                nt = (hi - lo) // m_tile
                cm = s.view(B, nt, chunk, npt).amax(dim=2).reshape(B, nt * npt)
            else:
                cm = s.view(B, (hi - lo) // chunk, chunk).amax(dim=2)
            out[:, lo // chunk : hi // chunk] = cm
    return out


def chunk_max(
    queries: torch.Tensor,  # [B, D] f32
    corpus_t: torch.Tensor,  # [D, M_pad] f32 or bf16
    chunk: int,
    m_tile: int,
    m_real: int = None,
    precision: str = "high3",
    epilogue: str = "loop",
) -> torch.Tensor:
    """Phase 1 of ``cosine_topk_fused``: chunk maxima ``[B, M_pad / chunk]``
    f32, pad columns at -inf. CUDA tensors launch ``csrc/dense_cmax.cu``;
    CPU tensors run ``chunk_max_ref``."""
    m_real = _check_chunk_args(
        queries, corpus_t, chunk, m_tile, m_real, precision, epilogue
    )
    if queries.device.type == "cpu":
        return chunk_max_ref(
            queries, corpus_t, chunk, m_tile, m_real, precision, epilogue
        )
    if queries.device.type != "cuda":
        raise ValueError(f"no chunk-max kernel for device {queries.device}")
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    if not (queries.is_contiguous() and corpus_t.is_contiguous()):
        raise ValueError("queries and corpus_t must be contiguous")
    B, D = queries.shape
    m = corpus_t.shape[1]
    nc = m // chunk
    n_spans = -(-nc // _KERNEL_CHUNKS_PER_BLOCK)
    if n_spans > 65535:
        raise ValueError(f"{nc} chunks exceed the kernel's grid (65535 x 128)")
    kern = load_kernels()
    out = torch.empty((B, nc), dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        rc = kern.lib.ircl_dense_cmax(
            queries.data_ptr(), B, D, corpus_t.data_ptr(), m, chunk, m_tile,
            m_real, _mode(precision, corpus_t.dtype), int(epilogue == "fold"),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    kern.check(rc, "dense chunk-max launch")
    chunk_max.launches += 1
    return out


chunk_max.launches = 0


def _check_presplit_args(queries, ct_hi, ct_lo, chunk, m_tile, m_real, epilogue) -> int:
    if ct_lo.shape != ct_hi.shape or ct_lo.dtype != ct_hi.dtype or (
        ct_lo.device != ct_hi.device
    ):
        raise ValueError(
            f"ct_hi and ct_lo must match: {tuple(ct_hi.shape)} {ct_hi.dtype} "
            f"against {tuple(ct_lo.shape)} {ct_lo.dtype}"
        )
    if ct_hi.dtype != torch.bfloat16:
        raise TypeError(f"expected a bfloat16 pre-split corpus, got {ct_hi.dtype}")
    return _check_chunk_args(queries, ct_hi, chunk, m_tile, m_real, "high3", epilogue)


def chunk_max_presplit_ref(
    queries: torch.Tensor,  # [B, D] f32
    ct_hi: torch.Tensor,  # [D, M_pad] bf16 high halves of the corpus
    ct_lo: torch.Tensor,  # [D, M_pad] bf16 low halves
    chunk: int,
    m_tile: int,
    m_real: int = None,
    epilogue: str = "fold",
) -> torch.Tensor:
    """Plain version of ``chunk_max_presplit``: the queries split here, the
    three fp32 products of bf16 halves grouped ``hi.hi + (lo.hi + hi.lo)``."""
    m_real = _check_presplit_args(queries, ct_hi, ct_lo, chunk, m_tile, m_real, epilogue)
    q_hi = _bf16(queries)
    q_lo = _bf16(queries - q_hi)

    def block_scores(lo, hi):
        c_hi = ct_hi[:, lo:hi].to(torch.float32)
        c_lo = ct_lo[:, lo:hi].to(torch.float32)
        return q_hi @ c_hi + (q_lo @ c_hi + q_hi @ c_lo)

    return _chunk_max_blocks(
        block_scores, queries, ct_hi.shape[1], chunk, m_tile, m_real, epilogue
    )


def chunk_max_presplit(
    queries: torch.Tensor,  # [B, D] f32
    ct_hi: torch.Tensor,  # [D, M_pad] bf16
    ct_lo: torch.Tensor,  # [D, M_pad] bf16
    chunk: int,
    m_tile: int,
    m_real: int = None,
    epilogue: str = "fold",
) -> torch.Tensor:
    """Phase 1 over a pre-split corpus: chunk maxima ``[B, M_pad / chunk]``
    f32, pad columns at -inf. CUDA tensors launch ``csrc/dense_cmax.cu``'s
    pre-split mode; CPU tensors run ``chunk_max_presplit_ref``."""
    m_real = _check_presplit_args(queries, ct_hi, ct_lo, chunk, m_tile, m_real, epilogue)
    if queries.device.type == "cpu":
        return chunk_max_presplit_ref(
            queries, ct_hi, ct_lo, chunk, m_tile, m_real, epilogue
        )
    if queries.device.type != "cuda":
        raise ValueError(f"no chunk-max kernel for device {queries.device}")
    from ircl_tpu_torch.utils.kernel_build import load_kernels

    if not (queries.is_contiguous() and ct_hi.is_contiguous() and ct_lo.is_contiguous()):
        raise ValueError("queries, ct_hi and ct_lo must be contiguous")
    B, D = queries.shape
    m = ct_hi.shape[1]
    nc = m // chunk
    if -(-nc // _KERNEL_CHUNKS_PER_BLOCK) > 65535:
        raise ValueError(f"{nc} chunks exceed the kernel's grid (65535 x 128)")
    kern = load_kernels()
    out = torch.empty((B, nc), dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        rc = kern.lib.ircl_dense_cmax_presplit(
            queries.data_ptr(), B, D, ct_hi.data_ptr(), ct_lo.data_ptr(), m, chunk,
            m_tile, m_real, int(epilogue == "fold"), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kern.check(rc, "pre-split dense chunk-max launch")
    chunk_max_presplit.launches += 1
    return out


chunk_max_presplit.launches = 0


def cosine_topk_fused_presplit(
    queries: torch.Tensor,  # [B, D] f32 L2-normalized
    ct_hi: torch.Tensor,  # [D, M_pad] bf16 (split_hi_lo of pad_corpus_t's)
    ct_lo: torch.Tensor,  # [D, M_pad] bf16
    corpus_rows: torch.Tensor,  # [M_pad, D] f32 rescore rows
    k: int,
    chunk: int = 128,
    m_tile: int = 512,
    m_real: int = None,
    epilogue: str = "fold",
):
    """``cosine_topk_fused(precision="high3")`` over a corpus split into
    bf16 halves when it was built: (scores [B, k] f32, ids [B, k] int32).
    Phase 2 is ``select_rescore`` over the f32 ``corpus_rows``."""
    if m_real is None:
        m_real = ct_hi.shape[1]
    cmax = chunk_max_presplit(queries, ct_hi, ct_lo, chunk, m_tile, m_real, epilogue)
    return select_rescore(queries, ct_hi, cmax, k, chunk, m_tile, m_real, 0,
                          epilogue, corpus_rows)


def cosine_topk_fused(
    queries: torch.Tensor,  # [B, D] f32 L2-normalized
    corpus_t: torch.Tensor,  # [D, M_pad] transposed corpus (padded); f32/bf16
    k: int,
    chunk: int = 128,
    m_tile: int = 512,
    m_real: int = None,  # true (unpadded) corpus size
    precision: str = "high3",  # phase 1's dot, see the module docstring
    extra_chunks: int = 0,  # slack chunks kept past k (for low-precision dots)
    epilogue: str = "loop",  # chunk partition: "loop" | "fold"
    corpus_rows: torch.Tensor = None,  # [M_pad, D] f32 rescore rows
):
    """Dense top-k with the fused chunk-max phase 1: (scores [B, k] f32,
    ids [B, k] int32), best first.

    ``corpus_t`` is the ``[D, M]`` transpose, zero-padded to an ``m_tile``
    multiple (``pad_corpus_t``); ``m_real`` is the true column count. Pad
    columns are -inf in phase 1 and in the rescore, so zero-padded columns
    never outrank real negative cosines. Phase 2 rescores ``corpus_rows``
    (required for a bf16 ``corpus_t``; otherwise ``corpus_t.T``) in full
    fp32. Equal scores may come back in another order than ``lax.top_k``'s
    (lowest index first)."""
    m = corpus_t.shape[1]
    if m_real is None:
        m_real = m
    if corpus_t.dtype == torch.bfloat16:
        if corpus_rows is None:
            raise ValueError("bf16 corpus_t needs f32 corpus_rows")
        if precision in ("high3", "highest") and extra_chunks == 0:
            # the dot on bf16 inputs is the bf16 1-pass dot whatever the
            # precision names: selection is then measurably inexact unless
            # slack chunks absorb the error
            raise ValueError(
                f"precision={precision!r} with a bf16 corpus_t runs the bf16 "
                "1-pass dot (inputs are already bf16); pass extra_chunks>0 "
                "for selection slack or keep the corpus f32"
            )
    cmax = chunk_max(queries, corpus_t, chunk, m_tile, m_real, precision, epilogue)
    return select_rescore(queries, corpus_t, cmax, k, chunk, m_tile, m_real,
                          extra_chunks, epilogue, corpus_rows)


def select_rescore(
    queries: torch.Tensor,  # [B, D] f32
    corpus_t: torch.Tensor,  # [D, M_pad]
    cmax: torch.Tensor,  # [B, M_pad / chunk] phase 1's chunk maxima
    k: int,
    chunk: int,
    m_tile: int,
    m_real: int,
    extra_chunks: int = 0,
    epilogue: str = "loop",
    corpus_rows: torch.Tensor = None,
):
    """Phase 2 of ``cosine_topk_fused`` (plain PyTorch): the top-(k + extra)
    chunks by maximum, their corpus rows gathered and rescored in full
    fp32, the top-k of those. Pad rows (>= ``m_real``) score -inf."""
    B = queries.shape[0]
    m = corpus_t.shape[1]
    kk = min(k, m_real)
    nc = m // chunk
    kc = min(kk + extra_chunks, nc)
    _, cidx = torch.topk(cmax, kc, dim=1)  # [B, kc] winning chunks
    lanes = torch.arange(chunk, device=cidx.device)
    if epilogue == "fold":
        # chunk g covers rows tile*m_tile + (g % npt) + npt*j, j in [0, chunk)
        npt = m_tile // chunk
        base = (cidx // npt) * m_tile + cidx % npt
        flat = base[:, :, None] + npt * lanes
    else:
        flat = cidx[:, :, None] * chunk + lanes
    flat = flat.reshape(B, kc * chunk)  # [B, kc*chunk] global row ids
    rows = corpus_rows if corpus_rows is not None else corpus_t.T
    rows_sel = rows[flat].to(torch.float32)  # [B, kc*chunk, D] gather
    with float32_precision():
        cand = torch.bmm(rows_sel, queries[:, :, None])[:, :, 0]
    cand = cand.masked_fill(flat >= m_real, float("-inf"))  # mask pad rows
    s, si = torch.topk(cand, kk, dim=1)
    gi = torch.gather(flat, 1, si)
    return s, gi.to(torch.int32)


def pad_corpus_t(corpus, m_tile: int = 512):
    """[M, D] corpus (tensor or array) -> ([D, M_pad] transposed zero-padded
    f32 tensor on the corpus's device, M)."""
    if not torch.is_tensor(corpus):
        corpus = torch.as_tensor(np.asarray(corpus))
    m, d = corpus.shape
    m_pad = -(-m // m_tile) * m_tile
    ct = torch.zeros((d, m_pad), dtype=torch.float32, device=corpus.device)
    ct[:, :m] = corpus.T
    return ct, m
