"""Hybrid heavy/light exact top-k: small membership slab + light pools.

Counterpart of ``ircl_tpu/ops/hybrid.py``. Device-side combine for
``index/split.py``:

    H[b, d] = heavy-term scores   (membership slab kernel, small union/width)
    L[b, d] = light-term scores   (host-gathered pools, segment-summed here)

Exactness: H, L >= 0 elementwise, so every doc in top-k(H + L) is either in
top-k(H) or has L > 0. ``hybrid_topk`` returns top-k over
{masked heavy top-k} ∪ {light candidates with exact H + L totals}; heavy
entries whose doc also appears in the light pool are masked (their exact
total lives in the candidate list), so no doc is double-counted or
underestimated. ``hybrid_topk_bucketed_fused`` instead adds the pools into
the transposed scores inside the ``light_add_topk_t`` kernel.

Engines: ``hybrid_topk`` (one width bucket, any corpus size),
``hybrid_topk_bucketed_fused`` (two width buckets, the bench engine up to
the ranker's fused gate) and ``hybrid_topk_bucketed`` (two width buckets,
staged: scores ``[B, N]`` materialized, then ``_merge_light`` or, with
``select_rescore``, ``_select_rescore_topk``). The reference's
``_topk_wide`` (a measured negative there) is not carried over.

Scoring GEMMs run through ``scores_matmul``: "highest" and "high" are full
fp32 (TF32 off; CUDA has no bf16_3x GEMM), "default" allows TF32 (opt-in,
inexact, like JAX's 1-pass bf16 mode). The one product below fp32 is
``select_rescore``'s selection pass: a bf16 ``torch.matmul`` stored as
bf16, as in the reference; every returned score is an fp32 rescore.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ircl_tpu_torch.ops.light_add_cuda import light_add_topk_t
from ircl_tpu_torch.ops.membership_cuda import (
    membership_slab,
    membership_slab_windowed,
    scores_matmul,
)
from ircl_tpu_torch.utils.precision import float32_precision

_TWOPHASE_MIN = 131_072  # below this width the flat top-k is already cheap
_TWOPHASE_CHUNK = 32


def _topk_twophase(h: torch.Tensor, kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over very wide rows: chunk-max reduce -> narrow top-k
    over chunk maxima -> gather + re-top-k of the kk*chunk candidates.
    Superset argument: the true top-kk live in at most kk chunks, each with
    max >= the kk-th value. Scores equal the flat top-k's; ids may differ
    across equal scores."""
    B, n = h.shape
    chunk = _TWOPHASE_CHUNK
    if n % chunk or kk > n // chunk:
        return torch.topk(h, kk, dim=1)
    nc = n // chunk
    cmax = h.view(B, nc, chunk).amax(dim=-1)
    _, cidx = torch.topk(cmax, kk, dim=1)  # [B, kk] winning chunks
    flat = (
        cidx[:, :, None] * chunk
        + torch.arange(chunk, device=h.device)
    ).reshape(B, kk * chunk)
    cand = torch.gather(h, 1, flat)
    s, si = torch.topk(cand, kk, dim=1)
    return s, torch.gather(flat, 1, si)


def _sorted_pools(light_docs, light_contribs, pools_sorted: bool):
    """Doc-ascending pools (the one shared copy for the merge and the fused
    kernel). The C++ gather pre-sorts (sort_pools=True); otherwise one
    stable device argsort."""
    if pools_sorted:
        return light_docs, light_contribs
    order = torch.argsort(light_docs, dim=1, stable=True)
    return (
        torch.gather(light_docs, 1, order),
        torch.gather(light_contribs, 1, order),
    )


def _bucketed_membership(u_sorted, terms_a, vals_a, terms_b, vals_b, d_tile):
    """Twin width-bucket membership slabs concatenated along docs: the one
    shared copy for the bucketed engines."""
    u_tile = _u_tile(u_sorted.shape[0], d_tile)
    ma = membership_slab_windowed(
        u_sorted, terms_a, vals_a, u_tile=u_tile, d_tile=d_tile
    )
    mb = membership_slab_windowed(
        u_sorted, terms_b, vals_b, u_tile=u_tile, d_tile=d_tile
    )
    return torch.cat([ma, mb], dim=1), u_tile  # [U, Na_pad + Nb_pad]


def _run_totals(sd: torch.Tensor, sv: torch.Tensor):
    """Per-run totals of doc-sorted pools: (is_end [B, P], l_tot [B, P]).

    ``l_tot`` is valid at run ends (``is_end``). Run totals are differences
    of an fp64 prefix sum, so a small run after a large prefix keeps its
    value; the reference needs a double-float scan only because the TPU has
    no f64. A plain f32 cumsum carries ulp(prefix) absolute error, which
    can exceed (and zero out) a small run's entire total."""
    P = sd.shape[1]
    csum = torch.cumsum(sv.to(torch.float64), dim=1)
    nxt = torch.cat([sd[:, 1:], torch.full_like(sd[:, :1], -1)], dim=1)
    is_end = sd != nxt
    idxs = torch.arange(P, device=sd.device)
    # index of the previous run's end at every position (-1: none yet)
    starts_after_end = torch.cat(
        [torch.zeros_like(is_end[:, :1]), is_end[:, :-1]], dim=1
    )
    prev_end = torch.where(starts_after_end, idxs[None, :] - 1, -1)
    prev_end = torch.cummax(prev_end, dim=1).values
    prev_csum = torch.where(
        prev_end >= 0,
        torch.gather(csum, 1, prev_end.clamp(min=0)),
        0.0,
    )
    return is_end, (csum - prev_csum).to(torch.float32)


def _merge_light(
    h: torch.Tensor,  # [B, N_pad] exact heavy scores
    light_docs: torch.Tensor,  # [B, P] int32 (pads: any in-range id, contrib 0)
    light_contribs: torch.Tensor,  # [B, P] f32
    k: int,
    num_real_docs: int,
    pools_sorted: bool = False,  # pools already doc-ascending (host gather)
) -> Tuple[torch.Tensor, torch.Tensor]:
    n_pad = h.shape[1]
    kk = min(k, n_pad)
    if n_pad >= _TWOPHASE_MIN:
        h_s, h_i = _topk_twophase(h, kk)
    else:
        h_s, h_i = torch.topk(h, kk, dim=1)

    # ---- light segment totals (per-row sort by doc, run-end reduction) -----
    sd, sv = _sorted_pools(light_docs, light_contribs, pools_sorted)
    is_end, l_tot = _run_totals(sd, sv)  # valid at run ends

    # Pool padding may carry any in-range doc id with zero contribution: its
    # candidate total collapses to H[d] + 0, and the duplicate mask below
    # removes the heavy-only entry for that doc, so totals stay exact and
    # zero-score rows are filtered at the end.
    real = sd < num_real_docs
    h_at_light = torch.gather(h, 1, sd.long().clamp(0, n_pad - 1))  # [B, P]
    cand = torch.where(is_end & real, h_at_light + l_tot, -torch.inf)

    # ---- mask heavy entries that also appear in the light pool -------------
    dup = (
        h_i[:, :, None] == torch.where(real, sd, -2).long()[:, None, :]
    ).any(dim=2)  # [B, kk]
    h_s = torch.where(dup, -torch.inf, h_s)

    all_s = torch.cat([h_s, cand], dim=1)
    all_i = torch.cat([h_i, sd.long()], dim=1)
    top_s, top_pos = torch.topk(all_s, min(k, all_s.shape[1]), dim=1)
    top_i = torch.gather(all_i, 1, top_pos)

    empty = (top_s <= 0.0) | (top_i >= num_real_docs) | ~torch.isfinite(top_s)
    return (
        torch.where(empty, 0.0, top_s),
        torch.where(empty, -1, top_i).to(torch.int32),
    )


def _light_total_at(sd, l_tot, cand):
    """Exact light run totals for candidate docs: per-row binary search over
    the doc-ascending pools. ``l_tot`` is valid at run ends, and the last
    occurrence of a doc in a sorted row IS its run end, so
    ``searchsorted(right=True) - 1`` lands exactly there. Docs absent from
    a row's pool contribute 0."""
    pos = torch.searchsorted(sd, cand.to(sd.dtype), right=True)
    pos = (pos - 1).clamp(min=0)
    hit = torch.gather(sd, 1, pos) == cand
    return torch.where(hit, torch.gather(l_tot, 1, pos), 0.0)


def _select_rescore_topk(
    m: torch.Tensor,  # [U, N_pad] membership slab
    wt: torch.Tensor,  # [U, B_pad] query slab
    h_sel: torch.Tensor,  # [B, N_pad] bf16 selection scores
    light_docs: torch.Tensor,
    light_contribs: torch.Tensor,
    k: int,
    n_cand: int,
    num_real_docs: int,
    pools_sorted: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select+rescore top-k: pick ``n_cand`` candidate docs per query from
    the cheap bf16 scores (heavy top-C ∪ light run-ends, the same candidate
    union as ``_merge_light``), then recompute those candidates' totals
    exactly — heavy part as an fp32 contraction (TF32 off) over the gathered
    slab columns, light part from the fp64 run totals — and take the final
    top-k over exact values.

    The candidate step is approximate: a true top-k doc could in principle
    fall outside the bf16 top-``n_cand`` heavy candidates (light candidates
    are unaffected: their selection already uses exact ``l_tot``). Callers
    that need certified results run a full-batch parity gate."""
    B, n_pad = h_sel.shape
    kk = min(n_cand, n_pad)
    if n_pad >= _TWOPHASE_MIN:
        h_s, h_i = _topk_twophase(h_sel, kk)
    else:
        h_s, h_i = torch.topk(h_sel, kk, dim=1)
    h_s = h_s.to(torch.float32)

    sd, sv = _sorted_pools(light_docs, light_contribs, pools_sorted)
    is_end, l_tot = _run_totals(sd, sv)
    real = sd < num_real_docs
    sd_l = sd.long()
    h_at_light = torch.gather(h_sel, 1, sd_l.clamp(0, n_pad - 1)).to(torch.float32)
    cand_l = torch.where(is_end & real, h_at_light + l_tot, -torch.inf)
    dup = (h_i[:, :, None] == torch.where(real, sd_l, -2)[:, None, :]).any(dim=2)
    h_s = torch.where(dup, -torch.inf, h_s)

    all_s = torch.cat([h_s, cand_l], dim=1)
    all_i = torch.cat([h_i, sd_l], dim=1)
    n_sel = min(n_cand, all_s.shape[1])
    sel_s, sel_pos = torch.topk(all_s, n_sel, dim=1)
    cand = torch.gather(all_i, 1, sel_pos)  # [B, n_sel]
    # Finite-selected candidates are distinct docs (heavy top-k ids are
    # distinct, light run-ends are one-per-doc, cross-duplicates masked);
    # -inf slots carry junk ids (possibly repeats): zero them after rescore
    # so no doc's exact total can enter the final top-k twice.
    valid = torch.isfinite(sel_s)
    safe = cand.clamp(0, n_pad - 1)

    mc = m[:, safe.reshape(-1)].view(m.shape[0], B, n_sel)  # column gather
    with float32_precision():
        h_exact = torch.einsum("ub,ubc->bc", wt[:, :B], mc)
    total = torch.where(valid, h_exact + _light_total_at(sd_l, l_tot, safe), 0.0)
    top_s, tp = torch.topk(total, min(k, n_sel), dim=1)
    top_i = torch.gather(safe, 1, tp)
    empty = (top_s <= 0.0) | (top_i >= num_real_docs)
    return (
        torch.where(empty, 0.0, top_s),
        torch.where(empty, -1, top_i).to(torch.int32),
    )


def _u_tile(u: int, d_tile: int = 256) -> int:
    """The reference's union tile: at least 4 u-tiles when the union allows
    it, clamped to u. The CUDA slab kernel has no u-tiles and ignores it;
    it is kept so the slab calls carry the reference's arguments."""
    cap = 256 if d_tile >= 1024 else 512
    return min(u, max(128, min(cap, u // 4)))


class _PrecDict(dict):
    def __missing__(self, key):
        raise ValueError(
            f"unknown precision {key!r}: expected one of {sorted(self)}"
        )


# precision name -> TF32 allowed in the scoring GEMM
_PREC = _PrecDict(
    highest=False,  # full fp32
    high=False,  # full fp32: CUDA has no bf16_3x GEMM
    default=True,  # TF32, ~1e-3 rel err (opt-in, like JAX's 1-pass bf16)
)


def _query_slab(u_sorted, qb_t, qw_t, u_tile, queries_sorted):
    """Query-side slab. Queries sorted ascending with pads (-1) trailing (the
    ranker pre-sorts on host) take the windowed entry point, as in the
    reference; the CUDA kernel is the same either way."""
    b_tile = 512 if qb_t.shape[1] % 512 == 0 else 128
    if queries_sorted:
        return membership_slab_windowed(
            u_sorted, qb_t, qw_t, u_tile=u_tile, d_tile=b_tile
        )
    return membership_slab(u_sorted, qb_t, qw_t, u_tile=u_tile, d_tile=b_tile)


def _heavy_scores(
    u_sorted, terms_t, vals_t, qb_t, qw_t, tf32, b,
    queries_sorted=False, d_tile=256,
):
    u_tile = _u_tile(u_sorted.shape[0], d_tile)
    # doc-side slab: rows sorted ascending, exact
    m = membership_slab_windowed(
        u_sorted, terms_t, vals_t, u_tile=u_tile, d_tile=d_tile
    )  # [U_h, N_pad]
    wt = _query_slab(u_sorted, qb_t, qw_t, u_tile, queries_sorted)
    return scores_matmul(wt.T, m, tf32=tf32)[:b]


def hybrid_topk(
    heavy_terms_t: torch.Tensor,  # [K_h, N_pad] int32 (pad -1)
    heavy_vals_t: torch.Tensor,  # [K_h, N_pad] f32
    u_sorted: torch.Tensor,  # [U_h] int32 heavy union slots (sentinel pad)
    qb_t: torch.Tensor,  # [T8, B_pad] int32 heavy query buckets
    qw_t: torch.Tensor,  # [T8, B_pad] f32 heavy query weights
    light_docs: torch.Tensor,  # [B, P] int32 light posting docs
    light_contribs: torch.Tensor,  # [B, P] f32 light w*val contributions
    k: int,
    num_real_docs: int,
    precision: str = "highest",  # see _PREC
    queries_sorted: bool = False,
    pools_sorted: bool = False,  # light pools pre-sorted by doc on host
    d_tile: int = 256,  # the reference's slab tile (ignored by the kernel)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-bucket hybrid top-k: (scores [B, k], doc ids [B, k]), empty rows
    (0, -1). The reference's ``interpret`` and ``slab_impl`` arguments have
    no counterpart: CPU tensors take the plain slab, CUDA tensors the
    kernel."""
    h = _heavy_scores(
        u_sorted, heavy_terms_t, heavy_vals_t, qb_t, qw_t, _PREC[precision],
        light_docs.shape[0], queries_sorted, d_tile,
    )
    return _merge_light(
        h, light_docs, light_contribs, k, num_real_docs,
        pools_sorted=pools_sorted,
    )


def hybrid_topk_bucketed_fused(
    terms_a: torch.Tensor,
    vals_a: torch.Tensor,
    terms_b: torch.Tensor,
    vals_b: torch.Tensor,
    u_sorted: torch.Tensor,
    qb_t: torch.Tensor,
    qw_t: torch.Tensor,
    light_docs: torch.Tensor,  # [B, P] ids in the PERMUTED doc space
    light_contribs: torch.Tensor,
    k: int,
    precision: str = "highest",
    queries_sorted: bool = False,
    pools_sorted: bool = False,  # light pools pre-sorted by doc on host
    d_tile: int = 256,  # slab tile only; the light-add kernel picks its own
    #   doc tile (largest of 1024/512/256 dividing the padded doc count)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fully fused variant: scores stay transposed ([N, B]), the light pools
    are added straight into them and per-tile top-k emitted by the
    ``light_add_topk_t`` kernel — no gather, no candidate merge, and the
    [N, B] score matrix is read once. Exact totals; the final top-k runs
    over n_tiles * k8 per-tile winners. Ids live in the permuted space."""
    m, u_tile = _bucketed_membership(
        u_sorted, terms_a, vals_a, terms_b, vals_b, d_tile
    )
    wt = _query_slab(u_sorted, qb_t, qw_t, u_tile, queries_sorted)
    h_t = scores_matmul(m.T, wt, tf32=_PREC[precision])  # [N_pad, B_pad]

    B = light_docs.shape[0]
    b_pad = -(-B // 128) * 128
    sd, sv = _sorted_pools(light_docs, light_contribs, pools_sorted)
    if b_pad != B:
        sd = torch.nn.functional.pad(sd, (0, 0, 0, b_pad - B))
        sv = torch.nn.functional.pad(sv, (0, 0, 0, b_pad - B))
    h_t = h_t[:, :b_pad].contiguous()

    # Largest doc tile the padded doc count admits, as in the reference:
    # the ranker pads buckets to lcm(d_tile, 1024), so this is 1024 there.
    if h_t.shape[0] % 256:
        raise ValueError(
            f"padded doc count {h_t.shape[0]} is not a multiple of 256 — "
            "pad buckets with pad_for_slab(d_tile=lcm(d_tile, 1024)) as "
            "TfidfRanker does"
        )
    light_dt = next(t for t in (1024, 512, 256) if h_t.shape[0] % t == 0)
    tile_s, tile_i = light_add_topk_t(
        h_t, sd.T.contiguous(), sv.T.contiguous(), k=k, b_tile=128,
        d_tile=light_dt,
    )  # [n_dt * k8, b_pad] scores / global doc positions

    top_s, top_pos = torch.topk(
        tile_s.T[:B], min(k, tile_s.shape[0]), dim=1
    )  # [B, k]
    top_i = torch.gather(tile_i.T[:B], 1, top_pos)
    empty = top_s <= 0.0
    return (
        torch.where(empty, 0.0, top_s),
        torch.where(empty, -1, top_i),
    )


def hybrid_topk_bucketed(
    terms_a: torch.Tensor,  # [K_a, Na_pad] narrow-doc bucket (k-major)
    vals_a: torch.Tensor,
    terms_b: torch.Tensor,  # [K_b, Nb_pad] wide-doc bucket
    vals_b: torch.Tensor,
    u_sorted: torch.Tensor,
    qb_t: torch.Tensor,
    qw_t: torch.Tensor,
    light_docs: torch.Tensor,  # [B, P] ids in the PERMUTED doc space
    light_contribs: torch.Tensor,
    k: int,
    precision: str = "highest",
    queries_sorted: bool = False,
    pools_sorted: bool = False,  # pools doc-ascending in PERMUTED space
    d_tile: int = 256,  # the reference's slab tile (ignored by the kernel)
    select_rescore: int = 0,  # >0: bf16 selection of this many candidates a
    #   query + exact fp32 rescore (see _select_rescore_topk); `precision`
    #   is ignored on that path. 0: exact full-score path (default).
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staged width-bucketed engine: the slab ``M [U, N]`` and the scores
    ``H [B, N]`` are materialized, then merged with the light pools. Returned
    ids live in the permuted space (positions into [bucket_a | bucket_b]);
    callers map back through the permutation. Padding positions score 0 and
    are filtered by score, not by position."""
    tf32 = _PREC[precision]
    m, u_tile = _bucketed_membership(
        u_sorted, terms_a, vals_a, terms_b, vals_b, d_tile
    )
    wt = _query_slab(u_sorted, qb_t, qw_t, u_tile, queries_sorted)
    B = light_docs.shape[0]
    if select_rescore:
        # one bf16 pass, fp32 accumulation, stored as bf16: half the [B, N]
        # traffic of the exact path
        h_sel = torch.matmul(
            wt[:, :B].T.to(torch.bfloat16), m.to(torch.bfloat16)
        )
        return _select_rescore_topk(
            m, wt, h_sel, light_docs, light_contribs, k,
            n_cand=max(select_rescore, k),  # at least k candidates
            num_real_docs=h_sel.shape[1],
            pools_sorted=pools_sorted,
        )
    h = scores_matmul(wt.T, m, tf32=tf32)[:B]
    # a positional real-mask is meaningless in permuted space; zero-score
    # filtering inside _merge_light handles pads
    return _merge_light(
        h, light_docs, light_contribs, k, h.shape[1], pools_sorted=pools_sorted
    )
