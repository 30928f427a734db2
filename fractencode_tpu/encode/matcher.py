"""All-pairs transform matching: the search core, as batched linear algebra.

The reference's triple-nested hot loop — ranges x domains x transforms with
per-pair early exits (``TransformEstimator2.hpp:29-48``,
``transformmatcher.h:38-144``) — decomposes into the five sums SumA, SumA2,
SumB, SumB2, SumAB.  Only SumAB depends on the (range, domain-isometry) pair
and it is exactly a matmul ``[R, K] @ [K, D*T]``.  Everything else is an
elementwise epilogue (ops/rank.py).

Two routes compute the same winners:
  * ``search`` — the plain reference: XLA, chunked over ranges, every pair
    scored and then masked.  SumAB is an f32 dot at ``Precision.HIGHEST``
    (true f32, no TF32/bf16 passes), exact for K <= 64 because every
    product and partial sum is an integer multiple of 0.25 below 2^22.
  * ``search_kernel`` — the class-sorted layout below feeding the Pallas
    kernel (ops/search_kernel.py), which skips the pairs the classifier
    rejects instead of masking them.
Both hand their winners to ``_winners``, which solves (s, o) and the
reported distance the same way for either route.

Exact reference selection semantics (criterion='raw'):
  * distance = MSE(range, sampled domain) WITHOUT (s, o), normalized by the
    DOMAIN area (``metrics.h:49``, ``transformmatcher.h:87,120``);
  * across domains the first strict improvement wins ties
    (``TransformEstimator2.hpp:34``);
  * within a domain, a later transform wins ties (`<=` compare,
    ``transformmatcher.h:57,67``);
  * early accept: the domain scan stops at the first domain where the
    running best <= rmsThreshold (``TransformEstimator2.hpp:40-41``), and
    within that domain the transform chain stops at the first prefix-minimum
    <= threshold (``transformmatcher.h:55-56,65-66``).  A full argmin with a
    masked prefix reproduces the same winner (see ``select_best``).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.rank import (BIG as _BIG, INT8_MAX_K, exact_sum_ab, rank_mode,
                        rank_tile, rank_to_dist)
from ..params import EncoderConfig
from .codebook import Codebook

__all__ = ["SearchResult", "solve_so", "search", "search_kernel"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SearchResult:
    """Per-range best match. All arrays [R]."""

    domain_idx: jnp.ndarray  # i32, row-major index into the domain grid
    transform: jnp.ndarray  # i32, TransformType value
    distance: jnp.ndarray  # f32, in the configured criterion's units
    s: jnp.ndarray  # f32 contrast
    o: jnp.ndarray  # f32 brightness
    valid: jnp.ndarray  # bool — False if the classifier rejected every domain
    # f32 MAXIMIZED rank key q of the winner (see ops.rank.rank_mode), or
    # None.  Sharded reducers compare q, not distance: distance saturates
    # (e.g. 'ls' clamps at 0 for flat ranges) so equal distances can hide
    # different keys, and only the key reproduces the single-device
    # first-occurrence tie-break bitwise across shards.
    key: jnp.ndarray | None = None


def solve_so(sum_a, sum_a2, sum_b, sum_b2, sum_ab, n: float, so_mode: str, s_max: float):
    """Solve the affine brightness map from the five sums.

    'reference' reproduces ``transformmatcher.h:103-105`` (including the
    ``(SumA-1)*SumA`` denominator quirk and the |den|<1e-5 zero guard);
    'ls' is the textbook least squares for ``range ~ s*domain + o``.

    Exactness: the reference accumulates these sums in DOUBLE and they are
    exact there (8-bit pixels, 0.25-quantized samples).  In f32 the
    ``n*SumAB - SumA*SumB`` subtraction loses ~4 low bits (both terms need
    26 bits), which showed up as ~1e-4 relative error in ``s`` — enough to
    flip u8 truncation boundaries in decode parity.  For K <= INT8_MAX_K
    every term scaled by 4 (num) / 16 (ls den) is an exact i32, so the
    numerator/denominator are computed exactly and the ONLY roundings left
    are the final i32->f32 casts and one division — matching the double
    computation to f32 precision.
    """
    exact = n <= INT8_MAX_K
    if exact:
        ni = int(n)
        sa_i = jnp.asarray(sum_a).astype(jnp.int32)
        sb4 = jnp.asarray(4.0 * jnp.asarray(sum_b)).astype(jnp.int32)
        ab4 = jnp.asarray(4.0 * jnp.asarray(sum_ab)).astype(jnp.int32)
        num4 = (ni * ab4 - sa_i * sb4).astype(jnp.float32)  # 4*num, exact
        if so_mode == "reference":
            sa2_i = jnp.asarray(sum_a2).astype(jnp.int32)
            den = (ni * sa2_i - (sa_i - 1) * sa_i).astype(jnp.float32)  # exact
            s = jnp.where(jnp.abs(den) < 1e-5, 0.0,
                          (num4 * 0.25) / jnp.where(den == 0, 1.0, den))
        else:
            sb2_16 = jnp.asarray(16.0 * jnp.asarray(sum_b2)).astype(jnp.int32)
            den16 = (ni * sb2_16 - sb4 * sb4).astype(jnp.float32)  # 16*den, exact
            # guard |den| < 1e-5: den is a multiple of 1/16, so that's den==0
            s = jnp.where(den16 == 0, 0.0,
                          (num4 * 4.0) / jnp.where(den16 == 0, 1.0, den16))
    else:
        if so_mode == "reference":
            den = n * sum_a2 - (sum_a - 1.0) * sum_a
        else:
            den = n * sum_b2 - sum_b * sum_b
        num = n * sum_ab - sum_a * sum_b
        s = jnp.where(jnp.abs(den) < 1e-5, 0.0, num / jnp.where(den == 0, 1.0, den))
    if s_max > 0.0:
        s = jnp.clip(s, -s_max, s_max)
    if so_mode == "reference":
        o = (sum_b - s * sum_a) / n
    else:
        o = (sum_a - s * sum_b) / n
    return s, o


def _mode_kw(cfg: EncoderConfig, cb: Codebook, k: int) -> dict:
    inv_norm = (1.0 / (cb.grid.block_size * cb.grid.block_size)
                if cfg.criterion == "raw" else 1.0 / k)
    return dict(criterion=cfg.criterion, so_mode=cfg.so_mode,
                s_max=cfg.s_max, inv_norm=inv_norm, n=float(k))


def _aux(cb: Codebook, cfg: EncoderConfig):
    """[D, T] per-column aux input of the rank key (see ops.rank.rank_mode)."""
    if rank_mode(cfg.criterion, cfg.so_mode, cfg.s_max) == "ls":
        return cb.inv_var_or_compute()
    return cb.sum_sq


def _pair_keys(ranges, sum_a, sum_a2, cb: Codebook, cfg: EncoderConfig):
    """Scores for a chunk of ranges against the whole codebook.

    ranges: [RC, K]; returns (dist, key), each [RC, D, T].  ``dist`` is in
    the criterion's units; ``key`` is the MINIMIZED ranking key (the negated
    kernel key, same f32 rounding, so winners and tie-breaks agree).
    """
    k = ranges.shape[-1]
    d, t, _ = cb.values.shape
    # SumAB for every pair: [RC, K] @ [K, D*T].  HIGHEST = true f32 on every
    # backend (TF32 or one bf16 pass would truncate the 10-bit samples).
    sum_ab = jax.lax.dot_general(
        ranges,
        cb.values.reshape(d * t, k),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(-1, d, t)
    sa = sum_a[:, None, None]
    sa2 = sum_a2[:, None, None]
    mode_kw = _mode_kw(cfg, cb, k)
    q = rank_tile(sum_ab, sa, sa2, cb.sum[None], _aux(cb, cfg)[None],
                  **mode_kw)
    return rank_to_dist(q, sa2, sa, **mode_kw), -q


def select_best(dist, threshold: float, key=None):
    """Per-range winner with the reference's tie/early-accept rules.

    dist: [RC, D, T].  Returns flat winner index into (D, T), i32.
    ``key`` (optional, same shape) is the MINIMIZED ranking key; when given,
    ranking/tie-breaks use it while the early-accept frontier still uses
    ``dist`` (thresholds are in distance units).  Ranking by key keeps the
    oracle bit-consistent with the kernel's rank-key argmax.

    Full-scan equivalence of the early exits: let d* be the first domain whose
    per-domain min <= threshold (if any).  The reference's scan then never
    looks past d*, and within d* never past t* (the first transform with
    distance <= threshold).  So mask out (d, t) beyond that frontier and take
    a composite argmin with keys (distance asc, domain asc, transform desc).
    """
    if key is None:
        key = dist
    rc, d, t = dist.shape
    dmin = dist.min(axis=2)  # [RC, D]
    hit = dmin <= threshold
    has_hit = hit.any(axis=1)  # [RC]
    dstar = jnp.argmax(hit, axis=1)  # first hit domain (garbage if none)

    # transform frontier within d*
    dist_at_dstar = jnp.take_along_axis(dist, dstar[:, None, None], axis=1)[:, 0, :]
    thit = dist_at_dstar <= threshold
    tstar = jnp.argmax(thit, axis=1)  # first hit transform (garbage if none)

    d_ids = jnp.arange(d, dtype=jnp.int32)[None, :, None]
    t_ids = jnp.arange(t, dtype=jnp.int32)[None, None, :]
    beyond = (d_ids > dstar[:, None, None]) | (
        (d_ids == dstar[:, None, None]) & (t_ids > tstar[:, None, None])
    )
    masked = jnp.where(has_hit[:, None, None] & beyond, _BIG, key)

    # composite argmin: key asc, then domain asc, then transform DESC
    # (later transform wins ties: transformmatcher.h:57,67).
    rev = masked[:, :, ::-1].reshape(rc, d * t)
    flat_rev = jnp.argmin(rev, axis=1).astype(jnp.int32)
    win_d = flat_rev // t
    win_t = (t - 1) - (flat_rev % t)
    return win_d, win_t


def _winners(ranges, sum_a, sum_a2, cb: Codebook, cfg: EncoderConfig,
             win_m, q) -> SearchResult:
    """From each range's winning search-order column ``win_m`` and its key
    ``q`` (-BIG where nothing competed) to the SearchResult, identically for
    both routes: (s, o) are solved for the winners only, from their exact
    SumAB (ops.rank.exact_sum_ab).

    Above INT8_MAX_K the routes' f32 SumAB dots round in different orders,
    so the reported distance is recomputed from the winner's exact SumAB;
    at or below it every route's keys are exact and the distance is the
    key's."""
    k = ranges.shape[-1]
    d, t, _ = cb.values.shape
    valid = q > -_BIG * 0.5
    win_m = jnp.clip(jnp.where(valid, win_m, 0), 0, d * t - 1)
    win_d = win_m // t
    win_t = (t - 1) - (win_m % t)
    sum_ab = exact_sum_ab(ranges, cb.values[win_d, win_t])
    sb = cb.sum[win_d, win_t]
    s, o = solve_so(sum_a, sum_a2, sb, cb.sum_sq[win_d, win_t], sum_ab,
                    float(k), cfg.so_mode, cfg.s_max)
    mode_kw = _mode_kw(cfg, cb, k)
    q_dist = q
    if k > INT8_MAX_K:
        q_dist = rank_tile(sum_ab, sum_a, sum_a2, sb,
                           _aux(cb, cfg)[win_d, win_t], **mode_kw)
    dist = rank_to_dist(q_dist, sum_a2, sum_a, **mode_kw)
    # Classifier rejected everything: reference falls back to the default
    # item_match_t (s=0, o=0 => decoder writes black; Encoder semantics of
    # TransformEstimator2.hpp:30 default + DecodeUtils.hpp:22-23).
    return SearchResult(
        domain_idx=win_d.astype(jnp.int32),
        transform=win_t.astype(jnp.int32),
        distance=jnp.where(valid, dist, _BIG),
        s=jnp.where(valid, s, 0.0),
        o=jnp.where(valid, o, 0.0),
        valid=valid,
        key=jnp.where(valid, q, -_BIG),
    )


def mask_ranges_result(res: SearchResult, range_mask: jnp.ndarray
                       ) -> SearchResult:
    """Canonical fields for ranges excluded by ``range_mask`` (False = out):
    both routes return the same bits for masked-out entries whether they
    skipped the work (kernel) or post-masked a full search (plain route)."""
    z32 = jnp.zeros((), jnp.int32)
    zf = jnp.zeros((), jnp.float32)
    return SearchResult(
        domain_idx=jnp.where(range_mask, res.domain_idx, z32),
        transform=jnp.where(range_mask, res.transform, z32),
        distance=jnp.where(range_mask, res.distance, _BIG),
        s=jnp.where(range_mask, res.s, zf),
        o=jnp.where(range_mask, res.o, zf),
        valid=res.valid & range_mask,
        key=None if res.key is None else jnp.where(range_mask, res.key, -_BIG),
    )


@partial(jax.jit, static_argnames=("cfg",))
def search(
    ranges: jnp.ndarray,
    sum_a: jnp.ndarray,
    sum_a2: jnp.ndarray,
    cb: Codebook,
    range_classes: jnp.ndarray | None,
    domain_classes: jnp.ndarray | None,
    cfg: EncoderConfig,
    domain_mask: jnp.ndarray | None = None,
    range_mask: jnp.ndarray | None = None,
) -> SearchResult:
    """Best (domain, transform, s, o) per range block: the plain reference.

    ranges [R, K] f32; sum_a/sum_a2 [R] f32; classes i32 or None.
    Scans in chunks of ``cfg.range_chunk`` ranges to bound the [RC, D, T]
    intermediates.  Class mismatches, ``domain_mask`` and ``range_mask``
    are applied after the work (``search_kernel`` skips it instead).
    """
    r, k = ranges.shape
    d, t, _ = cb.values.shape
    rc = min(cfg.range_chunk, r)
    num_chunks = -(-r // rc)
    pad = num_chunks * rc - r

    def pad0(x, fill=0):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)

    ranges_p = pad0(ranges).reshape(num_chunks, rc, k)
    sum_a_p = pad0(sum_a).reshape(num_chunks, rc)
    sum_a2_p = pad0(sum_a2).reshape(num_chunks, rc)
    use_classes = range_classes is not None and cfg.use_classifier
    if use_classes:
        rcls_p = pad0(range_classes, fill=-2).reshape(num_chunks, rc)

    def chunk_fn(args):
        if use_classes:
            rng, sa, sa2, rcls = args
        else:
            rng, sa, sa2 = args
        dist, key = _pair_keys(rng, sa, sa2, cb, cfg)
        if use_classes:
            match = rcls[:, None] == domain_classes[None, :]  # [RC, D]
            dist = jnp.where(match[:, :, None], dist, _BIG)
            key = jnp.where(match[:, :, None], key, _BIG)
        if domain_mask is not None:
            dist = jnp.where(domain_mask[None, :, None], dist, _BIG)
            key = jnp.where(domain_mask[None, :, None], key, _BIG)
        win_d, win_t = select_best(dist, cfg.rms_threshold, key)
        best_key = jnp.take_along_axis(
            jnp.take_along_axis(key, win_d[:, None, None], axis=1)[:, 0, :],
            win_t[:, None], axis=1)[:, 0]
        # search-order column and maximized key of the winner
        return win_d * t + (t - 1 - win_t), -best_key

    chunk_args = (ranges_p, sum_a_p, sum_a2_p) + ((rcls_p,) if use_classes else ())
    win_m, q = jax.lax.map(chunk_fn, chunk_args)
    unpad = lambda x: x.reshape(num_chunks * rc)[:r]
    res = _winners(ranges, sum_a, sum_a2, cb, cfg, unpad(win_m), unpad(q))
    if range_mask is not None:
        res = mask_ranges_result(res, range_mask)
    return res


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


_NUM_CLASS_BINS = 7  # classifier bins -1..5 shifted to 0..6


def _class_layout(classes01: jnp.ndarray, block: int, num_bins: int):
    """Tile-aligned class-sorted layout for ``n`` items in classes
    0..num_bins-1.

    Returns (pos [n] i32 destination of each item in the padded buffer,
    seg_start [num_bins+1] i32 first padded index of each class,
    counts [num_bins+1] i32, tile_cum [num_bins] i32 cumulative tile
    counts — tile i belongs to class searchsorted(tile_cum, i, 'right')).
    The trailing zero entries of seg_start/counts stand for "no class".

    The padded buffer has round_up(n, block) + num_bins*block slots, which
    covers the worst per-class alignment waste.  Stable: items of one class
    keep their order, so search order survives inside each segment.
    """
    # counting sort with fixed bins: per-class running rank from a cumsum
    # over the one-hot class matrix (no argsort, no scatter)
    onehot = (
        classes01[:, None] == jnp.arange(num_bins, dtype=classes01.dtype)
    ).astype(jnp.int32)  # [n, num_bins]
    csum = jnp.cumsum(onehot, axis=0)  # inclusive per-class counts
    counts = csum[-1]  # [num_bins]
    tiles = -(-counts // block)  # ceil
    tile_cum = jnp.cumsum(tiles)  # [num_bins]
    seg_start_t = jnp.concatenate([jnp.zeros(1, tiles.dtype), tile_cum[:-1]])
    seg_start = (seg_start_t * block).astype(jnp.int32)  # element units
    rank = (onehot * csum).sum(axis=1) - 1
    pos = (onehot * seg_start[None, :]).sum(axis=1) + rank.astype(jnp.int32)
    seg_start1 = jnp.concatenate([seg_start, jnp.zeros(1, jnp.int32)])
    counts1 = jnp.concatenate([counts.astype(jnp.int32), jnp.zeros(1, jnp.int32)])
    return pos, seg_start1, counts1, tile_cum.astype(jnp.int32)


@partial(jax.jit, static_argnames=("cfg", "interpret", "blocks"))
def search_kernel(
    ranges: jnp.ndarray,
    sum_a: jnp.ndarray,
    sum_a2: jnp.ndarray,
    cb: Codebook,
    range_classes: jnp.ndarray | None,
    domain_classes: jnp.ndarray | None,
    cfg: EncoderConfig,
    domain_mask: jnp.ndarray | None = None,
    range_mask: jnp.ndarray | None = None,
    interpret: bool = False,
    blocks=None,
) -> SearchResult:
    """``search`` through the Pallas kernel: same winners, same fields.

    Ranges and codebook columns are laid out sorted by class bin into
    tile-aligned segments, so each range tile visits only its own class's
    column tiles (ops/search_kernel.py).  Ranges excluded by ``range_mask``
    and domains excluded by ``domain_mask`` are parked in one extra row or
    column bin that no tile visits: they cost no kernel work.  Column order
    within a class stays (domain asc, transform desc) because the class
    sort is stable, so the reference tie-break is preserved.

    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests).
    """
    from ..ops import search_kernel as sk

    blocks = blocks or sk.DEFAULT_BLOCKS
    block_r, block_m = blocks[:2]
    r, k = ranges.shape
    d, t, _ = cb.values.shape
    m = d * t
    classed = range_classes is not None and cfg.use_classifier
    n_bins = _NUM_CLASS_BINS if classed else 1
    if classed:
        rbin = (range_classes + 1).astype(jnp.int32)  # bins -1..5 -> 0..6
        dbin = (domain_classes + 1).astype(jnp.int32)
    else:
        rbin = jnp.zeros((r,), jnp.int32)
        dbin = jnp.zeros((d,), jnp.int32)
    n_row_bins = n_bins + (range_mask is not None)
    n_col_bins = n_bins + (domain_mask is not None)
    if range_mask is not None:
        rbin = jnp.where(range_mask, rbin, n_bins)
    if domain_mask is not None:
        dbin = jnp.where(domain_mask, dbin, n_bins)

    rpos, _, _, r_tile_cum = _class_layout(rbin, block_r, n_row_bins)
    cpos, c_start, c_count, _ = _class_layout(jnp.repeat(dbin, t), block_m,
                                              n_col_bins)
    r_pad = _round_up(r, block_r) + n_row_bins * block_r
    m_pad = _round_up(m, block_m) + n_col_bins * block_m
    # inverse maps (padding slots point at a zero row appended to the source)
    inv_r = jnp.full((r_pad,), r, jnp.int32).at[rpos].set(
        jnp.arange(r, dtype=jnp.int32))
    inv_col = jnp.full((m_pad,), m, jnp.int32).at[cpos].set(
        jnp.arange(m, dtype=jnp.int32))

    # per range tile: its class bin's column-tile span.  Masked-range tiles
    # and padding tiles past the last bin visit nothing.
    tile_bin = (r_tile_cum[None, :]
                <= jnp.arange(r_pad // block_r)[:, None]).sum(axis=1)
    b = jnp.minimum(tile_bin, n_bins - 1)
    tile_lo = (c_start[b] // block_m).astype(jnp.int32)
    tile_cnt = jnp.where(tile_bin < n_bins, -(-c_count[b] // block_m),
                         0).astype(jnp.int32)
    tile_end = (c_start[b] + c_count[b]).astype(jnp.int32)

    def sort(x, inv):
        """Rows of x in the sorted layout (zero rows for padding slots)."""
        return jnp.concatenate([x, jnp.zeros((1,) + x.shape[1:], x.dtype)])[inv]

    # search-order columns: m = d*T + (T-1-t)
    cb_cols = cb.values[:, ::-1, :].reshape(m, k)
    kp = sk.padded_k(k)
    pad_k = lambda x: jnp.pad(x, ((0, 0), (0, kp - k)))
    if sk.use_int8(k):
        a = (ranges.astype(jnp.int32) - 128).astype(jnp.int8)
        b4 = jnp.round(cb_cols * 4.0).astype(jnp.int32)
        cols = ((b4 >> 3).astype(jnp.int8), (b4 & 7).astype(jnp.int8))
    else:
        a = ranges
        cols = (cb_cols,)
    a_s = sort(pad_k(a), inv_r)
    cols_s = tuple(sort(pad_k(c), inv_col) for c in cols)
    sb_s = sort(cb.sum[:, ::-1].reshape(m), inv_col)
    aux_s = sort(_aux(cb, cfg)[:, ::-1].reshape(m), inv_col)
    mode_kw = _mode_kw(cfg, cb, k)
    q_s, idx_s = sk.fused_search(
        a_s, sort(sum_a, inv_r), sort(sum_a2, inv_r), cols_s, sb_s, aux_s, tile_lo, tile_cnt, tile_end,
        k=k, criterion=cfg.criterion, so_mode=cfg.so_mode, s_max=cfg.s_max,
        inv_norm=mode_kw["inv_norm"], threshold=cfg.rms_threshold, t_n=t,
        blocks=blocks, interpret=interpret,
    )
    # back to range order; sorted winner column -> search-order column
    q = q_s[rpos]
    win_m = inv_col[jnp.clip(idx_s[rpos], 0, m_pad - 1)]
    res = _winners(ranges, sum_a, sum_a2, cb, cfg, win_m, q)
    if range_mask is not None:
        res = mask_ranges_result(res, range_mask)
    return res
