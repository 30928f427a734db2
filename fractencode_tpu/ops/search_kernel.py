"""Pallas search kernel (Triton route): fused all-pairs scoring with a
running argmax over class-sorted codebook tiles.

This is the device-side search the reference only stubbed (its OpenCL
engine uploads everything and then runs a placeholder kernel body,
reference ``gpu/opencl/OpenCLEncodingEngine.cpp:255-264``).  The plain
``search`` (encode/matcher.py) materializes every chunk's [RC, D, T] score
tensors in device memory; here the [BR, BM] score tile never leaves the SM.

  * The grid runs over range tiles (and, when they are few, over splits of
    each tile's column walk).  Program i keeps its [BR, K] range rows
    resident and walks codebook column tiles with a ``fori_loop``, carrying
    the running (best key, best column, frozen) in registers.
  * Ranges and codebook columns arrive class-sorted and tile-aligned
    (``encode.matcher.search_kernel``): a range tile of class c loops
    only over the column tiles of class c, read from three per-tile tables
    (first tile, tile count, end of the class segment).  The classifier's
    equality prune is skipped work, not a mask; the dense search is the same
    kernel with one class.
  * Columns are in search order ``m = d*T + (T-1-t)`` inside each class
    segment, so "first strict improvement" is the reference's tie-break
    (domain ascending, transform descending; see ``encode/matcher.py``).

Dot precision, per route:
  * K <= INT8_MAX_K (4x4 and 8x8 ranges): SumAB from the exact int8
    decomposition (ops.rank.rank_ls_int8), s8 x s8 -> s32 on the tensor
    cores; the int32 sums are exact, so keys are bit-identical to the plain
    route's integer algebra.
  * K > INT8_MAX_K: f32 x f32 -> f32 with IEEE precision (no TF32).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .rank import (BIG, BIG_I, INT8_MAX_K, apply_frontier, rank_ls_int8,
                   rank_mode, rank_tile, rank_to_dist)

__all__ = ["fused_search", "padded_k", "use_int8", "DEFAULT_BLOCKS"]

# (block_r, block_m, num_warps, num_stages): the fastest of eight choices
# at 2048^2 on an H100 (PERF.md)
DEFAULT_BLOCKS = (64, 64, 4, 2)
# programs to aim for: several per SM of an H100 (132 SMs)
MIN_PROGRAMS = 528

_DN = (((1,), (1,)), ((), ()))


def use_int8(k: int) -> bool:
    return k <= INT8_MAX_K


def padded_k(k: int) -> int:
    """Contraction width the kernel sees: a power of two (Triton block
    shapes), at least 32 for the int8 dot and 16 for the f32 dot.  Padding
    columns are zero on both operands and add nothing to any sum."""
    return max(32 if use_int8(k) else 16, 1 << (k - 1).bit_length())


def _kernel(lo_ref, cnt_ref, end_ref, a_ref, sa_ref, sa2_ref, *refs, bm, k,
            splits, threshold, t_n, mode_kw):
    *col_refs, sb_ref, aux_ref, q_out, idx_out, hit_out = refs
    n = float(k)
    int8 = use_int8(k)
    ls_int8 = int8 and rank_mode(mode_kw["criterion"], mode_kw["so_mode"],
                                 mode_kw["s_max"]) == "ls"
    a = a_ref[...]  # [BR, Kp], resident for the whole column walk
    br = a.shape[0]
    sa_row, sa2_row = sa_ref[...], sa2_ref[...]  # [BR]
    sa, sa2 = sa_row[:, None], sa2_row[:, None]
    sa_i = sa.astype(jnp.int32)  # exact: SumA is an integer
    end = end_ref[0]

    def body(j, carry):
        best_q, best_idx, frozen = carry
        c0 = pl.multiple_of(j * bm, bm)
        cols = pl.ds(c0, bm)
        sb = sb_ref[cols][None, :]
        aux = aux_ref[cols][None, :]
        if int8:
            # s8 x s8 -> s32: exact for any K this route takes
            ch_ref, cl_ref = col_refs
            abh = jax.lax.dot_general(
                a, ch_ref[cols, :], _DN, preferred_element_type=jnp.int32,
                precision=jax.lax.Precision.HIGHEST)
            abl = jax.lax.dot_general(
                a, cl_ref[cols, :], _DN, preferred_element_type=jnp.int32,
                precision=jax.lax.Precision.HIGHEST)
            if ls_int8:
                q = rank_ls_int8(sa_i, abh, abl, sb, aux, n)
            else:
                # exact: 8*abh + abl = 4*SumAB - 512*SumB in i32
                ab = (8 * abh + abl).astype(jnp.float32) * 0.25 + 128.0 * sb
                q = rank_tile(ab, sa, sa2, sb, aux, n=n, **mode_kw)
        else:
            # f32 x f32 -> f32, IEEE (HIGHEST: no TF32 truncation)
            (c_ref,) = col_refs
            ab = jax.lax.dot_general(
                a, c_ref[cols, :], _DN, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
            q = rank_tile(ab, sa, sa2, sb, aux, n=n, **mode_kw)
        ids = jax.lax.broadcasted_iota(jnp.int32, q.shape, 1)
        # padding slots at the end of the class segment never compete
        q = jnp.where(ids + c0 < end, q, -BIG)

        def argmax(q):
            # tile-local argmax, explicit first-occurrence tie-break
            tile_q = jnp.max(q, axis=1)
            tile_arg = jnp.min(jnp.where(q == tile_q[:, None], ids, BIG_I),
                               axis=1)
            return tile_q, tile_arg

        tile_q, tile_arg = argmax(q)
        # Early accept (distance <= threshold, also at threshold 0 where an
        # exact fit stops the reference's scan).  Distance is monotone in
        # the key, so a row has a hit in this tile iff its best key does:
        # the per-pair frontier runs only in tiles that hold a hit.
        row_hit = rank_to_dist(tile_q, sa2_row, sa_row, n=n,
                               **mode_kw) <= threshold

        def frontier(_):
            qf, any_hit = apply_frontier(q, sa, sa2, n=n, threshold=threshold,
                                         t_n=t_n, **mode_kw)
            return (*argmax(qf), any_hit)

        tile_q, tile_arg, any_hit = jax.lax.cond(
            jnp.max(row_hit.astype(jnp.int32)) > 0, frontier,
            lambda _: (tile_q, tile_arg, jnp.zeros_like(row_hit)), None)
        # rows past their frontier stop improving (the frontier tile itself
        # still updates: the freeze applies from the next tile on)
        improved = (tile_q > best_q) & (frozen == 0)
        return (jnp.where(improved, tile_q, best_q),
                jnp.where(improved, tile_arg + c0, best_idx),
                jnp.where(any_hit, 1, frozen))

    init = (jnp.full((br,), -BIG, jnp.float32),
            jnp.zeros((br,), jnp.int32),
            jnp.zeros((br,), jnp.int32))
    # this program's share of the class segment: split s of ``splits``
    cnt = cnt_ref[0]
    per = (cnt + splits - 1) // splits
    start = lo_ref[0] + pl.program_id(1) * per
    stop = lo_ref[0] + jnp.minimum((pl.program_id(1) + 1) * per, cnt)
    best_q, best_idx, frozen = jax.lax.fori_loop(start, stop, body, init)
    q_out[...] = best_q
    idx_out[...] = best_idx
    hit_out[...] = frozen


def _splits(n_tiles: int, col_tiles: int) -> int:
    """Column splits per range tile: enough programs to fill the card when
    there are few range tiles, never a split of less than two tiles."""
    want = -(-MIN_PROGRAMS // n_tiles)
    return max(1, min(want, col_tiles // 2))


def combine_splits(q, idx, hit):
    """[S, R] per-split winners -> [R] winner, in scan order.

    Splits hold consecutive column runs, so the scan the reference makes
    never passes the first split whose frontier was hit: later splits drop
    out, and among the rest the highest key wins, ties to the lowest split
    (each split's own winner is already its first occurrence)."""
    s_ids = jnp.arange(q.shape[0])[:, None]
    any_hit = hit.max(axis=0) > 0
    s_star = jnp.argmax(hit > 0, axis=0)
    q = jnp.where(any_hit[None, :] & (s_ids > s_star[None, :]), -BIG, q)
    win = jnp.argmax(q, axis=0)
    take = lambda x: jnp.take_along_axis(x, win[None, :], axis=0)[0]
    return take(q), take(idx)


@functools.partial(
    jax.jit,
    static_argnames=("k", "criterion", "so_mode", "s_max", "inv_norm",
                     "threshold", "t_n", "blocks", "interpret"),
)
def fused_search(a, sa, sa2, cols, sb, aux, tile_lo, tile_cnt, tile_end, *,
                 k: int, criterion: str, so_mode: str, s_max: float,
                 inv_norm: float, threshold: float, t_n: int,
                 blocks=DEFAULT_BLOCKS, interpret: bool = False):
    """Best (key, sorted column) per sorted range row.

    a [R_pad, Kp]: int8 ``A - 128`` rows (K <= INT8_MAX_K) or f32 rows.
    sa, sa2 [R_pad] f32 per-row sums SumA, SumA2.
    cols: (ch, cl) int8 [M_pad, Kp] halves of 4*B (``B4 >> 3``, ``B4 & 7``),
    or (c,) f32 [M_pad, Kp].  sb, aux [M_pad] f32 per-column sums (aux is
    inv_var_b in 'ls' rank mode, SumB2 otherwise).  tile_lo, tile_cnt,
    tile_end [R_pad // block_r] i32: each range tile's first column tile,
    number of column tiles, and first column past its class segment.

    The grid is (range tiles, column splits): with few range tiles each
    tile's column walk is split over several programs and the per-split
    winners are combined afterwards (``combine_splits``).

    Returns (q [R_pad] f32 maximized key, -BIG where nothing competed;
    idx [R_pad] i32 sorted column of the winner).
    """
    block_r, block_m, num_warps, num_stages = blocks
    r_pad, kp = a.shape
    m_pad = cols[0].shape[0]
    assert r_pad % block_r == 0 and m_pad % block_m == 0, (r_pad, m_pad)
    assert block_m % t_n == 0, (block_m, t_n)
    n_tiles = r_pad // block_r
    splits = _splits(n_tiles, m_pad // block_m)
    kernel = functools.partial(
        _kernel, bm=block_m, k=k, splits=splits, threshold=threshold,
        t_n=t_n, mode_kw=dict(criterion=criterion, so_mode=so_mode,
                              s_max=s_max, inv_norm=inv_norm),
    )
    tile = pl.BlockSpec((1,), lambda i, s: (i,))
    rows = pl.BlockSpec((block_r, kp), lambda i, s: (i, 0))
    row_sums = pl.BlockSpec((block_r,), lambda i, s: (i,))
    whole_cols = pl.BlockSpec((m_pad, kp), lambda i, s: (0, 0))
    whole_sums = pl.BlockSpec((m_pad,), lambda i, s: (0,))
    out = pl.BlockSpec((None, block_r), lambda i, s: (s, i))
    q, idx, hit = pl.pallas_call(
        kernel,
        grid=(n_tiles, splits),
        in_specs=[tile, tile, tile, rows, row_sums, row_sums,
                  *[whole_cols] * len(cols), whole_sums, whole_sums],
        out_specs=[out, out, out],
        out_shape=[jax.ShapeDtypeStruct((splits, r_pad), jnp.float32),
                   jax.ShapeDtypeStruct((splits, r_pad), jnp.int32),
                   jax.ShapeDtypeStruct((splits, r_pad), jnp.int32)],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="fractal_search",
    )(tile_lo, tile_cnt, tile_end, a, sa, sa2, *cols, sb, aux)
    if splits == 1:
        return q[0], idx[0]
    return combine_splits(q, idx, hit)
