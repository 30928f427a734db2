"""Rank algebra shared by the plain ``search`` and the search kernel.

Pure ``jnp`` on arrays of any shape, so the plain reference runs without
importing kernel code.  Every function here is written so that the plain
route (XLA) and the kernel route (Pallas) compute the SAME f32 values for
the same inputs: where the algebra is integer it is evaluated in exact i32
and rendered to f32 by one deterministic cast.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["BIG", "INT8_MAX_K", "rank_mode", "inv_var_b", "rank_tile",
           "rank_ls_int8", "rank_to_dist", "apply_frontier", "exact_sum_ab"]

# plain Python float: module import must not trigger backend initialization
BIG = 3.0e38
BIG_I = 2**31 - 1

# Largest contraction K for which the int8 decomposition of SumAB is exact in
# f32: |4*SumAB - 512*SumB| <= 4*K*255^2 must stay < 2^24.  K=64 (8x8 ranges)
# fits; larger K takes the f32 path.
INT8_MAX_K = 64


def rank_mode(criterion: str, so_mode: str, s_max: float) -> str:
    """Which ranking epilogue a (criterion, so_mode, s_max) combo uses.

    'raw'     — key q = 2*SumAB - SumB2 (maximize); dist = (SumA2 - q)*inv_norm.
    'ls'      — key q = cov^2 * inv_var_b (maximize);
                dist = max(var_a - q, 0) * (inv_norm / n).
                Requires the per-column reciprocal inv_var_b as the aux input.
    'general' — full residual with the mode's (s, o); key q = -dist.

    The fast keys drop every per-pair division/select and the rank-1
    var_a/var_b terms from the per-pair work: ranking by q is strictly
    monotone in dist per row, so argmax-q with first-occurrence ties equals
    the reference argmin-dist tie-break.
    """
    if criterion == "raw":
        return "raw"
    if so_mode == "ls" and s_max <= 0.0:
        return "ls"
    return "general"


def inv_var_b(sb, sb2, n: float):
    """Per-column guarded reciprocal 1/var_b with the oracle's zero-guard
    semantics (s = 0 when |var_b| < 1e-5; solve_so in encode/matcher.py).

    For K <= INT8_MAX_K the difference is computed in exact i32 (codebook
    samples are multiples of 0.25, so 16*var_b = n*(16*SumB2) - (4*SumB)^2
    with every term < 2^31): the only rounding is the final i32 -> f32 cast,
    so any code path that rebuilds the same integers reproduces the value
    bit-for-bit.  The guard |var_b| < 1e-5 collapses to var16 == 0 because
    var_b is a multiple of 1/16.
    """
    if n <= INT8_MAX_K:
        sb4 = (4.0 * sb).astype(jnp.int32)
        sb2_16 = (16.0 * sb2).astype(jnp.int32)
        var16 = int(n) * sb2_16 - sb4 * sb4  # exact i32
        var_b = var16.astype(jnp.float32) * 0.0625
        return jnp.where(var16 == 0, 0.0,
                         1.0 / jnp.where(var16 == 0, 1.0, var_b))
    var_b = n * sb2 - sb * sb
    return jnp.where(jnp.abs(var_b) < 1e-5, 0.0,
                     1.0 / jnp.where(var_b == 0.0, 1.0, var_b))


def _cov_exact(ab, sa, sb, n: float):
    """cov = n*SumAB - SumA*SumB without catastrophic-cancellation noise.

    cov is the difference of two ~n*K*255^2 quantities; in f32 the result
    inherits the operands' rounding and varies with the compiler's FMA
    contraction, enough to flip winners between separately compiled
    programs.  All terms are multiples of 0.25, so for K <= INT8_MAX_K the
    scaled difference fits i32 exactly and the single rounding is the final
    i32 -> f32 cast.
    """
    if n <= INT8_MAX_K:
        ab4 = (4.0 * ab).astype(jnp.int32)  # exact: 4*SumAB <= 2^24
        sa_i = sa.astype(jnp.int32)
        sb4 = (4.0 * sb).astype(jnp.int32)
        cov4 = int(n) * ab4 - sa_i * sb4  # exact i32
        return cov4.astype(jnp.float32) * 0.25
    return n * ab - sa * sb


def rank_tile(ab, sa, sa2, sb, aux, *, criterion, so_mode, s_max, inv_norm, n):
    """The MAXIMIZED ranking key q for broadcastable (SumAB, per-row sums,
    per-column sums).  ``aux`` is inv_var_b for mode 'ls', SumB2 otherwise
    (see rank_mode)."""
    mode = rank_mode(criterion, so_mode, s_max)
    if mode == "raw":
        return 2.0 * ab - aux  # aux = sb2
    cov = _cov_exact(ab, sa, sb, n)
    if mode == "ls":
        return (cov * cov) * aux  # aux = inv_var_b
    # general: full residual, q = -dist (aux = sb2)
    sb2 = aux
    var_b = n * sb2 - sb * sb
    if so_mode == "ls":
        var_a = n * sa2 - sa * sa
        s = jnp.where(jnp.abs(var_b) < 1e-5, 0.0,
                      cov / jnp.where(var_b == 0.0, 1.0, var_b))
        if s_max > 0.0:
            s = jnp.clip(s, -s_max, s_max)
        e = (var_a - 2.0 * s * cov + (s * s) * var_b) * (1.0 / n)
        return -(jnp.maximum(e, 0.0) * inv_norm)
    den = n * sa2 - (sa - 1.0) * sa
    s = jnp.where(jnp.abs(den) < 1e-5, 0.0,
                  cov / jnp.where(den == 0.0, 1.0, den))
    if s_max > 0.0:
        s = jnp.clip(s, -s_max, s_max)
    o = (sb - s * sa) * (1.0 / n)
    e = (sa2 + (s * s) * sb2 + n * o * o + 2.0 * s * o * sb
         - 2.0 * s * ab - 2.0 * o * sa)
    return -(jnp.maximum(e, 0.0) * inv_norm)


def rank_ls_int8(sa_i, abh, abl, sb, aux, n: float):
    """All-integer 'ls' key from the int8 decomposition of SumAB.

    With ai = A - 128 (int8), B4 = 4*B split as ch = B4 >> 3, cl = B4 & 7,
    abh = ai.ch and abl = ai.cl (i32), A8 := 8*abh + abl = 4*SumAB - 512*SumB
    and, with sb4 := 4*SumB,

        cov4 = 4*(n*SumAB - SumA*SumB) = n*A8 + (128*n - SumA) * sb4

    Every term fits i32 exactly for K <= INT8_MAX_K, so cov4 equals
    _cov_exact's value integer for integer.  ``sa_i`` is SumA as an exact
    i32 (the kernel derives it from its int8 range rows, so it needs no
    per-row sum inputs).  The key

        q = f32(cov4)^2 * (aux * 2^-4)

    is bit-identical to rank_tile's (f32(cov4)*0.25)^2 * aux: scaling by
    powers of two is exact and commutes with rounding.
    """
    ni = int(n)
    sb4 = (4.0 * sb).astype(jnp.int32)
    cov4 = ni * (8 * abh + abl) + (128 * ni - sa_i) * sb4
    cov4f = cov4.astype(jnp.float32)
    return (cov4f * cov4f) * (aux * 0.0625)


def rank_to_dist(q, sa2, sa, *, criterion, so_mode, s_max, inv_norm, n: float):
    """Convert ranking keys back to distances.

    Vectorized over any shape; sa/sa2 broadcast against q.  Entries with
    q <= -BIG/2 (masked) map to +BIG.
    """
    mode = rank_mode(criterion, so_mode, s_max)
    if mode == "raw":
        dist = (sa2 - q) * inv_norm
    elif mode == "ls":
        if n <= INT8_MAX_K:  # exact var_a (integer terms; see _cov_exact)
            sa_i = sa.astype(jnp.int32)
            var_a = (int(n) * sa2.astype(jnp.int32)
                     - sa_i * sa_i).astype(jnp.float32)
        else:
            var_a = n * sa2 - sa * sa
        dist = jnp.maximum(var_a - q, 0.0) * (inv_norm * (1.0 / n))
    else:
        dist = -q
    return jnp.where(q <= -BIG * 0.5, BIG, dist)


def apply_frontier(q, sa, sa2, *, criterion, so_mode, s_max, inv_norm,
                   n, threshold, t_n):
    """Early-accept frontier within one [BR, BM] tile of search-order columns.

    Reproduces the reference's data-dependent scan exits
    (``TransformEstimator2.hpp:40-41``: break the domain loop once best <=
    rmsThreshold; ``transformmatcher.h:55-56``: break the transform loop at
    the first transform under threshold) as a prefix mask.  Domain groups of
    ``t_n`` columns start at tile-local multiples of ``t_n``.  Let c0 be the
    first hit column and g its group: columns store transforms DESCENDING,
    so within g the frontier
    keeps the suffix from the LAST hit column (= the first hit transform in
    ascending-t order).  Beyond the frontier -> -BIG.  The hit test converts
    q back to distance with rank_to_dist's expression, so every route agrees.

    Returns (masked q, any_hit [BR] bool).
    """
    dist = rank_to_dist(q, sa2, sa, criterion=criterion, so_mode=so_mode,
                        s_max=s_max, inv_norm=inv_norm, n=n)
    hit = dist <= threshold
    ids = jax.lax.broadcasted_iota(jnp.int32, q.shape, 1)
    first_hit = jnp.min(jnp.where(hit, ids, BIG_I), axis=1)  # [BR]
    any_hit = first_hit < BIG_I
    g_start = jnp.where(any_hit, (first_hit // t_n) * t_n, BIG_I)[:, None]
    in_g = (ids >= g_start) & (ids < g_start + t_n)
    c_star = jnp.max(jnp.where(hit & in_g, ids, -1), axis=1)[:, None]
    allowed = (ids < g_start) | (in_g & (ids >= c_star))
    return jnp.where((~any_hit[:, None]) | allowed, q, -BIG), any_hit


def exact_sum_ab(ranges, rows):
    """SumAB of range rows against codebook rows, exact then rounded once.

    Both operands are exact in f32 (8-bit pixels; multiples of 0.25), so
    4*SumAB is an integer below 2^31 for K <= 1024; it is summed in i32 and
    cast to f32 once, so every route renders the same value whatever its
    summation order.
    """
    a = ranges.astype(jnp.int32)
    b4 = jnp.round(rows * 4.0).astype(jnp.int32)
    return (a * b4).sum(axis=-1).astype(jnp.float32) * 0.25
