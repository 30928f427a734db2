"""Brightness-block classification (Fisher-style), vectorized.

The reference classifies one block at a time from its four quadrant sums via
24 hand-written inequality chains mapping to 6 classes, or -1 when no chain
holds (``/root/reference/encode/Classifier2.cpp:8-53``).  Here the whole
grid's classes are computed at once from the [N, 4] quadrant-sum
tensor.

Faithfulness note: the 24 conditions are replicated *verbatim as inequality
triples*, including the reference's unreachable class-5 condition
``a4>a1 && a1>a3 && a3>a4`` (``Classifier2.cpp:48``), which is cyclic and can
never hold — so the descending order a4>a1>a3>a2 yields class -1 in both
implementations.  Every consistent condition determines a unique strict total
order, so at most one condition can match and evaluation order is irrelevant.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

__all__ = ["classify_from_quadrants", "NUM_CLASSES", "classify_grid"]

NUM_CLASSES = 6

# (class, ((i, j), (k, l), (m, n))) meaning a_i > a_j && a_k > a_l && a_m > a_n,
# 1-based quadrant indices, transcribed from Classifier2.cpp:22-50.
_CONDITIONS = [
    (0, ((1, 2), (2, 3), (3, 4))),
    (0, ((3, 1), (1, 4), (4, 2))),
    (0, ((4, 3), (3, 2), (2, 1))),
    (0, ((2, 4), (4, 1), (1, 3))),
    (1, ((1, 3), (3, 2), (2, 4))),
    (1, ((2, 1), (1, 4), (4, 3))),
    (1, ((4, 2), (2, 3), (3, 1))),
    (1, ((3, 4), (4, 1), (1, 2))),
    (2, ((1, 4), (4, 3), (3, 2))),
    (2, ((4, 1), (1, 2), (2, 3))),
    (2, ((3, 2), (2, 4), (4, 1))),
    (2, ((2, 3), (3, 1), (1, 4))),
    (3, ((1, 2), (2, 4), (4, 3))),
    (3, ((3, 1), (1, 2), (2, 4))),
    (3, ((4, 3), (3, 1), (1, 2))),
    (3, ((2, 4), (4, 3), (3, 1))),
    (4, ((2, 1), (1, 3), (3, 4))),
    (4, ((1, 3), (3, 4), (4, 2))),
    (4, ((3, 4), (4, 2), (2, 1))),
    (4, ((4, 2), (2, 1), (1, 3))),
    (5, ((1, 4), (4, 2), (2, 3))),
    (5, ((4, 1), (1, 3), (3, 4))),  # unreachable (cyclic), kept for parity
    (5, ((2, 3), (3, 4), (4, 1))),
    (5, ((3, 2), (2, 1), (1, 4))),
]


def _classify_from_quadrants_conditions(quads: jnp.ndarray) -> jnp.ndarray:
    """Direct transcription of the 24 where-chains (the oracle for the
    code-table path below; kept for tests)."""
    a = quads.astype(jnp.int32) if quads.dtype != jnp.float32 else quads
    result = jnp.full(quads.shape[:-1], -1, dtype=jnp.int32)
    for cls, triple in _CONDITIONS:
        match = None
        for i, j in triple:
            cmp = a[..., i - 1] > a[..., j - 1]
            match = cmp if match is None else (match & cmp)
        result = jnp.where(match, jnp.int32(cls), result)
    return result


# the 6 unordered quadrant pairs; bit b of the order code is a_i > a_j and
# bit b+6 is a_j > a_i (two bits per pair: ties leave both clear)
_PAIR_I = np.array([0, 0, 0, 1, 1, 2], np.int32)
_PAIR_J = np.array([1, 2, 3, 2, 3, 3], np.int32)


@functools.lru_cache(maxsize=None)
def _order_code_table() -> np.ndarray:
    """[4096] i32: 12-bit pairwise-order code -> class, by evaluating the 24
    reference conditions in their original where-chain order (last match
    wins — for codes arising from real numbers at most one can match)."""
    tbl = np.full(4096, -1, np.int32)
    for code in range(4096):
        gt = {}
        for b in range(6):
            i, j = int(_PAIR_I[b]) + 1, int(_PAIR_J[b]) + 1
            gt[(i, j)] = bool((code >> b) & 1)
            gt[(j, i)] = bool((code >> (b + 6)) & 1)
        cls = -1
        for c, triple in _CONDITIONS:
            if all(gt[(i, j)] for (i, j) in triple):
                cls = c
        tbl[code] = cls
    return tbl


def classify_from_quadrants(quads: jnp.ndarray) -> jnp.ndarray:
    """[N] i32 class in {-1, 0..5} from [N, 4] quadrant sums (a1..a4).

    The 24 three-way inequality chains (Classifier2.cpp:22-50) collapse to a
    12-bit pairwise-order code + one 4096-entry table lookup: ~10 vector ops
    instead of ~150.  Exactly equivalent — the table is built
    by evaluating the original chains (see _order_code_table), and ties map
    to codes whose rows keep -1.
    """
    # i32 is ample: quadrant sums of a 255-valued 64x64 block reach ~1e6.
    a = quads.astype(jnp.int32) if quads.dtype != jnp.float32 else quads
    ai = a[..., _PAIR_I]  # [N, 6]
    aj = a[..., _PAIR_J]
    w = jnp.asarray((1 << np.arange(6)).astype(np.int32))
    code = ((ai > aj).astype(jnp.int32) * w).sum(-1) + (
        ((aj > ai).astype(jnp.int32) * w).sum(-1) << 6
    )
    return jnp.asarray(_order_code_table())[code]


def classify_grid(plane, grid, ii=None, sums2x2=None) -> jnp.ndarray:
    """[num_items] classes for every block of a grid over a u8 plane.

    Equivalent of preclassifying every grid item at partition-build time
    (``Classifier2.cpp:64-68``).  ``sums2x2`` forwards a precomputed 2x2
    box-sum plane (see stats.quadrant_sums).
    """
    from .stats import quadrant_sums

    return classify_from_quadrants(
        quadrant_sums(plane, grid, ii=ii, sums2x2=sums2x2)
    )
