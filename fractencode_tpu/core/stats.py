"""Block statistics, vectorized.

Replaces the reference's per-block SIMD sum routines
(reference ``image/ImageStatistics.cpp:4-51``): the whole grid's
block sums are computed at once.  Two strategies, both exact in integer
arithmetic (i32 — a 255-valued 16x16 block sums to 65280, far below 2**31):

  * non-overlapping, image-aligned grids: reshape + sum;
  * arbitrary (overlapping) grids: 2-D inclusive prefix sum (integral image)
    + 4-corner gather, O(HW) regardless of overlap.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .grid import Grid

__all__ = ["integral_image", "grid_block_sums", "block_sums_nonoverlapping", "quadrant_sums"]


def integral_image(plane: jnp.ndarray) -> jnp.ndarray:
    """[H+1, W+1] i32 exclusive-origin integral image of a u8/int plane."""
    s = jnp.cumsum(jnp.cumsum(plane.astype(jnp.int32), axis=0), axis=1)
    return jnp.pad(s, ((1, 0), (1, 0)))


def _window_sums(ii: jnp.ndarray, ox: np.ndarray, oy: np.ndarray, w: int, h: int) -> jnp.ndarray:
    """Sums of h x w windows at origins (ox, oy) from an integral image."""
    oxj = jnp.asarray(ox)
    oyj = jnp.asarray(oy)
    return (
        ii[oyj + h, oxj + w]
        - ii[oyj, oxj + w]
        - ii[oyj + h, oxj]
        + ii[oyj, oxj]
    )


def grid_block_sums(plane: jnp.ndarray, grid: Grid, ii: jnp.ndarray | None = None) -> jnp.ndarray:
    """[num_items] i32 per-block pixel sums for a (possibly overlapping) grid."""
    if ii is None:
        ii = integral_image(plane)
    ox, oy = grid.origins()
    return _window_sums(ii, ox, oy, grid.block_size, grid.block_size)


def block_sums_nonoverlapping(plane: jnp.ndarray, block_size: int) -> jnp.ndarray:
    """[H//b, W//b] i32 block sums for an exact non-overlapping tiling.

    Lowered as ``reduce_window`` rather than a reshape-to-[H/b, b, W/b, b]
    sum, which splits the minor dimension and can force a relayout; which
    form is faster on the H100 awaits measurement.  Integer adds are
    order-independent, so the two are bit-identical.
    """
    h, w = plane.shape
    b = block_size
    assert h % b == 0 and w % b == 0, (h, w, b)
    return jax.lax.reduce_window(
        plane.astype(jnp.int32), 0, jax.lax.add, (b, b), (b, b), "VALID"
    )


def quadrant_sums(plane: jnp.ndarray, grid: Grid, ii: jnp.ndarray | None = None,
                  sums2x2: jnp.ndarray | None = None) -> jnp.ndarray:
    """[num_items, 4] i32 sums of the 4 half-size quadrants of each block.

    Quadrant order matches the reference classifier's a1..a4 = top-left,
    top-right, bottom-left, bottom-right (``encode/Classifier2.cpp:55-61``,
    quadrant helpers ``image/partition2.hpp:19-30``).

    Fast path: when the grid step is a multiple of the half-block (true for
    the default range and domain grids and all quadtree levels), every needed
    quadrant lies on the half-aligned non-overlapping tiling, so the sums are
    a reshape-reduce plus slicing — no integral image, no gathers.  For
    step == block (non-overlapping grids) the four "slices" are one fused
    reshape-transpose instead of four strided slices.

    ``sums2x2``: optional [H/2, W/2] i32 2x2-box sums of the plane — callers
    that already reduce the plane once (the codebook's half image is the
    same reduction x0.25) pass it here so the image is only read once.
    """
    h, w = plane.shape
    half = grid.block_size // 2
    if (
        half > 0
        and grid.step % half == 0
        and h % half == 0
        and w % half == 0
    ):
        if sums2x2 is not None and half % 2 == 0:
            if half == 2:
                bs = sums2x2
            else:
                hh = half // 2
                bs = jax.lax.reduce_window(
                    sums2x2, 0, jax.lax.add, (hh, hh), (hh, hh), "VALID"
                )
        else:
            bs = block_sums_nonoverlapping(plane, half)  # [H/half, W/half]
        k = grid.step // half
        ny, nx = grid.ny, grid.nx

        if k == 2 and bs.shape == (2 * ny, 2 * nx) and ny * nx <= 2048 ** 2:
            # non-overlapping grid: group the 2x2 quadrant cells with ONE
            # reshape-transpose instead of four strided slices.  Only up to
            # 8K images: the [ny, 2, nx, 2] intermediate's tiled layout
            # pads the minor dim 2 -> 128 (64x), which is 4.3 GB of HBM
            # temp at 8192^2 and EXCEEDS the chip at 16384^2 — the strided
            # picks below have no padded intermediate.
            g = bs.reshape(ny, 2, nx, 2).transpose(0, 2, 1, 3)
            return g.reshape(ny * nx, 4)

        def pick(row0, col0):
            v = bs[row0::k, col0::k][:ny, :nx]
            return v.reshape(-1)

        return jnp.stack(
            [pick(0, 0), pick(0, 1), pick(1, 0), pick(1, 1)], axis=1
        )
    if ii is None:
        ii = integral_image(plane)
    ox, oy = grid.origins()
    q = [
        _window_sums(ii, ox, oy, half, half),
        _window_sums(ii, ox + half, oy, half, half),
        _window_sums(ii, ox, oy + half, half, half),
        _window_sums(ii, ox + half, oy + half, half, half),
    ]
    return jnp.stack(q, axis=1)
