"""Domain codebook construction.

The reference re-samples domain pixels on every (range, domain, transform)
comparison through the bilinear sampler (``transformmatcher.h:97,130``).
Design: sample every (domain, isometry) *once per image* into a
dense codebook tensor ``C[D, T, K]`` (K = target_size**2) plus its per-column
sums — this is the "presampled partition" idea the reference abandoned
(``image/partition/presampledpartition.h:8-26``) taken to its conclusion.
The all-pairs search then reduces to one big matmul against ``C`` and
cheap elementwise epilogues.

Values are multiples of 0.25 in [0, 255], exactly representable in f32, so
f32 keeps bit-parity with the reference's float math on the sums that matter.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grid import Grid
from ..core.sampler import all_tap_tables

__all__ = ["Codebook", "build_codebook", "extract_ranges"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Codebook:
    """Sampled domain pool. All arrays are device arrays."""

    values: jnp.ndarray  # [D, T, K] f32 — sampled (domain, isometry) vectors
    sum: jnp.ndarray  # [D, T] f32 — per-vector sums (SumB)
    sum_sq: jnp.ndarray  # [D, T] f32 — per-vector sums of squares (SumB2)
    grid: Grid = dataclasses.field(metadata=dict(static=True))  # domain grid
    # [D, T] f32 guarded 1/var_b, or None (computed lazily).  var_b's
    # cancellation makes its f32 rounding sensitive to compiler fusion
    # choices, so it is computed ONCE here and shared by the jnp oracle and
    # every kernel path — bit-identical ranking keys across backends.
    inv_var: jnp.ndarray | None = None

    def inv_var_or_compute(self) -> jnp.ndarray:
        if self.inv_var is not None:
            return self.inv_var
        from ..ops.rank import inv_var_b

        k = self.values.shape[-1]
        return inv_var_b(self.sum, self.sum_sq, float(k))

    @property
    def num_domains(self) -> int:
        return self.values.shape[0]

    @property
    def num_transforms(self) -> int:
        return self.values.shape[1]


def _block_pixel_offsets(block_size: int, stride: int) -> np.ndarray:
    """[block_size**2] flat image offsets of a block's pixels, row-major."""
    ys, xs = np.mgrid[0:block_size, 0:block_size]
    return (ys * stride + xs).reshape(-1).astype(np.int32)


def build_codebook(
    plane_f32: jnp.ndarray,
    domain_grid: Grid,
    target_size: int,
    num_transforms: int,
    half: jnp.ndarray | None = None,
) -> Codebook:
    """Sample all domain blocks under the first ``num_transforms`` isometries.

    ``plane_f32`` is the [H, W] image as f32 (exact u8 values).

    Fast path: when the geometry is even-aligned (domain origins and sample
    coordinates all even — true for the default and quadtree configs), every
    4-tap average equals one pixel of the 2x2-box half image, so the whole
    codebook is a single gather from the half image (1 tap per entry instead
    of a block gather + 4 tap gathers).  Bit-exact with the general path.
    """
    from ..decode.decoder import _half_res_taps

    h, w = plane_f32.shape
    sw = domain_grid.block_size

    half_taps = _half_res_taps(sw, target_size, w)
    if half_taps is not None and domain_grid.step % 2 == 0:
        taps = half_taps[:num_transforms]  # [T, K] flat offsets (numpy)
        if half is None:
            from ..decode.decoder import half_res_image

            half = half_res_image(plane_f32)
        s2 = domain_grid.step // 2
        ny, nx = domain_grid.ny, domain_grid.nx
        if s2 >= 1:
            # Strided-slice path: tap offsets are static, so entry (t, k) of
            # every domain is one strided slice of the half image — T*K slices
            # (vectorized copies) instead of a [D, T, K] gather (~10ns/elem).
            w2 = w // 2
            t_n, k_n = taps.shape
            planes = []
            for t_i in range(t_n):
                for k_i in range(k_n):
                    dy, dx = divmod(int(taps[t_i, k_i]), w2)
                    v = jax.lax.slice(
                        half,
                        (dy, dx),
                        (dy + (ny - 1) * s2 + 1, dx + (nx - 1) * s2 + 1),
                        (s2, s2),
                    )  # [ny, nx]
                    planes.append(v.reshape(-1))
            values = (
                jnp.stack(planes)  # [T*K, D]
                .reshape(t_n, k_n, ny * nx)
                .transpose(2, 0, 1)
            )
        else:
            ox, oy = domain_grid.origins()
            origin_half = jnp.asarray(
                ((oy.astype(np.int64) // 2) * (w // 2) + ox // 2).astype(np.int32)
            )  # [D]
            values = half.reshape(-1)[
                origin_half[:, None, None] + jnp.asarray(taps)[None]
            ]
    else:
        flat = plane_f32.reshape(-1)
        origins = jnp.asarray(domain_grid.flat_origins(stride=w))  # [D]
        block_pix = jnp.asarray(_block_pixel_offsets(sw, w))  # [sw*sw]
        blocks = flat[origins[:, None] + block_pix[None, :]]  # [D, sw*sw]

        taps = all_tap_tables(sw, target_size)[:num_transforms]  # [T, K, 4]
        # Accumulate the four taps separately to keep the peak intermediate
        # at [D, T, K] instead of [D, T, K, 4].
        acc = blocks[:, jnp.asarray(taps[:, :, 0])]
        for j in range(1, 4):
            acc = acc + blocks[:, jnp.asarray(taps[:, :, j])]
        values = acc * 0.25  # [D, T, K]

    from ..ops.rank import inv_var_b

    sums = values.sum(axis=-1)
    sums_sq = (values * values).sum(axis=-1)
    return Codebook(
        values=values,
        sum=sums,
        sum_sq=sums_sq,
        grid=domain_grid,
        inv_var=inv_var_b(sums, sums_sq, float(target_size * target_size)),
    )


def extract_ranges(plane_f32: jnp.ndarray, target_size: int) -> jnp.ndarray:
    """[R, K] f32 range blocks for the non-overlapping range grid.

    Row-major block order (x fastest) matches ``createUniformGrid``
    (``partition2.hpp:123-133``), so range index r = ry * (W//tw) + rx.

    Lowering: past 8192^2 the reshape-transpose route's [H/tw, tw, W/tw,
    tw] intermediate can be padded by the device layout far beyond its
    logical size, so column k of the output is built with one strided
    slice instead (tw^2 slices, each [H/tw, W/tw], no padded
    intermediate).  Element selection identical.
    """
    h, w = plane_f32.shape
    tw = target_size
    assert h % tw == 0 and w % tw == 0, (h, w, tw)
    if h * w <= (8192 * 8192) or tw > 16:
        x = plane_f32.reshape(h // tw, tw, w // tw, tw)
        return x.transpose(0, 2, 1, 3).reshape(-1, tw * tw)
    cols = [jax.lax.slice(plane_f32, (0, px), (h, w), (1, tw))
            for px in range(tw)]
    return jnp.stack(
        [jax.lax.slice(cols[px], (py, 0), (h, w // tw), (tw, 1)).reshape(-1)
         for py in range(tw) for px in range(tw)],
        axis=1,
    )
