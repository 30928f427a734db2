"""Quadtree adaptive range partitioning with static shapes.

The reference parses ``--quadtree`` but never implements it
(``/root/reference/main.cpp:75-76``; the flag is dead — SURVEY.md section 2).
This module supplies the real feature, designed for static shapes instead of
recursion:

  * encode EVERY level of the size pyramid (range sizes ``min_size`` ..
    ``max_size``, powers of two) as an independent full uniform grid —
    each level is exactly the single-level search, so either search route
    is reused unchanged;
  * then select per-block depth with a mask cascade: a block is *accepted*
    at the coarsest level where its per-pixel error meets the threshold
    (finest level accepts whatever remains).  Children of accepted blocks
    are masked out by upsampling the ancestor-coverage mask — no tree
    structure ever materializes, just one boolean array per level.

Decode composes per-level decode steps with per-pixel masks: every level
produces a full image (its grid tiles the plane), and the output is the
mask-weighted sum.  L levels cost L gathers of H*W pixels per iteration —
static shapes, no scatter.

Quadrant-split geometry matches ``GridItemBase``'s topLeft/topRight/...
helpers (``image/partition2.hpp:19-30``): each parent splits into 4
half-size children in row-major order.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.classify import classify_grid
from ..core.grid import uniform_grid
from ..core.stats import integral_image
from ..params import DecoderConfig, EncoderConfig
from .codebook import build_codebook, extract_ranges
from .route import resolve_route, run_search

__all__ = ["QuadtreeConfig", "QuadtreeResult", "encode_plane_quadtree",
           "encode_batch_quadtree", "encode_batch_quadtree_stacked",
           "encode_batch_quadtree_sharded",
           "encode_batch_quadtree_sharded_stacked",
           "decode_plane_quadtree", "decode_batch_quadtree_sharded"]


@dataclasses.dataclass(frozen=True)
class QuadtreeConfig:
    min_size: int = 4  # finest range size (BASELINE config 3: range 4..16)
    max_size: int = 16  # coarsest range size
    error_threshold: float = 50.0  # accept level if per-pixel MSE <= this
    domain_ratio: int = 4  # domain = ratio * range per level
    lattice: int = 2  # domain step = domain_size // lattice
    # skip searching blocks already covered by an accepted coarser leaf
    # (bit-identical accepted leaves; False = search every level fully,
    # kept for A/B parity testing)
    mask_covered: bool = True

    def __post_init__(self):
        if self.min_size > self.max_size:
            raise ValueError("min_size > max_size")
        for s in (self.min_size, self.max_size, self.domain_ratio):
            if s & (s - 1):
                raise ValueError("sizes must be powers of two")

    @property
    def level_sizes(self) -> tuple[int, ...]:
        """Coarse -> fine range sizes."""
        sizes = []
        s = self.max_size
        while s >= self.min_size:
            sizes.append(s)
            s //= 2
        return tuple(sizes)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuadtreeLevel:
    """One pyramid level: a full uniform-grid encode + acceptance mask."""

    domain_idx: jnp.ndarray  # [R_l] i32
    transform: jnp.ndarray  # [R_l] i32
    s: jnp.ndarray  # [R_l] f32
    o: jnp.ndarray  # [R_l] f32
    error: jnp.ndarray  # [R_l] f32 per-pixel MSE under the stored map
    accepted: jnp.ndarray  # [R_l] bool — this block is a leaf of the tree

    range_size: int = dataclasses.field(metadata=dict(static=True))
    domain_size: int = dataclasses.field(metadata=dict(static=True))
    domain_step: int = dataclasses.field(metadata=dict(static=True))
    # True when 'o' stores the target block mean and the decoder applies
    # s*(D - mean(D)) + o (the bitstream's mean-centred parameterization;
    # see codec.bitstream.pack_result)
    o_is_mean: bool = dataclasses.field(default=False,
                                        metadata=dict(static=True))
    # isometries the search considered (decode-table width; see EncodeResult)
    num_transforms: int = dataclasses.field(default=8,
                                            metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuadtreeResult:
    levels: list[QuadtreeLevel]
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_leaves(self) -> int:
        return int(sum(int(np.asarray(l.accepted).sum()) for l in self.levels))


def _per_pixel_error(res, k: int, criterion: str, domain_area: int):
    """Convert a search distance to per-pixel MSE units for thresholding."""
    if criterion == "raw":
        # raw distance = sum / domain_area (metrics.h:49); per-pixel = sum / K
        return res.distance * (domain_area / k)
    return res.distance  # affine criterion is already per range pixel


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "range_size", "domain_size", "domain_step"),
)
def _encode_level(plane, plane_f32, cfg: EncoderConfig, range_size: int,
                  domain_size: int, domain_step: int, range_mask=None):
    from ..core.stats import block_sums_nonoverlapping

    h, w = plane.shape
    domain_grid = uniform_grid(w, h, domain_size, domain_step)
    range_grid = uniform_grid(w, h, range_size, range_size)
    if h % 2 == 0 and w % 2 == 0:
        sums2x2 = block_sums_nonoverlapping(plane, 2)
        half = sums2x2.astype(jnp.float32) * 0.25
    else:
        sums2x2 = half = None
    cb = build_codebook(plane_f32, domain_grid, range_size, cfg.num_transforms,
                        half=half)
    ranges = extract_ranges(plane_f32, range_size)
    sum_a = ranges.sum(axis=-1)
    sum_a2 = (ranges * ranges).sum(axis=-1)
    if cfg.use_classifier:
        ii = integral_image(plane)
        dcls = classify_grid(plane, domain_grid, ii=ii, sums2x2=sums2x2)
        rcls = classify_grid(plane, range_grid, ii=ii, sums2x2=sums2x2)
    else:
        dcls = rcls = None
    # on the kernel route the coverage mask (ranges under accepted coarser
    # blocks) is skipped work: masked range tiles visit no column tiles
    res = run_search(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg,
                     range_mask=range_mask)
    err = _per_pixel_error(res, range_size * range_size, cfg.criterion,
                           domain_size * domain_size)
    err = jnp.where(res.valid, err, jnp.inf)
    return res, err


def _upsample_mask(mask2d: jnp.ndarray) -> jnp.ndarray:
    """[ny, nx] bool -> [2ny, 2nx] bool (each parent covers 4 children)."""
    return jnp.repeat(jnp.repeat(mask2d, 2, axis=0), 2, axis=1)


def _encode_quadtree_impl(plane, cfg: EncoderConfig, qcfg: QuadtreeConfig,
                          reporter=None):
    """Per-level encodes + the selection cascade.  Called eagerly it
    dispatches one program per level (real progress boundaries); under
    ``_encode_quadtree_fused`` the whole pyramid is one program."""
    h, w = plane.shape
    plane_f32 = plane.astype(jnp.float32)
    levels = []
    covered = None  # [ny, nx] bool at current level resolution
    sizes = qcfg.level_sizes
    for i, rs in enumerate(sizes):
        ds = rs * qcfg.domain_ratio
        step = ds // qcfg.lattice
        lcfg = dataclasses.replace(cfg, source_size=ds, target_size=rs,
                                   lattice=qcfg.lattice)
        # coverage masking: blocks under an accepted coarser leaf are parked
        # in the empty class bin, so this level's kernel only searches
        # uncovered blocks (at 1024^2 the finest level is 65536 of 86016
        # ranges; typical thresholds cover most of them at 8-16 px)
        range_mask = (
            None if (covered is None or not qcfg.mask_covered)
            else ~covered.reshape(-1)
        )
        res, err = _encode_level(plane, plane_f32, lcfg, rs, ds, step,
                                 range_mask=range_mask)
        ny, nx = h // rs, w // rs
        err2d = err.reshape(ny, nx)
        if covered is None:
            covered = jnp.zeros((ny, nx), bool)
        is_last = i == len(sizes) - 1
        if is_last:
            accept2d = ~covered
        else:
            accept2d = (~covered) & (err2d <= qcfg.error_threshold)
        covered = covered | accept2d
        levels.append(
            QuadtreeLevel(
                domain_idx=res.domain_idx,
                transform=res.transform,
                s=res.s,
                o=res.o,
                error=err,
                accepted=accept2d.reshape(-1),
                range_size=rs,
                domain_size=ds,
                domain_step=step,
                num_transforms=cfg.num_transforms,
            )
        )
        if not is_last:
            covered = _upsample_mask(covered)
        if reporter is not None:
            # per-level progress: the host-visible step boundary of the
            # pyramid (the reference reports from inside its work queue,
            # EncodingEngine2.hpp:138; here each level is one device program)
            reporter.log(i + 1, len(sizes))
    return levels


@functools.partial(jax.jit, static_argnames=("cfg", "qcfg"))
def _encode_quadtree_fused(plane, cfg: EncoderConfig, qcfg: QuadtreeConfig):
    """The whole pyramid (every level + the selection cascade) as ONE device
    program: one dispatch instead of one per level plus a handful of eager
    mask ops."""
    return _encode_quadtree_impl(plane, cfg, qcfg)


def encode_plane_quadtree(plane, cfg: EncoderConfig | None = None,
                          qcfg: QuadtreeConfig | None = None,
                          reporter=None) -> QuadtreeResult:
    """Adaptive-depth encode: coarse blocks where they fit, fine where needed."""
    cfg = cfg or EncoderConfig()
    qcfg = qcfg or QuadtreeConfig()
    plane = jnp.asarray(plane, jnp.uint8)
    h, w = plane.shape
    if h % qcfg.max_size or w % qcfg.max_size:
        raise ValueError("image not aligned to the coarsest range size")
    if reporter is None and resolve_route(cfg) != "pallas_interpret":
        levels = _encode_quadtree_fused(plane, cfg, qcfg)
    else:
        # per-level dispatch: real progress boundaries for the reporter.
        # The interpreted kernel also takes this path: XLA:CPU has aborted
        # compiling the interpreter's expansion of the whole fused pyramid
        # in long-lived test processes, while per-level programs compile
        # cleanly; tests/test_quadtree.py pins fused == per-level.
        levels = _encode_quadtree_impl(plane, cfg, qcfg, reporter=reporter)
    return QuadtreeResult(levels=levels, width=w, height=h)


# ---------------------------------------------------------------------------
# batch / multi-chip quadtree (BASELINE config 3 at scale)


def _level_tuple(l: QuadtreeLevel):
    return (l.domain_idx, l.transform, l.s, l.o, l.error, l.accepted)


def _levels_from_tuples(tuples, sizes, qcfg: QuadtreeConfig, i: int | None,
                        num_transforms: int = 8):
    pick = (lambda x: x) if i is None else (lambda x: x[i])
    out = []
    for rs, t in zip(sizes, tuples):
        ds = rs * qcfg.domain_ratio
        out.append(QuadtreeLevel(
            domain_idx=pick(t[0]), transform=pick(t[1]), s=pick(t[2]),
            o=pick(t[3]), error=pick(t[4]), accepted=pick(t[5]),
            range_size=rs, domain_size=ds, domain_step=ds // qcfg.lattice,
            num_transforms=num_transforms,
        ))
    return out


@functools.partial(jax.jit, static_argnames=("cfg", "qcfg"))
def _encode_batch_quadtree_impl(planes, cfg: EncoderConfig,
                                qcfg: QuadtreeConfig):
    def one(plane):
        levels = _encode_quadtree_impl(plane, cfg, qcfg)
        return tuple(_level_tuple(l) for l in levels)

    # lax.map: frames stream through the per-level searches sequentially in
    # ONE device program (same pattern as encoder.encode_batch)
    return jax.lax.map(one, planes)


def encode_batch_quadtree_stacked(planes, cfg: EncoderConfig | None = None,
                                  qcfg: QuadtreeConfig | None = None
                                  ) -> QuadtreeResult:
    """Quadtree-encode a [B, H, W] u8 batch in one device program and return
    ONE ``QuadtreeResult`` whose level arrays carry a leading batch axis.

    The zero-dispatch form ``encode_batch_quadtree`` slices: per-frame
    slicing is ``6 * levels * B`` tiny device ops of pure host-API
    overhead."""
    cfg = cfg or EncoderConfig()
    qcfg = qcfg or QuadtreeConfig()
    planes = jnp.asarray(planes, jnp.uint8)
    b, h, w = planes.shape
    if h % qcfg.max_size or w % qcfg.max_size:
        raise ValueError("image not aligned to the coarsest range size")
    tuples = _encode_batch_quadtree_impl(planes, cfg, qcfg)
    return QuadtreeResult(
        levels=_levels_from_tuples(tuples, qcfg.level_sizes, qcfg, None,
                                   cfg.num_transforms),
        width=w, height=h,
    )


def encode_batch_quadtree(planes, cfg: EncoderConfig | None = None,
                          qcfg: QuadtreeConfig | None = None
                          ) -> list[QuadtreeResult]:
    """Quadtree-encode a [B, H, W] u8 batch in one device program."""
    stacked = encode_batch_quadtree_stacked(planes, cfg, qcfg)
    b = stacked.levels[0].domain_idx.shape[0]
    return [
        QuadtreeResult(
            levels=[
                dataclasses.replace(
                    l,
                    domain_idx=l.domain_idx[i], transform=l.transform[i],
                    s=l.s[i], o=l.o[i], error=l.error[i],
                    accepted=l.accepted[i],
                )
                for l in stacked.levels
            ],
            width=stacked.width, height=stacked.height,
        )
        for i in range(b)
    ]


@functools.partial(jax.jit, static_argnames=("cfg", "qcfg", "mesh"))
def encode_batch_quadtree_sharded_stacked(planes, cfg: EncoderConfig,
                                          qcfg: QuadtreeConfig, mesh):
    """``encode_batch_quadtree_sharded`` before the per-frame split: one
    6-tuple of [B, R_l] arrays per level, sharded over the 'data' axis."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import DATA_AXIS

    spec = tuple(tuple([P(DATA_AXIS)] * 6) for _ in qcfg.level_sizes)
    return shard_map(
        lambda local: _encode_batch_quadtree_impl(local, cfg, qcfg),
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None),),
        out_specs=spec,
        check_vma=False,
    )(planes)


def encode_batch_quadtree_sharded(planes, cfg: EncoderConfig,
                                  qcfg: QuadtreeConfig, mesh
                                  ) -> list[QuadtreeResult]:
    """Quadtree batch encode data-parallel over the mesh's 'data' axis
    (each device runs the full pyramid on its local frames; no cross-frame
    communication exists to shard)."""
    cfg = cfg or EncoderConfig()
    qcfg = qcfg or QuadtreeConfig()
    planes = jnp.asarray(planes, jnp.uint8)
    b, h, w = planes.shape
    if h % qcfg.max_size or w % qcfg.max_size:
        raise ValueError("image not aligned to the coarsest range size")
    tuples = encode_batch_quadtree_sharded_stacked(planes, cfg, qcfg, mesh)
    return [
        QuadtreeResult(
            levels=_levels_from_tuples(tuples, qcfg.level_sizes, qcfg, i,
                                       cfg.num_transforms),
            width=w, height=h,
        )
        for i in range(b)
    ]


# ---------------------------------------------------------------------------
# decode


def _level_tables(level: QuadtreeLevel, width: int, height: int):
    from ..decode.decoder import build_decode_tables

    return build_decode_tables(
        level.domain_idx, level.transform, width, height,
        level.domain_size, level.range_size, level.domain_step,
        getattr(level, "num_transforms", 8),
    )


def _level_step(img_u8, tables, s, o, height, width, range_size,
                o_is_mean=False):
    """Full-level decode image (same math as the uniform decoder)."""
    from ..decode.decoder import sample_domains

    samp = sample_domains(img_u8, tables)
    if o_is_mean:
        samp = samp - samp.mean(axis=-1, keepdims=True)
    out = s[:, None] * samp + o[:, None]
    out = jnp.floor(jnp.clip(out, 0.0, 255.0))
    ny = height // range_size
    nx = width // range_size
    return (
        out.reshape(ny, nx, range_size, range_size)
        .transpose(0, 2, 1, 3)
        .reshape(height, width)
    )


def _quadtree_step_at(levels, h: int, w: int, f: int):
    """Composite decode step at scale 1/f (f=1 is the full-res step)."""
    from ..decode.decoder import build_decode_tables

    hf, wf = h // f, w // f
    idxs = [
        build_decode_tables(
            l.domain_idx, l.transform, wf, hf, l.domain_size // f,
            l.range_size // f, l.domain_step // f,
            getattr(l, "num_transforms", 8),
        )
        for l in levels
    ]
    pixel_masks = [
        jnp.repeat(
            jnp.repeat(
                l.accepted.reshape(h // l.range_size, w // l.range_size),
                l.range_size // f, axis=0,
            ),
            l.range_size // f, axis=1,
        )
        for l in levels
    ]

    def step(img):
        out = jnp.zeros((hf, wf), jnp.float32)
        for l, idx, pmask in zip(levels, idxs, pixel_masks):
            lvl = _level_step(img, idx, l.s, l.o, hf, wf, l.range_size // f,
                              l.o_is_mean)
            out = jnp.where(pmask, lvl, out)
        return out.astype(jnp.uint8)

    return step


def _pyramid_init_quadtree(levels, h: int, w: int, dcfg: DecoderConfig):
    """Coarse-to-fine start image for the quadtree loop, or None
    (see decode.decoder._pyramid_init — same scheme, composite steps)."""
    from ..decode.decoder import pyramid_factors

    fs = None
    for l in levels:
        lf = pyramid_factors(h, w, l.range_size, l.domain_size, l.domain_step,
                             max_levels=dcfg.pyramid_levels)
        fs = set(lf) if fs is None else fs & set(lf)
    fs = tuple(sorted(fs or (), reverse=True))
    if not fs:
        return None
    img = None
    for i, f in enumerate(fs):
        step_f = _quadtree_step_at(levels, h, w, f)
        if img is None:
            img = jnp.full((h // f, w // f), dcfg.initial_value,
                           dtype=jnp.uint8)
            n = dcfg.pyramid_steps
        else:
            n = dcfg.pyramid_refine_steps
        img = jax.lax.fori_loop(0, n, lambda _, im, s=step_f: s(im), img)
        rep = f // (fs[i + 1] if i + 1 < len(fs) else 1)
        if rep > 1:
            img = jnp.repeat(jnp.repeat(img, rep, axis=0), rep, axis=1)
    return img


def _decode_quadtree_loop(levels, h: int, w: int, dcfg: DecoderConfig):
    """The shared fixed-point loop (single-plane and batch-sharded decode)."""
    step = _quadtree_step_at(levels, h, w, 1)

    if dcfg.pyramid:
        pi = _pyramid_init_quadtree(levels, h, w, dcfg)
        if pi is not None:
            # fixed-count full-res refinement from the near-converged
            # pyramid start (see decode.decoder._decode_core for the
            # measured rationale: PSNR saturates at the floor; any
            # convergence-based continuation pays ~9 extra steps on every
            # natural image because the inter-iterate MSE contracts
            # geometrically forever)
            def fstep(i, carry):
                img, _ = carry
                return step(img), img

            n_full = min(dcfg.pyramid_full_steps, dcfg.max_iterations)
            img0, prev0 = jax.lax.fori_loop(0, n_full, fstep, (pi, pi))
            d0 = img0.astype(jnp.float32) - prev0.astype(jnp.float32)
            mse0 = jnp.sum(d0 * d0) / (h * w)
            return img0, jnp.int32(n_full), mse0

    init = jnp.full((h, w), dcfg.initial_value, dtype=jnp.uint8)
    carry0 = (init, init ^ jnp.uint8(1), jnp.int32(0),
              jnp.float32(jnp.inf), jnp.bool_(False),
              jnp.float32(jnp.inf), jnp.int32(0))

    def cond(c):
        return (c[2] < dcfg.max_iterations) & ~c[4]

    def body(c):
        img, prev, steps, _, _, best, since = c
        nxt = step(img)
        d = nxt.astype(jnp.float32) - img.astype(jnp.float32)
        mse = jnp.sum(d * d) / (h * w)
        # period-2 + stall-window cycle exits; see decode.decoder.decode_plane
        cycle = jnp.all(nxt == prev)
        improved = mse < best * (1.0 - dcfg.stall_rtol)
        since = jnp.where(improved, 0, since + 1)
        best = jnp.minimum(best, mse)
        stalled = (
            since >= dcfg.stall_window if dcfg.stall_window > 0
            else jnp.bool_(False)
        )
        return (nxt, img, steps + 1, mse,
                (mse < dcfg.epsilon) | cycle | stalled, best, since)

    img, _, steps, mse, done, _, _ = jax.lax.while_loop(cond, body, carry0)
    return img, jnp.where(done, steps - 1, steps), mse


@functools.partial(jax.jit, static_argnames=("dcfg",))
def decode_plane_quadtree(result: QuadtreeResult,
                          dcfg: DecoderConfig = DecoderConfig()):
    """Fixed-point decode of a quadtree encode. Returns (u8 image, iters, mse)."""
    return _decode_quadtree_loop(result.levels, result.height, result.width,
                                 dcfg)


@functools.partial(jax.jit, static_argnames=("statics", "mesh", "dcfg",
                                             "h", "w"))
def _decode_batch_quadtree_impl(level_arrays, statics, mesh, dcfg, h, w):
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from ..parallel.mesh import DATA_AXIS

    def body(*local_arrays):
        def one(*arrs):
            levels = [
                QuadtreeLevel(
                    domain_idx=a[0], transform=a[1], s=a[2], o=a[3],
                    error=jnp.zeros_like(a[2]), accepted=a[4],
                    range_size=st[0], domain_size=st[1], domain_step=st[2],
                    o_is_mean=st[3], num_transforms=st[4],
                )
                for a, st in zip(arrs, statics)
            ]
            # carry must carry the data-varying axis (cf. _decode_batch_impl)
            img, steps, mse = _decode_quadtree_loop(levels, h, w, dcfg)
            return img, steps, mse

        return jax.vmap(one)(*local_arrays)

    spec_in = tuple(tuple([P(DATA_AXIS)] * 5) for _ in statics)
    return shard_map(
        body, mesh=mesh,
        in_specs=spec_in,
        out_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )(*level_arrays)


def decode_batch_quadtree_sharded(results: list[QuadtreeResult], mesh,
                                  dcfg: DecoderConfig = DecoderConfig()):
    """Decode a batch of quadtree encodes data-parallel over the mesh's
    'data' axis (the decode-side counterpart of
    ``encode_batch_quadtree_sharded``; per-level geometry is static, the
    acceptance masks ride along as data).

    Returns ([B, H, W] u8 images, [B] iterations, [B] final mse).
    """
    r0 = results[0]
    h, w = r0.height, r0.width
    statics = tuple(
        (l.range_size, l.domain_size, l.domain_step, l.o_is_mean,
         l.num_transforms)
        for l in r0.levels
    )
    level_arrays = tuple(
        (
            jnp.stack([r.levels[li].domain_idx for r in results]),
            jnp.stack([r.levels[li].transform for r in results]),
            jnp.stack([r.levels[li].s for r in results]),
            jnp.stack([r.levels[li].o for r in results]),
            jnp.stack([r.levels[li].accepted for r in results]),
        )
        for li in range(len(r0.levels))
    )
    return _decode_batch_quadtree_impl(level_arrays, statics, mesh, dcfg, h, w)
