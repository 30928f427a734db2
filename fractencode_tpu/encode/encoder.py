"""Plane encoder: the equivalent of ``Frac2::Encoder2``.

Reference pipeline (``/root/reference/encode/Encoder2.hpp:27-45``,
``main.cpp:142-167``): build domain + range grids with preclassified
brightness bins, then fan range blocks out over a thread pool where each
thread linearly scans all domains.  Here the whole search is one jitted
program: codebook build (gathers) -> class computation (prefix sums)
-> all-pairs search on the route encode/route.py chooses (the plain
chunked matmul + argmin, or the Pallas search kernel).

The per-range output arrays play the role of ``grid_encode_data_t``
(``encode/datatypes.h:8-26``).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..core.classify import classify_grid
from ..core.grid import Grid, uniform_grid
from ..core.stats import integral_image
from ..params import EncoderConfig
from .codebook import build_codebook, extract_ranges
from .route import run_search

__all__ = ["EncodeResult", "encode_plane", "encode_stats"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EncodeResult:
    """Encoded plane: per-range transform parameters (the compressed form).

    Range r covers the block at (x, y) = ((r % nx) * ts, (r // nx) * ts)
    where nx = width // target_size — recoverable by index arithmetic, so
    only the match data is stored (cf. ``encode_item_t``, datatypes.h:20-23).
    """

    domain_idx: jnp.ndarray  # [R] i32 row-major domain grid index
    transform: jnp.ndarray  # [R] i32 TransformType
    s: jnp.ndarray  # [R] f32 contrast
    o: jnp.ndarray  # [R] f32 brightness
    distance: jnp.ndarray  # [R] f32 search distance (criterion units)
    valid: jnp.ndarray  # [R] bool

    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    source_size: int = dataclasses.field(metadata=dict(static=True))
    target_size: int = dataclasses.field(metadata=dict(static=True))
    domain_step: int = dataclasses.field(metadata=dict(static=True))
    # When True, ``o`` holds the range block's target mean and the decoder
    # applies the mean-centred map ``s*(D - mean(D)) + o`` instead of
    # ``s*D + o``.  Used by the quantized bitstream: quantization error in a
    # mean adds ~1 gray level, while error in a plain offset is amplified by
    # s times the full pixel magnitude.
    o_is_mean: bool = dataclasses.field(default=False, metadata=dict(static=True))
    # Number of isometries the SEARCH considered: every stored transform id
    # is < num_transforms, so the decoder only materializes that many rows
    # of its gather tables (default 8 = all isometries, always safe; the
    # default search uses 4, halving decode-table work).
    num_transforms: int = dataclasses.field(default=8,
                                            metadata=dict(static=True))

    @property
    def num_ranges(self) -> int:
        return (self.width // self.target_size) * (self.height // self.target_size)

    @property
    def domain_grid(self) -> Grid:
        return uniform_grid(self.width, self.height, self.source_size, self.domain_step)

    @property
    def range_grid(self) -> Grid:
        return uniform_grid(self.width, self.height, self.target_size, self.target_size)

    def domain_origins(self):
        """([R] x, [R] y) i32 global origins of each range's matched domain."""
        nx = self.domain_grid.nx
        ox = (self.domain_idx % nx) * self.domain_step
        oy = (self.domain_idx // nx) * self.domain_step
        return ox, oy


def _normalize_affine(v: jnp.ndarray) -> jnp.ndarray:
    """Remove the components the search's affine map absorbs: zero-mean,
    ~unit-variance rows (variance floor 1 keeps flat blocks at ~0)."""
    mu = v.mean(axis=-1, keepdims=True)
    c = v - mu
    return c * jax.lax.rsqrt((c * c).mean(axis=-1, keepdims=True) + 1.0)


def _vq_classes(ranges: jnp.ndarray, cb, cfg: EncoderConfig):
    """(range_classes, domain_classes) from a learned LBG codebook, in the
    classifier's value convention (the downstream layout shifts by +1, so
    codeword ids 0..N-1 are returned as -1..N-2 -> bins 0..N-1)."""
    from .vq import assign_codes, train_codebook

    dvec = _normalize_affine(cb.values[:, 0, :])  # identity-isometry domains
    rvec = _normalize_affine(ranges)
    key = jax.random.PRNGKey(cfg.vq_seed)
    d = dvec.shape[0]
    limit = cfg.vq_sample_limit if cfg.vq_sample_limit < d else None
    codebook, dcls, _ = train_codebook(
        dvec, key, cfg.vq_classes, sample_limit=limit)
    rcls = assign_codes(rvec, codebook)
    return (rcls - 1).astype(jnp.int32), (dcls - 1).astype(jnp.int32)


def _encode_plane_impl(plane: jnp.ndarray, cfg: EncoderConfig) -> EncodeResult:
    from ..core.stats import block_sums_nonoverlapping

    h, w = plane.shape
    plane_f32 = plane.astype(jnp.float32)
    domain_grid = uniform_grid(w, h, cfg.source_size, cfg.domain_step)
    range_grid = uniform_grid(w, h, cfg.target_size, cfg.target_size)

    # one 2x2 box-sum pass over the image feeds BOTH the codebook's half
    # image (x0.25, exact) and the classifier's quadrant sums
    if h % 2 == 0 and w % 2 == 0:
        sums2x2 = block_sums_nonoverlapping(plane, 2)
        half = sums2x2.astype(jnp.float32) * 0.25
    else:
        sums2x2 = half = None

    cb = build_codebook(plane_f32, domain_grid, cfg.target_size,
                        cfg.num_transforms, half=half)
    ranges = extract_ranges(plane_f32, cfg.target_size)
    sum_a = ranges.sum(axis=-1)
    sum_a2 = (ranges * ranges).sum(axis=-1)

    if cfg.vq_classes > 0:
        # learned pruning: LBG codeword id as the class bin (the purpose
        # the reference built CodebookGenerator for and never wired,
        # CodebookGenerator.hpp:84-162).  Trained on contrast/brightness-
        # normalized vectors so codeword equality approximates SHAPE
        # similarity — the search's affine map absorbs (s, o), so raw-pixel
        # clusters would prune exactly the matches the search can fix up.
        range_classes, domain_classes = _vq_classes(ranges, cb, cfg)
    elif cfg.use_classifier:
        ii = integral_image(plane)
        domain_classes = classify_grid(plane, domain_grid, ii=ii, sums2x2=sums2x2)
        range_classes = classify_grid(plane, range_grid, ii=ii, sums2x2=sums2x2)
    else:
        domain_classes = None
        range_classes = None

    # the search layers branch on use_classifier: force it on when VQ bins
    # stand in for the brightness bins
    cfg_s = (dataclasses.replace(cfg, use_classifier=True)
             if cfg.vq_classes > 0 else cfg)

    res = run_search(ranges, sum_a, sum_a2, cb, range_classes,
                     domain_classes, cfg_s)
    return EncodeResult(
        domain_idx=res.domain_idx,
        transform=res.transform,
        s=res.s,
        o=res.o,
        distance=res.distance,
        valid=res.valid,
        width=w,
        height=h,
        source_size=cfg.source_size,
        target_size=cfg.target_size,
        domain_step=cfg.domain_step,
        num_transforms=cfg.num_transforms,
    )


_encode_plane_jit = jax.jit(_encode_plane_impl, static_argnames=("cfg",))


def encode_plane(plane, cfg: EncoderConfig | None = None) -> EncodeResult:
    """Encode one u8 plane. ``plane`` is [H, W] u8 (numpy or jax array)."""
    cfg = cfg or EncoderConfig()
    plane = jnp.asarray(plane, dtype=jnp.uint8)
    h, w = plane.shape
    if h % cfg.target_size or w % cfg.target_size:
        raise ValueError("image not aligned to range grid")  # partition2.hpp:119
    return _encode_plane_jit(plane, cfg)


def _encode_plane_arrays(plane: jnp.ndarray, cfg: EncoderConfig):
    res = _encode_plane_impl(plane, cfg)
    return (res.domain_idx, res.transform, res.s, res.o, res.distance, res.valid)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _encode_batch_impl(planes: jnp.ndarray, cfg: EncoderConfig):
    # lax.map: frames stream through the search one after another in ONE
    # device program (one dispatch for the whole batch), and only one
    # frame's intermediates are live at a time.  Whether vmap or a deeper
    # batch fills the card better awaits measurement on the H100.
    return jax.lax.map(lambda p: _encode_plane_arrays(p, cfg), planes)


def encode_batch_stacked(planes, cfg: EncoderConfig | None = None) -> EncodeResult:
    """Encode a [B, H, W] u8 batch in one device program; return ONE
    EncodeResult whose arrays carry a leading batch axis ([B, R]).

    This is the zero-dispatch form ``encode_batch`` slices: throughput
    loops should consume the stacked arrays directly — the per-frame
    slicing is 6*B extra device ops of pure host-API overhead."""
    cfg = cfg or EncoderConfig()
    planes = jnp.asarray(planes, jnp.uint8)
    _, h, w = planes.shape
    dom, tr, s, o, dist, valid = _encode_batch_impl(planes, cfg)
    return EncodeResult(
        domain_idx=dom, transform=tr, s=s, o=o, distance=dist, valid=valid,
        width=w, height=h, source_size=cfg.source_size,
        target_size=cfg.target_size, domain_step=cfg.domain_step,
        num_transforms=cfg.num_transforms,
    )


def encode_batch(planes, cfg: EncoderConfig | None = None) -> list[EncodeResult]:
    """Encode a [B, H, W] u8 batch in one device program (frames/s mode)."""
    stacked = encode_batch_stacked(planes, cfg)
    b = stacked.domain_idx.shape[0]
    return [
        jax.tree_util.tree_map(lambda a, i=i: a[i], stacked)
        for i in range(b)
    ]


def encode_stats(result: EncodeResult, range_classes=None, domain_classes=None):
    """Classifier rejection statistics (cf. ``encode_stats_t``,
    ``Encoder2.hpp:17-24``): rejected / total comparisons.

    O(R + D): a pair is rejected iff the class bins differ, so
    ``rejected = R*D - sum_c R_c * D_c`` over the 7 class histograms — never
    materialize the [R, D] comparison matrix (17 GB of host bools at 2048^2).
    """
    import numpy as np

    total = result.num_ranges * result.domain_grid.num_items
    if range_classes is None or domain_classes is None:
        return dict(total_mappings=total, rejected_mappings=0)
    # bins -1..5 -> 0..6
    rh = np.bincount(np.asarray(range_classes).ravel() + 1, minlength=7)
    dh = np.bincount(np.asarray(domain_classes).ravel() + 1, minlength=7)
    rejected = int(total - int((rh.astype(np.int64) * dh.astype(np.int64)).sum()))
    return dict(total_mappings=total, rejected_mappings=rejected)
