"""Fixed-point PIFS decoder, fully on-device.

Reference semantics (``/root/reference/encode/Encoder2.hpp:60-99``,
``encode/DecodeUtils.hpp:9-25``): start from a flat gray-100 image and
iterate the contractive map set (Jacobi style — every step reads the previous
full image) until the inter-iterate MSE drops below epsilon (default 1e-5) or
300 iterations.  Per range pixel: bilinear-sample the isometry-mapped domain,
apply ``s*v + o``, clamp to [0, 255] and *truncate* to u8
(``DecodeUtils.hpp:23`` uses a static_cast, not a round).

Design: because ranges tile the image exactly, one decode step is a single
batched gather (4 taps per output pixel through precomputed isometry/stride
tables) + an elementwise affine/clamp + a reshape — no scatter needed.
The convergence loop is a ``lax.while_loop`` so the whole decode stays on
device; u8 image state keeps HBM traffic minimal.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.sampler import all_tap_tables
from ..core.transform import NUM_TRANSFORMS
from ..encode.encoder import EncodeResult
from ..params import DecoderConfig

__all__ = ["decode_plane", "decode_batch_stacked", "decode_steps_py"]


@functools.lru_cache(maxsize=None)
def _global_tap_tables(source_size: int, target_size: int, stride: int) -> np.ndarray:
    """[NUM_TRANSFORMS, K, 4] flat *image* offsets of the 4 sample taps for
    every output pixel of a domain block anchored at flat origin 0."""
    local = all_tap_tables(source_size, target_size)  # block-flat, stride=sw
    my, mx = np.divmod(local, source_size)
    return (my.astype(np.int64) * stride + mx).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _half_res_taps(source_size: int, target_size: int, width: int):
    """Half-resolution single-tap tables, or None if the geometry doesn't
    qualify.

    The 4 taps of every sample are the isometry image of an axis-aligned
    2x2 cell; when the cell's min corner is always even (true when the
    source size and all sample coordinates are even), the 4-tap average
    equals one pixel of the 2x2-box-downsampled image.  One gather instead
    of four — the decoder's hot loop is gather-bound.

    Returns [NUM_TRANSFORMS, K] flat indices into the [H/2, W/2] half image
    for a domain anchored at flat half-image origin 0.
    """
    sw = source_size
    if sw % 2:
        return None
    local = all_tap_tables(sw, target_size)  # [T, K, 4] block-flat
    my, mx = np.divmod(local, sw)
    my0 = my.min(axis=2)
    mx0 = mx.min(axis=2)
    # qualify: the 4 taps of each sample must be exactly the 2x2 cell at the
    # (even) min corner
    cell_ok = (
        (my.max(axis=2) == my0 + 1)
        & (mx.max(axis=2) == mx0 + 1)
        & (my0 % 2 == 0)
        & (mx0 % 2 == 0)
    )
    if not cell_ok.all():
        return None
    return ((my0 // 2).astype(np.int64) * (width // 2) + mx0 // 2).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _patch_tap_tables(source_size: int, target_size: int, width: int,
                      max_slices: int = 256):
    """Static tables for the codebook-rows decode path, or None.

    Decomposes the half-res tap set into (a) the distinct local patch
    positions U that any of the 8 isometries samples (each is ONE static
    strided slice over all domain origins at once) and (b) a [T, K] index of
    every (transform, sample) into U.  Qualifies when the half-res geometry
    qualifies and U stays within the slice budget (true for every
    reference-shaped config: 4x4 targets from 16x16 domains need |U| = 64).

    Returns (positions tuple[(dy, dx)], tap_idx [NUM_TRANSFORMS, K] i32).
    """
    taps = _half_res_taps(source_size, target_size, width)
    if taps is None:
        return None
    w2 = width // 2
    ys, xs = np.divmod(taps, w2)  # local patch coords (origin-0 anchor)
    pos = sorted(set(zip(ys.ravel().tolist(), xs.ravel().tolist())))
    if len(pos) > max_slices:
        return None
    index = {p: i for i, p in enumerate(pos)}
    t_n, k_n = taps.shape
    tap_idx = np.array(
        [[index[(int(ys[t, k]), int(xs[t, k]))] for k in range(k_n)]
         for t in range(t_n)],
        np.int32,
    )
    return tuple(pos), tap_idx


def build_decode_tables(domain_idx, transform, width, height, source_size,
                        target_size, domain_step,
                        num_transforms: int = NUM_TRANSFORMS):
    """Gather tables for one map-set application.

    Preferred ("cb"): re-sample the whole (domain, isometry) pool from the
    evolving image with static strided slices — the decode-time analog of the
    encoder's codebook build (``encode/codebook.py``) — and read each range's
    values as ONE contiguous row instead of K scattered taps: K times fewer
    gather indices, the rest vectorized copies.  Its cost on the H100
    against the tap-gather fallbacks awaits measurement.

    Fallbacks: ("half", [R, K] single-tap indices into the half-res image)
    when only the half-res geometry qualifies, else ("full", [R, K, 4]
    indices into the full image).
    """
    nx = (width - source_size) // domain_step + 1
    ox = (domain_idx % nx) * domain_step
    oy = (domain_idx // nx) * domain_step

    if domain_step % 2 == 0 and domain_step >= 2:
        patch = _patch_tap_tables(source_size, target_size, width)
        if patch is not None:
            pos, tap_idx = patch
            # only the isometries the search considered: stored transform
            # ids are < num_transforms, so the per-step [D*T, K] reindex
            # shrinks proportionally (default search: 4 of 8 -> half)
            tap_idx = tap_idx[:num_transforms]
            ny = (height - source_size) // domain_step + 1
            code = domain_idx.astype(jnp.int32) * num_transforms + \
                transform.astype(jnp.int32)
            return "cb", (code, pos, tap_idx, ny, nx, domain_step // 2)

    half = _half_res_taps(source_size, target_size, width)
    if half is not None and domain_step % 2 == 0:
        origin_half = (oy.astype(jnp.int32) // 2) * (width // 2) + ox.astype(jnp.int32) // 2
        return "half", origin_half[:, None] + jnp.asarray(half)[transform]

    taps = jnp.asarray(_global_tap_tables(source_size, target_size, width))
    origin_flat = oy.astype(jnp.int32) * width + ox.astype(jnp.int32)
    return "full", origin_flat[:, None, None] + taps[transform]


def _build_indices(result: EncodeResult):
    return build_decode_tables(
        result.domain_idx, result.transform, result.width, result.height,
        result.source_size, result.target_size, result.domain_step,
        getattr(result, "num_transforms", NUM_TRANSFORMS),
    )


def half_res_image(img_u8: jnp.ndarray) -> jnp.ndarray:
    """[H, W] u8/f32 -> [H/2, W/2] f32 2x2 box averages (multiples of 0.25).

    ``reduce_window`` lowering rather than a reshape-to-[H/2, 2, W/2, 2]
    sum, which splits the minor dimension.  Sums of u8-valued floats are
    exact in f32 in any order, so the two are bit-identical.
    """
    s = jax.lax.reduce_window(
        img_u8.astype(jnp.float32), 0.0, jax.lax.add, (2, 2), (2, 2), "VALID"
    )
    return s * 0.25


def _half_sums_u16(img_u8: jnp.ndarray) -> jnp.ndarray:
    """[H/2, W/2] u16 2x2 box SUMS (4x the half image, <= 1020, exact).

    u8-only contract: the uint16 cast silently truncates fractional or
    negative values, so reject non-integer iterates loudly (decode state is
    always u8; an f32 iterate must go through ``half_res_image`` instead).
    """
    assert jnp.issubdtype(img_u8.dtype, jnp.integer), (
        f"_half_sums_u16 requires an integer (u8) plane, got {img_u8.dtype}"
    )
    return jax.lax.reduce_window(
        img_u8.astype(jnp.uint16), np.uint16(0), jax.lax.add,
        (2, 2), (2, 2), "VALID",
    )


def sample_domains(img_u8, tables):
    """[R, K] f32 sampled (2x2-averaged) domain pixels for every range.

    The pool/gather pipeline runs in u16 quarter-units (2x2 box sums,
    <= 1020): the per-range row gather moves half the bytes of an f32
    pool; the f32 conversion + 0.25 scale after the gather is exact.  Its
    gain on the H100 awaits measurement (ROADMAP Queue 1 item 4).
    """
    kind, idx = tables
    if kind == "cb":
        code, pos, tap_idx, ny, nx, s2 = idx
        half4 = _half_sums_u16(img_u8)
        h2, w2 = half4.shape
        # One slice per distinct patch position: [U, D] pool.  The column
        # stride is hoisted: s2 column-phase images (one column-strided
        # slice each), then every patch slice is row-strided with
        # contiguous columns.  Element selection is identical.  Whether the
        # hoist pays on the H100 awaits measurement.
        planes = []
        if s2 > 1:
            cols = {}
            for dy, dx in pos:
                b = dx % s2
                if b not in cols:
                    cols[b] = jax.lax.slice(half4, (0, b), (h2, w2),
                                            (1, s2))
                y = cols[b]
                c0 = dx // s2
                if c0 + nx > y.shape[1]:  # degenerate geometry: direct slice
                    planes.append(jax.lax.slice(
                        half4, (dy, dx),
                        (dy + (ny - 1) * s2 + 1, dx + (nx - 1) * s2 + 1),
                        (s2, s2)).reshape(-1))
                else:
                    planes.append(jax.lax.slice(
                        y, (dy, c0), (dy + (ny - 1) * s2 + 1, c0 + nx),
                        (s2, 1)).reshape(-1))
        else:
            planes = [
                jax.lax.slice(
                    half4, (dy, dx),
                    (dy + (ny - 1) * s2 + 1, dx + (nx - 1) * s2 + 1),
                    (s2, s2),
                ).reshape(-1)
                for dy, dx in pos
            ]
        base = jnp.stack(planes).T  # [D, U] u16
        t_n, k_n = tap_idx.shape
        # static reindex to the per-(domain, transform) row layout
        vals = base[:, jnp.asarray(tap_idx.reshape(-1))]  # [D, T*K]
        vals = vals.reshape(ny * nx * t_n, k_n)
        # ONE contiguous-row gather per range
        return vals[code].astype(jnp.float32) * 0.25
    if kind == "half":
        return _half_sums_u16(img_u8).reshape(-1)[idx].astype(jnp.float32) * 0.25
    flat = img_u8.astype(jnp.float32).reshape(-1)
    return flat[idx].sum(axis=-1) * 0.25


def _decode_step(img_u8, tables, s, o, height, width, target_size, o_is_mean=False):
    """One application of the full map set: u8 image -> u8 image."""
    samp = sample_domains(img_u8, tables)  # [R, K]
    if o_is_mean:
        samp = samp - samp.mean(axis=-1, keepdims=True)
    out = s[:, None] * samp + o[:, None]
    out = jnp.floor(jnp.clip(out, 0.0, 255.0)).astype(jnp.uint8)
    ny = height // target_size
    nx = width // target_size
    return (
        out.reshape(ny, nx, target_size, target_size)
        .transpose(0, 2, 1, 3)
        .reshape(height, width)
    )


def _mean_init_image(result: EncodeResult, dcfg: DecoderConfig):
    """Piecewise-constant start image from the block-mean fixed point.

    Each range's decoded mean is ~``s*mean(domain) + o`` and (for the
    step%ts == 0 geometries) a domain's mean is exactly the mean of the
    ``(sw/ts)^2`` range blocks it covers — so the block means satisfy their
    own [R]-sized contraction, solved here with a fori_loop of one tiny
    gather+mean per step (~1000x less work per iteration than full-res).
    Returns a [H, W] u8 image, or None when the geometry doesn't qualify.
    """
    h, w = result.height, result.width
    ts = result.target_size
    sw = result.source_size
    step = result.domain_step
    ny, nxr = h // ts, w // ts
    s = jnp.where(result.valid, result.s, 0.0)
    o = jnp.where(result.valid, result.o, 0.0)
    if result.o_is_mean:
        # out = s*(samp - mean) + o => block mean is just o: one shot
        mu = jnp.clip(o, 0.0, 255.0)
    else:
        if step % ts or sw % ts or step == 0:
            return None
        nxd = (w - sw) // step + 1
        kb = sw // ts
        dom = result.domain_idx
        oy = (dom // nxd) * (step // ts)  # domain origin in range-block units
        ox = (dom % nxd) * (step // ts)
        di, dj = np.meshgrid(np.arange(kb), np.arange(kb), indexing="ij")
        offs = (di.reshape(-1) * nxr + dj.reshape(-1)).astype(np.int32)
        gather_idx = (oy * nxr + ox)[:, None] + jnp.asarray(offs)[None, :]

        def body(_, mu):
            dm = mu[gather_idx].mean(axis=1)
            return jnp.clip(s * dm + o, 0.0, 255.0)

        mu0 = jnp.full((ny * nxr,), float(dcfg.initial_value), jnp.float32)
        mu = jax.lax.fori_loop(0, dcfg.mean_init_iters, body, mu0)
    img = jnp.floor(mu).astype(jnp.uint8).reshape(ny, nxr)
    return jnp.repeat(jnp.repeat(img, ts, axis=0), ts, axis=1)


def pyramid_factors(height: int, width: int, target_size: int,
                    source_size: int, domain_step: int,
                    max_levels: int = 2) -> tuple[int, ...]:
    """Static coarse-to-fine scale factors (coarsest first), possibly empty.

    A factor f qualifies when the whole decode geometry divides by f and the
    scaled image still supports the half-res pool build (even dims).  PIFS
    maps are resolution-independent — the same (domain, transform, s, o) set
    is a contraction at every scale — so iterating at H/f costs a fraction
    of a full-res step and lands the full-res loop near its fixed point.
    """
    fs = []
    f = 2
    while (len(fs) < max_levels and target_size % f == 0
           and source_size % f == 0 and domain_step % f == 0
           and height % (2 * f) == 0 and width % (2 * f) == 0
           and source_size // f >= 2 and domain_step // f >= 1):
        fs.append(f)
        f *= 2
    return tuple(reversed(fs))


def _pyramid_init(result: EncodeResult, s, o, dcfg: DecoderConfig):
    """Coarse-to-fine start image for the full-res loop, or None.

    Runs ``pyramid_steps`` fixed-point iterations at the coarsest scale and
    ``pyramid_refine_steps`` at each intermediate scale, upsampling by pixel
    replication between scales.  All scales reuse ``_decode_step`` (the
    scaled geometry routes through the same cb/half/full table builder), so
    per-scale semantics match the reference map application exactly — only
    the resolution differs.
    """
    h, w = result.height, result.width
    ts = result.target_size
    fs = pyramid_factors(h, w, ts, result.source_size, result.domain_step,
                         max_levels=dcfg.pyramid_levels)
    if not fs:
        return None
    nt = getattr(result, "num_transforms", NUM_TRANSFORMS)
    img = None
    for i, f in enumerate(fs):
        hf, wf = h // f, w // f
        tables = build_decode_tables(
            result.domain_idx, result.transform, wf, hf,
            result.source_size // f, ts // f, result.domain_step // f, nt,
        )
        tsf = ts // f

        def stp(im, tables=tables, hf=hf, wf=wf, tsf=tsf):
            return _decode_step(im, tables, s, o, hf, wf, tsf,
                                result.o_is_mean)

        if img is None:
            img = jnp.full((hf, wf), dcfg.initial_value, dtype=jnp.uint8)
            n = dcfg.pyramid_steps
        else:
            n = dcfg.pyramid_refine_steps
        img = jax.lax.fori_loop(0, n, lambda _, im, stp=stp: stp(im), img)
        rep = f // (fs[i + 1] if i + 1 < len(fs) else 1)
        if rep > 1:
            img = jnp.repeat(jnp.repeat(img, rep, axis=0), rep, axis=1)
    return img


def _decode_core(result: EncodeResult, dcfg: DecoderConfig):
    """Traceable decode loop shared by ``decode_plane`` (jitted single
    plane) and ``decode_batch_stacked`` (lax.map over frames)."""
    h, w = result.height, result.width
    idx = _build_indices(result)
    s = jnp.where(result.valid, result.s, 0.0)
    o = jnp.where(result.valid, result.o, 0.0)
    step = lambda img: _decode_step(
        img, idx, s, o, h, w, result.target_size, result.o_is_mean
    )

    init = jnp.full((h, w), dcfg.initial_value, dtype=jnp.uint8)
    if dcfg.initial == "means":
        mi = _mean_init_image(result, dcfg)
        if mi is not None:
            init = mi
    if dcfg.pyramid:
        pi = _pyramid_init(result, s, o, dcfg)
        if pi is not None:
            # Fixed-count full-res refinement.  Measured
            # (measured on PSNR): PSNR saturates at 4-5 steps
            # from the pyramid start on natural content, while the
            # inter-iterate MSE keeps contracting geometrically (ratio
            # ~0.5-0.85/step) essentially forever — so NO stall margin can
            # tell the PSNR-irrelevant tail from real refinement, and any
            # continuation pays ~9 extra steps on every natural image.
            # The one measured case that iterates usefully past the floor
            # is knife-edge synthetic content (pure ramps) whose
            # pre-truncation values sit exactly on integer boundaries;
            # there the u8 fixed point is non-unique anyway and the
            # pyramid may land on a +-1-gray alternate rendering of the
            # flat path's (tests/test_roundtrip.py content matrix).
            # ``pyramid=False`` remains the fully-converged mode.
            def fstep(i, carry):
                img, _ = carry
                return step(img), img

            # honor an explicit iteration cap (--decode N) below the floor
            n_full = min(dcfg.pyramid_full_steps, dcfg.max_iterations)
            img0, prev0 = jax.lax.fori_loop(0, n_full, fstep, (pi, pi))
            d0 = img0.astype(jnp.float32) - prev0.astype(jnp.float32)
            mse0 = jnp.sum(d0 * d0) / (h * w)
            return img0, jnp.int32(n_full), mse0

    # prev starts unequal to any first iterate (init ^ 1 flips every pixel)
    carry0 = (init, init ^ jnp.uint8(1), jnp.int32(0),
              jnp.float32(jnp.inf), jnp.bool_(False),
              jnp.float32(jnp.inf), jnp.int32(0))

    def cond(carry):
        img, prev, steps, mse, done, best, since = carry
        return (steps < dcfg.max_iterations) & ~done

    def body(carry):
        img, prev, steps, _, _, best, since = carry
        nxt = step(img)
        d = nxt.astype(jnp.float32) - img.astype(jnp.float32)
        mse = jnp.sum(d * d) / (h * w)
        # u8 truncation can trap the iteration in an exact period-2 cycle
        # (a few pixels flip-flopping by +-1 forever; the reference would
        # spin to max_iterations too, Encoder2.hpp:76-87).  Detect it by
        # comparing with the iterate from two steps back and stop — either
        # cycle state is a valid fixed-point rendering.
        cycle = jnp.all(nxt == prev)
        # longer/chaotic cycles never repeat two steps apart; they show up
        # as the MSE flickering at a floor instead.  A genuine contraction
        # shrinks the MSE by a material relative margin each step; orbit
        # noise produces sub-percent "new minima" which must NOT reset the
        # patience (see DecoderConfig.stall_rtol).
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
    iterations = jnp.where(done, steps - 1, steps)
    return img, iterations, mse


@functools.partial(jax.jit, static_argnames=("dcfg",))
def decode_plane(result: EncodeResult, dcfg: DecoderConfig = DecoderConfig()):
    """Decode to a fixed point. Returns (plane u8 [H, W], iterations, mse).

    ``iterations`` follows the reference's count (loop index at exit:
    ``Encoder2.hpp:76-88``).
    """
    return _decode_core(result, dcfg)


@functools.partial(jax.jit, static_argnames=("dcfg",))
def decode_batch_stacked(result: EncodeResult,
                         dcfg: DecoderConfig = DecoderConfig()):
    """Decode a stacked batch (arrays carry a leading [B] axis, as produced
    by ``encode_batch_stacked``) in ONE device program.

    The single-chip decode lane of BASELINE config 5 (the consumer loop of
    ``Encoder2.hpp:67-89`` at rate): frames stream through the fixed-point
    loop sequentially via ``lax.map`` — one dispatch for the whole batch,
    the per-dispatch floor amortizes across B frames, and only one frame's
    pool is live at a time.  Returns ([B, H, W] u8, [B] iterations, [B] mse).
    """
    import dataclasses

    def one(arrs):
        dom, tr, s, o, valid = arrs
        r1 = dataclasses.replace(
            result, domain_idx=dom, transform=tr, s=s, o=o,
            distance=jnp.zeros_like(s), valid=valid,
        )
        return _decode_core(r1, dcfg)

    return jax.lax.map(one, (result.domain_idx, result.transform,
                             result.s, result.o, result.valid))


def decode_steps_py(result: EncodeResult, dcfg: DecoderConfig = DecoderConfig(),
                    reporter=None):
    """Python-loop decode yielding every iterate (for --debug_decode dumps,
    cf. ``Encoder2.hpp:74-82``). Yields (step_index, u8 image)."""
    h, w = result.height, result.width
    idx = _build_indices(result)
    s = jnp.where(result.valid, result.s, 0.0)
    o = jnp.where(result.valid, result.o, 0.0)
    step = jax.jit(
        lambda img: _decode_step(
            img, idx, s, o, h, w, result.target_size, result.o_is_mean
        )
    )
    img = jnp.full((h, w), dcfg.initial_value, dtype=jnp.uint8)
    yield 0, img
    for i in range(dcfg.max_iterations):
        nxt = step(img)
        d = np.asarray(nxt, dtype=np.float32) - np.asarray(img, dtype=np.float32)
        mse = float((d * d).sum()) / (h * w)
        if reporter is not None:
            reporter.log(i + 1, dcfg.max_iterations)
        yield i + 1, nxt
        if mse < dcfg.epsilon:
            if reporter is not None:
                reporter.log(dcfg.max_iterations, dcfg.max_iterations)
            return
        img = nxt
