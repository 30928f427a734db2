"""Multi-chip sharded encode/decode via ``shard_map``.

Replaces the reference's single-host thread pool (SURVEY.md section 2,
"Parallelism & communication inventory") with mesh sharding:

  * ``data`` axis — independent images; embarrassingly parallel (the
    multi-image batch of BASELINE config 5).
  * ``search`` axis, three strategies for one image:
      - **range sharding** (default): each device owns a contiguous slice of
        the range blocks and the full domain codebook (built locally from the
        replicated plane — compute is duplicated but tiny next to the search
        matmul).  No communication at all in the hot loop; results come back
        naturally sharded.  This is the "replicate the codebook" strategy for
        images whose codebook fits HBM.
      - **domain sharding**: each device builds only ITS row-band of the
        domain codebook (O(codebook/n) build memory), scores ALL ranges
        against it, and the global winner is reduced with an
        argmax-allreduce on the rank key (``all_gather`` of the
        per-shard (q, winner) pairs + composite argmax).
      - **ring streaming**: each device builds its codebook row-band once and
        the shards then rotate around the ring (``ppermute``), visiting every
        device — ring-attention over the domain axis.  Peak codebook memory
        stays O(codebook/n) per device for the WHOLE search, the pattern
        BASELINE.json's north star requires for codebooks too big to
        replicate (4K+ images).

All cross-shard winner reduction compares the MAXIMIZED rank key ``q``
(``SearchResult.key``), not the distance: distances saturate (the 'ls'
criterion clamps at 0 on flat ranges) so distance ties can hide key
differences, and only the key reproduces the single-device first-occurrence
tie-break bitwise.  Global tie-break = lowest global search-order column,
exactly the reference's domain-ascending/transform-descending rule.

Everything runs under one ``jax.jit`` so XLA overlaps collectives with
compute.  XLA hands the collectives to NCCL; the cards of one host are
joined all to all by NVLink, so the mesh follows the algorithm alone and no
axis is laid out for a ring or torus topology.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core.classify import classify_grid
from ..core.grid import uniform_grid
from ..core.stats import integral_image
from ..encode.codebook import build_codebook, extract_ranges
from ..encode.encoder import EncodeResult
from ..encode.matcher import SearchResult, _BIG
from ..encode.route import resolve_route, run_search
from ..params import EncoderConfig
from .mesh import DATA_AXIS, SEARCH_AXIS

__all__ = [
    "encode_batch_sharded",
    "decode_batch_sharded",
    "encode_plane_sharded_image",
    "STRATEGIES",
]

STRATEGIES = ("ranges", "domains", "ring")


def _use_kernel(cfg: EncoderConfig) -> bool:
    # per-image bodies go through lax.map on the kernel route (one kernel
    # launch per frame) and through vmap on the plain route
    return resolve_route(cfg) != "jnp"


def _plane_search_arrays(plane, cfg: EncoderConfig, r_lo: int, r_count: int):
    """Search a contiguous slice [r_lo, r_lo + r_count) of the range blocks
    of one plane. Static slice bounds — used per search-shard."""
    h, w = plane.shape
    plane_f32 = plane.astype(jnp.float32)
    domain_grid = uniform_grid(w, h, cfg.source_size, cfg.domain_step)
    range_grid = uniform_grid(w, h, cfg.target_size, cfg.target_size)

    cb = build_codebook(plane_f32, domain_grid, cfg.target_size, cfg.num_transforms)
    ranges = jax.lax.dynamic_slice_in_dim(
        extract_ranges(plane_f32, cfg.target_size), r_lo, r_count, axis=0
    )
    sum_a = ranges.sum(axis=-1)
    sum_a2 = (ranges * ranges).sum(axis=-1)

    if cfg.use_classifier:
        ii = integral_image(plane)
        domain_classes = classify_grid(plane, domain_grid, ii=ii)
        range_classes = jax.lax.dynamic_slice_in_dim(
            classify_grid(plane, range_grid, ii=ii), r_lo, r_count, axis=0
        )
    else:
        domain_classes = None
        range_classes = None

    return run_search(ranges, sum_a, sum_a2, cb, range_classes,
                      domain_classes, cfg)


def _result_tuple(res: SearchResult):
    return (res.domain_idx, res.transform, res.s, res.o, res.distance, res.valid)


# ---------------------------------------------------------------------------
# domain-band machinery shared by the 'domains' and 'ring' strategies


def _band_statics(h: int, w: int, cfg: EncoderConfig, n: int):
    """Static geometry of the per-device domain row-band decomposition."""
    sw = cfg.source_size
    step = cfg.domain_step
    grid = uniform_grid(w, h, sw, step)
    ny, nx = grid.ny, grid.nx
    rows_per = -(-ny // n)  # ceil: every device owns the same band height
    band_h = (rows_per - 1) * step + sw
    pad_h = max(0, (n - 1) * rows_per * step + band_h - h)
    d_local = rows_per * nx
    return grid, ny, nx, rows_per, band_h, pad_h, d_local


def _local_band_codebook(plane, cfg: EncoderConfig, shard: jnp.ndarray,
                         statics):
    """Build the codebook + classes for domain rows [shard*rows_per, ...)
    from the (replicated) plane — each device materializes only O(D/n)
    codebook entries (build_codebook of the band, never of the full grid).

    Returns (cb_local, dcls_local [d_local] i32 or None,
    domain_mask [d_local] bool)."""
    grid, ny, nx, rows_per, band_h, pad_h, d_local = statics
    h, w = plane.shape
    step = cfg.domain_step
    plane_pad = jnp.pad(plane, ((0, pad_h), (0, 0)))
    band = jax.lax.dynamic_slice_in_dim(plane_pad, shard * (rows_per * step),
                                        band_h, axis=0)
    local_grid = uniform_grid(w, band_h, cfg.source_size, step)
    assert local_grid.ny == rows_per, (local_grid.ny, rows_per)
    cb_local = build_codebook(band.astype(jnp.float32), local_grid,
                              cfg.target_size, cfg.num_transforms)
    if cfg.use_classifier:
        dcls_local = classify_grid(band, local_grid)
    else:
        dcls_local = None
    local_rows = shard * rows_per + jnp.arange(d_local) // nx
    domain_mask = local_rows < ny
    return cb_local, dcls_local, domain_mask


def _range_arrays(plane, cfg: EncoderConfig):
    plane_f32 = plane.astype(jnp.float32)
    ranges = extract_ranges(plane_f32, cfg.target_size)
    sum_a = ranges.sum(axis=-1)
    sum_a2 = (ranges * ranges).sum(axis=-1)
    if cfg.use_classifier:
        h, w = plane.shape
        range_grid = uniform_grid(w, h, cfg.target_size, cfg.target_size)
        rcls = classify_grid(plane, range_grid)
    else:
        rcls = None
    return ranges, sum_a, sum_a2, rcls


def _local_m(res: SearchResult, t: int):
    """Search-order column of the winner within its shard:
    m = d*T + (T-1-t) (see ops/search_kernel.py)."""
    return res.domain_idx * t + (t - 1) - res.transform


def _acc_empty(r: int):
    """(key, col, dist, s, o, valid) running-winner accumulator."""
    return (
        jnp.full((r,), -_BIG, jnp.float32),
        jnp.zeros((r,), jnp.int32),
        jnp.full((r,), _BIG, jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), bool),
    )


def _acc_update(acc, res: SearchResult, gcol, gate=None):
    """Fold one shard's result into the accumulator with the global
    first-occurrence rule: higher key wins; equal keys -> lower global
    column wins (exact f32 equality: both sides are the same deterministic
    kernel expression).  ``gate`` (optional bool [R]) blocks updates."""
    bq, bcol, bdist, bs, bo, bvalid = acc
    better = (res.key > bq) | ((res.key == bq) & (gcol < bcol))
    if gate is not None:
        better = better & gate
    upd = lambda new, old: jnp.where(better, new, old)
    return (upd(res.key, bq), upd(gcol, bcol), upd(res.distance, bdist),
            upd(res.s, bs), upd(res.o, bo), upd(res.valid, bvalid))


def _acc_merge(x, y):
    """Composite-best of two accumulators (same (key, col) rule)."""
    xq, xcol = x[0], x[1]
    yq, ycol = y[0], y[1]
    better = (yq > xq) | ((yq == xq) & (ycol < xcol))
    return tuple(jnp.where(better, b, a) for a, b in zip(x, y))


def _ring_search(ranges, sum_a, sum_a2, rcls, cb_local, dcls_local, idx,
                 cfg: EncoderConfig, *, n: int, t_n: int, rows_per: int,
                 nx: int, ny: int, d_local: int):
    """Ring-streamed codebook search: the local shard rotates around the device
    ring (``ppermute``) past the resident ranges; the carry keeps the running
    (rank key, global column) winner with the single-device first-occurrence
    tie-break.  Peak codebook memory stays O(codebook/n) per device for the
    whole search.  Shard ``s`` owns domain rows [s*rows_per, ...), so its
    global search-order columns start at s*d_local*t_n.

    The ring rotates so device ``idx`` visits shards idx, idx+1, ..., n-1,
    0, ..., idx-1 — two runs that are each ASCENDING in global column order.
    The early-accept frontier (TransformEstimator2.hpp:40-41; live at every
    threshold, since an exact fit stops the scan even at rms_threshold 0)
    needs the global scan order, so the two runs keep separate
    accumulators, each frozen at its own first hit shard (group B = shards
    < idx holds the globally FIRST columns): the winner is B's frozen best
    when B hit, else composite(B, frozen A).

    Returns the 6-tuple (domain, transform, s, o, distance, valid)."""
    m_local = d_local * t_n
    # shard held by device i moves to device i-1 => device idx holds shard
    # (idx + hop) % n: ascending visit order from idx
    perm = [(i, (i - 1) % n) for i in range(n)]
    r = ranges.shape[0]
    if dcls_local is None:
        # carry needs static structure; use a zero placeholder
        dcls_c = jnp.zeros((d_local,), jnp.int32)
    else:
        dcls_c = dcls_local

    def hop(hi, carry):
        (acc_a, acc_b, frz_a, frz_b, vals, sums, sums2, ivar, dc) = carry
        src = (idx + hi) % n  # shard we currently hold
        cb_h = type(cb_local)(values=vals, sum=sums, sum_sq=sums2,
                              grid=cb_local.grid, inv_var=ivar)
        local_rows = src * rows_per + jnp.arange(d_local) // nx
        dmask = local_rows < ny
        res = run_search(ranges, sum_a, sum_a2, cb_h, rcls,
                         dc if cfg.use_classifier else None,
                         cfg, domain_mask=dmask)
        gcol = src * m_local + _local_m(res, t_n)
        in_b = src < idx  # traced scalar; group B = globally-first shards
        hit = res.valid & (res.distance <= cfg.rms_threshold)
        acc_a = _acc_update(acc_a, res, gcol, gate=(~in_b) & ~frz_a)
        acc_b = _acc_update(acc_b, res, gcol, gate=in_b & ~frz_b)
        frz_a = frz_a | ((~in_b) & hit)
        frz_b = frz_b | (in_b & hit)
        return (
            acc_a, acc_b, frz_a, frz_b,
            # rotate the shard to the next device of the ring
            jax.lax.ppermute(vals, SEARCH_AXIS, perm),
            jax.lax.ppermute(sums, SEARCH_AXIS, perm),
            jax.lax.ppermute(sums2, SEARCH_AXIS, perm),
            jax.lax.ppermute(ivar, SEARCH_AXIS, perm),
            jax.lax.ppermute(dc, SEARCH_AXIS, perm),
        )

    init = (
        _acc_empty(r), _acc_empty(r),
        jnp.zeros((r,), bool), jnp.zeros((r,), bool),
        cb_local.values, cb_local.sum, cb_local.sum_sq,
        cb_local.inv_var_or_compute(), dcls_c,
    )
    acc_a, acc_b, frz_a, frz_b, *_ = jax.lax.fori_loop(0, n, hop, init)
    # group B's columns all precede group A's: if B froze, the reference
    # scan never reaches A at all
    merged = _acc_merge(acc_b, acc_a)
    bq, bcol, bdist, bs, bo, bvalid = (
        jnp.where(frz_b, b, m) for b, m in zip(acc_b, merged))
    # fully-rejected ranges never update the carry: bcol stays 0, which
    # decodes to (domain 0, transform T-1) — exactly the single-device
    # argmin's first-column fallback
    g_dom = bcol // t_n
    g_tr = (t_n - 1) - (bcol % t_n)
    bs = jnp.where(bvalid, bs, 0.0)
    bo = jnp.where(bvalid, bo, 0.0)
    return (
        g_dom.astype(jnp.int32),
        g_tr.astype(jnp.int32),
        bs, bo,
        jnp.where(bvalid, bdist, _BIG),
        bvalid,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "strategy"))
def _encode_batch_impl(planes, cfg: EncoderConfig, mesh: Mesh, strategy: str):
    b, h, w = planes.shape
    n_search = mesh.shape[SEARCH_AXIS]
    num_ranges = (h // cfg.target_size) * (w // cfg.target_size)
    t_n = cfg.num_transforms

    if strategy == "ranges":
        assert num_ranges % n_search == 0, (num_ranges, n_search)
        r_per = num_ranges // n_search

        def body(planes_local):
            # planes_local: [B/nd, H, W]; this device owns range slice
            # [idx*r_per, (idx+1)*r_per) of every local image.
            idx = jax.lax.axis_index(SEARCH_AXIS)
            r_lo = idx * r_per

            def one(plane):
                return _result_tuple(_plane_search_arrays(plane, cfg, r_lo, r_per))

            if _use_kernel(cfg):
                # stream local images through the kernel sequentially, the
                # same pattern as encode_batch
                return jax.lax.map(one, planes_local)
            return jax.vmap(one)(planes_local)

        out_spec = tuple([P(DATA_AXIS, SEARCH_AXIS)] * 6)
        # check_vma=False: pallas_call can't declare varying-axes metadata on
        # its outputs, so the analysis can't type the kernel-route body.
        outs = shard_map(
            body,
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None, None),),
            out_specs=out_spec,
            check_vma=False,
        )(planes)

    elif strategy == "domains":
        statics = _band_statics(h, w, cfg, n_search)
        d_local = statics[-1]
        m_local = d_local * t_n

        def body(planes_local):
            idx = jax.lax.axis_index(SEARCH_AXIS)

            def one(plane):
                # this device's codebook row-band only: O(D/n) build memory
                cb, dcls, dmask = _local_band_codebook(plane, cfg, idx, statics)
                ranges, sum_a, sum_a2, rcls = _range_arrays(plane, cfg)
                local = run_search(ranges, sum_a, sum_a2, cb, rcls, dcls,
                                   cfg, domain_mask=dmask)

                # ---- argmax-allreduce on the rank key ----
                # per-shard (q, winner); global winner = max q, ties to the
                # lowest shard (shards hold ascending global columns, and the
                # in-shard winner is already the first occurrence).
                qs = jax.lax.all_gather(local.key, SEARCH_AXIS)  # [S, R]
                # early accept across shards (at every threshold: an exact
                # fit stops the scan even at rms_threshold 0): a shard has a
                # hit iff its frozen local best is under threshold (freezing
                # happens exactly when a hit occurs).  Shards hold
                # contiguous ascending column slabs, so the reference scan
                # never reaches shards PAST the first one with a hit — mask
                # them out of the argmax.
                hits = jax.lax.all_gather(
                    local.valid & (local.distance <= cfg.rms_threshold),
                    SEARCH_AXIS,
                )  # [S, R]
                any_hit = hits.any(axis=0)
                s_star = jnp.argmax(hits, axis=0)  # first hit shard
                sid = jnp.arange(n_search, dtype=jnp.int32)[:, None]
                beyond = any_hit[None, :] & (sid > s_star[None, :])
                qs = jnp.where(beyond, -_BIG, qs)
                winner = jnp.argmax(qs, axis=0)  # first (lowest shard) on ties
                sel = lambda x: jax.lax.all_gather(x, SEARCH_AXIS)[
                    winner, jnp.arange(num_ranges)
                ]
                g_dom = sel(local.domain_idx) + winner * d_local
                valid = sel(local.valid)
                return (
                    jnp.where(valid, g_dom, 0).astype(jnp.int32),
                    sel(local.transform),
                    sel(local.s),
                    sel(local.o),
                    sel(local.distance),
                    valid,
                )

            if _use_kernel(cfg):
                return jax.lax.map(one, planes_local)
            return jax.vmap(one)(planes_local)

        out_spec = tuple([P(DATA_AXIS, None)] * 6)
        # check_vma=False: after the all_gather + argmax-allreduce the outputs
        # ARE replicated over 'search', but the varying-axes analysis cannot
        # prove it statically (and the kernel-route body can't be typed).
        outs = shard_map(
            body,
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None, None),),
            out_specs=out_spec,
            check_vma=False,
        )(planes)

    elif strategy == "ring":
        statics = _band_statics(h, w, cfg, n_search)

        def body(planes_local):
            idx = jax.lax.axis_index(SEARCH_AXIS)

            def one(plane):
                # Build this device's shard ONCE; shards then rotate around
                # the ring past the resident ranges (ring attention over the
                # domain-codebook axis): peak codebook memory is O(D/n) per
                # device for the whole search — the "too big to replicate"
                # case of SURVEY.md section 5.
                cb, dcls, _ = _local_band_codebook(plane, cfg, idx, statics)
                ranges, sum_a, sum_a2, rcls = _range_arrays(plane, cfg)
                return _ring_search(ranges, sum_a, sum_a2, rcls, cb, dcls,
                                    idx, cfg, n=n_search, t_n=t_n,
                                    rows_per=statics[3], nx=statics[2],
                                    ny=statics[1], d_local=statics[-1])

            if _use_kernel(cfg):
                return jax.lax.map(one, planes_local)
            return jax.vmap(one)(planes_local)

        out_spec = tuple([P(DATA_AXIS, None)] * 6)
        outs = shard_map(
            body,
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None, None),),
            out_specs=out_spec,
            check_vma=False,
        )(planes)
    else:
        raise ValueError(f"unknown strategy {strategy}; want one of {STRATEGIES}")

    dom, tr, s, o, dist, valid = outs
    return dom, tr, s, o, dist, valid


def encode_batch_sharded(
    planes,
    cfg: EncoderConfig,
    mesh: Mesh,
    strategy: str = "ranges",
) -> list[EncodeResult]:
    """Encode a batch of [B, H, W] u8 planes across the mesh.

    Returns one EncodeResult per image (arrays remain device-sharded until
    consumed).
    """
    planes = jnp.asarray(planes, jnp.uint8)
    b, h, w = planes.shape
    dom, tr, s, o, dist, valid = _encode_batch_impl(planes, cfg, mesh, strategy)
    return [
        EncodeResult(
            domain_idx=dom[i],
            transform=tr[i],
            s=s[i],
            o=o[i],
            distance=dist[i],
            valid=valid[i],
            width=w,
            height=h,
            source_size=cfg.source_size,
            target_size=cfg.target_size,
            domain_step=cfg.domain_step,
            num_transforms=cfg.num_transforms,
        )
        for i in range(b)
    ]


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "codebook"))
def _encode_sharded_image_impl(plane, cfg: EncoderConfig, mesh: Mesh,
                               codebook: str = "replicate"):
    h, w = plane.shape
    n = mesh.shape[SEARCH_AXIS]
    hs = h // n  # rows per device
    sw = cfg.source_size
    step = cfg.domain_step
    halo = sw - step  # rows a device needs from its southern neighbour
    assert hs % step == 0 and hs % cfg.target_size == 0, (hs, step)
    assert hs >= sw, "shard must be at least one domain tall"

    domain_grid_global = uniform_grid(w, h, sw, step)
    ny_global = domain_grid_global.ny
    nx = domain_grid_global.nx
    rows_per_dev = hs // step  # domain rows anchored in each shard
    d_local = rows_per_dev * nx

    def body(plane_local):
        """plane_local: [hs, W] — this device's contiguous row band.

        Halo exchange: domains whose origin row is near the south edge read
        ``sw - step`` rows owned by the next device — fetched with a ring
        ppermute (the reference never needed this: one address
        space; SURVEY.md section 2 maps it to the 2048^2+ configs)."""
        idx = jax.lax.axis_index(SEARCH_AXIS)
        top_rows = jax.lax.ppermute(
            plane_local[:halo],
            SEARCH_AXIS,
            perm=[((i + 1) % n, i) for i in range(n)],  # south -> north
        )
        ext = jnp.concatenate([plane_local, top_rows], axis=0)  # [hs+halo, W]
        ext_f32 = ext.astype(jnp.float32)

        # local codebook over this band's domain rows (static count; the last
        # device's rows that fall off the image are masked invalid below)
        local_grid = uniform_grid(w, hs + halo, sw, step)
        assert local_grid.ny == rows_per_dev, (local_grid.ny, rows_per_dev)
        cb_local = build_codebook(ext_f32, local_grid, cfg.target_size,
                                  cfg.num_transforms)

        if codebook == "ring":
            # ring-streamed codebook shards (the 4K+ "too big to replicate"
            # variant of config 4): O(codebook/n) peak memory, shards rotate
            # past this device's resident range band
            ranges = extract_ranges(plane_local.astype(jnp.float32),
                                    cfg.target_size)
            sum_a = ranges.sum(axis=-1)
            sum_a2 = (ranges * ranges).sum(axis=-1)
            if cfg.use_classifier:
                dcls_local = classify_grid(ext, local_grid)
                range_grid = uniform_grid(w, hs, cfg.target_size,
                                          cfg.target_size)
                rcls = classify_grid(plane_local, range_grid)
            else:
                dcls_local = rcls = None
            return _ring_search(
                ranges, sum_a, sum_a2, rcls, cb_local, dcls_local, idx, cfg,
                n=n, t_n=cfg.num_transforms, rows_per=rows_per_dev, nx=nx,
                ny=ny_global, d_local=d_local,
            )

        # replicate the codebook: all_gather; device-major concat ==
        # global row-major domain order because bands are contiguous rows
        vals = jax.lax.all_gather(cb_local.values, SEARCH_AXIS)
        sums = jax.lax.all_gather(cb_local.sum, SEARCH_AXIS)
        sums2 = jax.lax.all_gather(cb_local.sum_sq, SEARCH_AXIS)
        ivar = jax.lax.all_gather(cb_local.inv_var_or_compute(), SEARCH_AXIS)
        d_total = n * d_local
        cb = type(cb_local)(
            values=vals.reshape(d_total, *cb_local.values.shape[1:]),
            sum=sums.reshape(d_total, *cb_local.sum.shape[1:]),
            sum_sq=sums2.reshape(d_total, *cb_local.sum_sq.shape[1:]),
            grid=domain_grid_global,
            inv_var=ivar.reshape(d_total, *cb_local.sum.shape[1:]),
        )
        global_row = jnp.arange(d_total) // nx
        domain_mask = global_row < ny_global

        ranges = extract_ranges(plane_local.astype(jnp.float32), cfg.target_size)
        sum_a = ranges.sum(axis=-1)
        sum_a2 = (ranges * ranges).sum(axis=-1)

        if cfg.use_classifier:
            ii = integral_image(ext)
            dcls_local = classify_grid(ext, local_grid, ii=ii)
            dcls = jax.lax.all_gather(dcls_local, SEARCH_AXIS).reshape(d_total)
            range_grid = uniform_grid(w, hs, cfg.target_size, cfg.target_size)
            rcls = classify_grid(plane_local, range_grid,
                                 ii=integral_image(plane_local))
        else:
            dcls = None
            rcls = None

        res = run_search(ranges, sum_a, sum_a2, cb, rcls, dcls, cfg,
                         domain_mask=domain_mask)
        return _result_tuple(res)

    out_spec = tuple([P(SEARCH_AXIS)] * 6)
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SEARCH_AXIS, None),),
        out_specs=out_spec,
        check_vma=False,
    )(plane)


def encode_plane_sharded_image(plane, cfg: EncoderConfig, mesh: Mesh,
                               codebook: str = "replicate") -> EncodeResult:
    """Encode ONE large plane with the image itself sharded by rows across
    the 'search' axis: halo exchange for boundary domains, then either a
    codebook all_gather (``codebook='replicate'``, fits-in-HBM case) or
    ring-streamed codebook shards (``codebook='ring'``, O(codebook/n) peak
    memory — BASELINE config 4 at 4K+).  Bitwise-matches the single-device
    encode either way.
    """
    if codebook not in ("replicate", "ring"):
        raise ValueError(f"unknown codebook mode {codebook}")
    plane = jnp.asarray(plane, jnp.uint8)
    h, w = plane.shape
    dom, tr, s, o, dist, valid = _encode_sharded_image_impl(plane, cfg, mesh,
                                                            codebook)
    return EncodeResult(
        domain_idx=dom, transform=tr, s=s, o=o, distance=dist, valid=valid,
        width=w, height=h, source_size=cfg.source_size,
        target_size=cfg.target_size, domain_step=cfg.domain_step,
        num_transforms=cfg.num_transforms,
    )


@functools.partial(jax.jit, static_argnames=("mesh", "max_iterations", "epsilon",
                                             "initial_value", "stall_window",
                                             "stall_rtol", "pyramid"))
def _decode_batch_impl(dom, tr, s, o, valid, template: EncodeResult, mesh: Mesh,
                       max_iterations: int, epsilon: float, initial_value: int,
                       stall_window: int, stall_rtol: float = 0.02,
                       pyramid: bool = False):
    from ..decode.decoder import _build_indices, _decode_step, _pyramid_init
    from ..params import DecoderConfig

    h, w = template.height, template.width

    def body(dom_l, tr_l, s_l, o_l, valid_l):
        # Inputs arrive sharded [B/nd, R/ns] exactly as the sharded encode
        # produced them (in_specs below mirror its out_specs — no SPMD
        # resharding, no "involuntary full rematerialization"); reassemble
        # the full per-image rows with one explicit all_gather.
        gather = lambda x: jax.lax.all_gather(x, SEARCH_AXIS, axis=1, tiled=True)
        dom_l, tr_l, s_l, o_l, valid_l = map(
            gather, (dom_l, tr_l, s_l, o_l, valid_l)
        )

        def one(dom1, tr1, s1, o1, v1):
            res = EncodeResult(
                domain_idx=dom1, transform=tr1, s=s1, o=o1,
                distance=jnp.zeros_like(s1), valid=v1,
                width=w, height=h, source_size=template.source_size,
                target_size=template.target_size,
                domain_step=template.domain_step,
                num_transforms=template.num_transforms,
            )
            idx = _build_indices(res)
            ss = jnp.where(v1, s1, 0.0)
            oo = jnp.where(v1, o1, 0.0)
            if pyramid:
                # the coarse-to-fine fast path, sharded: same fixed
                # floor as decode.decoder._decode_core (semantics and
                # measured rationale there); the init derives from the
                # data-varying maps, so no pcast is needed
                dcfg = DecoderConfig(
                    pyramid=True, max_iterations=max_iterations,
                    epsilon=epsilon, initial_value=initial_value,
                    stall_window=stall_window, stall_rtol=stall_rtol)
                pi = _pyramid_init(res, ss, oo, dcfg)
                if pi is not None:
                    def fstep(i, c):
                        img, _ = c
                        nxt = _decode_step(img, idx, ss, oo, h, w,
                                           template.target_size)
                        return nxt, img

                    n_full = min(dcfg.pyramid_full_steps,
                                 dcfg.max_iterations)
                    img0, prev0 = jax.lax.fori_loop(0, n_full, fstep,
                                                    (pi, pi))
                    d0 = img0.astype(jnp.float32) - prev0.astype(jnp.float32)
                    mse0 = jnp.sum(d0 * d0) / (h * w)
                    return (img0, jnp.int32(n_full), mse0)
            init = jnp.full((h, w), initial_value, dtype=jnp.uint8)

            def cond(c):
                return (c[2] < max_iterations) & ~c[4]

            def step(c):
                img, prev, steps, _, _, best, since = c
                nxt = _decode_step(img, idx, ss, oo, h, w, template.target_size)
                d = nxt.astype(jnp.float32) - img.astype(jnp.float32)
                mse = jnp.sum(d * d) / (h * w)
                # period-2 cycle + stall-window exits — must mirror
                # decode.decoder.decode_plane exactly, or the batch decode
                # exits a longer-period orbit on a different phase than the
                # single-device decode (+-1 pixel flips).
                cycle = jnp.all(nxt == prev)
                improved = mse < best * (1.0 - stall_rtol)
                since = jnp.where(improved, 0, since + 1)
                best = jnp.minimum(best, mse)
                stalled = (
                    since >= stall_window if stall_window > 0
                    else jnp.bool_(False)
                )
                return (nxt, img, steps + 1, mse,
                        (mse < epsilon) | cycle | stalled, best, since)

            # the carry must carry the same varying-axes as the loop body's
            # outputs (which vary over 'data' through dom1/s1/o1)
            carry0 = jax.lax.pcast(
                (init, init ^ jnp.uint8(1), jnp.int32(0),
                 jnp.float32(jnp.inf), jnp.bool_(False),
                 jnp.float32(jnp.inf), jnp.int32(0)),
                (DATA_AXIS,),
                to="varying",
            )
            img, _, steps, mse, _, _, _ = jax.lax.while_loop(cond, step, carry0)
            return img, steps, mse

        return jax.vmap(one)(dom_l, tr_l, s_l, o_l, valid_l)

    return shard_map(
        body,
        mesh=mesh,
        in_specs=tuple([P(DATA_AXIS, SEARCH_AXIS)] * 5),
        out_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )(dom, tr, s, o, valid)


def decode_batch_sharded(results: list[EncodeResult], mesh: Mesh,
                         max_iterations: int = 300, epsilon: float = 1e-5,
                         initial_value: int = 100, stall_window: int = 8,
                         stall_rtol: float = 0.02, pyramid: bool = False):
    """Decode a batch of encodes data-parallel across the mesh.

    ``pyramid=True`` uses the coarse-to-fine fast path (see
    ``DecoderConfig.pyramid``) inside every shard.

    Returns ([B, H, W] u8 images, [B] iterations, [B] final mse).
    """
    stack = lambda f: jnp.stack([f(r) for r in results])
    return _decode_batch_impl(
        stack(lambda r: r.domain_idx),
        stack(lambda r: r.transform),
        stack(lambda r: r.s),
        stack(lambda r: r.o),
        stack(lambda r: r.valid),
        results[0],
        mesh,
        max_iterations,
        epsilon,
        initial_value,
        stall_window,
        stall_rtol,
        pyramid,
    )
