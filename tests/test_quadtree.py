"""Quadtree adaptive partitioning tests (the feature the reference's
--quadtree flag stubs but never implements; BASELINE config 3)."""
import numpy as np
import pytest

from fractencode_tpu import DecoderConfig, EncoderConfig
from fractencode_tpu.core.metrics import psnr
from fractencode_tpu.encode.quadtree import (
    QuadtreeConfig,
    decode_plane_quadtree,
    encode_plane_quadtree,
)


def test_levels_partition_the_plane(rng):
    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    qcfg = QuadtreeConfig(min_size=4, max_size=16, error_threshold=100.0)
    res = encode_plane_quadtree(img, EncoderConfig(), qcfg)
    assert [l.range_size for l in res.levels] == [16, 8, 4]
    # accepted blocks tile the image exactly once
    total_area = sum(
        int(np.asarray(l.accepted).sum()) * l.range_size ** 2 for l in res.levels
    )
    assert total_area == 64 * 64
    # no child of an accepted parent is accepted
    for parent, child in zip(res.levels, res.levels[1:]):
        pny = 64 // parent.range_size
        pa = np.asarray(parent.accepted).reshape(pny, pny)
        ca = np.asarray(child.accepted).reshape(2 * pny, 2 * pny)
        covered = np.repeat(np.repeat(pa, 2, 0), 2, 1)
        assert not (covered & ca).any()


def test_flat_image_stays_coarse():
    img = np.full((64, 64), 80, dtype=np.uint8)
    res = encode_plane_quadtree(img, EncoderConfig(),
                                QuadtreeConfig(error_threshold=10.0))
    assert np.asarray(res.levels[0].accepted).all()
    assert res.num_leaves == (64 // 16) ** 2


def test_threshold_zero_goes_fine(rng):
    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    res = encode_plane_quadtree(img, EncoderConfig(),
                                QuadtreeConfig(error_threshold=0.0))
    # pure noise never meets threshold 0 -> everything lands on the finest level
    assert not np.asarray(res.levels[0].accepted).any()
    assert np.asarray(res.levels[-1].accepted).all()


def test_quadtree_roundtrip_quality(lenna_y):
    img = np.asarray(lenna_y)[128:256, 128:256]
    cfg = EncoderConfig()
    res = encode_plane_quadtree(img, cfg, QuadtreeConfig(error_threshold=40.0))
    out, iters, mse = decode_plane_quadtree(res, DecoderConfig())
    p = float(psnr(img, np.asarray(out)))
    assert p > 25.0, p
    # adaptive tree really is adaptive on a natural image
    leaves_per_level = [int(np.asarray(l.accepted).sum()) for l in res.levels]
    assert sum(1 for n in leaves_per_level if n > 0) >= 2, leaves_per_level


def test_quadtree_beats_uniform_at_equal_leaves(lenna_y):
    """With a sane threshold the quadtree should reach uniform-4x4 quality
    using far fewer leaves (rate), or better quality at equal leaves."""
    from fractencode_tpu import decode_plane, encode_plane

    img = np.asarray(lenna_y)[128:256, 128:256]
    uni = encode_plane(img, EncoderConfig())
    out_u, _, _ = decode_plane(uni)
    p_uniform = float(psnr(img, np.asarray(out_u)))

    res = encode_plane_quadtree(img, EncoderConfig(),
                                QuadtreeConfig(error_threshold=25.0))
    out_q, _, _ = decode_plane_quadtree(res)
    p_quad = float(psnr(img, np.asarray(out_q)))

    n_uniform = uni.num_ranges
    assert res.num_leaves < n_uniform
    assert p_quad > p_uniform - 3.0, (p_quad, p_uniform, res.num_leaves)


def test_invalid_configs():
    with pytest.raises(ValueError):
        QuadtreeConfig(min_size=8, max_size=4)
    with pytest.raises(ValueError):
        QuadtreeConfig(min_size=3, max_size=12)

def test_quadtree_bitstream_roundtrip(lenna_y):
    from fractencode_tpu.codec.bitstream_quadtree import (
        pack_quadtree,
        unpack_quadtree,
    )

    img = np.asarray(lenna_y)[:64, :64]
    res = encode_plane_quadtree(img, EncoderConfig(),
                                QuadtreeConfig(error_threshold=30.0))
    blob = pack_quadtree(res)
    back = unpack_quadtree(blob)
    assert back.width == 64 and back.num_leaves == res.num_leaves
    for a, b in zip(res.levels, back.levels):
        acc = np.asarray(a.accepted)
        np.testing.assert_array_equal(acc, np.asarray(b.accepted))
        np.testing.assert_array_equal(
            np.asarray(a.domain_idx)[acc], np.asarray(b.domain_idx)[acc]
        )
        np.testing.assert_array_equal(
            np.asarray(a.transform)[acc], np.asarray(b.transform)[acc]
        )
    out_a, _, _ = decode_plane_quadtree(res)
    out_b, _, _ = decode_plane_quadtree(back)
    p_a = float(psnr(img, np.asarray(out_a)))
    p_b = float(psnr(img, np.asarray(out_b)))
    assert p_b > p_a - 3.0, (p_b, p_a)

    # mean-centred o (pack with the source plane): quantization loss must
    # stay within ~1.5 dB of the unquantized decode at the same byte size
    blob_m = pack_quadtree(res, plane=img)
    assert len(blob_m) == len(blob)
    back_m = unpack_quadtree(blob_m)
    assert back_m.levels[0].o_is_mean
    out_m, _, _ = decode_plane_quadtree(back_m)
    p_m = float(psnr(img, np.asarray(out_m)))
    assert p_m > p_a - 1.5, (p_m, p_a)
    assert p_m > p_b, (p_m, p_b)


def test_batch_quadtree_matches_single(rng):
    """encode_batch_quadtree == per-plane encode_plane_quadtree bitwise."""
    from fractencode_tpu.encode.quadtree import (
        QuadtreeConfig,
        encode_batch_quadtree,
        encode_plane_quadtree,
    )
    from fractencode_tpu.params import EncoderConfig

    imgs = rng.integers(0, 256, size=(2, 64, 64), dtype=np.uint8)
    cfg = EncoderConfig()
    qcfg = QuadtreeConfig(min_size=4, max_size=16)
    batch = encode_batch_quadtree(imgs, cfg, qcfg)
    for i in range(2):
        single = encode_plane_quadtree(imgs[i], cfg, qcfg)
        for lb, ls in zip(batch[i].levels, single.levels):
            np.testing.assert_array_equal(
                np.asarray(lb.domain_idx), np.asarray(ls.domain_idx))
            np.testing.assert_array_equal(
                np.asarray(lb.accepted), np.asarray(ls.accepted))
            np.testing.assert_array_equal(np.asarray(lb.s), np.asarray(ls.s))


def test_sharded_quadtree_matches_single(rng):
    """Quadtree batch over the mesh data axis (config 3 at pod scale)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs 2+ devices")
    from fractencode_tpu.encode.quadtree import (
        QuadtreeConfig,
        encode_batch_quadtree_sharded,
        encode_plane_quadtree,
    )
    from fractencode_tpu.parallel import make_mesh
    from fractencode_tpu.params import EncoderConfig

    imgs = rng.integers(0, 256, size=(2, 64, 64), dtype=np.uint8)
    cfg = EncoderConfig()
    qcfg = QuadtreeConfig(min_size=4, max_size=16)
    mesh = make_mesh(n_data=2, n_search=1)
    batch = encode_batch_quadtree_sharded(imgs, cfg, qcfg, mesh)
    for i in range(2):
        single = encode_plane_quadtree(imgs[i], cfg, qcfg)
        for lb, ls in zip(batch[i].levels, single.levels):
            np.testing.assert_array_equal(
                np.asarray(lb.domain_idx), np.asarray(ls.domain_idx))
            np.testing.assert_array_equal(
                np.asarray(lb.accepted), np.asarray(ls.accepted))


def test_sharded_quadtree_pallas_backend(rng):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs 2+ devices")
    from fractencode_tpu.encode.quadtree import (
        QuadtreeConfig,
        encode_batch_quadtree_sharded,
        encode_plane_quadtree,
    )
    from fractencode_tpu.parallel import make_mesh
    from fractencode_tpu.params import EncoderConfig

    imgs = rng.integers(0, 256, size=(2, 64, 64), dtype=np.uint8)
    cfg = EncoderConfig(backend="pallas_interpret")
    qcfg = QuadtreeConfig(min_size=4, max_size=16)
    mesh = make_mesh(n_data=2, n_search=1)
    batch = encode_batch_quadtree_sharded(imgs, cfg, qcfg, mesh)
    for i in range(2):
        single = encode_plane_quadtree(imgs[i], cfg, qcfg)
        for lb, ls in zip(batch[i].levels, single.levels):
            np.testing.assert_array_equal(
                np.asarray(lb.domain_idx), np.asarray(ls.domain_idx))


def test_quadtree_decode_uses_cb_tables(rng):
    """Regression for the round-2 HEAD breakage: decode tables for every
    quadtree level must build through the 7-arg build_decode_tables signature
    and (for the default even-step geometry) select the "cb" gather path."""
    from fractencode_tpu.encode.quadtree import _level_tables

    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    res = encode_plane_quadtree(img, EncoderConfig(),
                                QuadtreeConfig(min_size=4, max_size=16,
                                               error_threshold=50.0))
    modes = {
        lvl.range_size: _level_tables(lvl, res.width, res.height)[0]
        for lvl in res.levels
    }
    # the fine levels qualify for the codebook gather path; the coarse 16px
    # level exceeds the patch-slice budget and falls back to half-res taps
    assert modes[4] == "cb" and modes[8] == "cb", modes
    out, iters, mse = decode_plane_quadtree(res, DecoderConfig())
    assert out.shape == (64, 64) and out.dtype == np.uint8


def test_sharded_quadtree_decode_matches_single(rng):
    """decode_batch_quadtree_sharded (data-parallel over the mesh) must be
    pixel-identical to decode_plane_quadtree per image."""
    import jax

    from fractencode_tpu.encode.quadtree import (
        decode_batch_quadtree_sharded,
        encode_plane_quadtree,
    )
    from fractencode_tpu.parallel import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual devices")
    imgs = rng.integers(0, 256, size=(2, 64, 64), dtype=np.uint8)
    cfg = EncoderConfig()
    qcfg = QuadtreeConfig(min_size=4, max_size=16, error_threshold=60.0)
    results = [encode_plane_quadtree(im, cfg, qcfg) for im in imgs]
    mesh = make_mesh(n_data=2, n_search=1)
    outs, iters, mses = decode_batch_quadtree_sharded(results, mesh)
    for i in range(2):
        single, it_s, mse_s = decode_plane_quadtree(results[i])
        np.testing.assert_array_equal(np.asarray(outs[i]), np.asarray(single))
        assert int(iters[i]) == int(it_s), (int(iters[i]), int(it_s))


def test_coverage_mask_leaves_bit_identical(lenna_y):
    """Round-4 coverage-masked search: fine levels skip blocks under an
    accepted coarser leaf (the partition-level analog of the reference's
    early-exit FLOP cut, TransformEstimator2.hpp:40-41).  Accepted leaves —
    selection masks AND every stored field of accepted entries — must be
    bit-identical to the full per-level search, on the jnp oracle and on the
    pallas (interpret) classed kernel."""
    import dataclasses

    import jax

    # The interpret-pallas quadtree programs below are the largest compiles
    # in the suite; XLA:CPU crashes compiling them once enough JIT state has
    # accumulated in the process (see conftest._clear_jax_caches_between_
    # modules — same resource limit, which round 5's extra pyramid-decode
    # compiles now reach mid-module).  Start them from a clean cache.
    jax.clear_caches()

    img = np.asarray(lenna_y)[128:256, 128:256]
    qcfg_on = QuadtreeConfig(min_size=4, max_size=16, error_threshold=50.0)
    qcfg_off = dataclasses.replace(qcfg_on, mask_covered=False)
    for backend in ("jnp", "pallas_interpret"):
        cfg = EncoderConfig(backend=backend)
        r_on = encode_plane_quadtree(img, cfg, qcfg_on)
        r_off = encode_plane_quadtree(img, cfg, qcfg_off)
        assert r_on.num_leaves == r_off.num_leaves
        # masking must actually engage: some coarse block accepted
        assert int(np.asarray(r_on.levels[0].accepted).sum()) > 0, "vacuous"
        for lon, loff in zip(r_on.levels, r_off.levels):
            acc_on = np.asarray(lon.accepted)
            np.testing.assert_array_equal(acc_on, np.asarray(loff.accepted),
                                          err_msg=f"{backend} accepted mask")
            for f in ("domain_idx", "transform", "s", "o"):
                a = np.asarray(getattr(lon, f))[acc_on]
                b = np.asarray(getattr(loff, f))[acc_on]
                np.testing.assert_array_equal(
                    a, b, err_msg=f"{backend} {lon.range_size}px {f}")


def test_coverage_mask_oracle_vs_pallas(lenna_y):
    """Masked classed kernel == masked oracle on every searched range
    (the kernel skips masked tiles; the oracle post-masks a full search)."""
    img = np.asarray(lenna_y)[128:192, 128:192]
    qcfg = QuadtreeConfig(min_size=4, max_size=16, error_threshold=50.0)
    r_j = encode_plane_quadtree(img, EncoderConfig(backend="jnp"), qcfg)
    r_p = encode_plane_quadtree(img, EncoderConfig(backend="pallas_interpret"), qcfg)
    for lj, lp in zip(r_j.levels, r_p.levels):
        for f in ("domain_idx", "transform", "s", "o", "accepted"):
            np.testing.assert_array_equal(
                np.asarray(getattr(lj, f)), np.asarray(getattr(lp, f)),
                err_msg=f"{lp.range_size}px {f}")


def test_fused_pyramid_matches_per_level(lenna_y):
    """The one-dispatch fused pyramid (the production program structure on
    every backend since round 5) must be bit-identical to the per-level
    dispatch path (which the progress reporter and the interpret-pallas
    oracle still use)."""
    from fractencode_tpu.encode.quadtree import (
        _encode_quadtree_fused,
        _encode_quadtree_impl,
    )
    import jax.numpy as jnp

    img = jnp.asarray(np.asarray(lenna_y)[128:256, 128:256])
    cfg = EncoderConfig()
    qcfg = QuadtreeConfig(min_size=4, max_size=16, error_threshold=50.0)
    fused = _encode_quadtree_fused(img, cfg, qcfg)
    eager = _encode_quadtree_impl(img, cfg, qcfg)
    assert len(fused) == len(eager)
    for lf, le in zip(fused, eager):
        for f in ("domain_idx", "transform", "s", "o", "accepted"):
            np.testing.assert_array_equal(
                np.asarray(getattr(lf, f)), np.asarray(getattr(le, f)),
                err_msg=f"{lf.range_size}px {f}")
