"""End-to-end encode -> decode tests (the round-trip coverage the reference
never had; SURVEY.md section 4)."""
import numpy as np
import pytest

from fractencode_tpu import (
    DecoderConfig,
    EncoderConfig,
    REFERENCE_COMPAT,
    decode_plane,
    encode_plane,
)
from fractencode_tpu.core.metrics import psnr


def _gradient_image(n=64):
    ys, xs = np.mgrid[0:n, 0:n]
    return ((xs * 255) // max(n - 1, 1)).astype(np.uint8)


def test_encode_result_shapes():
    img = _gradient_image(64)
    cfg = EncoderConfig(source_size=16, target_size=4)
    res = encode_plane(img, cfg)
    r = (64 // 4) ** 2
    assert res.domain_idx.shape == (r,)
    assert res.transform.shape == (r,)
    assert res.num_ranges == r
    assert res.domain_grid.num_items == 7 * 7
    t = np.asarray(res.transform)
    assert t.min() >= 0 and t.max() < cfg.num_transforms


@pytest.mark.parametrize("cfg", [
    EncoderConfig(),
    EncoderConfig(criterion="affine", so_mode="ls", num_transforms=8),
    EncoderConfig(use_classifier=False),
])
def test_roundtrip_gradient(cfg):
    img = _gradient_image(64)
    res = encode_plane(img, cfg)
    out, iters, mse = decode_plane(res, DecoderConfig())
    out = np.asarray(out)
    assert out.shape == img.shape and out.dtype == np.uint8
    assert int(iters) <= 300
    p = float(psnr(img, out))
    assert p > 25.0, p


def test_roundtrip_gradient_reference_compat():
    """The reference's backwards (s, o) regression yields non-contractive
    s ~= 4 on a pure gradient and its decode diverges to ~4.7 dB PSNR —
    measured from the patched C++ binary on this exact image.  Our compat
    mode must reproduce that behavior, not 'fix' it."""
    img = _gradient_image(64)
    res = encode_plane(img, REFERENCE_COMPAT())
    out, _, _ = decode_plane(res, DecoderConfig())
    p = float(psnr(img, np.asarray(out)))
    assert 3.0 < p < 7.0, p
    assert float(res.s.max()) > 3.0  # the tell-tale non-contractive contrast


def test_affine_ls_beats_reference_modes(lenna_y):
    """The corrected criterion + (s,o) solve must decode to at least the
    compat mode's PSNR on a real image (BASELINE.md decode-quality target)."""
    img = np.asarray(lenna_y)[:128, :128]
    res_ref = encode_plane(img, REFERENCE_COMPAT())
    res_ls = encode_plane(img, EncoderConfig(criterion="affine", so_mode="ls"))
    out_ref, _, _ = decode_plane(res_ref)
    out_ls, _, _ = decode_plane(res_ls)
    p_ref = float(psnr(img, np.asarray(out_ref)))
    p_ls = float(psnr(img, np.asarray(out_ls)))
    assert p_ls >= p_ref, (p_ls, p_ref)
    assert p_ls > 20.0, p_ls


def test_flat_image_perfect():
    """A flat image is exactly representable (s=0, o=value)."""
    img = np.full((32, 32), 137, dtype=np.uint8)
    res = encode_plane(img, EncoderConfig(criterion="affine", so_mode="ls"))
    out, iters, _ = decode_plane(res)
    assert np.array_equal(np.asarray(out), img)


def test_decoder_convergence_counting():
    img = np.full((32, 32), 7, dtype=np.uint8)
    res = encode_plane(img, EncoderConfig(criterion="affine", so_mode="ls"))
    _, iters, mse = decode_plane(res, DecoderConfig(max_iterations=50))
    assert float(mse) < 1e-5
    assert int(iters) < 50


def test_decode_steps_py_matches_jit():
    img = _gradient_image(32)
    res = encode_plane(img, EncoderConfig())
    from fractencode_tpu.decode import decode_steps_py

    last = None
    for i, step_img in decode_steps_py(res, DecoderConfig(max_iterations=20)):
        last = step_img
    out, _, _ = decode_plane(res, DecoderConfig(max_iterations=20))
    # both end at the same fixed point (or same 20th iterate)
    assert np.array_equal(np.asarray(last), np.asarray(out))


def test_encode_batch_matches_single(rng):
    from fractencode_tpu.encode import encode_batch

    cfg = EncoderConfig()
    imgs = rng.integers(0, 256, size=(3, 64, 64), dtype=np.uint8)
    batch = encode_batch(imgs, cfg)
    for i in range(3):
        single = encode_plane(imgs[i], cfg)
        np.testing.assert_array_equal(
            np.asarray(batch[i].domain_idx), np.asarray(single.domain_idx)
        )
        np.testing.assert_array_equal(
            np.asarray(batch[i].transform), np.asarray(single.transform)
        )


def test_encode_batch_pallas_matches_single(rng):
    """Batch throughput mode with the Pallas backend (interpreted on CPU):
    vmapped prep/post around the lax.map'd kernel must match per-plane."""
    from fractencode_tpu.encode import encode_batch

    cfg = EncoderConfig(backend="pallas_interpret")
    imgs = rng.integers(0, 256, size=(3, 64, 64), dtype=np.uint8)
    batch = encode_batch(imgs, cfg)
    for i in range(3):
        single = encode_plane(imgs[i], cfg)
        np.testing.assert_array_equal(
            np.asarray(batch[i].domain_idx), np.asarray(single.domain_idx)
        )
        np.testing.assert_array_equal(
            np.asarray(batch[i].transform), np.asarray(single.transform)
        )
        np.testing.assert_allclose(
            np.asarray(batch[i].s), np.asarray(single.s), atol=1e-6
        )


def test_encode_batch_stacked_matches_list(rng):
    """The stacked form is the exact arrays encode_batch slices, and a
    stacked frame decodes identically to its sliced EncodeResult."""
    import jax.tree_util as jtu

    from fractencode_tpu.encode import encode_batch, encode_batch_stacked

    cfg = EncoderConfig()
    imgs = rng.integers(0, 256, size=(3, 64, 64), dtype=np.uint8)
    stacked = encode_batch_stacked(imgs, cfg)
    assert stacked.domain_idx.shape[0] == 3
    assert stacked.width == 64 and stacked.num_transforms == cfg.num_transforms
    frames = encode_batch(imgs, cfg)
    for i, frame in enumerate(frames):
        for name in ("domain_idx", "transform", "s", "o", "distance", "valid"):
            np.testing.assert_array_equal(
                np.asarray(getattr(stacked, name)[i]),
                np.asarray(getattr(frame, name)),
            )
    # a sliced stacked frame is a full EncodeResult: decode it
    frame0 = jtu.tree_map(lambda a: a[0], stacked)
    out_a, it_a, _ = decode_plane(frame0, DecoderConfig(max_iterations=8))
    out_b, it_b, _ = decode_plane(frames[0], DecoderConfig(max_iterations=8))
    assert np.array_equal(np.asarray(out_a), np.asarray(out_b))


def test_decode_batch_stacked_matches_single(lenna_y):
    """Stacked batch decode (one device program) must match per-frame
    decode_plane exactly — same fixed-point pixels, iterations, mse."""
    import jax.numpy as jnp

    from fractencode_tpu.decode import decode_batch_stacked
    from fractencode_tpu.encode import encode_batch_stacked

    img = np.asarray(lenna_y)[128:192, 128:192]
    imgs = np.stack([img, img[::-1, ::-1].copy()])
    cfg = EncoderConfig()
    stacked = encode_batch_stacked(jnp.asarray(imgs), cfg)
    outs, iters, mses = decode_batch_stacked(stacked)
    import jax

    for i in range(2):
        res1 = jax.tree_util.tree_map(lambda a, i=i: a[i], stacked)
        out1, it1, mse1 = decode_plane(res1)
        np.testing.assert_array_equal(np.asarray(outs[i]), np.asarray(out1))
        assert int(iters[i]) == int(it1)
        assert float(mses[i]) == float(mse1)


def test_mean_init_decode_quality(lenna_y):
    """Block-mean initialization: same-or-better PSNR than the flat-100
    start within 0.2 dB, and no more iterations (it starts near the fixed
    point; the final limit cycle may differ by +-1-gray pixels — documented
    PSNR-neutral, see DecoderConfig.initial)."""
    from fractencode_tpu.params import DecoderConfig

    img = np.asarray(lenna_y)[128:256, 128:256]
    res = encode_plane(img, EncoderConfig())
    out_f, it_f, _ = decode_plane(res, DecoderConfig())
    out_m, it_m, _ = decode_plane(res, DecoderConfig(initial="means"))

    def _psnr(out):
        mse = ((np.asarray(out).astype(np.float64) - img) ** 2).mean()
        return 10.0 * np.log10(255.0**2 / max(mse, 1e-9))

    assert _psnr(out_m) > _psnr(out_f) - 0.2, (_psnr(out_m), _psnr(out_f))
    assert int(it_m) <= int(it_f), (int(it_m), int(it_f))


def test_pyramid_decode_quality(lenna_y):
    """Coarse-to-fine (pyramid) decode: the fast path (half-res iterations
    + a fixed count of full-res steps) must land within 0.05 dB of the flat
    reference-parity decode, for both a raw encode and a quantized stream,
    and report pyramid_full_steps as its iteration count."""
    from fractencode_tpu.codec import pack_result, unpack_result

    img = np.asarray(lenna_y)[:256, :256]
    res_raw = encode_plane(img, EncoderConfig())
    res_q = unpack_result(pack_result(res_raw, plane=img))

    def _psnr(out):
        mse = ((np.asarray(out).astype(np.float64) - img) ** 2).mean()
        return 10.0 * np.log10(255.0**2 / max(mse, 1e-9))

    for res in (res_raw, res_q):
        out_f, _, _ = decode_plane(res, DecoderConfig())
        out_p, it_p, _ = decode_plane(res, DecoderConfig(pyramid=True))
        assert int(it_p) == DecoderConfig.pyramid_full_steps
        assert _psnr(out_p) > _psnr(out_f) - 0.05, (_psnr(out_p), _psnr(out_f))


def test_pyramid_decode_quadtree(lenna_y):
    """Pyramid init composes with the multi-level quadtree decode loop."""
    from fractencode_tpu.encode.quadtree import (
        QuadtreeConfig,
        decode_plane_quadtree,
        encode_plane_quadtree,
    )

    img = np.asarray(lenna_y)[:256, :256]
    qres = encode_plane_quadtree(img, EncoderConfig(), QuadtreeConfig())
    out_f, _, _ = decode_plane_quadtree(qres, DecoderConfig())
    out_p, it_p, _ = decode_plane_quadtree(qres, DecoderConfig(pyramid=True))
    assert int(it_p) == DecoderConfig.pyramid_full_steps

    def _psnr(out):
        mse = ((np.asarray(out).astype(np.float64) - img) ** 2).mean()
        return 10.0 * np.log10(255.0**2 / max(mse, 1e-9))

    assert _psnr(out_p) > _psnr(out_f) - 0.05, (_psnr(out_p), _psnr(out_f))


def test_pyramid_decode_batch_matches_single(lenna_y):
    """Batch decode with pyramid init matches per-frame pyramid decode."""
    import jax.numpy as jnp

    from fractencode_tpu.decode import decode_batch_stacked
    from fractencode_tpu.encode import encode_batch_stacked

    img = np.asarray(lenna_y)[:128, :128]
    imgs = np.stack([img, np.rot90(img).copy()])
    cfg = EncoderConfig()
    dcfg = DecoderConfig(pyramid=True)
    stacked = encode_batch_stacked(jnp.asarray(imgs), cfg)
    outs, iters, mses = decode_batch_stacked(stacked, dcfg)
    import jax

    for i in range(2):
        res1 = jax.tree_util.tree_map(lambda a, i=i: a[i], stacked)
        out1, it1, _ = decode_plane(res1, dcfg)
        np.testing.assert_array_equal(np.asarray(outs[i]), np.asarray(out1))
        assert int(iters[i]) == int(it1)


def test_pyramid_decode_odd_geometry_falls_back():
    """Geometries the pyramid cannot divide (odd target size factors) must
    silently use the flat path, not crash."""
    img = _gradient_image(96)
    cfg = EncoderConfig(source_size=12, target_size=6, lattice=2)
    res = encode_plane(img, cfg)
    out_f, it_f, _ = decode_plane(res, DecoderConfig())
    out_p, it_p, _ = decode_plane(res, DecoderConfig(pyramid=True))
    # target 6 / source 12 / step 6: factor 2 qualifies (6/2=3, 12/2=6,
    # step 3 odd => half path) — just assert a sane decode either way
    assert np.asarray(out_p).shape == img.shape
    p = float(psnr(img, np.asarray(out_p)))
    assert p > 20.0, p


def _content_matrix(n=128):
    """Non-Lenna content: seeded noise, smooth ramp, hard structure."""
    rng = np.random.default_rng(7)
    noise = rng.integers(0, 256, (n, n), np.uint8)
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float64)
    ramp = ((xs + ys) * 255 / (2 * n - 2)).astype(np.uint8)
    checker = (((xs // 8).astype(int) ^ (ys // 8).astype(int)) & 1) * 200 + 30
    structured = np.clip(checker + xs * 0.2, 0, 255).astype(np.uint8)
    return {"noise": noise, "ramp": ramp, "structured": structured}


def test_pyramid_decode_content_matrix():
    """The pyramid fast path's step counts were tuned on the Lenna
    fixtures; guard them on content with very different statistics.

    Pass criteria: PSNR parity with the flat start, OR the outputs differ
    only by +-1 gray per pixel.  The latter covers knife-edge synthetic
    content (the pure ramp): its pre-truncation values land exactly on
    integer boundaries, so u8-truncation fixed points are non-unique and
    which one an init basin reaches is decided by 1-ulp rounding — both
    renderings are exact fixed points of the map (measured: the same ramp
    decodes to either on different devices).  What this test must still catch is
    genuine non-convergence (e.g. the pre-continuation fixed-step bug,
    which left the ramp 33 dB short with multi-gray errors)."""
    for name, img in _content_matrix().items():
        res = encode_plane(img, EncoderConfig())
        out_f, _, _ = decode_plane(res, DecoderConfig())
        out_p, _, _ = decode_plane(res, DecoderConfig(pyramid=True))
        p_f = float(psnr(img, np.asarray(out_f)))
        p_p = float(psnr(img, np.asarray(out_p)))
        d = np.abs(np.asarray(out_p).astype(int) - np.asarray(out_f).astype(int))
        assert p_p > p_f - 0.1 or int(d.max()) <= 1, (name, p_p, p_f, d.max())


def test_flat_short_circuit_content_matrix():
    """The flat-block threshold (0.35 buckets) was tuned on Lenna; its
    error-neutrality must hold on other content too."""
    from fractencode_tpu.codec import pack_result, unpack_result

    for name, img in _content_matrix().items():
        res = encode_plane(img, EncoderConfig())
        blob_off = pack_result(res, plane=img, flat_scale=0.0)
        blob_on = pack_result(res, plane=img)
        assert len(blob_on) <= len(blob_off), name
        out_off, _, _ = decode_plane(unpack_result(blob_off))
        out_on, _, _ = decode_plane(unpack_result(blob_on))
        p_off = float(psnr(img, np.asarray(out_off)))
        p_on = float(psnr(img, np.asarray(out_on)))
        assert p_on > p_off - 0.05, (name, p_on, p_off)


def test_pyramid_respects_max_iterations(lenna_y):
    """An explicit iteration cap (the CLI's --decode N) bounds the pyramid
    floor too."""
    img = np.asarray(lenna_y)[:128, :128]
    res = encode_plane(img, EncoderConfig())
    out, it, _ = decode_plane(res, DecoderConfig(pyramid=True,
                                                 max_iterations=2))
    assert int(it) == 2
    out6, it6, _ = decode_plane(res, DecoderConfig(pyramid=True))
    assert int(it6) == DecoderConfig.pyramid_full_steps
