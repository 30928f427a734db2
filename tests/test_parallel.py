"""Multi-chip sharding tests on the virtual 8-device CPU mesh
(conftest sets --xla_force_host_platform_device_count=8)."""
import jax
import numpy as np
import pytest

from fractencode_tpu import EncoderConfig, decode_plane, encode_plane
from fractencode_tpu.parallel import (
    decode_batch_sharded,
    encode_batch_sharded,
    make_mesh,
)


def _images(rng, b=2, n=64):
    return rng.integers(0, 256, size=(b, n, n), dtype=np.uint8)


@pytest.fixture(scope="module")
def devices_ok():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


@pytest.mark.parametrize("strategy", ["ranges", "domains", "ring"])
def test_sharded_encode_matches_single_device(rng, devices_ok, strategy):
    cfg = EncoderConfig(source_size=16, target_size=4)
    imgs = _images(rng, b=2, n=64)
    mesh = make_mesh(n_data=2, n_search=4)
    results = encode_batch_sharded(imgs, cfg, mesh, strategy=strategy)
    for i in range(2):
        single = encode_plane(imgs[i], cfg)
        np.testing.assert_array_equal(
            np.asarray(results[i].domain_idx), np.asarray(single.domain_idx),
            err_msg=f"strategy={strategy} image={i}",
        )
        np.testing.assert_array_equal(
            np.asarray(results[i].transform), np.asarray(single.transform)
        )
        np.testing.assert_allclose(
            np.asarray(results[i].s), np.asarray(single.s), atol=1e-6
        )


@pytest.mark.parametrize("strategy", ["ranges", "domains", "ring"])
def test_sharded_encode_pallas_backend(rng, devices_ok, strategy):
    """Every strategy with the Pallas kernel (interpreted on CPU):
    validates the kernel inside shard_map+lax.map, the domain-mask bin, and
    the ring/argmax reducers."""
    cfg = EncoderConfig(source_size=16, target_size=4, backend="pallas_interpret")
    imgs = _images(rng, b=2, n=64)
    mesh = make_mesh(n_data=2, n_search=4)
    results = encode_batch_sharded(imgs, cfg, mesh, strategy=strategy)
    for i in range(2):
        single = encode_plane(imgs[i], cfg)
        np.testing.assert_array_equal(
            np.asarray(results[i].domain_idx), np.asarray(single.domain_idx),
            err_msg=f"strategy={strategy} image={i}",
        )
        np.testing.assert_array_equal(
            np.asarray(results[i].transform), np.asarray(single.transform)
        )
        np.testing.assert_allclose(
            np.asarray(results[i].s), np.asarray(single.s), atol=1e-6
        )


@pytest.mark.parametrize("strategy", ["domains", "ring"])
def test_sharded_encode_flat_blocks_tiebreak(devices_ok, strategy):
    """Flat range blocks tie at distance 0 against MANY domains (the 'ls'
    criterion clamps); the cross-shard reducer must still reproduce the
    single-device winner bitwise — this is why the reduction compares the
    rank key, not the distance."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    img[:16, :] = 128  # flat band: every 4x4 range there ties at dist 0
    img = np.stack([img, img[::-1]])
    cfg = EncoderConfig(source_size=16, target_size=4)
    mesh = make_mesh(n_data=2, n_search=4)
    results = encode_batch_sharded(img, cfg, mesh, strategy=strategy)
    for i in range(2):
        single = encode_plane(img[i], cfg)
        np.testing.assert_array_equal(
            np.asarray(results[i].domain_idx), np.asarray(single.domain_idx),
            err_msg=f"strategy={strategy}",
        )
        np.testing.assert_array_equal(
            np.asarray(results[i].transform), np.asarray(single.transform)
        )


@pytest.mark.parametrize("strategy", ["domains", "ring"])
def test_sharded_encode_noclassifier(rng, devices_ok, strategy):
    cfg = EncoderConfig(source_size=16, target_size=4, use_classifier=False)
    imgs = _images(rng, b=2, n=64)
    mesh = make_mesh(n_data=2, n_search=4)
    results = encode_batch_sharded(imgs, cfg, mesh, strategy=strategy)
    for i in range(2):
        single = encode_plane(imgs[i], cfg)
        np.testing.assert_array_equal(
            np.asarray(results[i].domain_idx), np.asarray(single.domain_idx),
            err_msg=f"strategy={strategy}",
        )


def test_sharded_encode_uneven_domain_rows(rng, devices_ok):
    """Domain-row bands that don't divide evenly over the search axis: the
    tail shard's padded rows must be masked out bitwise-correctly."""
    cfg = EncoderConfig(source_size=16, target_size=4)
    # 80x64: domain grid ny=9 rows over 4 shards -> rows_per=3, 3 pad rows
    imgs = rng.integers(0, 256, size=(2, 80, 64), dtype=np.uint8)
    mesh = make_mesh(n_data=2, n_search=4)
    for strategy in ("domains", "ring"):
        results = encode_batch_sharded(imgs, cfg, mesh, strategy=strategy)
        for i in range(2):
            single = encode_plane(imgs[i], cfg)
            np.testing.assert_array_equal(
                np.asarray(results[i].domain_idx), np.asarray(single.domain_idx),
                err_msg=f"strategy={strategy}",
            )
            np.testing.assert_array_equal(
                np.asarray(results[i].valid), np.asarray(single.valid)
            )


def test_sharded_decode_matches_single_device(rng, devices_ok):
    cfg = EncoderConfig()
    imgs = _images(rng, b=2, n=64)
    mesh = make_mesh(n_data=2, n_search=4)
    results = encode_batch_sharded(imgs, cfg, mesh)
    outs, iters, mses = decode_batch_sharded(results, mesh)
    for i in range(2):
        single = encode_plane(imgs[i], cfg)
        out, it, _ = decode_plane(single)
        np.testing.assert_array_equal(np.asarray(outs[i]), np.asarray(out))


def test_sharded_decode_pyramid_matches_single_device(rng, devices_ok):
    """The coarse-to-fine fast path inside every shard must match
    decode_plane's pyramid mode bit-for-bit (same init, same fixed floor)."""
    from fractencode_tpu.params import DecoderConfig

    cfg = EncoderConfig()
    imgs = _images(rng, b=2, n=64)
    mesh = make_mesh(n_data=2, n_search=4)
    results = encode_batch_sharded(imgs, cfg, mesh)
    outs, iters, _ = decode_batch_sharded(results, mesh, pyramid=True)
    for i in range(2):
        single = encode_plane(imgs[i], cfg)
        out, it, _ = decode_plane(single, DecoderConfig(pyramid=True))
        np.testing.assert_array_equal(np.asarray(outs[i]), np.asarray(out))
        assert int(iters[i]) == int(it)


def test_mesh_shapes(devices_ok):
    mesh = make_mesh(n_data=2, n_search=4)
    assert mesh.shape == {"data": 2, "search": 4}
    with pytest.raises(ValueError):
        make_mesh(n_data=16, n_search=16)


def test_image_sharded_halo_encode_matches_single(rng, devices_ok):
    """BASELINE config 4 mechanics: image sharded by rows, halo exchange for
    boundary domains, codebook all_gather — must match single-device bitwise."""
    from fractencode_tpu.parallel.sharded import encode_plane_sharded_image

    cfg = EncoderConfig(source_size=16, target_size=4)
    img = rng.integers(0, 256, size=(128, 64), dtype=np.uint8)
    mesh = make_mesh(n_data=1, n_search=4)
    sharded = encode_plane_sharded_image(img, cfg, mesh)
    single = encode_plane(img, cfg)
    np.testing.assert_array_equal(
        np.asarray(sharded.domain_idx), np.asarray(single.domain_idx)
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.transform), np.asarray(single.transform)
    )
    np.testing.assert_allclose(np.asarray(sharded.s), np.asarray(single.s), atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(sharded.valid), np.asarray(single.valid)
    )


def test_image_sharded_halo_no_classifier(rng, devices_ok):
    from fractencode_tpu.parallel.sharded import encode_plane_sharded_image

    cfg = EncoderConfig(source_size=16, target_size=4, use_classifier=False)
    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    mesh = make_mesh(n_data=1, n_search=2)
    sharded = encode_plane_sharded_image(img, cfg, mesh)
    single = encode_plane(img, cfg)
    np.testing.assert_array_equal(
        np.asarray(sharded.domain_idx), np.asarray(single.domain_idx)
    )


def test_encode_pod_script_single_process(devices_ok, capsys):
    """scripts/encode_pod.py is the runnable multi-host artifact (BASELINE
    config 5); its single-process path must work end to end on the virtual
    mesh, and the arg plumbing must reject bad shapes loudly."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "encode_pod",
        os.path.join(os.path.dirname(__file__), "..", "scripts", "encode_pod.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    assert mod.resolve_mesh_shape(8, 2, None) == (2, 4)
    assert mod.resolve_mesh_shape(8, 1, 8) == (8, 1)
    with pytest.raises(ValueError):
        mod.resolve_mesh_shape(8, 1, 3)

    rc = mod.main(["--batch", "2", "--size", "64", "--n-data", "2",
                   "--reps", "1", "--decode", "--strategy", "ring"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "frames/s" in out and "decode:" in out


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"],
                         ids=["jnp", "pallas"])
def test_image_sharded_halo_ring_codebook(rng, devices_ok, backend):
    """Config-4-at-4K mechanics: image row-sharded AND the codebook
    ring-streamed (never replicated) — must still match single-device
    bitwise."""
    from fractencode_tpu.parallel.sharded import encode_plane_sharded_image

    cfg = EncoderConfig(source_size=16, target_size=4, backend=backend)
    img = rng.integers(0, 256, size=(128, 64), dtype=np.uint8)
    mesh = make_mesh(n_data=1, n_search=4)
    sharded = encode_plane_sharded_image(img, cfg, mesh, codebook="ring")
    single = encode_plane(img, cfg)
    np.testing.assert_array_equal(
        np.asarray(sharded.domain_idx), np.asarray(single.domain_idx)
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.transform), np.asarray(single.transform)
    )
    np.testing.assert_allclose(np.asarray(sharded.s), np.asarray(single.s),
                               atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(sharded.valid), np.asarray(single.valid)
    )


def _smooth_images(rng, b=2, n=64):
    """Low-pass images so rms_threshold early-accepts actually trigger."""
    import numpy as _np

    base = rng.integers(0, 256, size=(b, n, n)).astype(_np.float32)
    from numpy.lib.stride_tricks import sliding_window_view

    out = []
    for i in range(b):
        pad = _np.pad(base[i], 2, mode="edge")
        sm = sliding_window_view(pad, (5, 5)).reshape(n, n, 25).mean(axis=2)
        out.append(sm)
    return _np.stack(out).astype(_np.uint8)


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"],
                         ids=["jnp", "pallas"])
@pytest.mark.parametrize("strategy", ["ranges", "domains", "ring"])
def test_sharded_threshold_matches_single(rng, devices_ok, strategy, backend):
    """rms_threshold > 0 across shards: the early-accept frontier follows
    the GLOBAL scan order — 'domains' masks shards past the first hit shard,
    'ring' keeps two in-order accumulators (see _ring_search).  Must match
    the single-device encode bitwise."""
    cfg = EncoderConfig(source_size=16, target_size=4, rms_threshold=60.0,
                        backend=backend)
    imgs = _smooth_images(rng, b=2, n=64)
    mesh = make_mesh(n_data=2, n_search=4)
    results = encode_batch_sharded(imgs, cfg, mesh, strategy=strategy)
    hits_total = 0
    for i in range(2):
        single = encode_plane(imgs[i], cfg)
        hits_total += int((np.asarray(single.distance) <= 60.0).sum())
        for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
            np.testing.assert_array_equal(
                np.asarray(getattr(results[i], f)),
                np.asarray(getattr(single, f)),
                err_msg=f"strategy={strategy} backend={backend} "
                        f"image={i} field={f}",
            )
    assert hits_total > 0, "threshold never triggered: test is vacuous"


@pytest.mark.parametrize("codebook", ["replicate", "ring"])
@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"],
                         ids=["jnp", "pallas"])
def test_image_sharded_halo_threshold(rng, devices_ok, backend, codebook):
    """Halo-sharded single image with rms_threshold > 0: 'replicate' is one
    in-order search per device; 'ring' exercises _ring_search's two-group
    frontier accumulators under the halo driver."""
    from fractencode_tpu.parallel.sharded import encode_plane_sharded_image

    cfg = EncoderConfig(source_size=16, target_size=4, rms_threshold=60.0,
                        backend=backend)
    img = _smooth_images(rng, b=1, n=128)[0, :, :64]
    mesh = make_mesh(n_data=1, n_search=4)
    sharded = encode_plane_sharded_image(img, cfg, mesh, codebook=codebook)
    single = encode_plane(img, cfg)
    assert int((np.asarray(single.distance) <= 60.0).sum()) > 0
    for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sharded, f)), np.asarray(getattr(single, f)),
            err_msg=f"backend={backend} codebook={codebook} field={f}",
        )


@pytest.mark.parametrize("strategy", ["domains", "ring"])
def test_sharded_exact_fit_ends_scan_at_threshold_zero(devices_ok, strategy):
    """At rms_threshold 0 an exact fit (distance 0) still ends the
    reference's scan, so the cross-shard combine must stop at the first
    shard with such a hit, as one device does: on this seeded image a later
    shard holds exact fits whose keys round higher than the first one's."""
    from fractencode_tpu.image.synth import natural_image

    img = natural_image(603, 512, 512)
    cfg = EncoderConfig()
    single = encode_plane(img, cfg)
    assert int((np.asarray(single.distance) == 0).sum()) > 0, "vacuous"
    mesh = make_mesh(n_data=1, n_search=4, devices=jax.devices()[:4])
    res = encode_batch_sharded(img[None], cfg, mesh, strategy=strategy)[0]
    for f in ("domain_idx", "transform", "s", "o", "distance", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(res, f)),
                                      np.asarray(getattr(single, f)),
                                      err_msg=f"strategy={strategy} {f}")
