"""The Pallas search kernel vs the plain ``search``, with the kernel run by
the Pallas interpreter on the CPU (the compiled kernel runs on the GPU:
``chip_smoke.py`` and the ``gpu``-marked test below)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from fractencode_tpu.core.grid import uniform_grid
from fractencode_tpu.encode.codebook import build_codebook, extract_ranges
from fractencode_tpu.encode.matcher import search, search_kernel
from fractencode_tpu.params import EncoderConfig

FIELDS = ("domain_idx", "transform", "valid", "s", "o", "distance")


def _setup(rng, n=64, cfg=None, img=None):
    cfg = cfg or EncoderConfig()
    if img is None:
        img = rng.integers(0, 256, size=(n, n), dtype=np.uint8)
    n = img.shape[0]
    plane = jnp.asarray(img, jnp.float32)
    dg = uniform_grid(n, n, cfg.source_size, cfg.domain_step)
    cb = build_codebook(plane, dg, cfg.target_size, cfg.num_transforms)
    ranges = extract_ranges(plane, cfg.target_size)
    sum_a = ranges.sum(axis=-1)
    sum_a2 = (ranges * ranges).sum(axis=-1)
    if cfg.use_classifier:
        from fractencode_tpu.core.classify import classify_grid

        rg = uniform_grid(n, n, cfg.target_size, cfg.target_size)
        rcls = classify_grid(jnp.asarray(img), rg)
        dcls = classify_grid(jnp.asarray(img), dg)
    else:
        rcls = dcls = None
    return ranges, sum_a, sum_a2, cb, rcls, dcls


def _assert_same(a, b, fields=FIELDS, msg=""):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{msg} field={f}")


@pytest.mark.parametrize("cfg", [
    EncoderConfig(),
    EncoderConfig(use_classifier=False),
    EncoderConfig(criterion="raw", so_mode="reference"),
    EncoderConfig(num_transforms=8),
    EncoderConfig(s_max=1.0),
    # 8x8 ranges (K=64, the int8 route's widest), full 8-isometry search, no
    # classifier: the dense case is the same kernel with one class
    EncoderConfig(target_size=8, num_transforms=8, use_classifier=False),
    # 16x16 ranges (K=256): the f32 dot route
    EncoderConfig(source_size=32, target_size=16),
])
def test_pallas_matches_oracle(rng, cfg):
    args = _setup(rng, 64, cfg)
    oracle = search(*args, cfg)
    kernel = search_kernel(*args, cfg, interpret=True)
    # winners, (s, o) and distance are bit-identical: (s, o) and above
    # K=64 the distance come from the winner's exact SumAB on both routes
    _assert_same(kernel, oracle)


def test_pallas_backend_end_to_end(rng):
    """encode_plane with backend='pallas_interpret' matches jnp."""
    from fractencode_tpu import encode_plane

    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    res_jnp = encode_plane(img, EncoderConfig(backend="jnp"))
    res_pl = encode_plane(img, EncoderConfig(backend="pallas_interpret"))
    _assert_same(res_pl, res_jnp)


@pytest.mark.parametrize("cfg", [
    EncoderConfig(),
    EncoderConfig(criterion="raw", so_mode="reference"),
    EncoderConfig(num_transforms=8),
])
def test_classed_kernel_matches_oracle(rng, cfg):
    """Class-sorted kernel == masked oracle on content with flat (clipped)
    blocks, where whole classes and exact-fit ties occur."""
    from fractencode_tpu.image.synth import natural_image

    args = _setup(rng, cfg=cfg, img=natural_image(3, 64, 64))
    _assert_same(search_kernel(*args, cfg, interpret=True), search(*args, cfg))


def test_classed_kernel_lenna(lenna_y):
    """Real-image class distribution (including -1 ties) on a Lenna crop."""
    cfg = EncoderConfig()
    args = _setup(None, cfg=cfg, img=np.asarray(lenna_y)[:64, :64])
    _assert_same(search_kernel(*args, cfg, interpret=True), search(*args, cfg))


def test_exact_fit_at_threshold_zero(rng):
    """At rms_threshold 0 an exact fit (distance 0: a flat range, or a range
    that is an affine copy of a domain sample) still stops the reference's
    scan.  The kernel must apply that frontier too: a flat range's winner
    is the first transform of its first same-class domain, not the first
    search-order column."""
    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    img[:16, :16] = 0  # flat ranges with flat domains of the same class
    cfg = EncoderConfig()
    args = _setup(rng, cfg=cfg, img=img)
    oracle = search(*args, cfg)
    assert int((np.asarray(oracle.distance) == 0).sum()) > 0, "vacuous"
    _assert_same(search_kernel(*args, cfg, interpret=True), oracle)


def test_int8_path_bit_identical_at_k64(rng):
    """K=64 (8x8 ranges) is the widest contraction the exact int8 SumAB
    decomposition takes (INT8_MAX_K); winners and distances must be
    bit-identical to the plain route's f32 dot there."""
    from fractencode_tpu.ops.rank import INT8_MAX_K
    from fractencode_tpu.ops.search_kernel import padded_k, use_int8

    cfg = EncoderConfig(source_size=32, target_size=8)
    assert use_int8(64) and not use_int8(65) and INT8_MAX_K == 64
    assert padded_k(64) == 64 and padded_k(16) == 32 and padded_k(256) == 256
    args = _setup(rng, 128, cfg)
    _assert_same(search_kernel(*args, cfg, interpret=True), search(*args, cfg))


def test_encode_batch_vmapped_prep_matches_single(rng):
    """The batch path (lax.map over frames) must equal per-frame
    encode_plane bitwise, on the kernel route and on the plain route."""
    from fractencode_tpu import encode_plane
    from fractencode_tpu.encode import encode_batch

    imgs = rng.integers(0, 256, size=(3, 64, 64), dtype=np.uint8)
    for backend in ("pallas_interpret", "jnp"):
        cfg = EncoderConfig(backend=backend)
        outs = encode_batch(imgs, cfg)
        for i in range(3):
            _assert_same(outs[i], encode_plane(imgs[i], cfg), msg=backend)


@pytest.mark.parametrize("use_classifier", [False, True])
@pytest.mark.parametrize("threshold", [50.0, 500.0])
def test_threshold_frontier_matches_oracle(rng, threshold, use_classifier):
    """rms_threshold > 0 in the kernel (default 'ls' rank mode): the
    early-accept frontier (prefix mask + per-row freeze,
    ops.rank.apply_frontier) must reproduce select_best's oracle winners
    bitwise — including the within-domain transform suffix rule
    (transformmatcher.h:55-56)."""
    from numpy.lib.stride_tricks import sliding_window_view

    from fractencode_tpu.encode.encoder import _encode_plane_impl

    base = rng.integers(0, 256, size=(64, 64)).astype(np.float32)
    pad = np.pad(base, 2, mode="edge")
    img = sliding_window_view(pad, (5, 5)).reshape(64, 64, 25).mean(axis=2)
    img = img.astype(np.uint8)

    cfg_o = EncoderConfig(backend="jnp", rms_threshold=threshold,
                          use_classifier=use_classifier)
    cfg_p = dataclasses.replace(cfg_o, backend="pallas_interpret")
    ro = _encode_plane_impl(jnp.asarray(img), cfg_o)
    rp = _encode_plane_impl(jnp.asarray(img), cfg_p)
    assert int((np.asarray(ro.distance) <= threshold).sum()) > 0, "vacuous"
    _assert_same(rp, ro, msg=f"threshold={threshold} cls={use_classifier}")


def test_masks_park_rows_and_columns(rng):
    """domain_mask and range_mask park their entries in bins no tile
    visits; the kernel must equal the oracle's post-masked search."""
    cfg = EncoderConfig()
    args = _setup(rng, 64, cfg)
    d = args[3].values.shape[0]
    r = args[0].shape[0]
    dmask = jnp.asarray(np.arange(d) % 5 != 0)
    rmask = jnp.asarray(np.arange(r) % 3 != 0)
    kw = dict(domain_mask=dmask, range_mask=rmask)
    _assert_same(search_kernel(*args, cfg, interpret=True, **kw),
                 search(*args, cfg, **kw))


@pytest.mark.parametrize("blocks", [(16, 32, 4, 2), (32, 64, 4, 2)])
def test_tile_choice_does_not_change_winners(rng, blocks):
    """Tile sizes are a speed choice only: any (block_r, block_m) gives the
    same result."""
    cfg = EncoderConfig()
    args = _setup(rng, 64, cfg)
    _assert_same(search_kernel(*args, cfg, interpret=True, blocks=blocks),
                 search(*args, cfg))


@pytest.mark.gpu
def test_compiled_kernel_matches_oracle(rng):
    """The compiled kernel (Triton) on the card; chip_smoke.py runs the
    same comparison at real widths."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled kernel has no CPU route")
    cfg = EncoderConfig()
    args = _setup(rng, 128, cfg)
    _assert_same(search_kernel(*args, cfg), search(*args, cfg))


@pytest.mark.parametrize("min_programs", [1, 64])
def test_column_splits_do_not_change_winners(rng, monkeypatch, min_programs):
    """With few range tiles the kernel splits each tile's column walk over
    several programs (ops.search_kernel._splits); one split and many give
    the same result, frontier included."""
    from fractencode_tpu.encode import matcher
    from fractencode_tpu.ops import search_kernel as sk

    monkeypatch.setattr(sk, "MIN_PROGRAMS", min_programs)
    sk.fused_search.clear_cache()
    matcher.search_kernel.clear_cache()
    try:
        for cfg in (EncoderConfig(), EncoderConfig(rms_threshold=200.0)):
            args = _setup(rng, 64, cfg)
            _assert_same(search_kernel(*args, cfg, interpret=True),
                         search(*args, cfg), msg=f"{min_programs} {cfg}")
    finally:
        sk.fused_search.clear_cache()
        matcher.search_kernel.clear_cache()


def test_combine_splits_scan_order():
    """Per-split winners combine in scan order: splits after the first one
    whose frontier was hit drop out; otherwise the highest key wins, ties
    to the lowest split."""
    from fractencode_tpu.ops.search_kernel import _splits, combine_splits

    q = jnp.asarray([[1.0, 5.0, 2.0, -3e38],
                     [3.0, 5.0, 9.0, -3e38],
                     [7.0, 1.0, 9.0, -3e38]])
    idx = jnp.asarray([[10, 11, 12, 0], [20, 21, 22, 0], [30, 31, 32, 0]])
    hit = jnp.asarray([[0, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0]])
    qw, iw = combine_splits(q, idx, hit)
    # row 0: split 1 hit -> split 2 (key 7) drops out, best of 0..1 is 3
    np.testing.assert_array_equal(np.asarray(iw), [20, 11, 22, 0])
    np.testing.assert_array_equal(np.asarray(qw),
                                  np.float32([3.0, 5.0, 9.0, -3e38]))
    assert _splits(1000, 500) == 1 and _splits(10, 500) == 53
    assert _splits(10, 3) == 1 and _splits(1, 8) == 4
