"""LBG/k-means codebook trainer (behavioral port of the reference's
CodebookGeneratorTests, tests/CodebookGeneratorTests.cpp:7-45)."""
import jax
import numpy as np

from fractencode_tpu.encode.vq import assign_codes, train_codebook


def test_codebook_size_and_bounds(rng):
    x = rng.uniform(0.0, 255.0, size=(500, 16)).astype(np.float32)
    cb, assign, steps = train_codebook(x, jax.random.key(0), num_codes=8)
    cb = np.asarray(cb)
    assert cb.shape == (8, 16)
    # codewords stay within the data's convex hull bounds
    assert cb.min() >= x.min() - 1e-3 and cb.max() <= x.max() + 1e-3
    assert int(steps) >= 1
    a = np.asarray(assign)
    assert a.min() >= 0 and a.max() < 8


def test_separable_clusters(rng):
    a = rng.normal(0.0, 1.0, size=(200, 4)).astype(np.float32)
    b = rng.normal(100.0, 1.0, size=(200, 4)).astype(np.float32)
    x = np.concatenate([a, b])
    cb, assign, _ = train_codebook(x, jax.random.key(1), num_codes=2)
    assign = np.asarray(assign)
    # each true cluster maps to a single codeword
    assert len(set(assign[:200])) == 1
    assert len(set(assign[200:])) == 1
    assert assign[0] != assign[200]
    centers = sorted(float(c.mean()) for c in np.asarray(cb))
    assert abs(centers[0] - 0.0) < 1.0 and abs(centers[1] - 100.0) < 1.0


def test_assign_is_nearest(rng):
    x = rng.uniform(0, 10, size=(50, 3)).astype(np.float32)
    cb = rng.uniform(0, 10, size=(4, 3)).astype(np.float32)
    got = np.asarray(assign_codes(x, cb))
    expect = ((x[:, None, :] - cb[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(got, expect)


def test_convergence_deterministic(rng):
    x = rng.uniform(0, 255, size=(300, 8)).astype(np.float32)
    cb1, a1, s1 = train_codebook(x, jax.random.key(7), num_codes=4)
    cb2, a2, s2 = train_codebook(x, jax.random.key(7), num_codes=4)
    np.testing.assert_array_equal(np.asarray(cb1), np.asarray(cb2))
    assert int(s1) == int(s2)

def test_vq_classes_n1_equals_noclassifier(rng):
    """--vq-classes 1 puts everything in one bin: winners must equal the
    unclassified full search exactly (the parity anchor for the VQ prune)."""
    import dataclasses

    from fractencode_tpu import EncoderConfig, encode_plane

    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    base = EncoderConfig(use_classifier=False)
    vq1 = dataclasses.replace(base, vq_classes=1)
    r0 = encode_plane(img, base)
    r1 = encode_plane(img, vq1)
    for f in ("domain_idx", "transform", "s", "o", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(r0, f)), np.asarray(getattr(r1, f)), err_msg=f)


def test_vq_classes_end_to_end(lenna_y):
    """--vq-classes N: encode+decode works, PSNR within a sane band of the
    brightness-classifier encode (lossy prune, but not catastrophic)."""
    import dataclasses

    from fractencode_tpu import DecoderConfig, EncoderConfig, decode_plane, encode_plane
    from fractencode_tpu.core.metrics import psnr

    img = np.asarray(lenna_y)[128:192, 128:192]
    r_bb = encode_plane(img, EncoderConfig())
    r_vq = encode_plane(img, EncoderConfig(vq_classes=4))
    p_bb = float(psnr(img, np.asarray(decode_plane(r_bb)[0])))
    p_vq = float(psnr(img, np.asarray(decode_plane(r_vq)[0])))
    assert p_vq > p_bb - 3.0, (p_vq, p_bb)


def test_vq_classes_backends_agree(rng):
    """VQ bins through the classed Pallas kernel (interpret) == jnp oracle."""
    from fractencode_tpu import EncoderConfig, encode_plane

    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    r_j = encode_plane(img, EncoderConfig(vq_classes=3, backend="jnp"))
    r_p = encode_plane(img, EncoderConfig(vq_classes=3, backend="pallas_interpret"))
    for f in ("domain_idx", "transform", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(r_j, f)), np.asarray(getattr(r_p, f)), err_msg=f)
