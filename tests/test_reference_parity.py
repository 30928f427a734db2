"""Bit-exact parity against the compiled C++ reference.

Golden fixtures in ``tests/golden/`` were produced by the reference binary
(sebsgit/fractencode built with ``-ffp-contract=off`` so the compiler does
not fuse the YUV multiply-adds into FMAs — with FMA contraction the binary's
Y plane diverges from its own source semantics on a handful of pixels) run on
``lenna128_input.png`` with default parameters (16x16 domains step 8, 4x4
ranges, 4 transforms, classifier on, rmsThreshold 0, sMax -1):

  * ``lenna128_cpp_encode.txt.gz`` — per-range dump of ``encode_item_t``:
    x y w h  dom_x dom_y dom_w dom_h  transform  s o distance
  * ``lenna128_cpp_result.png`` — the decoded output image.

These tests pin: winning (domain, transform) per range (scan order +
tie-breaks), (s, o) to float precision, raw distances exactly, and the
decoded image bit-for-bit.
"""
import gzip
import os

import numpy as np
import pytest

from fractencode_tpu import REFERENCE_COMPAT, decode_plane, encode_plane
from fractencode_tpu.image import load_gray

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def cpp_dump():
    path = os.path.join(GOLDEN, "lenna128_cpp_encode.txt.gz")
    with gzip.open(path, "rt") as f:
        dump = np.loadtxt(f)
    # reorder per-engine completion order -> row-major range order
    rx = (dump[:, 0] // 4).astype(int)
    ry = (dump[:, 1] // 4).astype(int)
    out = np.zeros_like(dump)
    out[ry * 32 + rx] = dump
    return out


@pytest.fixture(scope="module")
def our_result():
    y = load_gray(os.path.join(GOLDEN, "lenna128_input.png"))
    return y, encode_plane(y, REFERENCE_COMPAT())


def test_encoder_parity(cpp_dump, our_result):
    _, res = our_result
    nx = (128 - 16) // 8 + 1
    dom_idx_cpp = (cpp_dump[:, 5] // 8).astype(int) * nx + (cpp_dump[:, 4] // 8).astype(int)
    assert np.array_equal(np.asarray(res.domain_idx), dom_idx_cpp)
    assert np.array_equal(np.asarray(res.transform), cpp_dump[:, 8].astype(int))
    # distances are exact in f32 for 4x4 ranges; (s, o) agree to f32 rounding
    np.testing.assert_allclose(np.asarray(res.distance), cpp_dump[:, 11], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.s), cpp_dump[:, 9], rtol=0, atol=5e-4)
    np.testing.assert_allclose(np.asarray(res.o), cpp_dump[:, 10], rtol=0, atol=0.1)


def test_decode_parity_from_cpp_encode(cpp_dump):
    """Our decoder on the C++ encoder's output must be pixel-identical to the
    C++ decoder's result.png."""
    import jax.numpy as jnp
    from PIL import Image

    from fractencode_tpu.encode.encoder import EncodeResult

    nx = (128 - 16) // 8 + 1
    dom_idx = (cpp_dump[:, 5] // 8).astype(int) * nx + (cpp_dump[:, 4] // 8).astype(int)
    res = EncodeResult(
        domain_idx=jnp.asarray(dom_idx, jnp.int32),
        transform=jnp.asarray(cpp_dump[:, 8].astype(int), jnp.int32),
        s=jnp.asarray(cpp_dump[:, 9], jnp.float32),
        o=jnp.asarray(cpp_dump[:, 10], jnp.float32),
        distance=jnp.asarray(cpp_dump[:, 11], jnp.float32),
        valid=jnp.ones(len(cpp_dump), bool),
        width=128, height=128, source_size=16, target_size=4, domain_step=8,
    )
    out, iters, _ = decode_plane(res)
    ref = np.asarray(Image.open(os.path.join(GOLDEN, "lenna128_cpp_result.png")).convert("L"))
    assert np.array_equal(np.asarray(out), ref)
    assert int(iters) == 16  # reference printed "decode stats: 16 steps"


def test_end_to_end_parity(our_result):
    """Compat encode + decode fully in our framework == C++ result.png."""
    from PIL import Image

    _, res = our_result
    out, _, _ = decode_plane(res)
    ref = np.asarray(Image.open(os.path.join(GOLDEN, "lenna128_cpp_result.png")).convert("L"))
    assert np.array_equal(np.asarray(out), ref)


def _load_dump(name):
    path = os.path.join(GOLDEN, name)
    with gzip.open(path, "rt") as f:
        dump = np.loadtxt(f)
    rx = (dump[:, 0] // 4).astype(int)
    ry = (dump[:, 1] // 4).astype(int)
    out = np.zeros_like(dump)
    out[ry * 32 + rx] = dump
    return out


_FLAG_CONFIGS = {
    # reference flags -> (our config overrides, dump golden, result golden)
    "rms10": (dict(rms_threshold=10.0), "lenna128_cpp_rms10.txt.gz",
              "lenna128_cpp_result_rms10.png"),
    "smax09": (dict(s_max=0.9), "lenna128_cpp_smax09.txt.gz",
               "lenna128_cpp_result_smax09.png"),
    "nocls": (dict(use_classifier=False), "lenna128_cpp_nocls.txt.gz",
              "lenna128_cpp_result_nocls.png"),
}


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"],
                         ids=["jnp", "pallas"])
@pytest.mark.parametrize("name", sorted(_FLAG_CONFIGS))
def test_encoder_parity_flag_matrix(name, backend):
    """Winner parity for the reference's non-default flags: --rms > 0
    (early-accept frontier, TransformEstimator2.hpp:40-41 +
    transformmatcher.h:55-56), --smax (truncateSMax clamp,
    transformmatcher.h:27-31), --noclassifier (DummyClassifier,
    Classifier2.hpp:41-49).  Goldens regenerated from the patched reference
    binary (scripts/build_reference.sh + the dump patch in BASELINE.md).
    Both routes must hit the goldens — the kernel (in the Pallas
    interpreter here) pins the in-kernel early-accept frontier and clamp
    epilogues."""
    overrides, dump_name, _ = _FLAG_CONFIGS[name]
    dump = _load_dump(dump_name)
    y = load_gray(os.path.join(GOLDEN, "lenna128_input.png"))
    res = encode_plane(y, REFERENCE_COMPAT(backend=backend, **overrides))
    nx = (128 - 16) // 8 + 1
    dom_idx_cpp = (dump[:, 5] // 8).astype(int) * nx + (dump[:, 4] // 8).astype(int)
    assert np.array_equal(np.asarray(res.domain_idx), dom_idx_cpp)
    assert np.array_equal(np.asarray(res.transform), dump[:, 8].astype(int))
    np.testing.assert_allclose(np.asarray(res.distance), dump[:, 11],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.s), dump[:, 9], rtol=0, atol=5e-4)
    np.testing.assert_allclose(np.asarray(res.o), dump[:, 10], rtol=0, atol=0.1)


@pytest.mark.parametrize("name", sorted(_FLAG_CONFIGS))
def test_decode_parity_flag_matrix(name):
    """Our full encode+decode under each flag config == the C++ result.png.

    The smax config tolerates <=2 pixels off by 1 gray level: clamped
    winners store s = f32(0.9) = 0.8999999762 while the reference applies
    DOUBLE 0.9 in its decoder (truncateSMax, transformmatcher.h:27-31 +
    DecodeUtils.hpp:22), and one Lenna pixel's s*v + o lands exactly on the
    integer truncation boundary between the two.  Unclamped configs are
    pixel-exact (s is correctly rounded from exact integer rationals; see
    solve_so)."""
    from PIL import Image

    overrides, _, result_name = _FLAG_CONFIGS[name]
    y = load_gray(os.path.join(GOLDEN, "lenna128_input.png"))
    res = encode_plane(y, REFERENCE_COMPAT(**overrides))
    out, _, _ = decode_plane(res)
    ref = np.asarray(Image.open(os.path.join(GOLDEN, result_name)).convert("L"))
    diff = np.abs(np.asarray(out).astype(int) - ref.astype(int))
    if name == "smax09":
        assert (diff > 0).sum() <= 2 and diff.max() <= 1, (
            (diff > 0).sum(), diff.max())
    else:
        assert np.array_equal(np.asarray(out), ref)
