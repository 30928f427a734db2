"""Matcher + estimator parity goldens.

Fixtures transcribed from /root/reference/tests/TransformMatcherTest.cpp and
tests/TransformEstimatorTest.cpp — they pin the ranking metric, the (s, o)
solve, scan order and tie-break semantics.
"""
import jax.numpy as jnp
import numpy as np

from fractencode_tpu.core.grid import Grid
from fractencode_tpu.core.transform import TransformType
from fractencode_tpu.encode.codebook import build_codebook, extract_ranges
from fractencode_tpu.encode.matcher import search, solve_so
from fractencode_tpu.params import REFERENCE_COMPAT

MATCHER_SOURCE = np.array(
    [
        [1, 1, 2, 2, 40, 41, 50, 51],
        [1, 1, 2, 2, 40, 41, 50, 51],
        [3, 3, 4, 4, 70, 71, 80, 81],
        [3, 3, 4, 4, 70, 71, 80, 81],
        [0, 0, 0, 0, 0, 0, 0, 0],
        [1, 1, 1, 1, 1, 1, 1, 1],
        [0, 0, 0, 0, 0, 0, 0, 0],
        [1, 1, 1, 1, 1, 1, 1, 1],
    ],
    dtype=np.uint8,
)

MATCHER_TARGET = np.array(
    [[2, 4, 40, 50], [1, 3, 70, 80], [0, 0, 0, 0], [1, 1, 1, 1]], dtype=np.uint8
)


def _run_search(source, domain_grid, target_blocks, cfg):
    cb = build_codebook(jnp.asarray(source, jnp.float32), domain_grid,
                        int(np.sqrt(target_blocks.shape[1])), cfg.num_transforms)
    ranges = jnp.asarray(target_blocks, jnp.float32)
    sum_a = ranges.sum(axis=-1)
    sum_a2 = (ranges * ranges).sum(axis=-1)
    return search(ranges, sum_a, sum_a2, cb, None, None, cfg)


def test_matcher_basic_match():
    """TransformMatcherTest.cpp:9-38: 4x4 source patch vs 2x2 target patch,
    best transform Rotate_270 with distance 0, s and o below 1."""
    cfg = REFERENCE_COMPAT(
        source_size=4, target_size=2, s_max=100.0, rms_threshold=0.0,
        use_classifier=False,
    )
    domain_grid = Grid(width=8, height=8, block_size=4, step=8)  # single item
    target_block = MATCHER_TARGET[0:2, 0:2].reshape(1, 4)
    res = _run_search(MATCHER_SOURCE, domain_grid, target_block, cfg)
    assert float(res.distance[0]) == 0.0
    assert int(res.transform[0]) == int(TransformType.ROT270)
    assert float(res.s[0]) < 1.0
    assert float(res.o[0]) < 1.0


ESTIMATOR_SOURCE = np.array(
    [
        [1, 1, 2, 2, 40, 41, 50, 51],
        [1, 1, 2, 2, 40, 41, 50, 51],
        [3, 3, 4, 4, 70, 71, 80, 81],
        [3, 3, 4, 4, 70, 71, 80, 81],
        [10, 10, 10, 10, 0, 0, 0, 0],
        [11, 11, 11, 11, 1, 1, 1, 1],
        [10, 10, 10, 10, 0, 0, 0, 0],
        [11, 11, 11, 11, 1, 1, 1, 1],
    ],
    dtype=np.uint8,
)

ESTIMATOR_TARGET = np.array(
    [[40, 50, 2, 4], [70, 80, 1, 3], [0, 0, 10, 10], [1, 1, 11, 11]], dtype=np.uint8
)

# range origin -> expected winning domain origin (TransformEstimatorTest.cpp:30-34)
ESTIMATOR_EXPECTED = {(0, 0): (4, 0), (2, 0): (0, 0), (0, 2): (4, 4), (2, 2): (0, 4)}


def test_estimator_winning_domains():
    cfg = REFERENCE_COMPAT(
        source_size=4, target_size=2, s_max=100.0, rms_threshold=0.0,
        use_classifier=False,
    )
    domain_grid = Grid(width=8, height=8, block_size=4, step=2)  # 3x3 = 9 items
    assert domain_grid.num_items == 9
    ranges = extract_ranges(jnp.asarray(ESTIMATOR_TARGET, jnp.float32), 2)
    res = _run_search(ESTIMATOR_SOURCE, domain_grid, np.asarray(ranges), cfg)

    ox, oy = domain_grid.origins()
    range_origins = [(0, 0), (2, 0), (0, 2), (2, 2)]  # row-major range order
    for r, origin in enumerate(range_origins):
        d = int(res.domain_idx[r])
        got = (int(ox[d]), int(oy[d]))
        assert got == ESTIMATOR_EXPECTED[origin], (origin, got)


def test_solve_so_reference_quirk():
    """The 'reference' mode keeps the (SumA-1)*SumA denominator
    (transformmatcher.h:103); 'ls' uses the textbook SumB-based one."""
    n = 4.0
    sum_a, sum_a2 = 10.0, 30.0
    sum_b, sum_b2, sum_ab = 8.0, 20.0, 22.0
    s_ref, o_ref = solve_so(sum_a, sum_a2, sum_b, sum_b2, sum_ab, n, "reference", -1.0)
    den_ref = n * sum_a2 - (sum_a - 1.0) * sum_a
    np.testing.assert_allclose(float(s_ref), (n * sum_ab - sum_a * sum_b) / den_ref)
    np.testing.assert_allclose(float(o_ref), (sum_b - float(s_ref) * sum_a) / n)

    s_ls, o_ls = solve_so(sum_a, sum_a2, sum_b, sum_b2, sum_ab, n, "ls", -1.0)
    den_ls = n * sum_b2 - sum_b * sum_b
    np.testing.assert_allclose(float(s_ls), (n * sum_ab - sum_a * sum_b) / den_ls)
    np.testing.assert_allclose(float(o_ls), (sum_a - float(s_ls) * sum_b) / n)


def test_solve_so_smax_clamp():
    s, _ = solve_so(10.0, 30.0, 8.0, 20.0, 29.0, 4.0, "reference", 0.05)
    assert abs(float(s)) <= 0.05 + 1e-7


def test_raw_distance_normalized_by_domain_area():
    """metrics.h:49 divides by sliceA (domain) area even though the sum runs
    over range pixels."""
    cfg = REFERENCE_COMPAT(
        source_size=4, target_size=2, use_classifier=False, s_max=-1.0
    )
    source = np.zeros((4, 4), dtype=np.uint8)
    target_block = np.full((1, 4), 2, dtype=np.uint8)  # each diff = 2
    grid = Grid(width=4, height=4, block_size=4, step=4)
    res = _run_search(source, grid, target_block, cfg)
    # sum of squared diffs = 4 * 4 = 16, normalized by domain area 16 -> 1.0
    np.testing.assert_allclose(float(res.distance[0]), 1.0)


def test_pallas_backend_threshold_native(rng):
    """rms_threshold > 0 runs IN the Pallas kernel (no oracle fallback, no
    warning): the early-accept frontier is a prefix mask + per-row freeze
    (ops.rank.apply_frontier) and must equal the oracle bitwise
    — here in the reference-compat 'raw' rank mode."""
    import warnings

    from fractencode_tpu import EncoderConfig, encode_plane

    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    cfg_p = EncoderConfig(rms_threshold=30.0, backend="pallas_interpret",
                          criterion="raw", so_mode="reference")
    cfg_j = EncoderConfig(rms_threshold=30.0, backend="jnp",
                          criterion="raw", so_mode="reference")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res_p = encode_plane(img, cfg_p)
    assert not any("rms_threshold" in str(w.message) for w in caught)
    res_j = encode_plane(img, cfg_j)
    np.testing.assert_array_equal(
        np.asarray(res_p.domain_idx), np.asarray(res_j.domain_idx)
    )
    np.testing.assert_array_equal(
        np.asarray(res_p.transform), np.asarray(res_j.transform)
    )
    np.testing.assert_array_equal(np.asarray(res_p.s), np.asarray(res_j.s))
    np.testing.assert_array_equal(
        np.asarray(res_p.distance), np.asarray(res_j.distance)
    )


def test_threshold_changes_winners(lenna_y):
    """A nonzero threshold must actually engage the early-accept frontier
    (first domain whose best distance <= threshold wins, even when a later
    domain is strictly better).  Natural-image distances on Lenna sit in the
    3..35 range (see the rms10 golden), so threshold 10 stops many scans."""
    from fractencode_tpu import EncoderConfig, encode_plane

    img = np.asarray(lenna_y)[:64, :64]
    res0 = encode_plane(img, EncoderConfig(criterion="raw", so_mode="reference",
                                           backend="jnp"))
    res1 = encode_plane(img, EncoderConfig(criterion="raw", so_mode="reference",
                                           backend="jnp", rms_threshold=10.0))
    d0 = np.asarray(res0.domain_idx)
    d1 = np.asarray(res1.domain_idx)
    assert (d0 != d1).any()  # the frontier stopped some scans early
    # and every early-accepted winner is at or below the threshold
    changed = d0 != d1
    assert (np.asarray(res1.distance)[changed] <= 10.0).all()
