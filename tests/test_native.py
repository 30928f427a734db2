"""Native C++ bit-packer vs the numpy oracle (same pattern as the
reference's CPU-vs-GPU classifier parity test, OpenCLTest.cpp:106-111)."""
import numpy as np
import pytest

from fractencode_tpu.codec.bitstream import _bits_to_ints, _ints_to_bits
from fractencode_tpu.codec.native import (
    get_lib,
    pack_items_native,
    unpack_items_native,
)

pytestmark = pytest.mark.skipif(get_lib() is None, reason="no C++ toolchain")


def _numpy_pack(dom, tr, sq, oq, valid, d_bits, t_bits, s_bits, o_bits):
    bits = np.concatenate(
        [
            valid.astype(np.uint8)[:, None],
            _ints_to_bits(dom, d_bits),
            _ints_to_bits(tr, t_bits),
            _ints_to_bits(sq, s_bits),
            _ints_to_bits(oq, o_bits),
        ],
        axis=1,
    )
    return np.packbits(bits.reshape(-1)).tobytes()


@pytest.mark.parametrize("widths", [(9, 3, 5, 7), (17, 3, 5, 7), (1, 1, 2, 2)])
def test_pack_matches_numpy(rng, widths):
    d_bits, t_bits, s_bits, o_bits = widths
    n = 1000
    dom = rng.integers(0, 1 << d_bits, n).astype(np.uint32)
    tr = rng.integers(0, 1 << t_bits, n).astype(np.uint32)
    sq = rng.integers(0, 1 << s_bits, n).astype(np.uint32)
    oq = rng.integers(0, 1 << o_bits, n).astype(np.uint32)
    valid = rng.integers(0, 2, n).astype(bool)

    native = pack_items_native(dom, tr, sq, oq, valid, d_bits, t_bits, s_bits, o_bits)
    ref = _numpy_pack(dom, tr, sq, oq, valid, d_bits, t_bits, s_bits, o_bits)
    assert native == ref


def test_roundtrip(rng):
    d_bits, t_bits, s_bits, o_bits = 11, 3, 5, 7
    n = 4096
    dom = rng.integers(0, 1 << d_bits, n).astype(np.uint32)
    tr = rng.integers(0, 1 << t_bits, n).astype(np.uint32)
    sq = rng.integers(0, 1 << s_bits, n).astype(np.uint32)
    oq = rng.integers(0, 1 << o_bits, n).astype(np.uint32)
    valid = rng.integers(0, 2, n).astype(bool)

    blob = pack_items_native(dom, tr, sq, oq, valid, d_bits, t_bits, s_bits, o_bits)
    dom2, tr2, sq2, oq2, valid2 = unpack_items_native(
        blob, n, d_bits, t_bits, s_bits, o_bits
    )
    np.testing.assert_array_equal(dom, dom2)
    np.testing.assert_array_equal(tr, tr2)
    np.testing.assert_array_equal(sq, sq2)
    np.testing.assert_array_equal(oq, oq2)
    np.testing.assert_array_equal(valid, valid2)

def test_rebuilt_when_source_hash_changes(tmp_path, monkeypatch):
    """The library is rebuilt from source whenever the source's content
    hash differs from the recorded one (checkouts do not keep mtimes), and
    only then."""
    import shutil

    from fractencode_tpu.codec import native

    src = tmp_path / "bitpack.cpp"
    so = tmp_path / "_bitpack.so"
    stamp = tmp_path / "_bitpack.sha256"
    shutil.copy(native._SRC, src)
    builds = []
    real_build = native._build
    monkeypatch.setattr(native, "_build",
                        lambda s, o: builds.append(s) or real_build(s, o))
    args = (str(src), str(so), str(stamp))
    assert native._ensure_built(*args) and so.exists() and len(builds) == 1
    assert native._ensure_built(*args) and len(builds) == 1  # hash unchanged
    os_mtime = so.stat().st_mtime
    src.write_text(src.read_text() + "\n// changed\n")
    assert native._ensure_built(*args) and len(builds) == 2
    assert so.stat().st_mtime >= os_mtime
    stamp.unlink()  # a binary of unknown provenance is rebuilt too
    assert native._ensure_built(*args) and len(builds) == 3
