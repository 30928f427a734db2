"""Image IO + YUV420 conversion tests.

Ports the reference's ``ImageIOTest.cpp:8-24`` (plane shapes after YUV420
split, load->save smoke) and pins the conversion quirks this repo documents:
last-sample-wins chroma subsampling (``ImageIO.cpp:54-55``) and the exact
BT.601-flavoured coefficients (``ImageIO.cpp:50-52,79-81``).
"""
import numpy as np
import pytest
from PIL import Image

from fractencode_tpu.image import load_gray, load_planes, save_plane, save_yuv
from fractencode_tpu.image.yuv import rgb_to_yuv420, yuv420_to_rgb

LENNA = "/root/reference/tests/input/lenna512x512.png"


def test_yuv420_plane_shapes():
    """ImageIOTest.cpp:8-16 — Y is full size, U/V are quarter size."""
    if not __import__("os").path.exists(LENNA):
        pytest.skip("lenna fixture not available")
    y, u, v = load_planes(LENNA)
    assert y.shape == (512, 512)
    assert u.shape == (256, 256)
    assert v.shape == (256, 256)
    assert y.dtype == u.dtype == v.dtype == np.uint8


def test_load_save_roundtrip_smoke(tmp_path):
    """ImageIOTest.cpp:18-24 — save and reload must preserve the gray plane
    exactly (PNG is lossless; grayscale save path is identity)."""
    rng = np.random.default_rng(7)
    plane = rng.integers(0, 256, size=(32, 48), dtype=np.uint8)
    p = tmp_path / "roundtrip.png"
    save_plane(plane, str(p))
    back = np.asarray(Image.open(p))
    np.testing.assert_array_equal(back, plane)


def test_y_coefficients_exact():
    """Y = 0.299 r + 0.587 g + 0.114 b, clamp + truncate (ImageIO.cpp:50,11-13)."""
    rgb = np.zeros((2, 2, 3), np.uint8)
    rgb[0, 0] = (255, 0, 0)
    rgb[0, 1] = (0, 255, 0)
    rgb[1, 0] = (0, 0, 255)
    rgb[1, 1] = (255, 255, 255)
    y, _, _ = rgb_to_yuv420(rgb)
    assert y[0, 0] == int(0.299 * 255)
    assert y[0, 1] == int(0.587 * 255)
    assert y[1, 0] == int(0.114 * 255)
    # (0.299*255 + 0.587*255) + 0.114*255 rounds to exactly 255.0 in IEEE
    # double left-to-right order — the same value the reference binary
    # produces (pinned transitively by tests/test_reference_parity.py)
    assert y[1, 1] == 255


def test_chroma_last_sample_wins():
    """The reference writes U/V at (x//2, y//2) for EVERY pixel, so the
    bottom-right sample of each 2x2 cell is what survives (ImageIO.cpp:54-55)
    — not an average."""
    rgb = np.zeros((2, 2, 3), np.uint8)
    # three pixels blue-ish, the LAST (bottom-right) pixel red
    rgb[..., 2] = 255
    rgb[1, 1] = (255, 0, 0)
    _, u, v = rgb_to_yuv420(rgb)
    # expected from the last pixel only: r=255, g=0, b=0
    exp_u = np.uint8(np.clip(-0.169 * 255 + 128.0, 0, 255))
    exp_v = np.uint8(np.clip(0.499 * 255 + 128.0, 0, 255))
    assert u[0, 0] == exp_u
    assert v[0, 0] == exp_v


def test_yuv_to_rgb_coefficients():
    """yuv2rgb (ImageIO.cpp:79-81): gray (u=v=128) maps to r=g=b=y."""
    y = np.full((4, 4), 77, np.uint8)
    u = np.full((2, 2), 128, np.uint8)
    v = np.full((2, 2), 128, np.uint8)
    rgb = yuv420_to_rgb(y, u, v)
    assert rgb.shape == (4, 4, 3)
    np.testing.assert_array_equal(rgb, np.full((4, 4, 3), 77, np.uint8))


def test_rgb_yuv_roundtrip_close():
    """Full-color roundtrip is lossy (420 subsampling + integer clamp) but
    should stay within a few gray levels on smooth content."""
    ys, xs = np.mgrid[0:16, 0:16]
    rgb = np.stack([ys * 8, xs * 8, (ys + xs) * 4], axis=-1).astype(np.uint8)
    y, u, v = rgb_to_yuv420(rgb)
    back = yuv420_to_rgb(y, u, v)
    assert np.abs(back.astype(int) - rgb.astype(int)).max() <= 24


def test_save_yuv_color_png(tmp_path):
    y = np.full((4, 4), 77, np.uint8)
    u = np.full((2, 2), 128, np.uint8)
    v = np.full((2, 2), 128, np.uint8)
    p = tmp_path / "c.png"
    save_yuv(y, u, v, str(p))
    img = np.asarray(Image.open(p))
    assert img.shape == (4, 4, 3)
    np.testing.assert_array_equal(img, np.full((4, 4, 3), 77, np.uint8))


def test_load_gray_matches_y_plane(tmp_path):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    p = tmp_path / "in.png"
    Image.fromarray(rgb, mode="RGB").save(p)
    y, _, _ = load_planes(str(p))
    np.testing.assert_array_equal(load_gray(str(p)), y)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA"])
@pytest.mark.parametrize("opts", [{}, {"optimize": True}, {"compress_level": 0}])
def test_stdlib_png_reads_what_pillow_writes(tmp_path, mode, opts):
    """The zlib+numpy PNG reader decodes Pillow's files (adaptive filters:
    Sub, Up, Average, Paeth) to exactly Pillow's pixels."""
    from fractencode_tpu.image.io import read_png
    from fractencode_tpu.image.synth import natural_image

    rgb = natural_image(5, 37, 29, color=True)
    img = Image.fromarray(rgb, "RGB").convert(mode)
    p = tmp_path / "x.png"
    img.save(p, **opts)
    np.testing.assert_array_equal(read_png(str(p)), np.asarray(Image.open(p)))
    y_ours = load_gray(str(p))
    y_pil = rgb_to_yuv420(np.asarray(Image.open(p).convert("RGB")))[0]
    np.testing.assert_array_equal(y_ours, y_pil)


@pytest.mark.parametrize("shape", [(19, 23), (16, 24, 3)])
def test_stdlib_png_writes_what_pillow_reads(tmp_path, shape):
    from fractencode_tpu.image.io import read_png, write_png

    img = np.random.default_rng(3).integers(0, 256, size=shape, dtype=np.uint8)
    p = str(tmp_path / "y.png")
    write_png(p, img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    np.testing.assert_array_equal(read_png(p), img)


def test_golden_pngs_decode_like_pillow():
    import glob
    import os

    from fractencode_tpu.image.io import read_png

    golden = os.path.join(os.path.dirname(__file__), "golden")
    files = sorted(glob.glob(os.path.join(golden, "*.png")))
    assert files
    for f in files:
        np.testing.assert_array_equal(read_png(f), np.asarray(Image.open(f)))


def test_other_formats_name_the_missing_package(tmp_path, monkeypatch):
    import sys

    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "x.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        load_gray(str(tmp_path / "x.jpg"))
