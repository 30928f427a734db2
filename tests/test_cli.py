"""CLI driver tests (in-process, small images, CPU)."""
import os

import numpy as np
import pytest
from PIL import Image

from fractencode_tpu.cli import main


@pytest.fixture()
def small_png(tmp_path, lenna_y):
    path = tmp_path / "small.png"
    Image.fromarray(np.asarray(lenna_y)[:64, :64], mode="L").save(path)
    return str(path)


def _run(args, tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        return main(args)
    finally:
        os.chdir(cwd)


def test_encode_decode_roundtrip(small_png, tmp_path, capsys):
    rc = _run([small_png, "--result", str(tmp_path / "out.png"),
               "--out", str(tmp_path / "c.ftc")], tmp_path)
    assert rc == 0
    out = capsys.readouterr().out
    assert "encoded in" in out and "psnr:" in out and "bitstream:" in out
    assert (tmp_path / "out.png").exists()
    assert (tmp_path / "c.ftc").exists()

    rc = _run(["--decode-file", str(tmp_path / "c.ftc"),
               "--result", str(tmp_path / "dec.png")], tmp_path)
    assert rc == 0
    assert (tmp_path / "dec.png").exists()
    dec = np.asarray(Image.open(tmp_path / "dec.png"))
    assert dec.shape == (64, 64)


def test_quadtree_flag(small_png, tmp_path, capsys):
    rc = _run([small_png, "--quadtree", "--qt-threshold", "40",
               "--result", str(tmp_path / "q.png"),
               "--out", str(tmp_path / "q.ftc")], tmp_path)
    assert rc == 0
    out = capsys.readouterr().out
    assert "leaves" in out
    # quadtree stream decodes through the same entry point (FTQ1 magic)
    rc = _run(["--decode-file", str(tmp_path / "q.ftc"),
               "--result", str(tmp_path / "qdec.png")], tmp_path)
    assert rc == 0
    assert (tmp_path / "qdec.png").exists()


def test_compat_flag(small_png, tmp_path, capsys):
    rc = _run([small_png, "--compat", "--result", str(tmp_path / "c.png")], tmp_path)
    assert rc == 0
    assert "psnr:" in capsys.readouterr().out


def test_invalid_sizes(small_png, tmp_path, capsys):
    rc = _run([small_png, "--source", "4", "--target", "8"], tmp_path)
    assert rc == 2
    assert "invalid source" in capsys.readouterr().err


def test_garbage_bitstream(tmp_path, capsys):
    bad = tmp_path / "bad.ftc"
    bad.write_bytes(b"garbage")
    rc = _run(["--decode-file", str(bad)], tmp_path)
    assert rc == 2
    assert "not a valid bitstream" in capsys.readouterr().err


def test_no_input(tmp_path, capsys):
    rc = _run([], tmp_path)
    assert rc == 2

def test_log_flag_prints_phases(small_png, tmp_path, capsys):
    rc = _run([small_png, "--log", "--result", str(tmp_path / "l.png")], tmp_path)
    assert rc == 0
    out = capsys.readouterr().out
    assert "-- phases --" in out and "encode:" in out and "decode:" in out


def test_color_flag_end_to_end(small_png, tmp_path, capsys):
    rc = _run([small_png, "--color", "--result", str(tmp_path / "rgb.png"),
               "--out", str(tmp_path / "c3.ftc")], tmp_path)
    assert rc == 0
    out = capsys.readouterr().out
    # three per-plane encodes reported
    assert "[Y]" in out and "[U]" in out and "[V]" in out
    img = np.asarray(Image.open(tmp_path / "rgb.png"))
    assert img.shape == (64, 64, 3)


@pytest.fixture()
def center_png(tmp_path, lenna_y):
    """Center crop: the corner crop's flat-texture content decodes poorly
    under unclamped |s| (reference semantics), which would mask real codec
    bugs behind a weak PSNR bound."""
    path = tmp_path / "center.png"
    Image.fromarray(np.asarray(lenna_y)[224:288, 224:288], mode="L").save(path)
    return str(path)


def test_color_bitstream_file_roundtrip(center_png, tmp_path, capsys):
    """--color --out -> --decode-file must reconstruct an RGB image from all
    three planes (cf. main.cpp:192-200, ImageIO.cpp:86-97); rounds 1-3 wrote
    bare concatenated streams and silently decoded only the Y plane."""
    rc = _run([center_png, "--color", "--result", str(tmp_path / "rgb.png"),
               "--out", str(tmp_path / "c3.ftc")], tmp_path)
    assert rc == 0
    capsys.readouterr()
    blob = (tmp_path / "c3.ftc").read_bytes()
    assert blob[:4] == b"FTCC"

    rc = _run(["--decode-file", str(tmp_path / "c3.ftc"),
               "--result", str(tmp_path / "cdec.png")], tmp_path)
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("decoded") == 3
    dec = np.asarray(Image.open(tmp_path / "cdec.png")).astype(np.float64)
    assert dec.shape == (64, 64, 3)
    src = np.asarray(Image.open(center_png).convert("RGB")).astype(np.float64)
    mse = ((dec - src) ** 2).mean()
    psnr = 10.0 * np.log10(255.0**2 / max(mse, 1e-9))
    assert psnr > 25.0, f"color file round-trip PSNR {psnr:.2f} dB"


def test_color_container_truncated_fails_loudly(small_png, tmp_path, capsys):
    rc = _run([small_png, "--color", "--result", str(tmp_path / "rgb.png"),
               "--out", str(tmp_path / "c3.ftc")], tmp_path)
    assert rc == 0
    capsys.readouterr()
    blob = (tmp_path / "c3.ftc").read_bytes()
    (tmp_path / "trunc.ftc").write_bytes(blob[: len(blob) - 7])
    rc = _run(["--decode-file", str(tmp_path / "trunc.ftc"),
               "--result", str(tmp_path / "t.png")], tmp_path)
    assert rc == 2
    assert "not a valid bitstream" in capsys.readouterr().err


def test_rejection_stats_histogram(small_png, tmp_path, capsys):
    """The CLI's rejection count must equal the brute-force [R, D] count
    (computed here on a small image; the CLI path must be O(R + D))."""
    rc = _run([small_png, "--result", str(tmp_path / "s.png")], tmp_path)
    assert rc == 0
    out = capsys.readouterr().out
    import re

    m = re.search(r"classifier rejected (\d+) out of (\d+)", out)
    assert m, out
    from fractencode_tpu.core.classify import classify_grid
    from fractencode_tpu.core.grid import uniform_grid
    from fractencode_tpu.image import load_gray

    plane = load_gray(small_png)
    rcls = np.asarray(classify_grid(plane, uniform_grid(64, 64, 4, 4)))
    dcls = np.asarray(classify_grid(plane, uniform_grid(64, 64, 16, 8)))
    brute = int((rcls[:, None] != dcls[None, :]).sum())
    assert int(m.group(1)) == brute
    assert int(m.group(2)) == len(rcls) * len(dcls)


def test_cli_round_trip_without_pillow(tmp_path, monkeypatch, capsys):
    """PNG in, .ftc out, PNG back, with Pillow unimportable: the main path
    needs no image library."""
    import sys

    from fractencode_tpu.image.io import read_png, write_png
    from fractencode_tpu.image.synth import natural_image

    src = str(tmp_path / "in.png")
    write_png(src, natural_image(2, 32, 48, color=True))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    rc = _run([src, "--color", "--out", str(tmp_path / "c.ftc"),
               "--result", str(tmp_path / "out.png")], tmp_path)
    assert rc == 0
    rc = _run(["--decode-file", str(tmp_path / "c.ftc"),
               "--result", str(tmp_path / "dec.png")], tmp_path)
    assert rc == 0
    assert read_png(str(tmp_path / "dec.png")).shape == (32, 48, 3)
    assert "psnr:" in capsys.readouterr().out
