"""Host-side image IO.

Equivalent of the reference's stb_image-based ``ImageIO``
(reference ``image/ImageIO.{hpp,cpp}``): load an image to YUV420
planes, save grayscale planes or 3-plane YUV images back to PNG.

8-bit grayscale / RGB PNG (with or without alpha, non-interlaced) is read
and written with ``zlib`` and numpy alone, so the main path needs no image
library.  Other formats (JPEG, palette or 16-bit PNG, ...) go through Pillow
when it is installed (the ``images`` extra in pyproject.toml).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .yuv import rgb_to_yuv420, yuv420_to_rgb

__all__ = ["load_planes", "load_gray", "save_plane", "save_yuv",
           "read_png", "write_png"]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the 8-bit non-palette types
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class _Unsupported(ValueError):
    """A PNG variant the stdlib codec does not handle."""


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (types 0-4) -> [h, w*bpp] u8."""
    stride = w * bpp
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError("corrupt PNG: image data has the wrong length")
    data = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = data[y, 0], data[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum along x, per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average / Paeth: serial along x
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"corrupt PNG: filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """8-bit gray/RGB(A) PNG -> [H, W] or [H, W, C] u8 (C = 2, 3 or 4)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIG:
        raise _Unsupported("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(blob):
        length, ctype = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError("corrupt PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise _Unsupported(f"PNG depth {depth}, colour type {ctype}, "
                           f"interlace {interlace}")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, ch)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W] (gray) or [H, W, 3] (RGB) u8 array as PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, ch = 2, 3
    else:
        raise ValueError(f"cannot write an array of shape {img.shape} as PNG")
    h, w = img.shape[:2]
    rows = img.reshape(h, w * ch)
    up = np.empty_like(rows)  # filter 2 (Up) on every scanline
    up[0] = rows[0]
    up[1:] = rows[1:] - rows[:-1]
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _pillow():
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            "only 8-bit gray/RGB PNG is read and written without an image "
            "library; install Pillow (pip install pillow) for other "
            "formats") from None
    return Image


def _save(path: str, img: np.ndarray) -> None:
    if path.lower().endswith(".png"):
        write_png(path, img)
    else:
        _pillow().fromarray(img).save(path)


def _imread_rgb(path: str) -> np.ndarray:
    try:
        img = read_png(path)
    except _Unsupported:
        img = None
    if img is None:
        with _pillow().open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    # gray -> RGB replicates the channel, alpha is dropped (as Pillow's
    # convert("RGB") does)
    return np.repeat(img[:, :, :1], 3, axis=2) if img.shape[2] <= 2 \
        else np.ascontiguousarray(img[:, :, :3])


def load_planes(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load an image file to (Y, U, V) u8 planes (YUV420)."""
    return rgb_to_yuv420(_imread_rgb(path))


def load_gray(path: str) -> np.ndarray:
    """Load an image file to its Y (luma) plane, like the reference's
    grayscale path (``main.cpp:189-190`` encodes plane 0 only)."""
    return load_planes(path)[0]


def save_plane(plane: np.ndarray, path: str) -> None:
    """Save a u8 plane as a grayscale image (``ImageIO.cpp:99-102``)."""
    _save(path, np.asarray(plane, dtype=np.uint8))


def save_yuv(y: np.ndarray, u: np.ndarray, v: np.ndarray, path: str) -> None:
    """Save YUV420 planes as an RGB image (``ImageIO.cpp:86-97``)."""
    _save(path, yuv420_to_rgb(y, u, v))
