"""Seeded test content with natural-image statistics.

A dead-leaves occlusion model (opaque discs with log-uniform radii: sharp
edges and a scale-invariant 1/f spectrum) plus a 1/f Gaussian texture.
Not tiled and not periodic: the texture is synthesized on a larger canvas
and cropped, so its FFT wrap-around never shows.  Used where no real image
is at hand (the chip smoke, the route timings) so that PSNR and bits/px
describe image-like content rather than noise.
"""
from __future__ import annotations

import numpy as np

__all__ = ["natural_image"]


def _texture(rng, h: int, w: int) -> np.ndarray:
    """Zero-mean, unit-std Gaussian field with amplitude ~ 1/f."""
    ph, pw = h + h // 4 + 8, w + w // 4 + 8
    fy = np.fft.fftfreq(ph)[:, None]
    fx = np.fft.rfftfreq(pw)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    spec = np.fft.rfft2(rng.standard_normal((ph, pw)).astype(np.float32))
    field = np.fft.irfft2(spec / f, s=(ph, pw))[:h, :w]
    field -= field.mean()
    return (field / max(field.std(), 1e-6)).astype(np.float32)


def _leaves(rng, h: int, w: int, channels: int) -> np.ndarray:
    """Dead-leaves layer: later discs occlude earlier ones."""
    out = np.empty((h, w, channels), np.float32)
    out[:] = rng.uniform(40, 215, size=channels)
    side = max(h, w)
    r_min, r_max = max(2.0, side / 256), side / 6
    n = int(12 * (side / r_min) ** 0.5) + 64
    radii = np.sort(r_min * (r_max / r_min) ** rng.random(n))[::-1]
    for r in radii:  # large discs first: small ones land on top
        cy, cx = rng.uniform(-r, h + r), rng.uniform(-r, w + r)
        y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, h)
        x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, w)
        if y0 >= y1 or x0 >= x1:
            continue
        yy = np.arange(y0, y1, dtype=np.float32)[:, None] - cy
        xx = np.arange(x0, x1, dtype=np.float32)[None, :] - cx
        inside = yy * yy + xx * xx <= r * r
        base = rng.uniform(10, 245)
        color = np.clip(base + rng.normal(0, 25, size=channels), 0, 255)
        out[y0:y1, x0:x1][inside] = color
    return out


def natural_image(seed: int, height: int, width: int,
                  color: bool = False) -> np.ndarray:
    """[H, W] u8 (or [H, W, 3] u8 when ``color``) seeded natural content."""
    rng = np.random.default_rng(seed)
    channels = 3 if color else 1
    img = _leaves(rng, height, width, channels)
    img += 18.0 * _texture(rng, height, width)[:, :, None]
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img if color else img[:, :, 0]
