"""Speed/PSNR tradeoff of the learned VQ prune at 2048^2.

Writes ``docs/vq_tradeoff.json`` (times are the device's it ran on)."""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")
import jax.numpy as jnp

from fractencode_tpu import DecoderConfig, EncoderConfig, decode_plane, encode_plane
from fractencode_tpu.image import load_gray

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "vq_tradeoff.json")

plane = np.asarray(load_gray("/root/reference/tests/input/lenna512x512.png"))
plane = np.tile(plane, (4, 4))[:2048, :2048]
p = jnp.asarray(plane)
jnp.add(p, 0).block_until_ready()

rows = []
for label, cfg in [
    ("brightness-6 (default)", EncoderConfig()),
    ("vq4", EncoderConfig(vq_classes=4)),
    ("vq6", EncoderConfig(vq_classes=6)),
    ("full search (noclassifier)", EncoderConfig(use_classifier=False)),
]:
    res = encode_plane(p, cfg)
    np.asarray(res.domain_idx)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = encode_plane(p, cfg)
        np.asarray(res.s)
        ts.append(time.perf_counter() - t0)
    out, _, _ = decode_plane(res, DecoderConfig(pyramid=True))
    mse = ((np.asarray(out).astype(np.float64) - plane) ** 2).mean()
    psnr = 10 * np.log10(255**2 / max(mse, 1e-9))
    rows.append([label, round(min(ts) * 1e3, 1), round(psnr, 3)])
    print(rows[-1], flush=True)

with open(OUT, "w") as f:
    json.dump({
        "title": "Classifier/VQ pruning tradeoff at 2048² (Lenna-tiled, "
                 "encode wall ms on one chip incl. dispatch floor, raw-"
                 "encode decode PSNR)",
        "script": "scripts/bench_vq.py",
        "columns": ["Pruning", "encode (ms)", "PSNR (dB)"],
        "rows": rows,
    }, f, indent=1)
print(f"wrote {OUT}")
