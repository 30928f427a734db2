"""Rate-distortion curve sweep.

Sweeps the codec's operating points on the Lenna fixtures:
  * uniform 512^2: (s_bits, o_bits) in {(4,6), (5,7), (6,8)}
  * quadtree 1024^2: the same quantizer points x error_threshold in
    {25, 50, 100}
and writes ``docs/rd_curve.json`` (bits and PSNR only: they do not depend
on the device).

Encode runs once per geometry/threshold; only pack/decode vary per
quantizer point.  Run on the GPU (or the CPU with patience).
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, "/root/repo")

from fractencode_tpu import DecoderConfig, EncoderConfig, decode_plane, encode_plane
from fractencode_tpu.codec import pack_result, unpack_result
from fractencode_tpu.codec.bitstream_quadtree import pack_quadtree, unpack_quadtree
from fractencode_tpu.encode.quadtree import (
    QuadtreeConfig,
    decode_plane_quadtree,
    encode_plane_quadtree,
)
from fractencode_tpu.image import load_gray

LENNA = "/root/reference/tests/input/lenna512x512.png"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "rd_curve.json")

Q_POINTS = [(4, 6), (5, 7), (6, 8)]
QT_THRESHOLDS = [25.0, 50.0, 100.0]
DCFG = DecoderConfig(pyramid=True)


def psnr_of(out, ref):
    err = ((np.asarray(out).astype(np.float64) - ref.astype(np.float64)) ** 2).mean()
    return 10.0 * np.log10(255.0**2 / max(err, 1e-9))


def main():
    plane = np.asarray(load_gray(LENNA))
    rows = []

    res = encode_plane(plane, EncoderConfig())
    for sb, ob in Q_POINTS:
        blob = pack_result(res, s_bits=sb, o_bits=ob, plane=plane)
        out, _, _ = decode_plane(unpack_result(blob), DCFG)
        rows.append([
            "512² uniform", f"s{sb}/o{ob}", "—",
            round(len(blob) * 8.0 / plane.size, 4),
            round(psnr_of(out, plane), 3),
        ])
        print(rows[-1], flush=True)

    p1024 = np.tile(plane, (2, 2))[:1024, :1024]
    for thr in QT_THRESHOLDS:
        qres = encode_plane_quadtree(
            p1024, EncoderConfig(),
            QuadtreeConfig(min_size=4, max_size=16, error_threshold=thr))
        for sb, ob in Q_POINTS:
            blob = pack_quadtree(qres, s_bits=sb, o_bits=ob, plane=p1024)
            out, _, _ = decode_plane_quadtree(unpack_quadtree(blob), DCFG)
            rows.append([
                "1024² quadtree", f"s{sb}/o{ob}", f"{thr:g}",
                round(len(blob) * 8.0 / p1024.size, 4),
                round(psnr_of(out, p1024), 3),
            ])
            print(rows[-1], flush=True)

    with open(OUT, "w") as f:
        json.dump({
            "title": "Rate-distortion curve (Lenna fixtures, mean-centred o, "
                     "entropy + flat short-circuit, pyramid decode)",
            "script": "scripts/bench_rd_curve.py",
            "columns": ["Config", "Quantizer", "qt threshold", "bits/px",
                        "PSNR (dB)"],
            "rows": rows,
        }, f, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
