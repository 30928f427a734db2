#!/usr/bin/env python3
"""End-to-end check of the codec's main path on an NVIDIA GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded APIs only

One card, in order:
  * kernel parity    the Pallas search kernel against the plain ``search``
                     (512^2 and 2048^2 default, 256^2 full search with 8
                     isometries, 16x16 ranges, rms > 0): winners bitwise,
                     (s, o, distance) within rtol 1e-6;
  * reference parity ``--compat`` on tests/golden/lenna128_input.png against
                     the C++ reference's winners and decoded pixels;
  * CLI              2048^2 gray -> .ftc -> --decode-file; 768x512 --color
                     FTCC round trip; 1024^2 --quadtree round trip;
  * library          encode_plane/decode_plane at 4096^2;
                     encode_batch_stacked/decode_batch_stacked on 16x512^2.
Content is generated from --seed (fractencode_tpu.image.synth).  Each phase
prints its wall time, its compile time, and its PSNR and bits/px, which
must clear floors set from CPU runs of the same content at small size.

``--four-cards`` runs encode_batch_sharded (ranges, domains, ring on (1,4)
and (2,2) meshes), encode_plane_sharded_image (halo; codebook gather and
ring) at 4096^2, decode_batch_sharded with pyramid=True, and the sharded
quadtree encode and decode, each against the same work on one card: equal
bitwise, outputs spanning 4 devices.

The card's name and power limit come first; the last line is one JSON
object.  Any failed phase makes the exit code non-zero; without a GPU the
script stops before any phase and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
GOLDEN = os.path.join(REPO, "tests", "golden")
WORKDIR = os.path.join(REPO, ".smoke")  # CLI files; gitignored, removed after

# PSNR floors (dB).  CPU runs of the same generator (seeds 0-3, plain
# route) gave at 512^2: gray CLI 30.74-31.18, quadtree CLI 29.89-31.18,
# 4096^2-phase content 30.27-31.34, batch frames 31.13-31.52; and at the
# full 768x512 colour size 28.09-28.93.  Each floor sits about 1.5 dB under
# the lowest of those (PSNR grows with size on this content).
PSNR_FLOOR = {
    "cli_gray": 29.0,
    "cli_color": 26.5,
    "cli_quadtree": 28.0,
    "lib_plane": 28.5,
    "lib_batch": 29.5,
}

KERNEL_PARITY = (  # name, batch, size, EncoderConfig kwargs
    ("512_default", 0, 512, {}),
    ("2048_default", 0, 2048, {}),
    ("256_full8", 0, 256, dict(source_size=16, target_size=8,
                               num_transforms=8, use_classifier=False)),
    ("512_target16", 0, 512, dict(source_size=32, target_size=16)),
    ("512_rms", 0, 512, dict(rms_threshold=20.0)),
)


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (jax.monitoring)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def psnr(a, b) -> float:
    import numpy as np

    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(10.0 * np.log10(255.0 ** 2 / max((d * d).mean(), 1e-12)))


def _cli(args):
    """Run the CLI in this process (one process per card); its output is
    kept and shown only if it fails."""
    from fractencode_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = main(args)
    check(rc == 0, f"CLI {' '.join(args)} exited {rc}:\n{buf.getvalue()[-2000:]}")
    return buf.getvalue()


# ---------------------------------------------------------------- one card


def kernel_parity(configs=KERNEL_PARITY, kernel="pallas", seed=0):
    import numpy as np

    from fractencode_tpu import EncoderConfig
    from fractencode_tpu.image.synth import natural_image
    from fractencode_tpu.utils.routes import route_parity

    out = {}
    for name, batch, size, kw in configs:
        planes = (np.stack([natural_image(seed + i, size, size)
                            for i in range(batch)]) if batch
                  else natural_image(seed, size, size))
        cmp = route_parity(planes, EncoderConfig(**kw), kernel=kernel)["compare"]
        print(f"  kernel parity {name}: {cmp}", flush=True)
        check(cmp["ok"], f"kernel parity {name}: {cmp}")
        out[name] = "ok"
    return out


def reference_parity(backend="auto"):
    import gzip

    import numpy as np

    from fractencode_tpu import REFERENCE_COMPAT, decode_plane, encode_plane
    from fractencode_tpu.image import load_gray
    from fractencode_tpu.image.io import read_png

    y = load_gray(os.path.join(GOLDEN, "lenna128_input.png"))
    with gzip.open(os.path.join(GOLDEN, "lenna128_cpp_encode.txt.gz"), "rt") as f:
        dump = np.loadtxt(f)
    order = (dump[:, 1] // 4).astype(int) * 32 + (dump[:, 0] // 4).astype(int)
    cpp = np.zeros_like(dump)
    cpp[order] = dump
    res = encode_plane(y, REFERENCE_COMPAT(backend=backend))
    nx = (128 - 16) // 8 + 1
    dom_cpp = (cpp[:, 5] // 8).astype(int) * nx + (cpp[:, 4] // 8).astype(int)
    dom_bad = int((np.asarray(res.domain_idx) != dom_cpp).sum())
    tr_bad = int((np.asarray(res.transform) != cpp[:, 8].astype(int)).sum())
    check(dom_bad == 0 and tr_bad == 0,
          f"--compat winners differ from the C++ golden: {dom_bad} domains, "
          f"{tr_bad} transforms")
    out, _, _ = decode_plane(res)
    ref = read_png(os.path.join(GOLDEN, "lenna128_cpp_result.png"))
    diff = np.abs(np.asarray(out).astype(int) - ref.astype(int))
    n_diff, max_diff = int((diff > 0).sum()), int(diff.max())
    print(f"  decoded vs C++ result.png: {n_diff} pixels differ, "
          f"largest difference {max_diff}", flush=True)
    check(max_diff <= 1, f"decoded pixels differ by up to {max_diff}")
    return dict(winners="bitwise", pixels_differing=n_diff,
                max_pixel_diff=max_diff, psnr=psnr(out, y))


def cli_gray(size=2048, backend="auto", seed=0):
    from fractencode_tpu.image.io import read_png, write_png
    from fractencode_tpu.image.synth import natural_image

    img = natural_image(seed + 100, size, size)
    src, ftc, dec = (os.path.join(WORKDIR, n)
                     for n in ("gray.png", "gray.ftc", "gray_dec.png"))
    write_png(src, img)
    _cli([src, "--backend", backend, "--out", ftc,
          "--result", os.path.join(WORKDIR, "gray_out.png")])
    _cli(["--decode-file", ftc, "--result", dec])
    return dict(psnr=psnr(read_png(dec), img),
                bpp=os.path.getsize(ftc) * 8 / img.size)


def cli_color(width=768, height=512, backend="auto", seed=0):
    from fractencode_tpu.image.io import read_png, write_png
    from fractencode_tpu.image.synth import natural_image

    img = natural_image(seed + 200, height, width, color=True)
    src, ftc, dec = (os.path.join(WORKDIR, n)
                     for n in ("color.png", "color.ftc", "color_dec.png"))
    write_png(src, img)
    _cli([src, "--color", "--backend", backend, "--out", ftc,
          "--result", os.path.join(WORKDIR, "color_out.png")])
    with open(ftc, "rb") as f:
        check(f.read(4) == b"FTCC", "--color did not write an FTCC container")
    _cli(["--decode-file", ftc, "--result", dec])
    out = read_png(dec)
    check(out.shape == img.shape, f"decoded shape {out.shape}")
    return dict(psnr=psnr(out, img),
                bpp=os.path.getsize(ftc) * 8 / (width * height))


def cli_quadtree(size=1024, backend="auto", seed=0):
    from fractencode_tpu.image.io import read_png, write_png
    from fractencode_tpu.image.synth import natural_image

    img = natural_image(seed + 300, size, size)
    src, ftc, dec = (os.path.join(WORKDIR, n)
                     for n in ("qt.png", "qt.ftc", "qt_dec.png"))
    write_png(src, img)
    _cli([src, "--quadtree", "--backend", backend, "--out", ftc,
          "--result", os.path.join(WORKDIR, "qt_out.png")])
    _cli(["--decode-file", ftc, "--result", dec])
    return dict(psnr=psnr(read_png(dec), img),
                bpp=os.path.getsize(ftc) * 8 / img.size)


def lib_plane(size=4096, backend="auto", seed=0):
    import numpy as np

    from fractencode_tpu import (DecoderConfig, EncoderConfig, decode_plane,
                                 encode_plane)
    from fractencode_tpu.codec import pack_result, unpack_result
    from fractencode_tpu.image.synth import natural_image

    img = natural_image(seed + 400, size, size)
    res = encode_plane(img, EncoderConfig(backend=backend))
    blob = pack_result(res, plane=img)
    out, _, _ = decode_plane(unpack_result(blob), DecoderConfig(pyramid=True))
    out = np.asarray(out)
    check(out.shape == img.shape, f"decoded shape {out.shape}")
    return dict(psnr=psnr(out, img), bpp=len(blob) * 8 / img.size)


def lib_batch(batch=16, size=512, backend="auto", seed=0):
    import jax
    import numpy as np

    from fractencode_tpu import (DecoderConfig, EncoderConfig,
                                 decode_batch_stacked, encode_batch_stacked)
    from fractencode_tpu.codec import pack_result
    from fractencode_tpu.image.synth import natural_image

    imgs = np.stack([natural_image(seed + 500 + i, size, size)
                     for i in range(batch)])
    res = encode_batch_stacked(imgs, EncoderConfig(backend=backend))
    outs, _, _ = decode_batch_stacked(res, DecoderConfig(pyramid=True))
    outs = np.asarray(outs)
    check(outs.shape == imgs.shape, f"decoded shape {outs.shape}")
    bits = sum(len(pack_result(jax.tree_util.tree_map(lambda a, i=i: a[i], res),
                               plane=imgs[i])) * 8 for i in range(batch))
    return dict(psnr=min(psnr(o, i) for o, i in zip(outs, imgs)),
                bpp=bits / imgs.size)


# -------------------------------------------------------------- four cards


def _same(a, b, what, fields=("domain_idx", "transform", "s", "o",
                              "distance", "valid")):
    """Fields that differ from one card, as failure messages."""
    import numpy as np

    out = []
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if not np.array_equal(x, y):
            out.append(f"{what}: {f} differs from one card in "
                       f"{int((x != y).sum())} entries")
    return out


def _spans(x, n, what):
    k = len(x.sharding.device_set)
    return [] if k == n else [f"{what}: output spans {k} devices, not {n}"]


def four_cards(devices, batch_size=1024, halo_size=4096, backend="auto",
               seed=0):
    """The sharded APIs on ``devices`` (4) against one card, bitwise."""
    import numpy as np

    from fractencode_tpu import (DecoderConfig, EncoderConfig, decode_plane,
                                 encode_plane)
    from fractencode_tpu.encode.quadtree import (
        QuadtreeConfig, decode_batch_quadtree_sharded, decode_plane_quadtree,
        encode_batch_quadtree_sharded, encode_batch_quadtree_sharded_stacked,
        encode_plane_quadtree)
    from fractencode_tpu.image.synth import natural_image
    from fractencode_tpu.parallel import (decode_batch_sharded,
                                          encode_batch_sharded, make_mesh)
    from fractencode_tpu.parallel.sharded import (STRATEGIES,
                                                  _encode_batch_impl,
                                                  encode_plane_sharded_image)

    n = len(devices)
    cfg = EncoderConfig(backend=backend)
    dcfg = DecoderConfig(pyramid=True)
    imgs = np.stack([natural_image(seed + 600 + i, batch_size, batch_size)
                     for i in range(4)])
    single = [encode_plane(im, cfg) for im in imgs]
    single_dec = np.stack([np.asarray(decode_plane(r, dcfg)[0])
                           for r in single])
    failures, checked = [], []  # every check runs; all failures are reported

    def same_pixels(x, y, what):
        if not np.array_equal(np.asarray(x), y):
            failures.append(f"{what}: decoded pixels differ from one card in "
                            f"{int((np.asarray(x) != y).sum())} entries")

    for nd, ns in ((1, 4), (2, 2)):
        mesh = make_mesh(n_data=nd, n_search=ns, devices=devices)
        for strategy in STRATEGIES:
            what = f"encode_batch_sharded {strategy} ({nd},{ns})"
            for x in _encode_batch_impl(imgs, cfg, mesh, strategy):
                failures += _spans(x, n, what)
            for r, s in zip(encode_batch_sharded(imgs, cfg, mesh, strategy),
                            single):
                failures += _same(r, s, what)
            checked.append(what)
        what = f"decode_batch_sharded pyramid ({nd},{ns})"
        results = encode_batch_sharded(imgs, cfg, mesh, "ranges")
        outs, _, _ = decode_batch_sharded(results, mesh, pyramid=True)
        failures += _spans(outs, n, what)
        same_pixels(outs, single_dec, what)
        checked.append(what)

    big = natural_image(seed + 700, halo_size, halo_size)
    big_single = encode_plane(big, cfg)
    mesh = make_mesh(n_data=1, n_search=n, devices=devices)
    for codebook in ("replicate", "ring"):
        what = f"encode_plane_sharded_image {codebook}"
        r = encode_plane_sharded_image(big, cfg, mesh, codebook=codebook)
        failures += _spans(r.domain_idx, n, what)
        failures += _same(r, big_single, what)
        checked.append(what)

    qcfg = QuadtreeConfig()
    mesh = make_mesh(n_data=n, n_search=1, devices=devices)
    what = "encode_batch_quadtree_sharded"
    for level in encode_batch_quadtree_sharded_stacked(imgs, cfg, qcfg, mesh):
        for x in level:
            failures += _spans(x, n, what)
    qres = encode_batch_quadtree_sharded(imgs, cfg, qcfg, mesh)
    q_single = [encode_plane_quadtree(im, cfg, qcfg) for im in imgs]
    for r, s in zip(qres, q_single):
        for lr, ls in zip(r.levels, s.levels):
            failures += _same(lr, ls, what, fields=(
                "domain_idx", "transform", "s", "o", "error", "accepted"))
    checked.append(what)
    what = "decode_batch_quadtree_sharded"
    qouts, _, _ = decode_batch_quadtree_sharded(qres, mesh, dcfg)
    failures += _spans(qouts, n, what)
    same_pixels(qouts, np.stack([np.asarray(decode_plane_quadtree(s, dcfg)[0])
                                 for s in q_single]), what)
    checked.append(what)
    for f in failures:
        print(f"  {f}", flush=True)
    check(not failures, f"{len(failures)} of the four-card checks failed")
    return dict(bitwise_equal_to_one_card=len(checked), spans=n)


# -------------------------------------------------------------------- main


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run_phase(name, fn, clock):
    t0, c0 = time.perf_counter(), clock.total
    try:
        metrics = fn()
        if name in PSNR_FLOOR:
            check(metrics["psnr"] >= PSNR_FLOOR[name],
                  f"PSNR {metrics['psnr']:.3f} dB below the floor "
                  f"{PSNR_FLOOR[name]} dB")
        status = "ok"
    except Exception as e:  # reported, and the run exits non-zero
        metrics, status = {}, f"FAILED: {type(e).__name__}: {e}"
    shown = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in metrics.items())
    print(f"phase {name}: {status} | wall {time.perf_counter() - t0:.3f} s, "
          f"compile {clock.total - c0:.3f} s | {shown}", flush=True)
    return status == "ok"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded APIs on 4 cards against one")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); refusing to run on anything else",
              file=sys.stderr)
        return 1
    from fractencode_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    print(f"card: {card_line()}", flush=True)
    os.makedirs(WORKDIR, exist_ok=True)
    clock = CompileClock()
    seed = args.seed
    if args.four_cards:
        if len(devices) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found "
                  f"{len(devices)}", file=sys.stderr)
            return 1
        devices = devices[:4]
        phases = [("four_cards", lambda: four_cards(devices, seed=seed))]
    else:
        devices = devices[:1]
        phases = [
            ("kernel_parity", lambda: kernel_parity(seed=seed)),
            ("reference_parity", reference_parity),
            ("cli_gray", lambda: cli_gray(seed=seed)),
            ("cli_color", lambda: cli_color(seed=seed)),
            ("cli_quadtree", lambda: cli_quadtree(seed=seed)),
            ("lib_plane", lambda: lib_plane(seed=seed)),
            ("lib_batch", lambda: lib_batch(seed=seed)),
        ]
    ok = all([run_phase(name, fn, clock) for name, fn in phases])
    shutil.rmtree(WORKDIR, ignore_errors=True)
    print(json.dumps({"ok": ok, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(jax.devices())}}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
