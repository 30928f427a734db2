#!/usr/bin/env python
"""Time the two search routes on the GPU: the plain XLA ``search`` against
the Pallas search kernel, end to end through ``encode_plane`` /
``encode_batch_stacked``, and check that they agree.

    python scripts/search_routes.py                     # all configs
    python scripts/search_routes.py --configs 512_default,256_full8
    python scripts/search_routes.py --sweep 2048        # kernel tile sweep

Prints the card's name and power limit, then one JSON line per
measurement (times in ms: median, min and max of ``--reps`` calls, each
ended by ``block_until_ready``; ``first`` includes compilation).  Content
is seeded (fractencode_tpu.image.synth).  Needs a GPU: it never falls back
to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> (batch, size, EncoderConfig kwargs, timed)
CONFIGS = {
    "512_default": (0, 512, {}, True),
    "2048_default": (0, 2048, {}, True),
    "512_batch16": (16, 512, {}, True),
    "256_full8": (0, 256, dict(source_size=16, target_size=8,
                               num_transforms=8, use_classifier=False), True),
    "512_target16": (0, 512, dict(source_size=32, target_size=16), False),
    "512_rms": (0, 512, dict(rms_threshold=20.0), False),
}

SWEEP = ((64, 64, 4, 2), (128, 64, 4, 2), (64, 128, 4, 2), (128, 128, 8, 2),
         (64, 64, 4, 3), (32, 64, 4, 2), (64, 32, 4, 2), (128, 64, 8, 3))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def emit(rec: dict, log):
    line = json.dumps(rec)
    print(line, flush=True)
    if log is not None:
        log.write(line + "\n")
        log.flush()


def _ms(t: dict) -> dict:
    return {k.replace("_s", "_ms"): v * 1e3 for k, v in t.items()}


def run_configs(names, reps: int, seed: int, log) -> bool:
    import numpy as np

    from fractencode_tpu import EncoderConfig
    from fractencode_tpu.image.synth import natural_image
    from fractencode_tpu.utils.routes import route_parity

    ok = True
    for name in names:
        batch, size, kw, timed = CONFIGS[name]
        if batch:
            planes = np.stack([natural_image(seed + i, size, size)
                               for i in range(batch)])
        else:
            planes = natural_image(seed, size, size)
        try:
            out = route_parity(planes, EncoderConfig(**kw),
                               reps=reps if timed else 0)
        except Exception as e:  # report and go on to the next config
            emit(dict(config=name, error=f"{type(e).__name__}: {e}"[:2000]),
                 log)
            ok = False
            continue
        rec = dict(config=name, parity=out["compare"])
        for route in ("jnp", "pallas"):
            if route in out:
                rec[route] = _ms(out[route])
        if "jnp" in out:
            rec["speedup"] = out["jnp"]["median_s"] / out["pallas"]["median_s"]
        ok &= out["compare"]["ok"]
        emit(rec, log)
    return ok


def sweep(size: int, reps: int, seed: int, log) -> None:
    """Device-resident search-only timings of each tile choice."""
    import jax.numpy as jnp

    from fractencode_tpu import EncoderConfig
    from fractencode_tpu.core.classify import classify_grid
    from fractencode_tpu.core.grid import uniform_grid
    from fractencode_tpu.encode.codebook import build_codebook, extract_ranges
    from fractencode_tpu.encode.matcher import search_kernel
    from fractencode_tpu.image.synth import natural_image
    from fractencode_tpu.utils.routes import time_call

    cfg = EncoderConfig()
    img = jnp.asarray(natural_image(seed, size, size))
    plane = img.astype(jnp.float32)
    dg = uniform_grid(size, size, cfg.source_size, cfg.domain_step)
    rg = uniform_grid(size, size, cfg.target_size, cfg.target_size)
    cb = build_codebook(plane, dg, cfg.target_size, cfg.num_transforms)
    ranges = extract_ranges(plane, cfg.target_size)
    args = (ranges, ranges.sum(-1), (ranges * ranges).sum(-1), cb,
            classify_grid(img, rg), classify_grid(img, dg))
    ref = None
    for blocks in SWEEP:
        try:
            f = lambda b=blocks: search_kernel(*args, cfg, blocks=b).domain_idx
            t = time_call(f, reps)
            res = f()
            ref = res if ref is None else ref
            same = bool(jnp.array_equal(res, ref))
            emit(dict(sweep=size, blocks=list(blocks), same=same, **_ms(t)),
                 log)
        except Exception as e:
            emit(dict(sweep=size, blocks=list(blocks),
                      error=f"{type(e).__name__}: {e}"[:1000]), log)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--configs", default=",".join(CONFIGS))
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sweep", type=int, default=0, metavar="SIZE",
                   help="time each kernel tile choice at SIZE^2 instead")
    p.add_argument("--log", default=None, help="also append JSON lines here")
    args = p.parse_args(argv)

    import jax

    from fractencode_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print(f"error: no GPU (JAX found {jax.devices()[0].platform})",
              file=sys.stderr)
        return 1
    print(f"card: {card()}", flush=True)
    log = open(args.log, "a") if args.log else None
    if args.sweep:
        sweep(args.sweep, args.reps, args.seed, log)
        return 0
    names = [n for n in args.configs.split(",") if n]
    return 0 if run_configs(names, args.reps, args.seed, log) else 1


if __name__ == "__main__":
    raise SystemExit(main())
