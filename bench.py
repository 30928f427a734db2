"""Benchmark runner.

Prints one JSON line per BASELINE config, HEADLINE LAST (the driver records
the final line):

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline metric: encode throughput (megapixels/s) on the 512x512 grayscale
Lenna default search (16x16 domains step 8, 4x4 ranges, 4 isometries,
classifier on) — the reference C++ encoder measured on this same machine
(2 cores, -O3 -mavx2, patched only to fix its condvar deadlock and disable
FMA contraction) takes 7.545 s for the identical search
=> 0.0347 Mpix/s baseline.  Secondary lines track every other BASELINE.json
config so round-over-round regressions are visible on all north-star axes:

  1. 256^2, 8x8 ranges / 16x16 domains, full search, 8 isometries
  3. 1024^2 quadtree adaptive partition (range 4..16)
  4. 2048^2 full domain pool (single-chip lane of the halo config)
  5. 4096^2 (single-chip lane of the multi-host batch config)

vs_baseline is only reported where the C++ reference was actually measured
(512^2, on a CPU); other configs print vs_baseline 0.0 (the C++ encoder
would need hours at 2048^2+ — see BASELINE.md).

All timings are device-resident (input staged on device first) and end in
a host transfer of a small result array.  Making this a valid GPU
benchmark (device identity on every line, median and spread, per-layer
spans) is ROADMAP Queue 1 item 1.
"""
import json
import os
import sys
import time

import numpy as np

BASELINE_CPP_SECONDS_512 = 7.545  # /tmp measurement, see BASELINE.md
# config 1 anchor (round 5): the patched reference on the 256^2 crop with
# --source 16 --target 8 --noclassifier, min of 3 runs on the same 2-core
# box.  The reference searches only 4 isometries (transformmatcher.h:41-46)
# while this lane searches all 8, so vs_baseline UNDERSTATES the speedup by
# ~2x.  See BASELINE.md.
BASELINE_CPP_SECONDS_256_FULL = 2.836
LENNA = "/root/reference/tests/input/lenna512x512.png"


def load_plane():
    if os.path.exists(LENNA):
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from fractencode_tpu.image import load_gray

        return np.asarray(load_gray(LENNA))
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(512, 512), dtype=np.uint8)


def tile_to(plane: np.ndarray, n: int) -> np.ndarray:
    reps = -(-n // plane.shape[0])
    return np.tile(plane, (reps, reps))[:n, :n]


def emit(metric, value, unit, vs_baseline=0.0):
    print(json.dumps({
        "metric": metric,
        "value": round(float(value), 4),
        "unit": unit,
        "vs_baseline": round(float(vs_baseline), 2),
    }), flush=True)


def time_encode(fn, out_probe, reps=3):
    """min wall seconds over reps; out_probe pulls a result field to host."""
    fn_out = fn()
    out_probe(fn_out)  # warmup/compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out_probe(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax.numpy as jnp

    from fractencode_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()

    from fractencode_tpu import EncoderConfig, decode_plane, encode_plane
    from fractencode_tpu.encode import encode_batch_stacked
    from fractencode_tpu.encode.quadtree import QuadtreeConfig, encode_plane_quadtree

    plane = load_plane()
    h, w = plane.shape
    cfg = EncoderConfig()  # default: affine criterion, 4 transforms, classifier

    # correctness smoke: encode+decode round trip must produce a plausible image
    res = encode_plane(plane, cfg)
    np.asarray(res.domain_idx)
    out, iters, mse = decode_plane(res)
    psnr_ok = float(
        10.0
        * np.log10(
            255.0**2
            / max(((np.asarray(out).astype(float) - plane.astype(float)) ** 2).mean(), 1e-9)
        )
    )
    assert psnr_ok > 25.0, f"decode sanity failed: {psnr_ok} dB"

    stage = lambda a: jnp.asarray(a)
    probe_plane = lambda r: np.asarray(r.domain_idx)

    # --- single-frame 512^2 latency (one dispatch; batch throughput below
    # amortizes the per-dispatch cost)
    p512 = stage(plane)
    jnp.add(p512, 0).block_until_ready()
    dt = time_encode(lambda: encode_plane(p512, cfg), probe_plane, reps=5)
    emit("encode_512px_ms", dt * 1e3, "ms",
         (BASELINE_CPP_SECONDS_512 * 1e3) / (dt * 1e3))

    # --- config 1: 256^2, 8x8/16x16, FULL search (no classifier), 8 isometries
    p256 = stage(plane[:256, :256])
    jnp.add(p256, 0).block_until_ready()
    cfg1 = EncoderConfig(source_size=16, target_size=8, num_transforms=8,
                         use_classifier=False)
    dt = time_encode(lambda: encode_plane(p256, cfg1), probe_plane)
    emit("encode_256px_full8_ms", dt * 1e3, "ms",
         (BASELINE_CPP_SECONDS_256_FULL * 1e3) / (dt * 1e3))

    # --- config 3: 1024^2 quadtree (range 4..16)
    p1024 = stage(tile_to(plane, 1024))
    jnp.add(p1024, 0).block_until_ready()
    qcfg = QuadtreeConfig(min_size=4, max_size=16)
    dt = time_encode(
        lambda: encode_plane_quadtree(p1024, cfg, qcfg),
        lambda r: np.asarray(r.levels[-1].domain_idx),
    )
    emit("encode_1024px_quadtree_ms", dt * 1e3, "ms")

    # quadtree throughput lane: the 8-frame batched form (one dispatch,
    # stacked results, one probe pull) as per-frame time
    from fractencode_tpu.encode.quadtree import encode_batch_quadtree_stacked

    pq8 = jnp.asarray(np.stack([np.asarray(p1024)] * 8))
    jnp.add(pq8, 0).block_until_ready()
    probe_qb = lambda r: np.asarray(r.levels[-1].domain_idx[-1])
    dt = time_encode(
        lambda: encode_batch_quadtree_stacked(pq8, cfg, qcfg), probe_qb)
    emit("encode_1024px_quadtree_batch8_ms_per_frame", dt * 1e3 / 8, "ms")
    del pq8

    # --- config 4: 2048^2 full domain pool, default search
    p2048 = stage(tile_to(plane, 2048))
    jnp.add(p2048, 0).block_until_ready()
    dt = time_encode(lambda: encode_plane(p2048, cfg), probe_plane)
    emit("encode_2048px_ms", dt * 1e3, "ms")

    # --- decode tracking (regressions were invisible before round 3).
    # Decode lanes use the coarse-to-fine pyramid fast path (round 5,
    # DecoderConfig.pyramid) — the PSNR lanes below decode through the SAME
    # config so the quality claims cover the timed path.
    from fractencode_tpu import DecoderConfig

    dcfg_fast = DecoderConfig(pyramid=True)
    probe_mse = lambda r: float(r[2])
    dt = time_encode(lambda: decode_plane(res, dcfg_fast), probe_mse)
    emit("decode_512px_ms", dt * 1e3, "ms")
    res2048 = encode_plane(p2048, cfg)
    probe_plane(res2048)
    dt = time_encode(lambda: decode_plane(res2048, dcfg_fast), probe_mse,
                     reps=3)
    emit("decode_2048px_ms", dt * 1e3, "ms")
    del res2048

    # --- batch decode throughput (the consumer loop of Encoder2.hpp:67-89
    # at rate; one device program for 16 frames)
    from fractencode_tpu.decode import decode_batch_stacked

    batch16 = jnp.asarray(np.stack([plane] * 16))
    res_b16 = encode_batch_stacked(batch16, cfg)
    np.asarray(res_b16.s[-1])
    dt = time_encode(lambda: decode_batch_stacked(res_b16, dcfg_fast),
                     lambda r: float(np.asarray(r[2][-1])))
    emit("decode_throughput_512px_batch16", 16 / dt, "frames/s")
    del batch16, res_b16

    # --- rate-distortion at the default 5-bit s / 7-bit o quantization
    # (north star fixes PSNR: a speed win that costs quality must show here)
    from fractencode_tpu.codec import pack_result, unpack_result

    blob = pack_result(res, plane=plane)  # mean-centred o (the CLI default)
    outq, _, _ = decode_plane(unpack_result(blob), dcfg_fast)
    mse_q = max(((np.asarray(outq).astype(float) - plane.astype(float)) ** 2).mean(), 1e-9)
    emit("psnr_512px_q5s7o_db", 10.0 * np.log10(255.0**2 / mse_q), "dB")
    emit("bpp_512px_q5s7o", len(blob) * 8.0 / (h * w), "bits/px")

    from fractencode_tpu.codec.bitstream_quadtree import (
        pack_quadtree,
        unpack_quadtree,
    )
    from fractencode_tpu.encode.quadtree import decode_plane_quadtree

    p1024_np = np.asarray(p1024)
    qres = encode_plane_quadtree(p1024, cfg, qcfg)
    qblob = pack_quadtree(qres, plane=p1024_np)
    outq, _, _ = decode_plane_quadtree(unpack_quadtree(qblob), dcfg_fast)
    mse_q = max(((np.asarray(outq).astype(float) - p1024_np.astype(float)) ** 2).mean(), 1e-9)
    emit("psnr_1024px_quadtree_q5s7o_db", 10.0 * np.log10(255.0**2 / mse_q), "dB")
    emit("bpp_1024px_quadtree_q5s7o", len(qblob) * 8.0 / (1024 * 1024), "bits/px")

    # --- second operating point on the rate-distortion curve (hq: finer
    # quantization + stricter quadtree threshold; the full sweep is
    # scripts/bench_rd_curve.py -> docs/rd_curve.json)
    qcfg_hq = QuadtreeConfig(min_size=4, max_size=16, error_threshold=25.0)
    qres_hq = encode_plane_quadtree(p1024, cfg, qcfg_hq)
    qblob_hq = pack_quadtree(qres_hq, plane=p1024_np, s_bits=6, o_bits=7)
    outq, _, _ = decode_plane_quadtree(unpack_quadtree(qblob_hq), dcfg_fast)
    mse_q = max(((np.asarray(outq).astype(float) - p1024_np.astype(float)) ** 2).mean(), 1e-9)
    emit("psnr_1024px_quadtree_hq_db", 10.0 * np.log10(255.0**2 / mse_q), "dB")
    emit("bpp_1024px_quadtree_hq", len(qblob_hq) * 8.0 / (1024 * 1024), "bits/px")

    # --- config 5 (single-chip lane): 4096^2 default search
    p4096 = stage(tile_to(plane, 4096))
    jnp.add(p4096, 0).block_until_ready()
    dt = time_encode(lambda: encode_plane(p4096, cfg), probe_plane, reps=3)
    emit("encode_4096px_ms", dt * 1e3, "ms")
    del p4096

    # --- 8K lane
    p8192 = stage(tile_to(plane, 8192))
    jnp.add(p8192, 0).block_until_ready()
    dt = time_encode(lambda: encode_plane(p8192, cfg), probe_plane, reps=1)
    emit("encode_8192px_ms", dt * 1e3, "ms")
    del p8192

    # --- batch-64 throughput (secondary): deeper batches amortize the
    # per-dispatch floor further; per-frame device work is identical
    batch64 = jnp.asarray(np.stack([plane] * 64))
    jnp.add(batch64, 0).block_until_ready()
    outs = encode_batch_stacked(batch64, cfg)
    np.asarray(outs.domain_idx[-1])
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = encode_batch_stacked(batch64, cfg)
        np.asarray(outs.s[-1])
        times.append(time.perf_counter() - t0)
    emit("encode_throughput_512px_lenna_batch64",
         64 * h * w / min(times) / 1e6, "Mpix/s/chip",
         (64 * h * w / min(times)) / ((h * w) / BASELINE_CPP_SECONDS_512))
    del batch64, outs

    # --- HEADLINE (must stay LAST): 512^2 batch-16 throughput
    batch = jnp.asarray(np.stack([plane] * 16))
    jnp.add(batch, 0).block_until_ready()
    outs = encode_batch_stacked(batch, cfg)
    np.asarray(outs.domain_idx)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        outs = encode_batch_stacked(batch, cfg)
        # stacked results + ONE small host pull as the completion barrier
        np.asarray(outs.s[-1])
        times.append(time.perf_counter() - t0)
    encode_s = min(times) / batch.shape[0]

    mpix_s = (h * w) / encode_s / 1e6
    baseline_mpix_s = (h * w) / BASELINE_CPP_SECONDS_512 / 1e6
    emit("encode_throughput_512px_lenna_batch16", mpix_s, "Mpix/s/chip",
         mpix_s / baseline_mpix_s)


if __name__ == "__main__":
    main()
