"""Command-line driver.

Mirrors the reference CLI (``/root/reference/main.cpp:29-104``) flag-for-flag
where sensible (--source/--target/--rms/--smax/--color/--decode/
--debug_decode/--noclassifier/--log) and adds what the reference never had:
a real compressed file format (encode to/decode from ``.ftc``), PSNR
reporting, and backend/mode selection.

Usage:
    python -m fractencode_tpu input.png [flags]          # encode+decode+stats
    python -m fractencode_tpu input.png --out out.ftc    # write bitstream
    python -m fractencode_tpu --decode-file in.ftc --result out.png
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fractencode_tpu", description=__doc__)
    p.add_argument("input", nargs="?",
                   help="input image (8-bit PNG; other formats need Pillow)")
    # reference-compatible flags (main.cpp:58-94)
    p.add_argument("--decode", type=int, default=-1, help="max decode iterations")
    p.add_argument("--source", type=int, default=16, help="domain block size")
    p.add_argument("--target", type=int, default=4, help="range block size")
    p.add_argument("--rms", type=float, default=0.0, help="early-accept MSE threshold")
    p.add_argument("--smax", type=float, default=-1.0, help="|s| clamp (<=0 off)")
    p.add_argument("--color", action="store_true", help="encode all 3 YUV planes")
    p.add_argument("--debug_decode", action="store_true", help="dump decode iterates")
    p.add_argument("--noclassifier", action="store_true")
    p.add_argument("--log", action="store_true",
                   help="per-phase wall-clock timing + progress reporting")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler device trace into DIR")
    p.add_argument("--quadtree", action="store_true",
                   help="adaptive quadtree ranges (the reference parsed this "
                        "flag but never implemented it)")
    p.add_argument("--qt-min", type=int, default=4, help="finest range size")
    p.add_argument("--qt-max", type=int, default=16, help="coarsest range size")
    p.add_argument("--qt-threshold", type=float, default=50.0,
                   help="per-pixel MSE acceptance threshold per level")
    # new capabilities
    p.add_argument("--transforms", type=int, default=4, choices=range(1, 9),
                   help="number of dihedral isometries to search (reference: 4)")
    p.add_argument("--criterion", choices=["affine", "raw"], default="affine")
    p.add_argument("--so-mode", choices=["ls", "reference"], default="ls")
    p.add_argument("--compat", action="store_true",
                   help="bit-parity with the C++ reference (raw + reference + 4)")
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"], default="auto",
                   help="search route: the Pallas kernel (GPU only), the "
                        "plain XLA search, or auto (the kernel on a GPU)")
    p.add_argument("--vq-classes", type=int, default=0, metavar="N",
                   help="replace the brightness classifier with an N-bin "
                        "learned LBG codebook prune (1..7; 0 = off) — the "
                        "reference's CodebookGenerator, finally wired in")
    p.add_argument("--out", help="write compressed bitstream to this path")
    p.add_argument("--decode-file", help="decode a .ftc bitstream instead of encoding")
    p.add_argument("--result", default="result.png", help="decoded output image path")
    p.add_argument("--decode-rms", type=float, default=1e-5)
    return p


def _config_from_args(args):
    from .params import EncoderConfig, REFERENCE_COMPAT

    kw = dict(
        source_size=args.source,
        target_size=args.target,
        rms_threshold=args.rms,
        s_max=args.smax,
        use_classifier=not args.noclassifier,
        num_transforms=args.transforms,
        backend=args.backend,
    )
    if args.compat:
        return REFERENCE_COMPAT(**{k: v for k, v in kw.items() if k != "num_transforms"})
    return EncoderConfig(criterion=args.criterion, so_mode=args.so_mode,
                         vq_classes=args.vq_classes, **kw)


def _encode_one_quadtree(plane, args, cfg, dcfg, label="", timer=None):
    from .core.metrics import psnr
    from .encode.quadtree import (
        QuadtreeConfig,
        decode_plane_quadtree,
        encode_plane_quadtree,
    )
    from .utils.progress import NullReporter, StdoutReporter

    reporter = StdoutReporter() if args.log else NullReporter()
    qcfg = QuadtreeConfig(min_size=args.qt_min, max_size=args.qt_max,
                          error_threshold=args.qt_threshold)
    t0 = time.perf_counter()
    with _maybe_phase(timer, f"encode{label}"):
        res = encode_plane_quadtree(plane, cfg, qcfg, reporter=reporter)
        res.levels[0].domain_idx.block_until_ready()
    t1 = time.perf_counter()
    print(f"encoded{label} in {t1 - t0:.4g} s.")
    leaves = [int(np.asarray(l.accepted).sum()) for l in res.levels]
    print(f"{res.num_leaves} leaves "
          + " ".join(f"{l.range_size}px:{n}" for l, n in zip(res.levels, leaves)))

    t0 = time.perf_counter()
    with _maybe_phase(timer, f"decode{label}"):
        out, iters, mse = decode_plane_quadtree(res, dcfg)
        out.block_until_ready()
    t1 = time.perf_counter()
    print(f"decoded{label} in {t1 - t0:.4g} s.")
    print(f"decode stats: {int(iters)} steps, rms: {float(mse):.6g}")
    print(f"psnr: {float(psnr(plane, out)):.4f} dB")
    return res, np.asarray(out)


def _maybe_phase(timer, name):
    """Timer phase context, or a no-op when --log is off."""
    import contextlib

    return timer.phase(name) if timer is not None else contextlib.nullcontext()


def _encode_one(plane, args, cfg, dcfg, label="", timer=None):
    from .core.metrics import psnr
    from .decode import decode_plane, decode_steps_py
    from .encode import encode_plane

    if args.quadtree:
        return _encode_one_quadtree(plane, args, cfg, dcfg, label, timer=timer)

    t0 = time.perf_counter()
    with _maybe_phase(timer, f"encode{label}"):
        res = encode_plane(plane, cfg)
        res.domain_idx.block_until_ready()
    t1 = time.perf_counter()
    print(f"encoded{label} in {t1 - t0:.4g} s.")
    print(f"{res.num_ranges} elements.")
    if cfg.use_classifier and cfg.vq_classes == 0:
        # classifier rejection statistics (cf. encode_stats_t::print,
        # Encoder2.hpp:21-23) — O(R + D) via class histograms
        # (brightness bins only; VQ bins are device-side)
        from .core.classify import classify_grid
        from .encode.encoder import encode_stats

        rcls = np.asarray(classify_grid(plane, res.range_grid))
        dcls = np.asarray(classify_grid(plane, res.domain_grid))
        st = encode_stats(res, rcls, dcls)
        total, rejected = st["total_mappings"], st["rejected_mappings"]
        print(
            f"classifier rejected {rejected} out of {total} comparisons "
            f"({100.0 * rejected / total:.4g})%"
        )

    if args.debug_decode:
        from .image import save_plane
        from .utils.progress import StdoutReporter

        rep = StdoutReporter() if args.log else None
        for i, img in decode_steps_py(res, dcfg, reporter=rep):
            save_plane(np.asarray(img), f"decode_debug{i}.png")

    t0 = time.perf_counter()
    with _maybe_phase(timer, f"decode{label}"):
        out, iters, mse = decode_plane(res, dcfg)
        out.block_until_ready()
    t1 = time.perf_counter()
    print(f"decoded{label} in {t1 - t0:.4g} s.")
    print(f"decode stats: {int(iters)} steps, rms: {float(mse):.6g}")
    print(f"psnr: {float(psnr(plane, out)):.4f} dB")
    _stats(res)
    return res, np.asarray(out)


def _stats(res):
    """Quantization statistics (cf. encode_data_statistics, main.cpp:106-140)."""
    from .codec.quantize import DEFAULT_O_BITS, DEFAULT_S_BITS, quantize

    s = np.asarray(res.s, dtype=np.float64)
    o = np.asarray(res.o, dtype=np.float64)
    print("----")
    print(f"grid element count: {len(s)}")
    print(f"contrast: {s.min():.6g}:{s.max():.6g}")
    print(f"brightness: {o.min():.6g}:{o.max():.6g}")
    sq = quantize(s, s.min(), s.max(), DEFAULT_S_BITS)
    oq = quantize(o, o.min(), o.max(), DEFAULT_O_BITS)
    print(
        "contrast / brightness quantization: "
        f"{len(np.unique(sq))} {len(np.unique(oq))}"
    )
    print("----")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .params import DecoderConfig
    from .utils.cache import setup_compile_cache

    setup_compile_cache()

    # --compat pins the strict reference decode semantics: flat-gray start
    # (no pyramid fast path) and stall_window=0 so the iteration count
    # follows Encoder2.hpp:76-87 exactly (the stall heuristic is this
    # framework's addition; 0 disables it — see DecoderConfig.stall_window).
    dcfg = DecoderConfig(
        max_iterations=args.decode if args.decode > 0 else 300,
        epsilon=args.decode_rms,
        pyramid=not args.compat,
        stall_window=0 if args.compat else DecoderConfig.stall_window,
    )

    if args.decode_file:
        from .codec import unpack_result
        from .codec.bitstream_quadtree import unpack_quadtree
        from .codec.container import is_container, unpack_container
        from .decode import decode_plane
        from .image import save_plane, save_yuv

        def _decode_blob(blob):
            if blob[:4] == b"FTQ1":
                from .encode.quadtree import decode_plane_quadtree

                return decode_plane_quadtree(unpack_quadtree(blob), dcfg)
            return decode_plane(unpack_result(blob), dcfg)

        try:
            with open(args.decode_file, "rb") as f:
                data = f.read()
            blobs = unpack_container(data) if is_container(data) else [data]
            decoded = [_decode_blob(b) for b in blobs]
        except Exception as e:  # struct.error / ValueError / truncated file
            print(f"error: not a valid bitstream: {args.decode_file} ({e})",
                  file=sys.stderr)
            return 2
        if len(decoded) == 3:
            # YUV triple -> RGB (cf. main.cpp:192-200, ImageIO.cpp:86-97)
            save_yuv(*(np.asarray(out) for out, _, _ in decoded), args.result)
        else:
            save_plane(np.asarray(decoded[0][0]), args.result)
        for (_, iters, mse), blob in zip(decoded, blobs):
            print(f"decoded {args.decode_file}: {int(iters)} steps, "
                  f"rms {float(mse):.6g}")
        return 0

    if not args.input:
        print("no input image", file=sys.stderr)
        return 2

    from .image import load_planes, save_plane, save_yuv

    try:
        cfg = _config_from_args(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)  # cf. main.cpp:99-102
        return 2
    from .utils.profiling import PhaseTimer, device_trace

    timer = PhaseTimer() if args.log else None
    trace = device_trace(args.profile) if args.profile else None

    total0 = time.perf_counter()
    with _maybe_phase(timer, "load"):
        y, u, v = load_planes(args.input)
    if trace is not None:
        trace.__enter__()
    try:
        if args.color:
            res_y, out_y = _encode_one(y, args, cfg, dcfg, " [Y]", timer=timer)
            res_u, out_u = _encode_one(u, args, cfg, dcfg, " [U]", timer=timer)
            res_v, out_v = _encode_one(v, args, cfg, dcfg, " [V]", timer=timer)
            save_yuv(out_y, out_u, out_v, args.result)
            results = [(res_y, y), (res_u, u), (res_v, v)]
        else:
            res, out = _encode_one(y, args, cfg, dcfg, timer=timer)
            save_plane(out, args.result)
            results = [(res, y)]
    finally:
        if trace is not None:
            trace.__exit__(None, None, None)
            print(f"profile trace written to {args.profile}")

    if args.out:
        from .codec import pack_result
        from .codec.bitstream_quadtree import pack_quadtree
        from .codec.container import pack_container

        # mean-centred parameterization: o-quantization error stays ~1 gray
        # level instead of being amplified by s (see codec/bitstream.py)
        if args.quadtree:
            blobs = [pack_quadtree(r, plane=pl) for r, pl in results]
        else:
            blobs = [pack_result(r, plane=pl) for r, pl in results]
        # single-plane files stay bare (backwards compatible); color files
        # get the FTCC container frame so the decoder can split the planes
        blob = blobs[0] if len(blobs) == 1 else pack_container(blobs)
        with open(args.out, "wb") as f:
            f.write(blob)
        raw = y.size * (3 if args.color else 1)
        print(f"bitstream: {len(blob)} bytes ({raw / max(len(blob), 1):.1f}x)")

    if timer is not None:
        print("-- phases --")
        print(timer.report())
    print(f"total time: {time.perf_counter() - total0:.4g} s.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
