#!/usr/bin/env python
"""Multi-process batch encode runner.

Runs the multi-image batch encode + on-device fixed-point decode over a
(data x search) device mesh, across one or many processes: the same script
is launched once per process (SPMD), brings up ``jax.distributed``, splits
the global batch with ``host_local_batch``, assembles the global sharded
array, and reports frames/s.

One process driving every local device:

    python scripts/encode_pod.py --batch 16 --size 512

Several processes (same command for each; nothing on the machine tells JAX
of a cluster, so give the coordinator, the count and the id):

    python scripts/encode_pod.py --batch 64 --size 512 \
        --coordinator localhost:1234 --num-processes 4 --process-id $ID

When several processes share one host with GPUs, each takes its own card
(process i uses card i, or the single id ``--local-device-ids`` names): a
JAX process reserves most of a card's memory when it starts.  The encode
itself is ``parallel.sharded.encode_batch_sharded``; the mesh's ``data``
axis spans processes.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=16,
                   help="GLOBAL batch size (must divide evenly over hosts)")
    p.add_argument("--size", type=int, default=512, help="square frame size")
    p.add_argument("--image", default=None,
                   help="replicate this image as the batch (default: "
                        "seeded natural content)")
    p.add_argument("--strategy", choices=["ranges", "domains", "ring"],
                   default="ranges")
    p.add_argument("--n-data", type=int, default=None,
                   help="mesh data-axis size (default: one per host, or the "
                        "device count if that leaves no search axis)")
    p.add_argument("--reps", type=int, default=3, help="timing repetitions")
    p.add_argument("--decode", action="store_true",
                   help="also run the sharded fixed-point decode")
    # multi-host bring-up (also honours JAX_COORDINATOR_ADDRESS etc.)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--init-timeout", type=float, default=None,
                   help="seconds to wait for the coordinator before failing")
    p.add_argument("--local-device-ids", default=None,
                   help="comma-separated local card ids for this process "
                        "(default with several processes on one host: "
                        "card = process id)")
    return p


def resolve_mesh_shape(n_devices: int, n_hosts: int, n_data: int | None):
    """(n_data, n_search) for the global mesh."""
    if n_data is None:
        n_data = n_hosts if n_devices > n_hosts else n_devices
    if n_devices % n_data:
        raise ValueError(f"--n-data {n_data} does not divide {n_devices} devices")
    return n_data, n_devices // n_data


def load_frames(args, per_host: int) -> np.ndarray:
    if args.image:
        from fractencode_tpu.image import load_gray

        base = np.asarray(load_gray(args.image))
        reps = -(-args.size // min(base.shape))
        base = np.tile(base, (reps, reps))[: args.size, : args.size]
    else:
        from fractencode_tpu.image.synth import natural_image

        base = natural_image(0, args.size, args.size)
    return np.stack([base] * per_host)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from fractencode_tpu.parallel.distributed import (
        host_local_batch,
        initialize_multihost,
        is_multihost,
        one_card_per_process,
    )
    from fractencode_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()

    multi = (
        args.coordinator
        or args.num_processes
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if multi:
        ids = (None if args.local_device_ids is None else
               [int(i) for i in args.local_device_ids.split(",")])
        ids = one_card_per_process(
            args.coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS"),
            args.num_processes, args.process_id, ids)
        info = initialize_multihost(args.coordinator, args.num_processes,
                                    args.process_id, args.init_timeout,
                                    local_device_ids=ids)
        print(f"multihost up: {info}")

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fractencode_tpu.params import EncoderConfig
    from fractencode_tpu.parallel import (
        decode_batch_sharded,
        encode_batch_sharded,
        make_mesh,
    )
    from fractencode_tpu.parallel.mesh import DATA_AXIS

    n_hosts = jax.process_count()
    n_data, n_search = resolve_mesh_shape(len(jax.devices()), n_hosts, args.n_data)
    mesh = make_mesh(n_data=n_data, n_search=n_search)
    cfg = EncoderConfig()

    per_host, offset = host_local_batch(args.batch)
    local = load_frames(args, per_host)

    # assemble the global [B, H, W] array from per-host slices; on one host
    # this is a plain device_put
    sharding = NamedSharding(mesh, P(DATA_AXIS, None, None))
    if is_multihost():
        global_batch = jax.make_array_from_process_local_data(sharding, local)
    else:
        global_batch = jax.device_put(jnp.asarray(local), sharding)

    def pull_scalar(x):
        """Multihost-safe completion barrier: reduce the (possibly
        non-process-local) sharded array to a replicated scalar every
        process can fetch — ``device_get`` of a global array whose shards
        live on other hosts raises "not fully addressable"."""
        return float(jax.jit(lambda a: jnp.asarray(a, jnp.float32).sum())(x))

    # warmup (compile)
    results = encode_batch_sharded(global_batch, cfg, mesh, args.strategy)
    pull_scalar(results[0].domain_idx)

    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        results = encode_batch_sharded(global_batch, cfg, mesh, args.strategy)
        pull_scalar(results[-1].domain_idx)
        pull_scalar(results[-1].s)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    frames_s = args.batch / dt
    mpix_s = frames_s * args.size * args.size / 1e6
    # deterministic cross-run checksum (same value on every process; lets a
    # 2-process run be compared against a single-process run of the same
    # config in tests/test_distributed.py)
    chk = sum(pull_scalar(r.domain_idx) + pull_scalar(r.transform)
              for r in results)
    if jax.process_index() == 0:
        print(
            f"encode: {args.batch}x{args.size}^2 strategy={args.strategy} "
            f"mesh={dict(mesh.shape)} hosts={n_hosts}: "
            f"{dt:.4f} s -> {frames_s:.2f} frames/s, {mpix_s:.1f} Mpix/s"
        )
        print(f"checksum: {chk:.0f}")

    if args.decode:
        outs, iters, mse = decode_batch_sharded(results, mesh)
        pull_scalar(iters)
        t0 = time.perf_counter()
        outs, iters, mse = decode_batch_sharded(results, mesh)
        iters_sum = pull_scalar(iters)
        out_chk = pull_scalar(outs)
        dt = time.perf_counter() - t0
        if jax.process_index() == 0:
            print(
                f"decode: {dt:.4f} s -> {args.batch / dt:.2f} frames/s "
                f"(mean iters={iters_sum / args.batch:.1f})"
            )
            print(f"decode checksum: {out_chk:.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
