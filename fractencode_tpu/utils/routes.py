"""Compare and time the two search routes end to end through the encoder.

Shared by ``chip_smoke.py`` (kernel parity phase) and
``scripts/search_routes.py`` (the kernel-vs-XLA timings).
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import jax
import numpy as np

__all__ = ["compare_results", "time_call", "route_parity"]

EXACT_FIELDS = ("domain_idx", "transform", "valid")
CLOSE_FIELDS = ("s", "o", "distance")


def compare_results(a, b, rtol: float = 1e-6) -> dict:
    """Field-by-field agreement of two encode results.

    Winners (``domain_idx``, ``transform``, ``valid``) must be equal
    bitwise; ``s``, ``o`` and ``distance`` within ``rtol`` of ``a``.  Returns
    the count of disagreeing entries per field and ``ok``.
    """
    out = {}
    for f in EXACT_FIELDS:
        out[f] = int((np.asarray(getattr(a, f)) != np.asarray(getattr(b, f))).sum())
    for f in CLOSE_FIELDS:
        x = np.asarray(getattr(a, f), np.float64)
        y = np.asarray(getattr(b, f), np.float64)
        out[f] = int((np.abs(x - y) > rtol * np.abs(x)).sum())
    out["ok"] = all(v == 0 for v in out.values())
    return out


def time_call(fn, reps: int = 5) -> dict:
    """Wall seconds of ``fn()`` (which must return arrays): the first call
    (compile + run) and the median and spread of ``reps`` further calls,
    each ended by ``block_until_ready``."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return dict(first_s=first, median_s=statistics.median(times),
                min_s=min(times), max_s=max(times))


def route_parity(planes, cfg, kernel: str = "pallas", reps: int = 0) -> dict:
    """Encode ``planes`` ([H, W] or [B, H, W] u8) on the plain route and on
    the kernel route ``kernel`` ('pallas', or 'pallas_interpret' by name);
    compare, and time both when ``reps`` > 0."""
    from ..encode import encode_batch_stacked, encode_plane

    planes = jax.device_put(np.asarray(planes, np.uint8))
    enc = encode_plane if planes.ndim == 2 else encode_batch_stacked
    cfg_j = dataclasses.replace(cfg, backend="jnp")
    cfg_k = dataclasses.replace(cfg, backend=kernel)
    ref = enc(planes, cfg_j)
    got = enc(planes, cfg_k)
    out = dict(compare=compare_results(ref, got))
    if reps > 0:
        fields = lambda r: (r.domain_idx, r.transform, r.s, r.o)
        out["jnp"] = time_call(lambda: fields(enc(planes, cfg_j)), reps)
        out["pallas"] = time_call(lambda: fields(enc(planes, cfg_k)), reps)
    return out
