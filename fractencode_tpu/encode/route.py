"""The one place that chooses the search route.

Routes:
  * ``'jnp'``   — the plain ``search`` (XLA; the reference every test pins).
  * ``'pallas'`` — the compiled search kernel (ops/search_kernel.py).  Only
    a GPU has a compiled route; asking for it elsewhere is an error.
  * ``'pallas_interpret'`` — the same kernel run by the Pallas interpreter.
    It runs only when a caller names it (the CPU tests do); no platform
    check ever selects it.

``EncoderConfig.backend='auto'`` takes the kernel on a GPU (it beat the
plain route end to end on the H100; see PERF.md) and the plain route
everywhere else.
"""
from __future__ import annotations

import jax

from ..params import EncoderConfig

__all__ = ["resolve_route", "run_search", "COMPILED_PLATFORMS"]

# platforms on which the Pallas search kernel compiles (Triton route)
COMPILED_PLATFORMS = ("gpu",)


def _kernel_takes(cfg: EncoderConfig) -> bool:
    """The kernel's early-accept frontier (live at every threshold: an exact
    fit stops the reference's scan even at rms_threshold 0) needs whole
    domain groups in each column tile: the isometry count must divide it."""
    from ..ops.search_kernel import DEFAULT_BLOCKS

    return DEFAULT_BLOCKS[1] % cfg.num_transforms == 0


def resolve_route(cfg: EncoderConfig) -> str:
    """'jnp', 'pallas' or 'pallas_interpret' for ``cfg`` on this platform."""
    platform = jax.default_backend()
    backend = cfg.backend
    if backend == "auto":
        if platform in COMPILED_PLATFORMS and _kernel_takes(cfg):
            return "pallas"
        return "jnp"
    if backend == "pallas" and platform not in COMPILED_PLATFORMS:
        raise ValueError(
            f"backend='pallas' has no compiled route on platform "
            f"{platform!r} (only {', '.join(COMPILED_PLATFORMS)}); use "
            "backend='jnp', or 'pallas_interpret' to run the kernel in the "
            "Pallas interpreter")
    if backend != "jnp" and not _kernel_takes(cfg):
        raise ValueError(
            f"the search kernel takes num_transforms in 1, 2, 4 or 8, not "
            f"{cfg.num_transforms}; use backend='jnp'")
    return backend


def run_search(ranges, sum_a, sum_a2, cb, range_classes, domain_classes,
               cfg: EncoderConfig, domain_mask=None, range_mask=None):
    """Search on the route ``resolve_route(cfg)`` chooses."""
    from .matcher import search, search_kernel

    route = resolve_route(cfg)
    if route == "jnp":
        return search(ranges, sum_a, sum_a2, cb, range_classes,
                      domain_classes, cfg, domain_mask=domain_mask,
                      range_mask=range_mask)
    return search_kernel(ranges, sum_a, sum_a2, cb, range_classes,
                         domain_classes, cfg, domain_mask=domain_mask,
                         range_mask=range_mask,
                         interpret=route == "pallas_interpret")
