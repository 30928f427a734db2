"""Device mesh helpers.

The reference's only parallelism is a mutex-guarded thread pool
(reference ``encode/EncodingEngine2.hpp:118-171``).  Here it is a
``jax.sharding.Mesh``: static sharding over named axes replaces dynamic
work stealing (uniform cost per range block once data-dependent early-exit
is dropped), and XLA collectives replace shared memory.  ``make_mesh`` only
reshapes ``jax.devices()``: the GPUs of one host are joined all to all by
NVLink, so any assignment of devices to mesh positions is equally good.

Axes:
  * ``data``   — independent images (batch): the pure data-parallel axis.
  * ``search`` — within one image, either range tiles (codebook replicated)
    or domain-codebook shards (argmin-allreduce), see ``sharded.py``.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "DATA_AXIS", "SEARCH_AXIS"]

DATA_AXIS = "data"
SEARCH_AXIS = "search"


def make_mesh(n_data: int = 1, n_search: int | None = None, devices=None) -> Mesh:
    """Build a (data, search) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_search is None:
        n_search = len(devices) // n_data
    if n_data * n_search > len(devices):
        raise ValueError(f"mesh {n_data}x{n_search} exceeds {len(devices)} devices")
    devs = np.asarray(devices[: n_data * n_search]).reshape(n_data, n_search)
    return Mesh(devs, (DATA_AXIS, SEARCH_AXIS))
