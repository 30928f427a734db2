"""Multi-host runtime bring-up.

The reference is a single process (SURVEY.md section 5: no distributed
communication backend).  Here: ``jax.distributed``
initialization across hosts, with the failure surface the brief asks for —
fail loudly with enough context to act on, since the recovery story for a
deterministic pure encoder is simply "rerun the failed work".

Exercised for real by ``tests/test_distributed.py``: two localhost CPU
processes (Gloo collectives) run the full pod driver and must match a
single-process run bitwise.  The multi-chip *logic* is additionally covered
by the virtual-device mesh tests (tests/test_parallel.py) and the driver's
``dryrun_multichip``.
"""
from __future__ import annotations

import os

import jax

__all__ = ["initialize_multihost", "is_multihost", "host_local_batch",
           "one_card_per_process"]

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1", "[::1]")


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: float | None = None,
    local_device_ids: list[int] | None = None,
) -> dict:
    """Initialize the multi-host runtime. Returns a summary dict.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID) when all are None; JAX's cluster
    auto-detection applies only where a cluster manager is present, so on
    a bare GPU host pass them explicitly.  ``initialization_timeout``
    (seconds) bounds how long workers wait for the coordinator before
    failing loudly (default: JAX's 300 s).  ``local_device_ids`` restricts
    this process to those local cards (see ``one_card_per_process``).
    """
    kwargs = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = (
            coordinator_address or os.environ["JAX_COORDINATOR_ADDRESS"]
        )
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if initialization_timeout is not None:
        kwargs["initialization_timeout"] = initialization_timeout
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    try:
        jax.distributed.initialize(**kwargs)
    except Exception as e:
        raise RuntimeError(
            "multi-host initialization failed "
            f"(coordinator={kwargs.get('coordinator_address', 'auto')}, "
            f"pid={kwargs.get('process_id', 'auto')}): {e}. "
            "Each host must run the same program; check that the coordinator "
            "is reachable and every process uses a distinct process_id."
        ) from e
    return dict(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=len(jax.local_devices()),
        global_devices=len(jax.devices()),
    )


def one_card_per_process(coordinator_address: str | None,
                         num_processes: int | None, process_id: int | None,
                         explicit: list[int] | None = None,
                         platforms: str | None = None) -> list[int] | None:
    """``local_device_ids`` for one process of a multi-process run.

    A JAX process reserves most of a GPU's memory when it first uses it, so
    several processes on one host must each own a different card.  With a
    coordinator on this host and more than one process, process i takes
    card i unless ``explicit`` ids are given; a CPU-only run
    (``JAX_PLATFORMS=cpu``) and single-process runs restrict nothing.
    Raises when the explicit ids would give one process several cards on a
    shared host."""
    platforms = os.environ.get("JAX_PLATFORMS", "") if platforms is None \
        else platforms
    if not num_processes or num_processes < 2 or not coordinator_address:
        return explicit
    if coordinator_address.rsplit(":", 1)[0] not in _LOCAL_HOSTS:
        return explicit
    if platforms and set(platforms.split(",")) <= {"cpu"}:
        return explicit
    if explicit is None:
        return [process_id]
    if len(explicit) != 1:
        raise ValueError(
            f"{num_processes} processes share this host: give each one card "
            f"(--local-device-ids with one id), not {explicit}")
    return explicit


def is_multihost() -> bool:
    return jax.process_count() > 1


def host_local_batch(global_batch: int) -> tuple[int, int]:
    """(per-host batch, offset of this host's slice) for even host splits."""
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    return per, per * jax.process_index()
