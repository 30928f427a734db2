"""Vector-quantization codebook training (LBG / k-means).

Port of the reference's ``generateCodebook``
(``/root/reference/encode/CodebookGenerator.hpp:84-162``): random unique
seeding, assign-to-nearest + centroid update until the max codeword movement
drops below epsilon or ``max_steps`` (reference default 200).  Like the
reference it is a tested building block for domain-pool pruning — train a
small codebook over the sampled domain vectors and search only the domains
whose codeword matches the range's (a learned generalization of the 6-class
brightness classifier).

Differences: the assign step is one [N, K] x [K, D] matmul instead of a
per-vector linear scan, the update is a segment-sum, and the
loop is a ``lax.while_loop`` with static shapes (empty clusters keep their
previous codeword, matching the reference's "no members -> unchanged"
behaviour implied by its epsilon loop).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["train_codebook", "assign_codes"]


def _pairwise_sq_dists(x, c):
    """[N, M] squared distances via the five-sums identity (one matmul)."""
    xx = (x * x).sum(axis=1, keepdims=True)  # [N, 1]
    cc = (c * c).sum(axis=1)[None, :]  # [1, M]
    xc = jax.lax.dot_general(
        x, c, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return xx - 2.0 * xc + cc


def assign_codes(x: jnp.ndarray, codebook: jnp.ndarray) -> jnp.ndarray:
    """[N] index of the nearest codeword for each vector (ties -> lowest)."""
    return jnp.argmin(_pairwise_sq_dists(x, codebook), axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("num_codes", "max_steps",
                                              "sample_limit"))
def train_codebook(
    x: jnp.ndarray,
    key: jax.Array,
    num_codes: int,
    max_steps: int = 200,
    epsilon: float = 1e-3,
    sample_limit: int | None = None,
):
    """Train an LBG codebook over [N, D] vectors.

    Returns (codebook [num_codes, D] f32, assignments [N] i32, steps i32).
    Seeding draws ``num_codes`` distinct input vectors (the reference's
    ``UniqueIndexGenerator`` random unique seeding,
    ``CodebookGenerator.hpp:10-38``).  ``sample_limit`` trains on a random
    subsample (the reference's ``LimitRange`` cluster-selection policy,
    ``CodebookGenerator.hpp:40-82``); assignments are still returned for the
    full input.
    """
    n_full, d = x.shape
    x_full = x.astype(jnp.float32)
    if sample_limit is not None and sample_limit < n_full:
        key, sub = jax.random.split(key)
        idx = jax.random.choice(sub, n_full, shape=(sample_limit,), replace=False)
        x = x_full[idx]
    else:
        x = x_full
    n = x.shape[0]
    seed_idx = jax.random.choice(key, n, shape=(num_codes,), replace=False)
    init = x[seed_idx]

    def body(carry):
        codebook, _, steps, _ = carry
        assign = assign_codes(x, codebook)
        one_hot = jax.nn.one_hot(assign, num_codes, dtype=jnp.float32)  # [N, M]
        counts = one_hot.sum(axis=0)  # [M]
        sums = jax.lax.dot_general(
            one_hot, x, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [M, D]
        new = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0),
                        codebook)
        move = jnp.sqrt(((new - codebook) ** 2).sum(axis=1)).max()
        return new, assign, steps + 1, move < epsilon

    def cond(carry):
        _, _, steps, done = carry
        return (steps < max_steps) & ~done

    codebook, assign, steps, _ = jax.lax.while_loop(
        cond, body, (init, jnp.zeros(n, jnp.int32), jnp.int32(0), jnp.bool_(False))
    )
    # final assignment of the FULL input against the converged codebook
    assign = assign_codes(x_full, codebook)
    return codebook, assign, steps
