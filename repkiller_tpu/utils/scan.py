"""Segmented-scan helpers for the device pipeline (jnp, jit-safe)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF32 = jnp.int32(-(1 << 30))


def segmented_cummax(values: jnp.ndarray, boundary: jnp.ndarray) -> jnp.ndarray:
    """Inclusive per-segment running max.

    boundary[i] == 1 marks the start of a new segment at i (boundary[0] must
    be 1). Implemented with an associative scan over (reset, value) pairs:
    (ra, va) • (rb, vb) = (ra|rb, vb if rb else max(va, vb)).
    """
    boundary = boundary.astype(jnp.int32)

    def combine(a, b):
        ra, va = a
        rb, vb = b
        return ra | rb, jnp.where(rb == 1, vb, jnp.maximum(va, vb))

    _, out = jax.lax.associative_scan(combine, (boundary, values))
    return out


def partition_live(flag: jnp.ndarray):
    """Stable front-compaction permutation for a boolean mask.

    Returns ``(order, dest, n_live)`` where ``order`` lists live slots
    first (slot order preserved within each class) and ``dest`` is its
    inverse permutation (``order[dest[i]] = i``), so a compacted-result
    array ``R`` maps back to slot order as ``R[dest]``. Built from one
    cumsum and ONE scatter — a capacity-sized ``argsort`` pair or a
    compaction ``lax.sort`` costs several full passes for the same
    permutation."""
    n = flag.shape[0]
    c = jnp.cumsum(flag.astype(jnp.int32))
    n_live = c[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    dest = jnp.where(flag, c - 1, n_live + idx - c)
    order = jnp.zeros(n, jnp.int32).at[dest].set(idx, unique_indices=True)
    return order, dest, n_live


def prefix_in_segment(values: jnp.ndarray, boundary: jnp.ndarray, fill) -> jnp.ndarray:
    """Exclusive per-segment prefix of an inclusive per-segment scan result.

    values must already be the inclusive segmented scan; element 0 of each
    segment gets `fill`.
    """
    shifted = jnp.concatenate([jnp.full((1,), fill, values.dtype), values[:-1]])
    return jnp.where(boundary.astype(bool), jnp.full_like(values, fill), shifted)
