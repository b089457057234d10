"""On-device hit thinning (SURVEY.md §2.2 "Hit filtering", `filterHits`).

Bucket-quantised diagonal thinning, matching oracle.pipeline.filter_hits:
sort hits by (diag, px) — a total order, since (diag, px) determines py —
and keep the first hit of every (diag, px // min_hit_dist) bucket. A
stable partition then squeezes the kept hits to the front, so the output
is extension-ready: a dense, deterministic seed list.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils.scan import partition_live


INT32_MAX = jnp.int32(0x7FFFFFFF)


def filter_hits(
    hpx: jnp.ndarray, hpy: jnp.ndarray, hvalid: jnp.ndarray, min_hit_dist: int,
    out_capacity: int = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """-> (px, py, valid, n_kept); kept hits dense at the front, sorted by
    (diag, px).

    Sort operand packing: the validity flag rides in the diagonal key
    (invalid -> INT32_MAX, unreachable for |diag| < 2^31 genuine hits),
    and py is payload, not key — (diag, px) already determines py, so
    (diagI, px) is a total order over hits. 3 operands / 2 keys per
    pass vs the naive 4 / 4.

    out_capacity (static, <= hit capacity) trims the compacted output
    arrays: seeds are thinned hits, so a tighter static bound shrinks
    every capacity-sized op downstream (Config.seed_capacity). n_kept is
    always the TRUE count — the caller must raise when it exceeds
    out_capacity (truncation is never silent)."""
    diag = hpx - hpy                     # int32; genomes < 2^31 bp
    diagI = jnp.where(hvalid, diag, INT32_MAX)
    diag_s, px_s, py_s = jax.lax.sort((diagI, hpx, hpy), num_keys=2)
    valid_s = diag_s != INT32_MAX
    bucket = px_s // jnp.int32(min_hit_dist)
    first = jnp.ones_like(px_s, dtype=bool)
    first = first.at[1:].set(
        (diag_s[1:] != diag_s[:-1]) | (bucket[1:] != bucket[:-1])
    )
    keep = valid_s & first

    # compact kept hits to the front, preserving (diag, px) order: a
    # stable partition (one scatter + one row gather, trimmed to
    # out_capacity) instead of a second capacity-sized 3-operand sort.
    # (px, py) ride ONE (n, 2) row gather instead of two element gathers.
    order, _, n_kept = partition_live(keep)
    if out_capacity is not None and out_capacity < order.shape[0]:
        order = order[:out_capacity]
    rows = jnp.stack([px_s, py_s], axis=1)[order]
    px_c, py_c = rows[:, 0], rows[:, 1]
    valid_c = jnp.arange(px_c.shape[0], dtype=jnp.int32) < n_kept
    px_c = jnp.where(valid_c, px_c, 0)
    py_c = jnp.where(valid_c, py_c, 0)
    return px_c, py_c, valid_c, n_kept
