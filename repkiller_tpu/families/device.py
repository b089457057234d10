"""On-device repeat-family clustering (SURVEY.md §1 L4: "overlap graph ->
connected components, iterative label propagation on the device,
finalize on host").

The host computes only the O(m log m) interval table and neighbor ranges
(families/cluster.py _edge_ranges — measured negligible even at 10^5
fragments). Everything edge-shaped runs in ONE jitted program:

- range -> edge expansion with the standard capacity + scatter/cummax
  owner-recovery pattern (same mechanism as seeds/self_join._expand;
  SURVEY.md §7 "Hard parts" #3), ~5 capacity-sized passes;
- the length-ratio edge filter (killed edges become (0, 0) self-loops,
  which are no-ops under scatter-min);
- min-label propagation to fixpoint: per round every edge scatter-mins
  ``min(lab[a], lab[b])`` into both endpoints and one pointer-jumping
  gather (``lab[lab]``) halves label-chain depth -> O(log n) rounds.

The fixpoint labels every fragment with its component's minimum fragment
index — exactly the oracle union-find's root (union-by-smaller-index
keeps roots minimal), so the result is bit-identical to
oracle.pipeline.cluster_families (tests/unit/test_families.py).

The path is opt-in and never taken on the CPU backend (cluster.py): XLA
CPU lowers scatter to a serial loop that loses to numpy's ufunc.at, so
CPU runs keep the streamed host path; tests force the device path with
``device_min_edges=0``. Shapes are bucketed to powers of two so repeated
calls at similar scales reuse compiled programs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _bucket(n: int, floor: int = 1 << 10) -> int:
    return max(floor, 1 << int(max(n - 1, 1)).bit_length())


@functools.partial(jax.jit, static_argnames=("e_cap", "n_pad", "pct"))
def _expand_filter_propagate(fidx, counts, lo, lens, e_cap: int,
                             n_pad: int, pct: int):
    """See module docstring. fidx/counts/lo are the interval table in
    (space, start, end, fidx) lex order; lens is per-FRAGMENT length."""
    m = counts.shape[0]
    xi = jnp.arange(m, dtype=jnp.int32)
    csum = jnp.cumsum(counts)
    offs = csum - counts
    t = jnp.arange(e_cap, dtype=jnp.int32)
    # slot t -> source interval: scatter each nonempty range's start slot,
    # then a running max recovers ownership for every slot
    bidx = jnp.where(counts > 0, jnp.minimum(offs, e_cap), e_cap)
    owner = jnp.zeros(e_cap + 1, jnp.int32).at[bidx].max(xi)
    src = jnp.minimum(jax.lax.cummax(owner[:e_cap]), m - 1)
    partner = lo[src] + (t - offs[src])
    valid = t < csum[m - 1]
    ea = fidx[src]
    eb = fidx[jnp.clip(partner, 0, m - 1)]
    keep = valid & (ea != eb)
    la, lb = lens[ea], lens[eb]
    keep &= jnp.minimum(la, lb) * 100 >= pct * jnp.maximum(la, lb)
    ea = jnp.where(keep, ea, 0)
    eb = jnp.where(keep, eb, 0)

    def body(state):
        lab, _ = state
        mn = jnp.minimum(lab[ea], lab[eb])
        new = lab.at[ea].min(mn).at[eb].min(mn)
        new = new[new]                           # pointer jumping
        return new, jnp.any(new != lab)

    lab0 = jnp.arange(n_pad, dtype=jnp.int32)
    lab, _ = jax.lax.while_loop(lambda s: s[1], body,
                                (lab0, jnp.bool_(True)))
    return lab


def cluster_families_jit(n: int, fidx: np.ndarray, counts: np.ndarray,
                         offs: np.ndarray, lo: np.ndarray,
                         lens: np.ndarray, pct: np.int64,
                         total: int) -> np.ndarray:
    """Entry from families/cluster.py. Returns labels identical to the
    streamed host path. Caller guarantees total <= DEVICE_EDGE_CAP and
    lens * 100 fits int32 (else it falls back to the host path)."""
    if not total:
        return np.arange(n, dtype=np.int32)
    m = fidx.shape[0]
    m_pad = _bucket(m)
    # padded intervals: empty ranges pointing at interval 0 (count 0)
    fidx_p = np.zeros(m_pad, np.int32)
    fidx_p[:m] = fidx
    counts_p = np.zeros(m_pad, np.int32)
    counts_p[:m] = counts
    lo_p = np.zeros(m_pad, np.int32)
    lo_p[:m] = lo
    out = _expand_filter_propagate(
        jnp.asarray(fidx_p), jnp.asarray(counts_p), jnp.asarray(lo_p),
        jnp.asarray(lens.astype(np.int32)),
        e_cap=_bucket(total), n_pad=_bucket(n), pct=int(pct))
    return np.asarray(out[:n])
