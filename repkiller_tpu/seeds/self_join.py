"""Both-strand seed hits of a self-comparison from ONE canonical index
(SURVEY.md §2.2 "Hit finding"; replaces the revcomp-index build + sorted
rank join of the generic path for the self-comparison pipeline).

Bit-identical hit SETS to oracle.pipeline.find_hits on (X, X) and
(X, revcomp(X)) — order differs, which is immaterial: the downstream
thinning sort (seeds/filter.py) is a total order on hit values.

Per canonical-index entry i (flag s, run [lo, mid) ++ [mid, hi) split by
flag, pos-sorted within each subrun — index/canonical.py):

  forward partners  = same-flag subrun entries AFTER me      [i+1, own_end)
                      (palindromic runs are all flag 0, so own = whole run)
  reverse partners  = opposite-flag subrun entries with pos >= mine
                      [alt_start + alt_before, alt_end)
                      palindromic run: whole run from me on  [i, hi)
                      (p == q kept once — the oracle's "a seed that is
                      its own reverse complement" rule)

Occurrence caps mirror the oracle exactly: a k-mer with more than
max_occ occurrences on either side contributes nothing; forward sides
are both |own|, reverse sides are |own| and |alt| (palindromic: whole
run on both sides, both strands).

Reverse hits are emitted in revcomp-space y coordinates
(py = y_len - k - q), matching what the downstream extension against
revcomp(X) expects.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..index.canonical import CanonIndex
from .join import owner_rows


def _expand(lo: jnp.ndarray, counts: jnp.ndarray, capacity: int,
            pos: jnp.ndarray
            ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Slot t of the static-capacity output -> (source POSITION, partner
    index, valid, total). Owner recovery via seeds/join.owner_rows
    (sort-compaction: the block-start scatter runs at capacity size,
    not n — see its docstring)."""
    n = counts.shape[0]
    csum = jnp.cumsum(counts)
    total = csum[-1] if n > 0 else jnp.int32(0)
    offs = csum - counts
    t = jnp.arange(capacity, dtype=jnp.int32)
    rows = owner_rows(counts, offs, capacity, (lo, pos))
    y_idx = rows[:, 1] + (t - rows[:, 0])
    return rows[:, 2], y_idx, t < total, total


def join_self_canonical(
    ci: CanonIndex, k: int, max_occ: int, capacity: int, y_len: int,
    entry_slice: Tuple = None,
) -> Tuple[Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray],
           Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """-> ((hpx_f, hpy_f, valid_f, total_f), (hpx_r, hpy_r, valid_r,
    total_r)) — forward and reverse strand hits, static capacity each.

    Entries iterate in A (pos-interleaved) order; partner intervals are
    B-slot ranges (index/canonical.py) whose positions are gathered from
    the scattered ``pos_b`` view. My own B slot = own subrun start + own
    rank.

    entry_slice=(offset, blk) restricts ENUMERATION to entries
    [offset, offset + blk): per-entry fields are sliced (so the
    expansion's sorts/scans run at blk, not n) while partner gathers
    still read the full ``pos_b``. Because every hit has exactly one
    source entry, the hit sets of a partition of entry slices partition
    the full hit set — the per-device decomposition of the sharded
    canonical self path (dist/sharded.py)."""
    n = ci.pos.shape[0]
    if entry_slice is None:
        off = jnp.int32(0)
        sl = lambda a: a                            # noqa: E731
        m = n
    else:
        off, m = entry_slice[0].astype(jnp.int32), int(entry_slice[1])
        sl = lambda a: jax.lax.dynamic_slice(a, (off,), (m,))  # noqa: E731
    pos, flag, palin = sl(ci.pos), sl(ci.flag), sl(ci.palin)
    run_lo, run_mid, run_hi = sl(ci.run_lo), sl(ci.run_mid), sl(ci.run_hi)
    own_rank, alt_before = sl(ci.own_rank), sl(ci.alt_before)

    xi = off + jnp.arange(m, dtype=jnp.int32)
    is_valid = xi < ci.n_valid
    own_lo = jnp.where(flag == 0, run_lo, run_mid)
    own_hi = jnp.where(flag == 0, run_mid, run_hi)
    alt_lo = jnp.where(flag == 0, run_mid, run_lo)
    alt_hi = jnp.where(flag == 0, run_hi, run_mid)
    own_n = own_hi - own_lo
    alt_n = alt_hi - alt_lo
    run_n = run_hi - run_lo
    slot = own_lo + own_rank             # my B slot

    # ---- forward: same k-mer, px < py ----
    # palindromic runs are all flag 0, so own == run there and no
    # palin special case is needed on the forward side
    occ_f = own_n                                    # both sides equal
    keep_f = is_valid & (occ_f <= max_occ)
    f_lo = slot + 1
    cnt_f = jnp.where(keep_f, jnp.maximum(own_hi - f_lo, 0), 0)
    px_f, yi_f, valid_f, total_f = _expand(f_lo, cnt_f, capacity, pos)
    hpx_f = jnp.where(valid_f, px_f, 0)
    hpy_f = jnp.where(valid_f, ci.pos_b[jnp.clip(yi_f, 0, n - 1)], 0)

    # ---- reverse: km_p == rc(km_q), p <= q (palindrome self kept once) ----
    occ_rx = own_n                                   # km_p occurrences in X
    occ_ry = jnp.where(palin, run_n, alt_n)          # in revcomp(X)
    keep_r = is_valid & (occ_rx <= max_occ) & (occ_ry <= max_occ)
    r_lo = jnp.where(palin, slot, alt_lo + alt_before)
    r_hi = jnp.where(palin, run_hi, alt_hi)
    cnt_r = jnp.where(keep_r, jnp.maximum(r_hi - r_lo, 0), 0)
    px_r, yi_r, valid_r, total_r = _expand(r_lo, cnt_r, capacity, pos)
    hpx_r = jnp.where(valid_r, px_r, 0)
    q = ci.pos_b[jnp.clip(yi_r, 0, n - 1)]
    hpy_r = jnp.where(valid_r, jnp.int32(y_len - k) - q, 0)

    return ((hpx_f, hpy_f, valid_f, total_f),
            (hpx_r, hpy_r, valid_r, total_r))
