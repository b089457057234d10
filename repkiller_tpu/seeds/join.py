"""On-device seed-hit finding (SURVEY.md §1 L2, §2.2 "Hit finding").

The reference joins two disk dictionaries (`hits` + `sortHits`); here the
join is a vectorised binary-search merge over two HBM-resident sorted
k-mer arrays, followed by a static-capacity pair expansion:

  1. per X-entry, locate its k-mer's run [lo, hi) in the Y index
     (searchsorted against the valid, kmer-sorted prefix);
  2. hyper-repeat cap: entries whose k-mer occurs > max_occ times on
     either side contribute nothing (matches oracle.pipeline.find_hits);
  3. self-comparison bounds are EXACT, not post-filtered: the canonical
     half (px < py for "f", px <= y_anchor for "r") is carved out of
     [lo, hi) with a (kmer, pos) composite-key rank, so the reported
     total is the true hit count and no capacity is wasted on hits that
     a validity filter would then drop. All bisection ranks — lo, hi,
     and the pair bound — come from ONE `lax.sort` of targets+queries
     (ranks_by_sort): both sides are already sorted, so the join is a
     merge, and a merge is one sort away;
  4. exclusive-scan the per-entry pair counts, then map output slot t
     back to its source entry with a scatter of entry ids at their
     offsets + running max (the standard capacity + two-pass XLA
     pattern, SURVEY.md §7 "Hard parts" #3, with O(capacity) owner
     recovery instead of a search).

Sharding hooks (SURVEY.md §2.3 / §3.4): `shard` restricts the join to
k-mers owned by one hash-prefix shard (ownership = high bits of the
k-mer, so each k-mer's whole Y-run lives in exactly one shard and the
per-shard hit sets partition the global hit set); `occ_idx` supplies the
FULL X index for occurrence counting when `kx` is only a window of X.

Output hits carry a validity mask plus the TRUE total pair count so the
host can detect capacity overflow (overflow is detected, never silent).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


MAXP = (1 << 31) - 1      # > any valid position (genomes < 2^31 bp)


def ranks_by_sort(ka, pa, n_valid, kqs, pqs):
    """Right-bisect several query sets into one sorted (kmer, pos) index
    with a SINGLE `lax.sort` — no binary-search gather loops.

    (ka, pa) is lexicographically sorted on the valid prefix [0, n_valid)
    (index/build.py's invariant). For each query set q, returns
    ``rank[q][i]`` = number of valid entries with (k, p) <= (kqs[q][i],
    pqs[q][i]) — i.e. the right-bisect insertion position of the composite
    key, the quantity every join bound needs.

    Mechanism (both sides are ALREADY sorted, so this is a merge, and a
    merge is one sort away): concatenate targets and all queries, sort by
    (kmer, pos, qid) where targets carry qid < 0 so an equal-key target
    orders BEFORE the query and is counted by the inclusive scan; the
    rank of each row is the running count of valid targets; queries read
    their rank back through one scatter on the sorted qid.

    Replaces `jnp.searchsorted(..., method="sort")` pairs (two sorts) plus
    a log2(n)-step fori_loop of 4M-wide gathers — the former join-stage
    hot spot (SURVEY.md §5 stage metrics).
    """
    nt = ka.shape[0]
    nq = kqs[0].shape[0]
    Q = len(kqs)
    ti = jnp.arange(nt, dtype=jnp.int32)
    # valid targets qid=-1, invalid (sentinel tail) qid=-2: both sort
    # before any equal-key query, only -1 rows are counted
    t_qid = jnp.where(ti < n_valid.astype(jnp.int32), -1, -2).astype(jnp.int32)
    K = jnp.concatenate([ka] + [kq.astype(ka.dtype) for kq in kqs])
    P = jnp.concatenate([pa.astype(jnp.int32)]
                        + [pq.astype(jnp.int32) for pq in pqs])
    QID = jnp.concatenate([t_qid, jnp.arange(Q * nq, dtype=jnp.int32)])
    _, _, qid_s = jax.lax.sort((K, P, QID), num_keys=3)
    rank = jnp.cumsum((qid_s == -1).astype(jnp.int32))
    # scatter ranks back to query order; target rows all land in the
    # discarded spill slot Q*nq (dup writes there are never read)
    out = jnp.zeros(Q * nq + 1, jnp.int32)
    out = out.at[jnp.where(qid_s >= 0, qid_s, Q * nq)].set(rank)
    return [out[q * nq:(q + 1) * nq] for q in range(Q)]


def owner_rows(counts: jnp.ndarray, offs: jnp.ndarray, capacity: int,
               vals: Tuple[jnp.ndarray, ...]) -> jnp.ndarray:
    """Static-capacity block expansion: slot t -> (offs, *vals) of the
    contributing entry that owns it (the entry whose exclusive offset
    block [offs, offs+count) contains t). Returns (capacity, 1+len(vals))
    int32 rows; callers derive the intra-block index as t - rows[:, 0].

    Scattering ALL n entry ids at their block starts would cost an
    n-element scatter, though only the contributing entries (count > 0,
    at most `capacity` of them since each produces >= 1 output) matter.
    One 1-key sort compacts the contributors to a dense offs-sorted
    prefix first, so the block-start scatter shrinks to `capacity`
    elements and the per-slot value reads ride one row gather from the
    compacted rows. The slot->owner mapping is
    unchanged (owner = last block start <= t, recovered by the same
    scatter + running max), so the output is bit-identical.
    """
    n = counts.shape[0]
    key = jnp.where(counts > 0, offs, jnp.int32(0x7FFFFFFF))
    dense = jax.lax.sort((key,) + tuple(v.astype(jnp.int32) for v in vals),
                         num_keys=1)
    m = min(capacity, n)
    dense = [d[:m] for d in dense]
    ci = jnp.arange(m, dtype=jnp.int32)
    # contributors have strictly increasing offs (unique slots); the
    # first one starts at offs 0, so every t < total is covered. Entries
    # past capacity (overflow, detected via total) land in the spill.
    bidx = jnp.where(dense[0] < capacity, dense[0], capacity)
    owner = jnp.zeros(capacity + 1, jnp.int32).at[bidx].set(ci)
    src = jax.lax.cummax(owner[:capacity])
    return jnp.stack(dense, axis=1)[src]             # (capacity, 1+len(vals))


def _run_bounds(k_sorted: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-entry [run_start, run_end) of equal-value runs in a sorted
    array — two O(n) scans, no searching."""
    n = k_sorted.shape[0]
    i_idx = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones(1, bool),
                             k_sorted[1:] != k_sorted[:-1]])
    lo = jax.lax.cummax(jnp.where(first, i_idx, 0))
    last = jnp.concatenate([k_sorted[1:] != k_sorted[:-1],
                            jnp.ones(1, bool)])
    nxt = jnp.where(last, i_idx + 1, n)
    hi = jax.lax.cummin(nxt[::-1])[::-1]
    return lo, hi


def join_hits(
    kx: jnp.ndarray, px: jnp.ndarray, nx_valid: jnp.ndarray,
    ky: jnp.ndarray, py: jnp.ndarray, ny_valid: jnp.ndarray,
    k: int,
    max_occ: int,
    capacity: int,
    self_mode: Optional[str] = None,
    y_len: int = 0,
    occ_idx: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    shard: Optional[Tuple[jnp.ndarray, int]] = None,
    same_index: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Join sorted indices -> (hpx, hpy, hvalid, total) with static capacity.

    self_mode "f": keep px < py (canonical half of a self-comparison; kx
    may be a window of the same genome Y was built from).
    self_mode "r": keep px <= y_len - py - k (X vs revcomp(X), matching
    oracle.pipeline.find_hits).
    occ_idx (k_full, n_full_valid): count X-side occurrences against this
    full index instead of kx (required when kx is a window).
    shard (shard_id, n_shards): keep only k-mers whose top bits equal
    shard_id — n_shards must be a power of two dividing 4**k.
    same_index (STATIC): kx/px ARE ky/py (self-comparison forward with the
    whole-genome index on both sides). Run bounds then come from O(n)
    boundary scans instead of searchsorted (whose "sort" method re-sorts
    queries+targets — the dominant join cost at genome scale), and the
    canonical-half bound is simply xi+1 (each entry sits inside its own
    pos-sorted run).
    """
    nx = kx.shape[0]
    xi = jnp.arange(nx, dtype=jnp.int32)

    # run of each X k-mer in Y (within the valid prefix), plus the exact
    # canonical-half pair bound, all from ONE sort (ranks_by_sort)
    if same_index:
        lo, hi = _run_bounds(kx)
        lo = jnp.minimum(lo, ny_valid)
        hi = jnp.minimum(hi, ny_valid)
        pair_rank = None
    else:
        kqs, pqs = [kx, kx], [jnp.full(nx, -1, jnp.int32),
                              jnp.full(nx, MAXP, jnp.int32)]
        if self_mode == "f":
            kqs.append(kx), pqs.append(px)
        elif self_mode == "r":
            anchor = jnp.int32(y_len) - px - jnp.int32(k)  # keep py <= anchor
            kqs.append(kx), pqs.append(anchor)
        ranks = ranks_by_sort(ky, py, ny_valid, kqs, pqs)
        lo, hi = ranks[0], ranks[1]
        pair_rank = ranks[2] if len(ranks) > 2 else None
    occ_y = hi - lo

    # occurrence count of each X k-mer in X itself
    if same_index:
        occ_x = occ_y                 # X and Y are the same index
    elif occ_idx is not None:
        ko, no_valid = occ_idx
        xr = ranks_by_sort(ko, jnp.zeros_like(ko, jnp.int32), no_valid,
                           [kx, kx], [jnp.full(nx, -1, jnp.int32),
                                      jnp.full(nx, MAXP, jnp.int32)])
        occ_x = xr[1] - xr[0]
    else:
        # occurrences of kx in kx itself: boundary scans, never a search
        xlo, xhi = _run_bounds(kx)
        occ_x = jnp.minimum(xhi, nx_valid) - jnp.minimum(xlo, nx_valid)

    x_is_valid = xi < nx_valid
    keep = x_is_valid & (occ_x <= max_occ) & (occ_y <= max_occ)

    if shard is not None:
        shard_id, n_shards = shard
        shift = 2 * k - (int(n_shards) - 1).bit_length()
        assert n_shards & (n_shards - 1) == 0, "n_shards must be a power of two"
        if shift <= 0:
            owner = kx.astype(jnp.uint32) % jnp.uint32(n_shards)
        else:
            owner = (kx >> jnp.uint32(shift)).astype(jnp.uint32)
        keep = keep & (owner == jnp.uint32(shard_id))

    # exact canonical-half bounds via the (kmer, pos) pair ranks
    if self_mode == "f" and same_index:
        lo = jnp.maximum(lo, xi + 1)  # entry xi is inside its own run
    elif self_mode == "f":
        lo = jnp.maximum(lo, pair_rank)
    elif self_mode == "r":
        hi = jnp.maximum(jnp.minimum(hi, pair_rank), lo)
    counts = jnp.where(keep, jnp.maximum(hi - lo, 0), 0)

    csum = jnp.cumsum(counts)                      # inclusive
    total = csum[-1] if nx > 0 else jnp.int32(0)
    offs = csum - counts                           # exclusive

    # owner recovery via sort-compaction + capacity-sized scatter + cummax
    # (owner_rows docstring); rows carry this hit's source (offs, px, lo)
    t = jnp.arange(capacity, dtype=jnp.int32)
    rows = owner_rows(counts, offs, capacity, (px, lo))
    hvalid = t < total
    hpx = rows[:, 1]
    y_idx = rows[:, 2] + (t - rows[:, 0])
    hpy = py[jnp.clip(y_idx, 0, ky.shape[0] - 1)]

    hpx = jnp.where(hvalid, hpx, 0)
    hpy = jnp.where(hvalid, hpy, 0)
    return hpx, hpy, hvalid, total
