"""Canonical k-mer index: ONE index serving both strands of a
self-comparison (SURVEY.md §1 L1/L2; replaces the separate
revcomp-index build + sorted-rank join for the reverse strand).

Each position's k-mer is stored under its canonical form
``min(km, revcomp(km))`` with a strand flag. Key observations that turn
both strand joins into pure O(n) scans over one sorted array:

- forward pair (p, q):  km_p == km_q           <=> same canon, same flag
  (palindromic k-mers, km == rc(km), match regardless of flag — and in
  a palindromic canon's run EVERY entry has flag 0, so "same flag"
  degenerates to "whole run" there automatically);
- reverse pair (p, q):  km_p == rc(km_q)       <=> same canon, flags
  differ (palindromic run: whole run);
- the oracle's reverse canonical half  px <= y_len - py - k  (with py
  in revcomp space, py = L - k - q) is simply  p <= q  — an ORIGINAL
  COORDINATE comparison, so with runs sub-sorted by (flag, pos) every
  entry's partner set is one contiguous interval whose start is a
  segmented prefix count, not a search.

Layout: ONE ``lax.sort`` by (canon, pos) — view A, strands interleaved
in position order. Everything the self-join needs per entry lives in A
order: the run span, the flag-0/flag-1 boundary (view-B "slot" space),
the rank among same-flag entries (``own rank``) and among opposite-flag
entries (``alt_before``) — all from O(n) segmented cumsums. Partner
ENUMERATION wants the flag-major view-B order, but only the partner
POSITIONS are ever gathered there, so view B is materialised as one
scattered ``pos_b`` array (each entry's B slot is its subrun start plus
its own rank) instead of a second full 3-operand sort or a pos+payload
double scatter.

Cost: one n-entry `lax.sort` + O(n) scans + one n-entry scatter.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .build import extract_kmers, SENTINEL
from ..seeds.join import _run_bounds


def revcomp_kmer(km: jnp.ndarray, k: int) -> jnp.ndarray:
    """Reverse-complement of big-endian 2-bit-packed k-mers (uint32)."""
    x = (~km).astype(jnp.uint32)                     # complement each base
    # reverse 2-bit groups across the full 32 bits
    m2, m4 = jnp.uint32(0x33333333), jnp.uint32(0x0F0F0F0F)
    m8 = jnp.uint32(0x00FF00FF)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    x = (x << 16) | (x >> 16)
    return x >> jnp.uint32(32 - 2 * k)               # realign to low bits


class CanonIndex(NamedTuple):
    pos: jnp.ndarray         # int32[n]  position, (canon, pos) A order
    pos_b: jnp.ndarray       # int32[n]  position, flag-major B order
                             #           (partner gathers only)
    flag: jnp.ndarray        # int32[n]  0: km == canon, 1: km == rc(canon)
    run_lo: jnp.ndarray      # int32[n]  B-slot run start of my canon
    run_mid: jnp.ndarray     # int32[n]  B-slot flag-0/flag-1 boundary
    run_hi: jnp.ndarray      # int32[n]  B-slot run end (exclusive)
    own_rank: jnp.ndarray    # int32[n]  # same-flag entries of my run
                             #           with pos < mine
    alt_before: jnp.ndarray  # int32[n]  # opposite-flag entries with
                             #           pos < mine
    palin: jnp.ndarray       # bool[n]   canon == rc(canon)
    n_valid: jnp.ndarray     # int32     valid prefix length (A order)


def canon_posfp(codes: jnp.ndarray, k: int):
    """Per-position (canon, posfp) pair stream + validity.

    posfp packs (pos << 2) | (flag << 1) | palin — flag/palin ride the
    position key's low bits so the canonical sort stays at 2 operands
    (requires pos < 2^29: per-sequence genomes < 536 Mbp, which int32
    coordinates bound anyway). Invalid positions carry canon = SENTINEL;
    a VALID canon is min(km, rc(km)) and can never be SENTINEL
    (rc(SENTINEL) == 0), so no separate invalid key is needed."""
    km, pos, valid = extract_kmers(codes, k)
    rc = revcomp_kmer(km, k)
    canon = jnp.minimum(km, rc)
    flag = (km != canon).astype(jnp.int32)
    palin = (km == rc).astype(jnp.int32)
    canon = jnp.where(valid, canon, SENTINEL)
    posfp = (pos << 2) | (flag << 1) | palin
    return canon, posfp, valid


def canon_scans(cA: jnp.ndarray, pfA: jnp.ndarray, n_valid,
                scan_broadcast: bool = True) -> CanonIndex:
    """CanonIndex from an ALREADY (canon, posfp)-sorted entry array.

    Everything here is run-local (O(n) scans + one more local sort for
    pos_b), so it applies unchanged to a hash-sharded slice of the
    canonical entry space: ownership is a pure function of canon, every
    run lives wholly in one shard, and the returned B-slot indices are
    local to the array passed in (dist/sharded.py's canonical self
    path)."""
    pA = pfA >> 2
    fA = (pfA >> 1) & 1
    plA = pfA & 1
    n = cA.shape[0]
    n_valid = jnp.asarray(n_valid, jnp.int32)
    loA, hiA = _run_bounds(cA)
    idx = jnp.arange(n, dtype=jnp.int32)

    # segmented flag cumsums -> per-entry subrun ranks and the flag-0/1
    # boundary, all in one pass over the A order
    ones_cum = jnp.cumsum(fA)                        # inclusive count of flag-1
    excl = ones_cum - fA                             # exclusive count at me
    if scan_broadcast:
        first = jnp.concatenate([jnp.ones(1, bool), cA[1:] != cA[:-1]])
        last = jnp.concatenate([cA[1:] != cA[:-1], jnp.ones(1, bool)])
        # run-start exclusive count: boundary values are non-decreasing
        # (counts), so a masked cummax broadcasts each run's start value
        run_start_cum = jax.lax.cummax(jnp.where(first, excl, 0))
        # run-end inclusive count: backward masked cummin (ones_cum is
        # non-decreasing, so the min over later `last` rows is MY run's)
        n1_end = jax.lax.cummin(
            jnp.where(last, ones_cum, jnp.int32(2147483647))[::-1])[::-1]
    else:
        run_start_cum = ones_cum[loA] - fA[loA]      # exclusive at run start
        n1_end = ones_cum[jnp.maximum(hiA - 1, 0)]
    n1_before = excl - run_start_cum                 # flag-1 entries before me
    n0_before = (idx - loA) - n1_before
    own_rank = jnp.where(fA == 1, n1_before, n0_before)
    alt_before = jnp.where(fA == 1, n0_before, n1_before)
    n1_run = (n1_end - run_start_cum).astype(jnp.int32)
    midA = hiA - n1_run                              # B-slot subrun boundary

    # view-B positions: flag-major order within each run = sort by
    # (canon, flag, pos), with flag+pos packed into one int32 key (pos
    # < 2^29 bounds the pipeline already), in place of a slot scatter.
    # The sentinel
    # tail orders identically to the scatter form: within the invalid
    # run, flag-0 entries in pos order then flag-1 entries in pos order.
    _, pfB = jax.lax.sort((cA, (fA << 30) | pA), num_keys=2)
    pos_b = pfB & ((1 << 30) - 1)

    lo = jnp.minimum(loA, n_valid)
    hi = jnp.minimum(hiA, n_valid)
    mid = jnp.clip(midA, lo, hi)

    return CanonIndex(pos=pA, pos_b=pos_b, flag=fA, run_lo=lo,
                      run_mid=mid, run_hi=hi, own_rank=own_rank,
                      alt_before=alt_before, palin=plA == 1,
                      n_valid=n_valid)


def build_canonical_index(codes: jnp.ndarray, k: int,
                          scan_broadcast: bool = True) -> CanonIndex:
    """Canonical self-comparison index (see module docstring).

    scan_broadcast=True (default) replaces the n-sized run-boundary
    gathers (``ones_cum[loA]``, ``fA[loA]``, ``ones_cum[hiA-1]``) with
    masked cummax / reverse-cummin segment broadcasts — bit-identical
    (tests/unit/test_canonical.py); scans stream where gathers read at
    random. The gather form stays for reference."""
    canon, posfp, valid = canon_posfp(codes, k)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    cA, pfA = jax.lax.sort((canon, posfp), num_keys=2)
    return canon_scans(cA, pfA, n_valid, scan_broadcast=scan_broadcast)
