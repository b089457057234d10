"""Single-device end-to-end comparison pipeline (SURVEY.md §3.3, §7 M1).

FASTA codes -> k-mer index -> seed hits -> diagonal filter -> extension ->
merge/accept -> canonical fragments, all on-device as one jitted program of
bulk array passes; repeat-family clustering (repkiller proper, tiny data)
runs on host afterwards. Output is bit-identical to oracle.pipeline.compare
— asserted by tests/unit/test_device.py on every stage combination.

Static-shape contract: arrays are sized by Config capacities with validity
masks; true counts are returned so overflow raises instead of truncating.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config
from .index.build import build_index
from .index.canonical import build_canonical_index
from .seeds.join import join_hits
from .seeds.self_join import join_self_canonical
from .seeds.filter import filter_hits
from .chain.diagonal import extend_gated
from .chain.merge import merge_accept
from .oracle import pipeline as orc


def revcomp_device(codes: jnp.ndarray) -> jnp.ndarray:
    """Reverse complement on device; N (code 4) stays N. Matches
    io.codec.revcomp_codes."""
    comp = jnp.where(codes < 4, 3 - codes, codes).astype(codes.dtype)
    return comp[::-1]


def _one_strand(cx, idxX, cy_cmp, strand: int, cfg: Config):
    """Pairwise hits + extension for one strand (two-genome path);
    returns frag dict + valid + totals."""
    kx, pxi, nxv = idxX
    idxY = build_index(cy_cmp, cfg.k)
    ky, pyi, nyv = idxY

    hpx, hpy, hvalid, total_hits = join_hits(
        kx, pxi, nxv, ky, pyi, nyv,
        k=cfg.k, max_occ=cfg.max_occ, capacity=cfg.hit_capacity,
        self_mode=None, y_len=cy_cmp.shape[0],
    )
    spx, spy, svalid, n_seeds = filter_hits(hpx, hpy, hvalid, cfg.min_hit_dist,
                                            out_capacity=cfg.seed_cap)

    frag, fvalid = extend_gated(spx, spy, svalid, cx, cy_cmp, cfg)
    frag["strand"] = jnp.where(fvalid, jnp.int32(strand), 0)
    return frag, fvalid, total_hits, n_seeds


def self_seeds_fn(cx, cfg: Config):
    """Self-comparison seeds for every requested strand from ONE
    canonical index (index/canonical.py + seeds/self_join.py): hit sets
    for f and r come from O(n) run scans over a single sorted array —
    no revcomp index build, no sorted-rank join. Returns
    {strand: (spx, spy, svalid, n_seeds, total_hits)} after thinning."""
    ci = build_canonical_index(cx, cfg.k)
    hits_f, hits_r = join_self_canonical(ci, cfg.k, cfg.max_occ,
                                         cfg.hit_capacity,
                                         y_len=cx.shape[0])
    out = {}
    if "f" in cfg.strands:
        out[0] = filter_hits(*hits_f[:3], cfg.min_hit_dist,
                             out_capacity=cfg.seed_cap) + (hits_f[3],)
    if "r" in cfg.strands:
        out[1] = filter_hits(*hits_r[:3], cfg.min_hit_dist,
                             out_capacity=cfg.seed_cap) + (hits_r[3],)
    return out


def compare_fn(cx: jnp.ndarray, cy: jnp.ndarray, cfg: Config, self_cmp: bool):
    """Unjitted single-device pipeline; cy is ignored (aliased to cx) when
    self_cmp. Exposed for __graft_entry__ (driver compile-check) — use
    :func:`compare` or `_compare_jit` everywhere else."""
    cy_f = cx if self_cmp else cy

    frags, valids, totals, nseeds = [], [], [], []
    if self_cmp:
        seeds = self_seeds_fn(cx, cfg)
        for strand, (spx, spy, sv, n_seeds, total) in seeds.items():
            cy_cmp = cx if strand == 0 else revcomp_device(cx)
            frag, fv = extend_gated(spx, spy, sv, cx, cy_cmp, cfg)
            frag["strand"] = jnp.where(fv, jnp.int32(strand), 0)
            frags.append(frag), valids.append(fv), totals.append(total)
            nseeds.append(n_seeds)
    else:
        idxX = build_index(cx, cfg.k)
        if "f" in cfg.strands:
            fr, va, th, ns = _one_strand(cx, idxX, cy_f, 0, cfg)
            frags.append(fr), valids.append(va), totals.append(th)
            nseeds.append(ns)
        if "r" in cfg.strands:
            cy_r = revcomp_device(cy_f)
            fr, va, th, ns = _one_strand(cx, idxX, cy_r, 1, cfg)
            frags.append(fr), valids.append(va), totals.append(th)
            nseeds.append(ns)

    frag = {k: jnp.concatenate([f[k] for f in frags]) for k in frags[0]}
    valid = jnp.concatenate(valids)
    out, valid_out, n_frags = merge_accept(
        frag, valid, cfg.min_len, cfg.min_identity, y_len=cy_f.shape[0]
    )
    total_hits = jnp.stack(totals)
    return out, n_frags, total_hits, jnp.stack(nseeds)


_compare_jit = functools.partial(jax.jit, static_argnames=("cfg", "self_cmp"))(
    compare_fn)


# ---- staged execution: same stages, one jit per stage ----------------------
# Bit-identical to _compare_jit (same stage functions), but each stage is
# its own program with a device sync between: stage programs compile
# faster than the fused whole-pipeline program, failures are attributable
# to a stage, and the per-stage walls are the SURVEY.md §5 metrics
# record.

_stage_index = functools.partial(jax.jit, static_argnames=("k",))(build_index)
_stage_revcomp = jax.jit(revcomp_device)
_stage_self_seeds = functools.partial(jax.jit, static_argnames=("cfg",))(
    self_seeds_fn)


@functools.partial(jax.jit, static_argnames=("cfg", "self_mode",
                                              "same_index"))
def _stage_join(idxX, idxY, y_len, cfg: Config, self_mode,
                same_index=False):
    # kx here is always the FULL X index (never a window), so X-side
    # occurrence counts come from join_hits' run-bounds scans (occ_idx
    # None) — no search against a separate occurrence index needed.
    kx, pxi, nxv = idxX
    ky, pyi, nyv = idxY
    return join_hits(kx, pxi, nxv, ky, pyi, nyv,
                     k=cfg.k, max_occ=cfg.max_occ, capacity=cfg.hit_capacity,
                     self_mode=self_mode, y_len=y_len,
                     same_index=same_index)


@functools.partial(jax.jit, static_argnames=("min_hit_dist", "out_capacity"))
def _stage_filter(hpx, hpy, hvalid, min_hit_dist: int, out_capacity=None):
    return filter_hits(hpx, hpy, hvalid, min_hit_dist,
                       out_capacity=out_capacity)


@functools.partial(jax.jit, static_argnames=("cfg", "strand", "rev_y"))
def _stage_extend(spx, spy, svalid, n_seeds, cx, cy, cfg: Config, strand: int,
                  rev_y: bool = False):
    # rev_y folds the (cheap) revcomp into the extension program
    if rev_y:
        cy = revcomp_device(cy)
    frag, fvalid = extend_gated(spx, spy, svalid, cx, cy, cfg)
    frag["strand"] = jnp.where(fvalid, jnp.int32(strand), 0)
    return frag, fvalid


@functools.partial(jax.jit, static_argnames=("cfg", "y_len"))
def _stage_merge(frag, valid, cfg: Config, y_len: int):
    return merge_accept(frag, valid, cfg.min_len, cfg.min_identity,
                        y_len=y_len)


def compare_staged(cx: jnp.ndarray, cy: jnp.ndarray, cfg: Config,
                   self_cmp: bool, timings: dict = None, store=None):
    """Stage-by-stage equivalent of _compare_jit; returns the same
    (out, n_frags, total_hits, n_seeds) tuple. `timings` (optional dict)
    collects per-stage wall seconds. `store` (optional
    utils.checkpoint.StageStore) dumps each logical stage's arrays and
    reloads them on a rerun with the same fingerprint — the SURVEY.md §5
    "resume from any stage" contract (--keep-intermediates)."""
    import time as _time

    def timed(name, fn, *a, **kw):
        t0 = _time.perf_counter()
        out = fn(*a, **kw)
        jax.block_until_ready(out)
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + _time.perf_counter() - t0
        return out

    def _seed_tuple_save(strand, t5):
        spx, spy, sv, n_seeds, total = t5
        store.save(f"seeds{strand}", {"spx": spx, "spy": spy, "sv": sv,
                                      "n_seeds": n_seeds, "total": total})

    def _seed_tuple_load(strand):
        z = store.load(f"seeds{strand}") if store is not None else None
        if z is None:
            return None
        return (jnp.asarray(z["spx"]), jnp.asarray(z["spy"]),
                jnp.asarray(z["sv"]), jnp.asarray(z["n_seeds"]),
                jnp.asarray(z["total"]))

    def _extend_load(strand):
        z = store.load(f"extend{strand}") if store is not None else None
        if z is None:
            return None
        fv = jnp.asarray(z.pop("fvalid"))
        return {f: jnp.asarray(v) for f, v in z.items()}, fv

    cy_f = cx if self_cmp else cy
    strands = ([0] if "f" in cfg.strands else []) + \
              ([1] if "r" in cfg.strands else [])

    frags, valids, totals, nseeds = [], [], [], []
    if self_cmp:
        seeds = {s: _seed_tuple_load(s) for s in strands}
        if any(v is None for v in seeds.values()):
            # ONE program: canonical index + both strands' joins + thinning
            seeds = timed("seeds", _stage_self_seeds, cx, cfg)
            if store is not None:
                for s, t5 in seeds.items():
                    _seed_tuple_save(s, t5)
        for strand, (spx, spy, sv, n_seeds, total) in seeds.items():
            hit = _extend_load(strand)
            if hit is None:
                frag, fv = timed("extend", _stage_extend, spx, spy, sv,
                                 n_seeds, cx, cx, cfg, strand,
                                 rev_y=(strand == 1))
                if store is not None:
                    store.save(f"extend{strand}", {**frag, "fvalid": fv})
            else:
                frag, fv = hit
            frags.append(frag), valids.append(fv), totals.append(total)
            nseeds.append(n_seeds)
    else:
        idxX = None
        for strand in strands:
            t5 = _seed_tuple_load(strand)
            ext = _extend_load(strand)
            cy_cmp = None
            if t5 is None or ext is None:
                cy_cmp = cy_f if strand == 0 else timed(
                    "revcomp", _stage_revcomp, cy_f)
            if t5 is None:
                if idxX is None:
                    idxX = timed("index_x", _stage_index, cx, cfg.k)
                idxY = timed("index_y", _stage_index, cy_cmp, cfg.k)
                hpx, hpy, hv, total = timed(
                    "join", _stage_join, idxX, idxY,
                    jnp.int32(cy_cmp.shape[0]), cfg, None)
                spx, spy, sv, n_seeds = timed(
                    "filter", _stage_filter, hpx, hpy, hv, cfg.min_hit_dist,
                    out_capacity=cfg.seed_cap)
                if store is not None:
                    _seed_tuple_save(strand, (spx, spy, sv, n_seeds, total))
            else:
                spx, spy, sv, n_seeds, total = t5
            if ext is None:
                frag, fv = timed("extend", _stage_extend, spx, spy, sv,
                                 n_seeds, cx, cy_cmp, cfg, strand)
                if store is not None:
                    store.save(f"extend{strand}", {**frag, "fvalid": fv})
            else:
                frag, fv = ext
            frags.append(frag), valids.append(fv), totals.append(total)
            nseeds.append(n_seeds)

    allfrag = {k: jnp.concatenate([f[k] for f in frags]) for k in frags[0]}
    allvalid = jnp.concatenate(valids)
    out, valid_out, n_frags = timed(
        "merge", _stage_merge, allfrag, allvalid, cfg,
        int(cy_f.shape[0]))
    return out, n_frags, jnp.stack(totals), jnp.stack(nseeds)


def compare(
    codesX: np.ndarray, codesY: Optional[np.ndarray], cfg: Config,
    staged: bool = True, timings: dict = None,
    keep_intermediates: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Device-pipeline equivalent of oracle.pipeline.compare.

    Returns the canonical fragment dict (original-genome coordinates, numpy,
    compacted to the true count) with the host-computed "group" family
    column. Raises on capacity overflow rather than silently truncating.

    staged=True (default) runs one jitted program per stage —
    bit-identical to the fused program (same stage functions), each
    stage compiled and timed on its own. staged=False keeps the single
    fused jit (the compile-check path of __graft_entry__.py).

    keep_intermediates (a directory; implies staged) dumps every logical
    stage's arrays and lets a rerun with identical inputs resume from the
    last completed stage (SURVEY.md §5 "Checkpoint/resume").
    """
    self_cmp = codesY is None
    cx = jnp.asarray(np.asarray(codesX, np.uint8))
    cy = cx if self_cmp else jnp.asarray(np.asarray(codesY, np.uint8))
    if int(cx.shape[0]) < cfg.k or int(cy.shape[0]) < cfg.k:
        frag = {f: np.zeros(0, np.int32) for f in orc.FRAG_FIELDS}
        frag["group"] = np.zeros(0, np.int32)
        return frag

    store = None
    if keep_intermediates:
        from .utils.checkpoint import StageStore, fingerprint
        store = StageStore(keep_intermediates,
                           fingerprint(codesX, codesY, cfg))
        staged = True
    if staged:
        out, n_frags, total_hits, n_seeds = compare_staged(
            cx, cy, cfg, self_cmp, timings=timings, store=store)
    else:
        out, n_frags, total_hits, n_seeds = _compare_jit(cx, cy, cfg,
                                                         self_cmp)
    total_hits = np.asarray(total_hits)
    if (total_hits > cfg.hit_capacity).any():
        raise ValueError(
            f"hit_capacity={cfg.hit_capacity} overflow: strand hit totals "
            f"{total_hits.tolist()}; raise Config.hit_capacity"
        )
    n_seeds = np.asarray(n_seeds)
    if (n_seeds > cfg.seed_cap).any():
        raise ValueError(
            f"seed_capacity={cfg.seed_cap} overflow: strand seed counts "
            f"{n_seeds.tolist()}; raise Config.seed_capacity"
        )
    n = int(n_frags)
    if n > 0 and n == out["xStart"].shape[0]:
        raise ValueError(
            f"frag capacity overflow ({n} fragments fill the array); "
            "raise Config.seed_capacity / Config.hit_capacity"
        )
    frag = {k: np.asarray(v[:n]) for k, v in out.items()}
    from .families.cluster import cluster_families
    frag["group"] = cluster_families(frag, cfg, self_cmp)
    return frag
