"""Sharded multi-device comparison pipeline (SURVEY.md §3.4, §7 M4/M5).

Structure (one jitted program over a (data, shard) mesh):

  stage A  shard_map join — the only irregular stage. Device (d, s)
           extracts the k-mers of query window d (a static-size slice of
           the padded X codes), joins them against the k-mers of Y that
           hash-prefix shard s owns, and emits a static-capacity hit
           block. Window ownership partitions hits by px; prefix
           ownership partitions them by k-mer; so the union of all
           (d, s) blocks IS the single-device hit set, each hit exactly
           once — equality with the oracle is by construction, not by
           reconciliation (SURVEY.md §7 "Hard parts" #1).
  stage B  per-device thin + extend. Device (d, s) all-gathers
           its data row's hit blocks along the SHARD axis (one tiled
           collective, hit_capacity/n_data values), so it holds window
           d's COMPLETE hit set; it then thins and extends window-locally
           — NO global capacity-sized ops. This is exact, not
           approximate: windows are rounded to lcm(min_hit_dist,
           gate_stride), so thinning buckets (diag, px//min_hit_dist)
           and gate buckets (diag, px//gate_stride) never span a window
           boundary, and per-window thinning/gating equals global
           thinning/gating — the same alignment proof the streamed
           driver rests on (dist/windows.py). A GLOBAL thinning sort +
           globally-rebalanced extension would let XLA's SPMD
           partitioner rematerialise sorts and arbitrary-index gathers
           by all-gathering the full arrays, so per-device work would
           GROW with total size. Per-window stage B
           keeps per-device work constant under weak scaling. The
           shard-axis devices of one data row recompute the same
           thin+extend (extension scales on the DATA axis; the shard
           axis scales index MEMORY); meshes should maximise n_data.
  stage C  global merge/accept/canonical sort over the concatenated
           per-window fragment blocks (the one remaining global
           stage). XLA inserts the collectives (NCCL on GPUs); no
           hand-written collectives (SURVEY.md §2.3).

The final fragment table is bit-identical to oracle.pipeline.compare and
device.compare for every mesh shape — asserted by tests/dist/.

Memory note: the k-mer indexes are PHYSICALLY SHARDED by hash prefix
(index/shards.py): device (d, s) stores only shard s's (kmer, pos) rows
— steady-state per-device index memory drops n_shard-fold — and joins
window d's k-mers against its local rows directly (an unowned k-mer
searches to an empty run, so no ownership filter is needed). On meshes
with more than one device the BUILD is distributed too
(index/shards.py build_sharded_index_dist — per-chunk extraction +
all-to-all shuffle, SURVEY.md §3.4), so peak per-device build memory is
O(n / n_shard), not the O(n) replicated transient of the global-sort
build. The genome codes stay replicated: extension window gathers read
arbitrary y positions, and 2-bit-packed codes are ~32 MB even at
human-chr1 scale.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Config
from ..index.build import build_index
from ..index.canonical import build_canonical_index
from ..index.shards import (build_canonical_dist, build_sharded_index,
                            build_sharded_index_dist, shard_capacity)
from ..seeds.join import join_hits
from ..seeds.filter import filter_hits
from ..chain.diagonal import extend_gated
from ..chain.merge import merge_accept
from ..device import revcomp_device
from ..oracle import pipeline as orc
from .mesh import DATA_AXIS, SHARD_AXIS, make_mesh

NCODE = jnp.uint8(4)


def _window_join(cx_pad, idxY_sh, idxX_occ_sh, win: int, cap_dev: int,
                 cfg: Config, self_mode: Optional[str], y_len: int):
    """Per-device body of stage A. cx_pad is replicated; idxY_sh /
    idxX_occ_sh arrive as this device's LOCAL index shard (leading axis 1
    after shard_map splits P(SHARD_AXIS)). A window k-mer this shard does
    not own searches to an empty run in the local rows, so per-shard hit
    sets partition the global set with no ownership filter."""
    d = jax.lax.axis_index(DATA_AXIS)
    w0 = (d * jnp.int32(win)).astype(jnp.int32)
    sl = jax.lax.dynamic_slice(cx_pad, (w0,), (win + cfg.k - 1,))
    km, pos, nv = build_index(sl, cfg.k)
    pos = pos + w0                               # window-local -> global
    kyS, pyS, cntY = idxY_sh
    kxoS, cntXo = idxX_occ_sh
    hpx, hpy, hv, total = join_hits(
        km, pos, nv, kyS[0], pyS[0], cntY[0],
        k=cfg.k, max_occ=cfg.max_occ, capacity=cap_dev,
        self_mode=self_mode, y_len=y_len,
        occ_idx=(kxoS[0], cntXo[0]),
    )
    return hpx, hpy, hv, total.reshape(1)


def _build_idx(codes, cfg: Config, mesh: Mesh, n_shard: int, cap_shard: int):
    """Physically sharded index build; the distributed all-to-all-shuffle
    build on multi-device meshes (O(n / n_shard) per-device transient),
    the global-sort build on one device (nothing to distribute). Returns
    ((kS, pS, cnt), blk_over-or-None)."""
    if mesh.devices.size > 1:
        kS, pS, cnt, blk_over = build_sharded_index_dist(
            codes, cfg.k, n_shard, cap_shard, mesh, DATA_AXIS, SHARD_AXIS,
            cfg.shard_slack)
        return (kS, pS, cnt), blk_over
    return build_sharded_index(codes, cfg.k, n_shard, cap_shard,
                               mesh, SHARD_AXIS), None


def _pack_by_window(px, py, hv, n_data: int, win: int, cap_b: int):
    """Partition one device's hit block by destination window
    (dest = px // win) into static (n_data, cap_b) send blocks, dense per
    block. Returns (pxB, pyB, okB int8, max_count) — the caller raises a
    shard_slack overflow when max_count > cap_b (truncation is detected,
    never silent). One 1-key 3-operand sort + a tiny boundary bisect +
    one (n_data, cap_b) gather."""
    cap = px.shape[0]
    dest = jnp.where(hv, px // jnp.int32(win), jnp.int32(n_data))
    d_s, px_s, py_s = jax.lax.sort(
        (dest, px.astype(jnp.int32), py.astype(jnp.int32)), num_keys=1)
    b = jnp.searchsorted(d_s, jnp.arange(n_data + 1, dtype=jnp.int32),
                         side="left").astype(jnp.int32)
    cnt = b[1:] - b[:-1]
    rows = b[:-1, None] + jnp.arange(cap_b, dtype=jnp.int32)[None, :]
    ok = rows < b[1:, None]
    idx = jnp.minimum(rows, cap - 1)
    pxB = jnp.where(ok, px_s[idx], 0)
    pyB = jnp.where(ok, py_s[idx], 0)
    return pxB, pyB, ok.astype(jnp.int8), jnp.max(cnt)


def _canon_self_body(ci_fields, cx, cy_r, cfg: Config, win: int,
                     cap_dev: int, cap_b: int, blk_e: int,
                     win_seed_cap: int, n_data: int, n_shard: int):
    """Per-device body of the canonical sharded SELF path: ONE canonical
    index serves both strands, as in the single-device pipeline).
    Device i of n_dev
    enumerates hit expansions for entry slice [i*blk_e, (i+1)*blk_e)
    (hits partition by source entry), regroups its hits by destination
    px-window with one all_to_all along the data axis, all_gathers the
    window's blocks along the shard axis, then thins/gates/extends
    window-locally (exact: window alignment argument in the module
    docstring)."""
    from ..index.canonical import CanonIndex
    from ..seeds.self_join import join_self_canonical
    ci = CanonIndex(*ci_fields)
    d = jax.lax.axis_index(DATA_AXIS)
    s = jax.lax.axis_index(SHARD_AXIS)
    i = d * jnp.int32(n_shard) + s
    hits_f, hits_r = join_self_canonical(
        ci, cfg.k, cfg.max_occ, cap_dev, y_len=cx.shape[0],
        entry_slice=(i * jnp.int32(blk_e), blk_e))
    return _regroup_thin_extend(hits_f, hits_r, cx, cy_r, cfg, win, cap_b,
                                win_seed_cap, n_data, n_shard)


def _canon_self_body_dist(ci_fields, cx, cy_r, cfg: Config, win: int,
                          cap_dev: int, cap_b: int, blk_e: int,
                          win_seed_cap: int, n_data: int, n_shard: int):
    """Hash-SHARDED index variant of _canon_self_body (multi-device
    meshes): the canonical index arrives physically sharded by canon
    low bits (index/shards.build_canonical_dist — O(n/n_shard)
    per-device build and storage, no replicated canonical build or
    transient). Device (d, s) expands data-slice d of SHARD s's
    entries; partner gathers read the whole shard's pos_b, which this
    device stores anyway. The entry partition is (shard, slice) — still
    a partition of all entries, so the hit set is unchanged and the
    shared regroup/thin/extend tail applies as-is."""
    from ..index.canonical import CanonIndex
    from ..seeds.self_join import join_self_canonical
    fields = list(ci_fields)
    nv = fields[-1][0]                       # my shard's valid count
    ci = CanonIndex(*([f[0] for f in fields[:-1]] + [nv]))
    d = jax.lax.axis_index(DATA_AXIS)
    hits_f, hits_r = join_self_canonical(
        ci, cfg.k, cfg.max_occ, cap_dev, y_len=cx.shape[0],
        entry_slice=(d * jnp.int32(blk_e), blk_e))
    return _regroup_thin_extend(hits_f, hits_r, cx, cy_r, cfg, win, cap_b,
                                win_seed_cap, n_data, n_shard)


def _regroup_thin_extend(hits_f, hits_r, cx, cy_r, cfg: Config, win: int,
                         cap_b: int, win_seed_cap: int, n_data: int,
                         n_shard: int):
    """Shared tail of both canonical self bodies: regroup this device's
    hits by destination px-window with one all_to_all along the data
    axis, all_gather the window's blocks along the shard axis, then
    thin/gate/extend window-locally (exact: window alignment argument
    in the module docstring). Output is replicated across the shard
    axis by construction (every (d, s) computes from the same gathered
    set)."""
    pairs = [(0, hits_f)] if "f" in cfg.strands else []
    if "r" in cfg.strands:
        pairs.append((1, hits_r))
    out = []
    cnt_max = []
    for strand, (hpx, hpy, hv, total) in pairs:
        pxB, pyB, okB, cmax = _pack_by_window(hpx, hpy, hv, n_data, win,
                                              cap_b)
        cnt_max.append(cmax)
        if n_data > 1:
            pxB = jax.lax.all_to_all(pxB, DATA_AXIS, 0, 0, tiled=True)
            pyB = jax.lax.all_to_all(pyB, DATA_AXIS, 0, 0, tiled=True)
            okB = jax.lax.all_to_all(okB, DATA_AXIS, 0, 0, tiled=True)
        hx, hy, hv2 = (a.reshape(-1) for a in (pxB, pyB, okB))
        if n_shard > 1:
            hx = jax.lax.all_gather(hx, SHARD_AXIS, tiled=True)
            hy = jax.lax.all_gather(hy, SHARD_AXIS, tiled=True)
            hv2 = jax.lax.all_gather(hv2, SHARD_AXIS, tiled=True)
        spx, spy, svalid, n_seeds = filter_hits(
            hx, hy, hv2.astype(bool), cfg.min_hit_dist,
            out_capacity=win_seed_cap)
        cy_cmp = cx if strand == 0 else cy_r
        frag, fvalid = extend_gated(spx, spy, svalid, cx, cy_cmp, cfg)
        frag["strand"] = jnp.where(fvalid, jnp.int32(strand), 0)
        out.append((frag, fvalid, n_seeds.reshape(1)))
    totals = jnp.stack([t for _, (_, _, _, t) in pairs]).reshape(1, -1)
    cnt_max = jnp.stack(cnt_max).reshape(1, -1)
    return tuple(out) + (totals, cnt_max)


def _self_canonical_sharded(cx, cfg: Config, mesh: Mesh, win: int,
                            cap_dev: int, cap_shard: int):
    """Both strands of a sharded self-comparison from ONE canonical
    index; every device expands an equal slice of entries, so the
    expensive expansion/thin/extend work is 1/n_dev / 1/n_data per
    device. On a 1-device mesh the index is built in place (nothing to
    distribute); multi-device meshes build it physically sharded by
    canon low bits via the all_to_all shuffle
    (index/shards.build_canonical_dist) — per-device build work,
    storage, and transient are all O(n/n_shard)."""
    n_data = mesh.shape[DATA_AXIS]
    n_shard = mesh.shape[SHARD_AXIS]
    n_dev = n_data * n_shard
    cy_r = revcomp_device(cx)
    # per-(device, destination-window) send-block capacity: slack over
    # the uniform share, overflow detected (entry slices are canon-
    # ordered, so a repeat neighbourhood can focus one device's hits on
    # few windows)
    cap_b = shard_capacity(cap_dev, n_data, cfg.shard_slack)
    win_seed_cap = cfg.seed_cap // n_data
    dd = P((DATA_AXIS, SHARD_AXIS))
    dp = P(DATA_AXIS)
    sp = P(SHARD_AXIS)
    n_str = ("f" in cfg.strands) + ("r" in cfg.strands)
    out_specs = tuple((dp, dp, dp) for _ in range(n_str)) + (dd, dd)

    if n_dev == 1:
        ci = build_canonical_index(cx, cfg.k)
        n = ci.pos.shape[0]
        blk_e = -(-n // n_dev)
        n_pad = n_dev * blk_e
        if n_pad > n:
            pad = lambda a: jnp.concatenate(        # noqa: E731
                [a, jnp.zeros(n_pad - n, a.dtype)])
            fields = [pad(a) if a.ndim == 1 else a for a in ci]
        else:
            fields = list(ci)
        *strand_outs, totals, cnt_max = jax.shard_map(
            functools.partial(_canon_self_body, cfg=cfg, win=win,
                              cap_dev=cap_dev, cap_b=cap_b, blk_e=blk_e,
                              win_seed_cap=win_seed_cap, n_data=n_data,
                              n_shard=n_shard),
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=out_specs,
            check_vma=False,
        )(tuple(fields), cx, cy_r)
        shard_cnt = jnp.zeros(n_shard, jnp.int32)
        blk_build = None
    else:
        ci2, shard_cnt, blk_build = build_canonical_dist(
            cx, cfg.k, n_shard, cap_shard, mesh, DATA_AXIS, SHARD_AXIS,
            cfg.shard_slack)
        blk_e = cap_shard // n_data
        *strand_outs, totals, cnt_max = jax.shard_map(
            functools.partial(_canon_self_body_dist, cfg=cfg, win=win,
                              cap_dev=cap_dev, cap_b=cap_b, blk_e=blk_e,
                              win_seed_cap=win_seed_cap, n_data=n_data,
                              n_shard=n_shard),
            mesh=mesh,
            in_specs=(tuple(sp for _ in range(10)), P(), P()),
            out_specs=out_specs,
            check_vma=False,
        )(tuple(ci2), cx, cy_r)
    # totals/cnt_max: (n_dev, n_strands) columns in strand order
    return (strand_outs, totals, cnt_max, jnp.int32(cap_b), shard_cnt,
            blk_build)


def _thin_extend_window(hpx_blk, hpy_blk, hv_blk, cx, cy_cmp, cfg: Config,
                        strand: int, win_seed_cap: int):
    """Per-device body of stage B. The hit blocks arrive as this device's
    (cap_dev,) stage-A output; the tiled all_gather along the SHARD axis
    assembles window d's COMPLETE hit set (every k-mer's hits live in
    exactly one shard), after which thinning, gating and extension are
    window-local and exact (window alignment argument in the module
    docstring). Output is replicated across the shard axis by
    construction (every (d, s) computes from the same gathered set)."""
    hx = jax.lax.all_gather(hpx_blk, SHARD_AXIS, tiled=True)
    hy = jax.lax.all_gather(hpy_blk, SHARD_AXIS, tiled=True)
    hv = jax.lax.all_gather(hv_blk, SHARD_AXIS, tiled=True)
    spx, spy, svalid, n_seeds = filter_hits(hx, hy, hv, cfg.min_hit_dist,
                                            out_capacity=win_seed_cap)
    frag, fvalid = extend_gated(spx, spy, svalid, cx, cy_cmp, cfg)
    frag["strand"] = jnp.where(fvalid, jnp.int32(strand), 0)
    return frag, fvalid, n_seeds.reshape(1)


def _one_strand_sharded(cx, cx_pad, idxX_sh, cy_cmp, strand: int,
                        self_cmp: bool, cfg: Config, mesh: Mesh,
                        win: int, cap_dev: int, cap_shard: int):
    """Sharded hits + per-window thin/extend for one strand. idxX_sh is
    the physically sharded X index (build_sharded_index); Y's index is
    built sharded here per strand. Returns the per-shard Y counts so the
    host can detect shard-capacity overflow."""
    n_data = mesh.shape[DATA_AXIS]
    n_shard = mesh.shape[SHARD_AXIS]
    blk_over = None
    if self_cmp and strand == 0:
        idxY_sh, self_mode = idxX_sh, "f"
    else:
        idxY_sh, blk_over = _build_idx(cy_cmp, cfg, mesh, n_shard, cap_shard)
        self_mode = "r" if self_cmp else None

    dd = P((DATA_AXIS, SHARD_AXIS))
    dp = P(DATA_AXIS)
    sp = P(SHARD_AXIS)
    joined = jax.shard_map(
        functools.partial(_window_join, win=win, cap_dev=cap_dev, cfg=cfg,
                          self_mode=self_mode, y_len=cy_cmp.shape[0]),
        mesh=mesh,
        in_specs=(P(), (sp, sp, sp), (sp, sp)),
        out_specs=(dd, dd, dd, dd),
    )(cx_pad, idxY_sh, (idxX_sh[0], idxX_sh[2]))
    hpx, hpy, hvalid, totals = joined

    # stage B: per-device window-local thinning + extension (module
    # docstring). Fragment blocks come back sharded over the data axis
    # (length n_data * win_seed_cap = seed_cap), replicated over shard.
    win_seed_cap = cfg.seed_cap // n_data
    frag, fvalid, n_seeds = jax.shard_map(
        functools.partial(_thin_extend_window, cfg=cfg, strand=strand,
                          win_seed_cap=win_seed_cap),
        mesh=mesh,
        in_specs=(dd, dd, dd, P(), P()),
        out_specs=(dp, dp, dp),
        check_vma=False,
    )(hpx, hpy, hvalid, cx, cy_cmp)
    return frag, fvalid, totals, n_seeds, idxY_sh[2], blk_over


@functools.partial(jax.jit, static_argnames=("cfg", "self_cmp", "mesh", "win",
                                             "cap_dev", "cap_shard"))
def _compare_sharded_jit(cx, cx_pad, cy, cfg: Config, self_cmp: bool,
                         mesh: Mesh, win: int, cap_dev: int, cap_shard: int):
    cy_f = cx if self_cmp else cy
    n_shard = mesh.shape[SHARD_AXIS]

    frags, valids, totals, nseeds = [], [], [], []
    shard_cnts = []
    blk_overs = []
    if self_cmp:
        # canonical self path: ONE index, both strands, per-device entry
        # slices
        strand_outs, tot, cnt_max, cap_b, shard_cnt, blk_build = \
            _self_canonical_sharded(cx, cfg, mesh, win, cap_dev, cap_shard)
        for j, (fr, va, ns) in enumerate(strand_outs):
            frags.append(fr), valids.append(va), nseeds.append(ns)
            totals.append(tot[:, j])
        blk_overs.append(jnp.stack([jnp.max(cnt_max), cap_b]))
        if blk_build is not None:
            blk_overs.append(blk_build)
        shard_cnts.append(shard_cnt)
    else:
        idxX_sh, blkX = _build_idx(cx, cfg, mesh, n_shard, cap_shard)
        shard_cnts.append(idxX_sh[2])
        if blkX is not None:
            blk_overs.append(blkX)
        if "f" in cfg.strands:
            fr, va, th, ns, sc, bo = _one_strand_sharded(
                cx, cx_pad, idxX_sh, cy_f, 0, self_cmp, cfg, mesh, win,
                cap_dev, cap_shard)
            frags.append(fr), valids.append(va), totals.append(th)
            nseeds.append(ns), shard_cnts.append(sc)
            if bo is not None:
                blk_overs.append(bo)
        if "r" in cfg.strands:
            cy_r = revcomp_device(cy_f)
            fr, va, th, ns, sc, bo = _one_strand_sharded(
                cx, cx_pad, idxX_sh, cy_r, 1, self_cmp, cfg, mesh, win,
                cap_dev, cap_shard)
            frags.append(fr), valids.append(va), totals.append(th)
            nseeds.append(ns), shard_cnts.append(sc)
            if bo is not None:
                blk_overs.append(bo)

    frag = {k: jnp.concatenate([f[k] for f in frags]) for k in frags[0]}
    valid = jnp.concatenate(valids)
    out, valid_out, n_frags = merge_accept(
        frag, valid, cfg.min_len, cfg.min_identity, y_len=cy_f.shape[0]
    )
    # Replicate the final table + totals across the whole mesh: this is
    # SURVEY.md §3.4's "all_gather fragment tables" step. XLA rides the
    # interconnect for the gather; afterwards every process holds the full result, so
    # host-side reads (np.asarray) are legal under multi-process too.
    rep = NamedSharding(mesh, P())
    out = {k: jax.lax.with_sharding_constraint(v, rep) for k, v in out.items()}
    n_frags = jax.lax.with_sharding_constraint(n_frags, rep)
    totals = jax.lax.with_sharding_constraint(jnp.stack(totals), rep)
    nseeds = jax.lax.with_sharding_constraint(jnp.stack(nseeds), rep)
    shard_cnts = jax.lax.with_sharding_constraint(jnp.stack(shard_cnts), rep)
    # [max block count seen, cap_blk] over the distributed builds' shuffle
    # blocks (empty on 1-device meshes where the global-sort build runs)
    blk_over = (jnp.stack(blk_overs) if blk_overs
                else jnp.zeros((1, 2), jnp.int32))
    blk_over = jax.lax.with_sharding_constraint(blk_over, rep)
    return out, n_frags, totals, nseeds, shard_cnts, blk_over


def compare_sharded(
    codesX: np.ndarray, codesY: Optional[np.ndarray], cfg: Config,
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Multi-device equivalent of device.compare — same output, any mesh.

    Raises on per-device hit-capacity overflow (the true per-(window,
    shard) hit counts are returned by stage A, never truncated silently).
    """
    if mesh is None:
        mesh = make_mesh()
    n_data = mesh.shape[DATA_AXIS]
    n_shard = mesh.shape[SHARD_AXIS]
    n_dev = n_data * n_shard
    if cfg.hit_capacity % n_dev:
        raise ValueError(f"hit_capacity {cfg.hit_capacity} must be divisible "
                         f"by the {n_dev}-device mesh")
    if cfg.seed_cap % n_dev:
        raise ValueError(f"seed_capacity {cfg.seed_cap} must be divisible "
                         f"by the {n_dev}-device mesh")
    cap_dev = cfg.hit_capacity // n_dev

    self_cmp = codesY is None
    cx = np.asarray(codesX, np.uint8)
    cy = cx if self_cmp else np.asarray(codesY, np.uint8)
    if cx.shape[0] < cfg.k or cy.shape[0] < cfg.k:
        frag = {f: np.zeros(0, np.int32) for f in orc.FRAG_FIELDS}
        frag["group"] = np.zeros(0, np.int32)
        return frag

    n_pos = cx.shape[0] - cfg.k + 1
    win = -(-n_pos // n_data)                   # ceil
    # round the window UP to the thinning/gating bucket quantum so no
    # bucket spans a window boundary — the exactness condition for the
    # per-window stage B (module docstring; dist/windows.py proof)
    quantum = int(np.lcm(cfg.min_hit_dist, max(cfg.gate_stride, 1)))
    win = -(-win // quantum) * quantum
    pad_to = n_data * win + cfg.k - 1
    cx_pad = np.full(pad_to, 4, np.uint8)       # N padding -> invalid k-mers
    cx_pad[: cx.shape[0]] = cx
    n_pos_max = max(cx.shape[0], cy.shape[0]) - cfg.k + 1
    cap_shard = shard_capacity(n_pos_max, n_shard, cfg.shard_slack)
    # the canonical self path slices each shard's rows across the data
    # axis (blk_e = cap_shard / n_data) — align so the slices tile
    cap_shard = -(-cap_shard // n_data) * n_data

    def _global(arr):
        # Single-process: a plain device array. Multi-process: every host
        # holds the same full input (they all read the same FASTA), so a
        # fully-replicated global array over the mesh is built from local
        # data with no communication.
        if jax.process_count() == 1:
            return jnp.asarray(arr)
        sh = NamedSharding(mesh, P())
        return jax.make_array_from_callback(arr.shape, sh,
                                            lambda idx: arr[idx])

    out, n_frags, totals, nseeds, shard_cnts, blk_over = _compare_sharded_jit(
        _global(cx), _global(cx_pad),
        _global(cx) if self_cmp else _global(cy),
        cfg, self_cmp, mesh, int(win), int(cap_dev), int(cap_shard))
    shard_cnts = np.asarray(shard_cnts)
    if (shard_cnts > cap_shard).any():
        raise ValueError(
            f"index shard capacity {cap_shard} overflow (max shard "
            f"{int(shard_cnts.max())} entries — skewed k-mer prefixes); "
            "raise Config.shard_slack")
    # hit-capacity overflow is checked BEFORE block skew: when the
    # expansion itself overflowed, the skewed send blocks are just a
    # consequence and raising hit_capacity is the actionable fix
    totals = np.asarray(totals)
    if (totals > cap_dev).any():
        raise ValueError(
            f"per-device hit capacity {cap_dev} overflow (max block "
            f"{int(totals.max())}); raise Config.hit_capacity")
    blk_over = np.asarray(blk_over)
    if (blk_over[:, 0] > blk_over[:, 1]).any():
        raise ValueError(
            f"shuffle block overflow (max block "
            f"{int(blk_over[:, 0].max())} entries > cap "
            f"{int(blk_over[:, 1].max())} — chunk-local k-mer prefix or "
            "window-destination skew); raise Config.shard_slack")
    nseeds = np.asarray(nseeds)              # (n_strands, n_data): per window
    win_seed_cap = cfg.seed_cap // n_data
    if (nseeds > win_seed_cap).any():
        raise ValueError(
            f"per-window seed capacity {win_seed_cap} (= seed_capacity "
            f"{cfg.seed_cap} / {n_data} windows) overflow: max window "
            f"seed count {int(nseeds.max())}; raise Config.seed_capacity")
    n = int(n_frags)
    if n > 0 and n == out["xStart"].shape[0]:
        raise ValueError("frag capacity overflow; raise "
                         "Config.seed_capacity / Config.hit_capacity")
    frag = {k: np.asarray(v[:n]) for k, v in out.items()}
    from ..families.cluster import cluster_families
    frag["group"] = cluster_families(frag, cfg, self_cmp)
    return frag
