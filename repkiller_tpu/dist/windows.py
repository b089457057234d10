"""Windowed streaming comparison with incremental checkpoint/resume
(SURVEY.md §5 "Failure/elastic recovery", "Checkpoint/resume", and the
long-sequence row: the device analog of the reference's out-of-core
staging is windowed streaming over HBM-resident indexes).

The genome is processed as fixed-size query windows on ONE jitted window
program (compiled once, reused for every window):

  window w owns seed start positions [w*win, (w+1)*win); its k-mers are
  joined against the FULL Y index (built once, resident in HBM), thinned
  per window, and extended against the full sequences — so, exactly as in
  dist/sharded.py, the union over windows of the per-window seed sets IS
  the single-shot seed set, each seed once, and the final merged output
  is bit-identical to device.compare / the oracle (tests/dist/).

  Per-window thinning equals global thinning because thinning buckets are
  (diag, px // min_hit_dist) and `win` is rounded to a multiple of
  min_hit_dist, so no bucket spans a window boundary.

Each finished window's raw fragments are appended to `out_dir` as an .npz
plus a manifest line; a rerun with the same fingerprint (config + genome
content hash) skips completed windows — a killed run resumes where it
stopped. The final merge/accept runs once over all windows' fragments.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..index.build import build_index
from ..seeds.join import join_hits
from ..seeds.filter import filter_hits
from ..chain.diagonal import extend_gated
from ..chain.merge import merge_accept
from ..device import revcomp_device
from ..oracle import pipeline as orc

_SAVE_FIELDS = ("xStart", "yStart", "xEnd", "yEnd", "strand", "length",
                "score", "idents")


def _window_seeds(cx_pad, cy_len, idxY, idxX_occ, w0, cfg: Config,
                  self_mode: Optional[str], win: int):
    """Window k-mers -> joined, thinned seeds (one staged program)."""
    sl = jax.lax.dynamic_slice(cx_pad, (w0,), (win + cfg.k - 1,))
    km, pos, nv = build_index(sl, cfg.k)
    pos = pos + w0
    ky, py, nyv = idxY
    hpx, hpy, hv, total = join_hits(
        km, pos, nv, ky, py, nyv,
        k=cfg.k, max_occ=cfg.max_occ, capacity=cfg.hit_capacity,
        self_mode=self_mode, y_len=cy_len, occ_idx=idxX_occ)
    spx, spy, svalid, n_seeds = filter_hits(hpx, hpy, hv, cfg.min_hit_dist,
                                            out_capacity=cfg.seed_cap)
    return spx, spy, svalid, n_seeds, total


def _window_extend(spx, spy, svalid, n_seeds, cx, cy_cmp, cfg: Config,
                   strand: int):
    """Seed extension for one window (second staged program): split from
    _window_seeds so that each program compiles on its own and a failure
    is attributable to a stage, as device.compare_staged does."""
    frag, fvalid = extend_gated(spx, spy, svalid, cx, cy_cmp, cfg)
    frag["strand"] = jnp.where(fvalid, jnp.int32(strand), 0)
    return frag, fvalid


@functools.partial(jax.jit, static_argnames=("cfg", "y_len"))
def _final_merge(frag, valid, cfg: Config, y_len: int):
    return merge_accept(frag, valid, cfg.min_len, cfg.min_identity,
                        y_len=y_len)


def _fingerprint(cx: np.ndarray, cy: Optional[np.ndarray], cfg: Config,
                 win: int) -> str:
    h = hashlib.sha256()
    h.update(cx.tobytes())
    if cy is not None:
        h.update(cy.tobytes())
    h.update(repr((cfg, win)).encode())
    return h.hexdigest()[:16]


def compare_streamed(
    codesX: np.ndarray, codesY: Optional[np.ndarray], cfg: Config,
    out_dir: Optional[str] = None, window: Optional[int] = None,
    resume: bool = True,
) -> Dict[str, np.ndarray]:
    """Streamed equivalent of device.compare — same output, bounded memory.

    out_dir enables incremental checkpointing: each window's raw fragment
    block is written as soon as it completes, and a rerun with identical
    inputs skips finished windows (manifest.jsonl). Without out_dir the
    stream runs in memory only.
    """
    self_cmp = codesY is None
    cx = np.asarray(codesX, np.uint8)
    cy = cx if self_cmp else np.asarray(codesY, np.uint8)
    if cx.shape[0] < cfg.k or cy.shape[0] < cfg.k:
        frag = {f: np.zeros(0, np.int32) for f in orc.FRAG_FIELDS}
        frag["group"] = np.zeros(0, np.int32)
        return frag

    # windows must align with thinning buckets (min_hit_dist) AND gate
    # buckets (gate_stride) so neither spans a boundary — that alignment
    # is what makes the streamed output bit-identical to the single-shot
    # pipeline for any window size
    quantum = int(np.lcm(cfg.min_hit_dist,
                         max(cfg.gate_stride, 1)))
    win = int(window or cfg.window)
    win = max(quantum, win - win % quantum)
    n_pos = cx.shape[0] - cfg.k + 1
    n_win = -(-n_pos // win)
    pad_to = n_win * win + cfg.k - 1
    cx_pad = np.full(pad_to, 4, np.uint8)
    cx_pad[: cx.shape[0]] = cx

    fp = _fingerprint(cx, None if self_cmp else cy, cfg, win)
    manifest = os.path.join(out_dir, "manifest.jsonl") if out_dir else None
    done = {}
    if manifest and resume and os.path.exists(manifest):
        with open(manifest) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("fp") == fp:
                    done[(rec["window"], rec["strand"])] = rec["file"]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    dcx = jnp.asarray(cx)
    dcx_pad = jnp.asarray(cx_pad)
    strands = []
    if "f" in cfg.strands:
        strands.append(0)
    if "r" in cfg.strands:
        strands.append(1)

    idxX = build_index(dcx, cfg.k)
    idxX_occ = (idxX[0], idxX[2])
    blocks = []       # (frag dict, valid) per completed window
    for strand in strands:
        if strand == 0:
            cy_cmp = dcx if self_cmp else jnp.asarray(cy)
            idxY = idxX if self_cmp else build_index(cy_cmp, cfg.k)
            self_mode = "f" if self_cmp else None
        else:
            cy_cmp = revcomp_device(dcx if self_cmp else jnp.asarray(cy))
            idxY = build_index(cy_cmp, cfg.k)
            self_mode = "r" if self_cmp else None
        # one jit instance per (strand, mode): a shared static-keyed jit is
        # mis-dispatched in jax 0.9 when one strand's call passes duplicate
        # array objects (self f: cy IS cx, idxY IS idxX) — the hoisted-
        # constant executable is then hit by the other strand's 9-buffer
        # call ("supplied 9 buffers but compiled program expected 11")
        seeds_step = jax.jit(functools.partial(
            _window_seeds, cfg=cfg, self_mode=self_mode, win=win))
        extend_step = jax.jit(functools.partial(
            _window_extend, cfg=cfg, strand=strand))
        for w in range(n_win):
            key = (w, strand)
            if key in done:
                z = np.load(os.path.join(out_dir, done[key]))
                blocks.append(({f: z[f] for f in _SAVE_FIELDS}, z["valid"]))
                continue
            spx, spy, sv, n_seeds, total = seeds_step(
                dcx_pad, jnp.int32(cy_cmp.shape[0]), idxY, idxX_occ,
                jnp.int32(w * win))
            frag, valid = extend_step(spx, spy, sv, n_seeds, dcx, cy_cmp)
            if int(total) > cfg.hit_capacity:
                raise ValueError(
                    f"window {w} strand {strand}: {int(total)} hits exceed "
                    f"hit_capacity {cfg.hit_capacity}; shrink window or "
                    "raise capacity")
            if int(n_seeds) > cfg.seed_cap:
                raise ValueError(
                    f"window {w} strand {strand}: {int(n_seeds)} seeds "
                    f"exceed seed_capacity {cfg.seed_cap}; shrink window "
                    "or raise Config.seed_capacity")
            blk = {f: np.asarray(v) for f, v in frag.items()}
            va = np.asarray(valid)
            blocks.append((blk, va))
            if out_dir:
                fname = f"win_{fp}_{strand}_{w:06d}.npz"
                np.savez_compressed(os.path.join(out_dir, fname),
                                    valid=va, **blk)
                with open(manifest, "a") as f:
                    f.write(json.dumps({"fp": fp, "window": w,
                                        "strand": strand, "file": fname,
                                        "n_seeds": int(n_seeds)}) + "\n")

    allfrag = {f: jnp.asarray(np.concatenate([b[0][f] for b in blocks]))
               for f in _SAVE_FIELDS}
    allvalid = jnp.asarray(np.concatenate([b[1] for b in blocks]))
    out, valid_out, n_frags = _final_merge(allfrag, allvalid, cfg,
                                           int(cy.shape[0]))
    n = int(n_frags)
    if n > 0 and n == out["xStart"].shape[0]:
        raise ValueError("frag capacity overflow in final merge")
    frag = {k: np.asarray(v[:n]) for k, v in out.items()}
    from ..families.cluster import cluster_families
    frag["group"] = cluster_families(frag, cfg, self_cmp)
    return frag
