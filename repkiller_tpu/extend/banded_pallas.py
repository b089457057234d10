"""Banded affine-gap (Gotoh) extension — Pallas kernel for the GPU
(Triton route).

Semantics are DEFINED by oracle/banded.py and re-expressed in
extend/banded_xla.py; this kernel must match both bit-identically
(tests/unit/test_banded_pallas.py). What changes is the machine mapping:

- extend/banded_xla.py carries the whole (n_seeds, W) DP state through a
  `lax.while_loop`, so every DP row round-trips the state arrays through
  device memory — the arithmetic is trivial, the memory traffic is the
  cost, and the loop runs until the deepest seed of the whole batch dies.
- here one thread owns one seed and keeps its band state (H, E and the
  two identity counts for all W = 2*band+1 offsets) in registers, with
  the row loop inside the kernel: no state reaches device memory between
  rows. The W offsets are unrolled statically, so the horizontal-gap
  donor is a running max carried across the unrolled offsets (argmax-last
  tie rule, exactly the XLA scan's).
- a block is one warp of 32 seeds, and it exits as soon as all 32 have
  x-dropped — bit-identical to per-seed exit, because pruning makes the
  all-dead state absorbing (dead rows are no-ops).
- bases are read by position straight from the uint8 code arrays (the
  genome sits in L2): one x load per row, and one y load per row because
  the y window slides by one base per row (the window is carried in
  registers and shifted).

The kernel compiles only for the GPU. ``interpret=True`` runs it in the
Pallas interpreter, which is how the CPU tests reach it; any other
backend raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..utils.scan import partition_live as _partition_live

NEG_INF = -(1 << 30)     # python int: an immediate inside the kernel
BLOCK = 32               # seeds per block: one warp, one seed per thread
NUM_WARPS = BLOCK // 32


def _check_backend(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the banded Pallas kernel compiles only for the GPU (Triton "
            f"route); the default backend is {jax.default_backend()!r}. "
            "Use banded_impl='xla' here, or interpret=True "
            "(banded_impl='pallas_interpret') to run it in the Pallas "
            "interpreter.")


def _make_kernel(E: int, jcap: int, band: int, base_off: int, step: int,
                 match: int, mismatch: int, x_drop: int,
                 gap_open: int, gap_extend: int, Lx: int, Ly: int):
    """Kernel for one direction at row cap ``E`` and column cap ``jcap``.

    Full runs use jcap == E (the oracle's y-window bound). Phase-1 runs use
    row cap E1 with jcap = E1 + band, so every cell computed in rows <= E1
    is IDENTICAL to the full-depth run's cell (j <= i + band <= E1 + band
    <= full jcap) — which makes "all cells dead by row E1" a final verdict
    (two-phase extension)."""
    b = band
    W = 2 * b + 1
    open_, ext, xd = int(gap_open), int(gap_extend), int(x_drop)
    m32, mm32 = int(match), int(mismatch)
    i32 = jnp.int32

    def kernel(px_ref, py_ref, v_ref, cx_ref, cy_ref,
               ei_ref, ej_ref, g_ref, id_ref, alive_ref):
        px = px_ref[...]
        py = py_ref[...]
        valid = v_ref[...] != 0

        def ybase(j):
            """y code consumed at y-step j (scalar, same for the block);
            255 where the step is outside [1, jcap] or the sequence."""
            pos = py + (base_off + step * (j - 1))
            ok = valid & (j >= 1) & (j <= jcap) & (pos >= 0) & (pos < Ly)
            c = cy_ref[jnp.clip(pos, 0, Ly - 1)].astype(i32)
            return jnp.where(ok, c, 255)

        def xbase(i):
            pos = px + (base_off + step * (i - 1))
            ok = valid & (pos >= 0) & (pos < Lx)
            c = cx_ref[jnp.clip(pos, 0, Lx - 1)].astype(i32)
            return jnp.where(ok, c, 255)

        # ---- row 0: lane o holds column j = o - b ----
        # H(0, j): 0 at the centre; -(open + j*ext) right of it while
        # every y-step 1..j is valid; NEG_INF elsewhere. Then x-drop vs 0.
        Y = [ybase(o - b) for o in range(W)]
        neg = jnp.full(px.shape, NEG_INF, i32)
        zero = jnp.zeros(px.shape, i32)
        H = [neg] * W
        H[b] = jnp.where(valid, 0, NEG_INF)
        run_ok = valid
        for o in range(b + 1, W):
            run_ok = run_ok & (Y[o] < 5)
            h = -(open_ + (o - b) * ext)
            H[o] = jnp.where(run_ok & (h >= -xd), h, NEG_INF)
        live = valid
        state = (i32(1), live, zero, zero, zero, zero,
                 tuple(H), (neg,) * W, (zero,) * W, (zero,) * W, tuple(Y))

        def cond(s):
            # (reduce_or has no Triton lowering; a max over int32 does)
            return (s[0] <= E) & (jnp.max(s[1].astype(i32)) > 0)

        def body(s):
            i, _, best, bei, bej, bid, H, Eg, IH, IE, Y = s
            xc = xbase(i)
            xok = xc < 5
            Y = Y[1:] + (ybase(i + b),)        # window slides one base
            Hn, En, IHn, IEn = [], [], [], []
            run_w, run_id = neg, zero          # exclusive max of ME + o*ext
            g, ob, gid = neg, zero, zero       # row max, first offset
            for o in range(W):
                yc = Y[o]
                yok = yc < 5
                is_match = (yc == xc) & (yc < 4)
                sub = jnp.where(is_match, m32, mm32)
                M = jnp.where((H[o] > NEG_INF) & xok & yok, H[o] + sub,
                              NEG_INF)
                IM = IH[o] + is_match.astype(i32)
                if o + 1 < W:
                    Ec1 = jnp.where((H[o + 1] > NEG_INF) & xok,
                                    H[o + 1] - (open_ + ext), NEG_INF)
                    Ec2 = jnp.where((Eg[o + 1] > NEG_INF) & xok,
                                    Eg[o + 1] - ext, NEG_INF)
                    e = jnp.maximum(Ec1, Ec2)
                    ie = jnp.where(Ec1 >= Ec2, IH[o + 1], IE[o + 1])
                else:
                    e, ie = neg, zero
                ME = jnp.maximum(M, e)
                IME = jnp.where(M >= e, IM, ie)
                F = jnp.where((run_w > NEG_INF) & yok,
                              run_w - (open_ + o * ext), NEG_INF)
                h = jnp.maximum(ME, F)
                ih = jnp.where(ME >= F, IME, run_id)
                w = jnp.where(ME > NEG_INF, ME + o * ext, NEG_INF)
                take = w >= run_w               # later donor wins w-ties
                run_w = jnp.where(take, w, run_w)
                run_id = jnp.where(take, IME, run_id)
                up = h > g
                g = jnp.maximum(g, h)
                ob = jnp.where(up, o, ob)
                gid = jnp.where(up, ih, gid)
                Hn.append(h), En.append(e), IHn.append(ih), IEn.append(ie)
            # endpoint: row max, ties -> smaller i + j
            jb = i - b + ob
            better = (g > best) | ((g == best) & (i + jb < bei + bej))
            bei = jnp.where(better, i, bei)
            bej = jnp.where(better, jb, bej)
            bid = jnp.where(better, gid, bid)
            best = jnp.where(better, g, best)
            thr = best - xd
            live = jnp.zeros(px.shape, bool)
            for o in range(W):
                dead = Hn[o] < thr
                Hn[o] = jnp.where(dead, NEG_INF, Hn[o])
                En[o] = jnp.where(dead, NEG_INF, En[o])
                live = live | (Hn[o] > NEG_INF)
            return (i + 1, live, best, bei, bej, bid,
                    tuple(Hn), tuple(En), tuple(IHn), tuple(IEn), Y)

        s = jax.lax.while_loop(cond, body, state)
        ei_ref[...] = s[3]
        ej_ref[...] = s[4]
        g_ref[...] = s[2]
        id_ref[...] = s[5]
        alive_ref[...] = s[1].astype(i32)

    return kernel


def _direction(px, py, seed_valid, cx, cy, base_off: int, step: int,
               rows: int, jcap: int, dp: dict, interpret: bool):
    """One direction for all seeds at row cap ``rows`` -> (ei, ej, gain,
    idents, alive) int32[n]; ``alive`` is 1 where cells were still alive
    at the row cap.

    The grid covers the whole capacity: a block whose seeds are all
    invalid (past n_live) exits before its first row, so the cost tracks
    the live seed count, not the static capacity."""
    _check_backend(interpret)
    n = px.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK

    def pad(a):
        return jnp.pad(a, (0, n_pad - n)) if n_pad != n else a

    kern = _make_kernel(rows, jcap, dp["band"], base_off, step,
                        dp["match"], dp["mismatch"], dp["x_drop"],
                        dp["gap_open"], dp["gap_extend"],
                        cx.shape[0], cy.shape[0])
    seeds = pl.BlockSpec((BLOCK,), lambda g: (g,))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    out = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
    res = pl.pallas_call(
        kern,
        grid=(n_pad // BLOCK,),
        in_specs=[seeds, seeds, seeds, whole, whole],
        out_specs=[seeds] * 5,
        out_shape=[out] * 5,
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="banded_extend",
    )(pad(px), pad(py), pad(seed_valid.astype(jnp.int32)), cx, cy)
    return tuple(r[:n] for r in res)


def _compact_rerun(px, py, need, cx, cy, base_off, step, rows, jcap, dp,
                   interpret):
    """Re-run one direction at row cap ``rows`` for the ``need`` seeds,
    front-compacted via :func:`_partition_live` so that the blocks that
    run hold only needed seeds; results come back in slot order (slots
    outside ``need`` carry garbage — callers select with
    ``jnp.where(need, ...)``)."""
    order, dest, _ = _partition_live(need)
    res = _direction(px[order], py[order], need[order], cx, cy, base_off,
                     step, rows, jcap, dp, interpret)
    res = jnp.stack(res, axis=1)[dest]
    return tuple(res[:, c] for c in range(5))


def _phase1(px, py, seed_valid, cx, cy, base_off, step, phase1_rows,
               dp, interpret):
    """Phase 1 at row cap ``phase1_rows`` over every seed -> (ei, ej, g,
    idn, alive). Death by the cap is final (the jcap argument in
    :func:`_make_kernel`), so only ``alive`` seeds need full depth."""
    res = _direction(px, py, seed_valid, cx, cy, base_off, step,
                     phase1_rows, phase1_rows + dp["band"], dp, interpret)
    return res[:4] + (seed_valid & (res[4] == 1),)


def _frag(px, py, k, match, left, right, valid):
    lei, lej, lg, lid = left
    rei, rej, rg, rid = right
    km1 = jnp.int32(k - 1)
    frag = {
        "xStart": px - lei,
        "yStart": py - lej,
        "xEnd": px + km1 + rei,
        "yEnd": py + km1 + rej,
        "strand": jnp.zeros(px.shape[0], jnp.int32),
        "score": jnp.int32(k * match) + lg + rg,
        "idents": jnp.int32(k) + lid + rid,
    }
    frag["length"] = frag["xEnd"] - frag["xStart"] + 1
    return {f: jnp.where(valid, v, 0) for f, v in frag.items()}


def extend_banded_pallas_gated(
    px: jnp.ndarray, py: jnp.ndarray, seed_valid: jnp.ndarray,
    anchor: jnp.ndarray, cx: jnp.ndarray, cy: jnp.ndarray,
    k: int, match: int, mismatch: int, x_drop: int, max_extend: int,
    band: int, gap_open: int, gap_extend: int,
    interpret: bool = False, phase1_rows: int = 192,
) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray]:
    """Coverage gating FUSED into the two-phase extension (chain/diagonal.py
    semantics, banded-kernel hot path) -> (frag dict, valid mask).

    The generic anchors-then-survivors wrapper costs two full extension
    passes, each with capacity-sized compactions, even when gating
    removes almost nothing. Here gating rides the two-phase structure
    instead, so its cost is a few extra capacity-sized gathers:

      1. phase 1 (row cap ``phase1_rows``) runs over ALL seeds once — no
         anchor reorder needed, results stay in slot order;
      2. non-anchors whose k-mer window is covered by their bucket
         anchor's PHASE-1 x-extent are gated immediately: phase-1
         endpoints are lower bounds of full-depth endpoints (death at the
         row cap is final, survivors only extend further — the jcap
         argument in _make_kernel), so phase-1 coverage implies final
         coverage and these seeds are exactly the oracle-gated ones;
      3. one full-depth compacted pass per direction extends the seeds
         still alive at the row cap that gating has not (yet) excluded —
         the anchors plus possibly-surviving non-anchors. This is a
         SUBSET of the ungated phase-2 set;
      4. the exact oracle coverage test then re-runs against the anchors'
         FINAL extents; the few non-anchors that were fully extended but
         turn out covered are zeroed.

    Output is bit-identical to oracle.pipeline.extend_gated
    (tests/unit/test_gate.py): every reported fragment comes from the
    same full-depth extension, and the gated set is exactly
    ``~anchor & covered-by-final-anchor-extent``.
    """
    dp = dict(match=match, mismatch=mismatch, x_drop=x_drop, band=band,
              gap_open=gap_open, gap_extend=gap_extend)
    n = px.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    # slot of my bucket's anchor = last anchor at or before me (valid seeds
    # are dense at the front and their first row is an anchor, so this is
    # well-defined wherever seed_valid holds)
    anc_slot = jax.lax.cummax(jnp.where(anchor, idx, 0))
    km1 = jnp.int32(k - 1)

    def covered_by(lei, rei):
        ex = jnp.stack([px - lei, px + km1 + rei], axis=1)[anc_slot]
        return (seed_valid & ~anchor & (ex[:, 0] <= px)
                & (ex[:, 1] >= px + km1))

    sides = ((k, +1), (-1, -1))
    if max_extend > phase1_rows + band:
        p1 = [_phase1(px, py, seed_valid, cx, cy, off, st, phase1_rows,
                         dp, interpret) for off, st in sides]
        maybe = seed_valid & ~covered_by(p1[1][0], p1[0][0])
        right, left = [], []
        for (off, st), r1, out in zip(sides, p1, (right, left)):
            need = maybe & r1[4]
            r2 = _compact_rerun(px, py, need, cx, cy, off, st, max_extend,
                                max_extend, dp, interpret)
            out.extend(jnp.where(need, a, b) for a, b in zip(r2[:4], r1[:4]))
    else:
        # max_extend fits a single pass: extend everything full-depth and
        # let the final coverage test discard the gated rows (identical
        # output; covered seeds' extensions are computed then dropped)
        right, left = (list(_direction(px, py, seed_valid, cx, cy, off, st,
                                       max_extend, max_extend, dp,
                                       interpret)[:4])
                       for off, st in sides)

    # exact oracle coverage against the anchors' final extents
    valid_out = seed_valid & ~covered_by(left[0], right[0])
    return _frag(px, py, k, match, left, right, valid_out), valid_out


def extend_banded_pallas(
    px: jnp.ndarray, py: jnp.ndarray, seed_valid: jnp.ndarray,
    cx: jnp.ndarray, cy: jnp.ndarray,
    k: int, match: int, mismatch: int, x_drop: int, max_extend: int,
    band: int, gap_open: int, gap_extend: int,
    interpret: bool = False, phase1_rows: int = 192,
) -> Dict[str, jnp.ndarray]:
    """Drop-in replacement for extend/banded_xla.extend_banded
    (bit-identical). A pass at row cap ``phase1_rows`` runs over every
    seed and only its survivors, compacted to the front, re-run at full
    depth — deep repeat seeds stop dragging whole blocks of shallow seeds
    through max_extend rows. When ``max_extend <= phase1_rows + band``
    one full-depth pass does it all."""
    dp = dict(match=match, mismatch=mismatch, x_drop=x_drop, band=band,
              gap_open=gap_open, gap_extend=gap_extend)

    def run_dir(off, st):
        if max_extend <= phase1_rows + band:
            return _direction(px, py, seed_valid, cx, cy, off, st,
                              max_extend, max_extend, dp, interpret)[:4]
        r1 = _phase1(px, py, seed_valid, cx, cy, off, st, phase1_rows,
                        dp, interpret)
        r2 = _compact_rerun(px, py, r1[4], cx, cy, off, st, max_extend,
                            max_extend, dp, interpret)
        return tuple(jnp.where(r1[4], a, b) for a, b in zip(r2[:4], r1[:4]))

    return _frag(px, py, k, match, run_dir(-1, -1), run_dir(k, +1),
                 seed_valid)
