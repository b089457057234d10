"""On-device banded affine-gap (Gotoh) extension — XLA wavefront version.

Semantics defined by oracle/banded.py (read its docstring first); this is
the same row-wavefront DP expressed as a `lax.while_loop` over rows with
(n_seeds, W = 2*band+1) vector state — band lane o holds column
j = i - band + o at row i, so the donors are: diagonal at o, vertical at
o+1 (previous row), horizontal at o-1 (current row).

The horizontal F state's within-row sequential scan is replaced by an
associative max-plus scan: F(o) = max_{o'<o}(ME(o') - open - (o-o')*ext)
 = [exclusive argmax-last cummax of w(o') = ME(o') + o'*ext] - open - o*ext,
which reproduces the oracle's per-step tie rule (later donor wins w-ties)
exactly — see tests/unit/test_device.py for the bit-equality suite.

A Pallas kernel with one seed per GPU thread replaces this for the hot
path (extend/banded_pallas.py); both must match this spec
bit-identically.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

NEG_INF = jnp.int32(-(1 << 30))


def _direction(
    px: jnp.ndarray, py: jnp.ndarray, seed_valid: jnp.ndarray,
    cx: jnp.ndarray, cy: jnp.ndarray,
    base_off: int, step: int,
    match: int, mismatch: int, x_drop: int, max_extend: int,
    band: int, gap_open: int, gap_extend: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One direction banded DP -> (ext_x, ext_y, gain, idents) int32[n].

    Base consumed at x-step i lives at px + base_off + step*(i-1); same for
    y with j (right: base_off=k step=+1; left: base_off=-1 step=-1).
    """
    n = px.shape[0]
    E = max_extend
    b = band
    W = 2 * b + 1
    Lx, Ly = cx.shape[0], cy.shape[0]
    open_, ext = jnp.int32(gap_open), jnp.int32(gap_extend)
    xd = jnp.int32(x_drop)
    o_idx = jnp.arange(W, dtype=jnp.int32)[None, :]          # (1, W)

    def gather_y(j_idx):
        """y code + validity for y-step j (consumes y[j-1])."""
        gy = py[:, None] + jnp.int32(base_off) + jnp.int32(step) * (j_idx - 1)
        ok = (j_idx >= 1) & (j_idx <= E) & (gy >= 0) & (gy < Ly)
        ch = cy[jnp.clip(gy, 0, Ly - 1)]
        return ch, ok

    def gather_x(i):
        gx = px + jnp.int32(base_off) + jnp.int32(step) * (i - 1)
        ok = (i >= 1) & (i <= E) & (gx >= 0) & (gx < Lx)
        ch = cx[jnp.clip(gx, 0, Lx - 1)]
        return ch[:, None], ok[:, None]                      # (n, 1)

    # ---- row 0: H(0,j) = -(open + j*ext) while y in bounds, H(0,0)=0 ----
    j0 = o_idx - jnp.int32(b)                                # (1, W) col at row 0
    # need ALL y-steps 1..j valid: cumulative AND along o for o > b
    _, y_ok0 = gather_y(jnp.broadcast_to(j0, (n, W)))
    right_of_center = j0 > 0
    cum_ok = jnp.cumsum(jnp.where(right_of_center, (~y_ok0).astype(jnp.int32), 0), axis=1) == 0
    H0 = jnp.where(
        j0 == 0, 0,
        jnp.where(right_of_center & cum_ok, -(open_ + j0 * ext), NEG_INF),
    ).astype(jnp.int32)
    H0 = jnp.where(seed_valid[:, None], H0, NEG_INF)
    best0 = jnp.zeros(n, jnp.int32)
    H0 = jnp.where(H0 < (best0 - xd)[:, None], NEG_INF, H0)

    def combine(a, c):
        """argmax-last max of (w, id) pairs — later index wins ties."""
        wa, ia = a
        wc, ic = c
        take_c = wc >= wa
        return jnp.where(take_c, wc, wa), jnp.where(take_c, ic, ia)

    def body(state):
        (i, H, Eg, IH, IE, best, bei, bej, bid) = state
        Hd, IHd = H, IH
        Hu = jnp.concatenate([H[:, 1:], jnp.full((n, 1), NEG_INF, jnp.int32)], axis=1)
        IHu = jnp.concatenate([IH[:, 1:], jnp.zeros((n, 1), jnp.int32)], axis=1)
        Eu = jnp.concatenate([Eg[:, 1:], jnp.full((n, 1), NEG_INF, jnp.int32)], axis=1)
        IEu = jnp.concatenate([IE[:, 1:], jnp.zeros((n, 1), jnp.int32)], axis=1)

        j_idx = jnp.int32(i) - jnp.int32(b) + o_idx          # (1, W)
        ychar, yok = gather_y(jnp.broadcast_to(j_idx, (n, W)))
        xchar, xok = gather_x(jnp.full((n,), i, jnp.int32))
        is_match = (ychar == xchar) & (ychar < 4) & (xchar < 4) & yok & xok
        sub = jnp.where(is_match, jnp.int32(match), jnp.int32(mismatch))

        M = jnp.where((Hd > NEG_INF) & xok & yok, Hd + sub, NEG_INF)
        IM = IHd + is_match.astype(jnp.int32)

        Ec1 = jnp.where((Hu > NEG_INF) & xok, Hu - open_ - ext, NEG_INF)
        Ec2 = jnp.where((Eu > NEG_INF) & xok, Eu - ext, NEG_INF)
        Enew = jnp.maximum(Ec1, Ec2)
        IEnew = jnp.where(Ec1 >= Ec2, IHu, IEu)

        ME = jnp.maximum(M, Enew)
        IME = jnp.where(M >= Enew, IM, IEnew)

        # F via exclusive argmax-last cummax of w = ME + o*ext
        w = jnp.where(ME > NEG_INF, ME + o_idx * ext, NEG_INF)
        wmax, wid = jax.lax.associative_scan(combine, (w, IME), axis=1)
        wmax_ex = jnp.concatenate([jnp.full((n, 1), NEG_INF, jnp.int32), wmax[:, :-1]], axis=1)
        wid_ex = jnp.concatenate([jnp.zeros((n, 1), jnp.int32), wid[:, :-1]], axis=1)
        # F(o) = max_{o'<o}(ME(o') - open - (o-o')*ext) = wmax_ex - open - o*ext
        F = jnp.where((wmax_ex > NEG_INF) & yok,
                      wmax_ex - open_ - o_idx * ext, NEG_INF)
        IFnew = wid_ex

        Hn = jnp.maximum(ME, F)
        IHn = jnp.where(ME >= F, IME, IFnew)

        # endpoint candidate: row max, tie -> smallest j
        ob = jnp.argmax(Hn, axis=1).astype(jnp.int32)
        g = jnp.take_along_axis(Hn, ob[:, None], axis=1)[:, 0]
        jb = jnp.int32(i) - jnp.int32(b) + ob
        idb = jnp.take_along_axis(IHn, ob[:, None], axis=1)[:, 0]
        cur_d = bei + bej
        better = (g > best) | ((g == best) & (jnp.int32(i) + jb < cur_d))
        bei = jnp.where(better, jnp.int32(i), bei)
        bej = jnp.where(better, jb, bej)
        bid = jnp.where(better, idb, bid)
        best = jnp.where(better, g, best)

        prune = Hn < (best - xd)[:, None]
        Hn = jnp.where(prune, NEG_INF, Hn)
        Enew = jnp.where(prune, NEG_INF, Enew)
        return (i + 1, Hn, Enew, IHn, IEnew, best, bei, bej, bid)

    def cond(state):
        i, H = state[0], state[1]
        return (i <= E) & jnp.any(H > NEG_INF)

    z = jnp.zeros(n, jnp.int32)
    Eg0 = jnp.full((n, W), NEG_INF, jnp.int32)
    init = (jnp.int32(1), H0, Eg0, jnp.zeros((n, W), jnp.int32),
            jnp.zeros((n, W), jnp.int32), best0, z, z, z)
    out = jax.lax.while_loop(cond, body, init)
    _, _, _, _, _, best, bei, bej, bid = out
    return bei, bej, best, bid


def extend_banded(
    px: jnp.ndarray, py: jnp.ndarray, seed_valid: jnp.ndarray,
    cx: jnp.ndarray, cy: jnp.ndarray,
    k: int, match: int, mismatch: int, x_drop: int, max_extend: int,
    band: int, gap_open: int, gap_extend: int,
) -> Dict[str, jnp.ndarray]:
    """Banded affine-gap extension of all seeds; matches
    oracle.banded.extend_banded bit-identically."""
    args = (match, mismatch, x_drop, max_extend, band, gap_open, gap_extend)
    rei, rej, rg, rid = _direction(px, py, seed_valid, cx, cy, k, +1, *args)
    lei, lej, lg, lid = _direction(px, py, seed_valid, cx, cy, -1, -1, *args)
    n = px.shape[0]
    seed_score = jnp.int32(k * match)
    frag = {
        "xStart": px - lei,
        "yStart": py - lej,
        "xEnd": px + jnp.int32(k - 1) + rei,
        "yEnd": py + jnp.int32(k - 1) + rej,
        "strand": jnp.zeros(n, jnp.int32),
        "score": seed_score + lg + rg,
        "idents": jnp.int32(k) + lid + rid,
    }
    frag["length"] = frag["xEnd"] - frag["xStart"] + 1
    frag = {f: jnp.where(seed_valid, v, 0) for f, v in frag.items()}
    return frag
