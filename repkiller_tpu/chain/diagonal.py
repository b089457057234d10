"""On-device seed chaining via coverage gating (SURVEY.md §1 L3 "chaining",
§7 layout `chain/diagonal.py`).

Semantics are DEFINED by oracle.pipeline.gate_anchors / extend_gated and
must match bit-identically (tests/unit/test_gate.py): seeds arrive sorted
by (diag, px) with the valid ones dense at the front (filter_hits'
output contract). The FIRST seed of every (diagonal, px // gate_stride)
bucket is an ANCHOR and always extends; a later seed of the same bucket
is skipped iff its k-mer window [px, px+k-1] lies inside its anchor's
fragment x-extent — the fragment already covers it, so extending it
again can only reproduce work the per-diagonal merge would throw away.
This is a deterministic, data-parallel formulation of GECKO FragHits'
sequential "skip hits covered by the previous fragment on this diagonal"
walk: on a
near-identical strain pair the shared backbone seeds every min_hit_dist
bp along one diagonal, and gating cuts the extension count per backbone
diagonal from length/min_hit_dist to ~length/gate_stride.

Bucket-LOCAL coverage (a seed only consults its own bucket's anchor)
keeps the decision a pure function of the bucket's seeds, so the output
is invariant to mesh shape and to window splits at gate_stride
multiples — the §4.5 determinism contract.

Cost: on the banded-Pallas hot path, gating is FUSED into the kernel's
two-phase structure (extend/banded_pallas.extend_banded_pallas_gated):
phase 1 runs over all seeds once, conservative phase-1 coverage gates
which non-anchors reach the full-depth pass, and the exact oracle
coverage test re-runs against the anchors' final extents — a few extra
capacity-sized gathers over the ungated cost, instead of the generic
wrapper's second full extension pass. Other kernels (ungapped, XLA
banded) use the generic anchors-then-survivors wrapper below; all paths
are bit-identical (tests/unit/test_gate.py).

Cap-binding caveat: when ``max_extend`` binds mid-repeat (repeat longer
than the per-side cap), the anchor's fragment is truncated at the cap, so
the overlap run's best fragment can differ from the ungated pipeline's
(whose mid-repeat seeds span up to 2*max_extend). Outputs remain
bit-identical across oracle/device/sharded/streamed for the SAME config —
gating is part of the defined semantics, as GECKO FragHits' skip is —
but configs should keep max_extend comfortably above the expected repeat
unit length (the default 2048 is a static-shape guard, not a tuning knob).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp

from ..config import Config
from ..extend import banded_impl, extend_dispatch
from ..extend.banded_pallas import extend_banded_pallas_gated
from ..utils.scan import partition_live


def extend_gated(
    spx: jnp.ndarray, spy: jnp.ndarray, svalid: jnp.ndarray,
    cx: jnp.ndarray, cy: jnp.ndarray, cfg: Config,
) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray]:
    """Extend seeds with coverage gating -> (frag dict, valid mask).

    Gated seeds come back invalid with zeroed fragment rows; anchors and
    surviving seeds carry their extension result in their own slot.
    gate_stride == 0 degrades to a plain extend_dispatch pass-through.
    """
    if cfg.gate_stride <= 0:
        frag = extend_dispatch(spx, spy, svalid, cx, cy, cfg)
        return frag, svalid

    n = spx.shape[0]
    diag = spx - spy
    bucket = spx // jnp.int32(cfg.gate_stride)
    prev_same = jnp.concatenate([
        jnp.zeros(1, bool),
        (diag[1:] == diag[:-1]) & (bucket[1:] == bucket[:-1]),
    ])
    anchor = svalid & ~prev_same

    impl = banded_impl(cfg)
    if cfg.extend_mode == "banded" and impl != "xla":
        # hot path: gating fused into the two-phase kernel structure
        return extend_banded_pallas_gated(
            spx, spy, svalid, anchor, cx, cy,
            k=cfg.k, match=cfg.match, mismatch=cfg.mismatch,
            x_drop=cfg.x_drop, max_extend=cfg.max_extend, band=cfg.band,
            gap_open=cfg.gap_open, gap_extend=cfg.gap_extend,
            interpret=impl == "pallas_interpret")

    # anchors to the front (stable: keeps (diag, px) order)
    order_a, _, _ = partition_live(anchor)
    fa = extend_dispatch(spx[order_a], spy[order_a], anchor[order_a],
                         cx, cy, cfg)

    # every seed's bucket-anchor sits at compact slot cumsum(anchor)-1
    # (each bucket's first valid row IS an anchor, so the running count
    # indexes the right compacted fragment); row 0 is always an anchor
    # when any seed is valid, so the clip only guards the all-invalid case
    ordinal = jnp.clip(jnp.cumsum(anchor.astype(jnp.int32)) - 1, 0, n - 1)
    a_s = fa["xStart"][ordinal]
    a_e = fa["xEnd"][ordinal]
    covered = svalid & ~anchor & (a_s <= spx) \
        & (a_e >= spx + jnp.int32(cfg.k - 1))
    surv = svalid & ~anchor & ~covered

    order_s, inv_s, _ = partition_live(surv)
    fs = extend_dispatch(spx[order_s], spy[order_s], surv[order_s],
                         cx, cy, cfg)

    frag = {}
    for f in fa:
        frag[f] = jnp.where(anchor, fa[f][ordinal],
                            jnp.where(surv, fs[f][inv_s], 0))
    return frag, anchor | surv
