"""Coverage-gating tests (SURVEY.md §1 L3 "chaining"; the GECKO-FragHits
"skip hits covered by the previous fragment on this diagonal" walk,
reformulated as deterministic bucket-local anchor gating — semantics
defined by oracle.pipeline.gate_anchors / extend_gated, device path in
chain/diagonal.py must match bit-identically)."""

import numpy as np
import pytest

from repkiller_tpu.config import Config
from repkiller_tpu import device
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu.utils import synth


def _sorted_by_diag_px(px, py):
    diag = px.astype(np.int64) - py.astype(np.int64)
    order = np.lexsort((px, diag))
    return px[order], py[order]


def test_gate_anchors_first_per_bucket():
    cfg = Config(gate_stride=64)
    px = np.array([0, 10, 70, 130, 0, 5], np.int32)
    py = np.array([100, 110, 170, 230, 50, 55], np.int32)
    px, py = _sorted_by_diag_px(px, py)
    anchor = orc.gate_anchors(px, py, cfg)
    # sorted: diag -100 at px 0,10 (bucket 0), 70 (b1), 130 (b2);
    #         diag  -50 at px 0,5  (bucket 0)
    assert anchor.tolist() == [True, False, True, True, True, False]


def test_gate_skips_covered_extends_uncovered():
    """An anchor whose fragment covers its bucket gates the later seeds;
    a bucket the fragment does NOT reach still extends its own seeds."""
    cfg = Config(k=8, gate_stride=64, min_hit_dist=8, strands="f",
                 max_extend=256, min_len=10)
    # two exact copies of a 100 bp unit, far apart -> one long diagonal run
    unit = synth.random_codes(100, seed=3)
    g = synth.random_codes(600, seed=4)
    g[50:150] = unit
    g[400:500] = unit
    want_gated = orc.compare(g, None, cfg)
    want_ungated = orc.compare(g, None, cfg.replace(gate_stride=0))
    # gating must not lose the repeat: same accepted fragments here
    for f in orc.FRAG_FIELDS:
        assert np.array_equal(want_gated[f], want_ungated[f]), f
    assert want_gated["xStart"].shape[0] > 0


def test_gate_reduces_extension_count_near_identical():
    """The config-#3 blow-up case: a near-identical pair seeds every
    min_hit_dist bp along the backbone diagonal; gating must cut the
    number of extensions by ~gate_stride/min_hit_dist."""
    cfg = Config(k=12, gate_stride=512, min_hit_dist=32, strands="f",
                 max_extend=1024)
    cx = synth.random_codes(4000, seed=9)
    rng = np.random.default_rng(10)
    cy = synth.mutate(cx, 0.01, rng)          # 1% diverged "strain"
    idxX = orc.build_index(cx, cfg.k)
    idxY = orc.build_index(cy, cfg.k)
    px, py = orc.find_hits(idxX, idxY, cfg)
    px, py = orc.filter_hits(px, py, cfg)
    anchor = orc.gate_anchors(px, py, cfg)
    fa = orc._extend_dispatch(px[anchor], py[anchor], cx, cy, cfg)
    ordinal = np.cumsum(anchor) - 1
    covered = (~anchor) & (fa["xStart"][ordinal] <= px) \
        & (fa["xEnd"][ordinal] >= px + cfg.k - 1)
    n_ext = int(anchor.sum() + (~anchor & ~covered).sum())
    # backbone diagonal alone has ~4000/32 = 125 thinned seeds; gating
    # should leave ~4000/512 = 8 anchors + stragglers at mismatch breaks
    assert n_ext < px.shape[0] // 3, (n_ext, px.shape[0])


GATE_CONFIGS = [
    Config(k=8, strands="fr", gate_stride=64, min_hit_dist=8, max_occ=16,
           hit_capacity=1 << 14, max_extend=256, min_len=20),
    Config(k=12, strands="fr", gate_stride=128, hit_capacity=1 << 14,
           max_extend=256),
    Config(k=12, strands="fr", gate_stride=128, extend_mode="banded", band=4,
           hit_capacity=1 << 14, max_extend=256),
    # fused gated Pallas path (the kernel in the Pallas interpreter),
    # two-phase branch (max_extend > phase1_rows + band = 196)
    Config(k=12, strands="fr", gate_stride=128, extend_mode="banded", band=4,
           banded_impl="pallas_interpret", hit_capacity=1 << 14,
           max_extend=256),
    # fused gated Pallas path, single-pass branch (max_extend <= 196)
    Config(k=12, strands="fr", gate_stride=128, extend_mode="banded", band=4,
           banded_impl="pallas_interpret", hit_capacity=1 << 14,
           max_extend=128),
]


def _assert_frag_equal(got, want):
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert np.array_equal(got[f], want[f]), (f, got[f], want[f])


@pytest.mark.parametrize("ci", range(len(GATE_CONFIGS)))
def test_gated_device_matches_oracle_self(ci):
    cfg = GATE_CONFIGS[ci]
    g = synth.plant(3000, [(120, 3, 0.05, 1), (80, 2, 0.0, 0)], seed=21 + ci)
    got = device.compare(g.codes, None, cfg)
    want = orc.compare(g.codes, None, cfg)
    _assert_frag_equal(got, want)
    assert got["xStart"].shape[0] > 0


@pytest.mark.parametrize("ci", [0, 2, 3, 4])
def test_gated_device_matches_oracle_cross(ci):
    cfg = GATE_CONFIGS[ci]
    rng = np.random.default_rng(300 + ci)
    cx = rng.integers(0, 4, 2500, dtype=np.uint8)
    cy = synth.mutate(cx, 0.02, rng)[:2300]   # near-identical pair slice
    got = device.compare(cx, cy, cfg)
    want = orc.compare(cx, cy, cfg)
    _assert_frag_equal(got, want)
    assert got["xStart"].shape[0] > 0


def test_gated_streamed_invariant():
    from repkiller_tpu.dist.windows import compare_streamed

    cfg = Config(k=12, strands="fr", gate_stride=256, min_hit_dist=32,
                 hit_capacity=1 << 13, max_extend=256)
    g = synth.plant(3000, [(150, 4, 0.03, 1)], seed=33)
    want = orc.compare(g.codes, None, cfg)
    for window in (512, 1024):               # multiples of gate_stride lcm
        got = compare_streamed(g.codes, None, cfg, window=window)
        _assert_frag_equal(got, want)
    assert want["xStart"].shape[0] > 0
