"""Ungapped x-drop extension in XLA (extend/ungapped.py) against the numpy
oracle: chunked cumsum/cummax scans, bit-identical endpoints, scores and
identities, N blocks, sequence edges, invalid seeds."""

import numpy as np
import jax.numpy as jnp
import pytest

from repkiller_tpu.config import Config
from repkiller_tpu.extend.ungapped import extend_ungapped
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu.utils import synth

FIELDS = ("xStart", "yStart", "xEnd", "yEnd", "score", "idents", "length")


def _run(px, py, cx, cy, cfg, valid=None):
    n = px.shape[0]
    if valid is None:
        valid = np.ones(n, bool)
    frag = extend_ungapped(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid),
        jnp.asarray(cx), jnp.asarray(cy),
        k=cfg.k, match=cfg.match, mismatch=cfg.mismatch,
        x_drop=cfg.x_drop, max_extend=cfg.max_extend)
    return {k2: np.asarray(v) for k2, v in frag.items()}


@pytest.mark.parametrize("max_extend,xd", [(128, 40), (256, 12), (384, 30)])
def test_random_vs_oracle(max_extend, xd):
    cfg = Config(k=8, max_extend=max_extend, x_drop=xd)
    rng = np.random.default_rng(max_extend + xd)
    L = 1500
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    mut = rng.random(L) < 0.06
    cy[mut] = (cy[mut] + rng.integers(1, 4, mut.sum())) % 4
    cx[700:705] = 4                         # N block
    n = 96
    px = rng.integers(0, L - cfg.k, n).astype(np.int32)
    py = rng.integers(0, L - cfg.k, n).astype(np.int32)
    py[: n // 2] = px[: n // 2]             # half on the identity diagonal
    want = orc.extend_ungapped(px, py, cx, cy, cfg)
    got = _run(px, py, cx, cy, cfg)
    for f in FIELDS:
        assert np.array_equal(got[f], want[f]), f


def test_invalid_seeds_zeroed():
    cfg = Config(k=8, max_extend=128)
    rng = np.random.default_rng(0)
    cx = rng.integers(0, 4, 600, dtype=np.uint8)
    n = 300
    px = rng.integers(0, 550, n).astype(np.int32)
    valid = np.zeros(n, bool)
    valid[:100] = True
    got = _run(px, px, cx, cx, cfg, valid=valid)
    want = orc.extend_ungapped(px[:100], px[:100], cx, cx, cfg)
    for f in ("xStart", "score", "idents"):
        assert np.array_equal(got[f][:100], want[f]), f
    assert (got["score"][100:] == 0).all()


def test_full_pipeline_ungapped_matches_oracle():
    from repkiller_tpu import device
    cfg = Config(k=12, strands="fr", hit_capacity=1 << 12, max_extend=256)
    g = synth.plant(2500, [(100, 3, 0.03, 1)], seed=4)
    want = orc.compare(g.codes, None, cfg)
    got = device.compare(g.codes, None, cfg)
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert np.array_equal(got[f], want[f]), f
    assert got["xStart"].shape[0] > 0
