"""Config.seed_capacity: a tighter static bound on thinned seeds shrinks
the extension stage's capacity-sized sorts/gathers without changing any
output; overflow raises instead of truncating (static-shape contract,
SURVEY.md §7 "Hard parts" #3)."""

import numpy as np
import pytest

from repkiller_tpu.config import Config
from repkiller_tpu import device
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu.utils import synth


CFG = Config(k=12, strands="fr", hit_capacity=1 << 14, max_extend=256)


def _genome():
    return synth.plant(4000, [(150, 4, 0.03, 1), (90, 3, 0.0, 0)], seed=77)


def test_tight_seed_capacity_same_output():
    g = _genome()
    want = device.compare(g.codes, None, CFG)
    got = device.compare(g.codes, None, CFG.replace(seed_capacity=1 << 11))
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert np.array_equal(got[f], want[f]), f
    assert want["xStart"].shape[0] > 0


def test_seed_capacity_overflow_raises():
    g = _genome()   # 28 forward / 26 reverse seeds at these thresholds
    with pytest.raises(ValueError, match="seed_capacity"):
        device.compare(g.codes, None, CFG.replace(seed_capacity=16))


def test_seed_capacity_banded_pallas_gated():
    g = _genome()
    cfg = CFG.replace(extend_mode="banded", band=4, banded_impl="pallas_interpret",
                      gate_stride=128, seed_capacity=1 << 11)
    got = device.compare(g.codes, None, cfg)
    want = orc.compare(g.codes, None, cfg)
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert np.array_equal(got[f], want[f]), f


def test_seed_capacity_sharded():
    from repkiller_tpu.dist.sharded import compare_sharded
    from repkiller_tpu.dist.mesh import make_mesh
    import jax

    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual devices")
    g = _genome()
    cfg = CFG.replace(hit_capacity=1 << 14, seed_capacity=1 << 12)
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    got = compare_sharded(g.codes, None, cfg, mesh)
    want = orc.compare(g.codes, None, cfg)
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert np.array_equal(got[f], want[f]), f


def test_seed_capacity_validation():
    with pytest.raises(ValueError):
        Config(seed_capacity=-1)
    with pytest.raises(ValueError):
        Config(hit_capacity=1 << 10, seed_capacity=1 << 11)
    assert Config(seed_capacity=0).seed_cap == Config().hit_capacity
    assert Config(seed_capacity=128).seed_cap == 128
