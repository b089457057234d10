"""Banded-Gotoh Pallas kernel parity (SURVEY.md §7 M2): must match the
numpy oracle and the XLA wavefront version bit-identically. On the CPU
the kernel runs in the Pallas interpreter (interpret=True); the tests
marked ``gpu`` compile it for the card."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from repkiller_tpu.config import Config
from repkiller_tpu.oracle import banded as obanded
from repkiller_tpu.extend import banded_pallas as bp
from repkiller_tpu.extend import banded_xla as bx
from repkiller_tpu.extend.banded_pallas import extend_banded_pallas
from repkiller_tpu.utils import synth


def _kw(cfg):
    return dict(k=cfg.k, match=cfg.match, mismatch=cfg.mismatch,
                x_drop=cfg.x_drop, max_extend=cfg.max_extend,
                band=cfg.band, gap_open=cfg.gap_open,
                gap_extend=cfg.gap_extend)


def _run_pallas(px, py, cx, cy, cfg, valid=None, **kw):
    n = px.shape[0]
    frag = extend_banded_pallas(
        jnp.asarray(px), jnp.asarray(py),
        jnp.ones(n, bool) if valid is None else jnp.asarray(valid),
        jnp.asarray(cx), jnp.asarray(cy), interpret=True, **_kw(cfg), **kw)
    return {k: np.asarray(v) for k, v in frag.items()}


def _assert_equal(got, want):
    for f in ("xStart", "yStart", "xEnd", "yEnd", "score", "idents", "length"):
        assert np.array_equal(got[f], want[f]), (
            f, got[f][:20], want[f][:20])


def _mutated_pair(rng, L, rate, shift_at=None):
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    mut = rng.random(L) < rate
    cy[mut] = (cy[mut] + rng.integers(1, 4, mut.sum())) % 4
    if shift_at is not None:           # deletions: shift a block
        cy[shift_at:] = np.roll(cy[shift_at:], 2)
    return cx, cy


@pytest.mark.parametrize("band,max_extend,xd", [(4, 64, 30), (8, 128, 40),
                                                (16, 96, 24)])
def test_random_seeds_vs_oracle(band, max_extend, xd):
    cfg = Config(k=8, band=band, max_extend=max_extend, x_drop=xd,
                 extend_mode="banded")
    rng = np.random.default_rng(band * 7 + max_extend)
    L = 1200
    cx, cy = _mutated_pair(rng, L, 0.05, shift_at=600)
    n = 96
    px = rng.integers(0, L - cfg.k, n).astype(np.int32)
    py = np.clip(px + rng.integers(-3, 4, n), 0, L - cfg.k).astype(np.int32)
    want = obanded.extend_banded(px, py, cx, cy, cfg)
    got = _run_pallas(px, py, cx, cy, cfg)
    _assert_equal(got, want)


def test_ns_and_bounds():
    cfg = Config(k=8, band=4, max_extend=64, x_drop=20, extend_mode="banded")
    rng = np.random.default_rng(0)
    cx = rng.integers(0, 4, 300, dtype=np.uint8)
    cy = cx.copy()
    cx[40:45] = 4          # N block mid-sequence
    px = np.array([0, 10, 35, 290, 150], np.int32)   # edges + around the Ns
    py = px.copy()
    want = obanded.extend_banded(px, py, cx, cy, cfg)
    got = _run_pallas(px, py, cx, cy, cfg)
    _assert_equal(got, want)


def test_invalid_seeds_zeroed():
    cfg = Config(k=8, band=4, max_extend=64, extend_mode="banded")
    cx = np.tile(np.arange(4, dtype=np.uint8), 64)
    px = np.array([8, 16], np.int32)
    frag = _run_pallas(px, px, cx, cx, cfg, valid=np.array([True, False]))
    assert int(frag["score"][1]) == 0 and int(frag["length"][1]) == 0


@pytest.mark.parametrize("n", [1, 31, 33, 70])
def test_capacity_padding_matches_xla(n):
    """Capacities that are not a multiple of the 32-seed block pad with
    invalid seeds; results for the real slots equal the XLA wavefront."""
    cfg = Config(k=8, band=4, max_extend=64, extend_mode="banded")
    rng = np.random.default_rng(n)
    cx, cy = _mutated_pair(rng, 800, 0.04)
    px = rng.integers(0, 780, n).astype(np.int32)
    py = np.clip(px + rng.integers(-2, 3, n), 0, 780).astype(np.int32)
    valid = rng.random(n) < 0.8
    got = _run_pallas(px, py, cx, cy, cfg, valid=valid)
    want = bx.extend_banded(jnp.asarray(px), jnp.asarray(py),
                            jnp.asarray(valid), jnp.asarray(cx),
                            jnp.asarray(cy), **_kw(cfg))
    _assert_equal(got, {k: np.asarray(v) for k, v in want.items()})


def test_row_cap_death_is_final():
    """A seed whose cells all die by the row cap (alive == 0) already has
    its full-depth endpoint — the phase-1 verdict the two-phase driver
    rests on; some seeds survive the cap, so both sides are exercised."""
    cfg = Config(k=8, band=4, max_extend=256, x_drop=40, extend_mode="banded")
    rng = np.random.default_rng(5)
    cx, cy = _mutated_pair(rng, 2000, 0.02)
    n = 40
    px = rng.integers(0, 1700, n).astype(np.int32)
    py = px.copy()
    py[::3] = rng.integers(0, 1700, len(py[::3]))   # some random (dead) seeds
    dp = dict(match=cfg.match, mismatch=cfg.mismatch, x_drop=cfg.x_drop,
              band=cfg.band, gap_open=cfg.gap_open, gap_extend=cfg.gap_extend)
    args = (jnp.asarray(px), jnp.asarray(py), jnp.ones(n, bool),
            jnp.asarray(cx), jnp.asarray(cy))
    cap = 32
    *capped, alive = bp._direction(*args, cfg.k, 1, cap, cap + cfg.band, dp,
                                   True)
    full = bx._direction(*args, cfg.k, 1, cfg.match, cfg.mismatch,
                         cfg.x_drop, cfg.max_extend, cfg.band, cfg.gap_open,
                         cfg.gap_extend)
    dead = np.asarray(alive) == 0
    assert dead.any() and not dead.all()
    for c, f in zip(capped, full):
        assert np.array_equal(np.asarray(c)[dead], np.asarray(f)[dead])


def test_full_pipeline_banded_pallas_matches_oracle():
    from repkiller_tpu import device
    from repkiller_tpu.oracle import pipeline as orc
    cfg = Config(k=12, strands="fr", extend_mode="banded", band=4,
                 banded_impl="pallas_interpret", hit_capacity=1 << 12,
                 max_extend=128)
    g = synth.plant(2000, [(100, 3, 0.04, 1)], seed=9)
    want = orc.compare(g.codes, None, cfg.replace(banded_impl="xla"))
    got = device.compare(g.codes, None, cfg)
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert np.array_equal(got[f], want[f]), f
    assert got["xStart"].shape[0] > 0


def test_two_phase_matches_single_phase():
    """Force the phase-1/compaction path (tiny phase1_rows) on inputs with
    deep survivors; must equal the single-phase run and the oracle."""
    cfg = Config(k=8, band=4, max_extend=256, x_drop=40,
                 extend_mode="banded")
    rng = np.random.default_rng(33)
    L = 4000
    cx, cy = _mutated_pair(rng, L, 0.02)       # long high-identity stretches
    n = 128
    px = rng.integers(0, L - cfg.k, n).astype(np.int32)
    py = np.clip(px + rng.integers(-2, 3, n), 0, L - cfg.k).astype(np.int32)
    valid = np.ones(n, bool)
    valid[100:] = False

    one = _run_pallas(px, py, cx, cy, cfg, valid=valid,
                      phase1_rows=cfg.max_extend)      # single pass
    two = _run_pallas(px, py, cx, cy, cfg, valid=valid, phase1_rows=32)
    for f in ("xStart", "yStart", "xEnd", "yEnd", "score", "idents"):
        assert np.array_equal(one[f], two[f]), f
    want = obanded.extend_banded(px[:100], py[:100], cx, cy, cfg)
    for f in ("xStart", "yStart", "xEnd", "yEnd", "score", "idents"):
        assert np.array_equal(two[f][:100], want[f]), f
    # deep survivors actually exist (the path is exercised)
    assert (want["length"] > 64).any()


def test_kernel_off_gpu_without_interpret_raises():
    """Requested on a backend it cannot compile for, the kernel raises —
    it never falls back to the interpreter on its own."""
    assert jax.default_backend() != "gpu"
    cfg = Config(k=8, band=4, max_extend=64, extend_mode="banded")
    cx = np.tile(np.arange(4, dtype=np.uint8), 64)
    px = np.array([8, 16], np.int32)
    with pytest.raises(RuntimeError, match="only for the GPU"):
        extend_banded_pallas(jnp.asarray(px), jnp.asarray(px),
                             jnp.ones(2, bool), jnp.asarray(cx),
                             jnp.asarray(cx), **_kw(cfg))


def test_auto_picks_xla_off_gpu_and_pallas_raises():
    from repkiller_tpu import device
    from repkiller_tpu.extend import banded_impl
    cfg = Config(k=12, extend_mode="banded", band=4, hit_capacity=1 << 12,
                 max_extend=128)
    assert banded_impl(cfg) == "xla"
    assert banded_impl(cfg.replace(banded_impl="pallas")) == "pallas"
    g = synth.plant(2000, [(100, 3, 0.04, 1)], seed=9)
    with pytest.raises(RuntimeError, match="only for the GPU"):
        device.compare(g.codes, None, cfg.replace(banded_impl="pallas"))


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; runs through chip_smoke.py")


@pytest.mark.gpu
def test_gpu_compiled_kernel_matches_oracle(gpu):
    """The kernel as compiled for the card (a Triton custom call in the
    lowered program, not the interpreter) equals the oracle."""
    cfg = Config(k=8, band=15, max_extend=256, x_drop=40,
                 extend_mode="banded")
    rng = np.random.default_rng(11)
    L = 5000
    cx, cy = _mutated_pair(rng, L, 0.03, shift_at=2500)
    n = 200
    px = rng.integers(0, L - cfg.k, n).astype(np.int32)
    py = np.clip(px + rng.integers(-3, 4, n), 0, L - cfg.k).astype(np.int32)
    args = (jnp.asarray(px), jnp.asarray(py), jnp.ones(n, bool),
            jnp.asarray(cx), jnp.asarray(cy))
    fn = jax.jit(lambda *a: extend_banded_pallas(*a, **_kw(cfg)))
    assert "xla.gpu.triton" in fn.lower(*args).as_text()
    got = {k: np.asarray(v) for k, v in fn(*args).items()}
    _assert_equal(got, obanded.extend_banded(px, py, cx, cy, cfg))
