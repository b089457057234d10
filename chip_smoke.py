#!/usr/bin/env python
"""Smoke test of repkiller on an NVIDIA GPU: the quickest proof that the
system still starts on the card and gives the right answers there.

    python chip_smoke.py             # one card: phases 1-6 below
    python chip_smoke.py --cards 4   # four cards: the sharded phase only

Phases (one card), in order; any failure ends the run with a non-zero
exit code, and nothing here catches a phase's failure:

1. refuse to run without a GPU;
2. name the card (nvidia-smi), its JAX device kind and the JAX version;
3. parity at small size: the device pipeline is bit-identical to the
   numpy oracle for both extend modes, self and cross comparison, both
   strands;
4. the banded Pallas kernel, compiled for the GPU (asserted from the
   lowered program), against the XLA reference (extend/banded_xla.py) at
   band 15 and max_extend 2048 on the thinned seeds of config #1: both
   directions, both strands, the two-phase path and coverage gating.
   Tolerance is zero: every value is int32 and acceptance is an integer
   test (chain/merge.py). No float matrix product is on this path, so
   TF32 does not apply;
5. the tests marked ``gpu`` (pytest, in a child process);
6. the main path through the CLI in a child process: config #1 (4,194,304
   bp, k=12, strands fr, banded) from a FASTA file must give 139,287
   fragments and write its output files. Wall times with and without
   compilation are printed.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Child processes share the card with this one, so every process here
allocates device memory on demand instead of reserving most of the card
(XLA_PYTHON_CLIENT_PREALLOCATE=false).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# config #1: E. coli-scale self-comparison (bench.py)
C1_SIZE = 1 << 22
C1_FAMS = [(1024, 6, 0.02, 2), (768, 5, 0.05, 1), (512, 7, 0.0, 0),
           (1536, 3, 0.03, 1), (256, 8, 0.08, 2)]
C1_FRAGMENTS = 139_287
# config #4: D. melanogaster chr2L+2R-scale masking (benchmarks/run_config4.py)
C4_SIZE = 48_000_000
C4_COUNTS = {"fragments": 85_400, "intervals": 132_102,
             "masked_bp": 9_997_161}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def c1_config():
    from repkiller_tpu.config import Config
    return Config(k=12, strands="fr", extend_mode="banded",
                  hit_capacity=1 << 20, seed_capacity=1 << 19,
                  max_extend=2048)


def phase_parity():
    import numpy as np
    from repkiller_tpu import device
    from repkiller_tpu.config import Config
    from repkiller_tpu.oracle import pipeline as orc
    from repkiller_tpu.utils import synth

    size = 60_000
    g = synth.plant(size, [(400, 4, 0.03, 1), (250, 3, 0.0, 1)], seed=99)
    cy = np.random.default_rng(7).integers(0, 4, size // 2, dtype=np.uint8)
    cy[1000:3000] = g.codes[5000:7000]
    keys = list(orc.FRAG_FIELDS) + ["group"]
    for mode, impl in (("banded", "auto"), ("banded", "xla"),
                       ("ungapped", "auto")):
        cfg = Config(k=12, strands="fr", extend_mode=mode, banded_impl=impl,
                     hit_capacity=1 << 16, max_extend=512)
        for name, y in (("self", None), ("cross", cy)):
            t0 = time.perf_counter()
            got = device.compare(g.codes, y, cfg)
            dt = time.perf_counter() - t0
            want = orc.compare(g.codes, y, cfg)
            bad = [k for k in keys if not np.array_equal(got[k], want[k])]
            n = got["xStart"].shape[0]
            check(n > 0 and not bad,
                  f"parity {name}/{mode}/{impl}: {n} fragments, "
                  f"mismatched fields {bad}")
            print(f"parity {name}/{mode}/{impl}: {n} fragments "
                  f"bit-identical to the oracle ({dt:.2f} s)", flush=True)


def _equal(a, b):
    import numpy as np
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def phase_kernel():
    import jax
    import jax.numpy as jnp
    from repkiller_tpu import device
    from repkiller_tpu.chain.diagonal import extend_gated
    from repkiller_tpu.extend import banded_pallas as bp
    from repkiller_tpu.extend import banded_xla as bx
    from repkiller_tpu.utils import synth

    cfg = c1_config()
    dp = dict(match=cfg.match, mismatch=cfg.mismatch, x_drop=cfg.x_drop,
              band=cfg.band, gap_open=cfg.gap_open,
              gap_extend=cfg.gap_extend)
    ek = dict(dp, k=cfg.k, max_extend=cfg.max_extend)
    E = cfg.max_extend
    codes = jnp.asarray(synth.plant(C1_SIZE, C1_FAMS, seed=1234).codes)
    seeds = device._stage_self_seeds(codes, cfg)
    for strand, (spx, spy, sv, n_seeds, _) in seeds.items():
        cy = codes if strand == 0 else device.revcomp_device(codes)
        args = (spx, spy, sv, codes, cy)
        for off, st in ((cfg.k, 1), (-1, -1)):
            pk = jax.jit(lambda *a: bp._direction(*a, off, st, E, E, dp,
                                                  False))
            hlo = pk.lower(*args).as_text()
            check("xla.gpu.triton" in hlo,
                  "the banded kernel was not compiled for the GPU")
            xk = jax.jit(lambda *a: bx._direction(
                *a, off, st, cfg.match, cfg.mismatch, cfg.x_drop, E,
                cfg.band, cfg.gap_open, cfg.gap_extend))
            got, want = pk(*args), xk(*args)
            check(_equal(got[:4], want),
                  f"kernel != XLA reference, strand {strand} step {st}")
            print(f"kernel strand {strand} step {st:+d}: {int(n_seeds)} "
                  f"seeds bit-identical to the XLA reference", flush=True)
        two = jax.jit(lambda *a: bp.extend_banded_pallas(*a, **ek))(*args)
        ref = jax.jit(lambda *a: bx.extend_banded(*a, **ek))(*args)
        check(_equal(two.values(), ref.values()),
              f"two-phase kernel path != XLA reference, strand {strand}")
        gated = [jax.jit(lambda *a, c=cfg.replace(banded_impl=impl):
                         extend_gated(*a, c))(*args)
                 for impl in ("pallas", "xla")]
        check(_equal(gated[0][0].values(), gated[1][0].values())
              and _equal([gated[0][1]], [gated[1][1]]),
              f"gated kernel path != gated XLA path, strand {strand}")
        print(f"kernel strand {strand}: two-phase and gated paths "
              "bit-identical to XLA", flush=True)


def phase_gpu_tests():
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                        "-p", "no:cacheprovider", "tests"],
                       cwd=ROOT, env=env, capture_output=True, text=True)
    tail = r.stdout.strip().splitlines()[-1:] or [""]
    print(f"gpu tests: {tail[0]}", flush=True)
    check(r.returncode == 0 and "passed" in tail[0] and "skipped" not in
          tail[0], f"gpu tests failed:\n{r.stdout[-4000:]}{r.stderr[-4000:]}")


def phase_main_path():
    from repkiller_tpu.io import codec
    from repkiller_tpu.utils import synth

    cfg = c1_config()
    codes = synth.plant(C1_SIZE, C1_FAMS, seed=1234).codes
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "config1.fasta")
        body = codec.decode(codes)
        with open(fa, "w") as f:
            f.write(">config1\n")
            f.writelines(body[i:i + 70] + "\n"
                         for i in range(0, len(body), 70))
        prefix = os.path.join(tmp, "config1")
        cmd = [sys.executable, "-m", "repkiller_tpu.cli", "run", fa,
               "-o", prefix, "--repeat", "2",
               "--k", str(cfg.k), "--strands", cfg.strands,
               "--extend-mode", cfg.extend_mode,
               "--hit-capacity", str(cfg.hit_capacity),
               "--seed-capacity", str(cfg.seed_capacity),
               "--max-extend", str(cfg.max_extend)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"CLI failed:\n{r.stderr[-4000:]}")
        m = json.loads(r.stdout.strip().splitlines()[-1])
        check(m["fragments"] == C1_FRAGMENTS,
              f"config #1 gave {m['fragments']} fragments, "
              f"want {C1_FRAGMENTS}")
        for ext in (".frags.csv", ".families.csv", ".repeats.bed"):
            check(os.path.getsize(prefix + ext) > 0, f"no {ext} output")
    print(f"main path (CLI, config #1): {m['fragments']} fragments, "
          f"{m['families']} families", flush=True)
    print(f"main path wall: process {wall:.3f} s; compare with compile "
          f"{m['walls_s'][0]} s, compiled {m['walls_s'][1]} s", flush=True)


def c4_config():
    # capacities are static bounds, not part of the output: per-device
    # blocks are capacity / n_devices, so the four-card mesh gets 4x the
    # one-card config's (2^20 hits, 2^19 seeds) and needs no retry
    from repkiller_tpu.config import Config
    return Config(k=16, strands="fr", extend_mode="banded",
                  hit_capacity=1 << 22, seed_capacity=1 << 21,
                  max_extend=2048)


def phase_four_cards(devices, size=C4_SIZE, cfg=None, counts=C4_COUNTS):
    """Config #4 on a (2, 2) mesh of four devices against the same
    compare_sharded program on a (1, 1) mesh of the first: bit for bit,
    and the recorded counts when ``counts`` is given."""
    import numpy as np
    from repkiller_tpu.dist.mesh import make_mesh
    from repkiller_tpu.dist.sharded import compare_sharded
    from repkiller_tpu.oracle import pipeline as orc
    from repkiller_tpu.report import intervals as report_iv
    from repkiller_tpu.utils import synth
    from repkiller_tpu.utils.capacity import with_auto_capacity

    half = size // 2
    fams = [(7000, 5, 0.05, 2), (4100, 4, 0.08, 1), (359, 30, 0.06, 5),
            (1024, 8, 0.02, 2)]
    codes = np.concatenate([synth.plant(half, fams, seed=21).codes,
                            np.array([4], np.uint8),
                            synth.plant(size - half, fams, seed=22).codes])
    cfg = cfg or c4_config()
    out = {}
    for shape in ((2, 2), (1, 1)):
        mesh = make_mesh(*shape, devices=devices[:shape[0] * shape[1]])
        t0 = time.perf_counter()
        frag, used = with_auto_capacity(
            lambda c: compare_sharded(codes, None, c, mesh), cfg)
        dt = time.perf_counter() - t0
        iv = orc.repeat_intervals(frag, frag["group"], used, self_cmp=True)
        ivs = iv.get(0, np.zeros((0, 2), np.int64))
        masked = report_iv.mask_codes(codes, iv.get(0))
        out[shape] = (frag, {
            "fragments": int(frag["xStart"].shape[0]),
            "intervals": int(ivs.shape[0]),
            "masked_bp": int((masked == 4).sum() - (codes == 4).sum())})
        print(f"config #4 on a {shape} mesh: {out[shape][1]} "
              f"({dt:.3f} s with compile)", flush=True)
    (f4, c4), (f1, c1) = out[(2, 2)], out[(1, 1)]
    keys = list(orc.FRAG_FIELDS) + ["group"]
    bad = [k for k in keys if not np.array_equal(f4[k], f1[k])]
    check(not bad and c4 == c1,
          f"(2, 2) mesh differs from (1, 1): fields {bad}, {c4} vs {c1}")
    if counts is not None:
        check(c4 == counts, f"config #4 counts {c4}, recorded {counts}")
    print("config #4: (2, 2) mesh bit-identical to (1, 1)"
          + (", recorded counts reproduced" if counts else ""), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded four-card phase")
    args = ap.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"device_kind: {devs[0].device_kind}; jax {jax.__version__}; "
          f"{len(devs)} device(s)", flush=True)
    from repkiller_tpu.utils.runtime import setup_compile_cache
    print(f"compile cache: {setup_compile_cache()}", flush=True)

    if args.cards == 4:
        check(len(devs) >= 4, f"--cards 4 needs 4 GPUs, found {len(devs)}")
        phase_four_cards(devs[:4])
    else:
        for phase in (phase_parity, phase_kernel, phase_gpu_tests,
                      phase_main_path):
            t0 = time.perf_counter()
            phase()
            print(f"{phase.__name__}: {time.perf_counter() - t0:.3f} s",
                  flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
