#!/usr/bin/env python
"""A/B the coverage-gating wrapper on the headline workload (perf tool):
times _stage_extend with gate_stride on vs off on identical seeds, and
reports anchor/survivor counts. Run on the GPU."""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1 << 22)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--hit-capacity", type=int, default=1 << 20)
    args = ap.parse_args()

    import jax
    from repkiller_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from repkiller_tpu.config import Config
    from repkiller_tpu.utils import synth
    from repkiller_tpu import device

    cfg = Config(k=12, strands="fr", extend_mode="banded",
                 hit_capacity=args.hit_capacity, max_extend=2048)
    fams = [(1024, 6, 0.02, 2), (768, 5, 0.05, 1), (512, 7, 0.0, 0),
            (1536, 3, 0.03, 1), (256, 8, 0.08, 2)]
    g = synth.plant(args.size, fams, seed=1234)
    codes = jax.device_put(jnp.asarray(g.codes), jax.devices()[0])

    seeds = device._stage_self_seeds(codes, cfg)
    jax.block_until_ready(seeds)
    spx, spy, sv, n_seeds, total = seeds[0]
    spx, spy, sv = map(np.asarray, (spx, spy, sv))
    n = int(n_seeds)
    diag = spx - spy
    bucket = spx // cfg.gate_stride
    prev_same = np.concatenate(
        [[False], (diag[1:] == diag[:-1]) & (bucket[1:] == bucket[:-1])])
    anchor = sv & ~prev_same
    print(f"# fwd strand: seeds {n}, anchors {int(anchor.sum())}",
          file=sys.stderr)

    spx_d, spy_d, sv_d, n_d = (seeds[0][0], seeds[0][1], seeds[0][2],
                               seeds[0][3])

    def timeit(name, cfg_v):
        # warm (compile)
        t0 = time.perf_counter()
        out = device._stage_extend(spx_d, spy_d, sv_d, n_d, codes, codes,
                                   cfg_v, 0)
        jax.block_until_ready(out)
        warm = time.perf_counter() - t0
        ts = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            out = device._stage_extend(spx_d, spy_d, sv_d, n_d, codes,
                                       codes, cfg_v, 0)
            jax.block_until_ready(out)
            ts.append(time.perf_counter() - t0)
        print(f"# {name}: warm {warm:.1f}s, runs "
              f"{['%.3f' % t for t in ts]} median "
              f"{statistics.median(ts):.3f}s", file=sys.stderr)
        return out

    o_on = timeit("gate 2048", cfg)
    o_off = timeit("gate 0", cfg.replace(gate_stride=0))
    fv_on = np.asarray(o_on[1])
    print(f"# extended (valid frag slots) gated: {int(fv_on.sum())} "
          f"vs ungated: {int(np.asarray(o_off[1]).sum())}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
