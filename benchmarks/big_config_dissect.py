#!/usr/bin/env python
"""Per-stage dissection of the big configs (#4 dmel-scale 48 Mbp, #5
chr1-scale 62 Mbp).

Two measurements on the SAME genome as the config scripts:

1. device.compare staged with per-stage walls (canonical self-join
   path) — where does the per-bp time go at 10x headline scale, and
   host clustering cost at the true output size;
2. compare_sharded (what run_config4/5 actually time on this 1-device
   environment) — the generic windowed-join path; the delta vs (1) is
   the cost of NOT having the canonical single-index trick in the
   sharded self-comparison path.

Every timed rep rolls the genome, and device.compare / compare_sharded
end with host fetches by construction. Prints JSONL records.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def genome(config: int, scale: float):
    import numpy as np
    from repkiller_tpu.utils import synth
    if config == 4:
        size = int(48_000_000 * scale)
        half = size // 2
        fams = [(7000, 5, 0.05, 2), (4100, 4, 0.08, 1), (359, 30, 0.06, 5),
                (1024, 8, 0.02, 2)]
        g2l = synth.plant(half, fams, seed=21)
        g2r = synth.plant(size - half, fams, seed=22)
        return np.concatenate([g2l.codes, np.array([4], np.uint8),
                               g2r.codes]), size
    if config == 5:
        size = int(248_000_000 * scale)
        fams = [(6000, 8, 0.10, 3), (300, 40, 0.12, 10), (1024, 10, 0.05, 3)]
        return synth.plant(size, fams, seed=1).codes, size
    raise SystemExit(f"unsupported config {config}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, choices=(4, 5), default=4)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="for config 5 pass 0.25 (the campaign scale)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--skip-sharded", action="store_true")
    args = ap.parse_args()

    from repkiller_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import numpy as np
    from repkiller_tpu.config import Config
    from repkiller_tpu import device
    from repkiller_tpu.dist.sharded import compare_sharded

    codes, size = genome(args.config, args.scale)
    cfg = Config(k=16, strands="fr", extend_mode="banded",
                 hit_capacity=1 << 20 if args.config == 4 else 1 << 21,
                 seed_capacity=1 << 19 if args.config == 4 else 1 << 21,
                 max_extend=2048)

    def rolled(r):
        return np.roll(codes, r) if r else codes

    # ---- staged device pipeline with per-stage walls ----
    t0 = time.perf_counter()
    timings = {}
    frag = device.compare(rolled(0), None, cfg, timings=timings)
    print(f"# staged warmup (compile+run): {time.perf_counter()-t0:.1f}s, "
          f"{frag['xStart'].shape[0]} fragments", file=sys.stderr)
    walls, cluster_s, n_frag = [], [], 0
    for r in range(args.reps):
        stage = {}
        t0 = time.perf_counter()
        frag = device.compare(rolled(1 + r), None, cfg, timings=stage)
        walls.append(time.perf_counter() - t0)
        # host clustering is inside device.compare but not a jitted
        # stage; recover it as total - sum(jitted stages)
        cluster_s.append(walls[-1] - sum(stage.values()))
        n_frag = int(frag["xStart"].shape[0])
        stage = {k: round(v, 3) for k, v in sorted(stage.items())}
        print(json.dumps({"config": args.config, "path": "device_staged",
                          "rep": r, "wall_s": round(walls[-1], 3),
                          "stages": stage,
                          "host_cluster_etc_s": round(cluster_s[-1], 3)}))
    best = min(walls)
    print(json.dumps({"config": args.config, "path": "device_staged",
                      "bp": size, "best_wall_s": round(best, 3),
                      "bp_per_s": round(size / best, 1),
                      "fragments": n_frag}))

    # ---- the sharded path the config scripts time ----
    if not args.skip_sharded:
        t0 = time.perf_counter()
        frag = compare_sharded(rolled(0), None, cfg)
        print(f"# sharded warmup: {time.perf_counter()-t0:.1f}s",
              file=sys.stderr)
        walls = []
        for r in range(args.reps):
            t0 = time.perf_counter()
            frag = compare_sharded(rolled(1 + r), None, cfg)
            walls.append(time.perf_counter() - t0)
        best = min(walls)
        print(json.dumps({"config": args.config, "path": "sharded",
                          "bp": size, "best_wall_s": round(best, 3),
                          "bp_per_s": round(size / best, 1),
                          "fragments": int(frag["xStart"].shape[0])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
