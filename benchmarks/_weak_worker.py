#!/usr/bin/env python
"""Worker for the weak-scaling proxy (benchmarks/weak_scaling_proxy.py).

One OS process = one CPU "host" with ONE device; N workers form an
N-device global gloo mesh via jax.distributed. The workload is the
dedicated small sharded program (NOT config #5's full streamed program —
its per-process CPU compile alone blew the round-4 proxy's timeouts,
round-4 verdict weak item 4): compare_sharded on a genome built as
n_dev INDEPENDENT per-device blocks, so total seed/extend work scales
~linearly with devices (constant per device — the weak-scaling
contract; a single planted genome would keep hit counts constant as bp
double, since planted pairs depend on copy counts, not length).

Prints one JSONL record: {"bp_per_s": ..., "fragments": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# per-BLOCK (= per-device) planted repeat content; different block seeds
# give different unit sequences, so cross-block hits are background-rare
FAMS = [(300, 8, 0.03, 2), (150, 10, 0.02, 3), (500, 4, 0.05, 1)]
HIT_CAP_DEV = 1 << 16
SEED_CAP_DEV = 1 << 14


def weak_genome(per_device_bp: int, n_blocks: int):
    import numpy as np
    from repkiller_tpu.utils import synth
    # block seeds 1000 apart: synth.plant derives family-unit RNG seeds
    # as seed+100+fam_i, so adjacent block seeds would make block i's
    # family f+1 unit share an RNG stream (= a unit PREFIX) with block
    # i+1's family f — cross-block repeat families that grow total work
    # superlinearly in devices (observed: 334 fragments for 2 blocks vs
    # 90 for 1). Weak scaling needs per-device work ~constant.
    parts = [synth.plant(per_device_bp, FAMS, seed=1000 * (i + 1)).codes
             for i in range(n_blocks)]
    return np.concatenate(parts)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device-bp", type=int, required=True)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    import jax
    from repkiller_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    jax.config.update("jax_platforms", "cpu")   # before any backend init
    if args.num_processes > 1:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from repkiller_tpu.dist.mesh import init_distributed, make_mesh
    init_distributed(args.coordinator, args.num_processes, args.process_id)

    from repkiller_tpu.config import Config
    from repkiller_tpu.dist.sharded import compare_sharded

    n_dev = jax.device_count()
    codes = weak_genome(args.per_device_bp, n_dev)
    cfg = Config(k=14, strands="fr", extend_mode="banded", max_extend=512,
                 hit_capacity=HIT_CAP_DEV * n_dev,
                 seed_capacity=SEED_CAP_DEV * n_dev)
    mesh = make_mesh(n_dev, 1)   # data-parallel axis = the weak dimension

    t0 = time.perf_counter()
    out = compare_sharded(codes, None, cfg, mesh)
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        out = compare_sharded(codes, None, cfg, mesh)
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(json.dumps({
        "bp": int(codes.shape[0]), "devices": n_dev,
        "warmup_s": round(warmup_s, 2), "run_s": round(best, 3),
        "bp_per_s": round(codes.shape[0] / best, 1),
        "fragments": int(out["xStart"].shape[0]),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
