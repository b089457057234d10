"""Shared harness for the five BASELINE.json benchmark configs.

Genomes are seeded synthetics at the scale of the named organisms (zero
egress — no real data in this environment; SURVEY.md §4.3): background
composition is uniform random, repeat content is planted with family
structure typical of the organism class. Each run prints a JSONL metrics
record (stage timings, bp, fragments, families, bp/s).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def jax_setup(platform=None):
    import jax
    from repkiller_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    if platform:
        jax.config.update("jax_platforms", platform)
    return jax


def std_args(desc: str, default_size: int):
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--size", type=int, default=default_size)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink factor for smoke runs (size *= scale)")
    return ap


def run_timed(tag: str, fn, runs: int, bp: int, cfg=None, retries=4):
    """Warmup (compile) + timed runs; prints one JSONL record.

    With cfg given, fn must take a Config and the warmup runs under
    with_auto_capacity (utils/capacity.py): an undersized first capacity
    guess doubles and retries instead of killing an unattended campaign
    (round-3 verdict item 7); the timed runs reuse the grown config and
    the record notes any growth.
    """
    from repkiller_tpu.utils.capacity import with_auto_capacity
    t0 = time.perf_counter()
    if cfg is not None:
        out, used_cfg = with_auto_capacity(fn, cfg, retries)
        call = lambda: fn(used_cfg)  # noqa: E731
        grown = {f: getattr(used_cfg, f)
                 for f in ("hit_capacity", "seed_capacity", "shard_slack")
                 if getattr(used_cfg, f) != getattr(cfg, f)}
    else:
        call = fn
        out, grown = fn(), {}
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(max(0, runs - 1) or 1):
        t0 = time.perf_counter()
        out = call()
        times.append(time.perf_counter() - t0)
    best = min(times)
    rec = {"config": tag, "bp": bp, "warmup_s": round(compile_s, 3),
           "run_s": round(best, 4), "bp_per_s": round(bp / best, 1),
           "fragments": int(out["xStart"].shape[0])}
    if grown:
        rec["auto_capacity_grown"] = grown
    print(json.dumps(rec))
    return out, rec
