#!/usr/bin/env python
"""Weak-scaling PROXY on the virtual CPU mesh.

The BASELINE.json north star (>=90% weak-scaling efficiency to 2 hosts)
needs two hosts. This script records the closest proxy one machine can
give: a dedicated small sharded program (_weak_worker.py,
compare_sharded — the same program shape the dist test suite compiles in
seconds on CPU) run as 1 process vs 2 REAL OS processes with gloo CPU
collectives (1 device each), sizes scaled weakly (constant bp AND
constant planted-repeat work per device). The number is NOT hardware
efficiency — CPU "devices" are host threads and gloo is loopback TCP,
both slower relative to compute than a real interconnect — but it
exercises the exact dispatch structure (jax.distributed init, global
mesh, XLA collectives, replicated gather) that a multi-host run uses,
and regressions in collective volume show up in it.

Each leg is bounded (--timeout, default 600 s); on timeout the
per-device size HALVES and both legs rerun (--min-bp floors the
halving), so the harness always finishes with either a number or a
named failure. One persistent compile cache (.jax_cache) is shared by
every leg.

Prints one JSONL record:
  {"config": "weak_scaling_proxy_cpu", "per_device_bp": N,
   "bp_per_s_1dev": ..., "bp_per_s_2dev": ..., "efficiency": ...,
   "caveat": "virtual CPU mesh + gloo loopback, not GPU hardware"}
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_weak_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(cmd):
    env = os.environ.copy()
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    return subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _parse(stdout: str) -> dict:
    for line in stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if "bp_per_s" in rec:
            return rec
    raise SystemExit(f"no bp_per_s record in worker output:\n{stdout}")


def _pin(i: int):
    """One core per worker process: without pinning the 1-proc leg would
    use every core for XLA intra-op threads while the 2-proc leg gets one
    core per rank, biasing efficiency downward on this 2-core host."""
    ncpu = os.cpu_count() or 1
    return ["taskset", "-c", str(i % ncpu)]


def _leg(n_proc: int, per_device_bp: int, runs: int, timeout: int):
    """Run one leg; returns the worker record or None on timeout."""
    base = [sys.executable, WORKER, "--per-device-bp", str(per_device_bp),
            "--runs", str(runs)]
    if n_proc > 1:
        port = _free_port()
        base += ["--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(n_proc)]
        procs = [_run(_pin(i) + base + ["--process-id", str(i)])
                 for i in range(n_proc)]
    else:
        procs = [_run(_pin(0) + base)]
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            left = timeout - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(1, left)))
    except subprocess.TimeoutExpired:
        for p in procs:                    # no orphaned CPU burners
            if p.poll() is None:
                p.kill()
                p.communicate()
        print(f"# {n_proc}-proc leg at {per_device_bp} bp/device timed out "
              f"after {timeout}s", file=sys.stderr)
        return None
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise SystemExit(f"{n_proc}-proc leg failed rc={p.returncode}\n"
                             f"{err}")
    rec = _parse(outs[0][0])
    print(f"# {n_proc}-proc done in {time.perf_counter()-t0:.0f}s: "
          f"{rec['bp_per_s']:.0f} bp/s ({rec['fragments']} fragments, "
          f"run {rec['run_s']}s, warmup {rec['warmup_s']}s)",
          file=sys.stderr)
    return rec


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device-bp", type=int, default=150_000)
    ap.add_argument("--min-bp", type=int, default=30_000)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--timeout", type=int, default=600,
                    help="per-leg bound (seconds); a timeout halves the "
                         "size and reruns both legs")
    args = ap.parse_args()

    bp = args.per_device_bp
    while True:
        r1 = _leg(1, bp, args.runs, args.timeout)
        r2 = _leg(2, bp, args.runs, args.timeout) if r1 else None
        if r1 and r2:
            break
        bp //= 2
        if bp < args.min_bp:
            raise SystemExit(f"no size >= {args.min_bp} bp/device fits the "
                             f"{args.timeout}s leg bound")
        print(f"# halving to {bp} bp/device", file=sys.stderr)

    # weak scaling: the 2-device leg carries 2x the bp, so efficiency is
    # (2-dev throughput) / (2 * 1-dev throughput)
    eff = r2["bp_per_s"] / (2 * r1["bp_per_s"])
    print(json.dumps({
        "config": "weak_scaling_proxy_cpu",
        "per_device_bp": bp,
        "bp_per_s_1dev": r1["bp_per_s"],
        "bp_per_s_2dev": r2["bp_per_s"],
        "efficiency": round(eff, 3),
        "caveat": "virtual CPU mesh + gloo loopback, not GPU hardware",
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
