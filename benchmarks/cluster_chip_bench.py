#!/usr/bin/env python
"""Host vs on-device repeat-family clustering at BASELINE config scales
(the device path is opt-in; this times both).

Rebuilds the exact config-#2 (yeast-scale) or config-#4 (dmel-scale)
fragment table by running the production pipeline once (compile cache
shared with the campaign), then times cluster_families through both
paths. Each rep feeds a ROLLED fragment table (same geometry, different
fragment indices -> different device inputs and labels) and the labels
array is fetched to host. Host and device
labels are asserted equal on every rep (min-label fixpoint is
order-independent).

Prints one JSONL record per path: {"path": ..., "ms_per_call": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_frags(config: int, scale: float):
    import numpy as np
    from repkiller_tpu.config import Config
    from repkiller_tpu.utils import synth

    if config == 2:
        size = int(12_100_000 * scale)
        cfg = Config(k=16, strands="fr", extend_mode="banded",
                     hit_capacity=1 << 20, seed_capacity=1 << 19,
                     max_extend=2048)
        fams = [(5900, 4, 0.03, 1), (332, 12, 0.05, 3), (137, 20, 0.08, 0),
                (1024, 6, 0.01, 2)]
        g = synth.plant(size, fams, seed=4242)
        from repkiller_tpu import device
        frag = device.compare(g.codes, None, cfg)
    elif config == 4:
        size = int(48_000_000 * scale)
        half = size // 2
        fams = [(7000, 5, 0.05, 2), (4100, 4, 0.08, 1), (359, 30, 0.06, 5),
                (1024, 8, 0.02, 2)]
        g2l = synth.plant(half, fams, seed=21)
        g2r = synth.plant(size - half, fams, seed=22)
        codes = np.concatenate([g2l.codes, np.array([4], np.uint8),
                                g2r.codes])
        cfg = Config(k=16, strands="fr", extend_mode="banded",
                     hit_capacity=1 << 20, seed_capacity=1 << 19,
                     max_extend=2048)
        from repkiller_tpu.dist.sharded import compare_sharded
        frag = compare_sharded(codes, None, cfg)
    else:
        raise SystemExit(f"unsupported config {config}")
    return frag, cfg


def synthetic_pileups(n_loci: int, copies: int, seed: int = 5):
    """Dense repeat-pileup fragment table (the regime where the host
    path's np.minimum.at propagation goes superlinear — families/
    cluster.py's cost-curve comment: ~12 s at 3.3M edges): n_loci
    repeat loci, `copies` same-locus fragments each -> ~n_loci *
    copies^2/2 edges."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = n_loci * copies
    base = np.repeat(rng.integers(0, 1 << 27, n_loci), copies)
    jit_ = rng.integers(0, 8, n)
    xs = (base + jit_).astype(np.int32)
    ln = rng.integers(150, 170, n).astype(np.int32)
    ys = rng.integers(0, 1 << 27, n).astype(np.int32)
    frag = {
        "xStart": xs, "xEnd": xs + ln - 1,
        "yStart": ys, "yEnd": ys + ln - 1,
        "strand": np.zeros(n, np.int32), "length": ln,
        "score": ln * 4, "idents": ln,
    }
    order = np.lexsort((frag["yStart"], frag["xStart"], frag["strand"]))
    return {k: v[order] for k, v in frag.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, choices=(2, 4), default=2)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--synthetic", type=int, default=0, metavar="N_LOCI",
                    help="skip the pipeline; time both paths on a dense "
                         "synthetic pileup table (N_LOCI x 32 fragments)")
    args = ap.parse_args()

    from repkiller_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import numpy as np
    from repkiller_tpu.families import cluster

    t0 = time.perf_counter()
    if args.synthetic:
        from repkiller_tpu.config import Config
        frag, cfg = synthetic_pileups(args.synthetic, 32), Config()
        args.config = 0
    else:
        frag, cfg = build_frags(args.config, args.scale)
    n = frag["xStart"].shape[0]
    print(f"# table build: {time.perf_counter()-t0:.1f}s, {n} fragments",
          file=sys.stderr)
    frag.pop("group", None)

    def rolled(r):
        return {k: np.roll(v, r) for k, v in frag.items()}

    # edge count at this scale (decides whether production would even
    # take the device path)
    *_, total, _ = cluster._edge_ranges(frag, cfg, True)
    print(f"# edge total: {total}", file=sys.stderr)

    def run(path: str, device_min_edges):
        times, labs = [], []
        for r in range(args.reps):
            f = rolled(r)
            t0 = time.perf_counter()
            lab = cluster.cluster_families(
                f, cfg, True, device_min_edges=device_min_edges)
            assert lab.shape[0] == n          # np array: already fetched
            times.append(time.perf_counter() - t0)
            labs.append(lab)
        best = min(times[1:]) if len(times) > 1 else times[0]
        print(json.dumps({"config": args.config, "path": path,
                          "fragments": int(n), "edges": int(total),
                          "ms_per_call": round(best * 1e3, 1),
                          "all_s": [round(t, 3) for t in times]}))
        return labs

    host = run("host", device_min_edges=1 << 62)
    dev = run("device", device_min_edges=0)
    for r, (a, b) in enumerate(zip(host, dev)):
        assert np.array_equal(a, b), f"host/device labels differ at rep {r}"
    print("# host == device labels on every rep", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
