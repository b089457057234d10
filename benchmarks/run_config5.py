#!/usr/bin/env python
"""BASELINE config #5: human-chr1-scale self-comparison streamed
data-parallel across N>=2 hosts with interval merge.

Multi-host bring-up: run one process per HOST (never several on one
card — each JAX process reserves most of a card's memory) with
  --coordinator host0:port --num-processes N --process-id i
(wires jax.distributed.initialize via dist.mesh.init_distributed; the
mesh then spans every host's devices and the SAME sharded program runs —
XLA routes the stage-A gathers over NVLink within a host and the
network across hosts).
Single-process runs use all local devices; weak-scaling efficiency is
reported as (bp/s at N devices) / (N * bp/s at 1 device) when --baseline
is passed."""

import json

from common import jax_setup, std_args, run_timed


def main():
    ap = std_args(__doc__, default_size=248_000_000)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--baseline", type=float, default=None,
                    help="1-device bp/s for weak-scaling efficiency")
    args = ap.parse_args()
    jax = jax_setup(args.platform)
    from repkiller_tpu.config import Config
    from repkiller_tpu.dist.mesh import init_distributed, make_mesh
    from repkiller_tpu.dist.sharded import compare_sharded
    from repkiller_tpu.utils import synth

    if (args.num_processes or 1) > 1 and args.platform == "cpu":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    init_distributed(args.coordinator, args.num_processes, args.process_id)

    size = int(args.size * args.scale)
    fams = [(6000, 8, 0.10, 3),          # L1-like
            (300, 40, 0.12, 10),         # Alu-like
            (1024, 10, 0.05, 3)]
    g = synth.plant(size, fams, seed=1)
    cfg = Config(k=16, strands="fr", extend_mode="banded",
                 hit_capacity=1 << 21, max_extend=2048)
    mesh = make_mesh()
    out, rec = run_timed("human_chr1_multihost",
                         lambda c: compare_sharded(g.codes, None, c, mesh),
                         args.runs, size, cfg=cfg)
    n_dev = jax.device_count()
    eff = (rec["bp_per_s"] / (n_dev * args.baseline)
           if args.baseline else None)
    print(json.dumps({"config": "human_chr1_multihost",
                      "devices": n_dev,
                      "processes": jax.process_count(),
                      "weak_scaling_efficiency": round(eff, 3) if eff else None}))


if __name__ == "__main__":
    main()
