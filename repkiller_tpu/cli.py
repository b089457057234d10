"""Command-line driver (SURVEY.md §1 L6, §5 "Config/flag system").

Subcommands:

  run    full pipeline: FASTA (self or pair) -> fragments CSV, family
         summary, repeat intervals BED, optional masked FASTA
  group  repkiller proper: fragments CSV in -> family-annotated CSV +
         summary + intervals (the reference tool's own entry point)

Flags map 1:1 onto Config fields; `--profile DIR` wraps the run in a
jax.profiler trace (SURVEY.md §5 tracing row).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time

import numpy as np

from .config import Config, DEFAULT
from .utils.capacity import grow_capacity as _grow_capacity
from . import api

log = logging.getLogger("repkiller_tpu")


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(Config):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "str" or isinstance(f.default, str):
            p.add_argument(flag, type=str, default=f.default)
        elif isinstance(f.default, bool):
            p.add_argument(flag, type=int, default=int(f.default))
        elif isinstance(f.default, float):
            p.add_argument(flag, type=float, default=f.default)
        else:
            p.add_argument(flag, type=int, default=f.default)


def _config_from_args(args: argparse.Namespace) -> Config:
    kw = {}
    for f in dataclasses.fields(Config):
        kw[f.name] = getattr(args, f.name)
    return Config(**kw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repkiller-tpu",
        description="Repeat detection on the GPU in JAX (capabilities of estebanpw/repkiller)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="full comparison pipeline")
    pr.add_argument("fasta_x", help="query FASTA (or '-' for stdin)")
    pr.add_argument("fasta_y", nargs="?", default=None,
                    help="optional second FASTA; omitted = self-comparison")
    pr.add_argument("-o", "--out-prefix", default="out",
                    help="output file prefix")
    pr.add_argument("--backend", choices=("device", "sharded", "oracle"),
                    default="device")
    pr.add_argument("--mask", action="store_true",
                    help="also write <prefix>.masked.fasta")
    pr.add_argument("--coords", choices=("concat", "record"),
                    default="concat",
                    help="fragment CSV coordinate space for multi-record "
                         "inputs: concatenated (round-trip canonical) or "
                         "record-local (per-chromosome, GECKO-consumer "
                         "dialect)")
    pr.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace to DIR")
    pr.add_argument("--metrics-json", default=None,
                    help="append a JSONL metrics record here")
    pr.add_argument("--keep-intermediates", default=None, metavar="DIR",
                    help="dump each stage's arrays to DIR; a rerun with "
                         "identical inputs resumes from the last completed "
                         "stage (device backend)")
    pr.add_argument("--auto-capacity", type=int, default=0, metavar="N",
                    help="on capacity overflow, double the offending "
                         "capacity (hit/seed/shard slack) and retry, up to "
                         "N times — each retry recompiles at the new static "
                         "shape. 0 = fail fast with the measured counts")
    pr.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="run the comparison N times in this process (runs "
                         "after the first reuse the compiled programs); "
                         "the metrics record lists every wall")
    pr.add_argument("--stage-timing", action="store_true",
                    help="also run the pipeline stage-by-stage and print "
                         "per-stage JSONL timings (forward strand)")
    # Multi-host launch (SURVEY.md §3.4): one process per host, same
    # command on every host with a distinct --process-id. Process 0 writes
    # the outputs (dist.merge.write_on_host0); the fragment table itself is
    # already globally merged by the in-jit all-gather.
    pr.add_argument("--num-processes", type=int, default=1,
                    help="total processes in the multi-host run")
    pr.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (required if --num-processes>1)")
    pr.add_argument("--coordinator", default="127.0.0.1:29477",
                    help="rank-0 coordinator address host:port")
    pr.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. 'cpu' for the virtual-"
                         "device harness) before the backend initialises")
    pr.add_argument("--host-devices", type=int, default=None,
                    help="virtual device count per host (cpu platform only; "
                         "appends xla_force_host_platform_device_count)")
    _add_config_flags(pr)

    pg = sub.add_parser("group", help="cluster an existing fragments CSV")
    pg.add_argument("frags_csv")
    pg.add_argument("-o", "--out-prefix", default="grouped")
    pg.add_argument("--cross", action="store_true",
                    help="fragments come from a two-genome comparison")
    _add_config_flags(pg)
    return p


def _init_runtime(args: argparse.Namespace) -> None:
    """Platform/device-count overrides, the compile cache and multi-host
    bring-up. Must run before the first jax backend use."""
    import os
    import re
    if args.host_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        opt = f"--xla_force_host_platform_device_count={args.host_devices}"
        if "xla_force_host_platform_device_count" in flags:
            # replace an existing value rather than silently keeping it
            new = re.sub(r"--xla_force_host_platform_device_count=\d+",
                         opt, flags)
            if new != flags:
                log.warning("XLA_FLAGS already set a host device count; "
                            "replacing it with --host-devices=%d",
                            args.host_devices)
            os.environ["XLA_FLAGS"] = new
        else:
            os.environ["XLA_FLAGS"] = (flags + " " + opt).strip()
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from .utils.runtime import setup_compile_cache
    setup_compile_cache()
    if args.num_processes > 1:
        if args.process_id is None:
            raise SystemExit("--process-id is required with --num-processes")
        if args.backend != "sharded":
            raise SystemExit("--num-processes>1 requires --backend sharded")
        if args.fasta_x == "-":
            # each rank would read its own stdin; launchers feed only rank
            # 0, so the ranks would silently build DIFFERENT "replicated"
            # inputs — refuse instead
            raise SystemExit("stdin input ('-') is not supported with "
                             "--num-processes>1; pass a file path visible "
                             "to every rank")
        if args.platform == "cpu":
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        from .dist.mesh import init_distributed
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id)


def cmd_run(args: argparse.Namespace) -> int:
    cfg = _config_from_args(args)
    _init_runtime(args)
    src_x = sys.stdin.read() if args.fasta_x == "-" else args.fasta_x
    profile_ctx = None
    if args.profile:
        import jax
        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()
    walls = []
    try:
        for _ in range(max(args.repeat, 1)):
            t0 = time.perf_counter()
            for attempt in range(args.auto_capacity + 1):
                try:
                    res = api.compare(
                        src_x, args.fasta_y, cfg, backend=args.backend,
                        keep_intermediates=args.keep_intermediates)
                    break
                except ValueError as e:
                    grown = _grow_capacity(cfg, str(e))
                    if grown is None or attempt == args.auto_capacity:
                        raise
                    log.warning("%s — retrying with %s (attempt %d/%d)",
                                e, grown[1], attempt + 1,
                                args.auto_capacity)
                    cfg = grown[0]
            walls.append(time.perf_counter() - t0)
    finally:
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
    dt = walls[0]

    from .dist.merge import is_output_host, write_on_host0

    prefix = args.out_prefix

    def _write_all():
        res.write_csv(prefix + ".frags.csv", coords=args.coords)
        res.write_family_summary(prefix + ".families.csv")
        res.write_intervals(prefix + ".repeats.bed")
        if args.mask:
            with open(prefix + ".masked.fasta", "w") as f:
                f.write(res.masked_fasta())

    write_on_host0(_write_all)

    if args.stage_timing:
        from .utils.metrics import profile_stages
        profile_stages(res.x.codes,
                       None if res.self_cmp else res.y.codes, cfg,
                       emit=print)

    bp = res.x.total_length + (0 if res.self_cmp else res.y.total_length)
    metrics = {
        "stage": "run", "wall_s": round(dt, 4), "bp": bp,
        "bp_per_s": round(bp / dt, 1),
        "fragments": res.n_fragments, "families": res.n_families,
        "backend": args.backend,
    }
    if len(walls) > 1:
        metrics["walls_s"] = [round(w, 4) for w in walls]
    log.info("run: %s", metrics)
    if is_output_host():
        print(json.dumps(metrics))
        if args.metrics_json:
            with open(args.metrics_json, "a") as f:
                f.write(json.dumps(metrics) + "\n")
    return 0


def cmd_group(args: argparse.Namespace) -> int:
    cfg = _config_from_args(args)
    frag = api.group_fragments(args.frags_csv, cfg, self_cmp=not args.cross)
    from .report import csv_writer, intervals as report_iv

    prefix = args.out_prefix
    csv_writer.write_frags_csv(frag, prefix + ".frags.csv")
    report_iv.write_family_summary(frag, prefix + ".families.csv")
    report_iv.write_intervals_bed(frag, cfg, prefix + ".repeats.bed",
                                  self_cmp=not args.cross)
    n_fam = int(np.unique(frag["group"]).shape[0]) if frag["xStart"].shape[0] else 0
    print(json.dumps({"stage": "group", "fragments": int(frag["xStart"].shape[0]),
                      "families": n_fam}))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "group":
        return cmd_group(args)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
