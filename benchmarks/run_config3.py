#!/usr/bin/env python
"""BASELINE config #3: pairwise E. coli strain comparison — two-genome
seed index, cross-hits only (no self-hit filtering path). Strain B is
derived from strain A by SNPs, indel blocks, and segment rearrangement,
the divergence profile of real strain pairs."""

from common import jax_setup, std_args, run_timed


def make_strain_pair(size: int, seed: int):
    import numpy as np
    from repkiller_tpu.utils import synth
    g = synth.plant(size, [(1024, 5, 0.02, 1), (512, 6, 0.0, 2)], seed=seed)
    a = g.codes
    rng = np.random.default_rng(seed + 1)
    b = a.copy()
    snp = rng.random(b.shape[0]) < 0.01
    b[snp] = (b[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    # segment swap (rearrangement) + an insertion-like block
    q = size // 4
    b = np.concatenate([b[q : 2 * q], b[:q], b[2 * q :]])
    ins = rng.integers(0, 4, 5000).astype(np.uint8)
    b = np.concatenate([b[: size // 2], ins, b[size // 2 :]])
    return a, b


def main():
    ap = std_args(__doc__, default_size=4_600_000)
    ap.add_argument("--backend", choices=("device", "streamed"),
                    default="device",
                    help="streamed: windowed driver with per-window "
                         "capacities (hit arrays 4x smaller than the 2^23 "
                         "whole-genome join program's)")
    args = ap.parse_args()
    jax_setup(args.platform)
    from repkiller_tpu.config import Config
    from repkiller_tpu import device

    size = int(args.size * args.scale)
    a, b = make_strain_pair(size, seed=77)
    # near-identical strain pair: the shared backbone alone contributes
    # ~5.4M forward hits at this scale (the 2^20 default overflows — the
    # exact-count capacity check catches it rather than truncating)
    # seeds: SNPs/indels fracture the backbone into many short diagonals,
    # so thinning keeps ~1.1M forward seeds at 4.6 Mbp (measured; the
    # seed_capacity check catches the 2^20 guess). 2^21 holds them while
    # keeping the extension wrapper ops 4x smaller than the hit arrays;
    # coverage gating then skips the redundant backbone seeds before the
    # full-depth phase (chain/diagonal.py)
    if args.backend == "streamed":
        from repkiller_tpu.dist.windows import compare_streamed
        cfg = Config(k=12, strands="fr", extend_mode="banded",
                     hit_capacity=1 << 21, seed_capacity=1 << 19,
                     max_extend=2048, window=1 << 20)
        run_timed("ecoli_pair_cross_streamed",
                  lambda c: compare_streamed(a, b, c), args.runs,
                  a.shape[0] + b.shape[0], cfg=cfg)
    else:
        cfg = Config(k=12, strands="fr", extend_mode="banded",
                     hit_capacity=1 << 23, seed_capacity=1 << 21,
                     max_extend=2048)
        run_timed("ecoli_pair_cross",
                  lambda c: device.compare(a, b, c), args.runs,
                  a.shape[0] + b.shape[0], cfg=cfg)


if __name__ == "__main__":
    main()
