#!/usr/bin/env python
"""Extension economics of config #1 on the GPU: the share of thinned
seeds whose banded DP still has live cells at each row cap (the survival
curve that sizes the two-phase extension's first pass), per strand and
direction. Runs the banded kernel at each cap on the config's real
seeds; needs a GPU. Prints one JSON line per (strand, direction)."""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CAPS = (16, 32, 64, 96, 128, 192, 256, 512, 1024, 2048)


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repkiller_tpu.utils.runtime import setup_compile_cache
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("extend_survival.py needs a GPU")
    setup_compile_cache()
    from chip_smoke import C1_FAMS, C1_SIZE, c1_config
    from repkiller_tpu import device
    from repkiller_tpu.extend import banded_pallas as bp
    from repkiller_tpu.utils import synth

    cfg = c1_config()
    dp = dict(match=cfg.match, mismatch=cfg.mismatch, x_drop=cfg.x_drop,
              band=cfg.band, gap_open=cfg.gap_open,
              gap_extend=cfg.gap_extend)
    codes = jnp.asarray(synth.plant(C1_SIZE, C1_FAMS, seed=1234).codes)
    seeds = device._stage_self_seeds(codes, cfg)
    for strand, (spx, spy, sv, n_seeds, _) in seeds.items():
        cy = codes if strand == 0 else device.revcomp_device(codes)
        n = int(n_seeds)
        for off, st in ((cfg.k, 1), (-1, -1)):
            alive = {}
            for cap in CAPS:
                *_, a = bp._direction(spx, spy, sv, codes, cy, off, st, cap,
                                      cap + cfg.band, dp, False)
                alive[cap] = int(np.asarray(a).sum())
            print(json.dumps({
                "strand": strand, "step": st, "seeds": n,
                "alive_at_row": alive,
                "share_alive": {c: alive[c] / n for c in CAPS},
                "device": jax.devices()[0].device_kind}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
