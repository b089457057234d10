"""Cross-host result assembly (SURVEY.md §3.4 final step: "host 0 writes
outputs (multihost_utils.process_allgather)").

In the sharded pipeline every fragment-table column comes out of the jit
replicated across the mesh, so single-host runs need nothing here. With
multiple processes (one per host), each host holds the full replicated
table too — XLA's collectives already merged it — but only
process 0 should touch the filesystem. These helpers make that explicit
and give a fallback gather for arrays that are NOT replicated (e.g.
per-host window blocks in a future physically-sharded index build).
"""

from __future__ import annotations

from typing import Dict

import jax
import numpy as np


def is_output_host() -> bool:
    """True on the process that writes files (process 0)."""
    return jax.process_index() == 0


def gather_fragments(frag: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Gather per-process fragment blocks to every host.

    No-op single-process. Multi-process: concatenates each column across
    processes (jax.experimental.multihost_utils.process_allgather), then
    re-sorts into the canonical total order so the result is identical on
    every host regardless of process count — the §4.5 determinism rule.
    """
    if jax.process_count() == 1:
        return frag
    from jax.experimental import multihost_utils
    from ..oracle import pipeline as orc

    # Per-host blocks are ragged (window/row counts differ per host) but
    # gloo/XLA collectives need uniform shapes and a globally consistent
    # issue order: exchange counts first, pad every column to the max,
    # gather in sorted-key order, then strip each host's padding.
    keys = sorted(frag)
    n_local = int(frag[keys[0]].shape[0]) if keys else 0
    counts = np.asarray(
        multihost_utils.process_allgather(np.int64(n_local))).reshape(-1)
    n_max = int(counts.max()) if counts.size else 0
    gathered = {}
    for k in keys:
        v = np.asarray(frag[k])
        pad = np.zeros(n_max - v.shape[0], dtype=v.dtype)
        g = np.asarray(multihost_utils.process_allgather(
            np.concatenate([v, pad]), tiled=False))
        gathered[k] = np.concatenate(
            [g[i, : counts[i]] for i in range(counts.shape[0])])
    return orc.canonical_sort(gathered)


def write_on_host0(write_fn, *args, **kw):
    """Run a writer callable only on process 0; barrier afterwards so no
    process races ahead of the files being complete. The barrier runs even
    when the writer raises — otherwise the other ranks would block forever
    in sync_global_devices (no timeout) instead of seeing process 0 die."""
    try:
        if is_output_host():
            write_fn(*args, **kw)
    finally:
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices("repkiller_tpu_write_barrier")
