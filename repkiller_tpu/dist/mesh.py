"""Device-mesh construction (SURVEY.md §2.3, §3.4).

One mesh, two axes:

- ``"data"``  — query windows of the X genome stream, data-parallel
  (SURVEY.md §2.3 "Data parallel": window w owns seed start positions
  [w*win, (w+1)*win)).
- ``"shard"`` — k-mer hash-prefix shards of the Y index (SURVEY.md §2.3
  '"Tensor"-style sharding': shard s owns k-mers whose top bits equal s,
  so every k-mer's whole occurrence run lives in exactly one shard and
  per-shard hit sets partition the global hit set).

The reference has no distributed runtime at all (single node, out-of-core
to disk — SURVEY.md §2.3); this layer is the scaling story: XLA
collectives (NCCL between GPUs), every card reaching every other over
NVLink, so the mesh shape follows the algorithm alone.

Multi-host entry: call :func:`init_distributed` once per process before
building a mesh; it wires `jax.distributed.initialize` so
``jax.devices()`` spans all hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
SHARD_AXIS = "shard"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (SURVEY.md §3.5): one process per host.

    No-op for single-process runs; with arguments (or the JAX_COORDINATOR
    env conventions) it initialises the XLA distributed runtime so the
    mesh below spans every host's devices.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(n_data: Optional[int] = None, n_shard: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over `devices` (default: all) with axes (data, shard).

    n_shard must be a power of two (k-mer prefix ownership); defaults to
    the largest power of two <= sqrt(n_devices) so both axes scale.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if n_shard is None and n_data is None:
        n_shard = 1 << (max(1, int(np.sqrt(n))).bit_length() - 1)
        n_data = n // n_shard
    elif n_shard is None:
        n_shard = n // n_data
    elif n_data is None:
        n_data = n // n_shard
    if n_data * n_shard > n:
        raise ValueError(f"{n_data}x{n_shard} mesh > {n} devices")
    devs = devs[: n_data * n_shard]   # sub-mesh on the leading devices is fine
    if n_shard & (n_shard - 1):
        raise ValueError(f"n_shard must be a power of two, got {n_shard}")
    arr = np.asarray(devs, dtype=object).reshape(n_data, n_shard)
    return Mesh(arr, (DATA_AXIS, SHARD_AXIS))
