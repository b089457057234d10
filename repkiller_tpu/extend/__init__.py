"""Seed extension kernels (SURVEY.md §1 L3): ungapped x-drop (chunked
lax.while_loop in XLA), banded affine-gap Gotoh (XLA wavefront, and a
Pallas kernel for the GPU — bit-identical, selected by
Config.banded_impl)."""

from __future__ import annotations

import jax

from ..config import Config

# Import the kernel modules EAGERLY. A lazy import inside extend_dispatch
# would execute during jit tracing, and module-level jnp constants (e.g.
# ungapped.NEG_INF) would then be created as leaked tracers — captured as
# un-suppliable jaxpr consts, breaking every later trace in the process
# ("Execution supplied 9 buffers but compiled program expected 11").
from . import ungapped as _ungapped                  # noqa: E402
from . import banded_xla as _banded_xla              # noqa: E402
from . import banded_pallas as _banded_pallas        # noqa: E402
from .ungapped import extend_ungapped                # noqa: F401
from .banded_xla import extend_banded                # noqa: F401
from .banded_pallas import extend_banded_pallas      # noqa: F401


def banded_impl(cfg: Config) -> str:
    """Resolve Config.banded_impl: "auto" takes the Pallas kernel on the
    GPU and the XLA wavefront elsewhere."""
    if cfg.banded_impl == "auto":
        return "pallas" if jax.default_backend() == "gpu" else "xla"
    return cfg.banded_impl


def extend_dispatch(spx, spy, svalid, cx, cy, cfg: Config):
    """Extend seeds -> fragment dict; picks the configured kernel."""
    if cfg.extend_mode == "ungapped":
        return extend_ungapped(
            spx, spy, svalid, cx, cy,
            k=cfg.k, match=cfg.match, mismatch=cfg.mismatch,
            x_drop=cfg.x_drop, max_extend=cfg.max_extend,
        )
    impl = banded_impl(cfg)
    kw = dict(k=cfg.k, match=cfg.match, mismatch=cfg.mismatch,
              x_drop=cfg.x_drop, max_extend=cfg.max_extend,
              band=cfg.band, gap_open=cfg.gap_open, gap_extend=cfg.gap_extend)
    if impl in ("pallas", "pallas_interpret"):
        return extend_banded_pallas(spx, spy, svalid, cx, cy,
                                    interpret=impl == "pallas_interpret", **kw)
    return extend_banded(spx, spy, svalid, cx, cy, **kw)
