"""repkiller-tpu: GPU repeat-detection engine in JAX.

Brand-new framework with the capabilities of estebanpw/repkiller (see
SURVEY.md; the reference mount was empty, so parity targets come from
BASELINE.json). Public API: :func:`repkiller_tpu.api.compare`.
"""

from .config import Config, DEFAULT

__version__ = "0.1.0"


def compare(*args, **kw):
    """Convenience alias for :func:`repkiller_tpu.api.compare` (lazy import
    so `import repkiller_tpu` stays light)."""
    from . import api
    return api.compare(*args, **kw)


__all__ = ["Config", "DEFAULT", "compare", "__version__"]
