"""Test env: the CPU backend with 8 virtual devices (SURVEY.md §4.4).

Both settings must be in the environment before jax is first imported,
so they are set here, at the top of the first module pytest loads. Tests
that need the card carry the ``gpu`` marker and skip on the CPU; on a GPU
host ``python chip_smoke.py`` runs them with JAX_PLATFORMS=cuda.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
