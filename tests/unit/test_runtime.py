"""Entry-point set-up: the compile-cache placement shared by the CLI,
chip_smoke.py and the benchmarks, and chip_smoke.py's refusal to run
without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_PROBE = """
import sys
sys.path.insert(0, {root!r})
import jax, jax.numpy as jnp
from repkiller_tpu.utils.runtime import setup_compile_cache
print(setup_compile_cache({checkout!r}))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()
"""


def _probe(tmp_path, env_dir):
    checkout = str(tmp_path / "checkout")
    os.makedirs(checkout)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c",
                        _PROBE.format(root=ROOT, checkout=checkout)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return checkout, r.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_checkout(tmp_path):
    checkout, used = _probe(tmp_path, None)
    want = os.path.join(checkout, ".jax_cache")
    assert used == want
    assert os.listdir(want), "no cache entries written"


def test_compile_cache_follows_env_variable(tmp_path):
    env_dir = str(tmp_path / "env_cache")
    checkout, used = _probe(tmp_path, env_dir)
    assert used == env_dir
    assert os.listdir(env_dir), "no cache entries written"
    assert not os.path.exists(os.path.join(checkout, ".jax_cache"))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No GPU (or no repository beside the script): non-zero exit and no
    JSON result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path)
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
