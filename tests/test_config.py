"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when set, else a fixed
directory inside the checkout."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROBE = "from neutfem_jax import config; print(config.compile_cache_dir())"


def _run(env_update):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_update)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_default_cache_dir_is_fixed_in_checkout():
    from neutfem_jax import config

    assert config.DEFAULT_CACHE_DIR == ROOT / ".jax_cache"
    assert _run({"JAX_PLATFORMS": "cpu"}) == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_cache_dir_env_is_honoured(tmp_path):
    assert _run({"JAX_PLATFORMS": "cpu",
                 "JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)
