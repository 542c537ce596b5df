"""The persistent compilation cache: JAX_COMPILATION_CACHE_DIR when it is
set, otherwise one fixed directory inside the checkout; XLA_FLAGS is left
as the caller set it.  Each case runs in a fresh interpreter, because the
cache directory is process-wide JAX state."""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = (
    "import json, os, jax\n"
    "from subread_tpu.utils.jaxenv import ensure_compile_cache\n"
    "d = ensure_compile_cache()\n"
    "print(json.dumps({'returned': d,\n"
    "                  'config': jax.config.jax_compilation_cache_dir,\n"
    "                  'xla_flags': os.environ.get('XLA_FLAGS')}))\n"
)


def _probe(cwd, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.update(env_over)
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cache_follows_env_var(tmp_path):
    want = str(tmp_path / "cache")
    got = _probe(tmp_path, JAX_COMPILATION_CACHE_DIR=want)
    assert got["config"] == want
    assert got["returned"] == want


def test_cache_default_is_fixed_in_checkout(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    first = _probe(tmp_path / "a")
    second = _probe(tmp_path / "b")
    assert first["config"] == str(REPO / ".jax_cache")
    assert second["config"] == first["config"] == first["returned"]


def test_cache_setup_leaves_xla_flags_alone(tmp_path):
    assert _probe(tmp_path)["xla_flags"] is None
    flags = "--xla_force_host_platform_device_count=2"
    assert _probe(tmp_path, XLA_FLAGS=flags)["xla_flags"] == flags
