"""utils: profiling helpers (StageTimer, persistent compilation cache)."""

import os
import subprocess
import sys

from lidar_slam_arvc_tpu.utils.profiling import StageTimer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestStageTimer:
    def test_accumulates_and_reports(self):
        t = StageTimer()
        with t.stage("icp", items=8):
            pass
        with t.stage("icp", items=8):
            pass
        rep = t.report()
        assert rep["icp"]["items"] == 16
        assert rep["icp"]["seconds"] >= 0
        assert "icp" in str(t)

    def test_dump(self, tmp_path):
        t = StageTimer()
        with t.stage("load", items=2):
            pass
        p = tmp_path / "timing.json"
        t.dump(str(p))
        assert p.stat().st_size > 0


class TestCompilationCache:
    """setup_compile_cache, each case in a fresh interpreter: the cache
    directory is process-global JAX state."""

    _PROBE = (
        "import sys, jax, jax.numpy as jnp\n"
        "from lidar_slam_arvc_tpu.utils.profiling import setup_compile_cache\n"
        "path = setup_compile_cache()\n"
        "if sys.argv[1] == 'compile':\n"
        "    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "    jax.jit(lambda x: (x * 2.0 + 1.0).sum())(\n"
        "        jnp.arange(1111.0)).block_until_ready()\n"
        "print(path)\n"
        "print(jax.config.jax_compilation_cache_dir)\n")

    def _run(self, cache_env, action):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        if cache_env is not None:
            env["JAX_COMPILATION_CACHE_DIR"] = cache_env
        out = subprocess.run(
            [sys.executable, "-c", self._PROBE, action], env=env, cwd=_REPO,
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout.split()[-2:]

    def test_cache_dir_populated(self, tmp_path):
        # with the variable set, the cache lands exactly there
        cache = str(tmp_path / "xla_cache")
        path, configured = self._run(cache, "compile")
        assert path == configured == cache
        entries = [n for _, _, files in os.walk(cache) for n in files]
        assert entries, "compilation cache wrote no entries"

    def test_default_is_checkout_dir(self):
        path, configured = self._run(None, "configure")
        assert path == configured == os.path.join(_REPO, ".jax_cache")
