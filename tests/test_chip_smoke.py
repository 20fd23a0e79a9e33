"""chip_smoke.py must refuse to run, and print no result, without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_exits_nonzero_without_gpu(tmp_path, where):
    script = os.path.join(_REPO, "chip_smoke.py")
    if where == "alone":
        # a directory holding chip_smoke.py and nothing else of the repo
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
