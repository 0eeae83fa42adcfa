"""chip_smoke.py refuses to run without a GPU or outside a checkout: it
exits non-zero and prints no result line."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, env=env, timeout=120,
                          cwd=os.path.dirname(script))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert not os.path.exists(os.path.join(os.path.dirname(script),
                                           ".smoke_work", "single"))
