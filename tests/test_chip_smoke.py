"""chip_smoke.py must refuse to run anywhere but on a GPU: with JAX on the
CPU, and in a directory that holds the script and nothing else of the
repository, it exits non-zero and prints no result line."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_fails_on_cpu_naming_the_platform():
    out = _run(REPO)
    assert out.returncode != 0
    assert "platform 'cpu'" in out.stderr
    assert '"ok"' not in out.stdout


def test_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
