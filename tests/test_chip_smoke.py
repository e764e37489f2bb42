"""chip_smoke.py refuses to run without a GPU: it exits non-zero and prints
no result, from the checkout and from a directory that holds nothing else
of the repository."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PINT_GPU_TESTS", None)
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    proc = _run(tmp_path if alone else ROOT, script)
    assert proc.returncode != 0, proc.stdout
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr
