"""uint64 layouts must refuse to run without x64 (silent truncation trap)."""

import pathlib
import subprocess
import sys


def test_u64_without_x64_raises():
    repo = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import jax.numpy as jnp\n"
        "from pint_jax import PackedLayout\n"
        "from pint_jax.ops import word as W\n"
        "lay = PackedLayout(*([8]*8))\n"
        "try:\n"
        "    W.pack(lay, *[jnp.asarray(i) for i in range(8)])\n"
        "except RuntimeError as e:\n"
        "    assert 'x64' in str(e)\n"
        "    print('GUARD OK')\n"
        "else:\n"
        "    print('NO GUARD')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env={
            "PYTHONPATH": str(repo),
            "PATH": "/usr/bin:/bin:/usr/local/bin",
            "JAX_PLATFORMS": "cpu",
            "HOME": "/tmp",
        },
        timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "GUARD OK" in out.stdout
