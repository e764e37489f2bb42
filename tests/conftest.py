"""Test configuration.

By default everything runs on the CPU, on a virtual 8-device mesh:
``--xla_force_host_platform_device_count=8`` gives the sharding tests the
same GSPMD partitioning and collective lowering paths as a multi-card
host, and Pallas kernels run in the interpreter (``interpret=True``).  x64
is enabled so uint64 word layouts (make_packed_int sums 33..64,
pint_test.cpp:82-87) are testable.

With ``PINT_GPU_TESTS=1`` (set by ``chip_smoke.py``, or by hand on a
machine with a GPU) the platform and x64 are left alone, so the tests
marked ``gpu`` run on the card.  Whether a card is present is decided by
the ``gpu`` fixture, never at import or collection time.
"""

import os

import pytest

_ON_CARD = os.environ.get("PINT_GPU_TESTS") == "1"

if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: run `python chip_smoke.py` on the card, or "
            "`PINT_GPU_TESTS=1 python -m pytest -m gpu tests/` there"
        )
    return jax.devices()[0]
