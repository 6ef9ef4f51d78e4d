"""Test harness for spectralmc_tpu.

Policy differences from the reference's GPU-mandatory conftest
(``/root/reference/tests/conftest.py``): tests target the **CPU backend with
8 virtual devices** so the full multi-chip sharding surface is exercised
hermetically; the GPU path is exercised by ``chip_smoke.py`` and
``bench.py``. x64 is enabled so float64 determinism gates can run
(dtype-explicit library code keeps float32 paths float32).

Tests that need the GPU carry the ``card`` marker and the ``card`` fixture,
which skips them unless the backend is a GPU — decided when the test runs,
never at import. On a machine with a card they run with
``SPECTRALMC_CARD_TESTS=1 python -m pytest tests -m card`` (the variable
leaves the backend to JAX instead of pinning the CPU).
"""

from __future__ import annotations

import os

CARD_RUN = os.environ.get("SPECTRALMC_CARD_TESTS") == "1"

# Must happen before jax initializes a backend: the unit suite is hermetic
# on the CPU unless a card run was asked for.
if not CARD_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not CARD_RUN:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import signal  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Per-test wall-clock ceiling (parity: reference conftest.py:101-117 uses a
# SIGALRM 60 s default). CPU-backend first compiles are slower than the
# reference's warm GPU, so the default here is 120 s; override per test with
# ``@pytest.mark.timeout_s(N)``.
DEFAULT_TIMEOUT_S = 120


def pytest_configure(config: pytest.Config) -> None:
    config.addinivalue_line(
        "markers", "timeout_s(seconds): per-test wall-clock limit (SIGALRM) override"
    )


def pytest_sessionstart(session: pytest.Session) -> None:
    """Env preflight: the virtual 8-device CPU mesh must actually exist."""
    if CARD_RUN:
        return
    devices = jax.devices()
    if devices[0].platform != "cpu":
        raise RuntimeError(
            f"test suite must run on the CPU backend, got {devices[0].platform!r} "
            "(an accelerator plugin overrode jax_platforms?)"
        )
    if len(devices) < 8:
        raise RuntimeError(
            f"expected >= 8 virtual CPU devices, got {len(devices)} — "
            "xla_force_host_platform_device_count was not applied before jax init"
        )
    if not jax.config.jax_enable_x64:
        raise RuntimeError("x64 must be enabled for the float64 determinism gates")


@pytest.fixture
def card() -> None:
    """Skip unless JAX's backend is a GPU (see the module docstring)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: SPECTRALMC_CARD_TESTS=1 pytest -m card")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item: pytest.Item):
    marker = item.get_closest_marker("timeout_s")
    seconds = int(marker.args[0]) if marker else DEFAULT_TIMEOUT_S

    def _on_alarm(signum: int, frame: object) -> None:
        raise TimeoutError(f"test exceeded {seconds}s wall-clock limit (SIGALRM)")

    previous = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(seconds)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def seed_prngs() -> None:
    """Deterministic host PRNG per test (parity: reference conftest seeds 42)."""
    np.random.seed(42)


@pytest.fixture
def eight_device_mesh():
    import jax.sharding as shd

    devices = np.array(jax.devices()[:8]).reshape(8)
    return shd.Mesh(devices, axis_names=("paths",))
