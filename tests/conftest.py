"""Test harness configuration (SURVEY.md section 5).

The suite runs on the CPU with 8 emulated devices so the full shard_map
mesh / collective paths execute without an accelerator (SURVEY.md 5.4),
with x64 enabled so float64 oracles are exact.  Pallas kernels run in
interpret mode there.

Tests marked ``chip`` need an NVIDIA GPU: they skip on the CPU (through
the ``gpu`` fixture) and run with ``pytest --chip -m chip``, which leaves
JAX on its default (GPU) backend — ``chip_smoke.py`` does this in its
kernel phase.
"""

import os

import jax
import pytest


def pytest_addoption(parser):
    parser.addoption("--chip", action="store_true", default=False,
                     help="keep JAX on its default backend (a GPU) for the "
                          "tests marked 'chip'")


def pytest_configure(config):
    from spectrobot_tpu.cli import enable_compile_cache

    enable_compile_cache()
    if config.getoption("--chip"):
        return
    # Read when the CPU backend initialises (lazily) — not at jax import.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    assert jax.devices()[0].platform == "cpu", jax.devices()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test anywhere else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX's backend is {dev.platform}); "
                    f"run with `pytest --chip -m chip` on a GPU host")
    return dev


@pytest.fixture(scope="session")
def co2_lines():
    from spectrobot_tpu.data.synth import co2_15um_band
    return co2_15um_band(j_max=40)


@pytest.fixture(scope="session")
def mars_atm():
    from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
    return mars_standard_atmosphere(n_lev=41, z_top=80e3)
