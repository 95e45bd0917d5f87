import os

import pytest

# 8 virtual CPU devices for multi-chip sharding tests; must be set before jax
# import. Tests run on the host CPU; only an explicit JAX_PLATFORMS=cuda
# selects the card (the `gpu`-marked tests: JAX_PLATFORMS=cuda python -m
# pytest -m gpu tests/).
if os.environ.get("JAX_PLATFORMS") not in ("cuda", "gpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

# jax may already have been imported before this conftest runs, so set the
# live config too, not only the environment.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at collection time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
