"""Test env: an 8-device virtual CPU mesh (SURVEY.md §4 rebuild test
plan). The default suite never touches an accelerator.

Two traps handled here:
- JAX_PLATFORMS may be preset in the environment, so we hard-override
  the env var for child processes; and
- the autoloaded jaxtyping pytest plugin imports jax BEFORE this
  conftest, freezing the env-derived config default — so we must also
  update the live jax config, not just the env var.

Tests that need the GPU carry the `gpu` marker and the `gpu` fixture,
which skips them on any other platform. They run on the card with

    DAGCON_TEST_PLATFORM=gpu python -m pytest -m gpu tests/

which leaves the platform to JAX instead of pinning the CPU."""

import os

import pytest

ON_GPU_RUN = os.environ.get("DAGCON_TEST_PLATFORM") == "gpu"

if not ON_GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402  (after env setup on purpose)

if not ON_GPU_RUN:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", "tests must run on CPU devices"
    assert len(jax.devices()) == 8, "tests expect an 8-device virtual CPU mesh"


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: DAGCON_TEST_PLATFORM=gpu "
            "python -m pytest -m gpu tests/"
        )
