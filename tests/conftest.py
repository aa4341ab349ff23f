"""Test harness: run everything on the CPU with 8 virtual devices.

Multi-device sharding is validated without a cluster via XLA's
host-platform device emulation (SURVEY.md §4); the GPU kernel runs
through the Pallas interpreter. The platform is forced through
jax.config before any backend initializes, whatever JAX_PLATFORMS says.

Tests that need a real GPU carry the `gpu` marker and take the
`gpu_device` fixture, which skips them when JAX finds no GPU; they run
on a card with `JAX_PLATFORMS=cuda python -m pytest tests -m gpu`
(with TERA_TEST_GPU=1, which keeps this file off the CPU).
"""

import os

if not os.environ.get("TERA_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.pop("JAX_PLATFORMS", None)
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Tests compile thousands of tiny programs; keep them out of the
# persistent compilation cache that the CLI entry point turns on.
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided when the test runs, never at
    import, so every xdist worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a CUDA GPU")
    return gpus[0]
