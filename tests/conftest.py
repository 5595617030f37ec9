import os

import pytest

# Tests run on a virtual 8-device CPU mesh with float64 enabled so we can
# check bitwise-tolerant parity against the (numpy float64) reference math.
# JAX_PLATFORMS defaults to cpu; the card-only tests (marker "gpu") run with
# JAX_PLATFORMS=cuda and skip everywhere else (see the `gpu` fixture).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU. Decided when the
    test runs, never at import, so every xdist worker collects the same
    tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
