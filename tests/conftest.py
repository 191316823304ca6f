"""Test harness configuration.

The suite is CPU-runnable by design (the reference's tests required a real
GPU — SURVEY.md §4 flags that as a weakness to fix): unless
``JAX_PLATFORMS`` is already set, we force the JAX CPU backend with 8
virtual devices so the multi-device paths compile and run without cards,
and we enable x64 so the float64/complex128 paths are exercised.

Tests that need a GPU carry the ``gpu`` marker and the ``gpu_device``
fixture, which skips them elsewhere; run them on a card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.

``PYFFT_TPU_NO_CACHE`` keeps the suite from writing a persistent
compilation cache into the checkout; tests/test_cache.py covers the cache.
"""

import os

import pytest

os.environ.setdefault("PYFFT_TPU_NO_CACHE", "1")
if "JAX_PLATFORMS" not in os.environ:
    os.environ["JAX_PLATFORMS"] = "cpu"
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
