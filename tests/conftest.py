"""Test configuration: run everything on a virtual 8-device CPU mesh.

Kernels run in Pallas interpret mode where a test passes interpret=True;
everything else runs the plain XLA versions (ops/dispatch.py). Tests that
need the card are marked `gpu` and skip here; chip_smoke.py runs the
GPU paths on the card.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at test time, not import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
