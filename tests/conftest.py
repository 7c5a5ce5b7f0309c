"""Test configuration: the CPU with an 8-device virtual mesh.

The suite runs on the CPU: the sharding tests use 8 virtual CPU devices
(xla_force_host_platform_device_count), and the GPU kernel runs in Pallas
interpret mode. Tests marked `gpu` skip here.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cornell_world():
    from webgpu_raytracer_tpu.models.native import NativeWorld

    w = NativeWorld("cornell")
    w.update_camera(64, 64)
    return w


@pytest.fixture(scope="session")
def cornell_scene(cornell_world):
    from webgpu_raytracer_tpu.render.resources import build_device_scene

    return build_device_scene(cornell_world)


@pytest.fixture
def gpu():
    """Skips the test unless JAX finds a GPU (decided here, not at import,
    so every test worker collects the same tests)."""
    import jax

    try:
        if jax.devices("gpu"):
            return jax.devices("gpu")[0]
    except RuntimeError:
        pass
    pytest.skip("no GPU visible to JAX")


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(1234)
