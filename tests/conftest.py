"""Test harness: run on a virtual 8-device CPU mesh unless told otherwise.

This is the fake-backend mechanism the reference never needed (SURVEY.md
section 4): all sharding/shard_map code paths run in CI on N virtual CPU
devices via --xla_force_host_platform_device_count, no accelerator required.

JAX_PLATFORMS, when set, is respected; unset, the suite runs on the CPU.
Tests marked `gpu` take the `gpu` fixture, which skips them unless JAX has a
GPU; run them on a GPU host with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# In case a plugin imported jax before this file ran.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from monocularsfm_tpu.utils import synthetic  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest tests/ -m gpu")


@pytest.fixture(scope="session")
def ring_scene():
    return synthetic.camera_ring_scene(num_cameras=8, num_points=400, noise_px=0.0, seed=3)


@pytest.fixture(scope="session")
def noisy_scene():
    return synthetic.camera_ring_scene(num_cameras=10, num_points=600, noise_px=0.5, seed=7)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
