"""Test config: run on CPU with 8 virtual devices so multi-device
sharding paths are exercised without accelerators."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.0")

import jax  # noqa: E402
import pytest  # noqa: E402

from imbatracer_tpu.utils.cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: XLA compiles each unique op graph once per
# checkout instead of once per pytest run (cold compiles dominate runtime).
enable_compile_cache()

REFERENCE_SCENES = "/root/reference/test/scenes"
REFERENCE_IMAGES = "/root/reference/test/references"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (chip_smoke.py "
        "runs the same checks on the card)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches_between_modules():
    """Free in-process executables after each test module.

    The full suite (~115 tests, hundreds of loaded CPU executables)
    segfaults the XLA CPU compiler inside backend_compile_and_load on a
    late big compile (test_scene_build::test_still_life_proxy_scene) —
    the same test passes in isolation, so the crash is accumulated
    in-process compiler/JIT state, not the graph itself.  Dropping the
    Python-side caches between modules releases the loaded executables
    (and their exec-page mappings); the persistent disk cache above
    makes the re-compiles cheap.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def cornell_scene_path():
    import os.path

    p = os.path.join(REFERENCE_SCENES, "cornell", "cornell_org.scene")
    if not os.path.exists(p):
        pytest.skip("reference cornell scene not available")
    return p
