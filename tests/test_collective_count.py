"""Collective-count regression test: the
sharded schedule's collective structure is hardware-independent, so pin
it — the docs/multichip.md census (1 film psum per PT band, 1 per VCM
light band, ZERO camera-band collectives) must not silently grow.  A
new collective here means a sharding regression that would ride
NVLink on real hardware.

The counts target the per-band jitted programs exactly as they execute
— jitting the whole python
orchestrator instead would hand the replicated host steps to GSPMD and
count collectives the real schedule never runs."""

from functools import partial

import jax
import jax.numpy as jnp
import pytest

from imbatracer_tpu.parallel import shard as shard_mod
from imbatracer_tpu.render.integrators.vcm import TECHNIQUES, empty_cache

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute")


def _counts(fn, *args):
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return {op: txt.count(op) for op in COLLECTIVES}


@pytest.fixture(scope="module")
def fixture():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.scene.procedural import make_cornell_scene

    scene, meta = make_cornell_scene()
    size = 32
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)
    mesh = shard_mod.make_mesh(jax.devices()[:8])
    return scene, cam, mesh, size


def test_pt_band_collectives(fixture):
    scene, cam, mesh, size = fixture
    f = partial(shard_mod._pt_band_sharded, width=size, height=size, spp=1,
                max_len=3, has_masks=False, has_bump=False, mesh=mesh,
                with_stats=False,
                band_pixels=size * size // 8)
    c = _counts(f, scene, cam, jnp.uint32(0), jnp.int32(0))
    # One film psum; nothing else moves between chips (scene
    # replicated, rays never migrate).
    assert c["all-reduce"] == 1, c
    assert sum(c.values()) == 1, c


def test_vcm_light_band_collectives(fixture):
    scene, cam, mesh, size = fixture
    lpc = 256
    f = partial(shard_mod._vcm_light_band_sharded, mesh=mesh, algo="vcm",
                num_pixels=size * size, light_path_count=lpc, max_len=3,
                local_capacity=2 * lpc // 8, has_masks=False,
                has_bump=False, techniques=TECHNIQUES,
                band_paths=lpc // 8)
    c = _counts(f, scene, cam, jnp.uint32(0), jnp.float32(0.05),
                jnp.int32(0))
    # One light-tracing film psum; local caches come back with a shard
    # axis (out_specs concat, no collective).
    assert c["all-reduce"] == 1, c
    assert sum(c.values()) == 1, c


def test_vcm_camera_band_collectives(fixture):
    scene, cam, mesh, size = fixture
    lpc = 256
    cache = empty_cache(2 * lpc)
    from imbatracer_tpu.render.hashgrid import build_hash_grid

    valid = jnp.zeros((2 * lpc,), bool)
    grid = build_hash_grid(cache.pos, valid, jnp.float32(0.05), 1024,
                           payload=jnp.zeros((2 * lpc, 8), jnp.float32))
    f = partial(shard_mod._vcm_camera_band_sharded, mesh=mesh, algo="vcm",
                width=size, height=size, spp=1, max_len=3,
                light_path_count=lpc, num_connections=1, num_knn=10,
                table_size=1024, max_per_cell=4, has_masks=False,
                has_bump=False, techniques=TECHNIQUES,
                band_pixels=size * size // 8)
    c = _counts(f, scene, cam, jnp.uint32(0), cache, grid,
                jnp.float32(0.05), jnp.int32(0))
    # Zero collectives: every shard renders its own pixels with the
    # replicated cache; films concatenate along the mesh.
    assert sum(c.values()) == 0, c
