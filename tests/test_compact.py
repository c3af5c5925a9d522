"""Mid-frame lane compaction (pt._render_pt_frame_compact) vs the plain
banded renderer: identical per-path estimator (RNG rides with the lane),
film differs only by summation order."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from imbatracer_tpu.render.camera import make_camera
from imbatracer_tpu.render.integrators import pt as pt_mod
from imbatracer_tpu.scene.procedural import make_cornell_scene


def _pair(size, spp, lanes, max_len=5, depth0=2, monkeypatch=None):
    scene, meta = make_cornell_scene()
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)
    monkeypatch.setenv("IMBA_PT_COMPACT", "0")
    a, na = pt_mod.render_pt_frame(
        scene, cam, jnp.uint32(0), size, size, spp=spp, max_len=max_len,
        with_stats=True)
    monkeypatch.setenv("IMBA_PT_COMPACT", "1")
    monkeypatch.setenv("IMBA_PT_COMPACT_DEPTH", str(depth0))
    monkeypatch.setattr(pt_mod, "BAND_RAYS", lanes)
    b, nb = pt_mod.render_pt_frame(
        scene, cam, jnp.uint32(0), size, size, spp=spp, max_len=max_len,
        with_stats=True)
    return np.asarray(a), np.asarray(b), int(na), int(nb)


def test_compact_matches_banded(monkeypatch):
    """Multiple phase-1 bands, phase-2 narrower than phase 1."""
    a, b, na, nb = _pair(size=48, spp=1, lanes=512, monkeypatch=monkeypatch)
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert na == nb  # same per-path ray sets, exactly


def test_compact_matches_banded_spp(monkeypatch):
    a, b, na, nb = _pair(size=24, spp=3, lanes=640, monkeypatch=monkeypatch)
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert na == nb


def test_vcm_camera_compact_matches_banded(monkeypatch):
    """The VCM camera pass through the same compaction (merge + connect
    + NEE in phase 2, cache/grid threading)."""
    from imbatracer_tpu.render.integrators import vcm as vcm_mod

    scene, meta = make_cornell_scene()
    size = 32
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)
    kw = dict(algo="vcm", width=size, height=size, spp=1, max_len=4,
              light_path_count=256)
    monkeypatch.setenv("IMBA_VCM_COMPACT", "0")
    a = np.asarray(vcm_mod.render_vcm_frame(
        scene, cam, jnp.uint32(0), 5e-3, **kw))
    monkeypatch.setenv("IMBA_VCM_COMPACT", "1")
    monkeypatch.setenv("IMBA_VCM_COMPACT_DEPTH", "2")
    monkeypatch.setattr(vcm_mod, "BAND_RAYS", 512)
    b = np.asarray(vcm_mod.render_vcm_frame(
        scene, cam, jnp.uint32(0), 5e-3, **kw))
    assert np.isfinite(b).all()
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_compact_deep_checkpoint(monkeypatch):
    """depth0 close to max_len (phase 2 nearly empty)."""
    a, b, na, nb = _pair(size=32, spp=1, lanes=512, max_len=4, depth0=3,
                         monkeypatch=monkeypatch)
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert na == nb


def test_sharded_compact_matches_single_device(monkeypatch):
    """Round-4 port: mid-frame compaction inside the sharded band path
    (parallel/shard._render_pt_frame_compact_sharded) must reproduce the
    single-chip banded frame (per-shard local sort, one host sync on the
    max alive count, no new collectives)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from imbatracer_tpu.parallel import shard as shard_mod
    from imbatracer_tpu.render.camera import make_camera

    scene, meta = make_cornell_scene()
    size = 48
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)
    mesh = shard_mod.make_mesh(jax.devices()[:8])

    monkeypatch.setenv("IMBA_PT_COMPACT", "0")
    a, na = pt_mod.render_pt_frame(
        scene, cam, jnp.uint32(0), size, size, max_len=5, with_stats=True)
    monkeypatch.setenv("IMBA_PT_COMPACT", "1")
    monkeypatch.setenv("IMBA_PT_COMPACT_DEPTH", "2")
    # 48*48/8 = 288 lanes per shard; band 64 -> 5 local bands.
    monkeypatch.setattr(shard_mod, "BAND_RAYS", 64)
    b, nb = shard_mod.render_pt_frame_sharded(
        scene, cam, jnp.uint32(0), size, size, mesh, max_len=5,
        with_stats=True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=2e-4, atol=2e-5)
    assert int(na) == int(nb)  # same per-path ray sets, exactly


def test_sharded_vcm_compact_matches_single_device(monkeypatch):
    """Round-4 port: VCM camera-pass compaction inside the sharded path
    (shard._vcm_camera_pass_compact_sharded) vs the single-chip
    un-compacted frame — merged cache, grid, connections and merge all
    thread through the per-shard phase split."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from imbatracer_tpu.parallel import shard as shard_mod
    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.render.integrators import vcm as vcm_mod

    scene, meta = make_cornell_scene()
    size = 32
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)
    mesh = shard_mod.make_mesh(jax.devices()[:8])
    kw = dict(algo="vcm", width=size, height=size, max_len=4,
              light_path_count=512, cache_capacity=8192)
    r = jnp.float32(0.05)
    monkeypatch.setenv("IMBA_VCM_COMPACT", "0")
    a = np.asarray(vcm_mod.render_vcm_frame(
        scene, cam, jnp.uint32(0), r, **kw))
    monkeypatch.setenv("IMBA_VCM_COMPACT", "1")
    monkeypatch.setenv("IMBA_VCM_COMPACT_DEPTH", "2")
    # 32*32/8 = 128 pixels per shard; band 32 -> 4 local bands.
    monkeypatch.setattr(shard_mod, "BAND_RAYS", 32)
    b = np.asarray(shard_mod.render_vcm_frame_sharded(
        scene, cam, jnp.uint32(0), r, mesh, **kw))
    assert np.isfinite(b).all()
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_compact_masked_matches_banded(monkeypatch):
    """Masks flow through both compaction phases: the alpha_fn re-trace
    (pt masked closest/any hit) must give identical films on the
    compacted and banded routes for the masked-occluder scene."""
    from imbatracer_tpu.render.integrators import pt as pt_mod
    from imbatracer_tpu.scene.procedural import make_masked_scene
    from imbatracer_tpu.frontend.renderer import RenderSettings, camera_for_scene

    scene, meta = make_masked_scene()
    assert meta.has_masks
    size = 32
    settings = RenderSettings(width=size, height=size, spp=1, max_path_len=4)
    cam = camera_for_scene(meta, settings)

    def render():
        return np.asarray(pt_mod.render_pt_frame(
            scene, cam, jnp.uint32(3), size, size, spp=1, max_len=4,
            has_masks=True))

    monkeypatch.setenv("IMBA_PT_COMPACT", "0")
    a = render()
    monkeypatch.setenv("IMBA_PT_COMPACT", "1")
    monkeypatch.setenv("IMBA_PT_COMPACT_DEPTH", "2")
    monkeypatch.setattr(pt_mod, "BAND_RAYS", 256)
    b = render()
    assert np.isfinite(b).all()
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_sharded_compact_masked_matches_single_device(monkeypatch):
    """The exact masked re-trace (while_loop over sorted compacted
    re-dispatches) must work inside shard_map: sharded compacted render
    of the masked scene vs the single-device banded frame."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from imbatracer_tpu.frontend.renderer import (RenderSettings,
                                                  camera_for_scene)
    from imbatracer_tpu.parallel import shard as shard_mod
    from imbatracer_tpu.scene.procedural import make_masked_scene

    scene, meta = make_masked_scene()
    assert meta.has_masks
    size = 32
    settings = RenderSettings(width=size, height=size, spp=1, max_path_len=4)
    cam = camera_for_scene(meta, settings)
    mesh = shard_mod.make_mesh(jax.devices()[:8])

    monkeypatch.setenv("IMBA_PT_COMPACT", "0")
    a = np.asarray(pt_mod.render_pt_frame(
        scene, cam, jnp.uint32(3), size, size, spp=1, max_len=4,
        has_masks=True))
    monkeypatch.setenv("IMBA_PT_COMPACT", "1")
    monkeypatch.setenv("IMBA_PT_COMPACT_DEPTH", "2")
    # 32*32/8 = 128 lanes per shard; band 32 -> 4 local bands.
    monkeypatch.setattr(shard_mod, "BAND_RAYS", 32)
    b = np.asarray(shard_mod.render_pt_frame_sharded(
        scene, cam, jnp.uint32(3), size, size, mesh, spp=1, max_len=4,
        has_masks=True))
    assert np.isfinite(b).all()
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_fused_frame_matches_banded(monkeypatch):
    """One-dispatch frame (outer jit unrolling the band loop,
    pt.use_fused_frame) estimates the same image as the banded render.

    Ulp-level tolerance, not bitwise: the eager path compiles each band
    as its own XLA program while the fused path compiles one unrolled
    graph, and XLA makes different FMA/fusion choices per compilation
    (with kind specialization on, ~2% of pixels differ by <=5e-7; with
    IMBA_SPEC=0 the two happen to agree bitwise)."""
    import jax

    size, lanes = 32, 256  # 4 spp x 1024 px / 256 lanes -> 16 bands
    scene, meta = make_cornell_scene()
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)
    monkeypatch.setenv("IMBA_PT_COMPACT", "0")
    monkeypatch.setattr(pt_mod, "BAND_RAYS", lanes)
    kw = dict(spp=4, max_len=5, with_stats=True)
    a, na = pt_mod.render_pt_frame(scene, cam, jnp.uint32(3), size, size,
                                   **kw)
    fused = jax.jit(lambda f: pt_mod.render_pt_frame(scene, cam, f, size,
                                                     size, **kw))
    b, nb = fused(jnp.uint32(3))
    assert int(na) == int(nb)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=1e-6)


def test_use_fused_frame_gating(monkeypatch):
    monkeypatch.setenv("IMBA_PT_FUSE", "1")
    monkeypatch.setenv("IMBA_PT_COMPACT", "0")
    assert pt_mod.use_fused_frame(4, 10)
    assert not pt_mod.use_fused_frame(1, 10)  # one band: nothing to fuse
    monkeypatch.setenv("IMBA_PT_COMPACT", "1")
    assert not pt_mod.use_fused_frame(4, 10)  # compaction wins
    monkeypatch.setenv("IMBA_PT_FUSE", "0")
    monkeypatch.setenv("IMBA_PT_COMPACT", "0")
    assert not pt_mod.use_fused_frame(4, 10)
    # Unset: the measured defaults, the same on every backend.
    monkeypatch.delenv("IMBA_PT_FUSE")
    monkeypatch.delenv("IMBA_PT_COMPACT")
    assert pt_mod._use_compact(4, 10) == pt_mod.PT_COMPACT
    assert pt_mod.use_fused_frame(4, 10) == (pt_mod.PT_FUSE
                                             and not pt_mod.PT_COMPACT)
