"""Deferred NEE occlusion (pt._resolve_slog + the slog carry route):
logging shadow rays per bounce and resolving them in chunked any_hit
dispatches after the loop must reproduce the per-bounce dispatches —
occlusion is read-only w.r.t. the path carry and consumes no RNG
(reference behaviour preserved: pt.cpp:17-44 NEE, only the dispatch
schedule moves)."""

import jax
import jax.numpy as jnp
import numpy as np

from imbatracer_tpu.render.integrators import pt as pt_mod


def _frame(scene, cam, size, monkeypatch, defer):
    monkeypatch.setenv("IMBA_SHADOW_DEFER", str(defer) if defer else "0")
    monkeypatch.setenv("IMBA_PT_COMPACT", "0")
    # The defer flag is read at trace time inside the jitted band driver
    # (same signature either way) — drop compiled traces so the flag is
    # re-read.  CPU-only test at 24²; the recompile is cheap.
    jax.clear_caches()
    return np.asarray(pt_mod.render_pt_frame(
        scene, cam, jnp.uint32(0), width=size, height=size, spp=1,
        max_len=4))


def test_defer_matches_per_bounce(monkeypatch):
    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.scene.procedural import make_cornell_scene

    scene, meta = make_cornell_scene()
    size = 24
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)
    a = _frame(scene, cam, size, monkeypatch, defer=False)
    b = _frame(scene, cam, size, monkeypatch, defer=True)
    assert np.isfinite(b).all()
    assert float(np.abs(a).sum()) > 0.0
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_vcm_defer_matches_per_bounce(monkeypatch):
    """VCM camera pass: NEE + connection shadow sets logged per bounce
    and resolved post-loop must reproduce the per-bounce batched
    any_hit (banded and compacted)."""
    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.render.integrators import vcm as vcm_mod
    from imbatracer_tpu.scene.procedural import make_cornell_scene

    scene, meta = make_cornell_scene()
    size = 24
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)
    kw = dict(algo="vcm", width=size, height=size, spp=1, max_len=4,
              light_path_count=256)

    def frame(defer, compact):
        monkeypatch.setenv("IMBA_SHADOW_DEFER", "1" if defer else "0")
        monkeypatch.setenv("IMBA_VCM_COMPACT", "1" if compact else "0")
        monkeypatch.setenv("IMBA_VCM_COMPACT_DEPTH", "2")
        if compact:
            monkeypatch.setattr(vcm_mod, "BAND_RAYS", 192)
        jax.clear_caches()
        return np.asarray(vcm_mod.render_vcm_frame(
            scene, cam, jnp.uint32(0), jnp.float32(0.05), **kw))

    a = frame(False, False)
    b = frame(True, False)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    c = frame(True, True)
    assert np.isfinite(c).all()
    np.testing.assert_allclose(a, c, rtol=2e-4, atol=2e-5)


def test_pt_compact_defer_matches(monkeypatch):
    """The compacted PT route (phase-1 flush before the lane sort +
    per-band phase-2 flushes) must reproduce the banded per-bounce
    frame."""
    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.scene.procedural import make_cornell_scene

    scene, meta = make_cornell_scene()
    size = 24
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)

    def frame(defer, compact):
        monkeypatch.setenv("IMBA_SHADOW_DEFER", str(defer) if defer else "0")
        monkeypatch.setenv("IMBA_PT_COMPACT", "1" if compact else "0")
        monkeypatch.setenv("IMBA_PT_COMPACT_DEPTH", "2")
        if compact:
            monkeypatch.setattr(pt_mod, "BAND_RAYS", 192)
        jax.clear_caches()
        return np.asarray(pt_mod.render_pt_frame(
            scene, cam, jnp.uint32(0), width=size, height=size, spp=1,
            max_len=4))

    a = frame(False, False)
    b = frame(1, True)
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    c = frame(2, True)
    np.testing.assert_allclose(a, c, rtol=2e-4, atol=2e-5)


def test_light_pass_cc_defer_matches(monkeypatch):
    """Light-pass camera connections: deferred cc occlusion (sclog) must
    reproduce the per-bounce any_hit — LT is pure light transport, so
    the whole film goes through this path."""
    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.render.integrators import vcm as vcm_mod
    from imbatracer_tpu.scene.procedural import make_cornell_scene

    scene, meta = make_cornell_scene()
    size = 24
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)
    kw = dict(algo="lt", width=size, height=size, spp=1, max_len=4,
              light_path_count=256)

    def frame(defer):
        monkeypatch.setenv("IMBA_SHADOW_DEFER", "1" if defer else "0")
        jax.clear_caches()
        return np.asarray(vcm_mod.render_vcm_frame(
            scene, cam, jnp.uint32(0), jnp.float32(0.05), **kw))

    a = frame(False)
    b = frame(True)
    assert float(np.abs(a).sum()) > 0.0
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_defer_chunked_resolve(monkeypatch):
    """Force the resolve to chunk (BAND_RAYS < logged rows) so the
    chunked any_hit path is exercised."""
    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.scene.procedural import make_cornell_scene

    scene, meta = make_cornell_scene()
    size = 24
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size,
                      60.0)
    a = _frame(scene, cam, size, monkeypatch, defer=False)
    monkeypatch.setattr(pt_mod, "BAND_RAYS", 640)  # 4*576 rows -> 4 chunks
    b = _frame(scene, cam, size, monkeypatch, defer=True)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
