"""Environment-map lighting and multi-chip sharding tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from imbatracer_tpu.render import envmap as envmap_mod
from imbatracer_tpu.scene.procedural import make_cornell_scene


def _env_test_image(h=16, w=32):
    """A lat-long HDR with a bright localized 'sun' patch."""
    img = np.full((h, w, 3), 0.05, np.float32)
    img[3:5, 6:9] = (40.0, 30.0, 20.0)
    return img


def test_env_importance_sampling_consistency():
    """sample_dir's pdf must integrate to 1 over the sphere and prefer the
    bright patch (the importance sampling the reference left TODO)."""
    env = envmap_mod.build_envmap(_env_test_image(), (1.0, 1.0, 1.0))
    n = 200_000
    rs = np.random.RandomState(0)
    u1 = jnp.asarray(rs.rand(n), jnp.float32)
    u2 = jnp.asarray(rs.rand(n), jnp.float32)
    d, li, pdf = envmap_mod.sample_dir(env, u1, u2)
    pdf = np.asarray(pdf)
    assert (pdf > 0).all()
    # MC integral of 1/pdf over sampled dirs = sphere solid angle (4 pi).
    integral = float(np.mean(1.0 / pdf))
    assert abs(integral - 4 * np.pi) < 0.25, integral
    # Bright patch should receive far more samples than its ~1% solid
    # angle.  (The pdf table is 2x2-neighbourhood averaged like the
    # reference's, light.h:380-389, so ~half the patch-directed samples
    # land on adjacent dark texels at nearest lookup — expected.)
    bright_frac = float(np.mean(np.asarray(li)[:, 0] > 1.0))
    assert bright_frac > 0.35, bright_frac

    # radiance() must report the same pdf used by sample_dir (MIS duals).
    # A handful of samples land exactly on cell boundaries where the
    # direction->(s,t) roundtrip picks the neighbouring cell; allow those.
    li2, pdf_direct, _ = envmap_mod.radiance(env, d, jnp.float32(1.0))
    rel = np.abs(np.asarray(pdf_direct) - pdf) / np.maximum(pdf, 1e-20)
    assert float(np.mean(rel < 2e-2)) > 0.999, float(np.mean(rel < 2e-2))


def test_env_estimator_unbiased():
    """E[li/pdf] over importance samples == the true env integral."""
    img = _env_test_image()
    env = envmap_mod.build_envmap(img, (1.0, 1.0, 1.0))
    n = 400_000
    rs = np.random.RandomState(1)
    u1 = jnp.asarray(rs.rand(n), jnp.float32)
    u2 = jnp.asarray(rs.rand(n), jnp.float32)
    d, li, pdf = envmap_mod.sample_dir(env, u1, u2)
    estimate = float(jnp.mean(li[:, 0] / pdf))
    # Ground truth: uniform-sphere MC through the same radiance() lookup
    # (shares the reference's s*(w-1) nearest-texel convention).
    from imbatracer_tpu.core import rng as rng_mod
    from imbatracer_tpu.core.sampling import sample_uniform_sphere

    st = rng_mod.seed(jnp.arange(n), 7)
    st, (a, b) = rng_mod.next_floats(st, 2)
    du, updf = sample_uniform_sphere(a, b)
    li_u, _, _ = envmap_mod.radiance(env, du, jnp.float32(1.0))
    true = float(jnp.mean(li_u[:, 0] / updf))
    assert abs(estimate - true) / true < 0.05, (estimate, true)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_pt_matches_single_device():
    from imbatracer_tpu.parallel.shard import make_mesh, render_pt_frame_sharded
    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.render.integrators.pt import render_pt_frame

    scene, meta = make_cornell_scene()
    size = 32
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size, 60.0)
    mesh = make_mesh(jax.devices()[:8])

    a = np.asarray(render_pt_frame(scene, cam, jnp.uint32(0), size, size, max_len=4))
    b = np.asarray(render_pt_frame_sharded(
        scene, cam, jnp.uint32(0), size, size, mesh, max_len=4))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
@pytest.mark.parametrize("algo", ["vcm", "bpt", "lt"])
def test_sharded_vcm_matches_single_device(algo):
    """Sharded light paths + merged canonical cache + sharded camera rays
    must reproduce the single-chip frame (same RNG per path/pixel; the
    canonical cache order makes vertex sampling schedule-independent).
    Tolerance covers the one non-associative piece: per-shard film
    segment-sums reduced by psum instead of one global segment-sum."""
    from imbatracer_tpu.parallel.shard import make_mesh, render_vcm_frame_sharded
    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.render.integrators.vcm import render_vcm_frame

    scene, meta = make_cornell_scene()
    size = 32
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size, 60.0)
    mesh = make_mesh(jax.devices()[:8])
    # cache_capacity with head-room: overflow *drop sets* are schedule-
    # dependent (single-chip drops in bounce-major order, shards locally)
    # — the equality contract holds for non-overflowing caches.
    kw = dict(algo=algo, width=size, height=size, max_len=4,
              light_path_count=512, cache_capacity=8192)
    r = jnp.float32(0.05)
    a = np.asarray(render_vcm_frame(scene, cam, jnp.uint32(0), r, **kw))
    b = np.asarray(render_vcm_frame_sharded(
        scene, cam, jnp.uint32(0), r, mesh, **kw))
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_light_pass_band_invariance():
    """Splitting the light pass into bands must not change the film
    (regression: cam_connect once normalised by the band size instead of
    light_path_count, over-brightening banded frames)."""
    import jax.numpy as jnp

    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.render.integrators.vcm import (
        TECHNIQUES, _light_pass, _mis_constants,
    )
    from imbatracer_tpu.render.light_cache import empty_cache

    scene, meta = make_cornell_scene()
    size = 16
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, size, size, 60.0)
    frame = jnp.uint32(0)
    br = jnp.float32(0.05)
    lpc = 128
    pm, evc, evm = _mis_constants(frame, br, lpc, "lt")
    kw = dict(algo="lt", num_pixels=size * size, light_path_count=lpc,
              max_len=3, cache_capacity=1024, has_masks=False,
              has_bump=False, alpha_fn=None,
              techniques=TECHNIQUES)
    whole, _ = _light_pass(scene, cam, frame, pm, br, evc, evm,
                           path_start=0, band_paths=lpc,
                           cache_in=empty_cache(1024), **kw)
    split = jnp.zeros_like(whole)
    for start in range(0, lpc, 32):
        f, _ = _light_pass(scene, cam, frame, pm, br, evc, evm,
                           path_start=start, band_paths=32,
                           cache_in=empty_cache(1024), **kw)
        split = split + f
    np.testing.assert_allclose(np.asarray(whole), np.asarray(split),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_tail_handling():
    """Pixel counts not divisible by the mesh must still render every
    pixel exactly once (regression: the old `max(rem // n_dev, 1)` clamp
    under-covered the tail, leaving trailing pixels black, or addressed
    out-of-range pixels).  The final < n_dev pixels run un-sharded."""
    from imbatracer_tpu.parallel.shard import (
        make_mesh, render_pt_frame_sharded, render_vcm_frame_sharded)
    from imbatracer_tpu.render.camera import make_camera
    from imbatracer_tpu.render.integrators.pt import render_pt_frame
    from imbatracer_tpu.render.integrators.vcm import render_vcm_frame

    scene, meta = make_cornell_scene()
    w, h = 13, 5  # 65 pixels: 65 = 8*8 + 1 on an 8-device mesh
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, w, h, 60.0)
    mesh = make_mesh(jax.devices()[:8])

    a = np.asarray(render_pt_frame(scene, cam, jnp.uint32(0), w, h, max_len=3))
    b = np.asarray(render_pt_frame_sharded(
        scene, cam, jnp.uint32(0), w, h, mesh, max_len=3))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

    kw = dict(algo="bpt", width=w, height=h, max_len=3,
              light_path_count=256, cache_capacity=4096)
    r = jnp.float32(0.05)
    va = np.asarray(render_vcm_frame(scene, cam, jnp.uint32(0), r, **kw))
    vb = np.asarray(render_vcm_frame_sharded(
        scene, cam, jnp.uint32(0), r, mesh, **kw))
    np.testing.assert_allclose(va, vb, rtol=2e-4, atol=2e-5)

    # Non-mesh-divisible light path counts are an estimator error, not a
    # silent truncation.
    with pytest.raises(ValueError, match="divisible"):
        render_vcm_frame_sharded(
            scene, cam, jnp.uint32(0), r, mesh, algo="bpt", width=w,
            height=h, max_len=3, light_path_count=255, cache_capacity=4096)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
@pytest.mark.parametrize("algo", ["pt", "lt"])
def test_sharded_film_without_psum_is_a_trace_error(algo, monkeypatch):
    """shard_map's varying-axis typing stays on: a film returned as
    replicated (out_specs=P()) without its psum must fail to trace, not
    silently return one shard's partial film."""
    from imbatracer_tpu.parallel.shard import (
        make_mesh, render_pt_frame_sharded, render_vcm_frame_sharded)
    from imbatracer_tpu.render.camera import make_camera

    scene, meta = make_cornell_scene()
    w, h = 9, 8  # a shape no other test compiles (no jit cache hit)
    cam = make_camera(meta.cam_pos, meta.cam_dir, meta.cam_up, w, h, 60.0)
    mesh = make_mesh(jax.devices()[:8])
    monkeypatch.setattr(jax.lax, "psum", lambda x, axis_name: x)
    with pytest.raises(ValueError, match="replicat"):
        if algo == "pt":
            render_pt_frame_sharded(scene, cam, jnp.uint32(0), w, h, mesh,
                                    max_len=2)
        else:
            render_vcm_frame_sharded(
                scene, cam, jnp.uint32(0), jnp.float32(0.05), mesh,
                algo="lt", width=w, height=h, max_len=2,
                light_path_count=64, cache_capacity=1024)
