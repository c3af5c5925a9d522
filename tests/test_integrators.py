"""Integrator tests: every algorithm runs, produces finite nonzero films,
and the unbiased ones (PT / BPT / VCM / LT) agree on the same scene —
the reference's convergence gate in miniature (run_bench.py:254-296)."""

import jax.numpy as jnp
import numpy as np
import pytest

from imbatracer_tpu.frontend.engine import make_frame_fn
from imbatracer_tpu.frontend.renderer import RenderSettings
from imbatracer_tpu.scene.procedural import make_cornell_scene

SIZE = 32


@pytest.fixture(scope="module")
def cornell():
    return make_cornell_scene(with_boxes=True)


def _render(scene, meta, algo, frames=2, size=SIZE, max_len=4, lpc=256):
    settings = RenderSettings(
        width=size, height=size, algorithm=algo, max_path_len=max_len,
        light_path_count=lpc, spp=1,
    )
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    acc = np.zeros((size * size, 3), np.float32)
    for f in range(frames):
        acc += np.asarray(frame_fn(jnp.uint32(f)))
    return acc / frames


@pytest.mark.parametrize("algo", ["pt", "lt", "bpt", "ppm", "vcm", "vcm_pt"])
def test_algorithm_runs(cornell, algo):
    scene, meta = cornell
    img = _render(scene, meta, algo)
    assert np.isfinite(img).all(), f"{algo} produced non-finite values"
    assert img.sum() > 0, f"{algo} produced a black image"
    # Energy sanity: mean radiance in a closed box with one light should be
    # in a plausible range (not exploding).
    assert img.mean() < 50.0, f"{algo} mean {img.mean()} looks divergent"


def test_unbiased_algorithms_agree(cornell):
    """PT, BPT, VCM and LT estimate the same integral; with enough samples
    their images must match within Monte-Carlo noise."""
    scene, meta = cornell
    frames = 48
    imgs = {
        algo: _render(scene, meta, algo, frames=frames, max_len=4, lpc=1024)
        for algo in ("pt", "bpt", "vcm", "lt")
    }
    ref = imgs["pt"].mean()
    for algo in ("bpt", "vcm"):
        m = imgs[algo].mean()
        rel = abs(m - ref) / max(ref, 1e-9)
        assert rel < 0.15, f"{algo} mean {m:.4f} vs pt {ref:.4f} (rel {rel:.2f})"
    # Pure light tracing lacks the "camera directly sees the emitter"
    # technique (the reference's LT has the same hole: no emitter-hit
    # handling on camera rays exists in the light pass), so compare off
    # the directly-visible-light pixels only.
    pt_px = imgs["pt"].reshape(SIZE * SIZE, 3).mean(-1)
    lt_px = imgs["lt"].reshape(SIZE * SIZE, 3).mean(-1)
    mask = pt_px < np.percentile(pt_px, 98)
    rel = abs(lt_px[mask].mean() - pt_px[mask].mean()) / max(pt_px[mask].mean(), 1e-9)
    assert rel < 0.2, f"lt masked mean rel diff {rel:.2f}"
    # Pixelwise: smoothed images should correlate strongly.
    a = imgs["pt"].reshape(SIZE, SIZE, 3).mean(-1)
    for algo in ("bpt", "vcm"):
        b = imgs[algo].reshape(SIZE, SIZE, 3).mean(-1)
        corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
        assert corr > 0.95, f"{algo} correlation {corr:.3f}"


def test_vcm_pt_matches_pt(cornell):
    """The VCM template collapsed to PT must agree with the dedicated PT."""
    scene, meta = cornell
    frames = 24
    a = _render(scene, meta, "pt", frames=frames)
    b = _render(scene, meta, "vcm_pt", frames=frames)
    rel = abs(a.mean() - b.mean()) / max(a.mean(), 1e-9)
    assert rel < 0.1, f"vcm_pt mean {b.mean():.4f} vs pt {a.mean():.4f}"


def test_cache_capacity_admission_contract(cornell, monkeypatch):
    """Cache contract: the default 2x-lpc capacity BINDS via the per-path
    admission cap (vcm.auto_cache_capacity docstring) — while
    IMBA_CACHE_CAP_MULT=5 restores probe-style keep-everything
    sizing (reference: light_vertices.cpp:15-129)."""
    import jax.numpy as jnp

    from imbatracer_tpu.frontend.engine import estimate_pixel_size
    from imbatracer_tpu.frontend.renderer import camera_for_scene
    from imbatracer_tpu.render.integrators import vcm as vcm_mod
    from imbatracer_tpu.render.light_cache import empty_cache

    scene, meta = cornell
    lpc, max_len = 512, 8
    settings = RenderSettings(width=SIZE, height=SIZE, algorithm="vcm",
                              light_path_count=lpc, max_path_len=max_len)
    cam = camera_for_scene(meta, settings)
    base_radius = jnp.float32(
        estimate_pixel_size(scene, cam, meta) * 2.0)

    def collect(collect_cap):
        cache = empty_cache(collect_cap)
        _, cache = vcm_mod._vcm_light_band(
            scene, cam, jnp.uint32(0), base_radius, jnp.int32(0), cache,
            algo="vcm", num_pixels=SIZE * SIZE, light_path_count=lpc,
            max_len=max_len, cache_capacity=collect_cap, has_masks=False,
            has_bump=False, techniques=vcm_mod.TECHNIQUES,
            band_paths=lpc)
        return cache

    import numpy as np

    from imbatracer_tpu.render.light_cache import select_shallowest

    # Production pipeline: collect everything, select the shallowest
    # `cap` rows (render_vcm_frame does exactly this).
    cap = vcm_mod.auto_cache_capacity(lpc, max_len)
    assert cap == 2 * lpc
    full = collect(lpc * (max_len - 1))
    total = int(full.count)
    assert total > cap  # the default genuinely binds on this scene
    c2 = select_shallowest(full, cap)
    assert int(c2.count) == cap

    # No-truncation override: capacity stops binding and every
    # collected vertex survives; the default set is a subset.
    monkeypatch.setenv("IMBA_CACHE_CAP_MULT", "5")
    cap5 = vcm_mod.auto_cache_capacity(lpc, max_len)
    assert cap5 > 2 * lpc and total < cap5
    c5 = select_shallowest(full, min(cap5, full.capacity))
    assert int(c5.count) == total
    kept = set(zip(np.asarray(c2.path_id[:cap]).tolist(),
                   np.asarray(c2.path_length[:cap]).tolist()))
    everything = set(zip(np.asarray(c5.path_id[:total]).tolist(),
                         np.asarray(c5.path_length[:total]).tolist()))
    assert kept <= everything
