#!/usr/bin/env python
"""Headline benchmark: sustained traversal+shading throughput of the PT
megastep (Mrays/s), the reference's rays/sec metric
(reference: test/run_bench.py:174-199, tile_scheduler.h:59-61).

Runs on the GPU only and fails elsewhere.  Prints one JSON line per
secondary metric (the 48k-triangle big scene at 1024², the still-life
proxy at 1080p), then the headline JSON line last.  Every line names the
device it ran on.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp


def _device():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    from imbatracer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {jax.devices()[0].platform}")

    from imbatracer_tpu.frontend.renderer import RenderSettings, camera_for_scene
    from imbatracer_tpu.render.integrators.pt import (BAND_RAYS,
                                                      render_pt_frame,
                                                      use_fused_frame)
    from imbatracer_tpu.scene.procedural import make_cornell_scene

    scene, meta = make_cornell_scene()
    size = 1024
    settings = RenderSettings(width=size, height=size, spp=1, max_path_len=10)
    cam = camera_for_scene(meta, settings)

    def render(scene, i):
        return render_pt_frame(
            scene, cam, i, size, size,
            spp=1, max_len=settings.max_path_len,
            has_masks=meta.has_masks, with_stats=True,
        )

    num_bands = -(-size * size // BAND_RAYS)
    if use_fused_frame(num_bands, settings.max_path_len):
        render = jax.jit(render)

    def frame(i):
        return render(scene, jnp.uint32(i))

    # Warmup/compile.
    film, n_rays = frame(0)
    jax.block_until_ready(film)

    frames = 20
    t0 = time.time()
    counts = []
    for i in range(1, frames + 1):
        film, n_rays = frame(i)
        counts.append(n_rays)  # kept on device: no per-frame sync
    jax.block_until_ready(film)
    elapsed = time.time() - t0
    total_rays = sum(int(c) for c in counts)
    mrays = total_rays / elapsed / 1e6

    print(json.dumps(_big_scene_metric()))
    print(json.dumps(_still_life_metric()))
    print(json.dumps({
        "metric": "pt_megastep_throughput_cornell_1024",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "device": _device(),
    }))


def _frame_ms(scene, meta, settings, frames):
    from imbatracer_tpu.frontend.engine import make_frame_fn

    frame_fn, _ = make_frame_fn(scene, meta, settings)
    jax.block_until_ready(frame_fn(jnp.uint32(0)))
    t0 = time.time()
    out = None
    for i in range(1, frames + 1):
        out = frame_fn(jnp.uint32(i))
    jax.block_until_ready(out)
    return (time.time() - t0) / frames * 1e3


def _still_life_metric(frames=3):
    """1080p PT on the config-2 proxy (>=100k tris, all six BSDF kinds,
    env + area lights, alpha-masked cards).  Reference workload:
    test/run_bench.py:58-111 config 2."""
    from imbatracer_tpu.frontend.renderer import RenderSettings
    from imbatracer_tpu.scene.procedural import make_still_life_like

    scene, meta = make_still_life_like()
    settings = RenderSettings(width=1920, height=1080, spp=1,
                              algorithm="pt", max_path_len=8)
    return {
        "metric": "pt_frame_ms_still_life_1080p",
        "tris": int(meta.num_tris),
        "value": round(_frame_ms(scene, meta, settings, frames), 1),
        "unit": "ms/frame",
        "device": _device(),
    }


def _big_scene_metric(boxes=4000, size=1024, frames=4):
    from imbatracer_tpu.frontend.renderer import RenderSettings
    from imbatracer_tpu.scene.procedural import make_big_scene

    scene, meta = make_big_scene(boxes)
    settings = RenderSettings(width=size, height=size, spp=1,
                              algorithm="pt", max_path_len=6)
    return {
        "metric": "pt_frame_ms_bigscene_1024",
        "tris": int(meta.num_tris),
        "value": round(_frame_ms(scene, meta, settings, frames), 1),
        "unit": "ms/frame",
        "device": _device(),
    }


if __name__ == "__main__":
    main()
