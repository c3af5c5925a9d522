"""Golden-image smoke gate: a low-res PT render of the reference's own
cornell_org.scene must match the committed golden image.

This is the CI-able miniature of the reference's RMSE gate
(test/run_bench.py:113-129 compares renders against
test/references/ref_*.png with ImageMagick RMSE).  Catches image-breaking
regressions anywhere in the stack: scene parsing, OBJ/MTL conversion,
BVH, traversal, materials, lights, camera, tone mapping."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from imbatracer_tpu.utils.metrics import load_reference_png, psnr

SCENE = "/root/reference/test/scenes/cornell/cornell_org.scene"
GOLDEN = "/root/reference/test/references/ref_cornell_org.png"
SIZE = 128


@pytest.mark.skipif(
    not (os.path.exists(SCENE) and os.path.exists(GOLDEN)),
    reason="reference assets not available",
)
def test_cornell_org_matches_golden():
    from imbatracer_tpu.frontend.engine import make_frame_fn
    from imbatracer_tpu.frontend.renderer import RenderSettings
    from imbatracer_tpu.scene.build import build_scene

    ds, meta = build_scene(SCENE)
    settings = RenderSettings(width=SIZE, height=SIZE, spp=2,
                              algorithm="pt", max_path_len=8)
    frame_fn, _ = make_frame_fn(ds, meta, settings)
    frames = 6
    acc = np.array(frame_fn(jnp.uint32(0)))
    for f in range(1, frames):
        acc += np.asarray(frame_fn(jnp.uint32(f)))
    # Tone map exactly as the render window: (x * weight) ** gamma with
    # the default gamma 0.5 (render_window.cpp:99-121, cmd_line.h:77).
    img = np.clip(acc / (frames * settings.spp), 0.0, None) ** 0.5
    img = img.reshape(SIZE, SIZE, 3)

    ref = load_reference_png(GOLDEN)
    k = ref.shape[0] // SIZE  # box downscale
    ref_small = ref.reshape(SIZE, k, SIZE, k, 3).mean(axis=(1, 3))

    db = psnr(img, ref_small)
    # 16 samples of MC noise + downscale resampling put the ceiling around
    # 28-29 dB (measured); anything above 25 means the image is right.
    assert db >= 25.0, f"PSNR vs golden {db:.2f} dB < 25"
