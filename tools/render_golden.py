"""Self-rendered goldens for scenes whose reference images don't exist.

The reference gates every bench row on RMSE vs a golden PNG
(/root/reference/test/run_bench.py:113-129) and renders those goldens
with long self-renders (/root/reference/test/render_refs.sh).  The
checkout ships goldens only for the cornell family, and the
sponza/still-life OBJs are absent (tools/run_bench.py docstring), so
the procedural proxy rows ran perf-only through round 4.  This tool
reproduces the reference's method on the procedural scenes: a long
PT self-render (PT is the transport oracle both estimator families
agree with) saved as a tone-mapped 8-bit PNG in goldens/.

Usage:
    python tools/render_golden.py still_life_512_len4 -t 900
    python tools/render_golden.py --list
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")

# name -> (scene uri, width, height, max_path_len)
GOLDENS = {
    "still_life_512_len4": ("proc:still_life", 512, 512, 4),
    "still_life_1080p_len8": ("proc:still_life", 1920, 1080, 8),
    "still_life_1080p_len10": ("proc:still_life", 1920, 1080, 10),
    "still_life_512_len10": ("proc:still_life", 512, 512, 10),
    "instances_1080p_len10": (
        "/root/reference/test/scenes/cornell/cornell_instances.scene",
        1920, 1080, 10),
}


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, name + ".png")


def render_golden(name: str, seconds: float, out: str = "") -> str:
    import numpy as np

    from imbatracer_tpu.frontend.engine import make_frame_fn
    from imbatracer_tpu.io.image import encode_png
    from imbatracer_tpu.frontend.renderer import (ProgressiveRenderer,
                                                  RenderSettings)
    from imbatracer_tpu.utils.metrics import quantize, rmse
    from run_bench import _build_any_scene

    scene_uri, width, height, max_len = GOLDENS[name]
    scene, meta = _build_any_scene(scene_uri)
    settings = RenderSettings(width=width, height=height, algorithm="pt",
                              max_path_len=max_len, max_time_sec=seconds)
    frame_fn, _ = make_frame_fn(scene, meta, settings)
    r = ProgressiveRenderer(frame_fn, settings)
    import jax

    r.step()
    jax.block_until_ready(r.accum)
    half = r.image()  # warm the tonemap jit outside the budget
    r.reset()

    t0 = time.time()
    half = None
    half_frames = 0
    while time.time() - t0 < seconds:
        r.step()
        jax.block_until_ready(r.accum)
        if half is None and time.time() - t0 >= seconds / 2:
            half = r.image()
            half_frames = r.frames
    img = r.image()
    # Convergence self-check (the only available error proxy without an
    # external truth): RMSE between the half-budget image and the final.
    conv = rmse(half, img) if half is not None else float("nan")
    print(f"{name}: {r.frames} frames in {time.time() - t0:.0f} s; "
          f"half-vs-final rmse {conv:.5f} "
          f"(half at {half_frames} frames)")

    out = out or golden_path(name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "wb") as f:
        f.write(encode_png(quantize(np.asarray(img))))
    print(f"wrote {out}")
    return out


def main():
    from imbatracer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", help="golden names (see --list)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("-t", type=float, default=900.0,
                    help="render budget per golden, seconds")
    ap.add_argument("-o", default="", help="output path (single name only)")
    args = ap.parse_args()
    if args.list or not args.names:
        for k, v in GOLDENS.items():
            print(f"{k}: {v}")
        return
    for n in args.names:
        render_golden(n, args.t, args.o if len(args.names) == 1 else "")


if __name__ == "__main__":
    main()
