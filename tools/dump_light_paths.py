#!/usr/bin/env python
"""Dump light-path vertices for offline inspection.

The analogue of the reference's PathDebugger (`LIGHT_PATH_DEBUG` writes a
binary `.path` file of every light-path vertex per frame, reference:
render/debug/path_debug.h:12-69).  Writes an npz with positions, outgoing
directions, throughputs, partial MIS weights and path lengths.

Usage: python tools/dump_light_paths.py <scene> [out.npz] [n_paths] [frame]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from imbatracer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    scene_path = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "light_paths.npz"
    n_paths = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    frame = int(sys.argv[4]) if len(sys.argv) > 4 else 0

    from imbatracer_tpu.frontend.engine import camera_for_scene, estimate_pixel_size
    from imbatracer_tpu.frontend.renderer import RenderSettings
    from imbatracer_tpu.render.integrators.vcm import debug_light_pass
    from imbatracer_tpu.scene.build import build_scene

    scene, meta = build_scene(scene_path)
    settings = RenderSettings()
    cam = camera_for_scene(meta, settings)
    base_radius = estimate_pixel_size(scene, cam, meta) * settings.radius_factor

    cache = debug_light_pass(
        scene, cam, frame, base_radius,
        light_path_count=n_paths, max_len=settings.max_path_len,
        has_masks=meta.has_masks,
    )
    count = int(cache.count)
    np.savez_compressed(
        out,
        pos=np.asarray(cache.pos[:count]),
        w_out=np.asarray(cache.w_out[:count]),
        throughput=np.asarray(cache.throughput[:count]),
        normal=np.asarray(cache.normal[:count]),
        d_vc=np.asarray(cache.d_vc[:count]),
        d_vcm=np.asarray(cache.d_vcm[:count]),
        d_vm=np.asarray(cache.d_vm[:count]),
        path_length=np.asarray(cache.path_length[:count]),
    )
    print(f"wrote {out}: {count} vertices from {n_paths} light paths "
          f"(avg path len {count / max(n_paths, 1):.2f})")


if __name__ == "__main__":
    main()
