"""Algorithm dispatch: settings -> a jitted frame-render function.

Mirrors the reference's integrator construction in main()
(reference: frontend/main.cpp:109-157): `pt` maps to the dedicated
path tracer; `vcm`/`bpt`/`ppm`/`lt`/`vcm_pt` map to the VCM template with
the corresponding static algorithm flag.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..render.camera import Camera
from ..render.integrators.pt import render_pt_frame
from ..render.integrators.vcm import render_vcm_frame
from ..render.intersect import BIG
from ..render.traverse import closest_hit
from ..render.integrators.pt import camera_rays
from ..utils.log import logger
from .renderer import RenderSettings, camera_for_scene

ALGO_MAP = {
    "pt": "pt-dedicated",
    "vcm": "vcm",
    "bpt": "bpt",
    "ppm": "ppm",
    "lt": "lt",
    "vcm_pt": "pt",
}


def estimate_pixel_size(scene, cam: Camera, meta) -> float:
    """World-space footprint of one pixel, used for the photon-mapping
    base radius and camera speed.

    The reference traces corner rays of every 8th pixel and averages
    distances between neighbouring hit points (integrator.cpp:14-71); for
    a pinhole camera that distance is hit_t / img_plane_dist, so we trace a
    sparse pixel subset and average that directly.
    """
    w = max(cam.width // 8, 1)
    h = max(cam.height // 8, 1)
    xs = (jnp.arange(w * h) % w).astype(jnp.float32) * 8.0 + 0.5
    ys = (jnp.arange(w * h) // w).astype(jnp.float32) * 8.0 + 0.5
    from ..render.camera import generate_ray

    org, d = generate_ray(cam, xs, ys)
    hit = closest_hit(scene.bvh, org, d, 0.0, BIG)
    ok = hit.prim_id >= 0
    mean_t = jnp.sum(jnp.where(ok, hit.t, 0.0)) / jnp.maximum(
        jnp.sum(ok.astype(jnp.float32)), 1.0
    )
    return float(mean_t / cam.img_plane_dist)


def vcm_frame_params(scene, meta, settings: RenderSettings, cam: Camera,
                     n_dev: int = 1):
    """The resolved VCM-family frame parameters: (base radius, light path
    count, static material kinds).  The path count is rounded up to a
    multiple of the `n_dev`-device mesh, since light paths shard over it."""
    vcm_algo = ALGO_MAP[settings.algorithm]
    base_radius = 1.0
    if vcm_algo in ("vcm", "ppm"):
        px = estimate_pixel_size(scene, cam, meta)
        base_radius = px * settings.radius_factor
        logger.info("pixel size %.6f -> base radius %.6f", px, base_radius)
    lpc = settings.resolved_light_path_count()
    lpc = -(-lpc // n_dev) * n_dev
    # Static material-kind set: kinds absent from the scene compile out
    # of the merge's BSDF evaluation.
    mat_kinds = tuple(sorted(set(
        int(k) for k in np.asarray(scene.materials.kind))))
    return jnp.float32(base_radius), lpc, mat_kinds


def make_frame_fn(scene, meta, settings: RenderSettings):
    """Returns (frame_fn, camera). frame_fn(frame_idx) -> (H*W, 3) film."""
    core, cam = make_camera_frame_fn(scene, meta, settings)
    return (lambda frame: core(frame, cam)), cam


def make_camera_frame_fn(scene, meta, settings: RenderSettings):
    """Returns (core_fn, default_camera) with core_fn(frame_idx, camera)
    -> (H*W, 3) film.  The camera is a traced pytree argument, so moving
    it (interactive preview) re-uses the compiled frame program.

    On a multi-chip host every frame is data-parallel over the device
    mesh (parallel/shard.py): camera rays / light paths shard over chips,
    films psum over the mesh, the VCM vertex cache is merged + canonicalised
    between the passes.  Results are identical to single-chip rendering
    (RNG is keyed by global pixel/path ids)."""
    cam = camera_for_scene(meta, settings)
    algo = settings.algorithm

    mesh = None
    if len(jax.devices()) > 1:
        from ..parallel.shard import make_mesh

        mesh = make_mesh()
        logger.info("multi-chip: sharding over %d devices",
                    mesh.devices.size)

    if algo == "pt":
        if mesh is not None:
            from ..parallel.shard import render_pt_frame_sharded

            def core(frame, cam):
                return render_pt_frame_sharded(
                    scene, cam, frame, settings.width, settings.height,
                    mesh, spp=settings.spp, max_len=settings.max_path_len,
                    has_masks=meta.has_masks,
                    has_bump=getattr(meta, "has_bump", False),
                )
            return core, cam

        # (render_pt_frame_regen, the regenerated wavefront, is a
        # test-only estimator cross-check, tests/test_regen.py.)
        def render(scene, frame, cam):
            return render_pt_frame(
                scene, cam, frame, settings.width, settings.height,
                spp=settings.spp, max_len=settings.max_path_len,
                has_masks=meta.has_masks,
                has_bump=getattr(meta, "has_bump", False),
            )

        # One-dispatch frames: the banded Python loop unrolls inside an
        # outer jit (pt.use_fused_frame).  The scene is an argument, not a
        # closure: closed-over arrays would be baked into the executable
        # as constants.
        from ..render.integrators.pt import BAND_RAYS, use_fused_frame

        band = max(1, BAND_RAYS // max(settings.spp, 1))
        num_bands = -(-settings.width * settings.height // band)
        if use_fused_frame(num_bands, settings.max_path_len):
            render = jax.jit(render)
        return (lambda frame, cam: render(scene, frame, cam)), cam

    vcm_algo = ALGO_MAP.get(algo)
    if vcm_algo is None or vcm_algo == "pt-dedicated":
        raise ValueError(f"unknown algorithm {algo!r}")

    n_dev = 1 if mesh is None else mesh.devices.size
    base_radius, lpc, mat_kinds = vcm_frame_params(scene, meta, settings,
                                                   cam, n_dev)

    if mesh is not None:
        from ..parallel.shard import render_vcm_frame_sharded

        def core(frame, cam):
            return render_vcm_frame_sharded(
                scene, cam, frame, base_radius, mesh,
                algo=vcm_algo, width=settings.width, height=settings.height,
                spp=settings.spp, max_len=settings.max_path_len,
                light_path_count=lpc,
                num_connections=settings.num_connections,
                num_knn=settings.num_knn,
                has_masks=meta.has_masks,
                has_bump=getattr(meta, "has_bump", False),
                mat_kinds=mat_kinds,
            )
        return core, cam

    def core(frame, cam):
        return render_vcm_frame(
            scene, cam, frame, base_radius,
            algo=vcm_algo, width=settings.width, height=settings.height,
            spp=settings.spp, max_len=settings.max_path_len,
            light_path_count=lpc,
            num_connections=settings.num_connections,
            num_knn=settings.num_knn,
            has_masks=meta.has_masks,
            has_bump=getattr(meta, "has_bump", False),
            mat_kinds=mat_kinds,
        )

    return core, cam
