"""Wavefront path tracer with NEE + MIS, as one on-device megastep.

Algorithm parity with the reference PathTracer (reference:
render/integrators/pt.cpp): per-vertex emitter-hit MIS with area->solid-
angle pdf conversion (pt.cpp:133-151), environment-miss shading
(pt.cpp:95-116), one uniformly-chosen light per vertex for NEE
(compute_direct_illum, pt.cpp:17-44), BSDF bounce with Russian roulette
and a path-length cap (bounce, pt.cpp:46-80).

Architecture is inverted from the reference: instead of host threads
draining tile queues with per-bounce device round trips
(ray_queue.h:277-292), the *whole* frame is a single jitted program — a
`lax.fori_loop` over bounces; every iteration traverses, shades and
extends all rays with active-lane masks.  Queue compaction
(ray_queue.h:161-207) becomes lane masking; the material sort
(ray_queue.h:211-244) becomes branchless all-material shading; the atomic
framebuffer becomes one segment-sum at the end.

`trace_paths` is the shard-agnostic core: the single-chip frame renderer
and the shard_map multi-chip path (parallel/shard.py) both call it.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

from ...core import rng as rng_mod
from ...core.sampling import mis_power_heuristic, russian_roulette_prob
from ...core.vecmath import dot, normalize
from .. import envmap as envmap_mod
from .. import lights as light_mod
from .. import materials as mat_mod
from ..camera import Camera, generate_ray
from ..film import splat
from ..intersect import BIG
from ..surface import make_interaction
from ..traverse import Hit, any_hit, closest_hit


def alpha_fn_for(scene):
    """Transparency-mask hook for traversal (the reference's "masked"
    kernel variants); None-able at call sites for mask-free scenes.

    Fast path: the pre-joined narrow mask record (TriAttrs.mask_rec,
    built in scene/build.py) makes each alpha test TWO gathers (row +
    texel) instead of the ~6-deep chain through shade record, material
    row and atlas geometry — gathers are the flat per-lane cost on this
    chip (CLAUDE.md), so depth-of-chain is the whole cost.  The texel
    math reproduces textures.sample_mask bit-exactly (same wrap, same
    binarisation, core/mask.h:33-40).  IMBA_MASK_REC=0 restores the
    chained path (A/B control)."""
    import os as _o

    mask_rec = getattr(scene.attrs, "mask_rec", None)
    if mask_rec is not None and _o.environ.get("IMBA_MASK_REC", "1") != "0":

        def alpha_fn(prim, u, v):
            import jax.lax

            from ...scene.textures import _wrap_uv

            rec = mask_rec[prim]
            mt = jax.lax.bitcast_convert_type(rec[:, 0], jnp.int32)
            w = jax.lax.bitcast_convert_type(rec[:, 1], jnp.int32)
            h = jax.lax.bitcast_convert_type(rec[:, 2], jnp.int32)
            off = jax.lax.bitcast_convert_type(rec[:, 3], jnp.int32)
            w0 = 1.0 - u - v
            tu = w0 * rec[:, 4] + u * rec[:, 6] + v * rec[:, 8]
            tv = w0 * rec[:, 5] + u * rec[:, 7] + v * rec[:, 9]
            tu, tv = _wrap_uv(tu, tv)
            x = jnp.clip((tu * w.astype(jnp.float32)).astype(jnp.int32),
                         0, w - 1)
            y = jnp.clip((tv * h.astype(jnp.float32)).astype(jnp.int32),
                         0, h - 1)
            texel = scene.textures.texels[off + y * w + x]
            return (jnp.sum(texel, axis=-1) > 0.0) | (mt < 0)

        return alpha_fn

    def alpha_fn(prim, u, v):
        import jax.lax

        from ...scene.textures import sample_mask

        rec = scene.attrs.rec[prim]
        mat_id = jax.lax.bitcast_convert_type(rec[:, 18], jnp.int32)
        mt = jax.lax.bitcast_convert_type(
            scene.materials.rec[jnp.maximum(mat_id, 0), 17], jnp.int32
        )
        w0 = 1.0 - u - v
        tu = w0 * rec[:, 12] + u * rec[:, 14] + v * rec[:, 16]
        tv = w0 * rec[:, 13] + u * rec[:, 15] + v * rec[:, 17]
        return sample_mask(scene.textures, mt, tu, tv)

    return alpha_fn


def trace_paths(
    scene,
    org,
    d,
    state,
    max_len: int,
    has_masks: bool = False,
    has_bump: bool = False,
    with_stats: bool = False,
    ablate: tuple = (),
):
    """Trace a batch of camera paths to completion.

    org/d: (R, 3) primary rays; state: (R,) RNG states.
    Returns per-ray accumulated radiance (R, 3); with stats, also a scalar
    count of traced rays (closest-hit + occlusion), the quantity the
    reference's schedulers report (tile_scheduler.h:59-61).

    `ablate` is a PROFILING knob (results are wrong when non-empty): a
    static tuple of megastep components to compile out, used to attribute
    the frame cost.
    Recognised: "shadow" (skip the NEE any_hit), "nee" (skip NEE
    entirely), "emit" (skip emitter-hit shading+termination), "env",
    "bounce" (continue straight, no BSDF sampling/RR), "trace" (skip
    closest_hit; synthetic hit at t=1).
    """
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    carry = _init_carry(org, d, state)
    defer = _use_shadow_defer()
    if defer:
        fz = 0.0 * carry["radiance"][0, 0]
        carry["slog"] = jnp.zeros(
            (_SLOG_COLS, max_len, org.shape[0]), jnp.float32) + fz
        carry["srow"] = jnp.int32(0) + 0 * carry["depth"][0]

    def bounce_body(i, c):
        return _pt_bounce(scene, c, alpha_fn=alpha_fn, has_bump=has_bump,
                          max_len=max_len,
                          ablate=ablate)

    out = jax.lax.fori_loop(0, max_len, bounce_body, carry)
    radiance = out["radiance"]
    if defer:
        radiance = radiance + _resolve_slog(
            scene, out["slog"], alpha_fn=alpha_fn)
    if with_stats:
        return radiance, out["n_rays"]
    return radiance


#  Deferred NEE occlusion (a different frame shape for the fused frame):
#  shadow rays are read-only w.r.t. the path carry and consume no RNG, so
#  each bounce can LOG its ray + contribution (component-major slog) and
#  they are all resolved in chunked any_hit dispatches after
#  the loop.  Estimator-exact; only float accumulation order and the
#  megastep's fusion shape change.  IMBA_SHADOW_DEFER=1 enables it
#  (trace-time read; default off, not measured on the H100).

_SLOG_COLS = 12  # org 3 | dir 3 | tmin 1 | tmax 1 | contrib 3 | ok 1


def _use_shadow_defer() -> bool:
    return os.environ.get("IMBA_SHADOW_DEFER", "0") == "1"


def _occlusion_batch(scene, org, d, tmin, tmax, ok, *, alpha_fn):
    """Chunked any_hit over a flat batch of shadow rays; returns occ in
    input order.  Chunks are BAND_RAYS-sized, as the bands are."""
    total = org.shape[0]
    occ_parts = []
    for s in range(0, total, BAND_RAYS):
        e = min(s + BAND_RAYS, total)
        occ_parts.append(any_hit(
            scene.bvh, org[s:e], d[s:e], tmin[s:e], tmax[s:e],
            alpha_fn=alpha_fn, active=ok[s:e]))
    return occ_parts[0] if len(occ_parts) == 1 else jnp.concatenate(occ_parts)


def _resolve_slog(scene, slog, *, alpha_fn):
    """Occlusion-test every logged shadow ray and return the per-lane
    NEE radiance (L, 3) summed over bounces."""
    nrows, m_, l_ = slog.shape
    comp = slog.reshape(nrows, m_ * l_)
    occ = _occlusion_batch(
        scene, comp[0:3].T, comp[3:6].T, comp[6], comp[7],
        comp[11] > 0.5, alpha_fn=alpha_fn)
    ok = (comp[11] > 0.5) & ~occ
    add = jnp.where(ok[:, None], comp[8:11].T, 0.0)
    return add.reshape(m_, l_, 3).sum(axis=0)


def _init_carry(org, d, state):
    """PT bounce-loop carry. Inits derived from inputs so they stay
    device-varying under shard_map."""
    zeros1 = jnp.zeros_like(org[:, 0])
    return dict(
        org=org,
        d=d,
        tmin=zeros1,
        throughput=jnp.ones_like(org),
        radiance=jnp.zeros_like(org),
        active=zeros1 < 1.0,
        depth=jnp.zeros_like(org[:, 0], dtype=jnp.int32),
        last_pdf=zeros1 + 1.0,
        last_specular=zeros1 < 1.0,
        state=state,
        n_rays=jnp.sum(jnp.zeros_like(org[:1, 0], dtype=jnp.int32)),
    )


def _pt_bounce(scene, c, *, alpha_fn, has_bump, max_len,
               ablate=()):
    """One PT bounce for every lane of the carry (trace + env/emitter MIS
    + NEE + BSDF extension).  Per-lane `depth` replaces the loop index so
    the same body drives both the plain megastep (all lanes in lockstep)
    and the regenerated wavefront (lanes at mixed depths,
    render_pt_frame_regen).  `ablate`: see trace_paths (profiling only)."""
    num_lights = scene.lights.kind.shape[0]
    first = c["depth"] == 0
    if "trace" in ablate:
        hit = Hit(t=jnp.ones_like(c["tmin"]),
                  prim_id=jnp.zeros_like(c["depth"]),
                  u=jnp.full_like(c["tmin"], 0.3),
                  v=jnp.full_like(c["tmin"], 0.3))
    else:
        hit = closest_hit(
            scene.bvh, c["org"], c["d"], c["tmin"], BIG,
            alpha_fn=alpha_fn, active=c["active"],
        )
    n_rays = c["n_rays"] + jnp.sum(c["active"].astype(jnp.int32))

    # ---- environment misses (pt.cpp:95-116) ------------------------
    miss = c["active"] & (hit.prim_id < 0)
    radiance = c["radiance"]
    if scene.env is not None and "env" not in ablate:
        li, pdf_direct_w, _ = envmap_mod.radiance(
            scene.env, normalize(c["d"]), scene.bsphere.inv_radius_sqr
        )
        pdf_di = pdf_direct_w / num_lights
        w = jnp.where(
            first | c["last_specular"],
            1.0,
            mis_power_heuristic(c["last_pdf"], pdf_di),
        )
        radiance = radiance + jnp.where(
            miss[..., None], c["throughput"] * li * w[..., None], 0.0
        )
    active = c["active"] & ~miss

    isect = make_interaction(scene, hit, c["org"], c["d"], has_bump=has_bump)
    if "interaction" in ablate:
        # Profiling only: synthesize the interaction from per-lane hit
        # data so XLA DCEs the shade-record fetch but every downstream
        # consumer (emit/NEE/bounce math) stays live and lane-varying.
        from ..surface import SurfaceInteraction
        from .. import materials as _mm

        # Lane-varying but always in w_out's hemisphere (a random fake
        # normal kills every lane through the hemisphere validity
        # checks in sample_bsdf).
        n_fake = normalize(2.0 * isect.w_out
                           + 0.3 * jnp.sin(17.0 * isect.pos))
        isect = SurfaceInteraction(
            pos=isect.pos, w_out=isect.w_out, normal=n_fake, gn=n_fake,
            uv=jnp.stack([hit.u, hit.v], -1),
            mat_id=jnp.zeros_like(hit.prim_id),
            light_id=hit.prim_id % 7 - 5,
            emit=jnp.broadcast_to(jnp.float32(0.5), isect.pos.shape)
            * (1.0 + 0.0 * hit.t[..., None]),
            area=jnp.abs(hit.u) + 0.5,
            params=_mm.MatParams(
                kind=jnp.zeros_like(hit.prim_id),
                kd=0.25 + 0.5 * jnp.abs(n_fake),
                ks=0.1 + 0.0 * n_fake, tf=0.0 * n_fake,
                ns=10.0 + hit.u, ior=1.3 + 0.0 * hit.u,
                emit=0.5 + 0.0 * n_fake,
                kd_tex=jnp.zeros_like(hit.prim_id) - 1,
                bump_tex=jnp.zeros_like(hit.prim_id) - 1,
                mask_tex=jnp.zeros_like(hit.prim_id) - 1,
            ),
        )

    # ---- emitter hits (pt.cpp:133-151) -----------------------------
    if "emit" not in ablate:
        is_emitter = active & (isect.light_id >= 0)
        cos_geom = dot(isect.gn, isect.w_out)
        cos_shade = dot(isect.normal, isect.w_out)
        emit_intensity = isect.emit
        area = jnp.maximum(isect.area, 1e-12)
        d_sqr = hit.t * hit.t
        pdf_di_emit = (1.0 / area) / num_lights * d_sqr / jnp.where(
            cos_shade <= 0.0, 1.0, cos_shade
        )
        w_emit = jnp.where(
            first | c["last_specular"],
            1.0,
            mis_power_heuristic(c["last_pdf"], pdf_di_emit),
        )
        emit_ok = is_emitter & (cos_geom > 0.0) & (cos_shade > 0.0)
        radiance = radiance + jnp.where(
            emit_ok[..., None], c["throughput"] * emit_intensity * w_emit[..., None], 0.0
        )
        active = active & ~is_emitter  # emitter hits terminate (pt.cpp:152)

    # Profiling-only RNG stand-in ("rng" ablation): lane-varying floats
    # from a two-op hash of state already in registers, so the PCG
    # chains DCE but every consumer stays live and lane-varying.
    def _fake_floats(k, count):
        base = (c["org"][..., 0] * 12.9898 + c["org"][..., 2] * 78.233
                + c["depth"].astype(jnp.float32) * 0.731 + k)
        return tuple(jnp.mod(base * (0.61 + 0.07 * i) + 0.13 * i, 1.0)
                     for i in range(count))

    # ---- next-event estimation (pt.cpp:17-44) ----------------------
    st = c["state"]
    slog = c.get("slog")
    if "nee" not in ablate:
        if "rng" in ablate:
            ul, ua, ub = _fake_floats(0.0, 3)
        else:
            st, (ul, ua, ub) = rng_mod.next_floats(st, 3)
        light_idx = jnp.minimum((ul * num_lights).astype(jnp.int32), num_lights - 1)
        ds = light_mod.sample_direct(
            scene.lights, light_idx, isect.pos, ua, ub, scene.bsphere, scene.env,
            kinds=scene.light_kinds,
        )
        f_nee, pdf_hit, _ = mat_mod.eval_pdf_bsdf(
            isect.params, isect.normal, isect.gn, isect.w_out, ds.dir,
            kinds=scene.mat_kinds,
        )
        pdf_lightpick = 1.0 / num_lights
        pdf_di = pdf_lightpick * ds.pdf_direct_w
        w_nee = jnp.where(ds.is_delta, 1.0, pdf_di / jnp.maximum(pdf_di + pdf_hit, 1e-20))
        contrib = (
            c["throughput"]
            * f_nee
            * ds.radiance
            * (jnp.abs(dot(isect.normal, ds.dir)) * w_nee / pdf_lightpick)[..., None]
        )
        shadow_ok = (
            active
            & (pdf_hit > 0.0)
            & (pdf_di > 0.0)
            & jnp.any(contrib > 0.0, axis=-1)
        )
        offset = 1e-3 * jnp.where(ds.distance >= BIG, 1.0, ds.distance)
        if "shadow" in ablate:
            occluded = jnp.zeros_like(shadow_ok)
            radiance = radiance + jnp.where(
                (shadow_ok & ~occluded)[..., None], contrib, 0.0)
            n_rays = n_rays + jnp.sum(shadow_ok.astype(jnp.int32))
        elif "slog" in c:
            # Deferred occlusion (IMBA_SHADOW_DEFER): log the shadow ray
            # + its contribution; every bounce's rays are resolved in
            # chunked any_hit dispatches AFTER the loop
            # (_resolve_slog).  Occlusion is read-only w.r.t. the path
            # carry and consumes no RNG, so deferral is estimator-exact;
            # only the fusion shape of the bounce body changes.
            rec = jnp.concatenate([
                isect.pos.T, ds.dir.T, offset[None],
                (ds.distance - offset)[None], contrib.T,
                shadow_ok.astype(jnp.float32)[None],
            ], axis=0)
            slog = jax.lax.dynamic_update_slice(
                c["slog"], rec[:, None, :], (0, c["srow"], 0))
            n_rays = n_rays + jnp.sum(shadow_ok.astype(jnp.int32))
        else:
            occluded = any_hit(
                scene.bvh, isect.pos, ds.dir, offset, ds.distance - offset,
                alpha_fn=alpha_fn, active=shadow_ok,
            )
            radiance = radiance + jnp.where(
                (shadow_ok & ~occluded)[..., None], contrib, 0.0)
            n_rays = n_rays + jnp.sum(shadow_ok.astype(jnp.int32))

    # ---- bounce (pt.cpp:46-80) -------------------------------------
    if "bounce" in ablate:
        # Continue straight with unchanged throughput — keeps the
        # traversal loop alive with everything else compiled out.
        ret = dict(
            org=c["org"] + hit.t[..., None] * c["d"],
            d=c["d"],
            tmin=jnp.full_like(c["tmin"], 1e-3),
            throughput=c["throughput"], radiance=radiance, active=active,
            depth=c["depth"] + 1, last_pdf=c["last_pdf"],
            last_specular=c["last_specular"], state=st, n_rays=n_rays,
        )
        if slog is not None:
            ret["slog"] = slog
            ret["srow"] = c["srow"] + 1
        return ret
    if "rng" in ablate:
        urr, u1, u2, u3 = _fake_floats(3.0, 4)
    else:
        st, (urr, u1, u2, u3) = rng_mod.next_floats(st, 4)
    if "rr" in ablate:
        rr_pdf = jnp.ones_like(urr)
        survive = urr > -1.0
    else:
        rr_pdf = russian_roulette_prob(c["throughput"])
        survive = urr < rr_pdf
    if "bsdf" in ablate:
        # Profiling only: deterministic hemisphere direction (mirror
        # reflection about the shading normal) with flat f/pdf, so the
        # whole sampling chain DCEs but the carry update, RR, traversal
        # and NEE of later bounces stay live and lane-varying.
        nn = isect.normal
        wi = normalize(2.0 * dot(nn, isect.w_out)[..., None] * nn
                       - isect.w_out)
        f = isect.params["kd"] * 0.3183
        pdf = jnp.full_like(u1, 0.5)
        spec = u1 > 2.0
        valid = u1 > -1.0
    else:
        wi, f, pdf, spec, valid = mat_mod.sample_bsdf(
            isect.params, isect.normal, isect.gn, isect.w_out, u1, u2, u3,
            kinds=scene.mat_kinds,
        )
    cos_term = jnp.abs(dot(isect.normal, wi))
    new_throughput = (
        c["throughput"] * f * (cos_term / jnp.maximum(pdf * rr_pdf, 1e-20))[..., None]
    )
    active = active & survive & valid & (c["depth"] + 1 < max_len)

    ret = dict(
        org=jnp.where(active[..., None], isect.pos, c["org"]),
        d=jnp.where(active[..., None], wi, c["d"]),
        tmin=jnp.where(active, 1e-3 * hit.t, c["tmin"]),
        throughput=jnp.where(active[..., None], new_throughput, c["throughput"]),
        radiance=radiance,
        active=active,
        depth=jnp.where(active, c["depth"] + 1, c["depth"]),
        last_pdf=jnp.where(active, pdf, c["last_pdf"]),
        last_specular=jnp.where(active, spec, c["last_specular"]),
        state=st,
        n_rays=n_rays,
    )
    if slog is not None:
        ret["slog"] = slog
        ret["srow"] = c["srow"] + 1
    return ret


def _tile_perm(num_pixels: int, width: int, tw: int = 32, th: int = 16):
    """Static permutation ordering a contiguous pixel band into (tw x th)
    image tiles, so each traversal block of neighbouring rays is a compact
    frustum instead of part of one image row.  Identity when the band is not
    row-aligned.  Returns (perm, inv_perm) as np arrays or (None, None)."""
    import numpy as np

    if num_pixels % width != 0 or num_pixels < width * th:
        return None, None
    i = np.arange(num_pixels)
    x, y = i % width, i // width
    perm = np.lexsort((x % tw, y % th, x // tw, y // th)).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(num_pixels, dtype=np.int32)
    return perm, inv


def unswizzle_film(radiance, spp: int, num_pixels: int, width: int):
    """Undo _tile_perm ordering and reduce spp: (spp*P, 3) -> (P, 3)."""
    _, inv = _tile_perm(num_pixels, width)
    r = radiance.reshape(spp, num_pixels, 3)
    if inv is not None:
        r = jnp.take(r, jnp.asarray(inv), axis=1)
    return r.sum(axis=0)


def camera_rays(cam: Camera, width: int, height: int, spp: int, frame,
                start_pixel: int = 0, count: int = 0):
    """Jittered primary rays + per-ray RNG state + pixel ids.

    start_pixel/count select a contiguous pixel band (used to split big
    frames into multiple dispatches); RNG streams are keyed by the global
    pixel id so banding never changes the rendered image.  Within a band,
    rays are emitted in image-tile order (see _tile_perm) — the pixel ids
    keep their global values, so the image is bitwise identical; callers
    reduce with unswizzle_film."""
    num_pixels = count if count > 0 else width * height
    rel = jnp.arange(num_pixels, dtype=jnp.int32)
    perm, _ = _tile_perm(num_pixels, width)
    if perm is not None:
        rel = jnp.asarray(perm)
    pixel_id = jnp.tile(start_pixel + rel, spp)
    sample_id = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), num_pixels)
    state = rng_mod.seed(pixel_id, sample_id, frame)
    state, (jx, jy) = rng_mod.next_floats(state, 2)
    px = (pixel_id % width).astype(jnp.float32) + jx
    py = (pixel_id // width).astype(jnp.float32) + jy
    org, d = generate_ray(cam, px, py)
    return org, d, state, pixel_id


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_len", "has_masks",
                     "has_bump", "with_stats", "band_pixels",
                     "ablate"),
)
def _pt_band(
    scene, cam, frame, start_pixel, *, width, height, spp, max_len,
    has_masks, has_bump, with_stats, band_pixels, ablate=(),
):
    org, d, state, pixel_id = camera_rays(
        cam, width, height, spp, frame, start_pixel=start_pixel,
        count=band_pixels,
    )
    out = trace_paths(
        scene, org, d, state, max_len,
        has_masks=has_masks, has_bump=has_bump, with_stats=with_stats,
        ablate=ablate,
    )
    # pixel ids are a static permutation of start + arange(B) tiled by spp,
    # so the "scatter" is an un-permute + reshape+sum — no scatter op.
    def fast_splat(radiance):
        return unswizzle_film(radiance, spp, band_pixels, width)

    if with_stats:
        radiance, n_rays = out
        return fast_splat(radiance), n_rays
    return fast_splat(out)


# Rays-per-dispatch cap (same rationale as vcm.BAND_RAYS: monolithic
# million-ray frame graphs over large BVHs exhaust device memory).
BAND_RAYS = 1 << 18

# ---------------------------------------------------------------------------
# Mid-frame lane compaction (the reference's RayQueue::compact,
# ray_queue.h:161-207, recast for fixed-shape dispatch): the lockstep
# megastep pays full per-bounce cost for every lane while Russian
# roulette and emitter hits kill most paths within a few bounces
# (~27% mean lane utilisation on cornell at max_len=10).  After
# `IMBA_PT_COMPACT_DEPTH` bounces the per-band carries are merged, lanes
# are stably sorted dead-last (one lax.sort over the ~19 carry columns),
# and only the first
# ceil(alive / BAND_RAYS) bands keep bouncing.  Per-lane math (RNG state
# rides with the lane) is bit-identical to the banded renderer; only the
# film summation order changes (one scatter-add at frame end instead of
# per-band reshape-sums).  One host sync per frame reads the alive count
# to pick the phase-2 band count.
# ---------------------------------------------------------------------------

def compact_depth(max_len: int) -> int:
    d = int(os.environ.get("IMBA_PT_COMPACT_DEPTH", "3"))
    return max(1, min(d, max_len - 1))


# Defaults for the two frame shapes below (IMBA_PT_COMPACT / IMBA_PT_FUSE
# = 1/0 override them for measurement and tests).  Measured on an H100
# 80GB HBM3 at 700 W, PT 1024² ms/frame (median of 5): fused 8.75 vs
# banded 10.61 vs compacted 17.87 on cornell; fused 22.56 vs banded 25.04
# vs compacted 29.17 on the 48k-triangle big scene.
PT_COMPACT = False
PT_FUSE = True


def _use_compact(num_bands: int, max_len: int) -> bool:
    """Mid-frame lane compaction for multi-band frames (see the block
    comment above)."""
    env = os.environ.get("IMBA_PT_COMPACT", "")
    if env == "0" or num_bands <= 1 or max_len < 2:
        return False
    return env == "1" or (env == "" and PT_COMPACT)


def use_fused_frame(num_bands: int, max_len: int) -> bool:
    """Fuse the whole banded frame into ONE device dispatch (an outer jit
    around the Python band loop, which then unrolls into a single graph).

    Incompatible with mid-frame compaction (it reads the alive count on
    the host to pick the phase-2 band count), so it applies only when
    compaction is off."""
    env = os.environ.get("IMBA_PT_FUSE", "")
    if env == "0" or num_bands <= 1:
        return False
    if _use_compact(num_bands, max_len):
        return False
    return env == "1" or (env == "" and PT_FUSE)


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_len", "has_masks",
                     "has_bump", "band_pixels", "bounces"),
)
def _pt_phase1(
    scene, cam, frame, start_pixel, *, width, height, spp, max_len,
    has_masks, has_bump, band_pixels, bounces,
):
    """Camera rays + the first `bounces` PT bounces of one pixel band;
    returns the live carry and the per-lane pixel ids."""
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    org, d, state, pixel_id = camera_rays(
        cam, width, height, spp, frame, start_pixel=start_pixel,
        count=band_pixels,
    )
    c = _init_carry(org, d, state)
    defer = _use_shadow_defer()
    if defer:
        fz = 0.0 * c["radiance"][0, 0]
        c["slog"] = jnp.zeros(
            (_SLOG_COLS, bounces, org.shape[0]), jnp.float32) + fz
        c["srow"] = jnp.int32(0) + 0 * c["depth"][0]

    def body(i, cc):
        return _pt_bounce(scene, cc, alpha_fn=alpha_fn, has_bump=has_bump,
                          max_len=max_len)

    out = jax.lax.fori_loop(0, bounces, body, c)
    if defer:
        # Flush phase-1 shadows BEFORE the carry compaction sort (the
        # 3-D slog can't ride _compact_carry's lane sort).
        out.pop("srow")
        out["radiance"] = out["radiance"] + _resolve_slog(
            scene, out.pop("slog"), alpha_fn=alpha_fn)
    return out, pixel_id


@partial(
    jax.jit,
    static_argnames=("max_len", "has_masks", "has_bump", "bounces"),
)
def _pt_phase2(scene, c, *, max_len, has_masks, has_bump, bounces):
    """Continue a (compacted) carry for the remaining `bounces`; the
    bounce body is depth-per-lane so mixed-progress lanes are fine."""
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    defer = _use_shadow_defer()
    if defer:
        c = dict(c)
        fz = 0.0 * c["radiance"][0, 0]
        c["slog"] = jnp.zeros(
            (_SLOG_COLS, bounces, c["d"].shape[0]), jnp.float32) + fz
        c["srow"] = jnp.int32(0) + 0 * c["depth"][0]

    def body(i, cc):
        return _pt_bounce(scene, cc, alpha_fn=alpha_fn, has_bump=has_bump,
                          max_len=max_len)

    out = jax.lax.fori_loop(0, bounces, body, c)
    if defer:
        out.pop("srow")
        out["radiance"] = out["radiance"] + _resolve_slog(
            scene, out.pop("slog"), alpha_fn=alpha_fn)
    return out


@jax.jit
def _compact_carry(c, pixel_id):
    """Stable-sort all carry lanes dead-last.  One multi-operand lax.sort
    (key + every carry column + pixel id) — no per-column gathers.
    Shape/dtype-introspective so any lockstep wavefront carry (PT's, the
    VCM camera pass's) compacts through the same sort.  Returns
    (sorted carry, sorted pixel ids, alive count)."""
    key = (~c["active"]).astype(jnp.int32)
    ops, spec = [key], []
    for name in sorted(c.keys()):
        a = c[name]
        if a.ndim == 2:
            at = a.T
            for j in range(a.shape[1]):
                ops.append(at[j])
            spec.append((name, a.shape[1], None))
        elif a.dtype == jnp.bool_:
            ops.append(a.astype(jnp.int32))
            spec.append((name, 0, jnp.bool_))
        else:
            ops.append(a)
            spec.append((name, 0, None))
    ops.append(pixel_id)
    out = jax.lax.sort(tuple(ops), num_keys=1, is_stable=True)
    i, sc = 1, {}
    for name, ncol, cast in spec:
        if ncol:
            sc[name] = jnp.stack(out[i:i + ncol], axis=1)
            i += ncol
        else:
            sc[name] = out[i] > 0 if cast is jnp.bool_ else out[i]
            i += 1
    return sc, out[i], jnp.sum(c["active"].astype(jnp.int32))


@partial(jax.jit, static_argnames=("num_pixels",))
def _scatter_film(pid, rad, *, num_pixels):
    return jnp.zeros((num_pixels, 3), rad.dtype).at[pid].add(rad)


def _render_pt_frame_compact(
    scene, cam, frame, width, height, spp, max_len, has_masks, has_bump,
    with_stats, band,
):
    num_pixels = width * height
    depth0 = compact_depth(max_len)
    kw = dict(width=width, height=height, spp=spp, max_len=max_len,
              has_masks=has_masks, has_bump=has_bump)

    carries, pixel_ids, n_rays = [], [], []
    for start in range(0, num_pixels, band):
        bp = min(band, num_pixels - start)
        c, pid = _pt_phase1(scene, cam, frame, jnp.int32(start),
                            band_pixels=bp, bounces=depth0, **kw)
        n_rays.append(c.pop("n_rays"))
        carries.append(c)
        pixel_ids.append(pid)
    merged = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *carries)
    pix = jnp.concatenate(pixel_ids, axis=0)
    sc, pix, alive = _compact_carry(merged, pix)

    lanes = pix.shape[0]
    band_lanes = band * spp
    forced_k = os.environ.get("IMBA_PT_COMPACT_K", "")
    if forced_k:
        # Measurement knob: skip the alive-count host sync and run a fixed
        # phase-2 band count.  EXACT ONLY IF alive <= K*band_lanes — for
        # profiling the sync cost, not a production default.
        n_bands2 = min(int(forced_k), -(-lanes // band_lanes))
    else:
        n_alive = int(alive)  # the one host sync: picks the phase-2 band count
        n_bands2 = -(-n_alive // band_lanes) if n_alive else 0

    rad_parts, done = [], 0
    for k in range(n_bands2):
        end = min(done + band_lanes, lanes)
        ck = jax.tree_util.tree_map(lambda a: a[done:end], sc)
        ck["n_rays"] = jnp.zeros((), jnp.int32)
        out = _pt_phase2(scene, ck, max_len=max_len, has_masks=has_masks,
                         has_bump=has_bump,
                         bounces=max_len - depth0)
        n_rays.append(out.pop("n_rays"))
        rad_parts.append(out["radiance"])
        done = end
    if done < lanes:
        rad_parts.append(sc["radiance"][done:])
    rad = rad_parts[0] if len(rad_parts) == 1 else jnp.concatenate(
        rad_parts, axis=0)
    film = _scatter_film(pix, rad, num_pixels=num_pixels)
    if with_stats:
        stats = n_rays[0]
        for n in n_rays[1:]:
            stats = stats + n
        return film, stats
    return film

# Regenerated-wavefront tuning: assumed mean path length (steps per
# megastep launch = ceil(total_paths * REGEN_EST_BOUNCES / lanes)); only
# affects how often the host checks for completion, never correctness.
REGEN_EST_BOUNCES = 4


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_len", "has_masks",
                     "has_bump", "steps", "num_paths",
                     "flush", "reseed"),
)
def _pt_regen_megastep(scene, cam, frame, c, *, width, height, spp, max_len,
                       has_masks, has_bump, steps, num_paths,
                       flush=True, reseed=True):
    """`steps` regeneration+bounce iterations over a fixed lane pool.

    The reference reclaims dead queue slots with RayQueue::compact +
    regeneration from the tile generator (ray_queue.h:145-221,
    tile_scheduler.h); here dead lanes are re-seeded in place from a
    global path counter, so the wavefront stays ~full while Russian
    roulette and emitter hits drain paths at mixed depths.  Per-path
    math (RNG keyed by pixel/sample/frame) is identical to the banded
    renderer; only film summation order differs."""
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    num_pixels = width * height
    lanes = c["org"].shape[0]
    perm, _ = _tile_perm(num_pixels, width)
    perm_arr = (jnp.asarray(perm) if perm is not None
                else jnp.arange(num_pixels, dtype=jnp.int32))

    def step_body(s, carry):
        # ---- flush + regenerate dead lanes ---------------------------
        # Finished paths append their (pixel, radiance) to a per-step
        # LOG ROW (a dynamic_update_slice — aliased in place) instead of
        # scattering into the film (an in-loop scatter-add de-vectorised
        # on the previous accelerator); the whole log flushes in ONE
        # scatter after the loop.
        # (`flush`/`reseed` are profiling knobs: False skips the log
        # write / the whole reseed block — results are WRONG either way.)
        c, log_pix, log_rad = carry
        dead = ~c["active"]
        fl = dead & (c["lane_pixel"] >= 0)
        if flush:
            log_pix = jax.lax.dynamic_update_slice(
                log_pix,
                jnp.where(fl, c["lane_pixel"], -1)[None], (s, 0))
            log_rad = jax.lax.dynamic_update_slice(
                log_rad,
                jnp.where(fl[:, None], c["radiance"], 0.0)[None],
                (s, 0, 0))

        if not reseed:
            out = _pt_bounce(scene, c_strip(c), alpha_fn=alpha_fn,
                             has_bump=has_bump, max_len=max_len)
            out["film"] = c["film"]
            out["lane_pixel"] = c["lane_pixel"]
            out["next_id"] = c["next_id"]
            return out, log_pix, log_rad

        rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
        new_id = c["next_id"] + rank
        start = dead & (new_id < num_paths)
        nid = jnp.where(start, new_id, 0)
        sid = (nid // num_pixels).astype(jnp.uint32)
        pid = perm_arr[nid % num_pixels]
        rst = rng_mod.seed(pid, sid, frame)
        rst, (jx, jy) = rng_mod.next_floats(rst, 2)
        px = (pid % width).astype(jnp.float32) + jx
        py = (pid // width).astype(jnp.float32) + jy
        org0, d0 = generate_ray(cam, px, py)

        start3 = start[:, None]
        cc = dict(
            org=jnp.where(start3, org0, c["org"]),
            d=jnp.where(start3, d0, c["d"]),
            tmin=jnp.where(start, 0.0, c["tmin"]),
            throughput=jnp.where(start3, 1.0, c["throughput"]),
            radiance=jnp.where((fl | start)[:, None], 0.0, c["radiance"]),
            active=c["active"] | start,
            depth=jnp.where(start, 0, c["depth"]),
            last_pdf=jnp.where(start, 1.0, c["last_pdf"]),
            last_specular=jnp.where(start, True, c["last_specular"]),
            state=jnp.where(start, rst, c["state"]),
            n_rays=c["n_rays"],
        )
        out = _pt_bounce(scene, cc, alpha_fn=alpha_fn, has_bump=has_bump,
                         max_len=max_len)
        out["film"] = c["film"]
        out["lane_pixel"] = jnp.where(
            start, pid, jnp.where(fl, -1, c["lane_pixel"]))
        out["next_id"] = c["next_id"] + jnp.sum(start.astype(jnp.int32))
        return out, log_pix, log_rad

    def c_strip(c):
        return {k: v for k, v in c.items()
                if k not in ("film", "lane_pixel", "next_id")}

    log_pix0 = jnp.full((steps, lanes), -1, jnp.int32)
    log_rad0 = jnp.zeros((steps, lanes, 3), jnp.float32)
    c, log_pix, log_rad = jax.lax.fori_loop(
        0, steps, step_body, (c, log_pix0, log_rad0))
    # One memory-speed scatter for every path the launch finished.
    flat_pix = log_pix.reshape(-1)
    c["film"] = c["film"].at[
        jnp.where(flat_pix >= 0, flat_pix, num_pixels)
    ].add(jnp.where((flat_pix >= 0)[:, None],
                    log_rad.reshape(-1, 3), 0.0), mode="drop")
    return c


def render_pt_frame_regen(
    scene,
    cam: Camera,
    frame: jnp.ndarray,
    width: int,
    height: int,
    spp: int = 1,
    max_len: int = 10,
    has_masks: bool = False,
    has_bump: bool = False,
    with_stats: bool = False,
):
    """render_pt_frame with lane regeneration (see _pt_regen_megastep).

    Identical estimator (per-path RNG/contributions match the banded
    renderer exactly); the film differs only by float summation order.
    Host loop: launch megasteps until the path queue is exhausted and
    every lane is dead (one device sync per launch)."""
    frame = jnp.asarray(frame, jnp.uint32)
    num_pixels = width * height
    num_paths = num_pixels * spp
    lanes = min(BAND_RAYS, max(num_paths, 1))

    z1 = jnp.zeros((lanes,), jnp.float32)
    z3 = jnp.zeros((lanes, 3), jnp.float32)
    c = dict(
        org=z3, d=z3.at[:, 2].set(1.0), tmin=z1,
        throughput=z3, radiance=z3,
        active=jnp.zeros((lanes,), bool),
        depth=jnp.zeros((lanes,), jnp.int32),
        last_pdf=z1, last_specular=jnp.zeros((lanes,), bool),
        state=rng_mod.seed(jnp.zeros((lanes,), jnp.int32), 0, frame),
        n_rays=jnp.zeros((), jnp.int32),
        film=jnp.zeros((num_pixels, 3), jnp.float32),
        lane_pixel=jnp.full((lanes,), -1, jnp.int32),
        next_id=jnp.zeros((), jnp.int32),
    )

    steps0 = max(max_len, -(-num_paths * REGEN_EST_BOUNCES // lanes))
    steps = steps0
    kw = dict(width=width, height=height, spp=spp, max_len=max_len,
              has_masks=has_masks, has_bump=has_bump,
              num_paths=num_paths)
    while True:
        c = _pt_regen_megastep(scene, cam, frame, c, steps=steps, **kw)
        done = (int(c["next_id"]) >= num_paths
                and not bool(jnp.any(c["active"])))
        if done:
            break
        steps = max_len  # drain launches
    # Final flush of lanes that ended after the last regeneration check.
    film = c["film"].at[
        jnp.where(c["lane_pixel"] >= 0, c["lane_pixel"], num_pixels)
    ].add(jnp.where((c["lane_pixel"] >= 0)[:, None], c["radiance"], 0.0),
          mode="drop")
    if with_stats:
        return film, c["n_rays"]
    return film


def render_pt_frame(
    scene,
    cam: Camera,
    frame: jnp.ndarray,
    width: int,
    height: int,
    spp: int = 1,
    max_len: int = 10,
    has_masks: bool = False,
    has_bump: bool = False,
    with_stats: bool = False,
    ablate: tuple = (),
):
    """Render one progressive frame; returns an un-normalised (H*W, 3)
    radiance-sum film (divide by frames*spp for display, as the render
    window does, render_window.cpp:99-121).  Large frames are rendered in
    pixel bands (separate dispatches, bitwise-identical results).
    `ablate`: profiling-only component knockouts, see trace_paths."""
    frame = jnp.asarray(frame, jnp.uint32)
    num_pixels = width * height
    band = max(1, BAND_RAYS // max(spp, 1))
    num_bands = -(-num_pixels // band)
    if not ablate and _use_compact(num_bands, max_len):
        return _render_pt_frame_compact(
            scene, cam, frame, width, height, spp, max_len, has_masks,
            has_bump, with_stats, band,
        )
    parts = []
    stats = jnp.zeros((), jnp.int32)
    for start in range(0, num_pixels, band):
        bp = min(band, num_pixels - start)
        out = _pt_band(
            scene, cam, frame, jnp.int32(start), width=width, height=height,
            spp=spp, max_len=max_len, has_masks=has_masks, has_bump=has_bump,
            with_stats=with_stats, band_pixels=bp,
            ablate=ablate,
        )
        if with_stats:
            film_part, n = out
            parts.append(film_part)
            stats = stats + n
        else:
            parts.append(out)
    film = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
    if with_stats:
        return film, stats
    return film
