"""Vertex Connection and Merging and its sub-algorithms (BPT / PPM / LT /
PT') as one template over a static `algo` flag — the same compile-time
pruning idea as the reference (reference: render/integrators/vcm.h:37-43,
vcm.cpp:634-639), realised as Python-level static branching inside jit.

MIS algebra is the partial-weight scheme of the VCM technical report,
reproduced from the reference exactly:
- per-frame constants: progressive radius r_i = r0 / i^{0.5(1-alpha)},
  alpha = 0.75; eta_vcm = pi r^2 n_light_paths; mis_eta_vc = 1/eta_vcm;
  mis_eta_vm = eta_vcm (0 for BPT)                        (vcm.cpp:27-45)
- light-path init dVC/dVCM/dVM                            (vcm.cpp:85-96)
- camera init dVCM = n_light / pdf_cam_w                  (vcm.cpp:120-129)
- partial-weight completion at each hit (x t^2 / cos_o)   (vcm.cpp:228-234,
  384-386)
- bounce updates, specular and non-specular               (vcm.cpp:165-177)
- camera connection img<->surf pdf conversion             (vcm.cpp:289-307)
- NEE full weights                                        (vcm.cpp:441-486)
- vertex connection with the vertex-cache pdf factor
  count/(n_light_paths * num_connections)                 (vcm.cpp:488-569)
- vertex merging with Epanechnikov kernel                 (vcm.cpp:571-611)
- adjoint shading-normal correction for light paths       (vcm.h:119-125)

Deviations (documented): light paths are capped at `max_len` bounces (the
reference relies on Russian roulette alone, vcm.cpp:140-190 — a static
loop bound is required for jit, and connections beyond max_len are
filtered in both); the vertex cache is a fixed-capacity scatter-append
instead of a probe-sized atomic append (light_vertices.cpp:15-129);
light paths TERMINATE at emitter surfaces.  The reference's light pass
does not (process_light_rays, vcm.cpp:213-254 has no emitter check — a
light path that re-hits a lamp bounces off the lamp's diffuse MTL
material), while its camera pass terminates at every emitter hit
(vcm.cpp:394-412).  The two passes therefore integrate DIFFERENT
transport wherever a lamp can be re-hit, and the converged image
becomes a sampling-parameter-dependent mixture: on cornell_indirect
(lamp facing the ceiling 0.2 units away) the reference's own
estimators disagree — our faithful transcription measured LT +17.3%,
BPT +10.7% vs dedicated PT with the BPT mean moving with
light_path_count (1.079 @ 8k -> 1.133 @ 131k),
and the reference's shipped BPT golden sits +14% linear above PT.
Terminating light paths at emitters makes every algorithm in the
family integrate the camera-pass transport (lamps absorb), which is
what the dedicated path tracers on BOTH sides and the PT-rendered
cornell_org golden define as truth.

The wavefront structure mirrors pt.py: each pass is a fori_loop megastep
over fixed-size ray batches with lane masks.
"""

from __future__ import annotations

from functools import partial

import os

import jax
import jax.numpy as jnp

from ...core import rng as rng_mod
from ...core.sampling import PI, russian_roulette_prob
from ...core.vecmath import dot, normalize
from .. import envmap as envmap_mod
from .. import lights as light_mod
from .. import materials as mat_mod
from ..camera import Camera, generate_ray, raster_to_id, world_to_raster
from ..film import splat
from .. import hashgrid as hashgrid_mod
from ..hashgrid import build_hash_grid
from ..intersect import BIG
from ..light_cache import (LightVertexCache, append, append_packed,
                           canonicalize, empty_cache, pack_batch,
                           select_shallowest)
from ..surface import make_interaction
from ..traverse import any_hit, closest_hit
from .pt import alpha_fn_for, camera_rays

ALGOS = ("vcm", "bpt", "ppm", "lt", "pt")

# Sampling-technique tags for the MIS debugger (the reference's
# MISDebugger writes per-technique contribution images, render/debug/
# mis_debug.h:11-56; here each tag statically gates one contribution site
# while RNG streams stay identical, so isolated renders sum exactly to the
# full render -- a machine-checkable version of the reference's
# weights-sum-to-one inspection).
TECHNIQUES = ("light_hit", "next_event", "connect", "merge", "cam_connect")

mis_pow = lambda x: x  # power-1 heuristic (vcm.h:112-116)


def shading_normal_adjoint(normal, gn, w_out, w_in):
    """Veach's adjoint-BSDF cosine correction (vcm.h:119-125)."""
    denom = dot(w_out, gn)
    denom = jnp.where(jnp.abs(denom) < 1e-9, jnp.where(denom < 0, -1e-9, 1e-9), denom)
    return dot(w_out, normal) * dot(w_in, gn) / denom


def _vertex_from_rec(scene, rec_t):
    """Unpack a gathered+transposed (24, R) cache record
    (LightVertexCache.packed; transposed so component reads are contiguous
    row slices)."""
    from ...scene.textures import sample_bilinear

    bits = lambda row: jax.lax.bitcast_convert_type(rec_t[row], jnp.int32)
    mat_id = bits(14)
    uv = rec_t[12:14].T
    params = mat_mod.gather_params(scene.materials, mat_id)
    if scene.textures.texels.shape[0] > 1:
        kd = jnp.where(
            (params["kd_tex"] >= 0)[..., None],
            sample_bilinear(scene.textures, params["kd_tex"], uv[:, 0], uv[:, 1]),
            params["kd"],
        )
        params["kd"] = kd
    return dict(
        pos=rec_t[0:3].T, w_out=rec_t[3:6].T, normal=rec_t[6:9].T,
        gn=rec_t[9:12].T, params=params, throughput=rec_t[15:18].T,
        d_vc=rec_t[18], d_vcm=rec_t[19], d_vm=rec_t[20],
        path_length=bits(21),
    )


# ======================================================================
#  Light pass
# ======================================================================

def _per_path_cap(cache_capacity: int, light_path_count: int,
                  max_len: int) -> int:
    """Per-path vertex admission cap K (0 = unlimited).

    K = capacity // light_path_count; when K can't bind (>= the
    max_len - 1 storable vertices) or the config is degenerate, return
    0 and the cache falls back to plain append-order truncation.  See
    the flush-site comment in _light_pass for why admission must be a
    per-lane rule."""
    if light_path_count <= 0:
        return 0
    k = cache_capacity // light_path_count
    if k <= 0 or k >= max(max_len - 1, 1):
        return 0
    return k


def _light_pass(scene, cam: Camera, frame, pm_radius, base_radius, mis_eta_vc,
                mis_eta_vm, *, algo, num_pixels, light_path_count, max_len,
                cache_capacity, has_masks, has_bump, alpha_fn,
                techniques=TECHNIQUES, path_start=0, band_paths=0,
                cache_in=None, admit_cap=-1):
    num_lights = scene.lights.kind.shape[0]
    L = band_paths if band_paths > 0 else light_path_count
    pdf_lightpick = 1.0 / num_lights

    path_id = path_start + jnp.arange(L, dtype=jnp.int32)
    state = rng_mod.seed(path_id, frame, jnp.uint32(0x1157A9))
    # Uniform split of paths across lights (UniformLightTileGen,
    # reference: render/ray_gen/tile_gen.h:98-177; pdf approximated as
    # uniform pick, vcm.cpp:67-68).  The split is over the GLOBAL path
    # index so banding never changes which light a path samples.
    light_idx = (path_id * num_lights) // light_path_count
    state, (u1, u2, u3, u4) = rng_mod.next_floats(state, 4)
    es = light_mod.sample_emit(
        scene.lights, light_idx, u1, u2, u3, u4, scene.bsphere, scene.env,
        kinds=scene.light_kinds,
    )

    throughput = es.radiance / pdf_lightpick
    d_vcm = mis_pow(es.pdf_direct_a / jnp.maximum(es.pdf_emit_w, 1e-20))
    d_vc = jnp.where(
        es.is_delta, 0.0,
        mis_pow(es.cos_out / jnp.maximum(es.pdf_emit_w * pdf_lightpick, 1e-20)),
    )
    d_vm = d_vc * mis_eta_vc

    # Constant carry inits must be *derived from inputs* so they are
    # device-varying under shard_map (same rule as pt.trace_paths; a
    # replicated init whose loop-carried value becomes varying is a
    # shard_map type error).  path_id is ALWAYS varying (the shard wrapper
    # offsets path_start by axis_index); es.* is NOT a safe source — under
    # single-kind light specialization a delta emitter makes dir/radiance/
    # pdfs compile-time constants (point: radiance; dir: direction; all:
    # is_delta/pdf_direct_a), so every carry entry goes through _vary.
    iz = 0 * path_id[0]                              # varying i32 zero
    fz = iz.astype(jnp.float32)                      # varying f32 zero
    def _vary(a):
        if jnp.issubdtype(a.dtype, jnp.bool_):
            return a ^ (iz != 0)
        if jnp.issubdtype(a.dtype, jnp.integer):
            return a + iz.astype(a.dtype)
        return a + fz.astype(a.dtype)
    cache0 = empty_cache(cache_capacity) if cache_in is None else cache_in
    use_cc = algo != "ppm" and "cam_connect" in techniques
    use_cache = algo != "lt"
    # Per-bounce vertex records, logged and appended ONCE after the loop
    # (same pattern as the cc rows below: one scatter after the loop
    # instead of a 12-field scatter-append inside the fori body).
    # IMBA_APPEND_FLUSH=0 restores the in-loop append.
    flush_append = use_cache and os.environ.get(
        "IMBA_APPEND_FLUSH", "1") != "0"
    carry = dict(
        org=es.pos,
        d=es.dir,
        tmin=jnp.full((L,), 1e-3, jnp.float32),
        throughput=throughput,
        active=(es.pdf_emit_w > 0.0) & jnp.any(es.radiance != 0.0, axis=-1),
        finite=es.is_finite,
        d_vc=d_vc, d_vcm=d_vcm, d_vm=d_vm,
        state=state,
    )
    # Admission cap: derived from THIS cache's sizing by default; the
    # sharded driver overrides it with the GLOBAL (capacity, lpc) ratio
    # — its per-shard band caches are transport buffers whose local size
    # must not change the admission policy.
    k_cap = (_per_path_cap(cache_capacity, light_path_count, max_len)
             if admit_cap < 0 else admit_cap)
    if use_cache and flush_append:
        carry["vrec"] = jnp.zeros((max_len, L, 24), jnp.float32)
        carry["vstore"] = jnp.zeros((max_len, L), jnp.bool_)
    elif use_cache:
        carry["cache"] = cache0
        if k_cap > 0:
            carry["vcount"] = jnp.zeros((L,), jnp.int32)
    carry = jax.tree.map(_vary, carry)
    if use_cc:
        # Per-bounce camera-connection rows, logged and splatted ONCE
        # after the loop instead of a scatter-add per fori iteration.
        carry["cc"] = jnp.zeros((max_len, L, 3), jnp.float32) + fz
        carry["cp"] = jnp.full((max_len, L), -1, jnp.int32) + iz
        from .pt import _use_shadow_defer

        if _use_shadow_defer():
            # Deferred cc occlusion: log the shadow ray per bounce, one
            # chunked any_hit after the loop zeroes occluded rows before
            # the splat (IMBA_SHADOW_DEFER; same pattern as the camera
            # pass slog).
            carry["sclog"] = jnp.zeros((9, max_len, L), jnp.float32) + fz

    def body(i, c):
        hit = closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                          alpha_fn=alpha_fn, active=c["active"])
        # Light rays ignore the environment (vcm.cpp:210-212).
        active = c["active"] & (hit.prim_id >= 0)
        isect = make_interaction(scene, hit, c["org"], c["d"], has_bump=has_bump)

        cos_o = jnp.abs(dot(isect.w_out, isect.normal))
        active = active & (cos_o > 0.0)
        # Terminate at emitter surfaces so the light pass integrates the
        # same transport as the camera pass (which terminates at every
        # emitter hit) — deliberate deviation from the reference, see
        # module docstring "Deviations".
        active = active & (isect.light_id < 0)

        # Complete the partial weights (vcm.cpp:228-234).
        t_sqr = hit.t * hit.t
        d_vcm = c["d_vcm"] * jnp.where((i > 0) | c["finite"], mis_pow(t_sqr), 1.0)
        inv_cos = 1.0 / mis_pow(jnp.maximum(cos_o, 1e-9))
        d_vcm = d_vcm * inv_cos
        d_vc = c["d_vc"] * inv_cos
        d_vm = c["d_vm"] * inv_cos

        non_spec = ~mat_mod.is_specular(isect.params)
        out = dict(finite=c["finite"])

        # Store vertices for connection/merging (vcm.cpp:237-246).
        if use_cache:
            store = active & non_spec
            if flush_append:
                rec = pack_batch(
                    isect.pos, isect.w_out, isect.normal, isect.gn,
                    isect.uv, isect.mat_id, c["throughput"], d_vc, d_vcm,
                    d_vm, jnp.full((L,), i + 2, jnp.int32), path_id,
                )
                out["vrec"] = jax.lax.dynamic_update_slice(
                    c["vrec"], rec[None], (i, 0, 0))
                out["vstore"] = jax.lax.dynamic_update_slice(
                    c["vstore"], store[None], (i, 0))
            else:
                if "vcount" in c:
                    # Per-path admission cap (see the flush-site note).
                    store = store & (c["vcount"] < k_cap)
                    out["vcount"] = c["vcount"] + store.astype(jnp.int32)
                out["cache"] = append(
                    c["cache"], store, isect.pos, isect.w_out, isect.normal,
                    isect.gn, isect.uv, isect.mat_id, c["throughput"], d_vc,
                    d_vcm, d_vm, jnp.full((L,), i + 2, jnp.int32), path_id,
                )

        # Connect every non-specular vertex to the camera (vcm.cpp:260-320).
        # NB: normalise by the GLOBAL light_path_count, not the band size
        # L — banding must not change the estimator (a 1024² frame runs
        # the light pass in multiple bands).
        if use_cc:
            res = _connect_to_camera(
                scene, cam, isect, c["throughput"], d_vc, d_vcm,
                active & non_spec, mis_eta_vm, light_path_count, num_pixels,
                algo, alpha_fn, defer="sclog" in c,
            )
            contrib, pix = res[0], res[1]
            if "sclog" in c:
                (o_, d_, tn_, tx_, ok_) = res[2]
                rec = jnp.concatenate([
                    o_.T, d_.T, tn_[None], tx_[None],
                    ok_.astype(jnp.float32)[None]], axis=0)
                out["sclog"] = jax.lax.dynamic_update_slice(
                    c["sclog"], rec[:, None, :], (0, i, 0))
            out["cc"] = jax.lax.dynamic_update_slice(
                c["cc"], contrib[None], (i, 0, 0))
            out["cp"] = jax.lax.dynamic_update_slice(
                c["cp"], pix[None], (i, 0))

        # Adjoint bounce (vcm.cpp:134-190).
        st = c["state"]
        (org, d, tmin, throughput, active, d_vc, d_vcm, d_vm, st) = _bounce(
            scene, isect, c["throughput"], d_vc, d_vcm, d_vm, active, st,
            hit, mis_eta_vc, mis_eta_vm, adjoint=True, algo=algo,
            last_bounce=(i + 1 >= max_len),
        )
        out.update(
            org=org, d=d, tmin=tmin, throughput=throughput, active=active,
            d_vc=d_vc, d_vcm=d_vcm, d_vm=d_vm, state=st,
        )
        return out

    out = jax.lax.fori_loop(0, max_len, body, carry)
    if use_cc and "sclog" in out:
        from .pt import _occlusion_batch

        comp = out["sclog"].reshape(9, max_len * L)
        occ = _occlusion_batch(
            scene, comp[0:3].T, comp[3:6].T, comp[6], comp[7],
            comp[8] > 0.5, alpha_fn=alpha_fn)
        keep = (comp[8] > 0.5) & ~occ
        film = splat(
            jnp.where(keep[:, None], out["cc"].reshape(-1, 3), 0.0),
            jnp.where(keep, out["cp"].reshape(-1), -1), num_pixels)
    elif use_cc:
        film = splat(out["cc"].reshape(-1, 3), out["cp"].reshape(-1),
                     num_pixels)
    else:
        # + fz: keep the output device-varying under shard_map.
        film = jnp.zeros((num_pixels, 3), jnp.float32) + fz
    if use_cache and flush_append:
        vstore = out["vstore"]
        if k_cap > 0:
            # Per-path admission cap (capacity // light_path_count
            # vertices per path): the schedule-INVARIANT form of cache
            # truncation.  A global first-capacity-rows drop makes the
            # surviving set depend on the light-band/shard schedule
            # (and breaks the multi-chip bitwise property); admitting
            # each path's first K vertices is a per-lane rule, fills at
            # most K * lpc = capacity slots (append never truncates),
            # and keeps depth-capped admission (auto_cache_capacity).
            cum = jnp.cumsum(vstore.astype(jnp.int32), axis=0)
            vstore = vstore & (cum <= k_cap)
        # One vectorised append of all logged bounces.  (max_len, L)
        # row-major = bounce-major path-minor — the exact order the
        # in-loop appends produced, so slot assignment is bit-identical.
        cache = append_packed(cache0, vstore.reshape(-1),
                              out["vrec"].reshape(-1, 24))
    elif use_cache:
        cache = out["cache"]
    else:
        cache = cache0
    return film, cache


def _connect_to_camera(scene, cam, isect, throughput, d_vc, d_vcm, valid,
                       mis_eta_vm, light_path_count, num_pixels, algo, alpha_fn,
                       defer=False):
    to_cam = cam.pos - isect.pos
    # Keep vertices in front of the camera (vcm.cpp:264-265 skips when
    # dot(-dir_to_cam, cam.dir) < 0).
    in_front = dot(-to_cam, cam.forward) >= 0.0
    rx, ry, _ = world_to_raster(cam, isect.pos)
    pixel = raster_to_id(cam, rx, ry)
    valid = valid & in_front & (pixel >= 0)

    dist_sqr = jnp.maximum(dot(to_cam, to_cam), 1e-12)
    dist = jnp.sqrt(dist_sqr)
    dir_c = to_cam / dist[..., None]

    cos_cam = jnp.abs(dot(cam.forward, -dir_c))
    cos_surf = jnp.abs(shading_normal_adjoint(isect.normal, isect.gn, isect.w_out, dir_c))

    f, _, pdf_rev = mat_mod.eval_pdf_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, dir_c,
        kinds=scene.mat_kinds)
    valid = valid & (pdf_rev > 0.0)

    img_to_surf = (cam.img_plane_dist ** 2 * cos_surf) / jnp.maximum(
        dist_sqr * cos_cam * cos_cam * cos_cam, 1e-12
    )

    w_light = mis_pow(img_to_surf / light_path_count) * (
        mis_eta_vm + d_vcm + d_vc * mis_pow(pdf_rev)
    )
    w = 1.0 if algo == "lt" else 1.0 / (w_light + 1.0)

    contrib = throughput * f * (w * img_to_surf / light_path_count)[..., None]
    valid = valid & jnp.any(contrib > 0.0, axis=-1)

    offset = dist * 1e-3
    if defer:
        # Deferred occlusion (IMBA_SHADOW_DEFER): hand the caller the
        # un-occluded rows plus the shadow ray; the light pass logs the
        # ray per bounce and one chunked any_hit after the loop zeroes
        # the occluded rows before the splat (estimator-exact — the
        # occlusion test is read-only and consumes no RNG).
        return (jnp.where(valid[..., None], contrib, 0.0),
                jnp.where(valid, pixel, -1),
                (isect.pos, dir_c, offset, dist - offset, valid))
    occluded = any_hit(scene.bvh, isect.pos, dir_c, offset, dist - offset,
                       alpha_fn=alpha_fn, active=valid)
    ok = valid & ~occluded
    # Returned as (contrib, pixel) rows, NOT splatted here: the caller
    # logs rows per bounce and applies ONE scatter after the loop instead
    # of a scatter-add inside the light-pass fori body.
    return (jnp.where(ok[..., None], contrib, 0.0),
            jnp.where(ok, pixel, -1))


def _bounce(scene, isect, throughput, d_vc, d_vcm, d_vm, active, state, hit,
            mis_eta_vc, mis_eta_vm, *, adjoint, algo, last_bounce):
    """Shared camera/light bounce with partial-weight updates
    (vcm.cpp:134-190)."""
    state, (urr, u1, u2, u3) = rng_mod.next_floats(state, 4)
    rr_pdf = russian_roulette_prob(throughput)
    survive = urr < rr_pdf

    wi, f, pdf_dir, spec, valid = mat_mod.sample_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, u1, u2, u3,
        adjoint=adjoint, kinds=scene.mat_kinds,
    )
    if algo == "ppm" and not adjoint:
        # PPM camera paths only follow specular chains (vcm.cpp:147-149).
        valid = valid & mat_mod.is_specular(isect.params)

    pdf_rev = jnp.where(
        spec, pdf_dir,
        mat_mod.pdf_bsdf(isect.params, isect.normal, isect.gn, wi, isect.w_out,
                         kinds=scene.mat_kinds),
    )
    cos_i = jnp.where(
        adjoint,
        jnp.abs(shading_normal_adjoint(isect.normal, isect.gn, isect.w_out, wi)),
        jnp.abs(dot(wi, isect.normal)),
    )

    safe_pdf = jnp.maximum(pdf_dir, 1e-20)
    new_d_vc = jnp.where(
        spec,
        d_vc * mis_pow(cos_i),
        mis_pow(cos_i / safe_pdf) * (d_vc * mis_pow(pdf_rev) + d_vcm + mis_eta_vm),
    )
    new_d_vm = jnp.where(
        spec,
        d_vm * mis_pow(cos_i),
        mis_pow(cos_i / safe_pdf) * (d_vm * mis_pow(pdf_rev) + d_vcm * mis_eta_vc + 1.0),
    )
    new_d_vcm = jnp.where(spec, 0.0, mis_pow(1.0 / safe_pdf))

    new_throughput = throughput * f * (cos_i / (rr_pdf * safe_pdf))[..., None]
    active = active & survive & valid & jnp.logical_not(last_bounce)

    org = jnp.where(active[..., None], isect.pos, 0.0)
    d = jnp.where(active[..., None], wi, 0.0)
    tmin = hit.t * 1e-4  # (vcm.cpp:254 offset convention)
    return (org, d, tmin,
            jnp.where(active[..., None], new_throughput, throughput),
            active,
            jnp.where(active, new_d_vc, d_vc),
            jnp.where(active, new_d_vcm, d_vcm),
            jnp.where(active, new_d_vm, d_vm),
            state)


def debug_light_pass(scene, cam: Camera, frame, base_radius, *,
                     light_path_count=1024, max_len=10, algo="vcm",
                     has_masks=False):
    """PathDebugger analogue (reference: render/debug/path_debug.h,
    LIGHT_PATH_DEBUG): runs one light pass and returns the vertex cache
    (positions, outgoing dirs, throughputs, partial MIS weights, path
    lengths) for offline inspection; see tools/dump_light_paths.py."""
    pm_radius = jnp.maximum(jnp.asarray(base_radius, jnp.float32), 1e-7)
    eta_vcm = PI * pm_radius * pm_radius * light_path_count
    _, cache = _light_pass(
        scene, cam, jnp.uint32(frame), pm_radius, pm_radius,
        mis_pow(1.0 / eta_vcm), mis_pow(eta_vcm), algo=algo,
        num_pixels=cam.width * cam.height, light_path_count=light_path_count,
        max_len=max_len, cache_capacity=light_path_count * max_len,
        has_masks=has_masks, has_bump=False,
        alpha_fn=alpha_fn_for(scene) if has_masks else None,
    )
    return cache


# ======================================================================
#  Camera pass
# ======================================================================

def _camera_carry_init(scene, cam, frame, *, width, height, spp,
                       light_path_count, start_pixel=0, band_pixels=0):
    """Primary-ray carry for the camera pass; returns (carry, pixel_id)."""
    num_pixels = band_pixels if band_pixels > 0 else width * height
    org, d, state, pixel_id = camera_rays(
        cam, width, height, spp, frame, start_pixel=start_pixel,
        count=num_pixels,
    )

    # dVCM init: pixel pdf converted to solid angle (vcm.cpp:120-129).
    cos_o = dot(d, cam.forward)
    pdf_cam_w = (cam.img_plane_dist / cos_o) ** 2 / cos_o
    d_vcm0 = mis_pow(light_path_count / pdf_cam_w)

    # fz: device-varying f32 zero — constant carry inits must be varying
    # under shard_map (see _light_pass).
    fz = 0.0 * jnp.sum(d[:1])
    zero1 = jnp.zeros_like(org[:, 0]) + fz
    carry = dict(
        org=org + fz,  # pinhole origins are a constant broadcast
        d=d,
        tmin=zero1,
        throughput=jnp.ones_like(org) + fz,
        radiance=jnp.zeros_like(org) + fz,
        active=zero1 < 1.0,
        d_vc=zero1, d_vcm=d_vcm0 + fz, d_vm=zero1,
        state=state,
    )
    return carry, pixel_id


def _camera_body_fn(scene, cache, grid, pm_radius, base_radius, mis_eta_vc,
                    mis_eta_vm, *, algo, max_len, light_path_count,
                    num_connections, num_knn, table_size, max_per_cell,
                    has_bump, alpha_fn, techniques, mat_kinds):
    """One camera-pass bounce as a fori_loop body (i, carry) -> carry.
    Lanes stay lockstep (every live lane is at depth i), so the same body
    drives both the plain megastep and the compacted two-phase schedule
    (pt.py mid-frame compaction)."""
    num_lights = scene.lights.kind.shape[0]
    # Wide-record view of the vertex cache: one gather per vertex access.
    cache_rec = cache.packed() if cache is not None else None

    def body(i, c):
        hit = closest_hit(scene.bvh, c["org"], c["d"], c["tmin"], BIG,
                          alpha_fn=alpha_fn, active=c["active"])
        radiance = c["radiance"]

        # --- env misses (vcm.cpp:338-365) -------------------------------
        # Deviation from the reference: vcm.cpp:344 skips env hits
        # entirely for ALGO_PT (`if (algo == ALGO_PT) break;`), losing all
        # environment light in the template's PT variant.  Here the PT
        # variant evaluates them, with full weight at the first vertex
        # (no competing technique exists there), matching the dedicated
        # path tracer (pt.cpp:95-116).
        miss = c["active"] & (hit.prim_id < 0)
        if scene.env is not None and "light_hit" in techniques:
            li, pdf_direct_w, pdf_emit_w = envmap_mod.radiance(
                scene.env, normalize(c["d"]), scene.bsphere.inv_radius_sqr
            )
            pdf_di = pdf_direct_w / num_lights
            pdf_e = pdf_emit_w / num_lights
            w_cam = mis_pow(pdf_di) * c["d_vcm"] + mis_pow(pdf_e) * c["d_vc"]
            if algo == "ppm":
                w = jnp.ones_like(w_cam)
            elif algo == "pt":
                w = jnp.where(i == 0, 1.0, 1.0 / (w_cam + 1.0))
            else:
                w = 1.0 / (w_cam + 1.0)
            radiance = radiance + jnp.where(
                miss[..., None], c["throughput"] * li * w[..., None], 0.0
            )
        active = c["active"] & ~miss

        isect = make_interaction(scene, hit, c["org"], c["d"], has_bump=has_bump)
        cos_o = jnp.abs(dot(isect.w_out, isect.normal))

        # Complete partial weights (vcm.cpp:384-392).
        inv_cos = 1.0 / mis_pow(jnp.maximum(cos_o, 1e-9))
        d_vcm = c["d_vcm"] * mis_pow(hit.t * hit.t) * inv_cos
        d_vc = c["d_vc"] * inv_cos
        d_vm = c["d_vm"] * inv_cos
        active = active & (cos_o > 0.0)

        # --- emitter hit (vcm.cpp:394-412) ------------------------------
        is_emitter = active & (isect.light_id >= 0)
        area = jnp.maximum(isect.area, 1e-12)
        cos_geom = dot(isect.gn, isect.w_out)
        li = jnp.where((cos_geom > 0.0)[..., None], isect.emit, 0.0)
        pdf_direct_a = jnp.where(cos_geom > 0.0, 1.0 / area, 1.0)
        # AreaEmitter pdf_emit_w measured about the geometric normal
        # (light.h:21-44).
        pdf_emit_w = jnp.where(
            cos_geom > 0.0,
            jnp.maximum(cos_geom, 0.0) / PI / area,
            1.0,
        )
        pdf_di = pdf_direct_a / num_lights
        pdf_e = pdf_emit_w / num_lights
        w_cam = mis_pow(pdf_di) * d_vcm + mis_pow(pdf_e) * d_vc
        if algo == "ppm":
            w_emit = jnp.ones_like(w_cam)
        else:
            w_emit = jnp.where(i == 0, 1.0, 1.0 / (w_cam + 1.0))
        if "light_hit" in techniques:
            radiance = radiance + jnp.where(
                is_emitter[..., None], c["throughput"] * li * w_emit[..., None], 0.0
            )
        active = active & ~is_emitter

        st = c["state"]
        non_spec = ~mat_mod.is_specular(isect.params)

        # --- NEE + vertex connections: shadow rays batch into ONE
        # any_hit dispatch (identical results, per-lane occlusion;
        # amortises the dispatch/sort cost over 1+C ray sets).
        shadow_batch = []
        if algo != "ppm":
            st, radiance = _direct_illum(
                scene, isect, c["throughput"], d_vc, d_vcm, active, st,
                radiance, mis_eta_vm, num_lights, algo, alpha_fn,
                enabled="next_event" in techniques, defer=shadow_batch,
            )

        # --- vertex connections (vcm.cpp:429-431, 488-569) --------------
        if algo in ("vcm", "bpt"):
            for _ in range(num_connections):
                st, radiance = _connect(
                    scene, cache, cache_rec, isect, c["throughput"], d_vc, d_vcm,
                    active & non_spec, st, radiance, mis_eta_vm,
                    light_path_count, num_connections, max_len,
                    cam_path_length=i + 1, base_radius=base_radius,
                    alpha_fn=alpha_fn,
                    enabled="connect" in techniques, defer=shadow_batch,
                )

        slog = None
        if shadow_batch and "slog" in c:
            # Deferred occlusion (IMBA_SHADOW_DEFER, same pattern as
            # pt.py): log each shadow set's ray + contribution; the
            # driver resolves every bounce's sets in chunked any_hit
            # dispatches after the loop (pt._resolve_slog).  Occlusion
            # is read-only w.r.t. the carry and consumes no RNG —
            # estimator-exact, only fusion shape changes.
            recs = [jnp.concatenate([
                o_.T, d_.T, tn_[None], tx_[None], cb_.T,
                ok_.astype(jnp.float32)[None],
            ], axis=0) for (o_, d_, tn_, tx_, ok_, cb_) in shadow_batch]
            rec = jnp.stack(recs, axis=1)           # (12, S, L)
            ns = len(shadow_batch)
            slog = jax.lax.dynamic_update_slice(
                c["slog"], rec, (0, i * ns, 0))
        elif shadow_batch:
            org_b = jnp.concatenate([e[0] for e in shadow_batch])
            dir_b = jnp.concatenate([e[1] for e in shadow_batch])
            tmin_b = jnp.concatenate([e[2] for e in shadow_batch])
            tmax_b = jnp.concatenate([e[3] for e in shadow_batch])
            ok_b = jnp.concatenate([e[4] for e in shadow_batch])
            occ_b = any_hit(scene.bvh, org_b, dir_b, tmin_b, tmax_b,
                            alpha_fn=alpha_fn, active=ok_b)
            nray = shadow_batch[0][4].shape[0]
            for bi, (_, _, _, _, okc, contrib) in enumerate(shadow_batch):
                occ = occ_b[bi * nray : (bi + 1) * nray]
                radiance = radiance + jnp.where(
                    (okc & ~occ)[..., None], contrib, 0.0)

        # --- vertex merging (vcm.cpp:433-436, 571-611) ------------------
        if algo in ("vcm", "ppm") and "merge" in techniques:
            radiance = _vertex_merging(
                scene, cache, cache_rec, grid, isect, c["throughput"],
                d_vcm, d_vm, active & non_spec, radiance, mis_eta_vc,
                pm_radius, light_path_count, num_knn, table_size,
                max_per_cell, algo, mat_kinds=mat_kinds,
            )

        # --- bounce ------------------------------------------------------
        (org, dd, tmin, throughput, active, d_vc, d_vcm, d_vm, st) = _bounce(
            scene, isect, c["throughput"], d_vc, d_vcm, d_vm, active, st,
            hit, mis_eta_vc, mis_eta_vm, adjoint=False, algo=algo,
            last_bounce=(i + 1 >= max_len),
        )
        ret = dict(org=org, d=dd, tmin=tmin, throughput=throughput,
                   radiance=radiance, active=active, d_vc=d_vc, d_vcm=d_vcm,
                   d_vm=d_vm, state=st)
        if slog is not None:
            ret["slog"] = slog
        return ret

    return body


def _shadow_sets(algo, techniques, num_connections) -> int:
    """Shadow-ray sets the camera body batches per bounce (must mirror
    the defer-append conditions in _direct_illum / _connect)."""
    n = 0
    if algo != "ppm" and "next_event" in techniques:
        n += 1
    if algo in ("vcm", "bpt") and "connect" in techniques:
        n += num_connections
    return n


def _shadow_deferred(algo, techniques, num_connections) -> bool:
    """Deferred camera-pass occlusion (IMBA_SHADOW_DEFER, pt.py's knob):
    log NEE + connection shadow rays per bounce, resolve all bounces in
    chunked any_hit dispatches after the loop (pt._resolve_slog)."""
    from .pt import _use_shadow_defer

    return (_use_shadow_defer()
            and _shadow_sets(algo, techniques, num_connections) > 0)


def _camera_pass(scene, cam: Camera, frame, cache, grid, pm_radius, base_radius,
                 mis_eta_vc, mis_eta_vm, *, algo, width, height, spp, max_len,
                 light_path_count, num_connections, num_knn, table_size,
                 max_per_cell, has_masks, has_bump, alpha_fn,
                 techniques=TECHNIQUES, start_pixel=0, band_pixels=0,
                 mat_kinds=None):
    num_pixels = band_pixels if band_pixels > 0 else width * height
    carry, _ = _camera_carry_init(
        scene, cam, frame, width=width, height=height, spp=spp,
        light_path_count=light_path_count, start_pixel=start_pixel,
        band_pixels=band_pixels,
    )
    body = _camera_body_fn(
        scene, cache, grid, pm_radius, base_radius, mis_eta_vc, mis_eta_vm,
        algo=algo, max_len=max_len, light_path_count=light_path_count,
        num_connections=num_connections, num_knn=num_knn,
        table_size=table_size, max_per_cell=max_per_cell, has_bump=has_bump,
        alpha_fn=alpha_fn, techniques=techniques,
        mat_kinds=mat_kinds,
    )
    sdefer = _shadow_deferred(algo, techniques, num_connections)
    fz = 0.0 * carry["radiance"][0, 0]
    if sdefer:
        ns = _shadow_sets(algo, techniques, num_connections)
        carry["slog"] = jnp.zeros(
            (12, max_len * ns, carry["d"].shape[0]), jnp.float32) + fz
    out = jax.lax.fori_loop(0, max_len, body, carry)
    rad = out["radiance"]
    if sdefer:
        from .pt import _resolve_slog

        rad = rad + _resolve_slog(scene, out["slog"], alpha_fn=alpha_fn)
    # pixel_id is a static tile-order permutation of arange(P) tiled by
    # spp: un-permute + reshape+sum instead of a scatter (see pt.camera_rays).
    from .pt import unswizzle_film

    return unswizzle_film(rad, spp, num_pixels, width)


def _direct_illum(scene, isect, throughput, d_vc, d_vcm, active, state,
                  radiance, mis_eta_vm, num_lights, algo, alpha_fn,
                  enabled=True, defer=None):
    state, (ul, ua, ub) = rng_mod.next_floats(state, 3)
    light_idx = jnp.minimum((ul * num_lights).astype(jnp.int32), num_lights - 1)
    ds = light_mod.sample_direct(
        scene.lights, light_idx, isect.pos, ua, ub, scene.bsphere, scene.env,
        kinds=scene.light_kinds,
    )
    cos_i = jnp.abs(dot(isect.normal, ds.dir))
    f, pdf_dir, pdf_rev = mat_mod.eval_pdf_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, ds.dir,
        kinds=scene.mat_kinds)
    ok = active & (pdf_dir > 0.0) & (pdf_rev > 0.0)

    pdf_forward = jnp.where(ds.is_delta, 0.0, pdf_dir)
    w_light = mis_pow(pdf_forward * num_lights / jnp.maximum(ds.pdf_direct_w, 1e-20))
    w_cam = mis_pow(
        ds.pdf_emit_w * cos_i / jnp.maximum(ds.pdf_direct_w * ds.cos_out, 1e-20)
    ) * (mis_eta_vm + d_vcm + d_vc * mis_pow(pdf_rev))
    w = jnp.ones_like(w_cam) if algo == "pt" else 1.0 / (w_cam + 1.0 + w_light)

    contrib = throughput * f * ds.radiance * (w * cos_i * num_lights)[..., None]
    ok = ok & jnp.any(contrib > 0.0, axis=-1)
    offset = 1e-3 * jnp.where(ds.distance >= BIG, 1.0, ds.distance)
    if defer is not None:
        # Batched occlusion: the camera pass concatenates NEE +
        # connection shadow rays into ONE any_hit dispatch (identical
        # results — occlusion is per-lane — at a fraction of the
        # fixed dispatch/sort cost).
        if enabled:
            defer.append((isect.pos, ds.dir, offset, ds.distance - offset,
                          ok, contrib))
        return state, radiance
    occluded = any_hit(scene.bvh, isect.pos, ds.dir, offset, ds.distance - offset,
                       alpha_fn=alpha_fn, active=ok)
    if enabled:
        radiance = radiance + jnp.where((ok & ~occluded)[..., None], contrib, 0.0)
    return state, radiance


def _connect(scene, cache: LightVertexCache, cache_rec, isect, throughput,
             d_vc, d_vcm, active, state, radiance, mis_eta_vm,
             light_path_count, num_connections, max_len, *, cam_path_length,
             base_radius, alpha_fn, enabled=True, defer=None):
    """One vertex connection per ray (vcm.cpp:488-569)."""
    count = cache.count
    have = count > 0
    slice_rows = _connect_slice_rows()
    if slice_rows and cache_rec.shape[0] > slice_rows:
        # (Static branch: the extra draw happens only in slice mode, so
        # the default path's RNG stream — and its frames — are untouched.)
        state, (uc, us) = rng_mod.next_floats(state, 2)
        # Locality-sliced uniform sampling (IMBA_VCM_CONNECT_SLICE=<rows>):
        # fetch ONE contiguous-modulo window of the cache per dispatch and
        # sample every lane inside it.  j = (s + u) mod count with
        # s ~ U[0,count) shared and u ~ U[0,min(S,count)) per lane is
        # marginally uniform over [0,count), so per-pixel this IS the
        # reference's uniform vertex choice (vcm.cpp:494-496) — only
        # cross-lane correlation changes, and s re-rolls per connection,
        # band and bounce.  The point: the per-lane random-access gather
        # reads an S-row buffer instead of the frame-sized cache table
        # (vcm_perf.md §4 locality suspect).
        denom = jnp.maximum(count, 1)
        s = jnp.minimum((us[0] * count.astype(jnp.float32)).astype(jnp.int32),
                        jnp.maximum(count - 1, 0))
        widx = (s + jnp.arange(slice_rows, dtype=jnp.int32)) % denom
        buf = cache_rec[widx]
        span = jnp.minimum(jnp.int32(slice_rows), denom).astype(jnp.float32)
        jj = jnp.minimum((uc * span).astype(jnp.int32),
                         jnp.minimum(jnp.maximum(count - 1, 0),
                                     slice_rows - 1))
        rec_j = buf[jj]
    else:
        state, (uc,) = rng_mod.next_floats(state, 1)
        j = jnp.minimum((uc * count.astype(jnp.float32)).astype(jnp.int32),
                        jnp.maximum(count - 1, 0))
        rec_j = cache_rec[j]

    v = _vertex_from_rec(scene, rec_j.T)   # the ONE vertex gather
    vpos = v["pos"]
    ok = active & have & (v["path_length"] + cam_path_length <= max_len)

    to_v = vpos - isect.pos
    dist_sq = jnp.maximum(dot(to_v, to_v), 1e-20)
    dist = jnp.sqrt(dist_sq)
    cdir = to_v / dist[..., None]
    ok = ok & (dist >= base_radius)  # (vcm.cpp:516-521)

    # Camera-side BSDF.
    f_cam, pdf_cam, pdf_cam_rev = mat_mod.eval_pdf_bsdf(
        isect.params, isect.normal, isect.gn, isect.w_out, cdir,
        kinds=scene.mat_kinds)

    # Light-side BSDF (adjoint eval; same formulas for non-delta kinds).
    vparams = v["params"]
    vn = v["normal"]
    vgn = v["gn"]
    vout = v["w_out"]
    f_light, pdf_light, pdf_light_rev = mat_mod.eval_pdf_bsdf(
        vparams, vn, vgn, vout, -cdir, kinds=scene.mat_kinds)

    ok = ok & (pdf_cam > 0) & (pdf_cam_rev > 0) & (pdf_light > 0) & (pdf_light_rev > 0)

    cos_cam = jnp.abs(dot(isect.normal, cdir))
    cos_light = jnp.abs(shading_normal_adjoint(vn, vgn, vout, -cdir))
    geom = cos_cam * cos_light / dist_sq
    ok = ok & (geom > 0.0)

    pdf_cam_a = pdf_cam * cos_light / dist_sq
    pdf_light_a = pdf_light * cos_cam / dist_sq
    w_light = mis_pow(pdf_cam_a) * (mis_eta_vm + v["d_vcm"] + v["d_vc"] * mis_pow(pdf_light_rev))
    w_cam = mis_pow(pdf_light_a) * (mis_eta_vm + d_vcm + d_vc * mis_pow(pdf_cam_rev))
    w = 1.0 / (w_cam + 1.0 + w_light)

    vc_weight = count.astype(jnp.float32) / (light_path_count * num_connections)
    contrib = (
        throughput * v["throughput"] * f_cam * f_light
        * (w * geom * vc_weight)[..., None]
    )
    ok = ok & jnp.any(contrib > 0.0, axis=-1)

    offset = 1e-3 * dist
    if defer is not None:
        if enabled:
            defer.append((isect.pos, cdir, offset, dist - offset, ok, contrib))
        return state, radiance
    occluded = any_hit(scene.bvh, isect.pos, cdir, offset, dist - offset,
                       alpha_fn=alpha_fn, active=ok)
    if enabled:
        radiance = radiance + jnp.where((ok & ~occluded)[..., None], contrib, 0.0)
    return state, radiance


def _vertex_merging(scene, cache: LightVertexCache, cache_rec, grid, isect,
                    throughput, d_vcm, d_vm, active, radiance, mis_eta_vc,
                    pm_radius, light_path_count, num_knn, table_size,
                    max_per_cell, algo, mat_kinds=None):
    """Fixed-radius photon gather + Epanechnikov kernel (vcm.cpp:571-611)
    on the hash grid (render/hashgrid.py): each of the 8 neighbour cells
    contributes up to `max_per_cell` candidates via ONE windowed gather
    of the payload-carrying grid record (hashgrid.cell_windows), and all
    in-radius candidates accumulate directly.  The per-cell cap is the
    stand-in for the reference's unbounded walk (rangesearch.h:90-129):
    a cell holding W > max_per_cell photons contributes its first
    max_per_cell, rescaled by W / max_per_cell."""
    radius_sqr = jnp.maximum(pm_radius * pm_radius, 1e-20)
    contrib = jnp.zeros_like(throughput)
    for rec, d2, ok_w, cscale in hashgrid_mod.cell_windows(grid, isect.pos,
                                                           max_per_cell):
        cell_sum = jnp.zeros_like(throughput)
        for w_i in range(rec.shape[1]):
            r = rec[:, w_i, :]
            ok = active & ok_w[:, w_i]
            photon_in = r[:, 4:7]
            f, pdf_dir, pdf_rev = mat_mod.eval_pdf_bsdf(
                isect.params, isect.normal, isect.gn, isect.w_out, photon_in,
                kinds=scene.mat_kinds)
            ok = ok & (pdf_dir > 0.0) & (pdf_rev > 0.0) & jnp.any(
                f != 0.0, axis=-1)

            w_light = r[:, 10] * mis_eta_vc + r[:, 11] * mis_pow(pdf_dir)
            w_cam = d_vcm * mis_eta_vc + d_vm * mis_pow(pdf_rev)
            w = (jnp.ones_like(w_cam) if algo == "ppm"
                 else 1.0 / (w_light + 1.0 + w_cam))

            kernel = jnp.maximum(1.0 - d2[:, w_i] / radius_sqr, 0.0)
            cell_sum = cell_sum + jnp.where(
                ok[..., None], r[:, 7:10] * f * (w * kernel)[..., None], 0.0
            )
        contrib = contrib + cell_sum * cscale[..., None]

    norm = 2.0 / (PI * radius_sqr * light_path_count)
    return radiance + jnp.where(
        active[..., None], throughput * contrib * norm[..., None], 0.0
    )


# ======================================================================
#  Frame entry point
# ======================================================================

def _mis_constants(frame, base_radius, light_path_count, algo):
    """Progressive radius + MIS constants (vcm.cpp:27-45)."""
    iteration = frame.astype(jnp.float32) + 1.0
    radius_alpha = 0.75
    pm_radius = base_radius / jnp.power(iteration, 0.5 * (1.0 - radius_alpha))
    pm_radius = jnp.maximum(pm_radius, 1e-7)
    eta_vcm = PI * pm_radius * pm_radius * light_path_count
    mis_eta_vc = mis_pow(1.0 / eta_vcm)
    mis_eta_vm = jnp.zeros_like(eta_vcm) if algo == "bpt" else mis_pow(eta_vcm)
    return pm_radius, mis_eta_vc, mis_eta_vm


@partial(jax.jit, static_argnames=(
    "algo", "num_pixels", "light_path_count", "max_len", "cache_capacity",
    "has_masks", "has_bump", "techniques", "band_paths",
))
def _vcm_light_band(scene, cam, frame, base_radius, path_start, cache_in, *,
                    algo, num_pixels, light_path_count, max_len,
                    cache_capacity, has_masks, has_bump,
                    techniques, band_paths):
    pm_radius, mis_eta_vc, mis_eta_vm = _mis_constants(
        frame, base_radius, light_path_count, algo
    )
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    return _light_pass(
        scene, cam, frame, pm_radius, base_radius, mis_eta_vc, mis_eta_vm,
        algo=algo, num_pixels=num_pixels, light_path_count=light_path_count,
        max_len=max_len, cache_capacity=cache_capacity, has_masks=has_masks,
        has_bump=has_bump, alpha_fn=alpha_fn,
        techniques=techniques, path_start=path_start, band_paths=band_paths,
        cache_in=cache_in, admit_cap=0,
    )


@partial(jax.jit, static_argnames=("table_size", "cache_capacity",
                                   "light_path_count", "algo"))
def _vcm_build_grid(cache, frame, base_radius, *, table_size, cache_capacity,
                    light_path_count, algo):
    pm_radius, _, _ = _mis_constants(frame, base_radius, light_path_count, algo)
    valid = jnp.arange(cache_capacity) < cache.count
    # Payload-carrying grid record (hashgrid.build_hash_grid): the
    # merge loop reads everything from the ONE windowed gather.
    payload = jnp.concatenate(
        [cache.w_out, cache.throughput, cache.d_vcm[:, None],
         cache.d_vm[:, None]], axis=1,
    )
    return build_hash_grid(cache.pos, valid, pm_radius, table_size,
                           payload=payload)


@partial(jax.jit, static_argnames=(
    "algo", "width", "height", "spp", "max_len", "light_path_count",
    "num_connections", "num_knn", "table_size", "max_per_cell", "has_masks",
    "has_bump", "techniques", "band_pixels", "mat_kinds",
))
def _vcm_camera_band(scene, cam, frame, cache, grid, base_radius, *, algo,
                     width, height, spp, max_len, light_path_count,
                     num_connections, num_knn, table_size, max_per_cell,
                     has_masks, has_bump, techniques,
                     start_pixel, band_pixels, mat_kinds=None):
    pm_radius, mis_eta_vc, mis_eta_vm = _mis_constants(
        frame, base_radius, light_path_count, algo
    )
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    return _camera_pass(
        scene, cam, frame, cache, grid, pm_radius, base_radius,
        mis_eta_vc, mis_eta_vm, algo=algo, width=width, height=height,
        spp=spp, max_len=max_len, light_path_count=light_path_count,
        num_connections=num_connections, num_knn=num_knn,
        table_size=table_size, max_per_cell=max_per_cell,
        has_masks=has_masks, has_bump=has_bump, alpha_fn=alpha_fn,
        techniques=techniques,
        start_pixel=start_pixel, band_pixels=band_pixels,
        mat_kinds=mat_kinds,
    )


# Rays per dispatch cap: a monolithic 1M-ray VCM graph exhausts device
# memory (reproducible device fault at 1080p-scale); bands of <=2^18 rays
# are safe, cheaper to compile, and bitwise-identical (RNG is keyed by
# global pixel id).
BAND_RAYS = 1 << 18


def auto_cache_capacity(light_path_count: int, max_len: int) -> int:
    """Default vertex-cache capacity: 2x light_path_count.

    The reference sizes its cache with probe paths so no vertex is ever
    dropped (light_vertices.cpp:15-129).  Because append fills in
    bounce order, a 2x cap drops the DEEPEST bounces first (25-47% of
    vertices on the cornell quality rows), i.e. it acts as depth-capped
    admission.  Against a no-truncation 5x cap it gave a higher PSNR at
    a fixed 30 s budget on every tracked cornell row: the dropped
    deep-bounce vertices cost more variance than the energy they carry,
    and fewer photons make merge frames faster.  (That comparison ran on
    the previous accelerator; it has not been repeated on the H100.)
    IMBA_CACHE_CAP_MULT overrides (5 = no truncation), clamped to
    max_len - 1 vertices/path.

    Enforcement is a PER-PATH admission cap (each path stores its first
    capacity // lpc vertices, _per_path_cap), not append-order
    truncation: a global first-capacity-rows drop makes the surviving
    vertex set depend on the light-band/shard schedule — it broke the
    multi-chip bitwise property the moment the cache could overflow.
    Per-path admission is a per-lane rule, schedule-invariant, and
    never overflows the capacity."""
    mult = float(os.environ.get("IMBA_CACHE_CAP_MULT", "2"))
    return max(int(min(mult, max(max_len - 1, 1)) * light_path_count), 1)


# Default for camera-pass compaction (IMBA_VCM_COMPACT=1/0 overrides it
# for measurement and tests).  Measured on an H100 80GB HBM3 at 700 W,
# VCM 1024² ms/frame (median of 3): compacted 33.11-34.47 vs banded 36.67
# on cornell with its mirror box and glass sphere; 57.83-60.03 vs 63.40
# on the 48k-triangle big scene.
VCM_COMPACT = True


def _use_vcm_compact(num_bands: int, max_len: int) -> bool:
    """Camera-pass mid-frame compaction for multi-band frames: VCM
    bounces (NEE + connections + merge) are expensive, so skipping
    RR-killed lanes can pay where it does not for PT."""
    env = os.environ.get("IMBA_VCM_COMPACT", "")
    if env == "0" or num_bands <= 1 or max_len < 2:
        return False
    return env == "1" or (env == "" and VCM_COMPACT)


def vcm_compact_depth(max_len: int) -> int:
    d = int(os.environ.get("IMBA_VCM_COMPACT_DEPTH", "4"))
    return max(1, min(d, max_len - 1))


def _connect_slice_rows() -> int:
    """IMBA_VCM_CONNECT_SLICE=<rows>: sample connection vertices from one
    contiguous-modulo cache window of this many rows per dispatch (0 =
    off, plain whole-table uniform gather).  See _connect for why this is
    estimator-neutral; it exists to test whether gathers from a
    frame-sized table lose locality.

    Read at TRACE time: toggling the env var after a (scene-shape, statics)
    combination has been jitted does NOT retrace — A/B it with one process
    per value or monkeypatch this function
    before first trace (tests/test_connect_slice.py)."""
    try:
        return int(os.environ.get("IMBA_VCM_CONNECT_SLICE", "0"))
    except ValueError:
        return 0


_CAM_STATICS = (
    "algo", "width", "height", "spp", "max_len", "light_path_count",
    "num_connections", "num_knn", "table_size", "max_per_cell", "has_masks",
    "has_bump", "techniques", "band_pixels", "mat_kinds",
    "bounces",
)


@partial(jax.jit, static_argnames=_CAM_STATICS)
def _vcm_camera_phase1(scene, cam, frame, cache, grid, base_radius, *, algo,
                       width, height, spp, max_len, light_path_count,
                       num_connections, num_knn, table_size, max_per_cell,
                       has_masks, has_bump, techniques,
                       start_pixel, band_pixels, mat_kinds, bounces):
    """Camera rays + the first `bounces` camera-pass bounces of one band
    (the compaction phase 1; see pt.py mid-frame compaction)."""
    pm_radius, mis_eta_vc, mis_eta_vm = _mis_constants(
        frame, base_radius, light_path_count, algo
    )
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    carry, pixel_id = _camera_carry_init(
        scene, cam, frame, width=width, height=height, spp=spp,
        light_path_count=light_path_count, start_pixel=start_pixel,
        band_pixels=band_pixels,
    )
    body = _camera_body_fn(
        scene, cache, grid, pm_radius, base_radius, mis_eta_vc, mis_eta_vm,
        algo=algo, max_len=max_len, light_path_count=light_path_count,
        num_connections=num_connections, num_knn=num_knn,
        table_size=table_size, max_per_cell=max_per_cell, has_bump=has_bump,
        alpha_fn=alpha_fn, techniques=techniques,
        mat_kinds=mat_kinds,
    )
    sdefer = _shadow_deferred(algo, techniques, num_connections)
    fz = 0.0 * carry["radiance"][0, 0]
    if sdefer:
        ns = _shadow_sets(algo, techniques, num_connections)
        carry["slog"] = jnp.zeros(
            (12, max_len * ns, carry["d"].shape[0]), jnp.float32) + fz
    out = jax.lax.fori_loop(0, bounces, body, carry)
    if sdefer:
        from .pt import _resolve_slog

        ns = _shadow_sets(algo, techniques, num_connections)
        out["radiance"] = out["radiance"] + _resolve_slog(
            scene, out.pop("slog")[:, :bounces * ns, :], alpha_fn=alpha_fn)
    return out, pixel_id


@partial(jax.jit, static_argnames=_CAM_STATICS)
def _vcm_camera_phase2(scene, frame, cache, grid, base_radius, c, *, algo,
                       width, height, spp, max_len, light_path_count,
                       num_connections, num_knn, table_size, max_per_cell,
                       has_masks, has_bump, techniques,
                       band_pixels, mat_kinds, bounces):
    """Bounces [bounces, max_len) on a compacted carry.  Lanes are
    lockstep (all live lanes at depth `bounces`), so the fori index keeps
    its meaning for the MIS first-vertex terms and cam_path_length."""
    pm_radius, mis_eta_vc, mis_eta_vm = _mis_constants(
        frame, base_radius, light_path_count, algo
    )
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    body = _camera_body_fn(
        scene, cache, grid, pm_radius, base_radius, mis_eta_vc, mis_eta_vm,
        algo=algo, max_len=max_len, light_path_count=light_path_count,
        num_connections=num_connections, num_knn=num_knn,
        table_size=table_size, max_per_cell=max_per_cell, has_bump=has_bump,
        alpha_fn=alpha_fn, techniques=techniques,
        mat_kinds=mat_kinds,
    )
    sdefer = _shadow_deferred(algo, techniques, num_connections)
    if sdefer:
        c = dict(c)
        fz = 0.0 * c["radiance"][0, 0]
        ns = _shadow_sets(algo, techniques, num_connections)
        c["slog"] = jnp.zeros(
            (12, max_len * ns, c["d"].shape[0]), jnp.float32) + fz
    out = jax.lax.fori_loop(bounces, max_len, body, c)
    if sdefer:
        from .pt import _resolve_slog

        ns = _shadow_sets(algo, techniques, num_connections)
        out["radiance"] = out["radiance"] + _resolve_slog(
            scene, out.pop("slog")[:, bounces * ns:, :], alpha_fn=alpha_fn)
    return out


def _camera_pass_compact(scene, cam, frame, cache, grid, base_radius, *,
                         algo, width, height, spp, max_len, band, **kw):
    """Banded camera pass with mid-frame lane compaction (pt.py): phase-1
    bands trace `vcm_compact_depth` bounces, lanes sort dead-last, and
    only ceil(alive / band) bands run the remaining bounces.  Identical
    per-lane estimator; film summation order differs (one scatter-add)."""
    from .pt import _compact_carry, _scatter_film

    num_pixels = width * height
    depth0 = vcm_compact_depth(max_len)
    carries, pixel_ids = [], []
    for start in range(0, num_pixels, band):
        bp = min(band, num_pixels - start)
        c, pid = _vcm_camera_phase1(
            scene, cam, frame, cache, grid, base_radius, algo=algo,
            width=width, height=height, spp=spp, max_len=max_len,
            start_pixel=jnp.int32(start), band_pixels=bp, bounces=depth0,
            **kw)
        carries.append(c)
        pixel_ids.append(pid)
    merged = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *carries)
    pix = jnp.concatenate(pixel_ids, axis=0)
    sc, pix, alive = _compact_carry(merged, pix)

    lanes = pix.shape[0]
    band_lanes = band * spp
    n_alive = int(alive)  # one host sync: picks the phase-2 band count
    n_bands2 = -(-n_alive // band_lanes) if n_alive else 0

    rad_parts, done = [], 0
    for k in range(n_bands2):
        end = min(done + band_lanes, lanes)
        ck = jax.tree_util.tree_map(lambda a: a[done:end], sc)
        out = _vcm_camera_phase2(
            scene, frame, cache, grid, base_radius, ck, algo=algo,
            width=width, height=height, spp=spp, max_len=max_len,
            band_pixels=end - done, bounces=depth0, **kw)
        rad_parts.append(out["radiance"])
        done = end
    if done < lanes:
        rad_parts.append(sc["radiance"][done:])
    rad = rad_parts[0] if len(rad_parts) == 1 else jnp.concatenate(
        rad_parts, axis=0)
    return _scatter_film(pix, rad, num_pixels=num_pixels)


def render_vcm_frame(
    scene,
    cam: Camera,
    frame: jnp.ndarray,
    base_radius: jnp.ndarray,
    *,
    algo: str = "vcm",
    width: int = 512,
    height: int = 512,
    spp: int = 1,
    max_len: int = 10,
    light_path_count: int = 0,
    num_connections: int = 1,
    num_knn: int = 10,
    cache_capacity: int = 0,
    table_size: int = 0,
    max_per_cell: int = 4,
    has_masks: bool = False,
    has_bump: bool = False,
    techniques: tuple = TECHNIQUES,
    mat_kinds: tuple = None,
):
    """One progressive VCM-family frame; returns the un-normalised film.

    Contributions are normalised exactly as the reference: everything is
    divided by frames*spp at display time; the light pass itself divides by
    light_path_count, so light_path_count can differ from the pixel count.

    `mat_kinds`: static tuple of material kinds present in the scene
    (engine.py derives it)."""
    assert algo in ALGOS
    frame = jnp.asarray(frame, jnp.uint32)
    base_radius = jnp.asarray(base_radius, jnp.float32)
    num_pixels = width * height
    if light_path_count <= 0:
        light_path_count = num_pixels // 2
    if cache_capacity <= 0:
        cache_capacity = auto_cache_capacity(light_path_count, max_len)
    if table_size <= 0:
        table_size = 2 * cache_capacity

    film = jnp.zeros((num_pixels, 3), jnp.float32)
    cache = None
    grid = None

    if algo != "pt":
        lband = BAND_RAYS
        # Depth-capped admission, schedule-invariant: on a SINGLE light
        # band the plain append-order truncation already keeps the
        # canonical shallowest set (its append order IS (bounce, lane),
        # bitwise-verified vs select_shallowest in
        # tests/test_cache_admission.py), so the common configs pay
        # zero machinery.  Multi-band schedules collect EVERY vertex
        # into a full-size transport cache and select the canonical
        # shallowest `cache_capacity` rows — the same set under any
        # banding (the collect+select route costs more, so it is gated
        # to the schedules that need it).
        num_lbands = -(-light_path_count // lband)
        if num_lbands <= 1:
            collect_cap = cache_capacity
        else:
            full_cap = light_path_count * max(max_len - 1, 1)
            collect_cap = max(cache_capacity,
                              min(full_cap, 4 * cache_capacity))
        cache = empty_cache(collect_cap)
        for start in range(0, light_path_count, lband):
            bp = min(lband, light_path_count - start)
            light_film, cache = _vcm_light_band(
                scene, cam, frame, base_radius, jnp.int32(start), cache,
                algo=algo, num_pixels=num_pixels,
                light_path_count=light_path_count, max_len=max_len,
                cache_capacity=collect_cap, has_masks=has_masks,
                has_bump=has_bump, techniques=techniques,
                band_paths=bp,
            )
            film = film + light_film
        # Canonical (path, bounce) cache order: makes the layout — and the
        # RNG-indexed vertex sampling downstream — independent of the
        # band/shard schedule (see light_cache.canonicalize).
        if collect_cap > cache_capacity:
            cache = select_shallowest(cache, cache_capacity)
        else:
            cache = canonicalize(cache)
        if algo in ("vcm", "ppm"):
            grid = _vcm_build_grid(
                cache, frame, base_radius, table_size=table_size,
                cache_capacity=cache_capacity,
                light_path_count=light_path_count, algo=algo,
            )

    if algo != "lt":
        band = max(1, BAND_RAYS // max(spp, 1))
        num_bands = -(-num_pixels // band)
        if _use_vcm_compact(num_bands, max_len):
            film = film + _camera_pass_compact(
                scene, cam, frame, cache, grid, base_radius, algo=algo,
                width=width, height=height, spp=spp, max_len=max_len,
                band=band, light_path_count=light_path_count,
                num_connections=num_connections, num_knn=num_knn,
                table_size=table_size, max_per_cell=max_per_cell,
                has_masks=has_masks, has_bump=has_bump,
                techniques=techniques, mat_kinds=mat_kinds,
            )
            return film
        parts = []
        for start in range(0, num_pixels, band):
            bp = min(band, num_pixels - start)
            parts.append(_vcm_camera_band(
                scene, cam, frame, cache, grid, base_radius, algo=algo,
                width=width, height=height, spp=spp, max_len=max_len,
                light_path_count=light_path_count,
                num_connections=num_connections, num_knn=num_knn,
                table_size=table_size, max_per_cell=max_per_cell,
                has_masks=has_masks, has_bump=has_bump,
                techniques=techniques, start_pixel=jnp.int32(start),
                band_pixels=bp, mat_kinds=mat_kinds,
            ))
        film = film + (parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0))

    return film
