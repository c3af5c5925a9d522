"""Multi-chip SPMD rendering via shard_map over a device mesh.

The reference's parallelism is host threads over image tiles
(reference: render/scheduling/tile_scheduler.h:69-78) plus a GPU offload
per queue.  Here (SURVEY.md §5) the *ray batch* shards across devices —
the scene is replicated in every device's memory (it is read-only), each
device traces its ray shard fully on-device, splats a partial film, and a
single `psum` over the mesh reduces films.  No other
communication exists in the whole frame: this is embarrassingly parallel
modulo one collective, which is exactly why the wavefront design scales.

Light passes (VCM/BPT/PPM) shard the same way over light paths; the
vertex cache is all-gathered before the camera pass (small: compact
records), matching SURVEY.md §5's plan.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..render.camera import Camera
from ..render.film import splat
from ..render.integrators.pt import (_compact_carry, _init_carry, _pt_bounce,
                                     alpha_fn_for, camera_rays, compact_depth,
                                     trace_paths)
from ..render.integrators.vcm import BAND_RAYS as VCM_BAND_RAYS
from ..render.light_cache import LightVertexCache, empty_cache

RAY_AXIS = "rays"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(devices, (RAY_AXIS,))


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_len", "has_masks",
                     "has_bump", "mesh", "with_stats",
                     "band_pixels"),
)
def _pt_band_sharded(
    scene, cam, frame, start_pixel, *, width, height, spp, max_len,
    has_masks, has_bump, mesh, with_stats, band_pixels,
):
    """One sharded PT pixel band: rays for [start, start+n_dev*band) are
    generated replicated, sharded over the mesh, traced, splatted per
    shard, and psum-reduced."""
    num_pixels = width * height
    org, d, state, pixel_id = camera_rays(
        cam, width, height, spp, frame, start_pixel=start_pixel,
        count=band_pixels * mesh.devices.size,
    )

    def shard_fn(scene, cam, org, d, state, pixel_id):
        out = trace_paths(
            scene, org, d, state, max_len, has_masks=has_masks,
            has_bump=has_bump, with_stats=with_stats,
        )
        radiance, n_rays = out if with_stats else (out, None)
        film = jax.lax.psum(splat(radiance, pixel_id, num_pixels), RAY_AXIS)
        if with_stats:
            return film, jax.lax.psum(n_rays, RAY_AXIS)
        return film

    out_specs = (P(), P()) if with_stats else P()
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=out_specs,
    )(scene, cam, org, d, state, pixel_id)


# ---------------------------------------------------------------------------
# Sharded mid-frame lane compaction (the round-3 single-chip win, ported
# per docs/multichip.md: compact per shard, no new collectives).  Phase 1
# runs the first `compact_depth` bounces of every local band inside ONE
# shard_map call and sorts each shard's lanes dead-last LOCALLY (lax.sort
# under shard_map is shard-local); one host sync reads the per-shard alive
# counts, and ceil(max_alive / band) phase-2 dispatches finish the
# remaining bounces on every shard in lockstep (shards with fewer live
# lanes do masked work — the SPMD price; no new collectives beyond the
# existing film psum).  Per-lane math is bit-identical to the un-compacted
# sharded renderer; at spp=1 the film is bitwise identical too (one lane
# per pixel).  Reference role: ray_queue.h:161-207 across devices.
# ---------------------------------------------------------------------------

_PT_CARRY_KEYS = ("active", "d", "depth", "last_pdf", "last_specular", "org",
                  "radiance", "state", "throughput", "tmin")


@partial(jax.jit, static_argnames=(
    "width", "height", "spp", "max_len", "has_masks", "has_bump", "mesh",
    "bounces", "band_lanes"))
def _pt_phase1_compact_sharded(scene, cam, frame, *, width, height, spp,
                               max_len, has_masks, has_bump, mesh,
                               bounces, band_lanes):
    """Whole-frame phase 1: every shard traces its local bands for
    `bounces` bounces and compacts locally.  Returns (sorted carry
    [sharded], pixel ids [sharded], per-shard alive counts (n_dev,),
    psum'd ray count)."""
    num_pixels = width * height
    n_dev = mesh.devices.size
    org, d, state, pixel_id = camera_rays(cam, width, height, spp, frame)
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    lanes_local = (num_pixels * spp) // n_dev

    def shard_fn(scene, cam, org, d, state, pixel_id):
        def body(i, cc):
            return _pt_bounce(scene, cc, alpha_fn=alpha_fn,
                              has_bump=has_bump, max_len=max_len)

        carries, n_rays = [], None
        for s in range(0, lanes_local, band_lanes):
            e = min(s + band_lanes, lanes_local)
            c = _init_carry(org[s:e], d[s:e], state[s:e])
            c = jax.lax.fori_loop(0, bounces, body, c)
            n = c.pop("n_rays")
            n_rays = n if n_rays is None else n_rays + n
            carries.append(c)
        merged = (carries[0] if len(carries) == 1 else
                  jax.tree_util.tree_map(
                      lambda *xs: jnp.concatenate(xs, axis=0), *carries))
        sc, pix, alive = _compact_carry(merged, pixel_id)
        return sc, pix, alive[None], jax.lax.psum(n_rays, RAY_AXIS)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS),
                  P(RAY_AXIS)),
        out_specs=({k: P(RAY_AXIS) for k in _PT_CARRY_KEYS}, P(RAY_AXIS),
                   P(RAY_AXIS), P()),
    )(scene, cam, org, d, state, pixel_id)


@partial(jax.jit, static_argnames=(
    "max_len", "has_masks", "has_bump", "mesh", "bounces",
    "size"))
def _pt_phase2_sharded(scene, sc, start, *, max_len, has_masks, has_bump,
                       mesh, bounces, size):
    """Bounce local rows [start, start+size) of the compacted carry on
    every shard; writes results back in place."""
    alpha_fn = alpha_fn_for(scene) if has_masks else None

    def shard_fn(scene, sc, start):
        ck = jax.tree_util.tree_map(
            lambda a: jax.lax.dynamic_slice_in_dim(a, start, size, 0), sc)
        # Derived-from-input zero: a replicated literal would change
        # varying-ness across the loop carry (shard_map vma typing).
        ck["n_rays"] = jnp.sum(jnp.zeros_like(ck["depth"][:1]))

        def body(i, cc):
            return _pt_bounce(scene, cc, alpha_fn=alpha_fn,
                              has_bump=has_bump, max_len=max_len)

        out = jax.lax.fori_loop(0, bounces, body, ck)
        n = out.pop("n_rays")
        sc2 = {k: jax.lax.dynamic_update_slice_in_dim(sc[k], out[k], start, 0)
               for k in sc}
        return sc2, jax.lax.psum(n, RAY_AXIS)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), {k: P(RAY_AXIS) for k in _PT_CARRY_KEYS}, P()),
        out_specs=({k: P(RAY_AXIS) for k in _PT_CARRY_KEYS}, P()),
    )(scene, sc, start)


@partial(jax.jit, static_argnames=("mesh", "num_pixels"))
def _scatter_film_sharded(pix, rad, *, mesh, num_pixels):
    def shard_fn(pix, rad):
        return jax.lax.psum(splat(rad, pix, num_pixels), RAY_AXIS)

    return jax.shard_map(shard_fn, mesh=mesh,
                         in_specs=(P(RAY_AXIS), P(RAY_AXIS)),
                         out_specs=P())(pix, rad)


def _render_pt_frame_compact_sharded(scene, cam, frame, width, height, spp,
                                     max_len, has_masks, has_bump,
                                     with_stats, mesh, band_lanes):
    num_pixels = width * height
    n_dev = mesh.devices.size
    depth0 = compact_depth(max_len)
    lanes_local = (num_pixels * spp) // n_dev

    sc, pix, alive, n_rays = _pt_phase1_compact_sharded(
        scene, cam, frame, width=width, height=height, spp=spp,
        max_len=max_len, has_masks=has_masks, has_bump=has_bump, mesh=mesh,
        bounces=depth0, band_lanes=band_lanes)

    n_alive = int(jnp.max(alive))  # the one host sync
    todo = min(lanes_local,
               -(-n_alive // band_lanes) * band_lanes if n_alive else 0)
    start = 0
    while start < todo:
        size = min(band_lanes, lanes_local - start)
        sc, n2 = _pt_phase2_sharded(
            scene, sc, jnp.int32(start), max_len=max_len,
            has_masks=has_masks, has_bump=has_bump,
            mesh=mesh, bounces=max_len - depth0, size=size)
        n_rays = n_rays + n2
        start += size
    film = _scatter_film_sharded(pix, sc["radiance"], mesh=mesh,
                                 num_pixels=num_pixels)
    if with_stats:
        return film, n_rays
    return film


def render_pt_frame_sharded(
    scene,
    cam: Camera,
    frame: jnp.ndarray,
    width: int,
    height: int,
    mesh: Mesh,
    spp: int = 1,
    max_len: int = 10,
    has_masks: bool = False,
    has_bump: bool = False,
    with_stats: bool = False,
):
    """Data-parallel PT frame over `mesh`; returns the full (H*W, 3) film
    (replicated).  Bit-identical to the single-chip renderer (RNG is keyed
    by global pixel id; the film reduction is a per-pixel sum over
    disjoint ray shards)."""
    num_pixels = width * height
    n_dev = mesh.devices.size
    frame = jnp.asarray(frame, jnp.uint32)
    # Per-device dispatch cap, same rationale as the single-chip bands.
    band = min(BAND_RAYS // max(spp, 1), max(num_pixels // n_dev, 1))

    # Mid-frame compaction (same default as the single-chip
    # renderer, pt._use_compact) when shards have multiple local bands and
    # lanes split evenly over the mesh.
    from ..render.integrators.pt import _use_compact

    band_lanes = band * spp
    lanes_local = (num_pixels * spp) // n_dev
    num_bands_local = (-(-lanes_local // band_lanes)
                       if (num_pixels * spp) % n_dev == 0 else 1)
    if num_bands_local > 1 and _use_compact(num_bands_local, max_len):
        return _render_pt_frame_compact_sharded(
            scene, cam, frame, width, height, spp, max_len, has_masks,
            has_bump, with_stats, mesh, band_lanes)
    film = jnp.zeros((num_pixels, 3), jnp.float32)
    stats = jnp.zeros((), jnp.int32)
    # Sharded bands cover exactly bp * n_dev pixels each; the final
    # < n_dev remainder is rendered un-sharded below, so every pixel is
    # rendered exactly once for ANY resolution (no divisibility clamp —
    # the old `max(remainder // n_dev, 1)` could under- or over-cover).
    start = 0
    while num_pixels - start >= n_dev:
        bp = min(band, (num_pixels - start) // n_dev)
        out = _pt_band_sharded(
            scene, cam, frame, jnp.int32(start), width=width, height=height,
            spp=spp, max_len=max_len, has_masks=has_masks, has_bump=has_bump,
            mesh=mesh, with_stats=with_stats,
            band_pixels=bp,
        )
        if with_stats:
            part, n = out
            film = film + part
            stats = stats + n
        else:
            film = film + out
        start += bp * n_dev
    if start < num_pixels:
        from ..render.integrators.pt import _pt_band

        tail = num_pixels - start
        out = _pt_band(
            scene, cam, frame, jnp.int32(start), width=width, height=height,
            spp=spp, max_len=max_len, has_masks=has_masks, has_bump=has_bump,
            with_stats=with_stats, band_pixels=tail,
        )
        part = out[0] if with_stats else out
        film = film.at[start : start + tail].add(part)
        if with_stats:
            stats = stats + out[1]
    if with_stats:
        return film, stats
    return film


# ======================================================================
#  VCM-family multi-chip rendering
# ======================================================================
#
# SURVEY.md §5 plan: shard light paths over the mesh, merge the (compact)
# vertex caches, replicate the merged cache + hash grid, shard camera
# rays, psum/concat films.  The merge reproduces the single-chip banded
# append order exactly: per light-band iteration every shard starts from
# an empty local cache, and the merge scatters shard k's vertices at the
# global offset after shards 0..k-1 — i.e. shard-major order, which is
# the same as single-chip band order when the shard split equals the
# band split (it does: both are contiguous BAND-ray slices of the global
# path index space).  So on shapes where no local cache overflows, the
# merged cache — and therefore the whole frame — is bitwise identical to
# the single-chip renderer.  (Overflow drops can differ: each shard's
# local head-room is 2x its band rather than the global remainder.)
#
# Reference roles: tile_scheduler.h:69-78 (host-thread tiling) and
# light_vertices.h:59-127 (shared atomic cache) — here one all-gather-
# style merge per light band and one psum per film.


@partial(jax.jit, static_argnames=("n_dev",))
def _merge_cache(global_cache: LightVertexCache,
                 shard_cache: LightVertexCache,
                 n_dev: int) -> LightVertexCache:
    """Append shard-local caches ((n_dev*cap_l, ...), count (n_dev,))
    into the replicated global cache, in shard-major order."""
    cap_l = shard_cache.pos.shape[0] // n_dev
    cap = global_cache.capacity
    counts = shard_cache.count.astype(jnp.int32)          # (n_dev,)
    offs = jnp.cumsum(counts) - counts                     # exclusive
    li = jnp.arange(cap_l, dtype=jnp.int32)
    valid = li[None, :] < counts[:, None]                  # (n_dev, cap_l)
    tgt = jnp.where(
        valid, global_cache.count + offs[:, None] + li[None, :], cap
    ).reshape(-1)
    tgt = jnp.where(tgt >= cap, cap, tgt)                  # overflow drop

    def put(dst, src):
        return dst.at[tgt].set(src, mode="drop")

    new_count = jnp.minimum(global_cache.count + counts.sum(), cap)
    return LightVertexCache(
        pos=put(global_cache.pos, shard_cache.pos),
        w_out=put(global_cache.w_out, shard_cache.w_out),
        normal=put(global_cache.normal, shard_cache.normal),
        gn=put(global_cache.gn, shard_cache.gn),
        uv=put(global_cache.uv, shard_cache.uv),
        mat_id=put(global_cache.mat_id, shard_cache.mat_id),
        throughput=put(global_cache.throughput, shard_cache.throughput),
        d_vc=put(global_cache.d_vc, shard_cache.d_vc),
        d_vcm=put(global_cache.d_vcm, shard_cache.d_vcm),
        d_vm=put(global_cache.d_vm, shard_cache.d_vm),
        path_length=put(global_cache.path_length, shard_cache.path_length),
        path_id=put(global_cache.path_id, shard_cache.path_id),
        count=new_count,
    )


@partial(jax.jit, static_argnames=(
    "mesh", "algo", "num_pixels", "light_path_count", "max_len",
    "local_capacity", "has_masks", "has_bump", "techniques",
    "band_paths", "admit_cap",
))
def _vcm_light_band_sharded(scene, cam, frame, base_radius, path_start, *,
                            mesh, algo, num_pixels, light_path_count,
                            max_len, local_capacity, has_masks, has_bump,
                            techniques, band_paths, admit_cap=0):
    """One sharded light band: every device traces `band_paths` paths into
    an empty local cache.  Returns (film (psum'd, replicated), local
    caches with leading shard axis)."""
    from ..render.integrators.pt import alpha_fn_for
    from ..render.integrators.vcm import _light_pass, _mis_constants

    pm_radius, mis_eta_vc, mis_eta_vm = _mis_constants(
        frame, base_radius, light_path_count, algo
    )
    alpha_fn = alpha_fn_for(scene) if has_masks else None

    def shard_fn(scene, cam, frame, pm_radius, base_radius, eta_vc, eta_vm,
                 path_start):
        my_start = path_start + jax.lax.axis_index(RAY_AXIS) * band_paths
        film, cache = _light_pass(
            scene, cam, frame, pm_radius, base_radius, eta_vc, eta_vm,
            algo=algo, num_pixels=num_pixels,
            light_path_count=light_path_count, max_len=max_len,
            cache_capacity=local_capacity, has_masks=has_masks,
            has_bump=has_bump, alpha_fn=alpha_fn,
            techniques=techniques, path_start=my_start,
            band_paths=band_paths, cache_in=empty_cache(local_capacity),
            admit_cap=admit_cap,
        )
        film = jax.lax.psum(film, RAY_AXIS)
        return film, cache.replace(count=cache.count[None])

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(RAY_AXIS)),
    )(scene, cam, frame, pm_radius, base_radius, mis_eta_vc, mis_eta_vm,
      path_start)


@partial(jax.jit, static_argnames=(
    "mesh", "algo", "width", "height", "spp", "max_len", "light_path_count",
    "num_connections", "num_knn", "table_size", "max_per_cell", "has_masks",
    "has_bump", "techniques", "band_pixels", "mat_kinds",
))
def _vcm_camera_band_sharded(scene, cam, frame, cache, grid, base_radius,
                             start_pixel, *, mesh, algo, width, height, spp,
                             max_len, light_path_count, num_connections,
                             num_knn, table_size, max_per_cell, has_masks,
                             has_bump, techniques, band_pixels,
                             mat_kinds=None):
    """One sharded camera band: each device renders `band_pixels` pixels
    with the replicated merged cache; films concatenate along the mesh."""
    from ..render.integrators.pt import alpha_fn_for
    from ..render.integrators.vcm import _camera_pass, _mis_constants

    pm_radius, mis_eta_vc, mis_eta_vm = _mis_constants(
        frame, base_radius, light_path_count, algo
    )
    alpha_fn = alpha_fn_for(scene) if has_masks else None

    def shard_fn(scene, cam, frame, cache, grid, pm_radius, base_radius,
                 eta_vc, eta_vm, start_pixel):
        my_start = start_pixel + jax.lax.axis_index(RAY_AXIS) * band_pixels
        return _camera_pass(
            scene, cam, frame, cache, grid, pm_radius, base_radius,
            eta_vc, eta_vm, algo=algo, width=width, height=height, spp=spp,
            max_len=max_len, light_path_count=light_path_count,
            num_connections=num_connections, num_knn=num_knn,
            table_size=table_size, max_per_cell=max_per_cell,
            has_masks=has_masks, has_bump=has_bump, alpha_fn=alpha_fn,
            techniques=techniques,
            start_pixel=my_start, band_pixels=band_pixels,
            mat_kinds=mat_kinds,
        )

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(),) * 10,
        out_specs=P(RAY_AXIS),
    )(scene, cam, frame, cache, grid, pm_radius, base_radius, mis_eta_vc,
      mis_eta_vm, start_pixel)


BAND_RAYS = 1 << 18  # per-device dispatch cap (see integrators.vcm)


# ---------------------------------------------------------------------------
# Sharded VCM camera-pass compaction (same structure as the PT port above:
# per-shard local bands + local dead-last sort inside one shard_map, one
# host sync on the max per-shard alive count, lockstep phase-2 bands).
# Each shard covers the contiguous global pixel range
# [axis_index * pixels_local, ...) — a different cover than the
# un-compacted band interleave, but RNG is keyed by global pixel id and
# the film is scattered by pixel id, so any disjoint cover renders the
# same frame.
# ---------------------------------------------------------------------------

_VCM_CARRY_KEYS = ("active", "d", "d_vc", "d_vcm", "d_vm", "org", "radiance",
                   "state", "throughput", "tmin")

_VCM_SHARD_STATICS = (
    "mesh", "algo", "width", "height", "spp", "max_len", "light_path_count",
    "num_connections", "num_knn", "table_size", "max_per_cell", "has_masks",
    "has_bump", "techniques", "mat_kinds", "bounces",
)


@partial(jax.jit, static_argnames=_VCM_SHARD_STATICS + ("band_pixels",))
def _vcm_camera_phase1_sharded(scene, cam, frame, cache, grid, base_radius,
                               *, mesh, algo, width, height, spp, max_len,
                               light_path_count, num_connections, num_knn,
                               table_size, max_per_cell, has_masks, has_bump,
                               techniques, mat_kinds, bounces,
                               band_pixels):
    """Whole-frame camera phase 1: every shard traces its local pixel
    bands for `bounces` camera bounces and compacts locally."""
    from ..render.integrators.vcm import (_camera_body_fn,
                                          _camera_carry_init, _mis_constants)

    pm_radius, mis_eta_vc, mis_eta_vm = _mis_constants(
        frame, base_radius, light_path_count, algo)
    alpha_fn = alpha_fn_for(scene) if has_masks else None
    num_pixels = width * height
    n_dev = mesh.devices.size
    pixels_local = num_pixels // n_dev

    def shard_fn(scene, cam, frame, cache, grid, pm_radius, base_radius,
                 eta_vc, eta_vm):
        body = _camera_body_fn(
            scene, cache, grid, pm_radius, base_radius, eta_vc, eta_vm,
            algo=algo, max_len=max_len, light_path_count=light_path_count,
            num_connections=num_connections, num_knn=num_knn,
            table_size=table_size, max_per_cell=max_per_cell,
            has_bump=has_bump, alpha_fn=alpha_fn,
            techniques=techniques, mat_kinds=mat_kinds)
        base = jax.lax.axis_index(RAY_AXIS) * pixels_local
        carries, pids = [], []
        for s in range(0, pixels_local, band_pixels):
            bp = min(band_pixels, pixels_local - s)
            carry, pid = _camera_carry_init(
                scene, cam, frame, width=width, height=height, spp=spp,
                light_path_count=light_path_count, start_pixel=base + s,
                band_pixels=bp)
            carries.append(jax.lax.fori_loop(0, bounces, body, carry))
            pids.append(pid)
        merged = (carries[0] if len(carries) == 1 else
                  jax.tree_util.tree_map(
                      lambda *xs: jnp.concatenate(xs, axis=0), *carries))
        pix = pids[0] if len(pids) == 1 else jnp.concatenate(pids, axis=0)
        sc, pix, alive = _compact_carry(merged, pix)
        return sc, pix, alive[None]

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(),) * 9,
        out_specs=({k: P(RAY_AXIS) for k in _VCM_CARRY_KEYS}, P(RAY_AXIS),
                   P(RAY_AXIS)),
    )(scene, cam, frame, cache, grid, pm_radius, base_radius, mis_eta_vc,
      mis_eta_vm)


@partial(jax.jit, static_argnames=_VCM_SHARD_STATICS + ("size",))
def _vcm_camera_phase2_sharded(scene, frame, cache, grid, base_radius, sc,
                               start, *, mesh, algo, width, height, spp,
                               max_len, light_path_count, num_connections,
                               num_knn, table_size, max_per_cell, has_masks,
                               has_bump, techniques, mat_kinds,
                               bounces, size):
    """Camera bounces [bounces, max_len) on local rows [start, start+size)
    of every shard's compacted carry, written back in place."""
    from ..render.integrators.vcm import _camera_body_fn, _mis_constants

    pm_radius, mis_eta_vc, mis_eta_vm = _mis_constants(
        frame, base_radius, light_path_count, algo)
    alpha_fn = alpha_fn_for(scene) if has_masks else None

    def shard_fn(scene, frame, cache, grid, pm_radius, base_radius, eta_vc,
                 eta_vm, sc, start):
        body = _camera_body_fn(
            scene, cache, grid, pm_radius, base_radius, eta_vc, eta_vm,
            algo=algo, max_len=max_len, light_path_count=light_path_count,
            num_connections=num_connections, num_knn=num_knn,
            table_size=table_size, max_per_cell=max_per_cell,
            has_bump=has_bump, alpha_fn=alpha_fn,
            techniques=techniques, mat_kinds=mat_kinds)
        ck = jax.tree_util.tree_map(
            lambda a: jax.lax.dynamic_slice_in_dim(a, start, size, 0), sc)
        out = jax.lax.fori_loop(bounces, max_len, body, ck)
        return {k: jax.lax.dynamic_update_slice_in_dim(sc[k], out[k],
                                                       start, 0)
                for k in sc}

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(),) * 8 + ({k: P(RAY_AXIS) for k in _VCM_CARRY_KEYS},
                               P()),
        out_specs={k: P(RAY_AXIS) for k in _VCM_CARRY_KEYS},
    )(scene, frame, cache, grid, pm_radius, base_radius, mis_eta_vc,
      mis_eta_vm, sc, start)


def _vcm_camera_pass_compact_sharded(scene, cam, frame, cache, grid,
                                     base_radius, mesh, *, band, spp,
                                     max_len, width, height, **kw):
    """Sharded camera pass with per-shard mid-frame compaction."""
    from ..render.integrators.vcm import vcm_compact_depth

    num_pixels = width * height
    n_dev = mesh.devices.size
    depth0 = vcm_compact_depth(max_len)
    lanes_local = (num_pixels // n_dev) * spp
    band_lanes = band * spp

    sc, pix, alive = _vcm_camera_phase1_sharded(
        scene, cam, frame, cache, grid, base_radius, mesh=mesh, spp=spp,
        max_len=max_len, width=width, height=height, bounces=depth0,
        band_pixels=band, **kw)

    n_alive = int(jnp.max(alive))  # the one host sync
    todo = min(lanes_local,
               -(-n_alive // band_lanes) * band_lanes if n_alive else 0)
    start = 0
    while start < todo:
        size = min(band_lanes, lanes_local - start)
        sc = _vcm_camera_phase2_sharded(
            scene, frame, cache, grid, base_radius, sc, jnp.int32(start),
            mesh=mesh, spp=spp, max_len=max_len, width=width, height=height,
            bounces=depth0, size=size, **kw)
        start += size
    return _scatter_film_sharded(pix, sc["radiance"], mesh=mesh,
                                 num_pixels=num_pixels)


def render_vcm_frame_sharded(
    scene,
    cam: Camera,
    frame,
    base_radius,
    mesh: Mesh,
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
    techniques=None,
    mat_kinds: tuple = None,
):
    """Multi-chip VCM-family frame (drop-in for
    integrators.vcm.render_vcm_frame; see the module comment for the
    exactness contract)."""
    from ..render.integrators.vcm import (
        ALGOS, TECHNIQUES, _vcm_build_grid,
    )

    if techniques is None:
        techniques = TECHNIQUES
    assert algo in ALGOS
    n_dev = mesh.devices.size
    frame = jnp.asarray(frame, jnp.uint32)
    base_radius = jnp.asarray(base_radius, jnp.float32)
    num_pixels = width * height
    if light_path_count <= 0:
        light_path_count = num_pixels // 2
    from ..render.integrators.vcm import auto_cache_capacity

    if cache_capacity <= 0:
        cache_capacity = auto_cache_capacity(light_path_count, max_len)
    if table_size <= 0:
        table_size = 2 * cache_capacity

    film = jnp.zeros((num_pixels, 3), jnp.float32)
    cache = None
    grid = None

    if algo != "pt":
        # Light paths shard the ESTIMATOR's sample space: tracing more
        # (or fewer) paths than light_path_count biases the light-tracing
        # film, so the count must split exactly over the mesh.  The
        # engine/CLI round it up to a mesh multiple (engine.py); direct
        # callers must do the same.
        if light_path_count % n_dev != 0:
            raise ValueError(
                f"light_path_count ({light_path_count}) must be divisible "
                f"by the mesh size ({n_dev}); round it up as engine.py does"
            )
        # Per-device band, global stride n_dev * band: the shard split of
        # the path index space equals the single-chip band split.
        band = min(VCM_BAND_RAYS, light_path_count // n_dev)
        stride = band * n_dev
        # Collect-then-select (single-chip render_vcm_frame, same
        # constants): every vertex lands in a full-size transport cache
        # and light_cache.select_shallowest keeps the canonical
        # shallowest `cache_capacity` — so the sharded cache holds
        # exactly the single-chip vertex set, bitwise.
        full_cap = light_path_count * max(max_len - 1, 1)
        collect_cap = max(cache_capacity,
                          min(full_cap, 4 * cache_capacity))
        cache = empty_cache(collect_cap)
        for start in range(0, light_path_count, stride):
            # Remainders stay divisible by n_dev (count and stride both
            # are), so the tail band is exact.
            bp = min(band, (light_path_count - start) // n_dev)
            # Per-shard band cache: a transport buffer sized so the
            # band NEVER truncates locally — max_len-1 slots per path.
            local_cap = max(bp * max(max_len - 1, 1), 1024)
            light_film, shard_cache = _vcm_light_band_sharded(
                scene, cam, frame, base_radius, jnp.int32(start),
                mesh=mesh, algo=algo, num_pixels=num_pixels,
                light_path_count=light_path_count, max_len=max_len,
                local_capacity=local_cap, has_masks=has_masks,
                has_bump=has_bump,
                techniques=techniques, band_paths=bp,
            )
            film = film + light_film
            cache = _merge_cache(cache, shard_cache, n_dev)
        from ..render.light_cache import canonicalize, select_shallowest

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
        band = min(VCM_BAND_RAYS // max(spp, 1),
                   max(num_pixels // n_dev, 1))
        from ..render.integrators.vcm import _use_vcm_compact

        num_bands_local = (-(-(num_pixels // n_dev) // band)
                           if num_pixels % n_dev == 0 else 1)
        if num_bands_local > 1 and _use_vcm_compact(num_bands_local, max_len):
            return film + _vcm_camera_pass_compact_sharded(
                scene, cam, frame, cache, grid, base_radius, mesh,
                band=band, spp=spp, max_len=max_len, width=width,
                height=height, algo=algo,
                light_path_count=light_path_count,
                num_connections=num_connections, num_knn=num_knn,
                table_size=table_size, max_per_cell=max_per_cell,
                has_masks=has_masks, has_bump=has_bump,
                techniques=techniques, mat_kinds=mat_kinds)
        parts = []
        # Sharded bands cover exactly bp * n_dev pixels; the final
        # < n_dev remainder renders un-sharded (single-device band), so
        # the concatenated parts cover every pixel exactly once for ANY
        # resolution.
        start = 0
        while num_pixels - start >= n_dev:
            bp = min(band, (num_pixels - start) // n_dev)
            parts.append(_vcm_camera_band_sharded(
                scene, cam, frame, cache, grid, base_radius,
                jnp.int32(start), mesh=mesh, algo=algo, width=width,
                height=height, spp=spp, max_len=max_len,
                light_path_count=light_path_count,
                num_connections=num_connections, num_knn=num_knn,
                table_size=table_size, max_per_cell=max_per_cell,
                has_masks=has_masks, has_bump=has_bump,
                techniques=techniques, band_pixels=bp, mat_kinds=mat_kinds,
            ))
            start += bp * n_dev
        if start < num_pixels:
            from ..render.integrators.vcm import _vcm_camera_band

            parts.append(_vcm_camera_band(
                scene, cam, frame, cache, grid, base_radius, algo=algo,
                width=width, height=height, spp=spp, max_len=max_len,
                light_path_count=light_path_count,
                num_connections=num_connections, num_knn=num_knn,
                table_size=table_size, max_per_cell=max_per_cell,
                has_masks=has_masks, has_bump=has_bump,
                techniques=techniques, start_pixel=jnp.int32(start),
                band_pixels=num_pixels - start, mat_kinds=mat_kinds,
            ))
        cam_film = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        film = film + cam_film
    return film
