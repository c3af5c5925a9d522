"""Threaded-BVH traversal kernel for NVIDIA Hopper (H100), Pallas on Triton.

Written for that card: one program walks a block of rays, one ray per
lane, over the stackless threaded layout of `accel/flatten.py` (`nodes64`
records: box, hit/miss links, embedded 4-triangle leaf packet).  This is
the shape of the reference renderer's own GPU traversal (one ray per
thread), with the per-ray stack replaced by the skip links.

Each block runs its own `while_loop` until every lane in it has reached
the terminal node, gathers each lane's node record from device memory
(a 35k-node tree is ~9 MB and stays in the 50 MB L2), and keeps the ray
and its best hit in registers; the hit is written once.  The plain
XLA route (`render/traverse._walk_*`) instead writes its whole per-lane
carry back to device memory every step and runs to the slowest lane of
the whole batch.

The leaf packet is read with a masked load, so only lanes that hit a
leaf box pay for its 40 floats.  Inputs are component-major (R,) arrays;
R is padded to the block here and padded lanes start at the terminal
node.  Only tests pass `interpret=True`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..accel.flatten import LEAF_WIDTH
from ..render.intersect import (BIG, ray_aabb_xyz, ray_triangle_xyz,
                                safe_inv_dir)

_BIG = float(BIG)

BLOCK = 64
NUM_WARPS = 2


def _i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _read(ref):
    """A lane block as a value.  Inside shard_map a raw block read keeps
    the input's mesh-varying type while every op of the body (traced with
    that typing off) drops it; one add gives the loop carries one type."""
    return ref[...] + jnp.zeros((), ref.dtype)


def _box(table_ref, node, act, ox, oy, oz, ix, iy, iz, tmin, t_limit):
    """Slab test of each lane's node box; returns (box_hit, next, leaf?)."""
    def col(c):
        return pltriton.load(table_ref.at[node, c], mask=act, other=0.0)

    box_hit = ray_aabb_xyz((ox, oy, oz), (ix, iy, iz),
                           (col(0), col(1), col(2)), (col(3), col(4), col(5)),
                           tmin, t_limit) & act
    hit_link, miss_link, leaf_id = _i32(col(6)), _i32(col(7)), _i32(col(8))
    nxt = jnp.where(box_hit, hit_link, miss_link)
    return box_hit, nxt, box_hit & (leaf_id >= 0)


def _tri(table_ref, node, do_leaf, j, ox, oy, oz, dx, dy, dz, tmin, tmax):
    """Moller-Trumbore for packed triangle j of the lane's leaf packet."""
    b = 12 + 12 * j

    def col(c):
        return pltriton.load(table_ref.at[node, b + c], mask=do_leaf,
                             other=0.0)

    tid = _i32(pltriton.load(table_ref.at[node, b + 9], mask=do_leaf,
                             other=-1.0))
    t, u, v, ok = ray_triangle_xyz(
        (ox, oy, oz), (dx, dy, dz), (col(0), col(1), col(2)),
        (col(3), col(4), col(5)), (col(6), col(7), col(8)), tmin, tmax)
    return t, u, v, tid, ok & (tid >= 0) & do_leaf


def _closest_kernel(table_ref, *refs):
    ray_refs, start_ref = refs[:8], refs[8]
    t_ref, id_ref, u_ref, v_ref = refs[9:]
    ox, oy, oz, dx, dy, dz, tmin, tmax = (_read(r) for r in ray_refs)
    ix, iy, iz = safe_inv_dir(dx), safe_inv_dir(dy), safe_inv_dir(dz)

    def cond(st):
        return jnp.max(st[0]) >= 0

    def body(st):
        node, bt, bid, bu, bv = st
        act = node >= 0
        n = jnp.maximum(node, 0)
        box_hit, nxt, do_leaf = _box(table_ref, n, act, ox, oy, oz,
                                     ix, iy, iz, tmin, bt)
        for j in range(LEAF_WIDTH):
            t, u, v, tid, ok = _tri(table_ref, n, do_leaf, j, ox, oy, oz,
                                    dx, dy, dz, tmin, bt)
            bt = jnp.where(ok, t, bt)
            bid = jnp.where(ok, tid, bid)
            bu = jnp.where(ok, u, bu)
            bv = jnp.where(ok, v, bv)
        return jnp.where(act, nxt, -1), bt, bid, bu, bv

    start = _read(start_ref)
    _, bt, bid, bu, bv = jax.lax.while_loop(
        cond, body,
        (start, tmax, jnp.full_like(start, -1), jnp.zeros_like(tmax),
         jnp.zeros_like(tmax)))
    t_ref[...] = jnp.where(bid >= 0, bt, _BIG)
    id_ref[...] = bid
    u_ref[...] = bu
    v_ref[...] = bv


def _any_kernel(table_ref, *refs):
    ray_refs, start_ref, occ_ref = refs[:8], refs[8], refs[9]
    ox, oy, oz, dx, dy, dz, tmin, tmax = (_read(r) for r in ray_refs)
    ix, iy, iz = safe_inv_dir(dx), safe_inv_dir(dy), safe_inv_dir(dz)

    def cond(st):
        return jnp.max(st[0]) >= 0

    def body(st):
        node, occ = st
        act = node >= 0
        n = jnp.maximum(node, 0)
        _, nxt, do_leaf = _box(table_ref, n, act, ox, oy, oz, ix, iy, iz,
                               tmin, tmax)
        found = jnp.zeros_like(act)
        for j in range(LEAF_WIDTH):
            found = found | _tri(table_ref, n, do_leaf, j, ox, oy, oz,
                                 dx, dy, dz, tmin, tmax)[4]
        # A lane stops at its first occluder.
        return jnp.where(act & ~found, nxt, -1), occ | found.astype(jnp.int32)

    start = _read(start_ref)
    _, occ = jax.lax.while_loop(cond, body, (start, jnp.zeros_like(start)))
    occ_ref[...] = occ


def _call(kernel, n_out, table, rays, start, block, num_warps, interpret):
    num_r = start.shape[0]
    pad = (-num_r) % block
    if pad:
        rays = [jnp.pad(r, (0, pad)) for r in rays]
        start = jnp.pad(start, (0, pad), constant_values=-1)
    total = num_r + pad
    lane = pl.BlockSpec((block,), lambda i: (i,))
    whole = pl.BlockSpec(table.shape, lambda i: (0, 0))
    vma = frozenset().union(*(jax.typeof(a).vma for a in (table, *rays, start)))
    f32 = jax.ShapeDtypeStruct((total,), jnp.float32, vma=vma)
    i32 = jax.ShapeDtypeStruct((total,), jnp.int32, vma=vma)
    out_shape = (f32, i32, f32, f32) if n_out == 4 else (i32,)
    outs = pl.pallas_call(
        kernel,
        grid=(total // block,),
        in_specs=[whole] + [lane] * 9,
        out_specs=[lane] * n_out,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name=kernel.__name__.lstrip("_"),
    )(table, *rays, start)
    return tuple(o[:num_r] for o in outs)


@partial(jax.jit, static_argnames=("block", "num_warps", "interpret"))
def closest_hit_kernel(table, rays, start, *, block=BLOCK,
                       num_warps=NUM_WARPS, interpret=False):
    """rays: 8 (R,) f32 arrays (ox, oy, oz, dx, dy, dz, tmin, tmax);
    start: (R,) i32 first node, -1 for an inactive lane.
    Returns (t, prim_id, u, v); t = BIG and prim_id = -1 on a miss."""
    return _call(_closest_kernel, 4, table, list(rays), start, block,
                 num_warps, interpret)


@partial(jax.jit, static_argnames=("block", "num_warps", "interpret"))
def any_hit_kernel(table, rays, start, *, block=BLOCK, num_warps=NUM_WARPS,
                   interpret=False):
    """Same inputs as closest_hit_kernel; returns the (R,) occlusion flag."""
    (occ,) = _call(_any_kernel, 1, table, list(rays), start, block,
                   num_warps, interpret)
    return occ > 0
