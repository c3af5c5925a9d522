"""Stackless threaded-BVH traversal: closest hit and occlusion.

Replaces the reference's external AnyDSL kernels
`intersect_*_masked_instanced` / `occluded_*_masked_instanced`
(reference: render/scheduling/ray_queue.h:254-341, core/traversal_interface.h)
with a branch-free per-lane state machine over the threaded layout of
accel/flatten.py:

    next = bbox_hit ? hit_link : miss_link

Routes, chosen by what the input shows:

* alpha masks present -> the plain route (`_walk_closest`/`_walk_any`),
  a `lax.while_loop` that runs until no lane is active.  The traced
  texture lookup `alpha_fn(tri_id, u, v)` runs inline in `_mt_packet`,
  so masked traversal is exact at any depth.
* otherwise, lowered for a GPU -> the Pallas kernel of ops/bvh_kernel.py
  (same walk, one ray per lane, carry in registers, per-block exit);
* otherwise (the CPU) -> the plain route.

The walk is exact: there is no step cap, so a ray never stops before its
nearest hit.  Instancing is resolved at build time (world-space
flattening).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..accel.device import DeviceBvh
from ..accel.flatten import LEAF_WIDTH
from ..ops.bvh_kernel import any_hit_kernel, closest_hit_kernel
from .intersect import BIG, ray_aabb_xyz, ray_triangle_xyz, safe_inv_dir


class Hit(NamedTuple):
    t: jnp.ndarray        # (R,) f32; BIG on miss
    prim_id: jnp.ndarray  # (R,) i32 flat primitive id; -1 on miss
    u: jnp.ndarray        # (R,) f32 barycentric
    v: jnp.ndarray        # (R,) f32 barycentric


def _bits_to_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _components(a):
    return a[:, 0], a[:, 1], a[:, 2]


def _mt_packet(leaf_t, j, ox, oy, oz, dx, dy, dz, tmin, tmax, alpha_fn):
    """Moller-Trumbore for packed triangle j of the gathered leaf records
    (leaf_t: the (48, R) component-major packet).  Returns
    (t, u, v, id, ok)."""
    b = j * 12
    tid = _bits_to_i32(leaf_t[b + 9])
    t, u, v, ok = ray_triangle_xyz(
        (ox, oy, oz), (dx, dy, dz), tuple(leaf_t[b:b + 3]),
        tuple(leaf_t[b + 3:b + 6]), tuple(leaf_t[b + 6:b + 9]), tmin, tmax)
    ok = ok & (tid >= 0)
    if alpha_fn is not None:
        # Transparency-masked traversal (reference: "masked" kernel
        # variants, core/mask.h): drop alpha-masked-out hits.
        ok = ok & alpha_fn(jnp.maximum(tid, 0), u, v)
    return t, u, v, tid, ok


def _prep(org, d, tmin, tmax, active):
    num_r = org.shape[0]
    # Data-dependent zero: scalar tmin/tmax broadcasts must inherit the
    # rays' device-varying type under shard_map (zeros_like is a constant
    # fill and does NOT — the traversal loop carry would be typed
    # replicated-in / varying-out, a shard_map error).
    vary = (org[:, 0] + d[:, 0]) * 0.0  # org alone can be a constant
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (num_r,)) + vary
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (num_r,)) + vary
    ox, oy, oz = _components(org)
    dx, dy, dz = _components(d)
    start = jnp.zeros_like(tmin, dtype=jnp.int32)
    if active is not None:
        start = jnp.where(active, start, -1)
    return (ox, oy, oz, dx, dy, dz, tmin, tmax, start)


def _table_and_start(bvh, start, dx, dy, dz):
    """The record table to walk and each lane's first node.  With the
    octant-ordered copy (accel/flatten.thread_bvh_octants) a ray starts
    in the block of its direction octant and visits near children first."""
    if bvh.nodes64o is None:
        return bvh.nodes64, start
    n = bvh.nodes64.shape[0]
    octant = (
        ((dx < 0.0).astype(jnp.int32) << 2)
        | ((dy < 0.0).astype(jnp.int32) << 1)
        | (dz < 0.0).astype(jnp.int32)
    )
    return bvh.nodes64o, jnp.where(start >= 0, octant * n, -1)


def _node_fetch(table, node, ox, oy, oz, ix, iy, iz, tmin, t_limit, active):
    """One (R, 64) record gather per step + slab test.
    Returns (rec_t, box_hit, hit_link, miss_link, leaf_id)."""
    rec_t = table[node].T
    box_hit = ray_aabb_xyz((ox, oy, oz), (ix, iy, iz), tuple(rec_t[0:3]),
                           tuple(rec_t[3:6]), tmin, t_limit) & active
    return (
        rec_t,
        box_hit,
        _bits_to_i32(rec_t[6]),
        _bits_to_i32(rec_t[7]),
        _bits_to_i32(rec_t[8]),
    )


def _lanes_left(state):
    return jnp.any(state[0] >= 0)


def _walk_closest(bvh, org, d, tmin, tmax, active, alpha_fn=None) -> Hit:
    """The plain route: a while_loop that advances every active lane one
    node per step and stops when no lane is active."""
    ox, oy, oz, dx, dy, dz, tmin, tmax, start = _prep(org, d, tmin, tmax,
                                                      active)
    ix, iy, iz = safe_inv_dir(dx), safe_inv_dir(dy), safe_inv_dir(dz)
    table, start = _table_and_start(bvh, start, dx, dy, dz)

    def body(state):
        node_raw, best_t, best_id, best_u, best_v = state
        act = node_raw >= 0
        node = jnp.maximum(node_raw, 0)
        rec_t, box_hit, hit_link, miss_link, leaf_id = _node_fetch(
            table, node, ox, oy, oz, ix, iy, iz, tmin, best_t, act
        )
        do_leaf = box_hit & (leaf_id >= 0)
        leaf_t = rec_t[12:60]  # embedded 4-triangle packet
        for j in range(LEAF_WIDTH):
            t, u, v, tid, ok = _mt_packet(
                leaf_t, j, ox, oy, oz, dx, dy, dz, tmin, best_t, alpha_fn
            )
            closer = ok & do_leaf
            best_t = jnp.where(closer, t, best_t)
            best_id = jnp.where(closer, tid, best_id)
            best_u = jnp.where(closer, u, best_u)
            best_v = jnp.where(closer, v, best_v)

        nxt = jnp.where(box_hit, hit_link, miss_link)
        return jnp.where(act, nxt, -1), best_t, best_id, best_u, best_v

    init = (start, tmax, jnp.zeros_like(start) - 1, jnp.zeros_like(tmin),
            jnp.zeros_like(tmin))
    _, t, prim_id, u, v = jax.lax.while_loop(_lanes_left, body, init)
    t = jnp.where(prim_id >= 0, t, BIG)
    return Hit(t=t, prim_id=prim_id, u=u, v=v)


def _walk_any(bvh, org, d, tmin, tmax, active, alpha_fn=None):
    """Plain-route occlusion: each lane stops at its first occluder."""
    ox, oy, oz, dx, dy, dz, tmin, tmax, start = _prep(org, d, tmin, tmax,
                                                      active)
    ix, iy, iz = safe_inv_dir(dx), safe_inv_dir(dy), safe_inv_dir(dz)
    table, start = _table_and_start(bvh, start, dx, dy, dz)

    def body(state):
        node_raw, occluded = state
        act = node_raw >= 0
        node = jnp.maximum(node_raw, 0)
        rec_t, box_hit, hit_link, miss_link, leaf_id = _node_fetch(
            table, node, ox, oy, oz, ix, iy, iz, tmin, tmax, act
        )
        do_leaf = box_hit & (leaf_id >= 0)
        leaf_t = rec_t[12:60]
        found = jnp.zeros_like(act)
        for j in range(LEAF_WIDTH):
            _, _, _, _, ok = _mt_packet(
                leaf_t, j, ox, oy, oz, dx, dy, dz, tmin, tmax, alpha_fn
            )
            found = found | (ok & do_leaf)
        nxt = jnp.where(box_hit, hit_link, miss_link)
        return jnp.where(act & ~found, nxt, -1), occluded | found

    init = (start, jnp.zeros_like(tmin, dtype=jnp.bool_))
    _, occluded = jax.lax.while_loop(_lanes_left, body, init)
    return occluded


def _kernel_args(bvh, org, d, tmin, tmax, active):
    ox, oy, oz, dx, dy, dz, tmin, tmax, start = _prep(org, d, tmin, tmax,
                                                      active)
    table, start = _table_and_start(bvh, start, dx, dy, dz)
    return table, (ox, oy, oz, dx, dy, dz, tmin, tmax), start


def _kernel_closest(bvh, org, d, tmin, tmax, active) -> Hit:
    return Hit(*closest_hit_kernel(*_kernel_args(bvh, org, d, tmin, tmax,
                                                 active)))


def _kernel_any(bvh, org, d, tmin, tmax, active):
    return any_hit_kernel(*_kernel_args(bvh, org, d, tmin, tmax, active))


@partial(jax.jit, static_argnames=("alpha_fn",))
def closest_hit(
    bvh: DeviceBvh,
    org: jnp.ndarray,
    d: jnp.ndarray,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    alpha_fn: Optional[Callable] = None,
    active: Optional[jnp.ndarray] = None,
) -> Hit:
    """Closest-hit traversal for a batch of rays.

    org/d: (R, 3); tmin/tmax: scalar or (R,).  Lanes where `active` is
    False skip traversal entirely (start at the terminal node)."""
    args = (bvh, org, d, tmin, tmax, active)
    if alpha_fn is not None:
        return _walk_closest(*args, alpha_fn=alpha_fn)
    return jax.lax.platform_dependent(
        *args, cuda=_kernel_closest, default=_walk_closest)


@partial(jax.jit, static_argnames=("alpha_fn",))
def any_hit(
    bvh: DeviceBvh,
    org: jnp.ndarray,
    d: jnp.ndarray,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    alpha_fn: Optional[Callable] = None,
    active: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Occlusion query: True where *any* primitive blocks (tmin, tmax).

    Early-outs per lane the moment an occluder is found (the reference's
    `occluded_*` kernels, ray_queue.h:296-343)."""
    args = (bvh, org, d, tmin, tmax, active)
    if alpha_fn is not None:
        return _walk_any(*args, alpha_fn=alpha_fn)
    return jax.lax.platform_dependent(
        *args, cuda=_kernel_any, default=_walk_any)
