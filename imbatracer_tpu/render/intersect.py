"""Ray-primitive intersection, fully batched (jnp).

Moller-Trumbore triangle test plus a brute-force all-triangles closest-hit
intersector used as ground truth for BVH traversal tests (SURVEY.md item 3:
"Validate against a brute-force jnp all-triangles intersector").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BIG = jnp.float32(1e30)


def ray_triangle(org, d, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore. All args broadcastable; vectors on trailing axis.

    Returns (t, u, v, hit).  Misses report t = BIG.
    """
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    # Two-sided test; reject near-parallel rays.
    inv_det = jnp.where(jnp.abs(det) < 1e-12, 0.0, 1.0 / det)
    tvec = org - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (inv_det != 0.0)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    return jnp.where(hit, t, BIG), u, v, hit


def ray_aabb(org, inv_d, box_min, box_max, tmin, tmax):
    """Slab test. Returns entry-interval hit mask (robust to inf*0 via
    explicit min/max ordering)."""
    t0 = (box_min - org) * inv_d
    t1 = (box_max - org) * inv_d
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (t_near <= t_far) & (t_far >= tmin) & (t_near <= tmax)


def safe_inv_dir(d, eps=1e-12):
    """Reciprocal direction with signed clamp to avoid 0-division NaNs."""
    s = jnp.where(d >= 0.0, 1.0, -1.0)
    return s / jnp.maximum(jnp.abs(d), eps)


def ray_triangle_xyz(o, d, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore on component triples (each an (x, y, z) tuple of
    same-shape arrays), the form both traversal routes use.  Returns
    (t, u, v, hit)."""
    (ox, oy, oz), (dx, dy, dz) = o, d
    (v0x, v0y, v0z), (e1x, e1y, e1z), (e2x, e2y, e2z) = v0, e1, e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = jnp.where(jnp.abs(det) < 1e-12, 0.0, 1.0 / det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ((inv_det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin) & (t < tmax))
    return t, u, v, hit


def ray_aabb_xyz(o, inv_d, lo, hi, tmin, tmax):
    """Slab test on component triples; the box-hit mask."""
    (ox, oy, oz), (ix, iy, iz) = o, inv_d
    tx0, tx1 = (lo[0] - ox) * ix, (hi[0] - ox) * ix
    ty0, ty1 = (lo[1] - oy) * iy, (hi[1] - oy) * iy
    tz0, tz1 = (lo[2] - oz) * iz, (hi[2] - oz) * iz
    t_near = jnp.maximum(
        jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
        jnp.minimum(tz0, tz1),
    )
    t_far = jnp.minimum(
        jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
        jnp.maximum(tz0, tz1),
    )
    return (t_near <= t_far) & (t_far >= tmin) & (t_near <= tmax)


def brute_force_closest_hit(org, d, v0, e1, e2, tmin=0.0, tmax=BIG, chunk=512):
    """Reference intersector: tests every ray against every triangle.

    org/d: (R, 3).  v0/e1/e2: (T, 3).  Returns (t, prim_id, u, v) with
    prim_id = -1 on miss.  Scans triangle chunks to bound memory.
    """
    num_t = v0.shape[0]
    pad = (-num_t) % chunk
    if pad:
        padv = jnp.full((pad, 3), 1e30, v0.dtype)
        v0 = jnp.concatenate([v0, padv])
        e1 = jnp.concatenate([e1, jnp.zeros((pad, 3), e1.dtype)])
        e2 = jnp.concatenate([e2, jnp.zeros((pad, 3), e2.dtype)])
    n_chunks = v0.shape[0] // chunk
    v0c = v0.reshape(n_chunks, chunk, 3)
    e1c = e1.reshape(n_chunks, chunk, 3)
    e2c = e2.reshape(n_chunks, chunk, 3)

    num_r = org.shape[0]
    init = (
        jnp.full((num_r,), BIG),
        jnp.full((num_r,), -1, jnp.int32),
        jnp.zeros((num_r,)),
        jnp.zeros((num_r,)),
    )

    def body(carry, chunk_data):
        best_t, best_id, best_u, best_v = carry
        cv0, ce1, ce2, base = chunk_data
        t, u, v, hit = ray_triangle(
            org[:, None, :], d[:, None, :], cv0[None], ce1[None], ce2[None],
            tmin, jnp.minimum(tmax, best_t)[:, None],
        )
        k = jnp.argmin(t, axis=-1)
        tk = jnp.take_along_axis(t, k[:, None], axis=-1)[:, 0]
        closer = tk < best_t
        take = lambda a: jnp.take_along_axis(a, k[:, None], axis=-1)[:, 0]
        best_u = jnp.where(closer, take(u), best_u)
        best_v = jnp.where(closer, take(v), best_v)
        best_id = jnp.where(closer, base + k.astype(jnp.int32), best_id)
        best_t = jnp.where(closer, tk, best_t)
        return (best_t, best_id, best_u, best_v), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (t, pid, u, v), _ = jax.lax.scan(body, init, (v0c, e1c, e2c, bases))
    pid = jnp.where(pid < num_t, pid, -1)
    return t, pid, u, v
