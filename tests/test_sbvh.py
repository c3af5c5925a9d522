"""Spatial-split BVH builder (accel/sbvh.py) vs the binned object-split
builder — correctness through the threaded traversal and SAH quality on
the scene class SBVH exists for (long thin diagonal triangles).
Reference: core/sbvh_builder.h (SplitBvhBuilder)."""

import jax.numpy as jnp
import numpy as np

from imbatracer_tpu.accel.builder import build_bvh, triangle_bboxes
from imbatracer_tpu.accel.device import DeviceBvh
from imbatracer_tpu.accel.flatten import thread_bvh
from imbatracer_tpu.accel.sbvh import build_sbvh, sah_cost
from imbatracer_tpu.render.intersect import BIG
from imbatracer_tpu.render.traverse import closest_hit


def _thin_tri_scene(n=1500, seed=0):
    rs = np.random.RandomState(seed)
    base = rs.rand(n, 3).astype(np.float32) * 10
    d1 = (np.tile(np.array([[3.0, 3.0, 3.0]], np.float32), (n, 1))
          + rs.randn(n, 3).astype(np.float32) * 0.05)
    d2 = rs.randn(n, 3).astype(np.float32) * 0.05
    return np.stack([base, base + d1, base + d2], axis=1)


def test_sbvh_quality_and_coverage():
    verts = _thin_tri_scene()
    lo, hi = triangle_bboxes(verts[:, 0], verts[:, 1], verts[:, 2])
    obj = build_bvh(lo, hi)
    sp = build_sbvh(lo, hi, verts, ref_budget=3.0)

    # Every primitive still referenced at least once (duplication allowed).
    seen = np.zeros(verts.shape[0], np.int32)
    for i in range(sp.right.shape[0]):
        if sp.right[i] == -1:
            ids = sp.prim_ids[sp.start[i]: sp.start[i] + sp.count[i]]
            seen[ids] += 1
    assert (seen >= 1).all()
    assert sp.prim_ids.shape[0] <= 3 * verts.shape[0] + 16

    # SAH quality: spatial splits must beat object splits on this scene
    # class by a clear margin (measured ~20%).
    assert sah_cost(sp) < 0.92 * sah_cost(obj), (
        sah_cost(sp), sah_cost(obj))


def test_sbvh_traversal_matches_object_bvh():
    verts = _thin_tri_scene(n=600, seed=3)
    v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
    lo, hi = triangle_bboxes(v0, v1, v2)
    obj = DeviceBvh.from_threaded(thread_bvh(build_bvh(lo, hi), v0, v1, v2))
    spn = build_sbvh(lo, hi, verts, ref_budget=3.0)
    sp = DeviceBvh.from_threaded(thread_bvh(spn, v0, v1, v2))

    rs = np.random.RandomState(11)
    n = 2048
    org = jnp.asarray(rs.rand(n, 3).astype(np.float32) * 14 - 2)
    d = jnp.asarray(rs.randn(n, 3).astype(np.float32))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    ha = closest_hit(obj, org, d, 0.0, BIG)
    hb = closest_hit(sp, org, d, 0.0, BIG)
    np.testing.assert_array_equal(np.asarray(ha.prim_id),
                                  np.asarray(hb.prim_id))
    m = np.asarray(ha.prim_id >= 0)
    np.testing.assert_allclose(np.asarray(ha.t)[m], np.asarray(hb.t)[m],
                               rtol=1e-4)


def test_native_sbvh_matches_quality():
    """C++ spatial-split builder (accel/cpp/bvh_builder.cpp::imba_build_sbvh)
    — same quality class as the NumPy SBVH, and traversal-correct."""
    import pytest

    from imbatracer_tpu.accel.native import build_sbvh_native

    verts = _thin_tri_scene()
    v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
    lo, hi = triangle_bboxes(v0, v1, v2)
    spn = build_sbvh_native(verts, ref_budget=3.0)
    if spn is None:
        pytest.skip("native builder unavailable (no toolchain)")

    obj = build_bvh(lo, hi)
    assert sah_cost(spn) < 0.92 * sah_cost(obj)

    seen = np.zeros(verts.shape[0], np.int32)
    for i in range(spn.right.shape[0]):
        if spn.right[i] == -1:
            ids = spn.prim_ids[spn.start[i]: spn.start[i] + spn.count[i]]
            seen[ids] += 1
    assert (seen >= 1).all()

    dev = DeviceBvh.from_threaded(thread_bvh(spn, v0, v1, v2))
    ref = DeviceBvh.from_threaded(thread_bvh(obj, v0, v1, v2))
    rs = np.random.RandomState(2)
    n = 1024
    org = jnp.asarray(rs.rand(n, 3).astype(np.float32) * 14 - 2)
    d = jnp.asarray(rs.randn(n, 3).astype(np.float32))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    ha = closest_hit(ref, org, d, 0.0, BIG)
    hb = closest_hit(dev, org, d, 0.0, BIG)
    np.testing.assert_array_equal(np.asarray(ha.prim_id),
                                  np.asarray(hb.prim_id))
