"""Instanced geometry, flattened to world space at build time.

The reference exercises its TopLevelAdapter/InstanceNode machinery with
cornell_instances.scene (core/adapter.h:25-38, cpu_adapter.cpp:221-378);
here every instance's triangles are transformed to world space and share
one BVH, so traversal over the instanced scene must agree with the
brute-force intersector over the transformed triangles, with primitive
ids numbered instance by instance."""

import jax.numpy as jnp
import numpy as np

from imbatracer_tpu.accel.builder import build_bvh, triangle_bboxes
from imbatracer_tpu.accel.device import DeviceBvh
from imbatracer_tpu.accel.flatten import thread_bvh
from imbatracer_tpu.core import math3d
from imbatracer_tpu.render.intersect import BIG, brute_force_closest_hit
from imbatracer_tpu.render.traverse import any_hit, closest_hit


def _box_mesh(n_seg=3):
    """A subdivided unit box around the origin (~108 tris)."""
    from imbatracer_tpu.scene.procedural import _add_box

    tris = []
    for i in range(n_seg):
        _add_box(tris, center=(0, 0.18 * i, 0), size=(1.0 - 0.2 * i, 0.15, 1.0 - 0.2 * i),
                 angle_deg=15.0 * i, mat=0)
    v0 = np.asarray([t[0] for t in tris], np.float32)
    v1 = np.asarray([t[1] for t in tris], np.float32)
    v2 = np.asarray([t[2] for t in tris], np.float32)
    return v0, v1, v2


def _instances():
    specs = [
        dict(pos=(0.0, 0.0, 0.0), scale=(1.0, 1.0, 1.0), rot=(0, 0, 0)),
        dict(pos=(2.5, 0.3, -1.0), scale=(0.7, 0.7, 0.7), rot=(0, 40, 0)),
        dict(pos=(-2.0, -0.2, 1.5), scale=(1.6, 1.2, 1.6), rot=(10, 0, 25)),
        dict(pos=(0.5, 1.5, 2.0), scale=(0.5, 0.5, 0.5), rot=(0, 160, 80)),
    ]
    return [math3d.instance_matrix(s["pos"], s["scale"], s["rot"]) for s in specs]


def test_flattened_instances_match_brute_force():
    v0, v1, v2 = _box_mesh()
    mats = _instances()
    f = v0.shape[0]
    wv = [np.concatenate([math3d.transform_points(m, v).astype(np.float32)
                          for m in mats]) for v in (v0, v1, v2)]
    lo, hi = triangle_bboxes(*wv)
    bvh = DeviceBvh.from_threaded(thread_bvh(build_bvh(lo, hi), *wv))

    rs = np.random.RandomState(11)
    n = 1024
    org = jnp.asarray(rs.uniform(-4, 4, (n, 3)).astype(np.float32))
    d = jnp.asarray(rs.randn(n, 3), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    hit = closest_hit(bvh, org, d, 0.0, BIG)
    bt, bid, _, _ = brute_force_closest_hit(
        org, d, jnp.asarray(wv[0]), jnp.asarray(wv[1] - wv[0]),
        jnp.asarray(wv[2] - wv[0]))
    got, want = np.asarray(hit.prim_id), np.asarray(bid)
    np.testing.assert_array_equal(got >= 0, want >= 0)
    m = want >= 0
    np.testing.assert_allclose(np.asarray(hit.t)[m], np.asarray(bt)[m],
                               rtol=2e-4, atol=1e-5)
    # Ids may differ only on exact-overlap seams; the instance never does.
    assert (got[m] == want[m]).mean() > 0.995
    np.testing.assert_array_equal(got[m] // f, want[m] // f)

    occ = any_hit(bvh, org, d, 0.0, jnp.full((n,), 2.5))
    np.testing.assert_array_equal(np.asarray(occ),
                                  np.asarray((bid >= 0) & (bt < 2.5)))
