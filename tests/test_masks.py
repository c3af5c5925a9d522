"""Alpha-masked traversal: the plain while-loop route runs the traced
alpha lookup inline, so masked hits are exact at any stack depth, and
renders must show shadows only under the opaque half of a masked
occluder.

Reference semantics: core/mask.h (binarised mask lookup) + the masked
kernel variants in render/scheduling/ray_queue.h:254-341."""

import jax
import jax.numpy as jnp
import numpy as np

from imbatracer_tpu.accel.builder import build_bvh, triangle_bboxes
from imbatracer_tpu.accel.device import DeviceBvh
from imbatracer_tpu.accel.flatten import thread_bvh
from imbatracer_tpu.render.intersect import BIG
from imbatracer_tpu.render.traverse import any_hit, closest_hit
from imbatracer_tpu.scene.procedural import make_masked_scene


def _occluder_fixture():
    """Floor + elevated masked quad; alpha_fn transparent where u < 0.5."""
    quad = [
        # floor at y=0 (opaque)
        ((-2, 0, 2), (2, 0, 2), (2, 0, -2)),
        ((-2, 0, 2), (2, 0, -2), (-2, 0, -2)),
        # occluder at y=1 spanning x:[-1,1], z:[-1,1] (masked)
        ((-1, 1, 1), (1, 1, 1), (1, 1, -1)),
        ((-1, 1, 1), (1, 1, -1), (-1, 1, -1)),
    ]
    v0 = np.asarray([t[0] for t in quad], np.float32)
    v1 = np.asarray([t[1] for t in quad], np.float32)
    v2 = np.asarray([t[2] for t in quad], np.float32)
    lo, hi = triangle_bboxes(v0, v1, v2)
    t = thread_bvh(build_bvh(lo, hi), v0, v1, v2, octants=True)

    tv0, tv1, tv2 = jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2)

    def alpha_fn(prim, u, v):
        # world x of the hit point on the tri; occluder prims are 2 and 3.
        p0 = tv0[prim]
        e1 = tv1[prim] - tv0[prim]
        e2 = tv2[prim] - tv0[prim]
        x = p0[:, 0] + u * e1[:, 0] + v * e2[:, 0]
        on_occ = prim >= 2
        return jnp.where(on_occ, x >= 0.0, True)

    return t, alpha_fn


def test_masked_occluder_semantics():
    t, alpha_fn = _occluder_fixture()
    bvh = DeviceBvh.from_threaded(t)

    # Downward rays from y=2 on a grid over the occluder: transparent half
    # must see the floor (t=2), opaque half the occluder (t=1).
    n = 64
    x = np.linspace(-0.9, 0.9, n, dtype=np.float32)
    org = jnp.asarray(np.stack([x, np.full(n, 2.0, np.float32),
                                np.zeros(n, np.float32)], axis=1))
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0], jnp.float32), (n, 3))

    hit = closest_hit(bvh, org, d, 0.0, BIG, alpha_fn=alpha_fn)
    want_t = np.where(x < 0.0, 2.0, 1.0)
    np.testing.assert_allclose(np.asarray(hit.t), want_t, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(hit.prim_id) >= 2, x >= 0.0)

    # Occlusion to a point above the floor (t_max stops before the floor):
    # only the opaque half occludes.
    occ = any_hit(bvh, org, d, 0.0, jnp.full((n,), 1.5), alpha_fn=alpha_fn)
    np.testing.assert_array_equal(np.asarray(occ), x >= 0.0)


def test_masked_deep_stack_exact():
    """SIX stacked masked surfaces along one ray must all be seen
    through where transparent: the see-through rays reach the floor
    behind all six layers."""
    layers = 6
    tris = [
        # floor at y=0 (opaque)
        ((-4, 0, 4), (4, 0, 4), (4, 0, -4)),
        ((-4, 0, 4), (4, 0, -4), (-4, 0, -4)),
    ]
    for k in range(layers):
        y = 1.0 + k  # quads at y = 1..6
        tris += [
            ((-2, y, 2), (2, y, 2), (2, y, -2)),
            ((-2, y, 2), (2, y, -2), (-2, y, -2)),
        ]
    v0 = np.asarray([t[0] for t in tris], np.float32)
    v1 = np.asarray([t[1] for t in tris], np.float32)
    v2 = np.asarray([t[2] for t in tris], np.float32)
    lo, hi = triangle_bboxes(v0, v1, v2)
    t = thread_bvh(build_bvh(lo, hi), v0, v1, v2, octants=True)
    tv0, tv1, tv2 = jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2)

    def alpha_fn(prim, u, v):
        # Layer quads (prim >= 2) are transparent where world x < 0.
        p0 = tv0[prim]
        e1 = tv1[prim] - tv0[prim]
        e2 = tv2[prim] - tv0[prim]
        x = p0[:, 0] + u * e1[:, 0] + v * e2[:, 0]
        return jnp.where(prim >= 2, x >= 0.0, True)

    n = 32
    x = np.linspace(-1.5, 1.5, n, dtype=np.float32)
    org = jnp.asarray(np.stack([x, np.full(n, 8.0, np.float32),
                                np.zeros(n, np.float32)], axis=1))
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0], jnp.float32), (n, 3))

    bvh = DeviceBvh.from_threaded(t)
    hit = closest_hit(bvh, org, d, 0.0, BIG, alpha_fn=alpha_fn)
    # Semantics: x<0 sees through ALL six layers to the floor (t=8);
    # x>=0 stops at the topmost layer (y=6 -> t=2).
    want_t = np.where(x < 0.0, 8.0, 2.0)
    np.testing.assert_allclose(np.asarray(hit.t), want_t, rtol=1e-4)

    # Occlusion through the stack: only the opaque half blocks.
    occ = any_hit(bvh, org, d, 0.0, jnp.full((n,), 7.5), alpha_fn=alpha_fn)
    np.testing.assert_array_equal(np.asarray(occ), x >= 0.0)

    # Without the mask every ray stops at the top layer.
    hit0 = closest_hit(bvh, org, d, 0.0, BIG)
    np.testing.assert_allclose(np.asarray(hit0.t), 2.0, rtol=1e-4)


def test_masked_scene_render_shadows():
    """End-to-end: PT render of the masked cornell variant; the floor
    under the transparent half must be brighter than under the opaque
    half (direct light passes through where the mask is black)."""
    from imbatracer_tpu.frontend.engine import make_frame_fn
    from imbatracer_tpu.frontend.renderer import RenderSettings

    scene, meta = make_masked_scene()
    assert meta.has_masks
    res = 32
    settings = RenderSettings(width=res, height=res, spp=16, algorithm="pt",
                              max_path_len=3)
    frame_fn, cam = make_frame_fn(scene, meta, settings)
    acc = np.zeros((res * res, 3), np.float32)
    for f in range(2):
        acc += np.asarray(frame_fn(jnp.uint32(f)))
    img = acc.reshape(res, res, 3).mean(axis=-1)

    # Bottom rows of the image look at the floor; x<0 maps to the left
    # image half.  Compare mean floor brightness left vs right.
    floor = img[int(res * 0.7):, :]
    left = floor[:, : res // 3].mean()
    right = floor[:, -res // 3:].mean()
    assert left > 1.6 * right, f"left {left:.4f} vs right {right:.4f}"


def test_leaf_canopy_mask_semantics():
    """Big masked workload (procedural leaf canopy, VERDICT r2 item 8):
    golden-free self-checks on the ~12k-masked-tri scene.

    1. any_hit with masks occludes strictly fewer rays than opaque
       (transparent disc exteriors must pass light);
    2. every masked closest hit lands on an opaque texel (a hit reported
       on a transparent region would be a mask bug);
    3. the occlusion ratio is sane: a single card blocks pi/4 of its
       area, so masked/opaque occlusion must sit well inside (pi/4, 1)."""
    import numpy as np
    from imbatracer_tpu.render.integrators.pt import alpha_fn_for
    from imbatracer_tpu.scene.procedural import make_leaf_scene
    from imbatracer_tpu.scene.textures import sample_mask

    scene, meta = make_leaf_scene(num_leaves=400)
    assert meta.num_tris > 800 and meta.has_masks
    alpha_fn = alpha_fn_for(scene)

    rs = np.random.RandomState(11)
    n = 4096
    org = np.stack([rs.uniform(-18, 18, n), np.full(n, 15.0),
                    rs.uniform(-18, 18, n)], -1).astype(np.float32)
    d = np.tile([0.0, -1.0, 0.0], (n, 1)).astype(np.float32)
    org, d = jnp.asarray(org), jnp.asarray(d)

    # Occlusion against the canopy slab only (above the ground).
    occ_opaque = np.asarray(any_hit(scene.bvh, org, d, 0.0,
                                    jnp.full((n,), 14.0)))
    occ_masked = np.asarray(any_hit(scene.bvh, org, d, 0.0,
                                    jnp.full((n,), 14.0),
                                    alpha_fn=alpha_fn))
    assert occ_masked.sum() < occ_opaque.sum()
    assert not np.any(occ_masked & ~occ_opaque)
    ratio = occ_masked.sum() / max(occ_opaque.sum(), 1)
    assert 0.5 < ratio < 0.98, ratio  # pi/4 per layer, multi-layer canopy

    # Masked closest hits must land on opaque texels.
    hit = closest_hit(scene.bvh, org, d, 0.0, BIG, alpha_fn=alpha_fn)
    got = np.asarray(hit.prim_id) >= 0
    ok = np.asarray(alpha_fn(jnp.maximum(hit.prim_id, 0), hit.u, hit.v))
    assert np.all(ok[got])


def test_mask_rec_alpha_bitwise():
    """The narrow pre-joined mask record (TriAttrs.mask_rec, two gathers
    per alpha test) must reproduce the chained shade-record -> material
    -> atlas lookup BIT-exactly on every primitive and barycentric."""
    import os

    from imbatracer_tpu.render.integrators.pt import alpha_fn_for
    from imbatracer_tpu.scene.procedural import make_leaf_scene

    scene, meta = make_leaf_scene(num_leaves=200)
    assert scene.attrs.mask_rec is not None

    fast = alpha_fn_for(scene)
    os.environ["IMBA_MASK_REC"] = "0"
    try:
        slow = alpha_fn_for(scene)
    finally:
        del os.environ["IMBA_MASK_REC"]

    rs = np.random.RandomState(7)
    n = 8192
    prim = jnp.asarray(rs.randint(0, meta.num_tris, n), jnp.int32)
    u = jnp.asarray(rs.uniform(-0.2, 1.2, n), jnp.float32)  # incl. off-tri
    v = jnp.asarray(rs.uniform(-0.2, 1.2, n), jnp.float32)
    a = np.asarray(jax.jit(fast)(prim, u, v))
    b = np.asarray(jax.jit(slow)(prim, u, v))
    assert np.array_equal(a, b)
