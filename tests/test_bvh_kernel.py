"""The Hopper traversal kernel (ops/bvh_kernel.py) in interpret mode, the
plain while-loop route, and the choice between them.

The kernel is compared with the brute-force intersector and with the
plain route; the routing tests lower `closest_hit`/`any_hit` for the
CUDA platform (lowering needs no GPU) and check which route the program
holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from imbatracer_tpu.accel.builder import build_bvh, triangle_bboxes
from imbatracer_tpu.accel.device import DeviceBvh
from imbatracer_tpu.accel.flatten import thread_bvh
from imbatracer_tpu.ops.bvh_kernel import any_hit_kernel, closest_hit_kernel
from imbatracer_tpu.render import traverse as tr
from imbatracer_tpu.render.intersect import BIG, brute_force_closest_hit


def _random_tris(n, rs, spread=10.0, size=1.5):
    c = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return (c + rs.uniform(-size, size, (n, 3)).astype(np.float32),
            c + rs.uniform(-size, size, (n, 3)).astype(np.float32),
            c + rs.uniform(-size, size, (n, 3)).astype(np.float32))


def _rays(n, rs):
    org = rs.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d)


def _bvh(v0, v1, v2, octants=True):
    lo, hi = triangle_bboxes(v0, v1, v2)
    return DeviceBvh.from_threaded(
        thread_bvh(build_bvh(lo, hi), v0, v1, v2, octants=octants))


def _kernel_closest(bvh, org, d, tmin, tmax, active=None, **kw):
    args = tr._kernel_args(bvh, org, d, tmin, tmax, active)
    return tr.Hit(*closest_hit_kernel(*args, interpret=True, **kw))


def _kernel_any(bvh, org, d, tmin, tmax, active=None, **kw):
    args = tr._kernel_args(bvh, org, d, tmin, tmax, active)
    return any_hit_kernel(*args, interpret=True, **kw)


def _brute(v0, v1, v2, org, d):
    return brute_force_closest_hit(org, d, jnp.asarray(v0),
                                   jnp.asarray(v1 - v0), jnp.asarray(v2 - v0))


@pytest.mark.parametrize("n_tris,n_rays", [(1, 1), (7, 37), (300, 130),
                                           (1200, 257)])
def test_kernel_closest_matches_brute_force(n_tris, n_rays):
    """Ray counts that are not block multiples exercise the padding."""
    rs = np.random.RandomState(n_tris + n_rays)
    v0, v1, v2 = _random_tris(n_tris, rs)
    org, d = _rays(n_rays, rs)
    hit = _kernel_closest(_bvh(v0, v1, v2), org, d, 0.0, BIG)
    bt, bid, bu, _ = _brute(v0, v1, v2, org, d)
    assert hit.t.shape == (n_rays,)
    got, want = np.asarray(hit.prim_id), np.asarray(bid)
    np.testing.assert_array_equal(got >= 0, want >= 0)
    m = want >= 0
    np.testing.assert_allclose(np.asarray(hit.t)[m], np.asarray(bt)[m],
                               rtol=1e-4, atol=1e-5)
    same = m & (got == want)
    assert same.sum() >= 0.99 * m.sum()
    np.testing.assert_allclose(np.asarray(hit.u)[same], np.asarray(bu)[same],
                               atol=1e-3)
    assert np.all(np.asarray(hit.t)[~m] == np.float32(BIG))


@pytest.mark.parametrize("octants", [True, False])
def test_kernel_matches_plain_route(octants):
    """Same walk, same table: the kernel and the while-loop route agree
    lane for lane, on the octant-ordered copy and on the plain records."""
    rs = np.random.RandomState(3)
    v0, v1, v2 = _random_tris(800, rs)
    bvh = _bvh(v0, v1, v2, octants=octants)
    assert (bvh.nodes64o is not None) == octants
    org, d = _rays(300, rs)
    act = jnp.asarray(rs.rand(300) < 0.8)
    hk = _kernel_closest(bvh, org, d, 0.0, BIG, act)
    hp = tr._walk_closest(bvh, org, d, 0.0, BIG, act)
    for a, b in zip(hk, hp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tmax = jnp.full((300,), 6.0)
    np.testing.assert_array_equal(
        np.asarray(_kernel_any(bvh, org, d, 0.0, tmax, act)),
        np.asarray(tr._walk_any(bvh, org, d, 0.0, tmax, act)))


@pytest.mark.parametrize("tmax", [2.0, 8.0, 30.0])
def test_kernel_any_hit_matches_brute_force(tmax):
    rs = np.random.RandomState(int(tmax))
    v0, v1, v2 = _random_tris(400, rs)
    org, d = _rays(200, rs)
    occ = _kernel_any(_bvh(v0, v1, v2), org, d, 0.0, jnp.full((200,), tmax))
    bt, bid, _, _ = _brute(v0, v1, v2, org, d)
    want = np.asarray((bid >= 0) & (bt < tmax))
    np.testing.assert_array_equal(np.asarray(occ), want)


def test_kernel_inactive_lanes_and_tmin():
    rs = np.random.RandomState(11)
    v0, v1, v2 = _random_tris(200, rs)
    bvh = _bvh(v0, v1, v2)
    org, d = _rays(150, rs)
    act = jnp.asarray(np.arange(150) % 3 != 0)
    hit = _kernel_closest(bvh, org, d, 0.0, BIG, act)
    dead = ~np.asarray(act)
    assert np.all(np.asarray(hit.prim_id)[dead] == -1)
    assert np.all(np.asarray(hit.t)[dead] == np.float32(BIG))
    assert not np.any(np.asarray(_kernel_any(bvh, org, d, 0.0, BIG,
                                             act))[dead])
    # Per-lane tmin past the first hit finds a farther surface or none.
    tmin = jnp.where(hit.prim_id >= 0, hit.t * 1.0001, 0.0)
    far = _kernel_closest(bvh, org, d, tmin, BIG, act)
    got = np.asarray(hit.prim_id) >= 0
    assert np.all(np.asarray(far.t)[got] > np.asarray(hit.t)[got])


def test_kernel_tmax_respected():
    v0 = np.array([[-1, -1, -5]], np.float32)
    v1 = np.array([[1, -1, -5]], np.float32)
    v2 = np.array([[0, 1, -5]], np.float32)
    bvh = _bvh(v0, v1, v2)
    org = jnp.zeros((2, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    hit = _kernel_closest(bvh, org, d, 0.0, jnp.asarray([4.0, 6.0]))
    assert int(hit.prim_id[0]) == -1 and int(hit.prim_id[1]) == 0
    np.testing.assert_allclose(float(hit.t[1]), 5.0, rtol=1e-5)
    occ = _kernel_any(bvh, org, d, 0.0, jnp.asarray([4.0, 6.0]))
    assert np.asarray(occ).tolist() == [False, True]


@pytest.mark.parametrize("block,num_warps", [(16, 1), (64, 2)])
def test_kernel_block_size_does_not_change_hits(block, num_warps):
    rs = np.random.RandomState(block)
    v0, v1, v2 = _random_tris(500, rs)
    bvh = _bvh(v0, v1, v2)
    org, d = _rays(100, rs)
    a = _kernel_closest(bvh, org, d, 0.0, BIG)
    b = _kernel_closest(bvh, org, d, 0.0, BIG, block=block,
                        num_warps=num_warps)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _walk_steps(t, org, d):
    """Nodes the threaded walk visits before it terminates (host model of
    the loop; no octant ordering, best-t culling included)."""
    inv = np.where(d >= 0, 1.0, -1.0) / np.maximum(np.abs(d), 1e-12)
    node, steps, best = 0, 0, np.inf
    while node >= 0:
        steps += 1
        t0 = (t.node_min[node] - org) * inv
        t1 = (t.node_max[node] - org) * inv
        near = np.max(np.minimum(t0, t1))
        far = np.min(np.maximum(t0, t1))
        hit = near <= far and far >= 0.0 and near <= best
        ls = t.leaf_start[node]
        if hit and ls >= 0:
            for k in range(4):
                if t.tri_id[ls + k] < 0:
                    continue
                p = np.cross(d, t.tri_e2[ls + k])
                det = t.tri_e1[ls + k] @ p
                if abs(det) < 1e-12:
                    continue
                s = org - t.tri_v0[ls + k]
                u = s @ p / det
                q = np.cross(s, t.tri_e1[ls + k])
                v = d @ q / det
                tt = t.tri_e2[ls + k] @ q / det
                if u >= 0 and v >= 0 and u + v <= 1 and 0 < tt < best:
                    best = tt
        node = t.hit_link[node] if hit else t.miss_link[node]
    return steps


def test_while_route_exact_past_old_step_cap():
    """A ray that enters the boxes of a long row of triangles it misses
    before hitting a wall: the walk needs far more steps than the old
    static bound min(nodes, max(64, 8 * depth)), which reported a miss."""
    n = 1500
    x = np.linspace(0.0, 300.0, n, dtype=np.float32)
    # Triangles across the ray's path, each covering only the half
    # y + z <= 0 of its box: the ray at y = z = 0.2 enters every box and
    # misses every triangle until the wall.
    v0 = np.stack([x, np.full(n, -0.5), np.full(n, -0.5)], 1)
    v1 = np.stack([x, np.full(n, 0.5), np.full(n, -0.5)], 1)
    v2 = np.stack([x, np.full(n, -0.5), np.full(n, 0.5)], 1)
    wall = np.array([[[310, -5, -5], [310, 5, -5], [310, 0, 5]]], np.float32)
    v0 = np.concatenate([v0, wall[:, 0]]).astype(np.float32)
    v1 = np.concatenate([v1, wall[:, 1]]).astype(np.float32)
    v2 = np.concatenate([v2, wall[:, 2]]).astype(np.float32)
    lo, hi = triangle_bboxes(v0, v1, v2)
    t = thread_bvh(build_bvh(lo, hi), v0, v1, v2, octants=False)
    org = np.array([-1.0, 0.2, 0.2], np.float32)
    d = np.array([1.0, 0.0, 0.0], np.float32)
    old_cap = min(t.stats["nodes"], max(64, 8 * t.stats["max_depth"]))
    assert _walk_steps(t, org, d) > old_cap
    bvh = DeviceBvh.from_threaded(t)
    hit = tr.closest_hit(bvh, jnp.asarray(org[None]), jnp.asarray(d[None]),
                         0.0, BIG)
    assert int(hit.prim_id[0]) == n
    np.testing.assert_allclose(float(hit.t[0]), 311.0, rtol=1e-5)
    assert bool(tr.any_hit(bvh, jnp.asarray(org[None]),
                           jnp.asarray(d[None]), 0.0, 400.0)[0])


def _lowered(fn, bvh, platform, alpha_fn=None):
    org = jnp.zeros((64, 3))
    d = jnp.ones((64, 3))
    f = jax.jit(lambda b, o, dd: fn(b, o, dd, 0.0, BIG, alpha_fn=alpha_fn))
    return f.trace(bvh, org, d).lower(lowering_platforms=(platform,)).as_text()


def _opaque(prim, u, v):
    return u >= 0.0


@pytest.mark.parametrize("fn", [tr.closest_hit, tr.any_hit])
def test_route_gpu_without_masks_is_the_kernel(fn):
    rs = np.random.RandomState(0)
    bvh = _bvh(*_random_tris(40, rs))
    txt = _lowered(fn, bvh, "cuda")
    assert "triton" in txt and "stablehlo.while" not in txt


@pytest.mark.parametrize("fn", [tr.closest_hit, tr.any_hit])
def test_route_masks_take_the_plain_walk(fn):
    rs = np.random.RandomState(0)
    bvh = _bvh(*_random_tris(40, rs))
    for platform in ("cuda", "cpu"):
        txt = _lowered(fn, bvh, platform, alpha_fn=_opaque)
        assert "triton" not in txt and "stablehlo.while" in txt


@pytest.mark.parametrize("fn", [tr.closest_hit, tr.any_hit])
def test_route_cpu_is_the_plain_walk(fn):
    rs = np.random.RandomState(0)
    bvh = _bvh(*_random_tris(40, rs))
    txt = _lowered(fn, bvh, "cpu")
    assert "triton" not in txt and "stablehlo.while" in txt


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["closest", "any"])
def test_compiled_kernel_matches_plain_route_on_gpu(gpu, fn):
    """The kernel as compiled for the card (no interpret mode)."""
    rs = np.random.RandomState(9)
    v0, v1, v2 = _random_tris(5000, rs)
    bvh = _bvh(v0, v1, v2)
    org, d = _rays(4099, rs)
    tmax = jnp.full((4099,), 6.0)
    if fn == "closest":
        got = tr._kernel_closest(bvh, org, d, 0.0, tmax, None)
        want = tr._walk_closest(bvh, org, d, 0.0, tmax, None)
        assert np.mean(np.asarray(got.prim_id == want.prim_id)) >= 0.999
    else:
        got = tr._kernel_any(bvh, org, d, 0.0, tmax, None)
        want = tr._walk_any(bvh, org, d, 0.0, tmax, None)
        assert np.mean(np.asarray(got == want)) >= 0.999
