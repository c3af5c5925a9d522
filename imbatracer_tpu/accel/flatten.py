"""Threaded (stackless) BVH flattening for the traversal walk.

The reference emits 4-wide MBVH nodes for CPU SIMD and binary nodes for
GPU, both traversed with an explicit per-ray stack (reference:
core/cpu_adapter.cpp:78-101, core/gpu_adapter.cpp:84-101).  A per-lane
stack is hostile to a lane-synchronous vector machine, so we instead
*thread* the depth-first tree with hit/miss skip links:

    next = bbox_hit ? hit_link[node] : miss_link[node]

which turns traversal into a branch-free per-lane state machine — one
gather of node data + one select per step, no stack, no divergence beyond
the per-lane node index.  Leaves are fixed 4-triangle packets (padded with
degenerate triangles) so leaf intersection is a static-shape 4-wide
Moller-Trumbore, echoing the reference's 4-tri SIMD packets
(reference: core/cpu_adapter.cpp:130-141) but in a fully vectorised form.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .builder import BvhNodes

LEAF_WIDTH = 4
SENTINEL = np.int32(-1)


@dataclass
class ThreadedBvh:
    """Flat traversal arrays (NumPy; converted to jnp at scene upload).

    `hit_link[i]`  : node to visit when node i's bbox is hit
                     (inner: left child; leaf: == miss_link, after the
                     leaf packet is tested).
    `miss_link[i]` : node to visit when the bbox test fails; -1 terminates.
    `leaf_start[i]`: first entry of the leaf's packet in the packed
                     triangle arrays (multiple of LEAF_WIDTH); -1 for inner
                     nodes.
    Packed triangles are in Moller-Trumbore form (v0, e1, e2) with the
    original primitive id; padded slots have id -1 and never intersect.

    `nodes16` / `leaf48` are *wide-record* views of the same data, one
    row per node and per leaf packet; `nodes64` fuses them so a traversal
    step reads one record.
      nodes16[i] = [min.xyz, max.xyz, hit(i32 bits), miss(i32 bits),
                    leaf_id(i32 bits), pad...] (N, 16)
      leaf48[l]  = 4 x [v0.xyz, e1.xyz, e2.xyz, tri_id(i32 bits),
                    pad, pad]                   (L, 48)
    """

    nodes64: np.ndarray       # (N, 64) f32 fused node+leaf record
    nodes64o: np.ndarray | None  # (8N, 64) octant-ordered records (or None)
    nodes16: np.ndarray       # (N, 16) f32 wide record (see above)
    leaf48: np.ndarray        # (L, 48) f32 wide record
    node_min: np.ndarray      # (N, 3) f32
    node_max: np.ndarray      # (N, 3) f32
    hit_link: np.ndarray      # (N,) i32
    miss_link: np.ndarray     # (N,) i32
    leaf_start: np.ndarray    # (N,) i32
    tri_v0: np.ndarray        # (P, 3) f32
    tri_e1: np.ndarray        # (P, 3) f32
    tri_e2: np.ndarray        # (P, 3) f32
    tri_id: np.ndarray        # (P,) i32, -1 = padding
    stats: dict = field(default_factory=dict)


def pack_records(node_min, node_max, hit_link, miss_link, leaf_start,
                 tri_v0, tri_e1, tri_e2, tri_id):
    """Build the wide-record node/leaf arrays (see ThreadedBvh docstring)."""
    n = node_min.shape[0]
    nodes16 = np.zeros((n, 16), np.float32)
    nodes16[:, 0:3] = node_min
    nodes16[:, 3:6] = node_max
    nodes16[:, 6] = hit_link.astype(np.int32).view(np.float32)
    nodes16[:, 7] = miss_link.astype(np.int32).view(np.float32)
    leaf_id = np.where(leaf_start >= 0, leaf_start // LEAF_WIDTH, -1).astype(np.int32)
    nodes16[:, 8] = leaf_id.view(np.float32)

    num_leaves = tri_v0.shape[0] // LEAF_WIDTH
    leaf48 = np.zeros((max(num_leaves, 1), LEAF_WIDTH * 12), np.float32)
    for j in range(LEAF_WIDTH):
        base = j * 12
        leaf48[:num_leaves, base + 0 : base + 3] = tri_v0[j::LEAF_WIDTH]
        leaf48[:num_leaves, base + 3 : base + 6] = tri_e1[j::LEAF_WIDTH]
        leaf48[:num_leaves, base + 6 : base + 9] = tri_e2[j::LEAF_WIDTH]
        leaf48[:num_leaves, base + 9] = tri_id[j::LEAF_WIDTH].astype(np.int32).view(np.float32)
    return nodes16, leaf48


def pack_nodes64(nodes16, leaf48):
    """Fuse node + leaf records: one (N, 64) row per node with the leaf's
    4-triangle packet embedded (zeros for inner nodes).  Cuts the traversal
    walk to one record read per step.
    Layout: [min(0:3), max(3:6), hit(6), miss(7), leaf_id(8), pad,
             tris(12:60) = 4 x (v0, e1, e2, id, pad2), pad(60:64)]."""
    n = nodes16.shape[0]
    nodes64 = np.zeros((n, 64), np.float32)
    nodes64[:, 0:16] = nodes16
    leaf_id = nodes16[:, 8].view(np.int32)
    is_leaf = leaf_id >= 0
    nodes64[is_leaf, 12:60] = leaf48[leaf_id[is_leaf]]
    return nodes64


def thread_bvh(nodes: BvhNodes, v0: np.ndarray, v1: np.ndarray,
               v2: np.ndarray, octants: bool = True) -> ThreadedBvh:
    """Thread a DFS-ordered binary BVH and pack leaf triangle packets.

    v0/v1/v2: (T, 3) world-space triangle vertices indexed by
    `nodes.prim_ids` entries.  `octants` controls the 8x octant-ordered
    record replication (thread_bvh_octants) that both traversal routes
    walk when it exists; trees over OCTANT_MAX_NODES skip it.
    """
    n = nodes.right.shape[0]
    hit_link = np.empty(n, np.int32)
    miss_link = np.empty(n, np.int32)
    leaf_start = np.full(n, SENTINEL, np.int32)

    is_leaf = nodes.right == -1
    num_leaves = int(is_leaf.sum())
    packets = np.full((num_leaves * LEAF_WIDTH,), -1, np.int64)

    # DFS walk carrying the miss target; left child = i + 1 by construction.
    leaf_cursor = 0
    stack = [(0, -1)]
    while stack:
        i, miss = stack.pop()
        miss_link[i] = miss
        if is_leaf[i]:
            hit_link[i] = miss
            cnt = int(nodes.count[i])
            assert 0 < cnt <= LEAF_WIDTH, f"leaf {i} has {cnt} prims"
            base = leaf_cursor * LEAF_WIDTH
            ids = nodes.prim_ids[nodes.start[i] : nodes.start[i] + cnt]
            packets[base : base + cnt] = ids
            leaf_start[i] = base
            leaf_cursor += 1
        else:
            right = int(nodes.right[i])
            hit_link[i] = i + 1
            stack.append((right, miss))
            stack.append((i + 1, right))

    # Gather packed triangle data; padding slots get a degenerate triangle
    # far away so the intersection test trivially rejects them.
    pad = packets < 0
    safe = np.where(pad, 0, packets)
    pv0 = v0[safe].astype(np.float32)
    pv1 = v1[safe].astype(np.float32)
    pv2 = v2[safe].astype(np.float32)
    pv0[pad] = 1e30
    pv1[pad] = 1e30
    pv2[pad] = 1e30

    depth = _max_depth(nodes)
    nodes16, leaf48 = pack_records(
        nodes.bbox_min, nodes.bbox_max, hit_link, miss_link, leaf_start,
        pv0, pv1 - pv0, pv2 - pv0, packets.astype(np.int32),
    )
    nodes64 = pack_nodes64(nodes16, leaf48)
    nodes64o = (
        thread_bvh_octants(nodes, nodes64)
        if (octants and n <= OCTANT_MAX_NODES) else None
    )
    return ThreadedBvh(
        nodes64=nodes64,
        nodes64o=nodes64o,
        nodes16=nodes16,
        leaf48=leaf48,
        node_min=nodes.bbox_min,
        node_max=nodes.bbox_max,
        hit_link=hit_link,
        miss_link=miss_link,
        leaf_start=leaf_start,
        tri_v0=pv0,
        tri_e1=pv1 - pv0,
        tri_e2=pv2 - pv0,
        tri_id=packets.astype(np.int32),
        stats={"nodes": n, "leaves": num_leaves, "max_depth": depth},
    )


OCTANT_MAX_NODES = 400_000


def thread_bvh_octants(nodes: BvhNodes, nodes64: np.ndarray) -> np.ndarray:
    """Ordered traversal: 8 threadings of the same tree, one per ray
    direction octant, with the near child visited first.

    The stackless skip-link scheme fixes the visit order at build time, so
    a single threading must use an arbitrary child order; replicating the
    (N, 64) records 8x with per-octant links restores front-to-back
    traversal (earlier best_t shrink -> fewer visits).  Links in block o
    are pre-offset by o*N so the traversal loop is unchanged; rays pick
    their block once from the direction signs.  The price is memory
    (256 B/node/octant).  On an H100 80GB HBM3 at a 400 W limit the
    kernel's closest hit on 2^18 camera rays over the 48k-triangle big
    scene took 0.666 ms with these records and 1.143 ms without.

    Returns (8*N, 64) float32.
    """
    n = nodes.right.shape[0]
    is_leaf = nodes.right == -1
    # Dominant separation axis + which child is "lower" along it.
    lc = np.arange(n) + 1
    rc = nodes.right.astype(np.int64)
    center = 0.5 * (nodes.bbox_min + nodes.bbox_max)
    sep_axis = np.zeros(n, np.int8)
    left_is_lower = np.ones(n, bool)
    inner = ~is_leaf
    diff = np.zeros((n, 3), np.float32)
    diff[inner] = center[lc[inner]] - center[rc[inner]]
    sep_axis[inner] = np.argmax(np.abs(diff[inner]), axis=1).astype(np.int8)
    left_is_lower[inner] = (
        diff[inner][np.arange(inner.sum()), sep_axis[inner]] <= 0.0
    )

    out = np.empty((8 * n, 64), np.float32)
    base_rec = nodes64.copy()
    for o in range(8):
        # Octant bit b set => direction component b is negative.
        neg = np.array([(o >> 2) & 1, (o >> 1) & 1, o & 1], bool)
        hit = np.empty(n, np.int32)
        miss = np.empty(n, np.int32)
        stack = [(0, -1)]
        while stack:
            i, m = stack.pop()
            miss[i] = m
            if is_leaf[i]:
                hit[i] = m
            else:
                l, r = int(lc[i]), int(rc[i])
                # near child: lower child first when dir >= 0 on the axis.
                near_is_left = left_is_lower[i] ^ neg[sep_axis[i]]
                near, far = (l, r) if near_is_left else (r, l)
                hit[i] = near
                stack.append((far, m))
                stack.append((near, far))
        blk = base_rec.copy()
        off = o * n
        blk[:, 6] = (np.where(hit >= 0, hit + off, -1)).astype(np.int32).view(np.float32)
        blk[:, 7] = (np.where(miss >= 0, miss + off, -1)).astype(np.int32).view(np.float32)
        out[off : off + n] = blk
    return out


def _max_depth(nodes: BvhNodes) -> int:
    depth = 0
    stack = [(0, 1)]
    while stack:
        i, d = stack.pop()
        depth = max(depth, d)
        if nodes.right[i] != -1:
            stack.append((i + 1, d + 1))
            stack.append((int(nodes.right[i]), d + 1))
    return depth
