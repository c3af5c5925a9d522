"""Light-path vertex cache (SoA, fixed capacity, on device).

Replaces the reference's lock-free atomic-append cache
(reference: render/integrators/light_vertices.h:59-127): vertices from the
light pass are scatter-appended into fixed-size SoA arrays; a cursor
tracks the fill level and overflow is dropped, mirroring the reference's
overflow behaviour (light_vertices.h:79-83).  The reference pre-measures
capacity with probe paths (light_vertices.cpp:15-129); we take capacity as
an explicit knob (default 2 x light_path_count) because static shapes are
required anyway.

Each vertex stores everything needed to re-evaluate its BSDF at connection
time (position, outgoing dir, shading/geometric normals, uv, material id)
plus throughput and the dVC/dVCM/dVM partial MIS weights.
"""

from __future__ import annotations

from functools import partial

from ..core import pytree
import jax
import jax.numpy as jnp


@pytree.dataclass
class LightVertexCache:
    pos: jnp.ndarray         # (C, 3)
    w_out: jnp.ndarray       # (C, 3) direction toward the previous vertex
    normal: jnp.ndarray      # (C, 3)
    gn: jnp.ndarray          # (C, 3)
    uv: jnp.ndarray          # (C, 2)
    mat_id: jnp.ndarray      # (C,) i32
    throughput: jnp.ndarray  # (C, 3)
    d_vc: jnp.ndarray        # (C,)
    d_vcm: jnp.ndarray       # (C,)
    d_vm: jnp.ndarray        # (C,)
    path_length: jnp.ndarray  # (C,) i32
    path_id: jnp.ndarray     # (C,) i32 global light-path index
    count: jnp.ndarray       # () i32 number of valid vertices

    @property
    def capacity(self):
        return self.pos.shape[0]

    def packed(self) -> jnp.ndarray:
        """Wide-record view (C, 24) for fast per-vertex gathers:
        [pos(0:3), w_out(3:6), normal(6:9), gn(9:12), uv(12:14),
         mat_id(14, i32 bits), throughput(15:18), dVC(18), dVCM(19),
         dVM(20), path_length(21, i32 bits), path_id(22, i32 bits),
         pad(23)].
        One gather per vertex access in connect/merge instead of ~8
        narrow ones."""
        import jax.lax

        bits = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
        cap = self.capacity
        return jnp.concatenate(
            [
                self.pos, self.w_out, self.normal, self.gn, self.uv,
                bits(self.mat_id)[:, None],
                self.throughput,
                self.d_vc[:, None], self.d_vcm[:, None], self.d_vm[:, None],
                bits(self.path_length)[:, None],
                bits(self.path_id)[:, None],
                jnp.zeros((cap, 1), jnp.float32),
            ],
            axis=1,
        )


def empty_cache(capacity: int) -> LightVertexCache:
    z = jnp.zeros((capacity,), jnp.float32)
    z3 = jnp.zeros((capacity, 3), jnp.float32)
    return LightVertexCache(
        pos=z3, w_out=z3, normal=z3, gn=z3,
        uv=jnp.zeros((capacity, 2), jnp.float32),
        mat_id=jnp.zeros((capacity,), jnp.int32),
        throughput=z3,
        d_vc=z, d_vcm=z, d_vm=z,
        path_length=jnp.zeros((capacity,), jnp.int32),
        path_id=jnp.zeros((capacity,), jnp.int32),
        count=jnp.zeros((), jnp.int32),
    )


def pack_batch(pos, w_out, normal, gn, uv, mat_id, throughput, d_vc, d_vcm,
               d_vm, path_length, path_id) -> jnp.ndarray:
    """Pack a vertex batch into the (N, 24) wide-record layout of
    LightVertexCache.packed() (ints bitcast into float lanes)."""
    import jax.lax

    bits = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
    n = pos.shape[0]
    return jnp.concatenate(
        [
            pos, w_out, normal, gn, uv,
            bits(mat_id)[:, None],
            throughput,
            d_vc[:, None], d_vcm[:, None], d_vm[:, None],
            bits(path_length)[:, None],
            bits(path_id)[:, None],
            jnp.zeros((n, 1), jnp.float32),
        ],
        axis=1,
    )


def append_packed(cache: LightVertexCache, valid,
                  rec: jnp.ndarray) -> LightVertexCache:
    """Scatter-append the `valid` rows of a packed (N, 24) record batch.

    Slots are assigned by an exclusive prefix sum over the valid mask
    (deterministic — unlike the reference's atomic order); overflow rows
    are dropped via the out-of-range scatter index.

    The light pass LOGS one record slab per bounce inside its fori_loop
    (dynamic_update_slice, aliased in place) and calls this ONCE after
    the loop: one big scatter instead of one inside every fori step.
    """
    import jax.lax

    cap = cache.capacity
    slot_in_batch = jnp.cumsum(valid.astype(jnp.int32)) - 1
    slot = cache.count + slot_in_batch
    target = jnp.where(valid & (slot < cap), slot, cap)  # cap = trash slot

    def put(dst, src):
        return dst.at[target].set(src, mode="drop")

    ibits = lambda col: jax.lax.bitcast_convert_type(rec[:, col], jnp.int32)
    new_count = jnp.minimum(
        cache.count + jnp.sum(valid.astype(jnp.int32)), cap
    )
    return LightVertexCache(
        pos=put(cache.pos, rec[:, 0:3]),
        w_out=put(cache.w_out, rec[:, 3:6]),
        normal=put(cache.normal, rec[:, 6:9]),
        gn=put(cache.gn, rec[:, 9:12]),
        uv=put(cache.uv, rec[:, 12:14]),
        mat_id=put(cache.mat_id, ibits(14)),
        throughput=put(cache.throughput, rec[:, 15:18]),
        d_vc=put(cache.d_vc, rec[:, 18]),
        d_vcm=put(cache.d_vcm, rec[:, 19]),
        d_vm=put(cache.d_vm, rec[:, 20]),
        path_length=put(cache.path_length, ibits(21)),
        path_id=put(cache.path_id, ibits(22)),
        count=new_count,
    )


def append(cache: LightVertexCache, valid, pos, w_out, normal, gn, uv, mat_id,
           throughput, d_vc, d_vcm, d_vm, path_length,
           path_id) -> LightVertexCache:
    """Scatter-append the `valid` rows of a batch into the cache
    (pack_batch + append_packed; see append_packed for semantics)."""
    return append_packed(
        cache, valid,
        pack_batch(pos, w_out, normal, gn, uv, mat_id, throughput, d_vc,
                   d_vcm, d_vm, path_length, path_id),
    )


@partial(jax.jit, static_argnames=("capacity",))
def select_shallowest(cache: LightVertexCache,
                      capacity: int) -> LightVertexCache:
    """Canonical depth-capped admission: keep the first `capacity` valid
    vertices in (path_length, path_id) order — EXACTLY the set a
    bounce-major single-band append-order truncation keeps (that order
    IS (bounce, lane)), but deterministic under ANY band/shard
    schedule.  The light pass collects every vertex into a full-size
    transport cache; this selects down to the working capacity before
    grid build / connections.  Returns a `capacity`-size cache in the
    canonical (path_id, path_length) layout (canonicalize)."""
    if capacity >= cache.capacity:
        return canonicalize(cache)
    cap_in = cache.capacity
    idx = jnp.arange(cap_in, dtype=jnp.int32)
    valid = idx < cache.count
    big = jnp.int32(2**31 - 1)
    k1 = jnp.where(valid, cache.path_length, big)
    k2 = jnp.where(valid, cache.path_id, big)
    _, _, order = jax.lax.sort((k1, k2, idx), num_keys=2)
    rec = cache.packed()[order[:capacity]]
    bits = lambda col: jax.lax.bitcast_convert_type(rec[:, col], jnp.int32)
    kept = LightVertexCache(
        pos=rec[:, 0:3], w_out=rec[:, 3:6], normal=rec[:, 6:9],
        gn=rec[:, 9:12], uv=rec[:, 12:14], mat_id=bits(14),
        throughput=rec[:, 15:18], d_vc=rec[:, 18], d_vcm=rec[:, 19],
        d_vm=rec[:, 20], path_length=bits(21), path_id=bits(22),
        count=jnp.minimum(cache.count, capacity),
    )
    return canonicalize(kept)


@jax.jit
def canonicalize(cache: LightVertexCache) -> LightVertexCache:
    """Sort valid vertices into (path_id, path_length) order.

    Band/bounce append order is an implementation detail: the single-chip
    renderer appends bounce-major within a band, the sharded renderer
    (parallel/shard.py) shard-major.  Sorting to the canonical key makes
    the cache layout — and everything derived from it (hash grid,
    connection vertex sampling) — identical across those schedules, so
    multi-chip frames bit-match single-chip ones.  One 24-wide-record
    gather + slicing; the sort itself is sub-ms at 1M entries."""
    cap = cache.capacity
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < cache.count
    # Two-key sort (path_id major, path_length minor): a fused
    # `path_id * K + length` key would collide once length can reach K
    # and overflow int32 near 2^31 / K paths — both silent breaks of the
    # multi-chip bit-match contract.  Invalid rows sort last via the
    # max path_id key.
    key_major = jnp.where(valid, cache.path_id, jnp.int32(2**31 - 1))
    key_minor = jnp.where(valid, cache.path_length, jnp.int32(2**31 - 1))
    _, _, order = jax.lax.sort((key_major, key_minor, idx), num_keys=2)
    rec = cache.packed()[order]
    bits = lambda col: jax.lax.bitcast_convert_type(rec[:, col], jnp.int32)
    return LightVertexCache(
        pos=rec[:, 0:3], w_out=rec[:, 3:6], normal=rec[:, 6:9],
        gn=rec[:, 9:12], uv=rec[:, 12:14], mat_id=bits(14),
        throughput=rec[:, 15:18], d_vc=rec[:, 18], d_vcm=rec[:, 19],
        d_vm=rec[:, 20], path_length=bits(21), path_id=bits(22),
        count=cache.count,
    )
