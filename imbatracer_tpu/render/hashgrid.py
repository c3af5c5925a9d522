"""Fixed-radius photon hash grid, built with sort + searchsorted (device-side).

The reference builds a 3D hash grid with an atomic counting sort and
answers queries with per-photon insertion sort
(reference: rangesearch/rangesearch.h:24-129).  Here the build is fully
data-parallel: photons are sorted by hashed cell id, per-cell ranges
come from one `searchsorted`, and a query examines the same 8 neighbour
cells (2x2x2 block chosen by the fractional cell coordinate,
rangesearch.h:90-97) through fixed-size windows.  Photons are stored as
wide records [x y z idx_bits payload...], so each candidate window is one
row gather.

Hash collisions only add candidates that the radius filter rejects, as in
the reference (same 73856093/19349663/83492791 hash, rangesearch.h:137-140).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import pytree


@pytree.dataclass
class HashGrid:
    sorted_rec: jnp.ndarray   # (P, 8) [x y z idx_bits 0 0 0 0] in cell order
    cell_start: jnp.ndarray   # (C + 1,) range boundaries per cell id
    bbox_min: jnp.ndarray     # (3,)
    inv_cell: jnp.ndarray     # ()
    radius_sqr: jnp.ndarray   # ()


def _cell_hash(cx, cy, cz, table_size: int):
    h = (
        (cx.astype(jnp.uint32) * jnp.uint32(73856093))
        ^ (cy.astype(jnp.uint32) * jnp.uint32(19349663))
        ^ (cz.astype(jnp.uint32) * jnp.uint32(83492791))
    )
    return (h % jnp.uint32(table_size)).astype(jnp.int32)


@partial(jax.jit, static_argnames=("table_size",))
def build_hash_grid(pos, valid, radius, table_size: int,
                    payload=None) -> HashGrid:
    """pos: (P, 3); valid: (P,) bool; radius: scalar.  Invalid photons are
    routed to the out-of-range cell `table_size` and never matched.

    `payload` (P, D<=12, optional): per-photon data carried INSIDE the
    sorted record so a range query needs exactly one windowed row gather
    (record = [x y z idx_bits payload..., pad to 8/16] — the fused-record
    rule: every extra indirection is another near-serial gather)."""
    big = jnp.float32(1e30)
    bbox_min = jnp.min(jnp.where(valid[:, None], pos, big), axis=0)
    bbox_max = jnp.max(jnp.where(valid[:, None], pos, -big), axis=0)
    any_valid = jnp.any(valid)
    bbox_min = jnp.where(any_valid, bbox_min, 0.0)
    bbox_max = jnp.where(any_valid, bbox_max, 1.0)
    ext = bbox_max - bbox_min
    bbox_min = bbox_min - ext * 1e-3 - 1e-6
    inv_cell = 1.0 / jnp.maximum(2.0 * radius, 1e-12)

    c = jnp.floor((pos - bbox_min) * inv_cell).astype(jnp.int32)
    h = _cell_hash(c[:, 0], c[:, 1], c[:, 2], table_size)
    h = jnp.where(valid, h, table_size)

    order = jnp.argsort(h)
    h_sorted = h[order]
    cell_start = jnp.searchsorted(
        h_sorted, jnp.arange(table_size + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)

    pos_sorted = jnp.where(valid[order][:, None], pos[order], big)
    cols = [
        pos_sorted,
        jax.lax.bitcast_convert_type(order.astype(jnp.int32), jnp.float32)[:, None],
    ]
    width = 8
    if payload is not None:
        cols.append(payload[order])
        width = 16 if 4 + payload.shape[1] > 8 else 8
    used = sum(col.shape[1] for col in cols)
    if used < width:
        cols.append(jnp.zeros((pos.shape[0], width - used), jnp.float32))
    rec = jnp.concatenate(cols, axis=1)
    return HashGrid(
        sorted_rec=rec,
        cell_start=cell_start,
        bbox_min=bbox_min,
        inv_cell=inv_cell,
        radius_sqr=radius * radius,
    )


def cell_windows(grid: HashGrid, qpos, max_per_cell: int):
    """Yield the 8 neighbour-cell candidate windows around each query.

    Per cell: (rec (R, W, C) gathered records, d2 (R, W), ok (R, W)
    in-range-and-in-radius mask, scale (R,) truncation compensation).
    One wide row gather per cell, no sorting — the fixed-radius
    formulation (the reference's range search, rangesearch.h:90-129; the
    kNN variant query_knn adds per-row top-k sorts).

    `scale` = cell_count / min(cell_count, W): the reference walks every
    photon in the cell; the window keeps the first W, so scaling the
    windowed sum by N/W keeps the estimator's expectation (the kept
    photons are an arbitrary-but-position-independent subset).

    Known approximations of the windowed form (both are exact in the
    reference's unbounded walk; tests/test_merge_exact.py compares the
    two):
    - `cell_count` is the HASH-BUCKET population, which can include
      photons from hash-collided unrelated cells; in a collided bucket
      the in-radius photons inside the first-W window get scaled by an
      inflated N/W.  Mitigate by sizing table_size for a low load
      factor (the default is 2x capacity -> collisions are rare).
    - the kept subset is the deterministic bucket prefix, not a random
      sample; the expectation argument assumes photon contributions are
      exchangeable within a cell, which weight-varying photons only
      approximately are."""
    cellf = (qpos - grid.bbox_min) * grid.inv_cell
    coord = jnp.floor(cellf)
    fract = cellf - coord
    base = coord.astype(jnp.int32)
    off = jnp.where(fract < 0.5, -1, 1)
    table_size = grid.cell_start.shape[0] - 1
    ar = jnp.arange(max_per_cell, dtype=jnp.int32)

    for j in range(8):
        cx = base[:, 0] + (off[:, 0] if j & 4 else 0)
        cy = base[:, 1] + (off[:, 1] if j & 2 else 0)
        cz = base[:, 2] + (off[:, 2] if j & 1 else 0)
        h = _cell_hash(cx, cy, cz, table_size)
        start = grid.cell_start[h]
        end = grid.cell_start[h + 1]
        idx2d = start[:, None] + ar[None, :]
        in_range = idx2d < end[:, None]
        # Flat 1-D row-index gather (XLA canonicalises it and the
        # 2-D-batched form alike).
        flat = jnp.where(in_range, idx2d, 0).reshape(-1)
        rec = grid.sorted_rec[flat].reshape(
            idx2d.shape[0], idx2d.shape[1], grid.sorted_rec.shape[1]
        )                                                      # (R, W, C)
        d2 = jnp.sum((rec[..., 0:3] - qpos[:, None, :]) ** 2, axis=-1)
        ok = in_range & (d2 <= grid.radius_sqr)
        n_cell = (end - start).astype(jnp.float32)
        scale = n_cell / jnp.maximum(
            jnp.minimum(n_cell, float(max_per_cell)), 1.0
        )
        yield rec, d2, ok, scale


@partial(jax.jit, static_argnames=("k", "max_per_cell", "table_size"))
def query_knn(grid: HashGrid, qpos, k: int, max_per_cell: int, table_size: int):
    """k nearest photons within the grid radius around each query point.

    qpos: (R, 3).  Returns (idx (R, k) into the original photon arrays or
    -1, dist_sqr (R, k), count (R,)).  Each of the 8 neighbour cells
    contributes at most `max_per_cell` candidates (the cap substitutes for
    the reference's unbounded per-cell walk)."""
    cellf = (qpos - grid.bbox_min) * grid.inv_cell
    coord = jnp.floor(cellf)
    fract = cellf - coord
    base = coord.astype(jnp.int32)
    off = jnp.where(fract < 0.5, -1, 1)

    num_r = qpos.shape[0]
    best_d2 = jnp.full((num_r, k), jnp.float32(1e30))
    best_idx = jnp.full((num_r, k), -1, jnp.int32)
    ar = jnp.arange(max_per_cell, dtype=jnp.int32)

    for j in range(8):
        cx = base[:, 0] + (off[:, 0] if j & 4 else 0)
        cy = base[:, 1] + (off[:, 1] if j & 2 else 0)
        cz = base[:, 2] + (off[:, 2] if j & 1 else 0)
        h = _cell_hash(cx, cy, cz, table_size)
        start = grid.cell_start[h]
        end = grid.cell_start[h + 1]
        idx2d = start[:, None] + ar[None, :]
        in_range = idx2d < end[:, None]
        rec = grid.sorted_rec[jnp.where(in_range, idx2d, 0)]       # (R, W, 8)
        d2 = jnp.sum((rec[..., 0:3] - qpos[:, None, :]) ** 2, axis=-1)
        d2 = jnp.where(in_range & (d2 <= grid.radius_sqr), d2, jnp.float32(1e30))
        cand = jnp.where(
            in_range,
            jax.lax.bitcast_convert_type(rec[..., 3], jnp.int32),
            -1,
        )
        # Merge into the running best-k: small sort over (R, k + W).
        all_d2 = jnp.concatenate([best_d2, d2], axis=1)
        all_idx = jnp.concatenate([best_idx, cand], axis=1)
        sd2, sidx = jax.lax.sort((all_d2, all_idx), num_keys=1, dimension=1)
        best_d2 = sd2[:, :k]
        best_idx = sidx[:, :k]

    found = best_d2 < 1e29
    best_idx = jnp.where(found, best_idx, -1)
    count = jnp.sum(found.astype(jnp.int32), axis=-1)
    return best_idx, best_d2, count
