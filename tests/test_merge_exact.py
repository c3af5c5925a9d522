"""The hash-grid photon merge (render/hashgrid.cell_windows, the one
merge route of VCM and PPM) against a plain brute-force exact merge.

Each query sums w * max(1 - d^2 / r^2, 0) over the photons within radius
r (the Epanechnikov kernel of vcm._vertex_merging).  The windowed route
keeps at most `max_per_cell` photons per hash cell and rescales the
cell's sum by N / max_per_cell: exact when every cell fits its window,
an estimate of the same sum otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest

from imbatracer_tpu.render.hashgrid import build_hash_grid, cell_windows


def _photons(n, seed, clustered=False):
    rs = np.random.RandomState(seed)
    pos = rs.rand(n, 3).astype(np.float32)
    if clustered:
        pos = (0.5 + 0.15 * rs.randn(n, 3)).astype(np.float32)
    w = rs.uniform(0.5, 2.0, n).astype(np.float32)
    valid = rs.rand(n) < 0.9
    return pos, w, valid


def _exact(pos, w, valid, q, r):
    d2 = ((q[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    k = np.maximum(1.0 - d2 / (r * r), 0.0) * (d2 <= r * r) * valid[None]
    return (k * w[None]).sum(1)


def _windowed(pos, w, valid, q, r, max_per_cell, table_size):
    grid = build_hash_grid(jnp.asarray(pos), jnp.asarray(valid),
                           jnp.float32(r), table_size,
                           payload=jnp.asarray(w)[:, None])
    total = jnp.zeros(q.shape[0])
    for rec, d2, ok, scale in cell_windows(grid, jnp.asarray(q),
                                           max_per_cell):
        k = jnp.maximum(1.0 - d2 / (r * r), 0.0)
        total = total + scale * jnp.sum(jnp.where(ok, rec[..., 4] * k, 0.0),
                                        axis=1)
    return np.asarray(total), grid


@pytest.mark.parametrize("r,seed", [(0.04, 0), (0.1, 1)])
def test_merge_exact_when_every_cell_fits(r, seed):
    pos, w, valid = _photons(3000, seed)
    q = np.random.RandomState(seed + 10).rand(500, 3).astype(np.float32)
    # A table much larger than the photon count: no hash collisions, and
    # a window as large as the fullest cell.
    table = 1 << 16
    _, grid = _windowed(pos, w, valid, q, r, 1, table)
    fullest = int(np.max(np.diff(np.asarray(grid.cell_start))[:-1]))
    got, _ = _windowed(pos, w, valid, q, r, max(fullest, 1), table)
    want = _exact(pos, w, valid, q, r)
    assert (want > 0).mean() > 0.3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_capped_windows_estimate_the_exact_sum():
    """Clustered photons overflow the 4-photon windows; the rescaled sum
    still matches the exact merge on average over many queries."""
    pos, w, valid = _photons(20000, 3, clustered=True)
    q = (0.5 + 0.1 * np.random.RandomState(4).randn(2000, 3)).astype(
        np.float32)
    r = 0.03
    got, grid = _windowed(pos, w, valid, q, r, 4, 1 << 16)
    want = _exact(pos, w, valid, q, r)
    fullest = int(np.max(np.diff(np.asarray(grid.cell_start))[:-1]))
    assert fullest > 4  # the cap binds
    assert not np.allclose(got, want)
    rel = abs(got.mean() - want.mean()) / want.mean()
    assert rel < 0.05, rel
