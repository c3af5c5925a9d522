"""Lat-long HDR environment map with piecewise-constant importance sampling.

The reference builds pdf/cdf tables but never finishes importance sampling
— `sample_uv` is uniform with a TODO and `pdf()` returns 1
(reference: render/light.h:361-485, TODO at :466).  We implement the full
2D piecewise-constant distribution (marginal over rows + per-row cdf,
sin-theta weighted), which is strictly better and keeps all MIS pdfs
consistent.

Directional convention matches the reference (light.h:419-424, 452-459):
    s = phi / 2pi,  phi = atan2(x, z) wrapped to [0, 2pi)
    t = theta / pi, theta = acos(y)
    dir(u, v) = (sin(pi v) sin(2pi u), cos(pi v), sin(pi v) cos(2pi u))
pdf conversion: p(w) = p(s,t) / (2 pi^2 sin(theta)).
"""

from __future__ import annotations

from ..core import pytree
import jax
import jax.numpy as jnp
import numpy as np

from ..core.sampling import PI, concentric_disc_pdf
from ..core.vecmath import luminance


@pytree.dataclass
class EnvMapData:
    img: jnp.ndarray           # (H, W, 3) radiance, intensity pre-multiplied
    pdf_table: jnp.ndarray     # (H, W) density over unit (s, t) square
    row_cdf: jnp.ndarray       # (H, W + 1) conditional cdf per row
    marginal_cdf: jnp.ndarray  # (H + 1,)


def build_envmap(img_rgb: np.ndarray, intensity) -> EnvMapData:
    """Host-side table construction. img_rgb: (H, W, >=3) float32."""
    img = np.asarray(img_rgb[..., :3], np.float32) * np.asarray(intensity, np.float32)
    h, w = img.shape[:2]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    # 2x2 neighbourhood average (reference light.h:380-389) so bilinear-ish
    # peaks are not missed, then sin(theta) weighting for the sphere metric.
    func = 0.25 * (
        lum + np.roll(lum, -1, 0) + np.roll(lum, -1, 1) + np.roll(np.roll(lum, -1, 0), -1, 1)
    )
    sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h).astype(np.float32)
    func = func * sin_theta[:, None]
    func = np.maximum(func, 1e-12)

    total = func.sum()
    pdf_table = func * (w * h / total)   # integrates to 1 over [0,1]^2

    row_sum = func.sum(axis=1)
    marginal_cdf = np.concatenate([[0.0], np.cumsum(row_sum)]) / total
    row_cdf = np.concatenate(
        [np.zeros((h, 1), np.float32), np.cumsum(func, axis=1)], axis=1
    ) / row_sum[:, None]

    return EnvMapData(
        img=jnp.asarray(img),
        pdf_table=jnp.asarray(pdf_table.astype(np.float32)),
        row_cdf=jnp.asarray(row_cdf.astype(np.float32)),
        marginal_cdf=jnp.asarray(marginal_cdf.astype(np.float32)),
    )


def _dir_to_st(d):
    phi = jnp.arctan2(d[..., 0], d[..., 2])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    s = phi / (2.0 * PI)
    t = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) / PI
    return s, t


def _st_pdf_w(env: EnvMapData, s, t):
    h, w = env.pdf_table.shape
    col = jnp.clip((s * w).astype(jnp.int32), 0, w - 1)
    row = jnp.clip((t * h).astype(jnp.int32), 0, h - 1)
    p_st = env.pdf_table[row, col]
    sin_t = jnp.maximum(jnp.sin(PI * t), 1e-5)
    return p_st / (2.0 * PI * PI * sin_t)


def radiance(env: EnvMapData, d, bsphere_inv_r2):
    """Env radiance + (pdf_direct_w, pdf_emit_w) for a direction
    (light.h:418-431)."""
    s, t = _dir_to_st(d)
    h, w = env.img.shape[:2]
    # Nearest lookup at the reference's coordinates (light.h:430).
    x = jnp.clip((s * (w - 1)).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((t * (h - 1)).astype(jnp.int32), 0, h - 1)
    li = env.img[y, x]
    pdf_direct_w = _st_pdf_w(env, s, t)
    pdf_emit_w = concentric_disc_pdf() * bsphere_inv_r2 * pdf_direct_w
    return li, pdf_direct_w, pdf_emit_w


def sample_dir(env: EnvMapData, u1, u2):
    """Importance-sample a direction toward the environment.

    Returns (dir, radiance, pdf_w).  Replaces the reference's uniform
    sample_uv (light.h:461-474).
    """
    h, w = env.pdf_table.shape
    row = jnp.clip(
        jnp.searchsorted(env.marginal_cdf, u1, side="right") - 1, 0, h - 1
    ).astype(jnp.int32)
    # Stratified remap of the residual for the in-row coordinate.
    lo = env.marginal_cdf[row]
    hi = env.marginal_cdf[row + 1]
    v_res = jnp.clip((u1 - lo) / jnp.maximum(hi - lo, 1e-12), 0.0, 1.0 - 1e-7)

    cdf_rows = env.row_cdf[row]  # (R, W+1)
    col = jnp.clip(
        jax.vmap(lambda c, u: jnp.searchsorted(c, u, side="right"))(cdf_rows, u2) - 1,
        0,
        w - 1,
    ).astype(jnp.int32)
    c_lo = jnp.take_along_axis(cdf_rows, col[..., None], axis=-1)[..., 0]
    c_hi = jnp.take_along_axis(cdf_rows, col[..., None] + 1, axis=-1)[..., 0]
    u_res = jnp.clip((u2 - c_lo) / jnp.maximum(c_hi - c_lo, 1e-12), 0.0, 1.0 - 1e-7)

    s = (col.astype(jnp.float32) + u_res) / w
    t = (row.astype(jnp.float32) + v_res) / h

    theta = PI * t
    sin_t = jnp.sin(theta)
    phi = 2.0 * PI * s
    d = jnp.stack([sin_t * jnp.sin(phi), jnp.cos(theta), sin_t * jnp.cos(phi)], axis=-1)

    x = jnp.clip((s * (w - 1)).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((t * (h - 1)).astype(jnp.int32), 0, h - 1)
    li = env.img[y, x]
    return d, li, _st_pdf_w(env, s, t)
