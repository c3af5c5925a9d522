"""Batched light sampling over an SoA light table.

The reference's `Light` class hierarchy with `sample_emit`/`sample_direct`
virtuals (reference: render/light.h:49-359) becomes one flat table; every
light kind's formulas are evaluated branchlessly and selected by kind.
The `{radiance, cos_out, pdf_emit_w, pdf_direct_w|a}` dual-pdf contract is
preserved exactly — it is what the VCM-family MIS weights consume.

Kinds: TRI (area emitter), POINT, DIR(ectional), SPOT, ENV.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from ..core import pytree
import jax.numpy as jnp
import numpy as np

from ..core.sampling import (
    PI,
    concentric_disc_pdf,
    cos_hemisphere_pdf,
    sample_concentric_disc,
    sample_cos_hemisphere,
    sample_uniform_cone,
    sample_uniform_sphere,
    sample_uniform_triangle,
    to_world,
    uniform_cone_pdf,
    uniform_sphere_pdf,
)
from ..core.vecmath import dot, normalize, where3
from . import envmap as envmap_mod
from .envmap import EnvMapData

LIGHT_TRI = 0
LIGHT_POINT = 1
LIGHT_DIR = 2
LIGHT_SPOT = 3
LIGHT_ENV = 4

FAR = jnp.float32(1e30)


@pytree.dataclass
class LightTable:
    """SoA light storage.

    `rec` is the wide-record per-light view used by per-ray gathers (one
    (R, 24) row gather):
      [kind(0, i32 bits), p0(1:4), p1(4:7), p2(7:10), normal(10:13),
       intensity(13:16), area(16), cos_angle(17), pad(18:24)]
    """

    rec: jnp.ndarray        # (L, 24) f32 wide record
    kind: jnp.ndarray       # (L,) i32
    p0: jnp.ndarray         # (L, 3) tri vert / point pos / spot pos
    p1: jnp.ndarray         # (L, 3) tri vert
    p2: jnp.ndarray         # (L, 3) tri vert
    normal: jnp.ndarray     # (L, 3) tri normal / dir-light dir / spot axis
    intensity: jnp.ndarray  # (L, 3)
    area: jnp.ndarray       # (L,) triangle area
    cos_angle: jnp.ndarray  # (L,) spot cone cosine

    @property
    def count(self):
        return self.kind.shape[0]


@pytree.dataclass
class BSphere:
    center: jnp.ndarray    # (3,)
    radius: jnp.ndarray    # ()
    inv_radius_sqr: jnp.ndarray  # ()


class DirectSample(NamedTuple):
    """One NEE sample per ray (light.h DirectIllumSample, :51-63)."""

    dir: jnp.ndarray
    distance: jnp.ndarray
    radiance: jnp.ndarray
    cos_out: jnp.ndarray
    pdf_emit_w: jnp.ndarray
    pdf_direct_w: jnp.ndarray
    is_delta: jnp.ndarray


class EmitSample(NamedTuple):
    """One photon-emission sample (light.h EmitSample, :65-77)."""

    pos: jnp.ndarray
    dir: jnp.ndarray
    radiance: jnp.ndarray
    cos_out: jnp.ndarray
    pdf_emit_w: jnp.ndarray
    pdf_direct_a: jnp.ndarray
    is_finite: jnp.ndarray
    is_delta: jnp.ndarray


def _bits(col):
    import jax.lax

    return jax.lax.bitcast_convert_type(col, jnp.int32)


UNROLL_LIGHTS = 8


def _fetch_rows(table_rec, li):
    """Per-ray light-record fetch, TRANSPOSED to (24, R).  For small tables
    a select-chain over static rows replaces the dynamic gather; either
    way the result is component-major so the ~18 component reads below
    are contiguous row slices, not cross-lane column extracts."""
    L = table_rec.shape[0]
    if L <= UNROLL_LIGHTS:
        rec_t = jnp.broadcast_to(table_rec[0][:, None], (table_rec.shape[1],) + li.shape)
        for l in range(1, L):
            rec_t = jnp.where((li == l)[None, :], table_rec[l][:, None], rec_t)
        return rec_t
    return table_rec[li].T


def _has(kinds, K) -> bool:
    """Static scene light-kind gate (DeviceScene.light_kinds): `()` means
    "unknown — evaluate every kind" (the previous behaviour); otherwise
    absent kinds' sampling blocks are never traced.  Algebraically
    identical for every lane whose kind is present; the compiled values
    can differ from the unspecialized graph by FMA-contraction noise
    (measured <=4e-6 relative, tests/test_specialize.py) because removing
    a select changes XLA's fusion decisions."""
    return (not kinds) or (K in kinds)


def _chain(kind, pairs):
    """Ordered (kind_id, value) select chain; the first pair is the base.
    Every real lane's kind is one of the pairs, so the base never leaks."""
    assert pairs, "empty kind-select chain: the kinds tuple doesn't cover the light table"
    acc = pairs[0][1]
    for K, v in pairs[1:]:
        m = kind == K
        acc = where3(m, v, acc) if acc.ndim == kind.ndim + 1 else jnp.where(m, v, acc)
    return acc


def is_delta_kind(kind):
    return (kind == LIGHT_POINT) | (kind == LIGHT_DIR) | (kind == LIGHT_SPOT)


def is_finite_kind(kind):
    return (kind != LIGHT_DIR) & (kind != LIGHT_ENV)


def sample_direct(
    lights: LightTable,
    light_idx: jnp.ndarray,
    from_pos: jnp.ndarray,
    u1,
    u2,
    bsphere: BSphere,
    env: Optional[EnvMapData] = None,
    kinds: tuple = (),
) -> DirectSample:
    """Sample a point/direction on light `light_idx` for NEE shadow rays.
    `kinds`: static scene light-kind set (see _has)."""
    li = jnp.maximum(light_idx, 0)
    rec_t = _fetch_rows(lights.rec, li)
    kind = _bits(rec_t[0])
    p0 = rec_t[1:4].T
    p1 = rec_t[4:7].T
    p2 = rec_t[7:10].T
    n = rec_t[10:13].T
    intensity = rec_t[13:16].T
    cos_angle = rec_t[17]

    has = lambda K: _has(kinds, K)
    # Per-output (kind, value) select chains — see _chain.
    dirs, dists, rads, pdf_es, pdf_ds, cos_outs = [], [], [], [], [], []
    ones = jnp.ones_like(rec_t[0])

    if has(LIGHT_TRI):
        # --- TRI (light.h:145-180) ---------------------------------------
        area = rec_t[16]
        tu, tv = sample_uniform_triangle(u1, u2)
        pos = tu[..., None] * p0 + tv[..., None] * p1 + (1.0 - tu - tv)[..., None] * p2
        to_l = pos - from_pos
        distsq_t = jnp.maximum(dot(to_l, to_l), 1e-12)
        dist_t = jnp.sqrt(distsq_t)
        dir_t = to_l / dist_t[..., None]
        cos_out_t = dot(n, -dir_t)
        front = (cos_out_t > 0.0) & (cos_out_t < 1.0)
        rad_t = jnp.where(
            front[..., None], intensity * (cos_out_t * area / distsq_t)[..., None], 0.0
        )
        pdf_emit_t = jnp.where(front, cos_hemisphere_pdf(cos_out_t) / jnp.maximum(area, 1e-12), 1.0)
        pdf_dir_t = jnp.where(front, distsq_t / jnp.maximum(area * cos_out_t, 1e-12), 1.0)
        cos_out_t = jnp.where(front, cos_out_t, 1.0)
        dirs.append((LIGHT_TRI, dir_t))
        dists.append((LIGHT_TRI, dist_t))
        rads.append((LIGHT_TRI, rad_t))
        pdf_es.append((LIGHT_TRI, pdf_emit_t))
        pdf_ds.append((LIGHT_TRI, pdf_dir_t))
        cos_outs.append((LIGHT_TRI, cos_out_t))

    if has(LIGHT_POINT) or has(LIGHT_SPOT):
        to_p = p0 - from_pos
        distsq_p = jnp.maximum(dot(to_p, to_p), 1e-12)
        dist_p = jnp.sqrt(distsq_p)
        dir_p = to_p / dist_p[..., None]
    if has(LIGHT_POINT):
        # --- POINT (light.h:266-283) --------------------------------------
        rad_p = intensity / (4.0 * PI * distsq_p)[..., None]
        dirs.append((LIGHT_POINT, dir_p))
        dists.append((LIGHT_POINT, dist_p))
        rads.append((LIGHT_POINT, rad_p))
        pdf_es.append((LIGHT_POINT, jnp.broadcast_to(uniform_sphere_pdf(), distsq_p.shape)))
        pdf_ds.append((LIGHT_POINT, distsq_p))
        cos_outs.append((LIGHT_POINT, ones))

    if has(LIGHT_DIR):
        # --- DIR (light.h:225-238) ----------------------------------------
        dirs.append((LIGHT_DIR, -n))
        dists.append((LIGHT_DIR, jnp.full_like(ones, FAR)))
        rads.append((LIGHT_DIR, intensity))
        pdf_es.append((LIGHT_DIR, jnp.broadcast_to(
            concentric_disc_pdf() * bsphere.inv_radius_sqr, ones.shape)))
        pdf_ds.append((LIGHT_DIR, ones))
        cos_outs.append((LIGHT_DIR, ones))

    if has(LIGHT_SPOT):
        # --- SPOT (light.h:324-346) ---------------------------------------
        cos_o_s = -dot(dir_p, n)
        in_cone = cos_o_s >= cos_angle
        rad_s = jnp.where(in_cone[..., None], intensity / distsq_p[..., None], 0.0)
        pdf_emit_s = jnp.where(in_cone, uniform_cone_pdf(cos_angle), 0.0)
        dirs.append((LIGHT_SPOT, dir_p))
        dists.append((LIGHT_SPOT, dist_p))
        rads.append((LIGHT_SPOT, rad_s))
        pdf_es.append((LIGHT_SPOT, pdf_emit_s))
        pdf_ds.append((LIGHT_SPOT, distsq_p))
        cos_outs.append((LIGHT_SPOT, ones))

    # --- ENV (light.h:519-536), python-level gate: scene-static ----------
    if env is not None and has(LIGHT_ENV):
        env_dir, env_li, env_pdf = envmap_mod.sample_dir(env, u1, u2)
        dirs.append((LIGHT_ENV, env_dir))
        dists.append((LIGHT_ENV, jnp.full_like(ones, FAR)))
        rads.append((LIGHT_ENV, env_li / jnp.maximum(env_pdf, 1e-20)[..., None]))
        pdf_es.append((LIGHT_ENV,
                       concentric_disc_pdf() * bsphere.inv_radius_sqr * env_pdf))
        pdf_ds.append((LIGHT_ENV, env_pdf))
        cos_outs.append((LIGHT_ENV, ones))

    return DirectSample(
        dir=_chain(kind, dirs),
        distance=_chain(kind, dists),
        radiance=_chain(kind, rads),
        cos_out=_chain(kind, cos_outs),
        pdf_emit_w=_chain(kind, pdf_es),
        pdf_direct_w=_chain(kind, pdf_ds),
        is_delta=is_delta_kind(kind),
    )


def sample_emit(
    lights: LightTable,
    light_idx: jnp.ndarray,
    u1,
    u2,
    u3,
    u4,
    bsphere: BSphere,
    env: Optional[EnvMapData] = None,
    kinds: tuple = (),
) -> EmitSample:
    """Sample an outgoing photon ray from light `light_idx` (light pass).
    `kinds`: static scene light-kind set (see _has)."""
    li = jnp.maximum(light_idx, 0)
    rec_t = _fetch_rows(lights.rec, li)
    kind = _bits(rec_t[0])
    p0 = rec_t[1:4].T
    p1 = rec_t[4:7].T
    p2 = rec_t[7:10].T
    n = rec_t[10:13].T
    intensity = rec_t[13:16].T
    cos_angle = rec_t[17]

    has = lambda K: _has(kinds, K)
    poss, dirss, rads, pdf_es, pdf_das, cos_outs = [], [], [], [], [], []
    ones = jnp.ones_like(rec_t[0])

    if has(LIGHT_TRI):
        # --- TRI (light.h:109-143) -----------------------------------------
        area = jnp.maximum(rec_t[16], 1e-12)
        tu, tv = sample_uniform_triangle(u1, u2)
        pos_t = tu[..., None] * p0 + tv[..., None] * p1 + (1.0 - tu - tv)[..., None] * p2
        d_loc, pdf_cos = sample_cos_hemisphere(u3, u4)
        dir_t = to_world(d_loc, n)
        cos_out_t = d_loc[..., 2]
        degen = pdf_cos <= 0.0
        rad_t = jnp.where(degen[..., None], 0.0, intensity * (area * PI)[..., None])
        pdf_emit_t = jnp.where(degen, 1.0, pdf_cos / area)
        pdf_direct_t = jnp.where(degen, 1.0, 1.0 / area)
        cos_out_t = jnp.where(degen, 0.0, cos_out_t)
        poss.append((LIGHT_TRI, pos_t))
        dirss.append((LIGHT_TRI, dir_t))
        rads.append((LIGHT_TRI, rad_t))
        pdf_es.append((LIGHT_TRI, pdf_emit_t))
        pdf_das.append((LIGHT_TRI, pdf_direct_t))
        cos_outs.append((LIGHT_TRI, cos_out_t))

    if has(LIGHT_POINT):
        # --- POINT (light.h:249-264) ---------------------------------------
        d_sph, pdf_sph = sample_uniform_sphere(u3, u4)
        poss.append((LIGHT_POINT, p0))
        dirss.append((LIGHT_POINT, d_sph))
        rads.append((LIGHT_POINT, intensity))
        pdf_es.append((LIGHT_POINT, pdf_sph))
        pdf_das.append((LIGHT_POINT, ones))
        cos_outs.append((LIGHT_POINT, ones))

    if has(LIGHT_DIR) or (env is not None and has(LIGHT_ENV)):
        dx, dy = sample_concentric_disc(u1, u2)
    if has(LIGHT_DIR):
        # --- DIR (light.h:205-223): disc on the bounding sphere ------------
        t_dir, b_dir = _onb(n)
        pos_d = bsphere.center + bsphere.radius * (-n + b_dir * dx[..., None] + t_dir * dy[..., None])
        pdf_emit_d = concentric_disc_pdf() * bsphere.inv_radius_sqr
        poss.append((LIGHT_DIR, pos_d))
        dirss.append((LIGHT_DIR, jnp.broadcast_to(n, p0.shape)))
        rads.append((LIGHT_DIR, intensity / pdf_emit_d))
        pdf_es.append((LIGHT_DIR, jnp.broadcast_to(pdf_emit_d, ones.shape)))
        pdf_das.append((LIGHT_DIR, ones))
        cos_outs.append((LIGHT_DIR, ones))

    if has(LIGHT_SPOT):
        # --- SPOT (light.h:305-322) ----------------------------------------
        d_cone, pdf_cone = sample_uniform_cone(cos_angle, u3, u4)
        poss.append((LIGHT_SPOT, p0))
        dirss.append((LIGHT_SPOT, to_world(d_cone, n)))
        rads.append((LIGHT_SPOT, intensity / pdf_cone[..., None]))
        pdf_es.append((LIGHT_SPOT, pdf_cone))
        pdf_das.append((LIGHT_SPOT, ones))
        cos_outs.append((LIGHT_SPOT, ones))

    # --- ENV (light.h:494-516) ------------------------------------------
    if env is not None and has(LIGHT_ENV):
        env_dir, env_li, env_pdf = envmap_mod.sample_dir(env, u3, u4)
        inward = -env_dir
        te, be = _onb(inward)
        pos_e = bsphere.center + bsphere.radius * (
            -inward + be * dx[..., None] + te * dy[..., None]
        )
        pdf_emit_e = concentric_disc_pdf() * bsphere.inv_radius_sqr * env_pdf
        poss.append((LIGHT_ENV, pos_e))
        dirss.append((LIGHT_ENV, inward))
        rads.append((LIGHT_ENV, env_li / jnp.maximum(pdf_emit_e, 1e-20)[..., None]))
        pdf_es.append((LIGHT_ENV, pdf_emit_e))
        pdf_das.append((LIGHT_ENV, env_pdf))
        cos_outs.append((LIGHT_ENV, ones))

    return EmitSample(
        pos=_chain(kind, poss),
        dir=normalize(_chain(kind, dirss)),
        radiance=_chain(kind, rads),
        cos_out=_chain(kind, cos_outs),
        pdf_emit_w=_chain(kind, pdf_es),
        pdf_direct_a=_chain(kind, pdf_das),
        is_finite=is_finite_kind(kind),
        is_delta=is_delta_kind(kind),
    )


def _onb(n):
    from ..core.sampling import local_coordinates

    return local_coordinates(n)


def build_light_table(rows: list[dict]) -> LightTable:
    """Host-side table assembly from a list of per-light dicts."""
    L = max(len(rows), 1)

    def arr(key, default, width=None):
        if width is None:
            out = np.full((L,), default, np.float32)
        else:
            out = np.full((L, width), default, np.float32)
        for i, r in enumerate(rows):
            if key in r:
                out[i] = r[key]
        return out

    kind = np.full((L,), LIGHT_POINT, np.int32)
    for i, r in enumerate(rows):
        kind[i] = r["kind"]
    if not rows:
        # Dummy black point light so the table is never empty.
        kind[0] = LIGHT_POINT

    rec = np.zeros((L, 24), np.float32)
    rec[:, 0] = kind.view(np.float32)
    rec[:, 1:4] = arr("p0", 0.0, 3)
    rec[:, 4:7] = arr("p1", 0.0, 3)
    rec[:, 7:10] = arr("p2", 0.0, 3)
    rec[:, 10:13] = arr("normal", 0.0, 3)
    rec[:, 13:16] = arr("intensity", 0.0, 3)
    rec[:, 16] = arr("area", 1.0)
    rec[:, 17] = arr("cos_angle", 0.0)
    return LightTable(
        rec=jnp.asarray(rec),
        kind=jnp.asarray(kind),
        p0=jnp.asarray(arr("p0", 0.0, 3)),
        p1=jnp.asarray(arr("p1", 0.0, 3)),
        p2=jnp.asarray(arr("p2", 0.0, 3)),
        normal=jnp.asarray(arr("normal", 0.0, 3)),
        intensity=jnp.asarray(arr("intensity", 0.0, 3)),
        area=jnp.asarray(arr("area", 1.0)),
        cos_angle=jnp.asarray(arr("cos_angle", 0.0)),
    )
