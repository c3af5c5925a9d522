"""Surface interaction assembly from traversal hits (batched gathers).

Replaces `calculate_intersection` (reference: render/integrators/
integrator.h:71-123).  Differences from the reference come from the
data layout: barycentric v comes straight from the traversal kernel
(the reference reconstructs it from the hit position, integrator.h:88-94),
and instancing is pre-flattened so no inverse-transform is needed at
shading time.

Performance: the entire shading step needs exactly ONE wide-record gather
(TriAttrs.shade_rec joins triangle attributes, the material row and the
emitter data at build time).  Texture lookups are statically skipped for
texture-free scenes.

Conventions preserved:
- attribute lerp weights (1-u-v, u, v)
- bump mapping perturbs an ONB of the shading normal with central
  differences of the bump texture (materials.h:33-55)
- the shading normal is flipped into the geometric normal's hemisphere
  (integrator.h:115-120)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.sampling import local_coordinates
from ..core.vecmath import dot, normalize
from ..scene.textures import sample_bilinear
from . import materials as mat_mod
from .traverse import Hit


class SurfaceInteraction(NamedTuple):
    pos: jnp.ndarray        # (R, 3) hit position
    w_out: jnp.ndarray      # (R, 3) direction toward the origin of the ray
    normal: jnp.ndarray     # (R, 3) shading normal (bumped, hemisphere-fixed)
    gn: jnp.ndarray         # (R, 3) geometric normal
    uv: jnp.ndarray         # (R, 2) texture coordinates
    mat_id: jnp.ndarray     # (R,) i32
    light_id: jnp.ndarray   # (R,) i32 (-1 unless emitter)
    emit: jnp.ndarray       # (R, 3) emitter intensity (AreaEmitter)
    area: jnp.ndarray       # (R,) emitter triangle area
    params: dict            # gathered per-ray material parameters


def make_interaction(scene, hit: Hit, org, d, has_bump: bool = False) -> SurfaceInteraction:
    """Gather per-hit shading data with a single wide-record gather.
    `hit.prim_id` < 0 rows produce garbage that callers must mask."""
    prim = jnp.maximum(hit.prim_id, 0)
    # One logical fetch, transposed once: row slices of (C, R) are
    # contiguous (column extracts of (R, C) are cross-lane shuffles).
    # The record holds only the statically-consumable column subset
    # (scene/types.py::shade_columns); `cpos` maps canonical column ids
    # to stored positions, and absent columns read as cheap lane-varying
    # zeros / -1 ids (their consumers are statically absent too).
    rec_t = scene.attrs.shade_rec[prim].T
    cpos = {c: i for i, c in enumerate(scene.attrs.shade_cols)}
    zero1 = hit.t * 0.0

    def row1(c):
        return rec_t[cpos[c]] if c in cpos else zero1

    def row3(c):
        if c in cpos:
            return rec_t[cpos[c]:cpos[c] + 3].T
        return jnp.zeros((3,), rec_t.dtype) + zero1[..., None]

    def row2(c):
        return rec_t[cpos[c]:cpos[c] + 2].T

    def bits(c, absent=-1):
        if c in cpos:
            return jax.lax.bitcast_convert_type(rec_t[cpos[c]], jnp.int32)
        return zero1.astype(jnp.int32) + absent

    w0 = (1.0 - hit.u - hit.v)[..., None]
    wu = hit.u[..., None]
    wv = hit.v[..., None]

    if 12 in cpos:
        uv = w0 * row2(12) + wu * row2(14) + wv * row2(16)
    else:
        uv = jnp.zeros((2,)) + zero1[..., None]
    n = normalize(w0 * row3(0) + wu * row3(3) + wv * row3(6))
    gn = row3(9)
    mat_id = bits(18)
    light_id = bits(19)

    kd = row3(23)
    kd_tex = bits(38)
    has_textures = scene.textures.texels.shape[0] > 1
    if has_textures:
        kd = jnp.where(
            (kd_tex >= 0)[..., None],
            sample_bilinear(scene.textures, kd_tex, uv[..., 0], uv[..., 1]),
            kd,
        )
    params = mat_mod.MatParams(
        kind=bits(22),
        kd=kd,
        ks=row3(26),
        tf=row3(29),
        ns=row1(32),
        ior=row1(33),
        emit=row3(34),
        kd_tex=kd_tex,
        bump_tex=bits(39),
        mask_tex=bits(40),
    )

    if has_bump and has_textures:
        n = _bump_normal(scene, params["bump_tex"], uv, n)

    # Shading normal must live in the geometric hemisphere
    # (integrator.h:115-120).
    n = jnp.where(dot(gn, n)[..., None] < 0.0, -n, n)

    pos = org + hit.t[..., None] * d
    return SurfaceInteraction(
        pos=pos,
        w_out=-normalize(d),
        normal=n,
        gn=gn,
        uv=uv,
        mat_id=mat_id,
        light_id=light_id,
        emit=row3(34),
        area=row1(37),
        params=params,
    )


def _bump_normal(scene, bump_tex, uv, n):
    """Central-difference bump mapping (materials.h:37-54); du=dv=1e-3,
    vscale=0.02 as in the reference."""
    du = 1e-3
    vscale = 0.02
    u, v = uv[..., 0], uv[..., 1]
    s = lambda uu, vv: sample_bilinear(scene.textures, bump_tex, uu, vv)[..., 0]
    h0 = s(u, v)
    diff_u = vscale * (s(u + du, v) - h0) / du
    diff_v = vscale * (s(u, v + du) - h0) / du
    t, b = local_coordinates(n)
    t2 = normalize(t + diff_u[..., None] * n)
    b2 = normalize(b + diff_v[..., None] * n)
    n_bumped = normalize(jnp.cross(t2, b2))
    return jnp.where((bump_tex >= 0)[..., None], n_bumped, n)
