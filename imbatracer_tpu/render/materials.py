"""Branchless, batched BSDF evaluation/sampling/pdf for all material kinds.

The reference dispatches through virtual BxDF objects placement-allocated in
per-thread arenas (reference: render/materials/materials.h,
bsdf.h:118-199, brdfs.h, btdfs.h, fresnel.h).  Here there is no dispatch:
materials live in an SoA table, every kind's math is evaluated for every
lane and the result selected by the kind id — four cheap formula blocks vs.
a gather-scatter of control flow.

Model parity (formulas match the reference exactly unless noted):
- DIFFUSE : Lambertian kd/pi                           (brdfs.h:8-20)
- MIRROR  : delta reflection, conductor Fresnel with
            (eta=1, kappa=ns), scale ks               (brdfs.h:22-46,
            materials.h MirrorMaterial; fresnel.h:8-22)
- GLASS   : delta reflection (ks) + delta transmission (tf), dielectric
            Fresnel (1.0 : ni), component chosen with probability
            1 - Fr ("importance", btdfs.h:55-58); radiance transport
            scales transmission by (eta_i/eta_t)^2, adjoint (light
            tracing) does not                          (btdfs.h:6-65)
- GLOSSY  : 0.5 * (CookTorrance(ks, Fresnel(1, ns), ns) + Lambertian(kd))
            with Blinn half-vector distribution       (brdfs.h:146-227,
            bsdf.h CombineBxDF)
- PHONG   : (ns+2)/2pi ks cos^ns about the mirror direction, sampled as a
            power-cosine lobe around it                (brdfs.h:48-91)
- OREN_NAYAR: rough diffuse, sigma (degrees) in `ns`   (brdfs.h:94-144)
  (both exist as BxDFs in the reference but are unreachable from its OBJ
  material conversion; here they are first-class kinds available to
  procedural scenes and the Python material API)

Deliberate improvement over the reference: for GLOSSY sampling we return
the *full* combined f and the *mixture* pdf (0.5 pa + 0.5 pb) instead of
the chosen component's f and pdf (bsdf.h:84-89) — equally unbiased, lower
variance, and consistent with pdf() used for MIS.

The PBRT-style light-leak fix is kept: the geometric normal decides
whether reflection or transmission applies (bsdf.h:125-145), and samples
that land on the wrong geometric side are rejected (bsdf.h:188-193).

All directions are in world space; `wo` points away from the surface.
"""

from __future__ import annotations

from ..core import pytree
import jax.numpy as jnp

from ..core.sampling import (
    INV_PI,
    PI,
    cos_hemisphere_pdf,
    local_coordinates,
    sample_cos_hemisphere,
    to_local,
    to_world,
)
from ..core.vecmath import dot, where3

MAT_DIFFUSE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_GLOSSY = 3
MAT_PHONG = 4
MAT_OREN_NAYAR = 5


@pytree.dataclass
class MaterialTable:
    """SoA material storage; one row per scene material.

    `rec` is the wide-record view used by per-ray gathers (one fast
    (R, 24) row gather — see accel/flatten.py for the rationale):
      [kind(0, i32 bits), kd(1:4), ks(4:7), tf(7:10), ns(10), ior(11),
       emit(12:15), kd_tex(15, i32 bits), bump_tex(16, i32 bits),
       mask_tex(17, i32 bits), pad(18:24)]
    """

    rec: jnp.ndarray       # (M, 24) f32 wide record
    kind: jnp.ndarray      # (M,) i32
    kd: jnp.ndarray        # (M, 3) diffuse albedo (DIFFUSE, GLOSSY)
    ks: jnp.ndarray        # (M, 3) specular scale / reflectance
    tf: jnp.ndarray        # (M, 3) glass transmittance
    ns: jnp.ndarray        # (M,)  exponent (GLOSSY) / conductor kappa (MIRROR)
    ior: jnp.ndarray       # (M,)  glass interior index of refraction
    emit: jnp.ndarray      # (M, 3) emission intensity (area lights)
    kd_tex: jnp.ndarray    # (M,) i32 texture id, -1 = none
    bump_tex: jnp.ndarray  # (M,) i32
    mask_tex: jnp.ndarray  # (M,) i32 alpha mask id, -1 = opaque


class MatParams(dict):
    """Per-ray gathered material parameters (kind, kd, ks, tf, ns, ior,
    plus texture ids).  kd is post-texture-lookup.  Plain dict so it stays
    a pytree.
    """


def gather_params(table: MaterialTable, mat_id: jnp.ndarray, kd_override=None) -> MatParams:
    import jax.lax

    m = jnp.maximum(mat_id, 0)
    # Transposed once so component reads are contiguous row slices.
    rec_t = table.rec[m].T
    bits = lambda row: jax.lax.bitcast_convert_type(rec_t[row], jnp.int32)
    kd = rec_t[1:4].T if kd_override is None else kd_override
    return MatParams(
        kind=bits(0),
        kd=kd,
        ks=rec_t[4:7].T,
        tf=rec_t[7:10].T,
        ns=rec_t[10],
        ior=rec_t[11],
        emit=rec_t[12:15].T,
        kd_tex=bits(15),
        bump_tex=bits(16),
        mask_tex=bits(17),
    )


def is_specular(p: MatParams) -> jnp.ndarray:
    return (p["kind"] == MAT_MIRROR) | (p["kind"] == MAT_GLASS)


# ------------------------------------------------- per-scene specialization
#
# Every eval/pdf/sample entry point takes a static `kinds` tuple — the set
# of material kinds that exist in the scene (DeviceScene.mat_kinds, a
# pytree-static field computed at build time).  `()` means "unknown":
# evaluate every kind, the previous behaviour.  With a non-empty tuple the
# absent kinds' formula blocks are never traced, which deletes their
# transcendental chains (Blinn/Phong powers, glass Fresnel) from the
# compiled program — the analogue of the reference compiling one
# kernel per material via AnyDSL specialisation (materials.h's
# per-material BxDF instantiation).  Results are BITWISE identical for
# every lane whose kind is in `kinds` (each select chain yields exactly
# the chosen kind's value; tests/test_specialize.py asserts this), and
# every real lane's kind is in `kinds` by construction.

def _has(kinds, K) -> bool:
    return (not kinds) or (K in kinds)


# ---------------------------------------------------------------- fresnel

def fresnel_conductor(cos_i, eta, kappa):
    """(fresnel.h:8-22); approximate conductor Fresnel."""
    c2 = cos_i * cos_i
    ekc = (eta * eta + kappa * kappa) * c2
    two_ec = 2.0 * eta * cos_i
    par = (ekc - two_ec + 1.0) / (ekc + two_ec + 1.0)
    ek = eta * eta + kappa * kappa
    perp = (ek - two_ec + c2) / (ek + two_ec + c2)
    return 0.5 * (par + perp)


def fresnel_dielectric(cos_i_signed, eta_outside, eta_inside):
    """(fresnel.h:24-31, 58-75). cos_i_signed: cos against the shading
    normal; sign selects which medium the ray arrives from."""
    entering = cos_i_signed > 0.0
    eta_i = jnp.where(entering, eta_outside, eta_inside)
    eta_t = jnp.where(entering, eta_inside, eta_outside)
    cos_i = jnp.abs(cos_i_signed)
    sin_t = eta_i / eta_t * jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_i * cos_i))
    tir = sin_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t * sin_t))
    par = (eta_t * cos_i - eta_i * cos_t) / jnp.maximum(eta_t * cos_i + eta_i * cos_t, 1e-20)
    perp = (eta_i * cos_i - eta_t * cos_t) / jnp.maximum(eta_i * cos_i + eta_t * cos_t, 1e-20)
    fr = 0.5 * (par * par + perp * perp)
    return jnp.where(tir, 1.0, fr)


# ------------------------------------------------------------ cook-torrance

def _ct_d(cos_h, ns):
    return (ns + 2.0) / (2.0 * PI) * jnp.power(jnp.maximum(jnp.abs(cos_h), 1e-12), ns)


def _ct_g(lo, li, h):
    o_dot_h = jnp.maximum(jnp.sum(lo * h, axis=-1), 1e-12)
    a = 2.0 * jnp.abs(h[..., 2]) * jnp.abs(lo[..., 2]) / o_dot_h
    b = 2.0 * jnp.abs(h[..., 2]) * jnp.abs(li[..., 2]) / o_dot_h
    return jnp.minimum(1.0, jnp.minimum(a, b))


def _ct_eval(ks, ns, lo, li):
    """Cook-Torrance with Blinn D (brdfs.h:154-172)."""
    h = lo + li
    h_len = jnp.sqrt(jnp.maximum(jnp.sum(h * h, axis=-1, keepdims=True), 1e-20))
    h = h / h_len
    cos_half = jnp.sum(li * h, axis=-1)
    fr = fresnel_conductor(cos_half, 1.0, ns)
    d = _ct_d(h[..., 2], ns)
    g = _ct_g(lo, li, h)
    denom = 4.0 * jnp.maximum(jnp.abs(li[..., 2]) * jnp.abs(lo[..., 2]), 1e-12)
    same_hemi = lo[..., 2] * li[..., 2] > 0.0
    val = ks * ((d * g * fr) / denom)[..., None]
    return jnp.where(same_hemi[..., None], val, 0.0)


def _ct_pdf(ns, lo, li):
    """Blinn half-vector pdf (brdfs.h:216-226)."""
    h = lo + li
    h_len = jnp.sqrt(jnp.maximum(jnp.sum(h * h, axis=-1, keepdims=True), 1e-20))
    h = h / h_len
    o_dot_h = jnp.sum(lo * h, axis=-1)
    same_hemi = lo[..., 2] * li[..., 2] > 0.0
    pdf = (ns + 1.0) * jnp.power(jnp.maximum(jnp.abs(h[..., 2]), 1e-12), ns) / (
        2.0 * PI * 4.0 * jnp.maximum(o_dot_h, 1e-12)
    )
    return jnp.where(same_hemi & (o_dot_h > 0.0), pdf, 0.0)


def _ct_sample(ns, lo, u1, u2):
    """Sample the Blinn distribution, reflect about the half vector
    (brdfs.h:194-214). Returns (li, pdf)."""
    c_theta = jnp.power(u1, 1.0 / (ns + 1.0))
    s_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - c_theta * c_theta))
    phi = u2 * 2.0 * PI
    h = jnp.stack([s_theta * jnp.cos(phi), s_theta * jnp.sin(phi), c_theta], axis=-1)
    flip = (lo[..., 2] * h[..., 2]) <= 0.0
    h = jnp.where(flip[..., None], -h, h)
    o_dot_h = jnp.sum(lo * h, axis=-1)
    li = -lo + 2.0 * o_dot_h[..., None] * h
    pdf = (ns + 1.0) * jnp.power(c_theta, ns) / (
        2.0 * PI * 4.0 * jnp.maximum(o_dot_h, 1e-12)
    )
    pdf = jnp.where(o_dot_h > 0.0, pdf, 1.0)  # value is 0 there; avoid NaN
    return li, pdf


# ------------------------------------------------------------------ phong

def _mirror_local(v):
    return jnp.stack([-v[..., 0], -v[..., 1], v[..., 2]], axis=-1)


def _phong_eval(ks, ns, lo, li):
    """(ns+2)/(2pi) ks max(cos(r, wo))^ns (brdfs.h:56-65)."""
    refl_in = _mirror_local(li)
    cos_ro = jnp.clip(jnp.sum(refl_in * lo, axis=-1), 0.0, 1.0)
    same = lo[..., 2] * li[..., 2] > 0.0
    val = ks * ((ns + 2.0) / (2.0 * PI) * jnp.power(cos_ro, ns))[..., None]
    return jnp.where(same[..., None], val, 0.0)


def _phong_pdf(ns, lo, li):
    """Power-cosine pdf about the mirror direction of `lo`.

    Deliberate fix over the reference: brdfs.h:87-90 returns the pdf about
    the NORMAL (in_dir.z) although sample() draws the lobe about the
    REFLECTED direction (brdfs.h:67-85) — an axis mismatch that makes
    f/pdf blow up at grazing angles (caught by the white-furnace test).
    """
    c = jnp.maximum(jnp.sum(_mirror_local(lo) * li, axis=-1), 0.0)
    return (ns + 1.0) / (2.0 * PI) * jnp.power(c, ns)


def _phong_sample(ns, lo, u1, u2):
    """Power-cosine lobe about the reflected direction (brdfs.h:67-85)."""
    from ..core.sampling import sample_power_cos_hemisphere, to_world as tw

    d_loc, pdf = sample_power_cos_hemisphere(ns, u1, u2)
    refl = _mirror_local(lo)
    li = tw(d_loc, refl)
    return li, pdf


# -------------------------------------------------------------- oren-nayar

def _oren_nayar_eval(kd, sigma_deg, lo, li):
    """Oren-Nayar rough diffuse (brdfs.h:94-144); sigma in degrees."""
    sigma = sigma_deg * (PI / 180.0)
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)

    def sin_theta(v):
        return jnp.sqrt(jnp.maximum(0.0, 1.0 - v[..., 2] * v[..., 2]))

    st_i = sin_theta(li)
    st_o = sin_theta(lo)
    denom = jnp.maximum(st_i * st_o, 1e-6)
    cos_dphi = (li[..., 0] * lo[..., 0] + li[..., 1] * lo[..., 1]) / denom
    max_cos = jnp.where((st_i > 1e-4) & (st_o > 1e-4), jnp.maximum(cos_dphi, 0.0), 0.0)

    abs_ci = jnp.abs(li[..., 2])
    abs_co = jnp.abs(lo[..., 2])
    sin_alpha = jnp.where(abs_ci > abs_co, st_o, st_i)
    tan_beta = jnp.where(
        abs_ci > abs_co,
        st_i / jnp.maximum(abs_ci, 1e-6),
        st_o / jnp.maximum(abs_co, 1e-6),
    )
    same = lo[..., 2] * li[..., 2] > 0.0
    val = kd * (INV_PI * (a + b * max_cos * sin_alpha * tan_beta))[..., None]
    return jnp.where(same[..., None], val, 0.0)


# ---------------------------------------------------------------- eval/pdf

def _lambert_eval(kd, lo, li):
    same = lo[..., 2] * li[..., 2] > 0.0
    return jnp.where(same[..., None], kd * INV_PI, 0.0)


def eval_bsdf(p: MatParams, n, gn, wo, wi, adjoint: bool = False, kinds: tuple = ()):
    """BSDF value for given directions; zero for delta materials.

    Matches BSDF::eval's geometric-side selection (bsdf.h:125-145).
    `kinds`: static scene material-kind set, see _has above.
    """
    lo = to_local(wo, n)
    li = to_local(wi, n)
    same_geom = dot(wo, gn) * dot(wi, gn) > 0.0

    kind = p["kind"]
    f = jnp.zeros_like(p["kd"])
    if _has(kinds, MAT_DIFFUSE):
        f = where3(kind == MAT_DIFFUSE, _lambert_eval(p["kd"], lo, li), f)
    if _has(kinds, MAT_GLOSSY):
        f_glossy = 0.5 * (_ct_eval(p["ks"], p["ns"], lo, li)
                          + _lambert_eval(p["kd"], lo, li))
        f = where3(kind == MAT_GLOSSY, f_glossy, f)
    if _has(kinds, MAT_PHONG):
        f = where3(kind == MAT_PHONG, _phong_eval(p["ks"], p["ns"], lo, li), f)
    if _has(kinds, MAT_OREN_NAYAR):
        f = where3(kind == MAT_OREN_NAYAR,
                   _oren_nayar_eval(p["kd"], p["ns"], lo, li), f)
    # Reflection-only materials contribute nothing across the surface.
    return where3(same_geom, f, jnp.zeros_like(f))


def pdf_bsdf(p: MatParams, n, gn, wo, wi, kinds: tuple = ()):
    """Solid-angle pdf of sample_bsdf picking wi; zero for delta kinds."""
    lo = to_local(wo, n)
    li = to_local(wi, n)
    same_geom = dot(wo, gn) * dot(wi, gn) > 0.0
    same_hemi = lo[..., 2] * li[..., 2] > 0.0

    pdf_cos = jnp.where(same_hemi, cos_hemisphere_pdf(jnp.abs(li[..., 2])), 0.0)

    kind = p["kind"]
    pdf = jnp.zeros_like(pdf_cos)
    if _has(kinds, MAT_DIFFUSE):
        pdf = jnp.where(kind == MAT_DIFFUSE, pdf_cos, pdf)
    if _has(kinds, MAT_GLOSSY):
        pdf_glossy = 0.5 * (_ct_pdf(p["ns"], lo, li) + pdf_cos)
        pdf = jnp.where(kind == MAT_GLOSSY, pdf_glossy, pdf)
    if _has(kinds, MAT_PHONG):
        pdf = jnp.where(kind == MAT_PHONG, _phong_pdf(p["ns"], lo, li), pdf)
    if _has(kinds, MAT_OREN_NAYAR):
        pdf = jnp.where(kind == MAT_OREN_NAYAR, pdf_cos, pdf)
    return jnp.where(same_geom, pdf, 0.0)


def _ct_eval_pdf2(ks, ns, lo, li):
    """Cook-Torrance eval + Blinn half-vector pdf in BOTH directions
    (brdfs.h:154-172, 216-226), sharing the half-vector, the hemisphere
    test and the |h.z|^ns power across all three results.  Bitwise equal
    to (_ct_eval, _ct_pdf(lo,li), _ct_pdf(li,lo)): h = lo+li is symmetric
    and IEEE multiplication/addition are commutative bitwise."""
    h = lo + li
    h_len = jnp.sqrt(jnp.maximum(jnp.sum(h * h, axis=-1, keepdims=True), 1e-20))
    h = h / h_len
    o_dot_h_f = jnp.sum(lo * h, axis=-1)
    o_dot_h_r = jnp.sum(li * h, axis=-1)
    same_hemi = lo[..., 2] * li[..., 2] > 0.0
    pow_h = jnp.power(jnp.maximum(jnp.abs(h[..., 2]), 1e-12), ns)

    fr = fresnel_conductor(o_dot_h_r, 1.0, ns)  # cos_half = li.h
    d = (ns + 2.0) / (2.0 * PI) * pow_h
    g = _ct_g(lo, li, h)
    denom = 4.0 * jnp.maximum(jnp.abs(li[..., 2]) * jnp.abs(lo[..., 2]), 1e-12)
    f = ks * ((d * g * fr) / denom)[..., None]
    f = jnp.where(same_hemi[..., None], f, 0.0)

    def bpdf(o_dot_h):
        pdf = (ns + 1.0) * pow_h / (2.0 * PI * 4.0 * jnp.maximum(o_dot_h, 1e-12))
        return jnp.where(same_hemi & (o_dot_h > 0.0), pdf, 0.0)

    return f, bpdf(o_dot_h_f), bpdf(o_dot_h_r)


def _phong_eval_pdf2(ks, ns, lo, li, same_hemi):
    """Phong eval + pdf sharing the lobe dot: mirror(li).lo == mirror(lo).li
    bitwise, and the pdf is therefore direction-symmetric — one value
    serves as both the forward and the reverse pdf (brdfs.h:56-91)."""
    m = jnp.sum(_mirror_local(li) * lo, axis=-1)
    cos_ro = jnp.clip(m, 0.0, 1.0)
    val = ks * ((ns + 2.0) / (2.0 * PI) * jnp.power(cos_ro, ns))[..., None]
    f = jnp.where(same_hemi[..., None], val, 0.0)
    c = jnp.maximum(m, 0.0)
    pdf = (ns + 1.0) / (2.0 * PI) * jnp.power(c, ns)
    return f, pdf


def eval_pdf_bsdf(p: MatParams, n, gn, wo, wi, kinds: tuple = ()):
    """Fused eval_bsdf(wo,wi) + pdf_bsdf(wo,wi) + pdf_bsdf(wi,wo).

    MIS needs all three at every NEE / vertex-connection vertex
    (reference: render/integrators/vcm.impala analogue vcm.cpp:488-569,
    pt.cpp:17-44); called separately they rebuild the tangent frame six
    times and the Blinn/Phong lobe powers three times, and XLA CSE cannot
    merge the forward and reverse pdf graphs because the swapped operands
    produce structurally different HLO.  This computes the ONB, the
    geometric-side test, the half-vector and each transcendental once.

    Bitwise-identical to the three separate calls
    (tests/test_materials_fused.py).  Returns (f, pdf_fwd, pdf_rev);
    unused outputs are dead-code-eliminated by XLA, so two-output call
    sites pay nothing for the third.  `kinds`: static scene material-kind
    set (see _has); absent kinds' blocks are never traced.
    """
    t, b = local_coordinates(n)
    def proj(v):
        return jnp.stack(
            [jnp.sum(v * t, axis=-1), jnp.sum(v * b, axis=-1),
             jnp.sum(v * n, axis=-1)],
            axis=-1,
        )
    lo = proj(wo)
    li = proj(wi)
    same_geom = dot(wo, gn) * dot(wi, gn) > 0.0
    same_hemi = lo[..., 2] * li[..., 2] > 0.0
    kind = p["kind"]

    f_diff = _lambert_eval(p["kd"], lo, li)
    pdf_cos_f = jnp.where(same_hemi, cos_hemisphere_pdf(jnp.abs(li[..., 2])), 0.0)
    pdf_cos_r = jnp.where(same_hemi, cos_hemisphere_pdf(jnp.abs(lo[..., 2])), 0.0)

    f = jnp.zeros_like(f_diff)
    pdf_f = jnp.zeros_like(pdf_cos_f)
    pdf_r = jnp.zeros_like(pdf_cos_r)

    def sel(K, fv, pf, pr):
        nonlocal f, pdf_f, pdf_r
        m = kind == K
        f = where3(m, fv, f)
        pdf_f = jnp.where(m, pf, pdf_f)
        pdf_r = jnp.where(m, pr, pdf_r)

    if _has(kinds, MAT_DIFFUSE):
        sel(MAT_DIFFUSE, f_diff, pdf_cos_f, pdf_cos_r)
    if _has(kinds, MAT_GLOSSY):
        ct_f, ct_pdf_f, ct_pdf_r = _ct_eval_pdf2(p["ks"], p["ns"], lo, li)
        sel(MAT_GLOSSY, 0.5 * (ct_f + f_diff),
            0.5 * (ct_pdf_f + pdf_cos_f), 0.5 * (ct_pdf_r + pdf_cos_r))
    if _has(kinds, MAT_PHONG):
        ph_f, ph_pdf = _phong_eval_pdf2(p["ks"], p["ns"], lo, li, same_hemi)
        sel(MAT_PHONG, ph_f, ph_pdf, ph_pdf)
    if _has(kinds, MAT_OREN_NAYAR):
        sel(MAT_OREN_NAYAR, _oren_nayar_eval(p["kd"], p["ns"], lo, li),
            pdf_cos_f, pdf_cos_r)

    f = where3(same_geom, f, jnp.zeros_like(f))
    pdf_f = jnp.where(same_geom, pdf_f, 0.0)
    pdf_r = jnp.where(same_geom, pdf_r, 0.0)
    return f, pdf_f, pdf_r


# ------------------------------------------------------------------ sample

def sample_bsdf(p: MatParams, n, gn, wo, u1, u2, u3, adjoint: bool = False,
                kinds: tuple = ()):
    """Sample an incoming direction.

    Returns (wi, f, pdf, specular_mask, valid_mask).  `f` excludes the
    cosine term; `pdf` includes component-choice probabilities.
    `kinds`: static scene material-kind set (see _has); absent kinds'
    sampling/eval blocks are never traced.
    """
    lo = to_local(wo, n)
    kind = p["kind"]
    has = lambda K: _has(kinds, K)
    need_cos = has(MAT_DIFFUSE) or has(MAT_GLOSSY) or has(MAT_OREN_NAYAR)
    need_mirror_dir = has(MAT_MIRROR) or has(MAT_GLASS)

    # Ordered (kind, value) select chains; the first present kind is the
    # chain base (every real lane's kind is present, so the base never
    # leaks — bitwise identical to the full chain).
    li_sel, f_sel, pdf_sel = [], [], []

    if need_cos:
        sign_o = jnp.where(lo[..., 2] >= 0.0, 1.0, -1.0)
        # --- DIFFUSE / GLOSSY shared cosine-hemisphere proposal --------
        d_cos, _ = sample_cos_hemisphere(u1, u2)
        d_cos = d_cos.at[..., 2].multiply(sign_o)  # stay in wo's hemisphere

    if has(MAT_GLOSSY):
        # --- GLOSSY: 50/50 Blinn vs cosine (bsdf.h:84-89) --------------
        li_blinn, _ = _ct_sample(p["ns"], lo, u1, u2)
        choose_blinn = u3 < 0.5
        li_glossy = where3(choose_blinn, li_blinn, d_cos)

    if need_mirror_dir:
        # --- MIRROR delta reflection ------------------------------------
        li_mirror = jnp.stack([-lo[..., 0], -lo[..., 1], lo[..., 2]], axis=-1)
    if has(MAT_MIRROR):
        fr_cond = fresnel_conductor(lo[..., 2], 1.0, p["ns"])
        f_mirror = p["ks"] * (fr_cond / jnp.maximum(jnp.abs(lo[..., 2]), 1e-12))[..., None]

    if has(MAT_GLASS):
        # --- GLASS: reflection or transmission by 1 - Fr ----------------
        fr_diel = fresnel_dielectric(lo[..., 2], 1.0, p["ior"])
        btdf_prob = 1.0 - fr_diel
        choose_trans = u3 < btdf_prob
        entering = lo[..., 2] > 0.0
        eta_i = jnp.where(entering, 1.0, p["ior"])
        eta_t = jnp.where(entering, p["ior"], 1.0)
        eta_frac = eta_i / eta_t
        sin_i_sqr = jnp.maximum(0.0, 1.0 - lo[..., 2] * lo[..., 2])
        sin_t_sqr = eta_frac * eta_frac * sin_i_sqr
        tir = sin_t_sqr >= 1.0
        cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t_sqr))
        cos_t = jnp.where(entering, -cos_t, cos_t)
        li_trans = jnp.stack(
            [-eta_frac * lo[..., 0], -eta_frac * lo[..., 1], cos_t], axis=-1
        )
        li_trans = jnp.where(tir[..., None], li_mirror, li_trans)
        radiance_factor = jnp.where(adjoint, 1.0, eta_frac * eta_frac)
        f_trans = p["tf"] * (
            radiance_factor
            * (1.0 - fr_diel)
            / jnp.maximum(jnp.abs(li_trans[..., 2]), 1e-12)
        )[..., None]
        f_trans = jnp.where(tir[..., None], 0.0, f_trans)
        f_glass_refl = p["ks"] * (fr_diel / jnp.maximum(jnp.abs(lo[..., 2]), 1e-12))[..., None]
        li_glass = where3(choose_trans, li_trans, li_mirror)
        f_glass = where3(choose_trans, f_trans, f_glass_refl)
        pdf_glass = jnp.where(choose_trans, btdf_prob, 1.0 - btdf_prob)

    if has(MAT_PHONG):
        # --- PHONG lobe about the reflection -----------------------------
        li_phong, _ = _phong_sample(p["ns"], lo, u1, u2)

    # --- select the sampled direction per kind ---------------------------
    if has(MAT_DIFFUSE):
        li_sel.append((MAT_DIFFUSE, d_cos))
    if has(MAT_GLOSSY):
        li_sel.append((MAT_GLOSSY, li_glossy))
    if has(MAT_MIRROR):
        li_sel.append((MAT_MIRROR, li_mirror))
    if has(MAT_GLASS):
        li_sel.append((MAT_GLASS, li_glass))
    if has(MAT_PHONG):
        li_sel.append((MAT_PHONG, li_phong))
    if has(MAT_OREN_NAYAR):
        li_sel.append((MAT_OREN_NAYAR, d_cos))
    li = li_sel[0][1]
    for K, v in li_sel[1:]:
        li = where3(kind == K, v, li)

    wi = to_world(li, n)

    # f / pdf for the scattering kinds evaluated at the sampled direction.
    if need_cos:
        f_diff = _lambert_eval(p["kd"], lo, li)
        pdf_diff = jnp.where(
            lo[..., 2] * li[..., 2] > 0.0, cos_hemisphere_pdf(jnp.abs(li[..., 2])), 0.0
        )
    if has(MAT_DIFFUSE):
        f_sel.append((MAT_DIFFUSE, f_diff))
        pdf_sel.append((MAT_DIFFUSE, pdf_diff))
    if has(MAT_GLOSSY):
        f_glossy = 0.5 * (_ct_eval(p["ks"], p["ns"], lo, li)
                          + _lambert_eval(p["kd"], lo, li))
        pdf_glossy = 0.5 * (_ct_pdf(p["ns"], lo, li) + pdf_diff)
        f_sel.append((MAT_GLOSSY, f_glossy))
        pdf_sel.append((MAT_GLOSSY, pdf_glossy))
    if has(MAT_MIRROR):
        f_sel.append((MAT_MIRROR, f_mirror))
        pdf_sel.append((MAT_MIRROR, jnp.ones_like(lo[..., 2])))
    if has(MAT_GLASS):
        f_sel.append((MAT_GLASS, f_glass))
        pdf_sel.append((MAT_GLASS, pdf_glass))
    if has(MAT_PHONG):
        f_sel.append((MAT_PHONG, _phong_eval(p["ks"], p["ns"], lo, li)))
        pdf_sel.append((MAT_PHONG, _phong_pdf(p["ns"], lo, li)))
    if has(MAT_OREN_NAYAR):
        f_sel.append((MAT_OREN_NAYAR,
                      _oren_nayar_eval(p["kd"], p["ns"], lo, li)))
        pdf_sel.append((MAT_OREN_NAYAR, pdf_diff))

    f = jnp.zeros_like(p["kd"])
    for K, v in f_sel:
        f = where3(kind == K, v, f)
    pdf = jnp.zeros_like(lo[..., 2])
    for K, v in pdf_sel:
        pdf = jnp.where(kind == K, v, pdf)

    spec = is_specular(p)

    # Geometric-side consistency (bsdf.h:188-193): reflections must stay on
    # wo's geometric side, transmissions must cross.
    same_geom = dot(wo, gn) * dot(wi, gn) > 0.0
    if has(MAT_GLASS):
        is_transmission = (kind == MAT_GLASS) & choose_trans & ~tir
        side_ok = jnp.where(is_transmission, ~same_geom, same_geom)
    else:
        side_ok = same_geom
    valid = side_ok & (pdf > 0.0) & jnp.any(f != 0.0, axis=-1)

    return wi, f, pdf, spec, valid
