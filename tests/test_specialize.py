"""Per-scene kind specialization must be exact.

materials/lights entry points take a static `kinds` tuple (the set of
material/light kinds the scene contains, DeviceScene.mat_kinds /
.light_kinds); absent kinds' formula blocks are never traced.  The
contract: for every lane whose kind IS in `kinds`, every output equals
the unspecialized (kinds=()) call — bitwise for the material chains
(whose select structure survives specialization), and up to XLA
FMA-contraction noise (<=4e-6 relative) for the light chains where a
single-kind scene drops the select entirely.  This is the analogue
of the reference compiling one shading kernel per material set via
AnyDSL (reference: render/materials/materials.h virtual dispatch ->
per-kind formula blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from imbatracer_tpu.render import lights as light_mod
from imbatracer_tpu.render import materials as mat


def _rand_unit(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _params(rng, n, kinds):
    kind_pool = np.asarray(kinds, np.int32)
    kinds_arr = kind_pool[rng.integers(0, len(kind_pool), n)]
    return mat.MatParams(
        kind=jnp.asarray(kinds_arr),
        kd=jnp.asarray(rng.random((n, 3), dtype=np.float32)),
        ks=jnp.asarray(rng.random((n, 3), dtype=np.float32)),
        tf=jnp.asarray(rng.random((n, 3), dtype=np.float32)),
        ns=jnp.asarray(1.0 + 200.0 * rng.random(n, dtype=np.float32)),
        ior=jnp.asarray(1.1 + rng.random(n, dtype=np.float32)),
        emit=jnp.zeros((n, 3), jnp.float32),
        kd_tex=jnp.full((n,), -1, jnp.int32),
        bump_tex=jnp.full((n,), -1, jnp.int32),
        mask_tex=jnp.full((n,), -1, jnp.int32),
    )


MAT_SUBSETS = [
    (mat.MAT_DIFFUSE,),
    (mat.MAT_MIRROR,),
    (mat.MAT_GLASS,),
    (mat.MAT_GLOSSY,),
    (mat.MAT_PHONG,),
    (mat.MAT_OREN_NAYAR,),
    (mat.MAT_DIFFUSE, mat.MAT_MIRROR, mat.MAT_GLASS),
    (mat.MAT_DIFFUSE, mat.MAT_GLOSSY, mat.MAT_OREN_NAYAR),
    tuple(range(6)),
]


@pytest.mark.parametrize("kinds", MAT_SUBSETS)
def test_material_specialization_bitwise(kinds):
    rng = np.random.default_rng(hash(kinds) % 2**31)
    n = 4096
    p = _params(rng, n, kinds)
    nrm = jnp.asarray(_rand_unit(rng, n))
    gn_np = _rand_unit(rng, n)
    mix = rng.random(n) < 0.7
    gn = jnp.asarray(np.where(mix[:, None], np.asarray(nrm), gn_np))
    wo = jnp.asarray(_rand_unit(rng, n))
    wi = jnp.asarray(_rand_unit(rng, n))
    u1 = jnp.asarray(rng.random(n, dtype=np.float32))
    u2 = jnp.asarray(rng.random(n, dtype=np.float32))
    u3 = jnp.asarray(rng.random(n, dtype=np.float32))

    def run(k):
        outs = []
        outs += list(mat.eval_pdf_bsdf(p, nrm, gn, wo, wi, kinds=k))
        outs.append(mat.eval_bsdf(p, nrm, gn, wo, wi, kinds=k))
        outs.append(mat.pdf_bsdf(p, nrm, gn, wo, wi, kinds=k))
        outs += list(mat.sample_bsdf(p, nrm, gn, wo, u1, u2, u3, kinds=k))
        return outs

    full = jax.jit(lambda: run(()))()
    spec = jax.jit(lambda: run(tuple(kinds)))()
    for i, (a, b) in enumerate(zip(full, spec)):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=f"output {i} kinds={kinds}")


def _light_table(rows):
    return light_mod.build_light_table(rows)


def _light_rows(kinds, rng):
    rows = []
    for k in kinds:
        for _ in range(2):
            p0 = rng.random(3).astype(np.float32) * 4 - 2
            p1 = p0 + rng.random(3).astype(np.float32)
            p2 = p0 + rng.random(3).astype(np.float32)
            nrm = np.cross(p1 - p0, p2 - p0)
            nrm = nrm / max(np.linalg.norm(nrm), 1e-9)
            rows.append(dict(
                kind=k, p0=p0, p1=p1, p2=p2, normal=nrm.astype(np.float32),
                intensity=rng.random(3).astype(np.float32) * 5,
                area=float(0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0))),
                cos_angle=float(0.5 + 0.4 * rng.random()),
            ))
    return rows


LIGHT_SUBSETS = [
    (light_mod.LIGHT_TRI,),
    (light_mod.LIGHT_POINT,),
    (light_mod.LIGHT_DIR,),
    (light_mod.LIGHT_SPOT,),
    (light_mod.LIGHT_TRI, light_mod.LIGHT_POINT),
    (light_mod.LIGHT_TRI, light_mod.LIGHT_POINT, light_mod.LIGHT_DIR,
     light_mod.LIGHT_SPOT),
]


@pytest.mark.parametrize("kinds", LIGHT_SUBSETS)
def test_light_specialization_bitwise(kinds):
    rng = np.random.default_rng(sum(kinds) + 11)
    rows = _light_rows(kinds, rng)
    table = _light_table(rows)
    n = 2048
    li = jnp.asarray(rng.integers(0, len(rows), n).astype(np.int32))
    from_pos = jnp.asarray(rng.random((n, 3), dtype=np.float32) * 6 - 3)
    u = [jnp.asarray(rng.random(n, dtype=np.float32)) for _ in range(4)]
    bs = light_mod.BSphere(
        center=jnp.zeros(3, jnp.float32), radius=jnp.float32(5.0),
        inv_radius_sqr=jnp.float32(1.0 / 25.0))

    def run(k):
        ds = light_mod.sample_direct(table, li, from_pos, u[0], u[1], bs,
                                     env=None, kinds=k)
        es = light_mod.sample_emit(table, li, u[0], u[1], u[2], u[3], bs,
                                   env=None, kinds=k)
        return list(ds) + list(es)

    full = jax.jit(lambda: run(()))()
    spec = jax.jit(lambda: run(tuple(kinds)))()
    # Not bitwise: dropping a select changes XLA's FMA-contraction
    # decisions inside the surviving kind's formula block (measured
    # <=4e-6 relative on CPU).  The algebra is identical.
    for i, (a, b) in enumerate(zip(full, spec)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-6,
            err_msg=f"output {i} kinds={kinds}")


@pytest.mark.parametrize("algo", ["pt", "vcm"])
def test_end_to_end_specialization(algo):
    """Rendering with DeviceScene.mat_kinds/.light_kinds populated must
    match the compile-everything scene: the integrators' wiring passes
    the static kinds through every BSDF/light call site."""
    from imbatracer_tpu.frontend.engine import make_frame_fn
    from imbatracer_tpu.frontend.renderer import RenderSettings
    from imbatracer_tpu.scene.procedural import make_cornell_scene

    scene, meta = make_cornell_scene(with_boxes=True)
    assert scene.mat_kinds, "builder did not populate mat_kinds"
    assert scene.light_kinds, "builder did not populate light_kinds"
    size = 32
    settings = RenderSettings(width=size, height=size, algorithm=algo,
                              max_path_len=4, light_path_count=256, spp=1)

    def render(s):
        frame_fn, _ = make_frame_fn(s, meta, settings)
        return np.asarray(frame_fn(jnp.uint32(1)))

    spec = render(scene)
    full = render(scene.replace(mat_kinds=(), light_kinds=()))
    np.testing.assert_allclose(spec, full, rtol=2e-4, atol=1e-5)


def test_specialized_graph_is_smaller():
    """The point of the exercise: a diffuse-only sample_bsdf graph must not
    contain the power/Fresnel chains of the absent kinds."""
    rng = np.random.default_rng(3)
    n = 128
    p = _params(rng, n, (mat.MAT_DIFFUSE,))
    nrm = jnp.asarray(_rand_unit(rng, n))
    wo = jnp.asarray(_rand_unit(rng, n))
    u = [jnp.asarray(rng.random(n, dtype=np.float32)) for _ in range(3)]

    def graph(k):
        f = jax.jit(lambda: mat.sample_bsdf(p, nrm, nrm, wo, *u, kinds=k))
        return f.lower().as_text()

    full = graph(())
    spec = graph((mat.MAT_DIFFUSE,))
    # Blinn/Phong exponentiation lowers through pow/log; diffuse-only needs
    # neither.
    assert full.count("pow") > spec.count("pow")
    assert len(spec) < 0.7 * len(full)
