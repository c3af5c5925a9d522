"""The local pytree-dataclass helper (core/pytree.py) on every scene and
render struct: children flatten and rebuild, static fields live in the
treedef, `.replace` copies, instances are frozen, and jit passes them
through."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from imbatracer_tpu.core import pytree


@pytest.fixture(scope="module")
def structs():
    from imbatracer_tpu.frontend.renderer import (RenderSettings,
                                                  camera_for_scene)
    from imbatracer_tpu.render.hashgrid import build_hash_grid
    from imbatracer_tpu.render.light_cache import empty_cache
    from imbatracer_tpu.scene.procedural import make_still_life_like

    scene, meta = make_still_life_like(num_objects=20, num_cards=4)
    pos = jnp.asarray(np.random.RandomState(0).rand(64, 3), jnp.float32)
    return {
        "DeviceScene": scene,
        "DeviceBvh": scene.bvh,
        "TriAttrs": scene.attrs,
        "MaterialTable": scene.materials,
        "LightTable": scene.lights,
        "TextureAtlas": scene.textures,
        "BSphere": scene.bsphere,
        "EnvMapData": scene.env,
        "Camera": camera_for_scene(meta, RenderSettings(width=8, height=6)),
        "HashGrid": build_hash_grid(pos, jnp.ones(64, bool), 0.1, 128),
        "LightVertexCache": empty_cache(16),
    }


NAMES = ["DeviceScene", "DeviceBvh", "TriAttrs", "MaterialTable",
         "LightTable", "TextureAtlas", "BSphere", "EnvMapData", "Camera",
         "HashGrid", "LightVertexCache"]


@pytest.mark.parametrize("name", NAMES)
def test_struct_is_a_pytree(structs, name):
    obj = structs[name]
    assert type(obj).__name__ == name
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    assert leaves and all(isinstance(x, jax.Array) for x in leaves)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(obj)
    static = [f.name for f in dataclasses.fields(obj)
              if f.metadata.get("static")]
    for f in dataclasses.fields(obj):
        a, b = getattr(obj, f.name), getattr(back, f.name)
        if f.name in static:
            assert a == b
        else:
            assert jax.tree_util.tree_structure(a) == \
                jax.tree_util.tree_structure(b)
    # Frozen, with a copying .replace.
    first = dataclasses.fields(obj)[0].name
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, first, None)
    assert obj.replace().__class__ is type(obj)
    # jit passes it through unchanged.
    out = jax.jit(lambda s: s)(obj)
    for x, y in zip(jax.tree_util.tree_leaves(out), leaves):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_static_fields_are_in_the_treedef():
    @pytree.dataclass
    class S:
        x: jnp.ndarray
        n: int = pytree.static_field(default=3)

    a, b = S(jnp.ones(2)), S(jnp.ones(2), n=4)
    assert jax.tree_util.tree_leaves(a) == [a.x]
    assert (jax.tree_util.tree_structure(a)
            != jax.tree_util.tree_structure(b))
    c = a.replace(n=5)
    assert c.n == 5 and a.n == 3 and c.x is a.x
    traces = []

    @jax.jit
    def f(s):
        traces.append(s.n)
        return s.x * s.n

    np.testing.assert_array_equal(np.asarray(f(a)), [3.0, 3.0])
    np.testing.assert_array_equal(np.asarray(f(b)), [4.0, 4.0])
    assert traces == [3, 4]
