"""Device-resident scene representation (one pytree, fully SoA).

Replaces the reference's `Scene` object (reference: render/scene.h:29-141)
— its mesh/instance/material/light containers and `anydsl::Array` device
buffers — with flat jnp arrays.  Instances are resolved at build time into
world-space triangles (regular data instead of per-ray transform
indirection; the per-triangle
`inst_id`/`local_tri_id` mapping the reference reconstructs at shading
time, scene.h:81-83, is kept as explicit arrays).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core import pytree
import jax.numpy as jnp

from ..accel.device import DeviceBvh
from ..render.envmap import EnvMapData
from ..render.lights import BSphere, LightTable
from ..render.materials import MaterialTable
from .textures import TextureAtlas


@pytree.dataclass
class TriAttrs:
    """Per flat (world-space) triangle shading attributes.

    `rec` is the wide-record view read by the hot path (one fast (R, 24)
    gather per hit instead of ~10 narrow ones):
      [n0(0:3), n1(3:6), n2(6:9), gn(9:12), uv0(12:14), uv1(14:16),
       uv2(16:18), mat_id(18, i32 bits), light_id(19, i32 bits),
       inst_id(20, i32 bits), local_id(21, i32 bits), pad(22:24)]
    """

    rec: jnp.ndarray      # (F, 24) f32 wide record (layout above)
    # shade_rec: rec[0:22] joined with the triangle's material row and
    # emitter data so one gather serves the whole shading step.  CANONICAL
    # column meanings (before pruning):
    #   [.. rec cols 0..21 .., kind(22), kd(23:26), ks(26:29), tf(29:32),
    #    ns(32), ior(33), emit(34:37), area(37), kd_tex(38), bump_tex(39),
    #    mask_tex(40), pad..48]  (integer cols are i32 bit patterns)
    # The stored array keeps only the columns the scene's shading step can
    # consume (see shade_columns below): `shade_cols[i]` names the
    # canonical column stored at position i.  Consumers (surface.
    # make_interaction) look positions up through this static tuple and
    # substitute cheap varying zeros for absent columns — bit-exact, since
    # absent columns feed only statically-absent formula blocks.
    shade_rec: jnp.ndarray  # (F, len(shade_cols)) f32 combined record
    n0: jnp.ndarray       # (F, 3) shading normal at vert 0
    n1: jnp.ndarray       # (F, 3)
    n2: jnp.ndarray       # (F, 3)
    uv0: jnp.ndarray      # (F, 2)
    uv1: jnp.ndarray      # (F, 2)
    uv2: jnp.ndarray      # (F, 2)
    gn: jnp.ndarray       # (F, 3) geometric normal
    mat_id: jnp.ndarray   # (F,) i32
    light_id: jnp.ndarray  # (F,) i32, -1 unless the triangle is an emitter
    inst_id: jnp.ndarray  # (F,) i32 source instance
    local_id: jnp.ndarray  # (F,) i32 triangle id within the source mesh
    # Narrow per-triangle mask record for alpha-masked traversal, or None
    # for mask-free scenes.  Masked traversal alpha-tests every candidate
    # hit, and each test would otherwise chain ~6 dependent gathers
    # (22-col shade row -> material row -> 3 atlas-geometry rows ->
    # texel), so the chain is pre-joined at build into ONE row per
    # triangle:
    #   [mask_tex(0, i32 bits), atlas w(1)/h(2)/offset(3, i32 bits),
    #    uv0(4:6), uv1(6:8), uv2(8:10)]
    # alpha tests become exactly two gathers (row + texel).
    mask_rec: Optional[jnp.ndarray] = None  # (F, 10) f32
    # Static (pytree-aux): canonical shade_rec column ids actually stored,
    # in order (see the shade_rec comment above).
    shade_cols: tuple = pytree.static_field(default=tuple(range(48)))


def shade_columns(mat_kinds: tuple, has_textures: bool, has_bump: bool,
                  has_masks: bool) -> tuple:
    """Static shade_rec column subset the shading step can consume.

    The per-hit record gather moves every stored COLUMN, so columns no
    consumer can read are pure cost.  Unconditionally dead:
    inst/local ids (20, 21; kept in TriAttrs.rec for tooling) and the pad
    (41:47).  Conditionally dead, keyed on the same static facts that
    drive kind specialization: uv + texture ids without textures, ks/tf/
    ns/ior when no present material kind reads them (see
    render/materials.py formula blocks).  `mat_kinds == ()` means
    "unknown" — keep every kind-dependent column.  IMBA_PRUNE=0 restores
    the full canonical layout (A/B control)."""
    import os

    if os.environ.get("IMBA_PRUNE", "1") == "0":
        return tuple(range(48))
    kinds = set(mat_kinds) if mat_kinds else {0, 1, 2, 3, 4, 5}
    cols = list(range(12))                    # n0 n1 n2 gn
    if has_textures or has_masks:
        cols += list(range(12, 18))           # uv0 uv1 uv2
    cols += [18, 19]                          # mat_id, light_id
    cols += [22, 23, 24, 25]                  # kind, kd
    if kinds & {1, 2, 3, 4}:                  # mirror/glass/glossy/phong
        cols += [26, 27, 28]                  # ks
    if 2 in kinds:                            # glass
        cols += [29, 30, 31]                  # tf
    if kinds & {1, 3, 4, 5}:                  # exponent / kappa / sigma
        cols += [32]                          # ns
    if 2 in kinds:
        cols += [33]                          # ior
    cols += [34, 35, 36, 37]                  # emit, area
    if has_textures:
        cols += [38]                          # kd_tex
    if has_bump and has_textures:
        cols += [39]                          # bump_tex
    if has_masks:
        cols += [40]                          # mask_tex
    return tuple(cols)


@pytree.dataclass
class DeviceScene:
    bvh: DeviceBvh
    attrs: TriAttrs
    materials: MaterialTable
    lights: LightTable
    textures: TextureAtlas
    bsphere: BSphere
    env: Optional[EnvMapData] = None
    # Static (pytree-aux) per-scene specialization facts: the sets of
    # material / light kinds present, as sorted tuples.  Hot paths pass
    # them to materials/lights entry points so XLA never traces formula
    # blocks for kinds the scene doesn't contain (the analogue of the
    # reference's per-material AnyDSL kernel specialization).  `()` means
    # "unknown — compile everything" (always correct).
    mat_kinds: tuple = pytree.static_field(default=())
    light_kinds: tuple = pytree.static_field(default=())

    @property
    def num_lights(self):
        return self.lights.kind.shape[0]


@dataclass
class SceneMeta:
    """Host-side static facts about a built scene."""

    name: str = ""
    num_tris: int = 0
    num_materials: int = 0
    num_lights: int = 0
    num_textures: int = 0
    has_env: bool = False
    has_masks: bool = False
    has_bump: bool = False
    cam_pos: tuple = (0.0, 0.0, 0.0)
    cam_dir: tuple = (0.0, 0.0, -1.0)
    cam_up: tuple = (0.0, 1.0, 0.0)
    bvh_stats: dict = None
