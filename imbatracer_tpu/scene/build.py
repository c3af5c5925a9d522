"""Scene building: .scene/OBJ/MTL assets -> DeviceScene.

Functional parity with the reference's build pipeline
(reference: frontend/build_scene.cpp:548-651):
  1. parse the .scene file (camera, meshes, lights, env, instances)
  2. per mesh: OBJ + MTL load, material conversion, attribute assembly
  3. instance expansion (we flatten to world space — see scene/types.py)
  4. triangle-light extraction per *instanced* emissive face
     (build_scene.cpp:616-626)
  5. BVH build + threading, bounding-sphere computation
  6. device upload (jnp conversion)

Material conversion rules mirror convert_materials
(build_scene.cpp:55-182): illum 5 -> MIRROR, illum 7 -> GLASS,
ks > 0 -> GLOSSY, else DIFFUSE; ke > 0 marks an emitter; map_kd/map_d/
map_bump resolve against the OBJ's directory; failed texture loads fall
back to magenta (build_scene.cpp:136,152).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

from ..accel.builder import build_bvh, triangle_bboxes
from ..accel.device import DeviceBvh
from ..accel.flatten import thread_bvh
from ..core import math3d
from ..io import image as image_io
from ..io import obj as obj_io
from ..io.scene_file import SceneDesc, parse_scene_file
from ..render import materials as mat_mod
from ..render import lights as light_mod
from ..render.envmap import build_envmap
from ..utils.cache import accel_cache_dir
from ..utils.log import logger
from .textures import pack_textures
from .types import DeviceScene, SceneMeta, TriAttrs, shade_columns

import jax.numpy as jnp  # noqa: E402


@dataclass
class HostMesh:
    """One loaded OBJ in object space (indexed, SoA)."""

    verts: np.ndarray       # (V, 3)
    normals: np.ndarray     # (V, 3) per-vertex shading normals
    uvs: np.ndarray         # (V, 2)
    tris: np.ndarray        # (T, 3) vertex indices
    mat_ids: np.ndarray     # (T,) global material ids


@dataclass
class HostSceneArrays:
    """Flat world-space arrays prior to device upload."""

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    attrs: dict
    materials: dict
    light_rows: list
    textures: list
    env_img: np.ndarray | None
    env_intensity: tuple
    bsphere_center: np.ndarray
    bsphere_radius: float


class MaterialConverter:
    """Global material/texture registry across all meshes in the scene."""

    def __init__(self, placeholder=image_io.magenta_placeholder):
        self.rows = []
        self.textures = []
        self._tex_ids = {}
        self._placeholder = placeholder
        # Slot 0: dummy diffuse for faces without a material
        # (build_scene.cpp:137-139 "Add a dummy material").
        self.add_default()

    def add_default(self):
        self.rows.append(
            dict(kind=mat_mod.MAT_DIFFUSE, kd=(1.0, 1.0, 1.0), ks=(0, 0, 0),
                 tf=(0, 0, 0), ns=1.0, ior=1.0, emit=(0, 0, 0),
                 kd_tex=-1, bump_tex=-1, mask_tex=-1)
        )
        return len(self.rows) - 1

    def load_texture(self, path: str) -> int:
        if path in self._tex_ids:
            return self._tex_ids[path]
        img = image_io.load_image(path)
        if img is None:
            logger.warning("texture load FAILED: %s", path)
            img = self._placeholder()
        tid = len(self.textures)
        self.textures.append(img)
        self._tex_ids[path] = tid
        return tid

    def convert(self, mtl: obj_io.ObjMaterial | None, base_dir: str) -> int:
        """One OBJ material -> material-table row id."""
        if mtl is None:
            return self.add_default()

        def tex(name):
            return self.load_texture(os.path.join(base_dir, name)) if name else -1

        kd_tex = tex(mtl.map_kd)
        bump_tex = tex(mtl.map_bump)
        mask_tex = tex(mtl.map_d)
        is_emissive = max(mtl.ke) > 0.0
        is_phong = max(mtl.ks) > 0.0

        if mtl.illum == 5:
            row = dict(kind=mat_mod.MAT_MIRROR, kd=(0, 0, 0), ks=mtl.ks,
                       tf=(0, 0, 0), ns=mtl.ns, ior=1.0)
        elif mtl.illum == 7:
            row = dict(kind=mat_mod.MAT_GLASS, kd=(0, 0, 0), ks=mtl.ks,
                       tf=mtl.tf, ns=1.0, ior=mtl.ni)
        elif is_phong:
            row = dict(kind=mat_mod.MAT_GLOSSY, kd=mtl.kd, ks=mtl.ks,
                       tf=(0, 0, 0), ns=mtl.ns, ior=1.0)
        else:
            row = dict(kind=mat_mod.MAT_DIFFUSE, kd=mtl.kd, ks=(0, 0, 0),
                       tf=(0, 0, 0), ns=1.0, ior=1.0)
        row.update(
            emit=mtl.ke if is_emissive else (0.0, 0.0, 0.0),
            kd_tex=kd_tex, bump_tex=bump_tex, mask_tex=mask_tex,
        )
        self.rows.append(row)
        return len(self.rows) - 1


def load_mesh(obj_path: str, conv: MaterialConverter) -> HostMesh:
    """Load one OBJ into an indexed HostMesh with global material ids."""
    base_dir = os.path.dirname(os.path.abspath(obj_path))
    f = obj_io.load_obj(obj_path)
    mtl_lib = {}
    for lib in f.mtl_libs:
        obj_io.load_mtl(os.path.join(base_dir, lib), mtl_lib)

    # Convert materials in usemtl order; name "" -> dummy slot 0.
    local_to_global = []
    for name in f.material_names:
        if name == "":
            local_to_global.append(0)
        else:
            local_to_global.append(conv.convert(mtl_lib.get(name), base_dir))

    # Dedupe (v, t, n) corner triples into a vertex buffer
    # (build_scene.cpp:24-51 HashIndex scheme, done with a dict here).
    corner_map = {}
    verts, uvs, norms = [], [], []
    tri_idx = []
    mat_ids = []
    any_normals = False
    for mat_local, (c0, c1, c2) in f.triangles:
        idx3 = []
        for c in (c0, c1, c2):
            key = c
            slot = corner_map.get(key)
            if slot is None:
                slot = len(verts)
                corner_map[key] = slot
                verts.append(f.vertices[c[0]])
                uvs.append(f.texcoords[c[1]])
                norms.append(f.normals[c[2]])
                if c[2] != 0:
                    any_normals = True
            idx3.append(slot)
        tri_idx.append(idx3)
        mat_ids.append(local_to_global[mat_local])

    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
    norms = np.asarray(norms, np.float32).reshape(-1, 3)
    tris = np.asarray(tri_idx, np.int32).reshape(-1, 3)
    mat_ids = np.asarray(mat_ids, np.int32)

    if not any_normals:
        norms = compute_vertex_normals(verts, tris)
    else:
        norms = repair_normals(verts, tris, norms)
    return HostMesh(verts=verts, normals=norms, uvs=uvs, tris=tris, mat_ids=mat_ids)


def compute_vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (reference: core/mesh.cpp:7-27)."""
    e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
    e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
    fn = np.cross(e1, e2)  # length = 2 * area -> area weighting for free
    out = np.zeros_like(verts)
    for k in range(3):
        np.add.at(out, tris[:, k], fn)
    ln = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(ln, 1e-20)


def repair_normals(verts, tris, norms) -> np.ndarray:
    """Replace NaN / zero-length shading normals with recomputed ones
    (reference: build_scene.cpp:592-606)."""
    ln = np.linalg.norm(norms, axis=-1, keepdims=True)
    bad = ~np.isfinite(ln[:, 0]) | (ln[:, 0] < 1e-12)
    norms = np.where(bad[:, None], 0.0, norms / np.maximum(ln, 1e-20))
    if bad.any():
        recomputed = compute_vertex_normals(verts, tris)
        norms[bad] = recomputed[bad]
    return norms


def flatten_instances(desc: SceneDesc, meshes: list[HostMesh], materials: list[dict]):
    """Expand instances into world-space flat triangle arrays, extracting a
    TriangleLight row per instanced emissive face (build_scene.cpp:616-626)."""
    v0s, v1s, v2s = [], [], []
    n0s, n1s, n2s = [], [], []
    uv0s, uv1s, uv2s = [], [], []
    mats, insts, locals_ = [], [], []
    light_rows = []
    light_ids = []

    emit_lookup = np.array(
        [max(m["emit"]) > 0.0 for m in materials], dtype=bool
    )

    for inst_id, inst in enumerate(desc.instances):
        mesh = meshes[inst.mesh_idx]
        m = math3d.instance_matrix(inst.pos, inst.scale, inst.rot)
        wv = math3d.transform_points(m, mesh.verts).astype(np.float32)
        wn = math3d.transform_normals(m, mesh.normals).astype(np.float32)
        t = mesh.tris
        a, b, c = wv[t[:, 0]], wv[t[:, 1]], wv[t[:, 2]]
        v0s.append(a)
        v1s.append(b)
        v2s.append(c)
        n0s.append(wn[t[:, 0]])
        n1s.append(wn[t[:, 1]])
        n2s.append(wn[t[:, 2]])
        uv0s.append(mesh.uvs[t[:, 0]])
        uv1s.append(mesh.uvs[t[:, 1]])
        uv2s.append(mesh.uvs[t[:, 2]])
        mats.append(mesh.mat_ids)
        insts.append(np.full(len(t), inst_id, np.int32))
        locals_.append(np.arange(len(t), dtype=np.int32))

        # Instanced emissive faces become per-face TRI lights.
        lid = np.full(len(t), -1, np.int32)
        emissive = emit_lookup[mesh.mat_ids]
        for ti in np.nonzero(emissive)[0]:
            intensity = materials[mesh.mat_ids[ti]]["emit"]
            normal = np.cross(b[ti] - a[ti], c[ti] - a[ti])
            area = 0.5 * np.linalg.norm(normal)
            if area < 1e-12:
                continue
            lid[ti] = len(light_rows)
            light_rows.append(
                dict(kind=light_mod.LIGHT_TRI, p0=a[ti], p1=b[ti], p2=c[ti],
                     normal=normal / (2.0 * area), intensity=intensity,
                     area=area)
            )
        light_ids.append(lid)

    cat = lambda xs: np.concatenate(xs, axis=0)
    attrs = dict(
        n0=cat(n0s), n1=cat(n1s), n2=cat(n2s),
        uv0=cat(uv0s), uv1=cat(uv1s), uv2=cat(uv2s),
        mat_id=cat(mats), light_id=cat(light_ids),
        inst_id=cat(insts), local_id=cat(locals_),
    )
    return cat(v0s), cat(v1s), cat(v2s), attrs, light_rows


def _scene_lights(desc: SceneDesc):
    """Parsed .scene lights -> table rows (build_scene.cpp:378-442)."""
    rows = []
    for l in desc.lights:
        p = l.params
        if l.kind == "point":
            rows.append(dict(kind=light_mod.LIGHT_POINT, p0=p[0:3], intensity=p[3:6]))
        elif l.kind == "dir":
            d = np.asarray(p[0:3], np.float32)
            d /= np.linalg.norm(d)
            rows.append(dict(kind=light_mod.LIGHT_DIR, normal=d, intensity=p[3:6]))
        elif l.kind == "spot":
            d = np.asarray(p[3:6], np.float32)
            d /= np.linalg.norm(d)
            # .scene angle is the full cone angle in degrees; the reference
            # halves it when constructing the light (build_scene.cpp:420-427).
            rows.append(
                dict(kind=light_mod.LIGHT_SPOT, p0=p[0:3], normal=d,
                     cos_angle=np.cos(np.deg2rad(p[6]) * 0.5), intensity=p[7:10])
            )
    return rows


def build_scene(scene_path: str, quiet: bool = False,
                spatial: bool = False):
    """Load + build everything. Returns (DeviceScene, SceneMeta).
    Instances are flattened to world space."""
    t_start = time.time()
    desc = parse_scene_file(scene_path)

    conv = MaterialConverter()
    meshes = []
    for mp in desc.mesh_paths:
        path = mp if os.path.isabs(mp) else os.path.join(desc.base_dir, mp)
        logger.info("loading mesh %s", path)
        meshes.append(load_mesh(path, conv))

    v0, v1, v2, attrs, light_rows = flatten_instances(desc, meshes, conv.rows)
    num_tris = v0.shape[0]
    logger.info("scene: %d world-space triangles, %d materials, %d textures",
                num_tris, len(conv.rows), len(conv.textures))

    # Scene lights from the .scene file go after the triangle lights.
    light_rows.extend(_scene_lights(desc))

    # Environment map.
    env = None
    env_img = None
    if desc.env_path:
        path = os.path.join(desc.base_dir, desc.env_path)
        env_img = image_io.load_image(path)
        if env_img is None:
            logger.warning("env map load failed: %s", path)
        else:
            env = build_envmap(env_img, desc.env_intensity)
            light_rows.append(dict(kind=light_mod.LIGHT_ENV, intensity=(1, 1, 1)))

    # Disk-cache the BVH next to the scene when writable (the reference's
    # `accel` mechanism; we key on asset fingerprints instead of trusting
    # the file blindly).
    from ..io import bvh_cache

    mesh_files = [
        mp if os.path.isabs(mp) else os.path.join(desc.base_dir, mp)
        for mp in desc.mesh_paths
    ]
    cache_key = bvh_cache.fingerprint(mesh_files + [scene_path])
    cache_file = ""
    cache_dir = accel_cache_dir()
    try:
        os.makedirs(cache_dir, exist_ok=True)
        cache_file = os.path.join(
            cache_dir, os.path.basename(scene_path) + "." + cache_key + ".npz"
        )
    except OSError:
        pass

    device_scene = assemble_device_scene(
        v0, v1, v2, attrs, conv.rows, light_rows, conv.textures, env,
        cache_file=cache_file, cache_key=cache_key, spatial=spatial,
    )
    has_masks = any(m["mask_tex"] >= 0 for m in conv.rows)
    has_bump = any(m["bump_tex"] >= 0 for m in conv.rows)
    meta = SceneMeta(
        name=os.path.basename(scene_path),
        num_tris=num_tris,
        num_materials=len(conv.rows),
        num_lights=len(light_rows),
        num_textures=len(conv.textures),
        has_env=env is not None,
        has_masks=has_masks,
        has_bump=has_bump,
        cam_pos=desc.cam_pos,
        cam_dir=desc.cam_dir,
        cam_up=desc.cam_up,
        bvh_stats=device_scene.bvh_stats,
    )
    logger.info("scene built in %.2fs", time.time() - t_start)
    return device_scene, meta


def _geom_normals(v0, v1, v2):
    n = np.cross(v1 - v0, v2 - v0)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def assemble_device_scene(v0, v1, v2, attrs, mat_rows, light_rows, textures, env,
                          cache_file: str = "", cache_key: str = "",
                          spatial: bool = False):
    """Shared tail of scene construction: BVH build + device upload.

    Used by both the file-based builder and procedural scenes
    (scene/procedural.py).  The returned DeviceScene gets a transient
    `bvh_stats` attribute for logging.  With cache_file set, the threaded
    BVH round-trips through the npz disk cache (io/bvh_cache.py), the
    analogue of the reference's `accel` files (loaders/load_bvh.cpp).
    """
    # Bounding sphere over all instanced geometry (scene.cpp:190-201).
    lo = np.minimum(np.minimum(v0.min(0), v1.min(0)), v2.min(0))
    hi = np.maximum(np.maximum(v0.max(0), v1.max(0)), v2.max(0))
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - center)) + 1e-6

    threaded = None
    if cache_file:
        from ..io import bvh_cache

        if spatial:
            cache_key = cache_key + ":sbvh"
        threaded = bvh_cache.load_accel(cache_file, cache_key)
        if threaded is not None:
            logger.info("BVH loaded from cache: %s", threaded.stats)
    if threaded is None:
        t_bvh = time.time()
        blo, bhi = triangle_bboxes(v0, v1, v2)
        if spatial:
            # Quality build: spatial splits (reference SplitBvhBuilder,
            # core/sbvh_builder.h) — native C++ (fast), NumPy fallback;
            # cached on disk either way.
            from ..accel.native import build_sbvh_native

            verts = np.stack([v0, v1, v2], axis=1)
            nodes = build_sbvh_native(verts)
            if nodes is None:
                from ..accel.sbvh import build_sbvh

                nodes = build_sbvh(blo, bhi, verts)
        else:
            # Native C++ builder (accel/cpp) with NumPy fallback.
            from ..accel.native import build_bvh_native

            nodes = build_bvh_native(blo, bhi)
            if nodes is None:
                nodes = build_bvh(blo, bhi)
        threaded = thread_bvh(nodes, v0, v1, v2)
        logger.info("BVH%s: %s in %.2fs", " (sbvh)" if spatial else "",
                    threaded.stats, time.time() - t_bvh)
        if cache_file:
            from ..io import bvh_cache

            bvh_cache.store_accel(cache_file, threaded, cache_key)

    arr = lambda key, dt=np.float32: np.asarray([m[key] for m in mat_rows], dt)
    M = len(mat_rows)
    mat_rec = np.zeros((M, 24), np.float32)
    mat_rec[:, 0] = arr("kind", np.int32).view(np.float32)
    mat_rec[:, 1:4] = arr("kd")
    mat_rec[:, 4:7] = arr("ks")
    mat_rec[:, 7:10] = arr("tf")
    mat_rec[:, 10] = arr("ns")
    mat_rec[:, 11] = arr("ior")
    mat_rec[:, 12:15] = arr("emit")
    mat_rec[:, 15] = arr("kd_tex", np.int32).view(np.float32)
    mat_rec[:, 16] = arr("bump_tex", np.int32).view(np.float32)
    mat_rec[:, 17] = arr("mask_tex", np.int32).view(np.float32)
    material_table = mat_mod.MaterialTable(
        rec=jnp.asarray(mat_rec),
        kind=jnp.asarray(arr("kind", np.int32)),
        kd=jnp.asarray(arr("kd")), ks=jnp.asarray(arr("ks")),
        tf=jnp.asarray(arr("tf")), ns=jnp.asarray(arr("ns")),
        ior=jnp.asarray(arr("ior")), emit=jnp.asarray(arr("emit")),
        kd_tex=jnp.asarray(arr("kd_tex", np.int32)),
        bump_tex=jnp.asarray(arr("bump_tex", np.int32)),
        mask_tex=jnp.asarray(arr("mask_tex", np.int32)),
    )

    gn = _geom_normals(v0, v1, v2)
    F = v0.shape[0]
    attr_rec = np.zeros((F, 24), np.float32)
    attr_rec[:, 0:3] = attrs["n0"]
    attr_rec[:, 3:6] = attrs["n1"]
    attr_rec[:, 6:9] = attrs["n2"]
    attr_rec[:, 9:12] = gn
    attr_rec[:, 12:14] = attrs["uv0"]
    attr_rec[:, 14:16] = attrs["uv1"]
    attr_rec[:, 16:18] = attrs["uv2"]
    attr_rec[:, 18] = attrs["mat_id"].astype(np.int32).view(np.float32)
    attr_rec[:, 19] = attrs["light_id"].astype(np.int32).view(np.float32)
    attr_rec[:, 20] = attrs["inst_id"].astype(np.int32).view(np.float32)
    attr_rec[:, 21] = attrs["local_id"].astype(np.int32).view(np.float32)

    # Combined shade record: triangle attributes JOINED with the material
    # row and per-face emitter data, so a hit needs exactly ONE gather.
    # Layout documented at scene/types.py TriAttrs.shade_rec.
    mid = attrs["mat_id"]
    lid = attrs["light_id"]
    tri_area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    shade_rec = np.zeros((F, 48), np.float32)
    shade_rec[:, 0:22] = attr_rec[:, 0:22]
    shade_rec[:, 22] = arr("kind", np.int32)[mid].view(np.float32)
    shade_rec[:, 23:26] = arr("kd")[mid]
    shade_rec[:, 26:29] = arr("ks")[mid]
    shade_rec[:, 29:32] = arr("tf")[mid]
    shade_rec[:, 32] = arr("ns")[mid]
    shade_rec[:, 33] = arr("ior")[mid]
    shade_rec[:, 34:37] = arr("emit")[mid]
    shade_rec[:, 37] = np.where(lid >= 0, tri_area, 0.0).astype(np.float32)
    shade_rec[:, 38] = arr("kd_tex", np.int32)[mid].view(np.float32)
    shade_rec[:, 39] = arr("bump_tex", np.int32)[mid].view(np.float32)
    shade_rec[:, 40] = arr("mask_tex", np.int32)[mid].view(np.float32)

    # Static per-scene specialization facts (DeviceScene.mat_kinds /
    # .light_kinds): the kind sets present, so the hot paths compile only
    # those formula blocks.  IMBA_SPEC=0 turns it off (compile-everything).
    if os.environ.get("IMBA_SPEC", "1") != "0":
        mat_kinds = tuple(sorted({int(m["kind"]) for m in mat_rows}))
        light_kinds = (tuple(sorted({int(r["kind"]) for r in light_rows}))
                       or (light_mod.LIGHT_POINT,))  # dummy black point light
    else:
        mat_kinds, light_kinds = (), ()

    # Drop shade_rec columns no consumer can read (scene/types.py::
    # shade_columns): the one-hot record fetch pays per column.
    shade_cols = shade_columns(
        mat_kinds,
        has_textures=len(textures) > 0,
        has_bump=bool((arr("bump_tex", np.int32) >= 0).any()),
        has_masks=bool((arr("mask_tex", np.int32) >= 0).any()),
    )
    shade_rec = shade_rec[:, list(shade_cols)]

    atlas = pack_textures(textures)

    # Narrow mask record (TriAttrs.mask_rec): pre-join the whole
    # alpha-test gather chain (tri -> material -> atlas geometry) into
    # one row per triangle so traversal alpha tests cost two gathers.
    mask_tex_tri = arr("mask_tex", np.int32)[mid]
    mask_rec = None
    if (mask_tex_tri >= 0).any():
        a_off = np.asarray(atlas.offset, np.int32)
        a_w = np.asarray(atlas.width, np.int32)
        a_h = np.asarray(atlas.height, np.int32)
        mt = np.maximum(mask_tex_tri, 0)
        mask_rec = np.zeros((F, 10), np.float32)
        mask_rec[:, 0] = mask_tex_tri.view(np.float32)
        mask_rec[:, 1] = a_w[mt].view(np.float32)
        mask_rec[:, 2] = a_h[mt].view(np.float32)
        mask_rec[:, 3] = a_off[mt].view(np.float32)
        mask_rec[:, 4:6] = attrs["uv0"]
        mask_rec[:, 6:8] = attrs["uv1"]
        mask_rec[:, 8:10] = attrs["uv2"]

    scene = DeviceScene(
        mat_kinds=mat_kinds,
        light_kinds=light_kinds,
        bvh=DeviceBvh.from_threaded(threaded),
        attrs=TriAttrs(
            rec=jnp.asarray(attr_rec),
            shade_rec=jnp.asarray(shade_rec),
            shade_cols=shade_cols,
            n0=jnp.asarray(attrs["n0"]), n1=jnp.asarray(attrs["n1"]),
            n2=jnp.asarray(attrs["n2"]), uv0=jnp.asarray(attrs["uv0"]),
            uv1=jnp.asarray(attrs["uv1"]), uv2=jnp.asarray(attrs["uv2"]),
            gn=jnp.asarray(gn),
            mat_id=jnp.asarray(attrs["mat_id"]),
            light_id=jnp.asarray(attrs["light_id"]),
            inst_id=jnp.asarray(attrs["inst_id"]),
            local_id=jnp.asarray(attrs["local_id"]),
            mask_rec=(None if mask_rec is None else jnp.asarray(mask_rec)),
        ),
        materials=material_table,
        lights=light_mod.build_light_table(light_rows),
        textures=atlas,
        bsphere=light_mod.BSphere(
            center=jnp.asarray(center, jnp.float32),
            radius=jnp.asarray(radius, jnp.float32),
            inv_radius_sqr=jnp.asarray(1.0 / (radius * radius), jnp.float32),
        ),
        env=env,
    )
    object.__setattr__(scene, "bvh_stats", threaded.stats)
    return scene
