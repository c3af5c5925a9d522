"""Texture atlas: all scene textures packed into one flat texel buffer.

The reference keeps one `TextureSampler` object per texture with virtual
lookups (reference: render/texture_sampler.h:11-47).  Here all textures
live in a single (T, 3) texel array plus per-texture descriptors
(offset/width/height — the same trick the reference uses for its packed
`MaskBuffer`, core/mask.h:29-40), so a batch of rays with *different*
textures resolves with plain gathers.

Sampling semantics match TextureSampler::sample exactly: repeat wrap,
v flipped, bilinear over a (w-1, h-1) grid with wrap-around top neighbour.
"""

from __future__ import annotations

from ..core import pytree
import jax.numpy as jnp
import numpy as np


@pytree.dataclass
class TextureAtlas:
    texels: jnp.ndarray  # (T, 3) f32
    offset: jnp.ndarray  # (K,) i32
    width: jnp.ndarray   # (K,) i32
    height: jnp.ndarray  # (K,) i32


def pack_textures(images: list[np.ndarray]) -> TextureAtlas:
    """Pack a list of (H, W, >=3) float images into one atlas."""
    if not images:
        images = [np.ones((1, 1, 3), np.float32)]
    offs, ws, hs, bufs = [], [], [], []
    cursor = 0
    for img in images:
        h, w = img.shape[:2]
        offs.append(cursor)
        ws.append(w)
        hs.append(h)
        bufs.append(np.asarray(img[..., :3], np.float32).reshape(-1, 3))
        cursor += w * h
    return TextureAtlas(
        texels=jnp.asarray(np.concatenate(bufs, axis=0)),
        offset=jnp.asarray(np.asarray(offs, np.int32)),
        width=jnp.asarray(np.asarray(ws, np.int32)),
        height=jnp.asarray(np.asarray(hs, np.int32)),
    )


def _wrap_uv(u, v):
    """Repeat wrap + v flip (texture_sampler.h:19-23)."""
    u = u - jnp.floor(u)
    v = v - jnp.floor(v)
    v = 1.0 - v
    return u, v


def sample_bilinear(atlas: TextureAtlas, tex_id: jnp.ndarray, u, v):
    """Bilinear sample; tex_id < 0 returns white (no texture)."""
    tid = jnp.maximum(tex_id, 0)
    w = atlas.width[tid]
    h = atlas.height[tid]
    off = atlas.offset[tid]
    u, v = _wrap_uv(u, v)
    kx = u * (w - 1).astype(jnp.float32)
    ky = v * (h - 1).astype(jnp.float32)
    x0 = kx.astype(jnp.int32)
    y0 = ky.astype(jnp.int32)
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h
    gx = (kx - jnp.floor(kx))[..., None]
    gy = (ky - jnp.floor(ky))[..., None]
    i00 = atlas.texels[off + y0 * w + x0]
    i10 = atlas.texels[off + y0 * w + x1]
    i01 = atlas.texels[off + y1 * w + x0]
    i11 = atlas.texels[off + y1 * w + x1]
    val = (1 - gy) * ((1 - gx) * i00 + gx * i10) + gy * ((1 - gx) * i01 + gx * i11)
    return jnp.where((tex_id >= 0)[..., None], val, 1.0)


def sample_mask(atlas: TextureAtlas, tex_id: jnp.ndarray, u, v):
    """Binary transparency lookup, nearest neighbour: opaque where the
    texel is non-black (core/mask.h:33-40 binarisation).  tex_id < 0 is
    always opaque."""
    tid = jnp.maximum(tex_id, 0)
    w = atlas.width[tid]
    h = atlas.height[tid]
    off = atlas.offset[tid]
    u, v = _wrap_uv(u, v)
    x = jnp.clip((u * w.astype(jnp.float32)).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h.astype(jnp.float32)).astype(jnp.int32), 0, h - 1)
    texel = atlas.texels[off + y * w + x]
    opaque = jnp.sum(texel, axis=-1) > 0.0
    return opaque | (tex_id < 0)
