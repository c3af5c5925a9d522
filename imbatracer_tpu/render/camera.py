"""Pinhole camera, matching the reference's raster conventions.

Reference: render/ray_gen/camera.h:27-98.  Conventions reproduced exactly
(including its quirks) so golden-image comparisons and the VCM pdf
conversions line up:

- `fov` is the *horizontal* field of view in degrees; the image-plane
  distance in pixel units is `d_img = width / (2 tan(fov/2))`
  (camera.h:53-54).
- The camera basis is right = normalize(cross(dir, up)),
  down = cross(dir, right); raster y grows downward.
- With the reference's default aspect of 1 (frontend/main.cpp:104), the
  vertical image-plane half-extent equals the horizontal one, so pixel
  (x, y) maps to plane offsets a = x - w/2 (right) and
  b = (w/h)(y - h/2) (down).  Pixel area on the plane is w/h, which the
  reference treats as 1 in its pdf conversions; we keep the same
  convention for parity.

Instead of 4x4 matrix pairs we carry the orthonormal basis directly --
cheaper and exact under jit.
"""

from __future__ import annotations

from ..core import pytree
import jax.numpy as jnp
import numpy as np

from ..core.vecmath import dot, normalize


@pytree.dataclass
class Camera:
    pos: jnp.ndarray        # (3,)
    forward: jnp.ndarray    # (3,) unit
    right: jnp.ndarray      # (3,) unit
    down: jnp.ndarray       # (3,) unit
    img_plane_dist: jnp.ndarray  # scalar, pixel units
    width: int = pytree.static_field()
    height: int = pytree.static_field()


def make_camera(pos, direction, up, width: int, height: int, fov_deg: float) -> Camera:
    pos = np.asarray(pos, np.float64)
    f = np.asarray(direction, np.float64)
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)  # points down in image space (camera.h:29-30 order)
    img_plane_dist = width / (2.0 * np.tan(np.deg2rad(fov_deg) * 0.5))
    return Camera(
        pos=jnp.asarray(pos, jnp.float32),
        forward=jnp.asarray(f, jnp.float32),
        right=jnp.asarray(r, jnp.float32),
        down=jnp.asarray(d, jnp.float32),
        img_plane_dist=jnp.asarray(img_plane_dist, jnp.float32),
        width=int(width),
        height=int(height),
    )


def generate_ray(cam: Camera, raster_x, raster_y):
    """Primary ray through raster position (x, y); returns (org, dir)."""
    a = raster_x - 0.5 * cam.width
    b = (cam.width / cam.height) * (raster_y - 0.5 * cam.height)
    p = (
        cam.forward * cam.img_plane_dist
        + cam.right * a[..., None]
        + cam.down * b[..., None]
    )
    d = normalize(p)
    org = jnp.broadcast_to(cam.pos, d.shape)
    return org, d


def world_to_raster(cam: Camera, world_pos):
    """Project world points to raster coords (camera.h:71-74).

    Returns (raster_x, raster_y, depth_along_forward)."""
    dp = world_pos - cam.pos
    depth = dot(dp, cam.forward)
    safe = jnp.where(jnp.abs(depth) < 1e-8, 1e-8, depth)
    a = dot(dp, cam.right) * cam.img_plane_dist / safe
    b = dot(dp, cam.down) * cam.img_plane_dist / safe
    rx = 0.5 * cam.width + a
    ry = 0.5 * cam.height + (cam.height / cam.width) * b
    return rx, ry, depth


def raster_to_id(cam: Camera, rx, ry):
    """Raster position -> pixel id, -1 outside (camera.h:81-90)."""
    x = jnp.floor(rx).astype(jnp.int32)
    y = jnp.floor(ry).astype(jnp.int32)
    inside = (x >= 0) & (x < cam.width) & (y >= 0) & (y < cam.height)
    return jnp.where(inside, y * cam.width + x, -1)
