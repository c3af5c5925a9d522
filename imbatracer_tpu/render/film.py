"""Film accumulation and tone mapping.

The reference accumulates with per-pixel CAS loops into an AtomicImage
(reference: core/atomic_vector.h:10-75, integrator.h:44-47); here the
same operation is a deterministic `segment_sum` over pixel ids — no
atomics, no races, bitwise reproducible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def splat(contrib: jnp.ndarray, pixel_id: jnp.ndarray, num_pixels: int) -> jnp.ndarray:
    """Scatter-add (R, 3) contributions into an (num_pixels, 3) film.

    pixel_id < 0 (terminated / out-of-image splats, camera.h:81-90) are
    dropped by routing them to a trash segment.
    """
    pid = jnp.where(pixel_id >= 0, pixel_id, num_pixels)
    film = jax.ops.segment_sum(contrib, pid, num_segments=num_pixels + 1)
    return film[:num_pixels]


def tonemap(film: jnp.ndarray, weight: float, gamma: float = 1.0 / 2.2) -> jnp.ndarray:
    """`pow(v * weight, gamma)` clamp to [0,1] (reference: store_png.h:34-49,
    frontend display path render_window.cpp:99-121)."""
    v = jnp.power(jnp.clip(film * weight, 0.0, None), gamma)
    return jnp.clip(v, 0.0, 1.0)
