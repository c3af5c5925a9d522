"""Device-resident BVH arrays (jnp pytree) + host->device conversion.

Plays the role of the reference's one-time accel upload
(reference: render/scene.cpp:119-188, `upload_mesh_accels` via
`anydsl_copy`).  One layout serves every traversal route
(render/traverse.py): the fused node+leaf records `nodes64` and, when
built, their octant-ordered copy `nodes64o`.  The packed triangle arrays
serve brute-force validation and tooling.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ..core import pytree
from .flatten import ThreadedBvh


@pytree.dataclass
class DeviceBvh:
    # packed leaf-order triangles (MT form)
    tri_v0: jnp.ndarray    # (P, 3) f32
    tri_e1: jnp.ndarray    # (P, 3) f32
    tri_e2: jnp.ndarray    # (P, 3) f32
    tri_id: jnp.ndarray    # (P,) i32 flat id, -1 = padding
    nodes64: jnp.ndarray   # (N, 64) fused node+leaf record
    nodes64o: Optional[jnp.ndarray] = None  # (8N, 64) octant-ordered

    @staticmethod
    def from_threaded(t: ThreadedBvh) -> "DeviceBvh":
        return DeviceBvh(
            tri_v0=jnp.asarray(t.tri_v0),
            tri_e1=jnp.asarray(t.tri_e1),
            tri_e2=jnp.asarray(t.tri_e2),
            tri_id=jnp.asarray(t.tri_id),
            nodes64=jnp.asarray(t.nodes64),
            nodes64o=(None if t.nodes64o is None
                      else jnp.asarray(t.nodes64o)),
        )
