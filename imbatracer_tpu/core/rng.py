"""Counter-based, vectorised RNG for on-device path tracing.

The reference renderer carries a 64-bit MWC64X RNG per ray state
(reference: render/random.h:15-47).  On the device we want something stateless
and fully vectorised: a small per-ray uint32 state advanced by a PCG step,
seeded by hashing (pixel_id, sample_id, frame).  Two integer multiplies per
sample; vectorises perfectly and keeps ray state at 4 bytes.

All functions operate elementwise on arbitrary-shaped uint32 arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def hash_wang(x: jnp.ndarray) -> jnp.ndarray:
    """Wang-style integer hash; good avalanche for seed scrambling."""
    x = x.astype(_U32)
    x = (x ^ _U32(61)) ^ (x >> 16)
    x = x * _U32(9)
    x = x ^ (x >> 4)
    x = x * _U32(0x27D4EB2D)
    x = x ^ (x >> 15)
    return x


def seed(pixel_id: jnp.ndarray, sample_id, frame=0) -> jnp.ndarray:
    """Build a well-mixed per-ray RNG state from ids.

    Plays the role of the Bernstein-hash seed scramble the reference uses
    when filling queues (reference: render/ray_gen/ray_gen.h:49-57).
    """
    pixel_id = jnp.asarray(pixel_id, _U32)
    sample_id = jnp.asarray(sample_id, _U32)
    frame = jnp.asarray(frame, _U32)
    s = hash_wang(pixel_id + _U32(0x9E3779B9) * (sample_id + _U32(1)))
    s = hash_wang(s ^ (frame * _U32(0x85EBCA6B) + _U32(0xC2B2AE35)))
    # Avoid the all-zeros fixed point of the LCG stream.
    return s | _U32(1)


def _pcg_step(state: jnp.ndarray) -> jnp.ndarray:
    return state * _U32(747796405) + _U32(2891336453)


def _pcg_output(state: jnp.ndarray) -> jnp.ndarray:
    # PCG-RXS-M-XS output permutation on 32-bit state.
    word = ((state >> ((state >> 28) + _U32(4))) ^ state) * _U32(277803737)
    return (word >> 22) ^ word


def next_u32(state: jnp.ndarray):
    """Advance and return (new_state, uniform uint32)."""
    new_state = _pcg_step(state)
    return new_state, _pcg_output(new_state)


def next_float(state: jnp.ndarray):
    """Advance and return (new_state, float32 in [0, 1))."""
    new_state, bits = next_u32(state)
    # 24 high-quality mantissa bits -> [0,1); never returns exactly 1.0.
    u = (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
    return new_state, u


def next_floats(state: jnp.ndarray, n: int):
    """Advance n times; returns (new_state, tuple of n float arrays)."""
    outs = []
    for _ in range(n):
        state, u = next_float(state)
        outs.append(u)
    return state, tuple(outs)
