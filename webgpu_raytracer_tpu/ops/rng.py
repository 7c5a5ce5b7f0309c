"""Counter-seeded PCG random number generation, vectorized over ray lanes.

Same generator family as the reference kernels (Raytracer.wgsl:178-189):
a per-pixel u32 state seeded from (pixel_idx, frame*SPP+sample) via an
xorshift-multiply hash, advanced by the PCG-RXS-M-XS step. Every lane advances
its state the same number of times per bounce (branch-free), which keeps the
whole pipeline deterministic for a given (pixel, frame, sample) — the property
the sharded-vs-single-chip equivalence tests rely on.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def init_rng(pixel_idx: jnp.ndarray, frame: jnp.ndarray) -> jnp.ndarray:
    """Hash (pixel, frame) into a u32 PCG state."""
    seed = pixel_idx.astype(_U32) + frame.astype(_U32) * _U32(719393)
    seed = seed ^ _U32(2747636419)
    seed = seed * _U32(2654435769)
    seed = seed ^ (seed >> 16)
    seed = seed * _U32(2654435769)
    seed = seed ^ (seed >> 16)
    seed = seed * _U32(2654435769)
    return seed


def rand_pcg(state: jnp.ndarray):
    """One PCG draw. Returns (new_state, uniform f32 in [0, 1]).

    The u32 -> f32 conversion is split 16/16 (both halves exact in f32, one
    final rounding) — BITWISE identical to a direct convert; kept so the
    draw uses only 16-bit-exact integer casts."""
    old = state
    state = old * _U32(747796405) + _U32(2891336453)
    word = (state >> ((old >> 28) + _U32(4))) ^ state
    word = (word >> 22) ^ word
    word_f = ((word >> 16).astype(jnp.int32).astype(jnp.float32)
              * jnp.float32(65536.0)
              + (word & _U32(0xFFFF)).astype(jnp.int32)
              .astype(jnp.float32))
    return state, word_f / jnp.float32(4294967295.0)


def rand_n(state: jnp.ndarray, n: int):
    """Draw n uniforms; returns (new_state, [u0, ..., un-1])."""
    outs = []
    for _ in range(n):
        state, u = rand_pcg(state)
        outs.append(u)
    return state, outs
