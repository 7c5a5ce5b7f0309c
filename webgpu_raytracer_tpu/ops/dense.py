"""Dense rays x world-triangles intersection: the plain XLA reference.

The Plucker-linear intersection test (render/worldtris.py) makes the whole
sweep a (R, 16) @ (16, 5T) f32 product plus elementwise combines and a
min-reduction, chunked over triangles with a fori_loop to bound memory. The
products run at Precision.HIGHEST, so no GPU runs them in TF32.
ops/sweep.py holds the GPU kernel of the same contract and chooses between
the two; this module is the reference and the CPU implementation.

Semantics match the reference's intersection (Raytracer.wgsl:443-453):
same 1e-6 determinant epsilon (det = -n.d), boundary-inclusive barycentrics,
strict (t_min, t_max) interval.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..render.worldtris import FEAT_K, WorldTris, ray_features

TRI_CHUNK = 128
T_MAX = 1e30


def _chunks(wt: WorldTris):
    twp = wt.v0.shape[0]
    # Small scenes are padded to multiples of 8 (< 128): one exact-size
    # chunk. Larger scenes are padded to 128-tile multiples.
    chunk = twp if twp < TRI_CHUNK else TRI_CHUNK
    assert twp % chunk == 0, (twp, chunk)
    n_chunks = twp // chunk
    # features grouped [s0|s1|s2|tn|td], each group twp wide
    feats = wt.features.reshape(FEAT_K, 5, twp)
    return feats, twp, n_chunks, chunk


def _chunk_result(rayf, feats, twp, k, chunk_size=TRI_CHUNK):
    cs = chunk_size
    c0 = k * cs
    chunk = jax.lax.dynamic_slice(
        feats, (0, 0, c0), (FEAT_K, 5, cs)
    ).reshape(FEAT_K, 5 * cs)
    res = jnp.dot(rayf, chunk, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    s0 = res[:, 0 * cs : 1 * cs]
    s1 = res[:, 1 * cs : 2 * cs]
    s2 = res[:, 2 * cs : 3 * cs]
    tn = res[:, 3 * cs : 4 * cs]
    td = res[:, 4 * cs : 5 * cs]
    inside = (jnp.minimum(jnp.minimum(s0, s1), s2) >= 0.0) | (
        jnp.maximum(jnp.maximum(s0, s1), s2) <= 0.0
    )
    ok = inside & (jnp.abs(td) >= 1e-6)
    t = tn / jnp.where(ok, td, 1.0)
    return t, ok


def multi_chunk(wt: WorldTris) -> bool:
    """More than one TRI_CHUNK of world triangles (static)."""
    return wt.v0.shape[0] > TRI_CHUNK


def dense_closest(wt: WorldTris, ro, rd, t_min=1e-3, t_max=T_MAX,
                  active=None):
    """Closest hit. Returns (t, wt_idx) with wt_idx == -1 on miss."""
    R = ro.shape[0]
    if active is None:
        active = jnp.ones(R, bool)
    rayf = ray_features(ro, rd)
    feats, twp, n_chunks, cs = _chunks(wt)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))

    def body(k, carry):
        best_t, best_i = carry
        t, ok = _chunk_result(rayf, feats, twp, k, cs)
        ok = ok & (t > t_min) & (t < t_max[:, None]) & active[:, None]
        # mask padded tail of the last chunk
        col = k * cs + jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
        ok = ok & (col < wt.valid_count)
        tm = jnp.where(ok, t, jnp.float32(T_MAX))
        carg = jnp.argmin(tm, axis=1)
        cmin = jnp.take_along_axis(tm, carg[:, None], axis=1)[:, 0]
        upd = cmin < best_t
        best_t = jnp.where(upd, cmin, best_t)
        best_i = jnp.where(upd, k * cs + carg.astype(jnp.int32), best_i)
        return best_t, best_i

    best_t = t_max
    best_i = jnp.full(R, -1, jnp.int32)
    best_t, best_i = jax.lax.fori_loop(0, n_chunks, body, (best_t, best_i))
    return best_t, best_i


def dense_shadow(wt: WorldTris, ro, rd, t_max, t_min=1e-3, active=None):
    """Any-hit occlusion. Returns bool (R,)."""
    R = ro.shape[0]
    if active is None:
        active = jnp.ones(R, bool)
    rayf = ray_features(ro, rd)
    feats, twp, n_chunks, cs = _chunks(wt)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))

    def body(k, occ):
        t, ok = _chunk_result(rayf, feats, twp, k, cs)
        ok = ok & (t > t_min) & (t < t_max[:, None]) & active[:, None]
        col = k * cs + jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
        ok = ok & (col < wt.valid_count)
        return occ | jnp.any(ok, axis=1)

    return jax.lax.fori_loop(0, n_chunks, body, jnp.zeros(R, bool))
