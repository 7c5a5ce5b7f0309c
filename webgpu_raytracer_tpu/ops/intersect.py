"""Ray/scene intersection: branch-free stackless TLAS->BLAS traversal.

Implements the same two-level skip-pointer scheme as the reference megakernel
(Raytracer.wgsl:433-600) but restructured for a vector machine: every ray lane
carries a (mode, cursor) state machine — mode 0 walks the TLAS, mode 1 walks a
BLAS in instance-local space — and all lanes advance in lock-step through one
masked while-loop with a single node gather per step. Skip pointers are
pre-absolutized into the merged node array (render/resources.py), so a jump is
just a cursor assignment; there is no stack and no per-lane control flow.

t values are comparable across spaces because instance-local rays keep the
unnormalized direction (local_rd = inv_rot @ rd), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

T_MIN = 1e-3
T_MAX = 1e30


class Hit(NamedTuple):
    t: jnp.ndarray        # (R,) f32
    tri_idx: jnp.ndarray  # (R,) i32, -1 = miss
    inst_idx: jnp.ndarray  # (R,) i32, -1 = miss


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _cross(a, b):
    return jnp.cross(a, b)


def safe_inv(d):
    """1/d with zero components nudged off zero (slab-test NaN guard)."""
    return 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.float32(1e-20), d)


def aabb_hit(nmin, nmax, ro, inv_d, t_min, t_max):
    """Slab test (reference Raytracer.wgsl:433-441). Returns bool (R,)."""
    t1 = (nmin - ro) * inv_d
    t2 = (nmax - ro) * inv_d
    tn = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tf = jnp.min(jnp.maximum(t1, t2), axis=-1)
    tn = jnp.maximum(tn, t_min)
    tf = jnp.minimum(tf, t_max)
    return tn <= tf


def moller_trumbore(ro, rd, p0, p1, p2, t_min, t_max):
    """Watertight-enough triangle test (reference Raytracer.wgsl:443-453).

    Returns (t, hit_mask); t only meaningful where hit_mask.
    """
    e1 = p1 - p0
    e2 = p2 - p0
    h = _cross(rd, e2)
    a = _dot(e1, h)
    ok = jnp.abs(a) >= 1e-6
    f = 1.0 / jnp.where(ok, a, jnp.float32(1.0))
    s = ro - p0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(rd, q)
    t = f * _dot(e2, q)
    hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    hit = hit & (t > t_min) & (t < t_max)
    return t, hit


def _gather_node(scene, cursor):
    c = jnp.clip(cursor, 0, scene.node_min.shape[0] - 1)
    return (scene.node_min[c], scene.node_max[c], scene.node_skip[c],
            scene.node_data[c])


def _gather_tri_verts(scene, tri):
    tcl = jnp.clip(tri, 0, scene.tri_v.shape[0] - 1)
    vidx = scene.tri_v[tcl]  # (R, 3)
    p0 = scene.pos[vidx[:, 0]]
    p1 = scene.pos[vidx[:, 1]]
    p2 = scene.pos[vidx[:, 2]]
    return p0, p1, p2


def _enter_instance(scene, inst, ro, rd):
    """Transform the world ray into instance-local space (gathered inverse)."""
    icl = jnp.clip(inst, 0, scene.inst_inv.shape[0] - 1)
    inv = scene.inst_inv[icl]  # (R, 4, 4)
    rot = inv[:, :3, :3]
    # HIGHEST: an f32 product may otherwise run in TF32 on a GPU.
    lro = jnp.einsum("rij,rj->ri", rot, ro, precision=jax.lax.Precision.HIGHEST) + inv[:, :3, 3]
    lrd = jnp.einsum("rij,rj->ri", rot, rd, precision=jax.lax.Precision.HIGHEST)
    bstart = scene.inst_blas[icl]
    return lro, lrd, bstart


def _traverse(scene, ro, rd, t_min, t_max, active_in, any_hit: bool):
    """Shared closest-hit / any-hit walk. t_max may be (R,) for shadow rays."""
    R = ro.shape[0]
    i32 = jnp.int32
    inv_d = safe_inv(rd)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))

    tlas_end = scene.tlas_count
    n_total = scene.node_min.shape[0]

    class _S(NamedTuple):
        it: jnp.ndarray
        in_blas: jnp.ndarray
        tcur: jnp.ndarray
        bcur: jnp.ndarray
        bend: jnp.ndarray
        cur_inst: jnp.ndarray
        lro: jnp.ndarray
        lrd: jnp.ndarray
        linv: jnp.ndarray
        best_t: jnp.ndarray
        best_tri: jnp.ndarray
        best_inst: jnp.ndarray
        occluded: jnp.ndarray

    init = _S(
        it=jnp.zeros((), i32),
        in_blas=jnp.zeros(R, bool),
        tcur=jnp.where(active_in, 0, tlas_end).astype(i32),
        bcur=jnp.zeros(R, i32),
        bend=jnp.zeros(R, i32),
        cur_inst=jnp.zeros(R, i32),
        lro=ro,
        lrd=rd,
        linv=inv_d,
        best_t=t_max,
        best_tri=jnp.full(R, -1, i32),
        best_inst=jnp.full(R, -1, i32),
        occluded=jnp.zeros(R, bool),
    )

    max_iters = 4 * n_total + 64  # safety bound; real walks end far earlier

    def cond(s):
        alive = s.in_blas | (s.tcur < tlas_end)
        return (s.it < max_iters) & jnp.any(alive)

    def body(s):
        tlas_active = (~s.in_blas) & (s.tcur < tlas_end)
        cursor = jnp.where(s.in_blas, s.bcur, s.tcur)
        nmin, nmax, skip, data = _gather_node(scene, cursor)
        is_leaf = data != 0

        cur_ro = jnp.where(s.in_blas[:, None], s.lro, ro)
        cur_inv = jnp.where(s.in_blas[:, None], s.linv, inv_d)
        limit = s.best_t if not any_hit else t_max
        hit = aabb_hit(nmin, nmax, cur_ro, cur_inv, t_min, limit)

        # ---- TLAS-mode update -------------------------------------------
        enter = tlas_active & hit & is_leaf
        tcur = jnp.where(
            tlas_active,
            jnp.where(hit & ~is_leaf, s.tcur + 1, skip),
            s.tcur,
        )
        inst = data >> 3
        lro_n, lrd_n, bstart = _enter_instance(scene, inst, ro, rd)
        bend_n = scene.node_skip[jnp.clip(bstart, 0, n_total - 1)]

        in_blas = s.in_blas | enter
        bcur = jnp.where(enter, bstart, s.bcur)
        bend = jnp.where(enter, bend_n, s.bend)
        cur_inst = jnp.where(enter, inst, s.cur_inst)
        lro = jnp.where(enter[:, None], lro_n, s.lro)
        lrd = jnp.where(enter[:, None], lrd_n, s.lrd)
        linv = jnp.where(enter[:, None], safe_inv(lrd_n), s.linv)

        # ---- BLAS-mode update -------------------------------------------
        blas_active = s.in_blas
        blas_leaf = blas_active & hit & is_leaf
        first = data >> 3
        count = data & 7

        best_t = s.best_t
        best_tri = s.best_tri
        best_inst = s.best_inst
        occluded = s.occluded
        for k in range(4):  # <=4 tris/leaf by construction (blas.rs:99)
            tri = first + k
            valid = blas_leaf & (k < count)
            p0, p1, p2 = _gather_tri_verts(scene, tri)
            t, tri_hit = moller_trumbore(s.lro, s.lrd, p0, p1, p2, t_min,
                                         limit if any_hit else best_t)
            tri_hit = tri_hit & valid
            if any_hit:
                occluded = occluded | tri_hit
            else:
                best_t = jnp.where(tri_hit, t, best_t)
                best_tri = jnp.where(tri_hit, tri, best_tri)
                best_inst = jnp.where(tri_hit, s.cur_inst, best_inst)

        bcur_next = jnp.where(
            blas_active,
            jnp.where(hit & ~is_leaf, s.bcur + 1, skip),
            bcur,
        )
        bcur = jnp.where(blas_active, bcur_next, bcur)
        exit_blas = blas_active & (bcur >= s.bend)
        in_blas = in_blas & ~exit_blas

        if any_hit:
            # Early out: occluded lanes stop walking entirely.
            tcur = jnp.where(occluded, tlas_end, tcur)
            in_blas = in_blas & ~occluded

        return _S(s.it + 1, in_blas, tcur, bcur, bend, cur_inst, lro, lrd,
                  linv, best_t, best_tri, best_inst, occluded)

    out = jax.lax.while_loop(cond, body, init)
    if any_hit:
        return out.occluded
    return Hit(t=out.best_t, tri_idx=out.best_tri, inst_idx=out.best_inst)


def intersect_closest(scene, ro, rd, t_min=T_MIN, t_max=T_MAX, active=None):
    """Closest hit over the two-level BVH (Raytracer.wgsl intersect_tlas)."""
    if active is None:
        active = jnp.ones(ro.shape[0], bool)
    return _traverse(scene, ro, rd, jnp.float32(t_min), t_max, active,
                     any_hit=False)


def intersect_shadow(scene, ro, rd, t_max, t_min=T_MIN, active=None):
    """Any-hit occlusion query (Raytracer.wgsl intersect_tlas_shadow)."""
    if active is None:
        active = jnp.ones(ro.shape[0], bool)
    return _traverse(scene, ro, rd, jnp.float32(t_min), t_max, active,
                     any_hit=True)
