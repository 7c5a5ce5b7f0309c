"""Checks of the GPU sweep kernel against the XLA reference (ops/dense.py).

Shared by the CPU tests (kernel in Pallas interpret mode) and chip_smoke.py
(kernel compiled for the card, reference at Precision.HIGHEST on the card).

Tolerances, and why:
- hit/miss flags are identical;
- where both pick the same triangle, t agrees within rtol TOL plus the
  rounding that the f32 plane-distance numerator tn = n.v0 - n.o can carry:
  16 ulp of its terms' magnitude over |n.d|. The kernel sums the same f32
  products in another order, and a ray that starts close to a triangle's
  plane cancels most of tn;
- a winner may differ only where the f64 Moller-Trumbore distances of both
  triangles agree within rtol TOL: a genuine near-tie (coplanar overlapping
  quads, shared edges), never an ordering error;
- the rows of agreeing winners are bit-identical to the shade table;
- occlusion is identical except where the f64 nearest occluder lies within
  TOL * t_max of t_max.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from webgpu_raytracer_tpu.ops import sweep
from webgpu_raytracer_tpu.ops.dense import T_MAX, dense_closest, dense_shadow

TOL = 1e-5
T_MIN = 1e-3


def _mt_t64(wt, ro, rd, tris):
    """f64 Moller-Trumbore distance of each ray to triangle `tris` (same
    length as ro); inf where the ray misses that triangle."""
    v0 = np.asarray(wt.v0, np.float64)[tris]
    e1 = np.asarray(wt.e1, np.float64)[tris]
    e2 = np.asarray(wt.e2, np.float64)[tris]
    h = np.cross(rd, e2)
    a = np.einsum("ij,ij->i", e1, h)
    ok = np.abs(a) > 0
    f = 1.0 / np.where(ok, a, 1.0)
    s = ro - v0
    u = f * np.einsum("ij,ij->i", s, h)
    q = np.cross(s, e1)
    v = f * np.einsum("ij,ij->i", rd, q)
    t = f * np.einsum("ij,ij->i", e2, q)
    eps = 1e-7
    hit = ok & (u >= -eps) & (v >= -eps) & (u + v <= 1 + eps)
    return np.where(hit, t, np.inf)


def _nearest_t64(wt, ro, rd):
    """f64 nearest hit distance in (T_MIN, inf) over every valid triangle."""
    n = int(wt.valid_count)
    out = np.full(ro.shape[0], np.inf)
    for k in range(ro.shape[0]):
        t = _mt_t64(wt, np.repeat(ro[k:k + 1], n, 0),
                    np.repeat(rd[k:k + 1], n, 0), np.arange(n))
        t = t[t > T_MIN]
        out[k] = t.min() if t.size else np.inf
    return out


def check_closest(wt, ro, rd, t_k, i_k, t_r, i_r, rows=None):
    """ro, rd (R, 3) numpy; kernel (t_k, i_k[, rows]) vs reference (t_r,
    i_r). Returns a report dict with "ok"."""
    t_k, i_k, t_r, i_r = map(np.asarray, (t_k, i_k, t_r, i_r))
    hit = i_r >= 0
    rep = {"rays": int(i_r.size), "hits": int(hit.sum()),
           "hitflag_diff": int(((i_k >= 0) != hit).sum())}
    same = hit & (i_k == i_r)
    rel = np.abs(t_k - t_r) / np.maximum(np.abs(t_r), 1e-30)
    rep["t_max_rel"] = float(rel[same].max()) if same.any() else 0.0
    tw = wt.v0.shape[0]
    f = np.asarray(wt.features, np.float64).reshape(-1, 5, tw)
    sel = np.nonzero(same)[0]
    n = f[0:3, 4].T[i_r[sel]]
    terms = (np.abs(np.asarray(ro, np.float64)[sel] * n).sum(1)
             + np.abs(f[9, 3][i_r[sel]]))
    nd = np.abs((np.asarray(rd, np.float64)[sel] * n).sum(1))
    slack = 16 * 2.0 ** -24 * terms / np.maximum(nd, 1e-30)
    beyond = np.abs(t_k - t_r)[sel] > TOL * np.abs(t_r[sel]) + slack
    rep["t_beyond_tol"] = int(beyond.sum())
    diff = np.nonzero(hit & (i_k != i_r))[0]
    rep["winner_diff"] = int(diff.size)
    rep["tie_max_rel"] = 0.0
    if diff.size:
        ro64 = np.asarray(ro, np.float64)[diff]
        rd64 = np.asarray(rd, np.float64)[diff]
        ta = _mt_t64(wt, ro64, rd64, i_r[diff])
        tb = _mt_t64(wt, ro64, rd64, i_k[diff])
        tie = np.abs(ta - tb) / np.maximum(np.abs(ta), 1e-30)
        rep["tie_max_rel"] = float(np.nan_to_num(tie, nan=np.inf).max())
    ok = (rep["hitflag_diff"] == 0 and rep["t_beyond_tol"] == 0
          and rep["tie_max_rel"] <= TOL)
    if rows is not None:
        rows = np.asarray(rows)
        st = np.asarray(wt.shade_table)
        rep["rows_exact"] = bool(
            (rows[:, same].T == st[i_k[same]]).all()
            and (rows[:, ~(i_k >= 0)] == 0).all())
        ok = ok and rep["rows_exact"]
    rep["ok"] = bool(ok)
    return rep


def check_occluded(wt, ro, rd, t_max, occ_k, occ_r):
    occ_k, occ_r = np.asarray(occ_k), np.asarray(occ_r)
    t_max = np.broadcast_to(np.asarray(t_max, np.float64), occ_r.shape)
    diff = np.nonzero(occ_k != occ_r)[0]
    rep = {"rays": int(occ_r.size), "occluded": int(occ_r.sum()),
           "occ_diff": int(diff.size), "occ_diff_unexplained": 0}
    if diff.size:
        near = _nearest_t64(wt, np.asarray(ro, np.float64)[diff],
                            np.asarray(rd, np.float64)[diff])
        grazing = np.abs(near - t_max[diff]) <= TOL * t_max[diff]
        rep["occ_diff_unexplained"] = int((~grazing).sum())
    rep["ok"] = rep["occ_diff_unexplained"] == 0
    return rep


def _comp(a):
    return (a[:, 0], a[:, 1], a[:, 2])


def compare(wt, ro, rd, t_max, active, mode: str, interpret: bool):
    """Run `mode` ("closest", "any_hit" or "fused") through the kernel and
    the reference; returns the check report. ro, rd (R, 3) f32 numpy."""
    ro_j, rd_j = jnp.asarray(ro), jnp.asarray(rd)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (ro.shape[0],))
    act = jnp.asarray(active)
    if mode == "closest":
        t_k, i_k, rows = jax.jit(lambda a, b: sweep.kernel_closest(
            wt, _comp(a), _comp(b), t_max=t_max, active=act, rows_from=0,
            interpret=interpret))(ro_j, rd_j)
        t_r, i_r = jax.jit(lambda a, b: dense_closest(
            wt, a, b, t_max=t_max, active=act))(ro_j, rd_j)
        return check_closest(wt, ro, rd, t_k, i_k, t_r, i_r, rows)
    if mode == "any_hit":
        occ_k = jax.jit(lambda a, b: sweep.kernel_occluded(
            wt, _comp(a), _comp(b), t_max, active=act,
            interpret=interpret))(ro_j, rd_j)
        occ_r = jax.jit(lambda a, b: dense_shadow(
            wt, a, b, t_max=t_max, active=act))(ro_j, rd_j)
        return check_occluded(wt, ro, rd, np.asarray(t_max), occ_k, occ_r)
    assert mode == "fused", mode
    # 2R lanes: shadow rays (bounded by t_max) first, closest rays after;
    # rows cover lanes [R:] only.
    R = ro.shape[0]
    both = lambda x: jnp.concatenate([x, x])
    tmax2 = jnp.concatenate([t_max, jnp.full((R,), T_MAX, jnp.float32)])
    t_k, i_k, rows = jax.jit(lambda a, b: sweep.kernel_closest(
        wt, _comp(both(a)), _comp(both(b)), t_max=tmax2, active=both(act),
        rows_from=R, interpret=interpret))(ro_j, rd_j)
    t_k, i_k = np.asarray(t_k), np.asarray(i_k)
    assert rows.shape == (wt.shade_table.shape[1], R), rows.shape
    occ_r = jax.jit(lambda a, b: dense_shadow(
        wt, a, b, t_max=t_max, active=act))(ro_j, rd_j)
    t_r, i_r = jax.jit(lambda a, b: dense_closest(wt, a, b, active=act))(
        ro_j, rd_j)
    rep = check_closest(wt, ro, rd, t_k[R:], i_k[R:], t_r, i_r, rows)
    occ = check_occluded(wt, ro, rd, np.asarray(t_max), i_k[:R] >= 0, occ_r)
    rep.update({"occ_" + k: v for k, v in occ.items() if k != "ok"})
    rep["ok"] = rep["ok"] and occ["ok"]
    return rep


def random_rays(wt, n: int, seed: int, scale: float = 1.0):
    """Origins spread over the scene's bounding box, random directions of
    length `scale`; every 7th lane inactive, every 5th bounded at half the
    box diagonal. Returns (ro, rd, t_max, active) numpy."""
    rng = np.random.default_rng(seed)
    v = np.asarray(wt.v0)[:int(wt.valid_count)]
    lo, hi = v.min(0), v.max(0)
    ro = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    rd = rng.normal(size=(n, 3))
    rd = (scale * rd / np.linalg.norm(rd, axis=1, keepdims=True))
    lane = np.arange(n)
    diag = float(np.linalg.norm(hi - lo))
    t_max = np.where(lane % 5 == 0, 0.5 * diag / scale, T_MAX)
    return (ro, rd.astype(np.float32), t_max.astype(np.float32),
            lane % 7 != 0)


def camera_rays(world, width: int, height: int):
    """Pinhole primary rays through pixel centres (unnormalised, as the
    tracer casts them)."""
    c = np.asarray(world.camera(), np.float32)
    lane = np.arange(width * height)
    u = ((lane % width) + 0.5) / width
    v = 1.0 - ((lane // width) + 0.5) / height
    rd = np.stack([c[4 + k] + u * c[8 + k] + v * c[12 + k] - c[k]
                   for k in range(3)], 1).astype(np.float32)
    ro = np.broadcast_to(c[:3], rd.shape).astype(np.float32)
    return ro, rd
