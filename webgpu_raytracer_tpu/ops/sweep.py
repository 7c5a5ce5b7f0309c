"""Closest-hit and any-hit sweeps over the dense world-triangle table.

Two implementations of one contract (ops/dense.py states the semantics):

- the plain XLA reference, `dense_closest` / `dense_shadow` (ops/dense.py);
- a Pallas kernel compiled through Triton for NVIDIA GPUs (`kernel_closest`,
  `kernel_occluded` below).

`on_platform` is the one place that chooses between them: the kernel where
the computation is compiled for CUDA, the reference where it is compiled for
the CPU. Lowering for any other platform raises. The choice is made by
`lax.platform_dependent` when the program is lowered, so it follows the
device the arrays live on, not the process default.

The kernel. The grid runs over blocks of RAY_BLOCK rays; each block walks
the triangle table in TRI_TILE-wide tiles with a `fori_loop`, keeping the
running best (t, index) -- or the any-hit flag -- in registers, so no
(rays x triangles) intermediate reaches device memory. The Plucker edge
tests are three 6-term dot products, the plane distance's numerator a
4-term and its denominator td = n.d a 3-term one, all f32 FMAs over the
meaningful feature rows (render/worldtris.py). td is read from its own rows
rather than formed as s0 + s1 + s2 (the Plucker identity): on grazing rays
that sum cancels differently from the reference's n.d and moved t by up to
6e-5 relative in the CPU tests, against 1e-5 allowed.
Inactive rays are encoded as t_max <= 0, and a block whose rays are all
inactive skips the walk. On scenes of more than one 128-triangle chunk the
block also skips every tile whose bounding sphere none of its rays can
reach within (t_min, running best t): a block-uniform branch, measured
2.9x off the mixed frame and 4% onto cornell's three-tile frame, hence the
scene-size rule (PERF.md, "Kernel decisions (H100)").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .dense import T_MAX, dense_closest, dense_shadow, multi_chunk
from .tune import DEFAULT_TUNE, TuneConfig
from ..render.worldtris import FEAT_K, WorldTris

RAY_BLOCK = 128   # rays per kernel block (grid axis)
TRI_TILE = 16     # triangles per fori_loop step inside a block
NUM_WARPS = 4
NUM_STAGES = 1

# Rows of the kernel's coefficient table (kernel_table): the six [d, m]
# coefficients of each edge test s0, s1, s2, the four [o, 1] coefficients
# of the plane-distance numerator tn, and the three [d] ones of td.
_EDGE_ROWS = 6
_TN_ROW = 3 * _EDGE_ROWS
_TD_ROW = _TN_ROW + 4
KERNEL_ROWS = _TD_ROW + 3


def on_platform(*args, xla, kernel, tune: TuneConfig = DEFAULT_TUNE):
    """`kernel(*args)` when compiled for CUDA, `xla(*args)` on the CPU.

    The single implementation choice of the dense sweeps. Any other
    lowering platform raises NotImplementedError. `tune.reference_sweep`
    forces the XLA reference on every platform: it is the baseline the
    kernel is compared and timed against on the card."""
    if tune.reference_sweep:
        return xla(*args)
    return jax.lax.platform_dependent(*args, cpu=xla, cuda=kernel)


def kernel_table(features: jnp.ndarray, tile: int = TRI_TILE) -> jnp.ndarray:
    """WorldTris.features (FEAT_K, 5*Tw) -> (KERNEL_ROWS, Tk) f32 with
    Tk = Tw rounded up to `tile`. Padding columns are zero: their td is 0,
    so they fail the determinant test like padding triangles do."""
    tw = features.shape[1] // 5
    f = features.reshape(FEAT_K, 5, tw)
    tab = jnp.concatenate([f[0:6, 0], f[0:6, 1], f[0:6, 2], f[6:10, 3],
                           f[0:3, 4]], axis=0)
    pad = (-tw) % tile
    return jnp.pad(tab, ((0, 0), (0, pad))) if pad else tab


def tile_spheres(wt: WorldTris, tile: int = TRI_TILE) -> jnp.ndarray:
    """(4, n_tiles) bounding sphere [cx, cy, cz, r] of each `tile`-wide run
    of world triangles (the kernel table's tiles); r = -1 for a tile of
    padding only. The radius is padded by 1e-3 relative (plus 1e-6) so the
    kernel's f32 reach test never culls a triangle it could hit."""
    tw = wt.v0.shape[0]
    pad = (-tw) % tile
    pts = jnp.stack([wt.v0, wt.v0 + wt.e1, wt.v0 + wt.e2], axis=1)
    valid = (jnp.abs(wt.v0).sum(1) + jnp.abs(wt.e1).sum(1)
             + jnp.abs(wt.e2).sum(1)) > 0
    big = jnp.float32(3e38)
    lo = jnp.where(valid[:, None, None], pts, big).min(1)
    hi = jnp.where(valid[:, None, None], pts, -big).max(1)
    lo = jnp.pad(lo, ((0, pad), (0, 0)), constant_values=big)
    hi = jnp.pad(hi, ((0, pad), (0, 0)), constant_values=-big)
    lo = lo.reshape(-1, tile, 3).min(1)
    hi = hi.reshape(-1, tile, 3).max(1)
    empty = lo[:, 0] > hi[:, 0]
    center = jnp.where(empty[:, None], 0.0, (lo + hi) * 0.5)
    r = jnp.linalg.norm(jnp.where(empty[:, None], 0.0, hi - center), axis=1)
    r = jnp.where(empty, -1.0, r * 1.001 + 1e-6)
    return jnp.concatenate([center.T, r[None]], axis=0)


def _sweep_kernel(rays_ref, tab_ref, *refs, n_tiles: int, c: int,
                  t_min: float, any_hit: bool, cull: bool):
    if cull:
        sph_ref, *out_refs = refs
    else:
        out_refs = refs
    dx, dy, dz, ox, oy, oz, tmax = (rays_ref[k, :] for k in range(7))
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    dm = [v[:, None] for v in (dx, dy, dz, mx, my, mz)]
    o1 = [v[:, None] for v in (ox, oy, oz)]
    tmax_c = tmax[:, None]
    live = tmax > 0.0
    n = n_tiles * jnp.max(live.astype(jnp.int32))  # 0: no live ray

    def tile_hits(k):
        base = pl.multiple_of(k * c, c)

        def row(r):
            return tab_ref[r, pl.ds(base, c)][None, :]

        def edge(g):
            s = dm[0] * row(g * _EDGE_ROWS)
            for j in range(1, _EDGE_ROWS):
                s = s + dm[j] * row(g * _EDGE_ROWS + j)
            return s

        s0, s1, s2 = edge(0), edge(1), edge(2)
        tn = (o1[0] * row(_TN_ROW) + o1[1] * row(_TN_ROW + 1)
              + o1[2] * row(_TN_ROW + 2) + row(_TN_ROW + 3))
        td = (dm[0] * row(_TD_ROW) + dm[1] * row(_TD_ROW + 1)
              + dm[2] * row(_TD_ROW + 2))
        inside = (jnp.minimum(jnp.minimum(s0, s1), s2) >= 0.0) | (
            jnp.maximum(jnp.maximum(s0, s1), s2) <= 0.0)
        ok = inside & (jnp.abs(td) >= 1e-6)
        t = tn / jnp.where(ok, td, 1.0)
        ok = ok & (t > t_min) & (t < tmax_c)
        return t, ok, base

    inv_dd = 1.0 / jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-30)

    def reachable(k, lane_tmax):
        """Can any ray of the block meet tile k's sphere in (t_min,
        lane_tmax)? Closest-point form: the ray's nearest approach to the
        centre, t_c, and the half chord h around it, in t units."""
        cx, cy, cz, r = (sph_ref[j, k] for j in range(4))
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        t_c = -(dx * ocx + dy * ocy + dz * ocz) * inv_dd
        px, py, pz = ocx + t_c * dx, ocy + t_c * dy, ocz + t_c * dz
        h2 = (r * r - (px * px + py * py + pz * pz)) * inv_dd
        h = jnp.sqrt(jnp.maximum(h2, 0.0))
        meets = ((h2 >= 0.0) & (lane_tmax > 0.0) & (t_c + h >= t_min)
                 & (t_c - h <= lane_tmax))
        return jnp.minimum(jnp.max(meets.astype(jnp.int32)),
                           (r >= 0.0).astype(jnp.int32)) > 0

    def walk(k, carry, work, lane_tmax):
        if not cull:
            return work(carry)
        return jax.lax.cond(reachable(k, lane_tmax), work, lambda x: x,
                            carry)

    if any_hit:
        (hit_ref,) = out_refs

        def body(k, hit):
            def work(hit):
                _, ok, _ = tile_hits(k)
                return jnp.maximum(hit, jnp.max(ok.astype(jnp.int32), axis=1))

            return walk(k, hit, work, jnp.where(hit > 0, 0.0, tmax))

        hit = jax.lax.fori_loop(0, n, body, jnp.zeros(tmax.shape, jnp.int32))
        hit_ref[:] = hit
        return

    t_ref, i_ref = out_refs

    def body(k, carry):
        def work(carry):
            best_t, best_i = carry
            t, ok, base = tile_hits(k)
            tm = jnp.where(ok, t, jnp.float32(T_MAX))
            cmin = jnp.min(tm, axis=1)
            cols = base + jax.lax.broadcasted_iota(jnp.int32, tm.shape, 1)
            cidx = jnp.min(jnp.where(tm <= cmin[:, None], cols, 2 ** 30),
                           axis=1)
            upd = cmin < best_t
            return (jnp.where(upd, cmin, best_t),
                    jnp.where(upd, cidx, best_i))

        return walk(k, carry, work, jnp.minimum(tmax, carry[0]))

    best_t, best_i = jax.lax.fori_loop(
        0, n, body, (tmax, jnp.full(tmax.shape, -1, jnp.int32)))
    t_ref[:] = best_t
    i_ref[:] = best_i


def _run(wt: WorldTris, ro, rd, t_max, active, t_min: float, any_hit: bool,
         interpret: bool):
    """ro, rd: (x, y, z) component tuples of (R,) arrays."""
    R = ro[0].shape[0]
    ones = jnp.ones((R,), jnp.float32)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
    if active is not None:
        t_max = jnp.where(active, t_max, 0.0)
    pad = (-R) % RAY_BLOCK
    rays = jnp.stack([c * ones for c in (*rd, *ro)]      # [d, o, t_max, 0]
                     + [t_max, jnp.zeros((R,), jnp.float32)], axis=0)
    if pad:
        rays = jnp.pad(rays, ((0, 0), (0, pad)))
    rp = R + pad
    tab = kernel_table(wt.features)
    n_tiles = tab.shape[1] // TRI_TILE
    cull = multi_chunk(wt)
    args = [rays, tab]
    in_specs = [pl.BlockSpec((8, RAY_BLOCK), lambda i: (0, i)),
                pl.BlockSpec(tab.shape, lambda i: (0, 0))]
    if cull:
        sph = tile_spheres(wt)
        args.append(sph)
        in_specs.append(pl.BlockSpec(sph.shape, lambda i: (0, 0)))

    spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    if any_hit:
        out_shape = [jax.ShapeDtypeStruct((rp,), jnp.int32)]
        out_specs = [spec]
    else:
        out_shape = [jax.ShapeDtypeStruct((rp,), jnp.float32),
                     jax.ShapeDtypeStruct((rp,), jnp.int32)]
        out_specs = [spec, spec]
    outs = pl.pallas_call(
        functools.partial(_sweep_kernel, n_tiles=n_tiles, c=TRI_TILE,
                          t_min=t_min, any_hit=any_hit, cull=cull),
        grid=(rp // RAY_BLOCK,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="dense_any_hit" if any_hit else "dense_closest_hit",
    )(*args)
    return [o[:R] for o in outs]


def shade_rows(wt: WorldTris, idx) -> jnp.ndarray:
    """(SHADE_K, R) shade-table rows of world triangles `idx`; zero where
    idx < 0 (a miss)."""
    rowT = wt.shade_table[jnp.clip(idx, 0, wt.shade_table.shape[0] - 1)].T
    return jnp.where((idx >= 0)[None, :], rowT, 0.0)


def kernel_closest(wt: WorldTris, ro, rd, t_max=T_MAX, active=None, *,
                   t_min: float = 1e-3, rows_from: int | None = None,
                   interpret: bool = False):
    """Closest hit through the kernel: (t, idx), idx == -1 on a miss, t is
    t_max on a miss.

    rows_from=k also returns rowT (SHADE_K, R - k), the shade rows of
    lanes [k:] only: the fused shadow+extension call packs its R shadow
    lanes first, and those never read rows."""
    R = ro[0].shape[0]
    t, idx = _run(wt, ro, rd, t_max, active, float(t_min), False, interpret)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
    t = jnp.where(idx >= 0, t, t_max)
    if rows_from is None:
        return t, idx
    return t, idx, shade_rows(wt, idx[rows_from:])


def kernel_occluded(wt: WorldTris, ro, rd, t_max, active=None, *,
                    t_min: float = 1e-3, interpret: bool = False):
    """Any hit in (t_min, t_max) through the kernel: bool (R,)."""
    (hit,) = _run(wt, ro, rd, t_max, active, float(t_min), True, interpret)
    return hit > 0


def _rows(v):
    return jnp.stack(v, axis=1)


def closest(wt: WorldTris, ro, rd, active, tune: TuneConfig = DEFAULT_TUNE):
    """Closest hit of component-tuple rays: (t, idx)."""
    return on_platform(
        wt, ro, rd, active, tune=tune,
        xla=lambda wt, ro, rd, a: dense_closest(wt, _rows(ro), _rows(rd),
                                                active=a),
        kernel=lambda wt, ro, rd, a: kernel_closest(wt, ro, rd, active=a))


def occluded(wt: WorldTris, ro, rd, t_max, active,
             tune: TuneConfig = DEFAULT_TUNE):
    """Any-hit occlusion of component-tuple rays: bool (R,)."""
    return on_platform(
        wt, ro, rd, t_max, active, tune=tune,
        xla=lambda wt, ro, rd, tm, a: dense_shadow(wt, _rows(ro), _rows(rd),
                                                   t_max=tm, active=a),
        kernel=lambda wt, ro, rd, tm, a: kernel_occluded(wt, ro, rd, tm,
                                                         active=a))


def occluded_and_closest(wt: WorldTris, sro, srd, s_tmax, s_active, cro,
                         crd, c_active, tune: TuneConfig = DEFAULT_TUNE):
    """The two per-bounce sweeps: shadow rays (any hit below s_tmax) and
    extension rays (closest hit). Returns (occluded, t, idx).

    The kernel runs both as one 2R-lane call, so the triangle table is
    walked once per block for both populations; the reference runs its two
    sweeps separately."""
    def xla(wt, sro, srd, s_tmax, s_active, cro, crd, c_active):
        occ = dense_shadow(wt, _rows(sro), _rows(srd), t_max=s_tmax,
                           active=s_active)
        t, idx = dense_closest(wt, _rows(cro), _rows(crd), active=c_active)
        return occ, t, idx

    def kernel(wt, sro, srd, s_tmax, s_active, cro, crd, c_active):
        R = s_tmax.shape[0]
        cat = jnp.concatenate
        ro = tuple(cat([a, b]) for a, b in zip(sro, cro))
        rd = tuple(cat([a, b]) for a, b in zip(srd, crd))
        tmax = cat([s_tmax, jnp.full((R,), T_MAX, jnp.float32)])
        t, idx = kernel_closest(wt, ro, rd, t_max=tmax,
                                active=cat([s_active, c_active]))
        return idx[:R] >= 0, t[R:], idx[R:]

    return on_platform(wt, sro, srd, s_tmax, s_active, cro, crd, c_active,
                       xla=xla, kernel=kernel, tune=tune)

