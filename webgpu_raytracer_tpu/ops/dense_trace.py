"""Path tracing over the dense world-triangle backend (the main path).

Same estimator and semantic contract as ops/trace.py (which documents the
mapping to reference Raytracer.wgsl), over world-space triangle tables:
- intersection = the dense closest-hit / any-hit sweeps (ops/sweep.py: the
  GPU kernel, or the XLA reference of ops/dense.py on the CPU)
- every per-ray quantity is component-SoA: separate (R,) arrays per vector
  component (ops/v3.py)
- shade-table rows arrive transposed (SHADE_K, R); field extraction is a
  major-dim slice
- no instance transforms in the loop: triangles/normals/lights pre-baked to
  world space per scene update (render/worldtris.py)

RNG consumption is identical to the BVH path (6 draws per bounce), so both
backends produce statistically identical images for the same (pixel, frame).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import bsdf_v3 as bsdf
from .bsdf_v3 import PI, Scatter, power_heuristic
from . import sweep
from .dense import T_MAX, multi_chunk
from .rng import init_rng, rand_n, rand_pcg
from .tune import DEFAULT_TUNE, TuneConfig
from .v3 import V3, cross, dot, length, max_component, normalize, splat, where
from ..render.worldtris import SHADE_COLS, SHADE_K, WorldTris

_SENT = 1e30


def _row_v3(rowT, name) -> V3:
    lo, _ = SHADE_COLS[name]
    return V3(rowT[lo], rowT[lo + 1], rowT[lo + 2])


def _row_f(rowT, name, k=0):
    lo, _ = SHADE_COLS[name]
    return rowT[lo + k]


def tex_level(textures, level: int):
    """Resolve a texture operand that may be a (level0, level1) pyramid.

    Bounce-0 samples read the full-resolution quad table; bounces >= 1 read
    the SECONDARY_MIP box mip (utils/textures.build_quad_pyramid) — the
    working-set cut that keeps incoherent secondary-hit gathers out of the
    multi-MB latency regime. A bare array means "one level for everything"
    (tests and the BVH path pass the plain packed table).
    """
    if isinstance(textures, (tuple, list)):
        return textures[min(level, len(textures) - 1)]
    return textures


def sample_texture_v3(textures, tex_idx, u, v) -> V3:
    """Component-SoA texture sample; tex_idx < 0 returns white.

    The texture is the PACKED QUAD TABLE (utils/textures.pack_quad_table):
    one (16 B) row gather delivers all four bilinear corners as u8 codes.
    The whole sample is skipped at runtime (lax.cond) when NO lane carries
    this map — most scenes only bind a base-color texture, so
    metallic-roughness / normal / emissive calls cost nothing.
    """
    K, TH, TW, _ = textures.shape
    has = tex_idx >= 0
    one = jnp.ones_like(u)
    if K == 1 and TH == 1 and TW == 1:
        texel = textures[0, 0, 0]
        return V3(jnp.where(has, texel[0], 1.0) * one,
                  jnp.where(has, texel[1], 1.0) * one,
                  jnp.where(has, texel[2], 1.0) * one)

    def sample(_):
        idx = jnp.clip(tex_idx, 0, K - 1)
        uu = u - jnp.floor(u)
        vv = v - jnp.floor(v)
        fx = uu * TW - 0.5
        fy = vv * TH - 0.5
        x0 = jnp.floor(fx).astype(jnp.int32)
        y0 = jnp.floor(fy).astype(jnp.int32)
        wx = fx - x0
        wy = fy - y0
        # Lanes with no texture (miss/dead lanes carry has=False) gather
        # row 0 instead of a garbage-uv scatter: their value is discarded
        # below, and pinning them to one hot DRAM row keeps the gather's
        # latency budget for the live lanes (late bounces run at <30%
        # occupancy before tail compaction kicks in).
        rows = (idx * TH + jnp.mod(y0, TH)) * TW + jnp.mod(x0, TW)
        rows = jnp.where(has, rows, 0)
        q = textures.reshape(-1, 4)[rows]

        def corner(c):
            w = q[:, c]
            return V3(((w >> 16) & 0xFF).astype(jnp.float32),
                      ((w >> 8) & 0xFF).astype(jnp.float32),
                      (w & 0xFF).astype(jnp.float32)) * (1.0 / 255.0)

        top = corner(0) * (1 - wx) + corner(1) * wx
        bot = corner(2) * (1 - wx) + corner(3) * wx
        rgb = top * (1 - wy) + bot * wy
        return where(has, rgb, V3(one, one, one))

    return jax.lax.cond(jnp.any(has), sample,
                        lambda _: V3(one, one, one), None)


class DenseHit(NamedTuple):
    rowT: jnp.ndarray  # (SHADE_K, R) shade rows of the hit tris
    wt: jnp.ndarray    # (R,) world-tri index (-1 = miss)
    hit_t: jnp.ndarray
    tex_u: jnp.ndarray
    tex_v: jnp.ndarray
    normal: V3         # shading normal (normal-mapped, world)
    geom_n: V3
    albedo: V3


def shade_from_rowT(textures, rowT, ro: V3, rd: V3, valid=None,
                    level: int = 0):
    """Barycentric attributes for a known world triangle (world space).

    Same math as the reference's hit reconstruction (Raytracer.wgsl:738-779)
    minus the object-space round trip: barycentrics are affine-invariant so
    world-space Moller-Trumbore gives identical weights.

    `valid` masks lanes with no real row (miss lanes carry zeroed rows whose
    texture slots read as 0 == "texture present", which would defeat the
    samplers' whole-call lax.cond skip).
    """
    v0 = _row_v3(rowT, "v0")
    e1 = _row_v3(rowT, "e1")
    e2 = _row_v3(rowT, "e2")

    s = ro - v0
    h = cross(rd, e2)
    a = dot(e1, h)
    f = 1.0 / jnp.where(jnp.abs(a) > 1e-20, a, 1e-20)
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(rd, q)
    w = 1.0 - u - v

    lo_uv0 = SHADE_COLS["uv0"][0]
    tex_u = rowT[lo_uv0] * w + rowT[SHADE_COLS["uv1"][0]] * u + rowT[SHADE_COLS["uv2"][0]] * v
    tex_v = rowT[lo_uv0 + 1] * w + rowT[SHADE_COLS["uv1"][0] + 1] * u + rowT[SHADE_COLS["uv2"][0] + 1] * v

    ln = normalize(_row_v3(rowT, "n0") * w + _row_v3(rowT, "n1") * u
                   + _row_v3(rowT, "n2") * v)

    base_tex = _row_f(rowT, "tex", 0).astype(jnp.int32)
    normal_tex = _row_f(rowT, "tex", 2).astype(jnp.int32)
    if valid is not None:
        base_tex = jnp.where(valid, base_tex, -1)
        normal_tex = jnp.where(valid, normal_tex, -1)
    tex = tex_level(textures, level)
    albedo = _row_v3(rowT, "base_color") * sample_texture_v3(
        tex, base_tex, tex_u, tex_v)

    # Tangent-space normal mapping with edge1 tangent (wgsl:770-776).
    n_map = sample_texture_v3(tex, normal_tex, tex_u, tex_v) * 2.0 - 1.0
    t_axis = normalize(e1)
    b_axis = normalize(cross(ln, t_axis))
    ln_mapped = normalize(t_axis * n_map.x + b_axis * n_map.y + ln * n_map.z)
    normal = where(normal_tex >= 0, ln_mapped, ln)

    geom_n = normalize(cross(e1, e2))
    return tex_u, tex_v, normal, geom_n, albedo


def _mt_refine_t(rowT, ro: V3, rd: V3):
    """f32 Moller-Trumbore hit distance for a KNOWN triangle row.

    The sweep's t only needs to RANK candidate triangles; the t actually
    used for hit positions is re-derived here in full f32
    from the winning row — the same refinement the reference's G-buffer
    seed performs by re-intersecting the identified triangle
    (Raytracer.wgsl:638-654). This also makes G-buffer-seeded bounce 0
    bit-identical to the traced-primary path (both recompute from rowT)."""
    v0 = _row_v3(rowT, "v0")
    e1 = _row_v3(rowT, "e1")
    e2 = _row_v3(rowT, "e2")
    s = ro - v0
    h = cross(rd, e2)
    a = dot(e1, h)
    f = 1.0 / jnp.where(jnp.abs(a) > 1e-20, a, 1e-20)
    q = cross(s, e1)
    return f * dot(e2, q)


def _hit_from_idx(wt: WorldTris, textures, t, idx, ro: V3, rd: V3,
                  level: int) -> DenseHit:
    rowT = sweep.shade_rows(wt, idx)
    t = jnp.where(idx >= 0, _mt_refine_t(rowT, ro, rd), t)
    tex_u, tex_v, normal, geom_n, albedo = shade_from_rowT(
        textures, rowT, ro, rd, valid=idx >= 0, level=level)
    return DenseHit(rowT, idx, t, tex_u, tex_v, normal, geom_n, albedo)


def intersect_and_shade(wt: WorldTris, textures, ro: V3, rd: V3, active,
                        tune: TuneConfig = DEFAULT_TUNE,
                        level: int = 0) -> DenseHit:
    t, idx = sweep.closest(wt, tuple(ro), tuple(rd), active, tune=tune)
    return _hit_from_idx(wt, textures, t, idx, ro, rd, level)


def seed_hit_from_wt_idx(wt: WorldTris, textures, wt_idx, ro: V3,
                         rd: V3) -> DenseHit:
    """Bounce-0 hit reconstructed from a G-buffer id channel.

    The reference reads depth 0 from its rasterized G-buffer instead of
    tracing it (Raytracer.wgsl:617-654): unpack the ids, re-fetch the
    triangle, recompute barycentrics + hit_t. Here: one shade-row gather by
    world-tri row + the shared shade_from_rowT / _mt_refine_t math, which
    yields radiance BIT-IDENTICAL to the traced-primary path (the traced
    path derives everything from the same rowT)."""
    idx = jnp.asarray(wt_idx, jnp.int32)
    rowT = sweep.shade_rows(wt, idx)
    t = jnp.where(idx >= 0, _mt_refine_t(rowT, ro, rd), jnp.float32(T_MAX))
    tex_u, tex_v, normal, geom_n, albedo = shade_from_rowT(
        textures, rowT, ro, rd, valid=idx >= 0)
    return DenseHit(rowT, idx, t, tex_u, tex_v, normal, geom_n, albedo)


def fused_shadow_and_next(wt: WorldTris, textures, sro: V3, srd: V3, s_tmax,
                          s_active, cro: V3, crd: V3, c_active,
                          tune: TuneConfig = DEFAULT_TUNE):
    """Both per-bounce ray sets: the NEE shadow rays (any hit below
    s_tmax) and the next-bounce extension rays (closest hit, shaded at the
    secondary texture level). On the GPU kernel both run as one 2R-lane
    sweep (ops/sweep.occluded_and_closest).

    Returns (occluded (R,), DenseHit for the extension rays).
    """
    occluded, t, idx = sweep.occluded_and_closest(
        wt, tuple(sro), tuple(srd), s_tmax, s_active, tuple(cro), tuple(crd),
        c_active, tune=tune)
    return occluded, _hit_from_idx(wt, textures, t, idx, cro, crd, level=1)


def shadow_query(wt: WorldTris, ro: V3, rd: V3, t_max, active,
                 tune: TuneConfig = DEFAULT_TUNE):
    return sweep.occluded(wt, tuple(ro), tuple(rd), t_max, active, tune=tune)


def _fetch_rowT(table, idx):
    return table[jnp.clip(idx, 0, table.shape[0] - 1)].T


def sample_light_dense(wt: WorldTris, textures, hit_p: V3, r0, r1, r2):
    """NEE light sample over world-tri lights (wgsl:345-399 semantics)."""
    lc = wt.light_count
    lc_f = jnp.maximum(lc.astype(jnp.float32), 1.0)
    pick = jnp.clip((r0 * lc_f).astype(jnp.int32), 0, jnp.maximum(lc - 1, 0))
    # light rows are pre-gathered per scene update: one fetch, no
    # light_wt -> shade_table double indirection
    rowT = _fetch_rowT(wt.light_rows, pick)

    v0 = _row_v3(rowT, "v0")
    e1 = _row_v3(rowT, "e1")
    e2 = _row_v3(rowT, "e2")

    sqrt_r1 = jnp.sqrt(r1)
    u = 1.0 - sqrt_r1
    v = r2 * sqrt_r1
    w = 1.0 - u - v
    # p = v0*u + v1*v + v2*w with v1 = v0+e1, v2 = v0+e2
    p = v0 + e1 * v + e2 * w

    cr = cross(e1, e2)
    n_raw = normalize(cr)
    area = length(cr) * 0.5

    l_dir = p - hit_p
    dist_sq = dot(l_dir, l_dir)
    dist = jnp.sqrt(dist_sq)
    unit_l = l_dir * (1.0 / jnp.maximum(dist, 1e-20))
    cos_theta_l = jnp.maximum(dot(n_raw, -unit_l), 0.0)

    lo0 = SHADE_COLS["uv0"][0]
    lo1 = SHADE_COLS["uv1"][0]
    lo2 = SHADE_COLS["uv2"][0]
    tex_u = rowT[lo0] * u + rowT[lo1] * v + rowT[lo2] * w
    tex_v = rowT[lo0 + 1] * u + rowT[lo1 + 1] * v + rowT[lo2 + 1] * w
    base_tex = _row_f(rowT, "tex", 0).astype(jnp.int32)
    L = _row_v3(rowT, "base_color") * sample_texture_v3(
        tex_level(textures, 1), base_tex, tex_u, tex_v)

    pdf = dist_sq / jnp.maximum(cos_theta_l * area, 1e-20) / lc_f
    valid = (lc > 0) & (cos_theta_l >= 1e-6) & (area > 0.0)
    pdf = jnp.where(valid, pdf, 0.0)
    return L, unit_l, dist, pdf


def light_pdf_from_rowT(wt: WorldTris, rowT, t, l_dir: V3):
    """MIS pdf of the emissive triangle just hit (wgsl:401-421)."""
    cr = cross(_row_v3(rowT, "e1"), _row_v3(rowT, "e2"))
    area = length(cr) * 0.5
    n = normalize(cr)
    cos_theta_l = jnp.maximum(dot(n, -l_dir), 0.0)
    lc_f = jnp.maximum(wt.light_count.astype(jnp.float32), 1.0)
    pdf = (t * t) / jnp.maximum(cos_theta_l * area, 1e-20) / lc_f
    return jnp.where(cos_theta_l >= 1e-4, pdf, 0.0)


def _offset_eps(p: V3):
    """Scale-adaptive ray-origin offset; see ops/trace._offset_eps."""
    m = jnp.maximum(jnp.abs(p.x), jnp.maximum(jnp.abs(p.y), jnp.abs(p.z)))
    return 1e-4 * jnp.maximum(1.0, m)


# Tail-compaction schedule ((depth, div), ...) lives in
# ops/tune.TuneConfig.tail_stages: from bounce `depth` onward, live lanes
# run in a static ceil(R/div) buffer (with a same-width fallback when the
# live count overflows). Depths ascend; budgets are relative to the
# ORIGINAL R. tail_min_r keeps small frames (CI-size frames, small sharded
# tiles) on the single-program path.


def ray_color_dense(wt: WorldTris, textures, ro: V3, rd: V3, rng,
                    max_depth: int, hit0: DenseHit | None = None,
                    tune: TuneConfig = DEFAULT_TUNE):
    """Returns (radiance V3, rng, rays): `rays` is the EXACT number of rays
    traced for this sample batch (primary + NEE shadow + extension lanes
    actually swept) — the honest numerator for Mrays/s reporting.

    `hit0` (optional) seeds bounce 0 from a G-buffer (seed_hit_from_wt_idx)
    instead of tracing primaries — reference Raytracer.wgsl:617-654."""
    R = ro.x.shape[0]
    f32 = jnp.float32
    zeros = jnp.zeros(R, f32)
    ones = jnp.ones(R, f32)

    primary_rays = 0.0 if hit0 is not None else float(R)
    if hit0 is None:
        hit0 = intersect_and_shade(wt, textures, ro, rd, jnp.ones(R, bool),
                                   tune=tune)
    active0 = hit0.wt >= 0

    class _S(NamedTuple):
        active: jnp.ndarray
        ro: V3
        rd: V3
        throughput: V3
        radiance: V3
        rng: jnp.ndarray
        prev_pdf: jnp.ndarray
        specular_bounce: jnp.ndarray
        hit: DenseHit
        rays: jnp.ndarray  # () f32 — rays traced so far

    state = _S(
        active=active0,
        ro=ro,
        rd=rd,
        throughput=V3(ones, ones, ones),
        radiance=V3(zeros, zeros, zeros),
        rng=rng,
        prev_pdf=zeros,
        specular_bounce=jnp.ones(R, bool),
        hit=hit0,
        rays=jnp.asarray(primary_rays, f32),  # primary rays
    )

    # Runtime gating of the per-bounce sweeps (see _bounce) applies to the
    # GPU kernel on scenes of more than one triangle chunk, where a sweep
    # and its shading cost more than the lax.cond around them. On the CPU
    # reference the conds would only add compile time.
    gated = multi_chunk(wt)

    def body(depth, s: _S):
        # Skip whole bounces once every lane has terminated (common for
        # depth > mean path length) — the cond prunes the device work.
        return jax.lax.cond(jnp.any(s.active),
                            lambda st: _bounce(depth, st), lambda st: st, s)

    def _bounce(depth, s: _S, last: bool = False):
        ones = jnp.ones_like(s.prev_pdf)  # shape-polymorphic: the tail
        # compaction (below) re-enters this body at R_tail lanes
        rowT = s.hit.rowT
        mat = _row_f(rowT, "mat").astype(jnp.int32)
        tex_mr = jnp.where(s.active, _row_f(rowT, "tex", 1), -1.0) \
            .astype(jnp.int32)
        tex_em = jnp.where(s.active, _row_f(rowT, "tex", 3), -1.0) \
            .astype(jnp.int32)

        hit_p = s.ro + s.rd * s.hit.hit_t

        # Face normals against the incoming ray (wgsl:660-661).
        normal = where(dot(s.rd, s.hit.normal) < 0.0, s.hit.normal,
                       -s.hit.normal)
        geom_n = where(dot(s.rd, s.hit.geom_n) < 0.0, s.hit.geom_n,
                       -s.hit.geom_n)

        metallic = _row_f(rowT, "mrir", 0)
        roughness = _row_f(rowT, "mrir", 1)
        mr = sample_texture_v3(tex_level(textures, 1), tex_mr,
                               s.hit.tex_u, s.hit.tex_v)
        metallic = jnp.where(tex_mr >= 0, metallic * mr.z, metallic)
        roughness = jnp.where(tex_mr >= 0, roughness * mr.y, roughness)
        roughness = jnp.maximum(roughness, 0.005)
        ior = _row_f(rowT, "mrir", 2)

        emissive = _row_v3(rowT, "emissive") * where(
            tex_em >= 0,
            sample_texture_v3(tex_level(textures, 1), tex_em,
                              s.hit.tex_u, s.hit.tex_v),
            V3(ones, ones, ones))

        albedo = s.hit.albedo
        f0 = albedo * metallic + (0.04 * (1.0 - metallic))  # mix(0.04, a, m)

        # --- Emissive / light hit with MIS (wgsl:677-682) ---
        is_light = mat == 3
        has_em = is_light | (length(emissive) > 1e-4)
        em_val = where(is_light, albedo, emissive)
        lp = light_pdf_from_rowT(wt, rowT, s.hit.hit_t, s.rd)
        mis_w = jnp.where(s.specular_bounce, 1.0,
                          power_heuristic(s.prev_pdf, lp))
        add = jnp.where(s.active & has_em, mis_w, 0.0)
        radiance = s.radiance + s.throughput * em_val * add
        active = s.active & ~is_light

        # --- NEE sample + BSDF response (wgsl:684-698); the shadow query is
        # deferred into the fused traversal below ---
        rng, (r0, r1, r2) = rand_n(s.rng, 3)
        L, ldir, ldist, lpdf = sample_light_dense(wt, textures, hit_p,
                                                  r0, r1, r2)
        nee_lane = active & (mat != 2) & (lpdf > 0.0)
        eps = _offset_eps(hit_p)
        end_eps = jnp.maximum(eps, _offset_eps(hit_p + ldir * ldist))
        n_dot_l = jnp.maximum(dot(normal, ldir), 0.0)
        is_diff = mat == 0
        bsdf_val = where(is_diff, bsdf.eval_diffuse(albedo),
                         bsdf.eval_ggx(normal, -s.rd, ldir, roughness, f0))
        bsdf_pdf = jnp.where(is_diff, n_dot_l / PI,
                             bsdf.ggx_pdf(normal, -s.rd, ldir, roughness))
        nee_tp = s.throughput  # contribution uses pre-scatter throughput

        # --- BSDF sampling (wgsl:700-707) ---
        rng, (s1, s2) = rand_n(rng, 2)
        sc_d = bsdf.sample_diffuse(normal, albedo, s1, s2)
        sc_m = bsdf.sample_ggx(normal, -s.rd, roughness, f0, s1, s2)
        sc_g = bsdf.sample_dielectric(s.rd, normal, ior, albedo, s1)

        is_m = mat == 1
        is_g = mat == 2
        dirn = where(is_g, sc_g.dir, where(is_m, sc_m.dir, sc_d.dir))
        pdf = jnp.where(is_g, sc_g.pdf, jnp.where(is_m, sc_m.pdf, sc_d.pdf))
        tp = where(is_g, sc_g.throughput,
                   where(is_m, sc_m.throughput, sc_d.throughput))
        is_spec = jnp.where(is_g, sc_g.is_specular,
                            jnp.where(is_m, sc_m.is_specular,
                                      sc_d.is_specular))

        # Geometric-normal guard for non-dielectrics (wgsl:709-712).
        bad = (mat != 2) & (dot(dirn, geom_n) <= 0.0)
        pdf = jnp.where(bad, 0.0, pdf)
        tp = tp * jnp.where(bad, 0.0, 1.0)

        active = active & (pdf > 0.0) & (length(tp) > 0.0)
        throughput = where(active, s.throughput * tp, s.throughput)

        off_n = where(dot(dirn, geom_n) > 0.0, geom_n, -geom_n)
        ro_next = where(active, hit_p + off_n * eps, s.ro)
        rd_next = where(active, dirn, s.rd)
        prev_pdf = jnp.where(active, pdf, s.prev_pdf)
        specular_bounce = jnp.where(active, is_spec, s.specular_bounce)

        # --- Russian roulette after depth 3 (wgsl:724-728) ---
        rng, rr = rand_pcg(rng)
        p = max_component(throughput)
        do_rr = active & (depth > 3)
        active = active & ~(do_rr & (rr > p))
        scale = jnp.where(do_rr & (rr <= p), 1.0 / jnp.maximum(p, 1e-20), 1.0)
        throughput = throughput * scale

        # --- Fused shadow + next-hit traversal (wgsl:688 + :731-780) ---
        # `last` (static): the final bounce never traces extension rays, so
        # it runs only an R-lane any-hit shadow query instead of the fused
        # 2R sweep. Gated scenes additionally check the per-bounce
        # populations at run time: a lightless scene never has shadow rays,
        # and a finished population skips its sweep and shading.
        do_next = (jnp.zeros_like(active) if last
                   else active & (depth < max_depth - 1))
        nR = ro_next.x.shape[0]

        def _zero_hit():
            z = jnp.zeros(nR, jnp.float32)
            z3 = V3(z, z, z)
            return DenseHit(jnp.zeros((SHADE_K, nR), jnp.float32),
                            jnp.full(nR, -1, jnp.int32), z, z, z,
                            z3, z3, z3)

        sro = hit_p + geom_n * eps
        stm = ldist - 2.0 * end_eps
        if last:
            def shadow_only(sro, ldir, stm, nee_lane):
                return shadow_query(wt, sro, ldir, stm, nee_lane, tune=tune)

            def shadow_gated(*a):
                return jax.lax.cond(jnp.any(a[3]), lambda a: shadow_only(*a),
                                    lambda a: jnp.zeros(nR, bool), a)

            occluded = sweep.on_platform(
                sro, ldir, stm, nee_lane, xla=shadow_only,
                kernel=shadow_gated if gated else shadow_only, tune=tune)
            nhit = _zero_hit()
        else:
            def both(*a):
                return fused_shadow_and_next(wt, textures, *a, tune=tune)

            def both_gated(*a):
                nee_lane, ro_n, rd_n, do_n = a[3:]

                def next_only(_):
                    return jnp.zeros(nR, bool), intersect_and_shade(
                        wt, textures, ro_n, rd_n, do_n, tune=tune, level=1)

                nee_any = jnp.any(nee_lane)
                return jax.lax.cond(
                    nee_any | jnp.any(do_n),
                    lambda _: jax.lax.cond(nee_any, lambda _: both(*a),
                                           next_only, None),
                    lambda _: (jnp.zeros(nR, bool), _zero_hit()), None)

            occluded, nhit = sweep.on_platform(
                sro, ldir, stm, nee_lane, ro_next, rd_next, do_next,
                xla=both, kernel=both_gated if gated else both, tune=tune)
        take = nee_lane & ~occluded & (bsdf_pdf > 0.0)
        wgt = jnp.where(
            take,
            power_heuristic(lpdf, bsdf_pdf) * n_dot_l /
            jnp.maximum(lpdf, 1e-20), 0.0)
        radiance = radiance + nee_tp * bsdf_val * L * wgt
        found = do_next & (nhit.wt >= 0)
        active = jnp.where(depth < max_depth - 1, found, active)

        # No found/stale select: lanes with found == False are inactive next
        # bounce and EVERY downstream contribution is active-gated, so they
        # may carry nhit's zero rows freely. (The old (40, R) select alone
        # moved ~120 MB per bounce.) Only hit_t needs clamping: T_MAX
        # squared overflows f32 in the NEE distance terms.
        hit = nhit._replace(hit_t=jnp.where(found, nhit.hit_t, 0.0))

        rays = s.rays + nee_lane.sum(dtype=jnp.float32) \
            + do_next.sum(dtype=jnp.float32)
        return _S(active, ro_next, rd_next, throughput, radiance, rng,
                  prev_pdf, specular_bounce, hit, rays)

    # --- Static TAIL COMPACTION (large frames, deep paths) ---
    # After Russian roulette bites, late bounces run at ~2-7% live lanes
    # (measured: cornell per-bounce live collapses 28% -> 2.5% across
    # bounce 4's RR; open scenes collapse even earlier via escape) yet
    # still pay full-R sweeps and ~30 full-R fusions — ~1/3 of the frame
    # serving <5% of the rays. At each tune.tail_stages (depth, div) boundary
    # the live lanes are compacted into a static ceil(R/div) buffer (one
    # (R, 28) row gather + one rowT transpose-gather; int/bool state rides
    # bitcast f32 rows — gathers/stacks are bit-preserving memory ops),
    # the remaining bounces run compacted, and radiance/rng scatter back.
    # If a stage's live count overflows its budget, a same-width fallback
    # branch skips just that stage (later stages still apply), preserving
    # correctness for any scene.
    def _compact_to(s, idxc):
        bc = jax.lax.bitcast_convert_type
        flags = s.active.astype(jnp.uint32) \
            | (s.specular_bounce.astype(jnp.uint32) << 1)
        rows = jnp.stack([
            s.ro.x, s.ro.y, s.ro.z, s.rd.x, s.rd.y, s.rd.z,
            s.throughput.x, s.throughput.y, s.throughput.z,
            s.radiance.x, s.radiance.y, s.radiance.z,
            s.prev_pdf,
            s.hit.hit_t, s.hit.tex_u, s.hit.tex_v,
            s.hit.normal.x, s.hit.normal.y, s.hit.normal.z,
            s.hit.geom_n.x, s.hit.geom_n.y, s.hit.geom_n.z,
            s.hit.albedo.x, s.hit.albedo.y, s.hit.albedo.z,
            bc(s.rng, jnp.float32), bc(s.hit.wt, jnp.float32),
            bc(flags, jnp.float32),
        ], axis=1)                               # (R, 28) — ONE row gather
        g = jnp.take(rows, idxc, axis=0, unique_indices=True)
        rowT_c = jnp.take(s.hit.rowT.T, idxc, axis=0,
                          unique_indices=True).T
        V = lambda i: V3(g[:, i], g[:, i + 1], g[:, i + 2])
        bits = bc(g[:, 27], jnp.uint32)
        return _S(
            active=(bits & 1).astype(bool),
            ro=V(0), rd=V(3), throughput=V(6), radiance=V(9),
            rng=bc(g[:, 25], jnp.uint32),
            prev_pdf=g[:, 12],
            specular_bounce=((bits >> 1) & 1).astype(bool),
            hit=DenseHit(rowT_c, bc(g[:, 26], jnp.int32),
                         g[:, 13], g[:, 14], g[:, 15], V(16), V(19), V(22)),
            rays=s.rays,
        )

    def _run_from(depth0: int, s, stages):
        """fori to the next stage boundary (or the end), cond-compact,
        recurse. Budgets are relative to the ORIGINAL R, so a skipped
        (overflowed) stage leaves later stages intact."""
        if not stages:
            # The LAST bounce is statically unrolled (stages are filtered
            # to < max_depth, so it always lands in this segment): it
            # replaces the fused 2R sweep with an R-lane shadow query.
            out = jax.lax.fori_loop(depth0, max_depth - 1, body, s)
            out = jax.lax.cond(
                jnp.any(out.active),
                lambda st: _bounce(max_depth - 1, st, last=True),
                lambda st: st, out)
            return out.radiance, out.rng, out.rays
        (d, div), rest = stages[0], stages[1:]
        s = jax.lax.fori_loop(depth0, d, body, s)
        r_cur = s.prev_pdf.shape[0]
        r_new = -(-(R // div) // tune.tail_align) * tune.tail_align
        if r_new >= r_cur:
            return _run_from(d, s, rest)
        live = s.active

        def full(s):
            return _run_from(d, s, rest)

        def compact(s):
            idxc = jnp.argsort(jnp.logical_not(live))[:r_new]  # live first
            rad, rng2, rays = _run_from(d, _compact_to(s, idxc), rest)
            rad = V3(
                s.radiance.x.at[idxc].set(rad.x, unique_indices=True),
                s.radiance.y.at[idxc].set(rad.y, unique_indices=True),
                s.radiance.z.at[idxc].set(rad.z, unique_indices=True))
            return rad, s.rng.at[idxc].set(rng2, unique_indices=True), rays

        return jax.lax.cond(live.sum() <= r_new, compact, full, s)

    sched = (tune.tail_stages_multitile if multi_chunk(wt)
             else tune.tail_stages)
    stages = [sv for sv in sched if 0 < sv[0] < max_depth]
    if R < tune.tail_min_r:
        stages = []
    return _run_from(0, state, tuple(stages))


# Strip-mining knobs (band_target / band_min_r / band_axis) live in
# ops/tune.TuneConfig.


def _pick_bands(width: int, height: int, tune: TuneConfig) -> int:
    """Bands to strip-mine a frame into, keeping ~tune.band_target lanes per
    band. Returns 1 (no banding) when the frame is small enough or when no
    band count in [ideal, 2*ideal] divides the height evenly (bands must
    share a static shape)."""
    R = width * height
    if R <= tune.band_min_r:
        return 1
    ideal = -(-R // tune.band_target)  # ceil
    for nb in range(ideal, min(2 * ideal, height) + 1):
        if height % nb == 0:
            return nb
    return 1


def trace_pixels_dense(wt: WorldTris, textures, camera24, frame_count, jitter,
                       width: int, height: int, spp: int, max_depth: int,
                       row0=0, full_height: int | None = None,
                       total_spp: int | None = None, sample0=0,
                       with_stats: bool = False, seed_wt_idx=None,
                       tune: TuneConfig = DEFAULT_TUNE):
    """Dense-backend frame render; same signature semantics as
    ops.trace.trace_pixels (tile/sample sharding offsets included).

    Returns (H*W, 3) radiance averaged over spp; with with_stats=True,
    returns (radiance, rays) where rays is the exact count of rays traced
    (seeded mode excludes the G-buffer's own primary cast — count it where
    the G-buffer is rendered).

    `seed_wt_idx` ((H*W,) i32, -1 = miss): seed every sample's bounce 0
    from a G-buffer id channel (GBuffer.wt_idx) instead of tracing
    primaries — the reference's rasterized depth-0 path
    (Raytracer.wgsl:617-654). The seed hit is reconstructed with each
    sample's own ray so, at lens_radius == 0, radiance is bit-identical to
    the traced-primary path.

    Frames larger than tune.band_target lanes are STRIP-MINED into bands
    processed sequentially inside the jitted step, bounding the per-bounce
    working set (~30 fusions of (R,) state + (40, R) shade rows) to the
    size of a 512^2 frame. Whether that pays on a GPU is not measured yet.
    Landscape frames band by
    COLUMN strips (tune.band_axis) so the dead horizontal periphery collapses
    into all-dead bands whose bounce loops skip entirely; portrait/square
    frames band by rows. Per-pixel RNG and arithmetic depend only on the
    global pixel coords: ROW banding is bit-identical to the unbanded path
    (test_banded_trace_bit_identical); COLUMN banding is a different XLA
    program whose codegen may contract the ray-gen chain with different
    FMA choices — ~1 ULP shifts on a minority of pixels, <1% near-tie
    winner flips (see test_column_banded_landscape_matches).
    """
    if full_height is None:
        full_height = height
    if total_spp is None:
        total_spp = spp

    nb = _pick_bands(width, height, tune)
    use_cols = tune.band_axis == "cols" or (
        tune.band_axis == "auto" and width > height)
    if use_cols:
        # Bands as COLUMN strips, lanes column-major inside each strip.
        # Rationale: dead pixels cluster at the horizontal periphery of
        # landscape frames (a 16:9 view of centered content: on cornell
        # 1080p ~45% of lanes die at bounce 0/1). Row bands all span the full width so no band
        # ever goes all-dead and every band pays all `max_depth` bounces;
        # column strips isolate the dead periphery and their bounce loops
        # skip via the existing any(active) lax.cond. Per-pixel RNG and
        # arithmetic are enumeration-invariant (one transpose re-assembles
        # the frame); see the docstring for the cross-program FP caveat.
        nbc = _pick_bands(height, width, tune)  # band count dividing WIDTH
        if nbc > 1:
            band_w = width // nbc
            band_R = band_w * height
            seed_t = None
            if seed_wt_idx is not None:
                seed_t = seed_wt_idx.reshape(height, width).T.reshape(-1)

            def cband_body(b, carry):
                out, rays = carry
                seed_b = None
                if seed_t is not None:
                    seed_b = jax.lax.dynamic_slice(
                        seed_t, (b * band_R,), (band_R,))
                lane = jnp.arange(band_R, dtype=jnp.uint32)
                gx = lane // jnp.uint32(height) \
                    + jnp.asarray(b, jnp.uint32) * jnp.uint32(band_w)
                gy = lane % jnp.uint32(height) + jnp.asarray(row0, jnp.uint32)
                col_b, rays_b = _trace_lanes(
                    wt, textures, camera24, frame_count, jitter, gx, gy,
                    width, full_height, spp, max_depth, total_spp, sample0,
                    seed_b, tune)
                out = jax.lax.dynamic_update_slice(out, col_b, (b * band_R, 0))
                return out, rays + rays_b

            out, rays = jax.lax.fori_loop(
                0, nbc, cband_body,
                (jnp.zeros((width * height, 3), jnp.float32),
                 jnp.zeros((), jnp.float32)))
            out = out.reshape(width, height, 3).swapaxes(0, 1) \
                .reshape(width * height, 3)
            if with_stats:
                return out, rays
            return out

    if nb > 1:
        band_h = height // nb
        band_R = width * band_h

        def band_body(b, carry):
            out, rays = carry
            seed_b = None
            if seed_wt_idx is not None:
                seed_b = jax.lax.dynamic_slice(seed_wt_idx, (b * band_R,),
                                               (band_R,))
            lane = jnp.arange(band_R, dtype=jnp.uint32)
            gx = lane % jnp.uint32(width)
            gy = lane // jnp.uint32(width) + jnp.asarray(row0, jnp.uint32) \
                + jnp.asarray(b, jnp.uint32) * jnp.uint32(band_h)
            col_b, rays_b = _trace_lanes(
                wt, textures, camera24, frame_count, jitter, gx, gy, width,
                full_height, spp, max_depth, total_spp, sample0, seed_b,
                tune)
            out = jax.lax.dynamic_update_slice(out, col_b, (b * band_R, 0))
            return out, rays + rays_b

        out, rays = jax.lax.fori_loop(
            0, nb, band_body,
            (jnp.zeros((width * height, 3), jnp.float32),
             jnp.zeros((), jnp.float32)))
        if with_stats:
            return out, rays
        return out

    R = width * height
    lane = jnp.arange(R, dtype=jnp.uint32)
    gx = lane % jnp.uint32(width)
    gy = lane // jnp.uint32(width) + jnp.asarray(row0, jnp.uint32)
    out = _trace_lanes(wt, textures, camera24, frame_count, jitter, gx, gy,
                       width, full_height, spp, max_depth, total_spp,
                       sample0, seed_wt_idx, tune)
    if with_stats:
        return out
    return out[0]


def _trace_lanes(wt: WorldTris, textures, camera24, frame_count, jitter,
                 gx, gy, width: int, full_height: int, spp: int,
                 max_depth: int, total_spp: int, sample0, seed_wt_idx,
                 tune: TuneConfig = DEFAULT_TUNE):
    """Trace one batch of lanes at GLOBAL pixel coords (gx, gy) (R,) u32.

    Pixel enumeration order is the caller's choice (row-major frame, row
    band, column strip): per-pixel RNG streams and arithmetic depend only
    on (gx, gy), so any partition of the frame produces the same radiance
    per pixel (bitwise within one compiled program; see
    trace_pixels_dense's docstring for the cross-program FP caveat).
    Returns (col (R, 3), rays ())."""
    cam = camera24  # (24,) block, see scene/camera contract
    R = gx.shape[0]
    origin = splat((cam[0], cam[1], cam[2]), jnp.zeros(R))
    lens_radius = cam[3]
    lower_left = (cam[4], cam[5], cam[6])
    horizontal = (cam[8], cam[9], cam[10])
    vertical = (cam[12], cam[13], cam[14])
    u_axis = (cam[16], cam[17], cam[18])
    v_axis = (cam[20], cam[21], cam[22])

    px = gx.astype(jnp.float32)
    py = gy.astype(jnp.float32)
    p_idx = gy * jnp.uint32(width) + gx

    def one_sample(i, acc):
        rng = init_rng(
            p_idx,
            frame_count.astype(jnp.uint32) * jnp.uint32(total_spp)
            + jnp.asarray(sample0, jnp.uint32) + i.astype(jnp.uint32))
        rng, (dr1, dr2) = rand_n(rng, 2)
        dx, dy = bsdf.random_in_unit_disk(dr1, dr2)
        rdx = lens_radius * dx
        rdy = lens_radius * dy
        off = V3(u_axis[0] * rdx + v_axis[0] * rdy,
                 u_axis[1] * rdx + v_axis[1] * rdy,
                 u_axis[2] * rdx + v_axis[2] * rdy)

        u = (px + 0.5 + jitter[0] * width) / width
        v = 1.0 - (py + 0.5 + jitter[1] * full_height) / full_height
        d = V3(
            lower_left[0] + u * horizontal[0] + v * vertical[0] - cam[0],
            lower_left[1] + u * horizontal[1] + v * vertical[1] - cam[1],
            lower_left[2] + u * horizontal[2] + v * vertical[2] - cam[2],
        ) - off
        ro = origin + off
        hit0 = None
        if seed_wt_idx is not None:
            hit0 = seed_hit_from_wt_idx(wt, textures, seed_wt_idx, ro, d)
        col, _, rays = ray_color_dense(wt, textures, ro, d, rng, max_depth,
                                       hit0=hit0, tune=tune)
        ax, ay, az, ar = acc
        return (ax + col.x, ay + col.y, az + col.z, ar + rays)

    zero = jnp.zeros(R, jnp.float32)
    cx, cy, cz, rays = jax.lax.fori_loop(
        0, spp, one_sample, (zero, zero, zero, jnp.zeros((), jnp.float32)))
    inv = 1.0 / spp
    col = jnp.stack([cx * inv, cy * inv, cz * inv], axis=-1)
    return col, rays
