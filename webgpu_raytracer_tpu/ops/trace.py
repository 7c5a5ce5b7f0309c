"""The path-trace megakernel: camera rays -> bounce loop -> accumulation.

Semantic contract = reference Raytracer.wgsl ray_color/main (:607-819):
per-pixel PCG streams, thin-lens DoF, pixel jitter, MIS between NEE and BSDF
sampling (power heuristic), dedicated any-hit shadow traversal, geometric
normal guard, Russian roulette after depth 3, and sum+count accumulation.

The reference seeds bounce 0 from a rasterized G-buffer (wgsl:617-654); the
equivalent here traces the primary ray with the same camera math, which
produces the identical first hit (the G-buffer is a rasterizer-side
optimization of exactly this intersection). A standalone G-buffer pass with
the reference's output layout lives in ops/gbuffer.py.

All lanes are advanced branch-free; per-bounce RNG consumption is a constant
6 draws/lane so pixel streams are reproducible regardless of masking.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import bsdf
from .bsdf import PI, normalize, power_heuristic
from .intersect import T_MAX, T_MIN, intersect_closest, intersect_shadow
from .rng import init_rng, rand_n, rand_pcg


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _offset_eps(p):
    """Scale-adaptive ray-origin offset (R,).

    The reference uses a fixed 1e-4 (wgsl:688,719) which self-intersects on
    large-coordinate geometry (e.g. the radius-1000 ground sphere of the
    `mesh`/`spheres` presets) where f32 hit points carry ~|p|*2^-13 error.
    Scaling by the hit-point magnitude keeps small scenes bit-comparable
    while staying robust at any scale.
    """
    return 1e-4 * jnp.maximum(1.0, jnp.max(jnp.abs(p), axis=-1))


# ---------------------------------------------------------------------------
# Texture sampling (bilinear, repeat, LOD 0 — ResourceManager.ts:69-75)
# ---------------------------------------------------------------------------


def sample_texture(textures, tex_idx, uv):
    """Sample the texture array; tex_idx < 0 returns white. uv repeat mode.

    General path reads the packed bilinear quad table (one short-row gather
    per sample; see utils/textures.pack_quad_table and the dense sampler
    ops/dense_trace.sample_texture_v3 for the rationale + measurements)."""
    K, TH, TW, _ = textures.shape
    if K == 1 and TH == 1 and TW == 1:
        # Placeholder-texture fast path (untextured scenes): statically
        # shaped, no gathers.
        texel = textures[0, 0, 0][None, :]
        return jnp.where((tex_idx >= 0)[..., None], texel, 1.0)

    def sample(_):
        idx = jnp.clip(tex_idx, 0, K - 1)
        u = uv[..., 0] - jnp.floor(uv[..., 0])
        v = uv[..., 1] - jnp.floor(uv[..., 1])
        fx = u * TW - 0.5
        fy = v * TH - 0.5
        x0 = jnp.floor(fx).astype(jnp.int32)
        y0 = jnp.floor(fy).astype(jnp.int32)
        wx = fx - x0
        wy = fy - y0
        flat = textures.reshape(-1, 4)
        q = flat[(idx * TH + jnp.mod(y0, TH)) * TW + jnp.mod(x0, TW)]

        def corner(c):
            w = q[..., c]
            return jnp.stack(
                [((w >> 16) & 0xFF), ((w >> 8) & 0xFF), (w & 0xFF)],
                axis=-1).astype(jnp.float32) * (1.0 / 255.0)

        top = corner(0) * (1 - wx)[..., None] + corner(1) * wx[..., None]
        bot = corner(2) * (1 - wx)[..., None] + corner(3) * wx[..., None]
        rgb = top * (1 - wy)[..., None] + bot * wy[..., None]
        return jnp.where((tex_idx >= 0)[..., None], rgb, 1.0)

    return jax.lax.cond(
        jnp.any(tex_idx >= 0), sample,
        lambda _: jnp.ones(tex_idx.shape + (3,), jnp.float32), None)


# ---------------------------------------------------------------------------
# Hit shading data (wgsl:617-654 primary / :738-779 bounce — same math)
# ---------------------------------------------------------------------------


class HitData(NamedTuple):
    hit_t: jnp.ndarray        # (R,)
    tex_uv: jnp.ndarray       # (R, 2)
    normal: jnp.ndarray       # (R, 3) shading normal (world, normal-mapped)
    world_geom_n: jnp.ndarray  # (R, 3)
    albedo: jnp.ndarray       # (R, 3) base_color * base texture


def _inv_transpose_dir(inv, n):
    """normalize((vec4(n,0) * inv).xyz): the inverse-transpose normal map."""
    return normalize(jnp.einsum("ri,rij->rj", n, inv[:, :3, :3],
                                precision=jax.lax.Precision.HIGHEST))


def load_hit(scene, ro, rd, tri_idx, inst_idx) -> HitData:
    """Recompute barycentrics/attributes for a known (tri, inst) hit."""
    icl = jnp.clip(inst_idx, 0, scene.inst_inv.shape[0] - 1)
    inv = scene.inst_inv[icl]
    lro = jnp.einsum("rij,rj->ri", inv[:, :3, :3], ro, precision=jax.lax.Precision.HIGHEST) + inv[:, :3, 3]
    lrd = jnp.einsum("rij,rj->ri", inv[:, :3, :3], rd, precision=jax.lax.Precision.HIGHEST)

    tcl = jnp.clip(tri_idx, 0, scene.tri_v.shape[0] - 1)
    vidx = scene.tri_v[tcl]
    v0 = scene.pos[vidx[:, 0]]
    v1 = scene.pos[vidx[:, 1]]
    v2 = scene.pos[vidx[:, 2]]

    s = lro - v0
    e1 = v1 - v0
    e2 = v2 - v0
    h = jnp.cross(lrd, e2)
    f = 1.0 / _dot(e1, h)
    u = f * _dot(s, h)
    q = jnp.cross(s, e1)
    v = f * _dot(lrd, q)
    w = 1.0 - u - v
    hit_t = f * _dot(e2, q)

    uv0 = scene.uv[vidx[:, 0]]
    uv1 = scene.uv[vidx[:, 1]]
    uv2 = scene.uv[vidx[:, 2]]
    tex_uv = uv0 * w[:, None] + uv1 * u[:, None] + uv2 * v[:, None]

    n0 = scene.nrm[vidx[:, 0]]
    n1 = scene.nrm[vidx[:, 1]]
    n2 = scene.nrm[vidx[:, 2]]
    ln = normalize(n0 * w[:, None] + n1 * u[:, None] + n2 * v[:, None])

    albedo = scene.tri_base_color[tcl]
    base_tex = scene.tri_tex[tcl][:, 0]
    albedo = albedo * sample_texture(scene.textures, base_tex, tex_uv)

    # Tangent-space normal mapping using edge1 as tangent (wgsl:770-776).
    normal_tex = scene.tri_tex[tcl][:, 2]
    n_map = sample_texture(scene.textures, normal_tex, tex_uv) * 2.0 - 1.0
    t_axis = normalize(e1)
    b_axis = normalize(jnp.cross(ln, t_axis))
    ln_mapped = normalize(
        t_axis * n_map[:, 0:1] + b_axis * n_map[:, 1:2] + ln * n_map[:, 2:3]
    )
    ln_final = jnp.where((normal_tex >= 0)[:, None], ln_mapped, ln)
    normal = _inv_transpose_dir(inv, ln_final)

    local_geom_n = normalize(jnp.cross(e1, e2))
    world_geom_n = _inv_transpose_dir(inv, local_geom_n)

    return HitData(hit_t, tex_uv, normal, world_geom_n, albedo)


# ---------------------------------------------------------------------------
# Next-event estimation (wgsl:345-427)
# ---------------------------------------------------------------------------


class LightSample(NamedTuple):
    L: jnp.ndarray     # (R, 3)
    dir: jnp.ndarray   # (R, 3)
    dist: jnp.ndarray  # (R,)
    pdf: jnp.ndarray   # (R,)


def _light_tri_world(scene, tri_idx, inst_idx):
    icl = jnp.clip(inst_idx, 0, scene.inst_tf.shape[0] - 1)
    m = scene.inst_tf[icl]
    tcl = jnp.clip(tri_idx, 0, scene.tri_v.shape[0] - 1)
    vidx = scene.tri_v[tcl]

    def xf(p):
        return jnp.einsum("rij,rj->ri", m[:, :3, :3], p, precision=jax.lax.Precision.HIGHEST) + m[:, :3, 3]

    v0 = xf(scene.pos[vidx[:, 0]])
    v1 = xf(scene.pos[vidx[:, 1]])
    v2 = xf(scene.pos[vidx[:, 2]])
    return v0, v1, v2, vidx, tcl


def sample_light_source(scene, hit_p, r0, r1, r2) -> LightSample:
    """Uniform light pick + sqrt-warp area sample (wgsl:345-399)."""
    lc = scene.light_count
    any_light = lc > 0
    lc_f = jnp.maximum(lc.astype(jnp.float32), 1.0)
    pick = jnp.clip((r0 * lc_f).astype(jnp.int32), 0, jnp.maximum(lc - 1, 0))
    lref = scene.lights[jnp.clip(pick, 0, scene.lights.shape[0] - 1)]
    inst_idx = lref[:, 0]
    tri_idx = lref[:, 1]

    v0, v1, v2, vidx, tcl = _light_tri_world(scene, tri_idx, inst_idx)

    sqrt_r1 = jnp.sqrt(r1)
    u = 1.0 - sqrt_r1
    v = r2 * sqrt_r1
    w = 1.0 - u - v

    p = v0 * u[:, None] + v1 * v[:, None] + v2 * w[:, None]
    e1 = v1 - v0
    e2 = v2 - v0
    cr = jnp.cross(e1, e2)
    n_raw = normalize(cr)
    area = jnp.linalg.norm(cr, axis=-1) * 0.5

    l_dir = p - hit_p
    dist_sq = _dot(l_dir, l_dir)
    dist = jnp.sqrt(dist_sq)
    unit_l = l_dir / jnp.maximum(dist, 1e-20)[:, None]

    cos_theta_l = jnp.maximum(_dot(n_raw, -unit_l), 0.0)

    uv0 = scene.uv[vidx[:, 0]]
    uv1 = scene.uv[vidx[:, 1]]
    uv2 = scene.uv[vidx[:, 2]]
    tex_uv = uv0 * u[:, None] + uv1 * v[:, None] + uv2 * w[:, None]
    L = scene.tri_base_color[tcl]
    base_tex = scene.tri_tex[tcl][:, 0]
    L = L * sample_texture(scene.textures, base_tex, tex_uv)

    pdf = dist_sq / jnp.maximum(cos_theta_l * area, 1e-20) / lc_f
    valid = any_light & (cos_theta_l >= 1e-6) & (area > 0.0)
    pdf = jnp.where(valid, pdf, 0.0)
    return LightSample(L, unit_l, dist, pdf)


def get_light_pdf(scene, tri_idx, inst_idx, t, l_dir):
    """pdf that NEE would have sampled this emissive hit (wgsl:401-421)."""
    v0, v1, v2, _, _ = _light_tri_world(scene, tri_idx, inst_idx)
    e1 = v1 - v0
    e2 = v2 - v0
    cr = jnp.cross(e1, e2)
    area = jnp.linalg.norm(cr, axis=-1) * 0.5
    normal = normalize(cr)
    cos_theta_l = jnp.maximum(_dot(normal, -l_dir), 0.0)
    lc_f = jnp.maximum(scene.light_count.astype(jnp.float32), 1.0)
    pdf = (t * t) / jnp.maximum(cos_theta_l * area, 1e-20) / lc_f
    return jnp.where(cos_theta_l >= 1e-4, pdf, 0.0)


# ---------------------------------------------------------------------------
# The bounce loop (wgsl ray_color :607-783)
# ---------------------------------------------------------------------------


def ray_color(scene, ro, rd, rng, max_depth: int):
    """Trace rays to completion. Returns (radiance (R,3), rng, rays):
    `rays` is the EXACT count of rays traced (primary + NEE shadow +
    extension lanes actually queried), the honest Mrays/s numerator —
    same accounting as ops/dense_trace.ray_color_dense."""
    R = ro.shape[0]
    f32 = jnp.float32

    primary = intersect_closest(scene, ro, rd)
    active0 = primary.inst_idx >= 0
    hd = load_hit(scene, ro, rd, primary.tri_idx, primary.inst_idx)

    class _S(NamedTuple):
        active: jnp.ndarray
        ro: jnp.ndarray
        rd: jnp.ndarray
        throughput: jnp.ndarray
        radiance: jnp.ndarray
        rng: jnp.ndarray
        prev_pdf: jnp.ndarray
        specular_bounce: jnp.ndarray
        tri: jnp.ndarray
        inst: jnp.ndarray
        hit_t: jnp.ndarray
        tex_uv: jnp.ndarray
        normal: jnp.ndarray
        geom_n: jnp.ndarray
        albedo: jnp.ndarray
        rays: jnp.ndarray  # () f32 — rays traced so far

    state = _S(
        active=active0,
        ro=ro,
        rd=rd,
        throughput=jnp.ones((R, 3), f32),
        radiance=jnp.zeros((R, 3), f32),
        rng=rng,
        prev_pdf=jnp.zeros(R, f32),
        specular_bounce=jnp.ones(R, bool),
        tri=primary.tri_idx,
        inst=primary.inst_idx,
        hit_t=hd.hit_t,
        tex_uv=hd.tex_uv,
        normal=hd.normal,
        geom_n=hd.world_geom_n,
        albedo=hd.albedo,
        rays=jnp.asarray(float(R), f32),  # primary rays
    )

    def body(depth, s: _S):
        tcl = jnp.clip(s.tri, 0, scene.tri_v.shape[0] - 1)
        mat = scene.tri_mat[tcl]
        mrir = scene.tri_mrir[tcl]
        tex = scene.tri_tex[tcl]
        emissive0 = scene.tri_emissive[tcl]

        hit_p = s.ro + s.rd * s.hit_t[:, None]

        # Face normals against the incoming ray (wgsl:660-661).
        normal = jnp.where((_dot(s.rd, s.normal) < 0.0)[:, None], s.normal, -s.normal)
        geom_n = jnp.where((_dot(s.rd, s.geom_n) < 0.0)[:, None], s.geom_n, -s.geom_n)

        metallic = mrir[:, 0]
        roughness = mrir[:, 1]
        mr = sample_texture(scene.textures, tex[:, 1], s.tex_uv)
        metallic = jnp.where(tex[:, 1] >= 0, metallic * mr[:, 2], metallic)
        roughness = jnp.where(tex[:, 1] >= 0, roughness * mr[:, 1], roughness)
        roughness = jnp.maximum(roughness, 0.005)
        ior = mrir[:, 2]

        emissive = emissive0 * jnp.where(
            (tex[:, 3] >= 0)[:, None], sample_texture(scene.textures, tex[:, 3], s.tex_uv), 1.0
        )

        f0 = 0.04 + (s.albedo - 0.04) * metallic[:, None]  # mix(0.04, albedo, m)

        # --- Emissive / light hit with MIS (wgsl:677-682) ---
        is_light = mat == 3
        has_em = is_light | (jnp.linalg.norm(emissive, axis=-1) > 1e-4)
        em_val = jnp.where(is_light[:, None], s.albedo, emissive)
        light_pdf = get_light_pdf(scene, s.tri, s.inst, s.hit_t, s.rd)
        mis_w = jnp.where(
            s.specular_bounce, 1.0, power_heuristic(s.prev_pdf, light_pdf)
        )
        radiance = s.radiance + jnp.where(
            (s.active & has_em)[:, None], s.throughput * em_val * mis_w[:, None], 0.0
        )
        active = s.active & ~is_light

        # --- NEE with shadow ray (wgsl:684-698) ---
        rng, (r0, r1, r2) = rand_n(s.rng, 3)
        ls = sample_light_source(scene, hit_p, r0, r1, r2)
        nee_lane = active & (mat != 2) & (ls.pdf > 0.0)
        eps = _offset_eps(hit_p)
        occluded = intersect_shadow(
            scene,
            hit_p + geom_n * eps[:, None],
            ls.dir,
            t_max=ls.dist - 2.0 * jnp.maximum(eps, _offset_eps(hit_p + ls.dir * ls.dist[:, None])),
            active=nee_lane,
        )
        n_dot_l = jnp.maximum(_dot(normal, ls.dir), 0.0)
        bsdf_diff = bsdf.eval_diffuse(s.albedo)
        pdf_diff = n_dot_l / PI
        bsdf_metal = bsdf.eval_ggx(normal, -s.rd, ls.dir, roughness, f0)
        pdf_metal = bsdf.ggx_pdf(normal, -s.rd, ls.dir, roughness)
        bsdf_val = jnp.where((mat == 0)[:, None], bsdf_diff, bsdf_metal)
        bsdf_pdf = jnp.where(mat == 0, pdf_diff, pdf_metal)
        contrib = (
            s.throughput
            * bsdf_val
            * ls.L
            * (power_heuristic(ls.pdf, bsdf_pdf) * n_dot_l /
               jnp.maximum(ls.pdf, 1e-20))[:, None]
        )
        take = nee_lane & ~occluded & (bsdf_pdf > 0.0)
        radiance = radiance + jnp.where(take[:, None], contrib, 0.0)

        # --- BSDF sampling (wgsl:700-707) ---
        rng, (s1, s2) = rand_n(rng, 2)
        sc_d = bsdf.sample_diffuse(normal, s.albedo, s1, s2)
        sc_m = bsdf.sample_ggx(normal, -s.rd, roughness, f0, s1, s2)
        sc_g = bsdf.sample_dielectric(s.rd, normal, ior, s.albedo, s1)

        is_m = (mat == 1)[:, None]
        is_g = (mat == 2)[:, None]
        dirn = jnp.where(is_g, sc_g.dir, jnp.where(is_m, sc_m.dir, sc_d.dir))
        pdf = jnp.where(is_g[:, 0], sc_g.pdf, jnp.where(is_m[:, 0], sc_m.pdf, sc_d.pdf))
        tp = jnp.where(is_g, sc_g.throughput, jnp.where(is_m, sc_m.throughput, sc_d.throughput))
        is_spec = jnp.where(
            is_g[:, 0], sc_g.is_specular, jnp.where(is_m[:, 0], sc_m.is_specular, sc_d.is_specular)
        )

        # Geometric-normal guard for non-dielectrics (wgsl:709-712).
        bad = (mat != 2) & (_dot(dirn, geom_n) <= 0.0)
        pdf = jnp.where(bad, 0.0, pdf)
        tp = jnp.where(bad[:, None], 0.0, tp)

        active = active & (pdf > 0.0) & (jnp.linalg.norm(tp, axis=-1) > 0.0)
        throughput = jnp.where(active[:, None], s.throughput * tp, s.throughput)

        off_n = jnp.where((_dot(dirn, geom_n) > 0.0)[:, None], geom_n, -geom_n)
        new_ro = hit_p + off_n * eps[:, None]
        ro_next = jnp.where(active[:, None], new_ro, s.ro)
        rd_next = jnp.where(active[:, None], dirn, s.rd)
        prev_pdf = jnp.where(active, pdf, s.prev_pdf)
        specular_bounce = jnp.where(active, is_spec, s.specular_bounce)

        # --- Russian roulette after depth 3 (wgsl:724-728) ---
        rng, rr = rand_pcg(rng)
        p = jnp.max(throughput, axis=-1)
        do_rr = active & (depth > 3)
        active = active & ~(do_rr & (rr > p))
        throughput = jnp.where(
            (do_rr & (rr <= p))[:, None], throughput / jnp.maximum(p, 1e-20)[:, None],
            throughput,
        )

        # --- Next intersection (wgsl:731-780) ---
        do_next = active & (depth < max_depth - 1)
        nxt = intersect_closest(scene, ro_next, rd_next, active=do_next)
        found = do_next & (nxt.inst_idx >= 0)
        hdn = load_hit(scene, ro_next, rd_next, nxt.tri_idx, nxt.inst_idx)
        active = jnp.where(depth < max_depth - 1, found, active)

        tri = jnp.where(found, nxt.tri_idx, s.tri)
        inst = jnp.where(found, nxt.inst_idx, s.inst)
        hit_t = jnp.where(found, hdn.hit_t, s.hit_t)
        tex_uv = jnp.where(found[:, None], hdn.tex_uv, s.tex_uv)
        nrm_new = jnp.where(found[:, None], hdn.normal, normal)
        geo_new = jnp.where(found[:, None], hdn.world_geom_n, geom_n)
        alb = jnp.where(found[:, None], hdn.albedo, s.albedo)

        rays = s.rays + nee_lane.sum(dtype=jnp.float32) \
            + do_next.sum(dtype=jnp.float32)
        return _S(active, ro_next, rd_next, throughput, radiance, rng, prev_pdf,
                  specular_bounce, tri, inst, hit_t, tex_uv, nrm_new, geo_new,
                  alb, rays)

    out = jax.lax.fori_loop(0, max_depth, body, state)
    return out.radiance, out.rng, out.rays


# ---------------------------------------------------------------------------
# Per-frame entry: camera rays + SPP loop + accumulation (wgsl main :791-819)
# ---------------------------------------------------------------------------


def camera_unpack(camera24):
    return dict(
        origin=camera24[0:3],
        lens_radius=camera24[3],
        lower_left=camera24[4:7],
        horizontal=camera24[8:11],
        vertical=camera24[12:15],
        u_axis=camera24[16:19],
        v_axis=camera24[20:23],
    )


def trace_pixels(scene, camera24, frame_count, jitter, width: int, height: int,
                 spp: int, max_depth: int, row0=0, full_height: int | None = None,
                 total_spp: int | None = None, sample0=0,
                 with_stats: bool = False):
    """Render one frame's radiance: returns (H*W, 3) averaged over spp;
    with with_stats=True, returns (radiance, rays) with the exact traced-ray
    count (same contract as ops.dense_trace.trace_pixels_dense).

    row0/full_height support tile sharding (this call renders rows
    [row0, row0+height) of a full_height-tall frame with globally-consistent
    pixel indices and jitter); sample0/total_spp support sample sharding
    (this call renders samples [sample0, sample0+spp) of a total_spp-sample
    frame with globally-consistent RNG streams).
    """
    if full_height is None:
        full_height = height
    if total_spp is None:
        total_spp = spp
    cam = camera_unpack(camera24)
    R = width * height
    lane = jnp.arange(R, dtype=jnp.uint32)
    px = (lane % jnp.uint32(width)).astype(jnp.float32)
    gy = lane // jnp.uint32(width) + jnp.asarray(row0, jnp.uint32)
    py = gy.astype(jnp.float32)
    p_idx = gy * jnp.uint32(width) + (lane % jnp.uint32(width))

    def one_sample(i, acc):
        rng = init_rng(
            p_idx,
            frame_count.astype(jnp.uint32) * jnp.uint32(total_spp)
            + jnp.asarray(sample0, jnp.uint32) + i.astype(jnp.uint32),
        )
        # Thin-lens DoF offset (wgsl:800-804). Always consumes 2 draws so the
        # stream is scene-independent (the reference skips the draws when
        # lens_radius == 0; both are self-consistent estimators).
        rng, (dr1, dr2) = rand_n(rng, 2)
        dx, dy = bsdf.random_in_unit_disk(dr1, dr2)
        rdx = cam["lens_radius"] * dx
        rdy = cam["lens_radius"] * dy
        off = cam["u_axis"][None, :] * rdx[:, None] + cam["v_axis"][None, :] * rdy[:, None]

        u = (px + 0.5 + jitter[0] * width) / width
        v = 1.0 - (py + 0.5 + jitter[1] * full_height) / full_height
        d = (cam["lower_left"][None, :]
             + u[:, None] * cam["horizontal"][None, :]
             + v[:, None] * cam["vertical"][None, :]
             - cam["origin"][None, :] - off)
        ro = cam["origin"][None, :] + off
        col, _, rays = ray_color(scene, ro, d, rng, max_depth)
        acc_col, acc_rays = acc
        return acc_col + col, acc_rays + rays

    col, rays = jax.lax.fori_loop(
        0, spp, one_sample,
        (jnp.zeros((R, 3), jnp.float32), jnp.zeros((), jnp.float32)))
    if with_stats:
        return col / spp, rays
    return col / spp


def accumulate(prev_acc, col, frame_count):
    """Progressive sum+count accumulation (wgsl:812-818). acc is (R, 4)."""
    sample = jnp.concatenate([col, jnp.ones_like(col[:, :1])], axis=-1)
    return jnp.where(frame_count > 1, prev_acc + sample, sample)
