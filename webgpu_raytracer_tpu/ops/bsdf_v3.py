"""BSDF evaluation/sampling in component-SoA form (see ops/v3.py).

Functionally identical to ops/bsdf.py (whose docstrings map each function to
the reference kernels, Raytracer.wgsl:191-339); this is the (R,)-lanes
version used by the dense path. Colors are V3 as well.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .v3 import V3, cross, dot, normalize, where

PI = 3.141592653589793


def reflect(i: V3, n: V3) -> V3:
    return i - n * (2.0 * dot(n, i))


def refract(i: V3, n: V3, eta) -> V3:
    """WGSL refract(): zero vector on total internal reflection."""
    cos_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    ok = k >= 0.0
    out = i * eta - n * (eta * cos_i + jnp.sqrt(jnp.maximum(k, 0.0)))
    zero = V3(jnp.zeros_like(out.x), jnp.zeros_like(out.y), jnp.zeros_like(out.z))
    return where(ok, out, zero)


def build_onb(n: V3):
    sign = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    u = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    v = V3(b, sign + n.y * n.y * a, -n.y)
    return u, v


def local_to_world(u: V3, v: V3, w: V3, a: V3) -> V3:
    return u * a.x + v * a.y + w * a.z


def cosine_hemisphere(n: V3, r1, r2) -> V3:
    u, v = build_onb(n)
    phi = 2.0 * PI * r1
    cos_theta = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
    sin_theta = jnp.sqrt(jnp.maximum(r2, 0.0))
    local = V3(jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta)
    return local_to_world(u, v, n, local)


def random_in_unit_disk(r1, r2):
    r = jnp.sqrt(r1)
    theta = 2.0 * PI * r2
    return r * jnp.cos(theta), r * jnp.sin(theta)


class Scatter(NamedTuple):
    dir: V3
    pdf: jnp.ndarray
    throughput: V3
    is_specular: jnp.ndarray


def eval_diffuse(albedo: V3) -> V3:
    return albedo * (1.0 / PI)


def sample_diffuse(normal: V3, albedo: V3, r1, r2) -> Scatter:
    d = cosine_hemisphere(normal, r1, r2)
    cos_theta = jnp.maximum(dot(normal, d), 0.0)
    return Scatter(d, cos_theta / PI, albedo, jnp.zeros(r1.shape, bool))


def ggx_d(n_dot_h, a2):
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / (PI * d * d)


def ggx_g(n_dot_v, n_dot_l, a2):
    g1v = 2.0 * n_dot_v / (n_dot_v + jnp.sqrt(a2 + (1.0 - a2) * n_dot_v**2))
    g1l = 2.0 * n_dot_l / (n_dot_l + jnp.sqrt(a2 + (1.0 - a2) * n_dot_l**2))
    return g1v * g1l


def fresnel_schlick(cos_theta, f0: V3) -> V3:
    p = jnp.clip(1.0 - cos_theta, 0.0, 1.0) ** 5
    return f0 + (V3(p, p, p) - f0 * p)  # f0 + (1 - f0) * p


def eval_ggx(n: V3, v: V3, l: V3, roughness, f0: V3) -> V3:
    h = normalize(v + l)
    n_dot_v = jnp.maximum(dot(n, v), 1e-4)
    n_dot_l = jnp.maximum(dot(n, l), 1e-4)
    n_dot_h = jnp.maximum(dot(n, h), 1e-4)
    v_dot_h = jnp.maximum(dot(v, h), 1e-4)
    a2 = roughness * roughness
    d = ggx_d(n_dot_h, a2)
    g = ggx_g(n_dot_v, n_dot_l, a2)
    f = fresnel_schlick(v_dot_h, f0)
    return f * (d * g / (4.0 * n_dot_v * n_dot_l))


def ggx_pdf(n: V3, v: V3, l: V3, roughness):
    h = normalize(v + l)
    n_dot_h = dot(n, h)
    v_dot_h = jnp.maximum(dot(v, h), 0.0)
    return (ggx_d(n_dot_h, roughness * roughness) * jnp.maximum(n_dot_h, 0.0)) / (
        4.0 * jnp.maximum(v_dot_h, 1e-8)
    )


def sample_ggx(n: V3, v: V3, roughness, f0: V3, r1, r2) -> Scatter:
    a = roughness
    phi = 2.0 * PI * r1
    cos_theta = jnp.sqrt(jnp.maximum(0.0, (1.0 - r2) / (1.0 + (a * a - 1.0) * r2)))
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta**2))
    h_local = V3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)
    u, vv = build_onb(n)
    h = local_to_world(u, vv, n, h_local)
    l = reflect(-v, h)

    below = dot(n, l) <= 0.0

    n_dot_v = jnp.maximum(dot(n, v), 1e-4)
    n_dot_l = jnp.maximum(dot(n, l), 1e-4)
    n_dot_h = jnp.maximum(dot(n, h), 1e-4)
    v_dot_h = jnp.maximum(dot(v, h), 1e-4)

    a2 = a * a
    d = ggx_d(n_dot_h, a2)
    g = ggx_g(n_dot_v, n_dot_l, a2)
    f = fresnel_schlick(v_dot_h, f0)

    pdf = (d * n_dot_h) / (4.0 * v_dot_h)
    scale = jnp.where(pdf > 1e-6, g * v_dot_h / (n_dot_v * n_dot_h), 0.0)
    tp = f * scale
    pdf = jnp.where(below, 0.0, pdf)
    zero = jnp.zeros_like(pdf)
    tp = where(below, V3(zero, zero, zero), tp)
    l = where(below, V3(zero, zero, zero), l)
    return Scatter(l, pdf, tp, roughness < 0.01)


def reflectance_dielectric(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * jnp.clip(1.0 - cosine, 0.0, 1.0) ** 5


def sample_dielectric(dir: V3, normal: V3, ior, albedo: V3, r1) -> Scatter:
    front_face = dot(dir, normal) < 0.0
    ratio = jnp.where(front_face, 1.0 / ior, ior)
    n = where(front_face, normal, -normal)

    unit = normalize(dir)
    cos_theta = jnp.minimum(dot(-unit, n), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta**2, 0.0))

    cannot_refract = ratio * sin_theta > 1.0
    do_reflect = cannot_refract | (reflectance_dielectric(cos_theta, ratio) > r1)
    d = where(do_reflect, reflect(unit, n), refract(unit, n, ratio))
    ones = jnp.ones(r1.shape, jnp.float32)
    return Scatter(d, ones, albedo, jnp.ones(r1.shape, bool))


def power_heuristic(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return a2 / jnp.maximum(a2 + b2, 1e-20)
