"""Primary-visibility G-buffer pass.

Capability parity with the reference rasterizer (src/shaders/Rasterizer.wgsl
+ RasterizerPass.ts): produces, per pixel, albedo (base_color x base
texture), the octahedral-packed shading normal, the hit triangle and
instance ids, and normalized depth — the exact MRT layout the reference's
raytrace kernel reads for bounce 0 (Raytracer.wgsl:617-654).

There is no rasterizer here; a primary-ray cast through the same
ray-traced camera (the reference manually reconstructs that camera's
view-projection so raster == primary rays, Rasterizer.wgsl:110-150) produces
the identical hit set, so this pass is implemented with the dense
intersector. The main render path folds bounce 0 into the trace loop (same
math); this standalone pass exists for feature parity and for denoisers /
tooling that want G-buffer outputs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .dense_trace import intersect_and_shade
from .trace import camera_unpack
from .tune import DEFAULT_TUNE, TuneConfig
from .v3 import V3
from ..render.worldtris import SHADE_COLS, WorldTris


class GBuffer(NamedTuple):
    albedo: jnp.ndarray       # (H, W, 3) f32
    normal_oct: jnp.ndarray   # (H, W, 2) f32 octahedral-packed
    tri_idx: jnp.ndarray      # (H, W) i32 topology index (-1 miss)
    inst_idx: jnp.ndarray     # (H, W) i32 instance index (-1 miss)
    depth: jnp.ndarray        # (H, W) f32 in [0, 1]; 1.0 = miss
    # Extra id channel: the world-triangle table row, so the
    # seeded bounce-0 path re-fetches the shade row with one gather instead
    # of the reference's (tri, inst) -> topology -> object-space round trip
    # (Raytracer.wgsl:617-654); information content is identical.
    wt_idx: jnp.ndarray       # (H, W) i32 world-tri row (-1 miss)


def pack_normal_oct(n: V3):
    """Octahedral normal encoding (Raytracer.wgsl:116-119)."""
    denom = jnp.abs(n.x) + jnp.abs(n.y) + jnp.abs(n.z)
    px = n.x / jnp.maximum(denom, 1e-20)
    py = n.y / jnp.maximum(denom, 1e-20)
    sx = jnp.where(px >= 0.0, 1.0, -1.0)
    sy = jnp.where(py >= 0.0, 1.0, -1.0)
    wrap_x = (1.0 - jnp.abs(py)) * sx
    wrap_y = (1.0 - jnp.abs(px)) * sy
    ox = jnp.where(n.z < 0.0, wrap_x, px)
    oy = jnp.where(n.z < 0.0, wrap_y, py)
    return ox, oy


def unpack_normal_oct(ox, oy) -> V3:
    """Inverse of pack_normal_oct (Raytracer.wgsl:121-127)."""
    z = 1.0 - jnp.abs(ox) - jnp.abs(oy)
    t = jnp.clip(-z, 0.0, 1.0)
    x = ox + jnp.where(ox >= 0.0, -t, t)
    y = oy + jnp.where(oy >= 0.0, -t, t)
    inv = 1.0 / jnp.maximum(jnp.sqrt(x * x + y * y + z * z), 1e-20)
    return V3(x * inv, y * inv, z * inv)


def render_gbuffer(wt: WorldTris, textures, camera24, width: int, height: int,
                   jitter=None, z_near: float = 0.01, z_far: float = 100.0,
                   tune: TuneConfig = DEFAULT_TUNE) -> GBuffer:
    """Cast primary rays and emit the G-buffer MRT set."""
    cam = camera_unpack(camera24)
    R = width * height
    lane = jnp.arange(R, dtype=jnp.uint32)
    px = (lane % jnp.uint32(width)).astype(jnp.float32)
    py = (lane // jnp.uint32(width)).astype(jnp.float32)
    jx = 0.0 if jitter is None else jitter[0]
    jy = 0.0 if jitter is None else jitter[1]
    u = (px + 0.5 + jx * width) / width
    v = 1.0 - (py + 0.5 + jy * height) / height

    c = camera24
    ro = V3(jnp.broadcast_to(c[0], (R,)), jnp.broadcast_to(c[1], (R,)),
            jnp.broadcast_to(c[2], (R,)))
    rd = V3(
        c[4] + u * c[8] + v * c[12] - c[0],
        c[5] + u * c[9] + v * c[13] - c[1],
        c[6] + u * c[10] + v * c[14] - c[2],
    )
    del cam

    hit = intersect_and_shade(wt, textures, ro, rd, jnp.ones(R, bool),
                              tune=tune)
    found = hit.wt >= 0

    rowT = hit.rowT
    tri = jnp.where(found, rowT[SHADE_COLS["tri_idx"][0]].astype(jnp.int32), -1)
    inst = jnp.where(found, rowT[SHADE_COLS["inst_idx"][0]].astype(jnp.int32),
                     -1)

    ox, oy = pack_normal_oct(hit.normal)
    # Perspective-style normalized depth from hit distance along the view ray
    # (the raster depth buffer analogue; 1.0 encodes a miss, wgsl:619).
    dlen = jnp.sqrt(rd.x**2 + rd.y**2 + rd.z**2)
    dist = hit.hit_t * dlen
    zn, zf = z_near, z_far
    depth = (zf / (zf - zn)) * (1.0 - zn / jnp.maximum(dist, 1e-20))
    depth = jnp.where(found, jnp.clip(depth, 0.0, 0.999999), 1.0)

    def img(a):
        return a.reshape(height, width)

    albedo = jnp.stack(
        [img(hit.albedo.x), img(hit.albedo.y), img(hit.albedo.z)], axis=-1)
    albedo = jnp.where(found.reshape(height, width, 1), albedo, 0.0)
    normal_oct = jnp.stack([img(ox), img(oy)], axis=-1)
    return GBuffer(albedo, normal_oct, img(tri), img(inst), img(depth),
                   img(jnp.where(found, hit.wt, -1)))
