"""Backend dispatch: dense (all-pairs sweep) vs bvh (per-ray BVH walk).

`dense` is the main path for scenes up to DENSE_MAX_TRIS world triangles
(all presets except `spheres`); `bvh` is the general path for large scenes.
Both produce the same estimator with the same per-(pixel, frame, sample)
RNG streams. Which sweep implementation the dense path runs (GPU kernel or
XLA reference) is chosen by ops/sweep.on_platform, not here.
"""

from __future__ import annotations

from .dense_trace import trace_pixels_dense
from .trace import trace_pixels

DENSE_MAX_TRIS = 16384


def choose_backend(world_tri_count: int) -> str:
    """The scene-size rule: the dense sweep costs O(rays x triangles), so
    scenes above DENSE_MAX_TRIS world triangles take the BVH walk."""
    return "dense" if world_tri_count <= DENSE_MAX_TRIS else "bvh"


def get_tracer(backend: str):
    """Returns tracer(scene, camera, frame_count, jitter, width, height,
    spp, max_depth, **shard_offsets).

    For `dense`, scene is the pytree (WorldTris, textures); for `bvh` it is a
    DeviceScene.
    """
    if backend == "dense":
        def tracer(scene, *args, **kwargs):
            wt, textures = scene
            return trace_pixels_dense(wt, textures, *args, **kwargs)
        return tracer
    if backend == "bvh":
        return trace_pixels
    raise ValueError(f"unknown backend {backend!r}")
