"""Golden statistics per preset: Monte-Carlo-aware regression guards.

The BASELINE criterion is "images match within Monte Carlo noise"; these
tests pin the mean radiance of low-res renders so estimator regressions
(e.g. broken MIS weights or NEE pdfs) are caught without bit-exact golden
images. Values were recorded from the validated build (dense == bvh ==
f64-oracle traversal) on the CPU backend the suite runs on.

Coverage: all six presets — including the metal/glass/caustics branches
(`mixed`, `special`), instancing (`mesh`) and the 257k-tri `spheres`
(through the chunked XLA dense sweep here) — plus a textured-GLB frame (texture-array sampling) and a
skinned-animation frame at t=0.5 (LBS + per-update BLAS rebuild).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from webgpu_raytracer_tpu.models.native import NativeWorld
from webgpu_raytracer_tpu.ops.dense_trace import trace_pixels_dense
from webgpu_raytracer_tpu.render.resources import build_device_scene
from webgpu_raytracer_tpu.render.worldtris import build_world_tris

from tests.glb_fixture import skinned_strip_glb, textured_quad_glb

# name -> (scene, depth, frames, res, glb_factory, anim_t, expected, tol).
# Tolerances are ~5 sigma of the frame-averaged MC estimate (~10-15% of the
# mean; caustic-heavy presets get the wider bound).
GOLDEN = {
    "cornell": ("cornell", 5, 8, 32, None, None, 0.2597, 0.03),
    "viewer": ("viewer", 4, 8, 32, None, None, 0.5219, 0.05),
    "mixed": ("mixed", 5, 8, 32, None, None, 0.2216, 0.025),
    "special": ("special", 5, 8, 32, None, None, 0.1355, 0.02),
    "mesh": ("mesh", 4, 8, 32, None, None, 0.1796, 0.022),
    "spheres": ("spheres", 3, 2, 16, None, None, 0.0382, 0.006),
    "textured_glb": ("viewer", 4, 8, 32, textured_quad_glb, None,
                     0.5185, 0.05),
    "skinned_glb_t05": ("viewer", 4, 8, 32, skinned_strip_glb, 0.5,
                        0.5369, 0.05),
}


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_mean_radiance(case):
    scene_name, depth, frames, res, glb_factory, anim_t, expected, tol = \
        GOLDEN[case]
    world = NativeWorld(scene_name,
                        glb_data=glb_factory() if glb_factory else None)
    if anim_t is not None:
        world.update(anim_t)
    world.update_camera(res, res)
    wt = build_world_tris(world)
    scene = build_device_scene(world)
    cam = jnp.asarray(world.camera())
    acc = np.zeros((res * res, 3), np.float32)
    for f in range(1, frames + 1):
        col = trace_pixels_dense(wt, scene.textures, cam,
                                 jnp.asarray(f, jnp.int32),
                                 jnp.zeros(2, jnp.float32), res, res, 1,
                                 depth)
        acc += np.asarray(col)
    mean = float(acc.mean()) / frames
    assert abs(mean - expected) < tol, (
        f"{case}: mean radiance {mean:.4f} departed from golden "
        f"{expected} +- {tol}")
