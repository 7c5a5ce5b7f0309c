"""Device traversal vs brute-force numpy oracle.

The stackless TLAS->BLAS walk (ops/intersect.py) must agree with a direct
all-triangles intersector on (t, tri_idx, inst_idx) for random rays.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from webgpu_raytracer_tpu.models.native import NativeWorld
from webgpu_raytracer_tpu.ops.intersect import intersect_closest, intersect_shadow
from webgpu_raytracer_tpu.render.resources import build_device_scene

from tests.oracle import intersect_brute


def random_rays(rng, n, lo=-3.0, hi=3.0):
    ro = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("scene_name", ["cornell", "special", "mesh", "viewer"])
def test_closest_hit_matches_oracle(scene_name):
    rng = np.random.default_rng(7)
    world = NativeWorld(scene_name)
    scene = build_device_scene(world)
    ro, rd = random_rays(rng, 256)

    hit = intersect_closest(scene, jnp.asarray(ro), jnp.asarray(rd))
    t_ref, tri_ref, inst_ref = intersect_brute(world, ro.astype(np.float64), rd.astype(np.float64))

    got_inst = np.asarray(hit.inst_idx)
    got_tri = np.asarray(hit.tri_idx)
    got_t = np.asarray(hit.t)

    miss_ref = inst_ref < 0
    # hits/misses must agree except for borderline f32-vs-f64 cases; require
    # exact agreement on at least 99% of rays and t agreement on joint hits.
    agree = (got_inst >= 0) == ~miss_ref
    assert agree.mean() > 0.99, f"hit/miss disagreement {1 - agree.mean():.3f}"

    both = (~miss_ref) & (got_inst >= 0) & agree
    np.testing.assert_allclose(got_t[both], t_ref[both], rtol=2e-3, atol=2e-4)
    # Triangle ids may differ where coplanar surfaces tie at equal t (e.g.
    # box faces resting on the floor plane), so only require a large majority
    # to match exactly — the t agreement above already pins the geometry.
    same_tri = got_tri[both] == tri_ref[both]
    assert same_tri.mean() > 0.9


def test_shadow_consistent_with_closest():
    rng = np.random.default_rng(11)
    world = NativeWorld("cornell")
    scene = build_device_scene(world)
    ro, rd = random_rays(rng, 512, lo=-0.9, hi=0.9)
    ro[:, 1] = np.abs(ro[:, 1]) + 0.05  # inside the box

    hit = intersect_closest(scene, jnp.asarray(ro), jnp.asarray(rd))
    t = np.asarray(hit.t)
    has_hit = np.asarray(hit.inst_idx) >= 0

    # Shadow query up to just beyond the closest hit must report occlusion.
    occ = np.asarray(
        intersect_shadow(scene, jnp.asarray(ro), jnp.asarray(rd),
                         t_max=jnp.asarray(t + 1e-2))
    )
    assert (occ[has_hit]).all()

    # Shadow query stopping well before the closest hit must be clear.
    occ2 = np.asarray(
        intersect_shadow(scene, jnp.asarray(ro), jnp.asarray(rd),
                         t_max=jnp.asarray(np.maximum(t * 0.5, 2e-3)))
    )
    assert not occ2[has_hit].any()


def test_inactive_lanes_do_not_hit():
    world = NativeWorld("cornell")
    scene = build_device_scene(world)
    ro = jnp.zeros((8, 3), jnp.float32) + jnp.asarray([0.0, 1.0, 0.0])
    rd = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (8, 1))
    active = jnp.asarray([True, False] * 4)
    hit = intersect_closest(scene, ro, rd, active=active)
    inst = np.asarray(hit.inst_idx)
    assert (inst[::2] >= 0).all()
    assert (inst[1::2] == -1).all()


def _big_grid_obj(n=93):
    """A bumpy (n-1)^2 * 2-triangle grid: 16,928 triangles for n = 93."""
    verts, faces = [], []
    for j in range(n):
        for i in range(n):
            verts.append((i / (n - 1) * 2 - 1, ((i * 7 + j * 3) % 5) * 0.02,
                          j / (n - 1) * 2 - 1))
    for j in range(n - 1):
        for i in range(n - 1):
            a = j * n + i + 1
            faces.append((a, a + 1, a + n))
            faces.append((a + 1, a + n + 1, a + n))
    return "".join(f"v {x} {y} {z}\n" for x, y, z in verts) + \
        "".join(f"f {a} {b} {c}\n" for a, b, c in faces)


def test_large_scene_takes_the_bvh_walk_and_matches_oracle():
    """Above DENSE_MAX_TRIS world triangles the renderer takes the BVH path;
    its walk agrees with the brute-force oracle there."""
    from webgpu_raytracer_tpu import RenderConfig, Renderer
    from webgpu_raytracer_tpu.ops.api import DENSE_MAX_TRIS

    r = Renderer("viewer", obj_source=_big_grid_obj(),
                 config=RenderConfig(width=8, height=8, max_depth=2))
    assert r._world_tri_count() > DENSE_MAX_TRIS
    assert r.backend == "bvh" and r.wt is None

    rng = np.random.default_rng(3)
    ro, rd = random_rays(rng, 96, lo=-1.0, hi=1.0)
    ro[:, 1] = 2.0
    rd[:, 1] = -np.abs(rd[:, 1]) - 0.5
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    hit = intersect_closest(r.scene, jnp.asarray(ro), jnp.asarray(rd))
    t_ref, tri_ref, inst_ref = intersect_brute(
        r.world, ro.astype(np.float64), rd.astype(np.float64))
    got = np.asarray(hit.inst_idx) >= 0
    assert (got == (inst_ref >= 0)).mean() > 0.99
    both = got & (inst_ref >= 0)
    assert both.sum() > 50
    np.testing.assert_allclose(np.asarray(hit.t)[both], t_ref[both],
                               rtol=2e-3, atol=2e-4)

    r.render_frame()
    assert np.isfinite(r.radiance()).all()
