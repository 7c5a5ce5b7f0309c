"""Multi-device sharding equivalence: sharded render == single-device render.

Deterministic counter-based RNG (ops/rng.py) makes tile sharding bit-exact;
sample sharding differs only by psum summation order (tolerance ~1e-6).
Runs on the 8-virtual-CPU-device mesh from conftest, for both backends: the
BVH walk and the dense sweep (the main path, which the 4-GPU run of
chip_smoke.py --multi exercises on cards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webgpu_raytracer_tpu.models.native import NativeWorld
from webgpu_raytracer_tpu.ops.api import get_tracer
from webgpu_raytracer_tpu.ops.trace import accumulate
from webgpu_raytracer_tpu.parallel.sharding import (
    make_mesh,
    sample_sharded_step,
    tile_sharded_step,
    tile_sample_sharded_step,
)
from webgpu_raytracer_tpu.render.resources import build_device_scene
from webgpu_raytracer_tpu.render.worldtris import build_world_tris

DEPTH = 3
# Frame side per backend. The dense path at 16x16 leaves 32 lanes per device,
# where XLA's CPU code generation for the shard differs from the whole
# frame's (near-tie winner flips); 64x64 compiles alike.
SIDE = {"bvh": 16, "dense": 64}
BACKENDS = list(SIDE)


@pytest.fixture(scope="module")
def setup():
    world = NativeWorld("cornell")
    world.update_camera(16, 16)  # square: the same camera at every side
    scene = build_device_scene(world, pad_nodes_to=32, pad_tris_to=64,
                               pad_verts_to=64)
    scenes = {"bvh": scene, "dense": (build_world_tris(world),
                                      scene.textures)}
    camera = jnp.asarray(world.camera())
    return scenes, camera


def reference_render(scene, camera, spp, backend):
    n = SIDE[backend]
    col = get_tracer(backend)(scene, camera, jnp.asarray(1, jnp.int32),
                              jnp.zeros(2, jnp.float32), n, n, spp, DEPTH)
    return np.asarray(accumulate(jnp.zeros((n * n, 4)), col,
                                 jnp.asarray(1, jnp.int32)))


def _run(step, scene, camera, backend):
    n = SIDE[backend]
    return step(scene, camera, jnp.asarray(1, jnp.int32),
                jnp.zeros(2, jnp.float32), jnp.zeros((n * n, 4)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_tile_sharding_bit_exact(setup, backend):
    scenes, camera = setup
    ref = reference_render(scenes[backend], camera, 2, backend)
    mesh = make_mesh()
    assert mesh.devices.size == 8
    n = SIDE[backend]
    step = tile_sharded_step(mesh, n, n, spp=2, max_depth=DEPTH,
                             backend=backend)
    out = _run(step, scenes[backend], camera, backend)
    # each row band lives on its own device
    assert {s.device for s in out.addressable_shards} == set(jax.devices())
    np.testing.assert_array_equal(np.asarray(out), ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sample_sharding_matches(setup, backend):
    scenes, camera = setup
    ref = reference_render(scenes[backend], camera, 8, backend)
    n = SIDE[backend]
    step = sample_sharded_step(make_mesh(), n, n, spp_total=8,
                               max_depth=DEPTH, backend=backend)
    out = _run(step, scenes[backend], camera, backend)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tile_sample_2d_mesh(setup, backend):
    scenes, camera = setup
    ref = reference_render(scenes[backend], camera, 4, backend)
    devices = jax.devices()[:8]
    mesh = jax.sharding.Mesh(np.array(devices).reshape(4, 2),
                             ("tile", "sample"))
    n = SIDE[backend]
    step = tile_sample_sharded_step(mesh, n, n, spp_total=4, max_depth=DEPTH,
                                    backend=backend)
    out = _run(step, scenes[backend], camera, backend)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-5, atol=2e-5)
    assert np.isfinite(np.asarray(out)).all()
