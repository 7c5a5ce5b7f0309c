"""The dense sweep kernel under interpret mode inside fori_loop + jit.

The kernel body (ops/sweep._sweep_kernel) runs through
`pl.pallas_call(interpret=True)` inside a `lax.fori_loop` under jit: a
loop-carried trace inside jit is the context in which XLA's excess-precision
rewrites can change a kernel's arithmetic, so the test pins it there. The
tolerances are those of tests/sweep_checks.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from webgpu_raytracer_tpu.models.native import NativeWorld
from webgpu_raytracer_tpu.ops import sweep
from webgpu_raytracer_tpu.ops.dense import dense_closest, dense_shadow
from webgpu_raytracer_tpu.render.worldtris import build_world_tris

from tests.sweep_checks import check_closest, check_occluded


@pytest.fixture(scope="module")
def cornell_wt():
    world = NativeWorld("cornell")
    world.update_camera(64, 64)
    wt = build_world_tris(world)
    assert not sweep.multi_chunk(wt), "cornell must stay one chunk"
    return wt


def _rays(R=2048):
    rng = np.random.default_rng(3)
    ro = rng.uniform(-0.9, 0.9, size=(R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    act = np.arange(R) % 5 != 0
    tmax = np.where(np.arange(R) % 3 == 0, 1.5, 1e30).astype(np.float32)
    return ro, rd, act, tmax


def test_single_tile_kernel_in_jitted_loop(cornell_wt):
    """Closest-hit + rows + shadow, interpret mode, inside fori_loop+jit."""
    wt = cornell_wt
    ro, rd, act, tmax = _rays()
    comp = lambda a: (a[:, 0], a[:, 1], a[:, 2])
    t_ref, i_ref = dense_closest(wt, jnp.asarray(ro), jnp.asarray(rd),
                                 t_max=tmax, active=act)

    @jax.jit
    def looped(ro, rd):
        def body(i, acc):
            return sweep.kernel_closest(wt, comp(ro), comp(rd), t_max=tmax,
                                        active=act, rows_from=0,
                                        interpret=True)
        return jax.lax.fori_loop(0, 2, body, (
            jnp.zeros_like(tmax), jnp.zeros(tmax.shape, jnp.int32),
            jnp.zeros((wt.shade_table.shape[1], tmax.shape[0]))))

    t2, i2, rows = looped(jnp.asarray(ro), jnp.asarray(rd))
    rep = check_closest(wt, ro, rd, t2, i2, t_ref, i_ref, rows)
    assert rep["ok"], str(rep)

    occ_ref = dense_shadow(wt, jnp.asarray(ro), jnp.asarray(rd), t_max=tmax,
                           active=act)
    occ2 = sweep.kernel_occluded(wt, comp(jnp.asarray(ro)),
                                 comp(jnp.asarray(rd)), tmax, active=act,
                                 interpret=True)
    rep = check_occluded(wt, ro, rd, tmax, occ2, occ_ref)
    assert rep["ok"], str(rep)
