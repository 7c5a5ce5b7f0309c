"""The GPU sweep kernel (ops/sweep.py) in Pallas interpret mode vs the XLA
reference (ops/dense.py), plus the implementation choice.

The kernel body runs under jit with its fori_loop over triangle tiles, on
single-chunk scenes (cornell) and scenes of many triangle tiles: bumpy grids,
well-separated patches, the mixed preset. The tolerances are those of
tests/sweep_checks.py; chip_smoke.py applies the same checks on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from webgpu_raytracer_tpu.models.native import NativeWorld
from webgpu_raytracer_tpu.ops import sweep
from webgpu_raytracer_tpu.ops.tune import TuneConfig
from webgpu_raytracer_tpu.render.worldtris import FEAT_K, build_world_tris

from tests.sweep_checks import compare, random_rays


def _obj_world(verts, faces):
    obj = "".join(f"v {x} {y} {z}\n" for x, y, z in verts) + \
          "".join(f"f {a} {b} {c}\n" for a, b, c in faces)
    world = NativeWorld("viewer", obj_source=obj)
    world.update_camera(64, 64)
    return world


def _grid_world(n=13):
    """A bumpy (n-1)^2*2-triangle grid in the viewer preset."""
    verts, faces = [], []
    for j in range(n):
        for i in range(n):
            verts.append((i / (n - 1) * 2 - 1, ((i * 7 + j * 3) % 5) * 0.1,
                          j / (n - 1) * 2 - 1))
    for j in range(n - 1):
        for i in range(n - 1):
            a = j * n + i + 1
            faces.append((a, a + 1, a + n))
            faces.append((a + 1, a + n + 1, a + n))
    return _obj_world(verts, faces)


def _ladder_world():
    """6 well-separated 9x9-vertex patches (128 tris each) along x."""
    verts, faces = [], []
    for k in range(6):
        base = len(verts)
        for j in range(9):
            for i in range(9):
                verts.append((3 * k - 0.5 + i / 8.0,
                              0.01 * ((i + j + k) % 3), -0.5 + j / 8.0))
        for j in range(8):
            for i in range(8):
                a = base + j * 9 + i + 1
                faces.append((a, a + 1, a + 9))
                faces.append((a + 1, a + 10, a + 9))
    return _obj_world(verts, faces)


def _preset(name):
    world = NativeWorld(name)
    world.update_camera(64, 64)
    return world


WORLDS = {
    "grid": lambda: _grid_world(),
    "grid_fine": lambda: _grid_world(n=37),
    "ladder": _ladder_world,
    "cornell": lambda: _preset("cornell"),
    "mixed": lambda: _preset("mixed"),
}
_WT = {}


def _wt(name):
    if name not in _WT:
        _WT[name] = build_world_tris(WORLDS[name]())
    return _WT[name]


def _rays(wt, case):
    """The ray sets: plain random rays, |d| = 10 (t units differ from world
    units), active lanes with t_max <= 0, and a lane count that is not a
    multiple of the kernel's ray block."""
    n = 1000 if case == "ragged" else 2 * sweep.RAY_BLOCK * 4
    ro, rd, t_max, act = random_rays(wt, n, seed=len(case),
                                     scale=10.0 if case == "unnormalized"
                                     else 1.0)
    if case == "tmax_le0":
        lane = np.arange(n)
        t_max = np.where(lane % 11 == 3, 0.0, t_max)
        t_max = np.where(lane % 13 == 4, -1.0, t_max).astype(np.float32)
    return ro, rd, t_max, act


CASES = [("closest", "plain"), ("any_hit", "plain"), ("fused", "plain"),
         ("closest", "unnormalized"), ("closest", "tmax_le0"),
         ("fused", "ragged")]


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("mode,case", CASES,
                         ids=[f"{m}-{c}" for m, c in CASES])
def test_kernel_matches_reference(world, mode, case):
    wt = _wt(world)
    ro, rd, t_max, act = _rays(wt, case)
    rep = compare(wt, ro, rd, t_max, act, mode, interpret=True)
    assert rep["ok"], str(rep)
    if mode != "any_hit":
        assert rep["hits"] > 0, rep


def test_multi_tile_worlds_span_many_tiles():
    assert _wt("grid").v0.shape[0] > sweep.TRI_TILE
    assert _wt("mixed").v0.shape[0] // sweep.TRI_TILE > 100
    assert _wt("cornell").v0.shape[0] < 128


def test_kernel_table_layout():
    wt = _wt("cornell")
    tab = np.asarray(sweep.kernel_table(wt.features))
    tw = wt.v0.shape[0]
    f = np.asarray(wt.features).reshape(FEAT_K, 5, tw)
    assert tab.shape == (sweep.KERNEL_ROWS, -(-tw // sweep.TRI_TILE)
                         * sweep.TRI_TILE)
    for g in range(3):
        np.testing.assert_array_equal(tab[6 * g:6 * g + 6, :tw], f[0:6, g])
    np.testing.assert_array_equal(tab[18:22, :tw], f[6:10, 3])
    np.testing.assert_array_equal(tab[22:25, :tw], f[0:3, 4])
    assert (tab[:, tw:] == 0).all()


def test_inactive_block_skips_and_misses():
    """All-inactive input: every lane misses, t is the caller's t_max."""
    wt = _wt("cornell")
    ro, rd, _, _ = random_rays(wt, 300, seed=1)
    comp = lambda a: tuple(jnp.asarray(a[:, k]) for k in range(3))
    t, idx = sweep.kernel_closest(wt, comp(ro), comp(rd), t_max=7.0,
                                  active=jnp.zeros(300, bool),
                                  interpret=True)
    assert (np.asarray(idx) == -1).all()
    assert (np.asarray(t) == 7.0).all()


def _lowered_text(fn, platform, tune=TuneConfig()):
    wt = _wt("cornell")
    ro = tuple(jnp.zeros(256) for _ in range(3))
    rd = tuple(jnp.ones(256) for _ in range(3))
    act = jnp.ones(256, bool)
    f = lambda ro, rd: fn(wt, ro, rd, act, tune=tune)
    return jax.jit(f).trace(ro, rd).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("fn", [sweep.closest,
                                lambda wt, ro, rd, a, tune: sweep.occluded(
                                    wt, ro, rd, 5.0, a, tune=tune)],
                         ids=["closest", "occluded"])
def test_cuda_lowering_runs_the_triton_kernel(fn):
    assert "triton" in _lowered_text(fn, "cuda")
    assert "triton" not in _lowered_text(fn, "cpu")


def test_reference_sweep_forces_xla_on_cuda():
    txt = _lowered_text(sweep.closest, "cuda",
                        TuneConfig(reference_sweep=True))
    assert "triton" not in txt


def test_unknown_platform_raises():
    """Only CUDA and the CPU have an implementation; lowering the sweep for
    any other platform JAX knows fails instead of falling back."""
    with pytest.raises(NotImplementedError):
        _lowered_text(sweep.closest, "rocm")


@pytest.mark.gpu
@pytest.mark.parametrize("world", ["cornell", "mixed"])
@pytest.mark.parametrize("mode", ["closest", "any_hit", "fused"])
def test_compiled_kernel_matches_reference_on_gpu(gpu, world, mode):
    """The same checks with the kernel compiled for the card (phase 2 of
    chip_smoke.py runs them at 262,144 rays)."""
    wt = _wt(world)
    ro, rd, t_max, act = random_rays(wt, 1 << 16, seed=5)
    rep = compare(wt, ro, rd, t_max, act, mode, interpret=False)
    assert rep["ok"], str(rep)


@pytest.mark.parametrize("world", ["grid", "ladder", "mixed"])
def test_tile_spheres_enclose_their_triangles(world):
    """Every vertex of a tile lies inside its sphere (multi-chunk scenes,
    where the kernel skips unreachable tiles); padding tiles have r < 0."""
    wt = _wt(world)
    assert sweep.multi_chunk(wt)
    sph = np.asarray(sweep.tile_spheres(wt))
    v0 = np.asarray(wt.v0)
    pts = np.stack([v0, v0 + np.asarray(wt.e1), v0 + np.asarray(wt.e2)], 1)
    n = int(wt.valid_count)
    tile = np.arange(n) // sweep.TRI_TILE
    d = np.linalg.norm(pts[:n] - sph[:3, tile].T[:, None, :], axis=2)
    assert (d <= sph[3, tile][:, None]).all()
    assert sph.shape[1] == -(-wt.v0.shape[0] // sweep.TRI_TILE)
    assert (sph[3, -(-n // sweep.TRI_TILE):] < 0).all()
    assert not sweep.multi_chunk(_wt("cornell"))
