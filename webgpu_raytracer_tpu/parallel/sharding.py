"""Multi-chip rendering: tile and sample sharding over a jax.sharding.Mesh.

The multi-device replacement for the reference's multi-browser distribution
(SURVEY.md §5.7/§5.8, BASELINE config 5): instead of WebRTC frame-batch jobs,
the pixel grid is sharded over devices (`tile`) or the same pixels are
rendered with disjoint RNG sample streams and the accumulator is
psum-reduced over the interconnect (`sample`). Both modes are bit-deterministic: the counter-based per-(pixel,
sample) RNG (ops/rng.py) makes the sharded result equal to the single-chip
result regardless of the device layout.

Frame sharding across hosts (animation farming, the reference's job-queue
tier) lives in parallel/cluster.py on top of these per-frame kernels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.api import get_tracer
from ..ops.trace import accumulate

AXIS = "shard"


def make_mesh(devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.array(devices), (AXIS,))


def tile_sharded_step(mesh: Mesh, width: int, height: int, spp: int,
                      max_depth: int, backend: str = "bvh"):
    """Returns a jitted step: pixel rows sharded over the mesh.

    accum is (H*W, 4) laid out row-major, sharded on rows; the scene and
    camera are replicated. Each chip traces its own row band with global
    pixel indices, so the result is identical to a single-chip render.
    """
    n = mesh.devices.size
    assert height % n == 0, f"height {height} must divide over {n} devices"
    rows_per = height // n
    tracer = get_tracer(backend)

    def shard_fn(scene, camera, frame_count, jitter, accum):
        dev = jax.lax.axis_index(AXIS)
        col = tracer(
            scene, camera, frame_count, jitter, width, rows_per, spp,
            max_depth, row0=dev * rows_per, full_height=height,
        )
        return accumulate(accum, col, frame_count)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(AXIS)),
        out_specs=P(AXIS),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(4,))


def tile_sample_sharded_step(mesh: Mesh, width: int, height: int,
                             spp_total: int, max_depth: int,
                             tile_axis: str = "tile",
                             sample_axis: str = "sample",
                             backend: str = "bvh"):
    """2D mesh: rows sharded over `tile_axis`, sample streams over
    `sample_axis` with a psum over the interconnect — the full BASELINE config-5 layout.

    accum is (H*W, 4) sharded on rows over tile_axis and replicated over
    sample_axis.
    """
    nt = mesh.shape[tile_axis]
    ns = mesh.shape[sample_axis]
    assert height % nt == 0, f"height {height} must divide over {nt} tiles"
    assert spp_total % ns == 0, f"spp {spp_total} must divide over {ns}"
    rows_per = height // nt
    spp_per = spp_total // ns
    tracer = get_tracer(backend)

    def shard_fn(scene, camera, frame_count, jitter, accum):
        ti = jax.lax.axis_index(tile_axis)
        si = jax.lax.axis_index(sample_axis)
        col = tracer(
            scene, camera, frame_count, jitter, width, rows_per, spp_per,
            max_depth, row0=ti * rows_per, full_height=height,
            total_spp=spp_total, sample0=si * spp_per,
        )
        col = jax.lax.psum(col * (spp_per / spp_total), sample_axis)
        return accumulate(accum, col, frame_count)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(tile_axis)),
        out_specs=P(tile_axis),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(4,))


def sample_sharded_step(mesh: Mesh, width: int, height: int, spp_total: int,
                        max_depth: int, backend: str = "bvh"):
    """Returns a jitted step: sample streams sharded, psum over the interconnect.

    Every chip renders the full pixel grid with a disjoint slice of the
    sample indices; the per-chip sums are psum-reduced so each chip holds the
    full accumulation (replicated output).
    """
    n = mesh.devices.size
    assert spp_total % n == 0, f"spp {spp_total} must divide over {n} devices"
    spp_per = spp_total // n
    tracer = get_tracer(backend)

    def shard_fn(scene, camera, frame_count, jitter, accum):
        dev = jax.lax.axis_index(AXIS)
        col = tracer(
            scene, camera, frame_count, jitter, width, height, spp_per,
            max_depth, total_spp=spp_total, sample0=dev * spp_per,
        )
        # col is the mean over this chip's spp_per samples; psum of
        # col * (spp_per/spp_total) is the global mean.
        col = jax.lax.psum(col * (spp_per / spp_total), AXIS)
        return accumulate(accum, col, frame_count)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(4,))
