"""Device-side scene resources.

Unpacks the scene compiler's flat buffers (the exact contract of SURVEY.md
§2.2 / reference src/renderer/ResourceManager.ts) into SoA device
arrays, and applies the static-shape padding policy that keeps jit caches
stable across animated rebuilds (the analogue of the reference's grow-only
GPU buffer reallocation, ResourceManager.ts:210-283).

Key transform: BLAS skip pointers are geometry-relative in the flat contract
(consumed as `node_start_idx + skip` in Raytracer.wgsl:459-490); here they are
absolutized into the merged TLAS+BLAS node array at upload time so the device
traversal is a single branch-free cursor walk.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class DeviceScene(NamedTuple):
    """All scene state needed by the tracer, as device arrays (a pytree)."""

    # Merged TLAS+BLAS nodes (TLAS first). Skips are absolute indices.
    node_min: jnp.ndarray   # (N, 3) f32
    node_max: jnp.ndarray   # (N, 3) f32
    node_skip: jnp.ndarray  # (N,) i32, absolutized
    node_data: jnp.ndarray  # (N,) i32: 0=internal, else (first<<3)|count
    tlas_count: jnp.ndarray  # () i32 — end sentinel of the TLAS walk

    # Topology (per triangle)
    tri_v: jnp.ndarray       # (T, 3) i32 global vertex indices
    tri_base_color: jnp.ndarray  # (T, 3) f32
    tri_mat: jnp.ndarray     # (T,) i32 (0 lambertian / 1 metal / 2 dielectric / 3 light)
    tri_mrir: jnp.ndarray    # (T, 3) f32: metallic, roughness, ior
    tri_tex: jnp.ndarray     # (T, 4) i32: base/metrough/normal/emissive (-1 none)
    tri_emissive: jnp.ndarray  # (T, 3) f32

    # Geometry
    pos: jnp.ndarray  # (V, 3) f32
    nrm: jnp.ndarray  # (V, 3) f32
    uv: jnp.ndarray   # (V, 2) f32

    # Instances (TLAS-sorted)
    inst_tf: jnp.ndarray    # (I, 4, 4) f32 row-major math matrices (p' = M @ [p,1])
    inst_inv: jnp.ndarray   # (I, 4, 4) f32
    inst_blas: jnp.ndarray  # (I,) i32 — absolute root index into merged nodes

    # Lights
    lights: jnp.ndarray       # (L, 2) i32 [instance_idx, tri_idx]
    light_count: jnp.ndarray  # () i32

    # Texture array (K, TH, TW, 3) f32 in [0,1]; K >= 1 (slot 0 = white).
    textures: jnp.ndarray


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def absolutize_blas_skips(blas_skip_u32: np.ndarray, tlas_count: int) -> np.ndarray:
    """Convert per-geometry-relative BLAS skips to merged-array-absolute.

    Each geometry's BLAS segment starts at its root whose skip pointer equals
    the segment's node count (blas.rs packs root skip = nodes.len()), so the
    segments can be recovered by walking the roots.
    """
    n = len(blas_skip_u32)
    out = np.empty(n, dtype=np.int64)
    start = 0
    while start < n:
        count = int(blas_skip_u32[start])
        if count <= 0:  # defensive: malformed segment, stop
            out[start:] = tlas_count + n
            break
        seg = slice(start, start + count)
        out[seg] = blas_skip_u32[seg].astype(np.int64) + tlas_count + start
        start += count
    return out


def unpack_instances(flat: np.ndarray):
    """(I*36,) f32 -> (tf, inv, blas_offset, instance_id) per §2.2."""
    inst = flat.reshape(-1, 36)
    count = inst.shape[0]
    # First 16 floats are the transform's 4 columns; transpose to math-matrix
    # convention (row i = output component).
    tf = inst[:, 0:16].reshape(count, 4, 4).transpose(0, 2, 1).copy()
    inv = inst[:, 16:32].reshape(count, 4, 4).transpose(0, 2, 1).copy()
    meta = inst[:, 32:36].copy().view(np.uint32)
    return tf, inv, meta[:, 0].astype(np.int64), meta[:, 2].astype(np.int64)


def build_device_scene(
    world,
    pad_nodes_to: int = 256,
    pad_tris_to: int = 256,
    pad_verts_to: int = 256,
    textures: np.ndarray | None = None,
) -> DeviceScene:
    """Unpack a NativeWorld's flat buffers into a padded DeviceScene."""
    tlas = np.asarray(world.tlas(), dtype=np.float32).reshape(-1, 8)
    blas = np.asarray(world.blas(), dtype=np.float32).reshape(-1, 8)
    tlas_count = tlas.shape[0]

    tlas_skip = tlas[:, 3].copy().view(np.uint32).astype(np.int64)
    blas_skip = absolutize_blas_skips(blas[:, 3].copy().view(np.uint32), tlas_count)

    merged_min = np.concatenate([tlas[:, 0:3], blas[:, 0:3]], axis=0)
    merged_max = np.concatenate([tlas[:, 4:7], blas[:, 4:7]], axis=0)
    merged_skip = np.concatenate([tlas_skip, blas_skip], axis=0)
    merged_data = np.concatenate(
        [tlas[:, 7].copy().view(np.uint32).astype(np.int64),
         blas[:, 7].copy().view(np.uint32).astype(np.int64)],
        axis=0,
    )

    n_nodes = merged_min.shape[0]
    n_pad = _round_up(n_nodes, pad_nodes_to)
    if n_pad > n_nodes:
        pad = n_pad - n_nodes
        merged_min = np.concatenate([merged_min, np.zeros((pad, 3), np.float32)])
        merged_max = np.concatenate([merged_max, np.full((pad, 3), -1.0, np.float32)])
        merged_skip = np.concatenate([merged_skip, np.full(pad, n_pad, np.int64)])
        merged_data = np.concatenate([merged_data, np.zeros(pad, np.int64)])

    # Topology: stride-20 u32 records
    topo = np.asarray(world.topology(), dtype=np.uint32).reshape(-1, 20)
    t_count = topo.shape[0]
    tri_v = topo[:, 0:3].astype(np.int64)
    attrs = topo[:, 4:20].copy().view(np.float32)  # same byte width
    base_color = attrs[:, 0:3].copy()
    mat = (attrs[:, 3] + 0.5).astype(np.int64)
    mrir = attrs[:, 4:7].copy()
    tex = attrs[:, 8:12].astype(np.int64)  # -1 encoded as -1.0 f32
    emissive = attrs[:, 12:15].copy()

    t_pad = _round_up(t_count, pad_tris_to)
    if t_pad > t_count:
        pad = t_pad - t_count
        tri_v = np.concatenate([tri_v, np.zeros((pad, 3), np.int64)])
        base_color = np.concatenate([base_color, np.zeros((pad, 3), np.float32)])
        mat = np.concatenate([mat, np.zeros(pad, np.int64)])
        mrir = np.concatenate([mrir, np.zeros((pad, 3), np.float32)])
        tex = np.concatenate([tex, -np.ones((pad, 4), np.int64)])
        emissive = np.concatenate([emissive, np.zeros((pad, 3), np.float32)])

    # Geometry
    pos = np.asarray(world.vertices(), np.float32).reshape(-1, 4)[:, :3]
    nrm = np.asarray(world.normals(), np.float32).reshape(-1, 4)[:, :3]
    uv = np.asarray(world.uvs(), np.float32).reshape(-1, 2)
    v_count = pos.shape[0]
    v_pad = _round_up(v_count, pad_verts_to)
    if v_pad > v_count:
        pad = v_pad - v_count
        pos = np.concatenate([pos, np.zeros((pad, 3), np.float32)])
        nrm = np.concatenate([nrm, np.zeros((pad, 3), np.float32)])
        uv = np.concatenate([uv, np.zeros((pad, 2), np.float32)])

    # Instances
    tf, inv, blas_off, _geom = unpack_instances(
        np.asarray(world.instances(), np.float32)
    )
    inst_blas_abs = blas_off + tlas_count

    # Lights
    lights = np.asarray(world.lights(), np.uint32).reshape(-1, 2).astype(np.int64)
    light_count = lights.shape[0]
    if light_count == 0:
        lights = np.zeros((1, 2), np.int64)

    if textures is None:
        textures = np.ones((1, 1, 1, 3), np.float32)
    elif textures.dtype != np.uint32 and textures.shape[1] > 1:
        # Real texture layers -> the packed bilinear quad table (one row
        # gather per sample instead of four; utils/textures.pack_quad_table)
        from ..utils.textures import pack_quad_table

        textures = pack_quad_table(textures)

    return DeviceScene(
        node_min=jnp.asarray(merged_min),
        node_max=jnp.asarray(merged_max),
        node_skip=jnp.asarray(merged_skip, jnp.int32),
        node_data=jnp.asarray(merged_data, jnp.int32),
        tlas_count=jnp.asarray(tlas_count, jnp.int32),
        tri_v=jnp.asarray(tri_v, jnp.int32),
        tri_base_color=jnp.asarray(base_color),
        tri_mat=jnp.asarray(mat, jnp.int32),
        tri_mrir=jnp.asarray(mrir),
        tri_tex=jnp.asarray(tex, jnp.int32),
        tri_emissive=jnp.asarray(emissive),
        pos=jnp.asarray(pos),
        nrm=jnp.asarray(nrm),
        uv=jnp.asarray(uv),
        inst_tf=jnp.asarray(tf),
        inst_inv=jnp.asarray(inv),
        inst_blas=jnp.asarray(inst_blas_abs, jnp.int32),
        lights=jnp.asarray(lights, jnp.int32),
        light_count=jnp.asarray(light_count, jnp.int32),
        textures=jnp.asarray(textures),  # u32 quad table or (1,1,1,3) f32
    )
