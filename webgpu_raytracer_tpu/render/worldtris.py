"""World-space triangle tables: the dense intersection backend's data.

Instead of the reference's two-level TLAS/BLAS pointer chase
(Raytracer.wgsl:455-528), every instance's triangles are flattened into
world space once per scene update, and intersection becomes a dense
rays x triangles sweep (ops/dense.py, ops/sweep.py). Shading attributes are
likewise baked per world triangle so the bounce loop fetches one row per hit
instead of chasing topology -> vertices -> instance pointers.

The ray/triangle test is the Plucker-coordinate form: for a ray (o, d) with
moment m = o x d, the signed side of edge (a, b) is
    s = d . (a x b) + m . (b - a)
which is LINEAR in the 6-vector [d, m] — so the three edge tests of every
triangle are one (R,6) @ (6, 3T) matmul. The hit distance comes from the
plane equation: t = (n.v0 - n.o) / (n.d), linear in [d, o, 1]. A triangle is
hit when all three s agree in sign (equivalent to Moller-Trumbore u,v tests;
same 1e-6 determinant epsilon since a = -(n.d)).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

# Feature-vector layout (K = 16): [d(3), m(3), o(3), 1, pad(6)]; only the
# first 10 rows are meaningful (the GPU kernel reads just those).
FEAT_K = 16
# Column groups per triangle: s0, s1, s2, t_num, t_den
N_GROUPS = 5

# shade_table column layout (SHADE_K = 40):
SHADE_COLS = dict(
    v0=(0, 3), e1=(3, 6), e2=(6, 9),
    n0=(9, 12), n1=(12, 15), n2=(15, 18),
    uv0=(18, 20), uv1=(20, 22), uv2=(22, 24),
    base_color=(24, 27), mat=(27, 28), mrir=(28, 31),
    tex=(31, 35), emissive=(35, 38), tri_idx=(38, 39), inst_idx=(39, 40),
)
SHADE_K = 40


class WorldTris(NamedTuple):
    """Per-world-triangle SoA (Tw = padded world triangle count)."""

    # Intersection feature table, (FEAT_K, N_GROUPS * Tw): columns grouped as
    # [all s0 | all s1 | all s2 | all t_num | all t_den].
    features: jnp.ndarray

    # Geometry (world space)
    v0: jnp.ndarray   # (Tw, 3)
    e1: jnp.ndarray   # (Tw, 3)
    e2: jnp.ndarray   # (Tw, 3)
    n0: jnp.ndarray   # (Tw, 3) world-space shading normals per corner
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray  # (Tw, 2)
    uv1: jnp.ndarray
    uv2: jnp.ndarray

    # Materials (same contract as MeshTopology data0..data3, SURVEY.md §2.2)
    base_color: jnp.ndarray  # (Tw, 3)
    mat: jnp.ndarray         # (Tw,) i32
    mrir: jnp.ndarray        # (Tw, 3) metallic, roughness, ior
    tex: jnp.ndarray         # (Tw, 4) i32
    emissive: jnp.ndarray    # (Tw, 3)

    # Back-references into the flat-buffer contract
    tri_idx: jnp.ndarray   # (Tw,) i32 topology index
    inst_idx: jnp.ndarray  # (Tw,) i32 TLAS-sorted instance index

    # Lights: world-tri ids of emissive triangles, (L,) i32 (+count)
    light_wt: jnp.ndarray
    light_count: jnp.ndarray

    valid_count: jnp.ndarray  # () i32 — unpadded Tw

    # Combined shading row table (Tw, SHADE_K) for single-matmul fetches;
    # column layout in SHADE_COLS.
    shade_table: jnp.ndarray

    # Shade rows of the light triangles, (Lpad, SHADE_K): NEE fetches sample
    # this directly instead of a light_wt -> shade_table double indirection.
    light_rows: jnp.ndarray


def _round_up(n, m):
    return max(m, ((n + m - 1) // m) * m)


def tri_pad(tw: int) -> int:
    """Padded world-triangle count: small scenes pad to a multiple of 8 (a
    36-tri cornell pays for 40 tris, not 128); larger scenes pad to full
    128-wide chunks (ops/dense.TRI_CHUNK)."""
    return _round_up(tw, 8) if tw <= 128 else _round_up(tw, 128)


def world_tri_count(world) -> int:
    """World triangles of a NativeWorld (instances x their geometry's
    triangles): one bincount over the topology, one gather per instance."""
    topo = np.asarray(world.topology()).reshape(-1, 20)
    inst = np.asarray(world.instances()).reshape(-1, 36)
    geoms = inst[:, 32:36].copy().view(np.uint32)[:, 2].astype(np.int64)
    per_geom = np.bincount(topo[:, 3].astype(np.int64),
                           minlength=int(geoms.max(initial=-1)) + 1)
    return int(per_geom[geoms].sum())


def build_world_tris(world, pad_to: int | None = None, extra: dict | None = None):
    """Flatten all instances' triangles to world space (numpy, per update).

    `extra` (optional): name -> numpy array of small per-tick operands
    (the Renderer passes the camera block) to ride the SAME packed device
    transfer instead of a put of its own on the animated path. Returns (WorldTris, {name: device array}) when
    given, else just the WorldTris."""
    topo = np.asarray(world.topology(), np.uint32).reshape(-1, 20)
    tri_v = topo[:, 0:3].astype(np.int64)
    tri_geom = topo[:, 3].astype(np.int64)
    attrs = topo[:, 4:20].copy().view(np.float32)
    pos = np.asarray(world.vertices(), np.float32).reshape(-1, 4)[:, :3]
    nrm = np.asarray(world.normals(), np.float32).reshape(-1, 4)[:, :3]
    uvs = np.asarray(world.uvs(), np.float32).reshape(-1, 2)

    inst = np.asarray(world.instances(), np.float32).reshape(-1, 36)
    n_inst = inst.shape[0]
    tf = inst[:, 0:16].reshape(n_inst, 4, 4).transpose(0, 2, 1)
    inv = inst[:, 16:32].reshape(n_inst, 4, 4).transpose(0, 2, 1)
    inst_geom = inst[:, 32:36].copy().view(np.uint32)[:, 2].astype(np.int64)

    lights = np.asarray(world.lights(), np.uint32).reshape(-1, 2).astype(np.int64)

    chunks = []
    light_wt = []
    base = 0
    for i in range(n_inst):
        sel = np.nonzero(tri_geom == inst_geom[i])[0]
        if sel.size == 0:
            continue
        rot = tf[i, :3, :3]
        trn = tf[i, :3, 3]
        # normals: inverse-transpose
        nrm_m = inv[i, :3, :3].T

        vi = tri_v[sel]
        v0 = pos[vi[:, 0]] @ rot.T + trn
        v1 = pos[vi[:, 1]] @ rot.T + trn
        v2 = pos[vi[:, 2]] @ rot.T + trn
        nn0 = pos_norm(nrm[vi[:, 0]] @ nrm_m.T)
        nn1 = pos_norm(nrm[vi[:, 1]] @ nrm_m.T)
        nn2 = pos_norm(nrm[vi[:, 2]] @ nrm_m.T)

        chunks.append((sel, v0, v1, v2, nn0, nn1, nn2,
                       uvs[vi[:, 0]], uvs[vi[:, 1]], uvs[vi[:, 2]]))

        # map this instance's light triangles to world-tri rows
        mine = lights[lights[:, 0] == i]
        if mine.size:
            # topology index -> position within sel
            lut = {int(t): k for k, t in enumerate(sel)}
            for _, t in mine:
                light_wt.append(base + lut[int(t)])
        base += sel.size

        chunks[-1] = chunks[-1] + (np.full(sel.size, i, np.int64),)

    if not chunks:
        # empty scene: one degenerate tri
        sel = np.zeros(1, np.int64)
        z3 = np.zeros((1, 3), np.float32)
        z2 = np.zeros((1, 2), np.float32)
        chunks = [(sel, z3, z3, z3, z3, z3, z3, z2, z2, z2,
                   np.zeros(1, np.int64))]

    sel_all = np.concatenate([c[0] for c in chunks])
    v0 = np.concatenate([c[1] for c in chunks])
    v1 = np.concatenate([c[2] for c in chunks])
    v2 = np.concatenate([c[3] for c in chunks])
    n0 = np.concatenate([c[4] for c in chunks])
    n1 = np.concatenate([c[5] for c in chunks])
    n2 = np.concatenate([c[6] for c in chunks])
    uv0 = np.concatenate([c[7] for c in chunks])
    uv1 = np.concatenate([c[8] for c in chunks])
    uv2 = np.concatenate([c[9] for c in chunks])
    wt_inst = np.concatenate([c[10] for c in chunks])

    tw = v0.shape[0]
    tw_pad = _round_up(tw, pad_to) if pad_to else tri_pad(tw)
    pad = tw_pad - tw

    def padf(a, fill=0.0):
        if pad == 0:
            return a
        shape = (pad,) + a.shape[1:]
        return np.concatenate([a, np.full(shape, fill, a.dtype)])

    v0, v1, v2 = padf(v0), padf(v1), padf(v2)
    n0, n1, n2 = padf(n0), padf(n1), padf(n2)
    uv0, uv1, uv2 = padf(uv0), padf(uv1), padf(uv2)
    sel_all = padf(sel_all)
    wt_inst = padf(wt_inst)

    a = attrs[np.clip(sel_all, 0, attrs.shape[0] - 1)]
    if pad:
        a[tw:] = 0.0

    e1 = v1 - v0
    e2 = v2 - v0

    # --- Plucker feature table ---
    # s_e for edge (a,b): d.(a x b) + m.(b-a)
    def edge_cols(pa, pb):
        c = np.zeros((FEAT_K, tw_pad), np.float32)
        c[0:3] = np.cross(pa, pb).T          # dotted with d
        c[3:6] = (pb - pa).T                 # dotted with m
        return c

    n = np.cross(e1, e2)
    col_s0 = edge_cols(v0, v1)
    col_s1 = edge_cols(v1, v2)
    col_s2 = edge_cols(v2, v0)
    col_tn = np.zeros((FEAT_K, tw_pad), np.float32)
    col_tn[6:9] = -n.T                        # -n.o
    col_tn[9] = np.einsum("tj,tj->t", n, v0)  # + n.v0
    col_td = np.zeros((FEAT_K, tw_pad), np.float32)
    col_td[0:3] = n.T                         # n.d

    features = np.concatenate([col_s0, col_s1, col_s2, col_tn, col_td], axis=1)

    lw = np.asarray(light_wt, np.int64) if light_wt else np.zeros(1, np.int64)

    mat_f = a[:, 3:4]
    shade = np.concatenate(
        [v0, e1, e2, n0, n1, n2, uv0, uv1, uv2,
         a[:, 0:3], mat_f, a[:, 4:7], a[:, 8:12], a[:, 12:15],
         sel_all[:, None].astype(np.float32), wt_inst[:, None].astype(np.float32)],
        axis=1,
    ).astype(np.float32)
    assert shade.shape[1] == SHADE_K

    # Pad the light-row table to a multiple of 8 only: typical scenes have
    # 2-8 emissive triangles.
    lw_pad = _round_up(len(lw), 8)
    lw_padded = np.zeros(lw_pad, np.int64)
    lw_padded[: len(lw)] = lw
    light_rows = shade[np.clip(lw_padded, 0, shade.shape[0] - 1)]

    host = dict(
        features=features,
        v0=v0, e1=e1, e2=e2, n0=n0, n1=n1, n2=n2,
        uv0=uv0, uv1=uv1, uv2=uv2,
        base_color=np.ascontiguousarray(a[:, 0:3]),
        mat=(a[:, 3] + 0.5).astype(np.int32),
        mrir=np.ascontiguousarray(a[:, 4:7]),
        tex=np.ascontiguousarray(a[:, 8:12]).astype(np.int32),
        emissive=np.ascontiguousarray(a[:, 12:15]),
        tri_idx=sel_all.astype(np.int32),
        inst_idx=wt_inst.astype(np.int32),
        light_wt=lw.astype(np.int32),
        light_count=np.int32(len(light_wt)),
        valid_count=np.int32(tw),
        shade_table=shade,
        light_rows=light_rows,
    )
    if extra:
        host.update({f"x_{k}": np.asarray(v) for k, v in extra.items()})
    dev = _upload_tables(host)
    if extra:
        ex = {k[2:]: dev.pop(k) for k in list(dev) if k.startswith("x_")}
        return WorldTris(**dev), ex
    return WorldTris(**dev)


# Per-tick scene re-uploads below this total size ride ONE device transfer
# unpacked by a jitted device-side slice program, instead of ~25 separate
# host->device puts on the animated path. Large scenes (load-once; the
# packing memcpy would cost more than it saves) keep per-array uploads.
_PACK_MAX_BYTES = 32 * 1024 * 1024


def _upload_tables(host: dict) -> dict:
    """numpy tables -> device arrays; one packed transfer when small."""
    total = sum(int(np.asarray(v).nbytes) for v in host.values())
    if total > _PACK_MAX_BYTES:
        out = {}
        for k, v in host.items():
            v = np.asarray(v)
            out[k] = jnp.asarray(v if v.dtype != np.int64 else
                                 v.astype(np.int32))
        return out

    spec = []   # (name, offset, size, shape, kind)
    parts = []
    off = 0
    for k in sorted(host):
        v = np.asarray(host[k])
        kind = "i32" if v.dtype in (np.int32, np.int64) else "f32"
        flat = (v.astype(np.int32).view(np.float32) if kind == "i32"
                else v.astype(np.float32)).reshape(-1)
        spec.append((k, off, v.size, v.shape, kind))
        parts.append(flat)
        off += v.size
    buf = jax.device_put(np.concatenate(parts))
    return dict(_unpack_fn(tuple(spec))(buf))


@functools.lru_cache(maxsize=16)
def _unpack_fn(spec):
    """Compile one device-side unpack program per scene shape signature."""

    @jax.jit
    def unpack(buf):
        out = {}
        for name, off, size, shape, kind in spec:
            a = buf[off:off + size]
            if kind == "i32":
                a = jax.lax.bitcast_convert_type(a, jnp.int32)
            out[name] = a.reshape(shape)
        return out

    return unpack


def pos_norm(v):
    l = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(l > 0, v / np.maximum(l, 1e-20), v)


def ray_features(ro, rd):
    """Build the (R, FEAT_K) feature vectors [d, o x d, o, 1, pad]."""
    m = jnp.cross(ro, rd)
    ones = jnp.ones_like(ro[:, :1])
    pad = jnp.zeros((ro.shape[0], FEAT_K - 10), ro.dtype)
    return jnp.concatenate([rd, m, ro, ones, pad], axis=-1)
