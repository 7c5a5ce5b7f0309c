"""GLB loader tests against programmatic fixtures (tests/glb_fixture.py).

Covers the loader.rs capability set: mesh primitives w/ materials, node
transforms baked into static instances, animations (keyframe sampling +
node TRS updates feeding per-frame rebuilds), and LBS skinning.
"""

import numpy as np
import pytest

from webgpu_raytracer_tpu.models.native import NativeWorld

from tests.glb_fixture import simple_quad_glb, skinned_strip_glb


def world_tris_of(world, geom_idx):
    topo = np.asarray(world.topology(), np.uint32).reshape(-1, 20)
    return topo[topo[:, 3] == geom_idx]


def test_glb_quad_loads():
    w = NativeWorld("viewer", glb_data=simple_quad_glb())
    # viewer env (geom 0) + glb quad geometry appended
    topo = np.asarray(w.topology(), np.uint32).reshape(-1, 20)
    geoms = set(topo[:, 3].tolist())
    assert len(geoms) >= 2
    quad = world_tris_of(w, max(geoms))
    assert quad.shape[0] == 2  # two triangles
    attrs = quad[:, 4:20].copy().view(np.float32)
    np.testing.assert_allclose(attrs[0, 0:3], [0.8, 0.1, 0.1], atol=1e-6)
    assert attrs[0, 3] == 0.0  # LAMBERTIAN (metallic == 0)
    np.testing.assert_allclose(attrs[0, 5], 0.9, atol=1e-6)  # roughness


def test_glb_instance_transform_applied():
    """Static node translation (0,1,0) is baked into the instance, then the
    demo model transform (0.7 scale + 180deg Y) is applied by update()."""
    w = NativeWorld("viewer", glb_data=simple_quad_glb(animated=False))
    inst = np.asarray(w.instances(), np.float32).reshape(-1, 36)
    assert inst.shape[0] == 2  # env + quad (empty viewer model slot skipped)
    # the non-env instance gets the demo transform (lib.rs:196-204 parity)
    geoms = inst[:, 32:36].copy().view(np.uint32)[:, 2]
    model = inst[geoms == geoms.max()][0]
    tf = model[0:16].reshape(4, 4).T
    np.testing.assert_allclose(np.diag(tf)[:3], [-0.7, 0.7, -0.7], atol=1e-5)


def test_glb_animation_playback():
    w = NativeWorld("viewer", glb_data=simple_quad_glb())
    assert w.animation_count() == 1
    assert w.animation_name(0) == "spin"

    v0 = np.asarray(w.vertices(), np.float32).reshape(-1, 4)[:, :3].copy()
    w.update(0.5)  # halfway: 90-degree rotation of the node
    v1 = np.asarray(w.vertices(), np.float32).reshape(-1, 4)[:, :3].copy()
    # NOTE: the quad node has no skin, so its vertices are static in the
    # geometry (instance transform handles placement); animation changes
    # node TRS which matters for skinned paths. Verify update is stable.
    np.testing.assert_allclose(v0, v1, atol=1e-6)


def test_glb_skinning_deforms():
    w = NativeWorld("viewer", glb_data=skinned_strip_glb())
    topo = np.asarray(w.topology(), np.uint32).reshape(-1, 20)
    geoms = sorted(set(topo[:, 3].tolist()))
    strip_geom = geoms[-1]

    def strip_verts():
        tris = world_tris_of(w, strip_geom)
        vids = sorted(set(tris[:, 0:3].reshape(-1).tolist()))
        pos = np.asarray(w.vertices(), np.float32).reshape(-1, 4)[:, :3]
        return pos[vids]

    v_t0 = strip_verts().copy()
    # top verts at y=1 bound to joint1 at rest position (0,1,0)
    assert v_t0[:, 1].max() == pytest.approx(1.0, abs=1e-5)

    # t=0.5: halfway -> joint1 at (0.5,1,0); t=1.0 would wrap to 0 (the
    # reference loops clips by duration, lib.rs:166-170)
    w.update(0.5)
    v_t1 = strip_verts().copy()
    moved = v_t1 - v_t0
    top = v_t0[:, 1] > 0.5
    np.testing.assert_allclose(moved[top, 0], 0.5, atol=1e-4)
    np.testing.assert_allclose(moved[~top, 0], 0.0, atol=1e-4)


def test_glb_garbage_is_tolerated():
    """Parse failures are swallowed (reference lib.rs:57-66 `let _ =`);
    the scene still builds with the preset environment."""
    w1 = NativeWorld("viewer", glb_data=b"not a glb file at all")
    assert w1.topology().size > 0
    import struct
    junk = struct.pack("<III", 0x46546C67, 2, 12)  # valid magic, truncated
    w2 = NativeWorld("viewer", glb_data=junk)
    assert w2.topology().size > 0


def test_glb_texture_pipeline():
    """Embedded PNG texture: bytes -> decode -> texture array -> sampling.

    The textured quad's albedo must vary left-red / right-blue across its
    UVs (ResourceManager texture-array semantics end to end)."""
    import jax.numpy as jnp

    from tests.glb_fixture import textured_quad_glb
    from webgpu_raytracer_tpu.ops.dense_trace import sample_texture_v3
    from webgpu_raytracer_tpu.utils.textures import (decode_world_textures,
                                                     pack_quad_table)

    w = NativeWorld("viewer", glb_data=textured_quad_glb())
    assert w.texture_count() == 1
    tex = decode_world_textures(w, size=64)
    assert tex.shape == (1, 64, 64, 3)
    textures = jnp.asarray(pack_quad_table(tex))  # the device layout

    idx = jnp.zeros(8, jnp.int32)
    u = jnp.asarray([0.2] * 4 + [0.8] * 4, jnp.float32)
    v = jnp.full(8, 0.5, jnp.float32)
    rgb = sample_texture_v3(textures, idx, u, v)
    left = np.stack([np.asarray(rgb.x)[:4], np.asarray(rgb.y)[:4],
                     np.asarray(rgb.z)[:4]], axis=1).mean(axis=0)
    right = np.stack([np.asarray(rgb.x)[4:], np.asarray(rgb.y)[4:],
                      np.asarray(rgb.z)[4:]], axis=1).mean(axis=0)
    assert left[0] > 0.9 and left[2] < 0.1    # red half
    assert right[2] > 0.9 and right[0] < 0.1  # blue half

    # full pipeline: topology references the texture slot
    topo = np.asarray(w.topology(), np.uint32).reshape(-1, 20)
    attrs = topo[:, 4:20].copy().view(np.float32)
    quad = attrs[topo[:, 3] == topo[:, 3].max()]
    assert (quad[:, 8] == 0.0).all()  # base tex index 0


def test_glb_textured_render():
    """A render of the textured quad shows the texture's colors."""
    from tests.glb_fixture import textured_quad_glb
    from webgpu_raytracer_tpu import Renderer, RenderConfig

    r = Renderer("viewer", glb_data=textured_quad_glb(),
                 config=RenderConfig(width=48, height=48, max_depth=3,
                                     shader_spp=1))
    assert r.scene.textures.shape[0] == 1
    for _ in range(4):
        r.render_frame()
        img = r.present()
    # the quad (scaled 0.7, rotated 180deg, at center) should show red/blue
    # regions somewhere in frame
    f = img.astype(np.float32) / 255.0
    redness = f[..., 0] - (f[..., 1] + f[..., 2]) / 2
    blueness = f[..., 2] - (f[..., 0] + f[..., 1]) / 2
    assert redness.max() > 0.15
    assert blueness.max() > 0.15


def test_real_asset_scale_glb_end_to_end():
    """Real-asset ingestion: a >1k-tri GLB with a
    node hierarchy, 3 primitives across 2 meshes, 2 embedded PNG textures,
    3 materials (textured lambertian / metal / textured emissive) and 2
    animation clips goes loader -> world -> render, and the stats match the
    reference loader contract (loader.rs material mapping, UIManager.ts:91
    file path)."""
    from tests.glb_fixture import character_glb
    from webgpu_raytracer_tpu import Renderer, RenderConfig

    glb = character_glb()
    w = NativeWorld("viewer", None, glb)
    topo = np.asarray(w.topology(), np.uint32).reshape(-1, 20)
    attrs = topo[:, 4:20].copy().view(np.float32)
    assert w.texture_count() == 2
    assert w.animation_count() == 2
    assert {w.animation_name(i) for i in range(2)} == {"bob", "spin"}

    # the model's three primitives arrive with their materials mapped per
    # loader.rs:150-157: metallic>0 -> METAL(1), emissive -> LIGHT(3)
    geoms = np.unique(topo[:, 3])
    mats_by_geom = {int(g): set(attrs[topo[:, 3] == g][:, 3].astype(int))
                    for g in geoms}
    all_mats = set().union(*mats_by_geom.values())
    assert {1, 3} <= all_mats  # metal head + emissive collar present
    model_tris = (np.isin(topo[:, 3], geoms[-3:])).sum()
    assert model_tris >= 1282  # 1024 + 256 + 2

    # end-to-end render converges and shows the model
    r = Renderer("viewer", glb_data=glb,
                 config=RenderConfig(width=48, height=48, max_depth=4,
                                     shader_spp=1))
    assert r.scene.textures.shape[0] == 2
    for _ in range(3):
        r.render_frame()
    rad = r.radiance()
    assert np.isfinite(rad).all() and rad.mean() > 0.01

    # both clips are selectable and tick cleanly (node animation on STATIC
    # meshes is not observable by contract: the reference bakes static node
    # transforms at load and hard-codes instance transforms per tick,
    # loader.rs:248-284 + lib.rs:196-204 — skinned motion is covered by
    # test_glb_skinning_deforms)
    for clip in (0, 1):
        w.set_animation(clip)
        w.update(0.5)
        v = np.asarray(w.vertices(), np.float32)
        assert np.isfinite(v).all() and v.size > 0


def test_glb_exporter_quirks():
    """Exporter-shaped GLB: interleaved single-view
    vertex buffer (Blender layout), extra TANGENT/COLOR_0 attributes,
    non-indexed primitive with computed normals, TRIANGLE_STRIP mode,
    sparse position accessor, data-URI image, and a LINES primitive that
    must be skipped (reference accepts arbitrary .glb/.vrm files,
    UIManager.ts:91)."""
    from tests.glb_fixture import exporter_quirks_glb

    w = NativeWorld("viewer", glb_data=exporter_quirks_glb())
    topo = np.asarray(w.topology(), np.uint32).reshape(-1, 20)
    geoms = sorted(set(topo[:, 3].tolist()))
    # env + 4 triangle primitives (LINES skipped, so exactly 4 model geoms)
    model_geoms = geoms[-4:]
    counts = {g: (topo[:, 3] == g).sum() for g in model_geoms}
    assert sorted(counts.values()) == [1, 2, 2, 2], counts

    pos = np.asarray(w.vertices(), np.float32).reshape(-1, 4)[:, :3]
    nrm = np.asarray(w.normals(), np.float32).reshape(-1, 4)[:, :3]
    uvs = np.asarray(w.uvs(), np.float32).reshape(-1, 2)

    def verts_of(g):
        vids = sorted(set(topo[topo[:, 3] == g][:, 0:3].reshape(-1).tolist()))
        return np.asarray(vids)

    # prim 0 (interleaved): normals all +z (pre-instance-transform store),
    # uvs the unit square corners — proves the stride-32 accessors decoded.
    g0 = model_geoms[0]
    v0 = verts_of(g0)
    np.testing.assert_allclose(np.abs(nrm[v0][:, 2]), 1.0, atol=1e-5)
    assert {tuple(u) for u in uvs[v0].tolist()} == {
        (0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)}

    # prim 1 (non-indexed, no NORMAL): normals computed, unit length, +-z
    g1 = model_geoms[1]
    v1 = verts_of(g1)
    lens = np.linalg.norm(nrm[v1], axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-4)
    np.testing.assert_allclose(np.abs(nrm[v1][:, 2]), 1.0, atol=1e-4)

    # prim 3 (sparse): the substituted vertex makes an isoceles triangle —
    # two edges equal, distinct from the base (ratios survive the viewer's
    # uniform normalize + demo transform). Without sparse handling the
    # triangle is degenerate (zero area).
    g3 = model_geoms[3]
    tri = topo[topo[:, 3] == g3][0, 0:3]
    a, b, c = pos[tri[0]], pos[tri[1]], pos[tri[2]]
    area = np.linalg.norm(np.cross(b - a, c - a)) * 0.5
    assert area > 1e-6
    e_ab = np.linalg.norm(b - a)
    e_ac = np.linalg.norm(c - a)
    e_bc = np.linalg.norm(c - b)
    np.testing.assert_allclose(e_ac, e_bc, rtol=1e-4)  # isoceles
    np.testing.assert_allclose(max(e_ac, e_bc) / e_ab,
                               np.sqrt(1.25), rtol=1e-3)

    # data-URI image decoded: one texture, solid red
    assert w.texture_count() == 1
    from webgpu_raytracer_tpu.utils.textures import decode_world_textures
    tex = decode_world_textures(w, size=8)
    assert tex.shape == (1, 8, 8, 3)
    assert tex[0, :, :, 0].min() > 0.9 and tex[0, :, :, 2].max() < 0.1

    # the whole thing renders
    from webgpu_raytracer_tpu import Renderer, RenderConfig
    r = Renderer("viewer", glb_data=exporter_quirks_glb(),
                 config=RenderConfig(width=32, height=32, max_depth=3,
                                     shader_spp=1))
    r.render_frame()
    rad = r.radiance()
    assert np.isfinite(rad).all() and rad.mean() > 0.01
