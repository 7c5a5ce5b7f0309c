"""What stays of the texture path, the PNG writer, the compile-cache
helper and the large-scene backend choice."""

import io
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import webgpu_raytracer_tpu
from webgpu_raytracer_tpu.ops.api import DENSE_MAX_TRIS, choose_backend
from webgpu_raytracer_tpu.ops.dense_trace import sample_texture_v3, tex_level
from webgpu_raytracer_tpu.utils.png import decode_png, encode_png, write_png
from webgpu_raytracer_tpu.utils.textures import (SECONDARY_MIP,
                                                 build_quad_pyramid,
                                                 decode_texture,
                                                 device_pyramid,
                                                 pack_quad_table)


def test_pyramid_builds_plain_mip_level():
    rng = np.random.default_rng(5)
    tex = rng.random((2, 512, 512, 3)).astype(np.float32)
    l0, l1 = build_quad_pyramid(tex)
    assert l0.shape == (2, 512, 512, 4)
    assert l1.shape == (2, SECONDARY_MIP, SECONDARY_MIP, 4)
    small = tex.reshape(2, SECONDARY_MIP, 4, SECONDARY_MIP, 4, 3) \
        .mean(axis=(2, 4))
    np.testing.assert_array_equal(l1, pack_quad_table(small))
    d0, d1 = device_pyramid((l0, l1))
    assert tex_level((d0, d1), 0) is d0 and tex_level((d0, d1), 3) is d1
    # textures no larger than the mip keep one shared level
    s0, s1 = build_quad_pyramid(tex[:, :64, :64])
    assert s1 is s0
    e0, e1 = device_pyramid((s0, s1))
    assert e1 is e0


def test_sampler_reads_the_mip_table_bilinearly():
    """One 16-byte quad row per sample: the bilinear blend of its corners,
    with repeat wrapping; tex_idx < 0 samples white."""
    rng = np.random.default_rng(4)
    tex = rng.random((2, 16, 16, 3)).astype(np.float32)
    quad = jnp.asarray(pack_quad_table(tex))
    n = 500
    u = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    k = rng.integers(-1, 2, n).astype(np.int32)
    got = np.stack(sample_texture_v3(quad, jnp.asarray(k), jnp.asarray(u),
                                     jnp.asarray(v)), 1)
    codes = np.clip(np.rint(tex * 255.0), 0, 255) / 255.0
    fx = (u - np.floor(u)) * 16 - 0.5
    fy = (v - np.floor(v)) * 16 - 0.5
    x0, y0 = np.floor(fx).astype(int), np.floor(fy).astype(int)
    wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
    kk = np.clip(k, 0, 1)
    c = lambda dy, dx: codes[kk, (y0 + dy) % 16, (x0 + dx) % 16]
    want = ((c(0, 0) * (1 - wx) + c(0, 1) * wx) * (1 - wy)
            + (c(1, 0) * (1 - wx) + c(1, 1) * wx) * wy)
    want = np.where((k >= 0)[:, None], want, 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(data), img)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    np.testing.assert_array_equal(decode_png(path.read_bytes()), img)
    from PIL import Image  # an independent decoder agrees

    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)


def test_bad_image_falls_back_to_grey():
    out = decode_texture(b"not an image", size=8)
    assert out.shape == (8, 8, 3) and (out == np.float32(0.8)).all()


def test_missing_pil_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        decode_texture(b"not an image", size=8)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        webgpu_raytracer_tpu.use_checkout_compile_cache()
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(webgpu_raytracer_tpu.__file__)))
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            root, ".cache", "jax")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_wins(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        webgpu_raytracer_tpu.use_checkout_compile_cache()
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("tris,backend", [(36, "dense"),
                                          (DENSE_MAX_TRIS, "dense"),
                                          (DENSE_MAX_TRIS + 1, "bvh"),
                                          (257_000, "bvh")])
def test_backend_is_the_scene_size_rule(tris, backend):
    assert choose_backend(tris) == backend
