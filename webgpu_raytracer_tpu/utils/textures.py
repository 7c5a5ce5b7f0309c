"""Texture decoding: raw encoded bytes -> fixed-size RGB texture array.

Parity with reference ResourceManager.ts:153-208: every texture is decoded
(createImageBitmap there, PIL here) and force-resized to one
TEX_SIZE x TEX_SIZE layer of a single texture array; an image that fails to
decode falls back to a solid fallback like the reference's fallback bitmaps.
PIL is imported only when a scene has textures, and a missing PIL raises.
"""

from __future__ import annotations

import io

import numpy as np

TEX_SIZE = 1024


def decode_texture(data: bytes, size: int = TEX_SIZE) -> np.ndarray:
    """Decode one image to (size, size, 3) float32 in [0, 1]."""
    from PIL import Image

    try:
        img = Image.open(io.BytesIO(data)).convert("RGB")
        img = img.resize((size, size), Image.BILINEAR)
    except (OSError, ValueError):  # not a decodable image
        # fallback texture (reference ResourceManager.ts:171-177)
        return np.full((size, size, 3), 0.8, np.float32)
    return np.asarray(img, np.float32) / 255.0


def decode_world_textures(world, size: int = TEX_SIZE) -> np.ndarray | None:
    """Decode all of a NativeWorld's textures; None when it has none."""
    count = world.texture_count()
    if count == 0:
        return None
    layers = []
    for i in range(count):
        data = world.texture(i)
        if data:
            layers.append(decode_texture(data, size))
        else:
            layers.append(np.ones((size, size, 3), np.float32))
    return np.stack(layers)


def pack_quad_table(tex: np.ndarray) -> np.ndarray:
    """(K, S, S, 3) f32 in [0,1] -> (K, S, S, 4) uint32 bilinear quad table.

    The four bilinear corners are pre-baked per texel: word c of row
    (k, y, x) packs corner c of the quad at (y, x) as r<<16 | g<<8 | b u8
    codes (repeat-mode neighbors baked via roll), making a bilinear sample
    ONE 16-byte row gather + bit unpacking. u8 codes reconstruct the reference's rgba8unorm
    texels exactly (code/255 at f32); memory is 16 B/texel (vs 12 for raw
    f32 rgb).
    """
    codes = np.clip(np.rint(tex * 255.0), 0, 255).astype(np.uint32)
    c00 = codes
    c10 = np.roll(codes, -1, axis=2)
    c01 = np.roll(codes, -1, axis=1)
    c11 = np.roll(c10, -1, axis=1)
    words = [
        (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
        for c in (c00, c10, c01, c11)
    ]
    return np.stack(words, axis=-1)


# Secondary-bounce mip size; None = mip disabled (both pyramid levels alias
# the full-resolution table). Bounces >= 1 sample a box-filtered mip of this
# size instead of level 0: a departure from the reference, which samples
# LOD 0 at every bounce (Raytracer.wgsl:666-672). Level 0 (bounce 0 /
# G-buffer primary hits) samples the full-resolution table like the
# reference.
SECONDARY_MIP = 128


def build_quad_pyramid(tex: np.ndarray,
                       mip: int | None = SECONDARY_MIP) -> tuple:
    """(K, S, S, 3) f32 -> (level0, level1) packed quad tables.

    level0 is pack_quad_table at full resolution (primary hits / G-buffer
    seeded bounce 0); level1 is the box-downsampled mip for bounces >= 1,
    or level0 again when mip is None or not smaller than the texture.
    """
    l0 = pack_quad_table(tex)
    k, s = tex.shape[0], tex.shape[1]
    if mip is None or s <= mip:
        return l0, l0
    f = s // mip
    small = tex[:, : mip * f, : mip * f].reshape(k, mip, f, mip, f, 3) \
        .mean(axis=(2, 4))
    return l0, pack_quad_table(small)


def device_pyramid(pyr: tuple):
    """Move build_quad_pyramid's numpy levels to device arrays; a shared
    level is uploaded once."""
    import jax.numpy as jnp

    l0, l1 = pyr
    d0 = jnp.asarray(l0)
    if l1 is l0:
        return d0, d0
    return d0, jnp.asarray(l1)
