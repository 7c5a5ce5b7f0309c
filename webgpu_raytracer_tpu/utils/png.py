"""Minimal PNG encoder (8-bit RGB, no filtering) on zlib + struct.

The render and record paths write frames with it, so they need no imaging
library on the machine that renders.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    assert c == 3, img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    rows = np.concatenate([np.zeros((h, 1), np.uint8),   # filter type 0
                           img.reshape(h, w * 3)], axis=1)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def decode_png(data: bytes) -> np.ndarray:
    """Inverse of encode_png (unfiltered 8-bit RGB only) -> (H, W, 3)."""
    assert data[:8] == _SIGNATURE, "not a PNG"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 2), (depth, ctype)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    assert (rows[:, 0] == 0).all(), "filtered scanlines are not supported"
    return rows[:, 1:].reshape(h, w, 3).copy()
