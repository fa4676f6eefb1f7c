"""A PNG writer and reader for 8-bit RGB images, standard library only.

Stands in for PIL's `Image.save` where the JAX package renders
(`ppsurf_tpu/utils/visualization.py:244`, `figures/render_figures.py:38`):
the machine the port runs on has no PIL. `write_png` writes the image's
pixels exactly (8-bit RGB, no interlace, filter 0 on every row, one IDAT
chunk); a decoder reads the same array back as from PIL's file.
`read_png` decodes what `write_png` writes.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as a PNG file."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as fp:
        fp.write(SIGNATURE)
        fp.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fp.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fp.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG whose rows all use filter
    0 (as `write_png` writes); checks every chunk's CRC."""
    with open(path, "rb") as fp:
        data = fp.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace: {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * 3 + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()
