"""PNG reading and writing in numpy and zlib.

The port's image IO: the GPU machine has no PIL. It reads 8-bit gray,
gray + alpha, RGB and RGBA images, not interlaced, with any of the five
row filters (None, Sub, Up, Average, Paeth), and writes the same kinds
with filter None. None, Sub and Up undo a row at a time in numpy;
Average and Paeth depend on the reconstructed byte to their left and
walk the row byte by byte. Palette, 16-bit and interlaced files raise.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(buf: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        yield kind, buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One row's bytes (uint8) from its filtered bytes and the row above."""
    if kind == 0:
        return row
    if kind == 1:      # Sub: a running sum per byte of the pixel, mod 256
        return np.cumsum(row.reshape(-1, bpp).astype(np.uint32), axis=0,
                         dtype=np.uint32).astype(np.uint8).reshape(-1)
    if kind == 2:      # Up
        return row + prior
    if kind not in (3, 4):
        raise ValueError(f"PNG row filter {kind} is not one of 0-4")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if kind == 3:      # Average
            out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
        else:              # Paeth
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(a, up[i], c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """uint8 (H, W) for gray, (H, W, C) otherwise (C = 2, 3 or 4)."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, data = None, []
    for kind, body in _chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            data.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in CHANNELS or interlace:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}; only 8-bit gray, gray + alpha, RGB and RGBA, not "
            f"interlaced, are read")
    c = CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(data)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{w}x{h}x{c}")
    raw = raw.reshape(h, stride + 1)
    img = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = img[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, c)
    return img.reshape(h, w) if c == 1 else img.reshape(h, w, c)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Writes uint8 (H, W), (H, W, 1), (H, W, 2), (H, W, 3) or (H, W, 4)
    as gray, gray, gray + alpha, RGB or RGBA, every row with filter None."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)], 1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                            0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
