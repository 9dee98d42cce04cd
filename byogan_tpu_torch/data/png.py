"""A small PNG decoder on the standard library's zlib.

Reads what a prepared dataset holds: 8-bit gray, RGB and RGBA,
non-interlaced, any of the five row filters.  Returns an RGB uint8
(H, W, 3) array, as ``PIL.Image.convert("RGB")`` would: gray is repeated
into three channels and alpha is dropped.  The JAX package decodes with its
native library or PIL; the port runs where neither is installed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above the image
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    for y in range(h):
        kind, line, prev = rows[y, 0], rows[y, 1:], out[y]
        if kind == 0:
            out[y + 1] = line
        elif kind == 1:  # Sub: a running sum along each channel
            acc = line.reshape(-1, bpp).astype(np.int64).cumsum(axis=0)
            out[y + 1] = (acc.reshape(-1) & 0xFF).astype(np.uint8)
        elif kind == 2:  # Up
            out[y + 1] = line + prev
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
    return out[1:]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 RGB (H, W, 3)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"PNG: only 8-bit non-interlaced gray, RGB or RGBA is read, got depth "
            f"{depth}, color type {color}, interlace {interlace}"
        )
    ch = _CHANNELS[color]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if ch == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
