"""A PNG decoder on the standard library's zlib: the plain reference.

Reads every non-interlaced PNG: gray at 1, 2, 4, 8 and 16 bits, RGB,
palette (with or without tRNS), gray+alpha and RGBA, any of the five row
filters.  Returns an RGB uint8 (H, W, 3) array, as the native lane's libpng
decode does (``native/byogan_io.cpp``): 16-bit samples keep their high byte,
low-depth gray is scaled to 8 bits, palettes are expanded, gray is repeated
into three channels, and alpha and tRNS are dropped.

The native lane reads PNG files through libpng where it was built with it.
Where it was not, they come here, and the C ``byogan_unfilter`` undoes the
row filters (``_unfilter`` in Python only where the library did not load:
it runs Average and Paeth rows byte by byte).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from byogan_tpu_torch.data import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# color type -> allowed bit depths
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above the image
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
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


def unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The native ``byogan_unfilter`` where the library loaded, else
    ``_unfilter``."""
    rows = native.unfilter(raw, h, stride, bpp)
    return _unfilter(raw, h, stride, bpp) if rows is None else rows


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> (H, W, ch) samples: 16-bit to its high byte,
    1/2/4-bit unpacked (values, not scaled)."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, : w * ch * 2].reshape(h, w, ch, 2)[..., 0]
    if depth == 8:
        return rows[:, : w * ch].reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :w, None]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 RGB (H, W, 3)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color] or interlace != 0:
        raise ValueError(
            f"PNG: only non-interlaced images of PNG's color types and depths are read, got depth "
            f"{depth}, color type {color}, interlace {interlace}"
        )
    ch = _CHANNELS[color]
    bits = depth * ch
    stride = (w * bits + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of scanlines, expected {h * (stride + 1)}")
    img = _samples(unfilter(raw, h, stride, max(1, bits // 8)), w, ch, depth)
    if color == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)  # entries past the palette read as black, as libpng's
        full[: len(palette)] = palette
        return full[img[..., 0]]
    if color == 0 and depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if ch <= 2:  # gray, gray+alpha
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
