"""Image files of a dataset: which are listed, and how each is decoded.

A file is listed by its extension, as the JAX package lists them
(``IMAGE_EXTENSIONS``, byogan_tpu/data/prep.py:25-29), and decoded by its
first bytes: PNG, JPEG and WebP through the port's own codecs
(``data/native.py``), BMP by ``decode_bmp`` below, every layout as Pillow
reads it.  Any other file, or one a decoder refuses, raises an ``OSError``
that names it and the reason: no listed file is skipped.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

from byogan_tpu_torch.data import native

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def is_image(name: str) -> bool:
    return os.path.splitext(name)[1].lower() in IMAGE_EXTENSIONS


def sniff(head: bytes) -> str:
    """The format of a file from its first 12 bytes: "PNG", "JPEG", "BMP",
    "WebP" or "unknown"."""
    if head.startswith(b"\x89PNG\r\n\x1a\n"):
        return "PNG"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if head.startswith(b"BM"):
        return "BMP"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    return "unknown"


#: the BMP header sizes Pillow reads (BmpImagePlugin): OS/2 1.x's 12 bytes,
#: then BITMAPINFOHEADER to BITMAPV5HEADER, OS/2 2.x's 64 among them
BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
#: the bitfield masks Pillow reads at 16 and 32 bits (at 24 bits only the
#: BGR one), by the shifts of R, G and B: at 32 bits alpha is dropped, and
#: all four masks zero read as BGRA
_MASKS_32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (16, 8, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (24, 16, 8),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (24, 8, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (24, 16, 8),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 8, 16),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (16, 8, 0),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (24, 8, 0),
    (0x0, 0x0, 0x0, 0x0): (16, 8, 0),
}
_MASKS_16 = {(0xF800, 0x7E0, 0x1F): (11, 5, 0, 63), (0x7C00, 0x3E0, 0x1F): (10, 5, 0, 31)}
_COMPRESSIONS = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS", 4: "BI_JPEG", 5: "BI_PNG"}
#: the most pixels Pillow opens (twice ``Image.MAX_IMAGE_PIXELS``: above
#: that it raises ``DecompressionBombError``)
BMP_MAX_PIXELS = 2 * 89478485


def _rle(data: bytes, at: int, w: int, h: int, rle4: bool) -> Optional[bytes]:
    """The index bytes of an RLE8 or RLE4 bitmap from ``data[at:]``, rows
    in file order, as Pillow's ``BmpRleDecoder`` reads them: a run is cut
    at the row's end (the column is not reset by a row that fills up, only
    by end of line and delta); end of line pads the row with zeros; a delta
    escape skips two bytes and reads (right, up) from the next two; an
    absolute run of n reads n bytes (RLE4: n // 2, two pixels each) and
    aligns to an even offset in the file.  None where the stream ends
    before ``w * h`` pixels."""
    out = bytearray()
    x, pos, end, need = 0, at, len(data), w * h
    while len(out) < need:
        if pos + 2 > end:
            break
        n, b = data[pos], data[pos + 1]
        pos += 2
        if n:
            n = max(0, w - x) if x + n > w else n
            if rle4:
                out += bytes((b >> 4, b & 15)) * (n // 2) + (bytes((b >> 4,)) if n % 2 else b"")
            else:
                out += bytes((b,)) * n
            x += n
        elif b == 0:  # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif b == 1:  # end of bitmap
            break
        elif b == 2:  # delta, after two bytes that are skipped
            if pos + 4 > end:
                return None
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # absolute
            count = b // 2 if rle4 else b
            raw = data[pos:pos + count]
            pos += len(raw)
            if rle4:
                nibbles = np.frombuffer(raw, np.uint8)
                out += np.stack([nibbles >> 4, nibbles & 15], 1).tobytes()
            else:
                out += raw
            if len(raw) < count:
                break
            x += b
            pos += pos % 2
    return bytes(out[:need]) if len(out) >= need else None


def decode_bmp(data: bytes, name: str = "BMP") -> np.ndarray:
    """A BMP file as uint8 RGB (H, W, 3), bit for bit with Pillow's
    ``Image.open(path).convert("RGB")`` (``BmpImagePlugin``, Pillow
    12.1.0), the lane through which the JAX package reads BMP files:

    - headers of 12 (OS/2 1.x, 3-byte palette entries), 40, 52, 56, 64,
      108 and 124 bytes; bottom-up rows, or top-down where the height's
      top byte is 0xFF;
    - 1-, 4- and 8-bit palettes of the header's colour count (or 2^bits),
      indices past a short palette black; a palette of 2 entries black and
      white reads as 1-bit pixels and any other gray ramp (entry i = (i, i,
      i)) as 8-bit gray, at every depth, as Pillow drops such palettes (so
      a 4-bit file with the 16-entry ramp reads a byte a pixel, rows
      overlapping, past the file's end as zeros);
    - 16-bit ``BI_RGB`` (555) and ``BI_BITFIELDS`` 555 and 565, each field
      expanded as v * 255 // max; 24-bit ``BI_RGB`` and BGR bitfields;
      32-bit ``BI_RGB`` and the eight bitfield layouts Pillow reads, alpha
      dropped;
    - RLE8 and RLE4 (``_rle``).

    What Pillow refuses raises ``OSError`` naming the file and the reason:
    another header size or depth, ``BI_JPEG``/``BI_PNG`` or an unknown
    compression, other bitfield masks, a palette of no or more than 65536
    colours (or more than 256 that are not a gray ramp), RLE without a
    palette, a truncated file."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: BMP {why}, which Pillow (the JAX package's BMP lane) does not read")

    if len(data) < 18 or data[:2] != b"BM":
        raise OSError(f"{name}: not a BMP file")
    offset, header = struct.unpack_from("<II", data, 10)
    if header not in BMP_HEADERS:
        raise refuse(f"with a {header}-byte header (Pillow reads {', '.join(map(str, BMP_HEADERS))})")
    pos = 14 + header
    if len(data) < pos:
        raise OSError(f"{name}: BMP truncated in its {header}-byte header")
    masks = ()
    if header == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", data, 18)
        compression, colors, entry, top_down = 0, 0, 3, False
    else:
        w, h, _, bits, compression = struct.unpack_from("<IIHHI", data, 18)
        (colors,) = struct.unpack_from("<I", data, 46)
        entry, top_down = 4, data[25] == 0xFF
        if top_down:
            h = 2**32 - h
        if compression == 3:
            if header >= 52:
                masks = struct.unpack_from("<IIII" if header >= 56 else "<III", data, 54)
            else:
                if len(data) < pos + 12:
                    raise OSError(f"{name}: BMP truncated in its bitfield masks")
                masks = struct.unpack_from("<III", data, pos)
                pos += 12
            masks = (masks + (0,))[:4]
    if w <= 0 or h <= 0:
        raise refuse(f"of {w} x {h} pixels")
    if w * h > BMP_MAX_PIXELS:
        raise refuse(f"of {w} x {h} pixels, more than {BMP_MAX_PIXELS}")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise refuse(f"with {bits}-bit pixels (Pillow reads 1, 4, 8, 16, 24 and 32)")
    colors = colors or 1 << bits
    if offset == 14 + header and bits <= 8:  # Pillow's guess that the pixels follow a palette of 4-byte entries
        offset += 4 * colors
    if compression not in (0, 1, 2, 3):
        raise refuse(f"with compression {compression} ({_COMPRESSIONS.get(compression, 'unknown')})")
    if compression == 3 and not ((bits == 32 and masks in _MASKS_32) or (bits == 16 and masks[:3] in _MASKS_16)
                                 or (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF))):
        raise refuse(f"with {bits}-bit bitfields R {masks[0]:#x}, G {masks[1]:#x}, B {masks[2]:#x}, A {masks[3]:#x}")

    gray = "RGB"
    lut = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise refuse(f"with a palette of {colors} colours")
        table = np.frombuffer(data[pos:pos + entry * colors], np.uint8)
        pos += table.size
        ramp = np.array((0, 255) if colors == 2 else np.arange(colors) & 255, np.uint8)
        if table.size == entry * colors and (table.reshape(colors, entry)[:, :3] == ramp[:, None]).all():
            gray = "1" if colors == 2 else "L"
        else:
            n = table.size // entry
            if n > 256:
                raise refuse(f"with a palette of {n} colours that is not a gray ramp (Pillow holds 256)")
            lut = np.zeros((256, 3), np.uint8)  # past the palette's end: black
            lut[:n] = table[: n * entry].reshape(n, entry)[:, 2::-1]
    if not offset:
        offset = pos

    if compression in (1, 2):
        if bits > 8 or gray == "1":
            raise refuse(f"{_COMPRESSIONS[compression]} with {bits}-bit pixels and "
                         + ("a black and white palette" if gray == "1" else "no palette"))
        rle = _rle(data, offset, w, h, compression == 2)
        if rle is None:
            raise OSError(f"{name}: BMP {_COMPRESSIONS[compression]} data end before its {w} x {h} pixels")
        px = np.frombuffer(rle, np.uint8).reshape(h, w)
    else:
        stride = (w * bits + 31) // 32 * 4
        depth = 8 if gray == "L" else 1 if gray == "1" else bits
        row = (w * depth + 7) // 8
        # 8-bit gray over rows of fewer bytes: Pillow maps the file, which must hold every row's stride
        need = offset + (h * stride if stride < row else (h - 1) * stride + row)
        if need > len(data):
            raise OSError(f"{name}: BMP truncated ({len(data)} bytes, its pixels end at {need})")
        span = np.frombuffer(data[offset:offset + (h - 1) * stride + row], np.uint8)
        if span.size < (h - 1) * stride + row:  # overlapping rows: the last reads past the file's end as zeros
            span = np.concatenate([span, np.zeros((h - 1) * stride + row - span.size, np.uint8)])
        rows = np.lib.stride_tricks.as_strided(span, (h, row), (stride, 1))
        if depth < 8:
            per = 8 // depth
            shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
            px = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, row * per)[:, :w]
            if gray == "1":
                px = px * np.uint8(255)
        elif depth == 8:
            px = rows[:, :w]
        elif depth == 16:
            v = rows[:, : 2 * w].copy().view("<u2").astype(np.uint32)
            r, g, b, gmax = _MASKS_16[masks[:3]] if compression == 3 else _MASKS_16[(0x7C00, 0x3E0, 0x1F)]
            px = np.stack([((v >> r) & 31) * 255 // 31, ((v >> g) & gmax) * 255 // gmax, (v & 31) * 255 // 31], -1)
        elif depth == 24:
            px = rows[:, : 3 * w].reshape(h, w, 3)[:, :, ::-1]
        else:
            v = rows[:, : 4 * w].copy().view("<u4")
            shifts = _MASKS_32[masks] if compression == 3 else (16, 8, 0)
            px = np.stack([(v >> s) & 255 for s in shifts], -1)
    if not top_down:
        px = px[::-1]
    if lut is not None:
        return lut[px]
    if px.ndim == 2:
        return np.repeat(px[:, :, None], 3, axis=2).astype(np.uint8)
    return np.ascontiguousarray(px, np.uint8)


def read_image(path: str, shape: Optional[Tuple[int, int]] = None, lane: str = "native") -> np.ndarray:
    """Decode an image file to uint8 RGB (H, W, 3) by its format.  ``shape``,
    the (H, W) the caller expects, lets the native library decode a PNG,
    JPEG or WebP in one call (``native.decode_image``); any shape is still
    read.  ``lane`` is the JAX package's lane to follow where its lanes
    part (``native.LANES``): "native" for the loader, as its
    ``StageDataset`` reads, "pillow" for originals, as its prep and
    ``cli.project`` read them (``Image.open(path).convert("RGB")``)."""
    with open(path, "rb") as f:
        head = f.read(12)
    fmt = sniff(head)
    if fmt == "BMP":
        with open(path, "rb") as f:
            return decode_bmp(f.read(), path)
    if fmt in ("PNG", "JPEG", "WebP"):
        return native.decode_image(path, shape, lane)
    raise OSError(f"{path}: unknown format (first bytes {head[:4]!r}): the PyTorch port decodes PNG, JPEG, BMP "
                  "and WebP files")

