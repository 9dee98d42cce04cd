"""Image files of a dataset: which are listed, and how each is decoded.

A file is listed by its extension, as the JAX package lists them
(``IMAGE_EXTENSIONS``, byogan_tpu/data/prep.py:25-29), and decoded by its
first bytes: PNG, JPEG and WebP through the port's own codecs
(``data/native.py``), BMP by ``decode_bmp`` below.  Any other file, or one
a decoder refuses, raises an ``OSError`` that names it and the reason: no
listed file is skipped.
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


def decode_bmp(data: bytes, name: str = "BMP") -> np.ndarray:
    """An uncompressed 24- or 32-bit (``BI_RGB``) BMP, what Pillow writes for
    RGB and RGBA images, as uint8 RGB (H, W, 3); the fourth byte of 32-bit
    pixels is dropped, as Pillow's ``convert("RGB")`` does.  Bottom-up and
    top-down rows."""
    if len(data) < 54 or data[:2] != b"BM":
        raise OSError(f"{name}: not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    header, w, h, _, bits, compression = struct.unpack_from("<IiiHHI", data, 14)
    if header < 40 or bits not in (24, 32) or compression != 0 or w <= 0 or h == 0:
        raise OSError(
            f"{name}: BMP with a {header}-byte header, {bits}-bit pixels and compression {compression}: "
            "only uncompressed 24- and 32-bit BI_RGB bitmaps are read"
        )
    ch, rows = bits // 8, abs(h)
    stride = (w * bits + 31) // 32 * 4
    if offset + stride * rows > len(data):
        raise OSError(f"{name}: BMP truncated ({len(data)} bytes, pixels end at {offset + stride * rows})")
    px = np.frombuffer(data, np.uint8, count=stride * rows, offset=offset).reshape(rows, stride)
    px = px[:, : w * ch].reshape(rows, w, ch)
    if h > 0:  # bottom-up
        px = px[::-1]
    return np.ascontiguousarray(px[:, :, 2::-1])  # BGR(X) -> RGB


def read_image(path: str, shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Decode an image file to uint8 RGB (H, W, 3) by its format.  ``shape``,
    the (H, W) the caller expects, lets the native library decode a PNG,
    JPEG or WebP in one call (``native.decode_image``); any shape is still
    read."""
    with open(path, "rb") as f:
        head = f.read(12)
    fmt = sniff(head)
    if fmt == "BMP":
        with open(path, "rb") as f:
            return decode_bmp(f.read(), path)
    if fmt in ("PNG", "JPEG", "WebP"):
        return native.decode_image(path, shape)
    raise OSError(f"{path}: unknown format (first bytes {head[:4]!r}): the PyTorch port decodes PNG, JPEG, BMP "
                  "and WebP files")

