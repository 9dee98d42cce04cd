"""A synthetic prepared dataset, written with numpy alone.

``write_prepared_dataset`` writes ``<root>/prepared/set_1 .. set_k`` (class
folder ``0``), one PNG per image at each stage's resolution 4*2^(k-1):
smooth colour gradients with a disk, drawn from parameters made by
``np.random.default_rng(seed)``, so every stage shows the same scenes.
For tests and for the smoke run on the card, which has no PIL.
``encode_png_filtered`` writes originals for ``data/prep.py`` under each
of PNG's five row filters, ``encode_bmp`` the 24-bit bitmaps Pillow
writes.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from byogan_tpu_torch.serve import _png_chunk, encode_png


def render(params: np.ndarray, size: int) -> np.ndarray:
    """One uint8 (size, size, 3) image from its 9 parameters."""
    cx, cy, r, p0, p1, p2, c0, c1, c2 = params
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack([np.sin(4 * xx + p) * np.cos(3 * yy + p) for p in (p0, p1, p2)], axis=-1)
    disk = ((xx - cx) ** 2 + (yy - cy) ** 2) < (0.3 * r) ** 2
    img[disk] = (c0, c1, c2)
    return ((img * 0.5 + 0.5) * 255).astype(np.uint8)


def write_prepared_dataset(root: str, n_images: int, num_stages: int, seed: int = 0) -> str:
    """Write ``n_images`` scenes at every stage up to ``num_stages``; returns
    ``root``, the path a config's ``data`` key takes."""
    rng = np.random.default_rng(seed)
    params = np.concatenate(
        [rng.random((n_images, 3)) * 0.8 + 0.1, rng.random((n_images, 3)) * 6.28,
         rng.random((n_images, 3)) * 2 - 1],
        axis=1,
    )
    for stage in range(1, num_stages + 1):
        size = 4 * 2 ** (stage - 1)
        folder = os.path.join(root, "prepared", f"set_{stage}", "0")
        os.makedirs(folder, exist_ok=True)
        for i, p in enumerate(params):
            with open(os.path.join(folder, f"img-{i:04d}.png"), "wb") as f:
                f.write(encode_png(render(p, size), compression=1))
    return root


def encode_png_filtered(img: np.ndarray, row_filter: int, compression: int = 6) -> bytes:
    """A uint8 RGB image (H, W, 3) as PNG bytes with every row under one
    PNG filter: 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth.  Each predictor
    reads the unfiltered neighbours, so the whole image filters at once.
    For originals that exercise every path of the decoder."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    left, up, up_left = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    left[:, c:], up[1:], up_left[1:, c:] = x[:, :-c], x[:-1], x[:-1, :-c]
    if row_filter == 4:
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    else:
        pred = (0, left, up, (left + up) >> 1)[row_filter]
    rows = np.concatenate([np.full((h, 1), row_filter, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"".join((b"\x89PNG\r\n\x1a\n", _png_chunk(b"IHDR", header),
                     _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), compression)), _png_chunk(b"IEND", b"")))


def encode_bmp(img: np.ndarray) -> bytes:
    """A uint8 RGB image (H, W, 3) as an uncompressed 24-bit BMP, rows
    bottom-up and padded to 4 bytes, as Pillow writes RGB images."""
    h, w, _ = img.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + info + rows.tobytes()
