"""Quantization to uint8, sample grids and PNG files
(byogan_tpu/core/grids.py:21-89)."""

from __future__ import annotations

import math

import numpy as np
import torch


def make_grid(
    images: np.ndarray, nrow: int = 8, padding: int = 2, pad_value: float = 0.0
) -> np.ndarray:
    """NHWC batch -> one HWC grid with torchvision ``make_grid`` semantics:
    ``nrow`` images per row, ``padding`` pixels around and between them."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncols = min(nrow, n)
    nrows = int(math.ceil(n / ncols))
    grid = np.full(
        (nrows * (h + padding) + padding, ncols * (w + padding) + padding, c),
        pad_value, dtype=images.dtype,
    )
    for idx in range(n):
        r, col = divmod(idx, ncols)
        y, x = r * (h + padding) + padding, col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[idx]
    return grid


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """[0,1]-nominal float -> uint8 with torchvision ``save_image`` rounding:
    ``clamp(x*255 + 0.5, 0, 255)`` then truncation; out-of-range values
    saturate, so the generator's negative half maps to 0."""
    return (image.float() * 255.0 + 0.5).clamp_(0, 255).to(torch.uint8)


def uint8_to_training_range(u8: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 in [-1, 1], ``u8 * 2/255 - 1``: the training
    normalization, shared by every metric so that real and generated pixels
    meet in one range, on the tensor's own device.  Not the inverse of
    :func:`to_uint8`, the reference's raw-range save rule."""
    return u8.float() * (2.0 / 255.0) - 1.0


def _write_png(u8: np.ndarray, path: str, compression: int = 6) -> None:
    from byogan_tpu_torch.serve import encode_png  # serve imports this module

    with open(path, "wb") as f:
        f.write(encode_png(u8, compression))


def save_image(image, path: str, compression: int = 6) -> None:
    """One HWC float image ([0,1]-nominal, tensor or array) as a PNG with
    ``to_uint8``'s rounding."""
    _write_png(to_uint8(torch.as_tensor(image)).cpu().numpy(), path, compression)


def save_image_grid(images, path: str, nrow: int = 8, padding: int = 2) -> None:
    """An NHWC float batch as one grid PNG, zero padding."""
    u8 = to_uint8(torch.as_tensor(images)).cpu().numpy()
    _write_png(make_grid(u8, nrow=nrow, padding=padding), path)
