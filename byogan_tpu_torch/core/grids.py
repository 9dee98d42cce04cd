"""Quantization to uint8 and sample grids (byogan_tpu/core/grids.py:21-47)."""

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
