"""Quantization to uint8 (byogan_tpu/core/grids.py:42-47)."""

from __future__ import annotations

import torch


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """[0,1]-nominal float -> uint8 with torchvision ``save_image`` rounding:
    ``clamp(x*255 + 0.5, 0, 255)`` then truncation; out-of-range values
    saturate, so the generator's negative half maps to 0."""
    return (image.float() * 255.0 + 0.5).clamp_(0, 255).to(torch.uint8)
