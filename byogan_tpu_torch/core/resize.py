"""2x bilinear upsample and 2x average pool on NHWC tensors
(byogan_tpu/core/resize.py:63-75).

The JAX package hand-writes the align_corners=False stencil to match
``torch.nn.functional.interpolate``; here that call is the implementation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C), torch ``Upsample(2, "bilinear")``."""
    up = F.interpolate(
        x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
        align_corners=False,
    )
    return up.permute(0, 2, 3, 1).contiguous()


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, C), torch ``avg_pool2d(x, 2)``: the
    mean of each 2x2 block."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
