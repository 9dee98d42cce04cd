"""2x bilinear upsample on NHWC tensors (byogan_tpu/core/resize.py:63-67).

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
