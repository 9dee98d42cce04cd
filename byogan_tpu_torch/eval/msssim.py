"""Multi-scale structural similarity (MS-SSIM), the diversity metric
(byogan_tpu/eval/msssim.py:64-157).

SWD (eval/swd.py) measures how far the generated distribution is from the
real one; the mean MS-SSIM between random pairs of generated images reads
out mode collapse (it goes to 1.0 when the generator emits near-identical
images).  Wang et al. 2003, the canonical 5-scale form, as the JAX package
computes it:

- an 11x11 Gaussian window, sigma 1.5, as two separable depthwise
  convolutions in float32 without padding;
- contrast*structure ``cs_j`` at every scale, luminance only at the
  coarsest, scales linked by the 2x average pool (core/resize.py);
- exponents (0.0448, 0.2856, 0.3001, 0.2363, 0.1333), negative ``cs``
  clamped to 0; the scale count ``M = min(5, floor(log2(size/11)) + 1)``
  adapts to small stages with the first ``M`` exponents renormalized, and
  below 11 px the window clamps to the image.

Inputs are uint8 (converted to the training range) or float in [-1, 1]; the
dynamic range is 2.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from byogan_tpu_torch.core.grids import uint8_to_training_range
from byogan_tpu_torch.core.resize import avg_pool2x

#: per-scale exponents (Wang et al. 2003), truncated and renormalized for
#: small images
WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
WINDOW = 11
SIGMA = 1.5
K1 = 0.01
K2 = 0.03
#: images live in the training range [-1, 1]
DYNAMIC_RANGE = 2.0


def _gaussian_kernel(size: int, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * SIGMA * SIGMA))
    return g / g.sum()


def _blur(x: torch.Tensor, size: int) -> torch.Tensor:
    """Separable depthwise Gaussian without padding, NHWC float32."""
    c = x.shape[-1]
    g = _gaussian_kernel(size, x.device)
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, g.view(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    y = F.conv2d(y, g.view(1, 1, 1, size).expand(c, 1, 1, size), groups=c)
    return y.permute(0, 2, 3, 1)


def _ssim_terms(a: torch.Tensor, b: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image mean (luminance*cs, cs) over the valid SSIM map."""
    c1 = (K1 * DYNAMIC_RANGE) ** 2
    c2 = (K2 * DYNAMIC_RANGE) ** 2
    mu_a, mu_b = _blur(a, size), _blur(b, size)
    var_a = _blur(a * a, size) - mu_a * mu_a
    var_b = _blur(b * b, size) - mu_b * mu_b
    cov = _blur(a * b, size) - mu_a * mu_b
    lum = (2.0 * mu_a * mu_b + c1) / (mu_a * mu_a + mu_b * mu_b + c1)
    cs = (2.0 * cov + c2) / (var_a + var_b + c2)
    return (lum * cs).mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def _num_scales(size: int, max_scales: int) -> int:
    if size < WINDOW:
        return 1
    return max(1, min(max_scales, int(math.floor(math.log2(size / WINDOW))) + 1))


def _to_float(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    if x.dtype == torch.uint8:
        return uint8_to_training_range(x)
    return x.float()


def _msssim_pairs(a: torch.Tensor, b: torch.Tensor, scales: int) -> torch.Tensor:
    weights = torch.tensor(WEIGHTS[:scales], dtype=torch.float32, device=a.device)
    weights = weights / weights.sum()
    score = torch.ones(a.shape[0], dtype=torch.float32, device=a.device)
    for j in range(scales):
        size = min(WINDOW, a.shape[1], a.shape[2])
        lum_cs, cs = _ssim_terms(a, b, size)
        if j < scales - 1:
            score = score * torch.pow(cs.clamp(min=0.0), weights[j])
            a, b = avg_pool2x(a), avg_pool2x(b)
        else:
            score = score * torch.pow(lum_cs.clamp(min=0.0), weights[j])
    return score


def msssim(a, b, max_scales: int = 5) -> torch.Tensor:
    """Per-pair MS-SSIM in [0, 1] of matched NHWC batches (1.0 = identical),
    scale count adapted to the resolution; uint8 inputs are converted."""
    a, b = _to_float(a), _to_float(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    return _msssim_pairs(a, b, _num_scales(min(a.shape[1], a.shape[2]), max_scales))


def msssim_diversity(images) -> torch.Tensor:
    """Mean MS-SSIM over split-half pairs (image i against i + N/2) of a
    sample set: near 1.0, the generator emits near-identical images.  Report
    the real set's own score beside it."""
    n = images.shape[0]
    if n < 2:
        raise ValueError("need at least 2 images to measure diversity")
    half = n // 2
    return msssim(images[:half], images[half : 2 * half]).mean()
