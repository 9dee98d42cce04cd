"""2x bilinear upsample and 2x average pool on NHWC tensors
(byogan_tpu/core/resize.py:63-75), and Pillow's bilinear resize of uint8
images, the filter of dataset preparation.

The JAX package hand-writes the align_corners=False stencil to match
``torch.nn.functional.interpolate``; here that call is the implementation.
``F.interpolate(mode="bilinear", antialias=True)`` is not Pillow's filter
(it differs by up to 2 in the last bit on many pixels), so the resize of
``data/prep.py`` follows Pillow's ``Resample.c`` step by step instead.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
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


#: fixed-point bits of Pillow's 8-bit resampling (Resample.c: 32 - 8 - 2)
PIL_PRECISION_BITS = 22


def pil_bilinear_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``Image.BILINEAR`` filter along one axis from ``in_size`` to
    ``out_size`` (Resample.c ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): per output index, the first input index of
    its taps and their fixed-point weights.  Returns ``(first, weights)``,
    (out,) and (out, taps) int64; taps past the image edge weigh 0."""
    scale = in_size / out_size
    support = max(scale, 1.0)  # the triangle's support, 1, times the filter scale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.int64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        x = np.arange(lo, hi, dtype=np.float64)
        w = np.maximum(1.0 - np.abs((x - center + 0.5) / support), 0.0)
        total = np.cumsum(w)[-1] if len(w) else 0.0  # summed in order, as the C loop
        if total != 0.0:
            w = w / total
        first[i] = lo
        weights[i, : hi - lo] = np.trunc(0.5 + w * (1 << PIL_PRECISION_BITS)).astype(np.int64)
    return first, weights


def _pil_pass_plain(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    first, weights = pil_bilinear_taps(img.shape[axis], out_size)
    n = img.shape[axis]
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1 :], 1 << (PIL_PRECISION_BITS - 1), np.int64)
    shape = [1] * img.ndim
    shape[axis] = out_size
    for t in range(weights.shape[1]):
        idx = np.minimum(first + t, n - 1)  # a clipped index carries weight 0
        acc += np.take(img, idx, axis=axis).astype(np.int64) * weights[:, t].reshape(shape)
    return np.clip(acc >> PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize(img, size: int, one_pass):
    """The horizontal pass first, then the vertical; an axis whose size
    does not change is not resampled, as in Pillow."""
    if img.dtype not in (np.uint8, torch.uint8) or img.ndim != 3:
        raise ValueError(f"expected a uint8 (H, W, C) image, got {img.dtype} {tuple(img.shape)}")
    if img.shape[1] != size:
        img = one_pass(img, 1, size)
    if img.shape[0] != size:
        img = one_pass(img, 0, size)
    return img


def resize_uint8_bilinear_pil_plain(img: np.ndarray, size: int) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((size, size), Image.BILINEAR)`` bit
    for bit, in numpy: an (H, W, C) uint8 image to (size, size, C).  Each
    pass sums its taps' products from ``1 << 21``, shifts right by 22 and
    clips to uint8."""
    return _resize(img, size, _pil_pass_plain)


def _pil_pass(img: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    first, weights = pil_bilinear_taps(img.shape[axis], out_size)
    n = img.shape[axis]
    dev = img.device
    shape = [1] * img.ndim
    shape[axis] = out_size
    x = img.to(torch.int32)
    acc = None
    for t in range(weights.shape[1]):
        idx = torch.from_numpy(np.minimum(first + t, n - 1)).to(dev)
        w = torch.from_numpy(weights[:, t].astype(np.int32)).to(dev).reshape(shape)
        term = x.index_select(axis, idx) * w
        acc = term if acc is None else acc + term
    acc = acc + (1 << (PIL_PRECISION_BITS - 1))
    return (acc >> PIL_PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


def resize_uint8_bilinear_pil(img: torch.Tensor, size: int) -> torch.Tensor:
    """``resize_uint8_bilinear_pil_plain`` on a tensor's device: the plain
    numpy version for a CPU tensor; on the card the same banded sums in
    int32, exact, since every partial sum of 8-bit pixels times 22-bit
    weights stays below 2^31."""
    if img.device.type == "cpu":
        return torch.from_numpy(resize_uint8_bilinear_pil_plain(img.numpy(), size))
    return _resize(img, size, _pil_pass)
