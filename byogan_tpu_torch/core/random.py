"""Truncated latents and per-stage synthesis noise (byogan_tpu/core/random.py).

Same distributions as the JAX package, drawn from an explicit
``torch.Generator`` that lives on the target device.  The two frameworks
give different numbers from one seed, so tests feed both the same arrays.
"""

from __future__ import annotations

import math
from typing import List

import torch


def truncated_noise(
    generator: torch.Generator,
    n_samples: int,
    z_dim: int = 512,
    trunc: float = 0.75,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``(n_samples, z_dim)`` draws of N(0,1) truncated to [-trunc, trunc].

    Inverse-CDF sampling in float32: a uniform draw between Phi(-trunc) and
    Phi(trunc) mapped through Phi^-1 (the method of
    ``jax.random.truncated_normal``), clamped against rounding at the ends.
    """
    lo = 0.5 * (1.0 + math.erf(-trunc / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(trunc / math.sqrt(2.0)))
    u = torch.rand(
        (n_samples, z_dim), generator=generator, device=generator.device,
        dtype=torch.float32,
    )
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    return z.clamp_(-trunc, trunc).to(dtype)


def stage_resolution(stage_index: int, base: int = 4) -> int:
    """Spatial resolution of progressive stage ``stage_index`` (0-based)."""
    return base * 2**stage_index


def synthesis_noise(
    generator: torch.Generator,
    batch: int,
    steps: int,
    base: int = 4,
    dtype: torch.dtype = torch.float32,
) -> List[torch.Tensor]:
    """Per-stage noise maps [(N, 4*2^i, 4*2^i, 1) for i < steps], NHWC.

    One map per stage, shared by both convs of the stage.
    """
    out = []
    for i in range(steps):
        r = stage_resolution(i, base)
        out.append(
            torch.randn(
                (batch, r, r, 1), generator=generator,
                device=generator.device, dtype=torch.float32,
            ).to(dtype)
        )
    return out


def fixed_synthesis_noise(
    generator: torch.Generator,
    steps: int = 8,
    base: int = 4,
    dtype: torch.dtype = torch.float32,
) -> List[torch.Tensor]:
    """A batch-1 noise pyramid, broadcast by callers that hold the noise
    fixed across images (byogan_tpu/core/random.py:61-68)."""
    return synthesis_noise(generator, 1, steps, base, dtype)
