"""Truncated latents and per-stage synthesis noise (byogan_tpu/core/random.py).

Same distributions as the JAX package, drawn from an explicit
``torch.Generator`` that lives on the target device.  The two frameworks
give different numbers from one seed, so tests feed both the same arrays.
``seeded_synthesis_noise`` draws the noise maps from a seed by tensor ops
alone, so that a ``torch.export`` program can take the seed as an input
(a ``torch.Generator`` cannot be captured in one).
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

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


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for x, c below 2^32, from 16-bit halves of x so
    that no int64 product reaches 2^63 (where torch's multiply wraps)."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32) of int64 tensors holding values
    below 2^32; every intermediate stays below 2^49."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seeded_synthesis_noise(
    seed: Union[int, torch.Tensor],
    batch: int,
    steps: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
    base: int = 4,
) -> List[torch.Tensor]:
    """``synthesis_noise``'s maps [(N, 4*2^i, 4*2^i, 1) for i < steps] as a
    function of ``seed`` (an int or an int64 0-dim tensor), in tensor ops
    that ``torch.export`` traces: element ``j`` of the maps laid end to end
    takes two uniforms from a counter-based hash of (seed, 2j) and (seed,
    2j + 1), 24 bits each, and Box-Muller in f64, rounded to f32 and then
    to ``dtype``.  The CPU and the card give the same numbers (the integer
    part exactly, the f64 part within an f32 rounding).  Not the numbers of
    the JAX package's ``synthesis_noise``, nor of a ``torch.Generator``."""
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor(int(seed), dtype=torch.int64, device=device)
    dev = seed.device if device is None else torch.device(device)
    seed = seed.to(device=dev, dtype=torch.int64)
    key = _hash32((seed & _MASK32) ^ _hash32((seed >> 32) & _MASK32))
    sizes = [batch * stage_resolution(i, base) ** 2 for i in range(steps)]
    counter = torch.arange(2 * sum(sizes), dtype=torch.int64, device=dev)
    bits = _hash32(_hash32((counter + key) & _MASK32)) >> 8
    u1 = (bits[0::2] + 1).double() * 2.0**-24  # (0, 1]
    u2 = bits[1::2].double() * 2.0**-24  # [0, 1)
    z = (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)).float().to(dtype)
    out = []
    for i, part in enumerate(torch.split(z, sizes)):
        r = stage_resolution(i, base)
        out.append(part.reshape(batch, r, r, 1))
    return out
