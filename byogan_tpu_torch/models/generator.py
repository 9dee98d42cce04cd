"""Progressive-growing StyleGAN generator (byogan_tpu/models/generator.py).

Mapping network -> up to 8 style stages -> per-stage to_rgb, with the
fade-in lerp of the upsampled previous-stage RGB.  All stages' parameters
exist regardless of ``steps``, so checkpoints carry every stage.  Module
names follow the reference state dict: ``to_w_noise.0``, ``gen_blocks.k``,
``to_rgbs.k``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from byogan_tpu_torch.core.resize import upsample2x_bilinear
from byogan_tpu_torch.models.layers import EqualizedConv, MappingNetwork, StyleStage

# (in_channels, out_channels) per stage, 4x4 -> 512x512 (reference gan.py:157-168).
GENERATOR_CHANNELS: Tuple[Tuple[int, int], ...] = (
    (512, 512),
    (512, 512),
    (512, 512),
    (512, 256),
    (256, 128),
    (128, 64),
    (64, 32),
    (32, 16),
)

Style = Union[torch.Tensor, Sequence[torch.Tensor]]


class Generator(nn.Module):
    """StyleGAN generator: mapping net + style stages + per-stage to_rgb.

    ``dtype`` is the compute dtype (None: that of the input); parameters
    stay float32.  ``generator`` seeds the initial weights (N(0,1) weights
    and const, zero biases and noise weights, AdaIN bias [1; 0]).
    """

    def __init__(
        self,
        channels: Sequence[Tuple[int, int]] = GENERATOR_CHANNELS,
        style_dim: int = 512,
        mapping_depth: int = 8,
        z_dim: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.channels = tuple(tuple(c) for c in channels)
        self.style_dim = style_dim
        self.z_dim = style_dim if z_dim is None else z_dim
        self.dtype = dtype
        self.to_w_noise = nn.Sequential(
            MappingNetwork(self.z_dim, style_dim, mapping_depth)
        )
        self.gen_blocks = nn.ModuleList(
            StyleStage(ic, oc, style_dim, is_initial=(i == 0))
            for i, (ic, oc) in enumerate(self.channels)
        )
        self.to_rgbs = nn.ModuleList(
            EqualizedConv(oc, 3, 1) for _, oc in self.channels
        )
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.to_w_noise[0].layers:
            layer[0].reset_parameters(generator)
        for stage in self.gen_blocks:
            stage.conv_1.reset_parameters(generator)
            stage.conv_2.reset_parameters(generator)
        for to_rgb in self.to_rgbs:
            to_rgb.reset_parameters(generator)

    @property
    def num_stages(self) -> int:
        return len(self.channels)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.dtype is None else t.to(self.dtype)

    def map_latent(self, z: torch.Tensor) -> torch.Tensor:
        """z -> w through the mapping network only (W-space access)."""
        return self.to_w_noise(self._cast(z))

    def forward(
        self,
        z: Optional[torch.Tensor],
        noise: Sequence[torch.Tensor],
        steps: int = 1,
        alpha: Optional[float] = None,
        style: Optional[Style] = None,
    ) -> torch.Tensor:
        """Synthesize images at stage ``steps``: (N, R, R, 3), ~[-1, 1].

        ``alpha`` (clamped to [0, 1]) blends the upsampled previous-stage RGB
        toward the current one; ``None`` means no blend.  ``style`` injects
        W-space styles instead of mapping ``z``: one (N, style_dim) tensor
        for every stage, or a sequence of >= ``steps`` per-stage tensors.
        """
        if not 1 <= steps <= self.num_stages:
            raise ValueError(f"steps must be in [1, {self.num_stages}], got {steps}")
        if len(noise) < steps:
            raise ValueError(f"need {steps} noise maps, got {len(noise)}")
        if style is None:
            styles = [self.map_latent(z)] * steps
        elif isinstance(style, (list, tuple)):
            if len(style) < steps:
                raise ValueError(f"need {steps} per-stage styles, got {len(style)}")
            styles = [self._cast(s) for s in style[:steps]]
        else:
            styles = [self._cast(style)] * steps

        out = prev = None
        for i in range(steps):
            prev = out
            out = self.gen_blocks[i](out, styles[i], noise[i])

        if alpha is not None and steps > 1:
            a = min(max(float(alpha), 0.0), 1.0)
            small_up = upsample2x_bilinear(self.to_rgbs[steps - 2](prev))
            large = self.to_rgbs[steps - 1](out)
            return small_up + a * (large - small_up)
        return self.to_rgbs[steps - 1](out)
