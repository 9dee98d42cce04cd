"""Progressive-growing critic (byogan_tpu/models/critic.py:45-180).

Takes NHWC images, as the JAX critic does, and runs NCHW inside on cuDNN,
as the JAX critic runs on lax: no hand kernel.  Module names follow the
reference state dict (``from_rgbs.k.0``, ``conv_blocks.k.conv_1.0``, ...),
so a reference ``.pth`` critic loads with ``strict=True``.  Every stage's
parameters exist whatever ``steps`` is.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from byogan_tpu_torch.models.layers import (
    EqualizedConv2d,
    EqualizedDense,
    LeakyReLU,
    MinibatchStdDev,
)

# from_rgb output channels, highest resolution first (reference gan.py:305-316).
CRITIC_FROM_RGB: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 512, 512)
# (in, out) per critic block, highest resolution first (reference gan.py:318-329).
CRITIC_CHANNELS: Tuple[Tuple[int, int], ...] = (
    (16, 32),
    (32, 64),
    (64, 128),
    (128, 256),
    (256, 512),
    (512, 512),
    (512, 512),
    (512, 512),
)


def from_rgb(channels: int) -> nn.Sequential:
    """1x1 equalized conv + LeakyReLU stem (reference gan.py:351-355)."""
    return nn.Sequential(EqualizedConv2d(3, channels, 1), LeakyReLU())


class CriticBlock(nn.Module):
    """One critic stage (reference ``CriticBlock``, gan.py:231-265).

    Non-final: conv3x3 + lrelu, then conv3x3 -> AvgPool(2) -> lrelu, unfused
    (JAX folds the conv and the pool into one stride-2 4x4 conv; the two
    agree to rounding).  Final: MinibatchStdDev -> conv3x3 + lrelu -> conv4x4
    (4x4 -> 1x1) -> lrelu -> flatten -> dense + lrelu -> dense(1).
    """

    def __init__(self, in_channels: int, out_channels: int, is_final: bool = False):
        super().__init__()
        self.is_final = is_final
        if is_final:
            self.conv_1 = nn.Sequential(
                MinibatchStdDev(),
                EqualizedConv2d(in_channels + 1, out_channels, 3, padding=1),
                LeakyReLU(),
            )
            self.conv_2 = nn.Sequential(
                EqualizedConv2d(out_channels, out_channels, 4),
                LeakyReLU(),
                nn.Flatten(),
                EqualizedDense(out_channels, out_channels),
                LeakyReLU(),
                EqualizedDense(out_channels, 1),
            )
        else:
            self.conv_1 = nn.Sequential(
                EqualizedConv2d(in_channels, out_channels, 3, padding=1), LeakyReLU()
            )
            self.conv_2 = nn.Sequential(
                EqualizedConv2d(out_channels, out_channels, 3, padding=1),
                nn.AvgPool2d(2),
                LeakyReLU(),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_2(self.conv_1(x))


class Critic(nn.Module):
    """Progressive critic (reference ``Critic``, gan.py:301-349).

    Enters at block ``num_stages - steps``; with ``alpha`` (clamped to
    [0, 1]) the first block's output is blended toward the next stem applied
    to the 2x average-pooled images.  Returns (N, 1) scores.  ``generator``
    seeds the N(0, 1) weights (biases start at zero).
    """

    def __init__(
        self,
        from_rgb_channels: Sequence[int] = CRITIC_FROM_RGB,
        block_channels: Sequence[Tuple[int, int]] = CRITIC_CHANNELS,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        n = len(block_channels)
        self.from_rgbs = nn.ModuleList(from_rgb(c) for c in from_rgb_channels)
        self.conv_blocks = nn.ModuleList(
            CriticBlock(ic, oc, is_final=(i == n - 1))
            for i, (ic, oc) in enumerate(block_channels)
        )
        for m in self.modules():
            if isinstance(m, (EqualizedConv2d, EqualizedDense)):
                m.reset_parameters(generator)

    @property
    def num_stages(self) -> int:
        return len(self.conv_blocks)

    def use_mesh(self, mesh) -> "Critic":
        """Take the minibatch-stddev statistics over the global batch of a
        ``mesh`` (``parallel.mesh.Mesh``), of which this process sees its
        data rank's rows; None: over the batch it is given.  The model
        axis's layers take the mesh where ``parallel.tensor.shard_module_``
        shards their weights."""
        for m in self.modules():
            if isinstance(m, MinibatchStdDev):
                m.mesh = mesh
        return self

    def forward(
        self, images: torch.Tensor, steps: int = 1, alpha: Optional[float] = None
    ) -> torch.Tensor:
        if not 1 <= steps <= self.num_stages:
            raise ValueError(f"steps must be in [1, {self.num_stages}], got {steps}")
        start = self.num_stages - steps
        x = images.permute(0, 3, 1, 2)
        out = self.conv_blocks[start](self.from_rgbs[start](x))
        if steps > 1 and alpha is not None:
            a = min(max(float(alpha), 0.0), 1.0)
            small = self.from_rgbs[start + 1](F.avg_pool2d(x, 2))
            out = small + a * (out - small)
        for block in self.conv_blocks[start + 1 :]:
            out = block(out)
        return out
