"""StyleGAN building blocks (byogan_tpu/models/layers.py).

Parameters are stored under the reference state-dict names and layouts --
linear (out, in), conv OIHW, noise (1, C, 1, 1), const (1, C, 4, 4) -- so a
reference ``.pth`` loads with ``load_state_dict(strict=True)``.  The
generator's activations are NHWC, as in the JAX package; the critic runs
NCHW inside (``EqualizedConv2d``, ``MinibatchStdDev``) on cuDNN, as JAX runs
its critic on lax.  Weights stay float32; a layer computes in its input's
dtype, multiplying by the equalized scale in float32 and casting at call
time, as the JAX layers do.

Under the model axis (``parallel/tensor.py``) a layer whose weight is
sharded holds its block of output features and runs column-parallel: its
``model_mesh`` is set, it computes its block from the full, replicated
input (through ``CopyToModel``) and gathers the blocks
(``GatherChannels``); with no mesh both are the identity, so one body
serves both.  ``tp_block_params`` names the replicated parameters a layer
uses on its block only, whose gradients the model group sums.  The
synthesis conv runs K1 on its block of channels with the matching blocks
of the conv bias, noise weights, gamma and beta: the instance norm and the
style affine work per channel, so a block needs nothing of the other
ranks' channels.  A synthesis block whose conv is replicated but whose
style is sharded (the initial block, and 64 px at full width) gathers
gamma and beta first.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from byogan_tpu_torch.core.resize import upsample2x_bilinear
from byogan_tpu_torch.ops.fused import leaky_relu, noise_lrelu_adain
from byogan_tpu_torch.ops.styleconv import styleconv
from byogan_tpu_torch.parallel.mesh import AllReduceSum
from byogan_tpu_torch.parallel.tensor import copy_to_model, gather_channels, local_rows, local_style_rows


class EqualizedDense(nn.Module):
    """Equalized-LR linear layer: N(0,1) weight, runtime scale
    sqrt(2 / in_features) (layers.py:39-67)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.scale = math.sqrt(2.0 / in_features)
        self.model_mesh = None  # set where the weight is sharded (parallel.tensor.shard_module_)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.normal_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)

    def tp_block_params(self) -> Tuple[str, ...]:
        """The replicated parameters used on this rank's block only."""
        return () if self.model_mesh is None else ("bias",)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight * self.scale).to(x.dtype)
        mesh = self.model_mesh
        b = local_rows(self.bias, w.shape[0], mesh).to(x.dtype)
        return gather_channels(F.linear(copy_to_model(x, mesh), w, b), -1, mesh)


class EqualizedConv(nn.Module):
    """Equalized-LR conv: OIHW weight, runtime scale sqrt(2 / (Cin*k*k))
    (layers.py:253-288).  Only the 1x1 to_rgb form is applied directly; the
    3x3 synthesis convs go through ``StyleConvBlock``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = math.sqrt(2.0 / (in_channels * kernel_size * kernel_size))
        self.model_mesh = None  # set where the weight is sharded (parallel.tensor.shard_module_)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.normal_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)

    def tp_block_params(self) -> Tuple[str, ...]:
        """The replicated parameters used on this rank's block only."""
        return () if self.model_mesh is None else ("bias",)

    def scaled_hwio(self, dtype: torch.dtype) -> torch.Tensor:
        """weight * scale in float32, as HWIO, cast to ``dtype``."""
        return (self.weight * self.scale).permute(2, 3, 1, 0).to(dtype).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """1x1 conv on NHWC x: a matmul over the channel axis."""
        if self.weight.shape[-1] != 1:
            raise ValueError("EqualizedConv.forward applies 1x1 kernels only")
        w = (self.weight[:, :, 0, 0] * self.scale).to(x.dtype)
        return F.linear(x, w, self.bias.to(x.dtype))


class EqualizedConv2d(EqualizedConv):
    """The critic's equalized conv on NCHW activations: any kernel size,
    zero padding ``padding``, through ``F.conv2d``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int = 0):
        super().__init__(in_channels, out_channels, kernel_size)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight * self.scale).to(x.dtype)
        mesh = self.model_mesh
        b = local_rows(self.bias, w.shape[0], mesh).to(x.dtype)
        return gather_channels(F.conv2d(copy_to_model(x, mesh), w, b, padding=self.padding), 1, mesh)


class LeakyReLU(nn.Module):
    """``leaky_relu`` as a module, for the critic's ``nn.Sequential`` slots
    (the reference's index positions carry its state-dict names)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x)


class NoiseInjection(nn.Module):
    """Per-channel learned noise scale, zero-init (layers.py:291-306)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.zeros_(self.weights)

    def flat(self) -> torch.Tensor:
        """The (C,) float32 weight the kernels take."""
        return self.weights.reshape(-1)


class AdaIN(nn.Module):
    """Style projection of adaptive instance norm (layers.py:322-365):
    an equalized linear style -> (gamma, beta), bias init [1; 0], gamma the
    first half.  The normalization itself runs in the fused epilogue."""

    def __init__(self, channels: int, style_dim: int):
        super().__init__()
        self.channels = channels
        self.style = EqualizedDense(style_dim, 2 * channels)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.style.reset_parameters(generator)
        with torch.no_grad():
            self.style.bias[: self.channels] = 1.0

    def forward(self, style: torch.Tensor, on_block: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(gamma, beta) of every channel; with ``on_block``, of this model
        rank's block of channels where the style weight is sharded (its
        rows are [gamma block; beta block], ``parallel.tensor.shard_rows``)."""
        layer = self.style
        mesh = layer.model_mesh
        w = (layer.weight * layer.scale).to(style.dtype)
        b = local_style_rows(layer.bias, w.shape[0] // 2, mesh).to(style.dtype)
        proj = F.linear(copy_to_model(style, mesh), w, b)
        proj = proj.view(proj.shape[0], 2, -1)
        if not on_block:
            proj = gather_channels(proj, 2, mesh)
        return proj[:, 0], proj[:, 1]


class StyleConvBlock(nn.Module):
    """One synthesis conv (layers.py:368-480).

    The initial block broadcasts a learned 4x4 const and runs the epilogue
    alone (K2 on CUDA).  Every other block upsamples 2x first when asked,
    then runs conv3x3 -> noise -> LeakyReLU -> AdaIN as one call (K1 on
    CUDA).  On the CPU both take their plain versions.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        style_dim: int,
        is_initial: bool = False,
        upsample_input: bool = False,
    ):
        super().__init__()
        self.is_initial = is_initial
        self.upsample_input = upsample_input
        if is_initial:
            self.conv = nn.Parameter(torch.empty(1, in_channels, 4, 4))
        else:
            self.conv = EqualizedConv(in_channels, out_channels, 3)
        self.inject_noise = NoiseInjection(out_channels)
        self.adain = AdaIN(out_channels, style_dim)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        if self.is_initial:
            nn.init.normal_(self.conv, generator=generator)
        else:
            self.conv.reset_parameters(generator)
        self.inject_noise.reset_parameters(generator)
        self.adain.reset_parameters(generator)

    def tp_block_params(self) -> Tuple[str, ...]:
        """The replicated parameters used on this rank's block only (the
        conv's bias is the conv's own)."""
        sharded = not self.is_initial and self.conv.model_mesh is not None
        return ("inject_noise.weights",) if sharded else ()

    def forward(
        self, x: Optional[torch.Tensor], style: torch.Tensor, noise: torch.Tensor
    ) -> torch.Tensor:
        mesh = None if self.is_initial else self.conv.model_mesh
        gamma, beta = self.adain(style, on_block=mesh is not None)
        noise_w = self.inject_noise.flat()
        if self.is_initial:
            const = self.conv.permute(0, 2, 3, 1).to(style.dtype)
            out = const.expand(style.shape[0], -1, -1, -1).contiguous()
            return noise_lrelu_adain(
                out, noise.to(out.dtype), noise_w, gamma.contiguous(),
                beta.contiguous(),
            )
        if self.upsample_input:
            x = upsample2x_bilinear(x)
        w = self.conv.scaled_hwio(x.dtype)
        k = w.shape[-1]
        out = styleconv(
            copy_to_model(x.contiguous(), mesh),
            w,
            local_rows(self.conv.bias, k, mesh).contiguous(),
            noise.to(x.dtype).contiguous(),
            local_rows(noise_w, k, mesh).contiguous(),
            gamma.contiguous(),
            beta.contiguous(),
        )
        return gather_channels(out, 3, mesh)


class StyleStage(nn.Module):
    """One resolution stage (layers.py:483-526): optional 2x bilinear
    upsample, then two StyleConvBlocks sharing one style and one noise map."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        style_dim: int,
        is_initial: bool = False,
    ):
        super().__init__()
        self.conv_1 = StyleConvBlock(
            in_channels, out_channels, style_dim, is_initial=is_initial,
            upsample_input=not is_initial,
        )
        self.conv_2 = StyleConvBlock(out_channels, out_channels, style_dim)

    def forward(
        self, x: Optional[torch.Tensor], style: torch.Tensor, noise: torch.Tensor
    ) -> torch.Tensor:
        return self.conv_2(self.conv_1(x, style, noise), style, noise)


class MappingNetwork(nn.Module):
    """z -> w: ``depth`` x (EqualizedDense + LeakyReLU(0.2)), no PixelNorm
    (layers.py:529-551)."""

    def __init__(self, z_dim: int, channels: int = 512, depth: int = 8):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Sequential(
                EqualizedDense(z_dim if i == 0 else channels, channels),
                nn.LeakyReLU(0.2),
            )
            for i in range(depth)
        )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            z = layer(z)
        return z


class MinibatchStdDev(nn.Module):
    """Minibatch standard-deviation channel on NCHW (layers.py:554-587),
    with the reference's statistics: the mean over the FULL batch; groups
    by a strided reshape, so sample ``g*(B/G) + m`` belongs to column ``m``
    and every member of a column shares its stat; the whole batch as the
    group when ``group_size`` does not divide it (no state kept).  f32
    statistics, cast back to x's dtype.

    Under data parallelism (``mesh``, which ``shard_train_state`` sets) x
    holds this data rank's contiguous row block of the global batch, as JAX's
    batch sharding lays it out, and the statistics are the global batch's:
    the mean is the ranks' row sums added by ``AllReduceSum`` over B, and
    each column's squared deviations are summed by global row index
    (``row % M``) on each rank, then across the data group.  Under the
    model axis x is the gathered activation, the same on every rank of a
    model group.  Without a mesh it is the single-process module."""

    def __init__(self, group_size: int = 4):
        super().__init__()
        self.group_size = group_size
        self.mesh = None  # a parallel.mesh.Mesh, or None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            return self._forward_over_mesh(x)
        b, c, h, w = x.shape
        g = self.group_size if b % self.group_size == 0 else b
        m = b // g
        x32 = x.float()
        dev2 = (x32 - x32.mean(dim=0, keepdim=True)).square().reshape(g, m, c, h, w)
        stat = torch.sqrt(dev2.mean(dim=0) + 1e-8).mean(dim=(1, 2, 3))  # (M,)
        stat_map = stat.repeat(g)[:, None, None, None].expand(b, 1, h, w)
        return torch.cat([x, stat_map.to(x.dtype)], dim=1)

    def _forward_over_mesh(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        local, c, h, w = x.shape
        b = local * mesh.size
        g = self.group_size if b % self.group_size == 0 else b
        m = b // g
        x32 = x.float()
        mean = AllReduceSum.apply(x32.sum(dim=0), mesh) / b
        cols = torch.arange(mesh.rank * local, (mesh.rank + 1) * local, device=x.device) % m
        dev2 = x32.new_zeros((m, c, h, w)).index_add(0, cols, (x32 - mean).square())
        stat = torch.sqrt(AllReduceSum.apply(dev2, mesh) / g + 1e-8).mean(dim=(1, 2, 3))  # (M,)
        stat_map = stat[cols][:, None, None, None].expand(local, 1, h, w)
        return torch.cat([x, stat_map.to(x.dtype)], dim=1)
