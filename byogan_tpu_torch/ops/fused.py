"""Synthesis epilogue: noise-inject -> LeakyReLU -> AdaIN (byogan_tpu/ops/fused.py).

``noise_lrelu_adain_plain`` is the plain PyTorch version, cast for cast the
JAX package's ``noise_lrelu_adain_lax``.  ``noise_lrelu_adain`` dispatches
on the tensor's device: the plain version on the CPU, the hand-written K2
kernel (``ops/adain.py``) on CUDA.
"""

from __future__ import annotations

import torch


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU(0.2), the reference's sole activation."""
    return torch.where(x >= 0, x, negative_slope * x)


def instance_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """InstanceNorm2d(eps, affine=False) over NHWC: f32 statistics over
    (H, W), biased variance, eps inside the rsqrt, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def noise_lrelu_adain_plain(
    x: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """x (N,H,W,C); noise (N,H,W,1); noise_w (C,); gamma, beta (N,C)."""
    h = x + noise_w.to(x.dtype) * noise.to(x.dtype)
    h = leaky_relu(h)
    norm = instance_norm(h, eps)
    return gamma[:, None, None, :].to(x.dtype) * norm + beta[
        :, None, None, :
    ].to(x.dtype)


def noise_lrelu_adain(
    x: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """The epilogue: plain on a CPU tensor, the K2 kernel on a CUDA one."""
    if x.device.type == "cpu":
        return noise_lrelu_adain_plain(x, noise, noise_w, gamma, beta, eps)
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda

    return noise_lrelu_adain_cuda(x, noise, noise_w, gamma, beta, eps)
