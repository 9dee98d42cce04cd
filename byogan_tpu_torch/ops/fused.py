"""Synthesis epilogue: noise-inject -> LeakyReLU -> AdaIN (byogan_tpu/ops/fused.py).

``noise_lrelu_adain_plain`` is the plain PyTorch version, cast for cast the
JAX package's ``noise_lrelu_adain_lax``.  ``noise_lrelu_adain`` dispatches
on the tensor's device: the plain version on the CPU, the hand-written K2
kernel (``ops/adain.py``) on CUDA.  When an input wants a gradient it goes
through ``NoiseLReLUAdaINFunction``, whose backward is K3
(``ops/styleconv_bwd.py``); JAX differentiates the lax epilogue instead.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from byogan_tpu_torch.ops.styleconv_bwd import styleconv_backward


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
    with_stats: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """x (N,H,W,C); noise (N,H,W,1); noise_w (C,); gamma, beta (N,C).
    ``with_stats`` also returns the pre-norm activations as f32 and their
    per-(sample, channel) mean and inv = rsqrt(var + eps), (N,C) f32."""
    h = x + noise_w.to(x.dtype) * noise.to(x.dtype)
    h = leaky_relu(h)
    norm = instance_norm(h, eps)
    out = gamma[:, None, None, :].to(x.dtype) * norm + beta[
        :, None, None, :
    ].to(x.dtype)
    if not with_stats:
        return out
    hv = h.float()
    mean = hv.mean(dim=(1, 2))
    var = (hv - mean[:, None, None, :]).square().mean(dim=(1, 2))
    return out, hv, mean, torch.rsqrt(var + eps)


class NoiseLReLUAdaINFunction(torch.autograd.Function):
    """The differentiable epilogue of the initial 4x4 block: K2 with its
    residuals forward, K3 backward (the plain versions on a CPU tensor).
    dx is K3's dpre; the caller's broadcast of the learned const sums it
    over the batch.  No second derivative."""

    @staticmethod
    def forward(ctx, x, noise, noise_w, gamma, beta, eps):
        if x.device.type == "cpu":
            fwd = noise_lrelu_adain_plain
        else:
            from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda as fwd
        out, hv, mean, inv = fwd(x, noise, noise_w, gamma, beta, eps, with_stats=True)
        ctx.save_for_backward(noise, noise_w, gamma, hv, mean, inv)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        noise, noise_w, gamma, hv, mean, inv = ctx.saved_tensors
        g = styleconv_backward(dy.contiguous(), hv, mean, inv, gamma, noise, noise_w)
        grads = (g.dpre, g.dnoise, g.dnoise_w, g.dgamma, g.dbeta)
        return tuple(
            t if want else None for t, want in zip(grads, ctx.needs_input_grad)
        ) + (None,)


def noise_lrelu_adain(
    x: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """The epilogue: plain on a CPU tensor, the K2 kernel on a CUDA one,
    through ``NoiseLReLUAdaINFunction`` when an input wants a gradient."""
    args = (x, noise, noise_w, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return NoiseLReLUAdaINFunction.apply(*args, eps)
    if x.device.type == "cpu":
        return noise_lrelu_adain_plain(x, noise, noise_w, gamma, beta, eps)
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda

    return noise_lrelu_adain_cuda(x, noise, noise_w, gamma, beta, eps)
