"""Synthesis epilogue: noise-inject -> LeakyReLU -> AdaIN (byogan_tpu/ops/fused.py).

``noise_lrelu_adain_plain`` is the plain PyTorch version, cast for cast the
JAX package's ``noise_lrelu_adain_lax``.  ``noise_lrelu_adain`` dispatches
on the tensor's device: the plain version on the CPU, the hand-written K2
kernel (``ops/adain.py``) on CUDA, through the registered op
``byogan::noise_lrelu_adain``.  When an input wants a gradient it goes
through ``NoiseLReLUAdaINFunction``, whose backward is K3
(``ops/styleconv_bwd.py``); JAX differentiates the lax epilogue instead.
Under ``create_graph`` that backward is ``NoiseLReLUAdaINBackwardFunction``,
whose own backward, the second derivative, is autograd of the plain
epilogue recomputed from the primal inputs.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from byogan_tpu_torch.ops.styleconv_bwd import at_inputs, epilogue_double_backward, styleconv_backward


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


def _epilogue_grads(dy, need, noise, noise_w, gamma, hv, mean, inv) -> tuple:
    """K3 (the plain version on a CPU tensor): grads of (x, noise, noise_w,
    gamma, beta), None where ``need`` says nobody wants one.  dx is K3's
    dpre; the caller's broadcast of the learned const sums it over the
    batch."""
    g = styleconv_backward(dy.contiguous(), hv, mean, inv, gamma, noise, noise_w)
    grads = (g.dpre, g.dnoise, g.dnoise_w, g.dgamma, g.dbeta)
    return tuple(t if want else None for t, want in zip(grads, need))


class NoiseLReLUAdaINFunction(torch.autograd.Function):
    """The differentiable epilogue of the initial 4x4 block: K2 with its
    residuals forward, K3 backward (the plain versions on a CPU tensor).
    Under ``create_graph`` the backward is
    ``NoiseLReLUAdaINBackwardFunction``, which runs the same code and has a
    second derivative."""

    @staticmethod
    def forward(ctx, x, noise, noise_w, gamma, beta, eps):
        if x.device.type == "cpu":
            fwd = noise_lrelu_adain_plain
        else:
            from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda as fwd
        out, hv, mean, inv = fwd(x, noise, noise_w, gamma, beta, eps, with_stats=True)
        ctx.save_for_backward(x, noise, noise_w, gamma, beta, hv, mean, inv)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dy):
        x, noise, noise_w, gamma, beta, hv, mean, inv = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        if torch.is_grad_enabled():  # create_graph: a second derivative may follow
            out = NoiseLReLUAdaINBackwardFunction.apply(
                dy, need, ctx.eps, hv, mean, inv, x, noise, noise_w, gamma, beta
            )
            return at_inputs(out, need) + (None,)
        return _epilogue_grads(dy, need, noise, noise_w, gamma, hv, mean, inv) + (None,)


class NoiseLReLUAdaINBackwardFunction(torch.autograd.Function):
    """``NoiseLReLUAdaINFunction``'s backward as a Function of dy and the
    primal inputs (x, noise, noise_w, gamma, beta).  Forward: K3 from the
    forward's residuals, the wanted grads only.  Backward, the second
    derivative: ``epilogue_double_backward`` of
    ``noise_lrelu_adain_plain`` recomputed from the primal inputs (its
    LeakyReLU branch agrees with K2's: both round the pre-activation in x's
    dtype)."""

    @staticmethod
    def forward(ctx, dy, need, eps, hv, mean, inv, *primals):
        _, noise, noise_w, gamma, _ = primals
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dy, *primals)
        ctx.need, ctx.eps = need, eps
        grads = _epilogue_grads(dy, need, noise, noise_w, gamma, hv, mean, inv)
        return tuple(g for g in grads if g is not None)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cotangents):
        dy, *primals = ctx.saved_tensors
        plain = lambda *p: noise_lrelu_adain_plain(*p, ctx.eps)  # noqa: E731
        wants = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[6:]
        got = epilogue_double_backward(plain, dy, primals, at_inputs(cotangents, ctx.need), wants)
        return (got[0], None, None, None, None, None) + got[1:]


def noise_lrelu_adain(
    x: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """The epilogue: plain on a CPU tensor, the K2 kernel on a CUDA one,
    through ``NoiseLReLUAdaINFunction`` when an input wants a gradient,
    else through the op ``byogan::noise_lrelu_adain`` (``ops/adain.py``,
    registered when ``byogan_tpu_torch.ops`` is imported)."""
    args = (x, noise, noise_w, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return NoiseLReLUAdaINFunction.apply(*args, eps)
    return torch.ops.byogan.noise_lrelu_adain(*args, eps)
