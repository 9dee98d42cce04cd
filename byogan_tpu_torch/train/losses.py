"""GAN losses (byogan_tpu/train/losses.py:34-187).

Each critic loss takes the critic as a callable on NHWC images and returns
``(loss, aux)``; the aux values are detached scalars.  The gradient
penalties differentiate the critic with respect to its input images with
``torch.autograd.grad(create_graph=True)``, so the caller's parameter
gradient runs the double backward through the critic (cuDNN and plain
PyTorch).  The WGAN-GP is the corrected form the JAX package implements,
with the per-sample mixing weights passed in.

The path-length penalty (``gen_path_length_penalty``) differentiates the
synthesis network with respect to w the same way, so its parameter
gradient is a second derivative through the synthesis convs: on the card
the inner gradient runs K3 inside the autograd Functions' backward
Functions (``ops/styleconv.py``, ``ops/fused.py``), whose own backward is
autograd of the plain epilogue, recomputed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

CriticFn = Callable[[torch.Tensor], torch.Tensor]
Aux = Dict[str, torch.Tensor]


def gen_wgan_loss(crit_fake_pred: torch.Tensor) -> torch.Tensor:
    """``-mean(D(G(z)))`` (gan.py:224-225)."""
    return -crit_fake_pred.mean()


def gen_logistic_loss(crit_fake_pred: torch.Tensor) -> torch.Tensor:
    """Non-saturating ``mean(softplus(-D(G(z))))`` (gan.py:227-228)."""
    return F.softplus(-crit_fake_pred).mean()


def gen_path_length_penalty(
    synth: Callable[[torch.Tensor], torch.Tensor],
    w: torch.Tensor,
    pl_ema: torch.Tensor,
    y: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """StyleGAN2's path-length regularization (byogan_tpu/train/losses.py:46-78).

    ``pl_i = ||J_w^T y_i||`` per sample, one VJP of the projection
    ``sum(img * y / sqrt(H*W))`` through ``synth``, taken with
    ``create_graph`` so the caller's parameter gradient runs the second
    derivative.  ``y`` is the draw: (N, H, W, 3) standard normal, f32.
    Returns ``(mean((pl - pl_ema)^2), mean(pl))``; the second feeds the
    caller's running mean ``pl_ema``."""
    img = synth(w).float()
    h, wd = img.shape[1], img.shape[2]
    proj = (img * (y / math.sqrt(float(h * wd)))).sum()
    (grad,) = torch.autograd.grad(proj, w, create_graph=True)
    pl = torch.sqrt(grad.float().square().sum(dim=-1) + 1e-8)
    return (pl - pl_ema).square().mean(), pl.mean()


def _input_grad(critic_fn: CriticFn, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(D(images), dD/dimages) with the graph kept for a second backward."""
    images = images.detach().requires_grad_(True)
    pred = critic_fn(images)
    (grad,) = torch.autograd.grad(pred.sum(), images, create_graph=True)
    return pred, grad.float().reshape(images.shape[0], -1)


def _logistic_terms(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    return F.softplus(-real_pred.float()).mean() + F.softplus(fake_pred.float()).mean()


def _aux(real_pred: torch.Tensor, fake_pred: torch.Tensor, **extra: torch.Tensor) -> Aux:
    aux = {"real_pred": real_pred.mean(), "fake_pred": fake_pred.mean(), **extra}
    return {k: v.detach().float() for k, v in aux.items()}


def critic_r1_loss(
    critic_fn: CriticFn, real: torch.Tensor, fake: torch.Tensor, c_lambda: float
) -> Tuple[torch.Tensor, Aux]:
    """Logistic loss + R1 penalty (gan.py:393-412):
    ``softplus(-D(real)) + softplus(D(fake)) + lambda/2 * mean ||dD/dreal||^2``."""
    real_pred, grad = _input_grad(critic_fn, real)
    penalty = (c_lambda / 2.0) * grad.square().sum(dim=1).mean()
    fake_pred = critic_fn(fake)
    loss = _logistic_terms(real_pred, fake_pred) + penalty
    real_sign = torch.sign(real_pred.detach().float()).mean()
    return loss, _aux(real_pred, fake_pred, r1_penalty=penalty, real_sign=real_sign)


def critic_logistic_loss(
    critic_fn: CriticFn, real: torch.Tensor, fake: torch.Tensor
) -> Tuple[torch.Tensor, Aux]:
    """The logistic loss without the penalty: lazy R1's off iterations."""
    real_pred = critic_fn(real)
    fake_pred = critic_fn(fake)
    real_sign = torch.sign(real_pred.detach().float()).mean()
    zero = torch.zeros((), device=real.device)
    return _logistic_terms(real_pred, fake_pred), _aux(
        real_pred, fake_pred, r1_penalty=zero, real_sign=real_sign
    )


def critic_wgan_gp_loss(
    critic_fn: CriticFn,
    real: torch.Tensor,
    fake: torch.Tensor,
    c_lambda: float,
    eps: torch.Tensor,
) -> Tuple[torch.Tensor, Aux]:
    """WGAN-GP, corrected (gan.py:357-391): ``-D(real) + D(fake) + lambda *
    mean((||dD/dx_hat|| - 1)^2)`` at ``x_hat = eps*real + (1-eps)*fake``, eps
    (N, 1, 1, 1) uniform per sample."""
    mixed = real * eps + (1.0 - eps) * fake
    _, grad = _input_grad(critic_fn, mixed)
    norms = torch.sqrt(grad.square().sum(dim=1) + 1e-12)
    penalty = c_lambda * (norms - 1.0).square().mean()
    real_pred = critic_fn(real)
    fake_pred = critic_fn(fake)
    loss = -real_pred.float().mean() + fake_pred.float().mean() + penalty
    return loss, _aux(real_pred, fake_pred, gradient_penalty=penalty)
