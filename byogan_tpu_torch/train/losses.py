"""GAN losses (byogan_tpu/train/losses.py:34-43, 93-187).

Each critic loss takes the critic as a callable on NHWC images and returns
``(loss, aux)``; the aux values are detached scalars.  The gradient
penalties differentiate the critic with respect to its input images with
``torch.autograd.grad(create_graph=True)``, so the caller's parameter
gradient runs the double backward.  That second-order path runs through the
critic only (cuDNN and plain PyTorch), never through a synthesis kernel.
The WGAN-GP is the corrected form the JAX package implements, with the
per-sample mixing weights passed in.
"""

from __future__ import annotations

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
