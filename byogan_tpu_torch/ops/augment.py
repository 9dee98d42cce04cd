"""Differentiable per-sample augmentation of the critic's inputs
(byogan_tpu/ops/augment.py:47-112, the port's own copy).

StyleGAN2-ADA's non-leaking scheme: each transform applies to each sample
with probability ``p``, to the reals and to the fakes alike, and is
differentiable with respect to the images, so the generator's gradient
flows through the augmentation of its own output.  In JAX's order:
x-flip; an integer translation of up to h//8 with a zero pad; brightness
N(0, 0.2); contrast 2^N(0, 0.5) about the per-image mean; saturation
2^N(0, 1) about the per-pixel channel mean; a cutout of one square of side
h//2 filled with zero (mid-gray in [-1, 1]).  A sample whose gate is off
computes the transform and has it selected away, as in JAX.

The draws are ``AugDraws`` (``draw_augment`` makes them from a
``torch.Generator``), so a test can feed JAX's 13 key splits instead.

The translation is a gather whose backward is the translation by the
opposite shift (``Translate``): both directions are reads, exact and
deterministic, where autograd's own backward of a gather is a
``scatter_add`` that sums in no fixed order on CUDA.  On the
in-bounds pixels the shift is a bijection, so the adjoint of "read
x[y + ty] or zero" is "read g[y - ty] or zero".  A one-hot shift matrix
applied as two batched products would be deterministic too, but it rounds
f32 images through TF32 wherever the caller allows TF32 matmuls, and does
h times the work.  Plain PyTorch on both devices: JAX has no kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch
import torch.nn.functional as F

# Per-transform strengths (byogan_tpu/ops/augment.py:42-44); p is the only
# runtime knob.
BRIGHTNESS_STD = 0.2
CONTRAST_LOG2_STD = 0.5
SATURATION_LOG2_STD = 1.0


@dataclasses.dataclass
class AugDraws:
    """The 13 per-sample draws of one augmented batch of n images, in the
    order JAX splits its key (augment.py:67-68): per transform its gate, a
    uniform in [0, 1) that applies it where below p, then its own draws.
    ``ty``, ``tx`` are shifts in [-max(h//8, 1), max(h//8, 1)]; ``b``,
    ``c``, ``s`` standard normals (brightness, contrast, saturation);
    ``cy``, ``cx`` the cutout's centre in [0, h) and [0, w).  All (n,)."""

    flip: torch.Tensor
    translate: torch.Tensor
    ty: torch.Tensor
    tx: torch.Tensor
    bright: torch.Tensor
    b: torch.Tensor
    contrast: torch.Tensor
    c: torch.Tensor
    saturate: torch.Tensor
    s: torch.Tensor
    cutout: torch.Tensor
    cy: torch.Tensor
    cx: torch.Tensor

    def to(self, device) -> "AugDraws":
        return AugDraws(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def draw_augment(rng: torch.Generator, n: int, h: int, w: int) -> AugDraws:
    """One batch's draws from ``rng``, on its device, in ``AugDraws``'s
    field order."""
    dev = rng.device
    pad = max(h // 8, 1)

    def uniform():
        return torch.rand((n,), generator=rng, device=dev)

    def shift():
        return torch.randint(-pad, pad + 1, (n,), generator=rng, device=dev)

    def normal():
        return torch.randn((n,), generator=rng, device=dev)

    flip, translate, ty, tx = uniform(), uniform(), shift(), shift()
    bright, b, contrast, c, saturate, s, cutout = (
        uniform(), normal(), uniform(), normal(), uniform(), normal(), uniform()
    )
    cy = torch.randint(0, h, (n,), generator=rng, device=dev)
    cx = torch.randint(0, w, (n,), generator=rng, device=dev)
    return AugDraws(flip, translate, ty, tx, bright, b, contrast, c, saturate, s, cutout, cy, cx)


def _shift(x: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor, pad: int) -> torch.Tensor:
    """out[i, y, x] = x[i, y + ty[i], x + tx[i]] inside the image, else 0."""
    n, h, w, _ = x.shape
    padded = F.pad(x, (0, 0, pad, pad, pad, pad))
    rows = (pad + ty)[:, None] + torch.arange(h, device=x.device)
    cols = (pad + tx)[:, None] + torch.arange(w, device=x.device)
    return padded[torch.arange(n, device=x.device)[:, None, None], rows[:, :, None], cols[:, None, :]]


class Translate(torch.autograd.Function):
    """Per-sample integer translation with a zero pad; its backward is the
    translation by the opposite shift (module docstring), itself a
    ``Translate``, so every order of derivative stays a gather."""

    @staticmethod
    def forward(ctx, x, ty, tx, pad):
        ctx.save_for_backward(ty, tx)
        ctx.pad = pad
        return _shift(x, ty, tx, pad)

    @staticmethod
    def backward(ctx, g):
        ty, tx = ctx.saved_tensors
        return Translate.apply(g, -ty, -tx, ctx.pad), None, None, None


def augment_batch(imgs: torch.Tensor, p: Union[float, torch.Tensor], draws: AugDraws) -> torch.Tensor:
    """The augmentation of an NHWC batch in [-1, 1] at probability ``p`` (a
    float or a 0-dim tensor, the ADA controller's), differentiable with
    respect to ``imgs``.  Same arithmetic and dtype casts as
    ``byogan_tpu.ops.augment.augment_batch``; ``p = 0`` is the identity to
    float rounding."""
    n, h, w, _ = imgs.shape
    dtype = imgs.dtype

    def on(gate):
        return (gate < p)[:, None, None, None]

    imgs = torch.where(on(draws.flip), imgs.flip(2), imgs)

    pad = max(h // 8, 1)
    t_on = draws.translate < p
    zero = torch.zeros_like(draws.ty)
    ty, tx = torch.where(t_on, draws.ty, zero), torch.where(t_on, draws.tx, zero)
    imgs = Translate.apply(imgs, ty, tx, pad)

    b = torch.where(on(draws.bright), draws.b[:, None, None, None] * BRIGHTNESS_STD, 0.0)
    imgs = imgs + b.to(dtype)

    s = torch.where(on(draws.contrast), torch.exp2(draws.c[:, None, None, None] * CONTRAST_LOG2_STD), 1.0)
    mean = imgs.mean(dim=(1, 2, 3), keepdim=True)
    imgs = (imgs - mean) * s.to(dtype) + mean

    s = torch.where(on(draws.saturate), torch.exp2(draws.s[:, None, None, None] * SATURATION_LOG2_STD), 1.0)
    luma = imgs.mean(dim=3, keepdim=True)
    imgs = (imgs - luma) * s.to(dtype) + luma

    half = max(h // 4, 1)
    yy = torch.arange(h, device=imgs.device)[None, :, None]
    xx = torch.arange(w, device=imgs.device)[None, None, :]
    keep = ((yy - draws.cy[:, None, None]).abs() >= half) | ((xx - draws.cx[:, None, None]).abs() >= half)
    keep = keep | ~(draws.cutout < p)[:, None, None]
    return imgs * keep[..., None].to(dtype)
