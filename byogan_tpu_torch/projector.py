"""W-space tools (byogan_tpu/projector.py): the mean mapping output and
latent projection.

``mean_w`` is the centre that W-space truncation pulls styles toward
(``Sampler(truncation_psi=...)``, ``generate_samples --psi``,
``cli.style_mix --psi``) and where a projection starts.  Its latents are
fixed, so every surface agrees on one centre for a checkpoint; they come
from a torch generator, so they are not the JAX package's (torch cannot
replay JAX's PRNG) and the two packages' centres differ by sampling noise.

``project`` inverts images into W (or W+, a w per stage) by Adam over w
alone, with the generator's weights frozen: L1 over matching Laplacian
bands (eval/swd.py's pyramid) plus L2 on pixels, against synthesis noise
held fixed for the whole run.  No perceptual network (LPIPS needs
pretrained weights).  On the card each iteration runs K1 and K2 with their
residuals and K3 with ``conv2d_input`` backward, and never the weight
gradient; the loss trajectory stays on the device until the end.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import torch

from byogan_tpu_torch.core.grids import uint8_to_training_range
from byogan_tpu_torch.core.random import synthesis_noise, truncated_noise
from byogan_tpu_torch.eval.swd import laplacian_pyramid

#: seed of mean_w's fixed latents (the JAX package's key, on torch's PRNG)
MEAN_W_SEED = 0x57AB1E


def mean_w(
    gen,
    z_dim: int,
    trunc: float = 0.75,
    n: int = 4096,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean mapping output, (style_dim,) float32, over ``n`` latents of the
    training distribution drawn from ``MEAN_W_SEED`` on the generator's
    device (byogan_tpu/projector.py:101-121); ``z`` (n, z_dim) replaces
    those latents."""
    dev = next(gen.parameters()).device
    if z is None:
        rng = torch.Generator(device=dev).manual_seed(MEAN_W_SEED)
        z = truncated_noise(rng, n, z_dim, trunc)
    with torch.no_grad():
        return gen.map_latent(z.to(dev)).float().mean(dim=0)


def truncate(w: torch.Tensor, w_mean: torch.Tensor, psi: float) -> torch.Tensor:
    """W-space truncation ``wm + psi * (w - wm)``, wm the mean cast to w's
    dtype as JAX casts it (byogan_tpu/serve.py:176-178).  Computed in f32
    and rounded once to w's dtype: in f32 that is JAX's expression, and in
    bf16 psi = 1 gives w back bit for bit."""
    wm = w_mean.to(w.dtype).float()
    return (wm + psi * (w.float() - wm)).to(w.dtype)


class ProjectResult(NamedTuple):
    w: torch.Tensor  # (B, style_dim), or (B, steps, style_dim) in W+
    image: torch.Tensor  # (B, H, W, 3) the final reconstruction, float32 ~[-1, 1]
    losses: torch.Tensor  # (n_iters,) the mean loss before each update, float32


def synthesize_w(
    gen, w: torch.Tensor, noise: List[torch.Tensor], steps: int, alpha: Optional[float] = None
) -> torch.Tensor:
    """Float32 images from styles ``w``: (B, D) for every stage, or a W+
    latent (B, steps, D) with one row per stage."""
    style = [w[:, i] for i in range(steps)] if w.ndim == 3 else w
    return gen(None, noise, steps=steps, alpha=alpha, style=style).float()


def _pyramid_loss(recon: torch.Tensor, target: torch.Tensor, target_levels) -> torch.Tensor:
    """L1 over matching Laplacian bands plus L2 on pixels (batch means)."""
    recon_levels = laplacian_pyramid(recon, min_size=min(8, recon.shape[1]))
    band = sum((r - t).abs().mean() for r, t in zip(recon_levels, target_levels))
    return band + (recon - target).square().mean()


def projection_loss(
    gen, w: torch.Tensor, target: torch.Tensor, noise: List[torch.Tensor], steps: int,
    alpha: Optional[float] = None,
) -> torch.Tensor:
    """The loss one projection iteration differentiates, target in [-1, 1]."""
    levels = laplacian_pyramid(target, min_size=min(8, target.shape[1]))
    return _pyramid_loss(synthesize_w(gen, w, noise, steps, alpha), target, levels)


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """The module's parameters without gradients, their flags restored after."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def project(
    gen,
    target,
    steps: int,
    z_dim: int,
    n_iters: int = 400,
    lr: float = 0.05,
    w_plus: bool = False,
    w_init=None,
    noise_seed: int = 0,
    alpha: Optional[float] = None,
    noise: Optional[List[torch.Tensor]] = None,
) -> ProjectResult:
    """Optimize W-space latents so that ``gen`` reproduces ``target``
    (byogan_tpu/projector.py:124-194).

    ``target``: NHWC, float in [-1, 1] or uint8, at stage ``steps``'
    resolution, on any device (moved to the generator's).  ``w_plus``
    optimizes one w per stage.  The start is the mean w unless ``w_init``
    is given.  ``alpha`` is the checkpoint's fade alpha (None: no blend).
    The synthesis noise is fixed for the run: drawn from ``noise_seed`` on
    the generator's device, or ``noise`` (one map a stage).  Adam (b1 0.9,
    b2 0.999, eps 1e-8, as ``optax.adam``) updates w alone; the loss
    trajectory is fetched by the caller, once.
    """
    dev = next(gen.parameters()).device
    target = torch.as_tensor(target).to(dev)
    if target.dtype == torch.uint8:
        target = uint8_to_training_range(target)
    target = target.float()
    expect = 4 * 2 ** (steps - 1)
    if target.shape[1] != expect or target.shape[2] != expect:
        raise ValueError(
            f"target is {target.shape[1]}x{target.shape[2]}, stage {steps} "
            f"needs {expect}x{expect}"
        )
    batch = target.shape[0]
    if w_init is None:
        wm = mean_w(gen, z_dim)
        w_init = wm.expand(batch, -1)
        if w_plus:
            w_init = w_init[:, None, :].expand(batch, steps, wm.shape[-1])
    w_init = torch.as_tensor(w_init).to(dev, torch.float32)
    want = (batch, steps, None) if w_plus else (batch, None)
    if w_init.ndim != len(want) or any(
        e is not None and w_init.shape[i] != e for i, e in enumerate(want)
    ):
        raise ValueError(
            f"w_init shape {tuple(w_init.shape)} does not match "
            f"{'(batch, steps, style_dim)' if w_plus else '(batch, style_dim)'}"
            f" for batch={batch}, steps={steps} — a saved 1-D w must be "
            "given a batch axis (w[None, :])"
        )
    if noise is None:
        noise = synthesis_noise(torch.Generator(device=dev).manual_seed(noise_seed), batch, steps)
    noise = [m.to(dev) for m in noise]
    target_levels = laplacian_pyramid(target, min_size=min(8, expect))
    w = w_init.clone().requires_grad_(True)
    opt = torch.optim.Adam([w], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = torch.empty(n_iters, dtype=torch.float32, device=dev)
    with _frozen(gen):
        for i in range(n_iters):
            loss = _pyramid_loss(synthesize_w(gen, w, noise, steps, alpha), target, target_levels)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses[i] = loss.detach()
        with torch.no_grad():
            image = synthesize_w(gen, w, noise, steps, alpha)
    return ProjectResult(w=w.detach(), image=image, losses=losses)
