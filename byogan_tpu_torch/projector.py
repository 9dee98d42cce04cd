"""W-space tools (byogan_tpu/projector.py): the mean mapping output.

``mean_w`` is the centre that W-space truncation pulls styles toward
(``Sampler(truncation_psi=...)``, ``generate_samples --psi``,
``cli.style_mix --psi``).  Its latents are fixed, so every surface agrees
on one centre for a checkpoint; they come from a torch generator, so they
are not the JAX package's (torch cannot replay JAX's PRNG) and the two
packages' centres differ by sampling noise.  ``project`` is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from byogan_tpu_torch.core.random import truncated_noise

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
