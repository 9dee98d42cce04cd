"""Multi-scale sliced Wasserstein distance (SWD) over Laplacian pyramids
(byogan_tpu/eval/swd.py:38-188).

The Progressive-GAN paper's evaluation metric (Karras et al. 2018,
appendix A), as the JAX package computes it:

- Laplacian levels from the full resolution down to ``min_size``, built
  from the repo's 2x average pool and bilinear upsample (core/resize.py),
  not the paper's 5-tap ``pyrDown``; values compare across runs of this
  implementation only.
- ``patches_per_image`` random 7x7x3 descriptors per image per level,
  gathered by one advanced index on the device.
- Descriptors normalized per colour channel over each set, projected on
  random unit directions (a matmul) and sorted (``torch.sort``); the mean
  |sorted_a - sorted_b| is the exact 1-D transport cost.

Every draw comes from an explicit ``torch.Generator``, in a fixed order per
level (real sites, fake sites, directions), or is passed in as
``LevelDraws`` so that a test can replay another implementation's draws.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from byogan_tpu_torch.core.grids import uint8_to_training_range
from byogan_tpu_torch.core.resize import avg_pool2x, upsample2x_bilinear

PATCH = 7  # descriptor spatial extent (Progressive GAN appendix A)

#: (ys, xs), each (N, patches_per_image) int64: patch corners per image
Sites = Tuple[torch.Tensor, torch.Tensor]


class LevelDraws(NamedTuple):
    """One pyramid level's draws: patch corners of the real and the fake
    set and unit directions (repeats, dim, dirs_per_repeat)."""

    real_sites: Sites
    fake_sites: Sites
    directions: torch.Tensor


def laplacian_pyramid(x: torch.Tensor, min_size: int = 16) -> List[torch.Tensor]:
    """Band-pass levels of ``x`` (NHWC), full resolution first: each level
    is ``x - up(down(x))``, the last the low-pass residual at ``min_size``.
    Adding each level onto the upsampled next recovers ``x``."""
    levels = []
    while x.shape[1] > min_size:
        down = avg_pool2x(x)
        levels.append(x - upsample2x_bilinear(down))
        x = down
    levels.append(x)
    return levels


def patch_sites(
    generator: torch.Generator, n: int, h: int, w: int, patches_per_image: int = 128
) -> Sites:
    """Uniform patch corners, rows then columns, on the generator's device."""
    patch = min(PATCH, h, w)
    kw = dict(generator=generator, device=generator.device)
    ys = torch.randint(0, h - patch + 1, (n, patches_per_image), **kw)
    xs = torch.randint(0, w - patch + 1, (n, patches_per_image), **kw)
    return ys, xs


def extract_patches(
    level: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    patches_per_image: int = 128,
    sites: Optional[Sites] = None,
) -> torch.Tensor:
    """(N*ppi, p, p, C) patches of an NHWC level at ``sites`` (drawn from
    ``generator`` when not given).  ``p`` is 7, clamped to the level's
    extent (a 4 px level's descriptor is the whole image)."""
    n, h, w, c = level.shape
    patch = min(PATCH, h, w)
    if sites is None:
        sites = patch_sites(generator, n, h, w, patches_per_image)
    ys, xs = (s.to(level.device) for s in sites)
    d = torch.arange(patch, device=level.device)
    rows, cols = ys[..., None] + d, xs[..., None] + d  # (n, ppi, patch)
    img = torch.arange(n, device=level.device)[:, None, None, None]
    patches = level[img, rows[..., :, None], cols[..., None, :]]  # (n, ppi, p, p, c)
    return patches.reshape(n * ys.shape[1], patch, patch, c)


def _normalize_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit std per colour channel over the whole set."""
    mean = desc.mean(dim=(0, 1, 2), keepdim=True)
    std = desc.std(dim=(0, 1, 2), keepdim=True, correction=0)
    return (desc - mean) / (std + 1e-8)


def unit_directions(
    generator: torch.Generator, dim: int, dirs_per_repeat: int = 128, repeats: int = 4
) -> torch.Tensor:
    """(repeats, dim, dirs_per_repeat) Gaussian directions, each column
    scaled to unit length."""
    dirs = torch.randn(
        (repeats, dim, dirs_per_repeat), generator=generator, device=generator.device
    )
    return dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)


def sliced_wasserstein(
    a: torch.Tensor,
    b: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    dirs_per_repeat: int = 128,
    repeats: int = 4,
    directions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean 1-D Wasserstein distance of two equal-count descriptor sets over
    random unit ``directions`` (repeats, dim, D), drawn from ``generator``
    when not given: both sets projected, sorted along the sample axis,
    mean |sorted_a - sorted_b| per repeat, averaged over repeats."""
    if a.shape[0] != b.shape[0]:
        raise ValueError(
            f"SWD needs equal descriptor counts, got {a.shape[0]} vs {b.shape[0]}"
        )
    a = a.reshape(a.shape[0], -1).float()
    b = b.reshape(b.shape[0], -1).float()
    if directions is None:
        directions = unit_directions(generator, a.shape[1], dirs_per_repeat, repeats)
    directions = directions.to(a.device)
    pa = torch.sort(a @ directions, dim=1).values  # (repeats, n, D)
    pb = torch.sort(b @ directions, dim=1).values
    return (pa - pb).abs().mean(dim=(1, 2)).mean()


def level_draws(
    generator: torch.Generator,
    n: int,
    size: int,
    channels: int = 3,
    patches_per_image: int = 128,
    dirs_per_repeat: int = 128,
    repeats: int = 4,
) -> LevelDraws:
    """The draws of one level of ``n`` images of ``size`` px, in order:
    real sites, fake sites, directions."""
    real = patch_sites(generator, n, size, size, patches_per_image)
    fake = patch_sites(generator, n, size, size, patches_per_image)
    dim = min(PATCH, size) ** 2 * channels
    return LevelDraws(real, fake, unit_directions(generator, dim, dirs_per_repeat, repeats))


def _to_float(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    if x.dtype == torch.uint8:
        return uint8_to_training_range(x)
    return x.float()


def sliced_wasserstein_distance(
    real,
    fake,
    generator: Optional[torch.Generator] = None,
    patches_per_image: int = 128,
    min_size: int = 16,
    dirs_per_repeat: int = 128,
    repeats: int = 4,
    draws: Optional[Sequence[LevelDraws]] = None,
) -> Dict[int, float]:
    """Per-resolution SWD between two equal-size NHWC image sets (uint8,
    converted to [-1, 1], or float): ``{resolution_px: distance * 1e3}``
    for every level, highest resolution first (the paper's x1e3), plus the
    mean over levels under key ``0``.  ``draws`` (one ``LevelDraws`` a
    level) replaces the generator's."""
    real = _to_float(real)
    fake = _to_float(fake).to(real.device)
    if real.shape != fake.shape:
        raise ValueError(f"shape mismatch: {tuple(real.shape)} vs {tuple(fake.shape)}")
    if real.shape[1] < min_size:
        raise ValueError(
            f"images are {real.shape[1]}px; SWD needs >= {min_size}px "
            "(lower min_size for tiny stages)"
        )
    out: Dict[int, float] = {}
    levels = zip(laplacian_pyramid(real, min_size), laplacian_pyramid(fake, min_size))
    for i, (rl, fl) in enumerate(levels):
        n, size, _, channels = rl.shape
        if draws is None:
            d = level_draws(generator, n, size, channels, patches_per_image, dirs_per_repeat, repeats)
        else:
            d = draws[i]
        dr = _normalize_descriptors(extract_patches(rl, sites=d.real_sites))
        df = _normalize_descriptors(extract_patches(fl, sites=d.fake_sites))
        out[int(size)] = float(sliced_wasserstein(dr, df, directions=d.directions)) * 1e3
    out[0] = sum(out.values()) / len(out)
    return out


def swd_summary(
    real_batches: Sequence, fake_batches: Sequence, seed: int = 0, **kwargs
) -> Dict[int, float]:
    """SWD over pre-batched image sets, cut to the shorter; draws from a
    generator seeded with ``seed`` on the real images' device."""
    real = torch.cat([torch.as_tensor(b) for b in real_batches])
    fake = torch.cat([torch.as_tensor(b) for b in fake_batches]).to(real.device)
    n = min(real.shape[0], fake.shape[0])
    generator = torch.Generator(device=real.device).manual_seed(seed)
    return sliced_wasserstein_distance(real[:n], fake[:n], generator, **kwargs)
