"""Unsupervised W-space edit directions, SeFa-style closed-form
factorization (byogan_tpu/editing.py:35-172).

The directions are the top eigenvectors of ``A A^T`` (style_dim x
style_dim), ``A`` the stacked AdaIN style projections of the chosen stages
(``gen_blocks.{i}.conv_{1,2}.adain.style.weight``, stored (2C, style_dim),
so ``A`` stacks their transposes): the directions in W along which the
per-layer modulations change the most (Shen & Zhou, "Closed-Form
Factorization of Latent Semantics in GANs", 2021).  No labels, data or
training.  Early stages move coarse structure, late stages fine texture.

Every checkpoint carries all stages' parameters from init, so pass
``trained_stages`` (the checkpoint's ``step``): the stages beyond it are
random init, whose noise would otherwise enter the eigenvectors.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from byogan_tpu_torch.core.random import fixed_synthesis_noise


def style_projection_matrix(
    gen_state: Mapping[str, torch.Tensor],
    stages: Optional[Sequence[int]] = None,
    trained_stages: Optional[int] = None,
) -> np.ndarray:
    """``(style_dim, sum 2*channels)``: the chosen stages' style-projection
    weights of a generator state dict, side by side.  The equalized-LR
    scale is the same for every projection and cancels in the
    eigendecomposition, so it is left out.  ``trained_stages`` caps the
    default all-stages choice."""
    if stages is None and trained_stages is not None:
        stages = range(trained_stages)
    mats = []
    i = 0
    while f"gen_blocks.{i}.conv_1.adain.style.weight" in gen_state:
        if stages is None or i in stages:
            for conv in ("conv_1", "conv_2"):
                weight = gen_state[f"gen_blocks.{i}.{conv}.adain.style.weight"]
                mats.append(weight.detach().cpu().numpy().T)
        i += 1
    if not mats:
        raise ValueError(f"no stages selected (generator has {i} stages)")
    return np.concatenate(mats, axis=1)


def sefa_directions(
    gen_state: Mapping[str, torch.Tensor],
    k: int = 10,
    stages: Optional[Sequence[int]] = None,
    trained_stages: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The top ``k`` unit edit directions in W, strongest first:
    ``(directions (k, style_dim), eigenvalues (k,))``, orthonormal."""
    a = style_projection_matrix(gen_state, stages, trained_stages)
    vals, vecs = np.linalg.eigh(a @ a.T)  # ascending
    order = np.argsort(vals)[::-1][:k]
    return vecs[:, order].T.copy(), vals[order].copy()


def _sheet_styles(
    w: torch.Tensor,
    direction: torch.Tensor,
    coeffs: torch.Tensor,
    steps: int,
    edit_stages: Optional[Sequence[int]] = None,
):
    """The styles of an edit sheet, one image per (w row, coefficient): W
    or W+ ``w`` walked along ``direction``; with ``edit_stages`` only those
    stages take the edited style and the rest keep the original."""
    batch, k = w.shape[0], coeffs.shape[0]
    n = batch * k
    if w.ndim == 3:
        w_edit = (w[:, None] + coeffs[:, None, None] * direction).reshape(n, steps, w.shape[-1])
    else:
        w_edit = (w[:, None, :] + coeffs[:, None] * direction).reshape(n, w.shape[-1])
    if w.ndim == 3 or edit_stages is not None:
        w_orig = w.repeat_interleave(k, dim=0)
        pick = [edit_stages is None or i in edit_stages for i in range(steps)]
        if w.ndim == 3:
            return [(w_edit if p else w_orig)[:, i] for i, p in enumerate(pick)]
        return [w_edit if p else w_orig for p in pick]
    return w_edit


def edit_sheet(
    gen,
    w,
    direction,
    steps: int,
    coeffs: Sequence[float],
    noise_seed: int = 0,
    edit_stages: Optional[Sequence[int]] = None,
    alpha: Optional[float] = None,
    noise: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """``w`` walked along ``direction``: (B*len(coeffs), H, W, 3) float32,
    row-major (for each w, one image per coefficient).  ``w`` is (B,
    style_dim) or a W+ latent (B, steps, style_dim), whose every stage
    walks the same direction.  ``edit_stages`` restricts the edit to those
    stages.  One batch-1 noise pyramid, drawn from ``noise_seed`` on the
    generator's device or given as ``noise``, is shared by the sheet."""
    dev = next(gen.parameters()).device
    w = torch.as_tensor(w).to(dev, torch.float32)
    if w.ndim == 3 and w.shape[1] != steps:
        raise ValueError(f"W+ latent has {w.shape[1]} stage rows, checkpoint uses {steps}")
    if edit_stages is not None and any(not 0 <= s < steps for s in edit_stages):
        raise ValueError(
            f"edit_stages {list(edit_stages)} outside [0, {steps}) — an "
            "out-of-range restriction would silently render an unedited sheet"
        )
    d = torch.as_tensor(direction, dtype=torch.float32).to(dev)
    cs = torch.tensor(list(coeffs), dtype=torch.float32, device=dev)
    n = w.shape[0] * cs.shape[0]
    if noise is None:
        noise = fixed_synthesis_noise(torch.Generator(device=dev).manual_seed(noise_seed), steps)
    noise = [m.to(dev).expand((n,) + tuple(m.shape[1:])).contiguous() for m in noise]
    with torch.no_grad():
        style = _sheet_styles(w, d, cs, steps, edit_stages)
        return gen(None, noise, steps=steps, alpha=alpha, style=style).float()
