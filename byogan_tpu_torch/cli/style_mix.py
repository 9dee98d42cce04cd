"""Style-mixing grid CLI (byogan_tpu/cli/style_mix.py).

    python -m byogan_tpu_torch.cli.style_mix ckpt.pth -o mix.png [-r 4] [-c 4]
        [--crossover K] [-t 0.75] [--psi 0.7] [--ema] [--seed 0] [-d cpu]

Renders the StyleGAN mixing matrix as one PNG of (rows+1) x (cols+1)
cells: cell (i, j) takes its coarse stages (below ``--crossover``) from row
latent A_i and its fine stages from column latent B_j; the header row shows
B alone, column 0 A alone, cell (0, 0) the zero style.  One fixed noise
pyramid is shared by every cell, so all variation comes from the styles.
Float32, as the sampling CLI; on the GPU unless ``-d cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import torch


def mix_grid_styles(
    w_a: torch.Tensor, w_b: torch.Tensor, crossover: int, steps: int
) -> List[torch.Tensor]:
    """The grid's per-stage styles, ((rows+1)*(cols+1), style_dim) each, cells
    row by row, for ``w_a`` (rows, D) and ``w_b`` (cols, D): coarse styles
    are A_i on row i >= 1 and B_j on the header row, fine styles B_j in
    column j >= 1 and A_i in column 0; cell (0, 0) is zero."""
    rows, cols, sd = w_a.shape[0], w_b.shape[0], w_a.shape[-1]
    zero = w_a.new_zeros((1, sd))
    head = torch.cat([zero, w_b])  # row 0: B alone
    coarse = torch.cat([head[None], w_a[:, None, :].expand(rows, cols + 1, sd)]).reshape(-1, sd)
    fine = head[None].repeat(rows + 1, 1, 1)
    fine[1:, 0, :] = w_a  # column 0: A alone
    fine = fine.reshape(-1, sd)
    return [coarse if i < crossover else fine for i in range(steps)]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Style-mixing grid")
    parser.add_argument("checkpoint", help="checkpoint (.pth)")
    parser.add_argument("-o", "--output", default="mix.png", help="output grid PNG path")
    parser.add_argument("-r", "--rows", default=4, type=int, help="coarse-style latents (A)")
    parser.add_argument("-c", "--cols", default=4, type=int, help="fine-style latents (B)")
    parser.add_argument(
        "--crossover", default=None, type=int,
        help="stages below this take A's style, the rest B's (default: half the checkpoint's stages)",
    )
    parser.add_argument("-t", "--truncation", default=0.75, type=float, help="z truncation boundary")
    parser.add_argument(
        "--psi", default=None, type=float,
        help="W-space truncation toward the mean w (e.g. 0.7); off if unset",
    )
    parser.add_argument("--ema", action="store_true", help="use the EMA generator weights (runs with ema_beta > 0)")
    parser.add_argument("--seed", default=0, type=int, help="seed")
    parser.add_argument(
        "-d", "--device", default=None, type=str, help="torch device (default: cuda; cpu runs the plain path)",
    )
    args = parser.parse_args(argv)

    from byogan_tpu_torch.core.grids import make_grid, to_uint8
    from byogan_tpu_torch.core.random import fixed_synthesis_noise, truncated_noise
    from byogan_tpu_torch.serve import Sampler, encode_png

    sampler = Sampler(
        args.checkpoint, batch=1, truncation=args.truncation, dtype="float32", seed=args.seed,
        device=args.device, use_ema=args.ema, truncation_psi=args.psi,
    )
    steps = sampler.steps
    crossover = args.crossover if args.crossover is not None else max(1, steps // 2)
    if not 0 <= crossover <= steps:
        raise SystemExit(f"--crossover must be in [0, {steps}]")
    rows, cols = args.rows, args.cols
    n = (rows + 1) * (cols + 1)
    rng = torch.Generator(device=sampler.device).manual_seed(args.seed)
    z_a = truncated_noise(rng, rows, sampler.z_dim, args.truncation)
    z_b = truncated_noise(rng, cols, sampler.z_dim, args.truncation)
    noise = [m.expand((n,) + m.shape[1:]).contiguous() for m in fixed_synthesis_noise(rng, steps)]
    with torch.inference_mode():
        styles = mix_grid_styles(sampler.to_w(z_a), sampler.to_w(z_b), crossover, steps)
        img = sampler.generator(None, noise, steps=steps, alpha=sampler.alpha, style=styles)
        frames = to_uint8(((img.float() + 1.0) / 2.0).clamp(0.0, 1.0)).cpu().numpy()
    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.output, "wb") as f:
        f.write(encode_png(make_grid(frames, nrow=cols + 1)))
    print(f"wrote {rows}x{cols} mixing grid (crossover {crossover}/{steps}) to {args.output}")


if __name__ == "__main__":
    main()
