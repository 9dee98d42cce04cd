"""Edit-sheet CLI (byogan_tpu/cli/edit.py).

    python -m byogan_tpu_torch.cli.edit ckpt.pth -o edit.png [-i 0] [-r 3]
        [--range 3] [--steps 7] [--stages 0,1] [--w x-w.npy] [-t 0.75]
        [--ema] [--seed 0] [-d cpu]

Derives unsupervised SeFa edit directions from the checkpoint's style
weights (``editing.py``) and renders a sheet: one row per sample, one
column per coefficient along the chosen direction.  Rows start from random
samples, or from one projected latent (``--w``, a ``-w.npy`` written by
``cli.project``).  Float32; on the GPU unless ``-d cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="SeFa edit sheet along an unsupervised W direction")
    parser.add_argument("checkpoint", help="checkpoint (.pth)")
    parser.add_argument("-o", "--output", default="edit.png", help="output sheet PNG")
    parser.add_argument(
        "-i", "--direction", default=0, type=int, help="direction index (0 = strongest eigenvalue)",
    )
    parser.add_argument("-r", "--rows", default=3, type=int, help="samples (rows)")
    parser.add_argument(
        "--range", dest="span", default=3.0, type=float,
        help="walk from -RANGE to +RANGE along the direction",
    )
    parser.add_argument(
        "--steps", dest="ncols", default=7, type=int, help="columns (coefficients, inclusive endpoints)",
    )
    parser.add_argument(
        "--stages", default=None,
        help="comma-separated stage indices to restrict BOTH the "
        "factorization and the edit to (e.g. '0,1' = coarse)",
    )
    parser.add_argument(
        "--w", default=None,
        help="start from this .npy w (cli.project output) instead of random samples; implies one row",
    )
    parser.add_argument(
        "-t", "--truncation", default=0.75, type=float, help="z truncation for random starting samples",
    )
    parser.add_argument("--ema", action="store_true", help="use the EMA generator weights (runs with ema_beta > 0)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument(
        "-d", "--device", default=None, type=str, help="torch device (default: cuda; cpu runs the plain path)",
    )
    args = parser.parse_args(argv)

    from byogan_tpu_torch.core.grids import save_image_grid
    from byogan_tpu_torch.core.random import truncated_noise
    from byogan_tpu_torch.editing import edit_sheet, sefa_directions
    from byogan_tpu_torch.serve import Sampler

    sampler = Sampler(args.checkpoint, batch=1, dtype="float32", device=args.device, use_ema=args.ema)
    gen, steps = sampler.generator, sampler.steps
    # Factorize only the trained stages: the ones beyond `step` are random init.
    stages = list(range(steps)) if args.stages is None else [int(s) for s in args.stages.split(",")]
    if any(s >= steps for s in stages):
        raise SystemExit(f"--stages includes untrained stages (checkpoint has {steps})")
    directions, eigvals = sefa_directions(
        gen.state_dict(), k=args.direction + 1, stages=stages, trained_stages=steps,
    )

    if args.w is not None:
        w = np.load(args.w)
        if w.ndim == 1:  # cli.project's single w: (style_dim,)
            w = w[None, :]
        elif w.ndim == 2:  # cli.project --w-plus: ONE W+ latent (steps, style_dim)
            if w.shape[0] != steps:
                raise SystemExit(
                    f"--w: shape {w.shape} is neither (style_dim,) nor a W+ latent with {steps} stage rows"
                )
            w = w[None, :, :]
        else:
            raise SystemExit(f"--w: unsupported array shape {w.shape}")
        w = torch.from_numpy(np.asarray(w, np.float32))
    else:
        rng = torch.Generator(device=sampler.device).manual_seed(args.seed)
        z = truncated_noise(rng, args.rows, sampler.z_dim, args.truncation)
        with torch.no_grad():
            w = gen.map_latent(z)

    coeffs = np.linspace(-args.span, args.span, args.ncols)
    sheet = edit_sheet(
        gen, w, directions[args.direction], steps, coeffs, noise_seed=args.seed,
        alpha=sampler.alpha, edit_stages=None if args.stages is None else stages,
    )
    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    save_image_grid(((sheet + 1.0) / 2.0).clamp(0.0, 1.0), args.output, nrow=args.ncols)
    print(
        f"wrote edit sheet (direction {args.direction}, eigenvalue "
        f"{eigvals[args.direction]:.3g}, coeffs ±{args.span}) to {args.output}"
    )


if __name__ == "__main__":
    main()
