"""Latent-walk frame dump (byogan_tpu/cli/interpolate.py, reference
interpolate.py).

    python -m byogan_tpu_torch.cli.interpolate [ckpt.pth] -o ./output [-n 60]
        [-t 0.7] [-p 61] [-z Z] [--seed 0] [--ema] [--w-space] [-d cpu] [--pallas]

The reference's defaults (``./chk-116000.pth``, 60 latents at truncation
0.7, 61 lerp steps per adjacent pair with inclusive endpoints, frames
``image_{e}.png`` from 1) with one fixed batch-1 noise pyramid broadcast
over every frame; each pair's frames are one batch.  Z-space lerp as the
reference, or W-space with ``--w-space``.  Frames are saved raw-range with
save_image's clamp, so the negative half is black.  Float32; on the GPU
unless ``-d cpu``.  ``--pallas`` is accepted for the JAX CLI's command
lines and changes nothing: on a GPU the port's CUDA kernels always run.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch


def render_pair(
    gen,
    start: torch.Tensor,
    end: torch.Tensor,
    noise: List[torch.Tensor],
    steps: int,
    alpha: Optional[float],
    frames: int,
    w_space: bool = False,
) -> torch.Tensor:
    """``frames`` images lerped from ``start`` to ``end`` (z, or w with
    ``w_space``), endpoints included, the batch-1 ``noise`` broadcast over
    them: (frames, H, W, 3) in the generator's dtype."""
    psi = torch.linspace(0.0, 1.0, frames, device=start.device)[:, None]
    lerp = start[None, :] * (1 - psi) + end[None, :] * psi
    noise = [m.expand((frames,) + tuple(m.shape[1:])).contiguous() for m in noise[:steps]]
    with torch.no_grad():
        if w_space:
            return gen(None, noise, steps=steps, alpha=alpha, style=lerp)
        return gen(lerp, noise, steps=steps, alpha=alpha)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Latent interpolation frames")
    parser.add_argument(
        "checkpoint", nargs="?", default="./chk-116000.pth",
        help="checkpoint (.pth); default matches the reference's hardcoded path",
    )
    parser.add_argument("-o", "--output", default="./output")
    parser.add_argument("-n", "--num-latents", type=int, default=60)
    parser.add_argument("-t", "--truncation", type=float, default=0.7)
    parser.add_argument(
        "-p", "--psi-steps", type=int, default=61, help="frames per latent pair (inclusive endpoints)",
    )
    parser.add_argument(
        "-z", "--z-size", type=int, default=None, help="noise size (default: read from the checkpoint)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "-d", "--device", default=None, help="torch device (default: cuda; cpu runs the plain path)",
    )
    parser.add_argument(
        "--pallas", action="store_true",
        help="accepted for the JAX CLI's command lines; no effect: on a GPU the port's CUDA kernels always run",
    )
    parser.add_argument(
        "--ema", action="store_true",
        help="render from the EMA generator weights (checkpoints trained with ema_beta > 0)",
    )
    parser.add_argument(
        "--w-space", action="store_true",
        help="lerp in W space instead of Z (smoother walks; the reference lerps z)",
    )
    args = parser.parse_args(argv)

    from byogan_tpu_torch.core.grids import save_image
    from byogan_tpu_torch.core.random import fixed_synthesis_noise, truncated_noise
    from byogan_tpu_torch.serve import Sampler

    os.makedirs(args.output, exist_ok=True)
    sampler = Sampler(
        args.checkpoint, batch=1, z_dim=args.z_size, dtype="float32", device=args.device, use_ema=args.ema,
    )
    gen, steps = sampler.generator, sampler.steps
    rng = torch.Generator(device=sampler.device).manual_seed(args.seed)
    z = truncated_noise(rng, args.num_latents, sampler.z_dim, args.truncation)
    fixed_noise = fixed_synthesis_noise(rng, steps=gen.num_stages)
    if args.w_space:  # map the endpoints once; frames lerp w
        with torch.no_grad():
            z = gen.map_latent(z)
    e = 0
    for i in range(args.num_latents - 1):
        frames = render_pair(gen, z[i], z[i + 1], fixed_noise, steps, sampler.alpha, args.psi_steps, args.w_space)
        for f in frames.float().cpu():
            e += 1
            save_image(f, os.path.join(args.output, f"image_{e}.png"))
    print(f"wrote {e} frames to {args.output}")


if __name__ == "__main__":
    main()
