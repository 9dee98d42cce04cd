"""Latent-projection CLI (byogan_tpu/cli/project.py).

    python -m byogan_tpu_torch.cli.project ckpt.pth a.png [b.png ...] -o out/
        [--iters 400] [--lr 0.05] [--w-plus] [--ema] [--seed 0] [-d cpu]

Inverts images (PNG, JPEG, BMP or WebP, ``data/images.py``: the port's
own codecs, on any machine) into the generator's W space
(``projector.project``, float32) and writes ``{stem}-proj.png`` (the reconstruction) and
``{stem}-w.npy`` (its w, or its W+ rows) per input.  An input whose size
is not the checkpoint's stage resolution is resized with
``F.interpolate(mode="bilinear", antialias=True)``; the JAX CLI resizes
with PIL's bilinear filter, so the two targets differ slightly.  On the
GPU unless ``-d cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F


def load_target(path: str, res: int) -> np.ndarray:
    """One image file (PNG, JPEG, BMP or WebP, decoded by ``read_image``) as
    uint8 (res, res, 3)."""
    from byogan_tpu_torch.data.images import read_image

    img = read_image(path)
    if img.shape[:2] == (res, res):
        return img
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(res, res), mode="bilinear", align_corners=False, antialias=True)
    return x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Project images into the generator's W space")
    parser.add_argument("checkpoint", help="checkpoint (.pth)")
    parser.add_argument("images", nargs="+", help="input PNG file(s)")
    parser.add_argument("-o", "--output", default=".", help="output directory")
    parser.add_argument("--iters", default=400, type=int, help="optimization iterations")
    parser.add_argument("--lr", default=0.05, type=float, help="Adam LR")
    parser.add_argument(
        "--w-plus", action="store_true", help="optimize an independent w per stage (more expressive)",
    )
    parser.add_argument("--ema", action="store_true", help="project against the EMA generator weights")
    parser.add_argument("--seed", default=0, type=int, help="synthesis-noise seed")
    parser.add_argument(
        "-d", "--device", default=None, type=str, help="torch device (default: cuda; cpu runs the plain path)",
    )
    args = parser.parse_args(argv)

    from byogan_tpu_torch.core.grids import save_image
    from byogan_tpu_torch.projector import project
    from byogan_tpu_torch.serve import Sampler

    sampler = Sampler(args.checkpoint, batch=1, dtype="float32", device=args.device, use_ema=args.ema)
    target = np.stack([load_target(p, sampler.resolution) for p in args.images])
    result = project(
        sampler.generator, target, steps=sampler.steps, z_dim=sampler.z_dim,
        n_iters=args.iters, lr=args.lr, w_plus=args.w_plus, noise_seed=args.seed,
        alpha=sampler.alpha,
    )
    losses = result.losses.cpu().numpy()
    os.makedirs(args.output, exist_ok=True)
    recon01 = ((result.image + 1.0) / 2.0).clamp(0.0, 1.0).cpu()
    w = result.w.cpu().numpy()
    for i, path in enumerate(args.images):
        stem = os.path.splitext(os.path.basename(path))[0]
        save_image(recon01[i], os.path.join(args.output, f"{stem}-proj.png"))
        np.save(os.path.join(args.output, f"{stem}-w.npy"), w[i])
    print(
        f"projected {len(args.images)} image(s): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} over {args.iters} iters; "
        f"outputs in {args.output}"
    )


if __name__ == "__main__":
    main()
