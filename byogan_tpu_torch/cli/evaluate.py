"""Evaluation CLI (byogan_tpu/cli/evaluate.py).

    python -m byogan_tpu_torch.cli.evaluate ckpt.pth data_root [-n 256]
        [--batch 32] [-t 0.75] [--ema] [--patches 128]
        [--metric {swd,msssim,both}] [--seed 0] [-d cpu]

Scores N generated samples of a checkpoint against N random real images
of a prepared dataset at the checkpoint's stage resolution and prints one
JSON line with the JAX CLI's keys in its order: the multi-scale sliced
Wasserstein distance (x1e3 per level and their mean; lower is better,
comparable only across runs of this implementation) and, with ``--metric
msssim`` or ``both``, the generated set's pairwise MS-SSIM beside the real
set's own (near 1.0 = mode collapse).  Truncation defaults to 0.75, the
training latent distribution.  Samples come from ``Sampler.sample_float``
(bf16 synthesis, raw range); both metrics run on the GPU unless ``-d cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="Sliced Wasserstein distance: checkpoint vs dataset")
    parser.add_argument("model", help="checkpoint (.pth)")
    parser.add_argument("data", help="dataset root (contains prepared/)")
    parser.add_argument(
        "-n", "--images", default=256, type=int, help="images per side (real and fake); more = less noisy",
    )
    parser.add_argument("--batch", default=32, type=int, help="synthesis batch size")
    parser.add_argument(
        "-t", "--truncation", default=0.75, type=float,
        help="latent truncation boundary (default 0.75 = the training distribution)",
    )
    parser.add_argument("--ema", action="store_true", help="evaluate the EMA generator weights")
    parser.add_argument(
        "--patches", default=128, type=int, help="descriptor patches per image per pyramid level",
    )
    parser.add_argument(
        "--metric", default="swd", choices=("swd", "msssim", "both"),
        help="swd = distribution distance (lower better); msssim = "
        "mode-collapse diversity readout (generated-set pairwise MS-SSIM, "
        "reported beside the real set's)",
    )
    parser.add_argument(
        "--seed", default=0, type=int, help="seed (real-image choice, samples, patch sites, projections)",
    )
    parser.add_argument(
        "-d", "--device", default=None, type=str, help="torch device (default: cuda; cpu runs the plain path)",
    )
    args = parser.parse_args(argv)

    from byogan_tpu_torch.data.pipeline import open_stage_dataset
    from byogan_tpu_torch.eval.msssim import msssim_diversity
    from byogan_tpu_torch.eval.swd import sliced_wasserstein_distance
    from byogan_tpu_torch.serve import Sampler

    sampler = Sampler(
        args.model, batch=min(args.batch, args.images), truncation=args.truncation,
        seed=args.seed, device=args.device, use_ema=args.ema,
    )
    dev, resolution = sampler.device, sampler.resolution
    dataset = open_stage_dataset(args.data, sampler.steps)
    n = args.images
    resampled = len(dataset) < n
    if resampled:
        print(
            f"warning: dataset has {len(dataset)} images < n={n}; sampling "
            "real images WITH replacement — SWD scores are not comparable "
            "to runs on larger datasets (the MS-SSIM real anchor is "
            "computed on the unique images only)",
            file=sys.stderr,
        )
    idx = np.random.default_rng(args.seed).choice(len(dataset), size=n, replace=resampled)
    real = torch.from_numpy(dataset.get_batch_uint8(np.sort(idx))).to(dev)
    # Float synthesis, not the uint8 frames: their save rule saturates the
    # negative half, which would bias the comparison against real pixels.
    fake = torch.from_numpy(sampler.sample_float(n)).to(dev)

    want_swd = args.metric in ("swd", "both")
    out = {
        "metric": "swd_x1e3" if want_swd else "msssim",
        "resolution": resolution,
        "n_images": n,
        "resampled": resampled,
        "ema": bool(args.ema),
        "truncation": args.truncation,
    }
    if want_swd:
        result = sliced_wasserstein_distance(
            real, fake, torch.Generator(device=dev).manual_seed(args.seed),
            patches_per_image=args.patches, min_size=min(16, resolution),
        )
        mean = result.pop(0)
        out["per_level"] = {str(k): round(v, 3) for k, v in result.items()}
        out["mean"] = round(mean, 3)
    if args.metric in ("msssim", "both"):
        # The real anchor holds no duplicate (a duplicated pair scores 1.0):
        # below -n images it is every unique image.
        real_anchor = (
            torch.from_numpy(dataset.get_batch_uint8(np.arange(len(dataset)))).to(dev) if resampled else real
        )
        out["msssim_diversity"] = {
            "fake": round(float(msssim_diversity(fake)), 4),
            # Fewer than 2 distinct images have no diversity: null, not 1.0.
            "real": round(float(msssim_diversity(real_anchor)), 4) if len(real_anchor) >= 2 else None,
            "real_n": int(len(real_anchor)),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
