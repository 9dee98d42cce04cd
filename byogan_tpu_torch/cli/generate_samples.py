"""Sample-generation CLI (byogan_tpu/cli/generate_samples.py).

Writes N frames ``image_{i}.png`` (``.jpg`` with ``--format jpeg``, through
the native library's encoder at ``--jpeg-quality``, byte for byte libjpeg's;
``.npy`` with ``--format raw``) from
a reference-format ``.pth`` at the checkpoint's saved step and alpha, from
fresh truncated latents, in float32 as the reference CLI does.  Pixels are
saved raw-range with save_image's clamp, so the negative half is black.

    python -m byogan_tpu_torch.cli.generate_samples ckpt.pth 16 -o out/ [--ema] [--psi 0.7]
        [--format {png,jpeg,raw}] [--jpeg-quality 92]

``--ema`` samples from the EMA generator (runs with ``ema_beta > 0``);
``--psi`` pulls each style toward the mean w.  Runs on the GPU; ``-d cpu`` takes the plain PyTorch path on the CPU.
``--pallas`` is accepted for the JAX CLI's command lines and changes
nothing: on a GPU the port's CUDA kernels always run.
"""

from __future__ import annotations

import argparse
import os

from byogan_tpu_torch.serve import Sampler, save_frame_u8


def jpeg_quality(text: str) -> int:
    q = int(text)
    if not 1 <= q <= 100:
        raise argparse.ArgumentTypeError(f"JPEG quality must be in [1, 100], got {q}")
    return q


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate samples")
    parser.add_argument("model", help="path to saved model", type=str)
    parser.add_argument("images", help="number of images to produce", type=int)
    parser.add_argument(
        "-d", "--device", dest="device", default=None, type=str,
        help="torch device (default: cuda; cpu runs the plain path)",
    )
    parser.add_argument(
        "-o", "--output", dest="output_dir", default=".", type=str,
        help="output directory",
    )
    parser.add_argument(
        "-z", "--z-size", dest="z_size", default=None, type=int,
        help="noise size (default: read from the checkpoint)",
    )
    parser.add_argument(
        "-t", "--truncation", dest="trunc", default=0.75, type=float,
        help="truncation boundary",
    )
    parser.add_argument("--seed", default=None, type=int, help="seed (default: random)")
    parser.add_argument(
        "--batch", default=None, type=int,
        help="generate in batches of this size (default: all at once)",
    )
    parser.add_argument(
        "--ema", action="store_true",
        help="sample from the EMA generator weights (checkpoints trained with ema_beta > 0)",
    )
    parser.add_argument(
        "--psi", default=None, type=float,
        help="W-space truncation toward the mean w (e.g. 0.7 trades diversity for fidelity; off if unset)",
    )
    parser.add_argument(
        "--pallas", action="store_true",
        help="accepted for the JAX CLI's command lines; no effect: on a GPU the port's CUDA kernels always run",
    )
    parser.add_argument(
        "--format", default="png", choices=("png", "jpeg", "raw"),
        help="output encoding: png, jpeg (the native library's encoder, libjpeg's bytes), or raw (uint8 .npy, no encode)",
    )
    parser.add_argument(
        "--jpeg-quality", default=92, type=jpeg_quality, help="JPEG quality for --format jpeg (1-100, libjpeg's scale)",
    )
    args = parser.parse_args(argv)

    if not os.path.exists(args.output_dir):
        raise OSError("path does not exist!")
    sampler = Sampler(
        args.model,
        batch=args.batch or args.images,
        z_dim=args.z_size,
        truncation=args.trunc,
        dtype="float32",
        seed=args.seed,
        device=args.device,
        use_ema=args.ema,
        truncation_psi=args.psi,
    )
    written = 0
    for frames in sampler.sample_batches(args.images):
        for frame in frames:
            written += 1
            stem = os.path.join(args.output_dir, f"image_{written}")
            save_frame_u8(frame, stem, args.format, png_compression=6, jpeg_quality=args.jpeg_quality)
    print(f"wrote {written} images to {args.output_dir}")


if __name__ == "__main__":
    main()
