"""Dataset preparation CLI (byogan_tpu/cli/prep.py).

    python -m byogan_tpu_torch.cli.prep <datapath> [start_size] [end_size]
                                        [-y] [-w WORKERS] [--pack] [-d DEVICE]

Moves the originals under ``<datapath>`` (files named .png, .jpg, .jpeg,
.bmp or .webp, each read by its bytes whatever its name, as the JAX
package's prep reads it through Pillow: PNG, JPEG, BMP, WebP, GIF, TIFF and
BigTIFF (Lab and CCITT fax among them), ICO, CUR, DIB, PNM, Targa, PSD
(Lab among them), PCX, SGI or QOI) into ``original/images`` and writes ``prepared/set_{k}/images/image-{n}.png``
for every size from ``start_size`` to ``end_size`` (``data/prep.py``),
asking before it rebuilds an existing set unless ``-y``.  ``--pack`` also
writes each set's ``packed.npy``, which training reads with no decode.
``-w`` threads decode and encode the files, for the pyramid and for the
packing.  The resizes run on the GPU; ``-d cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse

from byogan_tpu_torch.data.pipeline import pack_stage
from byogan_tpu_torch.data.prep import prepare_pyramid


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Prepare a dataset pyramid from image originals, each read by its bytes: PNG, JPEG, BMP, WebP, "
                    "GIF, TIFF and BigTIFF (Lab and CCITT fax among them), ICO, CUR, DIB, PNM, Targa, PSD, PCX, SGI "
                    "or QOI")
    parser.add_argument("datapath", help="path to data set, a folder of image originals named .png, .jpg, .jpeg, .bmp or .webp. "
                                         "Eg './data/images'", type=str)
    parser.add_argument(
        "start_size", nargs="?", default=4, type=int,
        help="first progression image size (default is 4)",
    )
    parser.add_argument(
        "end_size", nargs="?", default=512, type=int,
        help="last progression image size (default is 512)",
    )
    parser.add_argument("-y", "--yes", action="store_true", help="overwrite existing sets without prompting")
    parser.add_argument("-w", "--workers", default=8, type=int)
    parser.add_argument(
        "--pack", action="store_true",
        help="also pack each set into a zero-decode packed.npy memmap (fastest training data path)",
    )
    parser.add_argument("-d", "--device", default=None, help="torch device of the resizes (default: cuda)")
    args = parser.parse_args(argv)

    if args.yes:
        overwrite = lambda name: True  # noqa: E731
    else:
        overwrite = lambda name: input(f"{name} exists. Delete? (y/N)") == "y"  # noqa: E731

    def progress(done, total):
        if done % 200 == 0 or done == total:
            print(f"prepared {done}/{total} images")

    sets = prepare_pyramid(
        args.datapath, args.start_size, args.end_size, workers=args.workers,
        overwrite=overwrite, progress=progress, device=args.device,
    )
    if args.pack:
        for k in range(1, len(sets) + 1):
            pack_stage(args.datapath, k, workers=args.workers)
            print(f"packed set_{k}")
    print(f"dataset ready: {len(sets)} resolution sets")


if __name__ == "__main__":
    main()
