"""Export a checkpoint (byogan_tpu/cli/export.py), two lanes:

    python -m byogan_tpu_torch.cli.export <checkpoint.pth> <output> [--ema]
    python -m byogan_tpu_torch.cli.export <checkpoint.pth> <output> --program
        [--ema] [--batch N] [--dtype bfloat16|float32] [--psi PSI] [-t TRUNC] [-d DEVICE]

* default: a reference-loadable ``.pth``: the ``gen`` and ``critic`` state
  dicts under DataParallel's ``module.`` prefix and the logical fields
  ``iter``, ``im_count``, ``step``, ``epoch``, ``alpha``, nothing else, as
  the JAX package's lane writes them.  Only the reference architecture
  (``ModelSpec()``) is exported; ``--ema`` puts the EMA generator in the
  ``gen`` slot.
* ``--program``: a ``torch.export`` serving program of the generator with
  its weights inside and a ``.json`` sidecar (``deploy.py``; the JAX
  lane's ``--stablehlo``), traced on the GPU unless ``-d cpu``.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a checkpoint: reference-loadable .pth (default) "
        "or a torch.export serving program (--program)"
    )
    parser.add_argument("checkpoint", help="the port's .pth checkpoint")
    parser.add_argument(
        "output", help="output path (.pth, or the program with --program; a .json sidecar lands next to it)"
    )
    parser.add_argument(
        "--ema", action="store_true",
        help="export the EMA generator weights into the .pth 'gen' slot / into the program",
    )
    parser.add_argument(
        "--program", action="store_true",
        help="write a torch.export serving program (+ .json sidecar) instead of a .pth",
    )
    parser.add_argument("--batch", type=int, default=32, help="--program: batch size the program is traced at")
    parser.add_argument("--dtype", default="bfloat16", help="--program: compute dtype (bfloat16|float32)")
    parser.add_argument(
        "--psi", type=float, default=None,
        help="--program: bake W-space truncation (the mean w is a constant of the program)",
    )
    parser.add_argument(
        "-t", "--truncation", type=float, default=0.75,
        help="--program: the training z truncation (config.noise_trunc), used to compute the baked mean w",
    )
    parser.add_argument(
        "-d", "--device", default=None,
        help="--program: the device the program is traced on and runs on (default: cuda)",
    )
    args = parser.parse_args(argv)

    if args.program:
        from byogan_tpu_torch.deploy import export_program

        meta = export_program(
            args.checkpoint, args.output, batch=args.batch, dtype=args.dtype, use_ema=args.ema,
            truncation_psi=args.psi, truncation=args.truncation, device=args.device,
        )
        print(
            f"exported {args.checkpoint} -> {args.output} ({meta['bytes']} bytes, "
            f"{meta['resolution']}px, device {meta['device']})"
        )
        return

    from byogan_tpu_torch.models.factory import ModelSpec
    from byogan_tpu_torch.train.checkpoint import load_checkpoint

    save = load_checkpoint(args.checkpoint)
    gen = save["gen"]
    if args.ema:
        if save.get("gen_ema") is None:
            raise SystemExit(f"--ema: {args.checkpoint} carries no EMA weights (train with ema_beta > 0)")
        gen = save["gen_ema"]
    spec = ModelSpec.from_dict(save.get("model"))
    if spec != ModelSpec():
        raise SystemExit(
            f"checkpoint architecture {spec} is not the reference shape; "
            "only ModelSpec() defaults can be exported to .pth"
        )
    out = {
        "gen": {f"module.{k}": v for k, v in gen.items()},
        "critic": {f"module.{k}": v for k, v in save["critic"].items()},
        **{k: save[k] for k in ("iter", "im_count", "step", "epoch", "alpha")},
    }
    torch.save(out, args.output)
    print(f"exported {args.checkpoint} -> {args.output}")


if __name__ == "__main__":
    main()
