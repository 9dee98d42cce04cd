"""Training CLI (byogan_tpu/cli/main.py).

    python -m byogan_tpu_torch.cli.main <section> [-c CKPT] [--config-file cfg.txt]
                                        [--max-iters N] [-d DEVICE] [--force-resume]
                                        [--trace-dir DIR] [--distributed] [--auto-resume]
    torchrun --nproc-per-node N -m byogan_tpu_torch.cli.main <section> --distributed

Reads ``<section>`` of an INI config (``config.txt`` by default), trains on
the GPU and writes ``.pth`` checkpoints.  ``-d cpu`` (or ``device = cpu``
in the section) takes the plain PyTorch path on the CPU; without a GPU
any other device raises.  SIGTERM or SIGINT saves ``chk-{iters}.pth`` at
the next iteration boundary and exits 0; ``-c`` resumes from it, and
``--auto-resume`` from the newest checkpoint in the section's
``checkpoint_dir`` (``latest_checkpoint``; ``-c`` wins).  A resume
whose trajectory knobs differ from the checkpoint's fails unless
``--force-resume``.  ``--trace-dir`` writes a ``torch.profiler`` trace
of the run there (``profiling.trace_if``).

``--distributed`` trains over a ``data x model`` mesh, one process per
card, under ``torchrun`` (byogan_tpu/cli/main.py:33-55): each process
joins the process group from torchrun's environment
(``parallel.init_distributed``) and trains on ``cuda:LOCAL_RANK`` over
NCCL, or on the CPU over gloo with ``-d cpu``.  The section's
``data_axis`` times ``model_axis`` must equal the number of processes and
``data_axis`` divide every ``batch_progression`` entry; rank 0 writes the
checkpoints, grids and metrics.
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from byogan_tpu_torch.parallel.mesh import init_distributed
from byogan_tpu_torch.profiling import trace_if
from byogan_tpu_torch.train.checkpoint import latest_checkpoint
from byogan_tpu_torch.train.config import load_ini_config
from byogan_tpu_torch.train.loop import train


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a progressive StyleGAN")
    parser.add_argument("config", help="Specify which config to use", type=str)
    parser.add_argument("-c", "--checkpoint", dest="checkpoint", help="Path to checkpoint file")
    parser.add_argument("--config-file", default="config.txt", help="INI config path")
    parser.add_argument("--max-iters", type=int, default=None, help="stop after N iterations")
    parser.add_argument("--trace-dir", default=None, help="write a torch.profiler trace here")
    parser.add_argument(
        "--distributed", action="store_true",
        help="data- and model-parallel under torchrun, one process per card (NCCL; gloo with -d cpu): join "
        "the process group from RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; the section's "
        "data_axis x model_axis must equal the world size",
    )
    parser.add_argument(
        "--auto-resume", action="store_true",
        help="resume from the newest checkpoint in checkpoint_dir if one exists (chk-N.pth, or FINAL.pth "
        "when it is as new); -c wins",
    )
    parser.add_argument(
        "-d", "--device", default=None,
        help="torch device (default: cuda, or cpu when the section says device = cpu)",
    )
    parser.add_argument(
        "--force-resume", action="store_true",
        help="resume even when the config's trajectory knobs (batch/epoch "
        "progressions, critic_repeats, seed, ...) differ from the ones the "
        "checkpoint was trained with: the resumed trajectory will diverge",
    )
    args = parser.parse_args(argv)
    config = load_ini_config(args.config_file, args.config)
    device = args.device or ("cpu" if config.device == "cpu" else "cuda")
    if args.distributed:
        device = init_distributed(device=device)
    checkpoint = args.checkpoint
    if checkpoint is None and args.auto_resume:  # every rank reads the same directory
        checkpoint = latest_checkpoint(config.checkpoint_dir)
        if checkpoint:
            print(f"auto-resuming from {checkpoint}")
    try:
        with trace_if(args.trace_dir):
            return train(
                config, checkpoint=checkpoint, max_iters=args.max_iters, device=device,
                allow_config_mismatch=args.force_resume,
            )
    finally:
        if args.distributed:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
