"""Sweep K1's bf16 tile plans at the generator's 15 conv shapes, on the GPU.

    python -m byogan_tpu_torch.ops.tile_sweep [--batch 8]

For each shape and each tile size (BM pixels) that
``bf16_plan`` can build, runs K1 once against ``styleconv_plain`` and
prints the card's time in each of K1's kernels (torch.profiler device
time, mean of 10 calls after warm-up).  The planner's own choice is marked
``*``.  This is the measurement behind the planner's rules (PERF.md).
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from byogan_tpu_torch.models.factory import ModelSpec
from byogan_tpu_torch.ops.cardcheck import forced_plan, kernel_ms
from byogan_tpu_torch.ops.styleconv import WARPS, bf16_plan, plan_tiles, styleconv_cuda, styleconv_plain


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"tile_sweep on {card}, bf16, batch {args.batch}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, failed = args.batch, 0
    for r, cin, cout in ModelSpec().styleconv_shapes():
        def randn(*shape, std=1.0, dt=torch.bfloat16):
            return (std * torch.randn(shape, generator=gen, device="cuda")).to(dt)

        ins = dict(
            x=randn(n, r, r, cin), weight=randn(3, 3, cin, cout, std=(2.0 / (9 * cin)) ** 0.5),
            bias=randn(cout, std=0.1, dt=torch.float32), noise=randn(n, r, r, 1),
            noise_w=randn(cout, std=0.3, dt=torch.float32), gamma=1 + randn(n, cout, std=0.1),
            beta=randn(n, cout, std=0.1),
        )
        want = styleconv_plain(**ins).float()
        chosen = plan_tiles(n, r, r, cin, cout)
        for bm, bn in sorted(WARPS, reverse=True):
            if bn != chosen.bn:
                continue
            plan = bf16_plan(n, r, r, cin, cout, bm)
            with forced_plan(bm):
                got = styleconv_cuda(**ins).float()
                times = kernel_ms(lambda: styleconv_cuda(**ins))
            err = float(((got - want).abs() - 2e-2 * want.abs()).max())
            mark = "*" if plan == chosen else " "
            print(
                f"{mark} ({n},{r},{r},{cin}->{cout}) {plan.describe()}: device ms {sum(times.values()):.4f} ("
                + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                + f"); excess error {err:.2e}" + ("" if err <= 2e-2 else " FAILS 2e-2")
            )
            failed += err > 2e-2
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
