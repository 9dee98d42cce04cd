#!/usr/bin/env python3
"""Check and time K1, the synthesis conv's forward kernel, of one checkout of
the port at the generator's 15 conv shapes, on one GPU.

    python3 tools/time_k1.py [--checkout DIR] [--batches 1 5 8 24 64]

Imports ``byogan_tpu_torch`` from DIR (default: the checkout that holds this
script) and builds its kernels into DIR/build.  At batch 8 it holds
``styleconv_cuda`` against ``styleconv_plain`` in f32 (TF32 off) and bf16
(each element within tol * (1 + |plain|), as chip_smoke.py) and checks that two
runs give equal bits.  Then, in bf16, for each batch it prints the sums
over the 15 shapes, without residuals and with them (``with_stats``, the
training forward): CUDA events around 20 calls queued back to back
(``ms``) and the card's time in K1's kernels by torch.profiler
(``device_ms``), with the tile plan of each shape.  The last line is a JSON
summary.  Only the wrapper module of DIR is used, so DIR may be an older
checkout: to compare two on one card, run both inside one call, in the
order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # as chip_smoke.py


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 5, 8, 24, 64])
    args = ap.parse_args(argv)
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("time_k1: needs a CUDA device")
    from byogan_tpu_torch.models.factory import ModelSpec
    from byogan_tpu_torch.ops import build
    from byogan_tpu_torch.ops import styleconv as k1

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    build.build(["styleconv"], force=True)
    print(f"checkout {root}; built K1 in {time.time() - t0:.1f} s; {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = ModelSpec().styleconv_shapes()

    def inputs(n, r, cin, cout, dt):
        def randn(*shape, std=1.0, mean=0.0, t=dt):
            return (mean + std * torch.randn(shape, generator=gen, device=dev)).to(t)

        return dict(x=randn(n, r, r, cin), weight=randn(3, 3, cin, cout, std=(2.0 / (9 * cin)) ** 0.5),
                    bias=randn(cout, std=0.1, t=torch.float32), noise=randn(n, r, r, 1),
                    noise_w=randn(cout, std=0.3, t=torch.float32), gamma=randn(n, cout, std=0.1, mean=1.0),
                    beta=randn(n, cout, std=0.1))

    def events_ms(fn, iters=20):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def device_ms(fn, iters=10, tries=3):
        """The card's time per call in kernels; a trace that lost some
        kernel's records (not a whole number per call) is taken again."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            if kernels and all(e.count % iters == 0 for e in kernels):
                return sum(e.self_device_time_total for e in kernels) / 1e3 / iters
        raise SystemExit(f"time_k1: the profiler lost kernel records in {tries} traces")

    worst = {}
    # the plain version's f32 conv in full f32, as chip_smoke.py holds it (cuDNN takes TF32 by default)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            worst[name] = 0.0
            for r, cin, cout in shapes:
                ins = inputs(8, r, cin, cout, dt)
                got, again, want = k1.styleconv_cuda(**ins), k1.styleconv_cuda(**ins), k1.styleconv_plain(**ins)
                torch.cuda.synchronize()
                err = float(((got.float() - want.float()).abs() - TOL[name] * want.float().abs()).max())
                if not (torch.isfinite(got).all() and err <= TOL[name]):
                    raise SystemExit(f"time_k1: {name} (8,{r},{r},{cin}->{cout}): excess error {err:.3e} over {TOL[name]}")
                if not torch.equal(got, again):
                    raise SystemExit(f"time_k1: {name} (8,{r},{r},{cin}->{cout}): two runs differ")
                worst[name] = max(worst[name], err)
            print(f"check {name}: 15 shapes at batch 8 within {TOL[name]}*(1+|plain|) (worst excess {worst[name]:.3e}); "
                  f"two runs equal bit for bit")
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

        sums = {}
        for n in args.batches:
            total = {"ms": 0.0, "device_ms": 0.0, "with_stats_ms": 0.0, "with_stats_device_ms": 0.0}
            for r, cin, cout in shapes:
                ins = inputs(n, r, cin, cout, torch.bfloat16)
                plain = lambda: k1.styleconv_cuda(**ins)  # noqa: E731
                stats = lambda: k1.styleconv_cuda(**ins, with_stats=True)  # noqa: E731
                t = {"ms": events_ms(plain), "device_ms": device_ms(plain),
                     "with_stats_ms": events_ms(stats), "with_stats_device_ms": device_ms(stats)}
                for k in total:
                    total[k] += t[k]
                print(f"K1 bf16 ({n},{r},{r},{cin}->{cout}) " + " ".join(f"{k} {v:.4f}" for k, v in t.items())
                      + f"; plan: {k1.plan_tiles(n, r, r, cin, cout).describe()}")
                del ins
            sums[n] = {k: round(v, 4) for k, v in total.items()}
            print(f"K1 bf16 sum over {len(shapes)} shapes at batch {n}: "
                  + " ".join(f"{k} {v:.4f}" for k, v in total.items()) + f"; {card}")
    print(json.dumps({"checkout": root, "card": card, "sums": {str(n): v for n, v in sums.items()},
                      "max_excess_err": worst}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
