#!/usr/bin/env python3
"""Check and time K2, the noise + LeakyReLU + AdaIN epilogue kernel, of one
checkout of the port at the path's shapes, on one GPU.

    python3 tools/time_k2.py [--checkout DIR]

Imports ``byogan_tpu_torch`` from DIR (default: the checkout that holds this
script) and builds its K2 into DIR/build.  The shapes are the initial 4x4
block's: (8,4,4,512) without residuals (a sampling batch) and (5,4,4,512)
and (24,4,4,512) with them (training).  At each it holds
``noise_lrelu_adain_cuda`` against ``noise_lrelu_adain_plain`` in f32 and
bf16 (chip_smoke.py's tolerances) and checks that two runs give equal bits;
then, in bf16, it prints the card's time per call with the host out of the
way (``cardcheck.queued_ms``: calls queued back to back behind a spin
kernel), the CUDA-event time per call, the host's microseconds per call and
the library composition's card time.  Beside them it prints the launch
floor: an empty kernel's (``torch.cuda._sleep(0)``) queued time.  The last
line is a JSON summary.  Only the wrapper and ``cardcheck`` modules of DIR
are used, so DIR may be an older checkout: to compare two on one card, run
both inside one call, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # as chip_smoke.py
SHAPES = [((8, 4, 4, 512), False), ((5, 4, 4, 512), True), ((24, 4, 4, 512), True)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("time_k2: needs a CUDA device")
    from byogan_tpu_torch.ops import build
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.cardcheck import host_us, queued_ms
    from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain

    t0 = time.time()
    build.build(["adain"], force=True)
    print(f"checkout {root}; built K2 in {time.time() - t0:.1f} s")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(shape, dt):
        n, h, w, c = shape
        r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
        return dict(x=r(n, h, w, c).to(dt), noise=r(n, h, w, 1).to(dt), noise_w=0.3 * r(c),
                    gamma=(1 + 0.1 * r(n, c)).to(dt), beta=(0.1 * r(n, c)).to(dt))

    def library(x, noise, noise_w, gamma, beta):
        h = F.leaky_relu(x + noise_w.to(x.dtype) * noise, 0.2).permute(0, 3, 1, 2)
        return gamma[:, :, None, None] * F.instance_norm(h, eps=1e-8) + beta[:, :, None, None]

    def events_ms(fn, iters=50):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for shape, stats in SHAPES:
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            ins = inputs(shape, dt)
            got = noise_lrelu_adain_cuda(**ins, with_stats=stats)
            again = noise_lrelu_adain_cuda(**ins, with_stats=stats)
            want = noise_lrelu_adain_plain(**ins, with_stats=stats)
            got, again, want = ((t,) if not stats else t for t in (got, again, want))
            torch.cuda.synchronize()
            errs = []
            for i, (g, w) in enumerate(zip(got, want)):
                tol = TOL[name] if i < 2 else 1e-3  # out and hv, then mean and inv (relative)
                err = float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-12)
                if not (err <= tol and bool(torch.isfinite(g).all())):
                    raise SystemExit(f"time_k2: {shape} {name} output {i} relative error {err:.3e} over {tol}")
                errs.append(err)
            equal = all(torch.equal(a, b) for a, b in zip(got, again))
            if not equal:
                raise SystemExit(f"time_k2: {shape} {name}: two runs differ")
            print(f"check K2 {name} {shape} with_stats {stats}: max rel err {max(errs):.3e}; two runs bit-equal")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True

    floor = queued_ms(lambda: torch.cuda._sleep(0))
    print(f"launch floor: an empty kernel queued back to back {floor:.5f} ms")
    summary = {"checkout": root, "device": torch.cuda.get_device_name(0), "launch_floor_ms": floor, "shapes": []}
    for shape, stats in SHAPES:
        ins = inputs(shape, torch.bfloat16)

        def fn():
            return noise_lrelu_adain_cuda(**ins, with_stats=stats)

        t = {
            "shape": list(shape), "with_stats": stats,
            "device_ms": queued_ms(fn), "ms": events_ms(fn), "host_us_per_call": host_us(fn),
            "library_device_ms": queued_ms(lambda: library(**ins)),
        }
        summary["shapes"].append(t)
        print(f"time K2 bf16 {shape} with_stats {stats}: device_ms {t['device_ms']:.5f} (queued) ms {t['ms']:.5f} "
              f"(events) host_us_per_call {t['host_us_per_call']:.1f} library_device_ms {t['library_device_ms']:.5f}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
