#!/usr/bin/env python3
"""Check and time K3, the epilogue's backward kernel, of one checkout of the
port at the 16 stage-8 shapes, on one GPU.

    python3 tools/time_k3.py [--checkout DIR] [--batch 5]

Imports ``byogan_tpu_torch`` from DIR (default: the checkout that holds this
script) and builds its kernels into DIR/build.  At each shape (the 15
synthesis convs' (H, Cout) and the initial block's 4 px, 512) it holds
``styleconv_backward_cuda`` against ``styleconv_backward_plain`` in f32 and
bf16 (relative to each output's max) and checks that two runs give equal
bits; then, in bf16, it prints the CUDA-event time per call, the card's time
by kernel (torch.profiler), the host's microseconds per call (100 calls, no
synchronise in between) and GB/s over the card's time at 8 bytes an element
(dy and hv read, dpre written).  The last line is a JSON summary.  Only the
wrapper module of DIR is used, so DIR may be an older checkout: to compare
two on one card, run both inside one call, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # as chip_smoke.py
EPS = 1e-8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, default=5)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("time_k3: needs a CUDA device")
    from byogan_tpu_torch.models.factory import ModelSpec
    from byogan_tpu_torch.ops import build
    from byogan_tpu_torch.ops import styleconv_bwd as k3

    t0 = time.time()
    build.build(["styleconv_bwd"], force=True)
    print(f"checkout {root}; built K3 in {time.time() - t0:.1f} s")
    dev, n = torch.device("cuda"), args.batch
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(r, cout) for r, _, cout in ModelSpec().styleconv_shapes()] + [(4, 512)]

    def inputs(r, c, dt):
        hv = torch.randn((n, r, r, c), generator=gen, device=dev) + 0.1
        mean = hv.mean(dim=(1, 2))
        inv = torch.rsqrt(hv.var(dim=(1, 2), unbiased=False) + EPS)
        dy = torch.randn((n, r, r, c), generator=gen, device=dev).to(dt)
        gamma = (1 + 0.1 * torch.randn((n, c), generator=gen, device=dev)).to(dt)
        noise = torch.randn((n, r, r, 1), generator=gen, device=dev).to(dt)
        noise_w = 0.3 * torch.randn((c,), generator=gen, device=dev)
        return dy, hv, mean, inv, gamma, noise, noise_w

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
        """The card's time per call by kernel (short names); a trace that
        lost some kernel's records (not a whole number per call) is taken
        again."""
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
                break
        else:
            raise SystemExit(f"time_k3: the profiler lost kernel records in {tries} traces")
        out = {}
        for e in kernels:
            m = re.search(r"(\w+)(?:<[^()]*>)?\(", e.key)
            name = m.group(1) if m else e.key[:30]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / iters
        return out

    def host_us(fn, calls=100):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        us = 1e6 * (time.perf_counter() - t) / calls
        torch.cuda.synchronize()
        return us

    worst = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        worst[name] = 0.0
        for r, c in shapes:
            a = inputs(r, c, dt)
            got, again, want = k3.styleconv_backward_cuda(*a), k3.styleconv_backward_cuda(*a), k3.styleconv_backward_plain(*a)
            torch.cuda.synchronize()
            for f in want._fields:
                g, w = getattr(got, f).float(), getattr(want, f).float()
                err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)
                if not (torch.isfinite(g).all() and err <= GRAD_TOL[name]):
                    raise SystemExit(f"time_k3: {name} ({n},{r},{r},{c}) {f}: relative error {err:.3e} over {GRAD_TOL[name]}")
                if not torch.equal(getattr(got, f), getattr(again, f)):
                    raise SystemExit(f"time_k3: {name} ({n},{r},{r},{c}) {f}: two runs differ")
                worst[name] = max(worst[name], err)
        print(f"check {name}: 16 shapes within {GRAD_TOL[name]} of plain (worst {worst[name]:.3e}); two runs equal bit for bit")

    total = {"ms": 0.0, "device_ms": 0.0, "host_us": 0.0}
    for r, c in shapes:
        a = inputs(r, c, torch.bfloat16)
        call = lambda: k3.styleconv_backward_cuda(*a)  # noqa: E731
        t = {"ms": events_ms(call), "host_us": host_us(call)}
        parts = device_ms(call)
        t["device_ms"] = sum(parts.values())
        for k in total:
            total[k] += t[k]
        elems = n * r * r * c
        plan = k3.plan_backward(n, r * r, c).describe() if hasattr(k3, "plan_backward") else "one block per 256 pixels"
        print(f"K3 bf16 ({n},{r},{r},{c}) ms {t['ms']:.4f} device_ms {t['device_ms']:.4f} host_us {t['host_us']:.1f} "
              f"GB/s {8 * elems / t['device_ms'] / 1e6:.1f} (14 B: {14 * elems / t['device_ms'] / 1e6:.1f}); "
              f"by kernel: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f"; plan: {plan}")
    print(f"K3 bf16 sum over {len(shapes)} shapes: ms {total['ms']:.4f} device_ms {total['device_ms']:.4f} "
          f"host_us per call (mean) {total['host_us'] / len(shapes):.1f}")
    print(json.dumps({"checkout": root, **{k: round(v, 4) for k, v in total.items()}, "max_rel_err": worst}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
