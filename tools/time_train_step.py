#!/usr/bin/env python3
"""Time the stage-8 training iteration of one checkout of the port, on one GPU.

    python3 tools/time_train_step.py [--checkout DIR] [--iters 10]

Imports ``byogan_tpu_torch`` from DIR (default: the checkout that holds this
script), builds its kernels into DIR/build, and times the iteration that
chip_smoke.py times: full width, bf16, batch 5, stage 8's no-blend path,
random weights, under PyTorch's default math flags (printed).  Three
readings, which together say whether the host or the card sets the
iteration:

* idle start: for each iteration a synchronise, then the host clock around
  ``step`` alone (the host's issue time with an empty queue) inside a CUDA
  event pair (the card's time from that start to the end of the iteration);
* back to back: iterations issued without a synchronise, CUDA events around
  each (the rate of a training run, host and card overlapped);
* one profiled iteration (CPU and CUDA activity): the card's busy time
  summed over its kernels, the port's kernels apart, the kernels and copies
  launched, the ten largest kernels, and the host's calls by self CPU time
  (kernel launches, allocations, synchronisations, the autograd engine).

To compare two checkouts on one card, run it on both inside one call, in
the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

BATCH = 5  # batch_progression[7]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("time_train_step: needs a CUDA device")
    from byogan_tpu_torch.ops import build
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import make_train_step

    build.build(force=True)
    dev = torch.device("cuda")
    cfg = TrainConfig()
    state = build_state(cfg, dev)
    state.stage = 8
    gen = torch.Generator(device=dev).manual_seed(0)
    real = torch.randint(0, 256, (BATCH, 512, 512, 3), generator=gen, device=dev, dtype=torch.uint8)
    step = make_train_step(cfg, 8, BATCH, 8.0, (False,), False)
    for _ in range(3):
        step(state, real)
    torch.cuda.synchronize()

    print(f"checkout {root}")
    print(f"math: cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32} (PyTorch's defaults)")

    def stats(name, xs):
        return (f"{name} mean {statistics.mean(xs):.3f} median {statistics.median(xs):.3f} "
                f"min {min(xs):.3f} max {max(xs):.3f}")

    host, idle = [], []
    for _ in range(args.iters):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        step(state, real)
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
        torch.cuda.synchronize()
        idle.append(start.elapsed_time(end))
    print("idle start: " + stats("host ms to issue one iteration", host) + "; " + stats("card ms, start to end", idle))

    events = []
    for _ in range(args.iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, real)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    print("back to back: " + stats("iteration ms (CUDA events)", ms) + "; each: " + " ".join(f"{t:.2f}" for t in ms))

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        step(state, real)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    averages = prof.key_averages()
    device = [e for e in averages if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key) for e in device]
    busy = sum(t for t, _, _ in kernels)
    port = sum(t for t, _, k in kernels if "byogan" in k)
    copies = sum(c for _, c, k in kernels if k.startswith(("Memcpy", "Memset")))
    launched = sum(c for _, c, _ in kernels) - copies
    print(f"profiled iteration: {wall:.3f} ms; card busy {busy:.3f} ms ({100 * busy / wall:.1f}%), waiting "
          f"{wall - busy:.3f} ms; the port's kernels {port:.3f} ms, all others {busy - port:.3f} ms; "
          f"{launched} kernels and {copies} copies/memsets launched in the iteration")
    for t, count, key in sorted(kernels, reverse=True)[:10]:
        print(f"  {t:9.3f} ms {count:5d} calls  {key[:110]}")
    host_calls = sorted(
        (e for e in averages if e.device_type == DeviceType.CPU), key=lambda e: e.self_cpu_time_total, reverse=True
    )
    total_cpu = sum(e.self_cpu_time_total for e in host_calls) / 1e3
    print(f"host: self CPU time of the profiled iteration {total_cpu:.3f} ms (profiler on); the largest entries:")
    for e in host_calls[:15]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:6d} calls  {e.key[:90]}")
    watch = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMalloc", "cudaFree", "Synchronize", "autograd::engine")
    for w in watch:
        rows = [e for e in host_calls if w in e.key]
        if rows:
            print(f"  {w}: {sum(e.self_cpu_time_total for e in rows) / 1e3:.3f} ms self CPU over "
                  f"{sum(e.count for e in rows)} calls")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
