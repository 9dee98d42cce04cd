#!/usr/bin/env python3
"""Time the stage-8 training iteration of one checkout of the port, on one GPU.

    python3 tools/time_train_step.py [--checkout DIR] [--iters 10]

Imports ``byogan_tpu_torch`` from DIR (default: the checkout that holds this
script), builds its kernels into DIR/build, and times the iteration that
chip_smoke.py times: full width, bf16, batch 5, stage 8's no-blend path,
random weights.  Prints each iteration's time by CUDA events and the host's
time to issue it, then one profiled iteration: the card's busy time summed
over its kernels (the rest of the iteration the card waits), the port's
kernels apart from the others, and the ten largest kernels.  To compare two
checkouts on one card, run it on both inside one call, in the order A, B,
B, A.
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

    events, host = [], []
    for _ in range(args.iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        step(state, real)
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    print(f"checkout {root}")
    print(f"iteration ms (CUDA events): mean {statistics.mean(ms):.3f} median {statistics.median(ms):.3f} "
          f"min {min(ms):.3f} max {max(ms):.3f}; each: " + " ".join(f"{t:.2f}" for t in ms))
    print(f"host ms to issue one iteration: mean {statistics.mean(host):.3f} median {statistics.median(host):.3f}")

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        step(state, real)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(t for t, _, _ in kernels)
    port = sum(t for t, _, k in kernels if "byogan" in k)
    print(f"profiled iteration: {wall:.3f} ms; card busy {busy:.3f} ms ({100 * busy / wall:.1f}%), waiting "
          f"{wall - busy:.3f} ms; the port's kernels {port:.3f} ms, all others {busy - port:.3f} ms")
    for t, count, key in sorted(kernels, reverse=True)[:10]:
        print(f"  {t:9.3f} ms {count:5d} calls  {key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
