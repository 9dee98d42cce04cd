"""What the card checks share: the shapes and forced tile plans they hold K1
to, the card's time by kernel and per call, the host's time per call, and
the second derivatives that path-length regularization takes through the
autograd Functions.

``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` and ``tile_sweep``
use these; nothing on the port's paths does.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional
from unittest import mock

import torch

from byogan_tpu_torch.ops import styleconv

# K1 shapes (n, h, w, cin, cout) and the tile of bm pixels forced on the bf16
# route (None: plan_tiles' own).  Ragged H, W and channel counts; whole
# samples per tile (4 of 4x4 with one left over in a second tile, 2 of 8x8,
# 3 ragged 5x7 samples at 128 and 256 pixels); 4x8 rectangles; the 512 px
# narrow shape.
K1_CASES = [
    ((4, 8, 8, 16, 24), None), ((2, 16, 16, 8, 8), None), ((2, 32, 32, 32, 16), None),
    ((3, 5, 7, 40, 70), None), ((5, 4, 4, 512, 512), None), ((5, 4, 4, 512, 512), 64),
    ((8, 8, 8, 64, 64), None), ((8, 8, 8, 64, 64), 128), ((8, 8, 8, 64, 64), 32),
    ((3, 5, 7, 40, 70), 128), ((3, 5, 7, 40, 70), 256), ((1, 512, 512, 32, 16), None),
]

# K3 shapes (n, h, w, c): the initial block's at batch 5 and 24, narrow 64
# and 128 px, one 512 px sample, a ragged image, and C % 8 != 0 (the scalar
# route).
K3_CASES = [
    (5, 4, 4, 512), (24, 4, 4, 512), (2, 64, 64, 128), (10, 128, 128, 64),
    (1, 512, 512, 16), (3, 9, 31, 40), (2, 5, 7, 12),
]

# Short names of the kernels of K1 (csrc/styleconv.cu) and K3
# (csrc/styleconv_bwd.cu) in the profiler's table.
KERNELS = ("conv3x3_mma", "conv3x3_f32", "finalize_moments", "affine_apply",
           "epilogue_sums", "epilogue_apply", "sum_tiles")


@contextlib.contextmanager
def forced_plan(bm: Optional[int]):
    """Every bf16 K1 launch inside takes tiles of ``bm`` pixels
    (``styleconv.bf16_plan``); None leaves ``plan_tiles`` as it is."""
    if bm is None:
        yield
        return
    real = styleconv.plan_tiles

    def plan(n, h, w, cin, cout, dtype=torch.bfloat16):
        if dtype != torch.bfloat16:
            return real(n, h, w, cin, cout, dtype)
        return styleconv.bf16_plan(n, h, w, cin, cout, bm)

    with mock.patch.object(styleconv, "plan_tiles", plan):
        yield


def kernel_ms(fn, iters: int = 10, tries: int = 5) -> dict:
    """Mean time per fn() that the card spends in each kernel fn launches
    (torch.profiler's device time by kernel name, ``KERNELS`` by their short
    names), after warm-up.  Unlike CUDA events around the calls it leaves out
    the gaps where the card waits for the host.  The profiler now and then
    drops the records of small kernels; a trace in which some kernel was not
    recorded a whole number of times per call is taken again."""
    from torch.profiler import ProfilerActivity, profile

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
        raise RuntimeError(f"kernel_ms: the profiler lost kernel records in {tries} traces")
    out = {}
    for e in kernels:
        name = next((k for k in KERNELS if k in e.key), e.key[:30])
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / iters
    return out


def queued_ms(fn, calls: int = 20, cycles: int = 20_000_000) -> float:
    """Card time per fn() with the host out of the way: the calls are
    queued behind a spin kernel, so the card runs them back to back, and
    CUDA events time them there (their kernels and the gaps between
    dependent launches).  Needs no profiler.  Where the card finished the
    spin before the host had queued every call, it spins longer and again."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        caught_up = start.query()
        torch.cuda.synchronize()
        if not caught_up:
            return start.elapsed_time(end) / calls
        cycles *= 4
    raise RuntimeError("queued_ms: the host could not queue the calls ahead of the card")


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds per fn() call: a host clock around ``calls`` calls
    with no synchronise in between, after warm-up.  What the host spends to
    issue one call (argument checks, allocations, launches)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def second_derivatives(fn, ins: dict, seed: int):
    """First and second derivatives of ``fn(*ins.values())``, an epilogue
    (a Function or its plain version): the VJP of a seeded dy (in the
    output's dtype) with ``create_graph``, then the gradient of its inner
    product with seeded directions with respect to dy and to every input
    but ``noise`` (a draw).  Returns (firsts, seconds), zeros where an
    input does not reach a second derivative (beta enters linearly)."""
    dev = next(iter(ins.values())).device
    g = torch.Generator(device=dev).manual_seed(seed)
    leaves = [t.clone().requires_grad_(k != "noise") for k, t in ins.items()]
    out = fn(*leaves)
    dy = torch.randn(out.shape, generator=g, device=dev).to(out.dtype).requires_grad_(True)
    wanted = [t for t in leaves if t.requires_grad]
    firsts = torch.autograd.grad(out, wanted, dy, create_graph=True)
    inner = sum((f.float() * torch.randn(f.shape, generator=g, device=dev)).sum() for f in firsts)
    seconds = torch.autograd.grad(inner, [dy] + wanted, allow_unused=True)
    return [f.detach() for f in firsts], [torch.zeros_like(t) if s is None else s for s, t in zip(seconds, [dy] + wanted)]
