"""What the card checks of K1 share: the shapes and forced tile plans they
hold K1 to, and the card's time by kernel.

``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` and ``tile_sweep``
use these; nothing on the port's paths does.
"""

from __future__ import annotations

import contextlib
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

# Short names of K1's kernels (csrc/styleconv.cu) in the profiler's table.
K1_KERNELS = ("conv3x3_mma", "conv3x3_f32", "finalize_moments", "affine_apply")


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


def kernel_ms(fn, iters: int = 10) -> dict:
    """Mean time per fn() that the card spends in each kernel fn launches
    (torch.profiler's device time by kernel name, K1's kernels by their short
    names), after warm-up.  Unlike CUDA events around the calls it leaves out
    the gaps where the card waits for the host."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = next((k for k in K1_KERNELS if k in e.key), e.key[:30])
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / iters
    return out
