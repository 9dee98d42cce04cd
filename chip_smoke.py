#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``byogan_tpu_torch/csrc`` into ``build/``, holds
each against its plain PyTorch version at the shapes the sampling path gives
it, samples 512 px frames from the full-width generator through ``Sampler``
(counting kernel launches), checks the kernel path against the plain path
on the card, times every kernel beside its bound, and writes PNGs through
``save_stream`` and the CLI.  Every phase that fails raises, so the script
exits nonzero; the last line is the JSON result, printed only on success.
Without a GPU, or without the package beside it, it fails before any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import torch
import torch.nn.functional as F

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_TENSOR = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# Tolerances against the plain versions: f32 differs by summation order
# only; bf16 by the output rounding (a few ulps of bf16 at |x| ~ 4).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Whole generator, f32, kernel path vs plain path: 16 convs, each followed
# by an instance norm, compound the per-conv rounding differences.
GEN_TOL = 2e-3
PATH_BATCH, FRAMES, RATE_FRAMES = 8, 16, 128


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max |got - want|; raises where it exceeds tol + tol*|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    require(bool(torch.isfinite(got).all()), "non-finite kernel output")
    worst = float((err - tol * want.abs()).max())
    require(worst <= tol, f"kernel disagrees with plain: excess {worst} over tol {tol}")
    return float(err.max())


def timed_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() over iters launches, after warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_shapes(channels):
    """(H, Cin, Cout) of every K1 launch of one pass through the generator:
    conv2 of stage 1, then conv1 and conv2 of each later stage."""
    out = []
    for i, (ic, oc) in enumerate(channels):
        r = 4 * 2**i
        if i > 0:
            out.append((r, ic, oc))
        out.append((r, oc, oc))
    return out


def k1_inputs(n, r, cin, cout, dtype, gen):
    dev = "cuda"

    def randn(*shape, std=1.0, mean=0.0, dt=dtype):
        t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (mean + std * t).to(dt)

    return dict(
        x=randn(n, r, r, cin),
        weight=randn(3, 3, cin, cout, std=(2.0 / (9 * cin)) ** 0.5),
        bias=randn(cout, std=0.1, dt=torch.float32),
        noise=randn(n, r, r, 1),
        noise_w=randn(cout, std=0.3, dt=torch.float32),
        gamma=randn(n, cout, std=0.1, mean=1.0),
        beta=randn(n, cout, std=0.1),
    )


def k2_inputs(n, r, c, dtype, gen):
    ins = k1_inputs(n, r, c, c, dtype, gen)
    return {k: ins[k] for k in ("x", "noise", "noise_w", "gamma", "beta")}


def k1_library(x, weight, bias, noise, noise_w, gamma, beta):
    """Yardstick: cuDNN conv + torch ops in the working dtype."""
    xc = x.permute(0, 3, 1, 2)  # a channels-last NCHW view
    h = F.conv2d(xc, weight.permute(3, 2, 0, 1), bias.to(x.dtype), padding=1)
    h = h + noise_w.to(x.dtype)[None, :, None, None] * noise.permute(0, 3, 1, 2)
    h = F.instance_norm(F.leaky_relu(h, 0.2), eps=1e-8)
    return gamma[:, :, None, None] * h + beta[:, :, None, None]


def k2_library(x, noise, noise_w, gamma, beta):
    h = F.leaky_relu(x + noise_w.to(x.dtype) * noise, 0.2).permute(0, 3, 1, 2)
    h = F.instance_norm(h, eps=1e-8)
    return gamma[:, :, None, None] * h + beta[:, :, None, None]


def k1_bound(n, r, cin, cout, isz):
    """(bound_ms, bound_by) of one K1 call: each input read once, the output
    written once; the conv's flops plus ~10 per output at the bf16 tensor
    core rate (the fastest the card could do them)."""
    hw = r * r
    nbytes = (n * hw * cin + 9 * cin * cout + n * hw + 2 * n * cout + n * hw * cout) * isz + 8 * cout
    flops = 2 * n * hw * 9 * cin * cout + 10 * n * hw * cout
    peak = PEAK_BF16_TENSOR if isz == 2 else PEAK_F32
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def k2_bound(n, r, c, isz):
    hw = r * r
    nbytes = (2 * n * hw * c + n * hw + 2 * n * c) * isz + 4 * c
    flops = 12 * n * hw * c  # noise fma, lrelu, two moments, affine
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def main() -> int:
    # Phase 1: the card.
    require(torch.cuda.is_available(), "no CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from byogan_tpu_torch.core.random import synthesis_noise, truncated_noise
    from byogan_tpu_torch.models import layers
    from byogan_tpu_torch.models.factory import ModelSpec, build_generator
    from byogan_tpu_torch.ops import build
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain
    from byogan_tpu_torch.ops.styleconv import styleconv_cuda, styleconv_plain
    from byogan_tpu_torch.serve import Sampler

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # Phase 2: build every kernel, one nvcc per source, all at once.
    t0 = time.time()
    built = build.build(force=True)
    print(f"build: {built} in {time.time() - t0:.1f} s")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    channels = ModelSpec().generator_channels()
    shapes = k1_shapes(channels)
    require(len(shapes) == 15, f"expected 15 K1 shapes, got {len(shapes)}")
    k2_shapes = [(4, 512), (64, 128), (512, 16)]  # the path's, then split-HW

    # Phase 3: each kernel against its plain version, f32 then bf16.
    errs = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            e1 = 0.0
            for r, cin, cout in shapes:
                ins = k1_inputs(PATH_BATCH, r, cin, cout, dtype, gen)
                e = max_err(styleconv_cuda(**ins), styleconv_plain(**ins), TOL[dtype])
                print(f"check K1 {str(dtype)[6:]} ({PATH_BATCH},{r},{r},{cin}->{cout}) max_abs_err {e:.3e} tol {TOL[dtype]}*(1+|plain|)")
                e1 = max(e1, e)
            e2 = 0.0
            for r, c in k2_shapes:
                n = 2 if r == 512 else PATH_BATCH
                ins = k2_inputs(n, r, c, dtype, gen)
                e = max_err(noise_lrelu_adain_cuda(**ins), noise_lrelu_adain_plain(**ins), TOL[dtype])
                print(f"check K2 {str(dtype)[6:]} ({n},{r},{r},{c}) max_abs_err {e:.3e} tol {TOL[dtype]}*(1+|plain|)")
                e2 = max(e2, e)
            errs[dtype] = (e1, e2)
        torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        # Phase 4: the full-width generator, saved and loaded as a .pth.
        g = build_generator(ModelSpec(), generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            for m in g.modules():
                if isinstance(m, layers.NoiseInjection):  # zero-init otherwise
                    m.weights.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(1))
        ckpt = os.path.join(tmp, "gen.pth")
        torch.save({"gen": g.state_dict(), "step": 8, "alpha": None}, ckpt)
        sampler = Sampler(ckpt, batch=PATH_BATCH, seed=0)  # cuda, bf16
        require(sampler.resolution == 512, "sampler resolution")
        sampler.sample(PATH_BATCH)  # warm-up (cuDNN, allocator)
        torch.cuda.synchronize()

        styleconv_cuda.launches = noise_lrelu_adain_cuda.launches = 0
        t0 = time.perf_counter()
        frames = sampler.sample(FRAMES)
        main_s = time.perf_counter() - t0
        launches = {"styleconv": styleconv_cuda.launches, "adain": noise_lrelu_adain_cuda.launches}
        batches = FRAMES // PATH_BATCH
        print(f"main path: {FRAMES} frames {frames.shape} {frames.dtype} in {main_s:.3f} s; launches {launches}")
        require(frames.shape == (FRAMES, 512, 512, 3) and str(frames.dtype) == "uint8", "frame shape/dtype")
        require(frames.std() > 0, "constant frames")
        require(launches == {"styleconv": 15 * batches, "adain": batches}, f"launch counts {launches}")

        # The whole generator, kernel path vs plain path, f32 on the card.
        g32 = build_generator(ModelSpec())
        g32.load_state_dict(g.state_dict())
        g32.to("cuda").eval().requires_grad_(False)
        zg = torch.Generator(device="cuda").manual_seed(2)
        z = truncated_noise(zg, 2, 512)
        noise = synthesis_noise(zg, 2, 8)
        with torch.inference_mode():
            img_k = g32(z, noise, steps=8)
            with mock.patch.object(layers, "styleconv", styleconv_plain), mock.patch.object(
                layers, "noise_lrelu_adain", noise_lrelu_adain_plain
            ):
                img_p = g32(z, noise, steps=8)
            torch.cuda.synchronize()
        require(img_k.shape == (2, 512, 512, 3), "generator output shape")
        gen_err = max_err(img_k, img_p, GEN_TOL)
        print(f"generator f32 kernel vs plain path: max_abs_err {gen_err:.3e} tol {GEN_TOL}*(1+|plain|) (|img| max {float(img_p.abs().max()):.3f})")

        # Phase 5: the Sampler's rate, then every kernel's time at the path's
        # shapes (batch 8, bf16) beside its bound, plain and library times.
        t0 = time.perf_counter()
        sampler.sample(RATE_FRAMES)
        rate = RATE_FRAMES / (time.perf_counter() - t0)
        draws = sampler.draw()
        render_ms = timed_ms(lambda: sampler.render(*draws), iters=5)
        print(
            f"sampler: {rate:.2f} images/s at 512 px over {RATE_FRAMES} frames "
            f"(batch {PATH_BATCH}, bf16, host clock incl. fetch); render "
            f"{render_ms:.3f} ms per batch (CUDA events)"
        )
        totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        bound_by_kind = {"bytes": 0.0, "operations": 0.0}
        with torch.inference_mode():
            for r, cin, cout in shapes:
                ins = k1_inputs(PATH_BATCH, r, cin, cout, torch.bfloat16, gen)
                t = {
                    "ms": timed_ms(lambda: styleconv_cuda(**ins)),
                    "plain_ms": timed_ms(lambda: styleconv_plain(**ins)),
                    "library_ms": timed_ms(lambda: k1_library(**ins)),
                }
                t["bound_ms"], by = k1_bound(PATH_BATCH, r, cin, cout, 2)
                bound_by_kind[by] += t["bound_ms"]
                for k in totals:
                    totals[k] += t[k]
                print(f"time K1 bf16 ({PATH_BATCH},{r},{r},{cin}->{cout}) " + " ".join(f"{k} {v:.4f}" for k, v in t.items()) + f" bound_by {by}")
            k1_by = max(bound_by_kind, key=bound_by_kind.get)
            ins2 = k2_inputs(PATH_BATCH, 4, 512, torch.bfloat16, gen)
            k2 = {
                "ms": timed_ms(lambda: noise_lrelu_adain_cuda(**ins2)),
                "plain_ms": timed_ms(lambda: noise_lrelu_adain_plain(**ins2)),
                "library_ms": timed_ms(lambda: k2_library(**ins2)),
            }
            k2["bound_ms"], k2_by = k2_bound(PATH_BATCH, 4, 512, 2)
            print(f"time K2 bf16 ({PATH_BATCH},4,4,512) " + " ".join(f"{k} {v:.4f}" for k, v in k2.items()) + f" bound_by {k2_by}")
            for r, c in k2_shapes[1:]:
                insx = k2_inputs(PATH_BATCH, r, c, torch.bfloat16, gen)
                kx = timed_ms(lambda: noise_lrelu_adain_cuda(**insx), iters=10)
                bx, _ = k2_bound(PATH_BATCH, r, c, 2)
                print(f"time K2 bf16 ({PATH_BATCH},{r},{r},{c}) ms {kx:.4f} bound_ms {bx:.4f} (split-HW, off the path)")

        # Phase 6: frames to disk through save_stream and through the CLI.
        out_dir = os.path.join(tmp, "stream")
        require(sampler.save_stream(out_dir, 4) == 4, "save_stream count")
        for i in range(1, 5):
            with open(os.path.join(out_dir, f"image_{i}.png"), "rb") as f:
                require(f.read(8) == b"\x89PNG\r\n\x1a\n", f"image_{i}.png")
        from byogan_tpu_torch.cli.generate_samples import main as generate_main

        cli_dir = os.path.join(tmp, "cli")
        os.makedirs(cli_dir)
        generate_main([ckpt, "2", "-o", cli_dir, "--seed", "0"])
        require(sorted(os.listdir(cli_dir)) == ["image_1.png", "image_2.png"], "CLI output")

    kernels = [
        {
            "name": "styleconv", "route": "cuda",
            "source": "byogan_tpu_torch/csrc/styleconv.cu",
            "replaces": "byogan_tpu/ops/pallas_styleconv.py:169",
            "launches": launches["styleconv"],
            "max_abs_err": errs[torch.bfloat16][0],
            "max_abs_err_f32": errs[torch.float32][0],
            **totals, "bound_by": k1_by,
            "shapes": "15 path shapes summed, batch 8, bf16",
        },
        {
            "name": "adain", "route": "cuda",
            "source": "byogan_tpu_torch/csrc/adain.cu",
            "replaces": "byogan_tpu/ops/pallas_adain.py:73",
            "launches": launches["adain"],
            "max_abs_err": errs[torch.bfloat16][1],
            "max_abs_err_f32": errs[torch.float32][1],
            **k2, "bound_by": k2_by,
            "shapes": "(8,4,4,512) bf16",
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
