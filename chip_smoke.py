#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``byogan_tpu_torch/csrc`` into ``build/`` and
counts the tensor-core instructions (HMMA/HGMMA) in K1's SASS, then drives
both paths of the port at full width (``ModelSpec()``):

* sampling: each forward kernel against its plain PyTorch version at the
  shapes the sampling path gives it and K1 at the card tests' shapes, 512 px
  frames through ``Sampler`` (counting kernel launches), the kernel path
  against the plain path, every kernel's time beside its bound (K1 per
  shape with its tile plan and the card's time in each of its kernels),
  PNGs through ``save_stream`` and the CLI;
* training: the forwards with their residuals, the backward kernel and the
  autograd Functions' gradients against their plain versions at the
  stage-8 shapes, all 8 stages 4 -> 512 px through the training CLI on a
  synthetic dataset (counting launches per iteration), one stage-8 step on
  the kernel path against the plain path, and the stage-8 iteration's time
  broken into its parts;
* the EMA, style-mixing and preemption slice: the training CLI with EMA
  and style mixing in a subprocess, stopped by SIGTERM at stage 5, a
  resume with a changed knob refused, the resume to FINAL.pth (counting
  launches per iteration), the stage-8 iteration with and without the two
  extensions and the EMA update's time; then the sampling surfaces on the
  EMA weights at 512 px (W-space truncation, style mixing, both CLIs);
* the W-space and eval slice on those EMA weights at 512 px: projections
  in W and W+ from the mean w onto targets rendered from a known w
  (launches per iteration, no weight gradient, the loss ratio under the
  JAX suite's bars), the projection's gradient on the kernel path against
  the plain path, ``cli.project``, ``cli.edit``, ``cli.interpolate`` and
  ``cli.evaluate``, SWD and MS-SSIM on the card against the CPU, stage 8
  through the training CLI with the periodic eval against the same run
  without it, and their times;
* the augmentation, ADA and path-length regularization slice: both
  autograd Functions' second derivative against autograd's of the plain
  forward at the stage-8 shapes, the training CLI at full width with ADA
  and PLR (a subprocess through stage 7, then the resume through stage 8:
  launches per plain and per penalized iteration, the controller's exact
  steps, pl_ema, the checkpoint's regularizer state), one penalized
  stage-8 step with augmentation on the kernel path against the plain
  path, and the stage-8 iteration's time default, with ADA and penalized,
  with a profile of the penalized one;
* the remat, dataset-preparation, serving-program and trace slice: one
  stage-8 step with remat against the same step without it (plain and
  penalized), the training CLI through all 8 stages with remat at stage 7
  (launches per iteration), peak memory and time with and without remat,
  ``cli.prep`` on synthetic originals against the plain resize, the
  generator exported with ``cli.export --program`` and served from a
  fresh process against ``Sampler.render``, and a profiler trace of the
  training CLI;
* the data-parallel slice over two ranks that the script spawns (gloo,
  both on this card, since NCCL refuses two ranks on one device; NCCL
  with a card each where the machine has two): one stage-8 f32 step on
  the global batch against one process on it (R1, then ADA and PLR on a
  penalized iteration), ``train`` stopped by a signal to one rank and
  resumed in one process, the training CLI at world 1 under NCCL through
  torchrun, the iteration's time with and without a process group and
  over two ranks, and the Sampler over two devices against one.
* the image-IO slice: the native image-IO library, the port's own PNG and
  JPEG codecs linked to zlib alone (``native/``; the script fails if it
  does not build or links libpng or libjpeg), held to the fixtures' hashes
  of libjpeg-turbo's and libpng's output, the PNG decode bit-equal to
  data/png.py's on smooth (Paeth, Average) and noisy (Up, Sub) sets, JPEG
  and BMP files, the codecs' and the loader's times by decode threads
  beside the stage-8 iteration, prep's (cli.prep on JPEG originals) and
  the frame writers' times, and the training CLI on a set with JPEG and
  BMP files among its PNGs, stopped by SIGTERM and resumed with
  ``--auto-resume``, then ``cli.generate_samples --format jpeg --pallas``
  on its FINAL.pth.

The parity checks run with TF32 off (``strict_f32``); every timing runs
under PyTorch's defaults, as a user's run does, and its line prints both
flags.

Every phase that fails raises, so the script exits nonzero; the last line
is the JSON result, printed only on success.  Without a GPU, or without the
package beside it, it fails before any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import datetime
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
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
# Training: the residuals (hv, mean, inv) are f32 in both versions, so f32
# rounding only.  The backward kernel and the Functions' gradients, relative
# to each tensor's max: f32 differs by summation order; bf16 by rounding
# dpre to bf16 before the conv transposes (as JAX does), about 2^-8.
RES_TOL = 1e-4
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# One stage-8 step, f32, kernel path vs plain path.  Losses: relative
# 2e-3, as GEN_TOL (16 convs and instance norms compound per-conv
# rounding).  Gradients, per tensor: relative L2 error within 2e-2 and the
# largest difference within 5e-2 of the tensor's max.  Each Function is
# held at 1e-4 above; over a whole step two things widen that.  The conv
# biases' and noise weights' gradients are sums of dpre, whose instance-norm
# part sums to zero per sample and channel, so they are small differences
# of large terms.  And the two paths' activations differ by ~1e-5, so the
# few elements within that of zero take different branches of LeakyReLU
# (slopes 1 and 0.2), in the generator and in the critic, which sees the
# two paths' fakes.
STEP_TOL, STEP_GRAD_TOL = 2e-3, (2e-2, 5e-2)
TRAIN_BATCH, TRAIN_IMAGES, TIMED_ITERS = 5, 24, 5  # batch_progression[7]


@contextlib.contextmanager
def strict_f32():
    """f32 convs and matmuls in full f32 (TF32 off) for the parity checks,
    the flags restored after."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def math_flags() -> str:
    return f"[tf32 cudnn {torch.backends.cudnn.allow_tf32}, matmul {torch.backends.cuda.matmul.allow_tf32}]"


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


def rel_err(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> float:
    """max |got - want| / max |want|; raises where it exceeds tol."""
    got, want = got.float(), want.float()
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)
    require(err <= tol, f"{what}: relative error {err:.3e} over tol {tol}")
    return err


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


def device_ms(fn) -> float:
    """Mean time per fn() that the card spends in kernels (torch.profiler)."""
    from byogan_tpu_torch.ops.cardcheck import kernel_ms

    return sum(kernel_ms(fn).values())


def fmt_times(times: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in times.items())


def k1_inputs(n, r, cin, cout, dtype, gen, w=None):
    dev = "cuda"
    w = r if w is None else w

    def randn(*shape, std=1.0, mean=0.0, dt=dtype):
        t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (mean + std * t).to(dt)

    return dict(
        x=randn(n, r, w, cin),
        weight=randn(3, 3, cin, cout, std=(2.0 / (9 * cin)) ** 0.5),
        bias=randn(cout, std=0.1, dt=torch.float32),
        noise=randn(n, r, w, 1),
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


def k1_bound(n, r, cin, cout, isz, with_stats=False):
    """(bound_ms, bound_by) of one K1 call: each input read once, the output
    written once (with_stats: also the f32 hv, mean and inv); the conv's
    flops plus ~10 per output at the bf16 tensor core rate (the fastest the
    card could do them)."""
    hw = r * r
    nbytes = (n * hw * cin + 9 * cin * cout + n * hw + 2 * n * cout + n * hw * cout) * isz + 8 * cout
    if with_stats:
        nbytes += 4 * n * hw * cout + 8 * n * cout
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


def k3_bound(n, r, c, isz):
    """dy and the dpre write in x's dtype, hv in f32, noise and dnoise, the
    (N,C) statistics and grads; ~25 f32 flops per element."""
    hw = n * r * r
    nbytes = hw * c * (2 * isz + 4) + 2 * hw * isz + n * c * (8 + 3 * isz) + 12 * c
    t_bytes, t_ops = nbytes / PEAK_BYTES, 25 * hw * c / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def k3_library(dy, hv, mean, inv, gamma, noise, noise_w):
    """Yardstick for K3: ATen's LeakyReLU and instance-norm backward through
    autograd, plus the three torch reductions, in the working dtype.  The
    graph is built once; the returned function runs only the backward."""
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    pre = torch.where(hv >= 0, hv, 5.0 * hv).to(dy.dtype)
    pre = nchw(pre).detach().requires_grad_(True)
    g = gamma.detach().requires_grad_(True)
    b = torch.zeros_like(g, requires_grad=True)
    out = g[:, :, None, None] * F.instance_norm(F.leaky_relu(pre, 0.2), eps=1e-8) + b[:, :, None, None]
    dy_c, noise_c, nw = nchw(dy), nchw(noise), noise_w.to(dy.dtype)[None, :, None, None]

    def run():
        dpre, dg, db = torch.autograd.grad(out, (pre, g, b), dy_c, retain_graph=True)
        return dpre, dg, db, dpre.sum((0, 2, 3)), (dpre * noise_c).sum((0, 2, 3)), (dpre * nw).sum(1)

    return run


def tensor_core_instructions(lib, nvcc):
    """HMMA/HGMMA instructions in a built library's SASS (cuobjdump of the
    CUDA toolkit beside nvcc)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], check=True, capture_output=True, text=True).stdout
    return sum(1 for line in sass.splitlines() if "HMMA" in line or "HGMMA" in line)


def k1_extra_checks(gen):
    """K1 and its residuals against the plain version at the card tests'
    shapes and forced tile plans (``cardcheck.K1_CASES``), f32 and bf16;
    returns the largest out error per dtype."""
    from byogan_tpu_torch.ops.cardcheck import K1_CASES, forced_plan
    from byogan_tpu_torch.ops.styleconv import styleconv_cuda, styleconv_plain

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst[dtype] = 0.0
        for (n, h, w, cin, cout), bm in K1_CASES:
            ins = k1_inputs(n, h, cin, cout, dtype, gen, w=w)
            with torch.no_grad(), forced_plan(bm):
                got = styleconv_cuda(**ins, with_stats=True)
                want = styleconv_plain(**ins, with_stats=True)
            tag = f"K1 {str(dtype)[6:]} ({n},{h},{w},{cin}->{cout}) " + (f"forced bm {bm}" if bm else "planned")
            e = max_err(got[0], want[0], TOL[dtype])
            for name, gt, wt in zip(("hv", "mean", "inv"), got[1:], want[1:]):
                rel_err(gt, wt, RES_TOL, f"{tag} {name}")
            print(f"check {tag} out max_abs_err {e:.3e}, residuals within {RES_TOL} relative")
            worst[dtype] = max(worst[dtype], e)
    return worst


def training_kernels(shapes, gen):
    """The training path's kernels against their plain versions at the
    stage-8 shapes (batch 5), f32 and bf16: K1 and K2 with their residuals,
    K3, and the gradients of both autograd Functions for every input
    against autograd of the plain compositions."""
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.fused import NoiseLReLUAdaINFunction, noise_lrelu_adain_plain
    from byogan_tpu_torch.ops.styleconv import StyleConvFunction, styleconv_cuda, styleconv_plain
    from byogan_tpu_torch.ops.styleconv_bwd import styleconv_backward_cuda, styleconv_backward_plain

    errs = {}
    n = TRAIN_BATCH
    cases = [("K1", r, cin, cout) for r, cin, cout in shapes] + [("K2", 4, 512, 512)]
    for dtype in (torch.float32, torch.bfloat16):
        worst = {"fwd": 0.0, "k3": 0.0, "grad": 0.0}
        for kind, r, cin, cout in cases:
            if kind == "K1":
                ins = k1_inputs(n, r, cin, cout, dtype, gen)
                fwd, plain, fn = styleconv_cuda, styleconv_plain, StyleConvFunction.apply
            else:
                ins = k2_inputs(n, r, cout, dtype, gen)
                fwd, plain, fn = noise_lrelu_adain_cuda, noise_lrelu_adain_plain, NoiseLReLUAdaINFunction.apply
            tag = f"{kind} {str(dtype)[6:]} ({n},{r},{r},{cin}->{cout})"
            with torch.no_grad():
                got, want = fwd(**ins, with_stats=True), plain(**ins, with_stats=True)
                e = max_err(got[0], want[0], TOL[dtype])
                # K2's hv repeats the plain version's roundings in x's dtype
                res_tol = TOL[dtype] if kind == "K2" else RES_TOL
                for name, gt, wt in zip(("hv", "mean", "inv"), got[1:], want[1:]):
                    rel_err(gt, wt, res_tol if name == "hv" else 1e-3, f"{tag} {name}")
                dy = torch.randn(want[0].shape, generator=gen, device="cuda").to(dtype)
                args = (dy, *want[1:], ins["gamma"], ins["noise"], ins["noise_w"])
                k3, p3 = styleconv_backward_cuda(*args), styleconv_backward_plain(*args)
                e3 = max(rel_err(getattr(k3, f), getattr(p3, f), GRAD_TOL[dtype], f"{tag} K3 {f}") for f in k3._fields)
                k3_abs = float((k3.dpre.float() - p3.dpre.float()).abs().max())
            # The plain reference takes LeakyReLU's branch from the kernel's
            # hv: the two may differ where the pre-activation is within
            # rounding of zero (see styleconv_plain).
            ref = plain if kind == "K2" else (lambda *a, m=got[1] >= 0: plain(*a, positive=m))
            grads = {}
            for which, f in (("kernel", lambda *a: fn(*a, 1e-8)), ("plain", ref)):
                leaves = [t.clone().requires_grad_(True) for t in ins.values()]
                y = f(*leaves).float()
                grads[which] = torch.autograd.grad((y * torch.cos(y)).sum(), leaves)
            eg = max(
                rel_err(gk, gp, GRAD_TOL[dtype], f"{tag} grad {name}")
                for name, gk, gp in zip(ins, grads["kernel"], grads["plain"])
            )
            torch.cuda.synchronize()
            print(f"check train {tag} out max_abs_err {e:.3e}; K3 max rel err {e3:.3e} (dpre max_abs_err {k3_abs:.3e}); grads max rel err {eg:.3e} tol {GRAD_TOL[dtype]}")
            worst["fwd"] = max(worst["fwd"], e)
            worst["k3"] = max(worst["k3"], k3_abs)
            worst["grad"] = max(worst["grad"], eg)
        errs[dtype] = worst
    return errs


KERNEL_NAMES = ("styleconv", "adain", "styleconv_bwd")


def launch_counts() -> tuple:
    """The launch counts of K1, K2 and K3's wrappers."""
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.styleconv import styleconv_cuda
    from byogan_tpu_torch.ops.styleconv_bwd import styleconv_backward_cuda

    return tuple(w.launches for w in (styleconv_cuda, noise_lrelu_adain_cuda, styleconv_backward_cuda))


def zero_launch_counts() -> None:
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.styleconv import styleconv_cuda
    from byogan_tpu_torch.ops.styleconv_bwd import styleconv_backward_cuda

    styleconv_cuda.launches = noise_lrelu_adain_cuda.launches = styleconv_backward_cuda.launches = 0


@contextlib.contextmanager
def counting_steps(records: list, regularized: list = None):
    """The training loop's steps, each appending (stage, critic fade flags,
    generator fade flag, its K1, K2 and K3 launches) to ``records``; with
    ``regularized``, also a dict of the iteration, the batch, the state's
    aug_p, rt_ema and pl_ema before the step and the step's losses and
    regularizer metrics, as floats (a host sync a step)."""
    from byogan_tpu_torch.train import loop
    from byogan_tpu_torch.train.checkpoint import REGULARIZER_KEYS

    make_step = loop.make_train_step

    def counting_step(config, steps, batch, fade_in, critic_fade, gen_fade, **kw):
        fn = make_step(config, steps, batch, fade_in, critic_fade, gen_fade, **kw)

        def step(state, real, draws=None):
            before = launch_counts()
            if regularized is not None:
                rec = {"iters": state.iters, "stage": steps, "batch": batch,
                       "before": {k: float(getattr(state, k)) for k in REGULARIZER_KEYS if getattr(state, k) is not None}}
            out = fn(state, real, draws)
            launched = tuple(a - b for a, b in zip(launch_counts(), before))
            records.append((steps, critic_fade, gen_fade, launched))
            if regularized is not None:
                regularized.append(dict(rec, launches=launched, **{k: float(v) for k, v in out.items()}))
            return out

        return step

    with mock.patch.object(loop, "make_train_step", counting_step):
        yield


def train_through_cli(tmp):
    """All 8 stages at full width through the training CLI: 16 iterations
    on 24 synthetic images.  Counts the kernel launches of every step (the
    sample grid at the end adds forward launches of its own) and checks the
    losses, the fade pattern and the FINAL checkpoint."""
    from byogan_tpu_torch.cli.main import main as train_main
    from byogan_tpu_torch.data.synthetic import write_prepared_dataset
    from byogan_tpu_torch.models.factory import ModelSpec, build_critic, build_generator
    from byogan_tpu_torch.train.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    data = write_prepared_dataset(os.path.join(tmp, "data"), TRAIN_IMAGES, 8, seed=0)
    print(f"train: wrote {TRAIN_IMAGES} images x 8 stages in {time.perf_counter() - t0:.2f} s")
    cfg = os.path.join(tmp, "train.txt")
    with open(cfg, "w") as f:
        f.write(
            "[smoke]\n"
            f"data = {data}\n"
            "epoch_progression = 1,1,1,1,1,1,1,1\n"
            "fade_percentage = 2\n"
            "display_step = 1000\ncheckpoint_step = 1000\nrefresh_stat_step = 1\n"
            f"checkpoint_dir = {tmp}/ck\noutput_dir = {tmp}/out\n"
        )
    records = []
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting_steps(records):
        state = train_main(["smoke", "--config-file", cfg])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(KERNEL_NAMES, launch_counts()))
    print(f"train: 8 stages 4->512 px, {state.iters} iterations in {wall:.2f} s through the CLI; launches {launches}")
    require(state.iters == 16 and len(records) == 16, f"iterations {state.iters}, steps {len(records)}")
    for k, _, _, got in records:
        require(got == (2 * (2 * k - 1), 2, 2 * k), f"stage {k}: launches per iteration {got}")
    fades = [(c, g) for k, c, g, _ in records if k == 8]
    require(fades == [((True,), True), ((True,), False), ((False,), False), ((False,), False)], f"stage-8 fade flags {fades}")
    print(f"train: launches per iteration at stage 8 (K1, K2, K3) {records[-1][3]}; stage-8 fade flags {fades}")
    with open(os.path.join(tmp, "out", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    require(len(logged) == 16, f"metrics records {len(logged)}")
    require(all(math.isfinite(r["c_loss"]) and math.isfinite(r["g_loss"]) for r in logged), "non-finite losses")
    print(f"train: last losses c {logged[-1]['c_loss']:.4f} g {logged[-1]['g_loss']:.4f}")
    final = load_checkpoint(os.path.join(tmp, "ck", "FINAL.pth"))
    spec = ModelSpec.from_dict(final["model"])
    require(spec == ModelSpec() and final["step"] == 8 and final["alpha"] is None, "FINAL checkpoint fields")
    build_generator(spec).load_state_dict(final["gen"], strict=True)
    build_critic(spec).load_state_dict(final["critic"], strict=True)
    require(os.path.exists(os.path.join(tmp, "out", "s-final.png")), "final sample grid")
    return launches, wall


def stage8_step_kernel_vs_plain():
    """One stage-8 step at full width in f32 from one initial state: the
    kernel path against the plain path (the plain versions swapped into the
    layers), same draws and batch.  Compares the losses and every
    parameter's gradient, which the step leaves in ``.grad``."""
    import types

    from byogan_tpu_torch.models import layers
    from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain
    from byogan_tpu_torch.ops.styleconv import styleconv_plain
    from byogan_tpu_torch.ops.styleconv_bwd import styleconv_backward_cuda
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import draw, make_train_step

    cfg = TrainConfig(compute_dtype="float32")
    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(3)
    draws = draw(types.SimpleNamespace(rng=rng), cfg, TRAIN_BATCH, 8, torch.float32)
    real = torch.randint(0, 256, (TRAIN_BATCH, 512, 512, 3), generator=rng, device=dev, dtype=torch.uint8)
    step = make_train_step(cfg, 8, TRAIN_BATCH, 8.0, (True,), True)
    out = {}
    for path in ("kernel", "plain"):
        state = build_state(cfg, dev)
        with torch.no_grad():  # noise weights start at zero, which hides the noise path
            for name, p in state.gen.named_parameters():
                if "inject_noise" in name:
                    p.normal_(0.0, 0.3, generator=torch.Generator(device=dev).manual_seed(len(name)))
        k3_before = styleconv_backward_cuda.launches
        if path == "kernel":
            metrics = step(state, real, draws)
        else:
            with mock.patch.object(layers, "styleconv", styleconv_plain), mock.patch.object(
                layers, "noise_lrelu_adain", noise_lrelu_adain_plain
            ):
                metrics = step(state, real, draws)
        torch.cuda.synchronize()
        k3 = styleconv_backward_cuda.launches - k3_before
        require(k3 == (16 if path == "kernel" else 0), f"{path} path launched K3 {k3} times")
        out[path] = (metrics, {n: p.grad.clone() for n, p in state.gen.named_parameters()},
                     {n: p.grad.clone() for n, p in state.critic.named_parameters()})
        del state
    # The generator's backward alone: one cotangent on the image through
    # both paths (Functions with K3 and cuDNN transposes vs plain autograd).
    state = build_state(cfg, dev)
    params = list(state.gen.parameters())
    z, noise = draws.gen
    cot = torch.randn((TRAIN_BATCH, 512, 512, 3), generator=rng, device=dev)
    # A third run, the plain path on latents moved by float rounding (1e-6
    # relative), measures how far rounding alone moves these gradients.
    iso = {}
    for path in ("kernel", "plain", "plain, z moved by 1e-6"):
        with contextlib.ExitStack() as stack:
            if path != "kernel":
                stack.enter_context(mock.patch.object(layers, "styleconv", styleconv_plain))
                stack.enter_context(mock.patch.object(layers, "noise_lrelu_adain", noise_lrelu_adain_plain))
            zz = z * (1 + 1e-6 * torch.randn(z.shape, generator=rng, device=dev)) if path.endswith("1e-6") else z
            img = state.gen(zz, noise, steps=8, alpha=0.625)
            iso[path] = (img.detach(), dict(zip([n for n, _ in state.gen.named_parameters()],
                                                torch.autograd.grad(img, params, cot, allow_unused=True))))
    del state
    max_err(iso["kernel"][0], iso["plain"][0], GEN_TOL)
    (mk, gk, ck), (mp, gp, cp) = out["kernel"], out["plain"]
    worst = max(rel_err(mk[k], mp[k], STEP_TOL, f"step {k}") for k in ("c_loss", "g_loss", "r1_penalty", "real_pred", "fake_pred"))
    zero = lambda d: {n: torch.zeros_like(gp[n]) if g is None else g for n, g in d.items()}  # noqa: E731
    iso_l2, iso_max = grad_errs(zero(iso["kernel"][1]), zero(iso["plain"][1]), "generator backward alone, kernel vs plain")
    grad_errs(zero(iso["plain, z moved by 1e-6"][1]), zero(iso["plain"][1]), "generator backward alone, plain with z moved by 1e-6 vs plain")
    g_l2, g_max = grad_errs(gk, gp, "step gen grad")
    c_l2, c_max = grad_errs(ck, cp, "step critic grad")
    print(
        f"step f32 stage 8 kernel vs plain path: losses max rel err {worst:.3e} (tol {STEP_TOL}); generator grads "
        f"relative L2 {g_l2:.3e}, max {g_max:.3e}; critic grads relative L2 {c_l2:.3e}, max {c_max:.3e} "
        f"(tol {STEP_GRAD_TOL}); c_loss {float(mk['c_loss']):.5f} "
        f"vs {float(mp['c_loss']):.5f}, g_loss {float(mk['g_loss']):.5f} vs {float(mp['g_loss']):.5f}"
    )


def grad_errs(got, want, what, check=True):
    """Per tensor (relative L2, max relative) errors of one step's
    gradients, the worst printed before any tolerance is applied (``check``
    False: printed only, as for rounding alone)."""
    errs = []
    for n, w in want.items():
        if w.abs().max() == 0:  # a stage the step does not reach
            continue
        d = (got[n] - w).double()
        errs.append((float(d.norm() / w.double().norm()), float(d.abs().max() / w.abs().max()), n))
    errs.sort(reverse=True)
    print(f"{what}: worst (rel L2, rel max): " + "; ".join(f"{n} {a:.2e} {b:.2e}" for a, b, n in errs[:4]))
    l2_tol, max_tol = STEP_GRAD_TOL
    for e2, em, n in errs:
        require(not check or (e2 <= l2_tol and em <= max_tol),
                f"{what} {n}: relative L2 {e2:.3e}, max {em:.3e} over tol {STEP_GRAD_TOL}")
    return max(e[0] for e in errs), max(e[1] for e in errs)


def training_times(shapes, gen):
    """The stage-8 iteration, bf16, batch 5, no-blend path: ms and images/s
    by CUDA events, and its parts timed alone at the same shapes: K1
    forward (without and with residuals), K2, K3 (with its tile plan, the
    card's time per call, the host's microseconds per call and GB/s), the
    cuDNN conv transposes and the critic phase's loss with R1 and its
    gradient.  Returns K1's with-residuals (emit_hv) and K3's per-shape
    numbers summed (K3's host time: the mean per call)."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.cardcheck import host_us, queued_ms
    from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain
    from byogan_tpu_torch.ops.styleconv import plan_tiles, styleconv_cuda, styleconv_plain
    from byogan_tpu_torch.ops.styleconv_bwd import plan_backward, styleconv_backward_cuda, styleconv_backward_plain
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import critic_loss, draw, make_train_step

    # The card's time per call here is by calls queued back to back
    # (queued_ms), not torch.profiler: after the training phases the
    # profiler drops kernel records (tools/time_k3.py gives K3's split by
    # kernel in a process of its own).
    n, dt, dev = TRAIN_BATCH, torch.bfloat16, torch.device("cuda")
    cfg = TrainConfig()
    state = build_state(cfg, dev)
    state.stage = 8
    real = torch.randint(0, 256, (n, 512, 512, 3), generator=gen, device=dev, dtype=torch.uint8)
    step = make_train_step(cfg, 8, n, 8.0, (False,), False)
    it_ms = timed_ms(lambda: step(state, real), iters=TIMED_ITERS)
    print(f"time train iteration bf16 stage 8 batch {n}: {it_ms:.3f} ms, {1e3 * n / it_ms:.2f} images/s (CUDA events, {TIMED_ITERS} iterations) {math_flags()}")

    parts = {"K1 forward x15, no residuals": 0.0, "K1 forward x15, with residuals": 0.0, "K2 x2": 0.0,
             "K3 x16": 0.0, "cuDNN conv transposes x15": 0.0}
    k1s = {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0}
    k1s_by = {"bytes": 0.0, "operations": 0.0}
    k3 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "device_ms": 0.0, "host_us_per_call": 0.0, "bound_ms": 0.0}
    k3_by = {"bytes": 0.0, "operations": 0.0}
    cases = [(r, cin, cout) for r, cin, cout in shapes] + [(4, None, 512)]
    for r, cin, cout in cases:
        with torch.no_grad():
            if cin is None:
                ins = k2_inputs(n, r, cout, dt, gen)
                parts["K2 x2"] += timed_ms(lambda: noise_lrelu_adain_cuda(**ins)) + timed_ms(
                    lambda: noise_lrelu_adain_cuda(**ins, with_stats=True))
                _, hv, mean, inv = noise_lrelu_adain_plain(**ins, with_stats=True)
            else:
                ins = k1_inputs(n, r, cin, cout, dt, gen)
                no_stats_ms = timed_ms(lambda: styleconv_cuda(**ins))
                t = {
                    "ms": timed_ms(lambda: styleconv_cuda(**ins, with_stats=True)),
                    "plain_ms": timed_ms(lambda: styleconv_plain(**ins, with_stats=True)),
                    "device_ms": queued_ms(lambda: styleconv_cuda(**ins, with_stats=True)),
                }
                t["bound_ms"], by = k1_bound(n, r, cin, cout, 2, with_stats=True)
                k1s_by[by] += t["bound_ms"]
                for key in k1s:
                    k1s[key] += t[key]
                parts["K1 forward x15, no residuals"] += no_stats_ms
                parts["K1 forward x15, with residuals"] += t["ms"]
                print(f"time K1 with_stats bf16 ({n},{r},{r},{cin}->{cout}) " + " ".join(f"{k} {v:.4f}" for k, v in t.items())
                      + f" bound_by {by}; without stats ms {no_stats_ms:.4f}; {plan_tiles(n, r, r, cin, cout).describe()} {math_flags()}")
                _, hv, mean, inv = styleconv_cuda(**ins, with_stats=True)
                x_c, w_c = ins["x"].permute(0, 3, 1, 2), ins["weight"].permute(3, 2, 0, 1)
                d_c = torch.randn((n, r, r, cout), generator=gen, device=dev).to(dt).permute(0, 3, 1, 2)
                parts["cuDNN conv transposes x15"] += timed_ms(
                    lambda: (conv2d_input(x_c.shape, w_c, d_c, padding=1), conv2d_weight(x_c, w_c.shape, d_c, padding=1)))
        dy = torch.randn((n, r, r, cout), generator=gen, device=dev).to(dt)
        args = (dy, hv, mean, inv, ins["gamma"], ins["noise"], ins["noise_w"])
        t = {
            "ms": timed_ms(lambda: styleconv_backward_cuda(*args)),
            "plain_ms": timed_ms(lambda: styleconv_backward_plain(*args)),
            "library_ms": timed_ms(k3_library(*args)),
            "device_ms": queued_ms(lambda: styleconv_backward_cuda(*args)),
            "host_us_per_call": host_us(lambda: styleconv_backward_cuda(*args)),
        }
        t["bound_ms"], by = k3_bound(n, r, cout, 2)
        k3_by[by] += t["bound_ms"]
        for key in k3:
            k3[key] += t[key]
        gbs = 8 * n * r * r * cout / t["device_ms"] / 1e6  # dy, hv read, dpre written: 8 B an element
        print(f"time K3 bf16 ({n},{r},{r},{cout}) " + " ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f" bound_by {by}; {gbs:.1f} GB/s at 8 B an element over device time; plan: {plan_backward(n, r * r, cout).describe()} {math_flags()}")
    parts["K3 x16"] = k3["ms"]
    k3["host_us_per_call"] /= len(cases)  # the mean over the shapes; the times above are sums

    z, noise, _ = draw(state, cfg, n, 8, dt).critic[0]
    with torch.no_grad():
        fake = state.gen(z, noise, steps=8)
    real_f = (real.float() * (2.0 / 255.0) - 1.0).to(dt)
    params = list(state.critic.parameters())

    def critic_r1():
        loss, _ = critic_loss(state, cfg, real_f, fake, 8, None, None)
        return torch.autograd.grad(loss, params, allow_unused=True)

    def input_grad():
        images = real_f.detach().requires_grad_(True)
        pred = state.critic(images, 8, None)
        return torch.autograd.grad(pred.sum(), images, create_graph=True)

    with torch.no_grad():
        fwd_ms = timed_ms(lambda: (state.critic(real_f, 8, None), state.critic(fake, 8, None)), iters=TIMED_ITERS)
    first_ms = timed_ms(input_grad, iters=TIMED_ITERS)
    parts["critic R1 loss + grads"] = timed_ms(critic_r1, iters=TIMED_ITERS)
    print(
        f"time train critic R1 at 512 px, batch {n}, bf16: forward real + fake {fwd_ms:.3f} ms; forward + input "
        f"gradient (create_graph) {first_ms:.3f} ms; whole loss + parameter gradients (the double backward) "
        f"{parts['critic R1 loss + grads']:.3f} ms {math_flags()}"
    )
    rest = it_ms - sum(parts.values())
    for name, ms in parts.items():
        print(f"time train part {name}: {ms:.3f} ms ({100 * ms / it_ms:.1f}% of the iteration) {math_flags()}")
    print(f"time train part rest (critic-phase generator forward glue, generator-phase critic, Adam, launch gaps), by difference: {rest:.3f} ms ({100 * rest / it_ms:.1f}%) {math_flags()}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, real)
        torch.cuda.synchronize()
    print("profiler: top ten ops of one stage-8 iteration by device time")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10))
    return (k1s, max(k1s_by, key=k1s_by.get)), (k3, max(k3_by, key=k3_by.get)), it_ms


def k2_checks(gen):
    """K2 against its plain version at every shape of the path's initial
    block, (1..24, 4, 4, 512), f32 and bf16, with and without residuals; the
    element route at C = 12 and on a view of x off 16 bytes; two runs
    bit-equal.  Returns the largest out error per dtype."""
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain

    def check(tag, ins, want_ins=None):
        err = 0.0
        for stats in (False, True):
            got = noise_lrelu_adain_cuda(**ins, with_stats=stats)
            want = noise_lrelu_adain_plain(**(want_ins or ins), with_stats=stats)
            got, want = (got, want) if stats else ((got,), (want,))
            dtype = ins["x"].dtype
            err = max(err, max_err(got[0], want[0], TOL[dtype]))
            for name, gt, wt in zip(("hv", "mean", "inv"), got[1:], want[1:]):
                rel_err(gt, wt, TOL[dtype] if name == "hv" else 1e-3, f"K2 {tag} {name}")
        return err

    worst = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            worst[dtype] = max(check(f"{dt} ({n},4,4,512)", k2_inputs(n, 4, 512, dtype, gen)) for n in range(1, 25))
            e12 = check(f"{dt} (3,4,4,12)", k2_inputs(3, 4, 12, dtype, gen))
            ins = k2_inputs(5, 4, 512, dtype, gen)
            x = ins["x"]
            shifted = dict(ins, x=torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape))
            require(shifted["x"].data_ptr() % 16 != 0, "the unaligned view is aligned")
            e_view = check(f"{dt} (5,4,4,512) unaligned x", shifted, ins)
            ins = k2_inputs(24, 4, 512, dtype, gen)
            runs = [noise_lrelu_adain_cuda(**ins, with_stats=True) for _ in range(2)]
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(*runs)), f"K2 {dt}: two runs differ")
            print(f"check K2 {dt} path shapes (1..24,4,4,512) with and without residuals: out max_abs_err "
                  f"{worst[dtype]:.3e} tol {TOL[dtype]}*(1+|plain|), residuals hv {TOL[dtype]}, mean/inv 1e-3 "
                  f"relative; element route C = 12 {e12:.3e}; unaligned x {e_view:.3e}; two runs bit-equal")
    return worst


def k2_card_times(ins, gen):
    """K2's card time at ``ins`` with the host out of the way (calls queued
    back to back), beside an empty kernel's (the launch floor) and the
    library composition's, the host's microseconds per call, and the card
    time with residuals at the training shapes (batch 5 and 24)."""
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.cardcheck import host_us, queued_ms

    t = {
        "device_ms": queued_ms(lambda: noise_lrelu_adain_cuda(**ins)),
        "launch_floor_ms": queued_ms(lambda: torch.cuda._sleep(0)),
        "library_device_ms": queued_ms(lambda: k2_library(**ins)),
        "host_us_per_call": host_us(lambda: noise_lrelu_adain_cuda(**ins)),
        "with_stats": {},
    }
    for n in (5, 24):
        ins_n = k2_inputs(n, 4, 512, torch.bfloat16, gen)
        t["with_stats"][f"({n},4,4,512)"] = queued_ms(lambda: noise_lrelu_adain_cuda(**ins_n, with_stats=True))
    return t


SLICE_CONFIG = (
    "[slice]\n"
    "data = {data}\n"
    "epoch_progression = 1,1,1,1,1,1,1,1\n"
    "fade_percentage = 2\n"
    "display_step = 1000\ncheckpoint_step = 1000\nrefresh_stat_step = 1\n"
    "ema_beta = 0.999\nstyle_mix_prob = {mix}\n"
    "checkpoint_dir = {tmp}/slice_ck\noutput_dir = {tmp}/slice_out\n"
)


def slice_training(tmp, root):
    """The slice's training path at full width on the 24 synthetic images,
    EMA (0.999) and style mixing (0.9), all 8 stages at one epoch each:
    ``python -m byogan_tpu_torch.cli.main`` in a subprocess, sent SIGTERM
    once its metrics show stage 5; a resume with another style_mix_prob is
    refused; the resume through the CLI (in this process, counting each
    step's launches) runs to FINAL.pth.  Returns the resumed run's launches
    and FINAL.pth's path."""
    from byogan_tpu_torch.cli.main import main as train_main

    data = os.path.join(tmp, "data")  # written by train_through_cli
    cfg, changed = os.path.join(tmp, "slice.txt"), os.path.join(tmp, "slice_changed.txt")
    for path, mix in ((cfg, 0.9), (changed, 0.5)):
        with open(path, "w") as f:
            f.write(SLICE_CONFIG.format(data=data, mix=mix, tmp=tmp))
    metrics = os.path.join(tmp, "slice_out", "metrics.jsonl")
    log_path = os.path.join(tmp, "slice_run.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "byogan_tpu_torch.cli.main", "slice", "--config-file", cfg],
            cwd=root, stdout=log, stderr=subprocess.STDOUT,
        )
        try:
            stage = 0
            while stage < 5:
                require(proc.poll() is None, f"the training CLI ended (rc {proc.returncode}) before stage 5")
                require(time.perf_counter() - t0 < 600, "no stage-5 metrics within 600 s")
                time.sleep(0.05)
                if os.path.exists(metrics):
                    with open(metrics) as f:
                        stages = [json.loads(line)["stage"] for line in f if line.endswith("\n")]
                    stage = max(stages, default=0)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path) as f:
        out = f.read()
    print(f"slice train: SIGTERM sent at stage {stage}; the CLI exited {rc} after {time.perf_counter() - t0:.2f} s")
    require(rc == 0, f"the training CLI exited {rc} after SIGTERM:\n{out[-3000:]}")
    found = re.search(r"preemption checkpoint saved: (\S+)", out)
    require(found is not None, f"no stop line in the CLI's output:\n{out[-3000:]}")
    ckpt = found.group(1)
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    require(os.path.basename(ckpt) == f"chk-{saved['iter']}.pth", f"stop checkpoint {ckpt}")
    require(saved.get("gen_ema") is not None and saved.get("train_config", {}).get("style_mix_prob") == 0.9,
            "the stop checkpoint lacks gen_ema or train_config")
    print(f"slice train: {found.group(0)} (iteration {saved['iter']}, stage {saved['step']}); it holds gen_ema "
          f"and train_config {saved['train_config']}")
    try:
        train_main(["slice", "--config-file", changed, "-c", ckpt])
    except ValueError as e:
        require("style_mix_prob" in str(e) and "--force-resume" in str(e), f"resume guard message: {e}")
        print("slice train: a resume with style_mix_prob 0.5 is refused without --force-resume")
    else:
        require(False, "a resume with a changed style_mix_prob ran")

    records = []
    zero_launch_counts()
    t0 = time.perf_counter()
    with counting_steps(records):
        state = train_main(["slice", "--config-file", cfg, "-c", ckpt])
    torch.cuda.synchronize()
    launches = dict(zip(KERNEL_NAMES, launch_counts()))
    require(state.iters == 16 and state.gen_ema is not None, f"resumed run ended at {state.iters}")
    for k, _, _, got in records:
        require(got == (2 * (2 * k - 1), 2, 2 * k), f"slice stage {k}: launches per iteration {got}")
    require(all(v > 0 for v in launches.values()), f"a kernel of the slice's training path never ran: {launches}")
    final = os.path.join(tmp, "slice_ck", "FINAL.pth")
    require(torch.load(final, map_location="cpu", weights_only=False).get("gen_ema") is not None, "FINAL without gen_ema")
    stage8 = [got for k, _, _, got in records if k == 8]
    print(f"slice train: resumed to FINAL.pth in {time.perf_counter() - t0:.2f} s, {len(records)} iterations "
          f"(stages {records[0][0]}-8); launches {launches}; per iteration at stage 8 (K1, K2, K3) {stage8}, "
          f"as without mixing")
    return launches, final


def slice_times(gen):
    """The stage-8 iteration (bf16, batch 5, no-blend path) with style
    mixing and EMA against the default config's, in the order default,
    slice, slice, default; and the EMA update's card time (calls queued
    back to back)."""
    from byogan_tpu_torch.ops.cardcheck import queued_ms
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import ema_update, make_train_step

    n, dev = TRAIN_BATCH, torch.device("cuda")
    real = torch.randint(0, 256, (n, 512, 512, 3), generator=gen, device=dev, dtype=torch.uint8)
    configs = {"default": TrainConfig(), "mixing 0.9 + EMA 0.999": TrainConfig(ema_beta=0.999, style_mix_prob=0.9)}
    times = {k: [] for k in configs}
    for name in ("default", "mixing 0.9 + EMA 0.999", "mixing 0.9 + EMA 0.999", "default"):
        cfg = configs[name]
        state = build_state(cfg, dev)
        state.stage = 8
        step = make_train_step(cfg, 8, n, 8.0, (False,), False)
        times[name].append(timed_ms(lambda: step(state, real), iters=TIMED_ITERS))
        if state.gen_ema is not None:
            ema, params = list(state.gen_ema.parameters()), list(state.gen.parameters())
            ema_ms = queued_ms(lambda: ema_update(ema, params, 0.999))
        del state, step
    print(f"time slice stage-8 iteration bf16 batch {n} (CUDA events, {TIMED_ITERS} iterations each, order A B B A): "
          + "; ".join(f"{k} {' '.join(f'{t:.3f}' for t in v)} ms" for k, v in times.items())
          + f"; EMA update {ema_ms:.4f} ms of card time (calls queued back to back) {math_flags()}")


def slice_sampling(tmp, final):
    """The sampling surfaces on the slice's FINAL.pth at 512 px: the EMA
    weights with W-space truncation (psi 0.7) through ``Sampler`` (frames,
    rate, launches), ``Sampler.style_mix``, psi = 1 against no psi on the
    same draws (bit for bit), ``generate_samples --ema --psi`` and the
    style-mix grid CLI at 4 x 4.  Returns the launches of the Sampler's
    frames and mixes."""
    from byogan_tpu_torch.cli.generate_samples import main as generate_main
    from byogan_tpu_torch.cli.style_mix import main as style_mix_main
    from byogan_tpu_torch.data.png import decode_png
    from byogan_tpu_torch.serve import Sampler

    s = Sampler(final, batch=PATH_BATCH, seed=0, use_ema=True, truncation_psi=0.7)
    require(s.resolution == 512, "slice sampler resolution")
    s.sample(PATH_BATCH)  # warm-up; computes the mean w
    torch.cuda.synchronize()
    zero_launch_counts()
    frames = s.sample(FRAMES)
    mixed = s.style_mix(FRAMES, 4)
    launches = dict(zip(KERNEL_NAMES[:2], launch_counts()[:2]))
    batches = 2 * FRAMES // PATH_BATCH
    require(launches == {"styleconv": 15 * batches, "adain": batches}, f"slice sampling launches {launches}")
    for what, f in (("frames", frames), ("style_mix", mixed)):
        require(f.shape == (FRAMES, 512, 512, 3) and str(f.dtype) == "uint8" and f.std() > 0, f"slice {what}")
    t0 = time.perf_counter()
    s.sample(RATE_FRAMES)
    rate = RATE_FRAMES / (time.perf_counter() - t0)
    print(f"sampler: EMA weights, psi 0.7: {rate:.2f} images/s at 512 px over {RATE_FRAMES} frames (batch "
          f"{PATH_BATCH}, bf16, host clock incl. fetch); {FRAMES} frames and style_mix({FRAMES}, 4) launched "
          f"{launches} ({15} K1 / 1 K2 a batch) {math_flags()}")
    one = Sampler(final, batch=PATH_BATCH, seed=5, use_ema=True, truncation_psi=1.0).sample(PATH_BATCH)
    none = Sampler(final, batch=PATH_BATCH, seed=5, use_ema=True).sample(PATH_BATCH)
    require(np.array_equal(one, none), "psi = 1 frames differ from frames without psi")
    print("slice sample: psi = 1 gives the frames of no psi bit for bit (same seed and draws)")
    out = os.path.join(tmp, "slice_gen")
    os.makedirs(out)
    generate_main([final, "2", "-o", out, "--seed", "0", "--ema", "--psi", "0.7"])
    require(sorted(os.listdir(out)) == ["image_1.png", "image_2.png"], "generate_samples --ema --psi output")
    grid_path = os.path.join(tmp, "mix.png")
    style_mix_main([final, "-o", grid_path, "-r", "4", "-c", "4", "--ema", "--psi", "0.7", "--seed", "0"])
    with open(grid_path, "rb") as f:
        grid = decode_png(f.read())
    require(grid.shape == (5 * 514 + 2, 5 * 514 + 2, 3) and grid.std() > 0, f"style-mix grid {grid.shape}")
    print(f"slice sample: generate_samples --ema --psi 0.7 wrote 2 PNGs; cli.style_mix 4x4 grid {grid.shape}")
    return launches


# The W-space and eval slice (projection, SeFa edits, walks, SWD/MS-SSIM).
PROJECT_ITERS, WPLUS_ITERS = 200, 100
# Bars on last/first loss of a projection from the mean w onto a target
# rendered from a known w.  The JAX suite's (tests/test_projector.py:54,
# :72) are 0.1 in W and 0.2 in W+, for its 2-stage model; the card meets
# them at that model (SMALL_PROJECT).  At full width on FINAL.pth's EMA
# weights, W stalls near 0.2 in f32 and bf16 alike, for 400 iterations as
# for 200 and at lr 0.1 as at 0.05 (tools/project_sweep.py; PERF.md): a
# plateau of the barely trained 512 px model, not of the port.  So the
# full-width W bar is set above that trajectory; W+ meets 0.2.
PROJECT_BAR, WPLUS_BAR, SMALL_BAR = 0.25, 0.2, 0.1
SMALL_PROJECT = dict(num_stages=2, channel_divisor=16, mapping_depth=2)
# SWD per level (relative) and MS-SSIM diversity (absolute), card vs CPU on
# the same images and draws: f32 sums in another order.
SWD_TOL, MSSSIM_TOL = 1e-4, 1e-4
EVAL_KEYS = ["kind", "iter", "stage", "swd", "msssim", "swd_ema", "msssim_ema", "msssim_real"]
EVALUATE_KEYS = ["metric", "resolution", "n_images", "resampled", "ema", "truncation", "per_level", "mean",
                 "msssim_diversity"]


@contextlib.contextmanager
def counting_conv_grads(counts: dict):
    """StyleConvFunction's calls of ``conv2d_input`` (dx) and
    ``conv2d_weight`` (dweight), counted into ``counts``."""
    from byogan_tpu_torch.ops import styleconv as sc

    def counted(name):
        real = getattr(sc, name)

        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return real(*args, **kwargs)

        return call

    with mock.patch.object(sc, "conv2d_input", counted("conv2d_input")), \
            mock.patch.object(sc, "conv2d_weight", counted("conv2d_weight")):
        yield


def projection_setup(final, batch, dtype, seed=11):
    """The FINAL checkpoint's EMA generator on the card, a target rendered
    from a known w with the projector's own noise (noise_seed 0), so an
    exact inversion exists, and the mean w."""
    from byogan_tpu_torch.core.random import synthesis_noise, truncated_noise
    from byogan_tpu_torch.projector import synthesize_w
    from byogan_tpu_torch.serve import Sampler

    s = Sampler(final, batch=batch, dtype=dtype, use_ema=True)
    gen = s.generator
    with torch.no_grad():
        w_true = gen.map_latent(truncated_noise(torch.Generator(device="cuda").manual_seed(seed), batch, s.z_dim)).float()
        noise = synthesis_noise(torch.Generator(device="cuda").manual_seed(0), batch, 8)
        target = synthesize_w(gen, w_true, noise, 8, s.alpha)
    return s, target, noise


def project_on_card(final, w_plus, n_iters, bar):
    """A projection at 512 px, batch 2, bf16, from the mean w: launches per
    iteration (K1 15 with residuals, K2 1, K3 16, plus the final render's 15
    K1 and 1 K2), no weight gradient, finite losses, the last below ``bar``
    times the first."""
    from byogan_tpu_torch.projector import project

    s, target, _ = projection_setup(final, 2, "bfloat16")
    counts = {}
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    with counting_conv_grads(counts):
        res = project(s.generator, target, 8, s.z_dim, n_iters=n_iters, lr=0.05, w_plus=w_plus)
        losses = res.losses.cpu().numpy()  # the one fetch
    wall = time.perf_counter() - t0
    got = launch_counts()
    mode = "W+" if w_plus else "W"
    want = (15 * n_iters + 15, n_iters + 1, 16 * n_iters)
    require(got == want, f"project {mode}: launches (K1, K2, K3) {got}, expected {want}")
    require(counts.get("conv2d_weight", 0) == 0, f"project {mode}: {counts.get('conv2d_weight')} weight gradients")
    require(counts.get("conv2d_input", 0) == 15 * n_iters, f"project {mode}: conv2d_input calls {counts}")
    require(bool(np.isfinite(losses).all()) and losses.shape == (n_iters,), f"project {mode}: losses {losses}")
    ratio = float(losses[-1] / losses[0])
    marks = sorted({0, n_iters // 4, n_iters // 2, 3 * n_iters // 4, n_iters - 1})
    err = float((res.image - target).abs().max())
    print(f"project {mode}: 512 px batch 2 bf16, {n_iters} iterations from the mean w in {wall:.2f} s (host clock, "
          f"one loss fetch); launches (K1, K2, K3) {got} = {n_iters} x (15, 1, 16) + the final render's (15, 1, 0); "
          f"conv2d_weight calls 0, conv2d_input {counts['conv2d_input']}; loss at "
          + ", ".join(f"{i}: {losses[i]:.5f}" for i in marks)
          + f"; last/first {ratio:.4f} (bar {bar}); max |recon - target| {err:.4f} {math_flags()}")
    require(ratio < bar, f"project {mode}: last/first loss {ratio:.4f} not below {bar}")
    return dict(zip(KERNEL_NAMES, (15, 1, 16))), ratio


def project_small_on_card():
    """The JAX suite's projection test on the card: its 2-stage model
    (random weights), a target from a known w with the projector's noise,
    200 iterations from the mean w, bf16; last/first loss below 0.1 and
    launches per iteration (K1 3, K2 1, K3 4)."""
    from byogan_tpu_torch.core.random import synthesis_noise
    from byogan_tpu_torch.models.factory import ModelSpec, build_generator
    from byogan_tpu_torch.projector import project, synthesize_w

    gen = build_generator(ModelSpec(**SMALL_PROJECT), dtype=torch.bfloat16, z_dim=16,
                          generator=torch.Generator().manual_seed(0))
    gen.cuda().requires_grad_(False)
    z = torch.randn((2, 16), generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    with torch.no_grad():
        noise = synthesis_noise(torch.Generator(device="cuda").manual_seed(0), 2, 2)
        target = synthesize_w(gen, gen.map_latent(z).float(), noise, 2)
    zero_launch_counts()
    losses = project(gen, target, 2, 16, n_iters=PROJECT_ITERS).losses.cpu().numpy()
    got = launch_counts()
    n = PROJECT_ITERS
    require(got == (3 * n + 3, n + 1, 4 * n), f"small project launches {got}")
    ratio = float(losses[-1] / losses[0])
    print(f"project W at the JAX test's model (2 stages, 8 px, channel_divisor 16, mapping depth 2), bf16, {n} "
          f"iterations: loss {losses[0]:.5f} -> {losses[-1]:.5f}, last/first {ratio:.4f} (bar {SMALL_BAR}); "
          f"launches {got}")
    require(bool(np.isfinite(losses).all()) and ratio < SMALL_BAR, f"small project: last/first {ratio:.4f}")
    return ratio


def project_grad_kernel_vs_plain(final):
    """One projection iteration's gradient with respect to w at 512 px,
    batch 2, f32: the kernel path against the plain path (the plain
    versions swapped into the layers)."""
    from byogan_tpu_torch.models import layers
    from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain
    from byogan_tpu_torch.ops.styleconv import styleconv_plain
    from byogan_tpu_torch.projector import projection_loss

    s, target, noise = projection_setup(final, 2, "float32")
    w0 = s.mean_w().expand(2, -1)
    rng = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    # A third run, the plain path at w moved by float rounding (1e-6
    # relative), measures how far rounding alone moves this gradient.
    for path in ("kernel", "plain", "plain, w moved by 1e-6"):
        moved = path.endswith("1e-6")
        w = (w0 * (1 + 1e-6 * torch.randn(w0.shape, generator=rng, device="cuda")) if moved else w0)
        w = w.clone().requires_grad_(True)
        before = launch_counts()
        with contextlib.ExitStack() as stack:
            if path != "kernel":
                stack.enter_context(mock.patch.object(layers, "styleconv", styleconv_plain))
                stack.enter_context(mock.patch.object(layers, "noise_lrelu_adain", noise_lrelu_adain_plain))
            loss = projection_loss(s.generator, w, target, noise, 8, s.alpha)
            (g,) = torch.autograd.grad(loss, w)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(launch_counts(), before))
        require(launched == ((15, 1, 16) if path == "kernel" else (0, 0, 0)), f"{path} path launched {launched}")
        out[path] = (loss.detach(), g)
    (lk, gk), (lp, gp), (_, gm) = out["kernel"], out["plain"], out["plain, w moved by 1e-6"]
    loss_err = rel_err(lk, lp, STEP_TOL, "projection loss")

    def errs(g):
        d = (g - gp).double()
        return float(d.norm() / gp.double().norm()), float(d.abs().max() / gp.abs().max())

    (l2, mx), (l2_moved, mx_moved) = errs(gk), errs(gm)
    print(f"project f32 dL/dw kernel vs plain path (512 px, batch 2): loss {float(lk):.6f} vs {float(lp):.6f} "
          f"(rel {loss_err:.2e}, tol {STEP_TOL}); gradient relative L2 {l2:.3e}, max {mx:.3e} (tol {STEP_GRAD_TOL}); "
          f"rounding alone (plain, w moved by 1e-6 relative): relative L2 {l2_moved:.3e}, max {mx_moved:.3e}")
    require(l2 <= STEP_GRAD_TOL[0] and mx <= STEP_GRAD_TOL[1], "projection gradient kernel vs plain")
    return l2, mx


def wspace_clis(tmp, final):
    """cli.project on two PNGs of save_stream, cli.edit from one of the
    written latents and from random rows, cli.interpolate -n 3 -p 5 --ema
    --w-space, each at 512 px on the card; checks what each writes."""
    from byogan_tpu_torch.cli.edit import main as edit_main
    from byogan_tpu_torch.cli.interpolate import main as interpolate_main
    from byogan_tpu_torch.cli.project import main as project_main
    from byogan_tpu_torch.data.png import read_png
    from byogan_tpu_torch.serve import Sampler

    src, out = os.path.join(tmp, "wspace_in"), os.path.join(tmp, "wspace_out")
    Sampler(final, batch=2, seed=3, use_ema=True).save_stream(src, 2)
    t0 = time.perf_counter()
    project_main([final, os.path.join(src, "image_1.png"), os.path.join(src, "image_2.png"), "-o", out,
                  "--iters", "20", "--ema"])
    t_project = time.perf_counter() - t0
    require(sorted(os.listdir(out)) == ["image_1-proj.png", "image_1-w.npy", "image_2-proj.png", "image_2-w.npy"],
            f"cli.project wrote {sorted(os.listdir(out))}")
    require(read_png(os.path.join(out, "image_2-proj.png")).shape == (512, 512, 3), "cli.project reconstruction")
    require(np.load(os.path.join(out, "image_1-w.npy")).shape == (512,), "cli.project w")
    sheets = {}
    t0 = time.perf_counter()
    for name, extra, rows in (("proj", ["--w", os.path.join(out, "image_1-w.npy")], 1), ("random", [], 3)):
        path = os.path.join(tmp, f"edit_{name}.png")
        edit_main([final, "-o", path, "--ema"] + extra)
        sheets[name] = read_png(path).shape
        require(sheets[name] == (rows * 514 + 2, 7 * 514 + 2, 3), f"edit sheet {name} {sheets[name]}")
    t_edit = time.perf_counter() - t0
    frames = os.path.join(tmp, "walk")
    t0 = time.perf_counter()
    interpolate_main([final, "-o", frames, "-n", "3", "-p", "5", "--ema", "--w-space"])
    t_walk = time.perf_counter() - t0
    names = sorted(os.listdir(frames), key=lambda f: int(f[6:-4]))
    require(names == [f"image_{e}.png" for e in range(1, 11)], f"cli.interpolate wrote {names}")
    shape = read_png(os.path.join(frames, "image_10.png")).shape
    require(shape == (512, 512, 3), f"walk frame {shape}")
    print(f"wspace cli: project 2 PNGs of save_stream, 20 iterations -> {sorted(os.listdir(out))} in "
          f"{t_project:.2f} s; edit sheets --w (1x7) {sheets['proj']}, random 3x7 {sheets['random']} in "
          f"{t_edit:.2f} s; interpolate -n 3 -p 5 --ema --w-space: 10 frames {shape} in {t_walk:.2f} s")


def evaluate_on_card(tmp, final):
    """cli.evaluate --metric both -n 24 on the synthetic 512 px images: the
    JSON line's schema; then its parts timed alone (sampling, SWD, MS-SSIM)
    and SWD and MS-SSIM on the card against the CPU on the same images and
    draws (TF32 off, and under PyTorch's defaults)."""
    import io

    from byogan_tpu_torch.cli.evaluate import main as evaluate_main
    from byogan_tpu_torch.data.pipeline import open_stage_dataset
    from byogan_tpu_torch.eval.msssim import msssim_diversity
    from byogan_tpu_torch.eval.swd import LevelDraws, level_draws, sliced_wasserstein_distance
    from byogan_tpu_torch.serve import Sampler

    data = os.path.join(tmp, "data")  # written by train_through_cli
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        evaluate_main([final, data, "--metric", "both", "-n", "24", "--ema"])
    t_cli = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]
    out = json.loads(line)
    require(list(out) == EVALUATE_KEYS, f"evaluate keys {list(out)}")
    require(list(out["per_level"]) == ["512", "256", "128", "64", "32", "16"], f"per_level {out['per_level']}")
    require(list(out["msssim_diversity"]) == ["fake", "real", "real_n"] and out["msssim_diversity"]["real_n"] == 24,
            f"msssim_diversity {out['msssim_diversity']}")
    require(out["resolution"] == 512 and not out["resampled"] and math.isfinite(out["mean"]), f"evaluate {out}")
    print(f"evaluate: cli.evaluate --metric both -n 24 --ema in {t_cli:.2f} s: {line}")

    s = Sampler(final, batch=24, seed=0, use_ema=True)
    real = torch.from_numpy(open_stage_dataset(data, 8).get_batch_uint8(np.arange(24))).cuda()
    s.sample_float(24)  # warm-up
    parts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fake = torch.from_numpy(s.sample_float(24)).cuda()
    torch.cuda.synchronize()
    parts["sampling 24 (bf16, incl. fetch and upload)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sliced_wasserstein_distance(real, fake, torch.Generator(device="cuda").manual_seed(0))
    parts["SWD 6 levels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _ = float(msssim_diversity(fake)), float(msssim_diversity(real))
    parts["MS-SSIM fake + real"] = time.perf_counter() - t0
    print("time evaluate parts at 512 px, n 24 (host clock, each ends in a fetch): "
          + "; ".join(f"{k} {v:.3f} s" for k, v in parts.items()) + f" {math_flags()}")

    cpu = torch.Generator().manual_seed(5)
    draws = [level_draws(cpu, 24, 512 >> i) for i in range(6)]
    on_card = [LevelDraws(tuple(t.cuda() for t in d.real_sites), tuple(t.cuda() for t in d.fake_sites),
                          d.directions.cuda()) for d in draws]
    want_swd = sliced_wasserstein_distance(real.cpu(), fake.cpu(), draws=draws)
    want_ms = (float(msssim_diversity(fake.cpu())), float(msssim_diversity(real.cpu())))
    worst = {}
    for flags, ctx in (("TF32 off", strict_f32), ("PyTorch defaults", contextlib.nullcontext)):
        with ctx():
            got_swd = sliced_wasserstein_distance(real, fake, draws=on_card)
            got_ms = (float(msssim_diversity(fake)), float(msssim_diversity(real)))
        swd_err = max(abs(got_swd[k] - want_swd[k]) / abs(want_swd[k]) for k in want_swd)
        ms_err = max(abs(a - b) for a, b in zip(got_ms, want_ms))
        worst[flags] = (swd_err, ms_err)
        print(f"evaluate card vs CPU, same images and draws, {flags} {math_flags()}: SWD per level max rel err "
              f"{swd_err:.2e} (tol {SWD_TOL}; card mean {got_swd[0]:.4f}, CPU {want_swd[0]:.4f}); MS-SSIM "
              f"diversity fake/real max abs err {ms_err:.2e} (tol {MSSSIM_TOL}; card {got_ms}, CPU {want_ms})")
    swd_err, ms_err = worst["TF32 off"]
    require(swd_err <= SWD_TOL and ms_err <= MSSSIM_TOL, "SWD or MS-SSIM on the card disagrees with the CPU")
    return worst


EVAL_CONFIG = (
    "[evalrun]\n"
    "data = {data}\n"
    "epoch_progression = 1,1,1,1,1,1,1,2\n"
    "fade_percentage = 2\n"
    "display_step = 1000\ncheckpoint_step = 1000\nrefresh_stat_step = 1\n"
    "ema_beta = 0.999\nstyle_mix_prob = 0.9\n"
    "eval_step = {eval_step}\neval_images = 16\n"
    "checkpoint_dir = {tmp}/{name}_ck\noutput_dir = {tmp}/{name}_out\n"
)


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` inside,
    the previous setting restored after.  By default cuDNN may pick
    algorithms whose sums run in no fixed order, so two identical training
    runs need not end in equal bits; with this on, they do."""
    prev = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def train_with_eval(tmp, final):
    """Stage 8 through the training CLI from the slice's FINAL.pth, one
    more epoch (iterations 17-20) with ``eval_step = 2`` and ``eval_images
    = 16``, then the same run with ``eval_step = 0``: the eval records'
    keys, the time one eval adds, the training generator's RNG state (the
    eval draws nothing from it) and the final weights of the two runs, bit
    for bit, with deterministic algorithms.  Where they differ, a second
    run without eval shows whether the card's own run-to-run differences
    account for it."""
    from byogan_tpu_torch.cli.main import main as train_main
    from byogan_tpu_torch.train import loop
    from byogan_tpu_torch.train.metrics import read_metrics

    data = os.path.join(tmp, "data")
    eval_ms = []
    real_log_eval = loop.log_eval

    def timed_log_eval(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_log_eval(*args)
        torch.cuda.synchronize()
        eval_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def run(name, eval_step):
        cfg = os.path.join(tmp, f"{name}.txt")
        with open(cfg, "w") as f:
            f.write(EVAL_CONFIG.format(data=data, eval_step=eval_step, name=name, tmp=tmp))
        t0 = time.perf_counter()
        with mock.patch.object(loop, "log_eval", timed_log_eval), deterministic_algorithms():
            state = train_main(["evalrun", "--config-file", cfg, "-c", final, "--force-resume"])
        torch.cuda.synchronize()
        require(state.iters == 20, f"{name}: ended at iteration {state.iters}")
        print(f"train eval: {name}, stage 8, iterations 17-20, eval_step {eval_step}: {time.perf_counter() - t0:.2f} s")
        weights = {}
        for net in ("gen", "gen_ema", "critic"):
            for k, v in getattr(state, net).state_dict().items():
                weights[f"{net}.{k}"] = v.detach().clone()
        return weights, state.rng.get_state()

    with_eval, rng_eval = run("with_eval", 2)
    evals = read_metrics(os.path.join(tmp, "with_eval_out", "metrics.jsonl"), kind="eval")
    require([(r["iter"], r["stage"]) for r in evals] == [(18, 8), (20, 8)], f"eval records {evals}")
    for r in evals:
        require(list(r) == EVAL_KEYS, f"eval record keys {list(r)}")
        require(all(math.isfinite(r[k]) for k in EVAL_KEYS[3:]), f"eval record {r}")
    print(f"train eval: records {evals}; one eval at stage 8 (16 images; SWD and MS-SSIM of the generator and of "
          f"its EMA) took {', '.join(f'{t:.1f}' for t in eval_ms)} ms (host clock, synchronised) {math_flags()}")
    without, rng_plain = run("without_eval", 0)
    require(torch.equal(rng_eval, rng_plain), "the eval changed the training generator's RNG state")
    diff = lambda a, b: max(float((a[k].float() - b[k].float()).abs().max()) for k in a)  # noqa: E731
    cross = diff(with_eval, without)
    if cross == 0.0:
        print("train eval: final generator, EMA and critic weights bit-equal with eval_step 2 and 0 (deterministic "
              "algorithms on); the training RNG state equal")
        return evals, eval_ms, 0.0, None
    again, _ = run("without_eval_again", 0)
    own = diff(without, again)
    print(f"train eval: weights with and without eval differ by at most {cross:.3e}; two runs without eval differ "
          f"by {own:.3e} (the card's run-to-run difference); the training RNG state equal")
    require(own > 0.0, "two runs without eval are bit-equal, but the run with eval differs from them")
    return evals, eval_ms, cross, own


def wspace_times(final):
    """Milliseconds per projection iteration at 512 px, bf16 (CUDA events
    around project(25) and project(5), the difference over 20), batch 1 and
    4, W and W+; then one iteration at batch 1 by torch.profiler (the same
    difference): the card's time by kernel, K1's, K2's and K3's shares, and
    the host's self time by op."""
    from byogan_tpu_torch.projector import project

    rows = []
    for batch in (1, 4):
        s, target, _ = projection_setup(final, batch, "bfloat16")
        w0 = s.mean_w().expand(batch, -1)
        for w_plus in (False, True):
            w_init = w0[:, None, :].expand(batch, 8, -1) if w_plus else w0
            run = lambda n: project(s.generator, target, 8, s.z_dim, n_iters=n, w_init=w_init, w_plus=w_plus)  # noqa: E731
            run(5)
            ms = {}
            for n in (5, 25):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                run(n)
                end.record()
                torch.cuda.synchronize()
                ms[n] = start.elapsed_time(end)
            rows.append((batch, "W+" if w_plus else "W", (ms[25] - ms[5]) / 20))
    print("time project iteration at 512 px bf16 (CUDA events, (project(25) - project(5)) / 20): "
          + "; ".join(f"batch {b} {m} {t:.3f} ms" for b, m, t in rows) + f" {math_flags()}")
    s, target, _ = projection_setup(final, 1, "bfloat16")
    w0 = s.mean_w().expand(1, -1)
    run = lambda n: project(s.generator, target, 8, s.z_dim, n_iters=n, w_init=w0)  # noqa: E731
    traces = [profile_totals(lambda n=n: run(n)) for n in (2, 6)]
    names = set(traces[0][0]) | set(traces[1][0])
    per = {k: (traces[1][0].get(k, (0, 0.0))[1] - traces[0][0].get(k, (0, 0.0))[1]) / 4 for k in names}
    launched = {k: (traces[1][0].get(k, (0, 0.0))[0] - traces[0][0].get(k, (0, 0.0))[0]) / 4 for k in names}
    groups = {"K1": ("conv3x3", "finalize_moments", "affine_apply"), "K2": ("adain",),
              "K3": ("epilogue_sums", "epilogue_apply", "sum_tiles")}
    busy = sum(per.values())
    share = {g: sum(v for k, v in per.items() if any(p in k for p in pats)) for g, pats in groups.items()}
    recorded = {g: launched.get(k, 0.0) for g, k in (("K1", "conv3x3_mma"), ("K3", "epilogue_sums"))}
    recorded["K2"] = sum(v for k, v in launched.items() if "adain" in k)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    host = {k: (traces[1][1].get(k, 0.0) - traces[0][1].get(k, 0.0)) / 4 for k in set(traces[0][1]) | set(traces[1][1])}
    host_top = sorted(host.items(), key=lambda kv: -kv[1])[:6]
    print(f"time project iteration, batch 1 W (profiler, (project(6) - project(2)) / 4): card busy {busy:.3f} ms in "
          f"{sum(launched.values()):.0f} kernels; " + ", ".join(f"{g} {v:.4f} ms ({100 * v / busy:.1f}%)" for g, v in share.items())
          + f"; recorded a iteration: K1 conv3x3_mma {recorded['K1']:.2f}, K2 {recorded['K2']:.2f}, K3 epilogue_sums "
          f"{recorded['K3']:.2f} (15, 1, 16 launched; fewer: the profiler dropped records); largest: "
          + ", ".join(f"{k} {v:.3f}" for k, v in top) + "; host self CPU ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in host_top) + f" {math_flags()}")
    return rows, (busy, share)


# The augmentation, ADA and path-length regularization slice.
REG_CONFIG = (
    "[reg]\n"
    "data = {data}\n"
    "epoch_progression = 1,1,1,1,1,1,1,1\n"
    "fade_percentage = 2\n"
    "display_step = 1000\ncheckpoint_step = 1000\nrefresh_stat_step = 1\n"
    "ada_target = 0.6\nplr_weight = 2.0\nplr_interval = 4\n"
    "checkpoint_dir = {tmp}/reg_ck\noutput_dir = {tmp}/reg_out\n"
)
# The subprocess trains iterations 0-11 (stages 1-7) and stops with
# chk-12.pth; the resume trains stage 8 (iterations 12-15).  Penalized:
# iterations 0, 4, 8 and 12 (plr_interval 4).
REG_STOP, REG_TARGET, REG_INTERVAL = 12, 0.6, 4
SECOND_DERIVATIVE = "plr second derivative"  # the profiler's label of its torch ops


def iteration_launches(stage: int, penalized: bool) -> tuple:
    """(K1, K2, K3) launches of one iteration at ``stage``: the default
    2(2k-1), 2, 2k; a penalized iteration adds PLR's forward with residuals
    (K1 2k-1, K2 1), K3 for each Function in its inner gradient (2k), and
    K3 again in the outer backward through that forward for every Function
    but the last (2k-1): the last one's output reaches the image only
    through to_rgb, which is linear, so the inner gradient does not depend
    on it and the outer backward does not reach its Function."""
    k1, k2, k3 = 2 * (2 * stage - 1), 2, 2 * stage
    return (k1 + 2 * stage - 1, k2 + 1, k3 + 4 * stage - 1) if penalized else (k1, k2, k3)


def second_derivative_checks(shapes, gen):
    """Both Functions' first derivative (K3, run under create_graph by the
    backward Functions) and second derivative (autograd of the plain
    forward, recomputed) against autograd's of the plain forward at the 16
    stage-8 epilogue shapes, batch 2, f32 and bf16.  Beside each, rounding
    alone: the plain path's second derivative at inputs moved by 1e-6
    relative (f32), or computed in f32 from the same bf16 inputs (bf16).
    Returns the worst errors per dtype."""
    from byogan_tpu_torch.ops.cardcheck import second_derivatives
    from byogan_tpu_torch.ops.fused import NoiseLReLUAdaINFunction, noise_lrelu_adain_plain
    from byogan_tpu_torch.ops.styleconv import StyleConvFunction, styleconv_cuda, styleconv_plain

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-12)

    out = {}
    cases = [("K1", r, cin, cout) for r, cin, cout in shapes] + [("K2", 4, 512, 512)]
    for dtype in (torch.float32, torch.bfloat16):
        worst = {"first": 0.0, "second": 0.0, "rounding alone": 0.0}
        for kind, r, cin, cout in cases:
            if kind == "K1":
                ins = k1_inputs(2, r, cin, cout, dtype, gen)
                with torch.no_grad():
                    positive = styleconv_cuda(**ins, with_stats=True)[1] >= 0
                fn = lambda *a: StyleConvFunction.apply(*a, 1e-8)  # noqa: E731
                plain = lambda *a, m=positive: styleconv_plain(*a, positive=m)  # noqa: E731
            else:
                ins = k2_inputs(2, r, cout, dtype, gen)
                fn, plain = (lambda *a: NoiseLReLUAdaINFunction.apply(*a, 1e-8)), noise_lrelu_adain_plain
            tag = f"{kind} {str(dtype)[6:]} (2,{r},{r},{cin}->{cout})"
            before = launch_counts()
            kf, ks = second_derivatives(fn, ins, 1)
            torch.cuda.synchronize()
            launched = tuple(a - b for a, b in zip(launch_counts(), before))
            require(launched == ((1, 0, 1) if kind == "K1" else (0, 1, 1)), f"{tag}: launches {launched}")
            pf, ps = second_derivatives(plain, ins, 1)
            if dtype == torch.float32:
                moved = {k: v if k == "noise" else v * (1 + 1e-6 * torch.randn(v.shape, generator=gen, device="cuda"))
                         for k, v in ins.items()}
            else:
                moved = {k: v.float() for k, v in ins.items()}
            _, ms = second_derivatives(plain, moved, 1)
            errs = {
                "first": max(rel_err(a, b, GRAD_TOL[dtype], f"{tag} first derivative {i}") for i, (a, b) in enumerate(zip(kf, pf))),
                "second": max(rel_err(a, b, GRAD_TOL[dtype], f"{tag} second derivative {i}") for i, (a, b) in enumerate(zip(ks, ps))),
                "rounding alone": max(rel(a, b) for a, b in zip(ms, ps)),
            }
            print(f"check second derivative {tag}: max rel err first (K3) {errs['first']:.3e}, second {errs['second']:.3e} "
                  f"(tol {GRAD_TOL[dtype]}); rounding alone (plain, inputs "
                  f"{'moved by 1e-6' if dtype == torch.float32 else 'in f32'}) {errs['rounding alone']:.3e}; launches {launched}")
            worst = {k: max(worst[k], errs[k]) for k in worst}
        out[dtype] = worst
    return out


def counted_cli(out_path: str, argv: list) -> int:
    """The training CLI with every step counted (``counting_steps``): runs
    ``byogan_tpu_torch.cli.main.main(argv)`` and writes the steps' records
    to ``out_path`` as JSON.  ``regularized_training`` runs it in a
    subprocess."""
    from byogan_tpu_torch.cli.main import main as train_main

    records, regularized = [], []
    zero_launch_counts()
    with counting_steps(records, regularized):
        train_main(argv)
    with open(out_path, "w") as f:
        json.dump(regularized, f)
    return 0


def check_regularized_steps(regs: list, start_aug_p: float, what: str) -> int:
    """Per recorded step: finite losses; launches as ``iteration_launches``;
    on penalized iterations pl_penalty > 0 and pl_ema moved, else 0 and
    unchanged; aug_p exactly the controller applied to the step before, in
    f32 (each step moves it by +-batch/ada_speed, clipped to [0, 1]).
    Returns the number of steps that started with aug_p inside (0, 1)."""
    from byogan_tpu_torch.train.config import TrainConfig

    speed = TrainConfig().ada_speed  # the slice's configs keep the default
    prev, inside = torch.tensor(start_aug_p, dtype=torch.float32), 0
    for r in regs:
        it, k = r["iters"], r["stage"]
        pen = it % REG_INTERVAL == 0
        require(math.isfinite(r["c_loss"]) and math.isfinite(r["g_loss"]), f"{what} iteration {it}: losses {r}")
        require(tuple(r["launches"]) == iteration_launches(k, pen), f"{what} iteration {it} stage {k}: launches {r['launches']}")
        require(r["before"]["aug_p"] == float(prev), f"{what} iteration {it}: aug_p before {r['before']['aug_p']} vs {float(prev)}")
        if pen:
            require(r["pl_penalty"] > 0 and r["pl_ema"] != r["before"]["pl_ema"] and r["pl_ema"] > 0,
                    f"{what} iteration {it}: pl_penalty {r['pl_penalty']}, pl_ema {r['before']['pl_ema']} -> {r['pl_ema']}")
        else:
            require(r["pl_penalty"] == 0 and r["pl_ema"] == r["before"]["pl_ema"], f"{what} iteration {it}: plain but {r}")
        rt = torch.tensor(r["rt_ema"], dtype=torch.float32)
        want = (prev + torch.sign(rt - REG_TARGET) * (r["batch"] / float(speed))).clamp(0.0, 1.0)
        require(float(want) == r["aug_p"], f"{what} iteration {it}: aug_p {r['aug_p']!r}, controller gives {float(want)!r}")
        inside += 0.0 < float(prev) < 1.0
        prev = torch.tensor(r["aug_p"], dtype=torch.float32)
    return inside


def regularized_training(tmp, root):
    """The slice's training CLI at full width on the 24 synthetic images with
    ADA (target 0.6) and PLR (weight 2, interval 4), all 8 stages at one
    epoch each: iterations 0-11 through the CLI in a subprocess
    (``counted_cli``, --max-iters 12), then the resume from its chk-12.pth
    in this process through stage 8 (iterations 12-15) to FINAL.pth.  Checks
    every step (``check_regularized_steps``), that chk-12.pth and FINAL.pth
    hold aug_p, rt_ema and pl_ema, and that the resume starts from them.
    Returns the resumed run's launches, its launches per penalized and per
    plain stage-8 iteration, and the walls."""
    from byogan_tpu_torch.cli.main import main as train_main
    from byogan_tpu_torch.train.checkpoint import REGULARIZER_KEYS

    data = os.path.join(tmp, "data")  # written by train_through_cli
    cfg = os.path.join(tmp, "reg.txt")
    with open(cfg, "w") as f:
        f.write(REG_CONFIG.format(data=data, tmp=tmp))
    counts = os.path.join(tmp, "reg_counts.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.counted_cli(sys.argv[1], sys.argv[2:]))",
         counts, "reg", "--config-file", cfg, "--max-iters", str(REG_STOP)],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    sub_wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"the regularized training CLI exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(counts) as f:
        first = json.load(f)
    require([r["iters"] for r in first] == list(range(REG_STOP)), f"subprocess iterations {[r['iters'] for r in first]}")
    inside = check_regularized_steps(first, 0.0, "reg train (subprocess)")
    require(first[0]["pl_ema"] > 0, "pl_ema after the first penalized iteration")
    ckpt = os.path.join(tmp, "reg_ck", f"chk-{REG_STOP}.pth")
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    held = {k: saved.get(k) for k in REGULARIZER_KEYS}
    require(held == {k: first[-1][k] for k in REGULARIZER_KEYS}, f"chk-{REG_STOP}.pth holds {held}, the last step {first[-1]}")
    print(f"reg train: the CLI in a subprocess, stages 1-7, {len(first)} iterations in {sub_wall:.2f} s (process start "
          f"included); launches per iteration (K1, K2, K3) " + ", ".join(f"it {r['iters']} st {r['stage']} {tuple(r['launches'])}" for r in first)
          + f"; pl_ema after iterations 0/4/8 {[round(first[i]['pl_ema'], 5) for i in (0, 4, 8)]}; chk-{REG_STOP}.pth holds {held}")
    records, regs = [], []
    zero_launch_counts()
    t0 = time.perf_counter()
    with counting_steps(records, regs):
        state = train_main(["reg", "--config-file", cfg, "-c", ckpt])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(KERNEL_NAMES, launch_counts()))
    require(state.iters == 16 and [r["iters"] for r in regs] == [12, 13, 14, 15], f"resumed iterations {[r['iters'] for r in regs]}")
    require(regs[0]["before"] == held, f"the resume started from {regs[0]['before']}, the checkpoint holds {held}")
    inside += check_regularized_steps(regs, held["aug_p"], "reg train (resume)")
    final = torch.load(os.path.join(tmp, "reg_ck", "FINAL.pth"), map_location="cpu", weights_only=False)
    require(all(final.get(k) == regs[-1][k] for k in REGULARIZER_KEYS), "FINAL.pth lacks the regularizers' state")
    per_iteration = {"penalized": tuple(regs[0]["launches"]), "plain": tuple(regs[1]["launches"])}
    every = first + regs
    print(f"reg train: resumed from chk-{REG_STOP}.pth to FINAL.pth in this process, stage 8, iterations 12-15 in "
          f"{wall:.2f} s; launches {launches}; per iteration at stage 8 (K1, K2, K3): penalized (it 12) "
          f"{per_iteration['penalized']}, plain {per_iteration['plain']}; losses finite; aug_p "
          + ", ".join(f"{r['aug_p']:.8g}" for r in every) + f" (rt_ema " + ", ".join(f"{r['rt_ema']:.4f}" for r in every)
          + f"): the controller's exact step at every iteration, {inside} of 16 starting inside (0, 1); pl_ema "
          + ", ".join(f"{r['pl_ema']:.5f}" for r in every) + "; FINAL.pth holds aug_p, rt_ema, pl_ema")
    return launches, per_iteration, sub_wall, wall


def regularized_step_kernel_vs_plain(critic_biases: bool = True):
    """One stage-8 step at full width in f32 on a penalized iteration with
    augmentation on (aug_p 0.5 under ADA 0.6, PLR weight 2): the kernel
    path against the plain path (the plain versions swapped into the
    layers), the same draws and batch; a third run, the plain path with
    every latent moved by 1e-6 relative, gives rounding alone.  Losses,
    pl_penalty, pl_ema, the controller's step and both phases' parameter
    gradients, held to ``STEP_TOL`` and ``STEP_GRAD_TOL``.

    The generator's noise weights and, with ``critic_biases``, the critic's
    biases are drawn from normals first: both start at zero, and a zero
    critic bias puts the whole of a cutout's zero square on LeakyReLU's
    kink in every critic layer, where the sign of cuDNN's rounding picks
    the slope (1 or 0.2) and so the critic's bias gradients: there, moving
    the latents by 1e-6 moves them by ~8%.  ``critic_biases=False`` runs
    that fresh critic and only prints the errors beside rounding alone."""
    import dataclasses
    import types

    from byogan_tpu_torch.models import layers
    from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain
    from byogan_tpu_torch.ops.styleconv import styleconv_plain
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import draw, make_train_step

    cfg = TrainConfig(compute_dtype="float32", aug_p=0.5, ada_target=REG_TARGET, plr_weight=2.0, plr_interval=REG_INTERVAL)
    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(5)
    draws = draw(types.SimpleNamespace(rng=rng, iters=0), cfg, TRAIN_BATCH, 8, torch.float32)
    require(draws.plr is not None and len(draws.aug) == 3, "the penalized iteration's draws")
    real = torch.randint(0, 256, (TRAIN_BATCH, 512, 512, 3), generator=rng, device=dev, dtype=torch.uint8)

    def move(z):
        return z * (1 + 1e-6 * torch.randn(z.shape, generator=rng, device=dev))

    moved = dataclasses.replace(
        draws, critic=[(move(z), n, e) for z, n, e in draws.critic], gen=(move(draws.gen[0]), draws.gen[1]),
        plr=dataclasses.replace(draws.plr, z=move(draws.plr.z)),
    )
    step = make_train_step(cfg, 8, TRAIN_BATCH, 8.0, (True,), True)
    out = {}
    for path, d in (("kernel", draws), ("plain", draws), ("plain, latents moved by 1e-6", moved)):
        state = build_state(cfg, dev)
        with torch.no_grad():
            for net, pick, std in ((state.gen, "inject_noise", 0.3), (state.critic, "bias" if critic_biases else None, 0.1)):
                for name, p in net.named_parameters():
                    if pick is not None and pick in name:
                        p.normal_(0.0, std, generator=torch.Generator(device=dev).manual_seed(len(name)))
        before = launch_counts()
        with contextlib.ExitStack() as stack:
            if path != "kernel":
                stack.enter_context(mock.patch.object(layers, "styleconv", styleconv_plain))
                stack.enter_context(mock.patch.object(layers, "noise_lrelu_adain", noise_lrelu_adain_plain))
            metrics = step(state, real, d)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(launch_counts(), before))
        require(launched == (iteration_launches(8, True) if path == "kernel" else (0, 0, 0)), f"{path} path launched {launched}")
        out[path] = ({k: v.detach().clone() for k, v in metrics.items()},
                     {n: p.grad.clone() for n, p in state.gen.named_parameters()},
                     {n: p.grad.clone() for n, p in state.critic.named_parameters()})
        del state
    (mk, gk, ck), (mp, gp, cp), (mm, gm, cm) = out["kernel"], out["plain"], out["plain, latents moved by 1e-6"]
    what = "regularized step" + ("" if critic_biases else ", critic biases zero")
    keys = ("c_loss", "g_loss", "r1_penalty", "real_pred", "fake_pred", "pl_penalty", "pl_ema", "aug_p", "rt_ema")
    loss_round = max(abs(float(mm[k]) - float(mp[k])) / max(abs(float(mp[k])), 1e-12) for k in keys)
    gr = grad_errs(gm, gp, f"{what} gen grad, rounding alone (plain, latents moved by 1e-6)", check=False)
    cr = grad_errs(cm, cp, f"{what} critic grad, rounding alone (plain, latents moved by 1e-6)", check=False)
    loss_err = max(rel_err(mk[k], mp[k], STEP_TOL if critic_biases else math.inf, f"{what} {k}") for k in keys)
    # aug_p starts inside (0, 1): one controller step of exactly batch/ada_speed
    moved_p = (torch.tensor(0.5) + torch.sign(mk["rt_ema"].cpu() - REG_TARGET) * (TRAIN_BATCH / float(cfg.ada_speed))).clamp(0.0, 1.0)
    require(float(mk["aug_p"]) == float(moved_p) and float(mk["aug_p"]) != 0.5, f"aug_p {float(mk['aug_p'])!r} after one step")
    g_l2, g_max = grad_errs(gk, gp, f"{what} gen grad", check=critic_biases)
    c_l2, c_max = grad_errs(ck, cp, f"{what} critic grad", check=critic_biases)
    print(f"step f32 stage 8 penalized, aug_p 0.5, {'critic biases N(0, 0.1)' if critic_biases else 'critic biases zero (not held)'}, "
          f"kernel vs plain path: losses and regularizers max rel err {loss_err:.3e} "
          f"(tol {STEP_TOL}; rounding alone {loss_round:.3e}); aug_p 0.5 -> {float(mk['aug_p']):.9f} (rt_ema "
          f"{float(mk['rt_ema']):.4f}: one step of {TRAIN_BATCH}/{cfg.ada_speed}); pl_penalty {float(mk['pl_penalty']):.6f} vs "
          f"{float(mp['pl_penalty']):.6f}; g_loss {float(mk['g_loss']):.5f} vs {float(mp['g_loss']):.5f}; generator grads "
          f"relative L2 {g_l2:.3e}, max {g_max:.3e} (rounding alone {gr[0]:.3e}, {gr[1]:.3e}); critic grads relative L2 "
          f"{c_l2:.3e}, max {c_max:.3e} (rounding alone {cr[0]:.3e}, {cr[1]:.3e}) (tol {STEP_GRAD_TOL})")
    return loss_err, (g_l2, g_max), (c_l2, c_max)


@contextlib.contextmanager
def timed_second_derivative(pairs: list):
    """Both backward Functions' second derivatives
    (``epilogue_double_backward``) inside a profiler range named
    ``SECOND_DERIVATIVE`` and between two CUDA events each, appended to
    ``pairs``."""
    from byogan_tpu_torch.ops import fused, styleconv

    real = styleconv.epilogue_double_backward

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(SECOND_DERIVATIVE):
            start.record()
            got = real(*args)
            end.record()
        pairs.append((start, end))
        return got

    with mock.patch.object(styleconv, "epilogue_double_backward", timed), \
            mock.patch.object(fused, "epilogue_double_backward", timed):
        yield


def regularized_times(gen):
    """The stage-8 iteration (bf16, batch 5, no-blend path) by CUDA events
    under the default config, under ADA (target 0.6, aug_p from 0: the
    augmentation runs whatever p is) and as a penalized PLR iteration
    (weight 2, interval 1: every iteration penalized), in the order A B C
    C B A; then one penalized iteration by torch.profiler: the card's busy
    time, its ten largest kernels, the kernels launched, and the share of
    the second derivative's torch ops (the profiler's range, and CUDA
    events around its calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from byogan_tpu_torch.ops.cardcheck import KERNELS
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import make_train_step

    n, dev = TRAIN_BATCH, torch.device("cuda")
    real = torch.randint(0, 256, (n, 512, 512, 3), generator=gen, device=dev, dtype=torch.uint8)
    configs = {"default": TrainConfig(), "ADA 0.6": TrainConfig(ada_target=REG_TARGET),
               "PLR 2.0 penalized": TrainConfig(plr_weight=2.0, plr_interval=1)}
    times = {k: [] for k in configs}
    for name in ("default", "ADA 0.6", "PLR 2.0 penalized", "PLR 2.0 penalized", "ADA 0.6", "default"):
        cfg = configs[name]
        state = build_state(cfg, dev)
        state.stage = 8
        step = make_train_step(cfg, 8, n, 8.0, (False,), False)
        times[name].append(timed_ms(lambda: step(state, real), iters=TIMED_ITERS))
        del state, step
    print(f"time reg stage-8 iteration bf16 batch {n} (CUDA events, {TIMED_ITERS} iterations each, order A B C C B A): "
          + "; ".join(f"{k} {' '.join(f'{t:.3f}' for t in v)} ms" for k, v in times.items()) + f" {math_flags()}")
    cfg = configs["PLR 2.0 penalized"]
    state = build_state(cfg, dev)
    state.stage = 8
    step = make_train_step(cfg, 8, n, 8.0, (False,), False)
    step(state, real)
    torch.cuda.synchronize()
    pairs = []
    with timed_second_derivative(pairs), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, real)
        torch.cuda.synchronize()
    events_ms = sum(a.elapsed_time(b) for a, b in pairs)
    card = {}
    ranged = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            name = next((k for k in KERNELS if k in e.name), e.name[:60])
            count, ms = card.get(name, (0, 0.0))
            card[name] = (count + 1, ms + e.device_time_total / 1e3)
        elif e.device_type == DeviceType.CPU and e.name == SECOND_DERIVATIVE:
            ranged += e.device_time_total / 1e3
    busy = sum(ms for _, ms in card.values())
    launched = sum(c for c, _ in card.values())
    top = sorted(card.items(), key=lambda kv: -kv[1][1])[:10]
    ours = {g: sum(ms for k, (_, ms) in card.items() if any(p in k for p in pats))
            for g, pats in (("K1", ("conv3x3", "finalize_moments", "affine_apply")), ("K2", ("adain",)),
                            ("K3", ("epilogue_sums", "epilogue_apply", "sum_tiles")))}
    print(f"time reg penalized PLR iteration, stage 8 bf16 batch {n} (profiler): card busy {busy:.3f} ms in {launched} "
          f"kernels; the second derivative's torch ops ({len(pairs)} calls): {ranged:.3f} ms of card time in the "
          f"profiler's range ({100 * ranged / busy:.1f}% of busy), {events_ms:.3f} ms between CUDA events around its calls; "
          + ", ".join(f"{g} {v:.3f} ms" for g, v in ours.items()) + "; ten largest kernels: "
          + "; ".join(f"{k} x{c} {ms:.3f} ms" for k, (c, ms) in top) + f" {math_flags()}")
    return times, {"busy_ms": busy, "kernels": launched, "second_derivative_ms": ranged, "second_derivative_event_ms": events_ms}


def profile_totals(fn):
    """One traced fn() after a warm-up call: per kernel on the card (short
    name as in ``cardcheck.KERNELS``) its launches and ms, and per host op
    its self CPU ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from byogan_tpu_torch.ops.cardcheck import KERNELS

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    card, host = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):  # a range over kernels, not one
                continue
            name = next((k for k in KERNELS if k in e.name), e.name[:30])
            count, ms = card.get(name, (0, 0.0))
            card[name] = (count + 1, ms + e.device_time_total / 1e3)
        elif e.self_cpu_time_total > 0:
            host[e.name[:40]] = host.get(e.name[:40], 0.0) + e.self_cpu_time_total / 1e3
    return card, host


# The remat, dataset-preparation, serving-program and trace slice.
REMAT_CONFIG = (
    "[remat]\n"
    "data = {data}\n"
    "epoch_progression = 1,1,1,1,1,1,1,1\n"
    "fade_percentage = 2\n"
    "display_step = 1000\ncheckpoint_step = 1000\nrefresh_stat_step = 1\n"
    "remat_progression = False,False,False,False,False,False,True,False\n"
    "checkpoint_dir = {tmp}/remat_ck\noutput_dir = {tmp}/remat_out\n"
)
REMAT_STAGE = 7  # [ffhq-tpu-tuned]'s remat_progression flags stage 7 (256 px), at batch 128
PREP_ORIGINALS, PREP_SIDE = 16, 1024
PROGRAM_FRAMES = 128  # frames timed per sampler in the serving-program phase


@contextlib.contextmanager
def phase(name: str):
    """Prints the wall time of the phase inside."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s of wall time")


def remat_launches(stage: int, penalized: bool = False) -> tuple:
    """(K1, K2, K3) launches of one remat iteration at ``stage``: the
    default's, and the generator phase's forward once more in its backward
    (K1 2k-1, K2 1): the recompute runs up to the last activation the
    backward needs, to_rgb's input, so every synthesis conv runs again; K3
    as without remat.  A penalized iteration also recomputes PLR's
    synthesis in each of its two backwards, the inner gradient's and the
    parameter gradient's (K1 2(2k-1), K2 2 more)."""
    k1, k2, k3 = iteration_launches(stage, penalized)
    extra = (2 * stage - 1, 1) if not penalized else (3 * (2 * stage - 1), 3)
    return (k1 + extra[0], k2 + extra[1], k3)


def _step_outcome(cfg, draws, real, critic_biases):
    """One stage-8 step of ``cfg`` on the kernel path from a fresh state
    (noise weights and, with ``critic_biases``, the critic's biases drawn
    as in ``regularized_step_kernel_vs_plain``): its metrics, both nets'
    gradients and the (K1, K2, K3) launches."""
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda")
    state = build_state(cfg, dev)
    with torch.no_grad():
        for net, pick, std in ((state.gen, "inject_noise", 0.3), (state.critic, "bias" if critic_biases else None, 0.1)):
            for name, p in net.named_parameters():
                if pick is not None and pick in name:
                    p.normal_(0.0, std, generator=torch.Generator(device=dev).manual_seed(len(name)))
    step = make_train_step(cfg, 8, TRAIN_BATCH, 8.0, (True,), True)
    before = launch_counts()
    metrics = step(state, real, draws)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(launch_counts(), before))
    out = ({k: v.detach().clone() for k, v in metrics.items()}, {n: p.grad.clone() for n, p in state.gen.named_parameters()},
           {n: p.grad.clone() for n, p in state.critic.named_parameters()}, launched)
    del state
    return out


def remat_step_checks():
    """One stage-8 f32 step with ``remat=True`` against the same step
    without it, same weights, draws and batch, on the kernel path: the
    default step, and a penalized PLR + ADA step at aug_p 0.5 (the setup of
    ``regularized_step_kernel_vs_plain``).  Beside each, rounding alone:
    the step without remat on latents moved by 1e-6.  Losses within
    ``STEP_TOL``, gradients within ``STEP_GRAD_TOL``; launches as
    ``remat_launches``.  Returns the launches and the worst errors."""
    import dataclasses
    import types

    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.steps import draw

    dev = torch.device("cuda")
    out = {}
    for what, knobs, biases in (
        ("default", {}, False),
        ("penalized PLR 2.0 + ADA, aug_p 0.5", dict(aug_p=0.5, ada_target=REG_TARGET, plr_weight=2.0, plr_interval=REG_INTERVAL), True),
    ):
        cfg = TrainConfig(compute_dtype="float32", **knobs)
        rng = torch.Generator(device=dev).manual_seed(7)
        draws = draw(types.SimpleNamespace(rng=rng, iters=0), cfg, TRAIN_BATCH, 8, torch.float32)
        real = torch.randint(0, 256, (TRAIN_BATCH, 512, 512, 3), generator=rng, device=dev, dtype=torch.uint8)

        def move(z):
            return z * (1 + 1e-6 * torch.randn(z.shape, generator=rng, device=dev))

        moved = dataclasses.replace(
            draws, critic=[(move(z), n, e) for z, n, e in draws.critic], gen=(move(draws.gen[0]), draws.gen[1]),
            plr=None if draws.plr is None else dataclasses.replace(draws.plr, z=move(draws.plr.z)),
        )
        pen = draws.plr is not None
        t0 = time.perf_counter()
        mp, gp, cp, lp = _step_outcome(cfg, draws, real, biases)
        mr, gr, cr, lr = _step_outcome(dataclasses.replace(cfg, remat=True), draws, real, biases)
        mm, gm, cm, _ = _step_outcome(cfg, moved, real, biases)
        wall = time.perf_counter() - t0
        require(lp == iteration_launches(8, pen), f"remat check {what}: the step without remat launched {lp}")
        require(lr == remat_launches(8, pen), f"remat check {what}: the remat step launched {lr}, predicted {remat_launches(8, pen)}")
        keys = [k for k in mp if k in ("c_loss", "g_loss", "r1_penalty", "real_pred", "fake_pred", "pl_penalty", "pl_ema", "aug_p", "rt_ema")]
        loss_round = max(abs(float(mm[k]) - float(mp[k])) / max(abs(float(mp[k])), 1e-12) for k in keys)
        g_round = grad_errs(gm, gp, f"remat check {what}: gen grad, rounding alone (no remat, latents moved by 1e-6)", check=False)
        c_round = grad_errs(cm, cp, f"remat check {what}: critic grad, rounding alone (no remat, latents moved by 1e-6)", check=False)
        loss_err = max(rel_err(mr[k], mp[k], STEP_TOL, f"remat check {what} {k}") for k in keys)
        g_err = grad_errs(gr, gp, f"remat check {what}: gen grad, remat vs not")
        c_err = grad_errs(cr, cp, f"remat check {what}: critic grad, remat vs not")
        print(f"check remat step f32 stage 8 {what}, remat vs not: losses max rel err {loss_err:.3e} (tol {STEP_TOL}; "
              f"rounding alone {loss_round:.3e}); generator grads relative L2 {g_err[0]:.3e}, max {g_err[1]:.3e} (rounding "
              f"alone {g_round[0]:.3e}, {g_round[1]:.3e}); critic grads {c_err[0]:.3e}, {c_err[1]:.3e} (rounding alone "
              f"{c_round[0]:.3e}, {c_round[1]:.3e}) (tol {STEP_GRAD_TOL}); launches (K1, K2, K3) remat {lr}, without {lp}; "
              f"three steps {wall:.2f} s")
        out[what] = {"launches": lr, "loss_err": loss_err, "grad_err": (g_err, c_err)}
    return out


def remat_through_cli(tmp):
    """All 8 stages through the training CLI on the 24 synthetic images with
    ``[ffhq-tpu-tuned]``'s ``remat_progression`` (stage 7 only): launches
    per iteration asserted at every iteration, ``remat_launches`` at stage
    7 and the default's elsewhere.  Returns the run's launches and the
    stage-7 iteration's."""
    from byogan_tpu_torch.cli.main import main as train_main

    cfg = os.path.join(tmp, "remat.txt")
    with open(cfg, "w") as f:
        f.write(REMAT_CONFIG.format(data=os.path.join(tmp, "data"), tmp=tmp))
    records = []
    zero_launch_counts()
    t0 = time.perf_counter()
    with counting_steps(records):
        state = train_main(["remat", "--config-file", cfg])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(KERNEL_NAMES, launch_counts()))
    require(state.iters == 16 and len(records) == 16, f"remat run: iterations {state.iters}, steps {len(records)}")
    for k, _, _, got in records:
        want = remat_launches(k) if k == REMAT_STAGE else iteration_launches(k, False)
        require(got == want, f"remat run stage {k}: launches per iteration {got}, predicted {want}")
    per_stage = {k: got for k, _, _, got in records}
    print(f"remat train: 8 stages through the CLI with remat_progression {'F,' * 6}T,F, {state.iters} iterations in "
          f"{wall:.2f} s; launches {launches}; per iteration (K1, K2, K3) by stage {per_stage}: stage {REMAT_STAGE} "
          f"{remat_launches(REMAT_STAGE)} as predicted, the others the default's")
    return launches, per_stage[REMAT_STAGE]


def remat_memory_and_time(gen):
    """Peak allocated memory and ms per iteration (CUDA events, PyTorch's
    default math flags), bf16, no-blend path, with and without remat: at
    stage 7, batch 128 (``[ffhq-tpu-tuned]``'s remat stage and batch) and
    at stage 8, batch 5 (the default schedule's).  A run without remat
    that does not fit prints its out-of-memory error as the finding; the
    remat run at the same batch must fit.  Then one profiled remat
    iteration at stage 8."""
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda")
    results = {}
    for stage, batch in ((REMAT_STAGE, 128), (8, TRAIN_BATCH)):
        res = 4 * 2 ** (stage - 1)
        real = torch.randint(0, 256, (batch, res, res, 3), generator=gen, device=dev, dtype=torch.uint8)
        for remat in (False, True):
            cfg = TrainConfig(remat=remat)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                state = build_state(cfg, dev)
                state.stage = stage
                step = make_train_step(cfg, stage, batch, 8.0, (False,), False)
                step(state, real)  # warm-up
                torch.cuda.synchronize()
                ms = timed_ms(lambda: step(state, real), iters=3)
                peak = torch.cuda.max_memory_allocated() / 2**30
                results[(stage, batch, remat)] = (ms, peak)
                print(f"time remat stage {stage} ({res} px) batch {batch} bf16 remat {remat}: {ms:.3f} ms per iteration "
                      f"({1e3 * batch / ms:.2f} images/s, CUDA events, 3 iterations), peak allocated {peak:.3f} GiB; "
                      f"{time.perf_counter() - t0:.1f} s {math_flags()}")
            except torch.cuda.OutOfMemoryError as e:
                require(not remat, f"the remat iteration at stage {stage} batch {batch} does not fit: {e}")
                results[(stage, batch, remat)] = None
                print(f"time remat stage {stage} ({res} px) batch {batch} bf16 remat {remat}: out of memory "
                      f"(peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB): {str(e).splitlines()[0]}")
            finally:
                state = step = None
                torch.cuda.empty_cache()
    cfg = TrainConfig(remat=True)
    state = build_state(cfg, dev)
    state.stage = 8
    step = make_train_step(cfg, 8, TRAIN_BATCH, 8.0, (False,), False)
    real = torch.randint(0, 256, (TRAIN_BATCH, 512, 512, 3), generator=gen, device=dev, dtype=torch.uint8)
    before = launch_counts()
    card, _ = profile_totals(lambda: step(state, real))
    launched = tuple((a - b) // 2 for a, b in zip(launch_counts(), before))  # the warm-up call and the traced one
    busy = sum(ms for _, ms in card.values())
    top = sorted(card.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"time remat profiled stage-8 iteration bf16 batch {TRAIN_BATCH}: card busy {busy:.3f} ms in "
          f"{sum(c for c, _ in card.values())} kernels; launches (K1, K2, K3) {launched}; largest: "
          + "; ".join(f"{k} x{c} {ms:.3f} ms" for k, (c, ms) in top) + f" {math_flags()}")
    del state, step
    torch.cuda.empty_cache()
    return results


def prep_on_card(tmp, root):
    """``python -m byogan_tpu_torch.cli.prep <dir> 4 512 -y --pack`` on
    ``PREP_ORIGINALS`` synthetic 1024 px originals (two non-square), each
    written under one of PNG's five row filters, resizing on the card:
    every level bit-equal to the plain numpy resize of the same pixels,
    every ``packed.npy`` equal to its set's PNGs, stage 8 opened by
    ``open_stage_dataset``.  Seconds per original for the CLI (its worker
    threads) and, one original at a time in this process, by filter:
    decode, the card's 8 resizes with their fetch and encode.  Returns the
    seconds."""
    from byogan_tpu_torch.core.resize import resize_uint8_bilinear_pil, resize_uint8_bilinear_pil_plain
    from byogan_tpu_torch.data.pipeline import StageDataset, open_stage_dataset
    from byogan_tpu_torch.data.png import read_png
    from byogan_tpu_torch.data.synthetic import encode_png_filtered
    from byogan_tpu_torch.serve import encode_png

    data = os.path.join(tmp, "prep")
    os.makedirs(data)
    rng = np.random.default_rng(21)
    originals = {}
    for i in range(PREP_ORIGINALS):
        h, w = {3: (768, PREP_SIDE), 10: (PREP_SIDE, 900)}.get(i, (PREP_SIDE, PREP_SIDE))
        yy, xx = np.mgrid[0:h, 0:w]  # smooth colour with noise on top, as photos are
        base = np.stack([np.sin(xx / (37 + 5 * c + i) + c) * np.cos(yy / (53 + i)) for c in range(3)], -1)
        img = np.clip(127.5 + 100 * base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
        name = f"orig-{i:02d}.png"
        with open(os.path.join(data, name), "wb") as f:
            f.write(encode_png_filtered(img, i % 5))
        originals[name] = img
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "byogan_tpu_torch.cli.prep", data, "4", "512", "-y", "--pack"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli.prep exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    require("dataset ready: 8 resolution sets" in proc.stdout, f"cli.prep said {proc.stdout[-500:]}")
    names = sorted(originals)
    for n, name in enumerate(names):
        level = originals[name]
        for size in (512, 256, 128, 64, 32, 16, 8, 4):
            level = resize_uint8_bilinear_pil_plain(level, size)
            k = int(math.log2(size // 4)) + 1
            got = read_png(os.path.join(data, "prepared", f"set_{k}", "images", f"image-{n}.png"))
            require(np.array_equal(got, level), f"prep {name} at {size} px differs from the plain resize")
    for k in range(1, 9):
        ds = StageDataset(data, k)
        packed = np.load(os.path.join(ds.set_dir, "packed.npy"))
        require(packed.shape == (PREP_ORIGINALS,) + (4 * 2 ** (k - 1),) * 2 + (3,), f"set_{k} packed {packed.shape}")
        for i, path in enumerate(ds.files):
            require(np.array_equal(packed[i], read_png(path)), f"set_{k} packed.npy differs from {path}")
    stage8 = open_stage_dataset(data, 8)
    batch = stage8.get_batch_uint8(np.arange(4))
    require(len(stage8) == PREP_ORIGINALS and batch.shape == (4, 512, 512, 3), "open_stage_dataset on the prepared set")
    by_filter = {}
    dev = torch.device("cuda")
    for name in names[:5]:  # one original of each filter, 0-4
        path = os.path.join(data, "original", "images", name)
        t0 = time.perf_counter()
        img = read_png(path)
        t1 = time.perf_counter()
        x = torch.from_numpy(img).to(dev)
        for size in (512, 256, 128, 64, 32, 16, 8, 4):
            x = resize_uint8_bilinear_pil(x, size)
            encode_png(x.cpu().numpy())
        t2 = time.perf_counter()
        by_filter[("None", "Sub", "Up", "Average", "Paeth")[int(name[5:7]) % 5]] = (t1 - t0, t2 - t1)
    print(f"prep: cli.prep of {PREP_ORIGINALS} originals ({PREP_SIDE} px, two non-square) to 8 sets with --pack in "
          f"{cli_s:.2f} s ({cli_s / PREP_ORIGINALS:.3f} s per original, process start included, 8 worker threads); every "
          f"level bit-equal to the plain numpy resize, packed.npy equal to the PNGs, stage 8 opened; one original at a "
          f"time, s (decode, card resizes + fetch + encode) by row filter: "
          + "; ".join(f"{f} {d:.3f} + {r:.3f}" for f, (d, r) in by_filter.items()))
    return cli_s / PREP_ORIGINALS, by_filter


def serve_program(path: str, out_path: str, seeds: str) -> int:
    """Run in a fresh process by ``serving_program``: load the program with
    ``byogan_tpu_torch.ops`` and ``deploy`` alone, render one batch per seed
    (frames saved to ``out_path``), count K1, K2 and K3 launches, time
    ``PROGRAM_FRAMES`` frames, and write the numbers beside the frames."""
    t0 = time.perf_counter()
    from byogan_tpu_torch.deploy import ExportedSampler
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.styleconv import styleconv_cuda
    from byogan_tpu_torch.ops.styleconv_bwd import styleconv_backward_cuda

    s = ExportedSampler(path)
    load_s = time.perf_counter() - t0
    loaded = sorted(m for m in sys.modules if m.startswith("byogan"))
    z = s.sample_z(seed=5)
    s(z, seed=0)  # warm-up
    torch.cuda.synchronize()
    counters = (styleconv_cuda, noise_lrelu_adain_cuda, styleconv_backward_cuda)
    for c in counters:
        c.launches = 0
    frames = [s(z, seed=int(seed)) for seed in seeds.split(",")]
    launches = [c.launches for c in counters]
    t0 = time.perf_counter()
    for i in range(PROGRAM_FRAMES // s.in_shape[0]):
        s(z, seed=100 + i)
    rate = PROGRAM_FRAMES / (time.perf_counter() - t0)
    np.savez(out_path, frames=np.stack(frames), z=z, launches=np.array(launches), load_s=load_s, rate=rate,
             loaded=np.array(loaded))
    return 0


def serving_program(tmp, root, final):
    """The serving program from FINAL.pth's EMA weights: ``cli.export
    --program --ema`` at 512 px, batch 8, bf16, without and with ``--psi
    0.7``; each loaded in a fresh process (``serve_program``) that imports
    ``byogan_tpu_torch.ops`` and ``deploy`` alone.  Frames within 1 LSB of
    ``Sampler.render`` on the same z and the seeded noise, (15, 1, 0)
    launches per batch, the program's bytes, load seconds and images/s
    beside the Sampler's; the seeded noise on the card against the CPU
    within 1e-6.  Returns the launches per batch and the worst frame
    error."""
    from byogan_tpu_torch.cli.export import main as export_main
    from byogan_tpu_torch.core.random import seeded_synthesis_noise
    from byogan_tpu_torch.serve import Sampler

    dev = torch.device("cuda")
    worst, per_batch = 0, None
    seeds = (3, 11)
    for psi in (None, 0.7):
        path = os.path.join(tmp, f"gen{'' if psi is None else '-psi'}.pt2")
        argv = [final, path, "--program", "--ema", "--batch", str(PATH_BATCH)] + ([] if psi is None else ["--psi", str(psi)])
        t0 = time.perf_counter()
        export_main(argv)
        export_s = time.perf_counter() - t0
        with open(path + ".json") as f:
            meta = json.load(f)
        require(meta["resolution"] == 512 and meta["device"].startswith("cuda") and meta["truncation_psi"] == psi, f"sidecar {meta}")
        npz = path + ".npz"
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.serve_program(*sys.argv[1:]))",
             path, npz, ",".join(map(str, seeds))],
            cwd=root, capture_output=True, text=True, timeout=600,
        )
        require(proc.returncode == 0, f"the program's process exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        got = np.load(npz)
        loaded = [str(m) for m in got["loaded"]]
        require(all(m == "byogan_tpu_torch" or m.startswith(("byogan_tpu_torch.ops", "byogan_tpu_torch.core"))
                    or m == "byogan_tpu_torch.deploy" for m in loaded), f"the program's process imported {loaded}")
        launches = tuple(int(v) // len(seeds) for v in got["launches"])
        require(launches == (15, 1, 0), f"the program launched {tuple(got['launches'])} over {len(seeds)} batches")
        per_batch = launches
        sampler = Sampler(final, batch=PATH_BATCH, seed=0, use_ema=True, truncation_psi=psi)
        z = torch.from_numpy(got["z"]).to(dev)
        diffs = []
        for seed, frames in zip(seeds, got["frames"]):
            want = sampler.render(z, seeded_synthesis_noise(seed, PATH_BATCH, 8, dtype=sampler.dtype, device=dev)).cpu().numpy()
            d = np.abs(frames.astype(np.int16) - want.astype(np.int16))
            diffs.append((int(d.max()), int((d > 0).sum())))
        err = max(m for m, _ in diffs)
        require(err <= 1, f"program vs Sampler.render: max frame error {err}")
        worst = max(worst, err)
        sampler.sample(PATH_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.sample(PROGRAM_FRAMES)
        sampler_rate = PROGRAM_FRAMES / (time.perf_counter() - t0)
        print(f"program: cli.export --program --ema{'' if psi is None else f' --psi {psi}'} 512 px batch {PATH_BATCH} bf16 "
              f"in {export_s:.2f} s, {meta['bytes']} bytes; a fresh process (imports {len(loaded)} modules of the package: "
              f"ops, core, deploy) loads it in {float(got['load_s']):.2f} s and serves {float(got['rate']):.2f} images/s "
              f"(host clock incl. fetch, {PROGRAM_FRAMES} frames) beside the Sampler's {sampler_rate:.2f}; launches per "
              f"batch (K1, K2, K3) {launches}; frames vs Sampler.render on the same z and seeded noise: max error "
              f"{err} LSB, pixels differing " + ", ".join(f"seed {s} {n} of {frames.size}" for s, (_, n) in zip(seeds, diffs))
              + f" {math_flags()}")
        del sampler
    op_dispatch_cost(final, dev)
    noise_err = 0.0
    for seed in (0, 7, -3, 2**40 + 1):
        card = seeded_synthesis_noise(torch.tensor(seed, device=dev), PATH_BATCH, 8)
        cpu = seeded_synthesis_noise(seed, PATH_BATCH, 8)
        noise_err = max(noise_err, max(float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu)))
    require(noise_err <= 1e-6, f"seeded noise card vs CPU {noise_err}")
    print(f"program: seeded synthesis noise on the card vs the CPU (batch {PATH_BATCH}, 8 stages, 4 seeds): max abs err {noise_err:.3e}")
    return per_batch, worst


def op_dispatch_cost(final, dev):
    """What the registered ops cost the host: microseconds to issue one
    call through ``torch.ops.byogan`` against the wrapper called directly,
    K1 and K2 at the 4x4 block, batch 8, bf16; and ``Sampler.render``'s
    ms a batch (CUDA events) through the ops against the wrappers swapped
    into the layers, in the order A B B A."""
    from byogan_tpu_torch.models import layers
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.cardcheck import host_us
    from byogan_tpu_torch.ops.styleconv import styleconv_cuda
    from byogan_tpu_torch.serve import Sampler

    gen = torch.Generator(device=dev).manual_seed(13)
    k1 = list(k1_inputs(PATH_BATCH, 4, 512, 512, torch.bfloat16, gen).values())
    k2 = list(k2_inputs(PATH_BATCH, 4, 512, torch.bfloat16, gen).values())
    with torch.inference_mode():
        us = {"K1 op": host_us(lambda: torch.ops.byogan.styleconv(*k1, 1e-8)), "K1 wrapper": host_us(lambda: styleconv_cuda(*k1)),
              "K2 op": host_us(lambda: torch.ops.byogan.noise_lrelu_adain(*k2, 1e-8)),
              "K2 wrapper": host_us(lambda: noise_lrelu_adain_cuda(*k2))}
    sampler = Sampler(final, batch=PATH_BATCH, seed=0, use_ema=True)
    draws = sampler.draw()
    render = {"ops": [], "wrappers": []}
    for how in ("ops", "wrappers", "wrappers", "ops"):
        with contextlib.ExitStack() as stack:
            if how == "wrappers":
                stack.enter_context(mock.patch.object(layers, "styleconv", styleconv_cuda))
                stack.enter_context(mock.patch.object(layers, "noise_lrelu_adain", noise_lrelu_adain_cuda))
            render[how].append(timed_ms(lambda: sampler.render(*draws), iters=20))
    print("program: host us to issue one call, (8,4,4,512) bf16: " + ", ".join(f"{k} {v:.1f}" for k, v in us.items())
          + "; Sampler.render ms a batch (CUDA events, order A B B A): "
          + "; ".join(f"{k} {' '.join(f'{t:.3f}' for t in v)}" for k, v in render.items()) + f" {math_flags()}")


def trace_run(tmp):
    """The training CLI for 4 iterations (stages 1-4) with ``--trace-dir``:
    the trace file exists and names K1's kernel and the loop's
    ``annotate`` region."""
    from byogan_tpu_torch.cli.main import main as train_main

    cfg = os.path.join(tmp, "trace.txt")
    with open(cfg, "w") as f:
        f.write(REMAT_CONFIG.format(data=os.path.join(tmp, "data"), tmp=tmp).replace("[remat]", "[trace]")
                .replace("remat_progression = False,False,False,False,False,False,True,False\n", "")
                .replace("remat_ck", "trace_ck").replace("remat_out", "trace_out"))
    trace_dir = os.path.join(tmp, "trace")
    t0 = time.perf_counter()
    state = train_main(["trace", "--config-file", cfg, "--max-iters", "4", "--trace-dir", trace_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    require(state.iters == 4 and len(files) == 1, f"trace run: {state.iters} iterations, files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    k1 = sorted(n for n in names if "conv3x3" in n)
    regions = sorted(n for n in names if n.startswith("train_step stage"))
    require(k1 and regions, f"the trace names K1 {k1} and the regions {regions}")
    print(f"trace: the training CLI, 4 iterations with --trace-dir in {wall:.2f} s: {os.path.basename(files[0])}, "
          f"{os.path.getsize(files[0])} bytes, {len(events)} events; K1's kernels {k1[:2]}; regions {regions}")
    return os.path.getsize(files[0])


# The data-parallel slice: two ranks, spawned here, joined by gloo on one
# card (NCCL refuses two ranks on one device) or by NCCL, one card each,
# where the machine has two.
DP_WORLD, DP_BATCH, DP_TIME_BATCH, DP_IMAGES = 2, 8, 2 * TRAIN_BATCH, 64
DP_CONFIG = (
    "[{name}]\n"
    "data = {data}\n"
    "batch_progression = 64,64,64,64,32,32,16,8\n"  # configs/example.txt [DEFAULT]
    "epoch_progression = 1,1,1,1,1,1,1,1\n"
    "fade_percentage = 2\n"
    "display_step = 1000\ncheckpoint_step = 1000\nrefresh_stat_step = 1\n"
    "data_axis = {data_axis}\n"
    "checkpoint_dir = {tmp}/{name}_ck\noutput_dir = {tmp}/{name}_out\n"
)
DP_SIGNAL_STAGE = 5  # rank 1 alone receives SIGTERM after its first stage-5 iteration
# After the first step from the fresh state, the share of the nets' and
# the EMA's entries more than 1e-5 apart between the mesh and one process.
# Adam moves each entry by about lr times its gradient's sign, so an entry
# whose gradient is within rounding of zero lands up to 2 * lr away; a
# wrong reduction moves most entries.  The H100 found 0.004-0.09% (2,253
# to 54,649 of 61,878,353).  After a later step the share swings from run
# to run with the state the first step left (0.002-2.5%, and rounding
# alone, latents moved by 1e-6, 0.0003-2.6%), so it is printed only: the
# weights after a later step are held through the gradients and Adam's
# second moments (``DP_MOMENT_TOL``), not by a bound of their own.
DP_FAR_SHARE = 0.01
# Each net's whole gradient after a later step: Adam's first, sign-like
# step leaves a state in which the generator's gradient moves by up to
# 9e-3 (relative L2) between the mesh's batch split and one process's, and
# by as much under latents moved by 1e-6; a wrong reduction moves it by
# O(1).  At the fresh state it is held to STEP_GRAD_TOL, tensor by tensor.
DP_LATER_GRAD_TOL = 0.1
# Each optimizer's second moments (exp_avg_sq, all leaves as one vector)
# after the step, relative L2 between the mesh and one process, from the
# same state: beta_2 v + (1 - beta_2) g^2 of the averaged gradient g, so
# a gradient off by e moves them by about 2e where g^2 dominates.  Twice
# the gradient's bar, at the fresh state and after.  A gradient summed
# and not averaged over two ranks moves them by O(1) (3 at the fresh
# state).
DP_MOMENT_TOL = (2 * STEP_GRAD_TOL[0], 2 * DP_LATER_GRAD_TOL)


def dp_backend(world: int = DP_WORLD) -> str:
    """NCCL with a card per rank, else gloo, every rank on the one card."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def _dp_entry(rank: int, world: int, backend: str, store: str, job: str, args: tuple, out: str) -> None:
    import torch.distributed as dist

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    # a rank that fails leaves the others in a collective: time it out
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        result = globals()[job](rank, dev, *args)
        torch.save(result, f"{out}-{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(tmp: str, job: str, *args, backend: str = None, world: int = DP_WORLD) -> list:
    """``job(rank, device, *args)`` on ``world`` spawned ranks; each rank's
    result.  A rank that raises fails the call."""
    import torch.multiprocessing as mp

    backend = backend or dp_backend(world)
    tag = f"{job}-{backend}-{world}-{time.time_ns()}"  # a fresh file store for every spawn
    store, out = (os.path.join(tmp, f"{what}-{tag}") for what in ("store", "out"))
    mp.spawn(_dp_entry, args=(world, backend, store, job, args, out), nprocs=world, join=True)
    return [torch.load(f"{out}-{r}.pt", weights_only=False) for r in range(world)]


def _dp_step_state(cfg, dev):
    """A fresh full-width state with the noise weights and the critic's
    biases drawn, as ``_step_outcome`` makes it."""
    from byogan_tpu_torch.train.loop import build_state

    state = build_state(cfg, dev)
    with torch.no_grad():
        for net, pick, std in ((state.gen, "inject_noise", 0.3), (state.critic, "bias", 0.1)):
            for name, p in net.named_parameters():
                if pick in name:
                    p.normal_(0.0, std, generator=torch.Generator(device=dev).manual_seed(len(name)))
    return state


def _flat_params(state) -> torch.Tensor:
    nets = [state.gen, state.critic] + ([state.gen_ema] if state.gen_ema is not None else [])
    return torch.cat([p.detach().reshape(-1) for net in nets for p in net.parameters()])


DP_STEP_CASES = {
    "R1": dict(compute_dtype="float32", ema_beta=0.999),
    f"ADA {REG_TARGET} + PLR 2.0, penalized": dict(compute_dtype="float32", ema_beta=0.999, aug_p=0.5,
                                                   ada_target=REG_TARGET, plr_weight=2.0, plr_interval=REG_INTERVAL),
}


def _copy_state(src, dst) -> None:
    """``dst`` (a TrainState of the same config) takes ``src``'s nets,
    optimizer states, regularizer scalars and counters."""
    for net in ("gen", "critic", "gen_ema"):
        if getattr(src, net) is not None:
            getattr(dst, net).load_state_dict(getattr(src, net).state_dict())
    for opt in ("gen_opt", "critic_opt"):  # load_state_dict would share src's moment tensors
        getattr(dst, opt).load_state_dict(copy.deepcopy(getattr(src, opt).state_dict()))
    for k in ("aug_p", "rt_ema", "pl_ema"):
        if getattr(src, k) is not None:
            setattr(dst, k, getattr(src, k).clone())
    dst.iters, dst.im_count = src.iters, src.im_count


def _params_apart(a, b) -> tuple:
    """(largest |a - b|, entries more than 1e-5 apart, entries) over both
    nets and the EMA of two states."""
    worst, far, n = 0.0, 0, 0
    for net in ("gen", "critic", "gen_ema"):
        for p, q in zip(getattr(a, net).parameters(), getattr(b, net).parameters()):
            d = (p.detach() - q.detach()).abs()
            worst, far, n = max(worst, float(d.max())), far + int((d > 1e-5).sum()), n + d.numel()
    return worst, far, n


def _moments_rel_l2(a, b) -> dict:
    """Per optimizer of two states, the relative L2 distance of its
    second moments (every parameter's exp_avg_sq as one vector)."""
    out = {}
    for net, opt in (("gen", "gen_opt"), ("critic", "critic_opt")):
        want = {n: getattr(b, opt).state[p]["exp_avg_sq"] for n, p in getattr(b, net).named_parameters()}
        got = {n: getattr(a, opt).state[p]["exp_avg_sq"] for n, p in getattr(a, net).named_parameters()}
        out[net] = _net_rel_l2(got, want)
    return out


def _moved_latents(draws, rng):
    """``draws`` with every latent moved by 1e-6 relative: the same step
    on them measures how far rounding alone moves its results."""
    import dataclasses

    def move(z):
        return z * (1 + 1e-6 * torch.randn(z.shape, generator=rng, device=z.device))

    return dataclasses.replace(
        draws, critic=[(move(z), noise, eps) for z, noise, eps in draws.critic], gen=(move(draws.gen[0]), draws.gen[1]),
        plr=None if draws.plr is None else dataclasses.replace(draws.plr, z=move(draws.plr.z)),
    )


def _step_record(step, state, real, draws) -> dict:
    before = launch_counts()
    metrics = step(state, real, draws)
    torch.cuda.synchronize()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "launches": tuple(a - b for a, b in zip(launch_counts(), before))}


def _net_rel_l2(got: dict, want: dict) -> float:
    """Relative L2 distance of two gradients of one net, all its tensors
    taken as one vector."""
    num = sum(float((got[n] - w).double().square().sum()) for n, w in want.items())
    return math.sqrt(num / max(sum(float(w.double().square().sum()) for w in want.values()), 1e-300))


def dp_steps_job(rank: int, dev: torch.device) -> dict:
    """On each rank: per case of ``DP_STEP_CASES``, 2 iterations at stage 8,
    f32 (TF32 off), global batch 8 over the mesh, on global draws and
    batches made from one seed.  Before each, rank 0 gives one process
    the mesh's state and runs the same iteration on the whole batch (no
    mesh), and once more with every latent moved by 1e-6 (rounding alone,
    printed beside).  Rank 0 holds the mesh's losses within ``STEP_TOL``
    of that step's at every iteration; at the fresh state (where the
    tolerance was set) every gradient tensor within ``STEP_GRAD_TOL`` and
    at most ``DP_FAR_SHARE`` of the weights more than 1e-5 apart after the
    update; after a later step each net's whole gradient within
    ``DP_LATER_GRAD_TOL`` (after Adam's first update the generator's
    bias and noise-weight gradients, sums that cancel almost to zero, move
    by up to ~3e-2 with the batch's summation order alone); aug_p and
    rt_ema equal, pl_ema within ``STEP_TOL`` (path lengths summed in
    another order); each optimizer's second moments within
    ``DP_MOMENT_TOL``.  Every rank checks its parameters bit-equal to rank
    0's.  A failed check is returned, not raised, so that no rank leaves
    the others waiting in a collective.  Returns per case the (K1, K2, K3)
    launches of each iteration on this rank (and one process's), the
    errors, how far the nets and EMA lie apart, the regularizers and the
    failures."""
    import types

    from byogan_tpu_torch.parallel.mesh import broadcast_, make_mesh, shard_batch, shard_train_state
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.steps import draw, make_train_step

    mesh = make_mesh(device=dev)  # the spawned world
    result = {"backend": mesh.backend, "cases": {}, "failures": []}

    def check(cond: bool, what: str) -> None:
        if not cond:
            result["failures"].append(what)

    with strict_f32():
        for name, knobs in DP_STEP_CASES.items():
            cfg = TrainConfig(**knobs)
            rng = torch.Generator(device=dev).manual_seed(7)
            inputs = []
            for i in range(2):
                draws = draw(types.SimpleNamespace(rng=rng, iters=i), cfg, DP_BATCH, 8, torch.float32)
                real = torch.randint(0, 256, (DP_BATCH, 512, 512, 3), generator=rng, device=dev, dtype=torch.uint8)
                inputs.append((real, draws))
            check((inputs[0][1].plr is not None) == (cfg.plr_weight > 0) and inputs[1][1].plr is None,
                  f"{name}: penalized iterations")
            state = shard_train_state(_dp_step_state(cfg, dev), mesh)
            step = make_train_step(cfg, 8, DP_BATCH, 8.0, (True,), True, mesh=mesh)
            case = {"launches": [], "single_launches": [], "losses": 0.0, "grads": [], "moments": [],
                    "step params": [], "regularizers": []}
            if rank == 0:
                single = make_train_step(cfg, 8, DP_BATCH, 8.0, (True,), True)
                ref, moved = (_dp_step_state(cfg, dev) for _ in range(2))
            for i, (real, draws) in enumerate(inputs):
                what = f"dp {name} iteration {i}"
                if rank == 0:
                    _copy_state(state, ref)
                    _copy_state(state, moved)
                    want = _step_record(single, ref, real, draws)
                    _step_record(single, moved, real, _moved_latents(draws, rng))
                    case["single_launches"].append(want["launches"])
                got = _step_record(step, state, shard_batch(real, mesh), draws)
                case["launches"].append(got["launches"])
                if rank != 0:
                    continue
                for k, v in want["metrics"].items():
                    if k in ("aug_p", "rt_ema"):
                        check(got["metrics"][k] == v, f"{what} {k}: {got['metrics'][k]} vs {v}")
                    elif v != 0.0 or got["metrics"][k] != 0.0:
                        e = abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
                        check(e <= STEP_TOL, f"{what} {k}: relative error {e:.3e} over {STEP_TOL}")
                        case["losses"] = max(case["losses"], e)
                errs = {}
                for net in ("gen", "critic"):
                    grads = {x: {n: p.grad for n, p in getattr(st, net).named_parameters()} for x, st in
                             (("mesh", state), ("one", ref), ("moved", moved))}
                    per = grad_errs(grads["mesh"], grads["one"], f"{what} {net} grads", check=False)
                    whole = _net_rel_l2(grads["mesh"], grads["one"])
                    alone_err = grad_errs(grads["moved"], grads["one"], f"{what} {net} grads, rounding alone", check=False)
                    bar = STEP_GRAD_TOL[0] if i == 0 else DP_LATER_GRAD_TOL
                    check(whole <= bar, f"{what} {net} grads: relative L2 of the whole {whole:.3e} over {bar}")
                    if i == 0:
                        check(per[0] <= STEP_GRAD_TOL[0] and per[1] <= STEP_GRAD_TOL[1], f"{what} {net} grads {per}")
                    errs[net] = {"whole": whole, "worst tensor": per, "rounding alone": alone_err,
                                 "rounding alone whole": _net_rel_l2(grads["moved"], grads["one"])}
                case["grads"].append(errs)
                moments, by_rounding = _moments_rel_l2(state, ref), _moments_rel_l2(moved, ref)
                for net, e in moments.items():
                    check(e <= DP_MOMENT_TOL[min(i, 1)], f"{what} {net} second moments: relative L2 {e:.3e} over "
                          f"{DP_MOMENT_TOL[min(i, 1)]} (rounding alone {by_rounding[net]:.3e})")
                case["moments"].append((moments, by_rounding))
                apart, by_rounding = _params_apart(state, ref), _params_apart(moved, ref)
                check(i > 0 or apart[1] <= DP_FAR_SHARE * apart[2],
                      f"{what}: nets and EMA apart {apart}, by rounding alone {by_rounding}")
                case["step params"].append((apart, by_rounding))
                case["regularizers"].append({k: (float(getattr(state, k)), float(getattr(ref, k)))
                                             for k in ("aug_p", "rt_ema", "pl_ema") if getattr(ref, k) is not None})
                if ref.pl_ema is not None:
                    e = abs(float(state.pl_ema) - float(ref.pl_ema)) / max(abs(float(ref.pl_ema)), 1e-12)
                    check(e <= STEP_TOL, f"{what} pl_ema: relative error {e:.3e}")
            flat = _flat_params(state)
            theirs = flat.clone()
            broadcast_([theirs], mesh)
            case["bit_equal"] = bool(torch.equal(flat, theirs))
            check(case["bit_equal"], f"{name}: rank {rank}'s parameters differ from rank 0's")
            if rank == 0:
                del ref, moved
            result["cases"][name] = case
            del state
            torch.cuda.empty_cache()
    return result


def dp_steps(tmp, world: int = DP_WORLD):
    """The "dp steps" phase (``dp_steps_job`` on ``world`` spawned ranks)."""
    out = spawn_ranks(tmp, "dp_steps_job", world=world)
    backend = out[0]["backend"]
    where = f"{world} ranks sharing one card" if backend == "gloo" else f"{world} cards"
    for name, case in out[0]["cases"].items():
        launches = [o["cases"][name]["launches"] for o in out]
        g = case["grads"]
        print(f"dp steps {name} ({backend}, {where}), f32 stage 8, global batch {DP_BATCH}, each iteration against one "
              f"process from the same state: losses max rel err {case['losses']:.3e} (tol {STEP_TOL}); per iteration, "
              f"per net, relative L2 of the whole gradient (tol {STEP_GRAD_TOL[0]} at the fresh state, then "
              f"{DP_LATER_GRAD_TOL}) and the worst tensor's (rel L2, max) (tol {STEP_GRAD_TOL} at the fresh state), "
              f"beside rounding alone's: "
              + "; ".join(f"{i}: " + ", ".join(f"{net} {e['whole']:.3e} {e['worst tensor'][0]:.3e} {e['worst tensor'][1]:.3e} "
                                                f"(rounding alone {e['rounding alone whole']:.3e} {e['rounding alone'][0]:.3e} "
                                                f"{e['rounding alone'][1]:.3e})" for net, e in it.items())
                         for i, it in enumerate(g))
              + f"; per iteration, per net, relative L2 of the optimizer's second moments (tol {DP_MOMENT_TOL[0]} at "
              f"the fresh state, then {DP_MOMENT_TOL[1]}) beside rounding alone's: "
              + "; ".join(f"{i}: " + ", ".join(f"{net} {e:.3e} (rounding alone {r[net]:.3e})" for net, e in m.items())
                          for i, (m, r) in enumerate(case["moments"]))
              + f"; nets and EMA after each (max |diff|, entries over 1e-5, entries; held after the first only, to "
              f"{DP_FAR_SHARE} of entries), beside rounding alone's {case['step params']}; regularizers (mesh, one "
              f"process) {case['regularizers']}; the ranks' parameters "
              f"bit-equal {[o['cases'][name]['bit_equal'] for o in out]}; launches per iteration (K1, K2, K3) per "
              f"rank {launches[0]}, one process {case['single_launches']} {math_flags()}")
        require(all(x == case["single_launches"] for x in launches),
                f"{name}: launches {launches} vs one process's {case['single_launches']}")
    failures = [f for o in out for f in o["failures"]]
    require(not failures, "dp steps: " + "; ".join(failures))
    return backend, {name: case["launches"] for name, case in out[0]["cases"].items()}


def dp_train_job(rank: int, dev: torch.device, cfg_path: str, section: str = "dp") -> dict:
    """``train`` of the ``section`` of ``cfg_path`` on this rank, counting
    each step's launches; rank 1 sends itself SIGTERM after its first
    stage-5 step."""
    from byogan_tpu_torch.train import loop
    from byogan_tpu_torch.train.config import load_ini_config

    records = []
    make_step = loop.make_train_step

    def signalling(*args, **kw):
        fn = make_step(*args, **kw)

        def step(state, real, draws=None):
            out = fn(state, real, draws)
            if rank == 1 and state.stage == DP_SIGNAL_STAGE and not any(r[0] == DP_SIGNAL_STAGE for r in records):
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return step

    zero_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(loop, "make_train_step", signalling), counting_steps(records):
        state = loop.train(load_ini_config(cfg_path, section), device=str(dev))
    torch.cuda.synchronize()
    return {"iters": state.iters, "stage": state.stage, "records": records, "launches": launch_counts(),
            "wall": time.perf_counter() - t0}


def dp_train(tmp, root):
    """The "dp train" phase: ``train`` on two ranks at full width on 64
    synthetic images with ``[DEFAULT]``'s batch_progression, one epoch a
    stage (20 iterations), SIGTERM to rank 1 alone at stage 5: both stop at
    one iteration, rank 0 writes one checkpoint and one metrics file; the
    checkpoint resumes in one process to FINAL.pth, which the Sampler
    loads; then the CLI at world 1 under NCCL through torchrun."""
    from byogan_tpu_torch.cli.main import main as train_main
    from byogan_tpu_torch.data.synthetic import write_prepared_dataset
    from byogan_tpu_torch.serve import Sampler

    t0 = time.perf_counter()
    data = write_prepared_dataset(os.path.join(tmp, "dp_data"), DP_IMAGES, 8, seed=1)
    print(f"dp train: wrote {DP_IMAGES} images x 8 stages in {time.perf_counter() - t0:.2f} s")
    cfg = os.path.join(tmp, "dp.txt")
    with open(cfg, "w") as f:
        for name, axis in (("dp", DP_WORLD), ("dp1", 1), ("dpcli", 1)):
            f.write(DP_CONFIG.format(name=name, data=data, data_axis=axis, tmp=tmp))
    out = spawn_ranks(tmp, "dp_train_job", cfg, backend="gloo")
    iters = [o["iters"] for o in out]
    require(iters[0] == iters[1] and out[0]["stage"] == DP_SIGNAL_STAGE, f"the ranks stopped at {iters}, stage {out[0]['stage']}")
    n = iters[0]
    for r, o in enumerate(out):
        require(len(o["records"]) == n, f"rank {r}: {len(o['records'])} steps for {n} iterations")
        for k, _, _, got in o["records"]:
            require(got == (2 * (2 * k - 1), 2, 2 * k), f"rank {r} stage {k}: launches per iteration {got}")
    require(sorted(os.listdir(os.path.join(tmp, "dp_ck"))) == [f"chk-{n}.pth"], f"checkpoints {os.listdir(os.path.join(tmp, 'dp_ck'))}")
    require(sorted(os.listdir(os.path.join(tmp, "dp_out"))) == ["metrics.jsonl"], f"outputs {os.listdir(os.path.join(tmp, 'dp_out'))}")
    with open(os.path.join(tmp, "dp_out", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    require([r["iter"] for r in logged] == list(range(1, n + 1)), f"metrics iterations {[r['iter'] for r in logged]}")
    require(all(math.isfinite(r["c_loss"]) and math.isfinite(r["g_loss"]) for r in logged), "non-finite losses")
    launches = [dict(zip(KERNEL_NAMES, o["launches"])) for o in out]
    print(f"dp train: two ranks (gloo, one card) stopped together at iteration {n} (stage {DP_SIGNAL_STAGE}) in "
          f"{out[0]['wall']:.2f} s; one checkpoint chk-{n}.pth, one metrics file of {len(logged)} records; launches "
          f"per rank {launches}, per iteration as one process's; batch {64 // DP_WORLD} a rank at stages 1-4")

    records = []
    zero_launch_counts()
    t0 = time.perf_counter()
    with counting_steps(records):
        state = train_main(["dp1", "--config-file", cfg, "-c", os.path.join(tmp, "dp_ck", f"chk-{n}.pth")])
    torch.cuda.synchronize()
    require(state.iters == 20 and records[0][0] == DP_SIGNAL_STAGE, f"the resumed run ended at {state.iters}")
    for k, _, _, got in records:
        require(got == (2 * (2 * k - 1), 2, 2 * k), f"resumed stage {k}: launches per iteration {got}")
    frames = Sampler(os.path.join(tmp, "dp1_ck", "FINAL.pth"), batch=8, seed=0).sample(8)
    require(frames.shape == (8, 512, 512, 3) and frames.std() > 0, f"frames {frames.shape}")
    print(f"dp train: chk-{n}.pth resumed in one process to FINAL.pth in {time.perf_counter() - t0:.2f} s "
          f"({len(records)} iterations, stage 8 at batch 8); the Sampler's frames from it {frames.shape} "
          f"{frames.dtype}, std {frames.std():.2f}")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "byogan_tpu_torch.cli.main", "dpcli", "--config-file", cfg, "--distributed", "--max-iters", "4"],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    require(proc.returncode == 0, f"torchrun CLI exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    require("process group: world 1 (nccl), no mesh" in proc.stdout, f"no NCCL group line:\n{proc.stdout[-2000:]}")
    require(os.path.exists(os.path.join(tmp, "dpcli_ck", "chk-4.pth")), "torchrun CLI: no chk-4.pth")
    print(f"dp train: torchrun --standalone --nproc-per-node 1 ... cli.main --distributed --max-iters 4 exited 0 "
          f"in {time.perf_counter() - t0:.2f} s (a one-process NCCL group, no mesh; chk-4.pth)")
    return launches


def dp_time_job(rank: int, dev: torch.device) -> dict:
    """The stage-8 bf16 iteration (no-blend path) over the mesh at global
    batch ``DP_TIME_BATCH`` (``TRAIN_BATCH`` a rank), CUDA events; the
    all-reduce of each net's gradients alone (host clock, synchronised);
    one profiled iteration's host time in collective ops and card time in
    NCCL kernels."""
    import torch.distributed as dist

    from byogan_tpu_torch.parallel.mesh import all_reduce_mean_, make_mesh, shard_train_state
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import make_train_step

    mesh = make_mesh(device=dev)  # the spawned world
    cfg = TrainConfig()
    state = shard_train_state(build_state(cfg, dev), mesh)
    gen = torch.Generator(device=dev).manual_seed(rank)
    real = torch.randint(0, 256, (DP_TIME_BATCH // mesh.size, 512, 512, 3), generator=gen, device=dev, dtype=torch.uint8)
    step = make_train_step(cfg, 8, DP_TIME_BATCH, 8.0, (False,), False, mesh=mesh)
    it_ms = timed_ms(lambda: step(state, real), iters=TIMED_ITERS)
    reduce_ms, mbytes = {}, {}
    for net in ("critic", "gen"):
        grads = [p.grad for p in getattr(state, net).parameters()]
        all_reduce_mean_(grads, mesh)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(5):
            all_reduce_mean_(grads, mesh)
        torch.cuda.synchronize()
        reduce_ms[net] = (time.perf_counter() - t0) / 5 * 1e3
        mbytes[net] = sum(g.numel() * g.element_size() for g in grads) / 1e6
    card, host = profile_totals(lambda: step(state, real))
    collective = re.compile(r"all_?reduce|broadcast|gloo|nccl", re.IGNORECASE)
    return {
        "backend": mesh.backend, "it_ms": it_ms, "reduce_ms": reduce_ms, "mbytes": mbytes,
        "host_collective_ms": {k: v for k, v in host.items() if collective.search(k)},
        "card_nccl_ms": {k: ms for k, (_, ms) in card.items() if "nccl" in k.lower()},
        "card_busy_ms": sum(ms for _, ms in card.values()),
    }


def dp_times(tmp):
    """The "time dp" phase: the stage-8 bf16 iteration at world 1 with a
    one-process NCCL group against none (A B B A, CUDA events: the cost of
    the all-reduces with nothing to reduce across), then the two-rank
    iteration with gloo on this card (two ranks sharing one card, not a
    multi-card rate), and with NCCL on two cards where the machine has
    them."""
    import torch.distributed as dist

    from byogan_tpu_torch.parallel.mesh import make_mesh, shard_train_state
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda")
    cfg = TrainConfig()
    mesh = make_mesh(1, device=dev)  # NCCL on a card
    try:
        states = {"none": build_state(cfg, dev), "nccl": shard_train_state(build_state(cfg, dev), mesh)}
        step = {"none": make_train_step(cfg, 8, TRAIN_BATCH, 8.0, (False,), False),
                "nccl": make_train_step(cfg, 8, TRAIN_BATCH, 8.0, (False,), False, mesh=mesh)}
        real = torch.randint(0, 256, (TRAIN_BATCH, 512, 512, 3), generator=torch.Generator(device=dev).manual_seed(4),
                             device=dev, dtype=torch.uint8)
        times = {"none": [], "nccl": []}
        for mode in ("none", "nccl", "nccl", "none") * 2:
            times[mode].append(timed_ms(lambda: step[mode](states[mode], real), iters=TIMED_ITERS))
        profiles = {mode: profile_totals(lambda: step[mode](states[mode], real)) for mode in ("none", "nccl")}
        del states
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    busy = {m: (sum(ms for _, ms in card.values()), sum(n for n, _ in card.values())) for m, (card, _) in profiles.items()}
    print(f"time dp world 1, stage-8 iteration bf16 batch {TRAIN_BATCH}: no process group {times['none']} ms, one-process "
          f"NCCL group {times['nccl']} ms (A B B A twice, CUDA events, {TIMED_ITERS} iterations each); one profiled "
          f"iteration (card busy ms, kernels): none {busy['none']}, NCCL {busy['nccl']}; NCCL kernels "
          f"{fmt_times({k: v[1] for k, v in profiles['nccl'][0].items() if 'nccl' in k.lower()})} ms {math_flags()}")
    runs = [("gloo", "two ranks sharing one card, gloo")]
    if torch.cuda.device_count() >= DP_WORLD:
        runs.append(("nccl", "two cards, NCCL"))
    for backend, label in runs:
        ranks = spawn_ranks(tmp, "dp_time_job", backend=backend)
        for r, t in enumerate(ranks):
            share = (t["reduce_ms"]["critic"] + t["reduce_ms"]["gen"]) / t["it_ms"]
            print(f"time dp {label}, rank {r}: stage-8 iteration bf16 global batch {DP_TIME_BATCH} ({TRAIN_BATCH} a "
                  f"rank) {t['it_ms']:.3f} ms (CUDA events, {TIMED_ITERS} iterations); gradient all-reduce alone "
                  f"critic {t['reduce_ms']['critic']:.3f} ms ({t['mbytes']['critic']:.1f} MB), generator "
                  f"{t['reduce_ms']['gen']:.3f} ms ({t['mbytes']['gen']:.1f} MB), {100 * share:.1f}% of the iteration; "
                  f"profiled iteration: host ms in collective ops {fmt_times(t['host_collective_ms'])}, card ms in "
                  f"NCCL kernels {fmt_times(t['card_nccl_ms'])}, card busy {t['card_busy_ms']:.3f} ms {math_flags()}")


def dp_sampler(ckpt):
    """The "dp sampler" phase: ``Sampler(devices=["cuda:0", "cuda:0"])``
    against ``devices=None`` at 512 px, batch 8, on the same draws: in f32,
    frames within 1 LSB; in bf16 (the Sampler's default), each device's
    frames bit-equal to one device's render of the same rows alone, beside
    how far that batch of 4 lies from the batch of 8 and both from the f32
    frames; and which part depends on the batch: the mapping's w, and K1
    alone at each of the path's 15 shapes, on the same rows at batch 4
    and 8.  (K1, K2) launches a batch: one set per device."""
    from byogan_tpu_torch.models.factory import ModelSpec
    from byogan_tpu_torch.ops.styleconv import styleconv_cuda
    from byogan_tpu_torch.serve import Sampler

    def lsb(a, b):
        d = (a.int() - b.int()).abs()
        return int(d.max()), float((d > 1).float().mean())

    out, f32 = {}, None
    half = PATH_BATCH // 2
    for dtype in ("float32", "bfloat16"):
        one = Sampler(ckpt, batch=PATH_BATCH, seed=5, dtype=dtype)
        two = Sampler(ckpt, batch=PATH_BATCH, seed=5, dtype=dtype, devices=["cuda:0", "cuda:0"])
        z, noise = one.draw()
        z2, noise2 = two.draw()
        require(torch.equal(z, z2) and all(torch.equal(a, b) for a, b in zip(noise, noise2)), "the samplers' draws differ")
        with strict_f32():
            two.render(z, noise)  # warm-up
            zero_launch_counts()
            got = two.render(z, noise)
            torch.cuda.synchronize()
            launches = launch_counts()[:2]
            want = one.render(z, noise)
            blocks = torch.cat([one.render(z[i:i + half], [n[i:i + half] for n in noise]) for i in (0, half)])
        require(got.shape == (PATH_BATCH, 512, 512, 3), f"dp sampler frames {tuple(got.shape)}")
        require(launches == (2 * 15, 2), f"dp sampler launches {launches}")
        require(torch.equal(got, blocks), f"dp sampler {dtype}: the devices' frames differ from one device's render of their rows")
        err = lsb(got, want)
        if dtype == "float32":
            f32 = want
            require(err[0] <= 1, f"dp sampler f32: {err[0]} LSB from one device")
            frames, ref = two.sample(2 * PATH_BATCH), one.sample(2 * PATH_BATCH)
            err = max(err, lsb(torch.from_numpy(frames), torch.from_numpy(ref)))
            require(err[0] <= 1, f"dp sampler f32 sample(): {err[0]} LSB from one device")
            extra = ""
        else:
            with torch.inference_mode():
                w = {n: one.to_w(z[:n]).float() for n in (half, PATH_BATCH)}
                gen = torch.Generator(device="cuda").manual_seed(6)
                k1 = []
                for r, cin, cout in ModelSpec().styleconv_shapes():
                    ins = k1_inputs(PATH_BATCH, r, cin, cout, torch.bfloat16, gen)
                    rows = {k: v[:half] if k in ("x", "noise", "gamma", "beta") else v for k, v in ins.items()}
                    k1.append(float((styleconv_cuda(**ins)[:half].float() - styleconv_cuda(**rows).float()).abs().max()))
            w_err = float((w[PATH_BATCH][:half] - w[half]).abs().max())
            extra = (f"; from the f32 frames (max LSB, share of values over 1 LSB): batch {PATH_BATCH} "
                     f"{lsb(want, f32)}, the two devices' {lsb(got, f32)}; rows 0-{half - 1} at batch {half} against "
                     f"batch {PATH_BATCH}, max abs diff: the mapping's w {w_err:.3e}, K1 alone at the 15 path shapes "
                     f"{max(k1):.3e} ({sum(e == 0.0 for e in k1)} of 15 shapes bit-equal)")
        out[dtype] = err[0]
        print(f"dp sampler {dtype}: devices [cuda:0, cuda:0] against None at 512 px, batch {PATH_BATCH}: (max LSB, share "
              f"of values over 1 LSB) {err} (bar: 1 LSB in f32); bit-equal to one device rendering each block of {half} "
              f"alone{extra}; launches a batch (K1, K2) {launches} {math_flags()}")
    return launches, out


# --- the model-axis slice: tensor parallelism over ranks the script spawns ---

TP_MODEL = 2
# (global batch 8, f32, stage 8) one iteration each from the fresh state,
# where the dp phases' per-tensor bars hold: R1, then a penalized one
TP_STEP_CASES = {
    "R1": dict(compute_dtype="float32", ema_beta=0.999),
    f"ADA {REG_TARGET} + PLR 2.0, penalized": dict(compute_dtype="float32", ema_beta=0.999, aug_p=0.5,
                                                   ada_target=REG_TARGET, plr_weight=2.0, plr_interval=REG_INTERVAL),
}
# Parameters a rank holds at model 2 (the rule on ModelSpec(); JAX's
# sharding_for_leaf gives the same leaves)
TP_RANK_PARAMS = {"gen": 10_646_632, "critic": 10_642_433}


def tp_shard_shapes(model: int = TP_MODEL) -> list:
    """(H, Cin, Cout, Cout per rank) of the path's synthesis convs whose
    kernel the model axis shards (``sharding_for_param``), in path order."""
    from byogan_tpu_torch.models.factory import ModelSpec
    from byogan_tpu_torch.parallel.tensor import sharding_for_param

    return [(r, cin, cout, cout // model) for r, cin, cout in ModelSpec().styleconv_shapes()
            if sharding_for_param("gen_blocks.1.conv_1.conv.weight", (cout, cin, 3, 3), model) is not None]


def tp_kernels(gen) -> dict:
    """The "tp kernels" phase: K1 (without and with its residuals) and K3
    at the 7 model-2 shard shapes, stage 8, batch 5, f32 and bf16 (TF32
    off), against their plain versions at ``TOL``, ``RES_TOL`` and
    ``GRAD_TOL``, and K2 at the shape it keeps under the model axis, (5, 4,
    4, 512); then, bf16 under PyTorch's defaults, each shard shape's K1
    (with residuals) and K3 card time beside the full-width shape's, with
    their tile plans.  Returns the largest errors per kernel and dtype and
    the summed times."""
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain
    from byogan_tpu_torch.ops.styleconv import plan_tiles, styleconv_cuda, styleconv_plain
    from byogan_tpu_torch.ops.styleconv_bwd import plan_backward, styleconv_backward_cuda, styleconv_backward_plain

    n, shapes = TRAIN_BATCH, tp_shard_shapes()
    require(len(shapes) == 7, f"expected 7 sharded K1 shapes at model {TP_MODEL}, got {shapes}")
    errs = {}
    with strict_f32(), torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            worst = {"styleconv": 0.0, "adain": 0.0, "styleconv_bwd": 0.0}
            for r, cin, _, cout in shapes:
                tag = f"tp K1 {str(dtype)[6:]} ({n},{r},{r},{cin}->{cout})"
                ins = k1_inputs(n, r, cin, cout, dtype, gen)
                e = max_err(styleconv_cuda(**ins), styleconv_plain(**ins), TOL[dtype])
                got, want = styleconv_cuda(**ins, with_stats=True), styleconv_plain(**ins, with_stats=True)
                e = max(e, max_err(got[0], want[0], TOL[dtype]))
                er = max(rel_err(gt, wt, RES_TOL if name == "hv" else 1e-3, f"{tag} {name}")
                         for name, gt, wt in zip(("hv", "mean", "inv"), got[1:], want[1:]))
                dy = torch.randn(want[0].shape, generator=gen, device="cuda").to(dtype)
                args = (dy, *want[1:], ins["gamma"], ins["noise"], ins["noise_w"])
                k3, p3 = styleconv_backward_cuda(*args), styleconv_backward_plain(*args)
                e3 = max(rel_err(getattr(k3, f), getattr(p3, f), GRAD_TOL[dtype], f"{tag} K3 {f}") for f in k3._fields)
                k3_abs = float((k3.dpre.float() - p3.dpre.float()).abs().max())
                torch.cuda.synchronize()
                print(f"check {tag} out max_abs_err {e:.3e} (tol {TOL[dtype]}*(1+|plain|)); residuals max rel err "
                      f"{er:.3e} (hv tol {RES_TOL}); K3 max rel err {e3:.3e} tol {GRAD_TOL[dtype]} (dpre max_abs_err "
                      f"{k3_abs:.3e}); plans {plan_tiles(n, r, r, cin, cout, dtype).describe()}; "
                      f"{plan_backward(n, r * r, cout).describe()}")
                worst["styleconv"] = max(worst["styleconv"], e)
                worst["styleconv_bwd"] = max(worst["styleconv_bwd"], k3_abs)
            ins = k2_inputs(n, 4, 512, dtype, gen)
            for stats in (False, True):
                got = noise_lrelu_adain_cuda(**ins, with_stats=stats)
                want = noise_lrelu_adain_plain(**ins, with_stats=stats)
                got, want = (got[0], want[0]) if stats else (got, want)
                worst["adain"] = max(worst["adain"], max_err(got, want, TOL[dtype]))
            print(f"check tp K2 {str(dtype)[6:]} ({n},4,4,512) max_abs_err {worst['adain']:.3e}: the initial block "
                  f"keeps its full width under the model axis (its style gathered)")
            errs[dtype] = worst
    totals = {"K1 shard ms": 0.0, "K1 full ms": 0.0, "K3 shard ms": 0.0, "K3 full ms": 0.0,
              "K1 shard bound_ms": 0.0, "K3 shard bound_ms": 0.0}
    with torch.no_grad():
        for r, cin, full, cout in shapes:
            t = {}
            for what, c in (("shard", cout), ("full", full)):
                ins = k1_inputs(n, r, cin, c, torch.bfloat16, gen)
                t[f"K1 {what}"] = timed_ms(lambda: styleconv_cuda(**ins, with_stats=True))
                _, hv, mean, inv = styleconv_cuda(**ins, with_stats=True)
                dy = torch.randn((n, r, r, c), generator=gen, device="cuda").to(torch.bfloat16)
                args = (dy, hv, mean, inv, ins["gamma"], ins["noise"], ins["noise_w"])
                t[f"K3 {what}"] = timed_ms(lambda: styleconv_backward_cuda(*args))
                totals[f"K1 {what} ms"] += t[f"K1 {what}"]
                totals[f"K3 {what} ms"] += t[f"K3 {what}"]
            b1, by1 = k1_bound(n, r, cin, cout, 2, with_stats=True)
            b3, by3 = k3_bound(n, r, cout, 2)
            totals["K1 shard bound_ms"] += b1
            totals["K3 shard bound_ms"] += b3
            print(f"time tp K1 with_stats bf16 ({n},{r},{r},{cin}->{cout}) ms {t['K1 shard']:.4f} bound_ms {b1:.4f} "
                  f"({by1}; plan {plan_tiles(n, r, r, cin, cout).describe()}) against the full width ->{full} ms "
                  f"{t['K1 full']:.4f} ({plan_tiles(n, r, r, cin, full).describe()}); K3 ({n},{r},{r},{cout}) ms "
                  f"{t['K3 shard']:.4f} bound_ms {b3:.4f} ({by3}) against {full} channels {t['K3 full']:.4f} "
                  f"(CUDA events) {math_flags()}")
    print("time tp kernels, the 7 sharded shapes summed (one rank's calls against one process's): "
          + fmt_times(totals) + f" {math_flags()}")
    return {"errs": errs, "times": totals}


def _apart(got: dict, want: dict) -> tuple:
    """(largest |a - b|, entries more than 1e-5 apart, entries) of two
    state dicts."""
    worst, far, n = 0.0, 0, 0
    for k, w in want.items():
        d = (got[k].float() - w.float()).abs()
        worst, far, n = max(worst, float(d.max())), far + int((d > 1e-5).sum()), n + d.numel()
    return worst, far, n


def _exp_avg_sq(opt_state: dict, names: list) -> dict:
    """Adam's second moments by parameter name from a state dict."""
    return {n: opt_state["state"][i]["exp_avg_sq"] for i, n in enumerate(names) if i in opt_state["state"]}


def tp_steps_job(rank: int, dev: torch.device, model: int = TP_MODEL) -> dict:
    """On each rank of a ``world/model x model`` mesh: per case of
    ``TP_STEP_CASES``, one iteration at stage 8, f32 (TF32 off), global
    batch ``DP_BATCH``, from the fresh full-width state cut to the model
    axis's blocks, on global draws made from one seed; rank 0 runs one
    process on the whole batch from the same state and draws.  Every rank
    gathers the gradients, the nets, the EMA and Adam's second moments to
    the full layout; rank 0 holds the losses within ``STEP_TOL``, every
    gradient tensor within ``STEP_GRAD_TOL``, the second moments within
    ``DP_MOMENT_TOL``, at most ``DP_FAR_SHARE`` of the weights more than
    1e-5 apart, aug_p and rt_ema equal and pl_ema within ``STEP_TOL``.
    Every rank checks its replicated leaves bit-equal to rank 0's.  Failures
    are returned, not raised, so that no rank leaves the others waiting in
    a collective.  Returns per case the (K1, K2, K3) launches on this rank
    (and one process's), the errors, the parameters this rank holds and
    the failures."""
    import types

    from byogan_tpu_torch.parallel.mesh import broadcast_, make_mesh, shard_batch, shard_train_state
    from byogan_tpu_torch.parallel.tensor import gather_named, gather_optimizer_state, gather_state_dict
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.steps import draw, make_train_step

    mesh = make_mesh(None, model, device=dev)
    result = {"backend": mesh.backend, "mesh": (mesh.size, mesh.model_size), "cases": {}, "failures": []}

    def check(cond: bool, what: str) -> None:
        if not cond:
            result["failures"].append(what)

    with strict_f32():
        for name, knobs in TP_STEP_CASES.items():
            cfg = TrainConfig(**knobs, data_axis=mesh.size, model_axis=model)
            rng = torch.Generator(device=dev).manual_seed(7)
            draws = draw(types.SimpleNamespace(rng=rng, iters=0), cfg, DP_BATCH, 8, torch.float32)
            real = torch.randint(0, 256, (DP_BATCH, 512, 512, 3), generator=rng, device=dev, dtype=torch.uint8)
            check((draws.plr is not None) == (cfg.plr_weight > 0), f"{name}: penalized iteration")
            state = shard_train_state(_dp_step_state(cfg, dev), mesh)
            held = {net: sum(p.numel() for p in getattr(state, net).parameters()) for net in ("gen", "critic")}
            step = make_train_step(cfg, 8, DP_BATCH, 8.0, (True,), True, mesh=mesh)
            case = {"params_held": held}
            if rank == 0:
                ref = _dp_step_state(cfg, dev)
                want = _step_record(make_train_step(cfg, 8, DP_BATCH, 8.0, (True,), True), ref, real, draws)
                case["single_launches"] = want["launches"]
            got = _step_record(step, state, shard_batch(real, mesh), draws)
            case["launches"] = got["launches"]
            nets = {net: getattr(state, net) for net in ("gen", "critic", "gen_ema")}
            grads = {net: gather_named({n: p.grad for n, p in nets[net].named_parameters()}, nets[net].tp_shards, mesh)
                     for net in ("gen", "critic")}
            params = {net: gather_state_dict(m, mesh) for net, m in nets.items()}
            moments = {net: _exp_avg_sq(gather_optimizer_state(getattr(state, f"{net}_opt"), nets[net], mesh),
                                        [n for n, _ in nets[net].named_parameters()]) for net in ("gen", "critic")}
            replicated = torch.cat([p.detach().reshape(-1) for m in nets.values() for n, p in m.named_parameters()
                                    if n not in m.tp_shards])
            theirs = replicated.clone()
            broadcast_([theirs], mesh)
            case["replicated_bit_equal"] = bool(torch.equal(replicated, theirs))
            case["replicated_entries"] = replicated.numel()
            check(case["replicated_bit_equal"], f"{name}: rank {rank}'s replicated leaves differ from rank 0's")
            if rank == 0:
                what = f"tp {name}"
                case["losses"] = 0.0
                for k, v in want["metrics"].items():
                    if k in ("aug_p", "rt_ema"):
                        check(got["metrics"][k] == v, f"{what} {k}: {got['metrics'][k]} vs {v}")
                    elif v != 0.0 or got["metrics"][k] != 0.0:
                        e = abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
                        check(e <= STEP_TOL, f"{what} {k}: relative error {e:.3e} over {STEP_TOL}")
                        case["losses"] = max(case["losses"], e)
                case["grads"], case["moments"] = {}, {}
                for net in ("gen", "critic"):
                    one = {n: p.grad for n, p in getattr(ref, net).named_parameters()}
                    per = grad_errs(grads[net], one, f"{what} {net} grads", check=False)
                    whole = _net_rel_l2(grads[net], one)
                    check(per[0] <= STEP_GRAD_TOL[0] and per[1] <= STEP_GRAD_TOL[1], f"{what} {net} grads {per}")
                    check(whole <= STEP_GRAD_TOL[0], f"{what} {net} grads: relative L2 of the whole {whole:.3e}")
                    case["grads"][net] = {"whole": whole, "worst tensor": per}
                    m_one = _exp_avg_sq(getattr(ref, f"{net}_opt").state_dict(),
                                        [n for n, _ in getattr(ref, net).named_parameters()])
                    e = _net_rel_l2(moments[net], m_one)
                    check(e <= DP_MOMENT_TOL[0], f"{what} {net} second moments: relative L2 {e:.3e}")
                    case["moments"][net] = e
                case["apart"] = {net: _apart(params[net], getattr(ref, net).state_dict()) for net in params}
                far, n = sum(a[1] for a in case["apart"].values()), sum(a[2] for a in case["apart"].values())
                check(far <= DP_FAR_SHARE * n, f"{what}: nets and EMA apart {case['apart']}")
                case["regularizers"] = {k: (float(getattr(state, k)), float(getattr(ref, k)))
                                        for k in ("aug_p", "rt_ema", "pl_ema") if getattr(ref, k) is not None}
                if ref.pl_ema is not None:
                    e = abs(float(state.pl_ema) - float(ref.pl_ema)) / max(abs(float(ref.pl_ema)), 1e-12)
                    check(e <= STEP_TOL, f"{what} pl_ema: relative error {e:.3e}")
                del ref
            result["cases"][name] = case
            del state, grads, params, moments
            torch.cuda.empty_cache()
    return result


def tp_steps(tmp, world: int = TP_MODEL, model: int = TP_MODEL) -> dict:
    """The "tp steps" phase (``tp_steps_job`` on ``world`` spawned ranks,
    a ``world/model x model`` mesh): per case, the errors against one
    process, the parameters each rank holds, and the launches."""
    out = spawn_ranks(tmp, "tp_steps_job", model, world=world)
    backend, (data, _) = out[0]["backend"], out[0]["mesh"]
    where = f"{world} ranks sharing one card" if backend == "gloo" else f"{world} cards"
    for name, case in out[0]["cases"].items():
        launches = [o["cases"][name]["launches"] for o in out]
        held = [o["cases"][name]["params_held"] for o in out]
        print(f"tp steps {name} (data {data} x model {model}, {backend}, {where}), f32 stage 8, global batch {DP_BATCH}, "
              f"one iteration against one process from the same state: losses max rel err {case['losses']:.3e} "
              f"(tol {STEP_TOL}); per net, gathered gradients' relative L2 of the whole and the worst tensor's (rel L2, "
              f"max) (tol {STEP_GRAD_TOL}): "
              + ", ".join(f"{net} {e['whole']:.3e} {e['worst tensor'][0]:.3e} {e['worst tensor'][1]:.3e}"
                          for net, e in case["grads"].items())
              + f"; second moments relative L2 (tol {DP_MOMENT_TOL[0]}) {case['moments']}; nets and EMA after the "
              f"step, gathered (max |diff|, entries over 1e-5, entries; held to {DP_FAR_SHARE} of entries) "
              f"{case['apart']}; regularizers (mesh, one process) {case['regularizers']}; replicated leaves bit-equal "
              f"across the ranks {[o['cases'][name]['replicated_bit_equal'] for o in out]} "
              f"({case['replicated_entries']} entries); parameters per rank {held}; launches (K1, K2, K3) per rank "
              f"{launches}, one process {case['single_launches']} {math_flags()}")
        require(all(x == case["single_launches"] for x in launches),
                f"{name}: launches {launches} vs one process's {case['single_launches']}")
        if model == TP_MODEL:
            require(all(h == TP_RANK_PARAMS for h in held), f"{name}: parameters per rank {held}, not {TP_RANK_PARAMS}")
    failures = [f for o in out for f in o["failures"]]
    require(not failures, "tp steps: " + "; ".join(failures))
    return {name: case["launches"] for name, case in out[0]["cases"].items()}


def tp_train(tmp, root) -> list:
    """The "tp train" phase: ``train`` on two ranks (gloo, this card) with
    ``model_axis = 2`` at full width, ``[DEFAULT]``'s batch_progression on
    64 synthetic images, SIGTERM to rank 1 alone at stage 5: both stop at
    one iteration, rank 0 writes one checkpoint in the full layout (the
    shapes of one process's) and one metrics file; launches per rank per
    iteration as one process's; the checkpoint resumes in one process to
    FINAL.pth, which the Sampler loads."""
    from byogan_tpu_torch.cli.main import main as train_main
    from byogan_tpu_torch.data.synthetic import write_prepared_dataset
    from byogan_tpu_torch.models.factory import ModelSpec, build_critic, build_generator
    from byogan_tpu_torch.serve import Sampler

    data = os.path.join(tmp, "dp_data")
    if not os.path.isdir(data):
        write_prepared_dataset(data, DP_IMAGES, 8, seed=1)
    cfg = os.path.join(tmp, "tp.txt")
    with open(cfg, "w") as f:
        f.write(DP_CONFIG.format(name="tp", data=data, data_axis=1, tmp=tmp) + f"model_axis = {TP_MODEL}\n")
        f.write(DP_CONFIG.format(name="tp1", data=data, data_axis=1, tmp=tmp))
    out = spawn_ranks(tmp, "dp_train_job", cfg, "tp", backend="gloo")
    iters = [o["iters"] for o in out]
    require(iters[0] == iters[1] and out[0]["stage"] == DP_SIGNAL_STAGE, f"the ranks stopped at {iters}, stage {out[0]['stage']}")
    n = iters[0]
    for r, o in enumerate(out):
        require(len(o["records"]) == n, f"rank {r}: {len(o['records'])} steps for {n} iterations")
        for k, _, _, got in o["records"]:
            require(got == (2 * (2 * k - 1), 2, 2 * k), f"rank {r} stage {k}: launches per iteration {got}")
    require(sorted(os.listdir(os.path.join(tmp, "tp_ck"))) == [f"chk-{n}.pth"], f"checkpoints {os.listdir(os.path.join(tmp, 'tp_ck'))}")
    with open(os.path.join(tmp, "tp_out", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    require([r["iter"] for r in logged] == list(range(1, n + 1)), f"metrics iterations {[r['iter'] for r in logged]}")
    require(all(math.isfinite(r["c_loss"]) and math.isfinite(r["g_loss"]) for r in logged), "non-finite losses")
    chk = os.path.join(tmp, "tp_ck", f"chk-{n}.pth")
    saved = torch.load(chk, map_location="cpu", weights_only=False)
    for net, model in (("gen", build_generator(ModelSpec())), ("critic", build_critic(ModelSpec()))):
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        require({k: tuple(v.shape) for k, v in saved[net].items()} == want, f"{net}: the checkpoint is not in the full layout")
        require(all(tuple(v["exp_avg"].shape) == tuple(p.shape) for v, p in
                    zip(saved[f"{net}_opt"]["state"].values(), model.parameters())), f"{net}_opt: moments not gathered")
    launches = [dict(zip(KERNEL_NAMES, o["launches"])) for o in out]
    print(f"tp train: two ranks (data 1 x model {TP_MODEL}, gloo, one card) stopped together at iteration {n} (stage "
          f"{DP_SIGNAL_STAGE}) in {out[0]['wall']:.2f} s; one checkpoint chk-{n}.pth in the full layout (nets and "
          f"both Adam states gathered), one metrics file of {len(logged)} records; launches per rank {launches}, per "
          f"iteration as one process's")
    records = []
    zero_launch_counts()
    t0 = time.perf_counter()
    with counting_steps(records):
        state = train_main(["tp1", "--config-file", cfg, "-c", chk])
    torch.cuda.synchronize()
    require(state.iters == 20 and records[0][0] == DP_SIGNAL_STAGE, f"the resumed run ended at {state.iters}")
    for k, _, _, got in records:
        require(got == (2 * (2 * k - 1), 2, 2 * k), f"resumed stage {k}: launches per iteration {got}")
    frames = Sampler(os.path.join(tmp, "tp1_ck", "FINAL.pth"), batch=8, seed=0).sample(8)
    require(frames.shape == (8, 512, 512, 3) and frames.std() > 0, f"frames {frames.shape}")
    print(f"tp train: chk-{n}.pth resumed in one process to FINAL.pth in {time.perf_counter() - t0:.2f} s "
          f"({len(records)} iterations); the Sampler's frames from it {frames.shape} {frames.dtype}, std {frames.std():.2f}")
    return launches


def tp_time_job(rank: int, dev: torch.device, model: int) -> dict:
    """The stage-8 bf16 iteration (no-blend path, batch ``TRAIN_BATCH``) on
    a ``world/model x model`` mesh, or with no mesh in a world of one at
    ``model`` 1: CUDA events, the peak of allocated memory over the timed
    iterations, one profiled iteration's host ms in collective ops and card
    busy ms, and the parameters this rank holds."""
    from byogan_tpu_torch.parallel.mesh import make_mesh, shard_train_state
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig()
    state = build_state(cfg, dev)
    mesh = None if model == 1 else make_mesh(None, model, device=dev)
    if mesh is not None:
        shard_train_state(state, mesh)
    gen = torch.Generator(device=dev).manual_seed(0 if mesh is None else mesh.rank)
    batch = TRAIN_BATCH * (1 if mesh is None else mesh.size)
    real = torch.randint(0, 256, (TRAIN_BATCH, 512, 512, 3), generator=gen, device=dev, dtype=torch.uint8)
    step = make_train_step(cfg, 8, batch, 8.0, (False,), False, **({} if mesh is None else {"mesh": mesh}))
    step(state, real)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    it_ms = timed_ms(lambda: step(state, real), iters=TIMED_ITERS)
    peak = torch.cuda.max_memory_allocated(dev)
    card, host = profile_totals(lambda: step(state, real))
    collective = re.compile(r"all_?reduce|broadcast|gloo|nccl", re.IGNORECASE)
    return {
        "it_ms": it_ms, "peak_gib": peak / 2**30, "mesh": None if mesh is None else (mesh.size, mesh.model_size),
        "backend": None if mesh is None else mesh.backend,
        "host_collective_ms": sum(v for k, v in host.items() if collective.search(k)),
        "card_busy_ms": sum(ms for _, ms in card.values()),
        "card_nccl_ms": sum(ms for k, (_, ms) in card.items() if "nccl" in k.lower()),
        "kernels": sum(n for n, _ in card.values()),
        "top": sorted(card.items(), key=lambda kv: -kv[1][1])[:6],
        "params_held": {net: sum(p.numel() for p in getattr(state, net).parameters()) for net in ("gen", "critic")},
    }


def tp_times(tmp, world: int = TP_MODEL, model: int = TP_MODEL) -> dict:
    """The "time tp" phase: the stage-8 bf16 iteration of one process
    against the ``world/model x model`` mesh's (two ranks sharing this card
    over gloo on one card: not a multi-card rate; NCCL with a card each
    where the machine has ``world``), each in fresh processes."""
    out = {}
    for label, w, m in (("one", 1, 1), ("mesh", world, model)):
        out[label] = spawn_ranks(tmp, "tp_time_job", m, world=w, backend="gloo" if w == 1 else None)
    for ranks in out.values():
        for r, t in enumerate(ranks):
            where = "one process, no mesh" if t["mesh"] is None else (
                f"data {t['mesh'][0]} x model {t['mesh'][1]} over {t['backend']}, "
                + ("ranks sharing one card" if t["backend"] == "gloo" else "a card each"))
            share = t["host_collective_ms"] / t["it_ms"]
            print(f"time tp {where}, rank {r}: stage-8 iteration bf16 batch {TRAIN_BATCH} a data rank "
                  f"{t['it_ms']:.3f} ms (CUDA events, {TIMED_ITERS} iterations); peak allocated "
                  f"{t['peak_gib']:.3f} GiB; profiled iteration: host ms in collective ops "
                  f"{t['host_collective_ms']:.3f} ({100 * share:.1f}% of the iteration), card busy "
                  f"{t['card_busy_ms']:.3f} ms in {t['kernels']} kernels, {t['card_nccl_ms']:.3f} ms of it in NCCL "
                  f"kernels; six largest kernels " + "; ".join(f"{k} x{c} {ms:.3f} ms" for k, (c, ms) in t["top"])
                  + f"; parameters held {t['params_held']} {math_flags()}")
    return out


# --- the image-IO slice: the port's codecs, the loader's rate, JPEG/BMP sets ---

IO_IMAGES, IO_SIDE = 32, 512  # per set: smooth (Paeth, Average rows), noisy (Up, Sub rows) and JPEG
IO_JPEG_QUALITY = 92
# A JPEG at quality 92 against its source pixels: mean |error| in LSB (the
# CPU test's bound on a smooth image with noise and one sharp edge).
IO_JPEG_MEAN_ERR = 3.0
LOADER_WORKERS = (1, 2, 8)  # 2: dataloader_threads' default
LOADER_TIMED = 5  # batches timed per loader, after its first
IO_PREP_ORIGINALS = 4  # per format, 1024 px, prepare_pyramid in this process
IO_PREP_JPEGS = 6  # 1024 px JPEG originals through cli.prep
CODEC_REPEATS = 10  # timed calls per codec reading, after one untimed
CODEC_POOL_CALLS = 40  # decodes timed on a pool of threads
# per stage: Paeth PNGs, then 2 JPEG, 2 BMP, 2 WebP files and a JPEG of each kind of fx.JPEG_KINDS among them
IO_TRAIN_IMAGES, IO_TRAIN_OTHER = 24, 13
IO_CONFIG = (
    "[io]\n"
    "data = {data}\n"
    "epoch_progression = 1,1,1,1,1,1,1,1\n"
    "fade_percentage = 2\n"
    "display_step = 1000\ncheckpoint_step = 1000\nrefresh_stat_step = 1\n"
    "checkpoint_dir = {tmp}/io_ck\noutput_dir = {tmp}/io_out\n"
)


def scenes(rng, n: int) -> np.ndarray:
    return np.concatenate([rng.random((n, 3)) * 0.8 + 0.1, rng.random((n, 3)) * 6.28,
                           rng.random((n, 3)) * 2 - 1], axis=1)


def photo(rng, h: int, w: int, noise: float = 2.0) -> np.ndarray:
    """Smooth colour with noise on top, as photos are."""
    yy, xx = np.mgrid[0:h, 0:w]
    i = int(rng.integers(0, 9))
    base = np.stack([np.sin(xx / (37 + 5 * c + i) + c) * np.cos(yy / (53 + i)) for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, noise, base.shape), 0, 255).astype(np.uint8)


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def python_lane():
    """data/png.py with its Python ``_unfilter`` alone: the native library
    taken away for the duration, so the plain reference shares no code
    with the decoder it checks."""
    from byogan_tpu_torch.data import native

    with mock.patch.object(native, "load_library", lambda: None):
        yield


def codec_fixtures():
    """``tests/torch_port_codec_fixtures.py``, loaded by its path (numpy
    alone at import)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_port_codec_fixtures.py")
    spec = importlib.util.spec_from_file_location("torch_port_codec_fixtures", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_ms(fn, repeats: int = CODEC_REPEATS) -> float:
    """Median host ms of ``fn()`` over ``repeats`` calls after one."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def pool_ms(path: str, shape: tuple) -> dict:
    """Wall ms an image of ``CODEC_POOL_CALLS`` decodes of ``path`` on a
    pool of each of ``LOADER_WORKERS`` threads (the codec's own scaling,
    without the loader), after one decode a thread."""
    from byogan_tpu_torch.data import native

    out = {}
    for workers in LOADER_WORKERS:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            list(pool.map(lambda _: native.decode_image(path, shape), range(workers)))
            t0 = time.perf_counter()
            list(pool.map(lambda _: native.decode_image(path, shape), range(CODEC_POOL_CALLS)))
            out[workers] = 1e3 * (time.perf_counter() - t0) / CODEC_POOL_CALLS
    return out


def io_checks(tmp) -> dict:
    """Builds the native image-IO library (it must build) and prints the
    compiler, the headers it finds and what the library links: zlib, never
    libpng, libjpeg or libwebp (``ldd``).  Holds the port's codecs to the
    fixtures' hashes: libjpeg-turbo's, libpng's and libwebp's (Pillow's)
    RGB, libwebp's VP8 planes and libjpeg's JPEG bytes, recorded where
    those libraries exist (``tests/torch_port_codec_fixtures.py``).
    Writes two sets of ``IO_IMAGES`` 512 px PNGs, smooth (3 in 4 Paeth rows, the rest Average, as Pillow picks on
    smooth images) and noisy (Up, Sub), and a set of JPEGs at quality
    ``IO_JPEG_QUALITY``; holds each PNG set's decode (``maybe_cache``)
    bit-equal to data/png.py in Python alone and to the sources, and the
    JPEG set's within ``IO_JPEG_MEAN_ERR`` of its sources and equal to
    one file's decode at a time; BMP files decode exactly.  Then the
    codecs' host times beside the card's name.  Returns the sets and the
    timings."""
    from byogan_tpu_torch.data import images, native, png
    from byogan_tpu_torch.data.pipeline import StageDataset
    from byogan_tpu_torch.data.synthetic import encode_bmp, encode_png_filtered, render
    from byogan_tpu_torch.native import build as native_build

    t0 = time.perf_counter()
    native_build.build(force=True)
    build_s = time.perf_counter() - t0
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout.splitlines()[0]
    headers = {h: subprocess.run(["g++", "-x", "c++", "-E", "-o", os.devnull, "-"], input=f"#include <{h}>\n",
                                 capture_output=True, text=True).returncode == 0
               for h in ("zlib.h", "png.h", "jpeglib.h", "webp/decode.h")}
    native.load_library()
    linked = subprocess.run(["ldd", str(native_build.LIBRARY)], capture_output=True, text=True,
                            check=True).stdout
    libs = sorted({line.split()[0] for line in linked.splitlines() if line.strip()})
    require(any(lib.startswith("libz.") for lib in libs), f"the library does not link zlib: {libs}")
    require(not any("png" in lib or "jpeg" in lib or "webp" in lib for lib in libs),
            f"the library links libpng, libjpeg or libwebp: {libs}")
    print(f"io: {gxx}; headers {headers}; {native_build.LIBRARY.name} built in {build_s:.2f} s by "
          f"{' '.join(native_build.command(native_build.LIBRARY.name)[:5])} ... {' '.join(native_build.LIBS)}; "
          f"links {', '.join(libs)} (zlib only: no libpng, no libjpeg, no libwebp)")

    fx = codec_fixtures()

    def encode_bytes(img, quality):
        path = os.path.join(tmp, "fixture.jpg")
        native.encode_jpeg(path, img, quality)
        with open(path, "rb") as fh:
            return fh.read()

    matched = fx.check(native.decode_image, encode_bytes, native.decode_vp8_yuv)
    files = [m for m in matched if "@" not in m and not m.startswith((f"{fx.WEBP}/", f"{fx.KINDS}/"))]
    webp = [m for m in matched if "@" not in m and m.startswith(f"{fx.WEBP}/")]
    kinds = [m for m in matched if m.startswith(f"{fx.KINDS}/")]
    planes = [m for m in matched if m.endswith("@yuv")]
    encodes = [m for m in matched if "@q" in m]
    require(len(webp) >= 20 and planes, f"the manifest holds {len(webp)} WebP files, {len(planes)} with planes")
    require(len(kinds) >= 80 and {fx.kind_of(m) for m in kinds} >= set(fx.JPEG_KINDS),
            f"the manifest holds {len(kinds)} files of the JPEG kinds")
    small = [os.path.relpath(m, fx.KINDS) for m in kinds if "/card/" not in m and "/train/" not in m]
    print(f"io fixtures: {len(matched)} of {len(matched)} hashes matched: {len(files)} JPEG/PNG files decoded to "
          f"libjpeg-turbo's / libpng's RGB ({', '.join(files)}), {len(encodes)} encodes to libjpeg's bytes "
          f"({len(fx.SOURCES)} sources x qualities {fx.QUALITIES}); {len(webp)} WebP files decoded to Pillow's RGB "
          f"(libwebp; {', '.join(os.path.relpath(m, fx.WEBP) for m in webp)}) and {len(planes)} of them to libwebp's "
          f"VP8 planes; {len(kinds)} files of the JPEG kinds (4:4:0, arithmetic, block smoothing, CMYK, YCCK, "
          f"lossless) decoded to Pillow's RGB (libjpeg-turbo 3.1.3; the 4:4:0 and arithmetic ones the JAX native "
          f"lane's too): {', '.join(small)}, {len(fx.KINDS_CARD)} card originals and {len(kinds) - len(small) - len(fx.KINDS_CARD)} "
          f"training files")

    rng = np.random.default_rng(31)
    out = {"sets": {}, "cache_s": {}}
    for name in ("smooth", "noisy", "jpeg"):
        folder = os.path.join(tmp, "io", name, "prepared", "set_8", "images")
        os.makedirs(folder)
        src = np.empty((IO_IMAGES, IO_SIDE, IO_SIDE, 3), np.uint8)
        filters = []
        for i, p in enumerate(scenes(rng, IO_IMAGES)):
            img = render(p, IO_SIDE)
            if name == "noisy":
                img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
                f = (2, 1)[i % 2]
            else:
                f = 3 if i % 4 == 0 else 4
            src[i] = img
            filters.append(f)
            if name == "jpeg":
                native.encode_jpeg(os.path.join(folder, f"image-{i:02d}.jpg"), img, IO_JPEG_QUALITY)
            else:
                with open(os.path.join(folder, f"image-{i:02d}.png"), "wb") as fh:
                    fh.write(encode_png_filtered(img, f))
        root = os.path.dirname(os.path.dirname(os.path.dirname(folder)))
        ds = StageDataset(root, 8)
        t0 = time.perf_counter()
        require(ds.maybe_cache(workers=2), f"{name} set not cached")
        out["cache_s"][(name, "native")] = time.perf_counter() - t0
        out["sets"][name] = root
        if name == "jpeg":
            one = np.stack([images.read_image(f) for f in ds.files])
            require(np.array_equal(ds._cache, one), "jpeg set: the threads' decode differs from one file's at a time")
            errs = np.abs(one.astype(np.int16) - src).mean(axis=(1, 2, 3))
            require(errs.max() <= IO_JPEG_MEAN_ERR, f"JPEG mean errors {errs.max()} over {IO_JPEG_MEAN_ERR}")
            print(f"io: jpeg set, {IO_IMAGES} JPEGs (quality {IO_JPEG_QUALITY}, {IO_SIDE} px, the port's encoder): "
                  f"maybe_cache(workers=2) equal to one file at a time, mean |error| {errs.min():.3f}-{errs.max():.3f} "
                  f"LSB (bound {IO_JPEG_MEAN_ERR}), {out['cache_s'][(name, 'native')]:.3f} s")
            continue
        t0 = time.perf_counter()
        with python_lane():
            plain = np.stack([png.read_png(f) for f in ds.files])
        out["cache_s"][(name, "python")] = time.perf_counter() - t0
        require(np.array_equal(ds._cache, plain), f"{name} set: the native decoder differs from data/png.py's")
        require(np.array_equal(ds._cache, src), f"{name} set: decoded pixels differ from the sources")
        print(f"io: {name} set, {IO_IMAGES} PNGs at {IO_SIDE} px, row filters {sorted(set(filters))}: the native "
              f"decoder bit-equal to data/png.py (Python unfilter) and to the sources; s: maybe_cache(workers=2) "
              f"{out['cache_s'][(name, 'native')]:.3f}, data/png.py one file at a time "
              f"{out['cache_s'][(name, 'python')]:.3f}")

    other = os.path.join(tmp, "io", "other")
    os.makedirs(other)
    for i, p in enumerate(scenes(rng, 4)):
        img = render(p, 96 + 8 * i)[:, : 96 + 12 * i - 5]
        path = os.path.join(other, f"b{i}.bmp")
        with open(path, "wb") as fh:
            fh.write(encode_bmp(img))
        require(np.array_equal(images.read_image(path), img), f"{path} decodes to other pixels")
    print("io: 4 BMPs (odd widths) exact")
    out["codec_ms"] = codec_times(other)
    out["codec_ms"].update(webp_codec_times(fx))
    out["codec_ms"].update(kinds_codec_times(fx, other))
    return out


def codec_times(folder: str) -> dict:
    """Host ms of the codecs, one call at a time (median of
    ``CODEC_REPEATS``): JPEG decode of a 1024 px original and of a 512 px
    image (4:2:0, quality 92, the port's encoder), PNG decode of a 512 px
    Paeth image through the native decoder beside data/png.py (zlib in
    Python, the C unfilter: PR 11's lane on this machine), JPEG encode of a
    512 px frame; then the wall ms an image of ``CODEC_POOL_CALLS`` 512 px
    decodes on pools of 1, 2 and 8 threads (the codec's own scaling,
    without the loader)."""
    from byogan_tpu_torch.data import native, png
    from byogan_tpu_torch.data.synthetic import encode_png_filtered

    rng = np.random.default_rng(61)
    paths = {}
    for side in (PREP_SIDE, IO_SIDE):
        paths[side] = os.path.join(folder, f"photo-{side}.jpg")
        native.encode_jpeg(paths[side], photo(rng, side, side), IO_JPEG_QUALITY)
    frame = photo(rng, IO_SIDE, IO_SIDE)
    png_path = os.path.join(folder, "photo-512.png")
    with open(png_path, "wb") as fh:
        fh.write(encode_png_filtered(frame, 4))
    require(np.array_equal(native.decode_image(png_path), png.read_png(png_path)), "the PNG timed decodes differently")
    ms = {
        "jpeg_decode_1024": host_ms(lambda: native.decode_image(paths[PREP_SIDE], (PREP_SIDE, PREP_SIDE))),
        "jpeg_decode_512": host_ms(lambda: native.decode_image(paths[IO_SIDE], (IO_SIDE, IO_SIDE))),
        "png_decode_512": host_ms(lambda: native.decode_image(png_path, (IO_SIDE, IO_SIDE))),
        "png_decode_512_png_py": host_ms(lambda: png.read_png(png_path)),
        "jpeg_encode_512": host_ms(lambda: native.encode_jpeg(os.path.join(folder, "enc.jpg"), frame,
                                                              IO_JPEG_QUALITY)),
    }
    for fmt, path in (("jpeg", paths[IO_SIDE]), ("png", png_path)):
        for workers, t in pool_ms(path, (IO_SIDE, IO_SIDE)).items():
            ms[f"{fmt}_decode_512_pool_{workers}"] = t
    print(f"io codecs: host ms, median of {CODEC_REPEATS} calls, one thread: JPEG decode 4:2:0 q{IO_JPEG_QUALITY} "
          f"{PREP_SIDE} px {ms['jpeg_decode_1024']:.3f}, {IO_SIDE} px {ms['jpeg_decode_512']:.3f}; PNG decode "
          f"{IO_SIDE} px Paeth: native {ms['png_decode_512']:.3f}, data/png.py (C unfilter) "
          f"{ms['png_decode_512_png_py']:.3f}; JPEG encode {IO_SIDE} px q{IO_JPEG_QUALITY} {ms['jpeg_encode_512']:.3f}; "
          f"wall ms an image of {CODEC_POOL_CALLS} {IO_SIDE} px decodes on a pool of " + "/".join(map(str, LOADER_WORKERS))
          + " threads: JPEG " + "/".join(f"{ms[f'jpeg_decode_512_pool_{w}']:.3f}" for w in LOADER_WORKERS)
          + ", PNG " + "/".join(f"{ms[f'png_decode_512_pool_{w}']:.3f}" for w in LOADER_WORKERS)
          + f" ({os.cpu_count()} CPUs); card {card_name()}")
    return ms


def webp_codec_times(fx) -> dict:
    """Host ms of the WebP decoder, one call at a time (median of
    ``CODEC_REPEATS``), on the committed originals: VP8 at 1024 and 512 px,
    VP8L at 512 px; then the wall ms an image of ``CODEC_POOL_CALLS`` 512
    px decodes on pools of 1, 2 and 8 threads."""
    from byogan_tpu_torch.data import native

    card_dir = os.path.join(fx.FIXTURES, fx.WEBP, "card")
    files = {"vp8_1024": ("lossy-1024.webp", 1024, 1024), "vp8_512": ("lossy-512.webp", 512, 512),
             "vp8l_512": ("lossless-512.webp", 512, 512)}
    ms = {}
    for key, (name, h, w) in files.items():
        path = os.path.join(card_dir, name)
        ms[f"webp_{key}"] = host_ms(lambda: native.decode_image(path, (h, w)))
    for key in ("vp8_512", "vp8l_512"):
        for workers, t in pool_ms(os.path.join(card_dir, files[key][0]), (512, 512)).items():
            ms[f"webp_{key}_pool_{workers}"] = t
    print(f"io codecs: WebP decode to RGB, host ms, median of {CODEC_REPEATS} calls, one thread: VP8 (lossy, "
          f"fancy upsampling) 1024 px {ms['webp_vp8_1024']:.3f}, 512 px {ms['webp_vp8_512']:.3f}; VP8L (lossless) "
          f"512 px {ms['webp_vp8l_512']:.3f}; wall ms an image of {CODEC_POOL_CALLS} 512 px decodes on a pool of "
          + "/".join(map(str, LOADER_WORKERS)) + " threads: VP8 "
          + "/".join(f"{ms[f'webp_vp8_512_pool_{w}']:.3f}" for w in LOADER_WORKERS) + ", VP8L "
          + "/".join(f"{ms[f'webp_vp8l_512_pool_{w}']:.3f}" for w in LOADER_WORKERS)
          + f" ({os.cpu_count()} CPUs); card {card_name()}")
    return ms


def kinds_codec_times(fx, folder: str) -> dict:
    """Host ms of the JPEG decoder on the kinds, one call at a time (median
    of ``CODEC_REPEATS``), each beside a Huffman baseline file of the same
    source pixels at the same quality (4:2:0, the port's encoder, which
    writes libjpeg's bytes): arithmetic sequential and progressive at 1024
    and 512 px, CMYK, YCCK, 4:4:0 and the block-smoothed progressive file
    at 1024 px, lossless at 512 px; then the wall ms an image of
    ``CODEC_POOL_CALLS`` 512 px decodes, arithmetic and CMYK, on pools of
    1, 2 and 8 threads."""
    from byogan_tpu_torch.data import native

    files = {f"{k}_1024": f"card/{k}-1024.jpg" for k in ("arith", "arith-prog", "cmyk", "ycck", "440", "smoothed")}
    files.update({"arith_512": "train/512-arith.jpg", "arith-prog_512": "train/512-arith-prog.jpg",
                  "lossless_512": "card/lossless-512.jpg"})
    ms = {}
    for key, name in files.items():
        path = os.path.join(fx.FIXTURES, fx.KINDS, name)
        src = fx.kind_source(name)
        twin = os.path.join(folder, f"twin-{key}.jpg")
        native.encode_jpeg(twin, src, fx.KINDS_QUALITY)
        shape = src.shape[:2]
        ms[f"kind_{key}"] = host_ms(lambda: native.decode_image(path, shape))
        ms[f"kind_{key}_baseline"] = host_ms(lambda: native.decode_image(twin, shape))
    for key in ("arith", "cmyk"):
        for workers, t in pool_ms(os.path.join(fx.FIXTURES, fx.KINDS, "train", f"512-{key}.jpg"), (512, 512)).items():
            ms[f"kind_{key}_512_pool_{workers}"] = t
    print(f"io codecs: JPEG kinds, host ms, median of {CODEC_REPEATS} calls, one thread, each beside the same "
          f"pixels' Huffman baseline (q{fx.KINDS_QUALITY}, 4:2:0): "
          + ", ".join(f"{key} {ms[f'kind_{key}']:.3f} ({ms[f'kind_{key}_baseline']:.3f})" for key in files)
          + f"; wall ms an image of {CODEC_POOL_CALLS} 512 px decodes on a pool of "
          + "/".join(map(str, LOADER_WORKERS)) + " threads: arithmetic "
          + "/".join(f"{ms[f'kind_arith_512_pool_{w}']:.3f}" for w in LOADER_WORKERS) + ", CMYK "
          + "/".join(f"{ms[f'kind_cmyk_512_pool_{w}']:.3f}" for w in LOADER_WORKERS)
          + f" ({os.cpu_count()} CPUs); card {card_name()}")
    return ms


def prep_committed_cli(tmp, root, folder: str, names, key: str) -> tuple:
    """``python -m byogan_tpu_torch.cli.prep <dir> 4 512 -y`` on the
    committed originals ``names`` of ``fx.FIXTURES/folder``, the resizes on
    the card: every image of the 8 sets equal to the one the JAX package's
    ``prepare_pyramid`` wrote from them (the fixtures' manifest's ``key``).
    Returns the seconds the CLI took, process start included, and the
    images matched."""
    from byogan_tpu_torch.data import images

    fx = codec_fixtures()
    data = os.path.join(tmp, f"prep_{key}")
    os.makedirs(data)
    for name in sorted(names):
        shutil.copy(os.path.join(fx.FIXTURES, folder, name), data)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "byogan_tpu_torch.cli.prep", data, "4", "512", "-y"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli.prep exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    matched = fx.check_prep(data, images.read_image, key)
    require(matched == 8 * len(names), f"{matched} prepared images, expected {8 * len(names)}")
    return cli_s, matched


def prep_kinds_cli(tmp, root) -> float:
    """``prep_committed_cli`` on the originals of the JPEG kinds
    (arithmetic sequential and progressive, CMYK, YCCK, 4:4:0 and
    block-smoothed at 1024 px, lossless at 512 px), held to the JAX
    package's prep of them (Pillow's decode).  Returns the seconds per
    original."""
    fx = codec_fixtures()
    n = len(fx.KINDS_CARD)
    cli_s, matched = prep_committed_cli(tmp, root, os.path.join(fx.KINDS, "card"), fx.KINDS_CARD, "jpeg_prep")
    print(f"io prep: cli.prep of {n} originals of the JPEG kinds ({', '.join(sorted(fx.KINDS_CARD))}) to 8 sets in "
          f"{cli_s:.2f} s, {cli_s / n:.3f} s per original (process start included, 8 worker threads, resizes on the "
          f"card); {matched} of {matched} images equal to the JAX package's prepare_pyramid (Pillow's decode and "
          f"resize, hashes in the fixtures' manifest); card {card_name()}")
    return cli_s / n


def prep_webp_cli(tmp, root) -> float:
    """``prep_committed_cli`` on the WebP originals (lossy 512 px, 640 x
    480 and 1024 px, lossless 512 px, lossy with alpha 448 x 320), held to
    the JAX package's prep of them.  Returns the seconds per original."""
    fx = codec_fixtures()
    n = len(fx.WEBP_CARD)
    cli_s, matched = prep_committed_cli(tmp, root, os.path.join(fx.WEBP, "card"), fx.WEBP_CARD, "webp_prep")
    print(f"io prep: cli.prep of {n} WebP originals (VP8 512 px, 640 x 480 and 1024 px, VP8L 512 px, VP8X + ALPH "
          f"448 x 320) to 8 sets in {cli_s:.2f} s, {cli_s / n:.3f} s per original (process start included, 8 worker "
          f"threads, resizes on the card); {matched} of {matched} images equal to the JAX package's prepare_pyramid "
          f"(Pillow's decode and resize, hashes in the fixtures' manifest); card {card_name()}")
    return cli_s / n


def prep_jpeg_cli(tmp, root) -> float:
    """``python -m byogan_tpu_torch.cli.prep <dir> 4 512 -y --pack`` on
    ``IO_PREP_JPEGS`` 1024 px JPEG originals (one 768 x 1024), the resizes
    on the card: every level bit-equal to the plain numpy resize of the
    original's pixels as ``read_image`` decodes them (the fixtures hold
    that decode to libjpeg's).  Returns the seconds per original, process
    start included."""
    from byogan_tpu_torch.core.resize import resize_uint8_bilinear_pil_plain
    from byogan_tpu_torch.data import images, native
    from byogan_tpu_torch.data.pipeline import StageDataset

    data = os.path.join(tmp, "prep_jpeg_cli")
    os.makedirs(data)
    rng = np.random.default_rng(71)
    names = []
    for i in range(IO_PREP_JPEGS):
        h = 768 if i == 1 else PREP_SIDE
        names.append(f"orig-{i:02d}.jpg")
        native.encode_jpeg(os.path.join(data, names[-1]), photo(rng, h, PREP_SIDE, noise=12), IO_JPEG_QUALITY)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "byogan_tpu_torch.cli.prep", data, "4", "512", "-y", "--pack"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli.prep exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    require("dataset ready: 8 resolution sets" in proc.stdout, f"cli.prep said {proc.stdout[-500:]}")
    for n, name in enumerate(names):
        level = images.read_image(os.path.join(data, "original", "images", name))
        for size in (512, 256, 128, 64, 32, 16, 8, 4):
            level = resize_uint8_bilinear_pil_plain(level, size)
            k = int(math.log2(size // 4)) + 1
            got = images.read_image(os.path.join(data, "prepared", f"set_{k}", "images", f"image-{n}.png"))
            require(np.array_equal(got, level), f"prep {name} at {size} px differs from the plain resize")
    packed = np.load(os.path.join(StageDataset(data, 8).set_dir, "packed.npy"))
    require(packed.shape == (IO_PREP_JPEGS, 512, 512, 3), f"set_8 packed {packed.shape}")
    print(f"io prep: cli.prep of {IO_PREP_JPEGS} JPEG originals ({PREP_SIDE} px, one 768 x {PREP_SIDE}, quality "
          f"{IO_JPEG_QUALITY}) to 8 sets with --pack in {cli_s:.2f} s, {cli_s / IO_PREP_JPEGS:.3f} s per original "
          f"(process start included, 8 worker threads, resizes on the card); every level bit-equal to the plain "
          f"numpy resize of the decoded original; card {card_name()}")
    return cli_s / IO_PREP_JPEGS


def time_loader(io_state: dict, it_ms, tmp, root) -> dict:
    """``make_stage_loader`` over each set at 512 px (smooth and noisy
    PNGs, JPEGs), batch 5, cache off, on 1, 2 and 8 decode threads: ms per
    batch after the first, beside the stage-8 iteration's ms from this run.
    Then ``prepare_pyramid`` (card resizes, 8 threads) in this process on
    1024 px originals, Paeth PNGs, BMPs and JPEGs, seconds per original;
    ``cli.prep`` on JPEG originals (``prep_jpeg_cli``); and
    ``save_frame_u8`` ms per 512 px frame as PNG (levels 1 and 6) and
    JPEG."""
    from byogan_tpu_torch.data import native
    from byogan_tpu_torch.data.pipeline import StageDataset, make_stage_loader
    from byogan_tpu_torch.data.prep import prepare_pyramid
    from byogan_tpu_torch.data.synthetic import encode_bmp, encode_png_filtered
    from byogan_tpu_torch.serve import save_frame_u8

    iteration = "not measured in this run" if it_ms is None else f"{it_ms:.3f} ms"
    card = card_name()
    rates = {}
    for name, data_root in io_state["sets"].items():
        for workers in LOADER_WORKERS:
            ds = StageDataset(data_root, 8, cache_limit_bytes=0)
            loader = make_stage_loader(ds, TRAIN_BATCH, seed=workers, workers=workers)
            next(loader)
            t0 = time.perf_counter()
            for _ in range(LOADER_TIMED):
                next(loader)
            ms = 1e3 * (time.perf_counter() - t0) / LOADER_TIMED
            loader.close()
            rates[(name, workers)] = ms
            rows = np.arange(TRAIN_BATCH)
            batch_ms = host_ms(lambda: ds.get_batch_uint8(rows, workers), LOADER_TIMED)
            print(f"time loader {name} workers {workers}: {ms:.3f} ms per batch of {TRAIN_BATCH} at {IO_SIDE} px, "
                  f"cache off ({LOADER_TIMED} batches after the first; host clock); get_batch_uint8 alone (no "
                  f"producer thread, flips or queue) {batch_ms:.3f} ms; stage-8 iteration {iteration}; card {card}")

    rng = np.random.default_rng(41)
    prep_s = {}
    for fmt in ("png", "bmp", "jpeg"):
        data = os.path.join(os.path.dirname(io_state["sets"]["smooth"]), f"prep_{fmt}")
        os.makedirs(data)
        for i in range(IO_PREP_ORIGINALS):
            img = photo(rng, PREP_SIDE, PREP_SIDE)
            path = os.path.join(data, f"orig-{i}." + {"png": "png", "bmp": "bmp", "jpeg": "jpg"}[fmt])
            if fmt == "jpeg":
                native.encode_jpeg(path, img, IO_JPEG_QUALITY)
            else:
                with open(path, "wb") as fh:
                    fh.write(encode_png_filtered(img, 4) if fmt == "png" else encode_bmp(img))
        t0 = time.perf_counter()
        prepare_pyramid(data, 4, 512, workers=8)
        torch.cuda.synchronize()
        prep_s[fmt] = (time.perf_counter() - t0) / IO_PREP_ORIGINALS
    print(f"time prep: prepare_pyramid in this process, {IO_PREP_ORIGINALS} originals of {PREP_SIDE} px a format, "
          f"8 sets, 8 threads, s per original: " + ", ".join(f"{f} {s:.3f}" for f, s in prep_s.items())
          + " (PNG originals under Paeth rows; the \"prep:\" line's cli.prep reading is the one to hold against "
          "PR 9's 0.858 s)")
    prep_jpeg_s = prep_jpeg_cli(tmp, root)
    prep_webp_s = prep_webp_cli(tmp, root)
    prep_kinds_s = prep_kinds_cli(tmp, root)

    frames = StageDataset(io_state["sets"]["smooth"], 8).get_batch_uint8(np.arange(8), 2)
    frame_ms = {}
    out_dir = os.path.join(os.path.dirname(io_state["sets"]["smooth"]), "frames")
    os.makedirs(out_dir)
    lanes = [("png level 1", "png", {"png_compression": 1}), ("png level 6", "png", {"png_compression": 6}),
             (f"jpeg quality {IO_JPEG_QUALITY}", "jpeg", {"jpeg_quality": IO_JPEG_QUALITY})]
    for label, fmt, kw in lanes:
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            save_frame_u8(f, os.path.join(out_dir, f"{fmt}-{kw}-{i}"), fmt, **kw)
        frame_ms[label] = 1e3 * (time.perf_counter() - t0) / len(frames)
    print(f"time frames: save_frame_u8 ms per {IO_SIDE} px frame ({len(frames)} frames, host clock): "
          + ", ".join(f"{k} {v:.3f}" for k, v in frame_ms.items()) + f"; card {card}")
    return {"loader_ms": rates, "prep_s": prep_s, "prep_jpeg_cli_s": prep_jpeg_s, "prep_webp_cli_s": prep_webp_s,
            "prep_kinds_cli_s": prep_kinds_s,
            "frame_ms": frame_ms}


def uncached_stage8_cli(argv: list) -> int:
    """The training CLI with the stage-8 set never cached (every batch
    decoded by the loader): ``io_train`` runs it in a subprocess."""
    from byogan_tpu_torch.cli.main import main as train_main
    from byogan_tpu_torch.data import pipeline
    from byogan_tpu_torch.train import loop

    def open_uncached(root, stage):
        return pipeline.open_stage_dataset(root, stage, cache_limit_bytes=0 if stage == 8 else pipeline.CACHE_LIMIT_BYTES)

    with mock.patch.object(loop, "open_stage_dataset", open_uncached):
        train_main(argv)
    return 0


def io_train(tmp, root) -> tuple:
    """The training CLI at full width on a prepared set of Paeth PNGs with
    non-PNG files among them (2 JPEG, 2 BMP and 2 WebP a stage: the
    committed lossy and lossless files of each stage's size, so the loader
    decodes VP8 and VP8L on every stage-8 batch; and a committed JPEG of
    each kind of ``fx.JPEG_KINDS`` at each stage's size: 4:4:0,
    arithmetic sequential and progressive, block-smoothed, CMYK, YCCK,
    lossless), stage 8 uncached: ``len()`` counts them, the stage-8
    dataset's batch of the kinds' files equals their manifest hashes; a
    subprocess stopped by SIGTERM once its metrics
    show stage 5; ``--auto-resume`` with no ``-c`` picks the checkpoint the
    stop wrote and runs to FINAL (launches per iteration counted); then
    ``cli.generate_samples FINAL.pth 8 --format jpeg --pallas``, its JPEG
    frames read back by the port's decoder.  Returns the resume's launches
    and the sampling CLI's."""
    from byogan_tpu_torch.cli.generate_samples import main as generate_main
    from byogan_tpu_torch.data import images, native
    from byogan_tpu_torch.data.pipeline import open_stage_dataset
    from byogan_tpu_torch.data.synthetic import encode_bmp, encode_png_filtered, render
    from byogan_tpu_torch.train.checkpoint import latest_checkpoint

    fx = codec_fixtures()
    t0 = time.perf_counter()
    data = os.path.join(tmp, "io_data")
    params = scenes(np.random.default_rng(51), IO_TRAIN_IMAGES)
    for stage in range(1, 9):
        size = 4 * 2 ** (stage - 1)
        folder = os.path.join(data, "prepared", f"set_{stage}", "images")
        os.makedirs(folder)
        for i, p in enumerate(params):
            img = render(p, size)
            k = i - (IO_TRAIN_IMAGES - IO_TRAIN_OTHER)
            if k >= 6:
                kind = fx.JPEG_KINDS[k - 6]
                shutil.copy(os.path.join(fx.FIXTURES, fx.KINDS, "train", f"{size}-{kind}.jpg"),
                            os.path.join(folder, f"image-{i}.jpg"))
            elif k >= 4:
                kind = ("lossy", "lossless")[k - 4]
                shutil.copy(os.path.join(fx.FIXTURES, fx.WEBP, "train", f"{size}-{kind}.webp"),
                            os.path.join(folder, f"image-{i}.webp"))
            elif 0 <= k < 2:
                native.encode_jpeg(os.path.join(folder, f"image-{i}.jpg"), img, IO_JPEG_QUALITY)
            elif k >= 0:
                with open(os.path.join(folder, f"image-{i}.bmp"), "wb") as fh:
                    fh.write(encode_bmp(img))
            else:
                with open(os.path.join(folder, f"image-{i}.png"), "wb") as fh:
                    fh.write(encode_png_filtered(img, 4))
    stage8 = open_stage_dataset(data, 8, cache_limit_bytes=0)
    kinds = sorted({os.path.splitext(f)[1] for f in stage8.files})
    require(len(stage8) == IO_TRAIN_IMAGES, f"the stage-8 set counts {len(stage8)} of {IO_TRAIN_IMAGES} files")
    require(".webp" in kinds, f"no WebP file in set_8: {kinds}")
    manifest = fx.load_manifest()["files"]
    first = IO_TRAIN_IMAGES - IO_TRAIN_OTHER + 6
    rows = np.array([stage8.files.index(os.path.join(data, "prepared", "set_8", "images", f"image-{first + j}.jpg"))
                     for j in range(len(fx.JPEG_KINDS))])
    for kind, img in zip(fx.JPEG_KINDS, stage8.get_batch_uint8(rows, 2)):
        require(fx.sha256(img) == manifest[f"{fx.KINDS}/train/512-{kind}.jpg"]["sha256_rgb"],
                f"the stage-8 dataset read its {kind} file to other pixels than Pillow's")
    print(f"io train: wrote {IO_TRAIN_IMAGES} images x 8 stages ({kinds}) in {time.perf_counter() - t0:.2f} s; "
          f"len() of set_8 {len(stage8)}")

    cfg = os.path.join(tmp, "io.txt")
    with open(cfg, "w") as f:
        f.write(IO_CONFIG.format(data=data, tmp=tmp))
    metrics = os.path.join(tmp, "io_out", "metrics.jsonl")
    log_path = os.path.join(tmp, "io_run.log")
    argv = ["io", "--config-file", cfg, "--auto-resume"]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.uncached_stage8_cli(sys.argv[1:]))",
             *argv], cwd=root, stdout=log, stderr=subprocess.STDOUT,
        )
        try:
            stage = 0
            while stage < 5:
                require(proc.poll() is None, f"the training CLI ended (rc {proc.returncode}) before stage 5")
                require(time.perf_counter() - t0 < 600, "no stage-5 metrics within 600 s")
                time.sleep(0.05)
                if os.path.exists(metrics):
                    with open(metrics) as f:
                        stage = max([json.loads(line)["stage"] for line in f if line.endswith("\n")], default=0)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path) as f:
        out = f.read()
    require(rc == 0, f"the training CLI exited {rc} after SIGTERM:\n{out[-3000:]}")
    found = re.search(r"preemption checkpoint saved: (\S+)", out)
    require(found is not None, f"no stop line in the CLI's output:\n{out[-3000:]}")
    ckpt = found.group(1)
    chosen = latest_checkpoint(os.path.join(tmp, "io_ck"))
    require(chosen == ckpt, f"latest_checkpoint picks {chosen}, not the stop's {ckpt}")
    saved_iter = torch.load(ckpt, map_location="cpu", weights_only=False)["iter"]
    print(f"io train: SIGTERM at stage {stage}, the CLI exited {rc} after {time.perf_counter() - t0:.2f} s; "
          f"{found.group(0)} (iteration {saved_iter}); latest_checkpoint picks it")

    records = []
    zero_launch_counts()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with counting_steps(records), contextlib.redirect_stdout(printed):
        uncached_stage8_cli(argv)
    torch.cuda.synchronize()
    launches = dict(zip(KERNEL_NAMES, launch_counts()))
    require(f"auto-resuming from {ckpt}" in printed.getvalue(), f"the resume did not start from {ckpt}:\n"
            f"{printed.getvalue()[-3000:]}")
    print(printed.getvalue().strip().splitlines()[-1])
    require(len(records) == 16 - saved_iter, f"{len(records)} iterations resumed after iteration {saved_iter}")
    for k, _, _, got in records:
        require(got == (2 * (2 * k - 1), 2, 2 * k), f"io stage {k}: launches per iteration {got}")
    require(all(v > 0 for v in launches.values()), f"a kernel of the io training path never ran: {launches}")
    final = os.path.join(tmp, "io_ck", "FINAL.pth")
    require(latest_checkpoint(os.path.join(tmp, "io_ck")) == final, "FINAL.pth is not the latest after the resume")
    print(f"io train: --auto-resume to FINAL.pth in {time.perf_counter() - t0:.2f} s, {len(records)} iterations "
          f"(stages {records[0][0]}-8, set_8 uncached, dataloader_threads' default 2); launches {launches}")

    frames_dir = os.path.join(tmp, "io_frames")
    os.makedirs(frames_dir)
    zero_launch_counts()
    generate_main([final, "8", "-o", frames_dir, "--seed", "0", "--format", "jpeg", "--pallas"])
    torch.cuda.synchronize()
    sample_launches = dict(zip(KERNEL_NAMES, launch_counts()))
    require(sorted(os.listdir(frames_dir)) == sorted(f"image_{i}.jpg" for i in range(1, 9)), "generate_samples files")
    for i in range(1, 9):
        img = images.read_image(os.path.join(frames_dir, f"image_{i}.jpg"))
        require(img.shape == (512, 512, 3) and img.std() > 0, f"frame {i}: {img.shape}")
    require(sample_launches["styleconv"] == 15 and sample_launches["adain"] == 1, f"sampling launches {sample_launches}")
    print(f"io train: cli.generate_samples FINAL.pth 8 --format jpeg --pallas: 8 JPEG frames of 512 px read back "
          f"by the port's decoder; launches {sample_launches}")
    return launches, sample_launches


def io_main() -> int:
    """The image-IO phases alone (``python -c "import chip_smoke;
    chip_smoke.io_main()"``), for a short call; ``main`` runs them too."""
    require(torch.cuda.is_available(), "no CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from byogan_tpu_torch.ops import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}; {card}")
    build.build()
    with tempfile.TemporaryDirectory() as tmp:
        with phase("io"):
            io_state = io_checks(tmp)
        with phase("time loader"):
            time_loader(io_state, None, tmp, root)
        with phase("io train"):
            io_train(tmp, root)
    return 0


def dp_cards_main() -> int:
    """On a machine with several cards (``python -c "import chip_smoke;
    chip_smoke.dp_cards_main()"``): the dp steps over NCCL, one card a
    rank, with two ranks and with four where there are four, and the
    iteration's times over gloo on one card and NCCL on two."""
    require(torch.cuda.device_count() >= DP_WORLD, f"{torch.cuda.device_count()} cards")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from byogan_tpu_torch.ops import build

    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    build.build()
    with tempfile.TemporaryDirectory() as tmp:
        for world in (DP_WORLD, 4):
            if torch.cuda.device_count() >= world:
                with phase(f"dp steps, {world} cards"):
                    dp_steps(tmp, world)
        with phase("time dp"):
            dp_times(tmp)
    return 0


def dp_main() -> int:
    """The data-parallel phases alone (``python -c "import chip_smoke;
    chip_smoke.dp_main()"``), for a short call; ``main`` runs them too."""
    require(torch.cuda.is_available(), "no CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from byogan_tpu_torch.models.factory import ModelSpec, build_generator
    from byogan_tpu_torch.ops import build

    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    build.build()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gen.pth")
        torch.save({"gen": build_generator(ModelSpec(), generator=torch.Generator().manual_seed(0)).state_dict(),
                    "step": 8, "alpha": None}, ckpt)
        with phase("dp steps"):
            dp_steps(tmp)
        with phase("dp train"):
            dp_train(tmp, root)
        with phase("time dp"):
            dp_times(tmp)
        with phase("dp sampler"):
            dp_sampler(ckpt)
    return 0


def tp_main() -> int:
    """The model-axis phases alone (``python -c "import chip_smoke;
    chip_smoke.tp_main()"``), for a short call; ``main`` runs them too."""
    require(torch.cuda.is_available(), "no CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from byogan_tpu_torch.ops import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; {card}")
    build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        with phase("tp kernels"):
            tp_kernels(gen)
        with phase("tp steps"):
            tp_steps(tmp)
        with phase("tp train"):
            tp_train(tmp, root)
        with phase("time tp"):
            tp_times(tmp)
    return 0


def tp_cards_main() -> int:
    """On a machine with several cards (``python -c "import chip_smoke;
    chip_smoke.tp_cards_main()"``): the tp steps over NCCL, one card a rank,
    at data 1 x model 2 on two cards and data 2 x model 2 on four where
    there are four, and the iteration's time on each against one process."""
    require(torch.cuda.device_count() >= TP_MODEL, f"{torch.cuda.device_count()} cards")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from byogan_tpu_torch.ops import build

    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    build.build()
    with tempfile.TemporaryDirectory() as tmp:
        for world in (TP_MODEL, 2 * TP_MODEL):
            if torch.cuda.device_count() >= world:
                with phase(f"tp steps, {world} cards"):
                    tp_steps(tmp, world)
                with phase(f"time tp, {world} cards"):
                    tp_times(tmp, world)
    return 0


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
    from byogan_tpu_torch.ops.cardcheck import forced_plan, kernel_ms
    from byogan_tpu_torch.ops.styleconv import bf16_plan, plan_tiles, styleconv_cuda, styleconv_plain
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
    hmma = tensor_core_instructions(build.library_path("styleconv"), build.nvcc())
    print(f"sass: {hmma} HMMA/HGMMA instructions in {build.library_path('styleconv').name}")
    require(hmma > 0, "the bf16 K1 has no tensor-core instruction in its SASS")

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = ModelSpec().styleconv_shapes()
    require(len(shapes) == 15, f"expected 15 K1 shapes, got {len(shapes)}")
    k2_shapes = [(4, 512), (64, 128), (512, 16)]  # the path's, then split-HW

    # Phase 3: each kernel against its plain version, f32 then bf16.
    errs = {}
    with torch.inference_mode(), strict_f32():
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
    with strict_f32():
        extra_errs = k1_extra_checks(gen)
        k2_errs = k2_checks(gen)

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

        zero_launch_counts()
        t0 = time.perf_counter()
        frames = sampler.sample(FRAMES)
        main_s = time.perf_counter() - t0
        launches = dict(zip(KERNEL_NAMES[:2], launch_counts()[:2]))
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
        with torch.inference_mode(), strict_f32():
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
            f"{render_ms:.3f} ms per batch (CUDA events) {math_flags()}"
        )
        totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "device_ms": 0.0, "library_device_ms": 0.0, "bound_ms": 0.0}
        bound_by_kind = {"bytes": 0.0, "operations": 0.0}
        with torch.inference_mode():
            for r, cin, cout in shapes:
                ins = k1_inputs(PATH_BATCH, r, cin, cout, torch.bfloat16, gen)
                t = {
                    "ms": timed_ms(lambda: styleconv_cuda(**ins)),
                    "plain_ms": timed_ms(lambda: styleconv_plain(**ins)),
                    "library_ms": timed_ms(lambda: k1_library(**ins)),
                    "library_device_ms": device_ms(lambda: k1_library(**ins)),
                }
                parts_k1 = kernel_ms(lambda: styleconv_cuda(**ins))
                t["device_ms"] = sum(parts_k1.values())
                t["bound_ms"], by = k1_bound(PATH_BATCH, r, cin, cout, 2)
                bound_by_kind[by] += t["bound_ms"]
                for k in totals:
                    totals[k] += t[k]
                plan = plan_tiles(PATH_BATCH, r, r, cin, cout)
                print(f"time K1 bf16 ({PATH_BATCH},{r},{r},{cin}->{cout}) " + " ".join(f"{k} {v:.4f}" for k, v in t.items())
                      + f" bound_by {by}; plan: {plan.describe()}; device ms by kernel: {fmt_times(parts_k1)} {math_flags()}")
                if r <= 8:  # the same call with whole samples per tile, for comparison
                    for bm in (64, 128):
                        alt = bf16_plan(PATH_BATCH, r, r, cin, cout, bm)
                        with forced_plan(bm):
                            ms = timed_ms(lambda: styleconv_cuda(**ins))
                            dms = device_ms(lambda: styleconv_cuda(**ins))
                        print(f"time K1 bf16 ({PATH_BATCH},{r},{r},{cin}->{cout}) other plan ms {ms:.4f} device_ms {dms:.4f}: {alt.describe()} {math_flags()}")
            k1_by = max(bound_by_kind, key=bound_by_kind.get)
            ins2 = k2_inputs(PATH_BATCH, 4, 512, torch.bfloat16, gen)
            k2 = {
                "ms": timed_ms(lambda: noise_lrelu_adain_cuda(**ins2)),
                "plain_ms": timed_ms(lambda: noise_lrelu_adain_plain(**ins2)),
                "library_ms": timed_ms(lambda: k2_library(**ins2)),
            }
            k2.update(k2_card_times(ins2, gen))
            k2["bound_ms"], k2_by = k2_bound(PATH_BATCH, 4, 512, 2)
            print(f"time K2 bf16 ({PATH_BATCH},4,4,512) " + " ".join(f"{k} {v:.5f}" for k, v in k2.items()
                                                                   if not isinstance(v, dict))
                  + f" bound_by {k2_by}; with residuals, device ms {fmt_times(k2['with_stats'])} {math_flags()}")
            for r, c in k2_shapes[1:]:
                insx = k2_inputs(PATH_BATCH, r, c, torch.bfloat16, gen)
                kx = timed_ms(lambda: noise_lrelu_adain_cuda(**insx), iters=10)
                bx, _ = k2_bound(PATH_BATCH, r, c, 2)
                print(f"time K2 bf16 ({PATH_BATCH},{r},{r},{c}) ms {kx:.4f} bound_ms {bx:.4f} (split-HW, off the path) {math_flags()}")

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

        # Phases 7-10: the training path.
        with strict_f32():
            train_errs = training_kernels(shapes, gen)
        train_launches, train_wall = train_through_cli(tmp)
        with strict_f32():
            stage8_step_kernel_vs_plain()
        (k1s, k1s_by), (k3, k3_by), it_ms = training_times(shapes, gen)

        # Phases 11-12: the EMA, style-mixing and preemption slice, then its
        # sampling surfaces on the EMA weights.
        slice_train, final = slice_training(tmp, root)
        slice_times(gen)
        slice_sample = slice_sampling(tmp, final)

        # Phases 13-16: the W-space and eval slice on FINAL.pth's EMA
        # weights: projections (counting launches per iteration), the
        # projection gradient kernel vs plain path, the four CLIs, SWD and
        # MS-SSIM card vs CPU, training with the periodic eval, timings.
        project_launches, project_ratio = project_on_card(final, False, PROJECT_ITERS, PROJECT_BAR)
        _, wplus_ratio = project_on_card(final, True, WPLUS_ITERS, WPLUS_BAR)
        small_ratio = project_small_on_card()
        with strict_f32():
            project_grad = project_grad_kernel_vs_plain(final)
        wspace_clis(tmp, final)
        eval_errs = evaluate_on_card(tmp, final)
        train_with_eval(tmp, final)
        wspace_times(final)

        # Phases 17-20: the augmentation, ADA and path-length regularization
        # slice: both Functions' second derivative, the training CLI with
        # ADA and PLR (a subprocess to chk-12.pth, then the resume through
        # stage 8, counting launches per plain and per penalized iteration),
        # one penalized stage-8 step kernel vs plain path, and the times.
        with strict_f32():
            second_errs = second_derivative_checks(shapes, gen)
        reg_launches, reg_per_iteration, reg_sub_wall, reg_wall = regularized_training(tmp, root)
        with strict_f32():
            reg_step = regularized_step_kernel_vs_plain()
            regularized_step_kernel_vs_plain(critic_biases=False)
        _, reg_profile = regularized_times(gen)

        # Phases 21-26: remat (the step against the step without it, launches
        # per iteration through the CLI, memory and time), dataset
        # preparation on the card, the serving program, a profiler trace.
        with phase("remat steps"), strict_f32():
            remat_steps = remat_step_checks()
        with phase("remat CLI"):
            remat_run, remat_stage7 = remat_through_cli(tmp)
        with phase("remat memory and time"):
            remat_memory_and_time(gen)
        with phase("prep"):
            prep_s, _ = prep_on_card(tmp, root)
        with phase("serving program"):
            program_launches, program_err = serving_program(tmp, root, final)
        with phase("trace"):
            trace_run(tmp)

        # Phases 27-30: data parallelism over two spawned ranks: steps on the
        # global batch against one process, train() with a stop signal to
        # one rank and the resume in one process, the torchrun CLI, the
        # iteration's times, and the Sampler over two devices.
        with phase("dp steps"):
            dp_backend_used, dp_step_launches = dp_steps(tmp)
        with phase("dp train"):
            dp_launches = dp_train(tmp, root)
        with phase("time dp"):
            dp_times(tmp)
        with phase("dp sampler"):
            dp_sample_launches, dp_frame_err = dp_sampler(ckpt)

        # Phases 31-34: the model axis over two spawned ranks sharing this
        # card: K1 and K3 at the channel shards' shapes, one step of each
        # kind against one process, train() stopped by a signal to one rank
        # and resumed in one process, and the iteration's time.
        with phase("tp kernels"):
            tp_kernel_out = tp_kernels(gen)
        with phase("tp steps"):
            tp_step_launches = tp_steps(tmp)
        with phase("tp train"):
            tp_launches = tp_train(tmp, root)
        with phase("time tp"):
            tp_times(tmp)

        # Phases 35-37: the image-IO slice: the native library (PNG and JPEG
        # decode against the plain decoder), the loader's rate by lane and
        # threads beside the iteration, prep and frame encode times, and the
        # training CLI on a set with JPEG or BMP files, stopped and resumed
        # with --auto-resume, then JPEG frames.
        with phase("io"):
            io_state = io_checks(tmp)
        with phase("time loader"):
            time_loader(io_state, it_ms, tmp, root)
        with phase("io train"):
            io_launches, io_sample_launches = io_train(tmp, root)
    penalized_remat = remat_steps["penalized PLR 2.0 + ADA, aug_p 0.5"]["launches"]
    tp_kind = {"styleconv": "K1", "styleconv_bwd": "K3"}  # the kernels that run on channel shards
    remat_entries = [{
        "launches_remat_train": remat_run[name],
        f"launches_remat_stage{REMAT_STAGE}_iteration": remat_stage7[i],
        "launches_remat_stage8_iteration": remat_steps["default"]["launches"][i],
        "launches_remat_stage8_penalized_iteration": penalized_remat[i],
        "launches_program_batch": program_launches[i],
        "launches_dp_train": [r[name] for r in dp_launches],
        "launches_dp_step_iteration": [it[i] for it in dp_step_launches["R1"]],
        **({"launches_dp_sampler_batch": dp_sample_launches[i]} if i < 2 else {}),
        "launches_io_train": io_launches[name],
        **({"launches_io_sample_batch": io_sample_launches[name]} if i < 2 else {}),
        "launches_tp_stage8_iteration": tp_step_launches["R1"][i],
        "launches_tp_stage8_penalized_iteration": tp_step_launches[f"ADA {REG_TARGET} + PLR 2.0, penalized"][i],
        "launches_tp_train": [r[name] for r in tp_launches],
        "max_abs_err_tp_shapes": tp_kernel_out["errs"][torch.bfloat16][name],
        "max_abs_err_tp_shapes_f32": tp_kernel_out["errs"][torch.float32][name],
        **({"tp_shapes_ms": {k: v for k, v in tp_kernel_out["times"].items() if k.startswith(tp_kind[name])}}
           if name in tp_kind else {}),
    } for i, name in enumerate(KERNEL_NAMES)]

    kernels = [
        {
            "name": "styleconv", "route": "cuda",
            "source": "byogan_tpu_torch/csrc/styleconv.cu",
            "replaces": "byogan_tpu/ops/pallas_styleconv.py:169",
            "launches": launches["styleconv"],
            "max_abs_err": errs[torch.bfloat16][0],
            "max_abs_err_f32": errs[torch.float32][0],
            "max_abs_err_test_shapes": extra_errs[torch.bfloat16],
            "max_abs_err_test_shapes_f32": extra_errs[torch.float32],
            **totals, "bound_by": k1_by,
            "shapes": "15 path shapes summed, batch 8, bf16",
            "launches_train": train_launches["styleconv"],
            "launches_slice_train": slice_train["styleconv"],
            "launches_slice_sample": slice_sample["styleconv"],
            "launches_project_per_iteration": project_launches["styleconv"],
            "launches_reg_train": reg_launches["styleconv"],
            "launches_reg_stage8_penalized_iteration": reg_per_iteration["penalized"][0],
            "launches_reg_stage8_plain_iteration": reg_per_iteration["plain"][0],
            "max_abs_err_train": train_errs[torch.bfloat16]["fwd"],
            "with_stats": {**k1s, "bound_by": k1s_by, "library_ms": None,
                           "shapes": "15 stage-8 shapes summed, batch 5, bf16, f32 hv, mean, inv out "
                                     "(device_ms: calls queued back to back, CUDA events)"},
            "hmma_sass": hmma,
            **remat_entries[0], "program_max_frame_err": program_err,
        },
        {
            "name": "adain", "route": "cuda",
            "source": "byogan_tpu_torch/csrc/adain.cu",
            "replaces": "byogan_tpu/ops/pallas_adain.py:73",
            "launches": launches["adain"],
            "max_abs_err": errs[torch.bfloat16][1],
            "max_abs_err_f32": errs[torch.float32][1],
            "max_abs_err_path_shapes": k2_errs[torch.bfloat16],
            "max_abs_err_path_shapes_f32": k2_errs[torch.float32],
            **k2, "bound_by": k2_by,
            "shapes": "(8,4,4,512) bf16 (device_ms, library_device_ms, launch_floor_ms: calls queued back to "
                      "back, CUDA events; with_stats: (5,4,4,512) and (24,4,4,512))",
            "launches_train": train_launches["adain"],
            "launches_slice_train": slice_train["adain"],
            "launches_slice_sample": slice_sample["adain"],
            "launches_project_per_iteration": project_launches["adain"],
            "launches_reg_train": reg_launches["adain"],
            "launches_reg_stage8_penalized_iteration": reg_per_iteration["penalized"][1],
            "launches_reg_stage8_plain_iteration": reg_per_iteration["plain"][1],
            **remat_entries[1], "program_max_frame_err": program_err,
        },
        {
            "name": "styleconv_bwd", "route": "cuda",
            "source": "byogan_tpu_torch/csrc/styleconv_bwd.cu",
            "replaces": "byogan_tpu/ops/pallas_styleconv.py:266",
            "launches": train_launches["styleconv_bwd"],
            "launches_slice_train": slice_train["styleconv_bwd"],
            "launches_project_per_iteration": project_launches["styleconv_bwd"],
            "launches_reg_train": reg_launches["styleconv_bwd"],
            "launches_reg_stage8_penalized_iteration": reg_per_iteration["penalized"][2],
            "launches_reg_stage8_plain_iteration": reg_per_iteration["plain"][2],
            "max_rel_err_under_create_graph": second_errs[torch.bfloat16]["first"],
            "max_rel_err_under_create_graph_f32": second_errs[torch.float32]["first"],
            "max_abs_err": train_errs[torch.bfloat16]["k3"],
            "max_abs_err_f32": train_errs[torch.float32]["k3"],
            **k3, "bound_by": k3_by, **remat_entries[2],
            "shapes": "16 stage-8 epilogue shapes summed (host_us_per_call: their mean; device_ms: calls queued "
                      "back to back, CUDA events), batch 5, bf16",
        },
    ]
    print(f"train: stage-8 iteration {it_ms:.3f} ms; CLI run {train_wall:.2f} s")
    print(f"wspace: project last/first loss W {project_ratio:.4f} (bar {PROJECT_BAR}), W+ {wplus_ratio:.4f} "
          f"(bar {WPLUS_BAR}), the JAX test's model {small_ratio:.4f} (bar {SMALL_BAR}); dL/dw kernel vs plain "
          f"relative L2 {project_grad[0]:.3e}, max {project_grad[1]:.3e}; SWD, MS-SSIM card vs CPU (TF32 off) "
          f"{eval_errs['TF32 off']}")
    print(f"reg: second derivative kernel vs plain max rel err f32 {second_errs[torch.float32]['second']:.3e}, bf16 "
          f"{second_errs[torch.bfloat16]['second']:.3e} (rounding alone {second_errs[torch.float32]['rounding alone']:.3e}, "
          f"{second_errs[torch.bfloat16]['rounding alone']:.3e}); CLI with ADA 0.6 and PLR 2.0: subprocess {reg_sub_wall:.2f} s, "
          f"resume {reg_wall:.2f} s; stage-8 launches per penalized iteration {reg_per_iteration['penalized']}, plain "
          f"{reg_per_iteration['plain']}; penalized step kernel vs plain losses {reg_step[0]:.3e}, gen grads {reg_step[1]}, "
          f"critic grads {reg_step[2]}; penalized iteration card busy {reg_profile['busy_ms']:.3f} ms, second derivative "
          f"{reg_profile['second_derivative_ms']:.3f} ms")
    print(f"remat: steps remat vs not, f32 stage 8: default losses {remat_steps['default']['loss_err']:.3e}, penalized "
          f"{remat_steps['penalized PLR 2.0 + ADA, aug_p 0.5']['loss_err']:.3e}; launches per iteration (K1, K2, K3) stage "
          f"{REMAT_STAGE} {remat_stage7}, stage 8 {remat_steps['default']['launches']}, penalized {penalized_remat}; prep "
          f"{prep_s:.3f} s per original; program launches per batch {program_launches}, max frame error {program_err} LSB")
    print(f"dp: steps on {dp_backend_used}; launches per rank in the two-rank train() run {dp_launches}; the "
          f"Sampler over two devices {dp_sample_launches} a batch, {dp_frame_err} LSB from one device")
    print(f"tp: launches per rank per stage-8 iteration {tp_step_launches}; per rank in the model-2 train() run "
          f"{tp_launches}; the 7 shard shapes' K1 and K3 ms summed {tp_kernel_out['times']}")
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
