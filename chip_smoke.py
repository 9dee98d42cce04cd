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
  broken into its parts.

Every phase that fails raises, so the script exits nonzero; the last line
is the JSON result, printed only on success.  Without a GPU, or without the
package beside it, it fails before any result.
"""

from __future__ import annotations

import contextlib
import json
import math
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


def train_through_cli(tmp):
    """All 8 stages at full width through the training CLI: 16 iterations
    on 24 synthetic images.  Counts the kernel launches of every step (the
    sample grid at the end adds forward launches of its own) and checks the
    losses, the fade pattern and the FINAL checkpoint."""
    from byogan_tpu_torch.cli.main import main as train_main
    from byogan_tpu_torch.data.synthetic import write_prepared_dataset
    from byogan_tpu_torch.models.factory import ModelSpec, build_critic, build_generator
    from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
    from byogan_tpu_torch.ops.styleconv import styleconv_cuda
    from byogan_tpu_torch.ops.styleconv_bwd import styleconv_backward_cuda
    from byogan_tpu_torch.train import loop
    from byogan_tpu_torch.train.checkpoint import load_checkpoint

    wrappers = (styleconv_cuda, noise_lrelu_adain_cuda, styleconv_backward_cuda)

    def counts():
        return tuple(w.launches for w in wrappers)

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
    make_step = loop.make_train_step

    def counting_step(config, steps, batch, fade_in, critic_fade, gen_fade):
        fn = make_step(config, steps, batch, fade_in, critic_fade, gen_fade)

        def step(state, real, draws=None):
            before = counts()
            out = fn(state, real, draws)
            records.append((steps, critic_fade, gen_fade, tuple(a - b for a, b in zip(counts(), before))))
            return out

        return step

    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(loop, "make_train_step", counting_step):
        state = train_main(["smoke", "--config-file", cfg])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("styleconv", "adain", "styleconv_bwd"), counts()))
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
    def grad_errs(got, want, what):
        """Per tensor (relative L2, max relative) errors, the worst printed
        before any tolerance is applied."""
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
            require(e2 <= l2_tol and em <= max_tol, f"{what} {n}: relative L2 {e2:.3e}, max {em:.3e} over tol {STEP_GRAD_TOL}")
        return max(e[0] for e in errs), max(e[1] for e in errs)

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
    print(f"time train iteration bf16 stage 8 batch {n}: {it_ms:.3f} ms, {1e3 * n / it_ms:.2f} images/s (CUDA events, {TIMED_ITERS} iterations)")

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
                      + f" bound_by {by}; without stats ms {no_stats_ms:.4f}; {plan_tiles(n, r, r, cin, cout).describe()}")
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
              + f" bound_by {by}; {gbs:.1f} GB/s at 8 B an element over device time; plan: {plan_backward(n, r * r, cout).describe()}")
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
        f"{parts['critic R1 loss + grads']:.3f} ms"
    )
    rest = it_ms - sum(parts.values())
    for name, ms in parts.items():
        print(f"time train part {name}: {ms:.3f} ms ({100 * ms / it_ms:.1f}% of the iteration)")
    print(f"time train part rest (critic-phase generator forward glue, generator-phase critic, Adam, launch gaps), by difference: {rest:.3f} ms ({100 * rest / it_ms:.1f}%)")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, real)
        torch.cuda.synchronize()
    print("profiler: top ten ops of one stage-8 iteration by device time")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10))
    return (k1s, max(k1s_by, key=k1s_by.get)), (k3, max(k3_by, key=k3_by.get)), it_ms


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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = ModelSpec().styleconv_shapes()
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
    extra_errs = k1_extra_checks(gen)

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
                      + f" bound_by {by}; plan: {plan.describe()}; device ms by kernel: {fmt_times(parts_k1)}")
                if r <= 8:  # the same call with whole samples per tile, for comparison
                    for bm in (64, 128):
                        alt = bf16_plan(PATH_BATCH, r, r, cin, cout, bm)
                        with forced_plan(bm):
                            ms = timed_ms(lambda: styleconv_cuda(**ins))
                            dms = device_ms(lambda: styleconv_cuda(**ins))
                        print(f"time K1 bf16 ({PATH_BATCH},{r},{r},{cin}->{cout}) other plan ms {ms:.4f} device_ms {dms:.4f}: {alt.describe()}")
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

        # Phases 7-10: the training path.
        train_errs = training_kernels(shapes, gen)
        train_launches, train_wall = train_through_cli(tmp)
        stage8_step_kernel_vs_plain()
        (k1s, k1s_by), (k3, k3_by), it_ms = training_times(shapes, gen)

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
            "max_abs_err_train": train_errs[torch.bfloat16]["fwd"],
            "with_stats": {**k1s, "bound_by": k1s_by, "library_ms": None,
                           "shapes": "15 stage-8 shapes summed, batch 5, bf16, f32 hv, mean, inv out "
                                     "(device_ms: calls queued back to back, CUDA events)"},
            "hmma_sass": hmma,
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
            "launches_train": train_launches["adain"],
        },
        {
            "name": "styleconv_bwd", "route": "cuda",
            "source": "byogan_tpu_torch/csrc/styleconv_bwd.cu",
            "replaces": "byogan_tpu/ops/pallas_styleconv.py:266",
            "launches": train_launches["styleconv_bwd"],
            "max_abs_err": train_errs[torch.bfloat16]["k3"],
            "max_abs_err_f32": train_errs[torch.float32]["k3"],
            **k3, "bound_by": k3_by,
            "shapes": "16 stage-8 epilogue shapes summed (host_us_per_call: their mean; device_ms: calls queued "
                      "back to back, CUDA events), batch 5, bf16",
        },
    ]
    print(f"train: stage-8 iteration {it_ms:.3f} ms; CLI run {train_wall:.2f} s")
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
