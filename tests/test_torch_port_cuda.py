"""The port's hand-written CUDA kernels against their plain versions, on the card.

Skips without a GPU.  This file imports no JAX, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import contextlib
import warnings

import pytest
import torch

from byogan_tpu_torch.models.factory import ModelSpec
from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
from byogan_tpu_torch.ops.augment import augment_batch, draw_augment
from byogan_tpu_torch.ops.cardcheck import K1_CASES, K3_CASES, forced_plan, second_derivatives
from byogan_tpu_torch.ops.fused import NoiseLReLUAdaINFunction, noise_lrelu_adain_plain
from byogan_tpu_torch.ops.styleconv import StyleConvFunction, styleconv_cuda, styleconv_plain
from byogan_tpu_torch.ops.styleconv_bwd import styleconv_backward_cuda, styleconv_backward_plain
from torch_port_inputs import as_torch, epilogue_inputs, styleconv_inputs

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: summation order only.  bf16: one output rounding against several in
# the plain epilogue, a few bf16 ulps at |x| ~ 4 (the JAX suite's 2e-2).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    # The plain conv is cuDNN's, which runs f32 in TF32 unless told not to.
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,bm", K1_CASES)
def test_styleconv_kernel_matches_plain(cuda_device, shape, bm, dtype):
    ins = as_torch(styleconv_inputs(*shape, seed=1), DTYPES[dtype], cuda_device)
    launches = styleconv_cuda.launches
    with torch.no_grad(), forced_plan(bm):
        got = styleconv_cuda(**ins)
        want = styleconv_plain(**ins)
    torch.cuda.synchronize()
    assert styleconv_cuda.launches == launches + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_styleconv_kernel_takes_unaligned_views(cuda_device, dtype):
    """x and the weight as contiguous views that start one element into
    their storage, off the 16 bytes that K1's vector copies need."""
    ins = as_torch(styleconv_inputs(2, 8, 8, 64, 64, seed=9), DTYPES[dtype], cuda_device)
    shifted = dict(ins)
    for k in ("x", "weight"):
        t = ins[k]
        shifted[k] = torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
        assert shifted[k].is_contiguous() and shifted[k].data_ptr() % 16 != 0
    with torch.no_grad():
        got = styleconv_cuda(**shifted)
        want = styleconv_plain(**ins)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


# K2's shapes: the path's initial block at batch 1-24 (sampling at 8,
# training at 5 and 24, one sample), C % 8 != 0 (the element route) and a
# ragged image, then the split-HW route off the path.
K2_CASES = [(1, 4, 4, 512), (5, 4, 4, 512), (8, 4, 4, 512), (24, 4, 4, 512), (3, 4, 4, 12), (2, 9, 13, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape", K2_CASES + [(2, 64, 64, 128), (1, 512, 512, 16), (2, 9, 31, 20)]
)
def test_adain_kernel_matches_plain(cuda_device, shape, dtype):
    ins = as_torch(epilogue_inputs(shape, seed=2), DTYPES[dtype], cuda_device)
    got = noise_lrelu_adain_cuda(**ins)
    want = noise_lrelu_adain_plain(**ins)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adain_kernel_takes_unaligned_views(cuda_device, dtype):
    """x as a contiguous view that starts one element into its storage, off
    the 16 bytes that K2's vector accesses need."""
    ins = as_torch(epilogue_inputs((5, 4, 4, 512), seed=10), DTYPES[dtype], cuda_device)
    t = ins["x"]
    shifted = dict(ins, x=torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape))
    assert shifted["x"].is_contiguous() and shifted["x"].data_ptr() % 16 != 0
    got = noise_lrelu_adain_cuda(**shifted, with_stats=True)
    want = noise_lrelu_adain_plain(**ins, with_stats=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "hv", "mean", "inv"), got, want):
        assert_rel(g, w, TOL[dtype] if name in ("out", "hv") else 1e-3, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(24, 4, 4, 512), (3, 4, 4, 12)])
def test_adain_kernel_is_deterministic(cuda_device, shape, dtype):
    """Fixed shuffle orders: two runs give the same bits."""
    ins = as_torch(epilogue_inputs(shape, seed=11), DTYPES[dtype], cuda_device)
    first = noise_lrelu_adain_cuda(**ins, with_stats=True)
    second = noise_lrelu_adain_cuda(**ins, with_stats=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "hv", "mean", "inv"), first, second):
        assert torch.equal(a, b), name


# Gradients and the backward kernel, relative to each tensor's max: f32
# differs by summation order; bf16 by the rounding of dpre to bf16 before
# the conv transposes (as JAX does), about one bf16 ulp (2^-8).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def assert_rel(got, want, tol, what=""):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all()), what
    scale = max(float(want.abs().max()), 1e-6)
    torch.testing.assert_close(got, want, atol=tol * scale, rtol=0, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,bm", K1_CASES)
def test_styleconv_kernel_residuals_match_plain(cuda_device, shape, bm, dtype):
    ins = as_torch(styleconv_inputs(*shape, seed=3), DTYPES[dtype], cuda_device)
    with forced_plan(bm):
        got = styleconv_cuda(**ins, with_stats=True)
    want = styleconv_plain(**ins, with_stats=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "hv", "mean", "inv"), got, want):
        assert g.dtype == w.dtype, name
        assert_rel(g, w, TOL[dtype] if name == "out" else 1e-4, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K2_CASES + [(2, 64, 64, 128), (2, 9, 31, 20)])
def test_adain_kernel_residuals_match_plain(cuda_device, shape, dtype):
    ins = as_torch(epilogue_inputs(shape, seed=4), DTYPES[dtype], cuda_device)
    got = noise_lrelu_adain_cuda(**ins, with_stats=True)
    want = noise_lrelu_adain_plain(**ins, with_stats=True)
    torch.cuda.synchronize()
    # hv repeats the plain version's roundings in x's dtype (a bf16 ulp apart
    # at most, as out); the statistics are f32 sums of it.
    for name, g, w in zip(("out", "hv", "mean", "inv"), got, want):
        assert_rel(g, w, TOL[dtype] if name in ("out", "hv") else 1e-3, name)


def _backward_args(shape, dtype, device):
    """K3's inputs: the residuals of the plain forward, a seeded dy."""
    ins = as_torch(epilogue_inputs(shape, seed=5), DTYPES[dtype], device)
    _, hv, mean, inv = noise_lrelu_adain_plain(**ins, with_stats=True)
    dy = torch.randn(shape, generator=torch.Generator(device).manual_seed(6), device=device).to(DTYPES[dtype])
    return dy, hv, mean, inv, ins["gamma"], ins["noise"], ins["noise_w"]


def _assert_backward(got, want, dtype):
    for name in got._fields:
        g, wt = getattr(got, name), getattr(want, name)
        assert g.dtype == wt.dtype, name
        assert_rel(g, wt, GRAD_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K3_CASES)
def test_backward_kernel_matches_plain(cuda_device, shape, dtype):
    args = _backward_args(shape, dtype, cuda_device)
    launches = styleconv_backward_cuda.launches
    got = styleconv_backward_cuda(*args)
    want = styleconv_backward_plain(*args)
    torch.cuda.synchronize()
    assert styleconv_backward_cuda.launches == launches + 1
    _assert_backward(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_takes_unaligned_views(cuda_device, dtype):
    """dy and hv as contiguous views that start one element into their
    storage, off the 16 bytes that K3's vector route needs."""
    args = _backward_args((2, 8, 8, 64), dtype, cuda_device)
    shifted = list(args)
    for i in (0, 1):
        t = args[i]
        shifted[i] = torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
        assert shifted[i].is_contiguous() and shifted[i].data_ptr() % 16 != 0
    got = styleconv_backward_cuda(*shifted)
    want = styleconv_backward_plain(*args)
    torch.cuda.synchronize()
    _assert_backward(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 16, 16, 512), (1, 512, 512, 16), (2, 5, 7, 12)])
def test_backward_kernel_is_deterministic(cuda_device, shape, dtype):
    """No atomics, fixed summation orders: two runs give the same bits."""
    args = _backward_args(shape, dtype, cuda_device)
    first, second = styleconv_backward_cuda(*args), styleconv_backward_cuda(*args)
    torch.cuda.synchronize()
    for name in first._fields:
        assert torch.equal(getattr(first, name), getattr(second, name)), name


def _grads_vs_plain(fn, plain, ins, dtype):
    """Gradients of sum(out * cos(out)) for every input, through the
    Function (kernels) and through autograd of the plain composition (which
    takes LeakyReLU's branch from the kernel's forward, see styleconv_plain)."""
    out = {}
    for which, f in (("kernel", fn), ("plain", plain)):
        args = [t.clone().requires_grad_(True) for t in ins.values()]
        y = f(*args).float()
        out[which] = torch.autograd.grad((y * torch.cos(y)).sum(), args)
    torch.cuda.synchronize()
    for name, g, w in zip(ins, out["kernel"], out["plain"]):
        assert g.dtype == w.dtype, name
        assert_rel(g, w, GRAD_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,bm", K1_CASES)
def test_styleconv_function_grads_match_plain_autograd(cuda_device, shape, bm, dtype):
    ins = as_torch(styleconv_inputs(*shape, seed=7), DTYPES[dtype], cuda_device)
    with forced_plan(bm):
        with torch.no_grad():
            positive = styleconv_cuda(**ins, with_stats=True)[1] >= 0
        before = (styleconv_cuda.launches, styleconv_backward_cuda.launches)
        _grads_vs_plain(
            lambda *a: StyleConvFunction.apply(*a, 1e-8),
            lambda *a: styleconv_plain(*a, positive=positive), ins, dtype,
        )
    assert (styleconv_cuda.launches, styleconv_backward_cuda.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 4, 4, 512), (2, 16, 16, 24)])
def test_initial_block_function_grads_match_plain_autograd(cuda_device, shape, dtype):
    ins = as_torch(epilogue_inputs(shape, seed=8), DTYPES[dtype], cuda_device)
    _grads_vs_plain(
        lambda *a: NoiseLReLUAdaINFunction.apply(*a, 1e-8),
        lambda *a: noise_lrelu_adain_plain(*a), ins, dtype,
    )


# One train step, f32, kernel path vs plain path (chip_smoke.py's STEP_TOL
# and STEP_GRAD_TOL): losses relative 2e-3; each gradient within 2e-2
# relative L2 and 5e-2 of its max.
STEP_TOL, STEP_GRAD_TOL = 2e-3, (2e-2, 5e-2)


@pytest.mark.cuda
def test_mixed_style_step_kernel_path_matches_plain_path(cuda_device):
    """A stage-3 step at full width with style mixing and EMA: the kernels
    against their plain versions swapped into the layers, same draws.  The
    EMA is held to its update on each path's own weights: across the paths
    Adam's first step moves a weight by +-lr by the sign of its gradient,
    which flips where a gradient is within rounding of zero."""
    from unittest import mock

    from byogan_tpu_torch.models import layers
    from byogan_tpu_torch.train.config import TrainConfig
    from byogan_tpu_torch.train.loop import build_state
    from byogan_tpu_torch.train.steps import draw, make_train_step

    cfg = TrainConfig(compute_dtype="float32", style_mix_prob=0.9, ema_beta=0.99)
    rng = torch.Generator(device=cuda_device).manual_seed(3)
    state = build_state(cfg, cuda_device)
    state.rng = rng
    draws = draw(state, cfg, 16, 3, torch.float32)
    assert draws.mix is not None
    real = torch.randint(0, 256, (16, 16, 16, 3), generator=rng, device=cuda_device, dtype=torch.uint8)
    step = make_train_step(cfg, 3, 16, 100.0, (True,), True)
    out = {}
    for path in ("kernel", "plain"):
        state = build_state(cfg, cuda_device)
        with torch.no_grad():  # noise weights start at zero, which hides the noise path
            for name, p in state.gen.named_parameters():
                if "inject_noise" in name:
                    p.normal_(0.0, 0.3, generator=torch.Generator(device=cuda_device).manual_seed(len(name)))
            for e, p in zip(state.gen_ema.parameters(), state.gen.parameters()):
                e.copy_(p)
        before = [p.detach().clone() for p in state.gen.parameters()]
        launches = (styleconv_cuda.launches, noise_lrelu_adain_cuda.launches, styleconv_backward_cuda.launches)
        with contextlib.ExitStack() as stack:
            if path == "plain":
                stack.enter_context(mock.patch.object(layers, "styleconv", styleconv_plain))
                stack.enter_context(mock.patch.object(layers, "noise_lrelu_adain", noise_lrelu_adain_plain))
            metrics = step(state, real, draws)
        torch.cuda.synchronize()
        got = tuple(w.launches - b for w, b in zip((styleconv_cuda, noise_lrelu_adain_cuda, styleconv_backward_cuda), launches))
        assert got == ((10, 2, 6) if path == "kernel" else (0, 0, 0)), got  # K1 2(2k-1), K2 2, K3 2k at k = 3
        # The EMA after one step: 0.99 * the initial weights + 0.01 * the stepped ones.
        for e, p0, p1 in zip(state.gen_ema.parameters(), before, state.gen.parameters()):
            torch.testing.assert_close(e, p0 * 0.99 + p1.detach() * (1 - 0.99), rtol=1e-6, atol=1e-9)
        out[path] = (metrics, {n: p.grad.clone() for n, p in state.gen.named_parameters()})
    (mk, gk), (mp, gp) = out["kernel"], out["plain"]
    for k in ("c_loss", "g_loss", "r1_penalty", "real_pred", "fake_pred"):
        assert_rel(mk[k], mp[k], STEP_TOL, k)
    l2_tol, max_tol = STEP_GRAD_TOL
    for n, w in gp.items():
        if w.abs().max() == 0:  # a stage the step does not reach
            continue
        d = (gk[n] - w).double()
        assert float(d.norm() / w.double().norm()) <= l2_tol, n
        assert float(d.abs().max() / w.abs().max()) <= max_tol, n


# -- the W-space and eval slice ----------------------------------------------

# One projection iteration's dL/dw, kernel path vs plain path, relative L2
# and max over max.  f32: the step tolerance above (16 convs and instance
# norms compound f32 rounding; LeakyReLU's kink takes near-zero elements to
# different branches).  bf16: the kernel path rounds dpre and dx to bf16 in
# every conv's backward, as JAX's custom_vjp does, where plain autograd keeps
# f32 inside each conv: about 2^-8 per layer over the 9 layers of 5 stages.
PROJECT_GRAD_TOL = {"float32": STEP_GRAD_TOL, "bfloat16": (5e-2, 1e-1)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_projection_gradient_kernel_path_matches_plain_path(cuda_device, dtype):
    from unittest import mock

    from byogan_tpu_torch.core.random import synthesis_noise, truncated_noise
    from byogan_tpu_torch.models import layers
    from byogan_tpu_torch.models.factory import ModelSpec, build_generator
    from byogan_tpu_torch.projector import projection_loss

    steps = 5  # 64 px, every K1 route and K2
    gen = build_generator(
        ModelSpec(num_stages=steps, channel_divisor=4), dtype=DTYPES[dtype], generator=torch.Generator().manual_seed(0)
    )
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if "inject_noise" in name:
                p.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(len(name)))
    gen.to(cuda_device).requires_grad_(False)
    rng = torch.Generator(device=cuda_device).manual_seed(1)
    noise = synthesis_noise(rng, 2, steps)
    with torch.no_grad():
        w0 = gen.map_latent(truncated_noise(rng, 2, gen.z_dim)).float()
    target = torch.rand((2, 64, 64, 3), generator=rng, device=cuda_device) * 2 - 1
    out = {}
    for path in ("kernel", "plain"):
        w = w0.clone().requires_grad_(True)
        launches = (styleconv_cuda.launches, noise_lrelu_adain_cuda.launches, styleconv_backward_cuda.launches)
        with contextlib.ExitStack() as stack:
            if path == "plain":
                stack.enter_context(mock.patch.object(layers, "styleconv", styleconv_plain))
                stack.enter_context(mock.patch.object(layers, "noise_lrelu_adain", noise_lrelu_adain_plain))
            loss = projection_loss(gen, w, target, noise, steps, alpha=0.5)
            (g,) = torch.autograd.grad(loss, w)
        torch.cuda.synchronize()
        got = tuple(f.launches - b for f, b in zip((styleconv_cuda, noise_lrelu_adain_cuda, styleconv_backward_cuda), launches))
        assert got == ((9, 1, 10) if path == "kernel" else (0, 0, 0)), got
        out[path] = (loss.detach(), g)
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    l2_tol, max_tol = PROJECT_GRAD_TOL[dtype]
    assert_rel(lk, lp, 2e-3 if dtype == "float32" else 2e-2, "loss")
    d = (gk - gp).double()
    assert float(d.norm() / gp.double().norm()) <= l2_tol
    assert float(d.abs().max() / gp.abs().max()) <= max_tol


def _smooth_images(seed, n, size):
    """Colour fields plus noise in [-1, 1], on the CPU."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(size) / size, torch.arange(size) / size, indexing="ij")
    phase = torch.rand((n, 1, 1, 3), generator=g) * 6.28
    img = 0.6 * torch.sin(5 * xx[None, :, :, None] + phase) * torch.cos(4 * yy[None, :, :, None] + phase)
    return (img + 0.2 * torch.randn((n, size, size, 3), generator=g)).clamp(-1, 1)


@pytest.mark.cuda
def test_swd_and_msssim_on_the_card_match_the_cpu(cuda_device):
    """The same images and draws on both devices: SWD per level within 1e-4
    relative, MS-SSIM within 1e-4 (f32 sums in another order)."""
    from byogan_tpu_torch.eval.msssim import msssim, msssim_diversity
    from byogan_tpu_torch.eval.swd import LevelDraws, level_draws, sliced_wasserstein_distance

    fake = _smooth_images(0, 8, 64)
    real = ((_smooth_images(1, 8, 64) + 1) * 127.5).round().to(torch.uint8)
    g = torch.Generator().manual_seed(2)
    draws = [level_draws(g, 8, 64 >> i, patches_per_image=32, dirs_per_repeat=64) for i in range(3)]
    card = [LevelDraws(tuple(t.to(cuda_device) for t in d.real_sites), tuple(t.to(cuda_device) for t in d.fake_sites),
                       d.directions.to(cuda_device)) for d in draws]
    kw = dict(patches_per_image=32, dirs_per_repeat=64)
    want = sliced_wasserstein_distance(real, fake, draws=draws, **kw)
    got = sliced_wasserstein_distance(real.to(cuda_device), fake.to(cuda_device), draws=card, **kw)
    assert list(got) == list(want) == [64, 32, 16, 0]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
    b = (0.7 * fake + 0.3 * _smooth_images(3, 8, 64))
    torch.testing.assert_close(msssim(fake.to(cuda_device), b.to(cuda_device)).cpu(), msssim(fake, b), atol=1e-4, rtol=0)
    for images in (fake, real):
        assert abs(float(msssim_diversity(images.to(cuda_device))) - float(msssim_diversity(images))) <= 1e-4


# The synthesis epilogues of a stage-8 generator at batch 2, as path-length
# regularization runs them (n, h, w, cin, cout for K1; n, h, w, c for K2).
SECOND_ORDER_CASES = [(2, r, r, cin, cout) for r, cin, cout in ModelSpec().styleconv_shapes()] + [(2, 4, 4, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SECOND_ORDER_CASES)
def test_second_derivative_kernel_path_matches_plain(cuda_device, shape, dtype):
    """First (K3 under create_graph) and second derivatives through the
    Functions against autograd's of the plain forward, which takes
    LeakyReLU's branch from the kernel's hv (see styleconv_plain)."""
    if len(shape) == 5:
        ins = as_torch(styleconv_inputs(*shape, seed=10), DTYPES[dtype], cuda_device)
        with torch.no_grad():
            positive = styleconv_cuda(**ins, with_stats=True)[1] >= 0
        fn, plain = (lambda *a: StyleConvFunction.apply(*a, 1e-8)), (lambda *a: styleconv_plain(*a, positive=positive))
    else:
        ins = as_torch(epilogue_inputs(shape, seed=10), DTYPES[dtype], cuda_device)
        fn, plain = (lambda *a: NoiseLReLUAdaINFunction.apply(*a, 1e-8)), noise_lrelu_adain_plain
    k3 = styleconv_backward_cuda.launches
    got_first, got = second_derivatives(fn, ins, 0)
    torch.cuda.synchronize()
    assert styleconv_backward_cuda.launches == k3 + 1
    want_first, want = second_derivatives(plain, ins, 0)
    for i, (g, w) in enumerate(zip(got_first + got, want_first + want)):
        assert g.dtype == w.dtype, i
        assert_rel(g, w, GRAD_TOL[dtype], f"derivative {i}")


@contextlib.contextmanager
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 512, 512, 3), (24, 4, 4, 3), (16, 64, 64, 3)])
def test_augment_on_the_card_matches_the_cpu(cuda_device, shape):
    """The same images and draws on both devices, p a device scalar as the
    ADA controller's: forward and backward within 1e-5 (f32 means summed in
    another order), and no warning under deterministic algorithms (the
    translation's backward is a gather, not a scatter_add)."""
    n, h, w, _ = shape
    draws = draw_augment(torch.Generator().manual_seed(3), n, h, w)
    imgs = torch.rand(shape, generator=torch.Generator().manual_seed(4)) * 2 - 1
    cot = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    out = {}
    for dev in ("cpu", cuda_device):
        x = imgs.to(dev).requires_grad_(True)
        with warnings.catch_warnings(record=True) as caught, _deterministic():
            warnings.simplefilter("always")
            y = augment_batch(x, torch.tensor(0.5, device=dev), draws.to(dev))
            (g,) = torch.autograd.grad(y, x, cot.to(dev))
            torch.cuda.synchronize()
        assert not [c for c in caught if "determinis" in str(c.message)], [str(c.message) for c in caught]
        out[str(dev)] = (y.detach().cpu(), g.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 4, 4, 512, 512), (8, 64, 64, 256, 128), (2, 512, 512, 32, 16)])
def test_registered_ops_equal_the_kernels(cuda_device, shape, dtype):
    """``byogan::styleconv`` and ``byogan::noise_lrelu_adain`` on CUDA
    tensors are K1 and K2: the same bits as the wrappers called directly,
    one launch each, counted."""
    n, r, _, cin, cout = shape
    ins = as_torch(styleconv_inputs(n, r, r, cin, cout, seed=4), DTYPES[dtype], cuda_device)
    args = [ins[k] for k in ("x", "weight", "bias", "noise", "noise_w", "gamma", "beta")]
    before = styleconv_cuda.launches
    with torch.no_grad():
        got, want = torch.ops.byogan.styleconv(*args, 1e-8), styleconv_cuda(*args)
    torch.cuda.synchronize()
    assert styleconv_cuda.launches == before + 2 and torch.equal(got, want)
    ep = as_torch(epilogue_inputs((n, r, r, cout), seed=5), DTYPES[dtype], cuda_device)
    args = [ep[k] for k in ("x", "noise", "noise_w", "gamma", "beta")]
    before = noise_lrelu_adain_cuda.launches
    with torch.no_grad():
        got, want = torch.ops.byogan.noise_lrelu_adain(*args, 1e-8), noise_lrelu_adain_cuda(*args)
    torch.cuda.synchronize()
    assert noise_lrelu_adain_cuda.launches == before + 2 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 7, -3, 2**40 + 1])
def test_seeded_noise_on_the_card_matches_the_cpu(cuda_device, seed):
    """The hash is exact on both; Box-Muller in f64 leaves at most an f32
    rounding between them."""
    from byogan_tpu_torch.core.random import seeded_synthesis_noise

    card = seeded_synthesis_noise(torch.tensor(seed, device=cuda_device), 8, 8)
    cpu = seeded_synthesis_noise(seed, 8, 8)
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda" and a.shape == b.shape
        torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=0)
