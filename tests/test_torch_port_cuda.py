"""The port's hand-written CUDA kernels against their plain versions, on the card.

Skips without a GPU.  This file imports no JAX, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import pytest
import torch

from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
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
@pytest.mark.parametrize(
    "shape", [(4, 8, 8, 16, 24), (2, 16, 16, 8, 8), (2, 32, 32, 32, 16), (3, 5, 7, 40, 70)]
)
def test_styleconv_kernel_matches_plain(cuda_device, shape, dtype):
    ins = as_torch(styleconv_inputs(*shape, seed=1), DTYPES[dtype], cuda_device)
    launches = styleconv_cuda.launches
    with torch.no_grad():
        got = styleconv_cuda(**ins)
        want = styleconv_plain(**ins)
    torch.cuda.synchronize()
    assert styleconv_cuda.launches == launches + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape", [(8, 4, 4, 512), (2, 64, 64, 128), (1, 512, 512, 16), (2, 9, 31, 20)]
)
def test_adain_kernel_matches_plain(cuda_device, shape, dtype):
    ins = as_torch(epilogue_inputs(shape, seed=2), DTYPES[dtype], cuda_device)
    got = noise_lrelu_adain_cuda(**ins)
    want = noise_lrelu_adain_plain(**ins)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


# Gradients and the backward kernel, relative to each tensor's max: f32
# differs by summation order; bf16 by the rounding of dpre to bf16 before
# the conv transposes (as JAX does), about one bf16 ulp (2^-8).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SC_SHAPES = [(4, 8, 8, 16, 24), (2, 16, 16, 8, 8), (2, 32, 32, 32, 16), (3, 5, 7, 40, 70)]


def assert_rel(got, want, tol, what=""):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all()), what
    scale = max(float(want.abs().max()), 1e-6)
    torch.testing.assert_close(got, want, atol=tol * scale, rtol=0, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SC_SHAPES)
def test_styleconv_kernel_residuals_match_plain(cuda_device, shape, dtype):
    ins = as_torch(styleconv_inputs(*shape, seed=3), DTYPES[dtype], cuda_device)
    got = styleconv_cuda(**ins, with_stats=True)
    want = styleconv_plain(**ins, with_stats=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "hv", "mean", "inv"), got, want):
        assert g.dtype == w.dtype, name
        assert_rel(g, w, TOL[dtype] if name == "out" else 1e-4, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 4, 4, 512), (2, 64, 64, 128), (2, 9, 31, 20)])
def test_adain_kernel_residuals_match_plain(cuda_device, shape, dtype):
    ins = as_torch(epilogue_inputs(shape, seed=4), DTYPES[dtype], cuda_device)
    got = noise_lrelu_adain_cuda(**ins, with_stats=True)
    want = noise_lrelu_adain_plain(**ins, with_stats=True)
    torch.cuda.synchronize()
    # hv repeats the plain version's roundings in x's dtype (a bf16 ulp apart
    # at most, as out); the statistics are f32 sums of it.
    for name, g, w in zip(("out", "hv", "mean", "inv"), got, want):
        assert_rel(g, w, TOL[dtype] if name in ("out", "hv") else 1e-3, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape", [(5, 4, 4, 512), (2, 64, 64, 128), (1, 512, 512, 16), (3, 9, 31, 40)]
)
def test_backward_kernel_matches_plain(cuda_device, shape, dtype):
    n, h, w, c = shape
    ins = as_torch(epilogue_inputs(shape, seed=5), DTYPES[dtype], cuda_device)
    _, hv, mean, inv = noise_lrelu_adain_plain(**ins, with_stats=True)
    dy = torch.randn(shape, generator=torch.Generator(cuda_device).manual_seed(6), device=cuda_device).to(DTYPES[dtype])
    args = (dy, hv, mean, inv, ins["gamma"], ins["noise"], ins["noise_w"])
    launches = styleconv_backward_cuda.launches
    got = styleconv_backward_cuda(*args)
    want = styleconv_backward_plain(*args)
    torch.cuda.synchronize()
    assert styleconv_backward_cuda.launches == launches + 1
    for name in got._fields:
        g, wt = getattr(got, name), getattr(want, name)
        assert g.dtype == wt.dtype, name
        assert_rel(g, wt, GRAD_TOL[dtype], name)


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
@pytest.mark.parametrize("shape", SC_SHAPES)
def test_styleconv_function_grads_match_plain_autograd(cuda_device, shape, dtype):
    ins = as_torch(styleconv_inputs(*shape, seed=7), DTYPES[dtype], cuda_device)
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
