"""The port's hand-written CUDA kernels against their plain versions, on the card.

Skips without a GPU.  This file imports no JAX, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import pytest
import torch

from byogan_tpu_torch.ops.adain import noise_lrelu_adain_cuda
from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain
from byogan_tpu_torch.ops.styleconv import styleconv_cuda, styleconv_plain
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


@pytest.mark.cuda
def test_styleconv_refuses_inputs_that_want_grad(cuda_device):
    ins = as_torch(styleconv_inputs(1, 4, 4, 8, 8, seed=3), torch.float32, cuda_device)
    ins["weight"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        styleconv_cuda(**ins)
