"""K1: the whole synthesis conv (3x3 conv + noise + LeakyReLU + AdaIN), forward.

Replaces ``byogan_tpu/ops/pallas_styleconv.py::_kernel`` (46-95), reached
through ``_call_kernel`` (149-208) and ``styleconv_pallas`` (211-227).  The
source is ``csrc/styleconv.cu``; its note says what bounds the kernel and
how it is laid out.  Same contract as ``styleconv_pallas``: NHWC x, an HWIO
weight already multiplied by the equalized scale, bias and noise_w in f32.

``styleconv`` dispatches on the device: ``styleconv_plain`` for a CPU
tensor, the kernel for a CUDA one.  There is no backward yet: on CUDA the
wrapper refuses inputs that require grad while grad is enabled.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from byogan_tpu_torch.ops import build
from byogan_tpu_torch.ops._launch import (
    DTYPE_CODES,
    check_cuda_input,
    check_inference,
    check_tensor,
)


def styleconv_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: an f32 conv of the inputs
    as given, the f32 epilogue, one cast to x's dtype at the end.  The
    variance is two-pass, which the kernel's merged moments approximate to
    float rounding (the TPU kernel's one-pass form agrees to the same)."""
    acc = F.conv2d(
        x.float().permute(0, 3, 1, 2), weight.float().permute(3, 2, 0, 1),
        padding=1,
    ).permute(0, 2, 3, 1)
    hv = acc + bias.float() + noise.float() * noise_w.float()
    hv = torch.maximum(hv, 0.2 * hv)
    mean = hv.mean(dim=(1, 2), keepdim=True)
    var = (hv - mean).square().mean(dim=(1, 2), keepdim=True)
    scale = gamma.float()[:, None, None, :] * torch.rsqrt(var + eps)
    shift = beta.float()[:, None, None, :] - scale * mean
    return (scale * hv + shift).to(x.dtype)


def block_m(cout: int) -> int:
    """Pixels per conv tile: the kernel's tile is block_m x (4096/block_m)
    output channels, narrow where Cout is narrow (styleconv.cu)."""
    if cout <= 16:
        return 256
    if cout <= 32:
        return 128
    return 64


def styleconv_cuda(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Launch K1.  x (N,H,W,Cin) f32 or bf16; weight (3,3,Cin,Cout), noise
    (N,H,W,1), gamma and beta (N,Cout) in x's dtype; bias and noise_w
    (Cout,) f32.  Returns (N,H,W,Cout) in x's dtype."""
    check_cuda_input("styleconv_cuda", x)
    check_inference(
        "styleconv_cuda", x, weight, bias, noise, noise_w, gamma, beta
    )
    n, h, w, cin = x.shape
    cout = weight.shape[-1]
    dev, dt = x.device, x.dtype
    check_tensor("weight", weight, (3, 3, cin, cout), dt, dev)
    check_tensor("x", x, (n, h, w, cin), dt, dev)
    check_tensor("bias", bias, (cout,), torch.float32, dev)
    check_tensor("noise", noise, (n, h, w, 1), dt, dev)
    check_tensor("noise_w", noise_w, (cout,), torch.float32, dev)
    check_tensor("gamma", gamma, (n, cout), dt, dev)
    check_tensor("beta", beta, (n, cout), dt, dev)
    if n * h * w * cout >= 2**31:
        raise ValueError("styleconv_cuda: output exceeds 32-bit indexing")
    bm = block_m(cout)
    tiles = -(-(h * w) // bm)
    out = torch.empty((n, h, w, cout), dtype=dt, device=dev)
    hv = torch.empty((n, h, w, cout), dtype=torch.float32, device=dev)
    parts = torch.empty((2, n, tiles, cout), dtype=torch.float32, device=dev)
    scale_shift = torch.empty((2, n, cout), dtype=torch.float32, device=dev)
    lib = build.load("styleconv")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.styleconv_forward(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            noise.data_ptr(), noise_w.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), hv.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), scale_shift.data_ptr(),
            n, h, w, cin, cout, bm, float(eps), DTYPE_CODES[dt], stream,
        )
    styleconv_cuda.launches += 1
    build.check(lib, code, "styleconv_cuda")
    return out


styleconv_cuda.launches = 0


def styleconv(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """The synthesis conv: plain on a CPU tensor, K1 on a CUDA one."""
    if x.device.type == "cpu":
        return styleconv_plain(x, weight, bias, noise, noise_w, gamma, beta, eps)
    return styleconv_cuda(x, weight, bias, noise, noise_w, gamma, beta, eps)
