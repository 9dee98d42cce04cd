"""K1: the whole synthesis conv (3x3 conv + noise + LeakyReLU + AdaIN), and its gradient.

Replaces ``byogan_tpu/ops/pallas_styleconv.py::_kernel`` (46-95), reached
through ``_call_kernel`` (149-208) and ``styleconv_pallas`` (211-227).  The
source is ``csrc/styleconv.cu``; its note says what bounds the kernel and
how it is laid out.  Same contract as ``styleconv_pallas``: NHWC x, an HWIO
weight already multiplied by the equalized scale, bias and noise_w in f32.

``styleconv`` dispatches on the device: ``styleconv_plain`` for a CPU
tensor, the kernel for a CUDA one.  When an input wants a gradient it goes
through ``StyleConvFunction``, the port of the custom_vjp ``styleconv``
(pallas_styleconv.py:235-308): the forward also returns the residuals
(``with_stats``: the f32 pre-norm activations hv, as the TPU kernel's
``emit_hv`` variant does in x's dtype, and the per-(sample, channel) mean
and inv), the backward is K3 (``ops/styleconv_bwd.py``) followed by cuDNN's
conv transposes, as JAX leaves them to XLA.  On a CPU tensor the same
Function runs with the plain versions inside.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.nn.grad import conv2d_input, conv2d_weight

from byogan_tpu_torch.ops import build
from byogan_tpu_torch.ops._launch import DTYPE_CODES, check_cuda_input, check_tensor
from byogan_tpu_torch.ops.styleconv_bwd import styleconv_backward

#: (out, hv, mean, inv): the forward's output and the backward's residuals
WithStats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def styleconv_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-8,
    with_stats: bool = False,
    positive: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, WithStats]:
    """The kernel's arithmetic in plain PyTorch: an f32 conv of the inputs
    as given, the f32 epilogue, one cast to x's dtype at the end.  The
    variance is two-pass, which the kernel's merged moments approximate to
    float rounding (the TPU kernel's one-pass form agrees to the same).
    Differentiable by autograd.  ``with_stats`` also returns hv (N,H,W,Cout)
    and mean, inv (N,Cout), all f32.

    ``positive``, a bool (N,H,W,Cout) mask, picks LeakyReLU's branch per
    element instead of the sign of the pre-activation.  A gradient check
    passes the kernel's ``hv >= 0``: where the pre-activation is within
    rounding of zero the two versions may take different branches of the
    kink, and the slopes there differ by 0.8."""
    acc = F.conv2d(
        x.float().permute(0, 3, 1, 2), weight.float().permute(3, 2, 0, 1),
        padding=1,
    ).permute(0, 2, 3, 1)
    hv = acc + bias.float() + noise.float() * noise_w.float()
    hv = torch.maximum(hv, 0.2 * hv) if positive is None else torch.where(positive, hv, 0.2 * hv)
    mean = hv.mean(dim=(1, 2), keepdim=True)
    var = (hv - mean).square().mean(dim=(1, 2), keepdim=True)
    inv = torch.rsqrt(var + eps)
    scale = gamma.float()[:, None, None, :] * inv
    shift = beta.float()[:, None, None, :] - scale * mean
    out = (scale * hv + shift).to(x.dtype)
    if with_stats:
        return out, hv, mean[:, 0, 0, :], inv[:, 0, 0, :]
    return out


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
    with_stats: bool = False,
) -> Union[torch.Tensor, WithStats]:
    """Launch K1.  x (N,H,W,Cin) f32 or bf16; weight (3,3,Cin,Cout), noise
    (N,H,W,1), gamma and beta (N,Cout) in x's dtype; bias and noise_w
    (Cout,) f32.  Returns (N,H,W,Cout) in x's dtype and, ``with_stats``,
    also hv (the pass-1 scratch) and mean, inv (N,Cout), all f32."""
    check_cuda_input("styleconv_cuda", x)
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
    stats = torch.empty((2, n, cout), dtype=torch.float32, device=dev) if with_stats else None
    lib = build.load("styleconv")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.styleconv_forward(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            noise.data_ptr(), noise_w.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), hv.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), scale_shift.data_ptr(),
            stats[0].data_ptr() if with_stats else None,
            stats[1].data_ptr() if with_stats else None,
            n, h, w, cin, cout, bm, float(eps), DTYPE_CODES[dt], stream,
        )
    styleconv_cuda.launches += 1
    build.check(lib, code, "styleconv_cuda")
    if with_stats:
        return out, hv, stats[0], stats[1]
    return out


styleconv_cuda.launches = 0


class StyleConvFunction(torch.autograd.Function):
    """The differentiable synthesis conv (the custom_vjp ``styleconv``).

    Forward: K1 with its residuals (the plain version on a CPU tensor).
    Backward: K3 for the epilogue, then ``conv2d_input`` and
    ``conv2d_weight`` for dx and dweight.  Grads come back in each input's
    own layout and dtype (weight HWIO, bias and noise_w f32); what
    ``needs_input_grad`` says nobody wants is not computed.  There is no
    second derivative: path-length regularization, which needs one, is not
    ported.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, noise, noise_w, gamma, beta, eps):
        fwd = styleconv_plain if x.device.type == "cpu" else styleconv_cuda
        out, hv, mean, inv = fwd(
            x, weight, bias, noise, noise_w, gamma, beta, eps, with_stats=True
        )
        ctx.save_for_backward(x, weight, noise, noise_w, gamma, hv, mean, inv)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, noise, noise_w, gamma, hv, mean, inv = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = styleconv_backward(dy.contiguous(), hv, mean, inv, gamma, noise, noise_w)
        dx = dweight = None
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), weight.permute(3, 2, 0, 1)
        dpre = g.dpre.permute(0, 3, 1, 2)
        if need[0]:
            dx = conv2d_input(x_nchw.shape, w_oihw, dpre, padding=1).permute(0, 2, 3, 1)
        if need[1]:
            dweight = conv2d_weight(x_nchw, w_oihw.shape, dpre, padding=1).permute(2, 3, 1, 0)
        grads = (g.dbias, g.dnoise, g.dnoise_w, g.dgamma, g.dbeta)
        return (dx, dweight) + tuple(
            t if want else None for t, want in zip(grads, need[2:7])
        ) + (None,)


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
    """The synthesis conv: plain on a CPU tensor, K1 on a CUDA one, through
    ``StyleConvFunction`` when an input wants a gradient."""
    args = (x, weight, bias, noise, noise_w, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return StyleConvFunction.apply(*args, eps)
    if x.device.type == "cpu":
        return styleconv_plain(*args, eps)
    return styleconv_cuda(*args, eps)
