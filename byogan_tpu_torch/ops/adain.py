"""K2: the noise + LeakyReLU + AdaIN epilogue as a hand-written CUDA kernel.

Replaces ``byogan_tpu/ops/pallas_adain.py::_kernel`` (25-52), reached
through ``noise_lrelu_adain_pallas`` (55-96).  The source is
``csrc/adain.cu``; its note says what bounds the kernel and how it is laid
out.  The plain version is ``ops.fused.noise_lrelu_adain_plain`` and the
device dispatch ``ops.fused.noise_lrelu_adain``.  For training the kernel
also writes the backward's residuals (``with_stats``): the f32 pre-norm
activations and the per-(sample, channel) mean and inv; the backward is K3
(``ops.fused.NoiseLReLUAdaINFunction``).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from byogan_tpu_torch.ops import build
from byogan_tpu_torch.ops._launch import DTYPE_CODES, check_cuda_input, check_tensor

#: pixels of one sample that one block of the kernel summarises (adain.cu)
TILE = 256


def noise_lrelu_adain_cuda(
    x: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-8,
    with_stats: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Launch K2.  x (N,H,W,C) f32 or bf16; noise (N,H,W,1), gamma and beta
    (N,C) in x's dtype; noise_w (C,) f32.  Returns (N,H,W,C) in x's dtype
    and, ``with_stats``, also hv (N,H,W,C) and mean, inv (N,C), all f32."""
    check_cuda_input("noise_lrelu_adain_cuda", x)
    n, h, w, c = x.shape
    dev, dt = x.device, x.dtype
    check_tensor("x", x, (n, h, w, c), dt, dev)
    check_tensor("noise", noise, (n, h, w, 1), dt, dev)
    check_tensor("noise_w", noise_w, (c,), torch.float32, dev)
    check_tensor("gamma", gamma, (n, c), dt, dev)
    check_tensor("beta", beta, (n, c), dt, dev)
    hw = h * w
    tiles = -(-hw // TILE)
    out = torch.empty_like(x)
    parts = torch.empty((2, n, tiles, c), dtype=torch.float32, device=dev)
    scale_shift = torch.empty((2, n, c), dtype=torch.float32, device=dev)
    if with_stats:
        hv = torch.empty((n, h, w, c), dtype=torch.float32, device=dev)
        stats = torch.empty((2, n, c), dtype=torch.float32, device=dev)
        extra = (hv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr())
    else:
        extra = (None, None, None)
    lib = build.load("adain")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.adain_forward(
            x.data_ptr(), noise.data_ptr(), noise_w.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), *extra,
            parts[0].data_ptr(), parts[1].data_ptr(), scale_shift.data_ptr(),
            n, hw, c, float(eps), DTYPE_CODES[dt], stream,
        )
    noise_lrelu_adain_cuda.launches += 1
    build.check(lib, code, "noise_lrelu_adain_cuda")
    if with_stats:
        return out, hv, stats[0], stats[1]
    return out


noise_lrelu_adain_cuda.launches = 0
