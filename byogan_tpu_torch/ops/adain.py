"""K2: the noise + LeakyReLU + AdaIN epilogue as a hand-written CUDA kernel.

Replaces ``byogan_tpu/ops/pallas_adain.py::_kernel`` (25-52), reached
through ``noise_lrelu_adain_pallas`` (55-96).  The source is
``csrc/adain.cu``; its note says what bounds the kernel and how it is laid
out.  The plain version is ``ops.fused.noise_lrelu_adain_plain`` and the
device dispatch ``ops.fused.noise_lrelu_adain``.  For training the kernel
also writes the backward's residuals (``with_stats``): the f32 pre-norm
activations and the per-(sample, channel) mean and inv; the backward is K3
(``ops.fused.NoiseLReLUAdaINFunction``).  The forward without residuals
is also the registered op ``torch.ops.byogan.noise_lrelu_adain``
(``noise_lrelu_adain_op``): the plain version on a CPU tensor, K2 on a
CUDA one, traceable by ``torch.export``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from byogan_tpu_torch.ops import build
from byogan_tpu_torch.ops._launch import DTYPE_CODES, check_cuda_input, check_tensor
from byogan_tpu_torch.ops.fused import noise_lrelu_adain_plain

#: H*W up to which the kernel takes its one-launch route; larger images are
#: cut into tiles of this many pixels (adain.cu)
TILE = 256
#: channels a thread of the one-launch route owns (16-byte accesses in bf16)
VEC = 8


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
    and, ``with_stats``, also hv (N,H,W,C) and mean, inv (N,C), all f32.
    Up to ``TILE`` pixels a sample (the path's 4x4 block) it is one launch
    and allocates only its outputs; its vector accesses need C % 8 == 0 and
    x on 16 bytes, and element accesses take the rest."""
    check_cuda_input("noise_lrelu_adain_cuda", x)
    n, h, w, c = x.shape
    dev, dt = x.device, x.dtype
    check_tensor("x", x, (n, h, w, c), dt, dev)
    check_tensor("noise", noise, (n, h, w, 1), dt, dev)
    check_tensor("noise_w", noise_w, (c,), torch.float32, dev)
    check_tensor("gamma", gamma, (n, c), dt, dev)
    check_tensor("beta", beta, (n, c), dt, dev)
    hw = h * w
    out = torch.empty_like(x)  # fresh, so 16-byte aligned
    vec = c % VEC == 0 and x.data_ptr() % 16 == 0
    scratch = (None, None, None)
    if hw > TILE:  # the split-HW route's f32 partials (2, N, tiles, C), then scale and shift (2, N, C)
        part = n * -(-hw // TILE) * c
        buf = torch.empty(2 * part + 2 * n * c, dtype=torch.float32, device=dev)
        scratch = tuple(buf.data_ptr() + 4 * k * part for k in range(3))
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
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), *extra, *scratch,
            n, hw, c, float(eps), int(vec), DTYPE_CODES[dt], stream,
        )
    noise_lrelu_adain_cuda.launches += 1
    build.check(lib, code, "noise_lrelu_adain_cuda")
    if with_stats:
        return out, hv, stats[0], stats[1]
    return out


noise_lrelu_adain_cuda.launches = 0


@torch.library.custom_op("byogan::noise_lrelu_adain", mutates_args=(), device_types="cpu")
def noise_lrelu_adain_op(
    x: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """K2 without residuals as the op ``byogan::noise_lrelu_adain``: the
    plain version on a CPU tensor; on a CUDA tensor
    ``noise_lrelu_adain_cuda``, which counts the launch and raises if the
    build or the launch fails."""
    return noise_lrelu_adain_plain(x, noise, noise_w, gamma, beta, eps).contiguous()


@noise_lrelu_adain_op.register_kernel("cuda")
def _noise_lrelu_adain_op_cuda(x, noise, noise_w, gamma, beta, eps):
    return noise_lrelu_adain_cuda(x, noise, noise_w, gamma, beta, eps)


@noise_lrelu_adain_op.register_fake
def _noise_lrelu_adain_op_fake(x, noise, noise_w, gamma, beta, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
