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

import functools
from dataclasses import dataclass
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


# The bf16 route's tile configurations (csrc/styleconv.cu, launch_bf16):
# (BM, BN) -> warps along M and N.
WARPS = {
    (256, 64): (4, 2), (128, 64): (4, 2), (64, 64): (2, 2), (32, 64): (2, 2), (16, 64): (1, 4),
    (256, 32): (8, 1), (128, 32): (4, 1), (256, 16): (4, 1), (128, 16): (4, 1),
}
# The th x tw rectangle of one sample that a tile of BM pixels covers.
RECT = {256: (16, 16), 128: (8, 16), 64: (8, 8), 32: (4, 8), 16: (4, 4)}
BK = 16             # kBK: input channels per slice
STAGES = 3          # kStages: the cp.async ring's depth (fewer where Cin has fewer slices)
MAX_HALO = 336      # kMaxHalo: halo pixels a tile may stage
MAX_SPT = 8         # kMaxSpt: whole samples a tile may hold
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on the H100
TARGET_BLOCKS = 128  # about one block per SM (132)


@dataclass(frozen=True)
class TilePlan:
    """How one K1 call is cut into blocks.  A tile is ``bm`` pixels by
    ``bn`` output channels, walked in slices of ``BK`` input channels: a
    ``th`` x ``tw`` rectangle of one sample (``spt`` 1, ``tiles_y`` x
    ``tiles_x`` of them per sample), or ``spt`` whole samples (th, tw = H,
    W).  ``stages`` and ``smem`` are the pipeline's depth and its dynamic
    shared memory in bytes (1 and 0 on the f32 route, whose tiles are runs
    of ``bm`` pixels of the flattened sample)."""

    bm: int
    bn: int
    th: int
    tw: int
    spt: int
    tiles_y: int
    tiles_x: int
    m_tiles: int
    n_tiles: int
    stages: int
    smem: int

    @property
    def tiles_per_sample(self) -> int:
        return self.tiles_y * self.tiles_x

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def idle_rows(self) -> bool:
        """Tiles of whole samples that leave rows without a pixel in every
        tile (spt * H * W < bm)."""
        return self.th * self.tw * self.spt < self.bm and self.tiles_per_sample == 1

    def describe(self) -> str:
        where = f"{self.spt} samples of {self.th}x{self.tw}" if self.spt > 1 else f"{self.th}x{self.tw} of one sample"
        return f"tile {self.bm}x{self.bn} ({where}), {self.blocks} blocks, {self.stages} stages, {self.smem} B shared"


def _stage_bytes(halo_px: int, bn: int) -> int:
    """One pipeline stage: halo rows and weight rows, each padded by 8 bf16."""
    return halo_px * (BK + 8) * 2 + 9 * BK * (bn + 8) * 2


def bf16_plan(n: int, h: int, w: int, cin: int, cout: int, bm: int) -> TilePlan:
    """The bf16 route's plan with tiles of ``bm`` pixels: whole samples
    where H*W is at most ``bm`` and their halos fit, else rectangles of one
    sample.  ``plan_tiles`` picks ``bm``; the card checks and ``tile_sweep``
    call this to force it."""
    bn = 16 if cout <= 16 else 32 if cout <= 32 else 64
    if (bm, bn) not in WARPS:
        raise ValueError(f"styleconv: no tile of {bm} pixels x {bn} channels")
    hw = h * w
    spt = min(bm // hw, MAX_SPT, n) if hw <= bm else 0
    while spt > 1 and spt * (h + 2) * (w + 2) > MAX_HALO:
        spt -= 1
    if spt >= 1 and (h + 2) * (w + 2) <= MAX_HALO:  # whole samples
        th, tw, ty, tx, m_tiles = h, w, 1, 1, -(-n // spt)
    else:  # rectangles of one sample
        spt, (th, tw) = 1, RECT[bm]
        ty, tx = -(-h // th), -(-w // tw)
        m_tiles = n * ty * tx
    warps_m = WARPS[(bm, bn)][0]
    halo = spt * (th + 2) * (tw + 2)
    stages = min(STAGES, -(-cin // BK))  # no buffer for slices that do not exist
    smem = max(stages * _stage_bytes(halo, bn), (spt * warps_m * bn + spt * bn) * 4)
    return TilePlan(bm, bn, th, tw, spt, ty, tx, m_tiles, -(-cout // bn), stages, smem)


@functools.lru_cache(maxsize=None)
def plan_tiles(n: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16) -> TilePlan:
    """K1's tile plan for x (n, h, w, cin) and cout output channels.

    bf16: BN follows Cout (16, 32 or 64).  BM is the largest of 256, 128,
    64, 32, 16 (256 or 128, where BN < 64) that puts ``TARGET_BLOCKS``
    blocks on the card, else the one with the most blocks; a tile of whole
    samples with idle rows is taken only where every BM leaves some.  BK is
    16: it halves a stage's shared memory against 32, so that two or three
    blocks share an SM.  ``tile_sweep`` measured these rules (PERF.md).
    f32: the CUDA-core route's runs of 256, 128 or 64 pixels by 16, 32 or
    64 channels."""
    if dtype == torch.float32:
        bm = 256 if cout <= 16 else 128 if cout <= 32 else 64
        tiles = -(-h * w // bm)
        return TilePlan(bm, 4096 // bm, 1, bm, 1, 1, tiles, n * tiles, -(-cout // (4096 // bm)), 1, 0)
    candidates = (256, 128) if cout <= 32 else (256, 128, 64, 32, 16)
    plans = [bf16_plan(n, h, w, cin, cout, bm) for bm in candidates]
    plans = [p for p in plans if not p.idle_rows] or plans
    full = [p for p in plans if p.blocks >= TARGET_BLOCKS]
    return full[0] if full else max(plans, key=lambda p: (p.blocks, -p.bm))


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
    also hv (the pass-1 scratch) and mean, inv (N,Cout), all f32.
    ``plan_tiles`` cuts the call into blocks."""
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
    plan = plan_tiles(n, h, w, cin, cout, dt)
    out = torch.empty((n, h, w, cout), dtype=dt, device=dev)
    hv = torch.empty((n, h, w, cout), dtype=torch.float32, device=dev)
    # One f32 scratch: mean, inv (N,Cout) each; scale and shift; the
    # per-tile partial means and M2s (N, tiles, Cout) each.
    nc, parts = n * cout, n * plan.tiles_per_sample * cout
    aux = torch.empty(4 * nc + 2 * parts, dtype=torch.float32, device=dev)
    at = lambda i: aux.data_ptr() + 4 * i  # noqa: E731  byte address of aux[i]
    lib = build.load("styleconv")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.styleconv_forward(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            noise.data_ptr(), noise_w.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), hv.data_ptr(),
            at(4 * nc), at(4 * nc + parts), at(2 * nc),
            at(0) if with_stats else None, at(nc) if with_stats else None,
            n, h, w, cin, cout, plan.bm, plan.bn, plan.th, plan.tw,
            plan.spt, plan.stages, plan.smem, float(eps), DTYPE_CODES[dt], stream,
        )
    styleconv_cuda.launches += 1
    build.check(lib, code, "styleconv_cuda")
    if with_stats:
        stats = aux[: 2 * nc].view(2, n, cout)
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
