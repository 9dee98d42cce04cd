"""K3: the backward of the synthesis epilogue (noise -> LeakyReLU -> AdaIN).

Replaces the elementwise-and-reduction part of
``byogan_tpu/ops/pallas_styleconv.py::_styleconv_bwd`` (266-292), the
backward of the ``styleconv`` custom_vjp.  The source is
``csrc/styleconv_bwd.cu``; its note says what bounds the kernel and how it
is laid out.  Both autograd Functions (``ops/styleconv.py``,
``ops/fused.py``) call ``styleconv_backward``: the plain version on a CPU
tensor, the kernel on a CUDA one.

It takes the forward's residuals: hv, the pre-norm activations in f32, and
the per-(sample, channel) mean and inv = rsqrt(var + eps) the forward used.
The JAX backward recomputes mean and a one-pass var from hv instead; the
two agree to float rounding.

``epilogue_double_backward`` is the backward of that backward, which
path-length regularization needs: autograd's second derivative of a plain
forward recomputed from the primal inputs.  JAX has no kernel for it
(``jax.grad`` differentiates its lax path twice), so torch ops are its port.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from byogan_tpu_torch.ops import build
from byogan_tpu_torch.ops._launch import DTYPE_CODES, check_cuda_input, check_tensor

#: threads a block and channels a thread (styleconv_bwd.cu kThreads, kVec);
#: a pixel's channel groups fit one block, so C is at most THREADS * VEC
THREADS, VEC = 256, 8
MAX_C = THREADS * VEC
#: blocks the plan aims at where the work allows: 2 waves of the H100's 132
#: SMs (a block per SM per wave; tools/sweep_k3.py)
TARGET_BLOCKS = 2 * 132


class BackwardPlan(NamedTuple):
    """How K3 cuts an (N, HW, C) call into blocks: ``groups`` threads a
    pixel (8 channels each), ``pixels`` pixels a step of the block,
    ``steps`` steps a block, ``tiles`` blocks a sample."""

    n: int
    groups: int
    pixels: int
    steps: int
    tiles: int

    @property
    def blocks(self) -> int:
        return self.n * self.tiles

    def scratch_floats(self, c: int) -> int:
        """The wrapper's one f32 buffer: dbias and dnoise_w (2, C), the
        sums (2, N, C), the per-block partials (2, N, tiles, C)."""
        return 2 * c + 2 * self.n * c + 2 * self.blocks * c

    def describe(self) -> str:
        return (f"{self.groups} threads a pixel, {self.pixels} pixels a step, {self.steps} steps a block, "
                f"{self.tiles} blocks a sample, {self.blocks} blocks")


@functools.lru_cache(maxsize=None)
def plan_backward(n: int, hw: int, c: int) -> BackwardPlan:
    """The fewest steps a block that still give about ``TARGET_BLOCKS``
    blocks: one step a block where the call has fewer steps than two
    targets (small images: every step its own block), else as many steps
    as keep the blocks at or above the target (large images: few partials)."""
    groups = -(-c // VEC)
    if groups > THREADS:
        raise ValueError(f"styleconv_backward_cuda takes at most {MAX_C} channels, got {c}")
    pixels = THREADS // groups
    per_sample = -(-hw // pixels)
    steps = max(1, n * per_sample // TARGET_BLOCKS)
    return BackwardPlan(n, groups, pixels, steps, -(-per_sample // steps))


class EpilogueGrads(NamedTuple):
    """Gradients of the epilogue.  dpre (N,H,W,C) and dnoise (N,H,W,1) in
    dy's dtype; dnoise_w and dbias (C,) f32; dgamma and dbeta (N,C) in
    gamma's dtype."""

    dpre: torch.Tensor
    dnoise: torch.Tensor
    dnoise_w: torch.Tensor
    dbias: torch.Tensor
    dgamma: torch.Tensor
    dbeta: torch.Tensor


def styleconv_backward_plain(
    dy: torch.Tensor,
    hv: torch.Tensor,
    mean: torch.Tensor,
    inv: torch.Tensor,
    gamma: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
) -> EpilogueGrads:
    """``_styleconv_bwd`` 266-292 line by line, in f32, with the forward's
    mean and inv in place of their recomputation."""
    dy3 = dy.float()
    mean4, inv4 = mean[:, None, None, :], inv[:, None, None, :]
    hhat = (hv - mean4) * inv4
    dgamma = (dy3 * hhat).sum(dim=(1, 2)).to(gamma.dtype)
    dbeta = dy3.sum(dim=(1, 2)).to(gamma.dtype)
    dyg = dy3 * gamma.float()[:, None, None, :]
    dhv = inv4 * (
        dyg
        - dyg.mean(dim=(1, 2), keepdim=True)
        - hhat * (dyg * hhat).mean(dim=(1, 2), keepdim=True)
    )
    dpre = torch.where(hv >= 0, dhv, 0.2 * dhv)
    dbias = dpre.sum(dim=(0, 1, 2))
    dnoise_w = (dpre * noise.float()).sum(dim=(0, 1, 2))
    dnoise = (dpre * noise_w.float()).sum(dim=3, keepdim=True).to(noise.dtype)
    return EpilogueGrads(dpre.to(dy.dtype), dnoise, dnoise_w, dbias, dgamma, dbeta)


def styleconv_backward_cuda(
    dy: torch.Tensor,
    hv: torch.Tensor,
    mean: torch.Tensor,
    inv: torch.Tensor,
    gamma: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
) -> EpilogueGrads:
    """Launch K3.  dy (N,H,W,C) f32 or bf16; gamma (N,C) and noise
    (N,H,W,1) in dy's dtype; hv (N,H,W,C), mean and inv (N,C), noise_w (C,)
    f32.  C is at most ``MAX_C``.  The vector route runs where C % 8 == 0
    and dy and hv start on 16 bytes, the scalar route otherwise."""
    check_cuda_input("styleconv_backward_cuda", dy)
    n, h, w, c = dy.shape
    dev, dt = dy.device, dy.dtype
    check_tensor("dy", dy, (n, h, w, c), dt, dev)
    check_tensor("hv", hv, (n, h, w, c), torch.float32, dev)
    check_tensor("mean", mean, (n, c), torch.float32, dev)
    check_tensor("inv", inv, (n, c), torch.float32, dev)
    check_tensor("gamma", gamma, (n, c), dt, dev)
    check_tensor("noise", noise, (n, h, w, 1), dt, dev)
    check_tensor("noise_w", noise_w, (c,), torch.float32, dev)
    hw = h * w
    plan = plan_backward(n, hw, c)
    vec = c % VEC == 0 and dy.data_ptr() % 16 == 0 and hv.data_ptr() % 16 == 0
    dpre = torch.empty_like(dy)  # fresh, so 16-byte aligned
    dnoise = torch.empty((n, h, w, 1), dtype=dt, device=dev)
    dgamma, dbeta = torch.empty((2, n, c), dtype=dt, device=dev).unbind()
    # dbias and dnoise_w (2, C), then the kernel's scratch: sums, partials
    f32 = torch.empty(plan.scratch_floats(c), dtype=torch.float32, device=dev)
    lib = build.load("styleconv_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.styleconv_backward(
            dy.data_ptr(), hv.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            gamma.data_ptr(), noise.data_ptr(), noise_w.data_ptr(),
            dpre.data_ptr(), dnoise.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), f32.data_ptr(), f32.data_ptr() + 8 * c, n, hw, c,
            plan.groups, plan.pixels, plan.steps, plan.tiles, int(vec),
            DTYPE_CODES[dt], stream,
        )
    styleconv_backward_cuda.launches += 1
    build.check(lib, code, "styleconv_backward_cuda")
    return EpilogueGrads(dpre, dnoise, f32[c:2 * c], f32[:c], dgamma, dbeta)


styleconv_backward_cuda.launches = 0


def styleconv_backward(
    dy: torch.Tensor,
    hv: torch.Tensor,
    mean: torch.Tensor,
    inv: torch.Tensor,
    gamma: torch.Tensor,
    noise: torch.Tensor,
    noise_w: torch.Tensor,
) -> EpilogueGrads:
    """The epilogue's backward: plain on a CPU tensor, K3 on a CUDA one."""
    fn = styleconv_backward_plain if dy.device.type == "cpu" else styleconv_backward_cuda
    return fn(dy, hv, mean, inv, gamma, noise, noise_w)


def at_inputs(out, need: Sequence[bool]) -> Tuple[Optional[torch.Tensor], ...]:
    """A backward Function's outputs, the wanted grads only (a tensor or a
    tuple), back at their inputs' positions, None elsewhere."""
    out = iter((out,) if torch.is_tensor(out) else out)
    return tuple(next(out) if want else None for want in need)


def epilogue_double_backward(
    plain: Callable[..., torch.Tensor],
    dy: torch.Tensor,
    primals: Sequence[torch.Tensor],
    cotangents: Sequence[Optional[torch.Tensor]],
    wants: Sequence[bool],
) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of a backward Function ``(dy, *primals) -> J^T dy``,
    where J is the Jacobian of ``plain(*primals)``: given the cotangents of
    J^T dy (None where its consumer took none), the gradients with respect
    to dy and to each primal, where ``wants`` (one flag for dy, then one
    per primal) asks.  ``plain`` is recomputed under ``enable_grad``, its
    VJP taken with ``create_graph``, and that VJP's inner product with the
    cotangents differentiated: d/d dy gives J v, d/d primals the
    second-order terms.  The result carries no graph (no third derivative)."""
    pairs = [(i, c) for i, c in enumerate(cotangents) if c is not None]
    if not pairs or not any(wants):
        return (None,) * len(wants)
    with torch.enable_grad():
        dy_ = dy.detach().requires_grad_(True)
        leaves = [p.detach().requires_grad_(True) for p in primals]
        out = plain(*leaves)
        firsts = torch.autograd.grad(out, [leaves[i] for i, _ in pairs], dy_, create_graph=True)
        inner = sum((f.float() * c.float()).sum() for f, (_, c) in zip(firsts, pairs))
        targets = [t for t, want in zip([dy_] + leaves, wants) if want]
        got = iter(torch.autograd.grad(inner, targets, allow_unused=True))
    return tuple(next(got) if want else None for want in wants)
