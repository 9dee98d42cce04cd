"""Seeded numpy inputs for the port's kernel tests (imports no JAX, so the
CUDA tests can run where JAX is not installed)."""

import numpy as np


def epilogue_inputs(shape, seed):
    """x (N,H,W,C), noise (N,H,W,1), noise_w (C,), gamma and beta (N,C)."""
    n, h, w, c = shape
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal(shape).astype(np.float32),
        noise=r.standard_normal((n, h, w, 1)).astype(np.float32),
        noise_w=(0.1 * r.standard_normal(c)).astype(np.float32),
        gamma=(1 + 0.1 * r.standard_normal((n, c))).astype(np.float32),
        beta=(0.1 * r.standard_normal((n, c))).astype(np.float32),
    )


def styleconv_inputs(n, h, w, cin, cout, seed):
    """The epilogue's inputs plus x (N,H,W,Cin), an HWIO weight and bias."""
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((n, h, w, cin)).astype(np.float32),
        weight=(0.1 * r.standard_normal((3, 3, cin, cout))).astype(np.float32),
        bias=(0.1 * r.standard_normal(cout)).astype(np.float32),
        noise=r.standard_normal((n, h, w, 1)).astype(np.float32),
        noise_w=(0.1 * r.standard_normal(cout)).astype(np.float32),
        gamma=(1 + 0.1 * r.standard_normal((n, cout))).astype(np.float32),
        beta=(0.1 * r.standard_normal((n, cout))).astype(np.float32),
    )


# bias and noise_w stay float32 in every version of the kernels.
F32_ARGS = ("bias", "noise_w")


def as_torch(ins, dtype, device="cpu"):
    import torch

    return {
        k: torch.from_numpy(v).to(device, torch.float32 if k in F32_ARGS else dtype)
        for k, v in ins.items()
    }
