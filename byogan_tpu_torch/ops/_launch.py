"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_cuda_input(what: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if x.numel() >= 2**31:
        raise ValueError(f"{what}: {x.numel()} elements exceed 32-bit indexing")
