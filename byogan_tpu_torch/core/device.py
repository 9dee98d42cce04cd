"""Where the port's entry points run.

The default is the GPU.  Without one, an entry point raises instead of
quietly running on the CPU; the CPU is taken only when asked for by name.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or -d cpu) to "
            "run the plain PyTorch path on the CPU"
        )
    return dev


def make_generator(device: torch.device, seed: Optional[int] = None) -> torch.Generator:
    """A ``torch.Generator`` on ``device``, seeded from ``seed`` or the OS."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    return torch.Generator(device=device).manual_seed(int(seed))
