"""Checkpoint loading (byogan_tpu/train/checkpoint.py:261-276, ``.pth`` only).

The JAX package's own checkpoints are orbax directories, which need JAX to
read; convert one with ``byogan-export`` to a reference ``.pth`` first.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from byogan_tpu_torch.compat.torch_ckpt import load_torch_checkpoint


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference-format ``.pth`` file (see ``load_torch_checkpoint``)."""
    if os.path.isfile(path):
        return load_torch_checkpoint(path)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint); the port reads "
            "only .pth files -- export it with byogan-export first"
        )
    raise FileNotFoundError(f"checkpoint not found: {path}")
