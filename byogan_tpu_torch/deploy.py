"""Serving programs via ``torch.export`` (byogan_tpu/deploy.py).

``export_program`` traces the whole sampling path of a checkpoint's
generator (mapping network, the stages, W-space truncation toward the mean
w baked in at export time, the noise maps from a seed, the device-side
uint8 rounding of ``core/grids.to_uint8``) into one ``torch.export``
program, with the weights inside, and saves it with ``torch.export.save``.
The serving contract, recorded in the ``.json`` sidecar:

    (z: f32[batch, z_dim], seed: i64[]) -> u8[batch, res, res, 3]

The caller supplies latents, so interpolation, truncation and projection
stay possible downstream, and a seed for the synthesis noise
(``core/random.seeded_synthesis_noise``: a ``torch.Generator`` cannot be
captured in a program).  The program runs on the device it was exported
on.  The synthesis convs are the registered ops ``byogan::styleconv`` (K1)
and ``byogan::noise_lrelu_adain`` (K2), so loading a program needs
``byogan_tpu_torch.ops`` imported, which registers them; unlike the JAX
package's StableHLO blob it is not free of the package, but it needs no
checkpoint and none of the model code.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

import byogan_tpu_torch.ops  # noqa: F401  registers the ops the programs call
from byogan_tpu_torch.core.grids import to_uint8
from byogan_tpu_torch.core.random import seeded_synthesis_noise, truncated_noise

#: sidecar suffix for the JSON metadata written next to the program.
META_SUFFIX = ".json"
SIGNATURE = "(z: f32[batch, z_dim], seed: i64[]) -> u8[batch, res, res, 3]"


class SamplingProgram(torch.nn.Module):
    """What ``export_program`` traces: a loaded ``serve.Sampler``'s
    generator, steps, alpha, dtype and truncation, as a function of (z,
    seed) computed as ``Sampler.render`` computes it."""

    def __init__(self, sampler):
        super().__init__()
        self.gen = sampler.generator
        self.batch, self.steps, self.alpha, self.dtype = sampler.batch, sampler.steps, sampler.alpha, sampler.dtype
        self.psi = sampler.truncation_psi
        self.register_buffer("w_mean", None if self.psi is None else sampler.mean_w())

    def forward(self, z: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        from byogan_tpu_torch.projector import truncate  # export only: loading a program needs none of it

        noise = seeded_synthesis_noise(seed, self.batch, self.steps, dtype=self.dtype)
        w = self.gen.map_latent(z)
        if self.psi is not None:
            w = truncate(w, self.w_mean, self.psi)
        img = self.gen(None, noise, steps=self.steps, alpha=self.alpha, style=w)
        return to_uint8(img.float())


def export_program(
    checkpoint: str,
    out_path: str,
    batch: int = 32,
    dtype: str = "bfloat16",
    use_ema: bool = False,
    truncation_psi: Optional[float] = None,
    truncation: float = 0.75,
    device: Optional[str] = None,
) -> dict:
    """Export ``checkpoint``'s generator as a ``torch.export`` program on
    ``device`` (the GPU unless ``"cpu"``).  Writes the program to
    ``out_path`` and a JSON sidecar (the contract and the metadata) to
    ``out_path + ".json"``; returns the metadata.

    ``truncation_psi`` bakes W-space truncation in: the mean w of
    ``projector.mean_w``, computed once at export time from latents of the
    training distribution (``truncation``, the run's ``noise_trunc``), is a
    constant of the program and every request's w is pulled toward it."""
    from byogan_tpu_torch.serve import Sampler

    sampler = Sampler(
        checkpoint, batch=batch, truncation=truncation, dtype=dtype, device=device,
        use_ema=use_ema, truncation_psi=truncation_psi,
    )
    program = SamplingProgram(sampler)
    dev = sampler.device
    example = (torch.zeros((batch, sampler.z_dim), dtype=torch.float32, device=dev),
               torch.zeros((), dtype=torch.int64, device=dev))
    with torch.no_grad():
        exported = torch.export.export(program, example)
    torch.export.save(exported, out_path)
    meta = {
        "format": "torch.export",
        "signature": SIGNATURE,
        "batch": batch,
        "z_dim": sampler.z_dim,
        "resolution": sampler.resolution,
        "steps": sampler.steps,
        "alpha": sampler.alpha,
        "dtype": dtype,
        "use_ema": use_ema,
        "truncation_psi": truncation_psi,
        "train_truncation": truncation,
        # where JAX lists the platforms it lowered for: a program runs where it was exported
        "device": str(dev),
        "requires": "import byogan_tpu_torch.ops (registers byogan::styleconv and byogan::noise_lrelu_adain)",
        "model": sampler.spec.to_dict(),
        "bytes": os.path.getsize(out_path),
    }
    with open(out_path + META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ExportedSampler:
    """Serve from an ``export_program`` file: no checkpoint, no model code.

    Latents should come from the training distribution, a truncated normal
    at ``meta["train_truncation"]``; ``sample_z`` draws them:

    >>> s = ExportedSampler("gen.pt2")
    >>> frames = s(s.sample_z(seed=3), seed=7)
    """

    def __init__(self, path: str):
        self._exported = torch.export.load(path)
        self._call = self._exported.module()
        try:
            with open(path + META_SUFFIX) as f:
                self.meta = json.load(f)
        except FileNotFoundError:
            self.meta = {}
        self.device = self._input_value(0).device

    def _input_value(self, i: int):
        names = self._exported.graph_signature.user_inputs
        nodes = {n.name: n for n in self._exported.graph.nodes if n.op == "placeholder"}
        return nodes[names[i]].meta["val"]

    def sample_z(self, seed: int = 0) -> np.ndarray:
        """One batch of latents (``in_shape``) from the training
        distribution, drawn on the CPU from ``seed``."""
        batch, z_dim = self.in_shape
        trunc = float(self.meta.get("train_truncation", 0.75))
        return truncated_noise(torch.Generator().manual_seed(seed), batch, z_dim, trunc).numpy()

    def __call__(self, z, seed: int = 0) -> np.ndarray:
        """uint8 frames (batch, res, res, 3) of latents ``z`` (batch, z_dim)
        and the noise of ``seed``, fetched to the host."""
        z = torch.from_numpy(np.ascontiguousarray(z, np.float32))
        if tuple(z.shape) != self.in_shape:
            raise ValueError(
                f"z has shape {tuple(z.shape)} but the program was traced at "
                f"(batch, z_dim) = {self.in_shape} (see the .json sidecar; "
                "torch.export programs are fixed-shape: re-export with --batch to change it)"
            )
        seed = torch.tensor(int(seed), dtype=torch.int64, device=self.device)
        return self._call(z.to(self.device), seed).cpu().numpy()

    @property
    def in_shape(self) -> Tuple[int, int]:
        """(batch, z_dim) the program was traced at."""
        shape = self._input_value(0).shape
        return (int(shape[0]), int(shape[1]))
