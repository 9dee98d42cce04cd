"""Batched sampling service (byogan_tpu/serve.py).

``Sampler`` loads a checkpoint once, keeps the generator on the device and
serves requests of any size by tiling its fixed batch: latents and per-stage
noise are drawn on the device from an explicit ``torch.Generator``, frames
are quantized to uint8 on the device, and ragged tails are cut from a full
batch.  ``save_stream`` overlaps encoding on a host thread with synthesis.
It samples from the EMA weights (``use_ema``), pulls styles toward the mean
w (``truncation_psi``) and mixes coarse and fine styles of two latent sets
(``style_mix``), as the JAX Sampler does.  Over several devices
(``devices``, the counterpart of the JAX Sampler's ``mesh``) it keeps one
generator replica per device and renders each contiguous row block of a
batch on its own.  Frames are written as PNG, as JPEG through the native
library's own encoder, byte for byte libjpeg's (``format="jpeg"``), or raw.
"""

from __future__ import annotations

import copy
import os
import queue
import struct
import threading
import zlib
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from byogan_tpu_torch.core.device import make_generator, resolve_device
from byogan_tpu_torch.core.grids import to_uint8
from byogan_tpu_torch.core.random import synthesis_noise, truncated_noise
from byogan_tpu_torch.data import native
from byogan_tpu_torch.models.factory import (
    ModelSpec,
    build_generator,
    z_dim_from_params,
)
from byogan_tpu_torch.projector import mean_w, truncate
from byogan_tpu_torch.train.checkpoint import load_checkpoint

#: encode lane -> file extension
FRAME_EXTENSIONS = {"png": ".png", "jpeg": ".jpg", "raw": ".npy"}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(frame: np.ndarray, compression: int = 6) -> bytes:
    """A uint8 RGB frame (H, W, 3) as PNG bytes: 8-bit samples, filter 0 on
    every row, one zlib stream."""
    frame = np.ascontiguousarray(frame)
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"expected uint8 (H, W, 3), got {frame.dtype} {frame.shape}")
    h, w, _ = frame.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), frame.reshape(h, w * 3)], axis=1
    )
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return b"".join(
        (
            b"\x89PNG\r\n\x1a\n",
            _png_chunk(b"IHDR", header),
            _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), compression)),
            _png_chunk(b"IEND", b""),
        )
    )


def save_frame_u8(
    frame: np.ndarray, stem: str, format: str = "png", png_compression: int = 1, jpeg_quality: int = 92
) -> str:
    """Write one uint8 HWC frame as ``stem`` + extension ("png", "jpeg"
    ``.jpg`` at ``jpeg_quality``, or "raw" ``.npy``); returns the path
    written (byogan_tpu/serve.py:50-81)."""
    path = stem + FRAME_EXTENSIONS[format]
    if format == "png":
        with open(path, "wb") as f:
            f.write(encode_png(frame, png_compression))
    elif format == "jpeg":  # the bytes libjpeg writes at this quality
        native.encode_jpeg(path, frame, jpeg_quality)
    else:
        np.save(path, frame)
    return path


class Sampler:
    """Serve uint8 frames from a generator checkpoint.

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the plain PyTorch path.  ``dtype`` is the compute
    dtype ("bfloat16" or "float32"); weights stay float32.  ``use_ema``
    loads the EMA generator (checkpoints of runs with ``ema_beta > 0``;
    raises without one).  ``truncation_psi`` pulls each w toward the mean w
    (``projector.mean_w``, computed once, at the first render that needs
    it): psi = 1 changes nothing, 0 gives every sample the mean style.

    ``devices`` (byogan_tpu/serve.py:92, 129-171, ``mesh=``) is a list of
    devices to split each batch over, in place of ``device``: one replica
    of the generator per entry (an entry may repeat), latents and noise
    drawn for the whole batch on the first, each contiguous block of
    ``batch / len(devices)`` rows rendered on its own device and the frames
    concatenated in order on the first.
    """

    def __init__(
        self,
        checkpoint: str,
        batch: int = 32,
        z_dim: Optional[int] = None,
        truncation: float = 0.75,
        dtype: str = "bfloat16",
        seed: Optional[int] = None,
        device: Optional[str] = None,
        use_ema: bool = False,
        truncation_psi: Optional[float] = None,
        devices: Optional[Sequence[str]] = None,
    ):
        if devices is not None:
            if device is not None or not devices:
                raise ValueError("pass a non-empty devices list or one device, not both")
            if batch % len(devices):
                raise ValueError(f"batch {batch} does not split over {len(devices)} devices")
            device = devices[0]
        self.device = resolve_device(device)
        save = load_checkpoint(checkpoint)
        weights = save["gen"]
        if use_ema:
            if save.get("gen_ema") is None:
                raise ValueError(
                    f"use_ema=True but {checkpoint} carries no EMA weights (train with ema_beta > 0)"
                )
            weights = save["gen_ema"]
        self.steps: int = save["step"]
        self.alpha = save["alpha"]
        self.batch = batch
        trained_z_dim = z_dim_from_params(save["gen"])
        self.z_dim = trained_z_dim if z_dim is None else z_dim
        self.truncation = truncation
        self.dtype = getattr(torch, dtype)
        self.spec = ModelSpec.from_dict(save.get("model"))
        self._gen = build_generator(self.spec, dtype=self.dtype, z_dim=trained_z_dim)
        self._gen.load_state_dict(weights, strict=True)
        self._gen.to(self.device).eval().requires_grad_(False)
        self.devices = None if devices is None else [self.device] + [resolve_device(d) for d in devices[1:]]
        self._replicas = [self._gen] + [copy.deepcopy(self._gen).to(d) for d in (self.devices or [])[1:]]
        self._rng = make_generator(self.device, seed)
        self.truncation_psi = truncation_psi
        self._w_mean: Optional[torch.Tensor] = None

    @property
    def generator(self):
        """The loaded generator (on the device, no gradients)."""
        return self._gen

    @property
    def resolution(self) -> int:
        return 4 * 2 ** (self.steps - 1)

    def draw_latents(self) -> torch.Tensor:
        """One batch of truncated latents, on the device."""
        return truncated_noise(self._rng, self.batch, self.z_dim, self.truncation, self.dtype)

    def draw(self) -> tuple:
        """One batch of latents and per-stage noise maps, on the device."""
        z = self.draw_latents()
        noise = synthesis_noise(self._rng, self.batch, self.steps, dtype=self.dtype)
        return z, noise

    def mean_w(self) -> torch.Tensor:
        """The mean w of this checkpoint's generator, computed once."""
        if self._w_mean is None:
            self._w_mean = mean_w(self._gen, self.z_dim, self.truncation)
        return self._w_mean

    def to_w(self, z: torch.Tensor, gen=None) -> torch.Tensor:
        """Styles of latents ``z`` (through ``gen``, a replica, default the
        first), truncated toward the mean w when ``truncation_psi`` is set."""
        w = (self._gen if gen is None else gen).map_latent(z)
        if self.truncation_psi is None:
            return w
        return truncate(w, self.mean_w().to(w.device), self.truncation_psi)

    def _over_devices(self, fn: Callable, *batched) -> torch.Tensor:
        """``fn(gen, *batched)``; over several devices, ``fn`` of each
        replica on its row block of every tensor (or list of tensors) in
        ``batched``, the outputs concatenated on the first device."""
        if self.devices is None:
            return fn(self._gen, *batched)
        k = len(self.devices)

        def block(x, i):
            if isinstance(x, list):
                return [block(t, i) for t in x]
            return x.tensor_split(k)[i].to(self.devices[i])

        outs = [fn(gen, *(block(x, i) for x in batched)) for i, gen in enumerate(self._replicas)]
        return torch.cat([o.to(self.device) for o in outs])

    @torch.inference_mode()
    def render_float(self, z: torch.Tensor, noise: List[torch.Tensor]) -> torch.Tensor:
        """Float32 NHWC frames in the generator's raw ~[-1, 1] range."""
        def synth(gen, z, noise):
            return gen(None, noise, steps=self.steps, alpha=self.alpha, style=self.to_w(z, gen)).float()

        return self._over_devices(synth, z, noise)

    @torch.inference_mode()
    def render(self, z: torch.Tensor, noise: List[torch.Tensor]) -> torch.Tensor:
        """uint8 NHWC frames, quantized on the device (save_image rounding)."""
        return to_uint8(self.render_float(z, noise))

    @torch.inference_mode()
    def render_mix(
        self, z_a: torch.Tensor, z_b: torch.Tensor, noise: List[torch.Tensor], crossover: int
    ) -> torch.Tensor:
        """uint8 NHWC frames whose stages below ``crossover`` take the
        styles of ``z_a`` and the rest those of ``z_b``."""
        if not 0 <= crossover <= self.steps:
            raise ValueError(f"crossover must be in [0, {self.steps}], got {crossover}")

        def synth(gen, z_a, z_b, noise):
            w_a, w_b = self.to_w(z_a, gen), self.to_w(z_b, gen)
            styles = [w_a if i < crossover else w_b for i in range(self.steps)]
            return gen(None, noise, steps=self.steps, alpha=self.alpha, style=styles).float()

        return to_uint8(self._over_devices(synth, z_a, z_b, noise))

    def style_mix(self, n: int, crossover: int) -> np.ndarray:
        """n uint8 frames with coarse stages (below ``crossover``) styled by
        one latent set and fine stages by another (byogan_tpu/serve.py:
        229-286); ``truncation_psi`` applies to both.  Each batch draws z_a,
        z_b, then the noise maps, at the constructor's batch size."""
        out, produced = [], 0
        while produced < n:
            z_a, z_b = self.draw_latents(), self.draw_latents()
            noise = synthesis_noise(self._rng, self.batch, self.steps, dtype=self.dtype)
            take = min(self.batch, n - produced)
            out.append(self.render_mix(z_a, z_b, noise, crossover)[:take].cpu().numpy())
            produced += take
        return np.concatenate(out, axis=0)

    def sample_batches(self, n: int) -> Iterator[np.ndarray]:
        """Yield uint8 NHWC batches until n frames are produced; the next
        batch is queued on the device before the current one is fetched."""
        produced = 0
        pending = self.render(*self.draw())
        while produced < n:
            take = min(self.batch, n - produced)
            produced += take
            nxt = self.render(*self.draw()) if produced < n else None
            yield pending[:take].cpu().numpy()
            pending = nxt

    def sample(self, n: int) -> np.ndarray:
        """n uint8 HWC frames."""
        return np.concatenate(list(self.sample_batches(n)), axis=0)

    def sample_float(self, n: int) -> np.ndarray:
        """n float32 NHWC frames in the raw ~[-1, 1] range (for metrics: the
        uint8 path saturates the negative half)."""
        out = []
        produced = 0
        while produced < n:
            take = min(self.batch, n - produced)
            out.append(self.render_float(*self.draw())[:take].cpu().numpy())
            produced += take
        return np.concatenate(out, axis=0)

    def save_stream(
        self,
        directory: str,
        n: int,
        prefix: str = "image_",
        format: str = "png",
        jpeg_quality: int = 92,
    ) -> int:
        """Write n frames as ``{prefix}{i}`` (i from 1) in ``format`` (see
        ``save_frame_u8``), encoding on a host thread while the device
        renders the next batch."""
        if format not in FRAME_EXTENSIONS:
            raise ValueError(f"unknown save_stream format: {format!r}")
        os.makedirs(directory, exist_ok=True)
        q: "queue.Queue" = queue.Queue(maxsize=4)
        done = object()
        error: list = []

        def writer():
            idx = 0
            while True:
                item = q.get()
                if item is done:
                    return
                if error:
                    continue  # keep draining so the producer never blocks
                try:
                    for frame in item:
                        idx += 1
                        stem = os.path.join(directory, f"{prefix}{idx}")
                        save_frame_u8(frame, stem, format, jpeg_quality=jpeg_quality)
                except Exception as e:  # handed to the caller after join
                    error.append(e)

        thread = threading.Thread(target=writer, daemon=True)
        thread.start()
        written = 0
        try:
            for batch in self.sample_batches(n):
                q.put(batch)
                written += len(batch)
        finally:
            q.put(done)
            thread.join()
        if error:
            raise error[0]
        return written
