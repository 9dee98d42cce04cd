"""The port's Sampler, PNG writer and sampling CLI, on the CPU.

The Sampler is held against the JAX ``Generator.apply`` on the same weights
with the same latents and noise, handed in through ``Sampler.render``: the
JAX Sampler draws its own latents from a JAX key, so it cannot be the
comparison.
"""

import functools
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byogan_tpu_torch.cli.generate_samples import main as generate_main
from byogan_tpu_torch.ops import adain as port_adain
from byogan_tpu_torch.ops import styleconv as port_sc
from byogan_tpu_torch.serve import Sampler, encode_png

SPEC = dict(num_stages=3, channel_divisor=16, style_dim=512, mapping_depth=2)
STEPS, ALPHA, BATCH = 3, 0.4, 3


def decode_png(data: bytes) -> np.ndarray:
    """Parse a PNG written with filter 0 on every row: check the signature
    and every chunk's CRC, inflate IDAT, return the uint8 HWC pixels."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + length
    assert kind == b"IEND"
    w, h, depth, color, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    c = {0: 1, 2: 3, 6: 4}[color]
    assert depth == 8
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * c)
    assert not rows[:, 0].any()  # filter type 0 everywhere
    return rows[:, 1:].reshape(h, w, c)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A small JAX-initialised generator saved as a reference-format .pth
    with a ``model`` entry; noise weights perturbed so noise shows."""
    from byogan_tpu.compat.torch_ckpt import generator_params_to_torch
    from byogan_tpu.core.random import synthesis_noise as jax_noise
    from byogan_tpu.models.factory import ModelSpec, build_generator

    spec = ModelSpec(**SPEC)
    jgen = build_generator(spec)
    key = jax.random.PRNGKey(4)
    init = jax.jit(functools.partial(jgen.init, steps=1))
    params = jax.tree_util.tree_map(
        np.asarray, init(key, jnp.zeros((1, 32)), jax_noise(key, 1, STEPS))["params"]
    )
    rng = np.random.default_rng(5)
    for k in range(STEPS):
        for conv in ("conv1", "conv2"):
            w = params[f"stages_{k}"][conv]["noise"]["weight"]
            params[f"stages_{k}"][conv]["noise"]["weight"] = (
                0.3 * rng.standard_normal(w.shape)
            ).astype(np.float32)
    state = generator_params_to_torch(params, num_stages=STEPS, mapping_depth=2)
    path = str(tmp_path_factory.mktemp("ckpt") / "gen.pth")
    torch.save(
        {
            "gen": {k: torch.tensor(v) for k, v in state.items()},
            "step": STEPS, "alpha": ALPHA, "iter": 7, "model": spec.to_dict(),
        },
        path,
    )
    return path, jgen, params


def test_sampler_frames_match_jax_generator(checkpoint):
    path, jgen, params = checkpoint
    rng = np.random.default_rng(6)
    z = np.clip(rng.standard_normal((BATCH, 32)), -0.75, 0.75).astype(np.float32)
    noise = [
        rng.standard_normal((BATCH, 4 * 2**i, 4 * 2**i, 1)).astype(np.float32)
        for i in range(STEPS)
    ]
    img = jgen.apply(
        {"params": params}, jnp.asarray(z), [jnp.asarray(n) for n in noise],
        steps=STEPS, alpha=jnp.float32(ALPHA),
    )
    want = np.asarray(jnp.clip(img.astype(jnp.float32) * 255.0 + 0.5, 0, 255).astype(jnp.uint8))

    sampler = Sampler(path, batch=BATCH, dtype="float32", device="cpu", seed=0)
    assert sampler.resolution == 16 and sampler.z_dim == 32
    got = sampler.render(torch.from_numpy(z), [torch.from_numpy(n) for n in noise]).numpy()
    assert got.dtype == np.uint8 and got.shape == (BATCH, 16, 16, 3)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1  # 1 LSB


def test_sampler_tiles_ragged_requests_and_is_seeded(checkpoint):
    path, _, _ = checkpoint
    a = Sampler(path, batch=BATCH, device="cpu", seed=11)
    frames = a.sample(5)  # a full batch, then 2 cut from a second full one
    assert frames.shape == (5, 16, 16, 3) and frames.dtype == np.uint8
    b = Sampler(path, batch=BATCH, device="cpu", seed=11)
    np.testing.assert_array_equal(b.sample(5), frames)
    raw = Sampler(path, batch=BATCH, device="cpu", seed=11, dtype="float32").sample_float(4)
    assert raw.shape == (4, 16, 16, 3) and raw.dtype == np.float32
    assert np.isfinite(raw).all() and (raw < 0).any()


def test_sampler_never_launches_kernels_on_cpu(checkpoint):
    path, _, _ = checkpoint
    before = (port_sc.styleconv_cuda.launches, port_adain.noise_lrelu_adain_cuda.launches)
    Sampler(path, batch=2, device="cpu", seed=1).sample(2)
    assert (port_sc.styleconv_cuda.launches, port_adain.noise_lrelu_adain_cuda.launches) == before


def test_default_sampler_raises_without_cuda(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler(checkpoint[0])


def test_save_stream_writes_valid_pngs(checkpoint, tmp_path):
    path, _, _ = checkpoint
    frames = Sampler(path, batch=2, device="cpu", seed=3).sample(3)
    n = Sampler(path, batch=2, device="cpu", seed=3).save_stream(str(tmp_path), 3)
    assert n == 3 and sorted(os.listdir(tmp_path)) == [f"image_{i}.png" for i in (1, 2, 3)]
    for i in range(3):
        data = (tmp_path / f"image_{i + 1}.png").read_bytes()
        np.testing.assert_array_equal(decode_png(data), frames[i])


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 1, 3), (64, 3, 3)])
def test_encode_png_round_trips(shape):
    frame = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(frame)), frame)


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4, 3), np.float32)])
def test_encode_png_rejects_non_rgb_uint8(bad):
    with pytest.raises(ValueError):
        encode_png(bad)


@pytest.mark.parametrize("fmt", ["png", "raw"])
def test_cli_writes_reference_named_images(checkpoint, tmp_path, fmt, capsys):
    path, _, _ = checkpoint
    generate_main([path, "4", "-d", "cpu", "-o", str(tmp_path), "--seed", "2",
                   "--batch", "3", "--format", fmt])
    ext = ".png" if fmt == "png" else ".npy"
    assert sorted(os.listdir(tmp_path)) == [f"image_{i}{ext}" for i in (1, 2, 3, 4)]
    for i in (1, 2, 3, 4):
        f = tmp_path / f"image_{i}{ext}"
        img = decode_png(f.read_bytes()) if fmt == "png" else np.load(f)
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert "wrote 4 images" in capsys.readouterr().out


def test_cli_rejects_missing_output_dir(checkpoint, tmp_path):
    with pytest.raises(OSError):
        generate_main([checkpoint[0], "1", "-d", "cpu", "-o", str(tmp_path / "nope")])
