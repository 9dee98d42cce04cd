"""The port's PSD reader against Pillow and the JAX package, on the CPU.

The JAX package reads a Photoshop file under a listed extension through
Pillow alone: its prep and ``cli.project`` call
``Image.open(path).convert("RGB")``, and its loader falls back to the same
call.  So the port's ``data/images.decode_psd`` (numpy, with the PackBits
loop in the native library) is held bit for bit to Pillow 12.1.0's
``convert("RGB")`` of the merged image: on every colour mode Pillow reads
(bitmap, gray, indexed, RGB, RGBA, CMYK, multichannel, duotone, and Lab
through LittleCMS's Lab -> sRGB transform, ``fx.lab_psd_layouts``), raw
and PackBits, colour data, resources and layers to skip, PackBits streams
whose packets cross rows and hold no-ops, on 240 seeded files, and on
Pillow's refusals with the file and the reason named.  Then a folder of PSD originals under
listed names through the port's ``cli.prep`` against the JAX package's
``prepare_pyramid``, the loader against the JAX loader's Pillow fallback,
and ``cli.project`` targets against the JAX CLI's arrays.  Tolerance 0.
"""

import os
import re
import struct
import sys
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images
from byogan_tpu_torch.data import pipeline as port_pipe

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402
from test_torch_port_gif import _pillow, _same_as_pillow, _write  # noqa: E402

LAYOUTS = {**{k: v for k, v in fx.raster_layouts().items() if k.split("/")[1] == "psd"}, **fx.lab_psd_layouts()}
REFUSALS = {k: v for k, v in fx.raster_refusals().items() if k.startswith("psd")}
LISTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: n.split("/", 2)[2][:-4])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name)[:-4] + ".png", LAYOUTS[name])  # under a listed name
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n[:-4])
def test_refused_file_raises_naming_the_file_and_the_reason(tmp_path, name):
    """Pillow refuses each."""
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name[:-4] + ".jpg", data)
    assert isinstance(_pillow(path), Exception)
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


def _packets(r, nbytes: int) -> bytes:
    """Random PackBits packets of at least ``nbytes`` bytes of output: runs,
    literals and the 0x80 no-op, with no regard for rows."""
    out = bytearray()
    while len(out) < nbytes:
        k = r.random()
        if k < 0.05:
            out.append(0x80)
        elif k < 0.5:
            n = int(r.integers(2, 129))
            out += bytes([257 - n, int(r.integers(0, 256))])
        else:
            n = int(r.integers(1, 129))
            out += bytes([n - 1]) + r.integers(0, 256, n, dtype=np.uint8).tobytes()
    return bytes(out)


def _seeded_psd(r, modes=None) -> bytes:
    """A PSD over the reader's parameters together: colour mode and depth
    (some Pillow does not identify; one of ``modes`` where given), channels
    (too few, more), size, colour data, resources, layers, raw or PackBits
    (a row at a time, or random packets whose counts only place the
    channels), ZIP, truncation."""
    modes = modes or [(0, 1), (0, 8), (1, 8), (2, 8), (3, 8), (3, 8), (4, 8), (7, 8), (8, 8), (3, 16), (5, 8)]
    mode, bits = modes[int(r.integers(0, len(modes)))]
    need = {2: 1, 3: 3, 4: 4}.get(mode, 3 if mode in (5, 9) else 1)
    channels = max(1, need + int(r.choice([0, 0, 1, 2, -1])))
    h, w = int(r.integers(1, 12)), int(r.integers(1, 14))
    row = (w + 7) // 8 if bits == 1 else w
    planes = r.integers(0, 256, (channels, h, row)).astype(np.uint8)
    if r.random() < 0.5:
        planes = planes // 64 * 64
    color = b""
    if mode == 2 and r.random() < 0.8:
        color = r.integers(0, 256, 768, dtype=np.uint8).tobytes()
    elif r.random() < 0.2:
        color = r.integers(0, 256, int(r.integers(1, 50)), dtype=np.uint8).tobytes()
    resources = b""
    if r.random() < 0.4:
        resources = b"".join(fx.psd_resource(int(r.integers(1000, 1100)), b"n" * int(r.integers(0, 4)),
                                             bytes(int(r.integers(0, 7)))) for _ in range(int(r.integers(1, 4))))
    layers = b""
    if r.random() < 0.3:
        inner = r.integers(0, 256, int(r.integers(0, 30)), dtype=np.uint8).tobytes()
        layers = struct.pack(">I", len(inner)) + inner + bytes(int(r.integers(0, 5)))
    compression = int(r.choice([0, 1, 1, 2]))
    kw = {}
    if compression == 1 and r.random() < 0.5:
        read = 4 if mode == 3 and channels == 4 else min(need, channels)
        streams = [_packets(r, h * row) for _ in range(read)]
        counts = []
        for st in streams:
            cuts = sorted(r.integers(0, len(st) + 1, h - 1).tolist())
            counts += np.diff([0] + cuts + [len(st)]).tolist()
        kw = dict(streams=streams, counts=counts)
    data = fx.psd_file(planes, mode, w, bits, compression, channels, color, resources, layers, **kw)
    return data[:int(r.integers(10, len(data)))] if r.random() < 0.08 else data


@pytest.mark.parametrize("seed", range(3))
def test_seeded_psd_match_pillow(tmp_path, seed):
    """80 seeded PSD files a seed: wherever Pillow decodes one, the port
    decodes it to the same pixels; wherever Pillow refuses one, the port
    raises ``OSError`` naming it."""
    r = np.random.default_rng(2030 + seed)
    decoded = sum(_same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", _seeded_psd(r)), f"file {t}")
                  for t in range(80))
    assert decoded > 20


@pytest.mark.parametrize("seed", range(2))
def test_seeded_lab_psd_match_pillow(tmp_path, seed):
    """80 seeded Lab PSDs a seed (8 bits, and 16, which Pillow does not
    identify) under the same rule."""
    r = np.random.default_rng(2035 + seed)
    decoded = sum(_same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", _seeded_psd(r, [(9, 8), (9, 8), (9, 16)])),
                                  f"file {t}") for t in range(80))
    assert decoded > 12


@pytest.mark.parametrize("channel", range(3))
def test_packbits_channel_ends_at_the_files_end(tmp_path, channel):
    """A channel's stream runs from where the counts place it to the file's
    end, whatever the counts say of its own rows: counts that place a
    channel early read it from there, and one placed past the data is
    refused as Pillow refuses it (truncated)."""
    r = np.random.default_rng(2035 + channel)
    planes = r.integers(0, 4, (3, 6, 9)).astype(np.uint8) * 60
    coded = [fx.packbits_row(row) for p in planes for row in p]
    counts = [len(c) for c in coded]
    for shift in (-1, 1, 5, 400):
        moved = counts.copy()
        moved[6 * channel] = max(0, moved[6 * channel] + shift)
        data = fx.psd_file(planes, 3, 9, compression=1, streams=[b"".join(coded)], counts=moved)
        _same_as_pillow(_write(tmp_path, f"s{shift}.png", data), f"shift {shift}")


def _originals(root: str) -> str:
    """Small PSD originals under listed names: PackBits RGB with resources
    and layers (.jpg), raw CMYK (.png), indexed with a palette (.jpeg),
    RGBA (.bmp), bitmap (.webp), duotone (.png)."""
    os.makedirs(root)
    img = fx.source_image(2040, 37, 45)
    planes = np.concatenate([img, img[..., :1] // 2], 2).transpose(2, 0, 1)
    r = np.random.default_rng(2041)
    data = {
        "a.jpg": fx.psd_file(planes[:3], 3, 45, compression=1, resources=fx.psd_resource(1005, b"r", bytes(16)),
                             layers=struct.pack(">I", 8) + bytes(8)),
        "b.png": fx.psd_file(planes, 4, 45),
        "c.jpeg": fx.psd_file(planes[:1], 2, 45, compression=1, color=r.integers(0, 256, 768, dtype=np.uint8).tobytes()),
        "d.bmp": fx.psd_file(planes, 3, 45, compression=1),
        "e.webp": fx.psd_file(fx._pack(r.integers(0, 2, (37, 45, 1)), 1)[None], 0, 45, bits=1),
        "f.png": fx.psd_file(planes[1:2], 8, 45, color=bytes(20)),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_psd_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets on a folder of PSD originals under listed names."""
    from byogan_tpu.data.prep import prepare_pyramid as jax_prepare

    from byogan_tpu_torch.cli import prep as port_prep_cli
    from byogan_tpu_torch.data.png import read_png

    jax_root, port_root = _originals(str(tmp_path / "jax")), _originals(str(tmp_path / "port"))
    jax_prepare(jax_root, 4, 32, workers=2)
    port_prep_cli.main([port_root, "4", "32", "-y", "-w", "2", "-d", "cpu"])
    n = 0
    for k in range(1, 5):
        sub = os.path.join("prepared", f"set_{k}", "images")
        names = sorted(os.listdir(os.path.join(port_root, sub)))
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) and len(names) == 6
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
            n += 1
    assert n == 24


def test_loader_reads_psd_as_jax_pillow_fallback(tmp_path):
    """A prepared set of PSD files under listed names: the port's loader
    reads each as the JAX package's ``StageDataset`` does through its
    Pillow fallback, on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    r = np.random.default_rng(2042)
    for i in range(6):
        planes = r.integers(0, 256, (4, 16, 16)).astype(np.uint8)
        mode = (3, 3, 4)[i % 3]  # RGB, RGB, CMYK
        data = fx.psd_file(planes[:4 if mode == 4 else 3 + i % 2], mode, 16, compression=i % 2)
        (folder / f"image-{i}.{('png', 'jpg', 'webp')[i % 3]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)


def test_project_targets_given_as_psd_match_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on ``face.psd`` (PackBits RGB) and
    ``face2.psd`` (raw CMYK) at the stage's size: the arrays the JAX CLI
    builds (``Image.open(path).convert("RGB")``)."""
    from byogan_tpu_torch.cli.project import load_target

    img = fx.source_image(2043, 32, 32)
    planes = np.concatenate([img, img[..., :1]], 2).transpose(2, 0, 1)
    paths = [_write(tmp_path, "face.psd", fx.psd_file(planes[:3], 3, 32, compression=1)),
             _write(tmp_path, "face2.psd", fx.psd_file(planes, 4, 32))]
    for path in paths:
        with Image.open(path) as im:  # byogan_tpu/cli/project.py's target
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=path)
        np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=path)
