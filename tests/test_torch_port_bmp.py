"""The port's BMP reader against Pillow, every layout, on the CPU.

The JAX package reads BMP files through Pillow alone: its prep and
``cli.project`` call ``Image.open(path).convert("RGB")``, and its loader
falls back to the same call (its native lane reads no BMP).  So the
port's ``data/images.decode_bmp`` (numpy, no library) is held bit for bit
to Pillow 12.1.0's ``convert("RGB")`` on a file of every layout Pillow
reads (``torch_port_codec_fixtures.bmp_layouts``: every header size,
palettes of 1, 4 and 8 bits, the gray palettes Pillow drops, 16-bit and
bitfield pixels, 24 and 32 bits, RLE8 and RLE4 with every escape,
top-down rows), and to Pillow's refusal of every other layout, with the
file and the reason named.  Tolerance 0.
"""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402

LAYOUTS = fx.bmp_layouts()
REFUSALS = fx.bmp_refusals()


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / os.path.basename(name))
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: os.path.basename(n)[:-4])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, name, LAYOUTS[name])
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = images.read_image(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n[:-4])
def test_refused_layout_raises_naming_the_file_and_the_reason(tmp_path, name):
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name, data)
    with pytest.raises(Exception):  # Pillow refuses it too: OSError, ValueError
        with Image.open(path) as im:
            im.convert("RGB")
    with pytest.raises(OSError, match=f"{name.replace('.', '[.]')}: BMP .*{reason}"):
        images.read_image(path)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_layouts_match_pillow(tmp_path, seed):
    """Seeded files over the layouts' parameters together (header, depth,
    compression, palette size and kind, masks, offsets, direction, RLE
    streams of runs, absolute runs and deltas, truncation): wherever
    Pillow decodes one, the port decodes it to the same pixels, and
    wherever Pillow refuses one, the port raises ``OSError`` naming it."""
    r = np.random.default_rng(160 + seed)
    ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)
    decoded = 0
    for t in range(150):
        w, h = int(r.integers(1, 20)), int(r.integers(1, 12))
        header = int(r.choice([12, 40, 52, 56, 64, 108, 124]))
        bits = int(r.choice([1, 4, 8, 16, 24, 32]))
        comp = 0 if header == 12 else int(r.choice([0, 0, 1, 2, 3]))
        palette, colors = None, 0
        if bits <= 8:
            n = int(r.choice([1 << bits, r.integers(1, (1 << bits) + 1), r.integers(1, 300)]))
            kind = r.random()
            palette = ramp[np.arange(n) & 255] if kind < 0.25 else (
                np.array([[0, 0, 0], [255, 255, 255]]) if kind < 0.35 else r.integers(0, 256, (n, 3)))
            colors = 0 if header == 12 else len(palette)
        masks = ((0xFF0000, 0xFF00, 0xFF, 0), (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0, 0, 0, 0), (0xF800, 0x7E0, 0x1F),
                 (0x7C00, 0x3E0, 0x1F), (1, 2, 4))[int(r.integers(0, 6))] if comp == 3 else ()
        if comp in (1, 2):
            rows = r.integers(0, 16 if comp == 2 else 256, (h, w)) // int(r.integers(1, 5))
            body = bytearray(fx.rle_stream(rows, comp == 2))
            if r.random() < 0.3:  # a delta in place of an end of line
                at = body.find(b"\0\0")
                body[at:at + 2] = bytes([0, 2, 0, 0, int(r.integers(0, 3)), int(r.integers(0, 2))])
            body = bytes(body)
        else:
            body = bytes(r.integers(0, 256, (w * bits + 31) // 32 * 4 * h, dtype=np.uint8))
        offset = (None, None, None, 0, 14 + header)[int(r.integers(0, 5))]
        data = fx.bmp_file(body, w, h, bits, header=header, compression=comp, palette=palette, colors=colors,
                           masks=masks, offset=offset, top_down=header != 12 and r.random() < 0.2)
        if r.random() < 0.1:
            data = data[:-int(r.integers(1, 8))]
        path = _write(tmp_path, f"f{t}.bmp", data)
        try:
            with Image.open(path) as im:
                want = np.asarray(im.convert("RGB"))
        except Exception:  # noqa: BLE001 - Pillow refuses it: OSError, ValueError
            with pytest.raises(OSError, match=f"f{t}[.]bmp: "):
                images.read_image(path)
            continue
        np.testing.assert_array_equal(images.read_image(path), want, err_msg=f"file {t}")
        decoded += 1
    assert decoded > 40


def test_rle_at_1024_px_matches_pillow():
    """The committed 1024 px RLE8 original the card prepares (a Python loop
    over opcodes): Pillow's pixels."""
    path = os.path.join(fx.FIXTURES, fx.PILLOW, "card", "rle8-1024.bmp")
    with Image.open(path) as im:
        np.testing.assert_array_equal(images.read_image(path), np.asarray(im.convert("RGB")))
