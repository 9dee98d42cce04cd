"""The port's baseline TIFF decoder against Pillow, on the CPU.

The JAX package reads a TIFF under a listed extension through Pillow alone
(its prep, ``cli.project`` and its loader's fallback): Pillow's own raw
decoder for uncompressed files, libtiff 4.7.1 for the rest.  So the port's
``native/tiff.cpp`` (through ``data/images.read_image``, both lanes) is
held bit for bit to Pillow 12.1.0's ``convert("RGB")`` of the first page
on a file of each layout it reads (``torch_port_codec_fixtures.tiff_layouts``:
II and MM, strips and tiles, planar configurations 1 and 2, no
compression, PackBits, LZW and Deflate, Predictor 2 where libtiff applies
it, 1-, 2-, 4-, 8- and 16-bit gray, signed and float gray, gray with
alpha, 8- and 16-bit RGB with extra samples, 1- to 8-bit palettes, 8- and
16-bit CMYK, FillOrder 2, every Orientation; JPEG compression and YCbCr,
``fx.ycbcr_jpeg_layouts``, more in ``test_torch_port_tiff_jpeg.py``), on
TIFFs Pillow writes through libtiff and on seeded files; and each kind it
does not read is refused naming the file and the kind, whether Pillow
reads it or not.  Tolerance 0.
"""

import os
import re
import sys

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402
from test_torch_port_gif import _pillow, _same_as_pillow, _write  # noqa: E402

LAYOUTS = fx.tiff_layouts()
REFUSALS = fx.tiff_refusals()


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: os.path.basename(n)[:-4])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, name.replace(".tif", ".png"), LAYOUTS[name])  # a TIFF under a listed name
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n[:-4])
def test_refused_tiff_raises_naming_the_file_and_the_kind(tmp_path, name):
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name.replace(".tif", ".jpg"), data)
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits"])
@pytest.mark.parametrize("mode", ["1", "L", "I;16", "LA", "RGB", "RGBA", "P", "CMYK", "F"])
def test_pillow_written_tiff_matches_pillow(tmp_path, compression, mode):
    """Pillow's own writer (libtiff for the compressed ones)."""
    img = fx.smooth_scene(1780, 24, 37, cell=8, step=8)
    im = Image.fromarray(img)
    if mode == "I;16":
        im = Image.fromarray((img[..., 0].astype(np.uint16) * 3 + 7))
    elif mode == "F":
        im = Image.fromarray(img[..., 0].astype(np.float32) * 1.7 - 40)
    elif mode == "P":
        im = im.quantize(50)
    elif mode != "RGB":
        im = im.convert(mode)
    path = str(tmp_path / "a.png")
    im.save(path, format="TIFF", compression=compression)
    assert _same_as_pillow(path, f"{mode} {compression}")


def _seeded_tiff(r) -> bytes:
    """A TIFF over the layouts' parameters together: kind, size, byte
    order, compression, predictor, planes, strips or tiles, fill order,
    orientation, truncation."""
    kind = r.choice(["bilevel", "gray8", "gray16", "gray-alpha", "rgb", "rgba", "palette", "gray-low", "signed",
                     "float", "cmyk", "rgb16"])
    h, w = int(r.integers(1, 40)), int(r.integers(1, 40))
    kw = {"order": "<" if r.random() < 0.6 else ">", "compression": int(r.choice([1, 5, 5, 8, 32946, 32773]))}
    tags = {}
    if kind == "bilevel":
        s = r.integers(0, 2, (h, w))
        kw.update(bits=1, photometric=int(r.integers(0, 2)))
    elif kind == "gray8":
        s = r.integers(0, 256, (h, w))
        kw.update(photometric=int(r.integers(0, 2)))
    elif kind == "gray16":
        s = r.integers(0, 65536, (h, w)) >> int(r.choice([0, 6, 8]))
        kw.update(bits=16, photometric=int(r.integers(0, 2)))
    elif kind == "gray-alpha":
        s = r.integers(0, 256, (h, w, 2))
        kw.update(photometric=1, extra=(2,))
    elif kind == "rgb":
        s = r.integers(0, 256, (h, w, 3))
    elif kind == "rgba":
        n = int(r.choice([4, 4, 5, 6]))
        s = r.integers(0, 256, (h, w, n))
        if r.random() < 0.5:
            s[..., 3] = r.choice([0, 1, 128, 254, 255], (h, w))
        kw["extra"] = ([None, (0,), (1,), (2,), (999,)][int(r.integers(0, 5))] if n == 4
                       else (int(r.integers(0, 3)),) + (0,) * (n - 4))
    elif kind == "gray-low":
        bits = int(r.choice([2, 4]))
        s = r.integers(0, 1 << bits, (h, w))
        kw.update(bits=bits, photometric=int(r.choice([0, 1, 3])))
        if kw["photometric"] == 3:
            kw["colormap"] = r.integers(0, 65536, (1 << bits, 3))
    elif kind == "signed":
        bits = int(r.choice([8, 16]))
        s = r.integers(0, 1 << bits, (h, w))
        kw.update(bits=bits, photometric=1)
        tags[339] = (3, [2])
    elif kind == "float":
        order = kw["order"]
        s = r.normal(100, 150, (h, w)).astype(order + "f4").view(order + "u4")
        kw.update(bits=32, photometric=int(r.integers(0, 2)))
        tags[339] = (3, [3])
    elif kind == "cmyk":
        bits = int(r.choice([8, 8, 16]))
        n = 4 if bits == 16 else int(r.choice([4, 4, 5]))
        s = r.integers(0, 1 << bits, (h, w, n))
        kw.update(bits=bits, photometric=5, extra=(0,) if n == 5 else None)
    elif kind == "rgb16":
        n = int(r.choice([3, 4]))
        s = r.integers(0, 65536, (h, w, n))
        kw.update(bits=16, extra=[None, (0,), (1,), (2,)][int(r.integers(0, 4))] if n == 4 else None)
    else:
        s = r.integers(0, 256, (h, w))
        kw.update(photometric=3, colormap=r.integers(0, 65536, (256, 3)))
    if r.random() < 0.4 and kw.get("bits", 8) != 1 or r.random() < 0.1:
        kw["predictor"] = 2
    if r.random() < 0.3 and (s.ndim == 3 or r.random() < 0.2):
        kw["planar"] = 2
    if r.random() < 0.3:
        kw["tile"] = (int(r.choice([16, 32])), int(r.choice([16, 32, 48])))
    elif r.random() < 0.5:
        kw["rows_per_strip"] = int(r.integers(1, h + 3))
    if r.random() < 0.3:
        kw["orientation"] = int(r.integers(0, 10))
    if r.random() < 0.1:
        tags[266] = (3, [2])  # FillOrder 2: the coded bytes are not reversed, so compressed ones decode to other data
    data = fx.tiff_bytes(s, tags=tags, **kw)
    return data[:int(r.integers(8, len(data)))] if r.random() < 0.08 else data


@pytest.mark.parametrize("seed", range(3))
def test_seeded_tiffs_match_pillow(tmp_path, seed):
    """80 seeded files a seed: wherever Pillow decodes one, the port
    decodes it to the same pixels (every kind here is one the port reads,
    so every one Pillow reads is read); wherever Pillow refuses one, the
    port raises ``OSError`` naming it."""
    r = np.random.default_rng(1790 + seed)
    decoded = sum(_same_as_pillow(_write(tmp_path, f"t{t}.png", _seeded_tiff(r)), f"file {t}") for t in range(80))
    assert decoded > 50


def test_card_scan_matches_pillow():
    """The committed 1024 px LZW TIFF (predictor 2) the card prepares."""
    name = next(n for n, listed in fx.GIF_TIFF_CARD.items() if n.endswith(".tif"))
    path = os.path.join(fx.FIXTURES, fx.GIF_TIFF, "card", name)
    assert not isinstance(_pillow(path), Exception)
    np.testing.assert_array_equal(images.read_image(path), _pillow(path))
