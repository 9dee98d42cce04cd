"""The port's ICO, CUR and DIB readers against Pillow, on the CPU.

The JAX package reads an icon, a cursor or a headerless bitmap under a
listed extension through Pillow alone: its prep and ``cli.project`` call
``Image.open(path).convert("RGB")``, and its loader falls back to the same
call.  So the port's ``data/images.decode_ico``, ``decode_cur`` and
``decode_dib`` (numpy, the bitmap reader ``decode_bmp`` shares, and the
port's PNG codec for an icon's PNG frame) are held bit for bit to Pillow
12.1.0's ``convert("RGB")``: on icons Pillow writes with PNG and BMP
frames of every mode, on this module's layouts
(``torch_port_codec_fixtures.ico_pnm_tga_layouts``: entries of equal
areas and other depths, frames of another size than their entries, 32-bit
frames, top-down and OS/2 frames, cursors that pick a later entry or do
not, DIBs of every header and depth), on a DIB of every BMP layout, on
400 seeded files, and on Pillow's refusals, with the file and the reason
named.  Tolerance 0.
"""

import os
import re
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402
from test_torch_port_gif import _same_as_pillow, _write  # noqa: E402

LAYOUTS = {k: v for k, v in fx.ico_pnm_tga_layouts().items() if k.split("/")[1] in ("ico", "cur", "dib")}
REFUSALS = {k: v for k, v in fx.ico_pnm_tga_refusals().items() if k.startswith(("ico", "cur", "dib"))}
LISTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

pytestmark = pytest.mark.filterwarnings("ignore:Image was not the expected size")


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: n.split("/", 1)[1][:-4])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name)[:-4] + ".png", LAYOUTS[name])  # under a listed name
    assert images.sniff(LAYOUTS[name][:18]) == name.split("/")[1].upper()
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n[:-4])
def test_refused_file_raises_naming_the_file_and_the_reason(tmp_path, name):
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name[:-4] + ".jpg", data)
    with pytest.raises(Exception):  # Pillow refuses it too: OSError, ValueError, UnidentifiedImageError
        with Image.open(path) as im:
            im.convert("RGB")
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


@pytest.mark.parametrize("name", sorted(fx.bmp_layouts()), ids=lambda n: os.path.basename(n)[:-4])
def test_dib_of_every_bmp_layout_matches_pillow(tmp_path, name):
    """A BMP layout without its 14-byte file header: Pillow's DIB reads the
    pixels right after the palette, whatever offset the BMP gave."""
    path = _write(tmp_path, "dib.bmp", fx.bmp_layouts()[name][14:])
    _same_as_pillow(path, name)


@pytest.mark.parametrize("fmt", ["png", "bmp"])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "I;16"])
def test_pillow_written_icons_match_pillow(tmp_path, fmt, mode):
    """Pillow's ICO writer, every size it writes up to 48 px, a frame each."""
    img = fx.smooth_scene(1810, 48, 48, cell=8, step=8)
    im = Image.fromarray(img).convert(mode) if mode != "I;16" else Image.fromarray(img[..., 0].astype(np.uint16) * 3)
    if fmt == "bmp" and mode == "I;16":
        im = im.convert("L")
    path = str(tmp_path / "a.webp")
    im.save(path, "ICO", sizes=[(16, 16), (24, 24), (32, 32), (48, 48)], bitmap_format=fmt)
    assert _same_as_pillow(path, f"{mode} {fmt}")


def _seeded_frame(r, w: int, h: int) -> bytes:
    """A PNG or DIB frame of an icon: any depth, palette, header, mask or
    none, top-down rows."""
    if r.random() < 0.2:
        return fx.png_bytes(r.integers(0, 256, (h, w, 3)), 8, 2)
    bits = int(r.choice([1, 4, 8, 16, 24, 32]))
    values = r.integers(0, 256, (h, w, 3)) if bits == 24 else r.integers(0, 1 << min(bits, 24), (h, w))
    n = int(r.choice([1 << min(bits, 8), r.integers(1, 257)]))
    palette = r.integers(0, 256, (n, 3)) if bits <= 8 else None
    return fx.icon_dib(values, bits, palette, mask=r.random() < 0.8, top_down=r.random() < 0.15,
                       header=int(r.choice([40, 40, 12, 108])))


def _seeded_icon(r) -> bytes:
    """An ICO or CUR over the readers' parameters together: entries of
    sizes that may not be their frames', depths, colour counts, sizes and
    offsets that may be off, and truncation."""
    kind = 1 if r.random() < 0.6 else 2
    frames = []
    for _ in range(int(r.integers(1, 4))):
        w, h = int(r.integers(1, 20)), int(r.integers(1, 14))
        fw, fh = (w, h) if r.random() < 0.8 else (int(r.integers(1, 20)), int(r.integers(1, 14)))
        frames.append((fw, fh, int(r.choice([0, 0, 2, 16, 255])), int(r.choice([0, 1, 8, 24, 32])),
                       _seeded_frame(r, w, h)))
    sizes = [None if r.random() < 0.85 else int(r.integers(0, 400)) for _ in frames]
    data = fx.icon_file(frames, kind, sizes=sizes)
    return data[:int(r.integers(6, len(data)))] if r.random() < 0.1 else data


@pytest.mark.parametrize("seed", range(4))
def test_seeded_icons_and_cursors_match_pillow(tmp_path, seed):
    """100 seeded icons and cursors a seed: wherever Pillow decodes one,
    the port decodes it to the same pixels; wherever Pillow refuses one,
    the port raises ``OSError`` naming it."""
    r = np.random.default_rng(1820 + seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        decoded = sum(_same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", _seeded_icon(r)), f"file {t}")
                      for t in range(100))
    assert decoded > 40


def test_seeded_dibs_match_pillow(tmp_path):
    """100 seeded headerless bitmaps of any header, depth, palette and row
    order, cut short at times."""
    r = np.random.default_rng(1830)
    decoded = 0
    for t in range(100):
        w, h, bits = int(r.integers(1, 20)), int(r.integers(1, 12)), int(r.choice([1, 4, 8, 16, 24, 32]))
        values = r.integers(0, 256, (h, w, 3)) if bits == 24 else r.integers(0, 1 << min(bits, 24), (h, w))
        n = int(r.choice([1 << min(bits, 8), r.integers(1, 257)]))
        header, top_down = int(r.choice([40, 12, 56, 124])), r.random() < 0.2
        rows = fx.bmp_rows(values, bits)
        data = fx.dib_bytes((rows if top_down and header != 12 else rows[::-1]).tobytes(), w, h, bits, header=header,
                            palette=r.integers(0, 256, (n, 3)) if bits <= 8 else None,
                            top_down=top_down and header != 12)
        if r.random() < 0.15:
            data = data[:int(r.integers(4, len(data)))]
        decoded += _same_as_pillow(_write(tmp_path, f"d{t}.bmp", data), f"file {t}")
    assert decoded > 40
