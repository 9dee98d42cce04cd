"""The port's CCITT (fax) TIFF decoder against Pillow and libtiff, on the CPU.

Pillow 12.1.0 reads compressions 2 (Modified Huffman), 3 (T.4 1-D and
2-D), 4 (T.6) and 32771 (Modified Huffman, rows word-aligned) through
libtiff 4.7.1's tif_fax3.c; the port's ``native/ccitt.cpp`` follows it.
Each file the port reads is held bit for bit to Pillow's
``convert("RGB")``; and since libtiff goes on past a bad code word, a row
of the wrong length or data cut short, and Pillow then shows what it
decoded, each file is also held to libtiff itself (Pillow's own build,
through ctypes, its error and warning handlers recording what it reports):
the port reads a file exactly where libtiff decodes every strip and tile
with nothing to report, and refuses it by name otherwise.  Files by the
fixtures' writer (``fx.ccitt_tiff``: every compression, T4Options,
FillOrder, photometric, strips and tiles), by Pillow's writer and seeded
files, some cut or with bits flipped.  Tolerance 0.
"""

import ctypes
import glob
import os
import re
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402
from test_torch_port_gif import _pillow, _same_as_pillow, _write  # noqa: E402

LAYOUTS = fx.ccitt_layouts()
REFUSALS = {k: v for k, v in fx.tiff_refusals().items() if k.startswith("ccitt-")}
PALETTE_LAYOUTS = {k: v for k, v in fx.legacy_layouts().items() if "/tiff/ccitt-palette-" in k}

_HANDLER = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p)


class _Libtiff:
    """Pillow's libtiff through ctypes, its messages recorded."""

    def __init__(self):
        import PIL

        found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs", "libtiff-*.so*"))
        assert found, "Pillow's bundled libtiff"
        self.lib = ctypes.CDLL(found[0])
        self.messages = []
        self._keep = _HANDLER(lambda module, fmt, ap: self.messages.append((module or b"").decode()))
        lib = self.lib
        lib.TIFFOpen.restype = ctypes.c_void_p
        lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        for name in ("TIFFIsTiled", "TIFFNumberOfStrips", "TIFFNumberOfTiles", "TIFFClose"):
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("TIFFStripSize", "TIFFTileSize"):
            getattr(lib, name).argtypes = [ctypes.c_void_p]
            getattr(lib, name).restype = ctypes.c_int64
        for name in ("TIFFReadEncodedStrip", "TIFFReadEncodedTile"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64]
            getattr(lib, name).restype = ctypes.c_int64
        lib.TIFFSetErrorHandler.restype = lib.TIFFSetWarningHandler.restype = ctypes.c_void_p
        lib.TIFFSetErrorHandler.argtypes = lib.TIFFSetWarningHandler.argtypes = [ctypes.c_void_p]

    def clean(self, path: str) -> bool:
        """Whether libtiff reads the file's first directory and decodes its
        every strip or tile with no error and no warning (its fax decoders'
        and its directory reader's, which repairs a strip's byte count of
        0 from the file's size)."""
        lib = self.lib
        handler = ctypes.cast(self._keep, ctypes.c_void_p)
        old_error, old_warning = lib.TIFFSetErrorHandler(handler), lib.TIFFSetWarningHandler(handler)
        self.messages = []
        try:
            tif = lib.TIFFOpen(path.encode(), b"r")
            if not tif:
                return False
            try:
                tiled = lib.TIFFIsTiled(tif)
                n = lib.TIFFNumberOfTiles(tif) if tiled else lib.TIFFNumberOfStrips(tif)
                size = lib.TIFFTileSize(tif) if tiled else lib.TIFFStripSize(tif)
                buf = ctypes.create_string_buffer(max(size, 1))
                read = lib.TIFFReadEncodedTile if tiled else lib.TIFFReadEncodedStrip
                ok = all(read(tif, i, buf, size) >= 0 for i in range(n))
            finally:
                lib.TIFFClose(tif)
        finally:
            lib.TIFFSetErrorHandler(old_error)
            lib.TIFFSetWarningHandler(old_warning)
        return ok and not self.messages


@pytest.fixture(scope="module")
def libtiff():
    return _Libtiff()


def _held(path: str, libtiff: _Libtiff, what: str) -> bool:
    """The port reads ``path`` exactly where libtiff decodes it cleanly, and
    then to Pillow's RGB; otherwise it raises naming the file.  True where
    it reads it."""
    if libtiff.clean(path):
        assert _same_as_pillow(path, what), f"{what}: libtiff decodes it, Pillow refuses it"
        return True
    with pytest.raises(OSError, match=re.escape(path)):
        images.read_image(path)
    return False


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: os.path.basename(n)[:-4])
def test_layout_matches_pillow_and_libtiff(tmp_path, libtiff, name):
    path = _write(tmp_path, name.replace(".tif", ".png"), LAYOUTS[name])
    assert libtiff.clean(path), libtiff.messages
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n[:-4])
def test_refused_ccitt_raises_naming_the_file_and_the_reason(tmp_path, libtiff, name):
    """Each is a file libtiff reports errors on (Pillow may show it) or one
    it does not decode at all (8-bit samples)."""
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name.replace(".tif", ".jpg"), data)
    assert not libtiff.clean(path)
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


@pytest.mark.parametrize("width", [1, 9, 64, 301, 2700])
@pytest.mark.parametrize("compression", ["group3", "group4", "tiff_ccitt"])
def test_pillow_written_ccitt_matches_pillow(tmp_path, libtiff, compression, width):
    """Pillow's writer (libtiff's encoders) on a mode 1 image."""
    bits = fx._scan(2150 + width, 23, width)
    path = str(tmp_path / "a.png")
    Image.fromarray(bits.astype(bool)).save(path, format="TIFF", compression=compression)
    assert libtiff.clean(path)
    assert _same_as_pillow(path, f"{compression} {width}")


def test_pillow_written_rlew_follows_libtiff(tmp_path, libtiff):
    """Pillow's 32771 writer: libtiff's own decoder reports bad code words
    on most of its rows (its encoder aligns rows otherwise than its decoder
    reads them), and the port refuses those; the rest read as Pillow."""
    sparse = (np.random.default_rng(2165).random((20, 3000)) < 0.002) | (np.arange(3000) > 2900)
    verdicts = []
    for width in (7, 16, 32, 50, 2900, 3000):
        path = str(tmp_path / f"w{width}.png")
        bits = sparse if width == 3000 else fx._scan(2160 + width, 19, width).astype(bool)
        Image.fromarray(bits).save(path, format="TIFF", compression="tiff_raw_16")
        verdicts.append(_held(path, libtiff, f"32771 {width}"))
    assert verdicts == [False] * 5 + [True]


def _seeded_ccitt(r) -> bytes:
    """A CCITT TIFF over the writer's options together, sometimes with a few
    bits of its data flipped or its last strip or tile cut short."""
    h, w = int(r.integers(1, 30)), int(r.integers(1, 90))
    samples = (r.random((h, w)) < r.choice([0.05, 0.3, 0.7])).astype(np.uint8)
    if r.random() < 0.5:
        samples = fx._scan(int(r.integers(0, 1 << 30)), h, w)
    compression = int(r.choice([2, 3, 3, 4, 4, 32771]))
    kw = {"photometric": int(r.integers(0, 2)), "order": "<" if r.random() < 0.7 else ">",
          "fill_order": 2 if r.random() < 0.2 else 1}
    if compression == 3:
        kw.update(t4options=int(r.choice([0, 1, 4, 5])), fill_bits=bool(r.random() < 0.5),
                  rtc=bool(r.random() < 0.7), k=int(r.integers(1, 5)))
    if compression == 4:
        kw["eofb"] = bool(r.random() < 0.7)
    if r.random() < 0.3:
        kw["tile"] = (16 * int(r.integers(1, 3)), 16 * int(r.integers(1, 4)))
    elif r.random() < 0.5:
        kw["rows_per_strip"] = int(r.integers(1, h + 2))
    data = bytearray(fx.ccitt_tiff(samples, compression, **kw))
    directory = int.from_bytes(data[4:8], "little" if kw["order"] == "<" else "big")
    if r.random() < 0.25:  # bits flipped in the strips' or tiles' data, between the header and the directory
        for _ in range(int(r.integers(1, 4))):
            at = int(r.integers(8, directory))
            data[at] ^= 1 << int(r.integers(0, 8))
    elif r.random() < 0.15 and kw["order"] == "<":  # the last strip or tile cut short by its byte count
        return fx._cut_strip(bytes(data), int(r.integers(0, 6)))
    return bytes(data)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_ccitt_follows_libtiff(tmp_path, libtiff, seed):
    """60 seeded files a seed: read as Pillow where libtiff decodes them
    cleanly, refused by name where it does not."""
    r = np.random.default_rng(2170 + seed)
    read = sum(_held(_write(tmp_path, f"c{t}.tif", _seeded_ccitt(r)), libtiff, f"file {t}") for t in range(60))
    assert read > 30


@pytest.mark.slow
def test_many_seeded_ccitt_follow_libtiff(tmp_path, libtiff):
    """The seeded sweep at 40 times the size."""
    r = np.random.default_rng(2180)
    assert sum(_held(_write(tmp_path, f"c{t % 50}.tif", _seeded_ccitt(r)), libtiff, f"file {t}")
               for t in range(2400)) > 1200


@pytest.mark.parametrize("name", sorted(PALETTE_LAYOUTS), ids=lambda n: os.path.basename(n)[:-4])
def test_palette_layout_matches_pillow_and_libtiff(tmp_path, libtiff, name):
    """CCITT of a 1-bit palette (photometric 3, a ColorMap of two entries):
    every compression, T4Options, FillOrder 2, strips, tiles, MM; each
    decoded bit an index, each 16-bit entry taken to 8 bits as Pillow's
    palette takes it."""
    path = _write(tmp_path, os.path.basename(name).replace(".tif", ".bmp"), PALETTE_LAYOUTS[name])
    assert libtiff.clean(path), libtiff.messages
    assert _same_as_pillow(path, name)


def _seeded_palette_ccitt(r) -> bytes:
    """``_seeded_ccitt``'s files as 1-bit palettes of random colours, some
    ColorMaps of another length."""
    data = bytearray(_seeded_ccitt(r))
    order = "<" if data[:2] == b"II" else ">"
    end = "little" if order == "<" else "big"
    at = int.from_bytes(data[4:8], end)
    for i in range(int.from_bytes(data[at:at + 2], end)):  # photometric 0 or 1 -> 3 in place
        where = at + 2 + 12 * i
        if int.from_bytes(data[where:where + 2], end) == 262:
            data[where + 8:where + 10] = (3).to_bytes(2, end)
    return _with_colormap(bytes(data), r.integers(0, 65536, (2 if r.random() < 0.9 else 4, 3)), order)


def _with_colormap(data: bytes, colors: np.ndarray, order: str) -> bytes:
    """``data`` (a TIFF of one directory) with a ColorMap of ``colors``
    ((n, 3) 16-bit) added: its directory copied to the file's end with the
    new entry among its own."""
    end = "little" if order == "<" else "big"
    at = int.from_bytes(data[4:8], end)
    count = int.from_bytes(data[at:at + 2], end)
    entries = [data[at + 2 + 12 * i:at + 14 + 12 * i] for i in range(count)]
    values = np.asarray(colors).T.reshape(-1).astype(order + "u2").tobytes()
    out = bytearray(data)
    out += bytes(len(out) % 2)
    values_at = len(out)
    out += values
    entries.append(struct.pack(order + "HHII", 320, 3, len(values) // 2, values_at))
    entries.sort(key=lambda e: int.from_bytes(e[:2], end))
    new_at = len(out)
    out += struct.pack(order + "H", len(entries)) + b"".join(entries) + bytes(4)
    out[4:8] = new_at.to_bytes(4, end)
    return bytes(out)


@pytest.mark.parametrize("seed", range(2))
def test_seeded_palette_ccitt_follows_libtiff(tmp_path, libtiff, seed):
    """60 seeded 1-bit palette files a seed: read as Pillow where libtiff
    decodes them cleanly, refused by name where it does not."""
    r = np.random.default_rng(2190 + seed)
    read = sum(_held(_write(tmp_path, f"p{t}.tif", _seeded_palette_ccitt(r)), libtiff, f"file {t}")
               for t in range(60))
    assert read > 25


def test_card_scans_match_pillow_and_the_manifest(tmp_path):
    """The card's written 1024 px scans (``fx.card_scans``, among
    ``fx.raster_card_originals``): Pillow's RGB, and the manifest's bytes."""
    card = fx.load_manifest()["raster_card"]
    for name, data in fx.card_scans().items():
        assert fx.sha256(data) == card[f"{fx.RASTER}/card/{name}"]["sha256"], name
        path = _write(tmp_path, name, data)
        assert not isinstance(_pillow(path), Exception)
        np.testing.assert_array_equal(images.read_image(path), _pillow(path), err_msg=name)
