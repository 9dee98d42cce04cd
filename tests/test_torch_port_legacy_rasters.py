"""The port's XBM, XPM, MSP, FLI, DCX, GBR, PIXAR, FITS, McIdas and XV
thumbnail readers against Pillow and the JAX package, on the CPU.

The JAX package reads such a file under a listed extension through Pillow
alone: its prep and ``cli.project`` call ``Image.open(path).convert("RGB")``,
and its loader falls back to the same call.  So the port's
``data/images.decode_xbm``, ``decode_xpm``, ``decode_msp``, ``decode_fli``,
``decode_dcx``, ``decode_gbr``, ``decode_pixar``, ``decode_fits``,
``decode_mcidas`` and ``decode_xv`` (numpy, with XBM's hex bytes, MSP's
RLE and FLI's chunks in the native library) are held bit for bit to
Pillow 12.1.0's ``convert("RGB")`` in both of the port's lanes: every
layout of ``fx.legacy_layouts`` (12-bit gray and CCITT palette TIFFs
among them, held in ``test_torch_port_tiff.py`` and
``test_torch_port_tiff_ccitt.py`` too), the files Pillow's XBM and MSP
writers make, seeded files of each format, and Pillow's refusals with the
file and the kind named (``fx.legacy_refusals``, MPEG among them).  The
committed files under ``legacy_rasters/`` and the card's originals are
held to their writers and the manifest.  Then a folder of such originals
under listed names through the port's ``cli.prep`` against the JAX
package's ``prepare_pyramid``, the loader against the JAX loader's Pillow
fallback, and ``cli.project`` targets against the JAX CLI's arrays.
Tolerance 0.
"""

import io
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

LAYOUTS = fx.legacy_layouts()
REFUSALS = fx.legacy_refusals()
LISTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
FORMATS = ("xbm", "xpm", "msp", "fli", "dcx", "gbr", "pixar", "fits", "mcidas", "xv")


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: n.split("/", 1)[1].rsplit(".", 1)[0])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name).rsplit(".", 1)[0] + LISTED[len(name) % 5], LAYOUTS[name])
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n.rsplit(".", 1)[0])
def test_refused_file_raises_naming_the_file_and_the_kind(tmp_path, name):
    """Each refusal names the file and the kind; the manifest records
    Pillow's verdict beside it, a refusal (the TIFF kinds once sent to
    fault 7's queue item 4 are read since: old-style LZW,
    ``tiff/old-style-lzw-gray-7x9.tif`` among the layouts; old-style and
    12-bit JPEG, ``test_torch_port_tiff_lzma_zstd_ojpeg.py``)."""
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name.rsplit(".", 1)[0] + ".png", data)
    pillow = _pillow(path)
    assert isinstance(pillow, Exception), name
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


@pytest.mark.parametrize("size", [(1, 1), (7, 3), (16, 16), (33, 9)])
def test_pillow_written_xbm_and_msp_match_pillow(tmp_path, size):
    """Pillow's own XBM writer (with and without a hot spot) and MSP writer
    (version 1)."""
    w, h = size
    im = Image.fromarray((np.random.default_rng(2360 + w).integers(0, 2, (h, w)) * 255).astype(np.uint8)).convert("1")
    for fmt, kw in (("XBM", {}), ("XBM", {"hotspot": (w // 2, h // 2)}), ("MSP", {})):
        path = str(tmp_path / "a.png")
        im.save(path, fmt, **kw)
        assert _same_as_pillow(path, f"{fmt} {kw} {size}")


def _seeded_xbm(r) -> bytes:
    """An XBM over its writer's options, with stray 'x's, characters other
    than hex digits, a header Pillow's pattern may miss, truncation."""
    w, h = int(r.integers(1, 25)), int(r.integers(1, 9))
    data = fx.xbm_file(r.integers(0, 2, (h, w)), (1, 2) if r.random() < 0.3 else None,
                       str(r.choice(["im", "a_b", "x"])), r.random() < 0.5, int(r.integers(1, 15)), r.random() < 0.5)
    k = r.random()
    if k < 0.15:
        at = data.index(b"{") + int(r.integers(1, 20))
        data = data[:at] + bytes(r.choice(list(b"xg,Z 9"), int(r.integers(1, 4)))) + data[at:]
    elif k < 0.22:
        data = data.replace(b"#define", b"#  define", 1)
    elif k < 0.28:
        data = b" " * int(r.integers(0, 600)) + data
    return data[:int(r.integers(20, len(data)))] if r.random() < 0.1 else data


def _seeded_xpm(r) -> bytes:
    """An XPM over the colour count (a palette or RGB), characters a pixel,
    its colours (short or long hex, None, a name), keys not in the table,
    wrapped rows, a lost pixels comment, extra quotes, truncation."""
    w, h = int(r.integers(1, 12)), int(r.integers(1, 9))
    n = int(r.choice([1, 2, 5, 40, 256, 257, 300]))
    bpp = int(r.choice([1, 2, 2, 3])) if n < 90 else int(r.choice([2, 3]))
    colors = [b"#%06x" % int(v) for v in r.integers(0, 2 ** 24, n)]
    for _ in range(int(r.integers(0, 3))):
        colors[int(r.integers(0, n))] = bytes(r.choice([b"#123", b"#1234567", b"None", b"#-5", b"red", b"#"]))
    data = fx.xpm_file(r.integers(0, n, (h, w)), colors, bpp, pixels_comment=r.random() < 0.7,
                       per_line=int(r.integers(1, 2 * w + 1)) if r.random() < 0.3 else None)
    if r.random() < 0.1:
        data = fx._last_row_key(data)
    if r.random() < 0.1:
        data = data.replace(b'",\n"', b'", "', 1)
    return data[:int(r.integers(30, len(data)))] if r.random() < 0.1 else data


def _seeded_msp(r) -> bytes:
    """An MSP of version 1 or 2, version 2's rows encoded or random (blank,
    short, long, runs cut at the row's end), a bad checksum, truncation."""
    w, h = int(r.integers(1, 40)), int(r.integers(1, 9))
    bits = r.integers(0, 2, (h, w)) if r.random() < 0.5 else np.ones((h, w), np.int64)
    version = int(r.choice([1, 2, 2]))
    rows = None
    if version == 2 and r.random() < 0.4:
        rows = [bytes(r.integers(0, 256, int(r.choice([0, 1, 2, 3, 5, 9])), dtype=np.uint8)) for _ in range(h)]
    data = fx.msp_file(bits, version, rows)
    if r.random() < 0.05:
        data = data[:30] + bytes((data[30] ^ 1,)) + data[31:]
    return data[:int(r.integers(20, len(data)))] if r.random() < 0.1 else data


def _seeded_fli_chunk(r, w: int, h: int, px: np.ndarray) -> bytes:
    kind = int(r.choice([4, 11, 13, 15, 15, 16, 12, 12, 7, 7, 18, 99]))
    if kind in (4, 11):
        return fx.fli_palette(r.integers(0, 256, (int(r.integers(1, 257)), 3)), kind, int(r.integers(0, 4)))
    if kind == 15 and r.random() < 0.8:
        return fx.fli_brun(px)
    if kind == 16:
        return fx.fli_chunk(16, px.tobytes()[:w * h - int(r.choice([0, 0, 3]))])
    if kind == 12 and r.random() < 0.7:
        first = int(r.integers(0, h))
        return fx.fli_lc(px[first:first + int(r.integers(1, h + 1))], first)
    if kind == 7 and w % 2 == 0 and r.random() < 0.7:
        skip = int(r.integers(0, 3))
        return fx.fli_ss2(px[skip:], skip)
    return fx.fli_chunk(kind, r.integers(0, 256, int(r.integers(0, 40)), dtype=np.uint8).tobytes())


def _seeded_fli(r) -> bytes:
    """An FLI or FLC of random chunks (colour, BLACK, BRUN, COPY, LC, SS2,
    PSTAMP, unknown; valid or random bytes), frame counts, chunk sizes and
    padding off, prefix chunks, truncation."""
    w, h = int(r.integers(1, 17)), int(r.integers(1, 9))
    px = r.integers(0, 4, (h, w)).astype(np.uint8) * 60
    chunks = [_seeded_fli_chunk(r, w, h, px) for _ in range(int(r.integers(0, 4)))]
    if chunks and r.random() < 0.1:
        c = bytearray(chunks[0])
        struct.pack_into("<I", c, 0, int(r.choice([0, 3, len(c) + 5, 2 ** 31 + 1])))
        chunks[0] = bytes(c)
    frames = [fx.fli_frame(chunks, pad=int(r.choice([0, 0, 1])))]
    if r.random() < 0.05:
        frames.insert(0, fx.fli_chunk(0xF100, bytes(10)))
    if r.random() < 0.2:
        frames.append(fx.fli_frame([fx.fli_chunk(13)]))
    data = fx.fli_file(w, h, frames, int(r.choice([0xAF11, 0xAF12])), int(r.choice([1, 1, 1, 0, 3])))
    if r.random() < 0.05:
        data = data[:128] + struct.pack("<I", int(r.choice([0, 10, 1 << 20]))) + data[132:]
    return data[:int(r.integers(100, len(data)))] if r.random() < 0.1 else data


def _seeded_dcx(r) -> bytes:
    """A DCX of one to three PCX pages of random layouts (the 8-bit
    palette the whole file's last), offsets off, truncation."""
    pages = []
    for _ in range(int(r.integers(1, 4))):
        w, h = int(r.integers(1, 20)), int(r.integers(1, 8))
        bits, planes = [(1, 1), (8, 1), (8, 3), (1, 4)][int(r.integers(0, 4))]
        stride = -(-((w * bits + 7) // 8) // 2) * 2
        rows = r.integers(0, 256, (h, planes * stride), dtype=np.uint8)
        trailing = b"\x0c" + r.integers(0, 256, 768, dtype=np.uint8).tobytes() if r.random() < 0.5 else None
        pages.append(fx.pcx_file(rows, w, h, bits, planes, trailing=trailing))
    data = bytearray(fx.dcx_file(pages))
    if r.random() < 0.1:
        struct.pack_into("<I", data, 4, int(r.choice([0, 3, len(data) + 9])))
    data = bytes(data)
    return data[:int(r.integers(8, len(data)))] if r.random() < 0.1 else data


def _seeded_gbr(r) -> bytes:
    """A GIMP brush over version, depth, header sizes (its comment's, short
    of the header, past the file), truncation."""
    w, h = int(r.integers(1, 12)), int(r.integers(1, 8))
    depth = int(r.choice([1, 4]))
    px = r.integers(0, 256, (h, w, 4) if depth == 4 else (h, w), dtype=np.uint8)
    version = int(r.choice([1, 2]))
    header = int(r.choice([20, 24, 28, 40, 4000])) if r.random() < 0.2 else None
    data = fx.gbr_file(px, version, bytes(r.integers(32, 127, int(r.integers(0, 12)), dtype=np.uint8)) + b"\0",
                       header=header)
    return data[:int(r.integers(8, len(data)))] if r.random() < 0.1 else data


def _seeded_pixar(r) -> bytes:
    w, h = int(r.integers(1, 12)), int(r.integers(1, 8))
    mode = [(14, 2), (14, 2), (14, 1), (7, 2)][int(r.integers(0, 4))]
    data = fx.pixar_file(r.integers(0, 256, (h, w, 3), dtype=np.uint8), mode)
    return data[:int(r.integers(16, len(data)))] if r.random() < 0.1 else data


def _seeded_fits(r) -> bytes:
    """A FITS over BITPIX (read or not), axes, values (NaN, infinities,
    negative, past 255), comment and blank cards, GZIP_1 tiles, another
    compression, data and headers cut short."""
    w, h = int(r.integers(1, 12)), int(r.integers(1, 8))
    bitpix = int(r.choice([8, 16, 32, -32, -64]))
    values = r.normal(100, 200, (h, w))
    values[r.random((h, w)) < 0.1] = np.nan
    values[r.random((h, w)) < 0.05] = np.inf
    if bitpix > 0:
        lo, hi = {8: (0, 255), 16: (-32768, 32767), 32: (-2 ** 31, 2 ** 31 - 1)}[bitpix]
        values = np.clip(np.nan_to_num(values, posinf=hi, neginf=lo), lo, hi)
    k = r.random()
    if k < 0.2:
        data = fx.fits_gzip_file(np.clip(np.nan_to_num(values), -1e6, 1e6).astype(np.int64),
                                 int(r.choice([8, 16, 32, -32])), "'GZIP_1  '" if r.random() < 0.8 else "'RICE_1  '")
    else:
        cards = [bytes(r.choice([b"COMMENT x", b"HISTORY y / z", b""])).ljust(80) for _ in range(int(r.integers(0, 3)))]
        data = fx.fits_file(values, bitpix, cards, naxis1=r.random() < 0.1)
        if r.random() < 0.05:
            data = data.replace(b"BITPIX  =" + b" " * (20 - len(str(bitpix))) + str(bitpix).encode(),
                                b"BITPIX  =" + b" " * 18 + b"64", 1)
    return data[:int(r.integers(80, len(data)))] if r.random() < 0.15 else data


def _seeded_mcidas(r) -> bytes:
    """A McIdas area over sample size (read or not), bands, row prefixes
    (negative ones too), offsets, trailing bytes, truncation: the mapped
    and decoded reads of Pillow's raw tile."""
    w, h = int(r.integers(1, 12)), int(r.integers(1, 8))
    size = int(r.choice([1, 2, 4, 4, 3]))
    bands = int(r.integers(1, 3))
    values = r.integers(-300, 70000, (h, w))
    data = fx.mcidas_file(values % 2 ** (8 * min(size, 2)) if size < 4 else values, min(size, 4) if size != 3 else 1,
                          bands, int(r.integers(-2 * w * min(size, 4), 6)), int(r.choice([256, 256, 300])),
                          int(r.integers(0, 12)))
    if size == 3:
        data = data[:40] + struct.pack(">i", 3) + data[44:]
    return data[:int(r.integers(200, len(data)))] if r.random() < 0.15 else data


def _seeded_xv(r) -> bytes:
    w, h = int(r.integers(1, 12)), int(r.integers(1, 8))
    comments = [bytes(r.choice([b"#XVVERSION:Version 2.28", b"#", b"# a comment"]))
                for _ in range(int(r.integers(0, 4)))]
    line = [None, b"%d %d\n" % (w, h), b" %d\t%d 255 x\n" % (w, h), b"%d\n" % w, b"a b\n", b"\n"][int(r.integers(0, 6))]
    data = fx.xv_file(r.integers(0, 256, (h, w), dtype=np.uint8), comments, line)
    return data[:int(r.integers(7, len(data)))] if r.random() < 0.1 else data


SEEDED = {"xbm": _seeded_xbm, "xpm": _seeded_xpm, "msp": _seeded_msp, "fli": _seeded_fli, "dcx": _seeded_dcx,
          "gbr": _seeded_gbr, "pixar": _seeded_pixar, "fits": _seeded_fits, "mcidas": _seeded_mcidas, "xv": _seeded_xv}
#: of a seed's 60 files, at least this many Pillow decodes (and so the port)
DECODED = {"xbm": 30, "xpm": 20, "msp": 20, "fli": 5, "dcx": 25, "gbr": 30, "pixar": 20, "fits": 15, "mcidas": 15,
           "xv": 20}


@pytest.mark.parametrize("fmt", FORMATS)
def test_seeded_files_match_pillow(tmp_path, fmt):
    """60 seeded files of each format: wherever Pillow decodes one, the port
    decodes it to the same pixels; wherever Pillow refuses one, the port
    raises ``OSError`` naming it."""
    r = np.random.default_rng(2370 + FORMATS.index(fmt))
    seeded = SEEDED[fmt]
    decoded = sum(_same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", seeded(r)), f"file {t}") for t in range(60))
    assert decoded >= DECODED[fmt]


@pytest.mark.slow
@pytest.mark.parametrize("fmt", FORMATS)
def test_many_seeded_files_match_pillow(tmp_path, fmt):
    """1000 seeded files of each format."""
    r = np.random.default_rng(2390 + FORMATS.index(fmt))
    seeded = SEEDED[fmt]
    for t in range(1000):
        _same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", seeded(r)), f"file {t}")


def test_mpeg_is_refused_by_name_with_pillows_verdict(tmp_path):
    """MPEG: Pillow reads its size and cannot load it; the port names the
    format and Pillow's verdict."""
    path = _write(tmp_path, "clip.jpg", REFUSALS["mpeg.mpg"][0])
    assert "cannot load this image" in str(_pillow(path))
    with pytest.raises(OSError, match=re.escape(path) + r": MPEG files are not read by the PyTorch port \(Pillow "
                                                         r"identifies .*cannot load this image"):
        images.read_image(path)


def test_committed_fixtures_are_what_the_writers_make():
    """The committed files under ``legacy_rasters/`` are what
    ``legacy_fixtures`` writes here, and the manifest records each: Pillow's
    RGB, or for a refusal the reason and what Pillow makes of it; the card's
    written originals (never committed) and each listed one, by its listed
    name, in the JAX package's prep of every slice's originals of the
    Pillow lane (``PILLOW_LANE_PREP``)."""
    made = fx.legacy_fixtures()
    committed = fx.committed_legacy()
    assert sorted(made) == sorted(committed)
    for name, data in made.items():
        assert committed[name] == data, name
    manifest = fx.load_manifest()
    files = manifest["files"]
    assert sorted(n for n in files if n.startswith(f"{fx.LEGACY}/")) == sorted(committed)
    for name in committed:
        assert ("refused" in files[name]) == ("/refused/" in name) and files[name]["sha256"] == fx.sha256(
            committed[name]), name
    assert sorted(manifest["legacy_card"]) == sorted(fx.legacy_card_originals())
    listed = sorted(v for v in fx.LEGACY_CARD.values() if v)
    part = fx.pillow_lane_images(listed)
    assert len(part) == len(listed) and len(manifest[fx.PILLOW_LANE_PREP]) == 8
    assert all(set(part) <= set(d) for d in manifest[fx.PILLOW_LANE_PREP].values())
    assert sum(map(len, committed.values())) < 400_000


def test_committed_fixtures_decode_to_the_manifest():
    """``chip_smoke.py``'s "io fixtures" on this folder: each file decodes
    to the manifest's RGB in both lanes, each refusal raises its reason."""
    files = fx.load_manifest()["files"]
    n = 0
    for name, want in sorted(files.items()):
        if not name.startswith(f"{fx.LEGACY}/"):
            continue
        path = os.path.join(fx.FIXTURES, name)
        if "refused" in want:
            with pytest.raises(OSError, match=want["refused"]):
                images.read_image(path)
            continue
        for lane in ("native", "pillow"):
            got = images.read_image(path, lane=lane)
            assert list(got.shape[:2]) == want["shape"] and fx.sha256(got) == want["sha256_rgb"], name
        n += 1
    assert n >= 90


def test_card_originals_decode_to_the_manifest(tmp_path):
    """``chip_smoke.py``'s "io fixtures" on the card's originals of this
    slice: the written ones are the manifest's bytes, and each decodes to
    Pillow's RGB."""
    paths = fx.check_legacy_card(str(tmp_path), images.read_image)
    assert sorted(paths) == sorted(fx.LEGACY_CARD)


def _originals(root: str) -> str:
    """Small originals of each new kind under listed names: a 12-bit gray
    LZW TIFF (.bmp), a Group 4 palette TIFF (.png), an XPM of 300 colours
    (.png), an MSP version 2 (.bmp), an FLC of a BRUN frame (.jpg), a DCX
    (.png), a GBR version 2 (.png), a BITPIX -32 FITS (.jpg), a PIXAR
    (.webp), an XBM (.jpeg), a McIdas area (.png) and an XV thumbnail
    (.bmp)."""
    os.makedirs(root)
    img = fx.source_image(2380, 40, 48)
    r = np.random.default_rng(2381)
    scan = fx._scan(2382, 40, 48)
    idx = (img[..., 0] // 64 * 16 + img[..., 1] // 64 * 4 + img[..., 2] // 64).astype(np.uint8)
    data = {
        "a.bmp": fx.tiff_bytes(img[..., 0].astype(np.int64) * 3 // 2, 12, 1, compression=5, rows_per_strip=16),
        "b.png": fx.ccitt_tiff(scan, 4, 3, colormap=np.array([[0xFFFF, 0xF000, 0xE000], [0x1000, 0x2000, 0x8000]])),
        "c.png": fx.xpm_file(r.integers(0, 300, (40, 48)), [b"#%06x" % v for v in r.integers(0, 2 ** 24, 300)], 2),
        "d.bmp": fx.msp_file(scan, 2),
        "e.jpg": fx.fli_file(48, 40, [fx.fli_frame([fx.fli_palette(r.integers(0, 256, (256, 3))), fx.fli_brun(idx)])]),
        "f.png": fx.dcx_file([fx.pcx_file(np.packbits(scan.astype(np.uint8), axis=1), 48, 40, 1, 1)]),
        "g.png": fx.gbr_file(np.concatenate([img, img[..., :1]], 2)),
        "h.jpg": fx.fits_file(img[..., 1].astype(np.float32) * 1.3 - 20.5, -32),
        "i.webp": fx.pixar_file(img),
        "j.jpeg": fx.xbm_file(scan),
        "k.png": fx.mcidas_file(img[..., 2].astype(np.int64) * 2, 2, prefix=2),
        "l.bmp": fx.xv_file(idx),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_these_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets on a folder of this slice's originals under listed
    names."""
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
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) and len(names) == 12
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
            n += 1
    assert n == 48


def test_loader_reads_these_formats_as_jax_pillow_fallback(tmp_path):
    """A prepared set of FITS, FLC, XPM and MSP files under listed names: the
    port's loader reads each as the JAX package's ``StageDataset`` does
    through its Pillow fallback, on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    r = np.random.default_rng(2383)
    for i in range(8):
        img = r.integers(0, 256, (16, 16, 3)).astype(np.uint8)
        data = (fx.fits_file(img[..., 0].astype(np.float32) * 1.5 - 30, -32) if i % 4 == 0 else
                fx.fli_file(16, 16, [fx.fli_frame([fx.fli_palette(r.integers(0, 256, (256, 3))), fx.fli_brun(
                    img[..., 1])])]) if i % 4 == 1 else
                fx.xpm_file(img[..., 2] % 7, [b"#%06x" % v for v in r.integers(0, 2 ** 24, 7)], 1) if i % 4 == 2 else
                fx.msp_file(img[..., 0] & 1, 2))
        (folder / f"image-{i}.{('png', 'jpg', 'webp', 'bmp')[i % 4]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2, 7, 6])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)


def test_project_targets_given_in_these_formats_match_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on ``face.fits``, ``face.flc``,
    ``face.xpm``, ``face.gbr`` and ``face.tif`` (12-bit gray) at the
    stage's size: the arrays the JAX CLI builds
    (``Image.open(path).convert("RGB")``)."""
    from byogan_tpu_torch.cli.project import load_target

    img = fx.source_image(2384, 32, 32)
    r = np.random.default_rng(2385)
    paths = [_write(tmp_path, "face.fits", fx.fits_file(img[..., 0].astype(np.float32) * 1.2 - 9, -32)),
             _write(tmp_path, "face.flc", fx.fli_file(32, 32, [fx.fli_frame([fx.fli_palette(r.integers(
                 0, 256, (256, 3))), fx.fli_brun(img[..., 1])])])),
             _write(tmp_path, "face.xpm", fx.xpm_file(img[..., 2] // 16, [b"#%06x" % v for v in r.integers(
                 0, 2 ** 24, 16)], 1)),
             _write(tmp_path, "face.gbr", fx.gbr_file(np.concatenate([img, img[..., :1]], 2))),
             _write(tmp_path, "face.tif", fx.tiff_bytes(img[..., 0].astype(np.int64) * 2, 12, 1, compression=8))]
    for path in paths:
        with Image.open(path) as im:  # byogan_tpu/cli/project.py's target
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=path)
        np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=path)


def test_gbr_gate_keeps_a_narrow_qoi_a_qoi():
    """GBR's ``_accept`` takes a QOI of width 1 or 2 (its version field);
    ``_gbr``'s ``_open`` checks still send it on to QOI, and a brush they
    take reads as a brush."""
    for w in (1, 2):
        data = fx.qoi_encode(fx.smooth_scene(2386 + w, 5, w, cell=2, step=4))
        assert images.sniff(data[:images.HEAD]) == "QOI"
    brush = fx.gbr_file(np.arange(12, dtype=np.uint8).reshape(3, 4))
    assert images.sniff(brush[:images.HEAD]) == "GBR"
    with Image.open(io.BytesIO(brush)) as im:
        np.testing.assert_array_equal(images.decode_gbr(brush), np.asarray(im.convert("RGB")))
