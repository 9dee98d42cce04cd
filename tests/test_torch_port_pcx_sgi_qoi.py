"""The port's PCX, SGI and QOI readers against Pillow and the JAX package, on the CPU.

The JAX package reads a PCX, SGI or QOI file under a listed extension
through Pillow alone: its prep and ``cli.project`` call
``Image.open(path).convert("RGB")``, and its loader falls back to the same
call.  So the port's ``data/images.decode_pcx``, ``decode_sgi`` and
``decode_qoi`` (numpy, with the PCX RLE, SGI RLE and QOI loops in the
native library) are held bit for bit to Pillow 12.1.0's
``convert("RGB")``: PCX of 1 bit in 1, 2 and 4 planes and 8 bits in 1
(gray, palette, the gray ramp) and 3 planes, strides Pillow pads and
does not, a bad bbox that passes the file on to Targa; SGI of the eight
layouts raw and RLE, rows read for others, rows cut short; QOI of every
op, INDEX on empty slots, runs the index does not take in, widths that
GBR's ``_accept`` takes; Pillow's writers; 240 seeded files of each
format; Pillow's refusals with the file and the reason named.  The
committed files under ``psd_pcx_sgi_qoi/`` and the card's originals are
held to their writers and the manifest.  Then a folder of PCX, SGI, QOI
and JPEG-in-planes TIFF originals under listed names through the port's
``cli.prep`` against the JAX package's ``prepare_pyramid``, the loader
against the JAX loader's Pillow fallback, and ``cli.project`` targets
against the JAX CLI's arrays.  Tolerance 0.
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

LAYOUTS = {k: v for k, v in fx.raster_layouts().items() if k.split("/")[1] in ("pcx", "sgi", "qoi")}
REFUSALS = {k: v for k, v in fx.raster_refusals().items() if k.startswith(("pcx", "sgi", "qoi"))}
LISTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: n.split("/", 1)[1][:-4])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name)[:-4] + ".bmp", LAYOUTS[name])  # under a listed name
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n[:-4])
def test_refused_file_raises_naming_the_file_and_the_reason(tmp_path, name):
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name[:-4] + ".webp", data)
    assert isinstance(_pillow(path), Exception)  # Pillow refuses it too
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


@pytest.mark.parametrize("fmt,mode", [("PCX", m) for m in ("1", "L", "P", "RGB")]
                         + [("SGI", f"{m} {b}") for m in ("L", "RGB", "RGBA") for b in (1, 2)]
                         + [("QOI", m) for m in ("RGB", "RGBA")])
def test_pillow_written_file_matches_pillow(tmp_path, fmt, mode):
    """Pillow's own writers (SGI raw at 8 and 16 bits)."""
    img = fx.smooth_scene(2050, 29, 37, cell=8, step=4)
    im = Image.fromarray(np.concatenate([img, img[..., :1]], 2)).convert(mode.split()[0])
    path = str(tmp_path / "a.png")
    im.save(path, fmt, **({"bpc": int(mode.split()[1])} if fmt == "SGI" else {}))
    assert _same_as_pillow(path, f"{fmt} {mode}")


def _seeded_pcx(r) -> bytes:
    """A PCX over the reader's parameters together: bits and planes (some
    Pillow does not read), version, size, origin, the header's stride,
    palettes (header, trailing, the gray ramp, a wrong marker), RLE within
    rows or across them or random packets, padding, a bad bbox,
    truncation."""
    bits, planes = [(1, 1), (1, 2), (1, 4), (8, 1), (8, 1), (8, 3), (8, 3), (1, 2), (1, 4), (8, 3), (4, 1), (8, 4)][
        int(r.integers(0, 12))]
    version = int(r.choice([5, 5, 5, 5, 5, 0, 2, 3]))
    h, w = int(r.integers(1, 12)), int(r.integers(1, 20))
    base = (w * bits + 7) // 8
    stride = int(r.choice([base, base + base % 2, base + 1, max(1, base - 1)]))
    rows = r.integers(0, 256, (h, planes * stride)).astype(np.uint8)
    if r.random() < 0.5:
        rows = rows // 64 * 64
    trailing = None
    if bits == 8 and planes == 1 and r.random() < 0.6:
        ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        table = ramp if r.random() < 0.4 else r.integers(0, 256, (256, 3)).astype(np.uint8)
        trailing = bytes([12 if r.random() < 0.85 else 11]) + table.tobytes()
    body = None
    if r.random() < 0.3:
        body = bytearray()
        while len(body) < rows.size * 1.2:
            body += (bytes([0xC0 | int(r.integers(0, 64)), int(r.integers(0, 256))]) if r.random() < 0.4
                     else bytes([int(r.integers(0, 0xC0))]))
        body = bytes(body)
    pad = bytes(int(r.integers(0, 900))) if r.random() < 0.3 or (bits == 8 and planes == 1) else b""  # 769-byte look
    data = fx.pcx_file(rows, w, h, bits, planes, version, stride, r.integers(0, 256, 48, dtype=np.uint8).tobytes(),
                       pad + (trailing or b""), (int(r.integers(0, 5)), int(r.integers(0, 5))), body,
                       cross_rows=r.random() < 0.15)
    if r.random() < 0.05:
        data = data[:4] + struct.pack("<HH", 5, 5) + data[8:]
    return data[:int(r.integers(10, len(data)))] if r.random() < 0.08 else data


def _seeded_sgi(r) -> bytes:
    """An SGI over the reader's parameters together: bytes a sample (3:
    none Pillow reads), channels, dimension, size, raw, RLE or another
    storage, rows without their terminator, with bytes after it or with a
    copy that passes the row, lengths cut short, offsets shared,
    truncation."""
    bpc = int(r.choice([1, 1, 2, 3]))
    z = int(r.choice([1, 3, 4, 2]))
    dimension = int(r.choice([3, 3, 2, 1])) if z == 1 else int(r.choice([3, 3, 3, 2]))
    h, w = int(r.integers(1, 10)), int(r.integers(1, 14))
    s = r.integers(0, 256 ** min(bpc, 2), (h, w, z))
    if r.random() < 0.5:
        s = s // 37 * 37
    storage = int(r.choice([0, 1, 1, 1, 2]))
    if bpc == 3:
        data = bytearray(fx.sgi_file(s % 256, 1, storage, dimension))
        data[3] = 3
        return bytes(data)
    kw = {}
    if storage == 1 and r.random() < 0.5:
        rows = {}
        for c in range(z):
            for y in range(h):
                row = fx.sgi_rle_row(s[::-1][y, :, c], bpc)
                k = r.random()
                if k < 0.05:
                    row = row[:-bpc]  # no terminator
                elif k < 0.1:
                    row += r.integers(0, 256, 3, dtype=np.uint8).tobytes()
                elif k < 0.13:
                    row = bytes([0x85] if bpc == 1 else [0, 0x85]) + row  # a copy that may pass the row
                rows[y, c] = row
        kw["rows"] = rows
    data = fx.sgi_file(s, bpc, storage, dimension, **kw)
    if storage == 1 and r.random() < 0.2:
        n = h * z
        tab = list(struct.unpack(f">{2 * n}I", data[512:512 + 8 * n]))
        i = int(r.integers(0, n))
        if r.random() < 0.5:
            tab[n + i] = int(r.integers(0, 4))
        else:
            tab[i] = tab[int(r.integers(0, n))]
        data = data[:512] + struct.pack(f">{2 * n}I", *tab) + data[512 + 8 * n:]
    return data[:int(r.integers(10, len(data)))] if r.random() < 0.08 else data


def _seeded_qoi(r) -> bytes:
    """A QOI of random ops (each op, INDEX on slots empty or filled, runs),
    channels 3, 4 and others, sizes GBR's ``_accept`` takes, too few ops,
    truncation."""
    h, w = int(r.integers(1, 10)), int(r.integers(1, 14))
    ops = bytearray()
    for _ in range(int(h * w * r.uniform(0.3, 1.3))):
        k = r.random()
        if k < 0.15:
            ops += b"\xfe" + r.integers(0, 256, 3, dtype=np.uint8).tobytes()
        elif k < 0.25:
            ops += b"\xff" + r.integers(0, 256, 4, dtype=np.uint8).tobytes()
        elif k < 0.45:
            ops.append(int(r.integers(0, 64)))
        elif k < 0.65:
            ops.append(0x40 | int(r.integers(0, 64)))
        elif k < 0.8:
            ops += bytes([0x80 | int(r.integers(0, 64)), int(r.integers(0, 256))])
        else:
            ops.append(0xC0 | int(r.integers(0, 62)))
    data = fx.qoi_file(w, h, int(r.choice([3, 4, 4, 0, 5])), bytes(ops))
    return data[:int(r.integers(4, len(data)))] if r.random() < 0.08 else data


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fmt", ["pcx", "sgi", "qoi"])
def test_seeded_files_match_pillow(tmp_path, fmt, seed):
    """80 seeded files a seed: wherever Pillow decodes one, the port
    decodes it to the same pixels; wherever Pillow refuses one, the port
    raises ``OSError`` naming it."""
    r = np.random.default_rng(2060 + 10 * ("pcx", "sgi", "qoi").index(fmt) + seed)
    seeded = {"pcx": _seeded_pcx, "sgi": _seeded_sgi, "qoi": _seeded_qoi}[fmt]
    decoded = sum(_same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", seeded(r)), f"file {t}")
                  for t in range(80))
    assert decoded > {"pcx": 15, "sgi": 10, "qoi": 40}[fmt]  # the rest Pillow refuses, and so does the port


def test_qoi_of_width_one_or_two_is_not_a_gimp_brush(tmp_path):
    """GBR's ``_accept`` takes a QOI of width 1 or 2 (its version field);
    its ``_open`` then refuses it, and Pillow reads the file as QOI, as the
    port does; a file GBR's ``_open`` takes is named as GBR."""
    for w in (1, 2):
        data = fx.qoi_encode(fx.smooth_scene(2070 + w, 5, w, cell=2, step=4))
        assert images.candidates(data[:images.HEAD])[0] == "QOI" and _same_as_pillow(
            _write(tmp_path, f"q{w}.png", data), f"width {w}")
    brush = struct.pack(">IIIII", 28, 2, 3, 2, 1) + b"GIMP" + struct.pack(">I", 25) + bytes(6)
    path = _write(tmp_path, "brush.jpg", brush)
    assert images.sniff(brush[:images.HEAD]) == "GBR" and not isinstance(_pillow(path), Exception)
    with pytest.raises(OSError, match=re.escape(path) + ": GBR files are not read by the PyTorch port"):
        images.read_image(path)


def test_committed_fixtures_are_what_the_writers_make():
    """The committed files under ``psd_pcx_sgi_qoi/`` are what
    ``raster_fixtures`` writes here, and the manifest records each:
    Pillow's RGB, or for a refusal the reason and what Pillow makes of it;
    the card's written originals (never committed) and the JAX package's
    prep of every card original by its listed name."""
    made = fx.raster_fixtures()
    committed = fx.committed_raster()
    assert sorted(made) == sorted(committed)
    for name, data in made.items():
        assert committed[name] == data, name
    manifest = fx.load_manifest()
    files = manifest["files"]
    assert sorted(n for n in files if n.startswith(f"{fx.RASTER}/")) == sorted(committed)
    for name in committed:
        assert ("refused" in files[name]) == ("/refused/" in name) and files[name]["sha256"] == fx.sha256(
            committed[name]), name
    assert sorted(manifest["raster_card"]) == sorted(fx.raster_card_originals())
    listed = sorted(v for v in fx.RASTER_CARD.values() if v)
    assert sorted(n for d in manifest["raster_prep"].values() for n in d) == sorted(
        f"image-{i}.png" for i in range(len(listed)) for _ in range(8))
    assert sum(map(len, committed.values())) < 400_000


def test_card_originals_decode_to_the_manifest(tmp_path):
    """``chip_smoke.py``'s "io fixtures" on the card's originals of this
    slice: the written ones are the manifest's bytes, and each (the
    committed TIFFs too) decodes to Pillow's RGB."""
    paths = fx.check_raster_card(str(tmp_path), images.read_image)
    assert sorted(paths) == sorted(fx.RASTER_CARD)


def _originals(root: str) -> str:
    """Small originals under listed names: a PCX of 8 bits in 3 planes
    (.jpg), a 4-plane 1-bit PCX (.png), an RLE SGI (.bmp), a 16-bit raw SGI
    with alpha (.jpeg), a QOI from the numpy writer (.webp) and from
    Pillow's (.png), a YCbCr 1 x 1 JPEG TIFF in separate planes (.jpg) and
    an RGB one in tiles (.png)."""
    os.makedirs(root)
    img = fx.source_image(2080, 37, 45)
    r = np.random.default_rng(2081)
    rows = np.concatenate([np.pad(img[..., k], ((0, 0), (0, 1))) for k in range(3)], 1)
    idx = r.integers(0, 16, (37, 45))
    bit_rows = np.concatenate([fx._pack(((idx >> j) & 1)[..., None], 1) for j in range(4)], 1)
    ycc = np.asarray(Image.fromarray(img).convert("YCbCr"))
    data = {
        "a.jpg": fx.pcx_file(rows, 45, 37, 8, 3),
        "b.png": fx.pcx_file(bit_rows, 45, 37, 1, 4, stride=6, palette16=r.integers(0, 256, 48, dtype=np.uint8).tobytes()),
        "c.bmp": fx.sgi_file(img, 1, 1),
        "d.jpeg": fx.sgi_file(np.concatenate([img, img[..., :1]], 2).astype(np.int64) * 257, 2, 0),
        "e.webp": fx.qoi_encode(img),
        "f.png": fx.pil_bytes(Image.fromarray(img), "QOI"),
        "g.jpg": fx.jpeg_tiff(ycc, 6, 85, (1, 1), rows_per_strip=16, planar=2),
        "h.png": fx.jpeg_tiff(img, 2, 70, tile=(16, 32), planar=2),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_pcx_sgi_qoi_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets on a folder of PCX, SGI, QOI and JPEG-in-planes TIFF
    originals under listed names."""
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
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) and len(names) == 8
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
            n += 1
    assert n == 32


def test_loader_reads_pcx_sgi_qoi_as_jax_pillow_fallback(tmp_path):
    """A prepared set of PCX, SGI and QOI files under listed names: the
    port's loader reads each as the JAX package's ``StageDataset`` does
    through its Pillow fallback, on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    r = np.random.default_rng(2082)
    for i in range(6):
        img = r.integers(0, 256, (16, 16, 3)).astype(np.uint8)
        data = (fx.pcx_file(np.concatenate([img[..., k] for k in range(3)], 1), 16, 16, 8, 3) if i % 3 == 0 else
                fx.sgi_file(img, 1, i % 2) if i % 3 == 1 else fx.qoi_encode(img))
        (folder / f"image-{i}.{('png', 'jpg', 'webp')[i % 3]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)


def test_project_targets_given_as_pcx_sgi_qoi_match_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on ``face.pcx``, ``face.sgi`` and
    ``face.qoi`` at the stage's size: the arrays the JAX CLI builds
    (``Image.open(path).convert("RGB")``)."""
    from byogan_tpu_torch.cli.project import load_target

    img = fx.source_image(2083, 32, 32)
    paths = [_write(tmp_path, "face.pcx", fx.pcx_file(np.concatenate([img[..., k] for k in range(3)], 1), 32, 32, 8,
                                                       3)),
             _write(tmp_path, "face.sgi", fx.sgi_file(img, 1, 1)),
             _write(tmp_path, "face.qoi", fx.qoi_encode(img))]
    for path in paths:
        with Image.open(path) as im:  # byogan_tpu/cli/project.py's target
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=path)
        np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=path)
