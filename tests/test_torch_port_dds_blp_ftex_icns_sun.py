"""The port's DDS, BLP, FTEX, ICNS and Sun raster readers against Pillow
and the JAX package, on the CPU.

The JAX package reads such a file under a listed extension through Pillow
alone: its prep and ``cli.project`` call ``Image.open(path).convert("RGB")``,
and its loader falls back to the same call.  So the port's
``data/images.decode_dds``, ``decode_blp``, ``decode_ftex``, ``decode_icns``
and ``decode_sun`` (numpy, with the BCn blocks, the ICNS and Sun RLE loops
and the JPEG decode in the native library) and 32-bit integer gray TIFF
(``native/tiff.cpp``) are held bit for bit to Pillow 12.1.0's
``convert("RGB")`` in both of the port's lanes: every layout of
``fx.dbfis_layouts`` (every BCn kind and BC6H/BC7 mode, bit masks,
luminance and palette DDS; BLP1 JPEG, CMYK and YCCK among them, and
palette, BLP2 palette and DXT; FTEX; ICNS of RLE, raw and PNG elements;
Sun raster of every depth, type and colour map; 32-bit gray TIFF), the
files Pillow's DDS, BLP and ICNS writers make, seeded files of each format
and Pillow's refusals with the file and the kind named.  The committed
files under ``dds_blp_ftex_icns_sun/`` and the card's originals are held
to their writers and the manifest.  Then a folder of such originals under
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

LAYOUTS = fx.dbfis_layouts()
REFUSALS = fx.dbfis_refusals()
LISTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
FORMATS = ("dds", "blp", "ftex", "icns", "sun")


def _seeded(fmt: str):
    return {"dds": _seeded_dds, "blp": _seeded_blp, "ftex": _seeded_ftex, "icns": _seeded_icns, "sun": _seeded_sun}[fmt]


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: n.split("/", 1)[1].rsplit(".", 1)[0])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name).rsplit(".", 1)[0] + LISTED[len(name) % 5], LAYOUTS[name])
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n.rsplit(".", 1)[0])
def test_refused_file_raises_naming_the_file_and_the_kind(tmp_path, name):
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name.rsplit(".", 1)[0] + ".png", data)
    assert isinstance(_pillow(path), Exception)  # Pillow refuses it too
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path)


@pytest.mark.parametrize("mode,pixel_format", [("RGB", None), ("RGBA", None), ("L", None), ("LA", None),
                                               ("RGBA", "DXT1"), ("RGBA", "DXT3"), ("RGBA", "DXT5"), ("RGBA", "BC2"),
                                               ("RGBA", "BC3"), ("RGB", "BC5"), ("RGB", "DXT1")])
def test_pillow_written_dds_matches_pillow(tmp_path, mode, pixel_format):
    """Pillow's own DDS writer: raw RGB, RGBA, L and LA (bit masks and
    luminance), and its BC1 (DXT1), BC2, BC3 and BC5 encoders."""
    img = fx.smooth_scene(2400, 37, 29, cell=8, step=4)
    im = Image.fromarray(np.concatenate([img, img[..., :1]], 2)).convert(mode)
    path = str(tmp_path / "a.png")
    im.save(path, "DDS", **({"pixel_format": pixel_format} if pixel_format else {}))
    assert _same_as_pillow(path, f"DDS {mode} {pixel_format}")


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("palette", ["RGB", "RGBA"])
def test_pillow_written_blp_matches_pillow(tmp_path, version, palette):
    """Pillow's own BLP writer: a palette image (with and without the
    palette's alpha), as BLP1 and BLP2."""
    img = fx.smooth_scene(2401, 23, 31, cell=8, step=16)
    im = Image.fromarray(img).quantize(60)
    if palette == "RGBA":
        rgb = np.asarray(im.getpalette()).reshape(-1, 3)
        im.putpalette(np.concatenate([rgb, np.full((len(rgb), 1), 200)], 1).astype(np.uint8).tobytes(), "RGBA")
    path = str(tmp_path / "a.jpg")
    im.save(path, "BLP", blp_version=version)
    assert _same_as_pillow(path, f"{version} {palette}")


def test_pillow_written_icns_matches_pillow(tmp_path):
    """Pillow's own ICNS writer: every size as a PNG element, the largest
    1024 px (given, and resized by Pillow)."""
    img = fx.smooth_scene(2402, 64, 64, cell=8, step=4)
    path = str(tmp_path / "a.png")
    Image.fromarray(img).save(path, "ICNS")
    assert _same_as_pillow(path, "ICNS resized")
    big = Image.fromarray(fx.smooth_scene(2403, 1024, 1024, cell=64, step=4))
    Image.fromarray(img).save(path, "ICNS", append_images=[big])
    assert _same_as_pillow(path, "ICNS given 1024 px")


def _seeded_dds(r) -> bytes:
    """A DDS over the reader's parameters together: bit masks of any byte
    count (masks contiguous or not), luminance of any depth, palette,
    FourCCs and DXGI formats Pillow reads or not, sizes that cut edge
    blocks, a wrong header size, truncation."""
    w, h = int(r.integers(1, 21)), int(r.integers(1, 21))
    k = r.random()
    if k < 0.25:
        bitcount = int(r.choice([8, 16, 24, 32, 12, 40]))
        masks = tuple(int(r.integers(0, 2 ** 32)) & int(r.choice([0xFF, 0xFF00, 0xFF0000, 0xFF000000, 0xF0F0,
                                                                     0xFFFFFFFF, 0x3FF])) for _ in range(4))
        data = fx.dds_file(w, h, r.integers(0, 256, w * h * bitcount // 8, dtype=np.uint8).tobytes(),
                           pfflags=0x40 | int(r.integers(0, 2)), bitcount=bitcount, masks=masks)
    elif k < 0.35:
        bitcount = int(r.choice([8, 16, 16, 32]))
        data = fx.dds_file(w, h, r.integers(0, 256, w * h * 2, dtype=np.uint8).tobytes(),
                           pfflags=0x20000 | int(r.integers(0, 2)), bitcount=bitcount)
    elif k < 0.42:
        data = fx.dds_file(w, h, r.integers(0, 256, w * h, dtype=np.uint8).tobytes(), pfflags=0x20, bitcount=8,
                           palette=r.integers(0, 256, 1024, dtype=np.uint8).tobytes())
    else:
        n = (w + 3) // 4 * ((h + 3) // 4)
        payload = r.integers(0, 256, 16 * n, dtype=np.uint8).tobytes()
        if r.random() < 0.5:
            data = fx.dds_file(w, h, payload, bytes(r.choice([b"DXT1", b"DXT3", b"DXT5", b"ATI1", b"BC4U", b"ATI2",
                                                                b"BC5U", b"BC5S", b"DXT2", b"BC4S"])))
        else:
            dxgi = int(r.choice(list(fx.DXGI.values()) + [0, 100]))
            data = fx.dds_file(w, h, payload if dxgi not in (27, 28, 29) else bytes(4 * w * h), dxgi=dxgi)
    if r.random() < 0.03:
        data = data[:4] + struct.pack("<I", 120) + data[8:]
    return data[:int(r.integers(4, len(data)))] if r.random() < 0.1 else data


def _seeded_blp(r) -> bytes:
    """A BLP over its parameters together: version, compression, encoding,
    alpha depth and encoding, sizes that cut blocks, mips shorter or
    longer than the image, offsets elsewhere, JPEG streams, truncation."""
    version = int(r.choice([1, 2]))
    w, h = int(r.integers(1, 19)), int(r.integers(1, 19))
    alpha = int(r.choice([0, 1, 4, 8]))
    if version == 1:
        if r.random() < 0.3:
            img = r.integers(0, 256, (int(r.integers(1, 20)), int(r.integers(1, 20)), 3)).astype(np.uint8)
            header, mip = fx.jpeg_split(fx.port_jpeg(img, int(r.integers(30, 95))))
            return fx.blp_file(1, w, h, mip, compression=0, jpeg_header=header, alpha=alpha)
        data = fx.blp_file(1, w, h, r.integers(0, 256, int(w * h * r.uniform(0.8, 1.5)), dtype=np.uint8).tobytes(),
                           compression=int(r.choice([1, 1, 1, 2])), encoding=int(r.choice([4, 5, 5, 3])), alpha=alpha)
    else:
        encoding = int(r.choice([1, 2, 2, 2, 3]))
        alpha_encoding = int(r.choice([0, 1, 7, 7, 2]))
        size = 8 if alpha_encoding == 0 else 16
        n = (w + 3) // 4 * ((h + 3) // 4)
        mip = r.integers(0, 256, n * size if encoding == 2 else int(w * h * r.uniform(0.8, 1.5)), dtype=np.uint8)
        data = fx.blp_file(2, w, h, mip.tobytes(), compression=int(r.choice([1, 1, 1, 0])), encoding=encoding,
                           alpha=alpha, alpha_encoding=alpha_encoding)
    return data[:int(r.integers(8, len(data)))] if r.random() < 0.1 else data


def _seeded_ftex(r) -> bytes:
    w, h = int(r.integers(1, 19)), int(r.integers(1, 19))
    fmt = int(r.choice([0, 0, 1, 1, 2]))
    n = (w + 3) // 4 * ((h + 3) // 4) * 8 if fmt == 0 else 3 * w * h
    data = fx.ftex_file(w, h, fmt, r.integers(0, 256, n + int(r.integers(0, 9)), dtype=np.uint8).tobytes(),
                        formats=int(r.choice([1, 1, 1, 2])), size=int(r.choice([-1, -1, -2])) if r.random() < 0.2
                        else None)
    return data[:int(r.integers(4, len(data)))] if r.random() < 0.1 else data


def _seeded_icns(r) -> bytes:
    """An ICNS of random elements of the listed types: RLE (sometimes
    broken), raw, PNG (of a listed size or not), masks, elements of other
    types, a header size short of the file or past it."""
    elements = []
    for _ in range(int(r.integers(1, 5))):
        code = bytes(r.choice([b"is32", b"il32", b"ih32", b"it32", b"s8mk", b"l8mk", b"icp4", b"ic07", b"ic11",
                               b"TOC "]))
        side = {b"is32": 16, b"il32": 32, b"ih32": 48, b"it32": 128, b"s8mk": 16, b"l8mk": 32}.get(code, 16)
        img = (r.integers(0, 4, (side, side, 3)) * 80).astype(np.uint8)
        if code.endswith(b"32"):
            data = fx.icns_rgb(img, raw=r.random() < 0.2, it32=code == b"it32")
            if r.random() < 0.15:
                data = data[:int(r.integers(1, len(data)))] + r.integers(0, 256, 4, dtype=np.uint8).tobytes()
        elif code.endswith(b"mk"):
            data = r.integers(0, 256, side * side - int(r.choice([0, 0, 0, 7])), dtype=np.uint8).tobytes()
        elif code.startswith(b"ic"):
            s = int(r.choice([16, 32, 12]))
            data = fx.png_bytes(img[:s, :s], 8, 2)
        else:
            data = bytes(8)
        elements.append((code, data))
    data = fx.icns_file(elements)
    if r.random() < 0.1:
        data = data[:4] + struct.pack(">I", int(r.integers(8, len(data) + 40))) + data[8:]
    return data


def _seeded_sun(r) -> bytes:
    """A Sun raster over its parameters together: depth, type, colour map
    (its length and type), rows RLE-coded within or across rows or of
    random packets, truncation."""
    depth = int(r.choice([1, 4, 8, 8, 24, 32, 16]))
    ftype = int(r.choice([0, 1, 2, 2, 3, 4, 5, 6]))
    w, h = int(r.integers(1, 20)), int(r.integers(1, 10))
    bits = {1: 1, 4: 4, 8: 8}.get(depth, 8)
    px = r.integers(0, 1 << bits, (h, w * (depth // 8 if depth >= 24 else 1)))
    if r.random() < 0.5:
        px = px // 3 * 3
    rows = fx.sun_rows(px, bits if depth < 24 else 8, pad=ftype != 2)
    if ftype == 2:
        body = (fx.sun_rle(rows, cross_rows=r.random() < 0.5) if r.random() < 0.7 else
                bytes(r.choice([0x80, 0x80, 7, 200], int(rows.size * 1.2)).astype(np.uint8)))
    else:
        body = rows.tobytes()
    palette = b""
    if r.random() < 0.4:
        palette = r.integers(0, 256, int(r.choice([30, 48, 300, 768, 1100])), dtype=np.uint8).tobytes()
    data = fx.sun_file(w, h, depth, ftype, body, palette, ptype=int(r.choice([1, 1, 1, 2])))
    return data[:int(r.integers(10, len(data)))] if r.random() < 0.08 else data


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("fmt", FORMATS)
def test_seeded_files_match_pillow(tmp_path, fmt, seed):
    """60 seeded files a seed: wherever Pillow decodes one, the port
    decodes it to the same pixels; wherever Pillow refuses one, the port
    raises ``OSError`` naming it."""
    r = np.random.default_rng(2410 + 10 * FORMATS.index(fmt) + seed)
    seeded = _seeded(fmt)
    decoded = sum(_same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", seeded(r)), f"file {t}") for t in range(60))
    assert decoded > {"dds": 25, "blp": 15, "ftex": 20, "icns": 10, "sun": 15}[fmt]


@pytest.mark.slow
@pytest.mark.parametrize("fmt", FORMATS)
def test_many_seeded_files_match_pillow(tmp_path, fmt):
    """1000 seeded files of each format."""
    r = np.random.default_rng(2450 + FORMATS.index(fmt))
    seeded = _seeded(fmt)
    for t in range(1000):
        _same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", seeded(r)), f"file {t}")


@pytest.mark.parametrize("fmt,data", [
    ("MPEG", b"\0\0\1\xb3\x0a\x00\x78\x13" + bytes(60)),
])
def test_formats_still_in_the_queue_are_refused_by_name(tmp_path, fmt, data):
    """MPEG, which Pillow identifies and cannot load, refused by name (the
    queue's XBM, XPM, MSP and FITS are read since, ``test_torch_port_legacy_rasters.py``,
    JPEG 2000, ``test_torch_port_jpeg2000.py``, and AVIF, ``test_torch_port_avif.py``,
    which holds the AVIF case this test had, an ftyp box and no meta, to
    Pillow's verdict)."""
    path = _write(tmp_path, "q.png", data)
    with pytest.raises(OSError, match=re.escape(path) + f": {fmt} files are not read by the PyTorch port"):
        images.read_image(path)


def test_committed_fixtures_are_what_the_writers_make():
    """The committed files under ``dds_blp_ftex_icns_sun/`` are what
    ``dbfis_fixtures`` writes here, and the manifest records each: Pillow's
    RGB, or for a refusal the reason and what Pillow makes of it; the
    card's written originals (never committed) and each, by its listed
    name, in the JAX package's prep of every slice's originals of the
    Pillow lane (``PILLOW_LANE_PREP``)."""
    made = fx.dbfis_fixtures()
    committed = fx.committed_dbfis()
    assert sorted(made) == sorted(committed)
    for name, data in made.items():
        assert committed[name] == data, name
    manifest = fx.load_manifest()
    files = manifest["files"]
    assert sorted(n for n in files if n.startswith(f"{fx.DBFIS}/")) == sorted(committed)
    for name in committed:
        assert ("refused" in files[name]) == ("/refused/" in name) and files[name]["sha256"] == fx.sha256(
            committed[name]), name
    assert sorted(manifest["dbfis_card"]) == sorted(fx.dbfis_card_originals())
    listed = sorted(v for v in fx.DBFIS_CARD.values() if v)
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
        if not name.startswith(f"{fx.DBFIS}/"):
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
    assert n >= 150


def test_card_originals_decode_to_the_manifest(tmp_path):
    """``chip_smoke.py``'s "io fixtures" on the card's originals of this
    slice: the written ones are the manifest's bytes, and each decodes to
    Pillow's RGB."""
    paths = fx.check_dbfis_card(str(tmp_path), images.read_image)
    assert sorted(paths) == sorted(fx.DBFIS_CARD)


def _originals(root: str) -> str:
    """Small originals under listed names: a BC7 DDS (.png), a BC1 DDS
    (.jpg), a BLP2 DXT5 (.bmp), a BLP1 JPEG (.webp), a BC1 FTEX (.jpeg),
    an ICNS of a PNG element (.png), an RLE Sun raster with a colour map
    (.jpg) and a 32-bit gray TIFF (.bmp)."""
    os.makedirs(root)
    img = fx.source_image(2470, 40, 48)
    rgba = np.concatenate([img, np.full((40, 48, 1), 255, np.uint8)], 2)
    header, mip = fx.jpeg_split(fx.port_jpeg(img, 85))
    alpha = np.tile(np.array([[255, 255, 0, 0, 0, 0, 0, 0]], np.uint8), (120, 1))
    idx = (img[..., 0] // 64 * 16 + img[..., 1] // 64 * 4 + img[..., 2] // 64).astype(np.uint8)
    sun_map = (np.stack([np.arange(64) // 16, np.arange(64) // 4 % 4, np.arange(64) % 4]) * 85).astype(np.uint8)
    data = {
        "a.png": fx.dds_file(48, 40, fx.bc7_encode(rgba).tobytes(), dxgi=fx.DXGI["BC7_UNORM"]),
        "b.jpg": fx.dds_file(48, 40, fx.bc1_encode(img).tobytes(), b"DXT1"),
        "c.bmp": fx.blp_file(2, 48, 40, np.concatenate([alpha, fx.bc1_encode(img)], 1).tobytes(), encoding=2,
                             alpha=8, alpha_encoding=7),
        "d.webp": fx.blp_file(1, 48, 40, mip, compression=0, jpeg_header=header),
        "e.jpeg": fx.ftex_file(48, 40, 0, fx.bc1_encode(img).tobytes()),
        "f.png": fx.icns_file([(b"is32", fx.icns_rgb(img[:16, :16])), (b"ic07", fx.png_bytes(img[:32, :32], 8, 2))]),
        "g.jpg": fx.sun_file(48, 40, 8, 2, fx.sun_rle(fx.sun_rows(idx, 8, pad=False)), sun_map.tobytes()),
        "h.bmp": fx.tiff_bytes((img[..., 1].astype(np.int64) * 3 - 100) % 2 ** 32, 32, 1, compression=8, predictor=2,
                               tags={339: (3, [2])}),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_these_originals_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets on a folder of DDS, BLP, FTEX, ICNS, Sun raster and
    32-bit gray TIFF originals under listed names."""
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


def test_loader_reads_these_formats_as_jax_pillow_fallback(tmp_path):
    """A prepared set of BC7 DDS, ICNS, BLP2 DXT1 and Sun raster files
    under listed names: the port's loader reads each as the JAX package's
    ``StageDataset`` does through its Pillow fallback, on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    r = np.random.default_rng(2471)
    for i in range(8):
        img = r.integers(0, 256, (16, 16, 3)).astype(np.uint8)
        rgba = np.concatenate([img, np.full((16, 16, 1), 255, np.uint8)], 2)
        data = (fx.dds_file(16, 16, fx.bc7_encode(rgba).tobytes(), dxgi=fx.DXGI["BC7_UNORM"]) if i % 4 == 0 else
                fx.icns_file([(b"is32", fx.icns_rgb(img))]) if i % 4 == 1 else
                fx.blp_file(2, 16, 16, fx.bc1_encode(img).tobytes(), encoding=2, alpha=0, alpha_encoding=0)
                if i % 4 == 2 else fx.sun_file(16, 16, 24, 1, img[..., ::-1].tobytes()))
        (folder / f"image-{i}.{('png', 'jpg', 'webp', 'bmp')[i % 4]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2, 7, 6])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)


def test_project_targets_given_in_these_formats_match_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on ``face.dds``, ``face.blp``,
    ``face.icns``, ``face.ras`` and ``face.tif`` (32-bit gray) at the
    stage's size: the arrays the JAX CLI builds
    (``Image.open(path).convert("RGB")``)."""
    from byogan_tpu_torch.cli.project import load_target

    img = fx.source_image(2472, 32, 32)
    rgba = np.concatenate([img, np.full((32, 32, 1), 255, np.uint8)], 2)
    dds = fx.dds_file(32, 32, fx.bc7_encode(rgba).tobytes(), dxgi=fx.DXGI["BC7_UNORM"])
    paths = [_write(tmp_path, "face.dds", dds),
             _write(tmp_path, "face.blp", fx.blp_file(2, 32, 32, fx.bc1_encode(img).tobytes(), encoding=2, alpha=1,
                                                      alpha_encoding=0)),
             _write(tmp_path, "face.icns", fx.icns_file([(b"il32", fx.icns_rgb(img))])),
             _write(tmp_path, "face.ras", fx.sun_file(32, 32, 24, 2, fx.sun_rle(img[..., ::-1].reshape(32, -1)))),
             _write(tmp_path, "face.tif", fx.tiff_bytes(img[..., 0].astype(np.int64) * 2, 32, 1,
                                                        tags={339: (3, [1])}))]
    for path in paths:
        with Image.open(path) as im:  # byogan_tpu/cli/project.py's target
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=path)
        np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=path)
