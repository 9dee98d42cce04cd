"""The port's IM, IMT, IPTC, PCD and SPIDER readers, old-style LZW TIFF and
the walk of Pillow's plugins against Pillow and the JAX package, on the CPU.

The JAX package reads an original under a listed extension through
``Image.open(path).convert("RGB")``, and Pillow 12.1.0 identifies IM, IMT,
IPTC, PCD, SPIDER and TGA by their ``_open`` alone (they have no
``_accept``), at their places in its plugin order.  So the port's
``images.walk`` and its ``decode_im``, ``decode_imt``, ``decode_iptc``,
``decode_pcd`` and ``decode_spider`` (numpy; IM's bit decoder in the native
library) and ``native/tiff.cpp``'s old-style LZW are held bit for bit to
Pillow's ``convert("RGB")`` in both of the port's lanes: every layout of
``fx.imips_layouts``, every "Image type" of ImImagePlugin's table and every
mode and raw mode an IM header can pair, PCDs in each orientation, the
walk's order on files two plugins could take, Pillow's refusals with the
file and Pillow's verdict named (``fx.imips_refusals``; those that end
Pillow's walk are never read as a later format), the YCC;P and YCbCr ->
RGB conversions on all 2^24 triples, and seeded files of each kind (a
larger sweep under ``-m slow``).  The committed files under
``im_iptc_pcd_spider/`` and the card's originals are held to their writers
and the manifest.  Then a folder of such originals among earlier formats
under listed names through the port's ``cli.prep`` against the JAX
package's ``prepare_pyramid``, and ``cli.project`` on a PCD target against
the JAX CLI's.  Tolerance 0.
"""

import io
import os
import re
import struct
import sys

import numpy as np
import pytest
from PIL import Image, ImImagePlugin

from byogan_tpu_torch.data import images

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402
from test_torch_port_gif import _pillow, _same_as_pillow, _write  # noqa: E402

LAYOUTS = fx.imips_layouts()
REFUSALS = fx.imips_refusals()
LISTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
#: Pillow 12.1.0's modes: what an IM header's "Image type" may name besides its table
MODES = ("1", "L", "P", "RGB", "RGBA", "RGBX", "CMYK", "YCbCr", "LAB", "HSV", "I", "F", "LA", "PA", "La", "RGBa",
         "I;16", "I;16L", "I;16B", "I;16N", "X", "")


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: n.split("/", 1)[1].rsplit(".", 1)[0])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name).rsplit(".", 1)[0] + LISTED[len(name) % 5], LAYOUTS[name])
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n.rsplit(".", 1)[0])
def test_refused_file_raises_naming_the_file_and_pillows_verdict(tmp_path, name):
    """Pillow refuses each too: where its walk ends on the plugin's error,
    the port names the same verdict and reads it as no later format."""
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name.rsplit(".", 1)[0] + ".png", data)
    assert isinstance(_pillow(path), Exception), name
    with pytest.raises(OSError, match=f"{re.escape(path)}.*{reason}"):
        images.read_image(path)


@pytest.mark.parametrize("lut", ["none", "colours", "grays", "linear"])
@pytest.mark.parametrize("size", [(1, 1), (13, 9), (33, 4)])
def test_every_image_type_of_pillows_table(tmp_path, size, lut):
    """Each "Image type" of ImImagePlugin's OPEN (F;n through the bit
    decoder, RGB;T as three planes, RLB and PA refused as Pillow refuses
    them), with no LUT, a LUT of colours (L and P become P through it), of
    grays (kept, never applied) and the linear one, and data cut short."""
    w, h = size
    r = np.random.default_rng(2430 + w + len(lut))
    tables = {"none": b"", "colours": r.integers(0, 256, 768, dtype=np.uint8).tobytes(),
              "grays": np.tile(r.integers(0, 256, 256), 3).astype(np.uint8).tobytes(),
              "linear": np.tile(np.arange(256), 3).astype(np.uint8).tobytes()}
    read = 0
    for k, typ in enumerate(sorted(ImImagePlugin.OPEN)):
        lines = [b"Image type: " + typ.encode(), b"Image size (x*y): %d*%d" % (w, h)] + ([b"Lut: 1"] if lut != "none"
                                                                                        else [])
        body = r.integers(0, 256, 4 * w * h + 8, dtype=np.uint8).tobytes()
        data = fx.im_file(lines, body if k % 7 else body[:w * h // 2], tables[lut])
        read += _same_as_pillow(_write(tmp_path, f"t{k}{LISTED[k % 5]}", data), f"{typ} {size} {lut}")
    assert read >= 40


def test_every_mode_an_im_header_can_pair_with_a_raw_mode(tmp_path):
    """A second "Image type" line naming a mode itself keeps the raw mode of
    the type before it: every Pillow mode against every raw mode of the
    table (P from L, LAB from L through the Lab conversion, RGBX and RGBA
    from three planes...), with and without a LUT of colours."""
    r = np.random.default_rng(2440)
    raws = sorted({raw for _, raw in ImImagePlugin.OPEN.values()} | {"L"})
    read = 0
    for raw in raws:
        typ = next((t for t, (_, rr) in sorted(ImImagePlugin.OPEN.items()) if rr == raw), None)
        for k, mode in enumerate(MODES):
            lines = ([b"Image type: " + typ.encode()] if typ else []) + [b"Image type: " + mode.encode(),
                                                                          b"Image size (x*y): 6*4"]
            lut = r.integers(0, 256, 768, dtype=np.uint8).tobytes() if k % 3 == 0 else b""
            data = fx.im_file(lines + ([b"Lut: 1"] if lut else []), r.integers(0, 256, 200, dtype=np.uint8).tobytes(),
                              lut)
            read += _same_as_pillow(_write(tmp_path, f"{len(raw)}-{k}.png", data), f"{mode} of {raw}")
    assert read >= 60


def test_im_rows_are_bottom_up_and_a_palette_goes_through_its_lut(tmp_path):
    """An image Pillow's IM writer saved (rows bottom-up, RGB;L) reads as
    the image itself, and a P image with its LUT as that image in RGB."""
    img = fx.smooth_scene(2441, 11, 17, cell=4, step=8)
    img[0, 0] = (255, 0, 0)  # the top left corner, which the file stores last
    for mode in ("RGB", "P"):
        im = Image.fromarray(img) if mode == "RGB" else Image.fromarray(img).quantize(256)
        path = str(tmp_path / f"{mode}.png")
        im.save(path, "IM")
        with open(path, "rb") as f:
            assert f.read(512).startswith(b"Image type: ")
        np.testing.assert_array_equal(images.read_image(path), np.asarray(im.convert("RGB")), err_msg=mode)
    np.testing.assert_array_equal(images.read_image(str(tmp_path / "RGB.png")), img)


@pytest.mark.parametrize("orientation", range(8))
def test_pcd_in_each_orientation_matches_pillow(tmp_path, orientation):
    """A PhotoCD's base image, upright (orientation 0 and 2, and the same
    with the byte's upper bits set) or turned by 90 (1) or 270 (3)
    degrees, from seeded planes."""
    r = np.random.default_rng(2450 + orientation)
    y, c1, c2 = r.integers(0, 256, (512, 768)), r.integers(0, 256, (256, 384)), r.integers(0, 256, (256, 384))
    data = fx.pcd_file(y, c1, c2, orientation | (0xF0 if orientation > 3 else 0))
    path = _write(tmp_path, f"scan{LISTED[orientation % 5]}", data)
    assert _same_as_pillow(path, f"orientation {orientation}")
    assert images.read_image(path).shape == ((768, 512, 3) if orientation % 2 else (512, 768, 3))


def test_the_conversions_match_pillow_on_every_triple():
    """``ycc_to_rgb`` ("YCC;P", PCD's) and ``ycbcr_to_rgb`` (Pillow's YCbCr ->
    RGB, IM's) on all 2^24 triples, in the order the card's "io fixtures"
    hashes them."""
    triples = fx.lab_table_triples()
    want = np.asarray(Image.frombytes("RGB", (4096, 4096), triples.tobytes(), "raw", "YCC;P")).reshape(-1, 3)
    got = images.ycc_to_rgb(triples)
    assert np.array_equal(got, want) and fx.sha256(got) == fx.load_manifest()["ycc_table"]["sha256_rgb"]
    want = np.asarray(Image.frombytes("YCbCr", (4096, 4096), triples.tobytes()).convert("RGB")).reshape(-1, 3)
    got = images.ycbcr_to_rgb(triples)
    assert np.array_equal(got, want) and fx.sha256(got) == fx.load_manifest()["ycbcr_table"]["sha256_rgb"]


def _collisions():
    """Files two plugins could take, by Pillow's order: a Targa whose ID
    length is 28 and colour map type 1 (an IPTC field's first bytes: a
    length byte above 132 ends Pillow's walk at IPTC, a short one passes
    it on to TGA), text that is an IMT header or fails IM's and IMT's
    line rules (a PPM, an XBM, an XPM), a McIdas of zero bytes, a SPIDER
    whose first float makes an IM line, a PCD whose first bytes are a
    JPEG's, and 64 random bytes."""
    r = np.random.default_rng(2460)
    px = r.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    tga = fx.tga_file(px, 2, 24)
    cmap = bytes([28, 1, 2]) + struct.pack("<HHB", 0, 2, 24) + tga[8:18] + bytes(28) + bytes(6) + px.tobytes()
    gray = r.integers(0, 256, (9, 13), dtype=np.uint8)
    y, c1, c2 = r.integers(0, 256, (512, 768)), r.integers(0, 256, (256, 384)), r.integers(0, 256, (256, 384))
    return {
        "tga-like-iptc-short.tga": cmap,
        "tga-like-iptc-illegal.tga": cmap[:3] + bytes([0xC8, 0]) + cmap[5:],
        "width-13.imt": b"width 13\nheight 9\npixel n8\n\x0c" + gray.tobytes(),
        "width-13-no-pixel-line.imt": b"width 13\nheight 9\n\x0c" + gray.tobytes(),
        "ppm.ppm": fx.pnm_raw(px, b"P6"),
        "xbm.xbm": fx.xbm_file(gray & 1),
        "xpm.xpm": fx.xpm_file(gray % 3, [b"#ff0000", b"#00ff00", b"#0000ff"], 1),
        "mcidas.mcidas": fx.mcidas_file(gray, 1),
        "spider.spi": fx.spider_file(gray.astype(np.float32)),
        "pcd-of-jpeg-bytes.pcd": fx.port_jpeg(px, 80)[:2048].ljust(2048, b"\0") + fx.pcd_file(y, c1, c2)[2048:],
        "im-in-a-tiff-name.im": fx.im_file([b"Image type: L 8 image", b"Image size (x*y): 13*9"], gray.tobytes()),
        "noise.bin": bytes(r.integers(0, 256, 64, dtype=np.uint8)),
    }


@pytest.mark.parametrize("name", sorted(_collisions()))
def test_walk_order_on_files_two_plugins_could_take(tmp_path, name):
    """The port identifies each file as Pillow's ``Image.open`` does
    (``images.sniff`` names Pillow's format, or "unknown") and reads or
    refuses it as Pillow does."""
    data = _collisions()[name]
    path = _write(tmp_path, name.rsplit(".", 1)[0] + ".png", data)
    try:
        with Image.open(path) as im:
            want = {"SUN": "Sun raster", "MCIDAS": "McIdas", "XVTHUMB": "XV thumbnail", "WEBP": "WebP"}.get(
                im.format, im.format)
    except Exception as e:  # noqa: BLE001 - UnidentifiedImageError, or the plugin's own verdict
        want = e
    if isinstance(want, Exception) and "cannot identify" not in str(want):
        with pytest.raises(OSError, match=re.escape(str(want).split(" (")[0])):
            images.sniff(data)
    else:
        assert images.sniff(data) == ("unknown" if isinstance(want, Exception) else want)
    _same_as_pillow(path, name)


def test_prep_refuses_a_folder_before_writing_when_the_walk_ends_on_a_verdict(tmp_path):
    """``prepare_pyramid`` decides on the same walk: a folder with an IPTC
    file whose field length Pillow calls illegal is refused before any set
    is written, and one with a PCD among PNGs is read."""
    from byogan_tpu_torch.data.prep import prepare_pyramid

    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "a.png").write_bytes(fx.png_bytes(np.zeros((8, 8, 3), np.uint8), 8, 2))
    (bad / "b.jpg").write_bytes(REFUSALS["iptc-illegal-field-length.iptc"][0])
    with pytest.raises(OSError, match=r"b\.jpg: IPTC file that Pillow refuses \(illegal field length"):
        prepare_pyramid(str(bad), 4, 8, workers=1, device="cpu")
    assert not (bad / "prepared").exists()
    assert images.identify(str(bad / "original" / "images" / "a.png")) == "PNG"


def _seeded_im(r) -> bytes:
    """An IM file over the table's types and modes, header lines in any
    order and line ending, sizes that are no pair of integers, comments,
    LUTs, no padding, no 0x1a, data of any length."""
    w, h = int(r.integers(1, 9)), int(r.integers(1, 7))
    typ = str(r.choice(sorted(ImImagePlugin.OPEN) + ["RGB", "P", "L", "LAB", "foo", ""]))
    size = str(r.choice([f"{w}*{h}", f"{w},{h}", f"{w}", f"{w}*{h}*2", f"{w}.0*{h}", f"-{w}*{h}", f" {w} * {h} ",
                         f"{w}_0*{h}", "nan*3", "inf*2", f"{w}*x", "0*5"]))
    pool = [f"Image type: {typ}", f"Image size (x*y): {size}", "Name: a.im", "File size (no of images): 1",
            "Comment: c", "Scale (x,y): 1,1", "Date: d", "Lut: 1", "Foo: bar", "File size (no of images): x",
            "Image type:", "x" * 120, "no colon", "Name:" + "n" * 95]
    lines = [f"Image type: {typ}", f"Image size (x*y): {size}"] if r.random() < 0.8 else []
    lines += [str(r.choice(pool)) for _ in range(int(r.integers(0, 4)))]
    r.shuffle(lines)
    sep = str(r.choice(["\r\n", "\n", "\n\r"]))
    head = "".join(line + sep for line in lines).encode("latin-1")
    head += b"\0" * max(0, 511 - len(head)) if r.random() < 0.6 else b""
    body = r.integers(0, 256, int(r.integers(0, 32 * w * h + 800)), dtype=np.uint8).tobytes()
    return head + (b"" if r.random() < 0.05 else b"\x1a") + body


def _seeded_imt(r) -> bytes:
    """An IMT header of its fields, comments, lines that are no field, in
    any order, with or without its 0x0c byte, data of any length."""
    w, h = int(r.integers(1, 9)), int(r.integers(1, 7))
    pool = [f"width {w}", f"height {h}", "pixel n8", "pixel n16", "* comment", "width x", "height -3", "Width 5",
            "foo bar", "", "x" * 120, "width"]
    lines = ["width %d" % w, "height %d" % h, "pixel n8"] if r.random() < 0.8 else []
    lines += [str(r.choice(pool)) for _ in range(int(r.integers(0, 4)))]
    r.shuffle(lines)
    head = "".join(line + str(r.choice(["\n", "\r\n"])) for line in lines).encode()
    return head + (b"\x0c" if r.random() < 0.9 else b"") + r.integers(0, 256, int(r.integers(0, 2 * w * h + 5)),
                                                                        dtype=np.uint8).tobytes()


def _seeded_iptc(r) -> bytes:
    """An IPTC file: raw data or an embedded JPEG, PNG, PPM or TIFF, of L or
    of a band (in range or not), fields in any order, repeated, missing,
    of extended lengths, an illegal one, a bad compression, cut short."""
    w, h = int(r.integers(1, 9)), int(r.integers(1, 7))
    px = r.integers(0, 256, (h, w), dtype=np.uint8)
    kind = int(r.integers(0, 5))
    body = (px.tobytes() if kind == 0 else fx.port_jpeg(np.stack([px] * 3, -1), 80) if kind == 1 else
            fx.png_bytes(px[..., None], 8, 0) if kind == 2 else fx.pnm_raw(px, b"P5") if kind == 3 else
            fx.tiff_bytes(px, 8, 1, compression=5))
    layers, component = [(1, 0), (3, 1), (4, 1), (1, 1), (2, 1)][int(r.choice([0, 0, 1, 1, 2, 3, 4]))]
    band = int(r.integers(0, 6)) if r.random() < 0.5 else None
    fields = [fx.iptc_field(3, 20, struct.pack(">H", w)), fx.iptc_field(3, 30, struct.pack(">H", h)),
              fx.iptc_field(3, 60, bytes([layers, component])),
              fx.iptc_field(3, 120, bytes([1 if kind == 0 else int(r.choice([5, 5, 5, 3]))]))]
    if band is not None:
        fields.append(fx.iptc_field(3, 65, bytes([band])))
    if r.random() < 0.3:
        fields.append(fx.iptc_field(2, int(r.integers(0, 256)), b"caption", extended=int(r.choice([0, 1, 2, 4]))))
    r.shuffle(fields)
    if r.random() < 0.1:
        del fields[int(r.integers(0, len(fields)))]
    if r.random() < 0.05:
        fields.insert(0, bytes([0x1C, 2, 5, int(r.integers(129, 256)), 0]))
    step = int(r.integers(1, len(body) + 1))
    data = b"".join(fields) + b"".join(fx.iptc_field(8, 10, body[i:i + step]) for i in range(0, len(body), step))
    data += bytes(5) if r.random() < 0.8 else b""
    return data[:int(r.integers(3, len(data)))] if r.random() < 0.1 else data


def _seeded_spider(r) -> bytes:
    """A SPIDER file in either byte order, single or a stack, of any form,
    header records and lengths, NaN and infinite samples, cut short."""
    h, w = int(r.integers(1, 9)), int(r.integers(1, 9))
    values = r.normal(0, 300, (h, w)).astype(np.float32)
    if r.random() < 0.2:
        values[0, 0] = float(r.choice([np.nan, np.inf, -np.inf]))
    kw = {}
    if r.random() < 0.3:
        kw.update(istack=int(r.choice([0, 1, 2, -1])), maxim=int(r.integers(0, 3)), images=2)
    if r.random() < 0.2:
        kw["imgnum"] = int(r.choice([0, 1, -1]))
    if r.random() < 0.1:
        kw["iform"] = int(r.choice([1, 3, -11, 2]))
    if r.random() < 0.1:
        kw["labrec"] = int(r.integers(-2, 4))
    if r.random() < 0.1:
        kw["lenbyt"] = int(r.integers(-8, 80))
    data = fx.spider_file(values, bool(r.random() < 0.5), **kw)
    return data[:int(r.integers(0, len(data)))] if r.random() < 0.1 else data


def _seeded_old_lzw(r) -> bytes:
    """An old-style LZW TIFF of gray, RGB or 4-bit palette samples, in
    strips, tiles or planes, with Predictor 2, cut short."""
    h, w = int(r.integers(1, 40)), int(r.integers(1, 40))
    kind = int(r.integers(0, 3))
    kw = {}
    if r.random() < 0.3:
        kw["rows_per_strip"] = int(r.integers(1, h + 1))
    elif r.random() < 0.2:
        kw["tile"] = (16, 16)
    if kind != 2 and r.random() < 0.3:
        kw["predictor"] = 2
    if kind == 1 and r.random() < 0.2:
        kw["planar"] = 2
    if kind == 2:
        data = fx.tiff_bytes(r.integers(0, 16, (h, w)), 4, 3, compression=5, old_lzw=True,
                             colormap=r.integers(0, 65536, (16, 3)), **kw)
    else:
        v = r.integers(0, int(r.choice([2, 16, 256])), (h, w, 3) if kind == 1 else (h, w))
        data = fx.tiff_bytes(v, 8, 2 if kind == 1 else 1, compression=5, old_lzw=True, **kw)
    return data[:int(r.integers(8, len(data)))] if r.random() < 0.1 else data


SEEDED = {"im": (_seeded_im, 160), "imt": (_seeded_imt, 100), "iptc": (_seeded_iptc, 120),
          "spider": (_seeded_spider, 120), "old-lzw": (_seeded_old_lzw, 90)}


@pytest.mark.parametrize("kind", sorted(SEEDED))
def test_seeded_files_match_pillow(tmp_path, kind):
    """590 seeded files in all (160 IM, 100 IMT, 120 IPTC, 120 SPIDER, 90
    old-style LZW TIFFs)."""
    seeded, n = SEEDED[kind]
    r = np.random.default_rng(2470 + sorted(SEEDED).index(kind))
    for t in range(n):
        _same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", seeded(r)), f"{kind} file {t}")


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(SEEDED))
def test_seeded_sweep_matches_pillow(tmp_path, kind):
    """3000 seeded files of each kind."""
    seeded, _ = SEEDED[kind]
    r = np.random.default_rng(2480 + sorted(SEEDED).index(kind))
    for t in range(3000):
        _same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", seeded(r)), f"{kind} file {t}")


def test_committed_fixtures_are_what_the_writers_make():
    """The committed files under ``im_iptc_pcd_spider/`` are what
    ``imips_fixtures`` writes here, and the manifest records each: Pillow's
    RGB, or for a refusal the reason and what Pillow makes of it; the
    card's written originals (never committed), and the JAX package's prep
    of every slice's originals of the Pillow lane in one folder."""
    made = fx.imips_fixtures()
    committed = fx.committed_imips()
    assert sorted(made) == sorted(committed)
    for name, data in made.items():
        assert committed[name] == data, name
    manifest = fx.load_manifest()
    files = manifest["files"]
    assert sorted(n for n in files if n.startswith(f"{fx.IMIPS}/")) == sorted(committed)
    for name in committed:
        assert ("refused" in files[name]) == ("/refused/" in name) and files[name]["sha256"] == fx.sha256(
            committed[name]), name
    assert sorted(manifest["imips_card"]) == sorted(fx.imips_card_originals())
    listed = fx.pillow_lane_sources()
    assert len(listed) == len({n for n, _, _ in listed}) >= 55
    assert sorted(n for d in manifest[fx.PILLOW_LANE_PREP].values() for n in d) == sorted(
        f"image-{i}.png" for i in range(len(listed)) for _ in range(8))
    assert sum(map(len, committed.values())) < 200_000


def test_committed_fixtures_decode_to_the_manifest():
    """``chip_smoke.py``'s "io fixtures" on this folder: each file decodes
    to the manifest's RGB in both lanes, each refusal raises its reason."""
    files = fx.load_manifest()["files"]
    n = 0
    for name, want in sorted(files.items()):
        if not name.startswith(f"{fx.IMIPS}/"):
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
    assert n >= 100


def test_card_originals_decode_to_the_manifest(tmp_path):
    """``chip_smoke.py``'s "io fixtures" on the card's originals of this
    slice: the written ones are the manifest's bytes, and each decodes to
    Pillow's RGB."""
    paths = fx.check_imips_card(str(tmp_path), images.read_image)
    assert sorted(paths) == sorted(fx.IMIPS_CARD)


def _originals(root: str) -> str:
    """Small originals of each new kind among earlier formats, under listed
    names: an RGB;L IM (.png), an IMT (.jpg), a raw IPTC (.bmp), an IPTC
    band of an embedded gray JPEG (.webp), a PCD turned by 90 degrees
    (.jpeg), a little-endian SPIDER (.png), an old-style LZW TIFF (.jpg), a
    PNG, a Targa (.bmp) and an XPM (.png)."""
    os.makedirs(root)
    img = fx.source_image(2490, 40, 48)
    r = np.random.default_rng(2491)
    gray = Image.fromarray(img).convert("L")
    jpg = io.BytesIO()
    gray.save(jpg, "JPEG", quality=88)
    data = {
        "a.png": fx.im_file([b"Image type: RGB image", b"Image size (x*y): 48*40"], fx.im_planes(img)),
        "b.jpg": fx.imt_file(img[..., 1]),
        "c.bmp": fx.iptc_file(48, 40, 1, 0, 1, img[..., 2].tobytes()),
        "d.webp": fx.iptc_file(48, 40, 4, 1, 5, jpg.getvalue(), band=3),
        "e.jpeg": fx.pcd_file(r.integers(0, 256, (512, 768)), r.integers(90, 220, (256, 384)),
                              r.integers(90, 220, (256, 384)), 1),
        "f.png": fx.spider_file(img[..., 0].astype(np.float32) * 1.2 - 30.5, big=False),
        "g.jpg": fx.tiff_bytes(img, compression=5, predictor=2, rows_per_strip=16, old_lzw=True),
        "h.png": fx.png_bytes(img, 8, 2),
        "i.bmp": fx.tga_file(img, 2, 24),
        "j.png": fx.xpm_file(r.integers(0, 40, (40, 48)), [b"#%06x" % v for v in r.integers(0, 2 ** 24, 40)], 1),
    }
    for name, d in data.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(d)
    return root


def test_prep_cli_on_a_mixed_folder_matches_jax(tmp_path):
    """The port's ``cli.prep`` and the JAX package's ``prepare_pyramid``
    give equal sets, all 8 of them, on a folder of this slice's originals
    among earlier formats under listed names."""
    from byogan_tpu.data.prep import prepare_pyramid as jax_prepare

    from byogan_tpu_torch.cli import prep as port_prep_cli
    from byogan_tpu_torch.data.png import read_png

    jax_root, port_root = _originals(str(tmp_path / "jax")), _originals(str(tmp_path / "port"))
    jax_prepare(jax_root, 4, 512, workers=2)
    port_prep_cli.main([port_root, "4", "512", "-y", "-w", "2", "-d", "cpu"])
    n = 0
    for k in range(1, 9):
        sub = os.path.join("prepared", f"set_{k}", "images")
        names = sorted(os.listdir(os.path.join(port_root, sub)))
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) and len(names) == 10
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
            n += 1
    assert n == 80


def test_project_target_given_as_a_pcd_matches_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on a PCD turned by 270 degrees, an
    IM and a SPIDER, each at the stage's size: the JAX CLI's target."""
    from test_torch_port_project import jax_cli_target

    from byogan_tpu_torch.cli.project import load_target

    r = np.random.default_rng(2492)
    img = fx.source_image(2493, 24, 20)
    files = {"face.pcd": fx.pcd_file(r.integers(0, 256, (512, 768)), r.integers(90, 220, (256, 384)),
                                     r.integers(90, 220, (256, 384)), 3),
             "face.im": fx.im_file([b"Image type: RGB image", b"Image size (x*y): 20*24"], fx.im_planes(img)),
             "face.spi": fx.spider_file(img[..., 1].astype(np.float32) - 7.5)}
    paths = [_write(tmp_path, name, data) for name, data in files.items()]
    want = jax_cli_target(paths, 4)
    for path, expected in zip(paths, want):
        np.testing.assert_array_equal(load_target(path, 32), expected, err_msg=path)
