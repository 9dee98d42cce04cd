"""The port's own JPEG and PNG codecs against libjpeg-turbo and libpng, on the CPU.

(The WebP decoder has its own file, ``test_torch_port_webp.py``, and so
do the JPEG kinds its native lane refuses or reads otherwise,
``test_torch_port_jpeg_kinds.py``; their failures and their fixtures'
hashes are held here beside the others.)

The native library (``native/png.cpp``, ``jpeg_decode.cpp``,
``jpeg_encode.cpp``, through ``data/native.py``) links zlib alone, so the
same code runs here and on the machine with the card, which has neither
libjpeg nor libpng.  Its oracles here: the JAX package's native lane (its
``byogan_io.cpp`` built into this session's temporary directory, never
its own library), Pillow (the same libjpeg-turbo), ``data/png.py`` and the
samples a PNG was written from.  Every case is bit for bit: decoded RGB,
and the encoder's bytes.  Then the fixtures that prove the same on the
card's machine (``tests/torch_port_codec_fixtures.py``), the failures that
raise by name, and threads.
"""

import concurrent.futures
import io
import os
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images, native, png

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402


@pytest.fixture(scope="session")
def jax_lane(tmp_path_factory):
    """JAX's libpng/libjpeg lane, built once for all of the session's workers."""
    return fx.jax_lane(str(tmp_path_factory.getbasetemp().parent / "jax_native_lane"))


def _write(tmp_path, name, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    im = Image.fromarray(img)
    if kw.pop("gray", False):
        im = im.convert("L")
    im.save(buf, format="JPEG", **kw)
    return buf.getvalue()


# --- JPEG decode ------------------------------------------------------------

PIL_KINDS = {
    "444": dict(subsampling=0),
    "422": dict(subsampling=1),
    "420": dict(subsampling=2),
    "gray": dict(gray=True),
    "progressive": dict(progressive=True),
    "progressive-444": dict(progressive=True, subsampling=0),
    "restarts": dict(restart_marker_blocks=1),
    "restart-rows": dict(restart_marker_rows=1, subsampling=1),
    "adobe-rgb": dict(keep_rgb=True, subsampling=0),
}
SIZES = ((1, 1), (8, 8), (17, 33))
DECODE_CASES = [(k, q, s) for k in PIL_KINDS for q in (1, 50, 92, 100) for s in SIZES] + [
    (k, 92, (511, 513)) for k in PIL_KINDS
]


@pytest.mark.parametrize("kind,quality,size", DECODE_CASES, ids=[f"{k}-q{q}-{s[0]}x{s[1]}" for k, q, s in DECODE_CASES])
def test_jpeg_decode_matches_libjpeg(tmp_path, jax_lane, kind, quality, size):
    """Pillow's JPEGs of every subsampling it writes, gray, progressive,
    with restart markers and as Adobe RGB, at qualities 1-100 and odd
    sizes: the port's RGB equals JAX's lane's and Pillow's."""
    img = fx.source_image(quality * 1000 + size[1], *size)
    path = _write(tmp_path, "a.jpg", _jpeg(img, quality=quality, **PIL_KINDS[kind]))
    got = native.decode_image(path)
    np.testing.assert_array_equal(got, fx.jax_decode(jax_lane, path))
    np.testing.assert_array_equal(got, fx.pil_rgb(path))
    np.testing.assert_array_equal(images.read_image(path, size), got)


# The samplings Pillow cannot write, made by the fixtures' own writer:
# (component (h, v) factors), sizes.
OWN_SAMPLINGS = {
    "h4v1-411": [(4, 1), (1, 1), (1, 1)],
    "h2v2-420": [(2, 2), (1, 1), (1, 1)],
    "luma-v2-h2v1": [(2, 2), (1, 2), (1, 2)],
    "chroma-above-luma": [(1, 1), (2, 2), (2, 2)],
    "h3v1": [(3, 1), (1, 1), (1, 1)],
    "h2v4-boxes": [(2, 4), (1, 1), (1, 1)],
    "gray-2x2": [(2, 2)],
}
OWN_CASES = [(k, s) for k in OWN_SAMPLINGS for s in ((1, 1), (5, 3), (17, 33), (40, 71))]


@pytest.mark.parametrize("kind,size", OWN_CASES, ids=[f"{k}-{s[0]}x{s[1]}" for k, s in OWN_CASES])
def test_jpeg_decode_of_other_samplings_matches_libjpeg(tmp_path, jax_lane, kind, size):
    """h4v1 (4:1:1), h3v1 and 2x4 luma (int_upsample's boxes), h2v1 under
    2x2 luma, chroma sampled above luma, a 2x2 gray component: JAX's lane
    and Pillow."""
    path = _write(tmp_path, "a.jpg", fx.jpeg_from_blocks(*size, OWN_SAMPLINGS[kind], seed=size[0] * 7 + size[1]))
    got = native.decode_image(path)
    np.testing.assert_array_equal(got, fx.jax_decode(jax_lane, path))
    np.testing.assert_array_equal(got, fx.pil_rgb(path))


# --- JPEG encode ------------------------------------------------------------

ENCODE_CASES = [(q, s) for q in fx.QUALITIES for s in ((1, 1), (8, 8), (16, 16), (17, 33), (61, 50))]


@pytest.mark.parametrize("quality,size", ENCODE_CASES, ids=[f"q{q}-{s[0]}x{s[1]}" for q, s in ENCODE_CASES])
def test_jpeg_encode_matches_libjpeg_bytes(tmp_path, jax_lane, quality, size):
    """``native.encode_jpeg`` writes JAX's ``byogan_encode_jpeg``'s bytes
    (libjpeg's defaults at ``quality``), sizes whole and not in MCUs."""
    img = fx.source_image(size[0] * 31 + quality, *size)
    native.encode_jpeg(str(tmp_path / "port.jpg"), img, quality)
    want = fx.jax_encode(jax_lane, img, quality, str(tmp_path / "jax.jpg"))
    assert (tmp_path / "port.jpg").read_bytes() == want
    np.testing.assert_array_equal(native.decode_image(str(tmp_path / "port.jpg")), fx.pil_rgb(str(tmp_path / "jax.jpg")))


# --- PNG --------------------------------------------------------------------

# color type, depth, channels, extra chunks' kind
PNG_LAYOUTS = {
    "gray1": (0, 1, 1), "gray2": (0, 2, 1), "gray4": (0, 4, 1), "gray8": (0, 8, 1), "gray16": (0, 16, 1),
    "rgb8": (2, 8, 3), "rgb16": (2, 16, 3),
    "palette1": (3, 1, 1), "palette2": (3, 2, 1), "palette4": (3, 4, 1), "palette8": (3, 8, 1),
    "gray-alpha8": (4, 8, 2), "gray-alpha16": (4, 16, 2), "rgba8": (6, 8, 4), "rgba16": (6, 16, 4),
}
PNG_CASES = [(k, i) for k in PNG_LAYOUTS for i in (False, True)]


def _png_case(name: str, interlace: bool, size=(13, 11), trns: bool = False):
    color, depth, ch = PNG_LAYOUTS[name]
    r = np.random.default_rng(zlib.crc32(f"{name}{interlace}{size}".encode()))
    top = 1 << depth if color != 3 else min(1 << depth, 200)
    samples = r.integers(0, top, size + (ch,))
    palette = bytes(r.integers(0, 256, 3 * top, dtype=np.uint8)) if color == 3 else b""
    data, rgb = fx.png_fixture(samples, depth, color, palette, interlace=interlace)
    if trns:  # a tRNS chunk before IDAT: libpng's lane drops it with the alpha it makes
        body = {0: b"\x00\x01", 2: b"\x00\x01\x00\x02\x00\x03", 3: bytes(range(0, 250, 50))}[color]
        at = data.index(b"IDAT") - 4
        data = data[:at] + fx.png_chunk(b"tRNS", body) + data[at:]
    return data, rgb


@pytest.mark.parametrize("name,interlace", PNG_CASES, ids=[f"{k}-{'adam7' if i else 'plain'}" for k, i in PNG_CASES])
def test_png_decode_matches_libpng(tmp_path, jax_lane, name, interlace):
    """Every colour type and depth, Adam7 and not, all five row filters in
    each file: the port's RGB equals the samples', JAX's lane's and (not
    interlaced) data/png.py's."""
    data, rgb = _png_case(name, interlace)
    path = _write(tmp_path, "a.png", data)
    got = native.decode_image(path)
    np.testing.assert_array_equal(got, rgb)
    np.testing.assert_array_equal(got, fx.jax_decode(jax_lane, path))
    if not interlace:
        np.testing.assert_array_equal(got, png.read_png(path))


ADAM7_SIZES = [(1, 1), (1, 9), (9, 1), (2, 3), (5, 5), (8, 8), (31, 29)]


@pytest.mark.parametrize("size", ADAM7_SIZES, ids=[f"{h}x{w}" for h, w in ADAM7_SIZES])
def test_adam7_sizes_with_empty_passes(tmp_path, jax_lane, size):
    """Adam7 at sizes where passes are empty (no filter bytes), gray 4-bit
    and RGB 16-bit."""
    for name in ("gray4", "rgb16"):
        data, rgb = _png_case(name, True, size)
        path = _write(tmp_path, f"{name}.png", data)
        np.testing.assert_array_equal(native.decode_image(path), rgb)
        np.testing.assert_array_equal(native.decode_image(path), fx.jax_decode(jax_lane, path))


@pytest.mark.parametrize("name", ["gray8", "rgb8", "palette4"])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
def test_png_trns_is_dropped(tmp_path, jax_lane, name, interlace):
    data, rgb = _png_case(name, interlace, trns=True)
    path = _write(tmp_path, "t.png", data)
    np.testing.assert_array_equal(native.decode_image(path), rgb)
    np.testing.assert_array_equal(native.decode_image(path), fx.jax_decode(jax_lane, path))


@pytest.mark.parametrize("mode", ["RGB", "L", "LA", "RGBA", "P", "I;16", "1"])
def test_pillow_written_png(tmp_path, jax_lane, mode):
    """Files Pillow writes (its filter choice, zlib level 6, one IDAT or
    several): JAX's lane; Pillow's own decode where it converts as libpng
    does (not I;16, which it clips)."""
    img = fx.source_image(len(mode), 40, 37)
    im = Image.fromarray(img)
    if mode == "P":
        im = im.quantize(64)
    elif mode == "I;16":
        im = Image.fromarray(img[..., 0].astype(np.uint16) * 257)
    elif mode != "RGB":
        im = im.convert(mode)
    path = str(tmp_path / "pil.png")
    im.save(path)
    got = native.decode_image(path)
    np.testing.assert_array_equal(got, fx.jax_decode(jax_lane, path))
    if mode != "I;16":
        np.testing.assert_array_equal(got, fx.pil_rgb(path))


def test_png_row_filters_and_idat_split(tmp_path, jax_lane):
    """One file per row filter (data/png.py's own writer's layout), and one
    whose zlib stream is split over many IDAT chunks."""
    img = fx.source_image(5, 21, 19)
    for kind in range(5):
        path = _write(tmp_path, f"f{kind}.png", fx.png_bytes(img.astype(np.int64), 8, 2, kinds=(kind,)))
        np.testing.assert_array_equal(native.decode_image(path), img)
    data = fx.png_bytes(img.astype(np.int64), 8, 2)
    at = data.index(b"IDAT") - 4
    n = int.from_bytes(data[at:at + 4], "big")
    stream = data[at + 8:at + 8 + n]
    pieces = b"".join(fx.png_chunk(b"IDAT", stream[i:i + 37]) for i in range(0, len(stream), 37))
    path = _write(tmp_path, "split.png", data[:at] + pieces + data[at + 12 + n:])
    np.testing.assert_array_equal(native.decode_image(path), img)
    np.testing.assert_array_equal(fx.jax_decode(jax_lane, path), img)


# --- the fixtures -----------------------------------------------------------


def test_fixture_manifest_is_what_the_libraries_make(tmp_path, jax_lane):
    """The fixtures and their manifest rebuilt here (Pillow, JAX's lane)
    equal the committed ones, so they cannot drift from the libraries."""
    files = fx.fixtures()
    assert sorted(files) == sorted(n for n in os.listdir(fx.FIXTURES) if n not in ("manifest.json", fx.WEBP, fx.KINDS))
    for name, (data, _) in files.items():
        with open(os.path.join(fx.FIXTURES, name), "rb") as f:
            assert f.read() == data, name
    # The WebP files are the committed ones: another libwebp build may encode other bytes.  So are the
    # files of the JPEG kinds (test_torch_port_jpeg_kinds.py holds them to their writers).
    webp = fx.committed_webp()
    assert sorted(webp) == sorted(fx.webp_fixtures())
    assert fx.build_manifest(files, jax_lane, str(tmp_path), webp, fx.committed_kinds()) == fx.load_manifest()
    assert sum(len(d) for d, _ in files.values()) < 300_000
    assert sum(len(d) for d in webp.values()) < 300_000


def test_port_matches_the_fixtures(tmp_path):
    """What ``chip_smoke.py`` checks on the card's machine: every fixture
    decodes to the manifest's hash, every source encodes to it."""

    def encode(img, quality):
        native.encode_jpeg(str(tmp_path / "e.jpg"), img, quality)
        return (tmp_path / "e.jpg").read_bytes()

    matched = fx.check(native.decode_image, encode, native.decode_vp8_yuv)
    manifest = fx.load_manifest()
    planes = sum("sha256_yuv" in e for e in manifest["files"].values())
    assert len(matched) == len(manifest["files"]) + planes + len(fx.SOURCES) * len(fx.QUALITIES)
    assert len(manifest["files"]) == len(os.listdir(fx.FIXTURES)) - 3 + len(fx.committed_webp()) + len(fx.committed_kinds())


# --- failures ---------------------------------------------------------------


def _scan_start(data: bytes) -> int:
    """The first byte of the first scan's entropy-coded data."""
    at = data.index(b"\xff\xda")
    return at + 2 + int.from_bytes(data[at + 2:at + 4], "big")


def _cut_in_scan(data: bytes, scan: int = 0) -> bytes:
    """``data`` cut halfway through the entropy-coded data of its scan
    number ``scan``."""
    at = -1
    for _ in range(scan + 1):
        at = data.index(b"\xff\xda", at + 1)
    start = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    end = next(i for i in range(start, len(data) - 1)
               if data[i] == 0xFF and data[i + 1] != 0 and not 0xD0 <= data[i + 1] <= 0xD7)
    return data[:(start + end) // 2]


def _failures():
    img = fx.source_image(3, 40, 48)
    base = _jpeg(img, quality=90)
    prog = _jpeg(img, quality=90, progressive=True)
    sof = base.index(b"\xff\xc0")
    scan = _scan_start(base)

    def with_marker(code: int) -> bytes:
        return base[:sof + 1] + bytes([code]) + base[sof + 2:]

    twelve = bytearray(base)
    twelve[sof + 4] = 12
    corrupt = bytearray(base)
    corrupt[scan + 40:scan + 42] = b"\xff\xd3"  # a marker in the middle of the scan
    png_bytes = fx.png_bytes(img.astype(np.int64), 8, 2)
    bad_crc = bytearray(png_bytes)
    bad_crc[png_bytes.index(b"IDAT") + 10] ^= 0x55
    kind = lambda name: fx.committed_kinds()[f"{fx.KINDS}/{name}"]  # noqa: E731
    planes = [img[..., c] for c in range(3)]
    lossless = fx.jpeg_lossless(planes, 7, restart_rows=2)
    sof11 = bytearray(lossless)
    sof11[sof11.index(b"\xff\xc3") + 1] = 0xCB
    dac = bytearray(kind("arith-seq-420.jpg"))
    at = dac.index(b"\xff\xcc")
    dac[at + 5] = 0x23  # DC table 0: L 3 above U 2
    webp = {name: (data, "webp", what) for name, (data, what) in fx.webp_failures().items()}
    return {
        "jpeg-truncated-in-scan": (base[:scan + (len(base) - scan) // 2], "jpg", "truncated"),
        "jpeg-truncated-before-scan": (base[:scan - 5], "jpg", "truncated"),
        "jpeg-without-eoi": (base[:-2], "jpg", "truncated"),
        "progressive-truncated-between-scans": (prog[:prog.index(b"\xff\xda", _scan_start(prog))], "jpg",
                                                "truncated"),
        "jpeg-marker-inside-scan": (bytes(corrupt), "jpg", "breaks the format"),
        "png-truncated": (png_bytes[:len(png_bytes) // 2], "png", "truncated"),
        "png-bad-crc": (bytes(bad_crc), "png", "CRC does not match"),
        # the kinds that now decode, cut in their data
        "cmyk": (_cut_in_scan(kind("cmyk-adobe.jpg")), "jpg", "truncated"),
        "arithmetic": (_cut_in_scan(kind("arith-seq-420.jpg")), "jpg", "truncated"),
        "lossless": (_cut_in_scan(lossless), "jpg", "truncated"),
        "440": (_cut_in_scan(kind("440-33x45.jpg")), "jpg", "truncated"),
        "progressive-dc-only": (_cut_in_scan(kind("smooth-dc-only-420.jpg")), "jpg", "truncated"),
        "arithmetic-progressive-cut-in-a-later-scan": (_cut_in_scan(kind("arith-prog-444.jpg"), 3), "jpg",
                                                       "truncated"),
        "ycck-cut-in-restart-interval": (_cut_in_scan(kind("ycck-420.jpg")), "jpg", "truncated"),
        "arithmetic-dac-l-above-u": (bytes(dac), "jpg", "breaks the format"),
        "lossless-arithmetic-sof11": (bytes(sof11), "jpg", "arithmetic coding \\(SOF11\\)"),
        "lossless-16-bit": (fx.jpeg_lossless(planes[:1], 1, precision=16), "jpg", "precision other than 8 bits"),
        "lossless-12-bit": (fx.jpeg_lossless(planes[:1], 1, precision=12), "jpg", "precision other than 8 bits"),
        "lossless-jfif-ycbcr": (fx.jpeg_lossless(planes, 1, jfif=True), "jpg", "YCbCr colour space"),
        "12-bit": (bytes(twelve), "jpg", "12-bit"),
        "hierarchical": (with_marker(0xC5), "jpg", "hierarchical"),
        "fractional-sampling": (fx.jpeg_from_blocks(16, 24, [(3, 1), (2, 1), (1, 1)], 3), "jpg", "sampling"),
        **webp,
    }


FAILURES = list(_failures())


@pytest.mark.parametrize("name", FAILURES)
def test_failures_raise_naming_the_file_and_the_fault(tmp_path, name):
    data, ext, what = _failures()[name]
    path = _write(tmp_path, f"{name}.{ext}", data)
    with pytest.raises(OSError, match=f"{name}\\.{ext}: .*{what}"):
        images.read_image(path)


# --- threads ----------------------------------------------------------------


def test_eight_threads_equal_one(tmp_path):
    """The loader's threads call the decoders at once (ctypes drops the
    interpreter lock): 8 threads over a set of JPEGs and PNGs of every kind
    give what one thread gives, and the encoder likewise."""
    paths = [os.path.join(fx.FIXTURES, n) for n in sorted(os.listdir(fx.FIXTURES))
             if n not in ("manifest.json", fx.WEBP, fx.KINDS)]
    big = fx.source_image(9, 200, 160)
    for i, kw in enumerate((dict(), dict(progressive=True), dict(restart_marker_blocks=3))):
        paths.append(_write(tmp_path, f"big{i}.jpg", _jpeg(big, quality=85, **kw)))
    paths.append(_write(tmp_path, "big.png", fx.png_bytes(big.astype(np.int64), 8, 2, interlace=True)))
    work = paths * 6
    one = [native.decode_image(p) for p in work]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        many = list(pool.map(native.decode_image, work))
    for p, a, b in zip(work, one, many):
        np.testing.assert_array_equal(a, b, err_msg=p)

    def encode(i):
        path = str(tmp_path / f"enc{i}.jpg")
        native.encode_jpeg(path, big, 50 + i % 40)
        with open(path, "rb") as f:
            return f.read()

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        encoded = list(pool.map(encode, range(32)))
    assert encoded == [encode(i) for i in range(32)]
