"""The port's image IO against the JAX package's and Pillow, on the CPU.

The native library (the port's own PNG and JPEG codecs, ``native/*.cpp``
through ``data/native.py``), ``data/png.py``'s plain decoder (its Python
``_unfilter`` and the C ``byogan_unfilter``), the BMP reader and the format
dispatch of ``data/images.py``; then the fault they fix: a prepared set's
JPEG and BMP files were dropped, so the port trained on another set than
JAX.  Everything is held bit for bit, JPEG included: the port's decoder
gives libjpeg's output for its defaults, and its encoder libjpeg's bytes.
JAX's own native lane (libpng, libjpeg) is the reference, built from its
source into the session's temporary directory under a lock
(``torch_port_codec_fixtures.jax_lane``, as ``test_torch_port_codecs.py``
builds it), never the JAX package's own library, which its test workers
may be writing while another loads it: where the lane does not build, the
tests fail naming the compiler's error, and no Pillow decode stands in.
``test_torch_port_codecs.py`` holds the codecs over the whole matrix of
layouts.
"""

import os
import struct
import subprocess
import sys
import zlib
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images, native, png
from byogan_tpu_torch.data import pipeline as port_pipe
from byogan_tpu_torch.data.synthetic import encode_bmp, encode_png_filtered, render
from byogan_tpu_torch.native import build as native_build
from byogan_tpu_torch.serve import encode_png

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402


@pytest.fixture(scope="session")
def jax_lane(tmp_path_factory):
    """JAX's libpng/libjpeg lane, built once for all of the session's workers."""
    return fx.jax_lane(str(tmp_path_factory.getbasetemp().parent / "jax_native_lane"))


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _python_lane():
    """data/png.py with its Python ``_unfilter``: the library unloaded."""
    return mock.patch.object(native, "load_library", lambda: None)


def _filter_rows(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """PNG filter ``kind`` applied to unfiltered byte rows (h, stride)."""
    x = rows.astype(np.int16)
    left, up, up_left = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    left[:, bpp:], up[1:], up_left[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
    if kind == 4:
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    else:
        pred = (0, left, up, (left + up) >> 1)[kind]
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _png(samples: np.ndarray, depth: int, color: int, kind: int, chunks=()) -> bytes:
    """A PNG of ``samples`` (h, w, channels) at ``depth`` bits, every row
    under filter ``kind``; ``chunks`` go before IDAT (PLTE, tRNS)."""
    h, w, ch = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    elif depth == 8:
        rows = samples.astype(np.uint8).reshape(h, w * ch)
    else:  # pack low-depth samples, most significant first
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples[..., 0]
        groups = padded.reshape(h, -1, per)
        rows = sum((groups[..., i] << (depth * (per - 1 - i))) for i in range(per)).astype(np.uint8)
    bpp = max(1, depth * ch // 8)
    filtered = np.concatenate([np.full((h, 1), kind, np.uint8), _filter_rows(rows, bpp, kind)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return b"".join([b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", header), *[_chunk(k, d) for k, d in chunks],
                     _chunk(b"IDAT", zlib.compress(filtered.tobytes())), _chunk(b"IEND", b"")])


def _variant(name: str) -> bytes:
    r = np.random.default_rng(zlib.crc32(name.encode()))
    h, w = 13, 11
    if name.startswith("rgb8-f"):
        return encode_png_filtered(r.integers(0, 256, (h, w, 3), dtype=np.uint8), int(name[-1]))
    plte = r.integers(0, 256, (200, 3), dtype=np.uint8).tobytes()
    table = {
        "gray8": (r.integers(0, 256, (h, w, 1)), 8, 0, 4, ()),
        "gray-alpha8": (r.integers(0, 256, (h, w, 2)), 8, 4, 3, ()),
        "rgba8": (r.integers(0, 256, (h, w, 4)), 8, 6, 4, ()),
        "gray1": (r.integers(0, 2, (h, w, 1)), 1, 0, 4, ()),
        "gray2": (r.integers(0, 4, (h, w, 1)), 2, 0, 3, ()),
        "gray4": (r.integers(0, 16, (h, w, 1)), 4, 0, 1, ()),
        "palette8": (r.integers(0, 256, (h, w, 1)), 8, 3, 4, ((b"PLTE", plte),)),
        "palette8-trns": (r.integers(0, 200, (h, w, 1)), 8, 3, 2,
                          ((b"PLTE", plte), (b"tRNS", bytes(range(0, 200, 2))))),
        "palette4": (r.integers(0, 16, (h, w, 1)), 4, 3, 4, ((b"PLTE", plte[:48]),)),
        "palette2-trns": (r.integers(0, 4, (h, w, 1)), 2, 3, 3, ((b"PLTE", plte[:12]), (b"tRNS", b"\x00\x80"))),
        "rgb-trns": (r.integers(0, 256, (h, w, 3)), 8, 2, 4, ((b"tRNS", b"\x00\x10\x00\x20\x00\x30"),)),
        "rgb16": (r.integers(0, 65536, (h, w, 3)), 16, 2, 4, ()),
        "gray16": (r.integers(0, 65536, (h, w, 1)), 16, 0, 2, ()),
        "gray-alpha16": (r.integers(0, 65536, (h, w, 2)), 16, 4, 1, ()),
        "rgba16": (r.integers(0, 65536, (h, w, 4)), 16, 6, 3, ()),
    }
    samples, depth, color, kind, chunks = table[name]
    return _png(samples, depth, color, kind, chunks)


PNG_VARIANTS = [f"rgb8-f{k}" for k in range(5)] + [
    "gray8", "gray-alpha8", "rgba8", "gray1", "gray2", "gray4", "palette8", "palette8-trns", "palette4",
    "palette2-trns", "rgb-trns", "rgb16", "gray16", "gray-alpha16", "rgba16",
]


@pytest.mark.parametrize("name", PNG_VARIANTS)
def test_png_decode_matches_plain_decoder_and_jax(tmp_path, jax_lane, name):
    """The port's PNG decoder, data/png.py with the C unfilter and with the
    Python one, and JAX's libpng lane: one array on each row filter and PNG
    layout."""
    path = tmp_path / f"{name}.png"
    path.write_bytes(_variant(name))
    got = native.decode_image(str(path))
    assert got.dtype == np.uint8 and got.shape == (13, 11, 3)
    with _python_lane():
        plain = png.read_png(str(path))
    np.testing.assert_array_equal(png.read_png(str(path)), plain)  # the C byogan_unfilter
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, fx.jax_decode(jax_lane, str(path)))
    np.testing.assert_array_equal(images.read_image(str(path)), got)


@pytest.mark.parametrize("mode", ["RGB", "L", "LA", "RGBA", "P", "P-transparency"])
def test_pillow_written_png_matches_jax_and_pillow(tmp_path, jax_lane, mode):
    """Files Pillow writes, with its own filter choice (Paeth on smooth
    rows): the port's lanes equal JAX's and Pillow's decode."""
    r = np.random.default_rng(len(mode))
    base = render(r.random(9), 64) + r.integers(0, 3, (64, 64, 3), dtype=np.uint8)
    im = Image.fromarray(base)
    if mode.startswith("P"):
        im = im.quantize(64)
        if mode == "P-transparency":
            im.info["transparency"] = 3
    elif mode != "RGB":
        im = im.convert(mode)
    path = tmp_path / "pil.png"
    im.save(path, **({"transparency": 3} if mode == "P-transparency" else {}))
    got = native.decode_image(str(path))
    with _python_lane():
        np.testing.assert_array_equal(png.read_png(str(path)), got)
    np.testing.assert_array_equal(got, _pil_rgb(path))
    np.testing.assert_array_equal(got, fx.jax_decode(jax_lane, str(path)))


@pytest.mark.parametrize("bpp", [1, 3, 4, 6])
def test_native_unfilter_matches_python(bpp):
    r = np.random.default_rng(bpp)
    h, stride = 9, bpp * 7
    rows = r.integers(0, 256, (h, stride), dtype=np.uint8)
    for kind in range(5):
        raw = np.concatenate([np.full((h, 1), kind, np.uint8), _filter_rows(rows, bpp, kind)], axis=1).tobytes()
        np.testing.assert_array_equal(native.unfilter(raw, h, stride, bpp), png._unfilter(raw, h, stride, bpp))
        np.testing.assert_array_equal(native.unfilter(raw, h, stride, bpp), rows)
    mixed = r.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    mixed[:, 0] = r.integers(0, 5, h)
    np.testing.assert_array_equal(native.unfilter(mixed.tobytes(), h, stride, bpp),
                                  png._unfilter(mixed.tobytes(), h, stride, bpp))
    mixed[4, 0] = 7
    with pytest.raises(ValueError, match="unknown PNG row filter"):
        native.unfilter(mixed.tobytes(), h, stride, bpp)
    with pytest.raises(ValueError, match="unknown row filter 7"):
        png._unfilter(mixed.tobytes(), h, stride, bpp)


@pytest.mark.parametrize("kind", ["q92", "q50-444", "gray", "progressive"])
def test_jpeg_decode_matches_jax_and_pillow(tmp_path, jax_lane, kind):
    """The port's own JPEG decoder against JAX's libjpeg lane and Pillow's
    libjpeg-turbo, bit for bit."""
    r = np.random.default_rng(3)
    img = (render(r.random(9), 48)[:40] + r.normal(0, 4, (40, 48, 3))).clip(0, 255).astype(np.uint8)
    im = Image.fromarray(img)
    path = tmp_path / "a.jpg"
    if kind == "q92":
        im.save(path, quality=92)
    elif kind == "q50-444":
        im.save(path, quality=50, subsampling=0)
    elif kind == "gray":
        im.convert("L").save(path)
    else:
        im.save(path, progressive=True)
    got = native.decode_image(str(path))
    assert got.shape == (40, 48, 3)
    np.testing.assert_array_equal(got, _pil_rgb(path))
    np.testing.assert_array_equal(got, fx.jax_decode(jax_lane, str(path)))
    np.testing.assert_array_equal(images.read_image(str(path)), got)
    for shape in ((40, 48), (48, 40)):  # the right size expected, and a wrong one
        np.testing.assert_array_equal(images.read_image(str(path), shape), got)


def test_decode_batch_on_threads_equals_one_at_a_time(tmp_path):
    """A set of PNGs and JPEGs, and a BMP under a .png name (formats go by
    the first bytes): a batch on 1, 2 or 8 threads equals the files
    decoded one at a time.  Once a file's size is known, each PNG or JPEG
    takes one call of the library; a file of another size raises, naming it."""
    r = np.random.default_rng(4)
    images_dir = tmp_path / "prepared" / "set_5" / "images"
    images_dir.mkdir(parents=True)
    for i in range(8):
        img = render(r.random(9), 32)
        p = images_dir / f"{i}.{'jpg' if i % 3 == 0 else 'png'}"
        if i == 7:
            p.write_bytes(encode_bmp(img))
        elif i % 3 == 0:
            Image.fromarray(img).save(p, quality=85)
        else:
            p.write_bytes(encode_png_filtered(img, i % 5))
    ds = port_pipe.StageDataset(str(tmp_path), 5, cache_limit_bytes=0)
    one = np.stack([images.read_image(p) for p in ds.files])
    np.testing.assert_array_equal(one[7], images.decode_bmp((images_dir / "7.png").read_bytes()))
    idx = np.array([7, 0, 5, 1, 6, 2, 4, 3])
    for workers in (1, 2, 8):
        np.testing.assert_array_equal(ds.get_batch_uint8(idx, workers), one[idx])
    counting = mock.Mock(wraps=native.load_library())
    with mock.patch.object(native, "load_library", lambda: counting):
        fresh = port_pipe.StageDataset(str(tmp_path), 5, cache_limit_bytes=0)
        np.testing.assert_array_equal(fresh.get_batch_uint8(np.arange(7), 1), one[:7])
    assert counting.byogan_decode.call_count == 7 + 1  # the 7 PNG/JPEG files, and the first one's size
    Image.fromarray(render(r.random(9), 16)).save(images_dir / "small.png")
    ds = port_pipe.StageDataset(str(tmp_path), 5, cache_limit_bytes=0)
    with pytest.raises(OSError, match=r"small\.png: size \(16, 16, 3\) differs from the batch's"):
        ds.get_batch_uint8(np.array([0, 1, 8]), 2)


def test_encode_png_and_jpeg_round_trip(tmp_path, jax_lane):
    """The port's PNG writer read back by every decoder; its own JPEG
    encoder writes JAX's libjpeg lane's bytes and reads back as Pillow
    reads it."""
    r = np.random.default_rng(6)
    img = (render(r.random(9), 64)[:48] + r.integers(0, 4, (48, 64, 3), dtype=np.uint8)).astype(np.uint8)
    (tmp_path / "a.png").write_bytes(encode_png(img, 6))  # the port's PNG writer (serve.py)
    for decode in (native.decode_image, _pil_rgb, png.read_png):
        np.testing.assert_array_equal(decode(str(tmp_path / "a.png")), img)
    native.encode_jpeg(str(tmp_path / "a.jpg"), img, 92)
    assert (tmp_path / "a.jpg").read_bytes() == fx.jax_encode(jax_lane, img, 92, str(tmp_path / "jax.jpg"))
    got = native.decode_image(str(tmp_path / "a.jpg"))
    np.testing.assert_array_equal(got, _pil_rgb(tmp_path / "a.jpg"))
    err = np.abs(got.astype(int) - img)
    assert err.mean() < 3.0, err.mean()  # quality 92 on a smooth image with noise and one sharp edge
    native.encode_jpeg(str(tmp_path / "b.jpg"), img, 30)
    assert os.path.getsize(tmp_path / "b.jpg") < os.path.getsize(tmp_path / "a.jpg")
    with pytest.raises(ValueError, match="quality"):
        native.encode_jpeg(str(tmp_path / "c.jpg"), img, 0)
    with pytest.raises(ValueError, match="uint8"):
        native.encode_jpeg(str(tmp_path / "c.jpg"), img.astype(np.float32), 92)
    with pytest.raises(OSError, match="cannot open"):
        native.encode_jpeg(str(tmp_path / "no" / "c.jpg"), img, 92)


@pytest.mark.parametrize("shape", [(9, 7), (4, 4), (17, 30)])
def test_bmp_matches_pillow(tmp_path, shape):
    """24-bit (row padding at odd widths) and 32-bit BI_RGB as Pillow writes
    them; our writer's bitmaps; a top-down bitmap."""
    r = np.random.default_rng(shape[0])
    img = r.integers(0, 256, shape + (3,), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "rgb.bmp")
    Image.fromarray(np.dstack([img, img[..., :1]])).save(tmp_path / "rgba.bmp")
    (tmp_path / "ours.bmp").write_bytes(encode_bmp(img))
    for name in ("rgb.bmp", "rgba.bmp", "ours.bmp"):
        got = images.read_image(str(tmp_path / name))
        np.testing.assert_array_equal(got, img, err_msg=name)
        np.testing.assert_array_equal(got, _pil_rgb(tmp_path / name), err_msg=name)
    data = bytearray(encode_bmp(img[::-1]))
    data[22:26] = struct.pack("<i", -shape[0])  # negative height: rows top-down
    np.testing.assert_array_equal(images.decode_bmp(bytes(data)), img)


def test_unreadable_files_raise_naming_the_file(tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    webp = render(np.random.default_rng(3).random(9), 8)
    Image.fromarray(webp).save(tmp_path / "a.webp")  # a WebP decodes, as Pillow decodes it
    np.testing.assert_array_equal(images.read_image(str(tmp_path / "a.webp")), _pil_rgb(tmp_path / "a.webp"))
    (tmp_path / "b.png").write_bytes(b"GIF89a" + bytes(20))  # a GIF screen with no image: Pillow refuses it too
    with pytest.raises(Exception):
        _pil_rgb(tmp_path / "b.png")
    with pytest.raises(OSError, match=r"b\.png: decode failed: the GIF holds no image"):
        images.read_image(str(tmp_path / "b.png"))
    (tmp_path / "j2k.png").write_bytes(b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40))  # a JPEG 2000 signature
    with pytest.raises(OSError, match=r"j2k\.png: JPEG 2000 files are not read by the PyTorch port"):
        images.read_image(str(tmp_path / "j2k.png"))
    noise = bytes(np.random.default_rng(5).integers(0, 256, 64, dtype=np.uint8))
    (tmp_path / "noise.jpg").write_bytes(noise)
    with pytest.raises(OSError, match="cannot identify"):  # no Pillow plugin takes it
        _pil_rgb(tmp_path / "noise.jpg")
    with pytest.raises(OSError, match=r"noise\.jpg: unknown format"):
        images.read_image(str(tmp_path / "noise.jpg"))
    Image.fromarray(webp).convert("P").save(tmp_path / "p.bmp")  # a palette BMP decodes, as Pillow decodes it
    np.testing.assert_array_equal(images.read_image(str(tmp_path / "p.bmp")), _pil_rgb(tmp_path / "p.bmp"))
    (tmp_path / "c.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(10))
    with pytest.raises(OSError, match=r"c\.jpg: decode failed: the decoder refused the data"):
        images.read_image(str(tmp_path / "c.jpg"))


def test_lanes_without_the_libraries(tmp_path, monkeypatch):
    """One lane serves PNG and JPEG, and needs neither libpng nor libjpeg
    (the card's machine has neither): the build links zlib alone, the
    library asks the loader for no png_* or jpeg_* symbol, and both formats
    decode through it (never data/png.py) and JPEG encodes through it."""
    assert native_build.LIBS == ("-lz",)
    command = " ".join(native_build.command("lib.so"))
    assert "-lpng" not in command and "-ljpeg" not in command
    for source in native_build.SOURCES + native_build.HEADERS:
        text = source.read_text()
        assert "png.h" not in text and "jpeglib.h" not in text, source
    lib = native.load_library()
    undefined = subprocess.run(["nm", "-D", "--undefined-only", str(native_build.LIBRARY)], capture_output=True,
                               text=True, check=True).stdout.split()
    assert not [s for s in undefined if s.startswith(("png_", "jpeg_", "jpeg_std"))], undefined
    assert "inflate" in undefined
    img = render(np.random.default_rng(7).random(9), 24)
    (tmp_path / "a.png").write_bytes(encode_png_filtered(img, 4))
    Image.fromarray(img).save(tmp_path / "a.jpg")
    counting = mock.Mock(wraps=lib)
    monkeypatch.setattr(native, "load_library", lambda: counting)
    monkeypatch.setattr(png, "read_png", lambda *a: pytest.fail("data/png.py used"))
    np.testing.assert_array_equal(images.read_image(str(tmp_path / "a.png")), img)
    np.testing.assert_array_equal(images.read_image(str(tmp_path / "a.jpg")), _pil_rgb(tmp_path / "a.jpg"))
    native.encode_jpeg(str(tmp_path / "b.jpg"), img, 92)
    assert counting.byogan_decode.call_count == 4  # each file's size, then its pixels
    assert counting.byogan_encode_jpeg.call_count == 1


def test_a_failed_build_warns_once_naming_the_error(tmp_path, monkeypatch):
    """A build that fails raises the compiler's output, from load_library
    and from every decode or encode, each time it is asked: no lane is
    left to fall back on."""
    monkeypatch.setattr(native, "_LOADED", native._Loaded())
    monkeypatch.setattr(native_build, "BUILD", tmp_path)
    monkeypatch.setattr(native_build, "LIBRARY", tmp_path / "libbyogan_io.so")
    monkeypatch.setattr(native_build, "LIBS", ("-lz", "-lbyogan_no_such_library"))
    img = render(np.random.default_rng(7).random(9), 8)
    (tmp_path / "a.png").write_bytes(encode_png_filtered(img, 1))
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"did not build or load: g\+\+ .*failed:\n.*byogan_no_such_library"):
            native.load_library()
    with pytest.raises(RuntimeError, match="byogan_no_such_library"):
        images.read_image(str(tmp_path / "a.png"))
    with pytest.raises(RuntimeError, match="byogan_no_such_library"):
        native.encode_jpeg(str(tmp_path / "a.jpg"), img, 92)
    assert not (tmp_path / "libbyogan_io.so").exists()


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Processes that all force a build at once (test workers starting
    together) take turns under the lock; the library loads after, and no
    temporary file is left."""
    code = "from byogan_tpu_torch.native import build; build.build(force=True)"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root, stderr=subprocess.PIPE) for _ in range(3)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()
    assert not [f for f in os.listdir(native_build.BUILD) if f.startswith(".libbyogan_io.")]
    out = subprocess.run([sys.executable, "-c", "from byogan_tpu_torch.data import native; "
                          "print(native.load_library().byogan_abi_version())"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == str(native.ABI_VERSION), out.stderr


# --- the fault: a prepared set's non-PNG files ------------------------------


@pytest.fixture
def mixed_root(tmp_path):
    """A pyramid written by JAX's ``prepare_pyramid`` (Pillow's PNGs, 4-16
    px), then a JPEG and a BMP put into set_3 beside its 3 PNGs."""
    from byogan_tpu.data.prep import prepare_pyramid as jax_prepare

    root = tmp_path / "ds"
    root.mkdir()
    r = np.random.default_rng(8)
    for i in range(3):
        Image.fromarray(render(r.random(9), 40) + r.integers(0, 3, (40, 40, 3), dtype=np.uint8)).save(
            root / f"o{i}.png")
    jax_prepare(str(root), 4, 16, workers=2)
    images_dir = root / "prepared" / "set_3" / "images"
    Image.fromarray(render(r.random(9), 16)).save(images_dir / "photo.jpg", quality=90)
    (images_dir / "scan.bmp").write_bytes(encode_bmp(r.integers(0, 256, (16, 16, 3), dtype=np.uint8)))
    return str(root)


def _jax_pil_lane():
    """JAX's decode through Pillow: its native lane refuses BMP files."""
    return mock.patch("byogan_tpu.data.native.load_library", lambda: None)


def test_mixed_set_matches_jax(mixed_root):
    from byogan_tpu.data import pipeline as jax_pipe

    jds = jax_pipe.StageDataset(mixed_root, 3, cache_limit_bytes=0)
    pds = port_pipe.StageDataset(mixed_root, 3, cache_limit_bytes=0)
    assert len(pds) == len(jds) == 5
    assert [os.path.basename(f) for f in pds.files] == [os.path.basename(f) for f in jds.files]
    assert port_pipe.batches_per_epoch(len(pds), 2) == 2
    idx = np.array([4, 0, 3, 1, 2])
    with _jax_pil_lane():
        want = jds.get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(pds.get_batch_uint8(idx, workers), want)
    png_jpeg = np.array([3, 0, 1, 2])  # no BMP: JAX's libpng/libjpeg lane
    np.testing.assert_array_equal(pds.get_batch_uint8(png_jpeg), jds.get_batch_uint8(png_jpeg, workers=2))
    assert pds.maybe_cache(workers=3) is False
    cached = port_pipe.StageDataset(mixed_root, 3)
    assert cached.maybe_cache(workers=3)
    np.testing.assert_array_equal(cached.get_batch_uint8(idx), want)


def test_mixed_set_loader_matches_jax_for_any_worker_count(mixed_root):
    from byogan_tpu.data import pipeline as jax_pipe

    with _jax_pil_lane():
        jds = jax_pipe.StageDataset(mixed_root, 3, cache_limit_bytes=0)
        want = list(jax_pipe.make_stage_loader(jds, 2, seed=3, workers=1, device_normalize=True))
    assert len(want) == 2
    for limit in (0, 1 << 30):
        for workers in (1, 4):
            pds = port_pipe.StageDataset(mixed_root, 3, cache_limit_bytes=limit)
            got = list(port_pipe.make_stage_loader(pds, 2, seed=3, workers=workers))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    # stage 2 derived from set_3 when set_2 is absent: the JPEG and BMP downsampled too
    os.rename(os.path.join(mixed_root, "prepared", "set_2"), os.path.join(mixed_root, "prepared", "gone"))
    with _jax_pil_lane():
        jd = jax_pipe.open_stage_dataset(mixed_root, 2, cache_limit_bytes=0)
        want = jd.get_batch_uint8(np.arange(5), workers=1)
    pd = port_pipe.open_stage_dataset(mixed_root, 2, cache_limit_bytes=0)
    assert pd.derive_shift == 1
    np.testing.assert_array_equal(pd.get_batch_uint8(np.arange(5), 3), want)


def test_pack_stage_on_threads_and_a_webp_file_decodes(mixed_root):
    """``pack_stage`` on threads; then a WebP in the set is listed,
    decoded, cached and packed as JAX's Pillow lane decodes it (its native
    lane refuses WebP)."""
    from byogan_tpu.data import pipeline as jax_pipe

    path = port_pipe.pack_stage(mixed_root, 3, workers=3)
    ds = port_pipe.StageDataset(mixed_root, 3, cache_limit_bytes=0)
    packed = np.load(path)
    os.remove(path)
    np.testing.assert_array_equal(packed, ds.get_batch_uint8(np.arange(5), 2))
    Image.fromarray(render(np.random.default_rng(4).random(9), 16)).save(
        os.path.join(mixed_root, "prepared", "set_3", "images", "zz.webp"), quality=80)
    ds = port_pipe.StageDataset(mixed_root, 3, cache_limit_bytes=0)
    assert len(ds) == 6  # listed, as in JAX, and never skipped
    with _jax_pil_lane():
        want = jax_pipe.StageDataset(mixed_root, 3, cache_limit_bytes=0).get_batch_uint8(np.arange(6), workers=2)
    np.testing.assert_array_equal(ds.get_batch_uint8(np.arange(6), 2), want)
    cached = port_pipe.StageDataset(mixed_root, 3)
    assert cached.maybe_cache(workers=2)
    np.testing.assert_array_equal(cached.get_batch_uint8(np.arange(6), 2), want)
    path = port_pipe.pack_stage(mixed_root, 3, workers=3)
    np.testing.assert_array_equal(np.load(path), want)
    os.remove(path)
