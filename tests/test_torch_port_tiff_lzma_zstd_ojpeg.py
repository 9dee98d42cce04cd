"""The port's LZMA, ZSTD, old-style JPEG and 12-bit JPEG TIFF and the Pillow
lane's PNG past its image data, against Pillow, libtiff's codecs and the
JAX package, on the CPU.

The JAX package reads an original under a listed extension through
``Image.open(path).convert("RGB")``: LZMA and ZSTD TIFF through Pillow
12.1.0's libtiff 4.7.1 over liblzma 5.8.2 and libzstd 1.5.7, which the
card's machine lacks, so the port carries its own decoders
(``native/xz.cpp``, ``native/zstd.cpp``); old-style JPEG as libtiff's
OJPEG codec rebuilds one JPEG stream and hands its YCbCr, raw, to
TIFFRGBAImage; 12-bit gray JPEG through libjpeg-turbo's 12-bit decoder.
So every committed layout of ``fx.lzo_layouts`` and each seeded file is
held bit for bit to Pillow's ``convert("RGB")`` in both of the port's
lanes, each refusal (``fx.lzo_refusals``) to its reason with the file
named, and the decoders themselves to liblzma and libzstd through ctypes
(Pillow's own builds): on streams built to reach every LZMA2 chunk kind,
each .xz check kind, Delta, several blocks, sizes in a block header, and
Zstandard's raw, RLE and compressed blocks, levels, windows, checksums,
skippable and chained frames, whole (as lzma_code to its stream's end and
ZSTD_decompress) and as libtiff's LZMADecode and ZSTDDecode loops read a
strip (the same bytes, the same verdict), on seeded damaged streams too.
The PNGs whose chunks after the image data PngImageFile.load_end reads
(and a palette without PLTE, which Pillow shows black) are held to Pillow
in the Pillow lane and to the JAX package's libpng lane in the native
lane.  Then originals of these kinds under listed names through the
port's ``cli.prep`` against the JAX package's ``prepare_pyramid``, its
loader against the JAX loader's Pillow fallback and ``cli.project``
targets against the JAX CLI's.  Tolerance 0.
"""

import ctypes
import glob
import os
import re
import sys
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from byogan_tpu_torch.data import images, native
from byogan_tpu_torch.data import pipeline as port_pipe

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_codec_fixtures as fx  # noqa: E402
from test_torch_port_gif import _pillow, _same_as_pillow, _write  # noqa: E402

LAYOUTS = fx.lzo_layouts()
REFUSALS = fx.lzo_refusals()
PNGS = fx.lzo_png_layouts()
PNG_REFUSALS = fx.lzo_png_refusals()
LISTED = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


@pytest.fixture(scope="session")
def jax_lane(tmp_path_factory):
    """JAX's libpng/libjpeg lane, built once for all of the session's workers."""
    return fx.jax_lane(str(tmp_path_factory.getbasetemp().parent / "jax_native_lane"))


# --- liblzma and libzstd through ctypes, as libtiff drives them ---------------


def _pillow_lib(prefix: str) -> ctypes.CDLL:
    import PIL

    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs", prefix + "-*.so*"))
    return ctypes.CDLL(found[0])


class _LzmaStream(ctypes.Structure):
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t), ("total_in", ctypes.c_uint64),
                ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p), ("reserved", ctypes.c_void_p * 4),
                ("seek_pos", ctypes.c_uint64), ("reserved2", ctypes.c_uint64), ("reserved3", ctypes.c_size_t * 2),
                ("reserved4", ctypes.c_int * 2)]


class _ZstdBuffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_LZ = _pillow_lib("liblzma")
_LZ.lzma_stream_decoder.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_uint64, ctypes.c_uint32]
_LZ.lzma_code.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_int]
_LZ.lzma_end.argtypes = [ctypes.POINTER(_LzmaStream)]
_ZS = _pillow_lib("libzstd")
_ZS.ZSTD_createDStream.restype = ctypes.c_void_p
_ZS.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
_ZS.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
_ZS.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_ZstdBuffer), ctypes.POINTER(_ZstdBuffer)]
_ZS.ZSTD_decompressStream.restype = ctypes.c_size_t
_ZS.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
_ZS.ZSTD_decompress.restype = ctypes.c_size_t
_ZS.ZSTD_isError.argtypes = [ctypes.c_size_t]
_ZS.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
_ZS.ZSTD_getErrorName.restype = ctypes.c_char_p


def liblzma(data: bytes, occ=None, cap: int = 1 << 20):
    """liblzma's stream decoder on ``data`` (no flags, as libtiff opens it):
    with ``occ``, libtiff's LZMADecode loop into a strip of ``occ`` bytes
    (read where the buffer is full, whatever lzma_code returns after);
    else lzma_code(LZMA_FINISH) to the stream's end.  (read, bytes)."""
    s = _LzmaStream()
    assert _LZ.lzma_stream_decoder(ctypes.byref(s), 2 ** 64 - 1, 0) == 0
    size = cap if occ is None else occ
    src, out = ctypes.create_string_buffer(data, max(1, len(data))), ctypes.create_string_buffer(max(1, size))
    s.next_in, s.avail_in = ctypes.addressof(src), len(data)
    s.next_out, s.avail_out = ctypes.addressof(out), size
    while True:
        ret = _LZ.lzma_code(ctypes.byref(s), 0 if occ is not None else 3)
        if ret != 0 or (occ is not None and s.avail_out == 0):
            break
    _LZ.lzma_end(ctypes.byref(s))
    read = s.avail_out == 0 if occ is not None else ret == 1
    return read, out.raw[:size - s.avail_out]


def libzstd(data: bytes, occ=None, cap: int = 1 << 20):
    """libzstd on ``data``: with ``occ``, libtiff's ZSTDDecode loop over
    ZSTD_decompressStream into a strip of ``occ`` bytes; else
    ZSTD_decompress.  (read, bytes, libzstd's error or None)."""
    src = ctypes.create_string_buffer(data, max(1, len(data)))
    if occ is None:
        out = ctypes.create_string_buffer(cap)
        n = _ZS.ZSTD_decompress(out, cap, src, len(data))
        if _ZS.ZSTD_isError(n):
            return False, b"", _ZS.ZSTD_getErrorName(n).decode()
        return True, out.raw[:n], None
    d = _ZS.ZSTD_createDStream()
    _ZS.ZSTD_initDStream(d)
    out = ctypes.create_string_buffer(max(1, occ))
    ib, ob = _ZstdBuffer(ctypes.addressof(src), len(data), 0), _ZstdBuffer(ctypes.addressof(out), occ, 0)
    err = None
    while True:
        n = _ZS.ZSTD_decompressStream(d, ctypes.byref(ob), ctypes.byref(ib))
        if _ZS.ZSTD_isError(n):
            err = _ZS.ZSTD_getErrorName(n).decode()
            break
        if not (n != 0 and ib.pos < ib.size and ob.pos < ob.size):
            break
    _ZS.ZSTD_freeDStream(d)
    return err is None and ob.pos == occ, out.raw[:ob.pos], err


def _same_as_library(kind: str, data: bytes, occ=None, cap: int = 1 << 20) -> bool:
    """The port's decoder (``native.stream_decode``) reads ``data`` exactly
    where the library does, to the same bytes (a whole stream into ``cap``
    bytes).  True where it reads."""
    rc, got = native.stream_decode(kind, data, occ, cap)
    read, want = (liblzma if kind == "xz" else libzstd)(data, occ, cap)[:2]
    assert (rc == 0) == read, f"{kind} {occ}: the port returns {rc}, the library {'reads' if read else 'refuses'}"
    if read:
        assert got == want
    return read


# --- the committed files ----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LAYOUTS), ids=lambda n: n.split("/", 1)[1].rsplit(".", 1)[0])
def test_layout_matches_pillow(tmp_path, name):
    path = _write(tmp_path, os.path.basename(name).rsplit(".", 1)[0] + LISTED[len(name) % 5], LAYOUTS[name])
    assert _same_as_pillow(path, name)


@pytest.mark.parametrize("name", sorted(REFUSALS), ids=lambda n: n.rsplit(".", 1)[0])
def test_refused_file_raises_naming_the_file_and_the_verdict(tmp_path, name):
    """Each refusal names the file and the reason; Pillow refuses each too
    but an .xz block of a BCJ filter, old JPEG of RGB samples or of a frame
    taller than 65535 rows and a 12-bit JPEG of odd width, which it reads
    (the last two showing bytes libtiff never wrote)."""
    data, reason = REFUSALS[name]
    path = _write(tmp_path, name.rsplit(".", 1)[0] + ".jpg", data)
    reads = not isinstance(_pillow(path), Exception)
    assert reads == (name in ("lzma-bcj-x86.tif", "ojpeg-rgb.tif", "ojpeg-height-65537.tif",
                              "jpeg12-odd-width.tif")), name
    for lane in ("native", "pillow"):
        with pytest.raises(OSError, match=f"{re.escape(path)}: .*({reason})"):
            images.read_image(path, lane=lane)


def test_committed_fixtures_are_what_the_writers_make():
    """The committed layouts and refusals under ``tiff_lzma_zstd_ojpeg/``
    are what ``lzo_layouts`` and ``lzo_refusals`` write here, and the
    manifest records each (Pillow's RGB, or the reason beside Pillow's
    verdict); the card's originals, committed and written, and each, by its
    listed name, in the JAX package's prep of every slice's originals of
    the Pillow lane (``PILLOW_LANE_PREP``)."""
    made = {**LAYOUTS, **{f"{fx.LZO}/refused/{k}": v for k, (v, _) in REFUSALS.items()}}
    committed = fx.committed_lzo()
    card = [n for n in committed if n.startswith(f"{fx.LZO}/card/")]
    assert sorted(made) == sorted(n for n in committed if n not in card)
    assert sorted(os.path.basename(n) for n in card) == sorted(fx.LZO_COMMITTED_CARD)
    for name, data in made.items():
        assert committed[name] == data, name
    manifest = fx.load_manifest()
    files = manifest["files"]
    assert sorted(n for n in files if n.startswith(f"{fx.LZO}/")) == sorted(committed)
    for name in committed:
        assert ("refused" in files[name]) == ("/refused/" in name) and files[name]["sha256"] == fx.sha256(
            committed[name]), name
    assert sorted(manifest["lzo_card"]) == sorted(fx.lzo_card_originals())
    listed = sorted(fx.LZO_CARD.values())
    part = fx.pillow_lane_images(listed)
    assert len(part) == len(listed) and len(manifest[fx.PILLOW_LANE_PREP]) == 8
    assert all(set(part) <= set(d) for d in manifest[fx.PILLOW_LANE_PREP].values())
    assert sum(len(v) for n, v in committed.items() if n not in card) < 200_000


@pytest.mark.slow
def test_committed_card_originals_are_what_the_writers_make():
    """The committed 1024 px ZSTD and LZMA originals (libzstd at level 12
    takes some seconds)."""
    committed = fx.committed_lzo()
    for name, data in fx.lzo_card_committed().items():
        assert committed[name] == data, name


def test_committed_fixtures_decode_to_the_manifest():
    """``chip_smoke.py``'s "io fixtures" on this folder: each file decodes
    to the manifest's RGB in both lanes, each refusal raises its reason."""
    files = fx.load_manifest()["files"]
    n = 0
    for name, want in sorted(files.items()):
        if not name.startswith(f"{fx.LZO}/"):
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
    assert n >= 80


def test_card_originals_decode_to_the_manifest(tmp_path):
    """``chip_smoke.py``'s "io fixtures" on the card's originals of this
    slice: the written ones are the manifest's bytes, and each decodes to
    Pillow's RGB."""
    paths = fx.check_lzo_card(str(tmp_path), images.read_image)
    assert sorted(paths) == sorted(fx.LZO_CARD)


# --- the decoders against liblzma and libzstd --------------------------------------


def _xz_cases():
    """.xz streams of each LZMA2 chunk kind, check kind, Delta distance,
    block count, with sizes in the block header or not."""
    r = np.random.default_rng(2540)
    smooth = fx.smooth_scene(2541, 40, 60, cell=8, step=2).tobytes()
    noise = r.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    runs = bytes(np.repeat(r.integers(0, 4, 300), r.integers(1, 60, 300)).astype(np.uint8))
    out = {}
    for check in fx.XZ_CHECKS:
        out[f"check-{check}"] = fx.xz_of(smooth, check=check)
    for chunking in ("lzma", "uncompressed", "props", "state"):
        out[f"chunks-{chunking}"] = fx.xz_of(smooth + runs, chunking=chunking, check="crc64")
    for delta in (1, 3, 4, 256):
        out[f"delta-{delta}"] = fx.xz_of(smooth, delta=delta)
    out["blocks-3-sizes"] = fx.xz_of(smooth + noise, blocks=3, sizes=True, check="sha256")
    out["blocks-2"] = fx.xz_of(noise + smooth, blocks=2)
    out["preset-0-noise"] = fx.xz_of(noise, preset=0, check="none")
    out["preset-9-runs"] = fx.xz_of(runs, preset=9)
    out["empty"] = fx.xz_of(b"")
    out["big-chunks"] = fx.xz_of(bytes(3 << 20) + smooth)  # more than one 2 MiB LZMA2 chunk
    return out


XZ_CASES = _xz_cases()


@pytest.mark.parametrize("case", sorted(XZ_CASES))
def test_xz_streams_match_liblzma(case):
    """Whole, and as libtiff reads a strip of the data's size, of less and
    of more (more: the stream ends short, refused by both)."""
    data = XZ_CASES[case]
    assert _same_as_library("xz", data, cap=8 << 20)
    n = len(native.stream_decode("xz", data, cap=8 << 20)[1])
    for occ in {max(n, 1), max(1, n // 3), n + 1}:
        _same_as_library("xz", data, occ)


def test_xz_bcj_filters_are_refused_by_name():
    """liblzma decodes the BCJ family before LZMA2; libtiff never writes
    it: refused by name, each of x86 to RISC-V, where liblzma reads."""
    smooth = fx.smooth_scene(2542, 16, 16, cell=4, step=8).tobytes()
    for bcj in range(4, 12):
        data = fx.xz_of(smooth, bcj=bcj)
        assert liblzma(data, len(smooth))[0], bcj
        assert native.stream_decode("xz", data, len(smooth))[0] == -62, bcj


def _zstd_cases():
    """Zstandard data of libzstd's levels and strategies (raw, RLE and
    Huffman-coded literals in 1 and 4 streams, treeless repeats of each,
    single- and double-symbol tables through libzstd's fast loop, FSE
    tables predefined, RLE, compressed and repeated), windows, checksums,
    content sizes, and frames built here: raw and RLE blocks, RLE literals,
    Huffman literals of 12-bit codes and of four streams under 8 bytes
    (libzstd's plain four-stream loop, which its own encoder's output never
    reaches), a skippable frame between two frames, several frames."""
    r = np.random.default_rng(2543)
    smooth = fx.smooth_scene(2544, 64, 96, cell=16, step=2).tobytes()
    noise = r.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    text = b"".join(bytes(r.choice([b"the ", b"port ", b"reads ", b"zstd ", b"\n"])) for _ in range(3000))
    out = {}
    for level in (-7, -1, 1, 3, 9, 15, 19):
        out[f"level-{level}"] = fx.zstd_compress(smooth + text, level=level, checksum=level % 2)
    for strategy in range(1, 10):
        out[f"strategy-{strategy}"] = fx.zstd_compress(text + smooth[:9000], level=5, strategy=strategy)
    out["window-10"] = fx.zstd_compress(smooth, level=6, window_log=10, content_size=0)
    out["noise"] = fx.zstd_compress(noise, level=3)
    out["zeros"] = fx.zstd_compress(bytes(300000), level=3)
    out["big"] = fx.zstd_compress((smooth + text) * 8, level=4, checksum=1)
    out["raw-rle-blocks"] = fx.zstd_frame([("raw", noise[:500]), ("rle", b"\x07" * 1000), ("raw", noise[500:])],
                                          checksum=True)
    out["rle-only"] = fx.zstd_frame([("rle", b"\xa5" * 70000)], window_log=17)
    out["frames"] = fx.zstd_compress(text, level=3) + fx.zstd_compress(smooth, level=1)
    out["frame-skippable-frame"] = (fx.zstd_compress(text, level=3, checksum=1) + fx.skippable(b"meta", 7) +
                                    fx.zstd_compress(noise, level=1))
    out["skippable-first"] = fx.skippable(b"") + fx.zstd_compress(text, level=2)
    out["empty"] = fx.zstd_compress(b"", level=3)
    # four letters: few literals (one Huffman stream, an RLE FSE table), a
    # double-symbol table in libzstd's fast loop, treeless literals in 1 and
    # 4 streams and repeated FSE tables over blocks; long text: RLE literals
    for n, level in ((120, 1), (1500, 1), (20000, 1), (20000, 9)):
        out[f"letters-{n}-level-{level}"] = fx.zstd_compress(bytes(r.choice(list(b"abcd"), n)), level=level)
    out["text-level-19"] = fx.zstd_compress(text * 25, level=19)
    # literals built here: a 12-bit code (no fast loop), four streams of a
    # byte or two (no fast loop), RLE literals
    w12 = {k: 12 - k for k in range(12)}
    w12[12] = 1
    p = np.array([2.0 ** -(k + 1) for k in range(12)] + [2.0 ** -12])
    deep = r.choice(13, 900, p=p / p.sum()).astype(np.uint8).tobytes()
    for streams in (1, 4):
        out[f"huffman-12-bit-codes-{streams}"] = fx.zstd_frame(
            [("compressed", fx.zstd_literals(deep, w12, streams))], deep, checksum=True)
    two = r.integers(0, 2, 10, dtype=np.uint8).tobytes()
    out["huffman-tiny-streams"] = fx.zstd_frame([("compressed", fx.zstd_literals(two, {0: 1, 1: 1}, 4)),
                                                 ("raw", noise[:100])], two + noise[:100])
    out["rle-literals"] = fx.zstd_frame([("compressed", fx.zstd_literals(b"\x42" * 5000)),
                                         ("compressed", fx.zstd_literals(b"\x17" * 7))], b"\x42" * 5000 + b"\x17" * 7,
                                        checksum=True)
    return out


ZSTD_CASES = _zstd_cases()


@pytest.mark.parametrize("case", sorted(ZSTD_CASES))
def test_zstd_streams_match_libzstd(case):
    """Whole (ZSTD_decompress: every frame), and as libtiff reads a strip
    of the first frame's size, of less and of more."""
    data = ZSTD_CASES[case]
    assert _same_as_library("zstd", data, cap=8 << 20)
    first = len(native.stream_decode("zstd", data, 8 << 20)[1])  # a strip reads the first frame alone
    for occ in {max(1, first), max(1, first // 3), first + 7, 1}:
        _same_as_library("zstd", data, occ)


def test_zstd_dictionary_frame_is_refused_as_libzstd_refuses_it():
    """A frame that names a dictionary: libzstd without one says "Dictionary
    mismatch", whole and in a strip; the port names it."""
    frame = bytearray(fx.zstd_compress(b"abc" * 100, level=3))
    frame = bytes(frame[:4]) + bytes([frame[4] | 2]) + bytes(frame[5:6]) + b"\x2a\0" + bytes(frame[6:])
    assert libzstd(frame)[2] == "Dictionary mismatch" and libzstd(frame, 300)[2] == "Dictionary mismatch"
    assert native.stream_decode("zstd", frame)[0] == -63 and native.stream_decode("zstd", frame, 300)[0] == -63


def _damaged(r, data: bytes) -> bytes:
    """``data`` cut short, or 1 to 3 of its bits flipped."""
    b = bytearray(data)
    m = int(r.integers(0, 4))
    if m == 0:
        return bytes(b[:int(r.integers(0, len(b)))])
    for _ in range(m):
        i = int(r.integers(0, len(b)))
        b[i] ^= 1 << int(r.integers(0, 8))
    return bytes(b)


def _seeded_stream(r, kind: str):
    n = int(r.integers(1, 6000))
    k = int(r.integers(0, 3))
    data = (r.integers(0, 256, n, dtype=np.uint8) if k == 0 else
            np.cumsum(r.integers(-3, 4, n)).astype(np.uint8) if k == 1 else
            (np.arange(n) // int(r.integers(1, 40)) % 7).astype(np.uint8)).tobytes()
    if kind == "xz":
        coded = fx.xz_of(data, check=str(r.choice(list(fx.XZ_CHECKS))), delta=int(r.choice([0, 0, 1, 3])),
                         preset=int(r.integers(0, 10)), blocks=int(r.choice([1, 1, 2])))
    else:
        coded = fx.zstd_compress(data, level=int(r.integers(-5, 20)), checksum=int(r.integers(0, 2)),
                                 window_log=int(r.choice([10, 12, 17])))
    return data, coded


@pytest.mark.parametrize("kind", ["xz", "zstd"])
def test_seeded_damaged_streams_match_the_library(kind):
    """300 seeded streams, cut short or with bits flipped: the port reads
    a strip exactly where libtiff's loop over the library does, to the same
    bytes, and the whole stream likewise."""
    r = np.random.default_rng(2545 + (kind == "zstd"))
    reads = 0
    for _ in range(300):
        data, coded = _seeded_stream(r, kind)
        damaged = _damaged(r, coded)
        reads += _same_as_library(kind, damaged, len(data))
        _same_as_library(kind, damaged)
    assert reads > 10


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["xz", "zstd"])
def test_many_seeded_damaged_streams_match_the_library(kind):
    """5000 of each."""
    r = np.random.default_rng(2547 + (kind == "zstd"))
    for _ in range(5000):
        data, coded = _seeded_stream(r, kind)
        damaged = _damaged(r, coded)
        _same_as_library(kind, damaged, len(data))
        _same_as_library(kind, damaged)


# --- TIFFs written on the fly ------------------------------------------------------


@pytest.mark.parametrize("comp", ["lzma", "zstd"])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "I;16", "CMYK", "1"])
def test_pillow_written_tiffs_match_pillow(tmp_path, comp, mode):
    """Pillow's own LZMA and ZSTD writer (libtiff: Delta before LZMA2, no
    check) in each mode, in one strip and in strips of 5 rows, Predictor 1
    and 2 where libtiff takes it."""
    img = fx.smooth_scene(2550 + len(mode), 29, 41, cell=8, step=4)
    im = Image.fromarray(img)
    im = Image.fromarray(img[..., 0].astype(np.uint16) * 150) if mode == "I;16" else im.convert(mode)
    for pred in (1, 2) if mode != "1" else (1,):
        for rows in (29, 5):
            path = str(tmp_path / f"t{pred}{rows}.png")
            im.save(path, "TIFF", compression=comp, tiffinfo={317: pred, 278: rows})
            assert _same_as_pillow(path, f"{comp} {mode} {pred} {rows}")


def _seeded_tiff(r, comp: int) -> bytes:
    """A TIFF of LZMA or ZSTD strips or tiles (this module's writers), any
    of gray, RGB, 16-bit gray or a palette, Predictor 2 or not, often
    damaged."""
    h, w = int(r.integers(1, 40)), int(r.integers(1, 40))
    k = int(r.integers(0, 4))
    kw = {"predictor": int(r.choice([1, 2]))} if k != 3 else {}
    if r.random() < 0.3:
        kw["tile"] = (16, 16)
    elif r.random() < 0.5:
        kw["rows_per_strip"] = int(r.integers(1, h + 1))
    if comp == 34925:
        kw["compress"] = lambda b: fx.xz_of(b, check=str(r.choice(list(fx.XZ_CHECKS))), delta=int(r.choice([0, 1])))
    else:
        kw["compress"] = lambda b: fx.zstd_compress(b, level=int(r.integers(-3, 15)), checksum=int(r.integers(0, 2)))
    if k == 0:
        data = fx.tiff_bytes(r.integers(0, 256, (h, w)), 8, 1, compression=comp, **kw)
    elif k == 1:
        data = fx.tiff_bytes(np.cumsum(r.integers(-9, 10, (h, w, 3)), 1) % 256, compression=comp, **kw)
    elif k == 2:
        data = fx.tiff_bytes(r.integers(0, 65536, (h, w)), 16, 1, compression=comp, **kw)
    else:
        data = fx.tiff_bytes(r.integers(0, 16, (h, w)), 4, 3, compression=comp, colormap=r.integers(0, 65536, (16, 3)),
                             **kw)
    if r.random() < 0.3:  # damage a strip: bits flipped, past the header
        b = bytearray(data)
        for _ in range(int(r.integers(1, 4))):
            i = int(r.integers(8, max(9, len(b) - 200)))
            b[i] ^= 1 << int(r.integers(0, 8))
        data = bytes(b)
    return data


@pytest.mark.parametrize("comp", [34925, 50000])
def test_seeded_tiffs_match_pillow(tmp_path, comp):
    """120 seeded LZMA and 120 ZSTD TIFFs, some damaged: the port reads
    each as Pillow (libtiff) does, or refuses it naming the file where
    Pillow refuses it."""
    r = np.random.default_rng(2555 + comp % 7)
    read = sum(_same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", _seeded_tiff(r, comp)), f"file {t}")
               for t in range(120))
    assert read >= 60


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("route", ["tables", "header", "whole"])
@pytest.mark.parametrize("size", [(1, 1), (16, 16), (17, 33), (40, 9), (25, 70)])
def test_old_jpeg_matches_pillow(tmp_path, subsampling, route, size):
    """Old-style JPEG by each route at 1 x 1, 2 x 1 and 2 x 2 from Pillow's
    JPEG writer, one strip, and in strips of a restart interval each."""
    h, w = size
    img = fx.smooth_scene(2560 + h * w, h, w, cell=8, step=4)
    sub = ((1, 1), (2, 1), (2, 2))[subsampling]
    jpg = fx._pil_jpeg(img, quality=int(60 + 10 * subsampling), subsampling=subsampling)
    assert _same_as_pillow(_write(tmp_path, "one.png", fx.ojpeg_tiff(img, jpg, route, subsampling=sub)), "one")
    rows = 16 if subsampling == 2 else 8
    if route != "whole" and h > rows:
        jpg = fx._pil_jpeg(img, quality=75, subsampling=subsampling, restart_marker_rows=1)
        assert _same_as_pillow(_write(tmp_path, "strips.jpg", fx.ojpeg_tiff(img, jpg, route, rows, subsampling=sub)),
                               "strips")


def test_old_jpeg_gray_and_tags_match_pillow(tmp_path):
    """Gray old JPEG (MinIsBlack and MinIsWhite alike: Pillow keys old JPEG
    as YCbCr), YCbCr coefficients and reference black and white of the
    file's own, a JPEGRestartInterval tag, the YCbCrSubsampling tag left
    out (2 x 2 by default) and one the stream corrects."""
    img = fx.smooth_scene(2565, 30, 44, cell=8, step=4)
    gray = img[..., 1]
    gj = fx._pil_jpeg(gray, quality=80)
    for photometric in (0, 1):
        for route in ("tables", "header"):
            data = fx.ojpeg_tiff(gray, gj, route, photometric=photometric)
            assert _same_as_pillow(_write(tmp_path, f"g{photometric}{route}.png", data), route)
    jpg = fx._pil_jpeg(img, quality=85, subsampling=2)
    tags = {529: (5, [2990, 10000, 5870, 10000, 1140, 10000]), 532: (5, [15, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}
    for name, data in {"coefficients": fx.ojpeg_tiff(img, jpg, "tables", tags=tags),
                       "no-subsampling-tag": fx.ojpeg_tiff(img, jpg, "tables", subsampling=None),
                       "corrected": fx.ojpeg_tiff(img, jpg, "header", subsampling=(1, 1)),
                       "restart-tag": fx.ojpeg_tiff(img, jpg, "tables", tags={515: (3, [0])})}.items():
        assert _same_as_pillow(_write(tmp_path, f"{name}.jpg", data), name)


@pytest.mark.parametrize("scale", [0.1, 1.0, 6.0])
@pytest.mark.parametrize("size", [(1, 2), (16, 16), (24, 30), (33, 64), (9, 40)])
def test_12_bit_gray_jpeg_matches_pillow(tmp_path, scale, size):
    """12-bit gray JPEG TIFFs of even width (``fx.jpeg12_tiff``: one strip,
    strips, tiles, JPEGTables, restart markers), values up to 4095, which
    Pillow's I;16 -> RGB clips at 255, and dark ones under it."""
    h, w = size
    r = np.random.default_rng(2570 + h + w)
    for top in (250, 4095):
        scan = (np.cumsum(r.integers(-60, 61, (h, w)), axis=1) % top).astype(np.uint16)
        for layout, kw in (("one", {}), ("strips", {"rows_per_strip": 8}), ("tiles", {"tile": (16, 16)}),
                           ("shared", {"rows_per_strip": 8, "shared_tables": True}), ("restart", {"restart": 2})):
            data = fx.jpeg12_tiff(scan, scale, **kw)
            assert _same_as_pillow(_write(tmp_path, f"{layout}{top}.png", data), f"{layout} {top}")


def _seeded_jpeg_tiff(r, kind: str) -> bytes:
    """An old-style JPEG TIFF (Pillow's JPEG of any quality and sampling,
    this module's of 4 x 1, 4 x 2, 1 x 2, 4 x 4 and 2 x 2 factors, gray; by
    any route, one strip or a strip a restart interval, restart markers in
    one strip) or a 12-bit gray JPEG TIFF of any size, scale and layout."""
    h, w = int(r.integers(1, 60)), int(r.integers(1, 60))
    img = fx.smooth_scene(int(r.integers(0, 1 << 20)), h, w, cell=int(r.choice([2, 8, 16])),
                          step=int(r.choice([1, 4, 16])))
    route = str(r.choice(["tables", "header", "whole"]))
    if kind == "jpeg12":
        scan = np.cumsum(r.integers(-50, 51, (h, w + w % 2)), axis=1) % int(r.choice([256, 1000, 4096]))
        kw = [{}, {"rows_per_strip": int(r.integers(1, h + 1))}, {"tile": (16, 16)},
              {"rows_per_strip": 8, "shared_tables": True}][int(r.integers(0, 4))]
        if r.random() < 0.3:
            kw["restart"] = int(r.integers(1, 4))
        return fx.jpeg12_tiff(scan, float(r.choice([0.1, 0.5, 1, 3, 8])), **kw)
    k = int(r.integers(0, 3))
    if k == 0:
        ss = int(r.integers(0, 3))
        kw, rows = {}, None
        if route != "whole" and r.random() < 0.5 and h > (16 if ss == 2 else 8):
            kw["restart_marker_rows"], rows = 1, 16 if ss == 2 else 8
        elif r.random() < 0.3:
            kw["restart_marker_blocks"] = int(r.integers(1, 5))
        jpg = fx._pil_jpeg(img, quality=int(r.integers(5, 101)), subsampling=ss, **kw)
        return fx.ojpeg_tiff(img, jpg, route, rows, subsampling=((1, 1), (2, 1), (2, 2))[ss])
    if k == 1:
        samp = [[(4, 1), (1, 1), (1, 1)], [(4, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)], [(4, 4), (1, 1), (1, 1)],
                [(2, 2), (1, 1), (1, 1)]][int(r.integers(0, 5))]
        return fx.ojpeg_tiff(img, fx.jpeg_from_blocks(h, w, samp, int(r.integers(0, 1 << 20))), route,
                             subsampling=samp[0])
    gray = img[..., 0]
    return fx.ojpeg_tiff(gray, fx._pil_jpeg(gray, quality=int(r.integers(5, 101))), route,
                         photometric=int(r.integers(0, 2)))


@pytest.mark.parametrize("kind", ["ojpeg", "jpeg12"])
def test_seeded_jpeg_tiffs_match_pillow(tmp_path, kind):
    """100 seeded old-style and 100 seeded 12-bit JPEG TIFFs: each read as
    Pillow reads it, or refused naming the file where Pillow refuses it (4
    x 4 luma with two chroma blocks: more blocks an MCU than libjpeg's 10)."""
    r = np.random.default_rng(2576 + (kind == "jpeg12"))
    read = sum(_same_as_pillow(_write(tmp_path, f"f{t}{LISTED[t % 5]}", _seeded_jpeg_tiff(r, kind)), f"file {t}")
               for t in range(100))
    assert read >= 80


def test_12_bit_jpeg_libtiff_wrote_matches_pillow(tmp_path):
    """One strip of 12-bit gray JPEG by libtiff's own writer (its 12-bit
    libjpeg-turbo encoder, tables in JPEGTables), at several qualities."""
    r = np.random.default_rng(2575)
    for q in (40, 75, 95):
        scan = (np.cumsum(r.integers(-9, 10, (20, 26)), axis=1) % 500).astype(np.uint16)
        assert _same_as_pillow(_write(tmp_path, f"q{q}.webp", fx.libtiff_jpeg12(scan, q)), f"quality {q}")


# --- PNG past its image data: the Pillow lane ------------------------------------------


@pytest.mark.parametrize("name", sorted(PNGS), ids=lambda n: n.split("/", 1)[1][:-4])
def test_png_past_the_image_data_matches_each_lane(tmp_path, jax_lane, name):
    """The Pillow lane reads as Pillow (PngImageFile.load_end walks the
    chunks after the image data; a palette without PLTE reads black); the
    native lane as the JAX package's libpng lane, which refuses a palette
    without PLTE and a file cut inside its last CRC as libpng does."""
    path = _write(tmp_path, os.path.basename(name), PNGS[name])
    want = _pillow(path)
    assert not isinstance(want, Exception), want
    np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=name)
    try:
        native_want = fx.jax_decode(jax_lane, path)
    except OSError:
        with pytest.raises(OSError, match=re.escape(path)):
            images.read_image(path)
        assert "no-plte" in name or "cut-in-last-crc" in name
        return
    np.testing.assert_array_equal(images.read_image(path), native_want, err_msg=name)


@pytest.mark.parametrize("name", sorted(PNG_REFUSALS), ids=lambda n: n[:-4])
def test_png_chunk_after_the_image_data_refused_as_pillow_refuses_it(tmp_path, name):
    """A chunk after the image data cut short ("Truncated File Read") or
    one PngStream's handler raises on: Pillow refuses the file, and the
    Pillow lane names the file and the verdict; the native lane stops at
    the image's last byte, as libpng's lane does."""
    data, reason = PNG_REFUSALS[name]
    path = _write(tmp_path, name, data)
    assert isinstance(_pillow(path), Exception)
    with pytest.raises(OSError, match=f"{re.escape(path)}: .*{reason}"):
        images.read_image(path, lane="pillow")
    images.read_image(path)


def test_png_chunks_after_the_image_data_in_seeded_files(tmp_path):
    """120 seeded PNGs: chunks after the image data of every kind
    PngStream handles and unknown ones, of good and bad lengths, cut short
    anywhere, palettes with and without PLTE: the Pillow lane as Pillow."""
    r = np.random.default_rng(2580)
    kinds = [b"tEXt", b"zTXt", b"iTXt", b"gAMA", b"cHRM", b"sRGB", b"pHYs", b"tRNS", b"iCCP", b"eXIf", b"IHDR",
             b"PLTE", b"IDAT", b"acTL", b"fcTL", b"fdAT", b"abCd", b"IEND"]
    read = 0
    for t in range(120):
        h, w = int(r.integers(1, 9)), int(r.integers(1, 9))
        color = int(r.choice([0, 2, 3]))
        px = r.integers(0, 256, (h, w, 3 if color == 2 else 1))
        base = fx.png_bytes(px, 8, color, chunks=[(b"PLTE", bytes(range(48)))] if color == 3 and r.random() < 0.5
                            else ())
        chunks = []
        for _ in range(int(r.integers(0, 4))):
            kind = kinds[int(r.integers(0, len(kinds)))]
            body = bytes(r.integers(0, 256, int(r.integers(0, 40)), dtype=np.uint8))
            if kind == b"zTXt" and r.random() < 0.5:
                body = b"k\0\0" + fx.zlib.compress(body)
            chunks.append((kind, body))
        data = fx.png_after(base, chunks)
        if r.random() < 0.3:
            data = data[:int(r.integers(len(base) - 12, len(data) + 1))]
        path = _write(tmp_path, f"s{t}.png", data)
        want = _pillow(path)
        if isinstance(want, Exception):
            with pytest.raises(OSError, match=re.escape(path)):
                images.read_image(path, lane="pillow")
            continue
        np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=f"file {t}")
        read += 1
    assert read >= 40


# --- prep, the loader and cli.project ----------------------------------------------


def _originals(root: str) -> str:
    """Small originals of each kind under listed names: a ZSTD RGB TIFF
    with Predictor 2 (.png), an LZMA RGB TIFF of Delta (.jpg), an old-style
    JPEG 2 x 2 TIFF (.bmp), a 12-bit gray JPEG TIFF (.webp), a PNG with
    text after its image data (.jpeg) and a palette PNG without PLTE
    (.png)."""
    os.makedirs(root)
    img = fx.source_image(2590, 40, 48)
    scan = img[..., 1].astype(np.int64) * 3
    data = {
        "a.png": fx.tiff_bytes(img, compression=50000, predictor=2, rows_per_strip=16,
                               compress=lambda b: fx.zstd_compress(b, level=9, checksum=1)),
        "b.jpg": fx.tiff_bytes(img, compression=34925, compress=lambda b: fx.xz_of(b, delta=3)),
        "c.bmp": fx.ojpeg_tiff(img, fx.port_jpeg(img, 88), "header"),
        "d.webp": fx.jpeg12_tiff(scan, 1.0, rows_per_strip=16, shared_tables=True),
        "e.jpeg": fx.png_after(fx.png_bytes(img, 8, 2), [(b"tEXt", b"Comment\0after the image")]),
        "f.png": fx.png_bytes((img[..., :1] // 32).astype(np.int64), 4, 3),
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
        assert names == sorted(os.listdir(os.path.join(jax_root, sub))) and len(names) == 6
        for name in names:
            with Image.open(os.path.join(jax_root, sub, name)) as im:
                np.testing.assert_array_equal(read_png(os.path.join(port_root, sub, name)), np.asarray(im),
                                              err_msg=f"set_{k} {name}")
            n += 1
    assert n == 24


def test_loader_reads_these_formats_as_jax_pillow_fallback(tmp_path):
    """A prepared set of ZSTD, LZMA, old-style and 12-bit JPEG TIFFs under
    listed names: the port's loader reads each as the JAX package's
    ``StageDataset`` does through its Pillow fallback, on threads."""
    from byogan_tpu.data import pipeline as jax_pipe

    root = tmp_path / "ds"
    folder = root / "prepared" / "set_3" / "images"
    folder.mkdir(parents=True)
    r = np.random.default_rng(2591)
    for i in range(8):
        img = fx.smooth_scene(2592 + i, 16, 16, cell=4, step=8)
        data = (fx.tiff_bytes(img, compression=50000, predictor=2, compress=lambda b: fx.zstd_compress(b, level=3))
                if i % 4 == 0 else fx.tiff_bytes(img, compression=34925, compress=lambda b: fx.xz_of(b))
                if i % 4 == 1 else fx.ojpeg_tiff(img, fx._pil_jpeg(img, quality=85, subsampling=2), "tables")
                if i % 4 == 2 else fx.jpeg12_tiff(r.integers(0, 300, (16, 16)), 0.5))
        (folder / f"image-{i}.{('png', 'jpg', 'webp', 'bmp')[i % 4]}").write_bytes(data)
    idx = np.array([5, 0, 3, 1, 4, 2, 7, 6])
    with mock.patch("byogan_tpu.data.native.load_library", lambda: None):
        want = jax_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers=2)
    for workers in (1, 3):
        np.testing.assert_array_equal(
            port_pipe.StageDataset(str(root), 3, cache_limit_bytes=0).get_batch_uint8(idx, workers), want)


def test_project_targets_given_in_these_formats_match_jax_cli(tmp_path):
    """``cli.project``'s ``load_target`` on ``face.tif`` as ZSTD, LZMA,
    old-style JPEG and 12-bit JPEG, and ``face.png`` with text after its
    image data, at the stage's size: the arrays the JAX CLI builds
    (``Image.open(path).convert("RGB")``)."""
    from byogan_tpu_torch.cli.project import load_target

    img = fx.source_image(2593, 32, 32)
    files = {"zstd.tif": fx.tiff_bytes(img, compression=50000, compress=lambda b: fx.zstd_compress(b, level=5)),
             "lzma.tif": fx.tiff_bytes(img, compression=34925, predictor=2, compress=lambda b: fx.xz_of(b)),
             "ojpeg.tif": fx.ojpeg_tiff(img, fx._pil_jpeg(img, quality=90, subsampling=1), "whole",
                                        subsampling=(2, 1)),
             "jpeg12.tif": fx.jpeg12_tiff(img[..., 0].astype(np.int64) * 4, 1.0),
             "face.png": fx.png_after(fx.png_bytes(img, 8, 2), [(b"zTXt", b"k\0\0" + fx.zlib.compress(b"text"))])}
    for name, data in files.items():
        path = _write(tmp_path, name, data)
        with Image.open(path) as im:  # byogan_tpu/cli/project.py's target
            want = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(load_target(path, 32), want, err_msg=path)
        np.testing.assert_array_equal(images.read_image(path, lane="pillow"), want, err_msg=path)


def test_every_libtiff_codec_reads_the_same_samples(tmp_path):
    """One table of compressions: strips of LZMA, ZSTD, LZW and Deflate
    data of the same samples under Predictor 2 read to the same pixels."""
    img = fx.smooth_scene(2594, 20, 30, cell=8, step=4)
    got = []
    for comp, kw in ((34925, {"compress": lambda b: fx.xz_of(b)}), (50000, {"compress": fx.zstd_compress}),
                     (5, {}), (8, {}), (32946, {})):
        data = fx.tiff_bytes(img, compression=comp, predictor=2, rows_per_strip=7, **kw)
        got.append(images.read_image(_write(tmp_path, f"{comp}.png", data)))
    for g in got:
        np.testing.assert_array_equal(g, img)
