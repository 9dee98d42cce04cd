"""Fixtures of the port's JPEG, PNG and WebP codecs, and the writers that make them.

    python tests/torch_port_codec_fixtures.py

writes ``tests/data/torch_port_codecs/``: small JPEG files (Pillow's, and
this module's own for the samplings Pillow cannot write), Adam7 and
16-bit PNGs, WebP files under ``webp/``, the JPEG kinds under ``kinds/``
and ``manifest.json``.  For each file the manifest records the SHA-256 of
its bytes and of the RGB that libjpeg-turbo, libpng or libwebp decodes
from it: the JAX package's native lane and Pillow, which must agree (for
WebP, Pillow is the JAX package's lane).  For each seeded source image it
records the SHA-256 of the pixels and of the JAX lane's JPEG bytes at
every quality of ``QUALITIES``.  For each lossy WebP it records the
SHA-256 of the Y, U and V planes libwebp's ``WebPDecodeYUV`` gives, and
for the WebP originals of ``webp/card/`` the SHA-256 of every image the
JAX package's ``prepare_pyramid`` makes of them (4-512 px).  The JPEG
kinds (4:4:0, arithmetic coding, progressive files left for block
smoothing, CMYK, YCCK, lossless) are held to Pillow's RGB, the lane of the
JAX package that reads them all, and their entries record what its native
lane makes of each (``native_lane``: the same RGB, the samples it puts
apart, or its return code); the prep of their originals of
``kinds/card/`` is recorded as the WebP one is.  Under ``pillow/`` are
the files the JAX package reads through Pillow and the port once refused
or read otherwise: a BMP of every layout Pillow reads (``bmp/``) and of
those it refuses (``bmp/refused/``, with Pillow's error and the reason the
port names), 16-bit gray PNGs (``gray16/``, with both lanes' RGB) and JPEGs
whose dequantised coefficients leave 16 bits (``idct/``, Pillow's RGB
beside the native lane's), and originals for the card's prep
(``card/``).  The machine with the card
has none of these libraries, so ``chip_smoke.py`` holds the port's
codecs to these hashes there; ``tests/test_torch_port_codecs.py``
rebuilds the manifest here and asserts that it is the committed one.

The WebP files are written once, by Pillow and by the system's libwebp
(``libwebp.so.7``, through ctypes: its advanced API reaches the simple
filter, segments, partitions and sharpness, which Pillow cannot set), and
committed: the manifest is rebuilt from the committed bytes, since another
libwebp build may encode other ones.  Writing them needs Pillow with WebP
and ``libwebp.so.7``; reading them, Pillow alone.  The JPEG kinds are
committed too, written by the system's libjpeg (``torch_port_jpeg_writer.c``,
compiled by ``jpeg_writer``: arithmetic coding, YCCK, CMYK without an
Adobe marker, 4:4:0), Pillow (CMYK, progressive) and this module's
lossless writer; ``tests/test_torch_port_jpeg_kinds.py`` holds them to
what those writers make here.  So are the files under ``pillow/``
(``tests/test_torch_port_lanes.py`` holds them to this module's BMP and
PNG writers and the system libjpeg's coefficient writer).

At import this module needs numpy alone: Pillow, libwebp, libjpeg and the
JAX lane (built from ``byogan_tpu/native/byogan_io.cpp`` into a directory
the caller names, never the JAX package's own library) are reached inside
the functions that need them.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_codecs")
MANIFEST = os.path.join(FIXTURES, "manifest.json")
WEBP = "webp"  # the WebP files' folder under FIXTURES
#: WebP originals for the card's prep: name -> (kind, height, width)
WEBP_CARD = {"lossy-512.webp": ("lossy", 512, 512), "lossy-640x480.webp": ("lossy", 480, 640),
             "lossless-512.webp": ("lossless", 512, 512), "alpha-448x320.webp": ("alpha", 320, 448),
             "lossy-1024.webp": ("lossy", 1024, 1024)}
#: the card's training sets: a lossy and a lossless WebP at each stage's size
WEBP_TRAIN_SIZES = tuple(4 << k for k in range(8))
QUALITIES = (1, 50, 75, 92, 100)
#: the seeded sources of the encoder: name -> (seed, height, width)
SOURCES = {"src-16x16": (101, 16, 16), "src-23x37": (102, 23, 37), "src-61x50": (103, 61, 50)}


def sha256(data) -> str:
    return hashlib.sha256(bytes(data) if not isinstance(data, np.ndarray) else data.tobytes()).hexdigest()


def source_image(seed: int, h: int, w: int) -> np.ndarray:
    """A seeded uint8 RGB image with smooth regions, edges and noise, made
    with integer arithmetic alone (no libm), so every machine's numpy makes
    the same pixels: a coarse random grid upsampled bilinearly in integers,
    plus noise."""
    r = np.random.default_rng(seed)
    gh, gw = h // 8 + 2, w // 8 + 2
    grid = r.integers(0, 256, (gh, gw, 3), dtype=np.int64)
    y = np.arange(h, dtype=np.int64)
    x = np.arange(w, dtype=np.int64)
    y0, fy = y // 8, (y % 8)[:, None, None]
    x0, fx = x // 8, (x % 8)[None, :, None]
    a, b = grid[y0][:, x0], grid[y0][:, x0 + 1]
    c, d = grid[y0 + 1][:, x0], grid[y0 + 1][:, x0 + 1]
    smooth = ((8 - fy) * ((8 - fx) * a + fx * b) + fy * ((8 - fx) * c + fx * d)) // 64
    noise = r.integers(-12, 13, (h, w, 3), dtype=np.int64)
    return np.clip(smooth + noise, 0, 255).astype(np.uint8)


# --- PNG --------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def filter_rows(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
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


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    per = 8 // depth  # low-depth samples, most significant first
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = samples[..., 0]
    groups = padded.reshape(h, -1, per)
    return sum((groups[..., i] << (depth * (per - 1 - i))) for i in range(per)).astype(np.uint8)


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def png_bytes(samples: np.ndarray, depth: int, color: int, interlace: bool = False, chunks=(),
              kinds=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of ``samples`` (h, w, channels) at ``depth`` bits, Adam7 where
    ``interlace``; row r of each pass (or of the image) under filter
    ``kinds[r % len(kinds)]``; ``chunks`` (kind, data) go before IDAT."""
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = []
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub, depth)
        filtered = {kind: filter_rows(rows, bpp, kind) for kind in set(kinds)}
        for r in range(rows.shape[0]):
            kind = kinds[r % len(kinds)]
            raw.append(bytes([kind]) + filtered[kind][r].tobytes())
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    return b"".join([b"\x89PNG\r\n\x1a\n", png_chunk(b"IHDR", header), *[png_chunk(k, d) for k, d in chunks],
                     png_chunk(b"IDAT", zlib.compress(b"".join(raw))), png_chunk(b"IEND", b"")])


# --- JPEG written here ------------------------------------------------------

# One table of each kind, every symbol the same length: DC 0-11 in 4 bits,
# AC's 162 run/size symbols in 8 bits.
_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def _dht(index: int, length: int, symbols: List[int]) -> bytes:
    bits = [0] * 16
    bits[length - 1] = len(symbols)
    body = bytes([index]) + bytes(bits) + bytes(symbols)
    return b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, k: int) -> None:
        self.acc = (self.acc << k) | (value & ((1 << k) - 1))
        self.n += k
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8

    def flush(self) -> bytes:
        if self.n:
            self.put(0x7F, 8 - self.n)
        return bytes(self.out)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _category(v: int) -> Tuple[int, int]:
    n = abs(v).bit_length()
    return n, (v if v >= 0 else v - 1 + (1 << n)) if n else 0


def jpeg_from_blocks(h: int, w: int, sampling: List[Tuple[int, int]], seed: int) -> bytes:
    """A baseline JPEG (JFIF, so YCbCr where 3 components) with the
    components' (h, v) sampling factors ``sampling``, whose quantised
    coefficients are seeded random numbers: low-frequency terms of a few
    steps, a DC that wanders.  For the samplings Pillow cannot write
    (4:1:1, 4:4:0, luma at 2x2 beside chroma at 2x1...)."""
    r = np.random.default_rng(seed)
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = _ceil(w, 8 * hmax), _ceil(h, 8 * vmax)
    quant = r.integers(4, 17, 64)
    ncomp = len(sampling)
    head = b"\xff\xd8\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    head += b"\xff\xdb" + struct.pack(">H", 67) + b"\x00" + bytes(int(q) for q in quant)
    sof = struct.pack(">BHHB", 8, h, w, ncomp) + b"".join(bytes([i + 1, (sh << 4) | sv, 0])
                                                          for i, (sh, sv) in enumerate(sampling))
    head += b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
    head += _dht(0x00, 4, _DC_SYMBOLS) + _dht(0x10, 8, _AC_SYMBOLS)
    sos = bytes([ncomp]) + b"".join(bytes([i + 1, 0x00]) for i in range(ncomp)) + b"\x00\x3f\x00"
    head += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    dc_code = {s: (i, 4) for i, s in enumerate(_DC_SYMBOLS)}
    ac_code = {s: (i, 8) for i, s in enumerate(_AC_SYMBOLS)}
    bw = _BitWriter()
    preds, dcs = [0] * ncomp, [0] * ncomp

    def block(c: int) -> None:
        dcs[c] = int(np.clip(dcs[c] + r.integers(-3, 4), -12, 12))
        coef = np.zeros(64, np.int64)
        coef[0] = dcs[c]
        coef[1:10] = r.integers(-4, 5, 9) * (r.random(9) < 0.6)
        diff = int(coef[0]) - preds[c]
        preds[c] = int(coef[0])
        n, bits = _category(diff)
        bw.put(*dc_code[n])
        if n:
            bw.put(bits, n)
        run = 0
        for k in range(1, 64):
            v = int(coef[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bw.put(*ac_code[0xF0])
                run -= 16
            n, bits = _category(v)
            bw.put(*ac_code[(run << 4) | n])
            bw.put(bits, n)
            run = 0
        if run:
            bw.put(*ac_code[0x00])

    if ncomp == 1:  # one component: a scan of single blocks over its own extent
        sh, sv = sampling[0]
        for _ in range(_ceil(_ceil(w * sh, hmax), 8) * _ceil(_ceil(h * sv, vmax), 8)):
            block(0)
    else:
        for _ in range(mcux * mcuy):
            for c, (sh, sv) in enumerate(sampling):
                for _ in range(sh * sv):
                    block(c)
    return head + bw.flush() + b"\xff\xd9"


def optimal_huffman(counts: Dict[int, int]) -> Tuple[List[int], List[int]]:
    """A Huffman table for symbols of the given counts, as libjpeg's
    jpeg_gen_optimal_table builds it (T.81 K.2, codes of 16 bits or
    fewer, no code of all ones): (bits[1..16], symbols in code order)."""
    freq = [0] * 257
    for sym, n in counts.items():
        freq[sym] = n
    freq[256] = 1  # a reserved code point, so no code is all ones
    size, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if freq[i]]
        c1 = min(live, key=lambda i: (freq[i], -i))
        live.remove(c1)
        if not live:
            break
        c2 = min(live, key=lambda i: (freq[i], -i))
        freq[c1] += freq[c2]
        freq[c2] = 0
        for c in (c1, c2):
            size[c] += 1
            while others[c] >= 0:
                c = others[c]
                size[c] += 1
        c = c1
        while others[c] >= 0:
            c = others[c]
        others[c] = c2
    bits = [0] * 33
    for n in size:
        if n:
            bits[n] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    symbols = [s for n in range(1, 33) for s in range(256) if size[s] == n]
    return bits[1:17], symbols


def _huffman_codes(bits: List[int], symbols: List[int]) -> Dict[int, Tuple[int, int]]:
    """symbol -> (code, length) of a table given as DHT carries it."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _lossless_differences(x: np.ndarray, psv: int, first_rows: np.ndarray, initial: int) -> np.ndarray:
    """The differences a lossless encoder sends for the samples ``x``
    (int64, already reconstructed as the decoder will hold them), rows
    where ``first_rows`` predicted as a scan's first row."""
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = (None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv].copy()
    pred[:, 0] = rb[:, 0]  # the first column from above
    pred[first_rows, 1:] = ra[first_rows, 1:]  # a first row from the left
    pred[first_rows, 0] = initial
    d = (x - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def jpeg_lossless(planes: List[np.ndarray], psv: int, pt: int = 0, sampling: Optional[List[Tuple[int, int]]] = None,
                  restart_rows: int = 0, jfif: bool = False, adobe: Optional[int] = None, ids=None,
                  precision: int = 8, wrap: Tuple[Tuple[int, int, int], ...] = ()) -> bytes:
    """A lossless JPEG (SOF3, Huffman) of the components' sample planes
    (uint8 2-D arrays, each of its component's downsampled size, all in one
    interleaved scan) with predictor ``psv`` (1-7) and point transform
    ``pt``, written as T.81's Annex H and libjpeg-turbo's jclossls.c /
    jcdiffct.c do: the first row predicted from its left neighbour, the
    first column from the sample above, 2^(P-Pt-1) at the top left, and
    after every ``restart_rows`` MCU rows an RST marker and the first-row
    rules again; one Huffman table, optimal for the differences.  ``wrap``
    lists (component, y, x) whose difference is sent 32768 apart (the
    category-16 code, which wraps modulo 2^16 back to the same 8-bit
    sample).  ``jfif``, ``adobe`` (its transform) and ``ids`` (the
    component identifiers, 1, 2, 3... by default) set what a decoder reads
    the colour space from.  Component 0 is sampled at the largest factors
    and sets the image's size."""
    ncomp = len(planes)
    sampling = sampling or [(1, 1)] * ncomp
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    h, w = planes[0].shape
    ids = ids or list(range(1, ncomp + 1))
    mcux, mcuy = _ceil(w, hmax), _ceil(h, vmax)
    diffs = []
    for c, (p, (sh, sv)) in enumerate(zip(planes, sampling)):
        x = p.astype(np.int64) >> pt
        for cc, y, i in wrap:
            if cc == c:
                x[y, i] += 32768
        rows = np.arange(x.shape[0])
        first = rows == 0 if not restart_rows else rows % (restart_rows * sv) == 0
        d = np.zeros((mcuy * sv, mcux * sh), np.int64)  # the MCUs' padding sends 0
        d[:x.shape[0], :x.shape[1]] = _lossless_differences(x, psv, first, 1 << (precision - pt - 1))
        diffs.append(d)
    # the differences in scan order: MCU rows, MCUs, components, their rows and columns
    order = [np.stack([d[my * sv:(my + 1) * sv, :].reshape(sv, mcux, sh).transpose(1, 0, 2).reshape(mcux, sv * sh)
                       for my in range(mcuy)]) for d, (sh, sv) in zip(diffs, sampling)]
    seq = np.concatenate(order, axis=2)  # (mcuy, mcux, samples an MCU)
    mag = np.abs(seq)
    cat = sum((mag >= (1 << k)).astype(np.int64) for k in range(16))  # the bit length; 32768 is category 16
    extra = np.where(seq >= 0, seq, seq - 1 + (1 << cat)) & ((1 << cat) - 1)
    bits, symbols = optimal_huffman({int(k): int(n) for k, n in zip(*np.unique(cat, return_counts=True))})
    codes = _huffman_codes(bits, symbols)
    head = b"\xff\xd8"
    if jfif:
        head += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    if adobe is not None:
        head += b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe)
    sof = struct.pack(">BHHB", precision, h, w, ncomp) + b"".join(
        bytes([ids[i], (sh << 4) | sv, 0]) for i, (sh, sv) in enumerate(sampling))
    head += b"\xff\xc3" + struct.pack(">H", 2 + len(sof)) + sof
    dht = bytes([0x00]) + bytes(bits) + bytes(symbols)
    head += b"\xff\xc4" + struct.pack(">H", 2 + len(dht)) + dht
    if restart_rows:
        head += b"\xff\xdd" + struct.pack(">HH", 4, restart_rows * mcux)
    sos = bytes([ncomp]) + b"".join(bytes([ids[i], 0x00]) for i in range(ncomp)) + bytes([psv, 0, pt])
    head += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    code = np.zeros(17, np.int64)
    length = np.zeros(17, np.int64)
    for sym, (c, n) in codes.items():
        code[sym], length[sym] = c, n
    # each sample's code, then its extra bits (none for categories 0 and 16)
    values = np.stack([code[cat], extra], -1).reshape(mcuy, -1)
    lengths = np.stack([length[cat], np.where(cat == 16, 0, cat)], -1).reshape(mcuy, -1)
    out = bytearray(head)
    step = restart_rows or mcuy
    for at in range(0, mcuy, step):
        if at:
            out += bytes([0xFF, 0xD0 + (at // step - 1) % 8])
        out += _pack_bits(values[at:at + step].reshape(-1), lengths[at:at + step].reshape(-1))
    return bytes(out + b"\xff\xd9")


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """The low ``lengths[i]`` bits of each ``values[i]`` (at most 16),
    most significant first, as entropy-coded bytes: padded with ones to a
    whole byte, 0xFF followed by a stuffed 0x00."""
    shifts = lengths[:, None] - 1 - np.arange(16)[None, :]
    bits = (values[:, None] >> np.maximum(shifts, 0)) & 1
    stream = bits[shifts >= 0].astype(np.uint8)
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.uint8)])
    data = np.packbits(stream).tobytes()
    return data.replace(b"\xff", b"\xff\x00")


# --- the fixtures -----------------------------------------------------------


def _pil_jpeg(img: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    im = Image.fromarray(img)
    if kw.pop("gray", False):
        im = im.convert("L")
    im.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _png_samples(seed: int, h: int, w: int, ch: int, top: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, top, (h, w, ch))


def png_fixture(samples: np.ndarray, depth: int, color: int, palette: bytes = b"", **kw):
    """A PNG's bytes and the RGB libpng's lane makes of it, worked out from
    the samples: 16 bits cut to the high byte, palette entries looked up,
    alpha dropped, low-depth gray scaled, gray repeated (Pillow's convert("RGB") clips 16-bit gray
    instead, so it is no reference for those)."""
    chunks = ((b"PLTE", palette),) if palette else ()
    v = samples >> 8 if depth == 16 else samples
    if color == 0 and depth < 8:  # low-depth gray scaled to 8 bits
        v = v * (255 // ((1 << depth) - 1))
    if color == 3:
        rgb = np.frombuffer(palette, np.uint8).reshape(-1, 3)[v[..., 0]]
    elif color in (0, 4):
        rgb = np.repeat(v[..., :1], 3, axis=2)
    else:
        rgb = v[..., :3]
    return png_bytes(samples, depth, color, chunks=chunks, **kw), rgb.astype(np.uint8)


def fixtures() -> Dict[str, Tuple[bytes, object]]:
    """Every fixture file's name, its bytes (written anew, by Pillow for
    most JPEGs) and the RGB it must decode to, or None where Pillow's
    decode decides."""
    s = {n: source_image(*p) for n, p in SOURCES.items()}
    a, b, c = s["src-16x16"], s["src-23x37"], s["src-61x50"]
    plte = bytes(np.random.default_rng(7).integers(0, 256, 3 * 4, dtype=np.uint8))
    jpegs = {
        "q92-420.jpg": _pil_jpeg(c, quality=92),
        "q50-422-17x33.jpg": _pil_jpeg(c[:17, :33], quality=50, subsampling=1),
        "q75-444.jpg": _pil_jpeg(b, quality=75, subsampling=0),
        "q100-420-1x1.jpg": _pil_jpeg(a[:1, :1], quality=100),
        "gray-q85.jpg": _pil_jpeg(b, quality=85, gray=True),
        "progressive-q80.jpg": _pil_jpeg(c, quality=80, progressive=True),
        "restarts-q90.jpg": _pil_jpeg(c, quality=90, restart_marker_blocks=2),
        "adobe-rgb.jpg": _pil_jpeg(b, quality=90, keep_rgb=True, subsampling=0),
        "h4v1-411.jpg": jpeg_from_blocks(19, 45, [(4, 1), (1, 1), (1, 1)], 11),
    }
    pngs = {
        "adam7-rgb8.png": png_fixture(c[:29, :31].astype(np.int64), 8, 2, interlace=True),
        "adam7-gray16.png": png_fixture(_png_samples(8, 13, 17, 1, 65536), 16, 0, interlace=True),
        "adam7-palette2.png": png_fixture(_png_samples(9, 11, 7, 1, 4), 2, 3, plte, interlace=True),
        "rgba16.png": png_fixture(_png_samples(10, 9, 14, 4, 65536), 16, 6, kinds=(4, 3, 1)),
    }
    return {**{k: (v, None) for k, v in jpegs.items()}, **pngs}


def jax_lane(build_dir: str) -> ctypes.CDLL:
    """The JAX package's native lane (libpng, libjpeg), compiled from its
    source into ``build_dir`` once under a file lock: its ``byogan_decode``
    and ``byogan_encode_jpeg``."""
    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, "libbyogan_io_jax.so")
    with open(os.path.join(build_dir, "libbyogan_io_jax.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib):
            tmp = lib + f".{os.getpid()}.tmp"
            src = os.path.join(ROOT, "byogan_tpu", "native", "byogan_io.cpp")
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp, "-lpng", "-ljpeg", "-lz",
                            "-lpthread"], check=True, capture_output=True)
            os.replace(tmp, lib)
    handle = ctypes.CDLL(lib)
    ip = ctypes.POINTER(ctypes.c_int)
    handle.byogan_decode.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ip, ip]
    handle.byogan_encode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_void_p] + [ctypes.c_int] * 3
    return handle


#: libjpeg's J_COLOR_SPACE values
JCS = {"gray": 1, "rgb": 2, "ycbcr": 3, "cmyk": 4, "ycck": 5}


class _JpegOptions(ctypes.Structure):  # struct byogan_jpeg_options of torch_port_jpeg_writer.c
    _fields_ = [(n, ctypes.c_int) for n in ("quality", "arith", "progressive", "restart_interval", "restart_rows",
                                            "jpeg_space", "adobe", "jfif", "dc_l", "dc_u", "ac_k")] + [
        ("sampling", ctypes.c_int * 8)]


def jpeg_writer(build_dir: str) -> ctypes.CDLL:
    """``tests/torch_port_jpeg_writer.c`` over the system's libjpeg,
    compiled into ``build_dir`` once under a file lock."""
    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, "libbyogan_jpeg_writer.so")
    with open(os.path.join(build_dir, "libbyogan_jpeg_writer.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib):
            tmp = lib + f".{os.getpid()}.tmp"
            src = os.path.join(ROOT, "tests", "torch_port_jpeg_writer.c")
            subprocess.run(["gcc", "-O2", "-shared", "-fPIC", src, "-o", tmp, "-ljpeg"], check=True,
                           capture_output=True)
            os.replace(tmp, lib)
    handle = ctypes.CDLL(lib)
    handle.byogan_write_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(_JpegOptions)]
    handle.byogan_write_coefficients.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_ushort), ctypes.POINTER(ctypes.POINTER(ctypes.c_short)), ctypes.c_int, ctypes.c_int]
    return handle


def libjpeg_file(lib: ctypes.CDLL, samples: np.ndarray, path: str, space: str = "ycbcr", sampling=(),
                 **options) -> bytes:
    """``samples`` (RGB (h, w, 3), gray (h, w, 1) or CMYK (h, w, 4) uint8)
    written by the system's libjpeg as a ``space`` file (a key of ``JCS``)
    with the components' (h, v) factors ``sampling`` and ``options`` (the
    fields of ``struct byogan_jpeg_options``: arith, progressive, quality,
    restart_interval, adobe, jfif, dc_l...): the file's bytes."""
    o = _JpegOptions(*([-1] * 11))
    for k, v in options.items():
        setattr(o, k, int(v))
    o.jpeg_space = JCS[space]
    for i, (sh, sv) in enumerate(sampling):
        o.sampling[2 * i], o.sampling[2 * i + 1] = sh, sv
    samples = np.ascontiguousarray(samples, np.uint8)
    in_space = {1: JCS["gray"], 3: JCS["rgb"], 4: JCS["cmyk"]}[samples.shape[2]]
    if lib.byogan_write_jpeg(path.encode(), samples.ctypes.data, samples.shape[0], samples.shape[1], in_space,
                             ctypes.byref(o)) != 0:
        raise OSError(f"{path}: cannot be written")
    with open(path, "rb") as f:
        return f.read()


def jax_decode(lib: ctypes.CDLL, path: str) -> np.ndarray:
    """``path`` through the JAX lane (named by its extension, as its
    ``byogan_decode`` dispatches), uint8 RGB."""
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.byogan_decode(path.encode(), None, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise OSError(f"{path}: the JAX lane returned {rc}")
    out = np.zeros((h.value, w.value, 3), np.uint8)
    rc = lib.byogan_decode(path.encode(), out.ctypes.data, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise OSError(f"{path}: the JAX lane returned {rc}")
    return out


def jax_encode(lib: ctypes.CDLL, img: np.ndarray, quality: int, path: str) -> bytes:
    img = np.ascontiguousarray(img)
    rc = lib.byogan_encode_jpeg(path.encode(), img.ctypes.data, img.shape[0], img.shape[1], quality)
    if rc != 0:
        raise OSError(f"{path}: the JAX lane's JPEG encode returned {rc}")
    with open(path, "rb") as f:
        return f.read()


def pil_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


# --- WebP -------------------------------------------------------------------


def smooth_scene(seed: int, h: int, w: int, cell: int = 64, step: int = 1) -> np.ndarray:
    """A seeded uint8 RGB scene without noise, which WebP compresses well:
    a random grid of ``cell`` px upsampled bilinearly in integers, then
    posterised to multiples of ``step``."""
    r = np.random.default_rng(seed)
    grid = r.integers(0, 256, (h // cell + 2, w // cell + 2, 3), dtype=np.int64)
    y, x = np.arange(h, dtype=np.int64), np.arange(w, dtype=np.int64)
    y0, fy = y // cell, (y % cell)[:, None, None]
    x0, fx = x // cell, (x % cell)[None, :, None]
    a, b = grid[y0][:, x0], grid[y0][:, x0 + 1]
    c, d = grid[y0 + 1][:, x0], grid[y0 + 1][:, x0 + 1]
    img = ((cell - fy) * ((cell - fx) * a + fx * b) + fy * ((cell - fx) * c + fx * d)) // (cell * cell)
    return (img // step * step).astype(np.uint8)


def palette_image(seed: int, h: int, w: int, colors: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    return r.integers(0, 256, (colors, 3), dtype=np.uint8)[r.integers(0, colors, (h, w))]


def with_alpha(img: np.ndarray, seed: Optional[int] = None) -> np.ndarray:
    """RGBA: alpha 0-252, seeded noise or (no seed) a diagonal ramp, so
    transparent pixels keep their RGB only where the encoder is asked for
    it (``exact``)."""
    h, w = img.shape[:2]
    if seed is None:
        a = ((np.arange(h)[:, None] + np.arange(w)[None, :]) * 252 // (h + w - 1)).astype(np.uint8)[..., None]
    else:
        a = np.random.default_rng(seed).integers(0, 253, (h, w, 1), dtype=np.uint8)
    return np.concatenate([img, a], axis=2)


def pil_webp(img: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kw)
    return buf.getvalue()


def pil_webp_animation(frames: List[np.ndarray], **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(buf, format="WEBP", save_all=True, append_images=ims[1:], duration=80, **kw)
    return buf.getvalue()


_WEBP_CONFIG = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int) for n in (
    "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments", "sns_strength",
    "filter_strength", "filter_sharpness", "filter_type", "autofilter", "alpha_compression", "alpha_filtering",
    "alpha_quality", "pass_", "show_compressed", "preprocessing", "partitions", "partition_limit",
    "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact", "use_delta_palette",
    "use_sharp_yuv", "qmin", "qmax")]
_ENCODER_ABI = 0x020F  # WEBP_ENCODER_ABI_VERSION of /usr/include/webp/encode.h (libwebp 1.2.4)


def libwebp() -> ctypes.CDLL:
    """The system's libwebp (``libwebp.so.7``) with the signatures this
    module calls: the advanced encoder and ``WebPDecodeYUV``."""
    lib = ctypes.CDLL("libwebp.so.7")
    p, ip, u8p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8)
    lib.WebPConfigInitInternal.argtypes = [p, ctypes.c_int, ctypes.c_float, ctypes.c_int]
    lib.WebPValidateConfig.argtypes = [p]
    lib.WebPPictureInitInternal.argtypes = [p, ctypes.c_int]
    lib.WebPPictureImportRGB.argtypes = lib.WebPPictureImportRGBA.argtypes = [p, p, ctypes.c_int]
    lib.WebPEncode.argtypes = [p, p]
    lib.WebPPictureFree.argtypes = lib.WebPMemoryWriterInit.argtypes = lib.WebPMemoryWriterClear.argtypes = [p]
    lib.WebPDecodeYUV.restype = u8p
    lib.WebPDecodeYUV.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ip, ip, ctypes.POINTER(u8p),
                                  ctypes.POINTER(u8p), ip, ip]
    lib.WebPFree.argtypes = [p]
    return lib


class _WebPPicture(ctypes.Structure):  # struct WebPPicture of encode.h
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int), ("width", ctypes.c_int),
                ("height", ctypes.c_int), ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p),
                ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2), ("argb", ctypes.c_void_p),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3), ("writer", ctypes.c_void_p),
                ("custom_ptr", ctypes.c_void_p), ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int), ("progress_hook", ctypes.c_void_p),
                ("user_data", ctypes.c_void_p), ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
                ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2)]


class _WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32)]


def webp_encode(lib: ctypes.CDLL, img: np.ndarray, quality: float = 75.0, **options) -> bytes:
    """``img`` (RGB or RGBA uint8) encoded by libwebp's advanced API: a
    ``WebPConfig`` at ``quality`` with ``options`` set (filter_type,
    segments, partitions, filter_sharpness, filter_strength, lossless...)."""
    config = type("WebPConfig", (ctypes.Structure,), {"_fields_": _WEBP_CONFIG})()
    if not lib.WebPConfigInitInternal(ctypes.byref(config), 0, float(quality), _ENCODER_ABI):
        raise RuntimeError("libwebp: WebPConfigInit failed (another encoder ABI?)")
    for k, v in options.items():
        setattr(config, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(config)):
        raise ValueError(f"libwebp refuses the options {options}")
    img = np.ascontiguousarray(img)
    pic, out = _WebPPicture(), _WebPMemoryWriter()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), _ENCODER_ABI):
        raise RuntimeError("libwebp: WebPPictureInit failed")
    pic.width, pic.height, pic.use_argb = img.shape[1], img.shape[0], int(config.lossless)
    ch = img.shape[2]
    (lib.WebPPictureImportRGBA if ch == 4 else lib.WebPPictureImportRGB)(ctypes.byref(pic), img.ctypes.data,
                                                                        img.shape[1] * ch)
    lib.WebPMemoryWriterInit(ctypes.byref(out))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.addressof(out)
    try:
        if not lib.WebPEncode(ctypes.byref(config), ctypes.byref(pic)):
            raise RuntimeError(f"libwebp: WebPEncode failed with error {pic.error_code}")
        return ctypes.string_at(out.mem, out.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(out))


def webp_yuv(lib: ctypes.CDLL, data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libwebp's ``WebPDecodeYUV`` of a still lossy file: Y, U and V."""
    w, h, stride, uv_stride = (ctypes.c_int() for _ in range(4))
    u, v = ctypes.POINTER(ctypes.c_uint8)(), ctypes.POINTER(ctypes.c_uint8)()
    y = lib.WebPDecodeYUV(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(u), ctypes.byref(v),
                          ctypes.byref(stride), ctypes.byref(uv_stride))
    if not y:
        raise OSError("libwebp: WebPDecodeYUV failed")
    H, W = h.value, w.value
    uh, uw = (H + 1) // 2, (W + 1) // 2

    def plane(ptr, rows, cols, pitch):
        return np.ctypeslib.as_array(ptr, (rows * pitch,)).reshape(rows, pitch)[:, :cols].copy()

    try:
        return plane(y, H, W, stride.value), plane(u, uh, uw, uv_stride.value), plane(v, uh, uw, uv_stride.value)
    finally:
        lib.WebPFree(ctypes.cast(y, ctypes.c_void_p))


def riff_chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def webp_animation(canvas: Tuple[int, int], frames: List[Tuple[int, int, bytes]], background: int = 0xFF20C040) -> bytes:
    """An animated WebP built by hand: ``frames`` of (x, y, a still WebP
    file's bytes), each drawn at (x, y) (even) on a ``canvas`` (h, w)
    whose ANIM background colour decoders ignore."""
    h, w = canvas
    le24 = lambda v: struct.pack("<I", v)[:3]  # noqa: E731
    body = [riff_chunk(b"VP8X", bytes([0x02 | 0x10, 0, 0, 0]) + le24(w - 1) + le24(h - 1)),
            riff_chunk(b"ANIM", struct.pack("<IH", background, 0))]
    for x, y, still in frames:
        fh, fw = webp_size(still)
        head = le24(x // 2) + le24(y // 2) + le24(fw - 1) + le24(fh - 1) + le24(80) + b"\x00"
        body.append(riff_chunk(b"ANMF", head + still[12:]))
    payload = b"WEBP" + b"".join(body)
    return b"RIFF" + struct.pack("<I", len(payload)) + payload


def webp_size(still: bytes) -> Tuple[int, int]:
    """(h, w) of a simple-format file's VP8 or VP8L bitstream."""
    tag, data = still[12:16], still[20:]
    if tag == b"VP8L":
        bits = int.from_bytes(data[1:5], "little")
        return ((bits >> 14) & 0x3FFF) + 1, (bits & 0x3FFF) + 1
    return int.from_bytes(data[8:10], "little") & 0x3FFF, int.from_bytes(data[6:8], "little") & 0x3FFF


def webp_fixtures() -> Dict[str, bytes]:
    """Every WebP fixture's name (under ``webp/``) and bytes, encoded anew:
    lossy by Pillow (qualities, methods 0 and 6, odd sizes, alpha), this
    module's own lossy variants through libwebp's advanced API, lossless
    (a photo-like image for the predictor, cross-colour and subtract-green
    transforms, palettes of 2, 4, 16 and 200 colours, RGBA with exact RGB,
    1x1), animations (Pillow's, and a hand-built one whose first frame is
    offset), then the card's originals and training sets."""
    lib = libwebp()
    photo = source_image(201, 61, 50)
    scene = smooth_scene(202, 61, 50, cell=16)
    out = {
        "lossy-q1-m0.webp": pil_webp(photo, quality=1, method=0),
        "lossy-q50-m6.webp": pil_webp(photo, quality=50, method=6),
        "lossy-q75.webp": pil_webp(photo, quality=75),
        "lossy-q95.webp": pil_webp(photo, quality=95),
        "lossy-q100-m0.webp": pil_webp(photo, quality=100, method=0),
        "lossy-1x1.webp": pil_webp(photo[:1, :1], quality=80),
        "lossy-17x33.webp": pil_webp(photo[:17, :33], quality=80, method=6),
        "lossy-300x257.webp": pil_webp(smooth_scene(203, 300, 257, cell=32), quality=70),
        "lossy-alpha.webp": pil_webp(with_alpha(scene, 204), quality=80),
        "own-simple-filter.webp": webp_encode(lib, photo, 60, filter_type=0, filter_strength=60, autofilter=0),
        "own-segments4.webp": webp_encode(lib, scene, 60, segments=4, sns_strength=100),
        "own-partitions8.webp": webp_encode(lib, smooth_scene(205, 96, 80, cell=16), 60, partitions=3),
        "own-sharpness7.webp": webp_encode(lib, photo, 40, filter_type=1, filter_sharpness=7, filter_strength=80,
                                           autofilter=0),
        "own-filter-off.webp": webp_encode(lib, photo, 60, filter_strength=0, autofilter=0),
        "lossless-photo.webp": pil_webp(photo, lossless=True),
        "lossless-palette2.webp": pil_webp(palette_image(206, 23, 37, 2), lossless=True),
        "lossless-palette4.webp": pil_webp(palette_image(207, 23, 37, 4), lossless=True),
        "lossless-palette16.webp": pil_webp(palette_image(208, 23, 37, 16), lossless=True),
        "lossless-palette200.webp": pil_webp(palette_image(209, 40, 44, 200), lossless=True),
        "lossless-rgba-exact.webp": pil_webp(with_alpha(photo[:29, :31], 210), lossless=True, exact=True),
        "lossless-1x1.webp": pil_webp(photo[:1, :1], lossless=True),
        "anim-pillow.webp": pil_webp_animation([smooth_scene(211 + i, 30, 40, cell=8) for i in range(3)],
                                               quality=70),
        "anim-offset.webp": webp_animation((24, 24), [(4, 6, pil_webp(source_image(214, 16, 16), lossless=True)),
                                                       (0, 0, pil_webp(source_image(215, 24, 24), quality=60))]),
    }
    out = {f"{WEBP}/{k}": v for k, v in out.items()}
    for i, (name, (kind, h, w)) in enumerate(sorted(WEBP_CARD.items())):
        if kind == "lossless":
            img = smooth_scene(220 + i, h, w, cell=128, step=32)
            data = pil_webp(img, lossless=True)
        else:
            img = smooth_scene(220 + i, h, w, cell=128)
            data = pil_webp(with_alpha(img) if kind == "alpha" else img, quality=75)
        out[f"{WEBP}/card/{name}"] = data
    for size in WEBP_TRAIN_SIZES:
        cell = max(2, size // 4)
        out[f"{WEBP}/train/{size}-lossy.webp"] = pil_webp(smooth_scene(240 + size, size, size, cell=cell), quality=80)
        out[f"{WEBP}/train/{size}-lossless.webp"] = pil_webp(
            smooth_scene(250 + size, size, size, cell=cell, step=32), lossless=True)
    return out


def committed_webp() -> Dict[str, bytes]:
    """The committed WebP fixtures: name (under ``webp/``) -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, WEBP)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def is_animated(data: bytes) -> bool:
    return data[12:16] == b"VP8X" and bool(data[20] & 0x02)


def is_lossy(data: bytes) -> bool:
    """A still file whose frame is VP8 (after any VP8X and ALPH chunks)."""
    pos = 12
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], int.from_bytes(data[pos + 4:pos + 8], "little")
        if tag in (b"VP8 ", b"VP8L"):
            return tag == b"VP8 "
        pos += 8 + n + (n & 1)
    return False


def yuv_digest(planes) -> str:
    return sha256(b"".join(p.tobytes() for p in planes))


def jax_prep_digests(scratch: str, originals: Dict[str, bytes]) -> Dict[str, Dict[str, str]]:
    """The JAX package's ``prepare_pyramid`` (Pillow's decode and
    bilinear resize) of ``originals`` at 4-512 px: for each set, each
    image's SHA-256 of its RGB."""
    from PIL import Image

    from byogan_tpu.data.prep import prepare_pyramid

    root = os.path.join(scratch, "prep")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    for name, data in originals.items():
        with open(os.path.join(root, os.path.basename(name)), "wb") as f:
            f.write(data)
    prepare_pyramid(root, 4, 512, workers=4)
    out = {}
    for k in range(1, 9):
        folder = os.path.join(root, "prepared", f"set_{k}", "images")
        out[f"set_{k}"] = {}
        for name in sorted(os.listdir(folder)):
            with Image.open(os.path.join(folder, name)) as im:
                out[f"set_{k}"][name] = sha256(np.asarray(im.convert("RGB")))
    return out


def _set_sizes(data: bytes, chunk_at: int, chunk_size: int) -> bytes:
    """``data`` with its RIFF size and the chunk at ``chunk_at``'s size
    rewritten, so a cut file is whole as a container."""
    out = bytearray(data)
    out[4:8] = struct.pack("<I", len(data) - 8)
    out[chunk_at + 4:chunk_at + 8] = struct.pack("<I", chunk_size)
    return bytes(out)


def webp_failures() -> Dict[str, Tuple[bytes, str]]:
    """WebP files Pillow refuses: name -> (bytes, the reason the port
    names): files cut in the first partition, in the token partition and
    anywhere (with and without container sizes that agree with the cut), a
    bad VP8 start code, a VP8X canvas that is not the frame's size, a bad
    VP8L signature, an animation's first frame outside its canvas."""
    img = source_image(3, 40, 48)
    lossy = pil_webp(img, quality=90)
    lossless = pil_webp(img, lossless=True)
    part0 = int.from_bytes(lossy[20:23], "little") >> 5  # the first partition's size (frame tag)
    tokens = 20 + 10 + part0  # where the token partition starts
    in_tokens = lossy[:tokens + (len(lossy) - tokens) // 2]
    in_part0 = lossy[:30 + part0 // 2]
    start = bytearray(lossy)
    start[23:26] = b"\x9d\x01\x2b"
    canvas = bytearray(pil_webp(with_alpha(img), quality=90))
    canvas[27:30] = (40).to_bytes(3, "little")  # the VP8X canvas 41 rows high, the frame 40
    signature = bytearray(lossless)
    signature[20] = 0x2e
    outside = webp_animation((20, 20), [(6, 6, pil_webp(source_image(4, 16, 16), lossless=True))])
    return {
        "webp-cut-in-token-partition": (_set_sizes(in_tokens, 12, len(in_tokens) - 20), "truncated"),
        "webp-cut-in-first-partition": (_set_sizes(in_part0, 12, len(in_part0) - 20), "truncated"),
        "webp-cut-file": (lossy[: len(lossy) // 2], "truncated"),
        "webp-bad-start-code": (bytes(start), "breaks the format"),
        "webp-vp8x-canvas-not-frame": (bytes(canvas), "VP8X canvas is not its frame's size"),
        "webp-vp8l-bad-signature": (bytes(signature), "breaks the format"),
        "webp-frame-outside-canvas": (outside, "first frame lies outside its canvas"),
        "webp-vp8l-cut": (_set_sizes(lossless[:len(lossless) * 2 // 3], 12, len(lossless) * 2 // 3 - 20),
                          "truncated"),
    }



# --- the JPEG kinds the JAX package's native lane refuses or reads otherwise ---

KINDS = "kinds"  # their files' folder under FIXTURES
#: the kinds of ``kind_jpeg``: 4:4:0 chroma, arithmetic coding (sequential
#: and progressive), a progressive file left for block smoothing (its
#: refinement scans missing), CMYK (Pillow's, with its Adobe marker), YCCK
#: (4:2:0 chroma, K at full size), lossless (SOF3, predictor 7)
JPEG_KINDS = ("440", "arith", "arith-prog", "smoothed", "cmyk", "ycck", "lossless")
#: originals for the card's prep and decode rates: name -> (kind, height, width)
KINDS_CARD = {**{f"{k}-1024.jpg": (k, 1024, 1024) for k in JPEG_KINDS if k != "lossless"},
              "lossless-512.jpg": ("lossless", 512, 512)}
KINDS_QUALITY = 92  # the port's encoder's default, so each has a baseline twin of the same quality


def drop_scans(data: bytes, keep: Callable[[int, int, int, int, int], bool]) -> bytes:
    """A JPEG with the scans for which ``keep(components, Ss, Se, Ah, Al)``
    is false taken out (each up to the next marker that is not a restart)."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            out += data[pos:pos + 2]
            break
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            end = next(i for i in range(end, len(data) - 1)
                       if data[i] == 0xFF and data[i + 1] != 0 and not 0xD0 <= data[i + 1] <= 0xD7)
            n = data[pos + 4]
            ss, se, a = data[pos + 5 + 2 * n:pos + 8 + 2 * n]
            if not keep(n, ss, se, a >> 4, a & 15):
                pos = end
                continue
        out += data[pos:end]
        pos = end
    return bytes(out)


def cmyk_of(rgb: np.ndarray) -> np.ndarray:
    """RGB as CMYK samples by undercolour removal: K the least of 255 - R,
    G, B, and C, M, Y what is left of each."""
    cmy = 255 - rgb.astype(np.int64)
    k = cmy.min(axis=2, keepdims=True)
    return np.concatenate([cmy - k, k], axis=2).astype(np.uint8)


def kind_jpeg(lib: ctypes.CDLL, kind: str, img: np.ndarray, scratch: str) -> bytes:
    """``img`` (uint8 RGB) as a JPEG of ``kind`` (one of ``JPEG_KINDS``) at
    ``KINDS_QUALITY``, written by the system's libjpeg (``lib``, from
    ``jpeg_writer``), Pillow or this module's lossless writer."""
    from PIL import Image

    path = os.path.join(scratch, f"kind-{kind}.jpg")
    q = KINDS_QUALITY
    if kind == "440":
        return libjpeg_file(lib, img, path, sampling=[(1, 2), (1, 1), (1, 1)], quality=q)
    if kind in ("arith", "arith-prog"):
        return libjpeg_file(lib, img, path, arith=1, progressive=kind == "arith-prog", quality=q)
    if kind == "smoothed":  # the successive-approximation refinements never arrived
        return drop_scans(_pil_jpeg(img, quality=q, progressive=True), lambda n, ss, se, ah, al: ah == 0)
    if kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(cmyk_of(img), "CMYK").save(buf, format="JPEG", quality=q)
        return buf.getvalue()
    if kind == "ycck":
        return libjpeg_file(lib, cmyk_of(img), path, space="ycck", quality=q)
    if kind == "lossless":
        return jpeg_lossless([img[..., c] for c in range(3)], 7)
    raise ValueError(kind)


def kind_source(name: str) -> np.ndarray:
    """The source pixels of a card original or training file of the kinds
    (a name of ``kinds_fixtures()`` under ``card/`` or ``train/``)."""
    if name.startswith("card/"):
        i = sorted(KINDS_CARD).index(name[5:])
        _, h, w = KINDS_CARD[name[5:]]
        return smooth_scene(300 + i, h, w, cell=128)
    size, kind = name[6:-4].split("-", 1)
    size = int(size)
    return smooth_scene(330 + 10 * JPEG_KINDS.index(kind) + size.bit_length(), size, size, cell=max(2, size // 4),
                        step=16 if kind == "lossless" else 1)


def kinds_fixtures(scratch: str) -> Dict[str, bytes]:
    """Every file of the kinds (name under ``kinds/``) and its bytes, written
    anew: small files of each kind and variant the tests name, then the
    card's originals (``card/``) and training sets (``train/``, a file of
    each kind at each stage's size)."""
    from PIL import Image

    lib = jpeg_writer(os.path.join(scratch, "build"))
    photo = source_image(401, 61, 50)
    out = {"440-33x45.jpg": jpeg_from_blocks(33, 45, [(1, 2), (1, 1), (1, 1)], 402)}
    arith = {
        "arith-seq-420.jpg": dict(),
        "arith-prog-444.jpg": dict(progressive=1, sampling=[(1, 1)] * 3),
        "arith-restarts-dac-422.jpg": dict(restart_interval=2, dc_l=2, dc_u=6, ac_k=12,
                                          sampling=[(2, 1), (1, 1), (1, 1)]),
        "arith-prog-440-restarts.jpg": dict(progressive=1, restart_interval=3, sampling=[(1, 2), (1, 1), (1, 1)]),
    }
    for name, kw in arith.items():
        out[name] = libjpeg_file(lib, photo, os.path.join(scratch, name), arith=1, quality=88, **kw)
    out["arith-prog-gray.jpg"] = libjpeg_file(lib, photo[..., :1], os.path.join(scratch, "g.jpg"), space="gray",
                                              arith=1, progressive=1, quality=80)
    for sub, name in ((0, "444"), (2, "420")):
        prog = _pil_jpeg(photo, quality=90, progressive=True, subsampling=sub)
        out[f"smooth-dc-only-{name}.jpg"] = drop_scans(prog, lambda n, ss, se, ah, al: ss == 0)
        out[f"smooth-no-refine-{name}.jpg"] = drop_scans(prog, lambda n, ss, se, ah, al: ah == 0)
    cmyk = cmyk_of(photo)
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, format="JPEG", quality=90)
    out["cmyk-adobe.jpg"] = buf.getvalue()
    out["cmyk-no-adobe.jpg"] = libjpeg_file(lib, cmyk, os.path.join(scratch, "c.jpg"), space="cmyk", adobe=0,
                                            quality=90)
    out["cmyk-420.jpg"] = libjpeg_file(lib, cmyk, os.path.join(scratch, "c.jpg"), space="cmyk", quality=90,
                                       sampling=[(2, 2), (1, 1), (1, 1), (2, 2)])
    out["ycck-420.jpg"] = libjpeg_file(lib, cmyk, os.path.join(scratch, "y.jpg"), space="ycck", quality=90)
    out["ycck-prog-444.jpg"] = libjpeg_file(lib, cmyk, os.path.join(scratch, "y.jpg"), space="ycck", quality=90,
                                            progressive=1, sampling=[(1, 1)] * 4)
    planes = [photo[..., c] for c in range(3)]
    out["lossless-gray-p1-restarts.jpg"] = jpeg_lossless(planes[:1], 1, restart_rows=4)
    out["lossless-rgb-p7-pt2.jpg"] = jpeg_lossless(planes, 7, pt=2)
    out["lossless-rgb-p5-wrap.jpg"] = jpeg_lossless(planes, 5, wrap=((0, 0, 0), (1, 7, 9), (2, 60, 49)))
    out["lossless-420-p4.jpg"] = jpeg_lossless([planes[0], planes[1][::2, ::2], planes[2][::2, ::2]], 4,
                                               sampling=[(2, 2), (1, 1), (1, 1)])
    y, x = np.mgrid[0:256, 0:256]  # every (C, M or Y, K) pair: Pillow's cmyk2rgb, exhaustively
    pairs = np.stack([x, 255 - x, (x + y) % 256, y], -1).astype(np.uint8)
    out["lossless-cmyk-pairs.jpg"] = jpeg_lossless([pairs[..., c] for c in range(4)], 1)
    out = {f"{KINDS}/{k}": v for k, v in out.items()}
    for name in sorted(KINDS_CARD):
        out[f"{KINDS}/card/{name}"] = kind_jpeg(lib, KINDS_CARD[name][0], kind_source(f"card/{name}"), scratch)
    for size in WEBP_TRAIN_SIZES:
        for kind in JPEG_KINDS:
            name = f"train/{size}-{kind}.jpg"
            out[f"{KINDS}/{name}"] = kind_jpeg(lib, kind, kind_source(name), scratch)
    return out


def committed_kinds() -> Dict[str, bytes]:
    """The committed files of the kinds: name (under ``kinds/``) -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, KINDS)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


#: the kinds read by both of the JAX package's lanes alike; the others are
#: held to its Pillow lane alone
BOTH_LANES = ("440", "arith", "arith-prog")


def kind_of(name: str) -> str:
    """The kind of a file of ``kinds_fixtures()``: 440, arith, smooth,
    cmyk, ycck, lossless..."""
    base = os.path.basename(name)
    if "/train/" in f"/{name}":
        return base[:-4].split("-", 1)[1]
    if "/card/" in f"/{name}":
        return KINDS_CARD[base][0]
    return base.split("-")[0]


def kinds_entry(lib: ctypes.CDLL, name: str, path: str) -> dict:
    """A manifest entry of a file of the kinds: its Pillow RGB (the JAX
    package's Pillow lane), and what the JAX native lane does with it:
    refuses it (its return code), or reads it to the same RGB or to one
    that many samples apart by at most so much.  The 4:4:0 and arithmetic
    files must read alike in both lanes."""
    with open(path, "rb") as f:
        data = f.read()
    rgb = pil_rgb(path)
    entry = {"bytes": len(data), "sha256": sha256(data), "shape": list(rgb.shape[:2]), "sha256_rgb": sha256(rgb)}
    try:
        native_rgb = jax_decode(lib, path)
    except OSError as e:
        entry["native_lane"] = str(e).rsplit(" ", 1)[1]
    else:
        diff = np.abs(native_rgb.astype(np.int64) - rgb)
        entry["native_lane"] = "same" if not diff.any() else {"samples_apart": int((diff > 0).sum()),
                                                                 "max": int(diff.max())}
    if kind_of(name) in BOTH_LANES and entry["native_lane"] != "same":
        raise AssertionError(f"{name}: the JAX package's two lanes read it differently: {entry['native_lane']}")
    return entry


def build_manifest(files: Dict[str, Tuple[bytes, object]], lib: ctypes.CDLL, scratch: str,
                   webp: Optional[Dict[str, bytes]] = None, kinds: Optional[Dict[str, bytes]] = None,
                   pillow: Optional[Dict[str, bytes]] = None) -> dict:
    """The manifest of ``fixtures()``, of the WebP files (``webp``, the
    committed ones by default) and of the JPEG kinds' (``kinds``, likewise):
    each JPEG or PNG decoded by the JAX lane, which must agree with Pillow
    or with the file's known RGB; each WebP decoded by Pillow (the JAX
    package's WebP lane), and each still lossy one's planes by libwebp;
    each file of the kinds decoded by Pillow, beside what the JAX native
    lane makes of it (``kinds_entry``); each file under ``pillow/``
    (``pillow``, likewise) as ``pillow_entry`` records it; each source
    encoded by the JAX lane; the JAX package's pyramids of the card's WebP
    originals, of its originals of the kinds and of its originals under
    ``pillow/card/``."""
    import PIL
    from PIL import features

    webp = committed_webp() if webp is None else webp
    kinds = committed_kinds() if kinds is None else kinds
    pillow = committed_pillow() if pillow is None else pillow
    entries = {}
    for name, (data, truth) in sorted(files.items()):
        path = os.path.join(scratch, name)
        with open(path, "wb") as f:
            f.write(data)
        rgb = jax_decode(lib, path)
        if not np.array_equal(rgb, pil_rgb(path) if truth is None else truth):
            raise AssertionError(f"{name}: the JAX lane decodes it to other pixels than "
                                 + ("Pillow" if truth is None else "its samples"))
        entries[name] = {"bytes": len(data), "sha256": sha256(data), "shape": list(rgb.shape[:2]),
                         "sha256_rgb": sha256(rgb)}
    webp_lib = libwebp()
    for name, data in webp.items():
        path = os.path.join(scratch, "webp.webp")
        with open(path, "wb") as f:
            f.write(data)
        rgb = pil_rgb(path)
        entries[name] = {"bytes": len(data), "sha256": sha256(data), "shape": list(rgb.shape[:2]),
                         "sha256_rgb": sha256(rgb)}
        if is_lossy(data) and not is_animated(data):
            entries[name]["sha256_yuv"] = yuv_digest(webp_yuv(webp_lib, data))
    for name, data in kinds.items():
        path = os.path.join(scratch, "kind.jpg")
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = kinds_entry(lib, name, path)
    for name, data in pillow.items():
        path = os.path.join(scratch, "pillow" + os.path.splitext(name)[1])
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = pillow_entry(lib, name, path)
    sources = {}
    for name, (seed, h, w) in SOURCES.items():
        img = source_image(seed, h, w)
        sources[name] = {
            "seed": seed, "shape": [h, w], "sha256_pixels": sha256(img),
            "sha256_jpeg": {str(q): sha256(jax_encode(lib, img, q, os.path.join(scratch, f"{name}-{q}.jpg")))
                            for q in QUALITIES},
        }
    card = {n: d for n, d in webp.items() if n.startswith(f"{WEBP}/card/")}
    kinds_card = {n: d for n, d in kinds.items() if n.startswith(f"{KINDS}/card/")}
    pillow_card_files = {n: d for n, d in pillow.items() if n.startswith(f"{PILLOW}/card/")}
    return {
        "decoded_by": f"the JAX package's native lane (libpng, libjpeg-turbo), held to Pillow {PIL.__version__} "
                      "(JPEG, 8-bit PNG) or to the samples (PNG); WebP: the JAX package's Pillow lane, Pillow "
                      f"{PIL.__version__} with libwebp {features.version('webp')}, planes by the system's libwebp; "
                      f"{KINDS}/: the JAX package's Pillow lane, Pillow {PIL.__version__} with libjpeg-turbo "
                      f"{features.version('libjpeg_turbo')}, beside its native lane (native_lane); {PILLOW}/: "
                      f"Pillow {PIL.__version__}'s convert(\"RGB\") (BMP layouts, refusals with Pillow's "
                      "error), 16-bit "
                      "gray PNGs in both lanes (sha256_rgb: the native lane's, sha256_rgb_pillow: Pillow's), JPEGs "
                      "whose dequantised coefficients leave 16 bits beside the native lane (native_lane)",
        "files": entries, "sources": sources, "webp_prep": jax_prep_digests(scratch, card),
        "jpeg_prep": jax_prep_digests(scratch, kinds_card),
        "pillow_prep": jax_prep_digests(scratch, pillow_card_files),
    }


def write(scratch: str) -> dict:
    files = fixtures()
    webp = webp_fixtures()
    kinds = kinds_fixtures(scratch)
    pillow = pillow_fixtures(scratch)
    for folder in (WEBP, KINDS, PILLOW):
        shutil.rmtree(os.path.join(FIXTURES, folder), ignore_errors=True)
    for name, data in {**{k: d for k, (d, _) in files.items()}, **webp, **kinds, **pillow}.items():
        os.makedirs(os.path.dirname(os.path.join(FIXTURES, name)), exist_ok=True)
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
    manifest = build_manifest(files, jax_lane(os.path.join(scratch, "build")), scratch, webp, kinds, pillow)
    with open(MANIFEST, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


def load_manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def check(decode: Callable[..., np.ndarray], encode: Callable[[np.ndarray, int], bytes],
          decode_yuv: Optional[Callable[[str], Tuple[np.ndarray, np.ndarray, np.ndarray]]] = None) -> List[str]:
    """The committed fixtures against ``decode`` (a path -> RGB, in the
    JAX package's native lane; ``decode(path, lane="pillow")`` in its
    Pillow lane), ``encode`` (image, quality -> JPEG bytes) and
    ``decode_yuv`` (a lossy WebP's path -> Y, U, V; skipped where None):
    the names of those that match (``name@pillow`` for the Pillow lane,
    ``name@refused`` for a file ``decode`` must refuse with the recorded
    reason, ``name@yuv`` for planes, ``source@qN`` for encodes); raises
    ``AssertionError`` naming the first that does not."""
    import re

    manifest = load_manifest()
    matched = []
    for name, want in sorted(manifest["files"].items()):
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            if sha256(f.read()) != want["sha256"]:
                raise AssertionError(f"{name}: the file is not the one the manifest records")
        if "refused" in want:
            try:
                decode(path)
            except OSError as e:
                if not re.search(want["refused"], str(e)) or path not in str(e):
                    raise AssertionError(f"{name}: refused for another reason: {e}") from e
            else:
                raise AssertionError(f"{name}: decoded, where Pillow refuses it ({want['pillow']})")
            matched.append(f"{name}@refused")
            continue
        got = decode(path)
        if list(got.shape) != want["shape"] + [3] or sha256(got) != want["sha256_rgb"]:
            raise AssertionError(f"{name}: decoded to other pixels than libjpeg-turbo's / libpng's / libwebp's / "
                                 "Pillow's")
        matched.append(name)
        if "sha256_rgb_pillow" in want:
            if sha256(decode(path, lane="pillow")) != want["sha256_rgb_pillow"]:
                raise AssertionError(f"{name}: decoded to other pixels than Pillow's in the Pillow lane")
            matched.append(f"{name}@pillow")
        if decode_yuv is not None and "sha256_yuv" in want:
            if yuv_digest(decode_yuv(path)) != want["sha256_yuv"]:
                raise AssertionError(f"{name}: decoded to other planes than libwebp's WebPDecodeYUV")
            matched.append(f"{name}@yuv")
    for name, want in sorted(manifest["sources"].items()):
        img = source_image(want["seed"], *want["shape"])
        if sha256(img) != want["sha256_pixels"]:
            raise AssertionError(f"{name}: numpy made other source pixels")
        for q, digest in sorted(want["sha256_jpeg"].items(), key=lambda kv: int(kv[0])):
            if sha256(encode(img, int(q))) != digest:
                raise AssertionError(f"{name} at quality {q}: other bytes than the JAX lane's libjpeg")
            matched.append(f"{name}@q{q}")
    return matched


def check_prep(root: str, read: Callable[[str], np.ndarray], key: str = "webp_prep") -> int:
    """The pyramid prepared under ``root`` from the card's WebP originals
    (``key`` "webp_prep"), its originals of the JPEG kinds ("jpeg_prep")
    or its originals under ``pillow/card/`` ("pillow_prep") against the JAX
    package's recorded one: the number of images matched;
    raises ``AssertionError`` naming the first that differs."""
    want = load_manifest()[key]
    n = 0
    for set_name, digests in sorted(want.items()):
        folder = os.path.join(root, "prepared", set_name, "images")
        if sorted(os.listdir(folder)) != sorted(digests):
            raise AssertionError(f"{set_name}: files {sorted(os.listdir(folder))}, expected {sorted(digests)}")
        for name, digest in sorted(digests.items()):
            if sha256(read(os.path.join(folder, name))) != digest:
                raise AssertionError(f"{set_name}/{name}: other pixels than the JAX package's prepare_pyramid")
            n += 1
    return n



# --- the files the JAX package's Pillow lanes read and the port refused or read otherwise ---

PILLOW = "pillow"  # their files' folder under FIXTURES
#: the card's originals for cli.prep (under ``pillow/card/``): an 8-bit
#: palette BMP, an RLE8 BMP and a 16-bit gray PNG scan, at 1024 px
PILLOW_CARD = ("palette-1024.bmp", "rle8-1024.bmp", "gray16-1024.png")


def bmp_rows(values: np.ndarray, bits: int) -> np.ndarray:
    """BMP pixel rows of ``values``, top row first, each padded to 4 bytes:
    (h, w) indices at 1, 4 or 8 bits, (h, w) pixel words at 16 or 32 bits,
    (h, w, 3) bytes at 24 (in file order: B, G, R)."""
    v = np.asarray(values)
    h, w = v.shape[:2]
    out = np.zeros((h, (w * bits + 31) // 32 * 4), np.uint8)
    if bits < 8:
        per = 8 // bits
        pad = np.zeros((h, -(-w // per) * per), np.int64)
        pad[:, :w] = v
        groups = pad.reshape(h, -1, per)
        packed = sum(groups[..., i] << (bits * (per - 1 - i)) for i in range(per)).astype(np.uint8)
        out[:, :packed.shape[1]] = packed
    elif bits == 8:
        out[:, :w] = v
    else:
        words = {16: "<u2", 32: "<u4"}.get(bits)
        raw = v.astype(np.uint8) if words is None else v.astype(words).view(np.uint8)
        out[:, :w * bits // 8] = raw.reshape(h, -1)
    return out


def bmp_file(body: bytes, w: int, h: int, bits: int, header: int = 40, compression: int = 0,
             palette: Optional[np.ndarray] = None, colors: int = 0, masks: Tuple[int, ...] = (),
             offset: Optional[int] = None, top_down: bool = False) -> bytes:
    """A BMP file of pixel data ``body`` (rows in file order, or an RLE
    stream): a ``header``-byte info header (12: OS/2 1.x, with 3-byte
    palette entries), ``palette`` (RGB rows) written as BGR(X) after it,
    ``masks`` in the header (52 bytes and up) or after it (40), ``offset``
    the pixel data's (by default right after the palette), the height
    negated where ``top_down``."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression, len(body),
                           2835, 2835, colors, 0)
        if header >= 52:
            info += struct.pack("<IIII", *(tuple(masks) + (0,) * 4)[:4])[:12 if header == 52 else 16]
        info = info.ljust(header, b"\0")
    after = struct.pack("<III", *masks[:3]) if header == 40 and compression == 3 else b""
    table = b""
    if palette is not None:
        bgr = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            bgr = np.concatenate([bgr, np.zeros((len(bgr), 1), np.uint8)], axis=1)
        table = bgr.tobytes()
    start = 14 + len(info) + len(after) + len(table)
    at = start if offset is None else offset
    gap = bytes(max(0, at - start))
    return b"BM" + struct.pack("<IHHI", start + len(gap) + len(body), 0, 0, at) + info + after + table + gap + body


def rle_stream(rows: np.ndarray, rle4: bool) -> bytes:
    """Index rows (file order) as a BMP RLE8 or RLE4 stream that Pillow
    reads: runs of 3 or more equal indices, absolute runs of the rest (an
    even count at 4 bits) padded to 16 bits, end of line after each row,
    end of bitmap after the last."""
    out = bytearray()
    for row in np.asarray(rows, np.int64):
        x, w = 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 3 or w - x < 4:
                n = max(1, min(n, w - x))
                out += bytes([n, int(row[x]) * 17 if rle4 else int(row[x])])
                x += n
                continue
            m = 1  # an absolute run up to the next run of 3
            while x + m < w and m < 254 and not (x + m + 2 < w and row[x + m] == row[x + m + 1] == row[x + m + 2]):
                m += 1
            m -= m % 2 if rle4 else 0
            if m < (4 if rle4 else 3):
                out += bytes([1, int(row[x]) * 17 if rle4 else int(row[x])])
                x += 1
                continue
            vals = row[x:x + m]
            data = bytes((vals[0::2] << 4 | vals[1::2]).astype(np.uint8)) if rle4 else bytes(vals.astype(np.uint8))
            out += bytes([0, m]) + data + bytes(len(data) % 2)
            x += m
        out += b"\0\0"
    return bytes(out[:-2]) + b"\0\1"


def _quantised(img: np.ndarray, levels: int) -> Tuple[np.ndarray, np.ndarray]:
    """``img`` (uint8 RGB) on a palette of ``levels``^3 colours: (indices,
    palette rows)."""
    q = img.astype(np.int64) * levels // 256
    idx = (q[..., 0] * levels + q[..., 1]) * levels + q[..., 2]
    grid = np.stack(np.meshgrid(*[np.arange(levels)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return idx, (grid * 255 // max(1, levels - 1)).astype(np.uint8)


def bmp_layouts() -> Dict[str, bytes]:
    """A BMP of every layout Pillow 12.1.0 reads (name -> bytes), small and
    of odd widths: each header size; 1-, 4- and 8-bit palettes, full,
    short, counted in the header or not, 3-byte entries; the gray palettes
    Pillow drops (a black-and-white pair at 1, 4 and 8 bits, the 16-entry
    ramp at 4 bits, the 256-entry ramp); 16-bit BI_RGB and bitfields; 24-
    and 32-bit BI_RGB and every bitfield layout; RLE8 and RLE4 with runs,
    absolute runs, end of line, end of bitmap and deltas; top-down rows;
    the offsets Pillow guesses; Pillow's own L, P and 1 files."""
    from PIL import Image

    r = np.random.default_rng(1601)
    h, w = 11, 13
    out = {}
    pal = r.integers(0, 256, (256, 3))
    for bits in (1, 4, 8):
        n = 1 << bits
        idx = r.integers(0, n, (h, w))
        body = bmp_rows(idx, bits)[::-1].tobytes()
        out[f"pal{bits}.bmp"] = bmp_file(body, w, h, bits, palette=pal[:n])
        out[f"pal{bits}-colors-in-header.bmp"] = bmp_file(body, w, h, bits, palette=pal[:n], colors=n)
        out[f"pal{bits}-os2.bmp"] = bmp_file(body, w, h, bits, header=12, palette=pal[:n])
        out[f"pal{bits}-top-down.bmp"] = bmp_file(bmp_rows(idx, bits).tobytes(), w, h, bits, palette=pal[:n],
                                                   top_down=True)
        if bits > 1:
            short = max(2, n // 3)
            out[f"pal{bits}-short-{short}.bmp"] = bmp_file(body, w, h, bits, palette=pal[:short] + 1, colors=short)
        out[f"pal{bits}-black-white.bmp"] = bmp_file(body, w, h, bits, palette=[[0, 0, 0], [255, 255, 255]], colors=2)
    idx = r.integers(0, 16, (h, w))
    ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)
    out["pal4-gray-ramp16.bmp"] = bmp_file(bmp_rows(idx, 4)[::-1].tobytes(), w, h, 4, palette=ramp[:16])
    idx = r.integers(0, 256, (h, w))
    out["pal8-gray-ramp.bmp"] = bmp_file(bmp_rows(idx, 8)[::-1].tobytes(), w, h, 8, palette=ramp)
    out["pal8-offset-guessed.bmp"] = bmp_file(bmp_rows(idx, 8)[::-1].tobytes(), w, h, 8, palette=pal, offset=54)
    out["pal8-offset-zero.bmp"] = bmp_file(bmp_rows(idx, 8)[::-1].tobytes(), w, h, 8, palette=pal, offset=0)
    for header in (52, 56, 64, 108, 124):
        out[f"pal8-header{header}.bmp"] = bmp_file(bmp_rows(idx, 8)[::-1].tobytes(), w, h, 8, header=header,
                                                   palette=pal)
    words = r.integers(0, 65536, (h, w))
    body16 = bmp_rows(words, 16)[::-1].tobytes()
    out["rgb16-555.bmp"] = bmp_file(body16, w, h, 16)
    out["rgb16-555-os2.bmp"] = bmp_file(body16, w, h, 16, header=12)
    for name, masks in (("555", (0x7C00, 0x3E0, 0x1F)), ("565", (0xF800, 0x7E0, 0x1F))):
        for header in (40, 56, 124):
            out[f"bitfields16-{name}-header{header}.bmp"] = bmp_file(body16, w, h, 16, header=header, compression=3,
                                                                      masks=masks)
    bgr = r.integers(0, 256, (h, w, 3))
    out["rgb24.bmp"] = bmp_file(bmp_rows(bgr, 24)[::-1].tobytes(), w, h, 24)
    out["rgb24-os2.bmp"] = bmp_file(bmp_rows(bgr, 24)[::-1].tobytes(), w, h, 24, header=12)
    out["rgb24-top-down-header108.bmp"] = bmp_file(bmp_rows(bgr, 24).tobytes(), w, h, 24, header=108, top_down=True)
    out["bitfields24.bmp"] = bmp_file(bmp_rows(bgr, 24)[::-1].tobytes(), w, h, 24, compression=3,
                                      masks=(0xFF0000, 0xFF00, 0xFF))
    px = r.integers(0, 2**32, (h, w), dtype=np.uint64)
    body32 = bmp_rows(px, 32)[::-1].tobytes()
    out["rgb32.bmp"] = bmp_file(body32, w, h, 32)
    for masks in ((0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0), (0xFF000000, 0xFF00, 0xFF, 0x0),
                  (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                  (0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)):
        tag = "-".join(f"{m:x}" for m in masks)
        out[f"bitfields32-{tag}.bmp"] = bmp_file(body32, w, h, 32, header=124, compression=3, masks=masks)
    out["bitfields32-header40.bmp"] = bmp_file(body32, w, h, 32, compression=3, masks=(0xFF0000, 0xFF00, 0xFF))
    scene = smooth_scene(1602, 2 * h, 3 * w + 1, cell=8, step=48)
    for bits, comp in ((8, 1), (4, 2)):
        idx, palette = _quantised(scene, 6 if bits == 8 else 2)
        if bits == 4:
            idx = idx * 2 % 16
        stream = rle_stream(idx[::-1], bits == 4)
        hh, ww = idx.shape
        out[f"rle{bits}.bmp"] = bmp_file(stream, ww, hh, bits, compression=comp, palette=palette[:1 << bits])
        out[f"rle{bits}-gray.bmp"] = bmp_file(stream, ww, hh, bits, compression=comp, palette=ramp[:1 << bits])
        out[f"rle{bits}-top-down.bmp"] = bmp_file(rle_stream(idx, bits == 4), ww, hh, bits, compression=comp,
                                                  palette=palette[:1 << bits], top_down=True)
    # Pillow's reading of the escapes, on 6 x 4: a delta skips two bytes and reads (right, up) from the next
    # two; a run is cut at the row's end; an absolute run runs over it; an odd absolute count at 4 bits
    # reads count // 2 bytes; the alignment after an absolute run follows the file's offsets (odd here).
    escapes = {
        "rle8-delta.bmp": [6, 10, 0, 0, 2, 20, 0, 2, 9, 9, 2, 1, 0, 0, 6, 40, 0, 1],
        "rle8-run-past-row.bmp": [9, 10, 0, 0, 6, 20, 0, 0, 6, 30, 0, 0, 4, 40, 0, 0, 0, 1],
        "rle8-absolute-over-row.bmp": [0, 8, 1, 2, 3, 4, 5, 6, 7, 8, 0, 0, 6, 30, 0, 0, 6, 40, 0, 1],
        "rle8-no-end-of-bitmap.bmp": [6, 10, 0, 0, 6, 20, 0, 0, 6, 30, 0, 0, 6, 40],
        "rle8-odd-offset.bmp": [0, 3, 1, 2, 3, 3, 9, 0, 0, 6, 20, 0, 0, 6, 30, 0, 0, 6, 40, 0, 1],
        "rle4-odd-absolute.bmp": [0, 5, 0x12, 0x34, 0, 0, 6, 0x9A, 0, 0, 6, 0x11, 0, 0, 6, 0x22, 0, 1],
    }
    for name, ops in escapes.items():
        bits = 4 if name.startswith("rle4") else 8
        out[name] = bmp_file(bytes(ops), 6, 4, bits, compression=1 if bits == 8 else 2,
                             palette=ramp if bits == 8 else pal[:16],
                             offset=14 + 40 + 1024 + 1 if "odd-offset" in name else None)
    img = source_image(1603, h, w)
    for mode in ("L", "P", "1"):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, format="BMP")
        out[f"pillow-{mode}.bmp"] = buf.getvalue()
    return {f"{PILLOW}/bmp/{k}": v for k, v in sorted(out.items())}


def bmp_refusals() -> Dict[str, Tuple[bytes, str]]:
    """BMP files Pillow 12.1.0 refuses: name -> (bytes, the reason the
    port's ``OSError`` names, a regular expression)."""
    r = np.random.default_rng(1604)
    h, w = 5, 7
    idx = r.integers(0, 4, (h, w))
    pal = r.integers(0, 256, (300, 3))
    body8 = bmp_rows(idx, 8)[::-1].tobytes()
    rgb = bmp_rows(r.integers(0, 256, (h, w, 3)), 24)[::-1].tobytes()
    with_header16 = bytearray(bmp_file(body8, w, h, 8, palette=pal[:256]))
    with_header16[14:18] = struct.pack("<I", 16)
    ramp16 = np.repeat(np.arange(16)[:, None], 3, axis=1)
    ramp4 = bmp_file(bmp_rows(r.integers(0, 16, (h, w)), 4)[::-1].tobytes(), w, h, 4, palette=ramp16)
    return {
        "2-bit.bmp": (bmp_file(bmp_rows(idx, 2)[::-1].tobytes(), w, h, 2, palette=pal[:4]), "2-bit pixels"),
        "64-bit.bmp": (bmp_file(bytes(8 * w * h), w, h, 64), "64-bit pixels"),
        "bi-jpeg.bmp": (bmp_file(rgb, w, h, 24, compression=4), "BI_JPEG"),
        "bi-png.bmp": (bmp_file(rgb, w, h, 24, compression=5), "BI_PNG"),
        "bitfields32-rgb-alpha-low.bmp": (bmp_file(bytes(4 * w * h), w, h, 32, header=56, compression=3,
                                                   masks=(0xFF0000, 0xFF00, 0xFF, 0xFF)), "bitfields"),
        "bitfields16-444.bmp": (bmp_file(bytes(2 * w * h + 2 * h), w, h, 16, compression=3,
                                         masks=(0xF00, 0xF0, 0xF)), "bitfields"),
        "bitfields8.bmp": (bmp_file(body8, w, h, 8, compression=3, palette=pal[:256], masks=(0xE0, 0x1C, 0x3)),
                           "bitfields"),
        "palette-70000-colours.bmp": (bmp_file(body8, w, h, 8, palette=pal[:4], colors=70000), "70000 colours"),
        "palette-300-colours.bmp": (bmp_file(body8, w, h, 8, palette=pal, colors=300), "300 colours"),
        "header16.bmp": (bytes(with_header16), "16-byte header"),
        "rle8-black-white.bmp": (bmp_file(bytes([7, 1, 0, 0] * h), w, h, 8, compression=1,
                                          palette=[[0, 0, 0], [255, 255, 255]], colors=2), "black and white"),
        "rle8-24-bit.bmp": (bmp_file(bytes([7, 1, 0, 0] * h), w, h, 24, compression=1), "no palette"),
        "rle8-ends-early.bmp": (bmp_file(bytes([7, 1, 0, 0, 0, 1]), w, h, 8, compression=1, palette=pal[:256]),
                                "end before"),
        "truncated.bmp": (bmp_file(rgb, w, h, 24)[:-20], "truncated"),
        "gray-ramp16-truncated.bmp": (ramp4[:-1], "truncated"),
    }


def gray16_pngs() -> Dict[str, bytes]:
    """16-bit gray PNGs, where the JAX package's lanes part: samples over
    the whole range and below 1024 (a scanner's 10 bits), Adam7, tRNS."""
    r = np.random.default_rng(1605)
    full = r.integers(0, 65536, (9, 14, 1))
    full[0, :6, 0] = [0, 255, 256, 771, 1542, 65535]
    low = r.integers(0, 1024, (13, 10, 1))
    out = {
        "gray16-full.png": png_bytes(full, 16, 0),
        "gray16-10-bit.png": png_bytes(low, 16, 0),
        "gray16-10-bit-adam7.png": png_bytes(low, 16, 0, interlace=True),
        "gray16-trns.png": png_bytes(low, 16, 0, chunks=((b"tRNS", struct.pack(">H", int(low[0, 0, 0]))),)),
    }
    return {f"{PILLOW}/gray16/{k}": v for k, v in out.items()}


def coefficient_jpeg(lib: ctypes.CDLL, path: str, h: int, w: int, sampling: List[Tuple[int, int]], quant: np.ndarray,
                     coefs: List[np.ndarray], arith: bool = False, progressive: bool = False) -> bytes:
    """A JPEG written by the system's libjpeg (``jpeg_write_coefficients``)
    from quantised coefficients chosen here: component c of (h, v) factors
    ``sampling[c]``, quantised by ``quant[c]`` (64 values, natural order),
    its blocks ``coefs[c]`` ((rows, columns, 64) over its block grid
    rounded up to whole MCUs, natural order).  The file's bytes."""
    ints = ctypes.c_int * 8
    samp = ints(*[v for s in sampling for v in s])
    q = np.ascontiguousarray(np.asarray(quant, np.uint16).reshape(len(sampling), 64))
    arrays = [np.ascontiguousarray(c, np.int16) for c in coefs]
    short_p = ctypes.POINTER(ctypes.c_short)
    ptrs = (short_p * 4)(*[a.ctypes.data_as(short_p) for a in arrays])
    rc = lib.byogan_write_coefficients(path.encode(), h, w, len(sampling), samp,
                                       q.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)), ptrs, int(arith),
                                       int(progressive))
    if rc != 0:
        raise OSError(f"{path}: libjpeg did not write it ({rc})")
    with open(path, "rb") as f:
        return f.read()


#: the JPEG kinds that share the IDCT, as (sampling, arithmetic, progressive, block-smoothed)
IDCT_KINDS = {
    "baseline-gray": ([(1, 1)], False, False, False),
    "baseline-420": ([(2, 2), (1, 1), (1, 1)], False, False, False),
    "baseline-444": ([(1, 1)] * 3, False, False, False),
    "progressive-420": ([(2, 2), (1, 1), (1, 1)], False, True, False),
    "arith-444": ([(1, 1)] * 3, True, False, False),
    "arith-progressive-420": ([(2, 2), (1, 1), (1, 1)], True, True, False),
    "smoothed-420": ([(2, 2), (1, 1), (1, 1)], False, True, True),
}


def wide_blocks(seed: int, h: int, w: int, sampling: List[Tuple[int, int]]) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Quantisers (up to 255) and coefficients (DC up to +-2047, AC up to
    +-1023: what a baseline file codes) whose dequantised values leave the
    16-bit range in three blocks of four, beside blocks that stay in it:
    (quant, coefficients of each component).  A component's DC values keep
    one sign, so no difference between neighbours passes 2047."""
    r = np.random.default_rng(seed)
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = _ceil(w, 8 * hmax), _ceil(h, 8 * vmax)
    quant = r.integers(1, 256, (len(sampling), 64))
    quant[:, 0] = r.integers(100, 256, len(sampling))
    coefs = []
    for ci, (sh, sv) in enumerate(sampling):
        sign = 1 if ci % 2 == 0 else -1
        rows, cols = mcuy * sv, mcux * sh
        c = np.zeros((rows, cols, 64), np.int64)
        for by in range(rows):
            for bx in range(cols):
                kind = (by * cols + bx) % 4
                c[by, bx, 0] = sign * r.integers(0, 2048)
                if kind == 1:  # one large AC term
                    c[by, bx, r.integers(1, 64)] = r.integers(-1023, 1024)
                elif kind == 2:  # several
                    at = r.choice(np.arange(1, 64), 6, replace=False)
                    c[by, bx, at] = r.integers(-1023, 1024, 6)
                elif kind == 3:  # small terms: in range once dequantised
                    c[by, bx, 0] = sign * r.integers(0, 9)
                    c[by, bx, 1:10] = r.integers(-2, 3, 9)
        coefs.append(c.astype(np.int16))
    return quant, coefs


def idct_jpegs(lib: ctypes.CDLL, scratch: str) -> Dict[str, bytes]:
    """JPEGs of each kind of ``IDCT_KINDS`` whose dequantised coefficients
    leave the 16-bit range (``wide_blocks``), written by the system's
    libjpeg (``lib``, from ``jpeg_writer``); the block-smoothed one a
    progressive file with its refinement scans taken out."""
    out = {}
    for i, (kind, (sampling, arith, progressive, smoothed)) in enumerate(IDCT_KINDS.items()):
        h, w = 29 + 8 * i, 37
        quant, coefs = wide_blocks(1606 + i, h, w, sampling)
        data = coefficient_jpeg(lib, os.path.join(scratch, "idct.jpg"), h, w, sampling, quant, coefs, arith,
                                progressive)
        if smoothed:
            data = drop_scans(data, lambda n, ss, se, ah, al: ah == 0)
        out[f"{PILLOW}/idct/{kind}.jpg"] = data
    return out


def pillow_card() -> Dict[str, bytes]:
    """The card's originals for cli.prep: an 8-bit palette BMP of a photo
    on a 6 x 6 x 6 colour cube, an RLE8 BMP of a posterised scene and a
    16-bit gray PNG scan of 10 bits, each 1024 px."""
    side = 1024
    idx, palette = _quantised(source_image(1610, side, side), 6)
    scene = smooth_scene(1611, side, side, cell=128, step=32)
    ridx, rpalette = _quantised(scene, 6)
    high, low = smooth_scene(1612, side, side, cell=256), smooth_scene(1613, side, side, cell=256)
    gray = high[..., :1].astype(np.int64) * 4 + low[..., :1] % 4
    return {
        f"{PILLOW}/card/palette-1024.bmp": bmp_file(bmp_rows(idx, 8)[::-1].tobytes(), side, side, 8, palette=palette),
        f"{PILLOW}/card/rle8-1024.bmp": bmp_file(rle_stream(ridx[::-1], False), side, side, 8, compression=1,
                                                  palette=rpalette),
        f"{PILLOW}/card/gray16-1024.png": png_bytes(gray, 16, 0, kinds=(4,)),
    }


def pillow_fixtures(scratch: str) -> Dict[str, bytes]:
    """Every file under ``pillow/`` (name -> bytes), written anew: the BMP
    layouts and refusals, the 16-bit gray PNGs, the out-of-range JPEGs and
    the card's originals."""
    lib = jpeg_writer(os.path.join(scratch, "build"))
    refused = {f"{PILLOW}/bmp/refused/{k}": v for k, (v, _) in bmp_refusals().items()}
    return dict(sorted({**bmp_layouts(), **refused, **gray16_pngs(), **idct_jpegs(lib, scratch),
                        **pillow_card()}.items()))


def committed_pillow() -> Dict[str, bytes]:
    """The committed files under ``pillow/``: name -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, PILLOW)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def pillow_entry(lib: ctypes.CDLL, name: str, path: str) -> dict:
    """A manifest entry of a file under ``pillow/``: a BMP Pillow refuses
    records Pillow's error and the reason the port must name (``refused``);
    any other its Pillow RGB, and what the JAX native lane makes of it
    (``native_lane``, as ``kinds_entry``); a 16-bit gray PNG records the
    native lane's RGB (the loader's) as ``sha256_rgb`` and Pillow's (prep's)
    as ``sha256_rgb_pillow``."""
    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    if "/refused/" in name:
        try:
            with Image.open(path) as im:
                im.convert("RGB")
        except Exception as e:  # noqa: BLE001 - Pillow raises OSError, ValueError and its own
            return {"bytes": len(data), "sha256": sha256(data), "pillow": f"{type(e).__name__}: {e}",
                    "refused": bmp_refusals()[os.path.basename(name)][1]}
        raise AssertionError(f"{name}: Pillow reads it")
    if "/gray16/" in name or name.endswith(".png"):
        native_rgb, rgb = jax_decode(lib, path), pil_rgb(path)
        return {"bytes": len(data), "sha256": sha256(data), "shape": list(rgb.shape[:2]),
                "sha256_rgb": sha256(native_rgb), "sha256_rgb_pillow": sha256(rgb)}
    if name.endswith(".bmp"):
        rgb = pil_rgb(path)
        return {"bytes": len(data), "sha256": sha256(data), "shape": list(rgb.shape[:2]), "sha256_rgb": sha256(rgb)}
    entry = kinds_entry(lib, name, path)
    if "/smoothed" not in name and entry["native_lane"] != "same":
        raise AssertionError(f"{name}: the JAX package's two lanes read it differently: {entry['native_lane']}")
    return entry


if __name__ == "__main__":
    import tempfile

    sys.path.insert(0, ROOT)  # the JAX package, whose prep the card's originals are held to
    with tempfile.TemporaryDirectory() as tmp:
        out = write(tmp)
    total = sum(e["bytes"] for e in out["files"].values())
    webp_total = sum(e["bytes"] for n, e in out["files"].items() if n.startswith(f"{WEBP}/"))
    kinds_total = sum(e["bytes"] for n, e in out["files"].items() if n.startswith(f"{KINDS}/"))
    pillow_total = sum(e["bytes"] for n, e in out["files"].items() if n.startswith(f"{PILLOW}/"))
    print(f"{len(out['files'])} files ({total} bytes, {webp_total} of them WebP, {kinds_total} of the JPEG kinds, "
          f"{pillow_total} under {PILLOW}/), "
          f"{len(out['sources'])} sources x {len(QUALITIES)} qualities -> {FIXTURES}", file=sys.stderr)
