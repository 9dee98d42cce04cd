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

At import this module needs numpy alone: Pillow, libwebp, libjpeg, Python's
lzma, Pillow's libzstd and libtiff (through ctypes) and the JAX lane (built
from ``byogan_tpu/native/byogan_io.cpp`` into a directory the caller names,
never the JAX package's own library) are reached inside the functions that
need them; the card's written originals need none of them.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import gzip
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


# 12-bit gray JPEG: DC categories 0-15 in 5 bits, the AC run/size symbols
# of sizes 1-15 (and EOB, ZRL) in 8 bits
_DC12_SYMBOLS = list(range(16))
_AC12_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 16)]
_DCT8 = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                  for u in range(8)])


def jpeg12_tables(scale: float) -> Tuple[np.ndarray, bytes]:
    """A quantisation table (natural order) of the standard luminance table
    times ``scale``, and the DQT (16-bit entries where one passes 255) and
    DHT segments of a 12-bit gray JPEG."""
    base = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                     14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
    quant = np.clip(np.round(base * scale), 1, 65535).astype(np.int64)
    zz = [int(quant[kNatural]) for kNatural in _ZIGZAG]
    wide = max(zz) > 255
    body = bytes([0x10 if wide else 0]) + (struct.pack(">64H", *zz) if wide else bytes(zz))
    tables = b"\xff\xdb" + struct.pack(">H", 2 + len(body)) + body
    tables += _dht(0x00, 5, _DC12_SYMBOLS) + _dht(0x10, 8, _AC12_SYMBOLS)
    return quant, tables


# the natural places of zigzag 0-63
_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
           21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
           60, 61, 54, 47, 55, 62, 63]


def jpeg12_gray(samples: np.ndarray, scale: float = 1.0, restart: int = 0, tables: bool = True) -> bytes:
    """A 12-bit gray JPEG (SOF1, precision 12) of ``samples`` (h, w) in
    0-4095: each 8 x 8 block (the edges repeated) through the float DCT,
    quantised by ``jpeg12_tables(scale)`` and Huffman-coded with its
    fixed-length tables; restart markers every ``restart`` blocks; without
    its tables (``tables`` False: an abbreviated stream, as a TIFF's strips
    with JPEGTables)."""
    s = np.asarray(samples, np.float64)
    h, w = s.shape
    quant, segs = jpeg12_tables(scale)
    bh, bw = _ceil(h, 8), _ceil(w, 8)
    pad = np.pad(s, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge") - 2048
    head = b"\xff\xd8" + (segs if tables else b"")
    head += b"\xff\xc1" + struct.pack(">HBHHB", 11, 12, h, w, 1) + bytes([1, 0x11, 0])
    if restart:
        head += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    head += b"\xff\xda" + struct.pack(">HB", 8, 1) + bytes([1, 0x00, 0, 63, 0])
    dc_code = {v: (i, 5) for i, v in enumerate(_DC12_SYMBOLS)}
    ac_code = {v: (i, 8) for i, v in enumerate(_AC12_SYMBOLS)}
    out, bits, pred = bytearray(), _BitWriter(), 0
    for k in range(bh * bw):
        if restart and k and k % restart == 0:
            out += bits.flush() + bytes([0xFF, 0xD0 + (k // restart - 1) % 8])
            bits, pred = _BitWriter(), 0
        by, bx = divmod(k, bw)
        coef = _DCT8 @ pad[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] @ _DCT8.T
        q = np.round(coef.reshape(64) / quant).astype(np.int64)
        zz = [int(q[n]) for n in _ZIGZAG]
        n, b = _category(zz[0] - pred)
        pred = zz[0]
        bits.put(*dc_code[n])
        if n:
            bits.put(b, n)
        run = 0
        for v in zz[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac_code[0xF0])
                run -= 16
            n, b = _category(v)
            bits.put(*ac_code[(run << 4) | n])
            bits.put(b, n)
            run = 0
        if run:
            bits.put(*ac_code[0x00])
    return head + bytes(out) + bits.flush() + b"\xff\xd9"


def jpeg12_tiff(samples: np.ndarray, scale: float = 1.0, rows_per_strip: Optional[int] = None,
                tile: Optional[Tuple[int, int]] = None, shared_tables: bool = False, restart: int = 0) -> bytes:
    """A 12-bit gray JPEG-compressed TIFF (II, MinIsBlack, Pillow's I;16):
    each strip or tile a ``jpeg12_gray`` stream of its samples, whole, or
    abbreviated beside a JPEGTables tag (``shared_tables``)."""
    s = np.asarray(samples)
    h, w = s.shape
    chunks = []
    if tile:
        th, tw = tile
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                blk = np.zeros((th, tw), s.dtype)
                part = s[ty:ty + th, tx:tx + tw]
                blk[:part.shape[0], :part.shape[1]] = part
                chunks.append(jpeg12_gray(blk, scale, restart, not shared_tables))
    else:
        rps = rows_per_strip or h
        chunks = [jpeg12_gray(s[y:y + rps], scale, restart, not shared_tables) for y in range(0, h, rps)]
    tags = {347: (7, list(b"\xff\xd8" + jpeg12_tables(scale)[1] + b"\xff\xd9"))} if shared_tables else {}
    return tiff_bytes(s, 12, 1, compression=7, rows_per_strip=rows_per_strip, tile=tile, chunks=chunks, tags=tags)


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
    and ``byogan_encode_jpeg``.  A build that fails raises
    ``RuntimeError`` with the compiler's output: no other lane stands in."""
    os.makedirs(build_dir, exist_ok=True)
    lib = os.path.join(build_dir, "libbyogan_io_jax.so")
    with open(os.path.join(build_dir, "libbyogan_io_jax.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib):
            tmp = lib + f".{os.getpid()}.tmp"
            src = os.path.join(ROOT, "byogan_tpu", "native", "byogan_io.cpp")
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp, "-lpng", "-ljpeg", "-lz", "-lpthread"]
            try:
                done = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:  # no compiler on the PATH
                raise RuntimeError(f"the JAX package's native lane did not build: {' '.join(cmd)}: {e}") from e
            if done.returncode != 0:
                raise RuntimeError(f"the JAX package's native lane did not build: {' '.join(cmd)} failed:\n"
                                   f"{done.stdout}{done.stderr}")
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
                   pillow: Optional[Dict[str, bytes]] = None, gif_tiff: Optional[Dict[str, bytes]] = None,
                   ico_pnm_tga: Optional[Dict[str, bytes]] = None, raster: Optional[Dict[str, bytes]] = None,
                   dbfis: Optional[Dict[str, bytes]] = None, legacy: Optional[Dict[str, bytes]] = None,
                   imips: Optional[Dict[str, bytes]] = None, lzo: Optional[Dict[str, bytes]] = None,
                   j2k: Optional[Dict[str, bytes]] = None, avif: Optional[Dict[str, bytes]] = None) -> dict:
    """The manifest of ``fixtures()``, of the WebP files (``webp``, the
    committed ones by default) and of the JPEG kinds' (``kinds``, likewise):
    each JPEG or PNG decoded by the JAX lane, which must agree with Pillow
    or with the file's known RGB; each WebP decoded by Pillow (the JAX
    package's WebP lane), and each still lossy one's planes by libwebp;
    each file of the kinds decoded by Pillow, beside what the JAX native
    lane makes of it (``kinds_entry``); each file under ``pillow/``
    (``pillow``, likewise) as ``pillow_entry`` records it; each source
    encoded by the JAX lane; each file under ``gif_tiff/`` (``gif_tiff``,
    likewise) as ``gif_tiff_entry`` records it, and each under
    ``ico_pnm_tga/`` (``ico_pnm_tga``, likewise) and each of the card's
    written originals (``card_originals``, under ``card``) as
    ``ico_pnm_tga_entry`` does; each under ``psd_pcx_sgi_qoi/`` (``raster``,
    likewise) and each of the card's written originals of that folder
    (``raster_card_originals``, under ``raster_card``) as ``gif_tiff_entry``
    does with ``raster_refusals``; the JAX package's pyramids of the card's
    originals of the kinds, of its originals under ``pillow/card/`` and of
    those under ``gif_tiff/card/`` together with the written ones cli.prep
    reads (by their listed names, ``GIF_TIFF_CARD`` and
    ``CARD_ORIGINALS``), which tests check by hash on their own; the hash
    of Pillow's RGB of every 8-bit Lab triple (``lab_table``); and each
    file under ``dds_blp_ftex_icns_sun/`` (``dbfis``, likewise) and its
    card originals as ``dbfis_manifest`` records them; and each under
    ``legacy_rasters/`` (``legacy``, likewise) and its card originals as
    ``legacy_manifest`` records them; each
    under ``im_iptc_pcd_spider/`` (``imips``, likewise) and its card
    originals as ``imips_manifest`` records them; each under
    ``tiff_lzma_zstd_ojpeg/`` (``lzo``, likewise) and its card originals as
    ``lzo_manifest`` records them; each under ``jpeg2000/`` (``j2k``,
    likewise) as ``j2k_manifest`` records it; each under ``avif/``
    (``avif``, likewise) as ``avif_manifest`` records it; and the JAX package's
    pyramids of every slice's originals of the Pillow lane together
    (``pillow_lane_originals``, under ``PILLOW_LANE_PREP``), the one
    ``cli.prep`` the card's "io prep" runs on them."""
    import PIL
    from PIL import features

    webp = committed_webp() if webp is None else webp
    kinds = committed_kinds() if kinds is None else kinds
    pillow = committed_pillow() if pillow is None else pillow
    gif_tiff = committed_gif_tiff() if gif_tiff is None else gif_tiff
    ico_pnm_tga = committed_ico_pnm_tga() if ico_pnm_tga is None else ico_pnm_tga
    raster = committed_raster() if raster is None else raster
    dbfis_parts = dbfis_manifest(scratch, committed_dbfis() if dbfis is None else dbfis)
    legacy_parts = legacy_manifest(scratch, committed_legacy() if legacy is None else legacy)
    imips_parts = imips_manifest(scratch, committed_imips() if imips is None else imips)
    lzo_parts = lzo_manifest(scratch, committed_lzo() if lzo is None else lzo)
    j2k_parts = j2k_manifest(scratch, committed_j2k() if j2k is None else j2k)
    avif_parts = avif_manifest(scratch, committed_avif() if avif is None else avif)
    entries = {**dbfis_parts.pop("files"), **legacy_parts.pop("files"), **imips_parts.pop("files"),
               **lzo_parts.pop("files"), **j2k_parts.pop("files"), **avif_parts.pop("files")}
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
    for name, data in gif_tiff.items():
        path = os.path.join(scratch, "gif-tiff" + os.path.splitext(name)[1])
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = gif_tiff_entry(name, path)
    for name, data in ico_pnm_tga.items():
        path = os.path.join(scratch, "ico-pnm-tga" + os.path.splitext(name)[1])
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = ico_pnm_tga_entry(name, path)
    for name, data in raster.items():
        path = os.path.join(scratch, "raster" + os.path.splitext(name)[1])
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = gif_tiff_entry(name, path, raster_refusals())
    raster_card = {}
    for name, data in raster_card_originals().items():
        path = os.path.join(scratch, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        raster_card[name] = gif_tiff_entry(name, path, raster_refusals())
    written = card_originals()
    card_entries = {}
    for name, data in written.items():
        path = os.path.join(scratch, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        card_entries[name] = ico_pnm_tga_entry(name, path)
    sources = {}
    for name, (seed, h, w) in SOURCES.items():
        img = source_image(seed, h, w)
        sources[name] = {
            "seed": seed, "shape": [h, w], "sha256_pixels": sha256(img),
            "sha256_jpeg": {str(q): sha256(jax_encode(lib, img, q, os.path.join(scratch, f"{name}-{q}.jpg")))
                            for q in QUALITIES},
        }
    kinds_card = {n: d for n, d in kinds.items() if n.startswith(f"{KINDS}/card/")}
    pillow_card_files = {n: d for n, d in pillow.items() if n.startswith(f"{PILLOW}/card/")}
    gif_tiff_card_files = {GIF_TIFF_CARD[os.path.basename(n)]: d for n, d in gif_tiff.items()
                           if n.startswith(f"{GIF_TIFF}/card/")}
    gif_tiff_card_files.update({CARD_ORIGINALS[os.path.basename(n)]: d for n, d in written.items()
                                if CARD_ORIGINALS[os.path.basename(n)]})
    return {
        "decoded_by": f"the JAX package's native lane (libpng, libjpeg-turbo), held to Pillow {PIL.__version__} "
                      "(JPEG, 8-bit PNG) or to the samples (PNG); WebP: the JAX package's Pillow lane, Pillow "
                      f"{PIL.__version__} with libwebp {features.version('webp')}, planes by the system's libwebp; "
                      f"{KINDS}/: the JAX package's Pillow lane, Pillow {PIL.__version__} with libjpeg-turbo "
                      f"{features.version('libjpeg_turbo')}, beside its native lane (native_lane); {PILLOW}/: "
                      f"Pillow {PIL.__version__}'s convert(\"RGB\") (BMP layouts, refusals with Pillow's "
                      "error), 16-bit "
                      "gray PNGs in both lanes (sha256_rgb: the native lane's, sha256_rgb_pillow: Pillow's), JPEGs "
                      "whose dequantised coefficients leave 16 bits beside the native lane (native_lane); "
                      f"{GIF_TIFF}/: Pillow {PIL.__version__}'s convert(\"RGB\") (GIF's own decoder, libtiff "
                      f"{features.version('libtiff')}), refusals with what Pillow makes of the file; "
                      f"{ICO_PNM_TGA}/ and card: Pillow {PIL.__version__}'s convert(\"RGB\") (ICO, CUR, DIB, PNM, "
                      "Targa), refusals with Pillow's error; card: the originals card_originals writes on the "
                      f"card, never committed; {RASTER}/ and raster_card: Pillow {PIL.__version__}'s "
                      "convert(\"RGB\") (PSD, PCX, SGI, QOI, TIFF), refusals with what Pillow makes of the file; "
                      "raster_card: the originals raster_card_originals writes on the card, never committed; "
                      f"{DBFIS}/ and dbfis_card: Pillow {PIL.__version__}'s convert(\"RGB\") (DDS, BLP, FTEX, "
                      "ICNS, Sun raster, 32-bit gray TIFF), refusals with what Pillow makes of the file; "
                      "dbfis_card: the originals dbfis_card_originals writes on the card, never committed; "
                      f"{LEGACY}/ and legacy_card: Pillow {PIL.__version__}'s convert(\"RGB\") (12-bit gray and "
                      "CCITT palette TIFF, XBM, XPM, MSP, FLI, DCX, GBR, PIXAR, FITS, McIdas, XV thumbnail), "
                      "refusals with what Pillow makes of the file; legacy_card: the originals legacy_card_originals "
                      f"writes on the card, never committed; {IMIPS}/ and imips_card: Pillow {PIL.__version__}'s "
                      "convert(\"RGB\") (IM, IMT, IPTC, PCD, SPIDER, old-style LZW TIFF), refusals with what Pillow "
                      "makes of the file; imips_card: the originals imips_card_originals writes on the card, never "
                      f"committed; {LZO}/ and lzo_card: Pillow {PIL.__version__}'s convert(\"RGB\") (LZMA and ZSTD "
                      f"TIFF through libtiff {features.version('libtiff')}'s liblzma and libzstd, old-style and "
                      "12-bit JPEG TIFF, PNG past its image data), refusals with what Pillow makes of the file; "
                      "lzo_card: the originals lzo_card_originals writes on the card, never committed; "
                      f"{J2K}/: Pillow {PIL.__version__}'s convert(\"RGB\") through OpenJPEG "
                      f"{features.version('jpg_2000')} (codestreams, JP2 files, ICNS elements), refusals with what "
                      "Pillow makes of the file; "
                      f"{AVIF}/: Pillow {PIL.__version__}'s convert(\"RGB\") through libavif "
                      f"{features.version('avif')} and dav1d (Pillow's encoder over aom's settings, containers "
                      "written around its streams, 10- and 12-bit files of the system's libavif over libaom), "
                      "refusals with what Pillow makes of the file; "
                      f"{PILLOW_LANE_PREP}: the JAX package's prepare_pyramid of every slice's originals "
                      "of the Pillow lane in one folder (pillow_lane_sources)",
        "files": entries, "card": card_entries, "sources": sources, "jpeg_prep": jax_prep_digests(scratch, kinds_card),
        "pillow_prep": jax_prep_digests(scratch, pillow_card_files),
        "gif_tiff_prep": jax_prep_digests(scratch, gif_tiff_card_files),
        "raster_card": raster_card, **dbfis_parts,
        **legacy_parts, **imips_parts, **lzo_parts,
        PILLOW_LANE_PREP: jax_prep_digests(scratch, pillow_lane_originals()),
        "lab_table": {"sha256_rgb": sha256(lab_table_pillow()),
                      "made_by": f"Pillow {PIL.__version__}'s convert(\"RGB\") through LittleCMS "
                                 f"{features.version('littlecms2')} of every 8-bit Lab triple (L, a, b bands, "
                                 "the index's bytes high to low), uint8 RGB in index order"},
        "ycc_table": {"sha256_rgb": sha256(ycc_table_pillow()),
                      "made_by": f"Pillow {PIL.__version__}'s \"YCC;P\" raw mode of every triple (Y, C1, C2, the "
                                 "index's bytes high to low), uint8 RGB in index order"},
        "ycbcr_table": {"sha256_rgb": sha256(ycbcr_table_pillow()),
                        "made_by": f"Pillow {PIL.__version__}'s convert(\"RGB\") of every YCbCr triple (the index's "
                                   "bytes high to low), uint8 RGB in index order"},
    }


def write(scratch: str) -> dict:
    files = fixtures()
    webp = webp_fixtures()
    kinds = kinds_fixtures(scratch)
    pillow = pillow_fixtures(scratch)
    gif_tiff = gif_tiff_fixtures()
    ico_pnm_tga = ico_pnm_tga_fixtures()
    raster = raster_fixtures()
    dbfis = dbfis_fixtures()
    legacy = legacy_fixtures()
    imips = imips_fixtures()
    lzo = lzo_fixtures()
    j2k = j2k_fixtures()
    avif = avif_fixtures()
    for folder in (WEBP, KINDS, PILLOW, GIF_TIFF, ICO_PNM_TGA, RASTER, DBFIS, LEGACY, IMIPS, LZO, J2K, AVIF):
        shutil.rmtree(os.path.join(FIXTURES, folder), ignore_errors=True)
    for name, data in {**{k: d for k, (d, _) in files.items()}, **webp, **kinds, **pillow, **gif_tiff,
                       **ico_pnm_tga, **raster, **dbfis, **legacy, **imips, **lzo, **j2k, **avif}.items():
        os.makedirs(os.path.dirname(os.path.join(FIXTURES, name)), exist_ok=True)
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
    manifest = build_manifest(files, jax_lane(os.path.join(scratch, "build")), scratch, webp, kinds, pillow, gif_tiff,
                              ico_pnm_tga, raster, dbfis, legacy, imips, lzo, j2k, avif)
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


def check_prep(root: str, read: Callable[[str], np.ndarray], key: str) -> int:
    """The pyramid prepared under ``root`` from the card's originals of the
    JPEG kinds (``key`` "jpeg_prep"), its originals under ``pillow/card/``
    ("pillow_prep"), those under ``gif_tiff/card/`` with the written ones
    cli.prep reads (``card_originals``; "gif_tiff_prep") or every slice's
    originals of the Pillow lane (``PILLOW_LANE_PREP``) against the JAX
    package's recorded one: the number of images matched; raises
    ``AssertionError`` naming the first that differs."""
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


# --- GIF and baseline TIFF: the JAX package's Pillow lane ---------------------

GIF_TIFF = "gif_tiff"  # their files' folder under FIXTURES
#: the card's originals for cli.prep (under ``gif_tiff/card/``), each by the
#: listed name prep reads it under: a posterised 1024 px photo as a GIF with
#: a global table, the same pixels interlaced, a two-frame GIF whose first
#: frame sits at an offset on a transparent screen with a local table, and
#: an RGB scan as an LZW TIFF with predictor 2
GIF_TIFF_CARD = {"poster-1024.gif": "poster-1024.jpg", "poster-1024-interlaced.gif": "poster-1024-interlaced.png",
                 "sprite-1024.gif": "sprite-1024.jpeg", "scan-1024.tif": "scan-1024.png"}


def gif_lzw_codes(indices, min_size: int, clear_first: bool = True, end: bool = True,
                  clear_every: Optional[int] = None, clear_when_full: bool = True) -> List[Tuple[int, int]]:
    """The GIF LZW codes of an index sequence as (code, bits): each code's
    width the one a decoder reads it at (it adds an entry on every code
    but the first after a Clear, and widens once it has added entry
    2^bits - 1).  ``clear_first`` starts with a Clear, ``end`` ends with the
    end code, ``clear_every`` puts a Clear after that many indices, and
    ``clear_when_full`` a Clear once the table holds 4096 entries (else
    the codes go on at 12 bits with no new entries).  Below a minimum code
    size of 2 the width never grows past the first (a decoder's next entry
    starts above its mask), so the codes are literals alone, and at size 0
    there is no room for the end code."""
    clear = 1 << min_size
    literals = min_size < 2
    end = end and min_size > 0
    out: List[Tuple[int, int]] = []
    st: dict = {}

    def reset():
        st.update(table={(i,): i for i in range(clear)}, next=clear + 2, decoder_next=clear + 2, bits=min_size + 1,
                  first=True)

    def emit(code):
        out.append((code, st["bits"]))
        if st["first"]:
            st["first"] = False
        elif st["decoder_next"] < 4096:
            if st["decoder_next"] == (1 << st["bits"]) - 1 and st["bits"] < 12:
                st["bits"] += 1
            st["decoder_next"] += 1

    def emit_clear():
        out.append((clear, st["bits"]))
        reset()

    reset()
    if clear_first:
        emit_clear()
    run: tuple = ()
    for count, v in enumerate(int(v) for v in indices):
        if clear_every and count and count % clear_every == 0 and run:
            emit(st["table"][run])
            run = ()
            emit_clear()
        if not literals and run + (v,) in st["table"]:
            run += (v,)
            continue
        if run:
            emit(st["table"][run])
            if st["next"] < 4096:
                st["table"][run + (v,)] = st["next"]
                st["next"] += 1
            elif clear_when_full:
                emit_clear()
        run = (v,)
    if run:
        emit(st["table"][run])
    if end:
        out.append((clear + 1, st["bits"]))
    return out


def gif_pack(codes: List[Tuple[int, int]]) -> bytes:
    """GIF codes packed least significant bit first."""
    acc = nbits = 0
    out = bytearray()
    for code, size in codes:
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def gif_sub_blocks(data: bytes, size: int = 255) -> bytes:
    """``data`` in sub-blocks of ``size`` bytes, then the terminator."""
    out = bytearray()
    for i in range(0, len(data), size):
        out += bytes([len(data[i:i + size])]) + data[i:i + size]
    return bytes(out) + b"\0"


def _gif_table(palette) -> Tuple[int, bytes]:
    """The smallest colour table that holds the palette, 2^bits entries,
    zeros past the palette: (bits, bytes)."""
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(2, len(pal))))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[: min(len(pal), 1 << bits)] = pal[: 1 << bits]
    return bits, table.tobytes()


def gif_image(indices, x: int = 0, y: int = 0, palette=None, interlace: bool = False,
              min_size: int = 8, size: Optional[Tuple[int, int]] = None, data: Optional[bytes] = None,
              **lzw) -> bytes:
    """An image descriptor (at x, y; a local table where ``palette``), its
    minimum code size and its LZW data in sub-blocks: the codes of
    ``indices`` (h, w), rows in interlaced order where ``interlace``, or
    ``data`` as it stands; ``size`` (w, h) overrides the descriptor's."""
    idx = np.asarray(indices)
    h, w = idx.shape
    flags, table = 0, b""
    if palette is not None:
        b, table = _gif_table(palette)
        flags |= 0x80 | (b - 1)
    if interlace:
        flags |= 0x40
        idx = idx[[r for start, step in ((0, 8), (4, 8), (2, 4), (1, 2)) for r in range(start, h, step)]]
    if data is None:
        data = gif_sub_blocks(gif_pack(gif_lzw_codes(idx.reshape(-1), min_size, **lzw)))
    w, h = size or (w, h)
    return b"," + struct.pack("<HHHHB", x, y, w, h, flags) + table + bytes([min_size]) + data


def gif_gce(transparency: Optional[int] = None, disposal: int = 0, delay: int = 0) -> bytes:
    """A graphic control extension."""
    flags = disposal << 2 | (transparency is not None)
    return b"!\xf9\x04" + struct.pack("<BHB", flags, delay, transparency or 0) + b"\0"


def gif_extension(label: int, payload: bytes, size: int = 255) -> bytes:
    return b"!" + bytes([label]) + gif_sub_blocks(payload, size)


def gif_file(w: int, h: int, blocks: List[bytes], palette=None, version: bytes = b"GIF89a",
             trailer: bool = True) -> bytes:
    """A GIF: the screen (w, h) with a global table where ``palette``, the
    ``blocks`` and the trailer."""
    flags, table = 0, b""
    if palette is not None:
        b, table = _gif_table(palette)
        flags |= 0x80 | (b - 1)
    return (version + struct.pack("<HHBBB", w, h, flags, 0, 0) + table + b"".join(blocks)
            + (b";" if trailer else b""))


def gif_layouts() -> Dict[str, bytes]:
    """GIFs of each layout Pillow 12.1.0 reads, by this module's writer
    (Pillow's writes none of local tables beside a global one, odd code
    sizes, tables full without a Clear or missing end codes): name -> bytes."""
    r = np.random.default_rng(1701)
    h, w = 13, 11
    pal = r.integers(0, 256, (256, 3))
    idx = r.integers(0, 256, (h, w))
    small = r.integers(0, 4, (h, w))
    ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)
    photo, table = _quantised(source_image(1702, 64, 80), 6)
    out = {
        "global-87a.gif": gif_file(w, h, [gif_image(idx)], pal, version=b"GIF87a"),
        "global-89a.gif": gif_file(w, h, [gif_image(idx)], pal),
        "photo-216-colours.gif": gif_file(80, 64, [gif_image(photo)], table),
        "short-global-table.gif": gif_file(w, h, [gif_image(idx)], pal[:4]),  # indices past the table: black
        "local-table.gif": gif_file(w, h, [gif_image(idx, palette=pal[::-1])], pal),
        "local-table-only.gif": gif_file(w, h, [gif_image(small, palette=pal[:4], min_size=2)]),
        "local-ramp-global-colours.gif": gif_file(w, h, [gif_image(small, palette=ramp[:4], min_size=2)], pal[:8]),
        "global-ramp.gif": gif_file(w, h, [gif_image(idx)], ramp),
        "no-table.gif": gif_file(w, h, [gif_image(idx)]),
        "transparency-offset-frame.gif": gif_file(w + 6, h + 4, [gif_gce(transparency=9), gif_image(idx, 2, 3)], pal),
        "offset-frame.gif": gif_file(w + 6, h + 4, [gif_image(idx, 5, 1)], pal),
        "frame-past-screen.gif": gif_file(w - 4, h - 5, [gif_image(idx, 2, 1)], pal),
        "transparency-no-table.gif": gif_file(w + 2, h, [gif_gce(transparency=77), gif_image(idx, 1, 0)]),
        "interlaced.gif": gif_file(w, h, [gif_image(idx, interlace=True)], pal),
        "interlaced-3-rows.gif": gif_file(w, 3, [gif_image(idx[:3], interlace=True)], pal),
        "clear-every-17.gif": gif_file(w, h, [gif_image(idx, clear_every=17)], pal),
        "no-first-clear.gif": gif_file(w, h, [gif_image(idx, clear_first=False)], pal),
        "no-end-code.gif": gif_file(w, h, [gif_image(idx, end=False)], pal),
        "extensions.gif": gif_file(w, h, [gif_extension(254, b"a comment " * 40),
                                          gif_extension(255, b"NETSCAPE2.0", 11)[:-1] + b"\x03\x01\x05\x00\x00",
                                          gif_extension(1, bytes([12]) + bytes(12) + b"plain text"),
                                          gif_extension(0xAB, b"unknown"), gif_gce(disposal=2, delay=7),
                                          gif_image(idx)], pal),
        "two-frames.gif": gif_file(w, h, [gif_gce(disposal=1), gif_image(idx), gif_gce(transparency=0),
                                          gif_image(small, 1, 1, palette=pal[:4], min_size=2)], pal),
        "zero-width-at-x0.gif": gif_file(w, h, [gif_image(idx, 0, 4, size=(0, 3))], pal),  # Pillow: the whole screen
    }
    big = r.integers(0, 256, (96, 160))  # more codes than 4096 entries hold
    out["table-full-no-clear.gif"] = gif_file(160, 96, [gif_image(big, clear_when_full=False)], pal)
    out["table-full-clear.gif"] = gif_file(160, 96, [gif_image(big)], pal)
    for bits in (0, 1, 2, 3, 4, 5, 6, 7, 9, 12):
        top = min(1 << bits, 256) if bits <= 8 else 256
        codes = r.integers(0, top, (h, w)) if bits else np.zeros((h, w), np.int64)
        out[f"code-size-{bits}.gif"] = gif_file(w, h, [gif_image(codes, min_size=bits)], pal[: max(2, top)])
    return {f"{GIF_TIFF}/gif/{k}": v for k, v in sorted(out.items())}


def gif_refusals() -> Dict[str, Tuple[bytes, str]]:
    """GIFs Pillow 12.1.0 refuses: name -> (bytes, the reason the port's
    ``OSError`` names, a regular expression)."""
    r = np.random.default_rng(1703)
    h, w = 9, 7
    pal = r.integers(0, 256, (256, 3))
    idx = r.integers(0, 256, (h, w))
    whole = gif_file(w, h, [gif_image(idx)], pal)
    stream = gif_pack(gif_lzw_codes(idx.reshape(-1)[:30], 8))
    broken = gif_pack([(256, 9), (5, 9), (300, 9)] + [(5, 9)] * 80)
    return {
        "screen-only.gif": (b"GIF89a" + bytes(20), "holds no image"),
        "trailer-only.gif": (gif_file(w, h, [], pal), "holds no image"),
        "cut-in-data.gif": (whole[: len(whole) - 40], "truncated"),
        "cut-in-header.gif": (whole[:9], "cut short or malformed"),
        "cut-in-descriptor.gif": (gif_file(w, h, [], pal, trailer=False) + b",\0\0\0", "cut short or malformed"),
        "early-end-code.gif": (gif_file(w, h, [gif_image(idx, data=gif_sub_blocks(stream))], pal), "truncated"),
        "code-past-table.gif": (gif_file(w, h, [gif_image(idx, data=gif_sub_blocks(broken))], pal), "broken GIF"),
        "code-size-13.gif": (gif_file(w, h, [gif_image(idx, min_size=13, data=gif_sub_blocks(bytes(40)))], pal),
                             "above 12"),
        "zero-width.gif": (gif_file(w, h, [gif_image(idx, 1, 0, size=(0, h))], pal), "no width or no height"),
        "short-control-extension.gif": (gif_file(w, h, [b"!\xf9\x02\x01\x00\x00", gif_image(idx)], pal),
                                        "cut short or malformed"),
    }


def tiff_lzw(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW (MSB-first codes, widened one code early as libtiff
    reads them; or, ``old_style``, the codes of libtiff before 5.0, which
    its LZWDecodeCompat reads: LSB-first, widened one code late): a Clear
    first, a Clear whenever the table reaches 4094 entries, the end code
    last."""
    out = bytearray()
    acc = nbits = 0
    bits, decoder_next, first = 9, 258, True
    late = 1 if old_style else 2

    def emit(code):
        nonlocal acc, nbits, bits, decoder_next, first
        if old_style:
            acc |= code << nbits
            nbits += bits
            while nbits >= 8:
                nbits -= 8
                out.append(acc & 255)
                acc >>= 8
        else:
            acc = (acc << bits) | code
            nbits += bits
            while nbits >= 8:
                nbits -= 8
                out.append((acc >> nbits) & 255)
            acc &= (1 << nbits) - 1
        if code == 256:
            bits, decoder_next, first = 9, 258, True
        elif first:
            first = False
        else:
            decoder_next += 1
            if decoder_next > (1 << bits) - late and bits < 12:
                bits += 1

    emit(256)
    table: Dict[int, int] = {}  # (prefix code << 8 | byte) -> code
    next_code, run = 258, -1
    for byte in data:
        if run < 0:
            run = byte
            continue
        code = table.get(run << 8 | byte)
        if code is not None:
            run = code
            continue
        emit(run)
        table[run << 8 | byte] = next_code
        next_code += 1
        run = byte
        if next_code >= 4094:
            emit(run)
            run = -1
            emit(256)
            table.clear()
            next_code = 258
    if run >= 0:
        emit(run)
    emit(257)
    if nbits:
        out.append(acc & 255 if old_style else (acc << (8 - nbits)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes, literal runs of up to 128."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 255, data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


TIFF_COMPRESS = {1: lambda b: b, 5: tiff_lzw, 8: zlib.compress, 32946: zlib.compress, 32773: packbits}


def _tiff_rows(block: np.ndarray, bits: int, order: str) -> np.ndarray:
    """(h, w, c) samples as TIFF rows of bytes (h, row bytes)."""
    h, w, c = block.shape
    if bits in (16, 32):
        return block.astype(f"{order}u{bits // 8}").view(np.uint8).reshape(h, w * c * bits // 8)
    if bits == 8:
        return block.astype(np.uint8).reshape(h, w * c)
    if bits == 12:  # two samples in three bytes, the first's high bits first; rows padded to a byte
        bit = (block.reshape(h, w * c, 1).astype(np.int64) >> np.arange(11, -1, -1)) & 1
        return np.packbits(bit.astype(np.uint8).reshape(h, -1), axis=1)
    return _pack(block.reshape(h, w * c, 1), bits)


def tiff_bytes(samples, bits: int = 8, photometric: int = 2, order: str = "<", compression: int = 1,
               predictor: int = 1, planar: int = 1, rows_per_strip: Optional[int] = None,
               tile: Optional[Tuple[int, int]] = None, extra=None, colormap=None, orientation: Optional[int] = None,
               tags: Optional[Dict[int, Tuple[int, list]]] = None, data: Optional[bytes] = None,
               chunks: Optional[List[bytes]] = None, big: bool = False, offset_type: int = 16,
               old_lzw: bool = False, compress: Optional[Callable[[bytes], bytes]] = None) -> bytes:
    """A TIFF of ``samples`` ((h, w) or (h, w, c) integers of ``bits``) in
    byte order ``order`` ("<" II, ">" MM): strips of ``rows_per_strip`` or
    tiles (th, tw), each plane apart where ``planar`` is 2, differenced
    horizontally where ``predictor`` is 2 (whatever the compression: a
    reader applies it under LZW and Deflate alone), then compressed
    (``TIFF_COMPRESS``, or ``data`` as every chunk, or ``chunks``, one
    each); ``tags`` (id -> (type, values), a RATIONAL's values numerator,
    denominator pairs, UNDEFINED (7) bytes) add to or replace the
    directory's.  ``big``: a BigTIFF (version 43, 8-byte offsets, 20-byte
    entries), its chunks' offsets and byte counts of ``offset_type``
    (LONG8, 16, or LONG, 4).  ``old_lzw``: LZW of old-style codes
    (``tiff_lzw(old_style=True)``); ``compress``: each chunk's coder where
    ``TIFF_COMPRESS`` has none (LZMA's, ZSTD's)."""
    s = np.asarray(samples)
    s = s[:, :, None] if s.ndim == 2 else s
    h, w, c = s.shape
    planes = [s[:, :, k:k + 1] for k in range(c)] if planar == 2 else [s]
    blocks = []
    for p in planes:
        if tile:
            th, tw = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, p.shape[2]), s.dtype)
                    part = p[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    blocks.append(blk)
        else:
            blocks += [p[y:y + (rows_per_strip or h)] for y in range(0, h, rows_per_strip or h)]
    coded = []
    for blk in blocks:
        if predictor == 2:
            blk = blk.astype(np.int64)
            blk[:, 1:] -= blk[:, :-1].copy()
            blk %= 1 << bits
        if chunks is None:
            raw = _tiff_rows(blk, bits, order).tobytes()
            coded.append(data if data is not None else tiff_lzw(raw, True) if old_lzw and compression == 5 else
                         compress(raw) if compress is not None else TIFF_COMPRESS[compression](raw))
    chunks = coded if chunks is None else chunks
    body = bytearray((b"II" if order == "<" else b"MM") +
                     (struct.pack(order + "HHHQ", 43, 8, 0, 0) if big else struct.pack(order + "HI", 42, 0)))
    offsets = []
    for chunk in chunks:
        offsets.append(len(body))
        body += chunk + b"\0" * (len(chunk) % 2)
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c), 259: (3, [compression]), 262: (3, [photometric]),
         277: (3, [c]), 284: (3, [planar])}
    if predictor != 1:
        t[317] = (3, [predictor])
    at = offset_type if big else 4
    if tile:
        t.update({322: (3, [tile[1]]), 323: (3, [tile[0]]), 324: (at, offsets), 325: (at, list(map(len, chunks)))})
    else:
        t.update({273: (at, offsets), 278: (4, [rows_per_strip or h]), 279: (at, list(map(len, chunks)))})
    if extra is not None:
        t[338] = (3, list(extra))
    if colormap is not None:
        t[320] = (3, list(np.asarray(colormap).T.reshape(-1)))
    if orientation is not None:
        t[274] = (3, [orientation])
    t.update(tags or {})
    entries = sorted(t.items())
    ifd_at = len(body)
    field, entry, count = (8, "HHQ", "Q") if big else (4, "HHI", "H")
    values_at = ifd_at + struct.calcsize(order + count) + (20 if big else 12) * len(entries) + field
    ifd, values = bytearray(struct.pack(order + count, len(entries))), bytearray()
    for tag, (typ, vals) in entries:
        # RATIONAL (5): vals are numerator, denominator pairs
        raw = struct.pack(order + {1: "B", 3: "H", 4: "I", 5: "I", 7: "B", 11: "f", 16: "Q"}[typ] * len(vals),
                          *map(int, vals))
        if len(raw) > field:
            where = struct.pack(order + ("Q" if big else "I"), values_at + len(values))
            values += raw + b"\0" * (len(raw) % 2)
        else:
            where = raw + bytes(field - len(raw))
        ifd += struct.pack(order + entry, tag, typ, len(vals) // 2 if typ == 5 else len(vals)) + where
    if big:
        body[8:16] = struct.pack(order + "Q", ifd_at)
    else:
        body[4:8] = struct.pack(order + "I", ifd_at)
    return bytes(body + ifd + bytes(field) + values)


JPEG_TIFF_MODES = {1: "L", 2: "RGB", 5: "CMYK", 6: "RGB"}  # photometric -> Pillow's JPEG mode
JPEG_TIFF_SAMPLING = {(1, 1): 0, (2, 1): 1, (2, 2): 2}   # luma factors -> Pillow's subsampling


def _jpeg_segments(stream: bytes) -> List[Tuple[int, bytes]]:
    """A JPEG stream's marker segments up to its scan: (marker, whole
    segment); the scan's header and data, to EOI, as the last (0xDA, ...)."""
    out, i = [], 2
    while True:
        m, n = stream[i + 1], struct.unpack(">H", stream[i + 2:i + 4])[0]
        if m == 0xDA:
            return out + [(m, stream[i:])]
        out.append((m, stream[i:i + 2 + n]))
        i += 2 + n


def jpeg_tiff_stream(block: np.ndarray, photometric: int, quality: int, sampling=(2, 2)) -> bytes:
    """One strip's or tile's JPEG stream as Pillow's libjpeg writes it:
    gray (photometric 0, 1), RGB kept as RGB (2), CMYK (5), or YCbCr
    converted from RGB (6) with luma factors ``sampling``."""
    mode = JPEG_TIFF_MODES[max(photometric, 1)]
    from PIL import Image

    block = block.astype(np.uint8)
    im = Image.fromarray(block[..., 0] if block.shape[2] == 1 else block, "CMYK" if photometric == 5 else None)
    im = im.convert(mode)
    buf = io.BytesIO()
    kw = {"subsampling": JPEG_TIFF_SAMPLING[tuple(sampling)]} if photometric == 6 else {"keep_rgb": True}
    im.save(buf, format="JPEG", quality=quality, **kw)
    return buf.getvalue()


def jpeg_tiff(samples: np.ndarray, photometric: int = 6, quality: int = 90, sampling=(2, 2),
              rows_per_strip: Optional[int] = None, tile: Optional[Tuple[int, int]] = None, tables: bool = True,
              sampling_tag="stream", full_last: bool = False, encode: Optional[Callable[[np.ndarray], bytes]] = None,
              planar: int = 1, **kw) -> bytes:
    """A JPEG-compressed TIFF (Compression 7) of ``samples`` ((h, w) gray,
    (h, w, 3) RGB or (h, w, 4) CMYK), a JPEG stream a strip (the last one
    as tall as the others where ``full_last``) or a tile (edges repeated
    past the image), by ``jpeg_tiff_stream``; where ``tables``, their
    quantisation and Huffman tables in JPEGTables alone (abbreviated
    streams).  YCbCr (photometric 6): YCbCrSubsampling ``sampling`` where
    ``sampling_tag`` is "stream", another pair, or absent where None.
    ``encode`` (an RGB block -> a YCbCr JPEG of those factors) writes the
    streams in place of Pillow.  Where ``planar`` is 2 each plane's strips
    or tiles follow the plane before, each a gray stream of that plane's
    samples as they are (YCbCr ones too).  ``kw`` goes to ``tiff_bytes``."""
    s = np.asarray(samples)
    s = s[:, :, None] if s.ndim == 2 else s
    h, w, c = s.shape
    streams = []
    for p in [s[:, :, k:k + 1] for k in range(c)] if planar == 2 else [s]:
        if tile:
            th, tw = tile
            padded = np.pad(p, ((0, -h % th), (0, -w % tw), (0, 0)), mode="edge")
            blocks = [padded[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
        else:
            rps = rows_per_strip or h
            blocks = [p[y:y + rps] for y in range(0, h, rps)]
            if full_last and h % rps:
                blocks[-1] = np.pad(blocks[-1], ((0, rps - blocks[-1].shape[0]), (0, 0), (0, 0)), mode="edge")
        streams += [encode(b.astype(np.uint8)) if encode else
                    jpeg_tiff_stream(b, 1 if planar == 2 else photometric, quality, sampling) for b in blocks]
    tags = dict(kw.pop("tags", {}) or {})
    if tables:
        segs = _jpeg_segments(streams[0])
        table = b"\xff\xd8" + b"".join(d for m, d in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
        streams = [b"\xff\xd8" + b"".join(d for m, d in _jpeg_segments(st) if m not in (0xDB, 0xC4)) for st in streams]
        tags[347] = (7, list(table))
    if photometric == 6 and sampling_tag is not None:
        tags[530] = (3, list(sampling if sampling_tag == "stream" else sampling_tag))
    return tiff_bytes(np.zeros((h, w, c), np.uint8), photometric=photometric, compression=7,
                      rows_per_strip=rows_per_strip, tile=tile, tags=tags, chunks=streams, planar=planar, **kw)


def port_jpeg(img: np.ndarray, quality: int) -> bytes:
    """libjpeg's bytes (baseline, 4:2:0, the standard tables) for an RGB
    image, by the port's encoder (``native.encode_jpeg``), which the card's
    machine has without an image library."""
    import tempfile

    from byogan_tpu_torch.data import native

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.jpg")
        native.encode_jpeg(path, img, quality)
        with open(path, "rb") as f:
            return f.read()


def ycbcr_blocks(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """Packed YCbCr data: for each block of hs x vs luma samples (y (h, w),
    zeros past its edges) the block's samples row by row, then its Cb and
    Cr (cb, cr (ceil(h/vs), ceil(w/hs))): (block rows, blocks, hs*vs + 2)."""
    h, w = y.shape
    bh, bw = -(-h // vs), -(-w // hs)
    yp = np.zeros((bh * vs, bw * hs), np.uint8)
    yp[:h, :w] = y
    out = np.zeros((bh, bw, hs * vs + 2), np.uint8)
    out[:, :, :hs * vs] = yp.reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(bh, bw, hs * vs)
    out[:, :, -2], out[:, :, -1] = cb, cr
    return out


def ycbcr_tiff(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int, compression: int = 5,
               rows_per_strip: Optional[int] = None, tile: Optional[Tuple[int, int]] = None,
               sampling_tag: bool = True, **kw) -> bytes:
    """A YCbCr TIFF (photometric 6) of subsampled planes (``ycbcr_blocks``),
    a strip's rows (a multiple of vs) or a tile's blocks each compressed
    apart; YCbCrSubsampling (hs, vs) unless not ``sampling_tag``; ``kw``
    goes to ``tiff_bytes`` (YCbCrCoefficients 529, ReferenceBlackWhite 532
    as ``tags``)."""
    h, w = y.shape
    comp, chunks = TIFF_COMPRESS[compression], []
    if tile:
        th, tw = tile
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                part = [np.zeros((n, m), np.uint8) for n, m in ((th, tw), (th // vs, tw // hs), (th // vs, tw // hs))]
                for p, src, (y0, x0) in zip(part, (y, cb, cr), ((ty, tx), (ty // vs, tx // hs), (ty // vs, tx // hs))):
                    cut = src[y0:y0 + p.shape[0], x0:x0 + p.shape[1]]
                    p[:cut.shape[0], :cut.shape[1]] = cut
                chunks.append(comp(ycbcr_blocks(*part, hs, vs).tobytes()))
    else:
        rps = rows_per_strip or h
        for y0 in range(0, h, rps):
            rows = slice(y0 // vs, -(-(y0 + rps) // vs))
            chunks.append(comp(ycbcr_blocks(y[y0:y0 + rps], cb[rows], cr[rows], hs, vs).tobytes()))
    tags = dict(kw.pop("tags", {}) or {})
    if sampling_tag:
        tags[530] = (3, [hs, vs])
    return tiff_bytes(np.zeros((h, w, 3), np.uint8), photometric=6, compression=compression,
                      rows_per_strip=rows_per_strip, tile=tile, tags=tags, chunks=chunks, **kw)


def ycbcr_planes(r, h: int, w: int, hs: int, vs: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded luma (h, w) and chroma (ceil(h/vs), ceil(w/hs)) planes."""
    shape = (-(-h // vs), -(-w // hs))
    return (r.integers(0, 256, (h, w)).astype(np.uint8), r.integers(0, 256, shape).astype(np.uint8),
            r.integers(0, 256, shape).astype(np.uint8))


def ycbcr_jpeg_layouts() -> Dict[str, bytes]:
    """TIFFs of JPEG compression and of YCbCr pixels, each layout the port
    reads: name -> bytes."""
    r = np.random.default_rng(1901)
    h, w = 27, 21
    photo = np.clip(smooth_scene(1902, h, w, cell=8, step=4).astype(np.int64) + r.integers(-9, 10, (h, w, 3)), 0, 255)
    cmyk = np.concatenate([photo, photo.min(axis=2, keepdims=True) // 3], 2)
    out = {}
    for q in (50, 90):
        for samp in ((1, 1), (2, 1), (2, 2)):
            name = f"jpeg-ycbcr-{samp[0]}x{samp[1]}-q{q}"
            out[f"{name}-strips-11.tif"] = jpeg_tiff(photo, 6, q, samp, rows_per_strip=11)
            out[f"{name}-tiles.tif"] = jpeg_tiff(photo, 6, q, samp, tile=(16, 16))
        out[f"jpeg-gray-q{q}-strips-8.tif"] = jpeg_tiff(photo[..., 1], 1, q, rows_per_strip=8)
        out[f"jpeg-rgb-q{q}.tif"] = jpeg_tiff(photo, 2, q)
        out[f"jpeg-cmyk-q{q}-tiles.tif"] = jpeg_tiff(cmyk, 5, q, tile=(32, 16))
    out.update({
        "jpeg-ycbcr-2x2-inline-tables.tif": jpeg_tiff(photo, 6, 75, rows_per_strip=16, tables=False),
        "jpeg-ycbcr-2x2-no-subsampling-tag.tif": jpeg_tiff(photo, 6, 75, sampling_tag=None),
        "jpeg-ycbcr-1x1-no-subsampling-tag.tif": jpeg_tiff(photo, 6, 75, (1, 1), sampling_tag=None),
        "jpeg-ycbcr-2x1-last-strip-full.tif": jpeg_tiff(photo, 6, 75, (2, 1), rows_per_strip=16, full_last=True),
        "jpeg-ycbcr-2x2-mm-orientation-6.tif": jpeg_tiff(photo, 6, 75, order=">", orientation=6, rows_per_strip=24),
        "jpeg-white-is-zero.tif": jpeg_tiff(photo[..., 0], 0, 75, rows_per_strip=5),
    })
    samplings = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
    for hs, vs in samplings:
        for comp, cname in ((5, "lzw"), (8, "deflate"), (32773, "packbits")):
            planes = ycbcr_planes(r, 13, 11, hs, vs)
            out[f"ycbcr-{hs}x{vs}-{cname}-strips.tif"] = ycbcr_tiff(*planes, hs, vs, comp, rows_per_strip=4 // vs * vs or vs)
        out[f"ycbcr-{hs}x{vs}-lzw-tiles.tif"] = ycbcr_tiff(*ycbcr_planes(r, 20, 19, hs, vs), hs, vs, tile=(16, 16))
        out[f"ycbcr-{hs}x{vs}-lzw-one-strip.tif"] = ycbcr_tiff(*ycbcr_planes(r, 9, 7, hs, vs), hs, vs)
    yuv = r.integers(0, 256, (9, 7, 3))
    out.update({
        "ycbcr-2x2-lzw-no-subsampling-tag.tif": ycbcr_tiff(*ycbcr_planes(r, 9, 7, 2, 2), 2, 2, sampling_tag=False),
        "ycbcr-1x1-lzw-coefficients.tif": ycbcr_tiff(*ycbcr_planes(r, 9, 7, 1, 1), 1, 1, tags={
            529: (5, [2126, 10000, 7152, 10000, 722, 10000])}),
        "ycbcr-2x1-deflate-reference-black-white.tif": ycbcr_tiff(*ycbcr_planes(r, 9, 7, 2, 1), 2, 1, 8, tags={
            532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}),
        "ycbcr-4x2-lzw-both-tags-mm.tif": ycbcr_tiff(*ycbcr_planes(r, 11, 13, 4, 2), 4, 2, order=">", tags={
            529: (5, [299, 1000, 587, 1000, 114, 1000]), 532: (5, [15, 1, 236, 1, 127, 2, 511, 2, 100, 1, 200, 1])}),
        "ycbcr-1x1-lzw-planar.tif": tiff_bytes(yuv, photometric=6, compression=5, planar=2, tags={530: (3, [1, 1])}),
        "ycbcr-2x2-lzw-orientation-3.tif": ycbcr_tiff(*ycbcr_planes(r, 9, 7, 2, 2), 2, 2, orientation=3),
        # Pillow's raw decoder: RGBX, unconverted, four bytes a pixel read on past the strip (the file that
        # tiff_refusals named ycbcr.tif before the port read it)
        "ycbcr-raw.tif": tiff_bytes(np.random.default_rng(1705).integers(0, 256, (9, 7, 3)), photometric=6),
        "ycbcr-raw-planar.tif": tiff_bytes(yuv, photometric=6, planar=2),
        "ycbcr-raw-one-sample.tif": tiff_bytes(yuv[..., 0], photometric=6),
    })
    return out


def tiff_layouts() -> Dict[str, bytes]:
    """TIFFs of each layout the port reads, by ``tiff_bytes``: name -> bytes."""
    r = np.random.default_rng(1704)
    h, w = 13, 11
    rgb = r.integers(0, 256, (h, w, 3))
    rgba = r.integers(0, 256, (h, w, 4))
    rgba[0, :4, 3] = [0, 1, 128, 255]
    gray = r.integers(0, 256, (h, w))
    gray16 = r.integers(0, 65536, (h, w))
    gray16[0, :4] = [0, 255, 256, 65535]
    bits1 = r.integers(0, 2, (h, w))
    cmap = r.integers(0, 65536, (256, 3))
    comps = {"raw": 1, "packbits": 32773, "lzw": 5, "deflate": 8, "adobe-deflate": 32946}
    out = {}
    for cname, comp in comps.items():
        out[f"rgb-{cname}.tif"] = tiff_bytes(rgb, compression=comp, rows_per_strip=5)
        out[f"gray8-{cname}.tif"] = tiff_bytes(gray, photometric=1, compression=comp)
        out[f"bilevel-white-{cname}.tif"] = tiff_bytes(bits1, 1, photometric=0, compression=comp, rows_per_strip=4)
        out[f"palette-{cname}.tif"] = tiff_bytes(gray, photometric=3, compression=comp, colormap=cmap)
    for order, oname in (("<", "ii"), (">", "mm")):
        out[f"gray16-{oname}-lzw-predictor.tif"] = tiff_bytes(gray16, 16, 1, order, 5, 2, rows_per_strip=6)
        out[f"gray16-{oname}-raw.tif"] = tiff_bytes(gray16, 16, 1, order)
        out[f"rgb-{oname}-deflate-predictor.tif"] = tiff_bytes(rgb, order=order, compression=8, predictor=2)
        out[f"rgb-{oname}-lzw-tiles.tif"] = tiff_bytes(rgb, order=order, compression=5, tile=(16, 16))
    out.update({
        "gray8-white-lzw.tif": tiff_bytes(gray, photometric=0, compression=5),
        "gray16-white-ii-raw.tif": tiff_bytes(gray16, 16, 0),  # I;16: not inverted
        "bilevel-black-lzw.tif": tiff_bytes(bits1, 1, photometric=1, compression=5),
        "bilevel-black-raw-tiles.tif": tiff_bytes(bits1, 1, photometric=1, tile=(16, 16)),
        "gray-alpha-lzw.tif": tiff_bytes(r.integers(0, 256, (h, w, 2)), photometric=1, compression=5, extra=(2,)),
        "rgba-unassociated-lzw.tif": tiff_bytes(rgba, compression=5, extra=(2,)),
        "rgba-associated-lzw.tif": tiff_bytes(rgba, compression=5, extra=(1,)),  # divided out
        "rgba-associated-raw.tif": tiff_bytes(rgba, extra=(1,)),
        "rgbx-unspecified-deflate.tif": tiff_bytes(rgba, compression=8, extra=(0,)),
        "rgba-no-extrasamples-packbits.tif": tiff_bytes(rgba, compression=32773),
        "rgb-3-extra-lzw.tif": tiff_bytes(r.integers(0, 256, (h, w, 6)), compression=5, extra=(1, 0, 0)),
        "rgb-planar-lzw-predictor.tif": tiff_bytes(rgb, compression=5, predictor=2, planar=2, rows_per_strip=4),
        "rgb-planar-raw-tiles.tif": tiff_bytes(rgb, planar=2, tile=(16, 16)),
        "rgba-planar-associated-lzw.tif": tiff_bytes(rgba, compression=5, planar=2, extra=(1,)),
        "rgba-planar-no-extrasamples-lzw.tif": tiff_bytes(rgba, compression=5, planar=2),  # divided out too
        "palette-lzw-predictor.tif": tiff_bytes(gray, photometric=3, compression=5, predictor=2, colormap=cmap),
        "rgb-packbits-predictor.tif": tiff_bytes(rgb, compression=32773, predictor=2),  # no predictor applied
        "rgb-raw-predictor.tif": tiff_bytes(rgb, predictor=2),  # likewise
        "gray8-raw-tiles-48x32.tif": tiff_bytes(r.integers(0, 256, (40, 37)), photometric=1, tile=(48, 32)),
    })
    # the kinds past the baseline that Pillow reads without a codec library
    f32 = r.normal(100, 120, (h, w)).astype(np.float32)
    f32[0, :4] = [0.25, 254.99, np.nan, -3]
    cmyk = r.integers(0, 256, (h, w, 4))
    rgb16 = r.integers(0, 65536, (h, w, 3))
    rgba16 = r.integers(0, 65536, (h, w, 4))
    rgba16[0, :3, 3] = [0, 255, 65535]
    signed = r.integers(-32768, 32768, (h, w)) & 0xFFFF
    for cname, comp in comps.items():
        for bits in (2, 4):
            g = gray >> (8 - bits)
            out[f"gray{bits}-{cname}.tif"] = tiff_bytes(g, bits, 1, compression=comp, rows_per_strip=5)
            out[f"gray{bits}-white-{cname}.tif"] = tiff_bytes(g, bits, 0, compression=comp)
            out[f"palette{bits}-{cname}.tif"] = tiff_bytes(g, bits, 3, compression=comp,
                                                           colormap=r.integers(0, 65536, (1 << bits, 3)))
        out[f"cmyk-{cname}.tif"] = tiff_bytes(cmyk, photometric=5, compression=comp, rows_per_strip=6)
        out[f"rgb16-{cname}.tif"] = tiff_bytes(rgb16, 16, compression=comp)
        out[f"signed16-{cname}.tif"] = tiff_bytes(signed, 16, 1, compression=comp, tags={339: (3, [2])})
        out[f"float-{cname}.tif"] = tiff_bytes(f32.view("<u4"), 32, 1, compression=comp, tags={339: (3, [3])})
        fill = tiff_bytes(gray, photometric=1, compression=comp, tags={266: (3, [2])})
        if comp != 1:  # the coded bytes' bits reversed, as the tag says
            fill = tiff_bytes(gray, photometric=1, compression=comp, tags={266: (3, [2])},
                              data=bytes(_reverse_bits(TIFF_COMPRESS[comp](gray.astype(np.uint8).tobytes()))))
        out[f"fill-order-2-gray8-{cname}.tif"] = fill
    for order, oname in (("<", "ii"), (">", "mm")):
        out[f"signed16-{oname}-lzw-predictor.tif"] = tiff_bytes(signed, 16, 1, order, 5, 2, tags={339: (3, [2])})
        out[f"signed16-{oname}-raw.tif"] = tiff_bytes(signed, 16, 1, order, tags={339: (3, [2])})
        out[f"float-{oname}-deflate-predictor.tif"] = tiff_bytes(f32.astype(order + "f4").view(order + "u4"), 32, 0,
                                                                 order, 8, 2, tags={339: (3, [3])})
        out[f"float-{oname}-raw.tif"] = tiff_bytes(f32.astype(order + "f4").view(order + "u4"), 32, 1, order,
                                                   tags={339: (3, [3])})
        out[f"rgb16-{oname}-lzw-predictor-tiles.tif"] = tiff_bytes(rgb16, 16, order=order, compression=5, predictor=2,
                                                                   tile=(16, 16))
        out[f"cmyk16-{oname}-lzw.tif"] = tiff_bytes(cmyk * 257, 16, 5, order, 5)
    for extra in (None, (0,), (1,), (2,)):
        tag = "none" if extra is None else extra[0]
        out[f"rgba16-extra-{tag}-lzw.tif"] = tiff_bytes(rgba16, 16, compression=5, extra=extra)
        out[f"rgba16-extra-{tag}-raw.tif"] = tiff_bytes(rgba16, 16, extra=extra)
    out.update({
        "signed8-lzw.tif": tiff_bytes(gray, photometric=1, compression=5, tags={339: (3, [2])}),
        "signed8-raw.tif": tiff_bytes(gray, photometric=1, tags={339: (3, [2])}),
        "cmyk-x-lzw.tif": tiff_bytes(r.integers(0, 256, (h, w, 5)), photometric=5, compression=5, extra=(0,)),
        "cmyk-xx-raw.tif": tiff_bytes(r.integers(0, 256, (h, w, 6)), photometric=5, extra=(0, 0)),
        "cmyk-planar-lzw.tif": tiff_bytes(cmyk, photometric=5, compression=5, planar=2),
        "cmyk-planar-raw.tif": tiff_bytes(cmyk, photometric=5, planar=2),
        "cmyk-lzw-predictor-tiles.tif": tiff_bytes(cmyk, photometric=5, compression=5, predictor=2, tile=(16, 16)),
        "rgb16-planar-lzw.tif": tiff_bytes(rgb16, 16, compression=5, planar=2),
        "rgb16-planar-raw.tif": tiff_bytes(rgb16, 16, planar=2),  # Pillow reads each plane a byte a sample
        "gray4-planar-raw.tif": tiff_bytes(gray >> 4, 4, 1, planar=2),  # likewise
        "palette1-raw.tif": tiff_bytes(bits1, 1, 3, colormap=r.integers(0, 65536, (2, 3))),
        "palette4-raw-256-entries.tif": tiff_bytes(gray >> 4, 4, 3, colormap=cmap),
        "gray4-raw-tiles.tif": tiff_bytes(r.integers(0, 16, (40, 37)), 4, 1, tile=(16, 32)),
        "fill-order-2-bilevel-white-raw.tif": tiff_bytes(bits1, 1, photometric=0, tags={266: (3, [2])}),
        "fill-order-2-bilevel-black-raw.tif": tiff_bytes(bits1, 1, photometric=1, tags={266: (3, [2])}),
        "fill-order-2-gray4-white-raw.tif": tiff_bytes(gray >> 4, 4, 0, tags={266: (3, [2])}),
        "fill-order-2-gray16-ii-raw.tif": tiff_bytes(gray16, 16, 1, tags={266: (3, [2])}),
        "fill-order-2-rgb-raw.tif": tiff_bytes(rgb, tags={266: (3, [2])}),
        "fill-order-2-palette8-raw.tif": tiff_bytes(gray, photometric=3, colormap=cmap, tags={266: (3, [2])}),
        "fill-order-2-gray8-white-lzw.tif": tiff_bytes(gray, photometric=0, compression=5, tags={266: (3, [2])},
                                                       data=bytes(_reverse_bits(tiff_lzw(gray.astype(np.uint8)
                                                                                         .tobytes())))),
        "gray8-white-planar-raw.tif": tiff_bytes(gray, photometric=0, planar=2),  # a plane's raw mode: L, not L;I
        "bilevel-white-planar-raw.tif": tiff_bytes(bits1, 1, photometric=0, planar=2),
    })
    for o in range(1, 9):
        out[f"rgb-lzw-orientation-{o}.tif"] = tiff_bytes(rgb, compression=5, orientation=o, rows_per_strip=6)
    out["gray8-raw-orientation-6.tif"] = tiff_bytes(gray, photometric=1, orientation=6)  # mapped at swapped size
    out["rgb-raw-orientation-5.tif"] = tiff_bytes(rgb, orientation=5)
    out.update(ycbcr_jpeg_layouts())
    # the file that tiff_refusals named ycbcr-lzw-predictor.tif before the port read it: its blocks never
    # differenced, so the predictor's sums are what Pillow shows
    out["ycbcr-lzw-predictor.tif"] = ycbcr_predictor_tiff(_refusal_draws(), 9, 7, 1, 1)
    return {f"{GIF_TIFF}/tiff/{k}": v for k, v in sorted(out.items())}


def ycbcr_predictor_tiff(r, h: int, w: int, hs: int, vs: int, compression: int = 5, **kw) -> bytes:
    """``ycbcr_tiff`` of seeded planes with Predictor 2 (the blocks as they
    are: a reader differences them back, on its own row unit)."""
    return ycbcr_tiff(*ycbcr_planes(r, h, w, hs, vs), hs, vs, compression, predictor=2, **kw)


def jpeg_planes_predictor_layouts() -> Dict[str, bytes]:
    """TIFFs of JPEG streams in separate planes (gray, RGB, CMYK, YCbCr 1 x
    1) and of YCbCr blocks under Predictor 2 (1 x 1, 2 x 1, 2 x 2, 4 x 2
    and 4 x 4, widths that leave blocks partly shown, strips and tiles,
    rows whose unit libtiff's predictor does not divide, PackBits, which
    takes no predictor): name -> bytes."""
    r = np.random.default_rng(2001)
    h, w = 27, 21
    photo = np.clip(smooth_scene(2002, h, w, cell=8, step=4).astype(np.int64) + r.integers(-9, 10, (h, w, 3)), 0, 255)
    cmyk = np.concatenate([photo, photo.min(axis=2, keepdims=True) // 3], 2)
    yuv = r.integers(16, 240, (h, w, 3))
    out = {
        "jpeg-planes-rgb-strips-5.tif": jpeg_tiff(photo, 2, 85, rows_per_strip=5, planar=2),
        "jpeg-planes-rgb-tiles-mm.tif": jpeg_tiff(photo, 2, 60, tile=(16, 16), planar=2, order=">"),
        "jpeg-planes-rgb-inline-tables.tif": jpeg_tiff(photo, 2, 75, rows_per_strip=8, tables=False, planar=2),
        "jpeg-planes-rgb-last-strip-full.tif": jpeg_tiff(photo, 2, 75, rows_per_strip=8, full_last=True, planar=2),
        "jpeg-planes-gray.tif": jpeg_tiff(photo[..., 1], 1, 90, rows_per_strip=10, planar=2),
        "jpeg-planes-cmyk-tiles.tif": jpeg_tiff(cmyk, 5, 80, tile=(32, 16), planar=2),
        "jpeg-planes-ycbcr-1x1-strips-5.tif": jpeg_tiff(yuv, 6, 90, (1, 1), rows_per_strip=5, planar=2),
        "jpeg-planes-ycbcr-1x1-tiles.tif": jpeg_tiff(yuv, 6, 70, (1, 1), tile=(16, 32), planar=2),
        "jpeg-planes-ycbcr-1x1-tags-orientation-6.tif": jpeg_tiff(yuv, 6, 90, (1, 1), rows_per_strip=9, planar=2,
                                                                  orientation=6, tags={
            529: (5, [2126, 10000, 7152, 10000, 722, 10000]), 532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}),
    }
    for hs, vs in ((1, 1), (2, 1), (2, 2), (4, 2), (4, 4)):
        for width in (7, 13):
            out[f"ycbcr-{hs}x{vs}-lzw-predictor-w{width}.tif"] = ycbcr_predictor_tiff(r, 11, width, hs, vs,
                                                                                      rows_per_strip=4)
        out[f"ycbcr-{hs}x{vs}-deflate-predictor-tiles.tif"] = ycbcr_predictor_tiff(r, 20, 19, hs, vs, 8, tile=(16, 16))
    out["ycbcr-2x2-packbits-predictor.tif"] = ycbcr_predictor_tiff(r, 9, 7, 2, 2, 32773)
    out["ycbcr-1x1-lzw-predictor-planar.tif"] = tiff_bytes(yuv, photometric=6, compression=5, planar=2, predictor=2,
                                                           tags={530: (3, [1, 1])})
    return {f"{RASTER}/tiff/{k}": v for k, v in sorted(out.items())}


# --- Lab, BigTIFF and CCITT TIFFs and Lab PSDs: the JAX package's Pillow lane ---

# T.4's codes as it writes them, first bit first: white and black terminating
# codes (runs 0-63), make-up codes (64-1728) and the extended make-up codes
# both colours share (1792-2560)
_FAX_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 101010 "
    "101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 00000010 "
    "00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 00101001 00101010 "
    "00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 00100100 "
    "00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_FAX_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 "
    "011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011").split()
_FAX_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 000011000 "
    "0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 00000101000 00000010111 "
    "00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 000001101100 "
    "000001101101 000011011010 000011011011 000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 000000101000 "
    "000001011000 000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_FAX_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 0000001101100 "
    "0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 0000001100101").split()
_FAX_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
                   "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111").split()
_FAX_EOL = "000000000001"
#: the 2-D modes: pass, horizontal, and vertical by b1 - a1 (-3 .. 3)
_FAX_PASS, _FAX_HORIZ = "0001", "001"
_FAX_VERTICAL = {-3: "0000011", -2: "000011", -1: "011", 0: "1", 1: "010", 2: "000010", 3: "0000010"}


def _fax_codes(term, makeup):
    codes = {i: c for i, c in enumerate(term)}
    codes.update({64 * (i + 1): c for i, c in enumerate(makeup + _FAX_EXT_MAKEUP)})
    return codes


_FAX_CODES = (_fax_codes(_FAX_WHITE_TERM, _FAX_WHITE_MAKEUP), _fax_codes(_FAX_BLACK_TERM, _FAX_BLACK_MAKEUP))


def _fax_span(out: List[str], run: int, black: int) -> None:
    """libtiff's putspan: 2560s while the run is at least 2624, a make-up
    code, then a terminating code."""
    codes = _FAX_CODES[black]
    while run >= 2624:
        out.append(codes[2560])
        run -= 2560
    if run >= 64:
        out.append(codes[run & ~63])
        run &= 63
    out.append(codes[run])


def _finddiff(row: np.ndarray, start: int, colour: int) -> int:
    """The first place at or after ``start`` whose pixel is not ``colour``,
    else the row's width (libtiff's finddiff)."""
    rest = np.flatnonzero(row[start:] != colour)
    return start + int(rest[0]) if len(rest) else len(row)


def fax_row_1d(row: np.ndarray, colours: Optional[List[int]] = None) -> List[str]:
    """A row of 0/1 samples (1 coded black) as T.4 1-D codes, white first
    (libtiff's Fax3Encode1DRow); ``colours`` gets each code's colour."""
    out, x, black = [], 0, 0
    while True:
        end = _finddiff(row, x, black)
        n = len(out)
        _fax_span(out, end - x, black)
        if colours is not None:
            colours += [black] * (len(out) - n)
        x, black = end, 1 - black
        if x >= len(row):
            return out


def rlew_stream(samples: np.ndarray) -> bytes:
    """Compression 32771 as libtiff's Fax3DecodeRLE reads it back: each
    row's codes from where the reader stands after the row before.  Its
    lookahead loads whole bytes, 12 bits for a white code and 13 for a
    black one; at a row's end it drops the loaded bits short of 16 and, where
    none are left, a byte more to an even offset.  (libtiff's own encoder
    pads each row to 16 bits of its codes, which its decoder does not
    read back.)"""
    out, pos = bytearray(), 0
    for row in np.asarray(samples, np.uint8):
        colours: List[int] = []
        codes = fax_row_1d(row, colours)
        out[pos:] = _bits_bytes("".join(codes))
        avail = loaded = 0
        for code, black in zip(codes, colours):
            need = 13 if black else 12
            while avail < need:
                loaded, avail = loaded + 1, avail + 8
            avail -= len(code)
        avail -= avail % 16
        end = pos + loaded + (avail == 0 and (pos + loaded) % 2)
        pos = end - avail // 8
        out += bytes(max(0, pos - len(out)))
    return bytes(out)


def fax_row_2d(row: np.ndarray, ref: np.ndarray) -> List[str]:
    """A row as T.4 2-D codes against the row above (libtiff's
    Fax3Encode2DRow: pass, vertical within 3, else horizontal)."""
    n = len(row)
    out = []
    a0 = 0
    a1 = 0 if row[0] else _finddiff(row, 0, 0)
    b1 = 0 if ref[0] else _finddiff(ref, 0, 0)
    while True:
        b2 = _finddiff(ref, b1, ref[b1]) if b1 < n else n
        if b2 >= a1:
            d = b1 - a1
            if -3 <= d <= 3:
                out.append(_FAX_VERTICAL[d])
                a0 = a1
            else:
                a2 = _finddiff(row, a1, row[a1]) if a1 < n else n
                out.append(_FAX_HORIZ)
                colour = 0 if a0 + a1 == 0 or row[a0] == 0 else 1
                _fax_span(out, a1 - a0, colour)
                _fax_span(out, a2 - a1, 1 - colour)
                a0 = a2
        else:
            out.append(_FAX_PASS)
            a0 = b2
        if a0 >= n:
            return out
        colour = int(row[a0])
        a1 = _finddiff(row, a0, colour)
        b1 = _finddiff(ref, _finddiff(ref, a0, 1 - colour), colour)


def _bits_bytes(bits: str) -> bytes:
    return np.packbits(np.frombuffer((bits + "0" * (-len(bits) % 8)).encode(), np.uint8) - 48).tobytes()


def ccitt_stream(samples: np.ndarray, compression: int, t4options: int = 0, k: int = 4, fill_bits: bool = False,
                 rtc: bool = True, eofb: bool = True) -> bytes:
    """One strip or tile of 0/1 ``samples`` (rows, width) as CCITT data,
    most significant bit first: Modified Huffman rows padded to a byte
    (compression 2) or to 16 bits (32771); T.4 (3) each row after an EOL
    (byte-aligned where ``fill_bits``), and in 2-D (``t4options`` bit 0)
    the EOL's tag bit, every ``k``-th row 1-D, then the RTC (six EOLs)
    where ``rtc``; T.6 (4) rows against the row above, then the EOFB where
    ``eofb``."""
    bits, ref = "", np.zeros(samples.shape[1], np.uint8)
    two_d = compression == 4 or (compression == 3 and t4options & 1)
    for y, row in enumerate(np.asarray(samples, np.uint8)):
        if compression == 3:
            if fill_bits:
                bits += "0" * (-(len(bits) + 12) % 8)
            bits += _FAX_EOL + (("1" if y % k == 0 else "0") if two_d else "")
        one_d = compression in (2, 32771) or (compression == 3 and (not two_d or y % k == 0))
        bits += "".join(fax_row_1d(row) if one_d else fax_row_2d(row, ref))
        if compression in (2, 32771):
            bits += "0" * (-len(bits) % (8 if compression == 2 else 16))
        ref = row
    if compression == 3 and rtc:
        bits += (_FAX_EOL + ("1" if two_d else "")) * 6
    if compression == 4 and eofb:
        bits += _FAX_EOL * 2
    return _bits_bytes(bits)


def ccitt_tiff(samples: np.ndarray, compression: int = 4, photometric: int = 0, t4options: int = 0,
               rows_per_strip: Optional[int] = None, tile: Optional[Tuple[int, int]] = None, fill_order: int = 1,
               stream: Optional[Callable[[np.ndarray], bytes]] = None, **kw) -> bytes:
    """A bilevel TIFF of 0/1 ``samples`` (h, w) in CCITT ``compression``: a
    stream (``ccitt_stream``, or ``stream`` of a block) a strip or tile, each
    byte's bits reversed where ``fill_order`` is 2; ``kw`` goes to
    ``ccitt_stream`` where it names one of its options, else to
    ``tiff_bytes``."""
    s = np.asarray(samples, np.uint8)
    h, w = s.shape
    options = {k: kw.pop(k) for k in ("k", "fill_bits", "rtc", "eofb") if k in kw}
    if tile:
        th, tw = tile
        padded = np.pad(s, ((0, -h % th), (0, -w % tw)))
        blocks = [padded[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        blocks = [s[y:y + (rows_per_strip or h)] for y in range(0, h, rows_per_strip or h)]
    if stream is None and compression == 32771:
        stream = rlew_stream
    chunks = [stream(b) if stream else ccitt_stream(b, compression, t4options, **options) for b in blocks]
    if fill_order == 2:
        chunks = [bytes(_reverse_bits(c)) for c in chunks]
    tags = dict(kw.pop("tags", {}) or {})
    if compression == 3:
        tags.setdefault(292, (4, [t4options]))
    if fill_order == 2:
        tags[266] = (3, [2])
    return tiff_bytes(s, 1, photometric, compression=compression, rows_per_strip=rows_per_strip, tile=tile,
                      chunks=chunks, tags=tags, **kw)


def _scan(seed: int, h: int, w: int, cell: Optional[int] = None) -> np.ndarray:
    """Seeded 0/1 samples like a scanned page: dark blots (of about
    ``cell`` pixels) on a light field and a few full-width rules, 1 black."""
    return ((smooth_scene(seed, h, w, cell=cell or max(4, min(h, w) // 6), step=64)[..., 0] < 90)
            | (np.arange(h)[:, None] % max(3, h // 3) == 1)).astype(np.uint8)


def ccitt_layouts() -> Dict[str, bytes]:
    """CCITT TIFFs of each layout the port reads (name -> bytes; Pillow
    reads each through libtiff): Modified Huffman, 32771 with rows that
    leave it word-aligned, T.4 1-D and 2-D (EOLs with and without fill
    bits, with and without the RTC), T.6 with and without the EOFB; both
    photometrics, FillOrder 2, both byte orders, strips and tiles, widths
    past 2560 (the extended make-up codes), all white and all black rows."""
    r = np.random.default_rng(2101)
    scan = _scan(2102, 29, 61)
    noise = (r.random((17, 37)) < 0.35).astype(np.uint8)
    wide = np.zeros((6, 2900), np.uint8)
    wide[1, 5:2700] = 1
    wide[3, 2640:] = 1
    wide[4, ::7] = 1
    flat = np.zeros((5, 40), np.uint8)
    flat[2] = 1
    out = {
        "ccitt-mh.tif": ccitt_tiff(scan, 2),
        "ccitt-mh-black-is-zero.tif": ccitt_tiff(noise, 2, photometric=1),
        "ccitt-mh-strips-mm.tif": ccitt_tiff(scan, 2, rows_per_strip=7, order=">"),
        "ccitt-mh-fill-order-2.tif": ccitt_tiff(noise, 2, fill_order=2),
        "ccitt-rlew.tif": ccitt_tiff(scan, 32771),
        "ccitt-rlew-noise-strips-fill-order-2.tif": ccitt_tiff(noise, 32771, rows_per_strip=6, fill_order=2),
        "ccitt-rlew-wide.tif": ccitt_tiff(wide, 32771),
        "ccitt-g3-1d.tif": ccitt_tiff(scan, 3),
        "ccitt-g3-1d-fill-bits.tif": ccitt_tiff(scan, 3, t4options=4, fill_bits=True),
        "ccitt-g3-1d-no-rtc-strips.tif": ccitt_tiff(noise, 3, rows_per_strip=5, rtc=False),
        "ccitt-g3-1d-black-is-zero-fill-order-2.tif": ccitt_tiff(noise, 3, photometric=1, fill_order=2),
        "ccitt-g3-2d.tif": ccitt_tiff(scan, 3, t4options=1),
        "ccitt-g3-2d-k1.tif": ccitt_tiff(noise, 3, t4options=1, k=1),
        "ccitt-g3-2d-k1000-fill-bits.tif": ccitt_tiff(scan, 3, t4options=5, k=1000, fill_bits=True),
        "ccitt-g3-2d-tiles.tif": ccitt_tiff(_scan(2103, 40, 50), 3, t4options=1, tile=(16, 32)),
        "ccitt-g4.tif": ccitt_tiff(scan, 4),
        "ccitt-g4-no-eofb.tif": ccitt_tiff(noise, 4, eofb=False),
        "ccitt-g4-black-is-zero-mm.tif": ccitt_tiff(scan, 4, photometric=1, order=">"),
        "ccitt-g4-fill-order-2.tif": ccitt_tiff(noise, 4, fill_order=2),
        "ccitt-g4-strips-3.tif": ccitt_tiff(scan, 4, rows_per_strip=3),
        "ccitt-g4-tiles.tif": ccitt_tiff(_scan(2104, 40, 70), 4, tile=(32, 48)),
        "ccitt-g4-wide.tif": ccitt_tiff(wide, 4),
        "ccitt-g3-1d-wide.tif": ccitt_tiff(wide, 3),
        "ccitt-mh-wide.tif": ccitt_tiff(wide, 2),
        "ccitt-g4-flat.tif": ccitt_tiff(flat, 4),
        "ccitt-g4-width-1.tif": ccitt_tiff(noise[:, :1], 4),
        "ccitt-g4-orientation-6.tif": ccitt_tiff(noise, 4, orientation=6),
    }
    return {f"{RASTER}/tiff/{k}": v for k, v in sorted(out.items())}


def lab_tiff_layouts() -> Dict[str, bytes]:
    """CIELab TIFFs of each layout Pillow reads (8 bits, three samples, no
    extra samples, FillOrder 1: its one LAB key): name -> bytes; both byte
    orders, no compression, LZW with and without Predictor 2, Deflate,
    PackBits, JPEG (the streams' components as they are), strips, tiles,
    separate planes (whose a* and b* Pillow does not XOR) and Orientation;
    a* and b* stored signed."""
    r = np.random.default_rng(2111)
    h, w = 15, 13
    lab = r.integers(0, 256, (h, w, 3))
    lab[0, :6] = [[0, 128, 128], [255, 128, 128], [0, 0, 0], [255, 255, 255], [100, 127, 129], [50, 0, 255]]
    photo = smooth_scene(2112, h, w, cell=8, step=8)
    out = {
        "lab-raw.tif": tiff_bytes(lab, photometric=8),
        "lab-raw-mm.tif": tiff_bytes(lab, photometric=8, order=">"),
        "lab-lzw.tif": tiff_bytes(lab, photometric=8, compression=5),
        "lab-lzw-predictor-2.tif": tiff_bytes(lab, photometric=8, compression=5, predictor=2, rows_per_strip=4),
        "lab-deflate-mm.tif": tiff_bytes(lab, photometric=8, compression=8, order=">"),
        "lab-adobe-deflate-predictor-2.tif": tiff_bytes(lab, photometric=8, compression=32946, predictor=2),
        "lab-packbits.tif": tiff_bytes(lab, photometric=8, compression=32773),
        "lab-raw-strips-2.tif": tiff_bytes(lab, photometric=8, rows_per_strip=2),
        "lab-raw-tiles.tif": tiff_bytes(lab, photometric=8, tile=(16, 16)),
        "lab-lzw-tiles-mm.tif": tiff_bytes(lab, photometric=8, compression=5, tile=(16, 32), order=">"),
        "lab-raw-planar.tif": tiff_bytes(lab, photometric=8, planar=2),
        "lab-lzw-planar-tiles.tif": tiff_bytes(lab, photometric=8, compression=5, planar=2, tile=(16, 16)),
        "lab-deflate-orientation-7.tif": tiff_bytes(lab, photometric=8, compression=8, orientation=7),
        "lab-jpeg.tif": jpeg_tiff(photo, 2, 90, rows_per_strip=8, tags={262: (3, [8])}),
        "lab-jpeg-planar.tif": jpeg_tiff(photo, 2, 80, rows_per_strip=8, planar=2, tags={262: (3, [8])}),
    }
    return {f"{RASTER}/tiff/{k}": v for k, v in sorted(out.items())}


def bigtiff_layouts() -> Dict[str, bytes]:
    """Little-endian BigTIFFs (version 43, 8-byte offsets) of the kinds the
    port reads in classic TIFF: name -> bytes; offsets and byte counts as
    LONG8 or LONG, strips, tiles, planes, each compression, Lab, CCITT,
    JPEG, a palette, 16-bit gray and a directory past its values."""
    r = np.random.default_rng(2121)
    h, w = 14, 12
    rgb = r.integers(0, 256, (h, w, 3))
    gray16 = r.integers(0, 65536, (h, w))
    photo = smooth_scene(2122, h, w, cell=8, step=8)
    out = {
        "bigtiff-rgb-raw.tif": tiff_bytes(rgb, big=True),
        "bigtiff-rgb-raw-long-offsets.tif": tiff_bytes(rgb, big=True, offset_type=4),
        "bigtiff-rgb-lzw-predictor-2-strips.tif": tiff_bytes(rgb, big=True, compression=5, predictor=2,
                                                             rows_per_strip=5),
        "bigtiff-rgb-deflate-tiles.tif": tiff_bytes(rgb, big=True, compression=8, tile=(16, 16)),
        "bigtiff-rgb-packbits-planar.tif": tiff_bytes(rgb, big=True, compression=32773, planar=2),
        "bigtiff-gray16-raw.tif": tiff_bytes(gray16, 16, 1, big=True),
        "bigtiff-palette4.tif": tiff_bytes(r.integers(0, 16, (h, w)), 4, 3, big=True,
                                           colormap=r.integers(0, 65536, (16, 3))),
        "bigtiff-lab-lzw.tif": tiff_bytes(r.integers(0, 256, (h, w, 3)), photometric=8, compression=5, big=True),
        "bigtiff-ccitt-g4.tif": ccitt_tiff(_scan(2123, 20, 33), 4, big=True),
        "bigtiff-jpeg-ycbcr.tif": jpeg_tiff(photo, 6, 85, (2, 2), rows_per_strip=8, big=True),
        "bigtiff-cmyk-orientation-3.tif": tiff_bytes(r.integers(0, 256, (h, w, 4)), photometric=5, big=True,
                                                     orientation=3),
    }
    return {f"{RASTER}/tiff/{k}": v for k, v in sorted(out.items())}


def lab_big_ccitt_refusals() -> Dict[str, Tuple[bytes, str]]:
    """Lab, BigTIFF and CCITT TIFFs the port refuses by name: those Pillow
    does not identify (Lab of another layout than its key's, ICCLab,
    ITULab, a big-endian BigTIFF) and those libtiff decodes only with
    errors, which Pillow shows concealed (a bad code word, an
    uncompressed-mode extension, an EOL inside a row, a row too long, data
    cut short): name -> (bytes, reason)."""
    r = np.random.default_rng(2131)
    h, w = 9, 7
    lab = r.integers(0, 256, (h, w, 3))
    scan = _scan(2132, 12, 30)
    g4 = ccitt_stream(scan, 4, eofb=False)
    bad_code = _FAX_HORIZ + "000000000100"  # horizontal mode, then a white code word no table holds
    return {
        "lab-16-bit.tif": (tiff_bytes(lab * 257, 16, 8), "depth or sample layout"),
        "lab-alpha.tif": (tiff_bytes(np.concatenate([lab, lab[..., :1]], 2), photometric=8, extra=(2,)),
                          "depth or sample layout"),
        "lab-one-sample.tif": (tiff_bytes(lab[..., 0], photometric=8), "depth or sample layout"),
        "lab-fill-order-2.tif": (tiff_bytes(lab, photometric=8, tags={266: (3, [2])}), "depth or sample layout"),
        "icclab.tif": (tiff_bytes(lab, photometric=9), "photometric interpretation"),
        "itulab.tif": (tiff_bytes(lab, photometric=10, compression=5), "photometric interpretation"),
        "bigtiff-mm.tif": (tiff_bytes(lab, photometric=8, big=True, order=">"), "big-endian"),
        "ccitt-gray8.tif": (tiff_bytes(r.integers(0, 256, (h, w)), photometric=1, compression=4, data=g4),
                            "CCITT .* other samples"),
        "ccitt-g4-cut-short.tif": (ccitt_tiff(scan, 4, stream=lambda b: g4[:len(g4) // 2]), "decodes only with errors"),
        "ccitt-g4-bad-code.tif": (ccitt_tiff(scan, 4, stream=lambda b: _bits_bytes(
            "".join(fax_row_2d(b[0], np.zeros(b.shape[1], np.uint8))) + bad_code + "0" * 64)),
                                  "decodes only with errors"),
        "ccitt-g4-extension.tif": (ccitt_tiff(scan, 4, stream=lambda b: _bits_bytes("0000001111" + "0" * 40)),
                                   "decodes only with errors"),
        "ccitt-g4-eol-in-a-row.tif": (ccitt_tiff(scan, 4, stream=lambda b: _bits_bytes(
            "".join(fax_row_2d(b[0], np.zeros(b.shape[1], np.uint8)))[:6] + _FAX_EOL * 2)), "decodes only with errors"),
        "ccitt-g3-row-too-long.tif": (ccitt_tiff(scan[:, :20], 3, stream=lambda b: ccitt_stream(scan, 3)),
                                      "decodes only with errors"),
        "ccitt-g3-no-eol.tif": (ccitt_tiff(scan, 3, stream=lambda b: _bits_bytes("".join(
            "".join(fax_row_1d(row)) for row in b))), "decodes only with errors"),
        "ccitt-mh-rows-short.tif": (ccitt_tiff(scan, 2, stream=lambda b: ccitt_stream(b[:-2], 2)),
                                    "decodes only with errors"),
        "ccitt-rlew-rows-padded-to-16-bits.tif": (ccitt_tiff(scan, 32771, stream=lambda b: ccitt_stream(b, 32771)),
                                                  "decodes only with errors"),
    }


def lab_psd_layouts() -> Dict[str, bytes]:
    """Lab PSDs (colour mode 9, 8 bits) Pillow reads: raw and PackBits, raw
    with a fourth (alpha) channel, with image resources, every a*/b*
    extreme: name -> bytes."""
    r = np.random.default_rng(2141)
    h, w = 11, 9
    planes = r.integers(0, 256, (4, h, w)).astype(np.uint8)
    planes[:3, 0, :4] = np.array([[0, 128, 128], [255, 128, 128], [0, 0, 255], [255, 255, 0]]).T
    out = {
        "lab-raw.psd": psd_file(planes[:3], 9, w),
        "lab-packbits.psd": psd_file(planes[:3], 9, w, compression=1),
        "lab-alpha-raw.psd": psd_file(planes, 9, w),
        "lab-resources-raw.psd": psd_file(planes[:3], 9, w, resources=psd_resource(1005, b"res", bytes(16))),
        "lab-flat.psd": psd_file(np.full((3, h, w), 128, np.uint8), 9, w, compression=1),
    }
    return {f"{RASTER}/psd/{k}": v for k, v in sorted(out.items())}


def lab_table_pillow() -> np.ndarray:
    """Pillow's ``convert("RGB")`` of every 8-bit Lab triple (L, a, b band
    values, the index's bytes high to low), uint8 (2^24, 3): the oracle of
    ``native.lab_to_rgb``.  A LAB image is built from its bands with
    ``Image.merge``: ``np.asarray`` of one shows a* and b* XOR 0x80."""
    from PIL import Image

    idx = np.arange(1 << 24, dtype=np.uint32)
    bands = [Image.fromarray(((idx >> s) & 255).astype(np.uint8).reshape(4096, 4096), "L") for s in (16, 8, 0)]
    return np.asarray(Image.merge("LAB", bands).convert("RGB")).reshape(-1, 3)


def ycc_table_pillow() -> np.ndarray:
    """Pillow's "YCC;P" unpacker (a PhotoCD's) of every triple of
    ``lab_table_triples`` as Y, C1, C2: uint8 RGB (2^24, 3)."""
    from PIL import Image

    return np.asarray(Image.frombytes("RGB", (4096, 4096), lab_table_triples().tobytes(), "raw", "YCC;P")).reshape(
        -1, 3)


def ycbcr_table_pillow() -> np.ndarray:
    """Pillow's YCbCr -> RGB ``convert`` of every triple of
    ``lab_table_triples`` as Y, Cb, Cr: uint8 RGB (2^24, 3)."""
    from PIL import Image

    return np.asarray(Image.frombytes("YCbCr", (4096, 4096), lab_table_triples().tobytes()).convert("RGB")).reshape(
        -1, 3)


def lab_table_triples() -> np.ndarray:
    """Every 8-bit Lab triple in ``lab_table_pillow``'s order: uint8 (2^24, 3)."""
    idx = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(idx >> 16) & 255, (idx >> 8) & 255, idx & 255], -1).astype(np.uint8)


def _refusal_draws():
    """``tiff_refusals``' own draws for its YCbCr files, at the point where
    it drew the planes of ycbcr-lzw-predictor.tif."""
    rr = np.random.default_rng(1904)
    ycbcr_planes(rr, 9, 7, 1, 4)
    return rr


def _reverse_bits(data: bytes) -> np.ndarray:
    """Each byte of ``data`` with its bits in reverse order (FillOrder 2)."""
    return np.packbits(np.unpackbits(np.frombuffer(data, np.uint8)).reshape(-1, 8)[:, ::-1])


def tiff_refusals() -> Dict[str, Tuple[bytes, str]]:
    """TIFFs the port refuses by name (Pillow reads some of them: CCITT data
    libtiff decodes with errors, a JPEG stream cut short), with
    ``lab_big_ccitt_refusals``: name -> (bytes, the reason the port's
    ``OSError`` names, a regular expression)."""
    r = np.random.default_rng(1705)
    h, w = 9, 7
    rgb = r.integers(0, 256, (h, w, 3))
    gray = r.integers(0, 256, (h, w))
    junk = bytes(r.integers(0, 256, 64, dtype=np.uint8))
    lzw = tiff_bytes(rgb, compression=5)
    old_lzw = tiff_bytes(rgb, compression=5, data=b"\x00\x01" + junk)
    photo = smooth_scene(1903, 24, 20, cell=8, step=4)
    jpeg = jpeg_tiff(photo, 6, 80, (2, 2))
    sof = jpeg.index(b"\xff\xc0")
    jpeg12 = jpeg[:sof + 4] + b"\x0c" + jpeg[sof + 5:]  # the frame's precision 12 bits
    cut = jpeg_tiff(photo, 6, 80, (2, 2), tables=False)
    rr = np.random.default_rng(1904)  # the JPEG and YCbCr refusals' own draws
    lzw_planes = ycbcr_planes(rr, h, w, 1, 4)
    return {
        "bigtiff.tif": (b"II+\0\x08\0\0\0" + bytes(32), "first directory"),  # its directory at offset 0
        "jpeg.tif": (tiff_bytes(rgb, compression=7, data=junk), "breaks the format's rules"),
        "old-jpeg.tif": (tiff_bytes(rgb, compression=6, data=junk), "old-style JPEG"),
        "jpeg-12-bit.tif": (jpeg12, "12-bit"),
        "jpeg-cut-short.tif": (_cut_strip(cut, 60), "truncated"),
        "jpeg-subsampling-tag-1x1.tif": (jpeg_tiff(photo, 6, 80, (2, 2), sampling_tag=(1, 1)),
                                         "does not match the file's tags"),
        "jpeg-rgba.tif": (tiff_bytes(np.zeros((h, w, 4), np.uint8), compression=7, extra=(2,), data=junk),
                          "JPEG compression of other samples"),
        "ycbcr-1x4-lzw.tif": (ycbcr_tiff(*lzw_planes, 1, 4), "YCbCr pixels in this layout"),
        "ycbcr-lzw-one-sample.tif": (tiff_bytes(rgb[..., 0], photometric=6, compression=5), "depth or sample layout"),
        "ccitt-group4.tif": (tiff_bytes(gray & 1, 1, photometric=0, compression=4, data=junk),
                             "decodes only with errors"),
        "logluv.tif": (tiff_bytes(rgb, photometric=32845, compression=34676, data=junk), "LogLuv"),
        "lzma.tif": (tiff_bytes(rgb, compression=34925, data=junk), "breaks the format's rules"),
        "fill-order-2-gray8-white-raw.tif": (tiff_bytes(gray, photometric=0, tags={266: (3, [2])}), "FillOrder 2"),
        "fill-order-2-palette4-raw.tif": (tiff_bytes(gray & 15, 4, photometric=3, colormap=r.integers(0, 65536, (16, 3)),
                                                     tags={266: (3, [2])}), "FillOrder 2"),
        "signed-white.tif": (tiff_bytes(gray, photometric=0, tags={339: (3, [2])}), "depth or sample layout"),
        "gray16-planar-raw.tif": (tiff_bytes(gray * 257, 16, 1, planar=2), "depth or sample layout"),
        "gray4-predictor-2.tif": (tiff_bytes(gray & 15, 4, photometric=1, compression=5, predictor=2), "predictor"),
        "predictor-3.tif": (tiff_bytes(rgb, compression=5, tags={317: (3, [3])}), "predictor"),
        "bilevel-predictor-2.tif": (tiff_bytes(gray & 1, 1, photometric=1, compression=5, predictor=2), "predictor"),
        "old-style-lzw.tif": (old_lzw, "refused the data|breaks the format"),
        "lzw-cut-short.tif": (tiff_bytes(rgb, compression=5, data=tiff_lzw(rgb.astype(np.uint8).tobytes())[:40]),
                              "refused the data|breaks the format"),
        "strip-past-the-end.tif": (_strip_at_the_end(lzw), "truncated"),
        "raw-past-the-end.tif": (_strip_at_the_end(tiff_bytes(rgb)), "truncated"),
        "no-width.tif": (_without_tag(tiff_bytes(rgb), 256), "first directory"),
        **lab_big_ccitt_refusals(),
    }


def jpeg_planes_refusals() -> Dict[str, Tuple[bytes, str]]:
    """JPEG TIFFs in separate planes that libtiff refuses: YCbCr subsampled
    (no put routine for it; without the tag the default 2 x 2 stays), and
    a plane's stream of 2 x 2 sampling factors."""
    yuv = np.random.default_rng(2003).integers(16, 240, (16, 16, 3))
    gray = jpeg_tiff(yuv, 2, 80, rows_per_strip=8, planar=2, tables=False)
    at = gray.index(b"\xff\xc0") + 11  # the first stream's component: sampling factors 1 x 1 -> 2 x 2
    return {
        "jpeg-planes-ycbcr-2x2.tif": (jpeg_tiff(yuv, 6, 80, (2, 2), rows_per_strip=8, planar=2),
                                      "YCbCr pixels in this layout"),
        "jpeg-planes-ycbcr-no-subsampling-tag.tif": (jpeg_tiff(yuv, 6, 80, (1, 1), rows_per_strip=8, planar=2,
                                                               sampling_tag=None), "YCbCr pixels in this layout"),
        "jpeg-planes-factors-2x2.tif": (gray[:at] + b"\x22" + gray[at + 1:], "does not match the file's tags"),
    }


def _cut_strip(data: bytes, keep: int) -> bytes:
    """``data`` (II, one strip or tile at the last offset) with its last
    chunk's byte count cut to ``keep`` bytes."""
    out = bytearray(data)
    at = struct.unpack_from("<I", out, 4)[0]
    for i in range(struct.unpack_from("<H", out, at)[0]):
        tag, typ, count = struct.unpack_from("<HHI", out, at + 2 + 12 * i)
        if tag in (279, 325):
            where = at + 2 + 12 * i + 8 if count == 1 else struct.unpack_from("<I", out, at + 2 + 12 * i + 8)[0] + 4 * (count - 1)
            struct.pack_into("<I", out, where, keep)
    return bytes(out)


def _strip_at_the_end(data: bytes) -> bytes:
    """``data`` (II, one strip) with its strip's offset moved to 10 bytes
    before the file's end, so its data run past it."""
    out = bytearray(data)
    at = struct.unpack_from("<I", out, 4)[0]
    for i in range(struct.unpack_from("<H", out, at)[0]):
        if struct.unpack_from("<H", out, at + 2 + 12 * i)[0] == 273:
            struct.pack_into("<I", out, at + 2 + 12 * i + 8, len(out) - 10)
    return bytes(out)


def _without_tag(data: bytes, tag: int) -> bytes:
    """``data`` (II) with the directory entry of ``tag`` renamed to a tag no
    reader knows."""
    out = bytearray(data)
    at = struct.unpack_from("<I", out, 4)[0]
    for i in range(struct.unpack_from("<H", out, at)[0]):
        if struct.unpack_from("<H", out, at + 2 + 12 * i)[0] == tag:
            struct.pack_into("<H", out, at + 2 + 12 * i, 65000)
    return bytes(out)


def gif_tiff_card() -> Dict[str, bytes]:
    """The card's originals (``GIF_TIFF_CARD``), 1024 px."""
    side = 1024
    idx, palette = _quantised(smooth_scene(1710, side, side, cell=128, step=32), 6)
    sprite, sprite_palette = _quantised(smooth_scene(1711, 896, 960, cell=64, step=48), 5)
    scan = smooth_scene(1712, side, side, cell=256, step=16)
    return {
        f"{GIF_TIFF}/card/poster-1024.gif": gif_file(side, side, [gif_image(idx)], palette),
        f"{GIF_TIFF}/card/poster-1024-interlaced.gif": gif_file(side, side, [gif_image(idx, interlace=True)], palette),
        f"{GIF_TIFF}/card/sprite-1024.gif": gif_file(
            side, side, [gif_extension(255, b"NETSCAPE2.0", 11)[:-1] + b"\x03\x01\x00\x00\x00",
                         gif_gce(transparency=200, disposal=2), gif_image(sprite, 40, 96, palette=sprite_palette),
                         gif_gce(transparency=0), gif_image(sprite[:64, :64] % 4, 0, 0, palette=palette[:4], min_size=2)],
            palette),
        f"{GIF_TIFF}/card/scan-1024.tif": tiff_bytes(scan, compression=5, predictor=2, rows_per_strip=64),
    }


def gif_tiff_fixtures() -> Dict[str, bytes]:
    """Every file under ``gif_tiff/`` (name -> bytes), written anew: the GIF
    and TIFF layouts, their refusals and the card's originals."""
    refused = {f"{GIF_TIFF}/gif/refused/{k}": v for k, (v, _) in gif_refusals().items()}
    refused.update({f"{GIF_TIFF}/tiff/refused/{k}": v for k, (v, _) in tiff_refusals().items()})
    return dict(sorted({**gif_layouts(), **tiff_layouts(), **refused, **gif_tiff_card()}.items()))


def committed_gif_tiff() -> Dict[str, bytes]:
    """The committed files under ``gif_tiff/``: name -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, GIF_TIFF)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def gif_tiff_entry(name: str, path: str, reasons: Optional[Dict[str, Tuple[bytes, str]]] = None) -> dict:
    """A manifest entry of a file under ``gif_tiff/`` (or, with its
    ``reasons``, under ``psd_pcx_sgi_qoi/``, and a card original of that
    folder): Pillow's RGB, or for a refusal the reason the port names
    (``refused``) beside what Pillow makes of the file (its error, or the
    mode it reads)."""
    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    entry = {"bytes": len(data), "sha256": sha256(data)}
    if "/refused/" in name:
        reasons = reasons or {**gif_refusals(), **tiff_refusals()}
        try:
            with Image.open(path) as im:
                entry["pillow"] = f"reads it ({im.mode})"
                im.convert("RGB")
        except Exception as e:  # noqa: BLE001 - Pillow raises OSError, ValueError, EOFError and its own
            entry["pillow"] = f"{type(e).__name__}: {e}".replace(path, "<path>")
        entry["refused"] = reasons[os.path.basename(name)][1]
        return entry
    rgb = pil_rgb(path)
    return {**entry, "shape": list(rgb.shape[:2]), "sha256_rgb": sha256(rgb)}


# --- ICO, CUR, DIB, PNM and Targa: the JAX package's Pillow lane ----------------

ICO_PNM_TGA = "ico_pnm_tga"  # their files' folder under FIXTURES
#: the card's originals, written on the card by ``card_originals`` (never
#: committed, held to the manifest's hashes), each by the listed name
#: cli.prep reads it under, or None for one only timed: a 1024 px photo
#: as a raw P6 and as a plain P3, a 1024 px posterised scene as an RLE
#: Targa, a 256 px icon with a PNG frame and one with a BMP frame, a
#: 1024 px 4-bit gray scan and a 1024 px CMYK print as LZW TIFFs, the
#: photo as a YCbCr 2 x 2 JPEG TIFF (64-row strips, JPEGTables, the port's
#: encoder) and as a JPEG file (its twin, for the decode times)
CARD_ORIGINALS = {"photo-1024.ppm": "photo-1024.jpg", "photo-1024-plain.ppm": None,
                  "poster-1024-rle.tga": "poster-1024-rle.png", "icon-256-png.ico": "icon-256-png.bmp",
                  "icon-256-bmp.ico": None, "scan-1024-gray4.tif": "scan-1024-gray4.png",
                  "print-1024-cmyk.tif": None, "photo-1024-ycbcr-jpeg.tif": "photo-1024-ycbcr-jpeg.jpg",
                  "photo-1024-twin.jpg": None}


def dib_bytes(*args, **kw) -> bytes:
    """A headerless bitmap (Pillow's DIB): ``bmp_file``'s bytes after its
    14-byte file header, the pixels right after the palette."""
    return bmp_file(*args, **kw)[14:]


def icon_dib(values: np.ndarray, bits: int, palette=None, mask: bool = True, top_down: bool = False,
             header: int = 40) -> bytes:
    """An icon's bitmap frame: a DIB of ``values`` (``bmp_rows``' kinds) at
    twice its height, its rows then the AND mask's (zeros, rows of 32-bit
    words) where ``mask``."""
    h, w = np.asarray(values).shape[:2]
    rows = bmp_rows(values, bits)
    body = (rows if top_down else rows[::-1]).tobytes()
    if mask:
        body += bytes((w + 31) // 32 * 4 * h)
    return dib_bytes(body, w, 2 * h, bits, header=header, palette=palette, top_down=top_down)


def icon_file(frames: List[Tuple[int, int, int, int, bytes]], kind: int = 1, sizes=None, offsets=None,
              count: Optional[int] = None) -> bytes:
    """An ICO (``kind`` 1) or CUR (2) of ``frames``, each (width byte,
    height byte, colour count, bpp (for a CUR the hotspot's y), frame
    bytes), the frames after the directory in order; ``sizes`` and
    ``offsets`` (None or a value per entry) replace what the entries say,
    ``count`` the directory's count."""
    head = struct.pack("<HHH", 0, kind, len(frames) if count is None else count)
    at, body = 6 + 16 * len(frames), b""
    for i, (w, h, colors, bpp, blob) in enumerate(frames):
        size = len(blob) if sizes is None or sizes[i] is None else sizes[i]
        offset = at + len(body) if offsets is None or offsets[i] is None else offsets[i]
        head += struct.pack("<BBBBHHII", w & 255, h & 255, colors, 0, 1, bpp, size, offset)
        body += blob
    return head + body


def pil_bytes(im, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def pnm_plain(samples: np.ndarray, magic: bytes, maxval: Optional[int] = 255, per_line: int = 17,
              comment_every: int = 0) -> bytes:
    """A plain PBM (P1: 1 black), PGM or PPM of ``samples`` ((h, w) or (h,
    w, 3) integers), ``per_line`` samples a line, a comment after every
    ``comment_every`` lines."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    head = magic + b"\n# a plain PNM\n" + f"{w} {h}\n".encode() + (b"" if maxval is None else f"{maxval}\n".encode())
    flat = s.reshape(-1)
    lines = []
    for i in range(0, flat.size, per_line):
        lines.append(b" ".join(b"%d" % v for v in flat[i:i + per_line]))
        if comment_every and len(lines) % (comment_every + 1) == comment_every:
            lines.append(b"# comment " + str(i).encode())
    return head + b"\n".join(lines) + b"\n"


def pnm_raw(samples: np.ndarray, magic: bytes, maxval: int = 255) -> bytes:
    """A raw PGM (P5) or PPM (P6, or Pillow's P0CMYK and Py* magics) of
    ``samples``: a byte a sample, two big-endian where ``maxval`` is above
    255; P4 packs (h, w) bits, 1 black, and has no maxval."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    if magic == b"P4":
        return f"P4\n{w} {h}\n".encode() + _pack(s.reshape(h, w, 1), 1).tobytes()
    data = s.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return magic + f"\n{w} {h}\n{maxval}\n".encode() + data


def tga_header(w: int, h: int, itype: int, depth: int, id_field: bytes = b"", cmap: Optional[bytes] = None,
               start: int = 0, map_depth: int = 24, flags: int = 0) -> bytes:
    """A Targa header (18 bytes), the ID field and the colour map's bytes."""
    entries = 0 if cmap is None else len(cmap) // (map_depth // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), cmap is not None, itype, start, entries,
                       map_depth if cmap is not None else 0, 0, 0, w, h, depth, flags)
    return head + id_field + (cmap or b"")


def tga_rle(rows: np.ndarray, pixel_bytes: int, cross_rows: bool = True) -> bytes:
    """Targa RLE packets of ``rows`` ((h, row bytes), file order): runs of 2
    or more equal pixels within a row, literal packets of the rest, each of
    at most 128 pixels; literal packets run on across rows where
    ``cross_rows``."""
    out = bytearray()
    px = np.asarray(rows, np.uint8).reshape(rows.shape[0], -1, pixel_bytes)
    lines = [px.reshape(-1, pixel_bytes)] if cross_rows else list(px)
    w = px.shape[1]
    for line in lines:
        n, x = len(line), 0
        while x < n:
            run = 1
            while x + run < n and run < 128 and (line[x + run] == line[x]).all() and (x + run) // w == x // w:
                run += 1
            if run >= 2:
                out += bytes([0x80 | (run - 1)]) + line[x].tobytes()
                x += run
                continue
            lit = 1
            while x + lit < n and lit < 128 and not (x + lit + 1 < n and (line[x + lit] == line[x + lit + 1]).all()
                                                     and (x + lit + 1) // w == (x + lit) // w):
                lit += 1
            out += bytes([lit - 1]) + line[x:x + lit].tobytes()
            x += lit
    return bytes(out)


def tga_file(pixels: np.ndarray, itype: int, depth: int, rle_cross_rows: Optional[bool] = None,
             flags: int = 0, **header) -> bytes:
    """A Targa of ``pixels`` (uint8 (h, w, bytes a pixel) in file order: B,
    G, R(, A); an index or gray byte; 16-bit words as 2 bytes) or (h, row
    bytes) at 1 bit, rows bottom-up unless ``flags`` holds 0x20, raw or
    RLE (``rle_cross_rows`` True or False: ``tga_rle``)."""
    p = np.asarray(pixels, np.uint8)
    h = p.shape[0]
    w = p.shape[1] * 8 if depth == 1 else p.shape[1]
    rows = p.reshape(h, -1)
    stored = rows if flags & 0x20 else rows[::-1]
    body = stored.tobytes() if rle_cross_rows is None else tga_rle(stored, max(1, depth // 8), rle_cross_rows)
    return tga_header(w, h, itype, depth, flags=flags, **header) + body


def ico_pnm_tga_layouts() -> Dict[str, bytes]:
    """A file of each ICO, CUR, DIB, PNM and Targa layout the port reads
    (name -> bytes; Pillow reads each): icons Pillow writes with PNG and BMP
    frames, multi-entry icons of equal areas and other depths, frames of
    another size than their entries, 32-bit frames, cursors; DIBs of
    every header and depth; each PNM magic and maxval kind, plain and raw;
    Targa of each type and depth from Pillow's writer and this module's
    (colour-map starts, 16-bit maps, orientations, RLE across rows)."""
    from PIL import Image

    r = np.random.default_rng(1801)
    h, w = 11, 13
    img = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
    pal = r.integers(0, 256, (256, 3))
    idx8 = r.integers(0, 256, (h, w))
    out = {}
    # icons
    im = Image.fromarray(r.integers(0, 256, (40, 40, 3)).astype(np.uint8))
    for mode in ("RGB", "RGBA", "P", "L", "1"):
        m = im.convert(mode)
        out[f"ico/pillow-{mode}-png.ico"] = pil_bytes(m, "ICO", sizes=[(16, 16), (32, 32)])
        out[f"ico/pillow-{mode}-bmp.ico"] = pil_bytes(m, "ICO", sizes=[(16, 16), (24, 24)], bitmap_format="bmp")
    gray16 = png_bytes(r.integers(0, 65536, (12, 12, 1)), 16, 0)
    out["ico/png-gray16.ico"] = icon_file([(12, 12, 0, 32, gray16)])
    out["ico/png-palette.ico"] = icon_file([(9, 9, 0, 8, png_bytes(r.integers(0, 4, (9, 9, 1)), 2, 3, chunks=(
        (b"PLTE", pal[:4].astype(np.uint8).tobytes()),)))])
    bgra = r.integers(0, 256, (h, w, 4)).astype(np.uint8)
    out["ico/bmp-32.ico"] = icon_file([(w, h, 0, 32, icon_dib(bgra.view("<u4")[..., 0], 32))])
    out["ico/bmp-24.ico"] = icon_file([(w, h, 0, 24, icon_dib(img[..., ::-1], 24))])
    for bits in (1, 4, 8):
        v = r.integers(0, 1 << bits, (h, w))
        out[f"ico/bmp-pal{bits}.ico"] = icon_file([(w, h, (1 << bits) & 255, bits, icon_dib(v, bits, pal[:1 << bits]))])
    out["ico/bmp-16.ico"] = icon_file([(w, h, 0, 16, icon_dib(r.integers(0, 65536, (h, w)), 16))])
    out["ico/bmp-top-down.ico"] = icon_file([(w, h, 0, 24, icon_dib(img[..., ::-1], 24, top_down=True))])
    out["ico/bmp-os2-header.ico"] = icon_file([(w, h, 0, 24, icon_dib(img[..., ::-1], 24, header=12))])
    out["ico/bmp-no-mask-in-size.ico"] = icon_file([(w, h, 0, 24, icon_dib(img[..., ::-1], 24, mask=False))])
    a24, a8 = icon_dib(img[..., ::-1], 24), icon_dib(idx8, 8, pal)
    b24 = icon_dib(r.integers(0, 256, (h + 4, w + 4, 3)), 24)
    out["ico/equal-areas-24-then-8.ico"] = icon_file([(w, h, 0, 24, a24), (w, h, 0, 8, a8)])
    out["ico/equal-areas-8-then-24.ico"] = icon_file([(w, h, 0, 8, a8), (w, h, 0, 24, a24)])
    out["ico/equal-areas-colour-count.ico"] = icon_file([(w, h, 0, 0, a24), (w, h, 16, 0, a8)])
    out["ico/largest-wins.ico"] = icon_file([(w, h, 0, 8, a8), (w + 4, h + 4, 0, 24, b24), (w, h, 0, 24, a24)])
    out["ico/frame-not-entry-size.ico"] = icon_file([(40, 40, 0, 24, a24)])
    out["ico/entry-bpp-32-frame-24.ico"] = icon_file([(w, h, 0, 32, a24 + bytes(4 * w * h))])  # alpha read past
    out["ico/entry-size-short-of-frame.ico"] = icon_file([(w, h, 0, 24, a24)], sizes=[len(a24) - 20])
    wide = icon_dib(r.integers(0, 256, (2, 256, 3)), 24)
    out["ico/width-byte-0.ico"] = icon_file([(0, 2, 0, 24, wide)])
    cur = icon_dib(img[..., ::-1], 24)
    cur32 = icon_dib(bgra.view("<u4")[..., 0], 32, mask=False)
    big = icon_dib(r.integers(0, 256, (h + 2, w + 2, 3)), 24)
    out["cur/one.cur"] = icon_file([(w, h, 0, 3, cur)], kind=2)
    out["cur/32-bit.cur"] = icon_file([(w, h, 0, 3, cur32)], kind=2)
    out["cur/larger-second.cur"] = icon_file([(w, h, 0, 3, cur), (w + 2, h + 2, 0, 3, big)], kind=2)
    out["cur/wider-only-second.cur"] = icon_file([(w, h, 0, 3, cur), (w + 2, h, 0, 3, big)], kind=2)
    out["cur/zero-byte-second.cur"] = icon_file([(w, h, 0, 3, cur), (0, 0, 0, 3, big)], kind=2)
    out["cur/palette.cur"] = icon_file([(w, h, 0, 3, a8)], kind=2)
    # DIBs
    for header in (12, 40, 52, 56, 64, 108, 124):
        out[f"dib/pal8-header{header}.dib"] = dib_bytes(bmp_rows(idx8, 8)[::-1].tobytes(), w, h, 8, header=header,
                                                        palette=pal)
    for bits in (1, 4, 16, 24, 32):
        v = r.integers(0, 1 << min(bits, 24), (h, w)) if bits != 24 else img[..., ::-1]
        out[f"dib/{bits}-bit.dib"] = dib_bytes(bmp_rows(v, bits)[::-1].tobytes(), w, h, bits,
                                               palette=pal[:1 << bits] if bits < 8 else None)
    out["dib/bitfields-565.dib"] = dib_bytes(bmp_rows(r.integers(0, 65536, (h, w)), 16)[::-1].tobytes(), w, h, 16,
                                             compression=3, masks=(0xF800, 0x7E0, 0x1F))
    out["dib/rle8.dib"] = dib_bytes(rle_stream(r.integers(0, 4, (h, w))[::-1] * 7, False), w, h, 8, compression=1,
                                    palette=pal)
    out["dib/pillow-P.dib"] = pil_bytes(Image.fromarray(img).convert("P"), "DIB")
    out["dib/pillow-RGB.dib"] = pil_bytes(Image.fromarray(img), "DIB")
    # PNM
    gray = r.integers(0, 256, (h, w))
    bits1 = r.integers(0, 2, (h, w))
    for maxval in (1, 100, 255, 256, 1000, 65535):
        g = r.integers(0, maxval + 1, (h, w))
        c = r.integers(0, maxval + 1, (h, w, 3))
        out[f"pnm/p5-maxval-{maxval}.pgm"] = pnm_raw(g, b"P5", maxval)
        out[f"pnm/p6-maxval-{maxval}.ppm"] = pnm_raw(c, b"P6", maxval)
        out[f"pnm/p2-maxval-{maxval}.pgm"] = pnm_plain(g, b"P2", maxval)
        out[f"pnm/p3-maxval-{maxval}.ppm"] = pnm_plain(c, b"P3", maxval)
    out["pnm/p5-over-maxval.pgm"] = pnm_raw(np.full((2, 3), 200), b"P5", 100)  # scaled, then min(255)
    out["pnm/p1.pbm"] = pnm_plain(bits1, b"P1", None)
    out["pnm/p1-no-whitespace.pbm"] = b"P1\n%d %d\n" % (w, h) + b"".join(b"%d" % v for v in bits1.reshape(-1))
    out["pnm/p4.pbm"] = pnm_raw(bits1, b"P4")
    out["pnm/p2-comments.pgm"] = pnm_plain(gray, b"P2", 255, per_line=5, comment_every=3)
    out["pnm/p2-signs-underscores.pgm"] = b"P2 3 1 1000 +1 -0 1_0\n"
    out["pnm/header-comment-in-token.pgm"] = b"P5\n1#a\n3 2\n2#b\n55\n" + bytes(range(26))  # 13 x 2, maxval 255
    out["pnm/header-10-character-token.pgm"] = b"P5 0000000003 1 255\n" + bytes(3)
    floats = np.array([[0.25, 2.0, 254.99, 300.0, -3.0, 127.5, np.nan]], np.float32)
    out["pnm/pf-little-endian.pfm"] = b"Pf\n7 1\n-1.0\n" + floats.astype("<f4").tobytes()
    out["pnm/pf-big-endian-rows.pfm"] = b"Pf\n2 3\n1.0\n" + r.normal(100, 90, (3, 2)).astype(">f4").tobytes()
    out["pnm/p0cmyk.pam"] = pnm_raw(r.integers(0, 256, (h, w, 4)), b"P0CMYK")
    out["pnm/p0cmyk-maxval-1000.pam"] = pnm_raw(r.integers(0, 1001, (h, w, 4)), b"P0CMYK", 1000)
    out["pnm/pyp.pam"] = pnm_raw(gray, b"PyP")
    out["pnm/pyrgba.pam"] = pnm_raw(r.integers(0, 256, (h, w, 4)), b"PyRGBA")
    out["pnm/pycmyk.pam"] = pnm_raw(r.integers(0, 256, (h, w, 4)), b"PyCMYK")
    for mode in ("1", "L", "I", "RGB"):
        m = Image.fromarray(img).convert(mode) if mode != "I" else Image.fromarray(gray.astype(np.int32) * 200)
        out[f"pnm/pillow-{mode}.pnm"] = pil_bytes(m, "PPM")
    # Targa
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA"):
        m = Image.fromarray(img).convert(mode)
        for rle in (False, True):
            if mode == "1" and rle:
                continue
            out[f"tga/pillow-{mode}{'-rle' if rle else ''}.tga"] = pil_bytes(m, "TGA", rle=rle)
    bgr = img[..., ::-1]
    for itype, depth, px in ((2, 24, bgr), (2, 32, bgra), (2, 16, r.integers(0, 256, (h, w, 2))), (3, 8, gray[..., None]),
                             (3, 16, r.integers(0, 256, (h, w, 2)))):
        for rle in (None, True, False):
            t = itype + (8 if rle is not None else 0)
            tag = "raw" if rle is None else "rle-across-rows" if rle else "rle"
            out[f"tga/type{itype}-{depth}-{tag}.tga"] = tga_file(px, t, depth, rle_cross_rows=rle)
    out["tga/type3-1-bit.tga"] = tga_file(_pack(bits1.reshape(h, w, 1), 1), 3, 1)
    for flags in (0x10, 0x20, 0x30):
        out[f"tga/flags-{flags:#04x}.tga"] = tga_file(bgr, 10, 24, rle_cross_rows=True, flags=flags)
    idx = r.integers(0, 8, (h, w, 1))
    cmap24 = r.integers(0, 256, (6, 3)).astype(np.uint8).tobytes()
    cmap16 = r.integers(0, 65536, 6).astype("<u2").tobytes()
    out["tga/map24-start-2.tga"] = tga_file(idx, 1, 8, cmap=cmap24, start=2)
    out["tga/map16-start-3-rle.tga"] = tga_file(idx, 9, 8, rle_cross_rows=True, cmap=cmap16, start=3, map_depth=16)
    out["tga/map24-on-gray.tga"] = tga_file(idx, 3, 8, cmap=cmap24)
    out["tga/map16-on-gray-alpha.tga"] = tga_file(np.concatenate([idx, idx], 2), 3, 16, cmap=cmap16, map_depth=16)
    out["tga/id-field-and-footer.tga"] = tga_file(bgr, 2, 24, id_field=b"made here") + bytes(8) + b"TRUEVISION-XFILE.\0"
    return {f"{ICO_PNM_TGA}/{k}": v for k, v in sorted(out.items())}


def ico_pnm_tga_refusals() -> Dict[str, Tuple[bytes, str]]:
    """ICO, CUR, DIB, PNM and Targa files Pillow 12.1.0 refuses: name ->
    (bytes, the reason the port's ``OSError`` names, a regular
    expression)."""
    r = np.random.default_rng(1802)
    h, w = 5, 7
    img = r.integers(0, 256, (h, w, 3))
    a24 = icon_dib(img, 24)
    icon = icon_file([(w, h, 0, 24, a24)])
    bgra = r.integers(0, 256, (h, w, 4))
    icon32 = icon_file([(w, h, 0, 32, icon_dib(bgra.astype(np.uint8).view("<u4")[..., 0], 32, mask=False))])
    idx = r.integers(0, 4, (h, w, 1))
    return {
        "ico-no-entry.ico": (icon_file([]), "no image"),
        "ico-mask-cut-short.ico": (icon[:-8], "AND mask ends past"),
        "ico-mask-past-the-end.ico": (icon_file([(w, h, 0, 24, a24)], sizes=[4000]), "AND mask ends past"),
        "ico-alpha-cut-short.ico": (icon_file([(w, h, 0, 32, a24[:-4])]), "alpha bytes"),
        "ico-32-bit-cut-short.ico": (icon32[:-1], "alpha bytes|truncated"),
        "ico-mask-before-the-file.ico": (icon_file([(w, 11, 0, 24, icon_dib(r.integers(0, 256, (11, w, 3)), 24))],
                                                   sizes=[0]), "before the file"),
        "ico-frame-one-row.ico": (icon_file([(w, 1, 0, 24, dib_bytes(bytes(24), w, 1, 24))]), "of 7 x 0 pixels"),
        "ico-pixels-cut-short.ico": (icon_file([(w, h, 0, 24, a24[:60])]), "truncated"),
        "cur-no-entry.cur": (icon_file([], kind=2), "No cursors were found"),
        "cur-one-row.cur": (icon_file([(w, 1, 0, 0, dib_bytes(bytes(24), w, 1, 24))], kind=2), "of 7 x 0 pixels"),
        "dib-64-bit.dib": (dib_bytes(bytes(8 * w * h), w, h, 64), "64-bit pixels"),
        "dib-cut-short.dib": (dib_bytes(bmp_rows(img, 24)[::-1].tobytes(), w, h, 24)[:-30], "truncated"),
        "pnm-unknown-magic.ppm": (b"P0RGB\n1 1\n255\n" + bytes(3), "unknown format"),
        "pnm-maxval-0.pgm": (b"P5 1 1 0\n\0", "maxval must be greater than 0"),
        "pnm-maxval-65536.pgm": (b"P5 1 1 65536\n\0\0", "maxval must be greater than 0"),
        "pnm-width-not-integer.pgm": (b"P5 x 1 255\n\0", "invalid literal"),
        "pnm-header-token-too-long.pgm": (b"P5 00000000001 1 255\n\0", "Token too long in file header"),
        "pnm-header-ends.pgm": (b"P5 1 1", "Reached EOF"),
        "pnm-zero-width.pgm": (b"P5 0 1 255\n", "unknown format"),
        "pnm-scale-zero.pfm": (b"Pf 1 1 0.0\n" + bytes(4), "scale must be finite"),
        "pnm-scale-nan.pfm": (b"Pf 1 1 nan\n" + bytes(4), "scale must be finite"),
        "pnm-raw-cut-short.ppm": (b"P6 2 1 255\n" + bytes(5), "truncated"),
        "pnm-raw-scaled-cut-short.ppm": (b"P6 2 1 1000\n" + bytes(10), "truncated"),
        "pnm-plain-cut-short.pgm": (b"P2 3 1 255\n1 2", "truncated"),
        "pnm-plain-token-too-long.pgm": (b"P2 3 1 255\n1 2 3 00000000004", "longer than 10"),
        "pnm-plain-negative.pgm": (b"P2 3 1 255\n1 -2 3\n", "negative"),
        "pnm-plain-over-maxval.pgm": (b"P2 3 1 255\n1 256 3\n", "above its maxval"),
        "pnm-plain-not-integer.pgm": (b"P2 3 1 255\n1 2.5 3\n", "not an integer"),
        "pnm-plain-bitonal-2.pbm": (b"P1 3 1\n0 1 0 2\n", "other than 0 or 1"),
        "tga-type-4.tga": (tga_file(img.astype(np.uint8), 4, 24), "image type 4"),
        "tga-map-depth-8.tga": (tga_file(idx, 1, 8, cmap=bytes(6), map_depth=8), "8-bit colour map"),
        "tga-map-depth-32.tga": (tga_file(idx, 1, 8, cmap=bytes(16), map_depth=32), "32-bit colour map"),
        "tga-map-of-300.tga": (tga_file(idx, 1, 8, cmap=bytes(900)), "300 entries"),
        "tga-type-1-no-map.tga": (tga_file(idx, 1, 8), "without a colour map"),
        "tga-map-on-rgb.tga": (tga_file(img.astype(np.uint8), 2, 24, cmap=bytes(6)), "colour map on BGR"),
        "tga-type-2-8-bit.tga": (tga_file(idx, 2, 8), "cannot load"),
        "tga-rle-1-bit.tga": (tga_header(8, 2, 11, 1) + bytes([0x81, 0xFF]), "truncated"),
        "tga-rle-run-past-row.tga": (tga_header(3, 2, 11, 8) + bytes([0x85, 7]), "past the end of its row"),
        "tga-rle-cut-short.tga": (tga_header(3, 2, 11, 8) + bytes([0x82, 7, 4, 1]), "truncated"),
        "tga-raw-cut-short.tga": (tga_file(img.astype(np.uint8), 2, 24)[:-4], "truncated"),
    }


def card_originals() -> Dict[str, bytes]:
    """The card's originals (``CARD_ORIGINALS``), written by this module's
    writers from seeded numpy alone, as the card's machine (no Pillow)
    writes them: name (under ``ico_pnm_tga/card/``) -> bytes."""
    side = 1024
    r = np.random.default_rng(1880)
    photo = np.clip(smooth_scene(1881, side, side, cell=128, step=8).astype(np.int64)
                    + r.integers(-6, 7, (side, side, 3)), 0, 255)
    digits = [b"%d" % v for v in range(256)]
    plain = b"\n".join(b" ".join(digits[v] for v in line) for line in photo.reshape(-1, 24).tolist())
    poster = (smooth_scene(1882, side, side, cell=128, step=32) // 51 * 51).astype(np.uint8)
    icon = smooth_scene(1883, 256, 256, cell=32, step=16)
    alpha = np.full((256, 256, 1), 255, np.int64)
    alpha[:16] = 0
    small = [(s, s, 0, 32, icon_dib(np.concatenate([icon[::256 // s, ::256 // s, ::-1], alpha[:s, :s]], 2)
                                    .astype(np.uint8).view("<u4")[..., 0], 32, mask=False)) for s in (16, 32)]
    bgra = np.concatenate([icon[..., ::-1], alpha], 2).astype(np.uint8).view("<u4")[..., 0]
    scan = smooth_scene(1884, side, side, cell=256, step=16)[..., 0] >> 4
    cmy = (255 - smooth_scene(1885, side, side, cell=128, step=16)).astype(np.int64)
    cmyk = np.concatenate([cmy, cmy.min(axis=2, keepdims=True) // 2], 2)
    out = {
        "photo-1024.ppm": pnm_raw(photo, b"P6"),
        "photo-1024-plain.ppm": b"P3\n# a 1024 px photo\n1024 1024\n255\n" + plain + b"\n",
        "poster-1024-rle.tga": tga_file(poster[..., ::-1], 10, 24, rle_cross_rows=True, id_field=b"poster"),
        "icon-256-png.ico": icon_file(small + [(0, 0, 0, 32, png_bytes(np.concatenate([icon, alpha], 2), 8, 6,
                                                                        kinds=(1, 4)))]),
        "icon-256-bmp.ico": icon_file(small + [(0, 0, 0, 32, icon_dib(bgra, 32, mask=False))]),
        "scan-1024-gray4.tif": tiff_bytes(scan, 4, 1, compression=5, rows_per_strip=64),
        "print-1024-cmyk.tif": tiff_bytes(cmyk, photometric=5, compression=5, rows_per_strip=64),
        "photo-1024-ycbcr-jpeg.tif": jpeg_tiff(photo, 6, sampling=(2, 2), rows_per_strip=64,
                                               encode=lambda b: port_jpeg(b, 90)),
        "photo-1024-twin.jpg": port_jpeg(photo.astype(np.uint8), 90),
    }
    assert sorted(out) == sorted(CARD_ORIGINALS)
    return {f"{ICO_PNM_TGA}/card/{k}": v for k, v in out.items()}


def ico_pnm_tga_fixtures() -> Dict[str, bytes]:
    """Every committed file under ``ico_pnm_tga/`` (name -> bytes), written
    anew: the layouts and the refusals (the card's originals are written
    on the card, ``card_originals``)."""
    refused = {f"{ICO_PNM_TGA}/refused/{k}": v for k, (v, _) in ico_pnm_tga_refusals().items()}
    return dict(sorted({**ico_pnm_tga_layouts(), **refused}.items()))


def committed_ico_pnm_tga() -> Dict[str, bytes]:
    """The committed files under ``ico_pnm_tga/``: name -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, ICO_PNM_TGA)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def ico_pnm_tga_entry(name: str, path: str) -> dict:
    """A manifest entry of a file under ``ico_pnm_tga/`` (or of a card
    original): Pillow's RGB, or for a refusal the reason the port names
    (``refused``) beside Pillow's error."""
    import warnings

    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    entry = {"bytes": len(data), "sha256": sha256(data)}
    if "/refused/" in name:
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with Image.open(path) as im:
                    im.convert("RGB")
        except Exception as e:  # noqa: BLE001 - Pillow raises OSError, ValueError and its own
            entry["pillow"] = f"{type(e).__name__}: {e}".replace(path, "<path>")
            entry["refused"] = ico_pnm_tga_refusals()[os.path.basename(name)][1]
            return entry
        raise AssertionError(f"{name}: Pillow reads it")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rgb = pil_rgb(path)
    return {**entry, "shape": list(rgb.shape[:2]), "sha256_rgb": sha256(rgb)}


def check_card_originals(folder: str, decode: Callable[[str], np.ndarray]) -> List[str]:
    """Writes ``card_originals`` into ``folder`` and holds each to the
    manifest (``card``): its bytes and ``decode``'s RGB.  Returns the paths
    written; raises ``AssertionError`` naming the first that differs."""
    want = load_manifest()["card"]
    paths = []
    for name, data in card_originals().items():
        if sha256(data) != want[name]["sha256"]:
            raise AssertionError(f"{name}: the writer made other bytes than the manifest records")
        path = os.path.join(folder, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        got = decode(path)
        if list(got.shape[:2]) != want[name]["shape"] or sha256(got) != want[name]["sha256_rgb"]:
            raise AssertionError(f"{name}: decoded to other pixels than Pillow's")
        paths.append(path)
    return paths



# --- PSD, PCX, SGI and QOI: the JAX package's Pillow lane -----------------------

RASTER = "psd_pcx_sgi_qoi"  # their files' folder under FIXTURES
#: the card's originals, each by the listed name cli.prep reads it under,
#: or None for one only timed: written on the card from seeded numpy by
#: ``raster_card_originals`` (a 1024 px photo as a PackBits and a raw RGB
#: PSD, a 1024 px poster as a PCX of 8 bits in 3 planes, the photo as an
#: RLE SGI and as a QOI), or committed under ``psd_pcx_sgi_qoi/card/``
#: (Pillow's libjpeg wrote their streams: the photo as a YCbCr 1 x 1
#: JPEG TIFF in separate planes, one one-component stream a plane a strip,
#: and as its twin, an RGB JPEG TIFF of one three-component stream a strip)
RASTER_CARD = {"photo-1024-packbits.psd": "photo-1024-psd.png", "photo-1024-raw.psd": None,
               "poster-1024.pcx": "poster-1024-pcx.jpg", "photo-1024-rle.sgi": "photo-1024-sgi.bmp",
               "photo-1024.qoi": "photo-1024-qoi.webp", "photo-1024-jpeg-planes.tif": "photo-1024-jpeg-planes.jpg",
               "photo-1024-jpeg-contig.tif": None,
               # Lab, BigTIFF and CCITT: written on the card by ``raster_card_originals`` too
               "photo-1024-lab.tif": "photo-1024-lab.jpg", "photo-1024-lab.psd": "photo-1024-lab-psd.png",
               "photo-1024-big.tif": "photo-1024-big.bmp", "scan-1024-g4.tif": "scan-1024-g4.png",
               "scan-1024-g3-2d.tif": None, "scan-1024-mh.tif": None}
RASTER_COMMITTED_CARD = ("photo-1024-jpeg-planes.tif", "photo-1024-jpeg-contig.tif")


def _runs(row: np.ndarray, limit: int) -> List[Tuple[int, int]]:
    """(start, length) of each run of equal items of ``row`` (a 1-D array,
    or 2-D: an item a row), a run at most ``limit`` long."""
    row = np.asarray(row)
    flat = row.reshape(len(row), -1)
    change = np.flatnonzero((flat[1:] != flat[:-1]).any(axis=1)) + 1
    starts = np.concatenate([[0], change]).tolist()
    ends = starts[1:] + [len(row)]
    out = []
    for a, b in zip(starts, ends):
        out += [(k, min(limit, b - k)) for k in range(a, b, limit)]
    return out


def packbits_row(row: np.ndarray) -> bytes:
    """A row's bytes in PackBits (runs of 2-128 as 257 - n, literals of up to
    128 as n - 1), run by run."""
    row = np.asarray(row, np.uint8)
    out, lit = bytearray(), []
    for a, n in _runs(row, 128) + [(len(row), 0)]:
        if n == 1:
            lit.append(a)
            if len(lit) < 128:
                continue
        if lit:
            out += bytes([len(lit) - 1]) + row[lit[0]:lit[-1] + 1].tobytes()
            lit = []
        if n >= 2:
            out += bytes([257 - n, row[a]])
    return bytes(out)


def psd_resource(rid: int, name: bytes, data: bytes) -> bytes:
    """An image resource block: its signature, id, Pascal name padded to an
    even length and data padded to even."""
    label = bytes([len(name)]) + name
    return (b"8BIM" + struct.pack(">H", rid) + label + b"\0" * (len(label) % 2) + struct.pack(">I", len(data)) + data
            + b"\0" * (len(data) % 2))


def psd_file(planes, mode: int, w: int, bits: int = 8, compression: int = 0, channels: Optional[int] = None,
             color: bytes = b"", resources: bytes = b"", layers: bytes = b"", streams: Optional[List[bytes]] = None,
             counts: Optional[List[int]] = None, version: int = 1) -> bytes:
    """A PSD of ``planes`` ((c, h, row bytes) uint8: each channel's rows as
    stored, 1-bit rows packed most significant bit first) in colour
    ``mode`` at ``bits``, ``channels`` in the header (c by default); raw, or
    PackBits (compression 1) a row at a time, or the channels' ``streams``
    with the row byte ``counts`` given; the colour mode data, the image
    resources and the layer section (its bytes) as given."""
    planes = np.asarray(planes, np.uint8)
    c, h = planes.shape[:2]
    head = b"8BPS" + struct.pack(">H6xHIIHH", version, c if channels is None else channels, h, w, bits, mode)
    sections = b"".join(struct.pack(">I", len(x)) + x for x in (color, resources, layers))
    body = struct.pack(">H", compression)
    if compression == 1:
        if streams is None:
            coded = [packbits_row(r) for p in planes for r in p]
            counts, streams = [len(x) for x in coded], [b"".join(coded)]
        body += struct.pack(f">{len(counts)}H", *counts) + b"".join(streams)
    else:
        body += planes.tobytes() if streams is None else b"".join(streams)
    return head + sections + body


def pcx_rle_rows(rows: np.ndarray, cross_rows: bool = False) -> bytes:
    """PCX RLE of ``rows`` ((h, row bytes)): a run of 2-63 equal bytes, or a
    byte of 0xC0 and up, as 0xC0 | n and the byte, any other byte as
    itself; runs stop at each row's end unless ``cross_rows``."""
    rows = np.asarray(rows, np.uint8)
    out = bytearray()
    for line in [rows.reshape(-1)] if cross_rows else rows:
        for a, n in _runs(line, 63):
            v = int(line[a])
            out += bytes([v]) if n == 1 and v < 0xC0 else bytes([0xC0 | n, v])
    return bytes(out)


def pcx_file(rows: np.ndarray, w: int, h: int, bits: int, planes: int, version: int = 5, stride: Optional[int] = None,
             palette16: bytes = bytes(48), trailing: Optional[bytes] = None, origin=(0, 0), body: Optional[bytes] = None,
             cross_rows: bool = False) -> bytes:
    """A PCX of ``rows`` ((h, planes * the header's stride) bytes, each row its
    planes one after the other), RLE (``pcx_rle_rows``) or ``body`` as
    given; the header's bbox from ``origin``, ``stride`` its bytes a plane
    row ((w * bits + 7) // 8 rounded up to even by default), its 16-colour
    palette, and ``trailing`` (a 12 and 768 bytes of palette) after the
    data."""
    stride = -(-((w * bits + 7) // 8) // 2) * 2 if stride is None else stride
    x0, y0 = origin
    head = struct.pack("<BBBBHHHHHH48sBBHHHH", 10, version, 1, bits, x0, y0, x0 + w - 1, y0 + h - 1, 72, 72,
                       palette16, 0, planes, stride, 1, 0, 0)
    data = pcx_rle_rows(rows, cross_rows) if body is None else body
    return head + bytes(128 - len(head)) + data + (trailing or b"")


def sgi_rle_row(samples: np.ndarray, bpc: int) -> bytes:
    """One channel's row in SGI RLE: runs of 2-127 as n and the sample,
    copies of up to 127 as 0x80 | n and the samples, a 0 at the end; 16-bit
    samples as big-endian atoms, each count the low byte of one."""
    samples = np.asarray(samples)
    atom = (lambda v: bytes([v])) if bpc == 1 else (lambda v: struct.pack(">H", v))
    out, lit = bytearray(), []
    for a, n in _runs(samples, 127) + [(len(samples), 0)]:
        if n == 1:
            lit.append(a)
            if len(lit) < 127:
                continue
        if lit:
            out += atom(0x80 | len(lit)) + b"".join(atom(int(v)) for v in samples[lit[0]:lit[-1] + 1])
            lit = []
        if n >= 2:
            out += atom(n) + atom(int(samples[a]))
    return bytes(out + atom(0))


def sgi_file(samples: np.ndarray, bpc: int = 1, storage: int = 0, dimension: Optional[int] = None,
             rows: Optional[Dict[Tuple[int, int], bytes]] = None, tables: Optional[Tuple[list, list]] = None,
             zsize: Optional[int] = None) -> bytes:
    """An SGI image of ``samples`` ((h, w, z) integers of ``bpc`` bytes, top
    row first; stored bottom-up), raw (each channel's plane after the
    other) or RLE (storage 1: a packet row per channel and row,
    ``sgi_rle_row``, or ``rows`` {(row from the bottom, channel): bytes}),
    its offset and length tables, or ``tables`` as given; ``dimension``
    (3, or 2 for one channel, by default) and ``zsize`` as given."""
    s = np.asarray(samples)
    s = s[:, :, None] if s.ndim == 2 else s
    h, w, z = s.shape
    dimension = dimension or (2 if z == 1 else 3)
    head = struct.pack(">HBBHHHHII4s80sI", 474, storage, bpc, dimension, w, h, zsize or z, 0, 255 * bpc - 1, b"",
                       b"seeded", 0)
    head += bytes(512 - len(head))
    up = s[::-1]
    if storage != 1:
        return head + up.transpose(2, 0, 1).astype(">u2" if bpc == 2 else np.uint8).tobytes()
    data = rows or {(y, c): sgi_rle_row(up[y, :, c], bpc) for c in range(z) for y in range(h)}
    at = 512 + 8 * h * z
    offsets, lengths, body = [], [], bytearray()
    for c in range(z):
        for y in range(h):
            offsets.append(at + len(body))
            lengths.append(len(data[y, c]))
            body += data[y, c]
    offsets, lengths = tables or (offsets, lengths)
    return head + struct.pack(f">{len(offsets)}I{len(lengths)}I", *offsets, *lengths) + bytes(body)


def qoi_file(w: int, h: int, channels: int, ops: bytes, end: bytes = b"\0" * 7 + b"\1") -> bytes:
    """A QOI file: its header, then ``ops`` and ``end`` as given."""
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + ops + end


def qoi_encode(img: np.ndarray) -> bytes:
    """A QOI file of ``img`` (uint8 (h, w, 3) or (h, w, 4)), in numpy alone
    (so the card's machine writes it): runs of up to 62, then DIFF, LUMA,
    RGB or RGBA, each from the pixel before; no INDEX op."""
    h, w, c = img.shape
    px = np.concatenate([img.reshape(-1, c), np.full((h * w, 4 - c), 255, np.uint8)], 1).astype(np.int64)
    prev = np.concatenate([[[0, 0, 0, 255]], px[:-1]])
    same = (px == prev).all(axis=1)
    d = (px - prev + 128) % 256 - 128
    dg = d[:, 1]
    diff = ~same & (d[:, :3] >= -2).all(axis=1) & (d[:, :3] <= 1).all(axis=1) & (d[:, 3] == 0)
    dr, db = d[:, 0] - dg, d[:, 2] - dg
    luma = ~same & ~diff & (d[:, 3] == 0) & (dg >= -32) & (dg <= 31) & (dr >= -8) & (dr <= 7) & (db >= -8) & (db <= 7)
    rgb = ~same & ~diff & ~luma & (d[:, 3] == 0)
    ops = np.zeros((h * w, 5), np.int64)
    size = np.zeros(h * w, np.int64)
    ops[diff, 0] = 0x40 | (d[diff, 0] + 2) << 4 | (d[diff, 1] + 2) << 2 | (d[diff, 2] + 2)
    size[diff] = 1
    ops[luma, 0], ops[luma, 1] = 0x80 | (dg[luma] + 32), (dr[luma] + 8) << 4 | (db[luma] + 8)
    size[luma] = 2
    ops[rgb, 0], ops[rgb, 1:4], size[rgb] = 0xFE, px[rgb, :3], 4
    full = ~same & ~diff & ~luma & ~rgb
    ops[full, 0], ops[full, 1:5], size[full] = 0xFF, px[full], 5
    # each run of repeated pixels, cut into runs of 62: one byte at its first pixel
    edge = np.diff(np.concatenate([[0], same.astype(np.int8), [0]]))
    for a, b in zip(np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)):
        for k in range(a, b, 62):
            ops[k, 0], size[k] = 0xC0 | (min(62, b - k) - 1), 1
    keep = np.arange(5)[None, :] < size[:, None]
    return qoi_file(w, h, c, ops[keep].astype(np.uint8).tobytes())



def _pil_raster(img: np.ndarray, mode: str, fmt: str, **kw) -> bytes:
    from PIL import Image

    return pil_bytes(Image.fromarray(img).convert(mode), fmt, **kw)


def raster_layouts() -> Dict[str, bytes]:
    """A file of each PSD, PCX, SGI and QOI layout the port reads (name ->
    bytes; Pillow reads each): PSD of every mode (Lab in ``lab_psd_layouts``), raw and PackBits,
    with colour data, resources and layers to skip, PackBits streams of
    no-ops and runs across rows; PCX of 1 bit in 1, 2 and 4 planes, 8 bits
    in 1 plane (gray, with a palette, with the gray ramp) and in 3, strides
    Pillow pads and does not, Pillow's writer; SGI of the eight layouts
    raw and RLE, Pillow's writer, rows left unterminated, offsets shared;
    QOI from Pillow's writer and of every op by hand, INDEX on empty slots
    and runs the index does not take in."""
    r = np.random.default_rng(2011)
    h, w = 11, 13
    img = np.clip(smooth_scene(2012, h, w, cell=8, step=4).astype(np.int64) + r.integers(-6, 7, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    planes = np.concatenate([img, img[..., :2] // 2], 2).transpose(2, 0, 1)  # five channels
    gray = planes[1:2]
    bits1 = _pack(r.integers(0, 2, (h, w, 1)), 1)[None]
    out = {}
    # PSD
    res = psd_resource(1005, b"", bytes(16)) + psd_resource(1039, b"icc", bytes(7)) + psd_resource(1060, b"ab", b"x")
    layers = struct.pack(">I", 20) + bytes(r.integers(0, 256, 20, dtype=np.uint8)) + bytes(6)
    palette = bytes(r.integers(0, 256, 768, dtype=np.uint8))
    for comp, tag in ((0, "raw"), (1, "packbits")):
        out[f"psd/rgb-{tag}.psd"] = psd_file(planes[:3], 3, w, compression=comp)
        out[f"psd/rgba-{tag}.psd"] = psd_file(planes[:4], 3, w, compression=comp)
        out[f"psd/rgb-5-channels-{tag}.psd"] = psd_file(planes, 3, w, compression=comp)
        out[f"psd/cmyk-{tag}.psd"] = psd_file(planes[:4], 4, w, compression=comp)
        out[f"psd/cmyk-5-channels-{tag}.psd"] = psd_file(planes, 4, w, compression=comp)
        out[f"psd/gray-{tag}.psd"] = psd_file(gray, 1, w, compression=comp)
        out[f"psd/indexed-{tag}.psd"] = psd_file(gray, 2, w, compression=comp, color=palette)
        out[f"psd/bitmap-{tag}.psd"] = psd_file(bits1, 0, w, bits=1, compression=comp)
    out["psd/bitmap-8-bit.psd"] = psd_file(gray, 0, w)
    out["psd/multichannel.psd"] = psd_file(planes[:2], 7, w, compression=1)
    out["psd/duotone.psd"] = psd_file(gray, 8, w, color=bytes(range(40)))
    out["psd/indexed-no-palette.psd"] = psd_file(gray, 2, w)
    out["psd/indexed-short-colour-data.psd"] = psd_file(gray, 2, w, color=palette[:767])
    out["psd/resources-and-layers.psd"] = psd_file(planes[:3], 3, w, compression=1, color=b"\x01\x02\x03",
                                                   resources=res, layers=layers)
    # a channel in one stream, over and over: a packet that crosses a row's end is cut there, and the
    # rows go on filling from the copies after it
    streams = [bytes([0x80]) + packbits_row(p.reshape(-1)) * 8 for p in planes[:3]]
    counts = [len(st) if y == 0 else 0 for st in streams for y in range(h)]
    out["psd/packbits-runs-across-rows.psd"] = psd_file(planes[:3], 3, w, compression=1, streams=streams,
                                                        counts=counts)
    # PCX
    for mode in ("1", "L", "P", "RGB"):
        out[f"pcx/pillow-{mode}.pcx"] = _pil_raster(img, mode, "PCX")
    idx2, idx4 = r.integers(0, 4, (h, w)), r.integers(0, 16, (h, w))
    pal16 = bytes(r.integers(0, 256, 48, dtype=np.uint8))

    def planes_of(idx, n, stride):
        rows = np.zeros((h, n * stride), np.uint8)
        for j in range(n):
            rows[:, j * stride:j * stride + (w + 7) // 8] = _pack(((idx >> j) & 1)[..., None], 1)
        return rows

    out["pcx/1-bit-2-planes.pcx"] = pcx_file(planes_of(idx2, 2, 2), w, h, 1, 2, palette16=pal16)
    out["pcx/1-bit-4-planes.pcx"] = pcx_file(planes_of(idx4, 4, 2), w, h, 1, 4, palette16=pal16)
    out["pcx/1-bit-4-planes-stride-3.pcx"] = pcx_file(planes_of(idx4, 4, 3), w, h, 1, 4, stride=3, palette16=pal16)
    out["pcx/1-bit-1-plane-version-0.pcx"] = pcx_file(bits1[0], w, h, 1, 1, version=0)
    trailing_ramp = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    padded = np.pad(gray[0], ((0, 0), (0, 1)))
    out["pcx/8-bit-gray.pcx"] = pcx_file(padded, w, h, 8, 1, trailing=bytes(800))
    out["pcx/8-bit-gray-ramp.pcx"] = pcx_file(padded, w, h, 8, 1, trailing=trailing_ramp)
    out["pcx/8-bit-palette.pcx"] = pcx_file(padded, w, h, 8, 1, trailing=b"\x0c" + palette)
    out["pcx/8-bit-odd-stride.pcx"] = pcx_file(gray[0], w, h, 8, 1, stride=w, trailing=b"\x0c" + palette)
    rgb_rows = np.concatenate([np.pad(img[..., k], ((0, 0), (0, 1))) for k in range(3)], 1)
    out["pcx/8-bit-3-planes.pcx"] = pcx_file(rgb_rows, w, h, 8, 3, origin=(3, 7))
    tga = bytearray(tga_file(img[..., ::-1], 2, 24, id_field=b"0123456789"))
    tga[4] = 5  # as PCX: xmin 5 past xmax 0 (bad PCX image size), so Pillow tries the next format, Targa
    out["pcx/bad-bbox-read-as-targa.tga"] = bytes(tga)
    out["pcx/8-bit-3-planes-header-stride-odd.pcx"] = pcx_file(
        np.concatenate([np.pad(img[..., k], ((0, 0), (0, 1))) for k in range(3)], 1), w, h, 8, 3, stride=15)
    # SGI
    wide = img.astype(np.int64) * 257 + r.integers(0, 256, img.shape)
    four = np.concatenate([img, img[..., :1]], 2)
    for bpc, src in ((1, img), (2, wide)):
        for storage in (0, 1):
            tag = f"{8 * bpc}-bit-{'rle' if storage else 'raw'}"
            out[f"sgi/gray-{tag}.sgi"] = sgi_file(src[..., 0], bpc, storage)
            out[f"sgi/gray-dimension-1-{tag}.sgi"] = sgi_file(src[..., 0], bpc, storage, dimension=1)
            out[f"sgi/rgb-{tag}.sgi"] = sgi_file(src, bpc, storage)
            out[f"sgi/rgba-{tag}.sgi"] = sgi_file(np.concatenate([src, src[..., :1]], 2), bpc, storage)
    for mode in ("L", "RGB", "RGBA"):
        out[f"sgi/pillow-{mode}.sgi"] = _pil_raster(four, mode, "SGI")
    n = h * 3
    rle = sgi_file(img, 1, 1)
    tab = list(struct.unpack(f">{2 * n}I", rle[512:512 + 8 * n]))
    shared = tab.copy()
    shared[5], shared[n + 5] = tab[0], tab[n]  # one row's packets read for another
    out["sgi/rle-shared-offsets.sgi"] = rle[:512] + struct.pack(f">{2 * n}I", *shared) + rle[512 + 8 * n:]
    short = tab.copy()
    short[n + h + 4] = 1  # channel 1 of row 4 from the bottom: one packet, not the terminator, and Pillow stops
    out["sgi/rle-one-packet-row.sgi"] = rle[:512] + struct.pack(f">{2 * n}I", *short) + rle[512 + 8 * n:]
    # QOI
    out["qoi/pillow-RGB.qoi"] = _pil_raster(img, "RGB", "QOI")
    out["qoi/pillow-RGBA.qoi"] = _pil_raster(four, "RGBA", "QOI")
    out["qoi/numpy-rgb.qoi"] = qoi_encode(img)
    out["qoi/numpy-rgba.qoi"] = qoi_encode(four)
    ops = (b"\x05" + b"\xc3" + b"\xfe\x10\x20\x30" + b"\x6a" + b"\xa0\x88" + b"\xff\x01\x02\x03\x04" + b"\x35"
           + b"\xc0" + b"\x00" + bytes([(0x10 * 3 + 0x20 * 5 + 0x30 * 7 + 255 * 11) % 64]) + b"\xfe\xff\x00\x00"
           + b"\xcb")
    out["qoi/every-op.qoi"] = qoi_file(5, 5, 3, ops)
    out["qoi/every-op-4-channels.qoi"] = qoi_file(5, 5, 4, ops)
    out["qoi/channels-0.qoi"] = qoi_file(5, 5, 0, ops)
    return {f"{RASTER}/{k}": v for k, v in sorted(out.items())}


def raster_refusals() -> Dict[str, Tuple[bytes, str]]:
    """PSD, PCX, SGI and QOI files Pillow 12.1.0 refuses: name -> (bytes,
    the reason the port's ``OSError`` names, a regular expression)."""
    r = np.random.default_rng(2013)
    h, w = 5, 7
    planes = r.integers(0, 256, (4, h, w)).astype(np.uint8)
    rgb = planes[:3].transpose(1, 2, 0)
    psd = psd_file(planes[:3], 3, w, compression=1)
    rows = np.concatenate([np.pad(rgb[..., k], ((0, 0), (0, 1))) for k in range(3)], 1)
    sgi = sgi_file(rgb, 1, 1)
    n = 3 * h
    tab = list(struct.unpack(f">{2 * n}I", sgi[512:512 + 8 * n]))
    tab[2] = 100
    return {
        "psd-16-bit.psd": (psd_file(planes[:3], 3, w, bits=16), "which Pillow does not identify"),
        "psd-version-2.psd": (psd_file(planes[:3], 3, w, version=2), "which Pillow does not identify"),
        "psd-zip.psd": (psd_file(planes[:3], 3, w, compression=2), "ZIP"),
        "psd-rgb-2-channels.psd": (psd_file(planes[:2], 3, w), "not enough channels"),
        "psd-lab-16-bit.psd": (psd_file(planes[:3], 9, w, bits=16), "which Pillow does not identify"),
        "psd-lab-2-channels.psd": (psd_file(planes[:2], 9, w), "not enough channels"),
        # Pillow reads the row counts of 3 channels, Lab's, and takes the fourth's for data
        "psd-lab-alpha-packbits.psd": (psd_file(planes, 9, w, compression=1), "truncated"),
        "psd-raw-cut-short.psd": (psd_file(planes[:3], 3, w)[:-5], "truncated"),
        "psd-packbits-cut-short.psd": (psd[:-3], "truncated"),
        "psd-counts-cut-short.psd": (psd_file(planes[:3], 3, w, compression=1, streams=[b""], counts=[1] * 4),
                                     "which Pillow does not identify"),
        "psd-header-cut-short.psd": (psd[:40], "which Pillow does not identify"),
        "pcx-unknown-mode.pcx": (pcx_file(rows, w, h, 8, 4), "unknown PCX mode"),
        "pcx-8-bit-version-2.pcx": (pcx_file(rows[:, :8], w, h, 8, 1, version=2), "unknown PCX mode"),
        "pcx-8-bit-shorter-than-its-palette.pcx": (pcx_file(rows[:, :8], w, h, 8, 1), "769-byte palette"),
        "pcx-bad-bbox.pcx": (pcx_file(rows, w, h, 8, 3)[:4] + struct.pack("<HHHH", 5, 5, 2, 2)
                             + pcx_file(rows, w, h, 8, 3)[12:], "bad PCX image size"),
        "pcx-run-across-rows.pcx": (pcx_file(rows, w, h, 8, 3, body=bytes([0xC0 | 30, 9]) + bytes(2000)),
                                    "past the end of its row"),
        "pcx-cut-short.pcx": (pcx_file(rows, w, h, 8, 3)[:140], "truncated"),
        "sgi-unknown-layout.sgi": (sgi_file(rgb, 1, 0, zsize=2), "Unsupported SGI image mode"),
        "sgi-storage-2.sgi": (sgi_file(rgb, 1, 2), "cannot load"),
        "sgi-raw-cut-short.sgi": (sgi_file(rgb, 1, 0)[:-3], "truncated"),
        "sgi-rle-tables-past-the-end.sgi": (sgi[:512 + 8 * n - 4], "table past the file's end"),
        "sgi-rle-offset-in-header.sgi": (sgi[:512] + struct.pack(f">{2 * n}I", *tab) + sgi[512 + 8 * n:],
                                         "buffer overrun"),
        "sgi-rle-run-past-row.sgi": (sgi_file(rgb, 1, 1, rows={(y, c): bytes([w + 1, 7, 0]) for y in range(h)
                                                               for c in range(3)}), "run past the end of its row"),
        "qoi-cut-short.qoi": (qoi_encode(rgb)[:-20], "truncated"),
        "qoi-rgb-op-cut-short.qoi": (qoi_file(2, 1, 3, b"\xfe\x01\x02\x03\xfe\x01", b""), "truncated"),
        "qoi-header-cut-short.qoi": (b"qoif" + struct.pack(">II", 4, 4), "which Pillow does not identify"),
        **jpeg_planes_refusals(),
    }


def card_scans() -> Dict[str, bytes]:
    """The card's 1024 px scan (``_scan``) as Group 4, as T.4 2-D with fill
    bits and as Modified Huffman, 128-row strips: name -> bytes."""
    scan = _scan(2125, 1024, 1024, cell=16)
    return {"scan-1024-g4.tif": ccitt_tiff(scan, 4, rows_per_strip=128),
            "scan-1024-g3-2d.tif": ccitt_tiff(scan, 3, t4options=5, fill_bits=True, rows_per_strip=128),
            "scan-1024-mh.tif": ccitt_tiff(scan, 2, rows_per_strip=128)}


def raster_card_originals() -> Dict[str, bytes]:
    """The card's written originals of ``RASTER_CARD`` (all but the
    committed ones), from seeded numpy alone: name (under
    ``psd_pcx_sgi_qoi/card/``) -> bytes."""
    side = 1024
    photo = smooth_scene(2021, side, side, cell=128, step=4)
    poster = smooth_scene(2022, side, side, cell=128, step=32)
    planes = photo.transpose(2, 0, 1)
    pcx_rows = np.concatenate([poster[..., k] for k in range(3)], 1)
    lab = smooth_scene(2124, side, side, cell=128, step=4)  # seeded L, a, b bands
    out = {
        "photo-1024-lab.tif": tiff_bytes(lab ^ np.array([0, 128, 128]), photometric=8, compression=5, predictor=2,
                                         rows_per_strip=64),
        "photo-1024-lab.psd": psd_file(lab.transpose(2, 0, 1), 9, side, compression=1),
        "photo-1024-big.tif": tiff_bytes(photo, compression=8, tile=(256, 256), big=True),
        **card_scans(),
        "photo-1024-packbits.psd": psd_file(planes, 3, side, compression=1,
                                            resources=psd_resource(1005, b"", bytes(16))),
        "photo-1024-raw.psd": psd_file(planes, 3, side),
        "poster-1024.pcx": pcx_file(pcx_rows, side, side, 8, 3),
        "photo-1024-rle.sgi": sgi_file(photo, 1, 1),
        "photo-1024.qoi": qoi_encode(photo),
    }
    assert sorted(out) == sorted(set(RASTER_CARD) - set(RASTER_COMMITTED_CARD))
    return {f"{RASTER}/card/{k}": v for k, v in out.items()}


def raster_committed_card() -> Dict[str, bytes]:
    """The committed card originals of ``RASTER_COMMITTED_CARD``, written by
    Pillow's libjpeg: the photo of ``raster_card_originals`` as a YCbCr 1 x
    1 JPEG TIFF in separate planes (64-row strips, JPEGTables) and as an RGB
    JPEG TIFF of the same strips, quality 75."""
    from PIL import Image

    photo = smooth_scene(2021, 1024, 1024, cell=128, step=4)
    ycc = np.asarray(Image.fromarray(photo).convert("YCbCr"))
    return {f"{RASTER}/card/photo-1024-jpeg-planes.tif": jpeg_tiff(ycc, 6, 75, (1, 1), rows_per_strip=64, planar=2),
            f"{RASTER}/card/photo-1024-jpeg-contig.tif": jpeg_tiff(photo, 2, 75, rows_per_strip=64)}


def raster_fixtures() -> Dict[str, bytes]:
    """Every committed file under ``psd_pcx_sgi_qoi/`` (name -> bytes),
    written anew: the layouts (the Lab, BigTIFF and CCITT TIFFs among
    them), the refusals and the committed card originals."""
    refused = {f"{RASTER}/refused/{k}": v for k, (v, _) in raster_refusals().items()}
    return dict(sorted({**raster_layouts(), **jpeg_planes_predictor_layouts(), **lab_psd_layouts(),
                        **lab_tiff_layouts(), **bigtiff_layouts(), **ccitt_layouts(), **refused,
                        **raster_committed_card()}.items()))


def committed_raster() -> Dict[str, bytes]:
    """The committed files under ``psd_pcx_sgi_qoi/``: name -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, RASTER)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def check_raster_card(folder: str, decode: Callable[[str], np.ndarray]) -> Dict[str, str]:
    """Writes ``raster_card_originals`` into ``folder`` and holds each, and
    each committed card original, to the manifest (``raster_card``; the
    committed ones under ``files``): bytes and ``decode``'s RGB.  Returns
    name -> path of each; raises ``AssertionError`` naming the first that
    differs."""
    manifest = load_manifest()
    want = {**manifest["raster_card"], **{n: e for n, e in manifest["files"].items()
                                          if n.startswith(f"{RASTER}/card/")}}
    paths = {}
    written = raster_card_originals()
    for name in sorted(want):
        path = os.path.join(FIXTURES, name)
        if name in written:
            if sha256(written[name]) != want[name]["sha256"]:
                raise AssertionError(f"{name}: the writer made other bytes than the manifest records")
            path = os.path.join(folder, os.path.basename(name))
            with open(path, "wb") as f:
                f.write(written[name])
        got = decode(path)
        if list(got.shape[:2]) != want[name]["shape"] or sha256(got) != want[name]["sha256_rgb"]:
            raise AssertionError(f"{name}: decoded to other pixels than Pillow's")
        paths[os.path.basename(name)] = path
    if sorted(paths) != sorted(RASTER_CARD):
        raise AssertionError(f"card originals {sorted(paths)}, expected {sorted(RASTER_CARD)}")
    return paths


# --- DDS, BLP, FTEX, ICNS, Sun raster and 32-bit gray TIFF: the Pillow lane ------

DBFIS = "dds_blp_ftex_icns_sun"  # their files' folder under FIXTURES
#: the card's originals, each by the listed name cli.prep reads it under,
#: or None for one only timed: written on the card from seeded numpy by
#: ``dbfis_card_originals`` (a 1024 px photo as a BC7 and a BC1 DDS, a
#: BLP2 DXT5, a BLP1 JPEG whose stream the port's encoder writes, a BC1
#: FTEX, an ICNS of a 1024 px PNG element, a 1024 px poster of 64 colours
#: as an 8-bit RLE Sun raster with a colour map and a 32-bit integer gray
#: TIFF)
DBFIS_CARD = {"photo-1024-bc7.dds": "photo-1024-bc7.png", "photo-1024-bc1.dds": "photo-1024-bc1.jpg",
              "photo-1024-dxt5.blp": "photo-1024-blp2.bmp", "photo-1024-jpeg.blp": "photo-1024-blp1.webp",
              "photo-1024-bc1.ftex": "photo-1024-ftex.png", "icon-1024-png.icns": "icon-1024-icns.png",
              "poster-1024-rle.ras": "poster-1024-sun.jpg", "gray-1024-int32.tif": "gray-1024-int32.bmp"}
#: DXGI formats by name (dxgiformat.h), those Pillow reads and some it does not
DXGI = {"R8G8B8A8_TYPELESS": 27, "R8G8B8A8_UNORM": 28, "R8G8B8A8_UNORM_SRGB": 29, "BC1_TYPELESS": 70,
        "BC1_UNORM": 71, "BC1_UNORM_SRGB": 72, "BC2_TYPELESS": 73, "BC2_UNORM": 74, "BC3_TYPELESS": 76,
        "BC3_UNORM": 77, "BC4_TYPELESS": 79, "BC4_UNORM": 80, "BC4_SNORM": 81, "BC5_TYPELESS": 82, "BC5_UNORM": 83,
        "BC5_SNORM": 84, "BC6H_TYPELESS": 94, "BC6H_UF16": 95, "BC6H_SF16": 96, "BC7_TYPELESS": 97, "BC7_UNORM": 98,
        "BC7_UNORM_SRGB": 99, "B8G8R8A8_UNORM": 87}
#: BC6H's mode bits (the first 2 or 5 bits of a block), in the format's order
BC6_MODE_BITS = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15)


def bcn_blocks(r, kind: str, n: int, mode: Optional[int] = None) -> np.ndarray:
    """``n`` seeded random blocks of ``kind`` (BC1-BC5: any bytes; BC6H:
    ``mode`` of ``BC6_MODE_BITS``' index, 14 a reserved one, or each block
    one of them at random; BC7: ``mode`` 0-7, 8 the reserved, or random):
    uint8 (n, block bytes)."""
    size = 8 if kind in ("BC1", "BC4") else 16
    b = r.integers(0, 256, (n, size), dtype=np.uint8)
    if kind.startswith("BC6"):
        modes = np.full(n, mode) if mode is not None else r.integers(0, 15, n)
        bits = np.array(BC6_MODE_BITS + (19,))[modes]  # 19: a reserved mode
        two = bits < 2
        b[:, 0] = np.where(two, (b[:, 0] & 0xFC) | bits, (b[:, 0] & 0xE0) | bits).astype(np.uint8)
    elif kind == "BC7":
        modes = np.full(n, mode) if mode is not None else r.integers(0, 9, n)
        first = (b[:, 0].astype(np.int64) << (modes + 1) | (1 << modes)) & 255
        b[:, 0] = np.where(modes == 8, 0, first).astype(np.uint8)
    return b


def _bits_le(fields: List[Tuple[np.ndarray, int]], n: int, total: int) -> np.ndarray:
    """Blocks of ``total`` bits from (values (n,), bits) fields, each least
    significant bit first, in order: uint8 (n, total // 8)."""
    out = np.zeros((n, total), np.uint8)
    at = 0
    for values, bits in fields:
        v = np.asarray(values, np.int64).reshape(n, -1)
        for k in range(v.shape[1]):
            out[:, at:at + bits] = (v[:, k:k + 1] >> np.arange(bits)) & 1
            at += bits
    assert at == total
    return np.packbits(out, axis=1, bitorder="little")


def _blocks_of(img: np.ndarray) -> np.ndarray:
    """(h, w, c) with h and w multiples of 4 as (h/4 * w/4, 16, c) pixels,
    blocks in rows, pixels in rows."""
    h, w, c = img.shape
    return img.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(-1, 16, c)


def bc1_encode(img: np.ndarray) -> np.ndarray:
    """A simple BC1 encoder for the card's originals: each 4 x 4 block's
    brightest and darkest pixel as 5:6:5 endpoints (color0 > color1, the
    four-colour mode; a flat block gives both the same, read as three
    colours and black, which no index picks) and each pixel's nearest of
    the four colours (bcn's expansion): uint8 (blocks, 8)."""
    px = _blocks_of(img).astype(np.int64)
    luma = px @ np.array([2, 4, 1])
    hi = px[np.arange(len(px)), luma.argmax(1)]
    lo = px[np.arange(len(px)), luma.argmin(1)]

    def pack(c):
        return (c[:, 0] >> 3) << 11 | (c[:, 1] >> 2) << 5 | c[:, 2] >> 3

    c0, c1 = pack(hi), pack(lo)
    swap = c0 < c1
    c0, c1 = np.where(swap, c1, c0), np.where(swap, c0, c1)

    def expand(c):
        r, g, b = (c >> 11 & 31) << 3, (c >> 5 & 63) << 2, (c & 31) << 3
        return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)

    e0, e1 = expand(c0), expand(c1)
    colours = np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3], 1)
    idx = ((px[:, :, None, :] - colours[:, None]) ** 2).sum(-1).argmin(-1)
    return _bits_le([(c0, 16), (c1, 16), (idx, 2)], len(px), 64)


def bc7_encode(img: np.ndarray) -> np.ndarray:
    """A simple BC7 encoder for the card's originals: mode 6 (one subset,
    7-bit RGBA endpoints and a p-bit each, 4-bit indices), each block's
    per-channel minimum and maximum as the endpoints (p-bit 0, alpha 255
    but for the p-bit), each pixel's index its projection on the line
    between them: uint8 (blocks, 16)."""
    px = _blocks_of(img).astype(np.int64)
    n = len(px)
    lo, hi = px.min(1) >> 1, (px.max(1) + 1) >> 1
    hi = np.minimum(hi, 127)
    e0, e1 = lo << 1, hi << 1
    d = e1 - e0
    dot = ((px - e0[:, None]) * d[:, None]).sum(-1)
    den = np.maximum((d * d).sum(-1), 1)[:, None]
    idx = np.clip((dot * 15 * 2 + den) // (2 * den), 0, 15)
    flip = idx[:, 0] >= 8  # the anchor's index has 3 bits: swap the endpoints where it is past them
    e0f, e1f = np.where(flip[:, None], hi, lo), np.where(flip[:, None], lo, hi)
    idx = np.where(flip[:, None], 15 - idx, idx)
    fields = [(np.full(n, 1 << 6), 7)]
    for c in range(3):
        fields.append((np.stack([e0f[:, c], e1f[:, c]], 1), 7))
    fields += [(np.full((n, 2), 127), 7), (np.zeros((n, 2)), 1), (idx[:, :1], 3), (idx[:, 1:], 4)]
    return _bits_le(fields, n, 128)


def dds_file(w: int, h: int, payload: bytes, fourcc: bytes = b"", dxgi: Optional[int] = None, pfflags: int = 0x4,
             bitcount: int = 0, masks=(0, 0, 0, 0), header_size: int = 124, palette: bytes = b"",
             mipmaps: int = 0) -> bytes:
    """A DDS of one surface: the 128-byte header (``header_size`` in its
    size field), the pixel format (``pfflags``, ``fourcc``, ``bitcount``,
    ``masks``), a DX10 header where ``dxgi`` is given (FourCC DX10),
    ``palette`` and then ``payload``."""
    if dxgi is not None:
        fourcc = b"DX10"
    pf = struct.pack("<2I", 32, pfflags) + (fourcc or bytes(4)) + struct.pack("<5I", bitcount, *masks)
    head = b"DDS " + struct.pack("<7I", header_size, 0x1007 | (0x20000 if mipmaps else 0), h, w, 0, 0, mipmaps)
    head += bytes(44) + pf + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + palette + payload


def dds_rgb_values(pixels: np.ndarray, masks, bitcount: int) -> bytes:
    """(h, w, c) channel values in [0, 255] packed into ``bitcount``-bit
    little-endian words by ``masks`` (each value scaled to its field)."""
    v = np.zeros(pixels.shape[:2], np.int64)
    for c, mask in enumerate(masks):
        if mask:
            shift = (mask & -mask).bit_length() - 1
            v |= ((pixels[..., c].astype(np.int64) * (mask >> shift) // 255) << shift) & mask
    return v.astype("<u8").view(np.uint8).reshape(v.shape + (8,))[..., :bitcount // 8].tobytes()


def blp_file(version: int, w: int, h: int, mip: bytes, compression: int = 1, encoding: int = 1, alpha: int = 0,
             alpha_encoding: int = 0, palette: Optional[bytes] = None, offset: Optional[int] = None,
             length: Optional[int] = None, jpeg_header: Optional[bytes] = None) -> bytes:
    """A BLP1 or BLP2 of one mip: the header, 16 mip offsets and lengths
    (the first ``offset`` and ``length``, by default where ``mip`` is),
    then (BLP1 JPEG) ``jpeg_header``'s size and bytes or else a 1024-byte
    palette (``palette``, seeded where None), then ``mip``."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, w, h, encoding, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding, 1, w, h)
    if jpeg_header is not None:
        table = struct.pack("<I", len(jpeg_header)) + jpeg_header
    else:
        table = palette if palette is not None else np.random.default_rng(w * 131 + h).integers(
            0, 256, 1024, dtype=np.uint8).tobytes()
    at = len(head) + 128 + len(table)
    offsets = struct.pack("<16I", at if offset is None else offset, *(0,) * 15)
    lengths = struct.pack("<16I", len(mip) if length is None else length, *(0,) * 15)
    return head + offsets + lengths + table + mip


def jpeg_split(jpeg: bytes) -> Tuple[bytes, bytes]:
    """A JPEG stream split as BLP1 keeps it: the header shared by every
    mip (up to the scan) and the first mip's bytes (the scan onward)."""
    at = jpeg.index(b"\xff\xda")
    return jpeg[:at], jpeg[at:]


def ftex_file(w: int, h: int, fmt: int, mip: bytes, formats: int = 1, size: Optional[int] = None) -> bytes:
    """An FTEX of one format: header, the format and where its first mipmap
    is, then the mipmap's size (``size``, by default its length) and bytes."""
    head = b"FTEX" + struct.pack("<6i", 1, w, h, 1, formats, fmt) + struct.pack("<i", 32)
    return head + struct.pack("<i", len(mip) if size is None else size) + mip


def icns_rle(channel: np.ndarray) -> bytes:
    """One channel of an ICNS 24-bit element as its RLE: runs of 3-130
    equal bytes as (count + 125, value), other bytes in literals of up to
    128 as (count - 1, bytes)."""
    v = np.asarray(channel, np.uint8).reshape(-1)
    out, i, n = bytearray(), 0, v.size
    while i < n:
        j = i
        while j < n and j - i < 130 and v[j] == v[i]:
            j += 1
        if j - i >= 3:
            out += bytes((j - i + 125, int(v[i])))
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and v[j] == v[j + 1] == v[j + 2]):
            j += 1
        out += bytes((j - i - 1,)) + v[i:j].tobytes()
        i = j
    return bytes(out)


def icns_file(elements: List[Tuple[bytes, bytes]], size: Optional[int] = None) -> bytes:
    """An ICNS of ``elements`` (type, bytes) in order, its header's size the
    file's unless ``size`` is given."""
    body = b"".join(code + struct.pack(">I", len(data) + 8) + data for code, data in elements)
    return b"icns" + struct.pack(">I", len(body) + 8 if size is None else size) + body


def icns_rgb(img: np.ndarray, raw: bool = False, it32: bool = False) -> bytes:
    """An ICNS 24-bit element of ``img``: RLE channels after each other, or
    ``raw`` RGB; ``it32`` puts its four zero bytes first."""
    data = img.astype(np.uint8).tobytes() if raw else b"".join(icns_rle(img[..., c]) for c in range(3))
    return (bytes(4) if it32 else b"") + data


def sun_rle(rows: np.ndarray, cross_rows: bool = True) -> bytes:
    """Sun raster RLE of byte rows: runs of 2-256 as (0x80, count - 1,
    value), a 0x80 alone as (0x80, 0), other bytes as they are; runs cross
    row ends where ``cross_rows``."""
    out = bytearray()
    for seq in ([rows.reshape(-1)] if cross_rows else list(rows)):
        i, n = 0, len(seq)
        while i < n:
            j = i
            while j < n and j - i < 256 and seq[j] == seq[i]:
                j += 1
            if j - i >= 3 or (j - i >= 2 and seq[i] == 0x80):
                out += bytes((0x80, j - i - 1, int(seq[i])))
                i = j
            elif seq[i] == 0x80:
                out += b"\x80\x00"
                i += 1
            else:
                out.append(int(seq[i]))
                i += 1
    return bytes(out)


def sun_file(w: int, h: int, depth: int, ftype: int, body: bytes, palette: bytes = b"", ptype: int = 1) -> bytes:
    """A Sun raster: the 32-byte header, the colour map and ``body``."""
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype, ptype if palette else 0,
                       len(palette)) + palette + body


def sun_rows(px: np.ndarray, depth: int, pad: bool = True) -> np.ndarray:
    """Pixels as Sun raster rows: (h, w) samples of 1, 4 or 8 bits, or
    (h, w, 3|4) bytes in file order; each row padded to 16 bits where
    ``pad``."""
    h, w = px.shape[:2]
    rows = _pack(px[..., None], depth) if depth < 8 else px.reshape(h, -1).astype(np.uint8)
    if pad and rows.shape[1] % 2:
        rows = np.concatenate([rows, np.zeros((h, 1), np.uint8)], 1)
    return rows


def _dds_layouts(r) -> Dict[str, bytes]:
    out = {}
    for name, fourcc, kind in (("bc1-dxt1", b"DXT1", "BC1"), ("bc2-dxt3", b"DXT3", "BC2"), ("bc3-dxt5", b"DXT5", "BC3"),
                               ("bc4-ati1", b"ATI1", "BC4"), ("bc4-bc4u", b"BC4U", "BC4"),
                               ("bc5-ati2", b"ATI2", "BC5"), ("bc5-bc5u", b"BC5U", "BC5"), ("bc5s", b"BC5S", "BC5")):
        for w, h in ((16, 12), (13, 7)):
            out[f"dds/{name}-{w}x{h}.dds"] = dds_file(w, h, bcn_blocks(r, kind, (w + 3) // 4 * ((h + 3) // 4)).tobytes(),
                                                     fourcc)
    for dxgi in ("BC1_TYPELESS", "BC1_UNORM", "BC2_TYPELESS", "BC2_UNORM", "BC3_TYPELESS", "BC3_UNORM", "BC4_TYPELESS",
                 "BC4_UNORM", "BC5_TYPELESS", "BC5_UNORM", "BC5_SNORM", "BC7_TYPELESS", "BC7_UNORM_SRGB"):
        kind = dxgi[:3]
        out[f"dds/dx10-{dxgi.lower()}-9x10.dds"] = dds_file(9, 10, bcn_blocks(r, kind, 9).tobytes(), dxgi=DXGI[dxgi])
    for mode in range(9):
        out[f"dds/bc7-mode{mode}-16x8.dds"] = dds_file(16, 8, bcn_blocks(r, "BC7", 8, mode).tobytes(),
                                                      dxgi=DXGI["BC7_UNORM"])
    for mode in range(15):
        for dxgi in ("BC6H_UF16", "BC6H_SF16"):
            out[f"dds/{dxgi[:4].lower()}{'s' if 'SF' in dxgi else ''}-mode{mode}-16x8.dds"] = dds_file(
                16, 8, bcn_blocks(r, "BC6", 8, mode).tobytes(), dxgi=DXGI[dxgi])
    out["dds/bc7-every-mode-29x23.dds"] = dds_file(29, 23, bcn_blocks(r, "BC7", 48).tobytes(), dxgi=DXGI["BC7_UNORM"])
    out["dds/bc6h-every-mode-29x23.dds"] = dds_file(29, 23, bcn_blocks(r, "BC6", 48).tobytes(), dxgi=DXGI["BC6H_UF16"])
    img = source_image(2201, 11, 14)
    rgba = np.concatenate([img, r.integers(0, 256, (11, 14, 1))], 2)
    for dxgi in ("R8G8B8A8_TYPELESS", "R8G8B8A8_UNORM", "R8G8B8A8_UNORM_SRGB"):
        out[f"dds/dx10-{dxgi.lower()}-14x11.dds"] = dds_file(14, 11, rgba.astype(np.uint8).tobytes(), dxgi=DXGI[dxgi])
    for name, bitcount, masks, alpha in (
            ("rgb24", 24, (0xFF0000, 0xFF00, 0xFF, 0), False), ("bgr24", 24, (0xFF, 0xFF00, 0xFF0000, 0), False),
            ("rgba32", 32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), True), ("xrgb32", 32, (0xFF0000, 0xFF00, 0xFF, 0), False),
            ("rgb565", 16, (0xF800, 0x7E0, 0x1F, 0), False), ("argb1555", 16, (0x7C00, 0x3E0, 0x1F, 0x8000), True),
            ("argb4444", 16, (0xF00, 0xF0, 0xF, 0xF000), True), ("rgb332", 8, (0xE0, 0x1C, 0x3, 0), False),
            ("rgb10a2", 32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), True),
            ("split-masks", 16, (0b1010000000000000, 0x0FF0, 0b101, 0), False)):
        body = dds_rgb_values(rgba, masks, bitcount)
        out[f"dds/{name}-14x11.dds"] = dds_file(14, 11, body, pfflags=0x40 | (1 if alpha else 0), bitcount=bitcount,
                                               masks=masks)
    out["dds/rgb24-cut-short-14x11.dds"] = dds_file(14, 11, dds_rgb_values(rgba, (0xFF0000, 0xFF00, 0xFF), 24)[:200],
                                                   pfflags=0x40, bitcount=24, masks=(0xFF0000, 0xFF00, 0xFF, 0))
    out["dds/l8-14x11.dds"] = dds_file(14, 11, img[..., 0].tobytes(), pfflags=0x20000, bitcount=8)
    out["dds/la16-14x11.dds"] = dds_file(14, 11, rgba[..., ::3].astype(np.uint8).tobytes(), pfflags=0x20001,
                                         bitcount=16)
    out["dds/p8-14x11.dds"] = dds_file(14, 11, r.integers(0, 256, 154, dtype=np.uint8).tobytes(), pfflags=0x20,
                                       bitcount=8, palette=r.integers(0, 256, 1024, dtype=np.uint8).tobytes())
    out["dds/bc1-mipmaps-8x8.dds"] = dds_file(8, 8, bcn_blocks(r, "BC1", 4 + 1 + 1).tobytes(), b"DXT1", mipmaps=3)
    return out


def _blp_layouts(r) -> Dict[str, bytes]:
    from PIL import Image

    out = {}
    img = source_image(2202, 13, 18)
    for q, sub in ((85, "4:2:0"), (60, "4:4:4")):
        header, mip = jpeg_split(pil_bytes(Image.fromarray(img), "JPEG", quality=q, subsampling=sub))
        out[f"blp/blp1-jpeg-q{q}-18x13.blp"] = blp_file(1, 18, 13, mip, compression=0, jpeg_header=header)
    header, mip = jpeg_split(pil_bytes(Image.fromarray(img).convert("L"), "JPEG", quality=80))
    out["blp/blp1-jpeg-gray-18x13.blp"] = blp_file(1, 18, 13, mip, compression=0, jpeg_header=header)
    cmyk = np.concatenate([255 - img, img.min(2, keepdims=True) // 2], 2).astype(np.uint8)
    header, mip = jpeg_split(pil_bytes(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=90))
    out["blp/blp1-jpeg-cmyk-18x13.blp"] = blp_file(1, 18, 13, mip, compression=0, jpeg_header=header)
    wide = source_image(2203, 13, 24)
    header, mip = jpeg_split(port_jpeg(wide, 75))
    out["blp/blp1-jpeg-narrower-than-stream-18x13.blp"] = blp_file(1, 18, 13, mip, compression=0, jpeg_header=header)
    out["blp/blp1-jpeg-alpha-18x13.blp"] = blp_file(1, 18, 13, mip, compression=0, jpeg_header=header, alpha=8)
    for kind in ("ycck-420", "cmyk-no-adobe"):  # the committed JPEG kinds' files, which the system's libjpeg wrote
        with open(os.path.join(FIXTURES, KINDS, f"{kind}.jpg"), "rb") as f:
            header, mip = jpeg_split(f.read())
        out[f"blp/blp1-jpeg-{kind}.blp"] = blp_file(1, 17, 11, mip, compression=0, jpeg_header=header)
    out["blp/blp1-jpeg-gap-24x13.blp"] = blp_file(1, 24, 13, b"\0" * 7 + mip, compression=0, jpeg_header=header,
                                                 offset=28 + 128 + 4 + len(header) + 7, length=len(mip))
    idx = r.integers(0, 256, (13, 18), dtype=np.uint8)
    alpha_plane = r.integers(0, 256, 13 * 18, dtype=np.uint8).tobytes()
    for version in (1, 2):
        for depth in (0, 1, 4, 8):
            out[f"blp/blp{version}-palette-alpha{depth}-18x13.blp"] = blp_file(
                version, 18, 13, idx.tobytes() + alpha_plane[:13 * 18 * depth // 8], encoding=4 + (depth > 0)
                if version == 1 else 1, alpha=depth)
    out["blp/blp1-palette-offset-elsewhere-18x13.blp"] = blp_file(1, 18, 13, idx.tobytes(), encoding=5, offset=9)
    out["blp/blp2-palette-long-mip-18x13.blp"] = blp_file(2, 18, 13, idx.tobytes() + bytes(40), alpha=8)
    for w, h in ((16, 8), (18, 13)):
        n = (w + 3) // 4 * ((h + 3) // 4)
        for name, enc, size in (("dxt1", 0, 8), ("dxt3", 1, 16), ("dxt5", 7, 16)):
            kind = {"dxt1": "BC1", "dxt3": "BC2", "dxt5": "BC3"}[name]
            blocks = bcn_blocks(r, kind, n).tobytes()
            for alpha in (0, 8) if name != "dxt1" else (0, 1):
                out[f"blp/blp2-{name}-alpha{alpha}-{w}x{h}.blp"] = blp_file(2, w, h, blocks, encoding=2, alpha=alpha,
                                                                           alpha_encoding=enc)
    return out


def _ftex_icns_sun_layouts(r) -> Dict[str, bytes]:
    out = {}
    for w, h in ((16, 8), (13, 10)):
        n = (w + 3) // 4 * ((h + 3) // 4)
        out[f"ftex/bc1-{w}x{h}.ftc"] = ftex_file(w, h, 0, bcn_blocks(r, "BC1", n).tobytes() + bytes(24))
        out[f"ftex/rgb-{w}x{h}.ftu"] = ftex_file(w, h, 1, source_image(2204 + w, h, w).tobytes())
    out["ftex/rgb-size-to-end-13x10.ftu"] = ftex_file(13, 10, 1, source_image(2206, 10, 13).tobytes(), size=-1)
    icon = {s: smooth_scene(2210 + s, s, s, cell=4, step=8) for s in (16, 32, 48, 128)}
    mask = {s: r.integers(0, 256, s * s, dtype=np.uint8).tobytes() for s in icon}
    out["icns/is32-s8mk-16.icns"] = icns_file([(b"is32", icns_rgb(icon[16])), (b"s8mk", mask[16])])
    out["icns/il32-32.icns"] = icns_file([(b"il32", icns_rgb(icon[32]))])
    out["icns/ih32-h8mk-48.icns"] = icns_file([(b"is32", icns_rgb(icon[16])), (b"ih32", icns_rgb(icon[48])),
                                              (b"h8mk", mask[48])])
    out["icns/it32-t8mk-128.icns"] = icns_file([(b"TOC ", bytes(16)), (b"it32", icns_rgb(icon[128], it32=True)),
                                               (b"t8mk", mask[128])])
    out["icns/il32-raw-32.icns"] = icns_file([(b"il32", icns_rgb(icon[32], raw=True))])
    noisy = r.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    out["icns/il32-noisy-32.icns"] = icns_file([(b"il32", icns_rgb(noisy))])
    png64 = png_bytes(np.concatenate([icon[128][::2, ::2], icon[128][::2, ::2, :1]], 2), 8, 6)
    out["icns/ic07-png-64-in-128.icns"] = icns_file([(b"ic07", png64), (b"it32", icns_rgb(icon[128], it32=True)),
                                                    (b"t8mk", mask[128])])
    out["icns/ic10-png-gray-32.icns"] = icns_file([(b"is32", icns_rgb(icon[16])),
                                                  (b"ic10", png_bytes(icon[32][..., :1], 8, 0))])
    out["icns/icp4-png-16-replaced.icns"] = icns_file([(b"icp4", png_bytes(icon[48], 8, 2)),
                                                      (b"icp4", png_bytes(icon[16], 8, 2))])
    for depth in (1, 4, 8):
        for w in (13, 16):
            px = r.integers(0, 1 << depth, (9, w))
            out[f"sun/depth{depth}-{w}x9.ras"] = sun_file(w, 9, depth, 1, sun_rows(px, depth).tobytes())
            out[f"sun/depth{depth}-rle-{w}x9.ras"] = sun_file(w, 9, depth, 2, sun_rle(sun_rows(px, depth, pad=False)))
    pal = r.integers(0, 256, 3 * 200, dtype=np.uint8).tobytes()
    idx = r.integers(0, 256, (9, 13)) // 8 * 8
    out["sun/depth8-map-13x9.ras"] = sun_file(13, 9, 8, 1, sun_rows(idx, 8).tobytes(), pal)
    out["sun/depth8-map-rle-13x9.ras"] = sun_file(13, 9, 8, 2, sun_rle(sun_rows(idx, 8, pad=False)), pal[:301])
    out["sun/depth4-map-13x9.ras"] = sun_file(13, 9, 4, 0, sun_rows(idx % 16, 4).tobytes(), pal[:48])
    img = smooth_scene(2212, 9, 13, cell=4, step=16)
    for ftype in (0, 1, 2, 3, 4, 5):
        for depth in (24, 32):
            order = img if ftype == 3 else img[..., ::-1]
            px = np.concatenate([order, r.integers(0, 256, (9, 13, 1))], 2).astype(np.uint8) if depth == 32 else order
            body = sun_rle(sun_rows(px, 8, pad=False)) if ftype == 2 else sun_rows(px, 8).tobytes()
            out[f"sun/depth{depth}-type{ftype}-13x9.ras"] = sun_file(13, 9, depth, ftype, body)
    runs = np.repeat(np.array([[0x80, 7, 0x80, 0x80, 9]], np.uint8), 40, 0).reshape(8, 25)
    out["sun/depth8-rle-escapes-25x8.ras"] = sun_file(25, 8, 8, 2, sun_rle(runs) + b"\x80\xff\x11")
    gray = r.integers(-300, 600, (11, 17))
    for name, fmt, kw in (("ii-unsigned", 1, {}), ("ii-signed", 2, {}), ("mm-signed", 2, {"order": ">"}),
                          ("ii-unsigned-lzw-predictor", 1, {"compression": 5, "predictor": 2}),
                          ("mm-signed-deflate-predictor", 2, {"order": ">", "compression": 8, "predictor": 2}),
                          ("ii-signed-packbits-strips", 2, {"compression": 32773, "rows_per_strip": 4}),
                          ("mm-signed-lzw-tiles", 2, {"order": ">", "compression": 5, "tile": (16, 16)}),
                          ("ii-unsigned-planar", 1, {"planar": 2}), ("mm-signed-planar", 2, {"order": ">", "planar": 2})):
        values = gray % 2 ** 32 if fmt == 2 else np.abs(gray) * (1 + (gray > 500) * 2 ** 22)
        out[f"tiff/int32-{name}-17x11.tif"] = tiff_bytes(values % 2 ** 32, 32, 1, compression=kw.pop("compression", 1),
                                                         tags={339: (3, [fmt])}, **kw)
    return out


def dbfis_layouts() -> Dict[str, bytes]:
    """A file of each DDS, BLP, FTEX, ICNS, Sun raster and 32-bit integer
    gray TIFF layout the port reads (name -> bytes; Pillow reads each):
    seeded random BCn blocks of every BC1-BC7 kind and every BC6H and BC7
    mode (the reserved ones too), edge blocks, each FourCC and DXGI format
    Pillow reads, bit masks, luminance and palette; BLP1 JPEG (RGB, gray,
    CMYK, a stream wider than the file, a gap before the mip) and palette,
    BLP2 palette and DXT1/3/5 with and without alpha; FTEX BC1 and raw;
    ICNS of RLE, raw, PNG elements and masks; Sun raster of every depth,
    type and colour map; 32-bit gray TIFF of both sample formats, orders,
    compressions and layouts."""
    r = np.random.default_rng(2200)
    out = {**_dds_layouts(r), **_blp_layouts(r), **_ftex_icns_sun_layouts(r)}
    return {f"{DBFIS}/{k}": v for k, v in sorted(out.items())}


def dbfis_refusals() -> Dict[str, Tuple[bytes, str]]:
    """Files of these formats that Pillow refuses (name -> (bytes, the
    reason the port names)), and a JPEG 2000 ICNS element."""
    r = np.random.default_rng(2230)
    bc1 = bcn_blocks(r, "BC1", 6).tobytes()
    img = source_image(2231, 8, 8)
    icon = smooth_scene(2232, 16, 16, cell=4, step=8)
    jp2 = b"\0\0\0\x0cjP  \r\n\x87\n" + bytes(40)
    idx = r.integers(0, 256, 64, dtype=np.uint8).tobytes()
    return {
        "dds-header-size.dds": (dds_file(8, 8, bc1, b"DXT1", header_size=100), "Unsupported header size"),
        "dds-incomplete-header.dds": (dds_file(8, 8, b"", b"DXT1")[:90], "Incomplete header"),
        "dds-fourcc-dxt2.dds": (dds_file(8, 8, bc1, b"DXT2"), "Unimplemented pixel format"),
        "dds-fourcc-bc4s.dds": (dds_file(8, 8, bc1, b"BC4S"), "Unimplemented pixel format"),
        "dds-dxgi-bc1-srgb.dds": (dds_file(8, 8, bc1, dxgi=DXGI["BC1_UNORM_SRGB"]), "Unimplemented DXGI format"),
        "dds-dxgi-bc6h-typeless.dds": (dds_file(8, 8, bc1 * 2, dxgi=DXGI["BC6H_TYPELESS"]), "Unimplemented DXGI"),
        "dds-dxgi-b8g8r8a8.dds": (dds_file(8, 8, bytes(256), dxgi=DXGI["B8G8R8A8_UNORM"]), "Unimplemented DXGI"),
        "dds-luminance-16.dds": (dds_file(8, 8, bytes(128), pfflags=0x20000, bitcount=16), "Unsupported bitcount"),
        "dds-no-format-flags.dds": (dds_file(8, 8, bytes(256), pfflags=0), "Unknown pixel format flags"),
        "dds-bc1-cut-short.dds": (dds_file(8, 8, bc1[:20], b"DXT1"), "truncated"),
        "dds-l8-cut-short.dds": (dds_file(8, 8, bytes(40), pfflags=0x20000, bitcount=8), "truncated"),
        "blp1-compression-2.blp": (blp_file(1, 8, 8, idx, compression=2, encoding=5), "Unsupported BLP compression"),
        "blp1-encoding-3.blp": (blp_file(1, 8, 8, idx, encoding=3), "Unsupported BLP encoding"),
        "blp2-jpeg.blp": (blp_file(2, 8, 8, idx, compression=0), "Unknown BLP compression"),
        "blp2-raw-bgra.blp": (blp_file(2, 8, 8, bytes(256), encoding=3), "Unknown BLP encoding"),
        "blp2-alpha-encoding-2.blp": (blp_file(2, 8, 8, bc1 * 2, encoding=2, alpha_encoding=2),
                                      "Unsupported alpha encoding"),
        "blp2-palette-too-few.blp": (blp_file(2, 8, 8, idx[:50]), "not enough image data"),
        "blp2-palette-past-the-end.blp": (blp_file(2, 8, 8, idx, length=200), "Truncated File Read"),
        "blp2-dxt1-cut-short.blp": (blp_file(2, 8, 8, bc1[:24], encoding=2), "Truncated File Read"),
        "blp1-palette-cut-short.blp": (blp_file(1, 8, 8, b"", encoding=5)[:600], "Truncated File Read"),
        "blp1-jpeg-too-small.blp": (blp_file(1, 8, 9, jpeg_split(port_jpeg(img, 80))[1], compression=0,
                                             jpeg_header=jpeg_split(port_jpeg(img, 80))[0]), "not enough image data"),
        "ftex-two-formats.ftc": (ftex_file(8, 8, 0, bc1[:32], formats=2), "Pillow asserts one"),
        "ftex-format-2.ftc": (ftex_file(8, 8, 2, bc1[:32]), "Invalid texture compression format"),
        "ftex-bc1-cut-short.ftc": (ftex_file(8, 8, 0, bc1[:24]), "truncated"),
        "icns-jpeg2000.icns": (icns_file([(b"ic08", jp2)]), "Pillow's JPEG 2000 plugin does not open"),
        "icns-other-stream.icns": (icns_file([(b"ic09", b"GIF89a" + bytes(30))]), "Unsupported icon subimage"),
        "icns-rle-overrun.icns": (icns_file([(b"is32", b"\xff\x01" * 4)]), "run past the end of its channel"),
        "icns-rle-cut-short.icns": (icns_file([(b"is32", icns_rgb(icon)[:300])]), "truncated"),
        "icns-mask-cut-short.icns": (icns_file([(b"is32", icns_rgb(icon)), (b"s8mk", bytes(100))]), "mask"),
        "icns-it32-signature.icns": (icns_file([(b"it32", b"\0\0\0\1" + bytes(60))]), "Unknown signature"),
        "icns-mask-alone.icns": (icns_file([(b"s8mk", bytes(256))]), "mask alone"),
        "icns-png-of-another-size.icns": (icns_file([(b"ic07", png_bytes(icon[:12, :12], 8, 2))]),
                                          "not one of the allowed sizes"),
        "sun-map-on-24-bit.ras": (sun_file(4, 2, 24, 1, bytes(24), bytes(30)), "unrecognized image mode"),
        "sun-map-on-1-bit.ras": (sun_file(16, 2, 1, 1, bytes(4), bytes(30)), "unrecognized image mode"),
        "sun-raw-cut-short.ras": (sun_file(13, 9, 8, 1, bytes(100)), "truncated"),
        "sun-rle-cut-short.ras": (sun_file(13, 9, 8, 2, b"\x80\x20\x05" + bytes(20)), "truncated"),
        "tiff-int32-mm-unsigned.tif": (tiff_bytes(np.arange(64).reshape(8, 8), 32, 1, ">", tags={339: (3, [1])}),
                                       "depth or sample layout"),
    }


def dbfis_card_originals() -> Dict[str, bytes]:
    """The card's written originals of ``DBFIS_CARD``, from seeded numpy
    alone (the BLP1 JPEG's stream by the port's encoder): name (under
    ``dds_blp_ftex_icns_sun/card/``) -> bytes."""
    side = 1024
    photo = smooth_scene(2240, side, side, cell=128, step=4)
    r = np.random.default_rng(2241)
    noisy = np.clip(photo.astype(np.int64) + r.integers(-5, 6, photo.shape), 0, 255).astype(np.uint8)
    rgba = np.concatenate([noisy, np.full((side, side, 1), 255, np.uint8)], 2)
    bc1 = bc1_encode(noisy).tobytes()
    alpha = np.tile(np.array([[255, 255, 0, 0, 0, 0, 0, 0]], np.uint8), (side * side // 16, 1))
    header, mip = jpeg_split(port_jpeg(noisy, 85))
    icon = smooth_scene(2242, side, side, cell=64, step=8)
    small = smooth_scene(2243, 16, 16, cell=4, step=8)
    gray = (smooth_scene(2244, side, side, cell=128, step=1)[..., 0].astype(np.int64) * 3 - 200) * 37 // 36
    levels = smooth_scene(2245, side, side, cell=128, step=64) // 64  # 4 levels a channel: 64 colours, long runs
    poster = (levels[..., 0] * 16 + levels[..., 1] * 4 + levels[..., 2]).astype(np.uint8)
    sun_map = np.stack([np.arange(64) // 16, np.arange(64) // 4 % 4, np.arange(64) % 4]).astype(np.uint8) * 85
    sun_map = sun_map.tobytes()  # planar: every red, then every green, then every blue
    out = {
        "photo-1024-bc7.dds": dds_file(side, side, bc7_encode(rgba).tobytes(), dxgi=DXGI["BC7_UNORM"]),
        "photo-1024-bc1.dds": dds_file(side, side, bc1, b"DXT1"),
        "photo-1024-dxt5.blp": blp_file(2, side, side, np.concatenate([alpha, bc1_encode(noisy)], 1).tobytes(),
                                        encoding=2, alpha=8, alpha_encoding=7),
        "photo-1024-jpeg.blp": blp_file(1, side, side, mip, compression=0, jpeg_header=header),
        "photo-1024-bc1.ftex": ftex_file(side, side, 0, bc1),
        "icon-1024-png.icns": icns_file([(b"is32", icns_rgb(small)), (b"s8mk", bytes(256)),
                                         (b"ic10", png_bytes(icon, 8, 2, kinds=(1, 4)))]),
        "poster-1024-rle.ras": sun_file(side, side, 8, 2, sun_rle(sun_rows(poster, 8, pad=False)), sun_map),
        "gray-1024-int32.tif": tiff_bytes(gray % 2 ** 32, 32, 1, compression=5, predictor=2, rows_per_strip=64,
                                          tags={339: (3, [2])}),
    }
    assert sorted(out) == sorted(DBFIS_CARD)
    return {f"{DBFIS}/card/{k}": v for k, v in out.items()}


def dbfis_fixtures() -> Dict[str, bytes]:
    """Every committed file under ``dds_blp_ftex_icns_sun/`` (name ->
    bytes), written anew: the layouts and the refusals (the card's
    originals are written on the card, ``dbfis_card_originals``)."""
    refused = {f"{DBFIS}/refused/{k}": v for k, (v, _) in dbfis_refusals().items()}
    return dict(sorted({**dbfis_layouts(), **refused}.items()))


def committed_dbfis() -> Dict[str, bytes]:
    """The committed files under ``dds_blp_ftex_icns_sun/``: name -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, DBFIS)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def dbfis_manifest(scratch: str, files: Optional[Dict[str, bytes]] = None) -> dict:
    """The manifest's parts of this folder: each committed file
    (``files``, the committed ones by default) as ``gif_tiff_entry``
    records it with ``dbfis_refusals``; each card original written on
    the card (``dbfis_card``)."""
    files = committed_dbfis() if files is None else files
    reasons = dbfis_refusals()
    entries = {}
    for name, data in files.items():
        path = os.path.join(scratch, "dbfis" + os.path.splitext(name)[1])
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = gif_tiff_entry(name, path, reasons)
    written = dbfis_card_originals()
    card = {}
    for name, data in written.items():
        path = os.path.join(scratch, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        card[name] = gif_tiff_entry(name, path, reasons)
    return {"files": entries, "dbfis_card": card}


def check_dbfis_card(folder: str, decode: Callable[[str], np.ndarray]) -> Dict[str, str]:
    """Writes ``dbfis_card_originals`` into ``folder`` and holds each to
    the manifest (``dbfis_card``): bytes and ``decode``'s RGB.  Returns
    name -> path of each; raises ``AssertionError`` naming the first that
    differs."""
    want = load_manifest()["dbfis_card"]
    paths = {}
    for name, data in sorted(dbfis_card_originals().items()):
        if sha256(data) != want[name]["sha256"]:
            raise AssertionError(f"{name}: the writer made other bytes than the manifest records")
        path = os.path.join(folder, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        got = decode(path)
        if list(got.shape[:2]) != want[name]["shape"] or sha256(got) != want[name]["sha256_rgb"]:
            raise AssertionError(f"{name}: decoded to other pixels than Pillow's")
        paths[os.path.basename(name)] = path
    if sorted(paths) != sorted(DBFIS_CARD):
        raise AssertionError(f"card originals {sorted(paths)}, expected {sorted(DBFIS_CARD)}")
    return paths


# --- XBM, XPM, MSP, FLI, DCX, GBR, PIXAR, FITS, McIdas, XV thumbnail; 12-bit gray and CCITT palette TIFF ----

LEGACY = "legacy_rasters"  # their files' folder under FIXTURES
#: the card's 1024 px originals of this folder, written on the card by
#: ``legacy_card_originals`` (never committed): name -> the listed name
#: ``cli.prep`` reads it under, or None for one only timed
LEGACY_CARD = {"gray-1024-12bit.tif": "gray-1024-12bit.bmp", "scan-1024-g4-palette.tif": "scan-1024-g4-palette.png",
               "poster-1024.xpm": "poster-1024-xpm.png", "scan-1024-rle.msp": "scan-1024-msp.bmp",
               "anim-1024-brun.flc": "anim-1024-flc.jpg", "scan-1024.dcx": "scan-1024-dcx.png",
               "brush-1024.gbr": "brush-1024-gbr.png", "sky-1024-float.fits": "sky-1024-fits.jpg",
               "photo-1024.pxr": "photo-1024-pixar.webp", "scan-1024.xbm": None, "area-1024.mcidas": None,
               "thumb-1024.xv": None}
#: XPM keys: the printable characters but the quote and the backslash
XPM_CHARS = bytes(c for c in range(33, 127) if c not in b'"\\')


def xbm_file(bits: np.ndarray, hotspot=None, prefix: str = "im", unsigned: bool = False, per_line: int = 12,
             upper: bool = False) -> bytes:
    """An X11 bitmap of 0/1 ``bits`` (h, w), 1 white as Pillow reads it:
    rows padded to a byte, bits least significant first, as C hex bytes
    ``per_line`` a line (upper-case where ``upper``), after the width,
    height and optional hot spot defines of ``prefix``."""
    h, w = bits.shape
    packed = np.packbits(np.asarray(bits, np.uint8), axis=1, bitorder="little").reshape(-1)
    head = f"#define {prefix}_width {w}\n#define {prefix}_height {h}\n"
    if hotspot:
        head += f"#define {prefix}_x_hot {hotspot[0]}\n#define {prefix}_y_hot {hotspot[1]}\n"
    head += f"static {'unsigned ' if unsigned else ''}char {prefix}_bits[] = {{\n"
    hexes = [("0x%02X" if upper else "0x%02x") % v for v in packed]
    return (head + ",\n".join(", ".join(hexes[i:i + per_line]) for i in range(0, len(hexes), per_line))
            + "};\n").encode()


def xpm_keys(n: int, bpp: int) -> List[bytes]:
    """``n`` distinct XPM keys of ``bpp`` characters."""
    k = len(XPM_CHARS)
    return [bytes(XPM_CHARS[i // k ** j % k] for j in range(bpp - 1, -1, -1)) for i in range(n)]


def xpm_file(index: np.ndarray, colors: List[bytes], bpp: int, keys: Optional[List[bytes]] = None,
             pixels_comment: bool = True, per_line: Optional[int] = None) -> bytes:
    """An X11 pixmap of ``index`` ((h, w) rows of the colour table), the
    colour table's ``c`` values ``colors`` (``#rrggbb``, ``None``...), keys
    of ``bpp`` characters (``keys``, or ``xpm_keys``), a ``/* pixels */``
    line where ``pixels_comment``, the pixels ``per_line`` a line (a row's
    by default)."""
    h, w = index.shape
    keys = keys or xpm_keys(len(colors), bpp)
    lines = [b"/* XPM */", b"static char *image[] = {", b"/* columns rows colors chars-per-pixel */",
             f'"{w} {h} {len(colors)} {bpp} ",'.encode()]
    lines += [b'"' + key + b" c " + spec + b'",' for key, spec in zip(keys, colors)]
    if pixels_comment:
        lines.append(b"/* pixels */")
    flat = [keys[i] for i in np.asarray(index).reshape(-1)]
    step = per_line or w
    lines += [b'"' + b"".join(flat[i:i + step]) + b'",' for i in range(0, len(flat), step)]
    lines[-1] = lines[-1][:-1]
    return b"\n".join(lines + [b"};"]) + b"\n"


def msp_header(w: int, h: int, version: int) -> bytes:
    """The 32-byte MSP header Pillow's writer makes (``LinS`` for version
    2), its words XORed to 0 by the checksum word."""
    words = [0] * 16
    words[0], words[1] = struct.unpack("<HH", b"DanM" if version == 1 else b"LinS")
    words[2], words[3], words[4], words[5], words[6], words[7], words[8], words[9] = w, h, 1, 1, 1, 1, w, h
    for word in words[:12]:
        words[12] ^= word
    return struct.pack("<16H", *words)


def msp_rle_row(row: bytes) -> bytes:
    """An MSP version 2 row: runs of 3 to 255 bytes (0, count, byte), the
    rest literal (count, bytes)."""
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j < len(row) and j - i < 255 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes((0, j - i, row[i]))
            i = j
            continue
        k = i
        while k < len(row) and k - i < 255 and not (k + 2 < len(row) and row[k] == row[k + 1] == row[k + 2]):
            k += 1
        out += bytes((k - i,)) + row[i:k]
        i = k
    return bytes(out)


def msp_file(bits: np.ndarray, version: int = 1, rows: Optional[List[bytes]] = None) -> bytes:
    """An MSP of 0/1 ``bits`` (h, w), 1 white: version 1 raw rows, version 2
    a row map and ``msp_rle_row`` rows (or ``rows`` as given)."""
    h, w = bits.shape
    packed = np.packbits(np.asarray(bits, np.uint8), axis=1)
    if version == 1:
        return msp_header(w, h, 1) + packed.tobytes()
    rows = [msp_rle_row(r.tobytes()) for r in packed] if rows is None else rows
    return msp_header(w, h, 2) + struct.pack(f"<{len(rows)}H", *map(len, rows)) + b"".join(rows)


def fli_chunk(kind: int, payload: bytes = b"") -> bytes:
    return struct.pack("<IH", 6 + len(payload), kind) + payload


def fli_frame(chunks: List[bytes], pad: int = 0) -> bytes:
    body = b"".join(chunks) + bytes(pad)
    return struct.pack("<IHH8x", 16 + len(body), 0xF1FA, len(chunks)) + body


def fli_file(w: int, h: int, frames: List[bytes], magic: int = 0xAF12, count: Optional[int] = None) -> bytes:
    """An FLI (magic 0xAF11) or FLC (0xAF12) of ``frames`` (``fli_frame``s,
    or any chunks) after the 128-byte header, ``count`` frames by its
    field."""
    body = b"".join(frames)
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(body), magic, len(frames) if count is None else count, w, h, 8,
                     0, 70)
    return bytes(head) + body


def fli_palette(colors: np.ndarray, kind: int = 4, skip: int = 0) -> bytes:
    """A colour chunk (4: 8-bit values, 11: 6-bit) of one packet: ``skip``
    entries skipped, then ``colors`` ((n, 3), n up to 256)."""
    n = len(colors)
    return fli_chunk(kind, struct.pack("<HBB", 1, skip, n % 256) + np.asarray(colors, np.uint8).tobytes())


def fli_brun(px: np.ndarray) -> bytes:
    """A BRUN chunk of ``px`` (h, w indices): each row a packet count, then
    runs (count, byte) of 2 to 127 and literals (256 - count, bytes) of up
    to 128."""
    out = bytearray()
    for row in np.asarray(px, np.uint8):
        row, i, packets = row.tobytes(), 0, bytearray()
        while i < len(row):
            j = i
            while j < len(row) and j - i < 127 and row[j] == row[i]:
                j += 1
            if j - i >= 2:
                packets += bytes((j - i, row[i]))
                i = j
                continue
            k = i
            while k < len(row) and k - i < 128 and not (k + 1 < len(row) and row[k] == row[k + 1]):
                k += 1
            packets += bytes((256 - (k - i),)) + row[i:k]
            i = k
        out += bytes((0,)) + packets
    return fli_chunk(15, bytes(out))


def fli_lc(px: np.ndarray, first: int = 0) -> bytes:
    """An LC chunk writing rows ``first``... of ``px`` (their indices):
    each row a packet count, then packets (skip 0, count n, n bytes) of up
    to 127, or a run (skip, 256 - n, byte) where the bytes repeat."""
    out = bytearray(struct.pack("<HH", first, len(px)))
    for row in np.asarray(px, np.uint8):
        row, packets, n = row.tobytes(), bytearray(), 0
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and j - i < 127 and row[j] == row[i]:
                j += 1
            if j - i >= 3:
                packets += bytes((0, 256 - (j - i), row[i]))
            else:
                j = min(i + 127, len(row))
                packets += bytes((0, j - i)) + row[i:j]
            n += 1
            i = j
        out += bytes((n,)) + packets
    return fli_chunk(12, bytes(out))


def fli_ss2(px: np.ndarray, skip_first: int = 0) -> bytes:
    """An SS2 chunk writing the rows of ``px`` (an even width) after
    ``skip_first`` rows skipped: each row its packets of words (skip 0,
    count n, n words), a run of words (skip, 256 - n, word) where they
    repeat."""
    px = np.asarray(px, np.uint8)
    out = bytearray(struct.pack("<H", len(px)))
    for y, row in enumerate(px):
        if y == 0 and skip_first:
            out += struct.pack("<H", 65536 - skip_first)
        words = [row[i:i + 2].tobytes() for i in range(0, len(row), 2)]
        packets, n, i = bytearray(), 0, 0
        while i < len(words):
            j = i
            while j < len(words) and j - i < 127 and words[j] == words[i]:
                j += 1
            if j - i >= 2:
                packets += bytes((0, 256 - (j - i))) + words[i]
            else:
                j = min(i + 127, len(words))
                packets += bytes((0, j - i)) + b"".join(words[i:j])
            n += 1
            i = j
        out += struct.pack("<H", n) + packets
    return fli_chunk(7, bytes(out))


def dcx_file(pages: List[bytes]) -> bytes:
    """A DCX of PCX ``pages``: the magic, the offset table ended by 0, the
    pages."""
    at = 4 + 4 * (len(pages) + 1)
    offsets = []
    for page in pages:
        offsets.append(at)
        at += len(page)
    return struct.pack(f"<I{len(pages)}I", 987654321, *offsets) + bytes(4) + b"".join(pages)


def gbr_file(px: np.ndarray, version: int = 2, comment: bytes = b"brush\0", spacing: int = 25,
             header: Optional[int] = None) -> bytes:
    """A GIMP brush of ``px`` ((h, w) gray, depth 1, or (h, w, 4) RGBA,
    depth 4), version 1 or 2, its comment after the header (``header`` its
    size field, by default the header's bytes and the comment's)."""
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else 4
    size = (20 if version == 1 else 28) + len(comment) if header is None else header
    out = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        out += b"GIMP" + struct.pack(">I", spacing)
    return out + comment + np.asarray(px, np.uint8).tobytes()


def pixar_file(rgb: np.ndarray, mode=(14, 2)) -> bytes:
    """A PIXAR raster of ``rgb`` (h, w, 3): the 1024-byte header (its
    magic, height at 416, width at 418, the mode pair at 424), raw RGB."""
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, *mode)
    return bytes(head) + np.asarray(rgb, np.uint8).tobytes()


def fits_card(key: str, value: str = "", comment: str = "") -> bytes:
    """An 80-byte FITS header card: ``key = value / comment``, or ``key``
    alone (END)."""
    if not value:
        return key.ljust(80).encode()
    return (key.ljust(8) + "= " + value.rjust(20) + (f" / {comment}" if comment else "")).ljust(80).encode()


def fits_unit(cards: List[bytes], fill: bytes = b" ") -> bytes:
    body = b"".join(cards)
    return body + fill * (-len(body) % 2880)


FITS_DTYPES = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}


def fits_file(values: np.ndarray, bitpix: int, cards: List[bytes] = (), naxis1: bool = False,
              order: str = ">") -> bytes:
    """A FITS image of ``values`` (h, w), the first row shown at the top
    (FITS stores the bottom row first), samples of ``bitpix`` in byte
    ``order`` (FITS's big-endian; "<" writes what Pillow's little-endian
    raw modes read back as ``values``), ``cards`` among the header's;
    ``naxis1``: a 1-D image of the values."""
    h, w = values.shape
    axes = [fits_card("NAXIS", "1"), fits_card("NAXIS1", str(h * w))] if naxis1 else [
        fits_card("NAXIS", "2"), fits_card("NAXIS1", str(w)), fits_card("NAXIS2", str(h))]
    head = fits_unit([fits_card("SIMPLE", "T", "conforms to FITS"), fits_card("BITPIX", str(bitpix)), *axes, *cards,
                      fits_card("END")])
    return head + fits_unit([np.asarray(values)[::-1].astype(order + FITS_DTYPES[bitpix][1:]).tobytes()], b"\0")


def fits_gzip_file(values: np.ndarray, zbitpix: int = 32, cmptype: str = "'GZIP_1  '") -> bytes:
    """A FITS of a primary header without data and a binary table of a
    tile-compressed image (``ZIMAGE``, ``GZIP_1``): a row of descriptors a
    tile, then the heap of one gzip member a row of 4-byte big-endian
    samples (what Pillow's ``FitsGzipDecoder`` reads 4 bytes a pixel)."""
    h, w = values.shape
    members = [gzip.compress(np.asarray(row).astype(">i4").tobytes(), mtime=0) for row in np.asarray(values)[::-1]]
    table = b"".join(struct.pack(">ii", len(m), sum(map(len, members[:i]))) for i, m in enumerate(members))
    heap = b"".join(members)
    primary = fits_unit([fits_card("SIMPLE", "T"), fits_card("BITPIX", "8"), fits_card("NAXIS", "0"),
                         fits_card("EXTEND", "T"), fits_card("END")])
    ext = fits_unit([fits_card("XTENSION", "'BINTABLE'"), fits_card("BITPIX", "8"), fits_card("NAXIS", "2"),
                     fits_card("NAXIS1", "8"), fits_card("NAXIS2", str(h)), fits_card("PCOUNT", str(len(heap))),
                     fits_card("GCOUNT", "1"), fits_card("TFIELDS", "1"), fits_card("TTYPE1", "'COMPRESSED_DATA'"),
                     fits_card("TFORM1", "'1PB'"), fits_card("ZIMAGE", "T"), fits_card("ZBITPIX", str(zbitpix)),
                     fits_card("ZNAXIS", "2"), fits_card("ZNAXIS1", str(w)), fits_card("ZNAXIS2", str(h)),
                     fits_card("ZCMPTYPE", cmptype), fits_card("END")])
    return primary + ext + fits_unit([table + heap], b"\0")


def mcidas_file(samples: np.ndarray, size: int = 1, bands: int = 1, prefix: int = 0, at: int = 256,
                tail: int = 0) -> bytes:
    """A McIdas area file of ``samples`` ((h, w) big-endian values of
    ``size`` bytes, the first of ``bands``): the 256-byte directory (words
    9, 10, 11, 14, 15 and 34: rows, columns, bytes a sample, bands, a
    row's prefix bytes, the data's offset), each row its prefix (none
    where it is negative) and its bands from ``at``, ``tail`` bytes
    after."""
    h, w = samples.shape
    words = [0] * 64
    words[1], words[8], words[9], words[10], words[13], words[14], words[33] = 4, h, w, size, bands, prefix, at
    head = struct.pack(">64i", *words)
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[size]
    band = np.ascontiguousarray(np.asarray(samples).astype(dt)).view(np.uint8).reshape(h, w * size)
    rows = np.concatenate([np.full((h, max(prefix, 0)), 7, np.uint8), np.tile(band, (1, bands))], 1)
    return head + bytes(at - 256) + rows.tobytes() + bytes(tail)


def xv_file(index: np.ndarray, comments=(b"#XVVERSION:Version 2.28", b"#IMGINFO:1024x1024 Color JPEG",
                                          b"#END_OF_COMMENTS"), size_line: Optional[bytes] = None) -> bytes:
    """An XV thumbnail of ``index`` ((h, w) 3-3-2 colour bytes): the magic
    line, ``comments``, the size line, the bytes."""
    h, w = index.shape
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments) + (size_line or f"{w} {h} 255\n".encode())
            + np.asarray(index, np.uint8).tobytes())


def old_style_lzw(data: bytes) -> bytes:
    """``data`` as old-style (pre-5.0, LSB-first) TIFF LZW: a Clear code,
    each byte a literal 9-bit code, the end code (short enough that the
    code width never grows)."""
    codes = [256, *data, 257]
    assert len(codes) < 250
    value = sum(c << (9 * k) for k, c in enumerate(codes))
    return value.to_bytes((9 * len(codes) + 7) // 8, "little")


def sgilog_rows(planes: np.ndarray) -> bytes:
    """SGILog RLE rows of ``planes`` ((h, bytes a pixel, w)): each plane of a
    row as literal runs of up to 127 bytes."""
    out = bytearray()
    for row in planes:
        for plane in row:
            p = plane.tobytes()
            for i in range(0, len(p), 127):
                out += bytes((len(p[i:i + 127]),)) + p[i:i + 127]
    return bytes(out)


def _legacy_tiff_layouts(r) -> Dict[str, bytes]:
    out = {}
    values = r.integers(0, 4096, (11, 13))
    values[0, :6] = [0, 1, 255, 256, 4095, 300]
    values[1:4] = r.integers(0, 300, (3, 13))
    for comp, cname in ((1, "raw"), (5, "lzw"), (8, "deflate"), (32773, "packbits")):
        out[f"tiff/gray12-{cname}-13x11.tif"] = tiff_bytes(values, 12, 1, compression=comp)
        out[f"tiff/gray12-{cname}-strips-13x11.tif"] = tiff_bytes(values, 12, 1, compression=comp, rows_per_strip=4)
        out[f"tiff/gray12-{cname}-tiles-13x11.tif"] = tiff_bytes(values, 12, 1, compression=comp, tile=(16, 16))
    out["tiff/gray12-raw-predictor-2-13x11.tif"] = tiff_bytes(values, 12, 1, predictor=2)  # no predictor: raw
    out["tiff/gray12-packbits-predictor-2-13x11.tif"] = tiff_bytes(values, 12, 1, compression=32773, predictor=2)
    out["tiff/gray12-lzw-orientation-6-13x11.tif"] = tiff_bytes(values, 12, 1, compression=5, orientation=6)
    out["tiff/gray12-raw-20x3.tif"] = tiff_bytes(values[:3, :10].repeat(2, 1), 12, 1)
    scan = _scan(2301, 23, 37)
    cm = np.array([[0x1000, 0x2000, 0x7000], [0xF0F0, 0xEE00, 0xD8FF]])
    for comp, cname, opts in ((2, "mh", {}), (3, "t4-1d", {}), (3, "t4-2d", {"t4options": 1}),
                              (3, "t4-2d-fill", {"t4options": 5}), (4, "g4", {}), (32771, "rlew", {})):
        out[f"tiff/ccitt-palette-{cname}-37x23.tif"] = ccitt_tiff(scan, comp, 3, colormap=cm, **opts)
        out[f"tiff/ccitt-palette-{cname}-fill-order-2-37x23.tif"] = ccitt_tiff(scan, comp, 3, colormap=cm,
                                                                               fill_order=2, **opts)
    out["tiff/ccitt-palette-g4-strips-37x23.tif"] = ccitt_tiff(scan, 4, 3, colormap=cm, rows_per_strip=5)
    out["tiff/ccitt-palette-g4-tiles-37x23.tif"] = ccitt_tiff(scan, 4, 3, colormap=cm, tile=(16, 16))
    out["tiff/ccitt-palette-g4-mm-37x23.tif"] = ccitt_tiff(scan, 4, 3, colormap=cm[::-1], order=">")
    y, cb, cr = r.integers(16, 236, (8, 12)), r.integers(16, 240, (4, 6)), r.integers(16, 240, (4, 6))
    out["tiff/ycbcr-planes-2x2-raw-12x8.tif"] = tiff_bytes(
        np.zeros((8, 12, 3), np.uint8), 8, 6, planar=2, tags={530: (3, [2, 2])},
        chunks=[p.astype(np.uint8).tobytes() for p in (y, cb, cr)])
    return out


def _legacy_layouts_a(r) -> Dict[str, bytes]:
    """XBM, XPM and MSP layouts."""
    out = {}
    for w, h in ((1, 1), (8, 3), (13, 7), (17, 5)):
        bits = r.integers(0, 2, (h, w))
        out[f"xbm/plain-{w}x{h}.xbm"] = xbm_file(bits)
        out[f"msp/v1-{w}x{h}.msp"] = msp_file(bits, 1)
        out[f"msp/v2-{w}x{h}.msp"] = msp_file(bits, 2)
    bits = r.integers(0, 2, (9, 21))
    out["xbm/hotspot-unsigned-upper-21x9.xbm"] = xbm_file(bits, (3, 4), "cursor", True, 5, True)
    out["xbm/one-line-21x9.xbm"] = xbm_file(bits, per_line=1000)
    packed = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little").reshape(-1)
    odd = b"#define a_width 21\n#define a_height 9\n/* x in a comment */ static char a_bits[] = {\n" + b",".join(
        b"0x%x" % v if k % 3 else b"0x%X%s" % (v, b"g" if v < 16 else b"") for k, v in enumerate(packed)) + b"};\n"
    out["xbm/short-hex-and-junk-21x9.xbm"] = odd
    out["xbm/leading-space-21x9.xbm"] = b"  \n" + xbm_file(bits)
    idx = r.integers(0, 5, (7, 11))
    colors = [b"#ff0000", b"#00Ff00", b"#0000ff", b"#123", b"#fedcba98"]
    out["xpm/p-5-colors-11x7.xpm"] = xpm_file(idx, colors, 1)
    out["xpm/p-none-unused-11x7.xpm"] = xpm_file(idx, colors + [b"None"], 2)
    out["xpm/p-no-pixels-comment-wrapped-11x7.xpm"] = xpm_file(idx, colors, 3, pixels_comment=False, per_line=5)
    out["xpm/p-repeated-key-11x7.xpm"] = xpm_file(idx, colors + [b"#808080"], 1,
                                                   keys=xpm_keys(5, 1) + xpm_keys(1, 1))
    many = r.integers(0, 300, (9, 14))
    out["xpm/rgb-300-colors-14x9.xpm"] = xpm_file(many, [b"#%06x" % v for v in r.integers(0, 2 ** 24, 300)], 2)
    out["xpm/p-256-colors-14x9.xpm"] = xpm_file(many % 256, [b"#%06x" % v for v in r.integers(0, 2 ** 24, 256)], 2)
    run = np.ones((6, 40), np.uint8)
    run[2, 5:30] = 0
    run[4] = r.integers(0, 2, 40)
    out["msp/v2-runs-40x6.msp"] = msp_file(run, 2)
    packed = np.packbits(run, axis=1)
    rows = [msp_rle_row(p.tobytes()) for p in packed]
    rows[1] = b""  # a blank row: white
    rows[3] = bytes((0, 7, 0x55))  # a row of 7 bytes where it holds 5: the rows after it move on
    rows[5] = msp_rle_row(packed[5].tobytes()) + bytes((9,)) + bytes(3)  # a literal cut at the row's end
    out["msp/v2-odd-rows-40x6.msp"] = msp_file(run, 2, rows)
    return out


def _legacy_layouts_b(r) -> Dict[str, bytes]:
    """FLI, DCX, GBR, PIXAR, FITS, McIdas and XV thumbnail layouts."""
    out = {}
    w, h = 13, 9
    px = (r.integers(0, 6, (h, w)) * 40).astype(np.uint8)
    pal = r.integers(0, 256, (256, 3), dtype=np.uint8)
    pal64 = r.integers(0, 64, (256, 3), dtype=np.uint8)
    out["fli/flc-palette-brun-13x9.flc"] = fli_file(w, h, [fli_frame([fli_palette(pal), fli_brun(px)])])
    out["fli/fli-palette64-brun-13x9.fli"] = fli_file(w, h, [fli_frame([fli_palette(pal64, 11), fli_brun(px)])],
                                                      0xAF11)
    out["fli/fli-palette64-high-bits-13x9.fli"] = fli_file(w, h, [fli_frame([fli_palette(pal, 11), fli_brun(px)])],
                                                           0xAF11)
    out["fli/flc-no-palette-copy-13x9.flc"] = fli_file(w, h, [fli_frame([fli_chunk(16, px.tobytes())])])
    out["fli/flc-partial-palette-lc-13x9.flc"] = fli_file(w, h, [fli_frame(
        [fli_palette(pal[:40], 4, skip=30), fli_lc(px[2:7], 2)])])
    out["fli/flc-black-then-ss2-14x9.flc"] = fli_file(14, h, [fli_frame(
        [fli_palette(pal), fli_chunk(13), fli_ss2(np.pad(px, ((0, 0), (0, 1)))[3:], 3)])])
    out["fli/flc-pstamp-brun-two-frames-13x9.flc"] = fli_file(w, h, [
        fli_frame([fli_chunk(18, bytes(20)), fli_palette(pal), fli_brun(px)]), fli_frame([fli_lc(px[:2][::-1])])])
    out["fli/flc-frame-padded-13x9.flc"] = fli_file(w, h, [fli_frame([fli_palette(pal), fli_brun(px)], pad=1)])
    out["fli/flc-ss2-last-byte-13x9.flc"] = fli_file(w, h, [fli_frame([fli_palette(pal), _ss2_last_byte(px)])])
    rows = np.packbits(r.integers(0, 2, (9, 30)).astype(np.uint8), axis=1)
    page1 = pcx_file(rows, 30, 9, 1, 1)
    page2 = pcx_file(np.packbits(r.integers(0, 2, (5, 12)).astype(np.uint8), axis=1), 12, 5, 1, 1)
    out["dcx/two-1-bit-pages-30x9.dcx"] = dcx_file([page1, page2])
    gray = r.integers(0, 256, (7, 11), dtype=np.uint8)
    tail = b"\x0c" + r.integers(0, 256, 768, dtype=np.uint8).tobytes()
    out["dcx/8-bit-page-palette-at-the-end-11x7.dcx"] = dcx_file(
        [pcx_file(gray, 11, 7, 8, 1, trailing=b"\x0c" + bytes(768)), page2 + tail])
    rgb = r.integers(0, 256, (7, 11, 3), dtype=np.uint8)
    out["dcx/rgb-page-11x7.dcx"] = dcx_file([pcx_file(rgb.transpose(0, 2, 1).reshape(7, 33), 11, 7, 8, 3,
                                                      stride=11)])
    brush = r.integers(0, 256, (9, 13, 4), dtype=np.uint8)
    out["gbr/v2-rgba-13x9.gbr"] = gbr_file(brush)
    out["gbr/v2-gray-13x9.gbr"] = gbr_file(brush[..., 0])
    out["gbr/v1-gray-13x9.gbr"] = gbr_file(brush[..., 0], 1, b"old\0")
    out["gbr/v1-rgba-no-comment-13x9.gbr"] = gbr_file(brush, 1, b"")
    out["gbr/v2-comment-longer-than-its-field-13x9.gbr"] = gbr_file(brush[..., 1], 2, b"ab\0", header=29) + bytes(2)
    out["pixar/rgb-13x9.pxr"] = pixar_file(brush[..., :3])
    out["pixar/rgb-trailing-13x9.pxr"] = pixar_file(brush[..., :3]) + bytes(100)
    sky = r.normal(120, 150, (9, 13))
    sky[0, :6] = [np.nan, np.inf, -np.inf, 254.99, 255, -0.5]
    for bitpix in (8, 16, 32, -32, -64):
        v = np.clip(np.nan_to_num(np.abs(sky), posinf=0), 0, 250) if bitpix == 8 else sky if bitpix < 0 else np.clip(
            np.nan_to_num(sky, posinf=0, neginf=0), -30000, 30000)
        out[f"fits/bitpix{bitpix}-13x9.fits"] = fits_file(v, bitpix, [fits_card("BZERO", "0", "offset")])
    flat = np.clip(np.nan_to_num(sky, posinf=0, neginf=0), -30000, 30000)
    out["fits/naxis1-13x9.fits"] = fits_file(np.abs(flat[:3]) % 256, 8, naxis1=True)
    out["fits/comments-and-equals-13x9.fits"] = fits_file(flat, 16, [
        b"COMMENT   a comment card".ljust(80), fits_card("OBJECT", "'M 31/andromeda'"),
        b"HISTORY x = y".ljust(80), b"".ljust(80)])
    out["fits/gzip-zbitpix32-13x9.fits"] = fits_gzip_file(flat.astype(np.int64) * 3, 32)
    out["fits/gzip-zbitpix16-13x9.fits"] = fits_gzip_file(flat.astype(np.int64), 16)
    out["fits/gzip-zbitpix8-13x9.fits"] = fits_gzip_file(np.abs(flat).astype(np.int64), 8)
    out["fits/gzip-cmptype-rice-read-as-table-13x9.fits"] = fits_gzip_file(np.zeros((9, 13), np.int64), 32,
                                                                          "'RICE_1  '")
    area = r.integers(0, 400, (9, 13))
    for size in (1, 2, 4):
        v = area % 256 if size == 1 else area - 60 if size == 4 else area
        out[f"mcidas/size{size}-13x9.mcidas"] = mcidas_file(v % 2 ** (8 * size) if size < 4 else v, size)
        out[f"mcidas/size{size}-prefix-bands-13x9.mcidas"] = mcidas_file(v % 2 ** (8 * size) if size < 4 else v,
                                                                         size, bands=2, prefix=4, at=300)
        out[f"mcidas/size{size}-prefix-mapped-13x9.mcidas"] = mcidas_file(v % 2 ** (8 * size) if size < 4 else v,
                                                                          size, prefix=3, tail=3)
    idx = r.integers(0, 256, (9, 13), dtype=np.uint8)
    out["xv/thumb-13x9.xv"] = xv_file(idx)
    out["xv/no-comments-13x9.xv"] = xv_file(idx, ())
    out["xv/size-line-extra-13x9.xv"] = xv_file(idx, (b"#a",), b"  13   9 255 extra\n")
    return out


def _ss2_last_byte(px: np.ndarray) -> bytes:
    """An SS2 chunk of ``px``'s first two rows (an odd width) whose first row
    stores its last byte in a flag word before its packets."""
    even = np.asarray(px, np.uint8)[:2, :-1]
    chunk = bytearray(fli_ss2(even))
    at = 6 + 2  # the chunk header, the line count: the first row's packet count
    chunk[at:at] = struct.pack("<H", 0x8000 | int(px[0, -1]))
    struct.pack_into("<I", chunk, 0, len(chunk))
    return bytes(chunk)


def legacy_layouts() -> Dict[str, bytes]:
    """A file of each layout of this slice the port reads (name -> bytes;
    Pillow reads each): 12-bit gray TIFF of every compression, strips and
    tiles; CCITT of a 1-bit palette of every compression and fill order;
    YCbCr in subsampled raw planes; XBM (hot spot, upper-case, short hex
    and junk), XPM (P and RGB, None, repeated keys, rows wrapped), MSP
    version 1 and 2 (blank, long and cut rows), FLI and FLC (both palette
    chunks, BLACK, BRUN, COPY, LC, SS2, PSTAMP, padding), DCX (1-bit, 8-bit
    with the file's last palette, RGB), GBR (versions, depths, comments),
    PIXAR, FITS (every BITPIX, 1-D, comments, GZIP_1 tiles), McIdas (every
    sample size, prefixes, bands, mapped and not) and XV thumbnail; and an
    8-bit gray TIFF of old-style LZW codes."""
    r = np.random.default_rng(2300)
    out = {**_legacy_tiff_layouts(r), **_legacy_layouts_a(r), **_legacy_layouts_b(r)}
    gray = np.random.default_rng(2303).integers(0, 256, (9, 7)).astype(np.uint8)
    out["tiff/old-style-lzw-gray-7x9.tif"] = tiff_bytes(gray, 8, 1, compression=5, chunks=[old_style_lzw(gray.tobytes())])
    return {f"{LEGACY}/{k}": v for k, v in sorted(out.items())}



def legacy_refusals() -> Dict[str, Tuple[bytes, str]]:
    """Files of this slice the port refuses (name -> (bytes, the reason the
    port names, a regular expression)), each one Pillow refuses too (the
    old-style and 12-bit JPEG TIFFs once here are read since:
    ``legacy_old_jpeg``, ``legacy_jpeg12``)."""
    r = np.random.default_rng(2330)
    values = r.integers(0, 4096, (9, 7))
    y, cb, cr = r.integers(16, 236, (8, 12)), r.integers(16, 240, (4, 6)), r.integers(16, 240, (4, 6))
    lum = r.integers(0, 65536, (8, 12)).astype("<u2")
    luv = r.integers(0, 2 ** 32, (8, 12)).astype("<u4")
    gray = r.integers(0, 256, (9, 7)).astype(np.uint8)
    bits = r.integers(0, 2, (5, 11))
    idx = r.integers(0, 3, (4, 6))
    px = (r.integers(0, 6, (6, 8)) * 40).astype(np.uint8)
    pal = r.integers(0, 256, (256, 3), dtype=np.uint8)
    brun = fli_brun(px)
    sky = r.normal(100, 60, (5, 7))
    head = b"#define b_width 11\n#define b_height 5\n"
    return {
        "tiff-gray12-mm.tif": (tiff_bytes(values, 12, 1, ">"), r"big-endian \(MM\) 12-bit"),
        "tiff-gray12-lzw-predictor-2.tif": (tiff_bytes(values, 12, 1, compression=5, predictor=2), "predictor"),
        "tiff-gray12-white.tif": (tiff_bytes(values, 12, 0), "depth or sample layout"),
        "tiff-gray12-fill-order-2.tif": (tiff_bytes(values, 12, 1, tags={266: (3, [2])}), "depth or sample layout"),
        "tiff-ccitt-palette-4-entries.tif": (ccitt_tiff(_scan(2332, 9, 20), 4, 3, colormap=r.integers(0, 65536, (4, 3))),
                                             "first directory"),
        "tiff-ycbcr-planes-2x2-lzw.tif": (tiff_bytes(np.zeros((8, 12, 3), np.uint8), 8, 6, compression=5, planar=2, tags={
            530: (3, [2, 2])}, chunks=[tiff_lzw(p.astype(np.uint8).tobytes()) for p in (y, cb, cr)]),
                                          "YCbCr pixels in this layout"),
        "tiff-logl.tif": (tiff_bytes(lum, 16, 32844, compression=34676, tags={339: (3, [2])}, chunks=[sgilog_rows(
            lum.view(np.uint8).reshape(8, 12, 2)[..., ::-1].transpose(0, 2, 1))]), "LogLuv"),
        "tiff-logluv-32.tif": (tiff_bytes(np.zeros((8, 12, 3), np.uint8), 16, 32845, compression=34676, chunks=[
            sgilog_rows(luv.view(np.uint8).reshape(8, 12, 4)[..., ::-1].transpose(0, 2, 1))]), "LogLuv"),
        "tiff-logluv-24.tif": (tiff_bytes(np.zeros((8, 12, 3), np.uint8), 16, 32845, compression=34677, chunks=[
            r.integers(0, 256, 288, dtype=np.uint8).tobytes()]), "LogLuv"),
        "xbm-no-bits-in-512-bytes.xbm": (head + b" " * 500 + b"static char b_bits[] = {0x00};\n", "does not match"),
        "xbm-cut-short.xbm": (xbm_file(bits)[:-20], "truncated"),
        "xpm-colour-name.xpm": (xpm_file(idx, [b"#ff0000", b"red", b"#0000ff"], 1), "refuses"),
        "xpm-key-not-in-table.xpm": (_last_row_key(xpm_file(idx, [b"#ff0000", b"#00ff00", b"#0000ff"], 1)),
                                     "not in its colour table"),
        "xpm-none-used.xpm": (xpm_file(idx, [b"#ff0000", b"None", b"#0000ff"], 1), "not in its colour table"),
        "xpm-too-few-pixels.xpm": (xpm_file(idx, [b"#ff0000", b"#00ff00", b"#0000ff"], 1)[:-10] + b"\n",
                                   "not enough image data"),
        "xpm-rgb-key-not-in-table.xpm": (xpm_file(r.integers(0, 300, (3, 4)), [b"#%06x" % i for i in range(300)], 2,
                                                  )[:-12] + b'~~"\n};\n', "not in its colour table"),
        "msp-v1-cut-short.msp": (msp_file(bits, 1)[:-3], "truncated"),
        "msp-v2-row-map-cut-short.msp": (msp_file(bits, 2)[:36], "row map"),
        "msp-v2-row-cut-short.msp": (msp_file(bits, 2)[:-2], "row cut short"),
        "msp-v2-run-cut-short.msp": (msp_file(bits, 2, [b"\x02\xff\xff"] * 4 + [b"\x00\x05"]), "run cut short"),
        "msp-v2-too-few-bytes.msp": (msp_file(bits, 2, [b"\x01\xff"] * 5), "not enough image data"),
        "fli-prefix-chunk.flc": (fli_file(8, 6, [fli_chunk(0xF100, bytes(10)), fli_frame([fli_palette(pal), brun])]),
                                 "unknown error"),
        "fli-unknown-chunk.flc": (fli_file(8, 6, [fli_frame([fli_palette(pal), fli_chunk(99, bytes(4))])]),
                                  "unknown error"),
        "fli-brun-past-its-row.flc": (fli_file(8, 6, [fli_frame([fli_chunk(15, bytes((0, 9, 1)) * 6)])]),
                                      "buffer overrun"),
        "fli-lc-past-the-rows.flc": (fli_file(8, 6, [fli_frame([fli_chunk(12, struct.pack("<HH", 4, 4)
                                                                          + bytes(8))])]), "buffer overrun"),
        "fli-ss2-skip-past-the-rows.flc": (fli_file(8, 6, [fli_frame([fli_chunk(7, struct.pack("<HH", 1, 65536 - 9))])]),
                                           "buffer overrun"),
        "fli-chunk-of-no-size.flc": (fli_file(8, 6, [fli_frame([struct.pack("<IH", 0, 18) + bytes(4), fli_chunk(13)])]),
                                     "no size"),
        "fli-frame-cut-short.flc": (fli_file(8, 6, [fli_frame([fli_palette(pal), brun])])[:-8], "truncated"),
        "fli-copy-cut-short.flc": (fli_file(8, 6, [fli_frame([fli_chunk(16, bytes(30))])]), "truncated"),
        "dcx-page-not-a-pcx.dcx": (dcx_file([b"GIF89a" + bytes(200)]), "not a PCX's"),
        "gbr-pixels-cut-short.gbr": (gbr_file(r.integers(0, 256, (5, 6, 4), dtype=np.uint8))[:-7],
                                     "not enough image data"),
        "pixar-cut-short.pxr": (pixar_file(r.integers(0, 256, (5, 6, 3), dtype=np.uint8))[:-5], "truncated"),
        "pixar-mode-14-1.pxr": (pixar_file(r.integers(0, 256, (5, 6, 3), dtype=np.uint8), (14, 1)), "sets no mode"),
        "fits-bitpix-64.fits": (fits_file(sky, -32)[:2880].replace(b"BITPIX  =                  -32",
                                                                   b"BITPIX  =                   64") + bytes(2880),
                                "does not identify"),
        "fits-no-end.fits": (fits_card("SIMPLE", "T") + fits_card("BITPIX", "8") + fits_card("NAXIS", "0"),
                             "Truncated FITS file"),
        "fits-no-image-data.fits": (fits_unit([fits_card("SIMPLE", "T"), fits_card("BITPIX", "8"),
                                               fits_card("NAXIS", "0"), fits_card("END")]) + bytes(2880),
                                    "No image data"),
        "fits-data-cut-short.fits": (fits_file(sky, -32)[:2880 + 100], "truncated"),
        "fits-naxis-not-an-integer.fits": (fits_file(sky, 8).replace(b"NAXIS1  =                    7",
                                                                     b"NAXIS1  =                  7.0"), "refuses"),
        "fits-gzip-zbitpix-minus-32.fits": (fits_gzip_file(np.zeros((5, 7), np.int64), -32), "not enough image data"),
        "fits-gzip-not-gzip.fits": (fits_gzip_file(np.zeros((5, 7), np.int64), 32).replace(b"\x1f\x8b", b"\x1f\x8c"),
                                    "does not decompress"),
        "mcidas-3-bytes-a-sample.mcidas": (mcidas_file(gray, 1)[:40] + struct.pack(">i", 3) + mcidas_file(gray, 1)[44:],
                                           "unsupported McIdas format"),
        "mcidas-stride-short-of-a-row.mcidas": (mcidas_file(gray.astype(np.int64) * 300, 4, prefix=-20, at=300),
                                                "bad configuration"),
        "mcidas-cut-short.mcidas": (mcidas_file(gray, 2)[:-10], "truncated"),
        "mcidas-mapped-cut-short.mcidas": (mcidas_file(gray, 2, prefix=-14)[:-20], "buffer is not large enough"),
        "mcidas-int-cut-short.mcidas": (mcidas_file(gray.astype(np.int64), 4)[:-10], "truncated"),
        "xv-one-number.xv": (xv_file(gray, (), b"7\n"), "refuses"),
        "xv-cut-short.xv": (xv_file(gray)[:-5], "truncated"),
        "mpeg.mpg": (b"\0\0\1\xb3" + bytes((0x0A, 0x00, 0x78, 0x13)) + bytes(60), "cannot load this image"),
    }


def _last_row_key(xpm: bytes) -> bytes:
    """``xpm`` with the first key of its last row of pixels replaced by one
    its colour table lacks."""
    at = xpm.rindex(b'\n"') + 2
    return xpm[:at] + b"~" + xpm[at + 1:]


def legacy_card_originals() -> Dict[str, bytes]:
    """The card's written originals of ``LEGACY_CARD``, 1024 px, from seeded
    numpy alone: name (under ``legacy_rasters/card/``) -> bytes."""
    side = 1024
    photo = smooth_scene(2340, side, side, cell=128, step=4)
    r = np.random.default_rng(2341)
    noisy = np.clip(photo.astype(np.int64) + r.integers(-5, 6, photo.shape), 0, 255).astype(np.uint8)
    dark = smooth_scene(2342, side, side, cell=128, step=1)[..., 0].astype(np.int64) * 9 // 8 + r.integers(0, 16, (
        side, side))  # a 12-bit camera's dark frame: most samples under 256, some over
    scan = _scan(2343, side, side, cell=48)
    levels = smooth_scene(2344, side, side, cell=96, step=1).astype(np.int64) * np.array([6, 8, 6]) // 256
    poster = levels[..., 0] * 48 + levels[..., 1] * 6 + levels[..., 2]  # 288 colours
    colors = [b"#%02x%02x%02x" % (a * 51, b * 36, c * 51) for a in range(6) for b in range(8) for c in range(6)]
    anim = (smooth_scene(2345, side, side, cell=128, step=32)[..., 0] // 32 * 32).astype(np.uint8)
    pal = np.stack([np.arange(256), 255 - np.arange(256), np.arange(256) // 2 + 64], 1).astype(np.uint8)
    sky = smooth_scene(2346, side, side, cell=64, step=1)[..., 0].astype(np.float32) * 1.1 - 10.25
    sky[::97, ::89] = np.nan
    area = smooth_scene(2347, side, side, cell=128, step=1)[..., 1].astype(np.int64) + 40
    thumb = (photo[..., 0] >> 5 << 5 | photo[..., 1] >> 5 << 2 | photo[..., 2] >> 6).astype(np.uint8)
    brush = np.concatenate([noisy, np.full((side, side, 1), 200, np.uint8)], 2)
    page = np.packbits(scan.astype(np.uint8) ^ 1, axis=1)
    out = {
        "gray-1024-12bit.tif": tiff_bytes(dark, 12, 1, compression=5, rows_per_strip=64),
        "scan-1024-g4-palette.tif": ccitt_tiff(scan, 4, 3, colormap=np.array([[0xFFFF, 0xF8F8, 0xE0E0],
                                                                              [0x1010, 0x2020, 0x7070]])),
        "poster-1024.xpm": xpm_file(poster, colors, 2),
        "scan-1024-rle.msp": msp_file(scan ^ 1, 2),
        "anim-1024-brun.flc": fli_file(side, side, [fli_frame([fli_palette(pal), fli_brun(anim)]),
                                                    fli_frame([fli_lc(anim[:8][::-1])])]),
        "scan-1024.dcx": dcx_file([pcx_file(page, side, side, 1, 1), pcx_file(page[:64], side, 64, 1, 1)]),
        "brush-1024.gbr": gbr_file(brush, 2, b"GIMP brush from a photo\0"),
        "sky-1024-float.fits": fits_file(sky, -32, [fits_card("BUNIT", "'ADU'")]),
        "photo-1024.pxr": pixar_file(noisy),
        "scan-1024.xbm": xbm_file(scan ^ 1),
        "area-1024.mcidas": mcidas_file(area, 2, prefix=4, tail=4),
        "thumb-1024.xv": xv_file(thumb),
    }
    assert sorted(out) == sorted(LEGACY_CARD)
    return {f"{LEGACY}/card/{k}": v for k, v in out.items()}


def legacy_fixtures() -> Dict[str, bytes]:
    """Every committed file under ``legacy_rasters/`` (name -> bytes), written
    anew: the layouts and the refusals (the card's originals are written on
    the card, ``legacy_card_originals``)."""
    refused = {f"{LEGACY}/refused/{k}": v for k, (v, _) in legacy_refusals().items()}
    return dict(sorted({**legacy_layouts(), **refused}.items()))


def committed_legacy() -> Dict[str, bytes]:
    """The committed files under ``legacy_rasters/``: name -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, LEGACY)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def legacy_manifest(scratch: str, files: Optional[Dict[str, bytes]] = None) -> dict:
    """The manifest's parts of this folder: each committed file as
    ``gif_tiff_entry`` records it with ``legacy_refusals``; each card
    original written on the card (``legacy_card``)."""
    files = committed_legacy() if files is None else files
    reasons = legacy_refusals()
    entries = {}
    for name, data in files.items():
        path = os.path.join(scratch, "legacy" + os.path.splitext(name)[1])
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = gif_tiff_entry(name, path, reasons)
    written = legacy_card_originals()
    card = {}
    for name, data in written.items():
        path = os.path.join(scratch, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        card[name] = gif_tiff_entry(name, path, reasons)
    return {"files": entries, "legacy_card": card}


def check_legacy_card(folder: str, decode: Callable[[str], np.ndarray]) -> Dict[str, str]:
    """Writes ``legacy_card_originals`` into ``folder`` and holds each to the
    manifest (``legacy_card``): bytes and ``decode``'s RGB.  Returns name
    -> path of each; raises ``AssertionError`` naming the first that
    differs."""
    want = load_manifest()["legacy_card"]
    paths = {}
    for name, data in sorted(legacy_card_originals().items()):
        if sha256(data) != want[name]["sha256"]:
            raise AssertionError(f"{name}: the writer made other bytes than the manifest records")
        path = os.path.join(folder, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        got = decode(path)
        if list(got.shape[:2]) != want[name]["shape"] or sha256(got) != want[name]["sha256_rgb"]:
            raise AssertionError(f"{name}: decoded to other pixels than Pillow's")
        paths[os.path.basename(name)] = path
    if sorted(paths) != sorted(LEGACY_CARD):
        raise AssertionError(f"card originals {sorted(paths)}, expected {sorted(LEGACY_CARD)}")
    return paths


# --- IM, IMT, IPTC, PCD and SPIDER, which Pillow identifies without an _accept; old-style LZW TIFF ----

IMIPS = "im_iptc_pcd_spider"  # their files' folder under FIXTURES
#: the card's originals of this folder, written on the card by
#: ``imips_card_originals`` (never committed): name -> the listed name
#: ``cli.prep`` reads it under
IMIPS_CARD = {"photo-1024-rgbl.im": "photo-1024-im.png", "scan-1024.imt": "scan-1024-imt.jpg",
              "gray-1024-raw.iptc": "gray-1024-iptc.bmp", "photo-768x512.pcd": "photo-768x512-pcd.webp",
              "photo-512x768-rotated.pcd": "photo-512x768-pcd.png", "micrograph-1024-be.spi": "micrograph-1024-spi.jpg",
              "photo-1024-old-lzw.tif": "photo-1024-old-lzw.jpeg"}


def im_file(lines: List[bytes], body: bytes, lut: bytes = b"", pad: bool = True) -> bytes:
    """An IFUNC IM file as Pillow's writer lays one out: the header lines,
    each ended by CR LF, NULs up to byte 511 (``pad``), 0x1a, a LUT's 768
    bytes, then the data."""
    head = b"".join(line + b"\r\n" for line in lines)
    return head + (b"\0" * max(0, 511 - len(head)) if pad else b"") + b"\x1a" + lut + body


def im_planes(img: np.ndarray) -> bytes:
    """An RGB image's rows bottom-up, each its red, green and blue planes
    one after the other (IM's ``RGB;L``)."""
    return np.ascontiguousarray(np.asarray(img, np.uint8)[::-1].transpose(0, 2, 1)).tobytes()


def imt_file(px: np.ndarray, lines: Optional[List[bytes]] = None) -> bytes:
    """An IM Tools file: ``width``, ``height`` and ``pixel n8`` lines (or
    ``lines``), 0x0c, then the L rows top-down."""
    h, w = px.shape
    lines = [b"width %d" % w, b"height %d" % h, b"pixel n8"] if lines is None else lines
    return b"".join(line + b"\n" for line in lines) + b"\x0c" + np.asarray(px, np.uint8).tobytes()


def iptc_field(record: int, dataset: int, data: bytes, extended: int = 0) -> bytes:
    """An IPTC/NAA field: 0x1c, record, dataset, a 15-bit length (or, with
    ``extended`` bytes, 0x80 + that count and the length), the data."""
    if extended:
        return bytes([0x1C, record, dataset, 0x80 | extended]) + len(data).to_bytes(extended, "big") + data
    return bytes([0x1C, record, dataset]) + struct.pack(">H", len(data)) + data


def iptc_file(w: int, h: int, layers: int, component: int, compression: int, body: bytes,
              band: Optional[int] = None, chunk: int = 32000, extra: bytes = b"", end: bytes = b"\0" * 5) -> bytes:
    """An IPTC/NAA image: a character set field, ``extra``, the size (3, 20)
    and (3, 30), layers and component (3, 60), the compression (3, 120)
    and a band (3, 65), then ``body`` in (8, 10) fields of ``chunk`` bytes,
    then ``end``."""
    out = iptc_field(1, 90, b"\x1b%G") + extra + iptc_field(3, 20, struct.pack(">H", w))
    out += iptc_field(3, 30, struct.pack(">H", h)) + iptc_field(3, 60, bytes([layers, component]))
    out += iptc_field(3, 120, bytes([compression]))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    for i in range(0, len(body), chunk):
        out += iptc_field(8, 10, body[i:i + chunk])
    return out + end


def pcd_file(y: np.ndarray, c1: np.ndarray, c2: np.ndarray, orientation: int = 0, head: bytes = b"") -> bytes:
    """A Kodak PhotoCD of the base image alone: ``PCD_`` at byte 2048 and the
    orientation at byte 3586, ``head`` at byte 0, then from byte 96 * 2048
    the chunks of two rows of ``y`` (512, 768) and one row each of ``c1``
    and ``c2`` (256, 384)."""
    out = bytearray(96 * 2048)
    out[:len(head)] = head
    out[2048:2052] = b"PCD_"
    out[2048 + 1538] = orientation
    y, c1, c2 = (np.asarray(p, np.uint8) for p in (y, c1, c2))
    chunks = np.concatenate([y.reshape(256, 2 * 768), c1, c2], 1)
    return bytes(out) + chunks.tobytes()


def pcd_planes(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PhotoYCC planes of an RGB image (512, 768, 3), roughly as a scanner
    writes them: luma over 1.3584, the chroma planes at half size about
    156 and 137."""
    rgb = np.asarray(img, np.float64)
    y = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]) / 1.3584
    c1 = 156 + (rgb[..., 2] - 1.3584 * y) / 2.2179
    c2 = 137 + (rgb[..., 0] - 1.3584 * y) / 1.8215
    half = [np.clip(p.reshape(256, 2, 384, 2).mean((1, 3)), 0, 255) for p in (c1, c2)]
    return np.clip(np.rint(y), 0, 255).astype(np.uint8), *(np.rint(p).astype(np.uint8) for p in half)


def spider_file(values: np.ndarray, big: bool = True, istack: int = 0, imgnum: int = 0, maxim: int = 1,
                iform: int = 1, labrec: Optional[int] = None, lenbyt: Optional[int] = None,
                labbyt: Optional[int] = None, images: int = 1, fields: Tuple[Tuple[int, float], ...] = ()) -> bytes:
    """A SPIDER file of float ``values`` (h, w): a header of ``labrec``
    records of ``lenbyt`` bytes (by default as SPIDER writes one: records of
    a row, enough for 1024 bytes), its fields 1, 2, 5, 12, 13, 22, 23, 24,
    26 and 27 set (``fields``: more, by their 1-based index), then the
    floats; a stack (``istack`` > 0) repeats the header before each of its
    ``images``."""
    h, w = values.shape
    lenbyt = 4 * w if lenbyt is None else lenbyt
    labrec = (-(-1024 // lenbyt) if lenbyt > 0 else 1) if labrec is None else labrec
    labbyt = labrec * lenbyt if labbyt is None else labbyt
    hd = np.zeros(max(27, labbyt // 4), np.float64)
    for k, v in ((1, 1), (2, h), (5, iform), (12, w), (13, labrec), (22, labbyt), (23, lenbyt), (24, istack),
                 (26, maxim), (27, imgnum), *fields):
        hd[k - 1] = v
    dtype = ">f4" if big else "<f4"
    head = hd.astype(dtype).tobytes()[:max(labbyt, 108)]
    body = np.asarray(values).astype(dtype).tobytes()
    return head + b"".join(head + body for _ in range(images)) if istack > 0 else head + body


def _im_layouts(r) -> Dict[str, bytes]:
    out = {}
    seen = set()
    for typ, (mode, raw) in sorted(_pillow_im_types().items()):
        if (mode, raw) in seen or raw == "RLB" or typ == "PA image":
            continue
        seen.add((mode, raw))
        body = r.integers(0, 256, 13 * 9 * 4, dtype=np.uint8).tobytes()
        out[f"im/{typ[:-6].replace(' ', '-').replace('*', 'x').replace(';', '')}-13x9.im"] = im_file(
            [b"Image type: " + typ.encode(), b"Image size (x*y): 13*9"], body)
    lut = r.integers(0, 256, 768, dtype=np.uint8).tobytes()
    gray_lut = np.tile(np.arange(256)[::-1], 3).astype(np.uint8).tobytes()
    for typ in ("Greyscale", "B2", "B4", "LA", "PA"):
        body = r.integers(0, 256, 13 * 9 * 2, dtype=np.uint8).tobytes()
        lines = [b"Image type: %s image" % typ.encode(), b"Image size (x*y): 13*9", b"Lut: 1"]
        out[f"im/lut-{typ.lower()}-13x9.im"] = im_file(lines, body, lut)
        if typ != "PA":  # a gray LUT leaves a PA image LA of raw mode PA;L, which Pillow cannot unpack
            out[f"im/lut-gray-{typ.lower()}-13x9.im"] = im_file(lines, body, gray_lut)
    out["im/lut-rgb-kept-13x9.im"] = im_file([b"Image type: RGB image", b"Image size (x*y): 13*9", b"Lut: 1"],
                                             r.integers(0, 256, 13 * 9 * 3, dtype=np.uint8).tobytes(), lut)
    out["im/type-p-raw-l-13x9.im"] = im_file([b"Image type: P", b"Image size (x*y): 13*9"],
                                             r.integers(0, 256, 13 * 9, dtype=np.uint8).tobytes())
    out["im/type-lab-raw-l-13x9.im"] = im_file([b"Image type: LAB", b"Image size (x*y): 13*9"],
                                               r.integers(0, 256, 13 * 9, dtype=np.uint8).tobytes())
    out["im/lf-and-lfcr-lines-no-padding-13x9.im"] = (
        b"Image type: RGB image\n\rName: a\nComment: b\nImage size (x*y): 13,9\n\x1a"
        + r.integers(0, 256, 13 * 9 * 3, dtype=np.uint8).tobytes())
    out["im/second-frame-ignored-13x9.im"] = im_file(
        [b"Image type: RGB image", b"Image size (x*y): 13*9", b"File size (no of images): 2"],
        r.integers(0, 256, 2 * 13 * 9 * 3, dtype=np.uint8).tobytes())
    return out


def _imips_layouts(r) -> Dict[str, bytes]:
    from PIL import Image

    out = _im_layouts(r)
    photo = smooth_scene(2401, 9, 13, cell=4, step=2)
    gray = photo[..., 1]
    for mode in ("1", "L", "P", "LA", "RGB", "RGBA", "CMYK", "YCbCr", "I", "F"):
        im = Image.fromarray(photo).convert(mode) if mode not in ("I", "F") else Image.fromarray(
            gray.astype(np.int32) * 3 - 100 if mode == "I" else gray.astype(np.float32) * 1.5 - 20.25)
        if mode == "P":
            im = Image.fromarray(photo).quantize(13)
        buf = io.BytesIO()
        im.save(buf, "IM")
        out[f"im/pillow-written-{mode.lower()}-13x9.im"] = buf.getvalue()
    out["imt/gray-13x9.imt"] = imt_file(gray)
    out["imt/comments-and-other-fields-13x9.imt"] = imt_file(gray, [b"* IM Tools", b"width 13", b"height 9",
                                                                   b"format raw", b"pixel n8"])
    out["imt/data-longer-13x9.imt"] = imt_file(gray) + bytes(7)
    out["iptc/raw-gray-13x9.iptc"] = iptc_file(13, 9, 1, 0, 1, gray.tobytes())
    out["iptc/raw-gray-fields-of-20-13x9.iptc"] = iptc_file(13, 9, 1, 0, 1, gray.tobytes(), chunk=20)
    out["iptc/raw-gray-extended-length-13x9.iptc"] = (
        iptc_field(3, 20, b"\0\x0d") + iptc_field(3, 30, b"\0\x09") + iptc_field(3, 60, b"\1\0")
        + iptc_field(3, 120, b"\1") + iptc_field(8, 10, gray.tobytes(), extended=4) + bytes(5))
    for band in (0, 1, 2, 3):
        out[f"iptc/raw-rgb-band-{band}-13x9.iptc"] = iptc_file(13, 9, 3, 1, 1, gray.tobytes(), band=band)
    out["iptc/raw-rgb-no-band-13x9.iptc"] = iptc_file(13, 9, 3, 1, 1, gray.tobytes())
    out["iptc/raw-cmyk-band-4-13x9.iptc"] = iptc_file(13, 9, 4, 1, 1, gray.tobytes(), band=4)
    out["iptc/jpeg-rgb-13x9.iptc"] = iptc_file(13, 9, 1, 0, 5, port_jpeg(photo, 90))
    gray_jpeg = io.BytesIO()
    Image.fromarray(gray).save(gray_jpeg, "JPEG", quality=90)
    out["iptc/jpeg-gray-band-2-13x9.iptc"] = iptc_file(13, 9, 3, 1, 5, gray_jpeg.getvalue(), band=2)
    out["iptc/png-16-bit-gray-13x9.iptc"] = iptc_file(13, 9, 1, 0, 5, png_bytes(gray[..., None].astype(np.uint16) * 250, 16, 0))
    values = gray.astype(np.float32) * 2.5 - 100.125
    values[0, :3] = [np.nan, np.inf, -np.inf]
    out["spider/big-endian-13x9.spi"] = spider_file(values)
    out["spider/little-endian-13x9.spi"] = spider_file(values, big=False)
    out["spider/stack-of-2-13x9.spi"] = spider_file(values, istack=2, maxim=2, images=2)
    out["spider/header-of-3-records-13x9.spi"] = spider_file(values, labrec=3, lenbyt=52 * 7)
    buf = io.BytesIO()
    Image.fromarray(values).save(buf, "SPIDER")
    out["spider/pillow-written-13x9.spi"] = buf.getvalue()
    rgb = smooth_scene(2402, 37, 53, cell=8, step=4)
    for name, kw in (("strip", {}), ("strips", {"rows_per_strip": 7}), ("tiles", {"tile": (16, 32)}),
                     ("predictor-2", {"predictor": 2}), ("planes", {"planar": 2, "rows_per_strip": 9}),
                     ("mm", {"order": ">"})):
        out[f"tiff/old-style-lzw-rgb-{name}-53x37.tif"] = tiff_bytes(rgb, compression=5, old_lzw=True, **kw)
    out["tiff/old-style-lzw-gray-16-predictor-2-53x37.tif"] = tiff_bytes(
        rgb[..., 0].astype(np.int64) * 250, 16, 1, compression=5, predictor=2, old_lzw=True)
    out["tiff/old-style-lzw-palette-4-53x37.tif"] = tiff_bytes(rgb[..., 1] >> 4, 4, 3, compression=5, old_lzw=True,
                                                              colormap=r.integers(0, 65536, (16, 3)))
    out["tiff/old-style-lzw-fill-order-2-53x37.tif"] = tiff_bytes(
        rgb[..., 2], 8, 1, compression=5, tags={266: (3, [2])},
        chunks=[bytes(_reverse_bits(tiff_lzw(rgb[..., 2].tobytes(), True)))])
    out["tiff/old-style-lzw-no-end-code-53x37.tif"] = tiff_bytes(
        rgb[..., 0], 8, 1, compression=5, chunks=[tiff_lzw(rgb[..., 0].tobytes(), True)[:-1]])
    return out


def _pillow_im_types() -> Dict[str, Tuple[str, str]]:
    """ImImagePlugin's "Image type" table: type -> (mode, raw mode)."""
    from PIL import ImImagePlugin

    return dict(ImImagePlugin.OPEN)


def imips_layouts() -> Dict[str, bytes]:
    """Every layout of this folder the port reads (name -> bytes): IM of
    each type of Pillow's table the port reads (random bytes of the size),
    with a LUT of colours and of grays, LF and LF CR lines, files Pillow's
    IM writer makes; IMT; IPTC raw (in fields of
    20 bytes, of an extended length, each band of RGB and CMYK) and of an
    embedded JPEG or 16-bit PNG; SPIDER in both byte orders, a stack,
    Pillow's writer's; old-style LZW TIFF in strips, tiles, planes, with
    Predictor 2, MM, FillOrder 2, a 4-bit palette and 16-bit gray."""
    r = np.random.default_rng(2400)
    return {f"{IMIPS}/{k}": v for k, v in sorted(_imips_layouts(r).items())}


def imips_refusals() -> Dict[str, Tuple[bytes, str]]:
    """Files of this slice the port refuses (name -> (bytes, the reason the
    port names, a regular expression)), each of which Pillow refuses too:
    where its walk ends on an error of one of these plugins (an IPTC field
    length above 132 or an unknown compression, an IM size that is no
    number, a SPIDER stack field that is no number or an image of a stack)
    and where it opens the file and cannot load it."""
    r = np.random.default_rng(2410)
    gray = r.integers(0, 256, (9, 13)).astype(np.uint8)
    body = gray.tobytes()
    values = gray.astype(np.float32)
    jpg = port_jpeg(np.stack([gray] * 3, -1) ^ np.uint8(0x55), 85)
    lines = [b"Image type: RGB image", b"Image size (x*y): 13*9"]
    a, b = gray[:5], gray[5:]
    return {
        "im-rlb.im": (im_file([b"Image type: RLB image", b"Image size (x*y): 13*9"], body * 3), "unknown raw mode"),
        "im-pa.im": (im_file([b"Image type: PA image", b"Image size (x*y): 13*9"], body * 2), "unknown raw mode"),
        "im-pa-gray-lut.im": (im_file([b"Image type: PA image", b"Image size (x*y): 13*9", b"Lut: 1"], body * 2,
                                      np.tile(np.arange(256), 3).astype(np.uint8).tobytes()), "unknown raw mode"),
        "im-mode-rgb-raw-l.im": (im_file([b"Image type: RGB", b"Image size (x*y): 13*9"], body * 3), "unknown raw mode"),
        "im-size-not-a-number.im": (im_file([b"Image type: L 8 image", b"Image size (x*y): 13*nine"], body),
                                    "refuses"),
        "im-size-floats.im": (im_file([b"Image type: Greyscale image", b"Image size (x*y): 13.0*9"], body),
                              "no pair of integers"),
        "im-size-of-three.im": (im_file([b"Image type: Greyscale image", b"Image size (x*y): 13*9*1"], body),
                                "no pair of integers"),
        "im-cut-short.im": (im_file(lines, body * 3)[:-5], "truncated"),
        "im-bits-cut-short.im": (im_file([b"Image type: L*12 image", b"Image size (x*y): 13*9"], body), "truncated"),
        "im-too-many-pixels.im": (im_file([b"Image type: Greyscale image", b"Image size (x*y): 20000*20000"], body),
                                  "more than"),
        "imt-no-data-byte.imt": (b"width 13\nheight 9\npixel n8\n" + body, "0x0c"),
        "imt-cut-short.imt": (imt_file(gray)[:-4], "truncated"),
        "imt-width-not-a-number.imt": (imt_file(gray, [b"width 13x", b"height 9", b"pixel n8"]), "refuses"),
        "iptc-illegal-field-length.iptc": (iptc_file(13, 9, 1, 0, 1, body, extra=bytes([0x1C, 2, 5, 133, 0])),
                                           "illegal field length"),
        "iptc-compression-3.iptc": (iptc_file(13, 9, 1, 0, 3, body), "Unknown IPTC image compression"),
        "iptc-no-data-fields.iptc": (iptc_file(13, 9, 1, 0, 1, b""), "cannot load this image"),
        "iptc-data-cut-short.iptc": (iptc_file(13, 9, 1, 0, 1, body[:-3]), "truncated"),
        "iptc-band-5-of-rgb.iptc": (iptc_file(13, 9, 3, 1, 1, body, band=5), "index out of range"),
        "iptc-rgb-jpeg-in-a-band.iptc": (iptc_file(13, 9, 3, 1, 5, jpg, band=2), "mode mismatch"),
        "iptc-rgb-jpeg-in-the-first-band.iptc": (iptc_file(13, 9, 3, 1, 5, jpg, band=1), "image has wrong mode"),
        "iptc-float-tiff.iptc": (iptc_file(13, 9, 1, 0, 5, tiff_bytes(values.view(np.uint32), 32, 1, tags={
            339: (3, [3])})), "conversion from F to RGB"),
        "pcd-cut-short.pcd": (pcd_file(*pcd_planes(smooth_scene(2411, 512, 768, cell=128)))[:4000], "truncated"),
        "spider-image-of-a-stack.spi": (spider_file(values, imgnum=1), "stkoffset"),
        "spider-stack-field-nan.spi": (spider_file(values, fields=((24, float("nan")),)), "NaN"),
        "spider-negative-header-length.spi": (spider_file(values, labrec=-1, lenbyt=52), "negative seek"),
        "spider-cut-short.spi": (spider_file(values)[:-9], "truncated"),
        "tiff-old-style-lzw-then-new.tif": (tiff_bytes(gray, 8, 1, compression=5, rows_per_strip=5, chunks=[
            tiff_lzw(a.tobytes(), True), tiff_lzw(b.tobytes())]), "refused the data|breaks the format"),
        "tiff-old-style-lzw-cut-short.tif": (tiff_bytes(gray, 8, 1, compression=5, chunks=[
            tiff_lzw(body, True)[:40]]), "refused the data|breaks the format"),
    }


def imips_card_originals() -> Dict[str, bytes]:
    """The card's written originals of ``IMIPS_CARD``, from seeded numpy
    alone: name (under ``im_iptc_pcd_spider/card/``) -> bytes."""
    side = 1024
    photo = smooth_scene(2420, side, side, cell=128, step=1)
    r = np.random.default_rng(2421)
    noisy = np.clip(photo.astype(np.int64) + r.integers(-6, 7, photo.shape), 0, 255).astype(np.uint8)
    scan = smooth_scene(2422, side, side, cell=64, step=1)[..., 0]
    wide = smooth_scene(2423, 512, 768, cell=96, step=1)
    tall = smooth_scene(2424, 768, 512, cell=96, step=1)
    micrograph = smooth_scene(2425, side, side, cell=32, step=1)[..., 1].astype(np.float32) * 0.9 - 12.375
    micrograph += r.normal(0, 4, micrograph.shape).astype(np.float32)
    out = {
        "photo-1024-rgbl.im": im_file([b"Image type: RGB image", b"Name: photo-1024.im",
                                       b"Image size (x*y): 1024*1024", b"File size (no of images): 1"],
                                      im_planes(noisy)),
        "scan-1024.imt": imt_file(scan),
        "gray-1024-raw.iptc": iptc_file(side, side, 1, 0, 1, noisy[..., 1].tobytes()),
        "photo-768x512.pcd": pcd_file(*pcd_planes(wide)),
        "photo-512x768-rotated.pcd": pcd_file(*pcd_planes(np.rot90(tall, 3)), orientation=1),
        "micrograph-1024-be.spi": spider_file(micrograph),
        "photo-1024-old-lzw.tif": tiff_bytes(noisy, compression=5, predictor=2, rows_per_strip=64, old_lzw=True),
    }
    assert sorted(out) == sorted(IMIPS_CARD)
    return {f"{IMIPS}/card/{k}": v for k, v in out.items()}


def imips_fixtures() -> Dict[str, bytes]:
    """Every committed file under ``im_iptc_pcd_spider/`` (name -> bytes),
    written anew: the layouts and the refusals (the card's originals are
    written on the card, ``imips_card_originals``)."""
    refused = {f"{IMIPS}/refused/{k}": v for k, (v, _) in imips_refusals().items()}
    return dict(sorted({**imips_layouts(), **refused}.items()))


def committed_imips() -> Dict[str, bytes]:
    """The committed files under ``im_iptc_pcd_spider/``: name -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, IMIPS)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def imips_manifest(scratch: str, files: Optional[Dict[str, bytes]] = None) -> dict:
    """The manifest's parts of this folder: each committed file as
    ``gif_tiff_entry`` records it with ``imips_refusals``; each card
    original written on the card (``imips_card``)."""
    files = committed_imips() if files is None else files
    reasons = imips_refusals()
    entries = {}
    for name, data in files.items():
        path = os.path.join(scratch, "imips" + os.path.splitext(name)[1])
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = gif_tiff_entry(name, path, reasons)
    card = {}
    for name, data in imips_card_originals().items():
        path = os.path.join(scratch, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        card[name] = gif_tiff_entry(name, path, reasons)
    return {"files": entries, "imips_card": card}


def check_imips_card(folder: str, decode: Callable[[str], np.ndarray]) -> Dict[str, str]:
    """Writes ``imips_card_originals`` into ``folder`` and holds each to the
    manifest (``imips_card``): bytes and ``decode``'s RGB.  Returns name ->
    path of each; raises ``AssertionError`` naming the first that
    differs."""
    want = load_manifest()["imips_card"]
    paths = {}
    for name, data in sorted(imips_card_originals().items()):
        if sha256(data) != want[name]["sha256"]:
            raise AssertionError(f"{name}: the writer made other bytes than the manifest records")
        path = os.path.join(folder, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        got = decode(path)
        if list(got.shape[:2]) != want[name]["shape"] or sha256(got) != want[name]["sha256_rgb"]:
            raise AssertionError(f"{name}: decoded to other pixels than Pillow's")
        paths[os.path.basename(name)] = path
    if sorted(paths) != sorted(IMIPS_CARD):
        raise AssertionError(f"card originals {sorted(paths)}, expected {sorted(IMIPS_CARD)}")
    return paths


# --- LZMA, ZSTD, old-style JPEG and 12-bit JPEG TIFF; the Pillow lane's PNG past its image data ---

LZO = "tiff_lzma_zstd_ojpeg"  # their files' folder under FIXTURES
#: the card's originals (under ``tiff_lzma_zstd_ojpeg/card/``), each by the
#: listed name cli.prep reads it under: a 1024 px photo as a ZSTD RGB TIFF
#: with Predictor 2 and as an LZMA RGB TIFF (64-row strips, committed:
#: written by libzstd and liblzma, which the card's machine may lack), as
#: an old-style JPEG TIFF of 2 x 2 YCbCr (its stream by the port's encoder,
#: after JPEGInterchangeFormat), a 12-bit gray scan as a JPEG TIFF
#: (64-row strips, JPEGTables) and the photo as a PNG with chunks after its
#: image data
LZO_CARD = {"photo-1024-zstd-predictor.tif": "photo-1024-zstd.png", "photo-1024-lzma.tif": "photo-1024-lzma.jpg",
            "photo-1024-ojpeg-2x2.tif": "photo-1024-ojpeg.bmp", "scan-1024-jpeg12.tif": "scan-1024-jpeg12.webp",
            "photo-1024-chunks-after.png": "photo-1024-chunks-after.jpeg"}
LZO_COMMITTED_CARD = ("photo-1024-zstd-predictor.tif", "photo-1024-lzma.tif")
XZ_CHECKS = {"none": 0, "crc32": 1, "crc64": 4, "sha256": 10}


def libzstd() -> ctypes.CDLL:
    """Pillow's own libzstd (1.5.7), through ctypes: the writer of the ZSTD
    fixtures and the reference the tests hold the port's decoder to."""
    import glob

    import PIL
    from PIL import Image  # noqa: F401 - loads the libraries Pillow's libzstd sits beside

    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs", "libzstd-*.so*"))
    lib = ctypes.CDLL(found[0])
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_size_t]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    return lib


#: ZSTD_cParameter values
_ZSTD_PARAMS = {"level": 100, "window_log": 101, "strategy": 107, "content_size": 200, "checksum": 201}


def zstd_compress(data: bytes, **params) -> bytes:
    """One Zstandard frame of ``data`` by libzstd's ZSTD_compress2, with
    ``params`` (level, window_log, strategy, content_size, checksum)."""
    lib = libzstd()
    cctx = lib.ZSTD_createCCtx()
    try:
        for k, v in params.items():
            assert not lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, _ZSTD_PARAMS[k], int(v))), k
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
        assert not lib.ZSTD_isError(n)
        return out.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def zstd_frame(blocks: List[Tuple[str, bytes]], content: Optional[bytes] = None, checksum: bool = False,
               window_log: int = 17, dict_id: int = 0) -> bytes:
    """A Zstandard frame built here of raw (``("raw", bytes)``) and RLE
    (``("rle", byte * count)``) blocks: no content size, a window of
    2^window_log, ``dict_id`` a 4-byte dictionary ID where not 0, and the
    XXH64 checksum of ``content`` (the blocks' bytes) where ``checksum``;
    ``("compressed", section)`` a compressed block of ``zstd_literals``' section."""
    fhd = (4 if checksum else 0) | (3 if dict_id else 0)
    out = bytearray(struct.pack("<IB", 0xFD2FB528, fhd) + bytes([(window_log - 10) << 3]))
    if dict_id:
        out += struct.pack("<I", dict_id)
    for k, (kind, payload) in enumerate(blocks):
        last = k == len(blocks) - 1
        if kind == "raw":
            out += struct.pack("<I", int(last) | len(payload) << 3)[:3] + payload
        elif kind == "compressed":
            out += struct.pack("<I", int(last) | 4 | len(payload) << 3)[:3] + payload
        else:
            out += struct.pack("<I", int(last) | 2 | len(payload) << 3)[:3] + payload[:1]
    if checksum:
        out += struct.pack("<I", xxh64(content if content is not None else b"".join(
            p for _, p in blocks)) & 0xFFFFFFFF)
    return bytes(out)


def xxh64(data: bytes) -> int:
    """XXH64 of ``data``, seed 0 (Zstandard's content checksum)."""
    p1, p2, p3, p4, p5 = (11400714785074694791, 14029467366897019727, 1609587929392839161, 9650029242287828579,
                          2870177450012600261)
    m = (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, v):
        return rotl((acc + v * p2) & m, 31) * p1 & m

    n, i = len(data), 0
    if n >= 32:
        v = [(p1 + p2) & m, p2, 0, (-p1) & m]
        while n - i >= 32:
            for k in range(4):
                v[k] = rnd(v[k], struct.unpack_from("<Q", data, i + 8 * k)[0])
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & m
        for k in range(4):
            h = ((h ^ rnd(0, v[k])) * p1 + p4) & m
    else:
        h = p5
    h = (h + n) & m
    while n - i >= 8:
        h = (rotl(h ^ rnd(0, struct.unpack_from("<Q", data, i)[0]), 27) * p1 + p4) & m
        i += 8
    if n - i >= 4:
        h = (rotl(h ^ (struct.unpack_from("<I", data, i)[0] * p1 & m), 23) * p2 + p3) & m
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * p5 & m), 11) * p1 & m
        i += 1
    h = ((h ^ (h >> 33)) * p2) & m
    h = ((h ^ (h >> 29)) * p3) & m
    return h ^ (h >> 32)


def zstd_literals(data: bytes, weights: Optional[Dict[int, int]] = None, streams: int = 1) -> bytes:
    """A compressed block's literals section built here: ``data`` as RLE
    literals (``weights`` None: every byte the same) or Huffman-coded in 1
    or 4 ``streams`` under the table of ``weights`` (symbol -> weight, the
    largest symbol's weight left implied, as the direct 4-bit header writes
    them), each stream's symbols written last first, LSB-first, with the
    end mark; then the empty sequences section (no sequences)."""
    n = len(data)
    if weights is None:
        assert len(set(data)) <= 1
        head = struct.pack("<I", 1 | 3 << 2 | n << 4)[:3] if n >= 4096 else struct.pack("<H", 1 | 1 << 2 | n << 4)
        return head + data[:1] + b"\0"
    top = max(weights)
    given = [weights.get(k, 0) for k in range(top)]
    total = sum(1 << w >> 1 for w in given)
    log = total.bit_length()
    assert (1 << log) - total == 1 << (weights[top] - 1), "the implied weight must complete the code"
    full = given + [weights[top]]
    # the codes as the decoder's table lays them out: by weight from 1, symbols in order
    code, at = {}, 0
    for w in range(1, log + 1):
        for k in range(top + 1):
            if full[k] == w:
                code[k] = (at >> (w - 1), log + 1 - w)
                at += 1 << (w - 1)
    description = bytes([127 + len(given)]) + bytes(
        (given[i] << 4) | (given[i + 1] if i + 1 < len(given) else 0) for i in range(0, len(given), 2))

    def stream(part: bytes) -> bytes:
        acc = nbits = 0
        for b in reversed(part):
            v, nb = code[b]
            acc |= v << nbits
            nbits += nb
        acc |= 1 << nbits  # the end mark
        return (acc).to_bytes((nbits + 8) // 8, "little")

    if streams == 1:
        coded = stream(data)
    else:
        seg = (n + 3) // 4
        parts = [stream(data[k * seg:(k + 1) * seg]) for k in range(4)]
        coded = struct.pack("<3H", *map(len, parts[:3])) + b"".join(parts)
    csize = len(description) + len(coded)
    fmt = 0 if streams == 1 else 1 if max(n, csize) < 1024 else 2
    assert max(n, csize) < (1 << 10 if streams == 1 else 1 << 14)  # one stream: 10-bit sizes alone
    head = (struct.pack("<I", 2 | fmt << 2 | n << 4 | csize << 14)[:3] if fmt < 2 else
            struct.pack("<I", 2 | fmt << 2 | n << 4 | csize << 18))
    return head + description + coded + b"\0"


def skippable(payload: bytes, nibble: int = 0) -> bytes:
    """A Zstandard skippable frame."""
    return struct.pack("<II", 0x184D2A50 | nibble, len(payload)) + payload


def _xz_vli(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    return bytes(out + bytes([v]))


def lzma2_raw(data: bytes, preset: int = 6, dict_size: Optional[int] = None, lc: int = 3, lp: int = 0,
              pb: int = 2) -> bytes:
    """Raw LZMA2 chunks of ``data`` (its end marker included) by Python's
    lzma (liblzma)."""
    import lzma

    f = {"id": lzma.FILTER_LZMA2, "preset": preset, "lc": lc, "lp": lp, "pb": pb}
    if dict_size:
        f["dict_size"] = dict_size
    return lzma.compress(data, format=lzma.FORMAT_RAW, filters=[f])


def lzma2_uncompressed(data: bytes) -> bytes:
    """LZMA2 of uncompressed chunks alone: the first resets the dictionary
    (control 1), the rest do not (2)."""
    out = bytearray()
    for k in range(0, max(len(data), 1), 65536):
        part = data[k:k + 65536]
        out += bytes([1 if k == 0 else 2]) + struct.pack(">H", len(part) - 1) + part
    return bytes(out + b"\0")


def lzma2_spliced(a: bytes, b: bytes, mode: str) -> bytes:
    """The LZMA2 of ``a`` then ``b``'s bytes in one stream: ``b``'s first
    chunk (an LZMA chunk that resets the dictionary, 0xE0) made one that
    keeps the dictionary and resets the state with new properties
    (``mode`` "props", 0xC0) or the state alone ("state", 0xA0, its
    properties byte dropped).  ``b`` is coded without literal context
    (lc, lp and pb 0, ``a`` too for "state"), so its coder's start, which
    knew no bytes before it, reads alike after ``a``'s."""
    ra = lzma2_raw(a, dict_size=1 << 20, **({"lc": 0, "pb": 0} if mode == "state" else {}))
    rb = lzma2_raw(b, dict_size=1 << 20, lc=0, pb=0)
    assert ra[-1] == 0 and rb[0] == 0xE0 | (rb[0] & 0x1F)
    if mode == "props":
        return ra[:-1] + bytes([0xC0 | (rb[0] & 0x1F)]) + rb[1:]
    return ra[:-1] + bytes([0xA0 | (rb[0] & 0x1F)]) + rb[1:5] + rb[6:]


def xz_file(blocks: List[Tuple[bytes, bytes, bytes]], check: str = "crc32", sizes: bool = False) -> bytes:
    """An .xz stream built here: each block (filter flags, raw LZMA2,
    uncompressed data) with its header (its compressed and uncompressed
    sizes where ``sizes``), padding and check, then the index and footer."""
    cid = XZ_CHECKS[check]
    flags = bytes([0, cid])
    out = bytearray(b"\xfd7zXZ\0" + flags + struct.pack("<I", zlib.crc32(flags)))
    records = []
    for filters, raw, data in blocks:
        body = (_xz_vli(len(raw)) + _xz_vli(len(data)) if sizes else b"") + filters[1:]
        head = bytes([filters[0] | (0xC0 if sizes else 0)]) + body
        head = head + bytes(-(len(head) + 1 + 4) % 4)
        head = bytes([(len(head) + 1 + 4) // 4 - 1]) + head
        head += struct.pack("<I", zlib.crc32(head))
        if cid == 0:
            chk = b""
        elif cid == 1:
            chk = struct.pack("<I", zlib.crc32(data))
        elif cid == 4:
            chk = _crc64(data)
        else:
            chk = hashlib.sha256(data).digest()
        out += head + raw + bytes(-len(raw) % 4) + chk
        records.append((len(head) + len(raw) + len(chk), len(data)))
    index = bytearray(b"\0" + _xz_vli(len(records)))
    for unpadded, size in records:
        index += _xz_vli(unpadded) + _xz_vli(size)
    index += bytes(-len(index) % 4)
    index += struct.pack("<I", zlib.crc32(index))
    foot = struct.pack("<I", len(index) // 4 - 1) + flags
    return bytes(out + index + struct.pack("<I", zlib.crc32(foot)) + foot + b"YZ")


def _crc64(data: bytes) -> bytes:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0xC96C5795D7870F42 if c & 1 else c >> 1
        table.append(c)
    crc = (1 << 64) - 1
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return struct.pack("<Q", crc ^ ((1 << 64) - 1))


def xz_filters(delta: int = 0, bcj: int = 0, dict_byte: int = 16) -> bytes:
    """A block header's flags byte (the filter count less one) and filter
    flags: Delta of ``delta`` bytes and a BCJ filter of id ``bcj`` where not
    0, then LZMA2 of the dictionary ``dict_byte``."""
    filters = b""
    if bcj:
        filters += bytes([bcj, 0])
    if delta:
        filters += b"\x03\x01" + bytes([delta - 1])
    filters += b"\x21\x01" + bytes([dict_byte])
    return bytes([bool(bcj) + bool(delta)]) + filters


def xz_of(data: bytes, check: str = "crc32", delta: int = 0, preset: int = 6, chunking: str = "lzma",
          blocks: int = 1, sizes: bool = False, bcj: int = 0) -> bytes:
    """``data`` as an .xz stream built here: ``blocks`` blocks, each of
    LZMA2 by liblzma (``chunking`` "lzma"), of uncompressed chunks
    ("uncompressed"), or of two halves whose second keeps the dictionary
    and resets the state with new properties ("props") or alone ("state");
    Delta of ``delta`` bytes first where not 0, and a BCJ filter ``bcj``
    named before them (the data not run through it: a decoder's inverse
    applies to whatever bytes there are)."""
    step = -(-len(data) // blocks) if data else 1
    out = []
    for k in range(blocks):
        part = data[k * step:(k + 1) * step]
        coded = np.frombuffer(part, np.uint8).astype(np.int64)
        if delta:
            coded = coded.copy()
            coded[delta:] -= np.frombuffer(part, np.uint8)[:-delta].astype(np.int64)
        coded = (coded % 256).astype(np.uint8).tobytes()
        if chunking == "lzma":
            raw = lzma2_raw(coded, preset)
        elif chunking == "uncompressed":
            raw = lzma2_uncompressed(coded)
        else:
            raw = lzma2_spliced(coded[:len(coded) // 2], coded[len(coded) // 2:], chunking)
        out.append((xz_filters(delta, bcj, 20), raw, part))
    return xz_file(out, check, sizes)


def ojpeg_tiff(samples: np.ndarray, jpg: bytes, route: str = "tables", rows_per_strip: Optional[int] = None,
               photometric: int = 6, subsampling: Optional[Tuple[int, int]] = (2, 2),
               tags: Optional[Dict[int, Tuple[int, list]]] = None) -> bytes:
    """An old-style JPEG TIFF (compression 6) of the baseline JPEG ``jpg``
    (of ``samples``' size), its scan one strip, or with ``rows_per_strip``
    a strip each of its restart intervals: ``route`` "tables", its
    tables in JPEGQTables, JPEGDcTables and
    JPEGAcTables (JPEGProc 1); "header", JPEGInterchangeFormat the stream's
    markers up to its scan; or "whole",
    JPEGInterchangeFormat the whole stream and the strips inside it."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    segs = [(m, seg[4:]) for m, seg in _jpeg_segments(jpg) if m != 0xDA]  # the segments' bodies
    sof = next(b for m, b in segs if m == 0xC0)
    sos_at = jpg.index(b"\xff\xda")
    head_end = sos_at + 2 + struct.unpack(">H", jpg[sos_at + 2:sos_at + 4])[0]
    scan = jpg[head_end:jpg.rindex(b"\xff\xd9")]
    parts, cur, i = [], bytearray(), 0
    while rows_per_strip and i < len(scan):  # strips: the scan's restart intervals, one each
        if scan[i] == 0xFF and i + 1 < len(scan) and 0xD0 <= scan[i + 1] <= 0xD7:
            parts.append(bytes(cur))
            cur, i = bytearray(), i + 2
            continue
        cur.append(scan[i])
        i += 1
    parts.append(bytes(cur) if rows_per_strip else scan)
    nc = sof[5]
    pre = bytearray()  # what goes after the 8-byte header: tables or the interchange stream
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * nc), 259: (3, [6]), 262: (3, [photometric]),
         277: (3, [nc]), 278: (4, [rows_per_strip or h])}
    if route == "tables":
        dqt, dht = {}, {}
        for m, b in segs:
            q = 0
            while m == 0xDB and q < len(b):
                dqt[b[q] & 15] = b[q + 1:q + 65]
                q += 65
            while m == 0xC4 and q < len(b):
                n = sum(b[q + 1:q + 17])
                dht[b[q] >> 4, b[q] & 15] = b[q + 1:q + 17 + n]
                q += 17 + n
        sos = jpg[sos_at + 4:head_end]
        sel = {sos[1 + 2 * k]: sos[2 + 2 * k] for k in range(sos[0])}
        comps = [sof[6 + 3 * k:9 + 3 * k] for k in range(nc)]
        at = {}
        for key, table in [(("q", c[2]), dqt[c[2]]) for c in comps] + \
                          [(("dc", sel[c[0]] >> 4), dht[0, sel[c[0]] >> 4]) for c in comps] + \
                          [(("ac", sel[c[0]] & 15), dht[1, sel[c[0]] & 15]) for c in comps]:
            if key not in at:
                at[key] = 8 + len(pre)
                pre += table + bytes(len(table) % 2)
        dri = [struct.unpack(">H", b[:2])[0] for m, b in segs if m == 0xDD]
        if dri and not rows_per_strip:  # the stream's restart interval, in JPEGRestartInterval
            t[515] = (3, dri[-1:])
        t.update({512: (3, [1]), 519: (4, [at["q", c[2]] for c in comps]),
                  520: (4, [at["dc", sel[c[0]] >> 4] for c in comps]), 521: (4, [at["ac", sel[c[0]] & 15] for c in comps])})
    elif route == "header":
        t.update({513: (4, [8]), 514: (4, [head_end])})
        pre += jpg[:head_end] + bytes(head_end % 2)
    else:
        t.update({513: (4, [8]), 514: (4, [len(jpg)])})
        pre += jpg + bytes(len(jpg) % 2)
    if nc == 3 and photometric == 6 and subsampling:
        t[530] = (3, list(subsampling))
    if route == "whole":  # the strips' bytes are the interchange stream's own
        offs, at = [], 8 + head_end
        for part in parts:
            offs.append(at)
            at += len(part) + 2
        t.update({273: (4, offs), 279: (4, [len(p) for p in parts])})
        t.update(tags or {})
        return _tiff_directory(bytes(pre), t, 8)
    offs, body = [], bytearray(pre)
    for part in parts:
        offs.append(8 + len(body))
        body += part + bytes(len(part) % 2)
    t.update({273: (4, offs), 279: (4, [len(p) for p in parts])})
    t.update(tags or {})
    return _tiff_directory(bytes(body), t, 8)


def _tiff_directory(body: bytes, tags: Dict[int, Tuple[int, list]], at: int) -> bytes:
    """An II TIFF: its header, ``body`` (offsets in ``tags`` count from the
    file's start, the body at ``at``), then the directory of ``tags``."""
    head = bytearray(b"II*\0\0\0\0\0")
    out = head + body
    entries = sorted(tags.items())
    ifd_at = len(out) + len(out) % 2
    out += bytes(len(out) % 2)
    values_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, values = bytearray(struct.pack("<H", len(entries))), bytearray()
    for tag, (typ, vals) in entries:
        # RATIONAL (5): vals are numerator, denominator pairs
        raw = struct.pack("<" + {1: "B", 3: "H", 4: "I", 5: "I", 7: "B"}[typ] * len(vals), *map(int, vals))
        if len(raw) > 4:
            where = struct.pack("<I", values_at + len(values))
            values += raw + bytes(len(raw) % 2)
        else:
            where = raw + bytes(4 - len(raw))
        ifd += struct.pack("<HHI", tag, typ, len(vals) // 2 if typ == 5 else len(vals)) + where
    out[4:8] = struct.pack("<I", ifd_at)
    return bytes(out + ifd + bytes(4) + values)


def png_after(data: bytes, chunks: List[Tuple[bytes, bytes]], end: bool = True) -> bytes:
    """A PNG (``png_bytes``' one IDAT, then IEND) with ``chunks`` between
    its image data and IEND (no IEND where not ``end``)."""
    assert data.endswith(png_chunk(b"IEND", b""))
    return data[:-12] + b"".join(png_chunk(k, d) for k, d in chunks) + (data[-12:] if end else b"")


def libtiff_jpeg12(samples: np.ndarray, quality: int = 90) -> bytes:
    """A 12-bit gray JPEG TIFF of one strip written by Pillow's own libtiff
    (4.7.1, libjpeg-turbo's 12-bit encoder) through ctypes.  One strip
    only: libtiff codes each strip with Huffman tables of its own but
    writes the first strip's alone into JPEGTables, so its strips past the
    first read as damaged data."""
    import glob
    import tempfile

    import PIL
    from PIL import Image  # noqa: F401 - loads the libraries Pillow's libtiff sits beside

    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
                                             "libtiff-*.so*"))[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFWriteEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_ssize_t]
    lib.TIFFWriteEncodedStrip.restype = ctypes.c_ssize_t
    s = np.asarray(samples, np.uint16)
    h, w = s.shape
    assert w % 2 == 0, "libtiff's 12-bit JPEG codec reads a row's samples two at a time"
    rows = _tiff_rows(s[:, :, None], 12, ">")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.tif").encode()
        t = lib.TIFFOpen(path, b"w")
        for tag, value in ((256, w), (257, h), (258, 12), (277, 1), (262, 1), (259, 7), (284, 1), (278, h),
                           (65537, quality)):  # 65537: TIFFTAG_JPEGQUALITY
            lib.TIFFSetField(ctypes.c_void_p(t), ctypes.c_uint32(tag), ctypes.c_int(value))
        data = rows.tobytes()
        assert lib.TIFFWriteEncodedStrip(t, 0, data, len(data)) >= 0
        lib.TIFFClose(t)
        with open(path, "rb") as f:
            return f.read()


def _pil_tiff(im, **kw) -> bytes:
    out = io.BytesIO()
    im.save(out, "TIFF", **kw)
    return out.getvalue()


def _lzo_tiff_layouts(r) -> Dict[str, bytes]:
    """LZMA and ZSTD TIFFs: Pillow's writer (libtiff 4.7.1) in L, RGB, P,
    I;16, RGBA and CMYK with Predictor 1 and 2 (in strips: it writes no
    tiles); and this module's, in strips and tiles: .xz streams of each check kind, Delta,
    two blocks, sizes in the block header, uncompressed chunks, chunks that
    reset the state with and without new properties, presets 0 and 9, a
    check, index and footer damaged after the strip's last byte (libtiff
    never reads them); Zstandard frames of levels -5 to 19, with a
    checksum, a content size, a 1 KiB window, of raw and RLE blocks built
    here, a frame followed by another or by a skippable frame (libtiff
    reads the first alone), 16-bit gray with Predictor 2."""
    from PIL import Image

    photo = smooth_scene(2511, 23, 37, cell=8, step=4)
    im = Image.fromarray(photo)
    modes = {"L": im.convert("L"), "RGB": im, "P": im.quantize(16),
             "I16": Image.fromarray(photo[..., 0].astype(np.uint16) * 7 + 3),
             "RGBA": Image.fromarray(with_alpha(photo, 2512)), "CMYK": im.convert("CMYK")}
    out = {}
    for comp in ("lzma", "zstd"):
        for mode, m in modes.items():
            for pred in (1, 2):
                out[f"{comp}/pillow-{mode}-p{pred}.tif"] = _pil_tiff(m, compression=comp, tiffinfo={317: pred})
    noisy = np.clip(photo.astype(np.int64) + r.integers(-30, 31, photo.shape), 0, 255).astype(np.uint8)
    gray16 = photo[..., 1].astype(np.int64) * 200 + r.integers(0, 200, photo.shape[:2])

    def lz(**kw):
        return lambda raw: xz_of(raw, **kw)

    def zs(**kw):
        return lambda raw: zstd_compress(raw, **kw)

    for check in XZ_CHECKS:
        out[f"lzma/check-{check}.tif"] = tiff_bytes(photo, compression=34925, rows_per_strip=8, compress=lz(check=check))
    out["lzma/delta-3.tif"] = tiff_bytes(photo, compression=34925, compress=lz(delta=3, check="crc64"))
    out["lzma/delta-1-predictor-2.tif"] = tiff_bytes(photo, compression=34925, predictor=2, compress=lz(delta=1))
    out["lzma/two-blocks.tif"] = tiff_bytes(noisy, compression=34925, compress=lz(blocks=2, check="sha256"))
    out["lzma/sizes-in-header.tif"] = tiff_bytes(photo, compression=34925, compress=lz(blocks=3, sizes=True))
    out["lzma/uncompressed-chunks.tif"] = tiff_bytes(noisy, compression=34925, compress=lz(chunking="uncompressed"))
    out["lzma/props-reset.tif"] = tiff_bytes(photo, compression=34925, compress=lz(chunking="props"))
    out["lzma/state-reset.tif"] = tiff_bytes(photo, compression=34925, compress=lz(chunking="state"))
    out["lzma/preset-0.tif"] = tiff_bytes(noisy, compression=34925, tile=(16, 16), compress=lz(preset=0))
    out["lzma/preset-9.tif"] = tiff_bytes(noisy, compression=34925, compress=lz(preset=9, check="crc64"))
    out["lzma/gray16-predictor-2.tif"] = tiff_bytes(gray16, 16, 1, compression=34925, predictor=2, compress=lz())
    # damage past the strip's last byte: the check, the index, the footer
    good = xz_of(photo.tobytes(), check="crc32")
    out["lzma/bad-check-after-strip.tif"] = tiff_bytes(photo, compression=34925, chunks=[
        good[:-28] + bytes([good[-28] ^ 1]) + good[-27:]])
    out["lzma/bad-footer-after-strip.tif"] = tiff_bytes(photo, compression=34925, chunks=[good[:-2] + b"ZY"])
    for level in (-5, 1, 9, 19):
        out[f"zstd/level-{level}.tif"] = tiff_bytes(noisy if level < 9 else photo, compression=50000,
                                                     rows_per_strip=12, compress=zs(level=level))
    out["zstd/checksum.tif"] = tiff_bytes(photo, compression=50000, compress=zs(level=3, checksum=1))
    out["zstd/no-content-size.tif"] = tiff_bytes(photo, compression=50000, compress=zs(level=3, content_size=0,
                                                                                       checksum=1))
    out["zstd/window-1k.tif"] = tiff_bytes(noisy, compression=50000, compress=zs(level=5, window_log=10))
    out["zstd/raw-and-rle-blocks.tif"] = tiff_bytes(
        photo, compression=50000, compress=lambda raw: zstd_frame(
            [("raw", raw[:700]), ("rle", raw[700:701] * 300), ("raw", raw[1000:])], raw[:700] + raw[700:701] * 300 +
            raw[1000:], checksum=True))
    out["zstd/two-frames.tif"] = tiff_bytes(photo, compression=50000, compress=lambda raw: zstd_compress(
        raw, level=3) + zstd_compress(raw[::-1], level=3))
    out["zstd/frame-then-skippable.tif"] = tiff_bytes(photo, compression=50000, compress=lambda raw: zstd_compress(
        raw, level=3, checksum=1) + skippable(b"metadata"))
    out["zstd/gray16-predictor-2.tif"] = tiff_bytes(gray16, 16, 1, compression=50000, predictor=2,
                                                    compress=zs(level=12))
    out["zstd/tiles.tif"] = tiff_bytes(noisy, compression=50000, tile=(16, 16), compress=zs(level=7, checksum=1))
    return out


def _lzo_jpeg_layouts(r) -> Dict[str, bytes]:
    """Old-style JPEG TIFFs by each route (the tables, the interchange
    stream's header, the whole stream) at 1 x 1, 2 x 1 and 2 x 2, 4 x 1,
    4 x 2 and 1 x 2 (this module's JPEG writer), strips of a restart
    interval each,
    gray, the interchange file once refused; 12-bit gray JPEG TIFFs
    (``jpeg12_tiff``) in one strip, strips, tiles, beside JPEGTables and
    with restart markers, one libtiff wrote, the 8-bit stream read at 12
    bits once refused."""
    from PIL import Image

    photo = smooth_scene(2513, 23, 37, cell=8, step=4)
    tall = smooth_scene(2514, 40, 21, cell=8, step=4)
    out = {}
    for ss, sub in ((0, (1, 1)), (1, (2, 1)), (2, (2, 2))):
        jpg = _pil_jpeg(photo, quality=88, subsampling=ss)
        for route in ("tables", "header", "whole"):
            out[f"ojpeg/{route}-{sub[0]}x{sub[1]}.tif"] = ojpeg_tiff(photo, jpg, route, subsampling=sub)
        rows = 16 if ss == 2 else 8
        jpg = _pil_jpeg(tall, quality=80, subsampling=ss, restart_marker_rows=1)
        for route in ("tables", "header"):
            out[f"ojpeg/{route}-{sub[0]}x{sub[1]}-strips.tif"] = ojpeg_tiff(tall, jpg, route, rows, subsampling=sub)
    for sampling, route in (([(4, 1), (1, 1), (1, 1)], "tables"), ([(4, 2), (1, 1), (1, 1)], "header"),
                            ([(1, 2), (1, 1), (1, 1)], "header")):
        name = "x".join(map(str, sampling[0]))
        out[f"ojpeg/{route}-{name}.tif"] = ojpeg_tiff(photo, jpeg_from_blocks(23, 37, sampling, 2515 + len(out)),
                                                      route, subsampling=sampling[0])
    gray = np.asarray(Image.fromarray(photo).convert("L"))
    gjpg = _pil_jpeg(gray, quality=85)
    for route in ("tables", "header"):
        out[f"ojpeg/gray-{route}.tif"] = ojpeg_tiff(gray, gjpg, route, photometric=1)
    out["ojpeg/interchange-twice.tif"] = legacy_old_jpeg()
    scan = (smooth_scene(2516, 24, 30, cell=8, step=4)[..., 0].astype(np.int64) * 5 + 40 +
            r.integers(0, 40, (24, 30)))
    for scale in (0.25, 1.0, 4.0):
        out[f"jpeg12/one-strip-{scale}.tif"] = jpeg12_tiff(scan, scale)
    out["jpeg12/strips.tif"] = jpeg12_tiff(scan, 1.0, rows_per_strip=8)
    out["jpeg12/tiles.tif"] = jpeg12_tiff(scan, 1.0, tile=(16, 16))
    out["jpeg12/shared-tables.tif"] = jpeg12_tiff(scan, 0.5, rows_per_strip=16, shared_tables=True)
    out["jpeg12/restarts.tif"] = jpeg12_tiff(scan, 1.0, restart=3)
    out["jpeg12/libtiff-written.tif"] = libtiff_jpeg12(scan % 4096, 85)
    out["jpeg12/eight-bit-stream-at-12.tif"] = legacy_jpeg12()
    return out


def legacy_old_jpeg() -> bytes:
    """An old-style JPEG TIFF whose JPEGInterchangeFormat and only strip are
    one whole JPEG stream (the port's encoder's), as ``legacy_refusals``
    wrote it before the port read it."""
    photo = smooth_scene(2331, 24, 20, cell=8, step=4)
    jpg = port_jpeg(photo, 85)
    return tiff_bytes(photo, 8, 6, compression=6, chunks=[jpg], tags={530: (3, [2, 2]), 513: (4, [8]),
                                                                      514: (4, [len(jpg)])})


def legacy_jpeg12() -> bytes:
    """A gray JPEG TIFF whose 8-bit stream's precision byte and
    BitsPerSample say 12, as ``legacy_refusals`` wrote it before the port
    read it."""
    photo = smooth_scene(2331, 24, 20, cell=8, step=4)
    jpeg_gray = jpeg_tiff(photo[..., 0], 1, 85)
    sof = jpeg_gray.index(b"\xff\xc0")
    jpeg12 = bytearray(jpeg_gray[:sof + 4] + b"\x0c" + jpeg_gray[sof + 5:])
    at = struct.unpack_from("<I", jpeg12, 4)[0]
    for i in range(struct.unpack_from("<H", jpeg12, at)[0]):
        if struct.unpack_from("<H", jpeg12, at + 2 + 12 * i)[0] == 258:  # BitsPerSample 12
            struct.pack_into("<H", jpeg12, at + 2 + 12 * i + 8, 12)
    return bytes(jpeg12)


def lzo_png_layouts() -> Dict[str, bytes]:
    """The Pillow lane's PNG past its image data (PngImageFile.load_end),
    never committed (a PNG's lanes part here: the native lane reads
    libpng's way, and refuses a palette without PLTE):
    palettes without PLTE at each depth (Pillow's empty palette: black), a
    PLTE after the image data (too late for Pillow), text, compressed text
    and an unknown chunk after it, a second IDAT, an fcTL of a file that is
    not animated, a bad CRC after the image data (never checked), a file
    cut inside the last CRC."""
    r = np.random.default_rng(2517)
    photo = smooth_scene(2517, 13, 17, cell=4, step=8)
    base = png_bytes(photo, 8, 2)
    idx = r.integers(0, 256, (13, 17, 1))
    out = {f"png/palette-{d}-no-plte.png": png_bytes(idx % (1 << d), d, 3) for d in (1, 2, 4, 8)}
    out["png/plte-after-image.png"] = png_after(png_bytes(idx, 8, 3, chunks=[(b"PLTE", bytes(range(256)) * 3)]),
                                                [(b"PLTE", bytes(r.integers(0, 256, 768, dtype=np.uint8)))])
    itxt = b"Title\0\1\0en\0Titel\0" + zlib.compress("a caption, déjà vu".encode())
    out["png/text-after-image.png"] = png_after(base, [(b"tEXt", b"Comment\0after the image"),
                                                       (b"zTXt", b"Software\0\0" + zlib.compress(b"port" * 50)),
                                                       (b"iTXt", itxt), (b"eXIf", b"MM\0*\0\0\0\x08\0\0"),
                                                       (b"prVt", bytes(40))])
    out["png/second-idat.png"] = png_after(base, [(b"IDAT", zlib.compress(b"more"))])
    fctl = struct.pack(">IIIIIHHBB", 0, 17, 13, 0, 0, 1, 10, 0, 0)
    out["png/fctl-not-animated.png"] = png_after(base, [(b"fcTL", fctl)])
    bad = png_after(base, [(b"tEXt", b"k\0v")])
    out["png/bad-crc-after-image.png"] = bad[:-13] + bytes([bad[-13] ^ 0xFF]) + bad[-12:]
    out["png/cut-in-last-crc.png"] = base[:-12 - 2]
    return out


def lzo_layouts() -> Dict[str, bytes]:
    """Every committed file of this folder the port reads (name under
    ``tiff_lzma_zstd_ojpeg/`` -> bytes)."""
    r = np.random.default_rng(2510)
    out = {**_lzo_tiff_layouts(r), **_lzo_jpeg_layouts(r)}
    return {f"{LZO}/{k}": v for k, v in sorted(out.items())}


def lzo_refusals() -> Dict[str, Tuple[bytes, str]]:
    """Files of this slice the port refuses (name -> (bytes, the reason
    its error names, a regular expression)): those Pillow refuses too, and
    those Pillow reads that the port leaves out by name (an .xz BCJ filter,
    old JPEG of RGB samples or of a frame taller than 65535 rows built from
    the tags, a 12-bit JPEG row libtiff leaves short)."""
    r = np.random.default_rng(2520)
    photo = smooth_scene(2521, 12, 20, cell=4, step=8)
    raw = photo.tobytes()
    xz = xz_of(raw)
    z = zstd_compress(raw, level=3, checksum=1)
    zh = _zstd_header_size(z)
    dictz = bytearray(zstd_compress(raw, level=3))
    dictz = bytes(dictz[:4]) + bytes([dictz[4] | 1]) + bytes(dictz[5:6]) + b"\x2a" + bytes(dictz[6:])
    jpg = _pil_jpeg(photo, quality=85, subsampling=0)
    jpg22 = _pil_jpeg(photo, quality=85, subsampling=2)
    scan = (photo[..., 0].astype(np.int64) * 9) % 4096
    odd = r.integers(0, 4096, (12, 21))
    wide = tiff_bytes(odd, 12, 1, compression=7, chunks=[jpeg12_gray(odd, 1.0)])
    out = {
        "lzma-bcj-x86.tif": (tiff_bytes(photo, compression=34925, compress=lambda b: xz_of(b, bcj=4)), "BCJ"),
        "lzma-cut-short.tif": (tiff_bytes(photo, compression=34925, chunks=[xz[:len(xz) // 2]]),
                               "truncated|breaks the format"),
        "lzma-stream-short-of-the-strip.tif": (tiff_bytes(photo, compression=34925, chunks=[xz_of(raw[:-7])]),
                                               "truncated"),
        "lzma-bad-first-block-check.tif": (tiff_bytes(photo, compression=34925, chunks=[
            _flip_xz_check(xz_of(raw, blocks=2))]), "breaks the format"),
        "lzma-bad-data.tif": (tiff_bytes(photo, compression=34925, chunks=[xz[:40] + bytes(b ^ 0x55 for b in xz[40:60])
                                                                              + xz[60:]]), "breaks the format|truncated"),
        "zstd-dictionary.tif": (tiff_bytes(photo, compression=50000, chunks=[dictz]), "Dictionary mismatch"),
        "zstd-skippable-first.tif": (tiff_bytes(photo, compression=50000, chunks=[skippable(b"x") + z]), "truncated"),
        "zstd-bad-checksum.tif": (tiff_bytes(photo, compression=50000, chunks=[z[:-1] + bytes([z[-1] ^ 1])]),
                                  "breaks the format"),
        "zstd-cut-short.tif": (tiff_bytes(photo, compression=50000, chunks=[z[:len(z) // 2]]),
                               "truncated|breaks the format"),
        "zstd-reserved-block.tif": (tiff_bytes(photo, compression=50000, chunks=[
            z[:zh] + bytes([z[zh] | 6]) + z[zh + 1:]]), "breaks the format"),
        "ojpeg-rgb.tif": (ojpeg_tiff(photo, jpg, "tables", photometric=2), "old-style JPEG"),
        "ojpeg-tiled.tif": (tiff_bytes(photo, 8, 6, compression=6, tile=(16, 16), data=jpg, tags={
            530: (3, [1, 1])}), "old-style JPEG"),
        "ojpeg-no-tables.tif": (ojpeg_tiff(photo, jpg, "tables", subsampling=(1, 1), tags={519: (4, [0])}),
                                "old-style JPEG"),
        "ojpeg-2x4.tif": (ojpeg_tiff(photo, jpeg_from_blocks(12, 20, [(2, 4), (1, 1), (1, 1)], 2522), "header",
                                     subsampling=(2, 4)), "YCbCr pixels in this layout"),
        # the tables route's frame takes the tags' size in 16 bits
        "ojpeg-width-70000.tif": (ojpeg_tiff(photo, jpg22, "tables", tags={256: (4, [70000])}),
                                  "does not match the file's tags"),
        "ojpeg-height-65537.tif": (ojpeg_tiff(photo, jpg22, "tables", tags={257: (4, [65537]), 278: (4, [65537])}),
                                   "taller than 65535 rows"),
        "ojpeg-chroma-2x1.tif": (ojpeg_tiff(photo, jpeg_from_blocks(12, 20, [(2, 2), (2, 1), (1, 1)], 2523), "header"),
                                 "old-style JPEG"),
        "jpeg12-rgb.tif": (tiff_bytes(np.zeros((12, 20, 3), np.uint16), 12, 2, compression=7, chunks=[b"\xff\xd8"]),
                           "depth or sample layout"),
        "jpeg12-odd-width.tif": (wide, "odd width"),
        "jpeg12-eight-bit-stream.tif": (tiff_bytes(scan, 12, 1, compression=7, chunks=[_pil_jpeg(
            photo[..., 0], quality=80)]), "does not match the file's tags"),
        "webp-in-tiff.tif": (tiff_bytes(photo, compression=50001, chunks=[pil_webp(photo, lossless=True)]),
                             "with this compression"),
        "jbig.tif": (tiff_bytes(photo[..., 0] & 1, 1, 0, compression=34661, chunks=[bytes(40)]),
                     "with this compression"),
    }
    return out


def lzo_png_refusals() -> Dict[str, Tuple[bytes, str]]:
    """PNGs whose chunks after the image data Pillow's Pillow lane refuses
    (a body cut short: "Truncated File Read"; a chunk handler's error),
    never committed: the native lane reads them."""
    png = png_bytes(smooth_scene(2521, 12, 20, cell=4, step=8), 8, 2)
    return {
        "png-text-cut-after-image.png": (png_after(png, [(b"tEXt", b"Comment\0" + bytes(60))], end=False)[:-30],
                                         "Truncated File Read"),
        "png-idat-cut-after-image.png": (png_after(png, [(b"IDAT", bytes(100))], end=False)[:-50],
                                         "Truncated File Read"),
        "png-ztxt-method-after-image.png": (png_after(png, [(b"zTXt", b"k\0\1xyz")]), "chunk handler refuses"),
        "png-gama-short-after-image.png": (png_after(png, [(b"gAMA", b"\0\1")]), "chunk handler refuses"),
        "png-ztxt-too-large-after-image.png": (png_after(png, [(b"zTXt", b"k\0\0" + zlib.compress(bytes(1 << 21)))]),
                                               "chunk handler refuses"),
        "png-fctl-sequence-after-image.png": (png_after(png, [(b"fcTL", struct.pack(">IIIIIHHBB", 4, 20, 12, 0, 0,
                                                                                      1, 10, 0, 0))]),
                                              "chunk handler refuses"),
    }


def _flip_xz_check(stream: bytes) -> bytes:
    """A two-block .xz stream (CRC32) with its first block's check
    changed: a fault liblzma finds before the strip's buffer is full."""
    at = 12
    assert not stream[at + 1] & 0xC0  # no sizes in the block header
    data = at + (stream[at] + 1) * 4
    # the first block's LZMA2 ends at its end marker: walk its chunks
    q = data
    while stream[q] != 0:
        c = stream[q]
        if c >= 0x80:
            packed = (stream[q + 3] << 8 | stream[q + 4]) + 1
            q += 5 + (c >= 0xC0) + packed
        else:
            q += 3 + (stream[q + 1] << 8 | stream[q + 2]) + 1
    q += 1
    q += -(q - data) % 4
    return stream[:q] + bytes([stream[q] ^ 1]) + stream[q + 1:]


def _zstd_header_size(frame: bytes) -> int:
    """The size of a Zstandard frame's header: magic, descriptor, window,
    dictionary ID and content size."""
    fhd = frame[4]
    single = fhd >> 5 & 1
    return 5 + (not single) + (0, 1, 2, 4)[fhd & 3] + ((1 if single else 0), 2, 4, 8)[fhd >> 6]


def lzo_card_committed() -> Dict[str, bytes]:
    """The committed card originals of ``LZO_COMMITTED_CARD``: the 1024 px
    photo of ``lzo_card_originals`` as an RGB TIFF of 64-row strips, ZSTD
    (level 12) after Predictor 2 and LZMA (Delta of 3 bytes, preset 6,
    CRC32), as libtiff's own LZMA writer chains Delta before LZMA2."""
    photo = lzo_card_photo()
    return {f"{LZO}/card/photo-1024-zstd-predictor.tif": tiff_bytes(
        photo, compression=50000, predictor=2, rows_per_strip=64, compress=lambda b: zstd_compress(b, level=12)),
            f"{LZO}/card/photo-1024-lzma.tif": tiff_bytes(photo, compression=34925, rows_per_strip=64,
                                                           compress=lambda b: xz_of(b, delta=3))}


def lzo_card_photo() -> np.ndarray:
    return smooth_scene(2530, 1024, 1024, cell=256, step=1)


def lzo_card_originals() -> Dict[str, bytes]:
    """The card's written originals of ``LZO_CARD`` (all but the committed
    ones), from seeded numpy and the port's JPEG encoder alone: name (under
    ``tiff_lzma_zstd_ojpeg/card/``) -> bytes."""
    photo = lzo_card_photo()
    scan = smooth_scene(2531, 1024, 1024, cell=128, step=1)[..., 1].astype(np.int64) * 9 + 100
    png = png_bytes(photo, 8, 2)
    out = {
        "photo-1024-ojpeg-2x2.tif": ojpeg_tiff(photo, port_jpeg(photo, 90), "header"),
        "scan-1024-jpeg12.tif": jpeg12_tiff(scan, 1.0, rows_per_strip=64, shared_tables=True),
        "photo-1024-chunks-after.png": png_after(png, [(b"tEXt", b"Comment\0" + b"written after the image " * 8),
                                                       (b"zTXt", b"Software\0\0" + zlib.compress(b"port" * 64)),
                                                       (b"eXIf", b"MM\0*\0\0\0\x08\0\0")]),
    }
    assert sorted(out) == sorted(set(LZO_CARD) - set(LZO_COMMITTED_CARD))
    return {f"{LZO}/card/{k}": v for k, v in out.items()}


def lzo_fixtures() -> Dict[str, bytes]:
    """Every committed file under ``tiff_lzma_zstd_ojpeg/`` (name -> bytes),
    written anew: the layouts, the refusals and the committed card
    originals."""
    refused = {f"{LZO}/refused/{k}": v for k, (v, _) in lzo_refusals().items()}
    return dict(sorted({**lzo_layouts(), **refused, **lzo_card_committed()}.items()))


def committed_lzo() -> Dict[str, bytes]:
    """The committed files under ``tiff_lzma_zstd_ojpeg/``: name -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, LZO)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def lzo_manifest(scratch: str, files: Optional[Dict[str, bytes]] = None) -> dict:
    """The manifest's parts of this folder: each committed file as
    ``gif_tiff_entry`` records it with ``lzo_refusals``; each card original
    written on the card (``lzo_card``)."""
    files = committed_lzo() if files is None else files
    reasons = lzo_refusals()
    entries = {}
    for name, data in files.items():
        path = os.path.join(scratch, "lzo" + os.path.splitext(name)[1])
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = gif_tiff_entry(name, path, reasons)
    card = {}
    for name, data in lzo_card_originals().items():
        path = os.path.join(scratch, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        card[name] = gif_tiff_entry(name, path, reasons)
    return {"files": entries, "lzo_card": card}


def check_lzo_card(folder: str, decode: Callable[[str], np.ndarray]) -> Dict[str, str]:
    """Writes ``lzo_card_originals`` into ``folder`` and holds each, and
    each committed card original, to the manifest (``lzo_card``; the
    committed ones under ``files``): bytes and ``decode``'s RGB.  Returns
    name -> path of each; raises ``AssertionError`` naming the first that
    differs."""
    manifest = load_manifest()
    want = {**manifest["lzo_card"], **{n: e for n, e in manifest["files"].items() if n.startswith(f"{LZO}/card/")}}
    written = lzo_card_originals()
    paths = {}
    for name in sorted(want):
        path = os.path.join(FIXTURES, name)
        if name in written:
            if sha256(written[name]) != want[name]["sha256"]:
                raise AssertionError(f"{name}: the writer made other bytes than the manifest records")
            path = os.path.join(folder, os.path.basename(name))
            with open(path, "wb") as f:
                f.write(written[name])
        got = decode(path)
        if list(got.shape[:2]) != want[name]["shape"] or sha256(got) != want[name]["sha256_rgb"]:
            raise AssertionError(f"{name}: decoded to other pixels than Pillow's")
        paths[os.path.basename(name)] = path
    if sorted(paths) != sorted(LZO_CARD):
        raise AssertionError(f"card originals {sorted(paths)}, expected {sorted(LZO_CARD)}")
    return paths


# --- JPEG 2000: the JAX package's Pillow lane through OpenJPEG ------------------------------------

J2K = "jpeg2000"  # their files' folder under FIXTURES
#: the card's originals (under ``jpeg2000/card/``, committed: the card's
#: machine has no JPEG 2000 writer), each by the listed name cli.prep reads
#: it under, or None for one only timed: a 1024 px photo as a 5/3 lossless
#: codestream, as a JP2 of 9/7 in three quality layers, and as a JP2 of 9/7
#: in 256 px tiles, RPCL order and 64 px precincts; a 128 px icon whose
#: ``ic07`` element is a JP2
J2K_CARD = {"photo-1024-53.j2k": None, "photo-1024-97-layers.jp2": "photo-1024-jp2.jpg",
            "photo-1024-97-rpcl-tiles.jp2": None, "icon-128-jpeg2000.icns": "icon-128-jpeg2000.png"}
#: the progression orders by OpenJPEG's numbers
J2K_PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
_JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"


def openjpeg() -> ctypes.CDLL:
    """Pillow's own libopenjp2 (2.5.4), through ctypes, with its encoder's
    structures (``opj_cparameters_t``, ``opj_image_t``) declared on it: the
    writer of what Pillow's encoder cannot set (code-block styles, POC,
    RGN, subsampled components, 1- to 16-bit and signed samples,
    tile-parts, TLM and PLT)."""
    import glob

    import PIL
    from PIL import Image  # noqa: F401 - loads the libraries Pillow's libopenjp2 sits beside

    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
                                             "libopenjp2-*.so*"))[0])
    if hasattr(lib, "Params"):
        return lib
    u, i = ctypes.c_uint32, ctypes.c_int

    class Poc(ctypes.Structure):
        _fields_ = ([(n, u) for n in "resno0 compno0 layno1 resno1 compno1 layno0 precno0 precno1".split()]
                    + [("prg1", i), ("prg", i), ("progorder", ctypes.c_char * 5), ("tile", u)]
                    + [(n, ctypes.c_int32) for n in "tx0 tx1 ty0 ty1".split()]
                    + [(n, u) for n in ("layS resS compS prcS layE resE compE prcE txS txE tyS tyE dx dy lay_t res_t "
                                        "comp_t prc_t tx0_t ty0_t").split()])

    class Params(ctypes.Structure):
        _fields_ = [("tile_size_on", i), ("cp_tx0", i), ("cp_ty0", i), ("cp_tdx", i), ("cp_tdy", i),
                    ("cp_disto_alloc", i), ("cp_fixed_alloc", i), ("cp_fixed_quality", i),
                    ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p), ("csty", i), ("prog_order", i),
                    ("POC", Poc * 32), ("numpocs", u), ("tcp_numlayers", i), ("tcp_rates", ctypes.c_float * 100),
                    ("tcp_distoratio", ctypes.c_float * 100), ("numresolution", i), ("cblockw_init", i),
                    ("cblockh_init", i), ("mode", i), ("irreversible", i), ("roi_compno", i), ("roi_shift", i),
                    ("res_spec", i), ("prcw_init", i * 33), ("prch_init", i * 33), ("infile", ctypes.c_char * 4096),
                    ("outfile", ctypes.c_char * 4096), ("index_on", i), ("index", ctypes.c_char * 4096),
                    ("image_offset_x0", i), ("image_offset_y0", i), ("subsampling_dx", i), ("subsampling_dy", i),
                    ("decod_format", i), ("cod_format", i), ("jpwl_epc_on", i), ("jpwl_hprot_MH", i),
                    ("jpwl_hprot_TPH_tileno", i * 16), ("jpwl_hprot_TPH", i * 16), ("jpwl_pprot_tileno", i * 16),
                    ("jpwl_pprot_packno", i * 16), ("jpwl_pprot", i * 16), ("jpwl_sens_size", i),
                    ("jpwl_sens_addr", i), ("jpwl_sens_range", i), ("jpwl_sens_MH", i),
                    ("jpwl_sens_TPH_tileno", i * 16), ("jpwl_sens_TPH", i * 16), ("cp_cinema", i),
                    ("max_comp_size", i), ("cp_rsiz", i), ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char),
                    ("tcp_mct", ctypes.c_char), ("jpip_on", i), ("mct_data", ctypes.c_void_p), ("max_cs_size", i),
                    ("rsiz", ctypes.c_uint16)]

    class ComponentParams(ctypes.Structure):
        _fields_ = [(n, u) for n in "dx dy w h x0 y0 prec bpp sgnd".split()]

    class Component(ctypes.Structure):
        _fields_ = ([(n, u) for n in "dx dy w h x0 y0 prec bpp sgnd resno_decoded factor".split()]
                    + [("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)])

    class OpjImage(ctypes.Structure):
        _fields_ = [("x0", u), ("y0", u), ("x1", u), ("y1", u), ("numcomps", u), ("color_space", i),
                    ("comps", ctypes.POINTER(Component)), ("icc_profile_buf", ctypes.c_void_p),
                    ("icc_profile_len", u)]

    p = ctypes.c_void_p
    lib.opj_image_create.restype = ctypes.POINTER(OpjImage)
    lib.opj_image_destroy.argtypes = [ctypes.POINTER(OpjImage)]
    lib.opj_create_compress.restype = p
    lib.opj_stream_create_default_file_stream.restype = p
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, i]
    lib.opj_setup_encoder.argtypes = [p, ctypes.POINTER(Params), ctypes.POINTER(OpjImage)]
    lib.opj_start_compress.argtypes = [p, ctypes.POINTER(OpjImage), p]
    lib.opj_encode.argtypes = [p, p]
    lib.opj_end_compress.argtypes = [p, p]
    lib.opj_encoder_set_extra_options.argtypes = [p, ctypes.POINTER(ctypes.c_char_p)]
    lib.opj_stream_destroy.argtypes = [p]
    lib.opj_destroy_codec.argtypes = [p]
    lib.Params, lib.ComponentParams = Params, ComponentParams
    params = Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(params))
    # the layout as OpenJPEG 2.5's defaults place them
    assert (params.numresolution, params.cblockw_init, params.roi_compno, params.subsampling_dx, params.decod_format,
            params.cod_format) == (6, 64, -1, 1, -1, -1)
    return lib


def opj_stream(planes: List[np.ndarray], prec=8, sgnd=False, sub=None, offset=(0, 0), layers=None,
               irreversible: bool = False, numres: int = 3, cblk=None, mode: int = 0, progression: str = "LRCP",
               pocs=(), roi=None, tiles=None, tile_offset=(0, 0), precincts=None, csty: int = 0,
               mct: Optional[int] = None, tile_parts: Optional[str] = None, extra=(), comment: Optional[bytes] = None,
               color_space: int = 0) -> bytes:
    """A raw codestream of ``planes`` (one integer array a component, each
    at its subsampled size ``sub``) by libopenjp2's encoder (``openjpeg``):
    ``prec``/``sgnd`` (or a list a component), ``layers`` the rates of the
    quality layers, ``mode`` the code-block style flags, ``pocs`` (res0,
    comp0, layer1, res1, comp1, order) entries, ``roi`` (component, shift),
    ``precincts`` (w, h) a resolution from the highest, ``csty`` 2 for SOP
    and 4 for EPH, ``tile_parts`` OpenJPEG's "R", "L" or "C", ``extra``
    its options ("PLT=YES", "TLM=YES")."""
    import tempfile

    lib = openjpeg()
    n = len(planes)
    sub = sub or [(1, 1)] * n
    precs = list(prec) if isinstance(prec, (list, tuple)) else [prec] * n
    signs = list(sgnd) if isinstance(sgnd, (list, tuple)) else [sgnd] * n
    cparams = (lib.ComponentParams * n)()
    for c, plane in enumerate(planes):
        cp = cparams[c]
        cp.dx, cp.dy = sub[c]
        cp.h, cp.w = plane.shape
        cp.x0, cp.y0 = offset
        cp.prec = cp.bpp = precs[c]
        cp.sgnd = int(signs[c])
    image = lib.opj_image_create(n, cparams, color_space)
    im = image.contents
    im.x0, im.y0 = offset
    im.x1 = offset[0] + (planes[0].shape[1] - 1) * sub[0][0] + 1
    im.y1 = offset[1] + (planes[0].shape[0] - 1) * sub[0][1] + 1
    for c, plane in enumerate(planes):
        a = np.ascontiguousarray(plane, np.int32)
        ctypes.memmove(im.comps[c].data, a.ctypes.data, a.nbytes)
    p = lib.Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    p.tcp_numlayers = len(layers) if layers else 1
    for k, rate in enumerate(layers or [0]):
        p.tcp_rates[k] = rate
    p.cp_disto_alloc = 1
    p.irreversible = int(irreversible)
    p.numresolution = numres
    if cblk:
        p.cblockw_init, p.cblockh_init = cblk
    p.mode = mode
    p.prog_order = J2K_PROGRESSIONS.index(progression)
    p.image_offset_x0, p.image_offset_y0 = offset
    if tiles:
        p.tile_size_on = 1
        p.cp_tdx, p.cp_tdy = tiles
        p.cp_tx0, p.cp_ty0 = tile_offset
    if precincts:
        p.csty |= 1
        p.res_spec = len(precincts)
        for k, (pw, ph) in enumerate(precincts):
            p.prcw_init[k], p.prch_init[k] = pw, ph
    p.csty |= csty
    if roi:
        p.roi_compno, p.roi_shift = roi
    for k, (r0, c0, l1, r1, c1, order) in enumerate(pocs):
        q = p.POC[k]
        q.resno0, q.compno0, q.layno1, q.resno1, q.compno1 = r0, c0, l1, r1, c1
        q.prg1 = J2K_PROGRESSIONS.index(order)
        q.tile = 1
    p.numpocs = len(pocs)
    p.tcp_mct = bytes([mct if mct is not None else int(n >= 3)])
    if tile_parts:
        p.tp_on, p.tp_flag = b"\x01", tile_parts.encode()
    if comment:
        p.cp_comment = comment
    codec = lib.opj_create_compress(0)
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    try:
        assert lib.opj_setup_encoder(codec, ctypes.byref(p), image)
        if extra:
            options = (ctypes.c_char_p * (len(extra) + 1))(*[e.encode() for e in extra], None)
            assert lib.opj_encoder_set_extra_options(codec, options)
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
              and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        with open(path, "rb") as f:
            data = f.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
        os.unlink(path)
    assert ok, "libopenjp2 refused the encode"
    return data


def pil_j2k(img: np.ndarray, mode: Optional[str] = None, **kw) -> bytes:
    """``img`` saved by Pillow's JPEG 2000 encoder (OpenJPEG) with ``kw``."""
    from PIL import Image

    out = io.BytesIO()
    if mode == "I;16":
        im = Image.frombuffer("I;16", img.shape[::-1], np.ascontiguousarray(img, "<u2").tobytes(), "raw", "I;16", 0, 1)
    else:
        im = Image.fromarray(img, mode) if mode else Image.fromarray(img)
    im.save(out, "JPEG2000", **kw)
    return out.getvalue()


def jp2_box(kind: bytes, body: bytes, xl: bool = False) -> bytes:
    """A JP2 box; ``xl`` writes its length in the 64-bit field."""
    if xl:
        return struct.pack(">I", 1) + kind + struct.pack(">Q", 16 + len(body)) + body
    return struct.pack(">I", 8 + len(body)) + kind + body


def colr(enumcs: int) -> bytes:
    return jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def jp2_file(codestream: bytes, size: Optional[Tuple[int, int]] = None, nc: Optional[int] = None, bpc: int = 7,
             boxes: Optional[bytes] = None, brand: bytes = b"jp2 ", xl: bool = False, after: bytes = b"") -> bytes:
    """A JP2 file around ``codestream``: the signature, ``ftyp``, ``jp2h``
    (``ihdr`` of ``size`` (w, h) and ``nc``, the codestream's by default,
    then ``boxes``: an sRGB or greyscale ``colr`` by default) and ``jp2c``
    (``xl``: its 64-bit length), then ``after``."""
    siz = struct.unpack_from(">HHIIIIIIIIH", codestream, 4)
    w, h = size or (siz[2] - siz[4], siz[3] - siz[5])
    nc = nc or siz[10]
    if boxes is None:
        boxes = colr(16 if nc >= 3 else 17)
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    return (_JP2_SIGNATURE + jp2_box(b"ftyp", brand + b"\0\0\0\0" + brand) + jp2_box(b"jp2h", ihdr + boxes)
            + jp2_box(b"jp2c", codestream, xl) + after)


def pclr(entries: List[Tuple[int, ...]], depth: int = 8) -> bytes:
    """A ``pclr`` box of ``entries`` (one tuple a colour) and its ``cmap``."""
    npc = len(entries[0])
    body = struct.pack(">HB", len(entries), npc) + bytes([depth - 1] * npc) + b"".join(bytes(e) for e in entries)
    return jp2_box(b"pclr", body) + jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(npc)))


def j2k_split(stream: bytes) -> Tuple[List[Tuple[int, bytes]], List[Tuple[List[Tuple[int, bytes]], bytes]]]:
    """A codestream's main header markers after SIZ ((marker, body) each,
    SIZ first) and its tile-parts ((header markers after SOT, SOT first),
    data), for the rewriters below."""
    at, main = 2, []
    while be16(stream, at) != 0xFF90:
        length = be16(stream, at + 2)
        main.append((be16(stream, at), stream[at + 4:at + 2 + length]))
        at += 2 + length
    parts = []
    while be16(stream, at) == 0xFF90:
        psot = struct.unpack_from(">I", stream, at + 6)[0]
        end = at + psot
        markers, k = [(0xFF90, stream[at + 4:at + 12])], at + 12
        while be16(stream, k) != 0xFF93:
            length = be16(stream, k + 2)
            markers.append((be16(stream, k), stream[k + 4:k + 2 + length]))
            k += 2 + length
        parts.append((markers, stream[k + 2:end]))
        at = end
    assert stream[at:] == b"\xff\xd9"
    return main, parts


def be16(data: bytes, at: int) -> int:
    return struct.unpack_from(">H", data, at)[0]


def j2k_join(main: List[Tuple[int, bytes]], parts: List[Tuple[List[Tuple[int, bytes]], bytes]]) -> bytes:
    """``j2k_split``'s parts as a codestream again, each Psot recomputed."""
    seg = lambda m, body: struct.pack(">HH", m, len(body) + 2) + body  # noqa: E731
    out = b"\xff\x4f" + b"".join(seg(m, b) for m, b in main)
    for markers, data in parts:
        rest = b"".join(seg(m, b) for m, b in markers[1:]) + b"\xff\x93" + data
        sot = bytearray(markers[0][1])
        struct.pack_into(">I", sot, 2, 12 + len(rest))
        out += seg(0xFF90, bytes(sot)) + rest
    return out + b"\xff\xd9"


def _packets(data: bytes) -> List[Tuple[bytes, bytes]]:
    """A tile-part's packets of a stream with SOP and EPH: (header with its
    EPH, body), each SOP dropped."""
    starts = [k for k in range(len(data) - 3) if data[k:k + 4] == b"\xff\x91\x00\x04"]
    out = []
    for n, k in enumerate(starts):
        end = starts[n + 1] if n + 1 < len(starts) else len(data)
        eph = data.index(b"\xff\x92", k + 6) + 2
        out.append((data[k + 6:eph], data[eph:end]))
    return out


def packed_headers(stream: bytes, where: str) -> bytes:
    """A codestream of SOP and EPH markers with its packet headers moved to
    a PPT marker in each tile-part header (``where`` "ppt"; Zppt counting a
    tile's markers) or to PPM markers in the main header ("ppm"), each
    packet's SOP kept before its body."""
    main, parts = j2k_split(stream)
    ppm, out_parts, zppt = b"", [], {}
    for markers, data in parts:
        packets = _packets(data)
        headers = b"".join(h for h, _ in packets)
        body = b"".join(b"\xff\x91\x00\x04" + struct.pack(">H", n) + b for n, (_, b) in enumerate(packets))
        if where == "ppt":  # Zppt counts a tile's PPT markers
            tile = be16(markers[0][1], 0)
            zppt[tile] = zppt.get(tile, -1) + 1
            markers = markers + [(0xFF61, bytes([zppt[tile]]) + headers)]
        else:
            ppm += struct.pack(">I", len(headers)) + headers
        out_parts.append((markers, body))
    if where == "ppm":
        main = main + [(0xFF60, b"\0" + ppm)]
    return j2k_join(main, out_parts)


def interleaved_tile_parts(stream: bytes) -> bytes:
    """A codestream of several tile-parts a tile with them taken in turn
    from each tile (the first of every tile, then the second...)."""
    main, parts = j2k_split(stream)
    by_tile: Dict[int, list] = {}
    for part in parts:
        by_tile.setdefault(be16(part[0][0][1], 0), []).append(part)
    out = []
    for k in range(max(len(v) for v in by_tile.values())):
        out += [v[k] for _, v in sorted(by_tile.items()) if k < len(v)]
    return j2k_join(main, out)


def with_markers(stream: bytes, main_extra=(), tile_extra=(), first=None) -> bytes:
    """``stream`` with ``main_extra`` (marker, body) appended to its main
    header and ``tile_extra`` to each tile-part header; ``first`` (marker,
    body) placed first after SIZ."""
    main, parts = j2k_split(stream)
    main = main[:1] + ([first] if first else []) + main[1:] + list(main_extra)
    return j2k_join(main, [(markers + list(tile_extra), data) for markers, data in parts])


def _j2k_planes(r, h: int, w: int, n: int, prec: int = 8, sgnd: bool = False) -> List[np.ndarray]:
    """n seeded components of smooth ramps and noise at ``prec`` bits."""
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for c in range(n):
        v = ((x * (3 + c) + y * (5 - c)) << max(0, prec - 8)) // 2 + r.integers(0, 1 << max(1, prec - 3), (h, w))
        v %= 1 << prec
        out.append(v - (1 << (prec - 1)) if sgnd else v)
    return out


def _j2k_pillow_layouts(r) -> Dict[str, bytes]:
    """What Pillow's encoder writes: each mode, 5/3 and 9/7, its layers,
    resolutions, code-block and precinct sizes, tiles and offsets, the five
    orders, MCT off, signed samples, PLT, a bare codestream and a
    comment."""
    rgb = smooth_scene(2600, 30, 41, cell=8, step=1)
    rgb = ((rgb.astype(np.int64) + r.integers(0, 24, rgb.shape)) % 256).astype(np.uint8)
    gray = rgb[..., 1]
    out = {
        "pil-rgb-53.jp2": pil_j2k(rgb),
        "pil-rgb-97.jp2": pil_j2k(rgb, irreversible=True),
        "pil-rgb-97-layers-rates.j2k": pil_j2k(rgb, irreversible=True, quality_mode="rates",
                                                quality_layers=[40, 12, 4], no_jp2=True),
        "pil-rgb-97-layers-db.jp2": pil_j2k(rgb, irreversible=True, quality_mode="dB", quality_layers=[28, 36, 44]),
        "pil-rgb-one-resolution.jp2": pil_j2k(rgb, num_resolutions=1),
        "pil-rgb-two-resolutions-97.jp2": pil_j2k(rgb, num_resolutions=2, irreversible=True),
        "pil-rgb-codeblocks-8x32.jp2": pil_j2k(rgb, codeblock_size=(8, 32)),
        "pil-rgb-tiles-offsets.jp2": pil_j2k(rgb, tile_size=(16, 12), tile_offset=(3, 2), offset=(5, 7),
                                             irreversible=True),
        "pil-rgb-mct-off-97.jp2": pil_j2k(rgb, mct=0, irreversible=True),
        "pil-rgb-plt.j2k": pil_j2k(rgb, plt=True, no_jp2=True, quality_layers=[20, 5], quality_mode="rates"),
        "pil-rgb-comment.jp2": pil_j2k(rgb, comment="written by Pillow"),
        "pil-l-53.j2k": pil_j2k(gray, "L", no_jp2=True),
        "pil-l-97.jp2": pil_j2k(gray, "L", irreversible=True),
        "pil-la-53.jp2": pil_j2k(np.stack([gray, rgb[..., 2]], -1), "LA"),
        "pil-rgba-97.jp2": pil_j2k(with_alpha(rgb), "RGBA", irreversible=True),
        "pil-i16-53.jp2": pil_j2k(gray.astype(np.uint16) * 181 + 7, "I;16"),
        "pil-i16-97.j2k": pil_j2k(gray.astype(np.uint16) * 97, "I;16", irreversible=True, no_jp2=True),
        "pil-rgb-signed-53.jp2": pil_j2k(rgb, signed=True),
        "pil-l-signed-97.j2k": pil_j2k(gray, "L", signed=True, irreversible=True, no_jp2=True),
    }
    for order in J2K_PROGRESSIONS:
        out[f"pil-rgb-{order.lower()}-precincts.jp2"] = pil_j2k(
            rgb, progression=order, num_resolutions=3, precinct_size=(16, 16), codeblock_size=(8, 8),
            quality_layers=[30, 10], quality_mode="rates", irreversible=order in ("RPCL", "CPRL"))
    return out


def _j2k_openjpeg_layouts(r) -> Dict[str, bytes]:
    """What libopenjp2's encoder writes beyond Pillow's options: each
    code-block style flag and all of them, POC, RGN, SOP and EPH,
    tile-parts by resolution, layer and component with TLM, PLT, a
    digital-cinema frame's coding choices, 1- to 16-bit samples unsigned
    and signed, components of other depths (QCC) and subsampled ones (an
    unspecified space Pillow takes for YCbCr)."""
    rgb = _j2k_planes(r, 26, 35, 3)
    out = {}
    styles = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "erterm": 16, "segsym": 32, "all": 63}
    for name, flags in styles.items():
        out[f"opj-style-{name}-53.j2k"] = opj_stream(rgb, mode=flags, layers=[8, 2, 1])
        out[f"opj-style-{name}-97.j2k"] = opj_stream(rgb, mode=flags, irreversible=True, layers=[16, 4, 1])
    out["opj-poc.j2k"] = opj_stream(rgb, layers=[10, 3], pocs=[(0, 0, 1, 3, 3, "RLCP"), (0, 0, 2, 3, 3, "CPRL")])
    out["opj-rgn-53.j2k"] = opj_stream(rgb, roi=(0, 6))
    out["opj-rgn-97.j2k"] = opj_stream(rgb, roi=(2, 9), irreversible=True, layers=[12, 3])
    out["opj-sop-eph.j2k"] = opj_stream(rgb, csty=6, layers=[10, 3, 1], mode=1)
    for kind in "RLC":
        out[f"opj-tile-parts-{kind}-tlm.j2k"] = opj_stream(rgb, tiles=(16, 16), tile_parts=kind, layers=[8, 2],
                                                            extra=("TLM=YES",))
    out["opj-plt-tiles.j2k"] = opj_stream(rgb, tiles=(16, 16), irreversible=True, extra=("PLT=YES",))
    # a digital-cinema frame's coding choices (Pillow's cinema_mode fails to encode here): 12-bit samples, no
    # component transform, 9/7, CPRL, 32 x 32 code-blocks, 256/128 px precincts, a tile-part a component, TLM
    out["opj-dcp-like-12bit-cprl.j2k"] = opj_stream(
        _j2k_planes(r, 40, 56, 3, 12), prec=12, mct=0, irreversible=True, progression="CPRL", cblk=(32, 32),
        precincts=[(256, 256), (128, 128), (128, 128)], tile_parts="C", extra=("TLM=YES",), layers=[20])
    out["opj-big-codeblocks-1024x4.j2k"] = opj_stream(rgb, cblk=(1024, 4))
    out["opj-odd-offsets-tiles.j2k"] = opj_stream(rgb, offset=(5, 3), tiles=(7, 11), tile_offset=(2, 1),
                                                  irreversible=True, numres=2)
    for prec in (1, 2, 4, 5, 9, 12, 16):
        for sgnd in (False, True):
            tag = f"{prec}bit{'-signed' if sgnd else ''}"
            out[f"opj-gray-{tag}.j2k"] = opj_stream(_j2k_planes(r, 13, 17, 1, prec, sgnd), prec=prec, sgnd=sgnd)
            out[f"opj-rgb-{tag}.j2k"] = opj_stream(_j2k_planes(r, 13, 17, 3, prec, sgnd), prec=prec, sgnd=sgnd,
                                                   irreversible=prec % 2 == 0)
    out["opj-mixed-depths-qcc.j2k"] = opj_stream(
        [_j2k_planes(r, 13, 17, 1, p)[0] for p in (8, 4, 12, 1)], prec=[8, 4, 12, 1])
    for name, sub in (("420", [(1, 1), (2, 2), (2, 2)]), ("422", [(1, 1), (2, 1), (2, 1)]),
                      ("440", [(1, 1), (1, 2), (1, 2)]), ("411-odd", [(1, 1), (3, 3), (3, 3)]),
                      ("all-2x2", [(2, 2), (2, 2), (2, 2)])):
        planes = [_j2k_planes(r, -(-26 // dy), -(-35 // dx), 1)[0] for dx, dy in sub]
        out[f"opj-sub-{name}.j2k"] = opj_stream(planes, sub=sub, mct=0)
        out[f"opj-sub-{name}-offset-97.j2k"] = opj_stream(planes, sub=sub, mct=0, offset=(3, 5), irreversible=True)
    planes = [_j2k_planes(r, 26, 35, 1)[0]] + [_j2k_planes(r, 13, 18, 1)[0] for _ in range(2)]
    out["opj-sub-420-alpha.j2k"] = opj_stream(planes + [_j2k_planes(r, 26, 35, 1)[0]],
                                              sub=[(1, 1), (2, 2), (2, 2), (1, 1)], mct=0)
    return out


def _j2k_rewritten_layouts(r) -> Dict[str, bytes]:
    """Markers no encoder here writes, put into written streams: packet
    headers in PPT and PPM, a restated COC and QCC, CRG, PLM, COM in a
    tile-part header, an unknown main-header marker, tile-parts taken in
    turn from each tile; and the orders OpenJPEG's reading decides (its
    own seed): a tile-part COD after a main COC of another style (the COD
    wins), a QCC before and after a QCD (the later wins), a tile-part QCD
    after a main QCC, POC in the main header alone and in both headers,
    PPT over several tile-parts a tile taken in turn; a QCD of scalar
    derived quantization."""
    rgb = _j2k_planes(r, 26, 35, 3)
    sop_eph = opj_stream(rgb, csty=6, layers=[10, 3, 1], tiles=(16, 16))
    tiled_parts = opj_stream(rgb, tiles=(16, 16), tile_parts="R", irreversible=True)
    plain = opj_stream(rgb)
    main, _ = j2k_split(plain)
    cod = dict(main)[0xFF52]
    qcd = dict(main)[0xFF5C]
    return {
        "rw-ppt.j2k": packed_headers(sop_eph, "ppt"),
        "rw-ppm.j2k": packed_headers(sop_eph, "ppm"),
        "rw-coc-qcc-restated.j2k": with_markers(plain, [(0xFF53, b"\1" + bytes([cod[0] & 1]) + cod[5:]),
                                                        (0xFF5D, b"\2" + qcd)]),
        "rw-crg-plm-com.j2k": with_markers(plain, [(0xFF63, bytes(12)), (0xFF57, b"\0\1\5"),
                                                   (0xFF64, b"\0\1main")], [(0xFF64, b"\0\1tile-part")]),
        "rw-unknown-marker.j2k": with_markers(plain, [(0xFF6F, b"\x12\x34\x56\x78")]),
        "rw-tile-parts-in-turn.j2k": interleaved_tile_parts(tiled_parts),
        **_j2k_reading_orders(np.random.default_rng(2605)),
    }


def _j2k_reading_orders(r) -> Dict[str, bytes]:
    rgb = _j2k_planes(r, 26, 35, 3)
    main, parts = j2k_split(opj_stream(rgb, layers=[10, 3]))
    cod, qcd = dict(main)[0xFF52], dict(main)[0xFF5C]
    coc_bypass = b"\1" + bytes([cod[0] & 1]) + cod[5:8] + bytes([cod[8] | 1]) + cod[9:]
    qcc = b"\1" + bytes([(qcd[0] & 0x1F) | (((qcd[0] >> 5) + 1) << 5)]) + qcd[1:]  # one more guard bit
    no_qcd = [m for m in main if m[0] != 0xFF5C]
    poc_main, poc_parts = j2k_split(opj_stream(rgb, layers=[10, 3], pocs=[(0, 0, 1, 3, 3, "RLCP"),
                                                                           (0, 0, 2, 3, 3, "CPRL")]))
    poc = next(b for m, b in poc_parts[0][0] if m == 0xFF5F)
    tile_parts = opj_stream(rgb, csty=6, layers=[10, 3, 1], tiles=(16, 16), tile_parts="R")
    return {
        "rw-tile-cod-after-main-coc.j2k": j2k_join(main + [(0xFF53, coc_bypass)],
                                                   [(m + [(0xFF52, cod)], d) for m, d in parts]),
        "rw-qcc-before-qcd.j2k": j2k_join(no_qcd + [(0xFF5D, qcc), (0xFF5C, qcd)], parts),
        "rw-qcd-before-qcc.j2k": j2k_join(no_qcd + [(0xFF5C, qcd), (0xFF5D, qcc)], parts),
        "rw-tile-qcd-after-main-qcc.j2k": j2k_join(no_qcd + [(0xFF5C, qcd), (0xFF5D, qcc)],
                                                   [(m + [(0xFF5C, qcd)], d) for m, d in parts]),
        "rw-poc-main.j2k": j2k_join(poc_main + [(0xFF5F, poc)],
                                    [([x for x in m if x[0] != 0xFF5F], d) for m, d in poc_parts]),
        "rw-poc-main-and-tile.j2k": j2k_join(poc_main + [(0xFF5F, poc)], poc_parts),
        "rw-ppt-tile-parts-in-turn.j2k": interleaved_tile_parts(packed_headers(tile_parts, "ppt")),
        **_j2k_derived_quantization(np.random.default_rng(2606)),
    }


def _j2k_derived_quantization(r) -> Dict[str, bytes]:
    """A 9/7 stream's QCD rewritten to scalar derived quantization (its LL
    band's step alone; no encoder here writes one)."""
    main, parts = j2k_split(opj_stream(_j2k_planes(r, 26, 35, 3), layers=[12, 4], irreversible=True))
    qcd = dict(main)[0xFF5C]
    derived = bytes([(qcd[0] & 0xE0) | 1]) + qcd[1:3]
    return {"rw-qcd-scalar-derived.j2k": j2k_join([(m, derived if m == 0xFF5C else b) for m, b in main], parts)}


def _j2k_box_layouts(r) -> Dict[str, bytes]:
    """JP2 boxes: palettes (P and PA; colours repeated, one, two and four
    columns), cdef, res with resc, an ICC profile, an unknown enumerated
    space, sYCC, CMYK, a greyscale colr on a three-component ihdr, bpcc,
    an XL jp2c box and bytes after it."""
    gray = _j2k_planes(r, 12, 15, 1)[0]
    rgb = _j2k_planes(r, 12, 15, 3)
    idx = r.integers(0, 6, (12, 15))
    cs_idx = opj_stream([idx], numres=2)
    cs_pa = opj_stream([idx, gray], numres=2)
    cs_gray, cs_rgb = opj_stream([gray], numres=2), opj_stream(rgb, numres=2)
    colours = [(255, 0, 0), (0, 200, 0), (255, 0, 0), (0, 0, 250), (9, 9, 9), (0, 200, 0)]
    srgb = colr(16)
    cmyk = opj_stream(_j2k_planes(r, 12, 15, 4), numres=2, mct=0)
    sycc = opj_stream([rgb[0], rgb[1][::2, ::2], rgb[2][::2, ::2]], sub=[(1, 1), (2, 2), (2, 2)], mct=0, numres=2)
    return {
        "box-pclr-p.jp2": jp2_file(cs_idx, boxes=srgb + pclr(colours)),
        "box-pclr-pa.jp2": jp2_file(cs_pa, boxes=srgb + pclr(colours)),
        "box-pclr-one-column.jp2": jp2_file(cs_idx, boxes=srgb + pclr([(k * 40,) for k in range(6)])),
        "box-pclr-two-columns.jp2": jp2_file(cs_idx, boxes=srgb + pclr([(k * 40, 7) for k in range(6)])),
        "box-pclr-rgba.jp2": jp2_file(cs_idx, boxes=srgb + pclr([c + (128,) for c in colours])),
        "box-cdef-res.jp2": jp2_file(cs_rgb, boxes=srgb + jp2_box(b"cdef", struct.pack(">HHHHHHHHHH", 3, 0, 0, 1, 1, 0,
                                                                                        2, 2, 0, 3)) +
                                     jp2_box(b"res ", jp2_box(b"resc", struct.pack(">HHHHBB", 72, 1, 72, 1, 0, 0)))),
        "box-icc.jp2": jp2_file(cs_rgb, boxes=jp2_box(b"colr", b"\2\0\0" + bytes(32))),
        "box-enumcs-unknown.jp2": jp2_file(cs_gray, boxes=colr(99)),
        "box-sycc-420.jp2": jp2_file(sycc, boxes=colr(18)),
        "box-cmyk.jp2": jp2_file(cmyk, boxes=colr(12)),
        "box-gray-colr-three-ihdr.jp2": jp2_file(cs_gray, nc=3, boxes=colr(17)),
        "box-bpcc.jp2": jp2_file(cs_gray, bpc=255, boxes=jp2_box(b"bpcc", b"\7") + colr(17)),
        "box-xl-jp2c-and-after.jp2": jp2_file(cs_rgb, xl=True, after=jp2_box(b"xml ", b"<x/>")),
    }


def _j2k_icns_layouts(r) -> Dict[str, bytes]:
    """ICNS files whose element is a JPEG 2000 stream, of each mode."""
    rgb = smooth_scene(2610, 32, 32, cell=8, step=1)
    return {
        "icns-icp5-jp2-rgb.icns": icns_file([(b"icp5", pil_j2k(rgb, num_resolutions=3))]),
        "icns-icp4-j2k-l.icns": icns_file([(b"icp4", pil_j2k(rgb[:16, :16, 0], "L", no_jp2=True,
                                                             num_resolutions=2))]),
        "icns-ic11-jp2-rgba-97.icns": icns_file([(b"ic11", pil_j2k(with_alpha(rgb), "RGBA", irreversible=True,
                                                                   num_resolutions=3))]),
        "icns-icp5-jp2-i16.icns": icns_file([(b"icp5", pil_j2k(rgb[..., 0].astype(np.uint16) * 2, "I;16",
                                                               num_resolutions=3))]),
    }


def j2k_layouts() -> Dict[str, bytes]:
    """Every committed file of ``jpeg2000/`` the port reads (name under
    ``jpeg2000/`` -> bytes)."""
    r = np.random.default_rng(2601)
    out = {**_j2k_pillow_layouts(r), **_j2k_openjpeg_layouts(r), **_j2k_rewritten_layouts(r), **_j2k_box_layouts(r),
           **_j2k_icns_layouts(r)}
    return {f"{J2K}/{k}": v for k, v in sorted(out.items())}


def j2k_refusals() -> Dict[str, Tuple[bytes, str]]:
    """Files of this slice the port refuses (name -> (bytes, the reason its
    error names, a regular expression)): those Pillow refuses too, and
    HTJ2K code-blocks, which OpenJPEG decodes and the port leaves out by
    name."""
    r = np.random.default_rng(2620)
    rgb = smooth_scene(2621, 30, 41, cell=8, step=1)
    c53, c97 = pil_j2k(rgb, no_jp2=True), pil_j2k(rgb, irreversible=True, no_jp2=True)
    gray = opj_stream(_j2k_planes(r, 12, 15, 1), numres=2)
    five = opj_stream(_j2k_planes(r, 12, 15, 5), numres=2, mct=0)
    broken = "broken data stream"
    sop_eph = opj_stream(_j2k_planes(r, 12, 15, 3), csty=6, numres=2)
    eph = sop_eph.rindex(b"\xff\x92")
    siz = bytearray(gray)
    siz[6] |= 0x40  # Rsiz: Part 15
    ht = with_markers(bytes(siz), first=(0xFF50, struct.pack(">IH", 1 << 17, 0)))
    cod_at = ht.index(b"\xff\x52")
    ht = ht[:cod_at + 12] + bytes([ht[cod_at + 12] | 0x40]) + ht[cod_at + 13:]  # SPcod's code-block style
    return {
        "cut-60-53.j2k": (c53[:len(c53) * 6 // 10], broken),
        "cut-95-97.j2k": (c97[:len(c97) * 95 // 100], broken),
        "cut-95-53.jp2": (jp2_file(c53)[:len(jp2_file(c53)) * 95 // 100], broken),
        "no-eoc.j2k": (c53[:-2], broken),
        "no-eph.j2k": (sop_eph[:eph] + b"\0\0" + sop_eph[eph + 2:], broken),
        "five-components.j2k": (five, "unable to determine J2K image mode"),
        "ihdr-wider.jp2": (jp2_file(gray, size=(16, 12)), broken),
        "colr-sycc-on-gray.jp2": (jp2_file(gray, boxes=colr(18)), "no unpacker"),
        "colr-eycc-on-gray.jp2": (jp2_file(gray, boxes=colr(24)), "no unpacker"),
        "colr-cmyk-on-rgb.jp2": (jp2_file(opj_stream(_j2k_planes(r, 12, 15, 3), numres=2), boxes=colr(12)),
                                 "no unpacker"),
        "pclr-on-greyscale-colr.jp2": (jp2_file(opj_stream([r.integers(0, 4, (12, 15))], numres=2),
                                                boxes=colr(17) + pclr([(1, 2, 3)] * 4)), "no unpacker"),
        "pclr-300-colours.jp2": (jp2_file(gray, boxes=colr(16) + pclr([(k % 256, k // 256, 0) for k in range(300)])),
                                 "cannot allocate more than 256 colors"),
        # Pillow's precincts halve at each level down to 1 px, which OpenJPEG's decoder refuses
        "precincts-down-to-one.jp2": (pil_j2k(smooth_scene(2622, 64, 64), precinct_size=(16, 16)), broken),
        "not-a-jp2.jp2": (_JP2_SIGNATURE + bytes(12), "unknown format|does not identify"),
        # OpenJPEG reads the PPM headers in its tiles' decoding order, not in the tile-parts' order
        "ppm-tile-parts-in-turn.j2k": (packed_headers(interleaved_tile_parts(opj_stream(
            _j2k_planes(r, 26, 35, 3), csty=6, layers=[10, 3, 1], tiles=(16, 16), tile_parts="R")), "ppm"),
            broken),
        "htj2k.j2k": (ht, "HTJ2K"),
        "part2-mct-marker.j2k": (with_markers(gray, [(0xFF74, b"\0\0" + bytes(8))]), "Part 2"),
        "icns-element-jp2-box-alone.icns": (icns_file([(b"ic07", b"\x0d\x0a\x87\x0a" + bytes(20))]),
                                            "does not open"),
        "icns-element-of-other-size.icns": (icns_file([(b"icp5", pil_j2k(rgb[:24, :24], num_resolutions=2))]),
                                            "none of its sizes"),
    }


def j2k_card_photo() -> np.ndarray:
    return smooth_scene(2630, 1024, 1024, cell=64, step=1)


def j2k_card_originals() -> Dict[str, bytes]:
    """The card's originals of ``J2K_CARD``, all committed: name (under
    ``jpeg2000/card/``) -> bytes as Pillow's encoder writes them."""
    photo = j2k_card_photo()
    icon = smooth_scene(2631, 128, 128, cell=16, step=1)
    out = {
        "photo-1024-53.j2k": pil_j2k(photo, no_jp2=True),
        "photo-1024-97-layers.jp2": pil_j2k(photo, irreversible=True, quality_mode="rates",
                                            quality_layers=[40, 20, 10]),
        "photo-1024-97-rpcl-tiles.jp2": pil_j2k(photo, irreversible=True, quality_mode="rates",
                                                quality_layers=[20, 10], tile_size=(256, 256), progression="RPCL",
                                                precinct_size=(64, 64), num_resolutions=5),
        "icon-128-jpeg2000.icns": icns_file([(b"ic07", pil_j2k(icon, irreversible=True, quality_mode="rates",
                                                               quality_layers=[8]))]),
    }
    assert sorted(out) == sorted(J2K_CARD)
    return {f"{J2K}/card/{k}": v for k, v in out.items()}


def j2k_fixtures() -> Dict[str, bytes]:
    """Every committed file under ``jpeg2000/`` (name -> bytes), written
    anew: the layouts, the refusals and the card's originals."""
    refused = {f"{J2K}/refused/{k}": v for k, (v, _) in j2k_refusals().items()}
    return dict(sorted({**j2k_layouts(), **refused, **j2k_card_originals()}.items()))


def committed_j2k() -> Dict[str, bytes]:
    """The committed files under ``jpeg2000/``: name -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, J2K)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def j2k_manifest(scratch: str, files: Optional[Dict[str, bytes]] = None) -> dict:
    """The manifest's entries of this folder: each committed file as
    ``gif_tiff_entry`` records it with ``j2k_refusals``."""
    files = committed_j2k() if files is None else files
    reasons = j2k_refusals()
    entries = {}
    for name, data in files.items():
        path = os.path.join(scratch, "j2k" + os.path.splitext(name)[1])
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = gif_tiff_entry(name, path, reasons)
    return {"files": entries}


def check_j2k_card(decode: Callable[[str], np.ndarray]) -> Dict[str, str]:
    """Holds each committed card original of ``J2K_CARD`` to the manifest:
    bytes and ``decode``'s RGB.  Returns name -> path of each; raises
    ``AssertionError`` naming the first that differs."""
    manifest = load_manifest()["files"]
    paths = {}
    for name in sorted(J2K_CARD):
        key = f"{J2K}/card/{name}"
        path = os.path.join(FIXTURES, key)
        with open(path, "rb") as f:
            if sha256(f.read()) != manifest[key]["sha256"]:
                raise AssertionError(f"{key}: the file is not the one the manifest records")
        got = decode(path)
        if list(got.shape[:2]) != manifest[key]["shape"] or sha256(got) != manifest[key]["sha256_rgb"]:
            raise AssertionError(f"{key}: decoded to other pixels than Pillow's")
        paths[name] = path
    return paths


# --- AVIF: the JAX package's Pillow lane through libavif and dav1d ------------------------------------

AVIF = "avif"  # their files' folder under FIXTURES
#: the card's originals (under ``avif/card/``, committed: the card's machine
#: has no AVIF writer), each by the listed name cli.prep reads it under, or
#: None for one only decoded and timed
AVIF_CARD = {"photo-1024.avif": "photo-1024-avif.jpg",
             "photo-1024-444-cdef-lr-sb128-tiles.avif": "photo-1024-avif444.png",
             "screen-1024-palette.avif": "screen-1024-avif.png",
             "photo-512-premultiplied.avif": "photo-512-avif-prem.jpg",
             # decoded and timed only (None: not among cli.prep's originals)
             "screen-1024-intrabc.avif": None,
             "photo-1024-10bit.avif": None}
#: the alpha auxiliary type libavif writes
AVIF_ALPHA_URN = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"


def pil_avif(img: np.ndarray, **kw) -> bytes:
    """``img`` (RGB or RGBA) saved by Pillow's AVIF encoder (libavif over
    aom) with ``kw``."""
    from PIL import Image

    f = io.BytesIO()
    Image.fromarray(img).save(f, "AVIF", **kw)
    return f.getvalue()


#: the system's libavif (0.11.1, its encoder libaom 3.6.0 built for 10- and
#: 12-bit samples; Pillow's bundled libavif carries an aom of 8 bits alone)
SYSTEM_LIBAVIF = "libavif.so.15"
#: avifPixelFormat of each subsampling
_AVIF_FORMATS = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3, "4:0:0": 4}


def deep_planes(seed: int, h: int, w: int, depth: int, subsampling: str = "4:2:0") -> List[np.ndarray]:
    """Y, U and V planes (uint16, U and V subsampled, none in 4:0:0) of
    ``depth`` bits: a smooth scene's BT.601 luma and chroma widened to that
    depth, a seeded fine noise in the low bits and a few flat bars."""
    r = np.random.default_rng(seed)
    rgb = smooth_scene(seed, h, w, cell=max(8, min(h, w) // 3), step=1).astype(np.float64)
    top = (1 << depth) - 1
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    u = (rgb[..., 2] - y) / 1.772 + 128
    v = (rgb[..., 0] - y) / 1.402 + 128
    out = []
    for k, p in enumerate((y, u, v) if subsampling != "4:0:0" else (y,)):
        p = p * top / 255 + r.normal(0, 1 << (depth - 8), (h, w))
        bar = int(r.integers(0, max(1, h - 6)))
        p[bar:bar + 6] = r.integers(0, top + 1)
        if k and subsampling != "4:4:4":
            sy = 2 if subsampling == "4:2:0" else 1
            p = np.pad(p, ((0, h % sy), (0, w % 2)), mode="edge")
            p = p.reshape(p.shape[0] // sy, sy, p.shape[1] // 2, 2).mean(axis=(1, 3))
        out.append(np.clip(np.rint(p), 0, top).astype(np.uint16))
    return out


def deep_avif(planes: List[np.ndarray], depth: int, subsampling: str = "4:2:0", full: bool = True,
              cicp: Tuple[int, int, int] = (2, 2, 2), alpha: Optional[np.ndarray] = None, premultiplied: bool = False,
              quantizer: int = 24, speed: int = 6, tiles_log2: Tuple[int, int] = (0, 0),
              advanced: Optional[Dict[str, str]] = None) -> bytes:
    """An AVIF of ``planes`` (``deep_planes``' Y, U, V of ``depth`` bits)
    written by the system's libavif over libaom through ctypes: ``full`` or
    limited range, ``cicp`` (primaries, transfer, matrix), an alpha plane of
    the same depth, premultiplied or not, quantizer (0-63, the encoder's
    min and max), speed, tile rows and columns (log2), and aom options."""
    lib = ctypes.CDLL(SYSTEM_LIBAVIF)
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageAllocatePlanes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.avifEncoderCreate.restype = ctypes.c_void_p
    lib.avifEncoderAddImage.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
    lib.avifEncoderFinish.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.avifEncoderSetCodecSpecificOption.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.avifEncoderSetCodecSpecificOption.restype = None
    for name in ("avifImageDestroy", "avifEncoderDestroy", "avifRWDataFree"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    h, w = planes[0].shape
    img = lib.avifImageCreate(w, h, depth, _AVIF_FORMATS[subsampling])
    # avifImage (0.11.1): yuvRange at 16, yuvPlanes at 24, yuvRowBytes at 48,
    # alphaPlane at 64, alphaRowBytes at 72, alphaPremultiplied at 80, CICP at 104.
    ctypes.c_uint32.from_address(img + 16).value = int(full)
    ctypes.c_int32.from_address(img + 80).value = int(premultiplied)
    for k, v in enumerate(cicp):
        ctypes.c_uint16.from_address(img + 104 + 2 * k).value = v
    enc = None
    try:
        if lib.avifImageAllocatePlanes(img, 0xFF if alpha is not None else 1):
            raise OSError("avifImageAllocatePlanes failed")
        for k, p in enumerate(list(planes) + ([alpha] if alpha is not None else [])):
            at, rb_at = (24 + 8 * k, 48 + 4 * k) if k < len(planes) else (64, 72)
            rb = ctypes.c_uint32.from_address(img + rb_at).value
            buf = (ctypes.c_uint8 * (rb * p.shape[0])).from_address(ctypes.c_uint64.from_address(img + at).value)
            kind = np.uint16 if depth > 8 else np.uint8
            np.frombuffer(buf, kind).reshape(p.shape[0], -1)[:, :p.shape[1]] = p
        enc = lib.avifEncoderCreate()
        # avifEncoder (0.11.1): codecChoice (1, aom) at 0, maxThreads at 4,
        # speed at 8, min/max quantizer (and of alpha) at 24-36, tile rows
        # and columns (log2) at 40 and 44.
        for off, v in ((0, 1), (4, 1), (8, speed), (24, quantizer), (28, quantizer), (32, quantizer), (36, quantizer),
                       (40, tiles_log2[0]), (44, tiles_log2[1])):
            ctypes.c_int32.from_address(enc + off).value = v
        for key, value in (advanced or {}).items():  # aom checks each as it starts
            lib.avifEncoderSetCodecSpecificOption(enc, key.encode(), value.encode())
        rc = lib.avifEncoderAddImage(enc, img, 1, 2)  # AVIF_ADD_IMAGE_FLAG_SINGLE
        out = (ctypes.c_uint64 * 2)()
        if rc or lib.avifEncoderFinish(enc, out):
            raise OSError(f"libavif's encoder failed ({rc})")
        data = ctypes.string_at(out[0], out[1])
        lib.avifRWDataFree(out)
        return data
    finally:
        if enc:
            lib.avifEncoderDestroy(enc)
        lib.avifImageDestroy(img)


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + payload)


def avif_parts(data: bytes) -> dict:
    """A single-image AVIF's parts as Pillow writes it: the primary (colour)
    item's AV1 stream and av1C, the alpha item's if any, the size and the
    colour item's colr boxes."""
    def boxes(at, end):
        while at < end:
            size, kind = struct.unpack(">I4s", data[at:at + 8])
            yield kind, at + 8, at + size
            at += size

    meta = next((a, z) for k, a, z in boxes(0, len(data)) if k == b"meta")
    items, props, assoc, refs = {}, [], {}, []
    for k, a, z in boxes(meta[0] + 4, meta[1]):
        if k == b"iloc":
            version = data[a]
            p = a + 6
            count = struct.unpack(">H", data[p:p + 2])[0]
            p += 2
            sizes = data[a + 4:a + 6]
            osz, lsz, bsz = sizes[0] >> 4, sizes[0] & 15, sizes[1] >> 4
            for _ in range(count):
                item = struct.unpack(">H", data[p:p + 2])[0]
                p += 2 + (2 if version in (1, 2) else 0) + 2
                base = int.from_bytes(data[p:p + bsz], "big")
                p += bsz
                ext = []
                for _ in range(struct.unpack(">H", data[p:p + 2])[0]):
                    p += 2
                    off = int.from_bytes(data[p:p + osz], "big")
                    length = int.from_bytes(data[p + osz:p + osz + lsz], "big")
                    p += osz + lsz
                    ext.append((base + off, length))
                items[item] = b"".join(data[o:o + n] for o, n in ext)
        elif k == b"iprp":
            for k2, a2, z2 in boxes(a, z):
                if k2 == b"ipco":
                    props = [(k3, data[a3:z3]) for k3, a3, z3 in boxes(a2, z2)]
                elif k2 == b"ipma":
                    p = a2 + 8
                    for _ in range(struct.unpack(">I", data[a2 + 4:a2 + 8])[0]):
                        item, n = struct.unpack(">HB", data[p:p + 3])
                        assoc[item] = [data[p + 3 + i] & 0x7F for i in range(n)]
                        p += 3 + n
        elif k == b"iref":
            for k2, a2, z2 in boxes(a + 4, z):
                refs.append((k2, struct.unpack(">H", data[a2:a2 + 2])[0]))
        elif k == b"pitm":
            primary = struct.unpack(">H", data[a + 4:a + 6])[0]

    def prop(item, kind):
        return next((props[i - 1][1] for i in assoc.get(item, ()) if props[i - 1][0] == kind), None)

    alpha = next((src for kind, src in refs if kind == b"auxl"), None)
    w, h = struct.unpack(">II", prop(primary, b"ispe")[4:12])
    return {"color": items[primary], "av1c": prop(primary, b"av1C"), "size": (w, h),
            "colr": [props[i - 1][1] for i in assoc.get(primary, ()) if props[i - 1][0] == b"colr"],
            "alpha": items.get(alpha), "alpha_av1c": prop(alpha, b"av1C") if alpha else None}


def nclx(cp: int, tc: int, mc: int, full: bool = True) -> bytes:
    """A colr box's payload of type nclx."""
    return b"nclx" + struct.pack(">HHHB", cp, tc, mc, 0x80 if full else 0)


def avif_file(color: bytes, av1c: bytes, size: Tuple[int, int], alpha: Optional[bytes] = None,
              alpha_av1c: Optional[bytes] = None, prem: bool = False, colr: Tuple[bytes, ...] = (),
              extra_props: Tuple[Tuple[bytes, bytes], ...] = (), iloc_version: int = 0, idat: bool = False,
              split: int = 1, infe_version: int = 2, major: bytes = b"avif",
              brands: Tuple[bytes, ...] = (b"avif", b"mif1", b"miaf"), exif: Optional[bytes] = None,
              grid: Optional[Tuple[int, int, List[bytes]]] = None, large_mdat: bool = False) -> bytes:
    """An AVIF file this module writes around AV1 streams: item 1 the colour
    image (or, with ``grid`` (rows, columns, tiles), a grid of av01 tiles
    2...), an alpha item with its auxC (``alpha``, 'prem' with ``prem``),
    an Exif item ('cdsc'); properties ispe, pixi, av1C, ``colr`` (each a
    colr payload) and ``extra_props`` (kind, payload); iloc of
    ``iloc_version``, the colour item in ``split`` extents, in an idat box
    with ``idat`` (construction method 1), infe of ``infe_version``; an
    mdat box of 64-bit size with ``large_mdat``."""
    w, h = size
    items = []  # (id, type, payload, hidden)
    if grid:
        rows, cols, tiles = grid
        payload = struct.pack(">BBBBHH", 0, 0, rows - 1, cols - 1, w, h)
        items.append((1, b"grid", payload, False))
        items += [(2 + i, b"av01", t, True) for i, t in enumerate(tiles)]
    else:
        items.append((1, b"av01", color, False))
    alpha_id = exif_id = None
    if alpha is not None:
        alpha_id = len(items) + 1
        items.append((alpha_id, b"av01", alpha, False))
    if exif is not None:
        exif_id = len(items) + 1
        items.append((exif_id, b"Exif", exif, False))
    # properties
    prop_list = []

    def prop(kind, payload):
        prop_list.append(_box(kind, payload))
        return len(prop_list)

    ispe = prop(b"ispe", struct.pack(">III", 0, w, h))
    depth = 12 if av1c[2] & 0x20 else 10 if av1c[2] & 0x40 else 8
    pixi = prop(b"pixi", struct.pack(">IB", 0, 3) + bytes([depth] * 3))
    av1 = prop(b"av1C", av1c)
    colr_ids = [prop(b"colr", c) for c in colr]
    # transformative properties and lsel are essential, as libavif requires
    extra_ids = [prop(k, p) | (0x80 if k in (b"irot", b"imir", b"clap", b"lsel") else 0) for k, p in extra_props]
    assoc = {1: [ispe, pixi] + ([] if grid else [0x80 | av1]) + colr_ids + extra_ids}
    if grid:
        tw, th = struct.unpack(">II", grid[2][0][:0] or b"\0" * 8) if False else (w // grid[1], h // grid[0])
        tile_ispe = prop(b"ispe", struct.pack(">III", 0, tw, th))
        for i in range(len(grid[2])):
            assoc[2 + i] = [tile_ispe, pixi, 0x80 | av1]
    if alpha is not None:
        a_depth = 12 if alpha_av1c[2] & 0x20 else 10 if alpha_av1c[2] & 0x40 else 8
        a_pixi = prop(b"pixi", struct.pack(">IB", 0, 1) + bytes([a_depth]))
        a_av1 = prop(b"av1C", alpha_av1c)
        a_aux = prop(b"auxC", struct.pack(">I", 0) + AVIF_ALPHA_URN + b"\0")
        assoc[alpha_id] = [ispe, a_pixi, 0x80 | a_av1, a_aux]
    ipco = _box(b"ipco", b"".join(prop_list))
    ipma = _full(b"ipma", 0, 0, struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", item, len(ids)) + bytes(ids) for item, ids in sorted(assoc.items())))
    refs = []
    if grid:
        refs.append((b"dimg", 1, [2 + i for i in range(len(grid[2]))]))
    if alpha is not None:
        refs.append((b"auxl", alpha_id, [1]))
        if prem:
            refs.append((b"prem", 1, [alpha_id]))
    if exif is not None:
        refs.append((b"cdsc", exif_id, [1]))
    iref = _full(b"iref", 0, 0, b"".join(_box(k, struct.pack(">HH", src, len(dst)) + b"".join(
        struct.pack(">H", d) for d in dst)) for k, src, dst in refs)) if refs else b""
    infes = b"".join(_full(b"infe", infe_version, 1 if hidden else 0,
                           (struct.pack(">H", i) if infe_version == 2 else struct.pack(">I", i)) + b"\0\0" + t + b"\0")
                     for i, t, _, hidden in items)
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", len(items)) + infes)
    hdlr = _full(b"hdlr", 0, 0, b"\0\0\0\0pict" + bytes(12) + b"\0")
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))

    def iloc(offsets):
        wide = ">I" if iloc_version == 2 else ">H"
        out = struct.pack(">BB", 0x44, 0x00) + struct.pack(wide, len(items))
        for (i, _, payload, _), exts in zip(items, offsets):
            method = 1 if (idat and i == 1) else 0
            out += struct.pack(wide, i)
            if iloc_version in (1, 2):
                out += struct.pack(">H", method)
            out += struct.pack(">H", 0) + struct.pack(">H", len(exts))
            out += b"".join(struct.pack(">II", o, n) for o, n in exts)
        return _full(b"iloc", iloc_version, 0, out)

    def extents(i, payload, at):
        n = split if i == 1 else 1
        cuts = [len(payload) * k // n for k in range(n + 1)]
        return [(at + cuts[k], cuts[k + 1] - cuts[k]) for k in range(n)]

    ftyp = _box(b"ftyp", major + b"\0\0\0\0" + b"".join(brands))
    idat_payload = items[0][2] if idat else b""
    placeholder = [extents(i, p, 0) for i, _, p, _ in items]
    idat_box = _box(b"idat", idat_payload) if idat else b""

    def meta_box(offsets):
        return _full(b"meta", 0, 0, hdlr + pitm + iloc(offsets) + iinf + iref + _box(b"iprp", ipco + ipma) + idat_box)

    head = len(ftyp) + len(meta_box(placeholder)) + (16 if large_mdat else 8)
    offsets, at, body = [], head, b""
    for i, _, payload, _ in items:
        if idat and i == 1:
            offsets.append(extents(i, payload, 0))
            continue
        offsets.append(extents(i, payload, at))
        at += len(payload)
        body += payload
    mdat = (struct.pack(">I4sQ", 1, b"mdat", 16 + len(body)) if large_mdat else struct.pack(">I4s", 8 + len(body),
                                                                                            b"mdat")) + body
    return ftyp + meta_box(offsets) + mdat


def _obus(data: bytes) -> List[Tuple[int, bytes]]:
    """An AV1 stream's OBUs (each with a size field): (type, payload)."""
    out, at = [], 0
    while at < len(data):
        head = data[at]
        ext = (head >> 2) & 1
        p = at + 1 + ext
        size, shift = 0, 0
        while True:
            b = data[p]
            size |= (b & 0x7F) << shift
            shift += 7
            p += 1
            if not b & 0x80:
                break
        out.append(((head >> 3) & 15, data[p:p + size]))
        at = p + size
    return out


def _obu(kind: int, payload: bytes) -> bytes:
    size, leb = len(payload), b""
    while True:
        b = size & 0x7F
        size >>= 7
        leb += bytes([b | (0x80 if size else 0)])
        if not size:
            break
    return bytes([(kind << 3) | 2]) + leb + payload


def _bits(data: bytes) -> List[int]:
    return [(b >> (7 - i)) & 1 for b in data for i in range(8)]


def _unbits(bits: List[int]) -> bytes:
    bits = bits + [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def _reduced_seq_fields(seq: bytes) -> dict:
    """Bit positions of a reduced still-picture sequence header's fields
    (the headers Pillow's encoder writes)."""
    b = _bits(seq)
    assert b[3] == 1 and b[4] == 1, "not a reduced still-picture header"
    at = 3 + 1 + 1 + 5
    wbits = int("".join(map(str, b[at:at + 4])), 2) + 1
    hbits = int("".join(map(str, b[at + 4:at + 8])), 2) + 1
    at += 8 + wbits + hbits
    fields = {"use_128x128_superblock": at, "enable_superres": at + 3, "high_bitdepth": at + 6}
    return fields


def avif_stream_edit(data: bytes, edit: str) -> bytes:
    """A Pillow-written AVIF with its AV1 stream edited at the bit level, the
    nearest file to a kind no encoder here writes: "high_bitdepth" (the
    sequence header's and av1C's flag set: a 10-bit stream's header over
    8-bit data) and "use_superres" (enable_superres set in the sequence
    header, use_superres and coded_denom 0 put in the frame header)."""
    parts = avif_parts(data)
    obus = _obus(parts["color"])
    av1c = bytearray(parts["av1c"])
    out = []
    seq_fields = None
    for kind, payload in obus:
        if kind == 1:
            seq_fields = _reduced_seq_fields(payload)
            b = _bits(payload)
            if edit == "high_bitdepth":
                b[seq_fields["high_bitdepth"]] = 1
                av1c[2] |= 0x40
            if edit == "use_superres":
                b[seq_fields["enable_superres"]] = 1
            payload = _unbits(b)[:len(payload)]
        elif kind == 6:
            b = _bits(payload)
            if edit == "use_superres":
                at = 2 + (1 if b[1] else 0)
                b = b[:at] + [1, 0, 0, 0] + b[at:]
            payload = _unbits(b)
        out.append(_obu(kind, payload))
    return avif_file(b"".join(out), bytes(av1c), parts["size"], colr=tuple(parts["colr"]))


def _avif_scene(seed: int, h: int, w: int) -> np.ndarray:
    """Smooth regions, edges, lines and noise: every intra tool has
    something to do."""
    img = source_image(seed, h, w).astype(np.int64)
    r = np.random.default_rng(seed)
    for _ in range(max(1, h * w // 2000)):
        y, x = int(r.integers(0, h)), int(r.integers(0, w))
        img[y:y + int(r.integers(1, 9)), x:x + int(r.integers(1, 40))] = r.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _avif_screen(seed: int, h: int, w: int, colours: int = 6) -> np.ndarray:
    """Flat rectangles of a few colours: screen content, palette's case."""
    r = np.random.default_rng(seed)
    pal = r.integers(0, 256, (colours, 3))
    img = np.zeros((h, w, 3), np.uint8) + pal[0].astype(np.uint8)
    for _ in range(max(4, h * w // 300)):
        y, x = int(r.integers(0, h)), int(r.integers(0, w))
        img[y:y + int(r.integers(1, 24)), x:x + int(r.integers(1, 48))] = pal[int(r.integers(0, colours))]
    return img


def _avif_pillow_layouts() -> Dict[str, bytes]:
    scene = _avif_scene(2700, 72, 88)
    small = _avif_scene(2701, 40, 48)
    photo = smooth_scene(2702, 96, 128, cell=24, step=1)
    screen = _avif_screen(2703, 64, 96)
    out = {}
    for ss in ("4:2:0", "4:2:2", "4:4:4", "4:0:0"):
        tag = ss.replace(":", "")
        for rng in ("full", "limited"):
            out[f"pil-{tag}-{rng}.avif"] = pil_avif(scene, subsampling=ss, range=rng)
        for q in (0, 30, 90, 100):
            out[f"pil-{tag}-q{q}.avif"] = pil_avif(small, subsampling=ss, quality=q)
        for speed in (0, 10):
            out[f"pil-{tag}-speed{speed}.avif"] = pil_avif(small, subsampling=ss, speed=speed)
        out[f"pil-{tag}-cdef-restoration.avif"] = pil_avif(photo, subsampling=ss, speed=3, advanced={
            "enable-cdef": "1", "enable-restoration": "1"})
        out[f"pil-{tag}-screen.avif"] = pil_avif(screen, subsampling=ss, advanced={"tune-content": "screen"})
        out[f"pil-{tag}-lossless.avif"] = pil_avif(small[:24, :32], subsampling=ss, lossless=True)
    for w, h in ((1, 1), (2, 3), (3, 2), (17, 33), (33, 17), (65, 1), (1, 65), (127, 129)):
        out[f"pil-size-{w}x{h}.avif"] = pil_avif(_avif_scene(2704 + w, h, w))
    for q in (5, 15, 50, 60, 75, 85, 95):
        out[f"pil-420-q{q}.avif"] = pil_avif(scene, quality=q)
    for speed in (0, 1, 2, 4, 6, 8):
        out[f"pil-420-speed{speed}-scene.avif"] = pil_avif(scene, speed=speed)
    tools = {
        "cdef-on": {"enable-cdef": "1"}, "cdef-off": {"enable-cdef": "0"},
        "restoration-on": {"enable-restoration": "1"}, "restoration-off": {"enable-restoration": "0"},
        "filter-intra-on": {"enable-filter-intra": "1"}, "filter-intra-off": {"enable-filter-intra": "0"},
        "cfl-on": {"enable-cfl-intra": "1"}, "cfl-off": {"enable-cfl-intra": "0"},
        "palette-on": {"enable-palette": "1", "tune-content": "screen"}, "palette-off": {"enable-palette": "0"},
        "deltaq": {"deltaq-mode": "1"}, "sharpness-7": {"sharpness": "7"}, "sharpness-3": {"sharpness": "3"},
        "sb-128": {"sb-size": "128"}, "sb-64": {"sb-size": "64"},
        "smooth-off": {"enable-smooth-intra": "0"}, "paeth-off": {"enable-paeth-intra": "0"},
        "angle-delta-off": {"enable-angle-delta": "0"}, "intra-edge-off": {"enable-intra-edge-filter": "0"},
        "tx64-off": {"enable-tx64": "0"}, "rect-tx-off": {"enable-rect-tx": "0"},
        "rect-partitions-off": {"enable-rect-partitions": "0"}, "ab-partitions-off": {"enable-ab-partitions": "0"},
        "1to4-partitions-off": {"enable-1to4-partitions": "0"}, "min-partition-8": {"min-partition-size": "8"},
    }
    for name, adv in tools.items():
        img = screen if "palette" in name else photo if name.startswith(("cdef", "restoration", "sb-")) else scene
        out[f"pil-tool-{name}.avif"] = pil_avif(img, speed=2, advanced=adv)
    out["pil-tool-sb-128-speed0-restoration.avif"] = pil_avif(photo, speed=0, advanced={"enable-restoration": "1"})
    out["pil-tool-screen-444-lossless.avif"] = pil_avif(screen, subsampling="4:4:4", lossless=True,
                                                       advanced={"tune-content": "screen"})
    big = smooth_scene(2705, 256, 320, cell=40, step=1)
    out["pil-tiles-2x2.avif"] = pil_avif(big, tile_rows=1, tile_cols=1)
    out["pil-tiles-1x4.avif"] = pil_avif(big, tile_cols=2)
    out["pil-tiles-4x1-sb128.avif"] = pil_avif(big, tile_rows=2, speed=0)
    out["pil-autotiling.avif"] = pil_avif(smooth_scene(2706, 520, 200, cell=40, step=1), autotiling=True)
    out["pil-large-blocks-q10.avif"] = pil_avif(smooth_scene(2707, 256, 256, cell=128, step=1), quality=10, speed=0)
    rgba = with_alpha(scene, 2708)
    out["pil-alpha.avif"] = pil_avif(rgba)
    out["pil-alpha-premultiplied.avif"] = pil_avif(rgba, alpha_premultiplied=True)
    out["pil-alpha-444.avif"] = pil_avif(rgba, subsampling="4:4:4")
    out["pil-alpha-premultiplied-limited.avif"] = pil_avif(with_alpha(small), alpha_premultiplied=True,
                                                           range="limited")
    out["pil-alpha-opaque.avif"] = pil_avif(np.concatenate([small, np.full(small.shape[:2] + (1,), 255, np.uint8)],
                                                           -1))
    out["pil-alpha-premultiplied-q50.avif"] = pil_avif(with_alpha(photo), alpha_premultiplied=True, quality=50)
    out["pil-exif-orientation-6.avif"] = pil_avif(small, exif=b"Exif\0\0MM\0*\0\0\0\x08\0\x01\x01\x12\0\3\0\0\0\1"
                                                  b"\0\x06\0\0\0\0\0\0")
    out.update(_avif_coverage_layouts())
    return out


def _avif_coverage_layouts() -> Dict[str, bytes]:
    """Content that reaches what the layouts above leave out: 8- and 16-px
    bands (the 32x8, 8x32, 64x16 and 16x64 transforms), text of eight
    colours in 4-px cells (palettes of 6-8 colours), a flat half beside a
    textured one (restoration units left unfiltered)."""
    r = np.random.default_rng(2740)

    def bands(height: int, top: int, slope: int) -> np.ndarray:
        out = np.zeros((128, 128, 3), np.uint8)
        ramp = np.arange(128)[None, :, None] // slope
        for k in range(0, 128, height):
            out[k:k + height] = np.clip(np.random.default_rng(k).integers(0, top, 3) + ramp, 0, 255)
        return out

    text = np.full((96, 128, 3), 255, np.uint8)
    pal = r.integers(0, 256, (8, 3))
    cells = r.integers(0, 8, (24, 32))
    text[:] = pal[np.repeat(np.repeat(cells, 4, 0), 4, 1)]
    b8, b16 = bands(8, 200, 3), bands(16, 256, 2)
    flat = np.concatenate([np.full((128, 256, 3), 120, np.uint8), _avif_scene(2741, 128, 256)], 1)
    return {
        "cov-bands-8.avif": pil_avif(b8, speed=0, quality=20),
        "cov-bands-8-tall.avif": pil_avif(np.ascontiguousarray(b8.transpose(1, 0, 2)), speed=0, quality=20),
        "cov-bands-16.avif": pil_avif(b16, speed=0, quality=20),
        "cov-bands-16-tall.avif": pil_avif(np.ascontiguousarray(b16.transpose(1, 0, 2)), speed=0, quality=20),
        "cov-text-8-colours.avif": pil_avif(text, speed=0, quality=95, advanced={"tune-content": "screen"}),
        "cov-text-8-colours-444.avif": pil_avif(text, speed=0, subsampling="4:4:4",
                                                advanced={"tune-content": "screen"}),
        "cov-restoration-flat-half.avif": pil_avif(flat, speed=0, advanced={"enable-restoration": "1"}),
    }


def _avif_box_layouts() -> Dict[str, bytes]:
    base = avif_parts(pil_avif(_avif_scene(2710, 36, 44)))
    b444 = avif_parts(pil_avif(_avif_scene(2711, 20, 28), subsampling="4:4:4"))
    rgba = avif_parts(pil_avif(with_alpha(_avif_scene(2712, 24, 30), 2713)))
    c, a, size = base["color"], base["av1c"], base["size"]
    out = {
        "box-no-colr.avif": avif_file(c, a, size),
        "box-iloc-v1.avif": avif_file(c, a, size, iloc_version=1),
        "box-iloc-v2.avif": avif_file(c, a, size, iloc_version=2),
        "box-idat.avif": avif_file(c, a, size, iloc_version=1, idat=True),
        "box-extents-3.avif": avif_file(c, a, size, split=3),
        "box-infe-v3.avif": avif_file(c, a, size, infe_version=3),
        "box-mdat-64bit.avif": avif_file(c, a, size, large_mdat=True),
        "box-brand-mif1-major.avif": avif_file(c, a, size, major=b"mif1"),
        "box-exif-item.avif": avif_file(c, a, size, exif=b"\0\0\0\0II*\0\x08\0\0\0\0\0\0\0\0\0"),
        "box-irot-1.avif": avif_file(c, a, size, extra_props=((b"irot", b"\x01"),)),
        "box-imir-0.avif": avif_file(c, a, size, extra_props=((b"imir", b"\x00"),)),
        "box-clap.avif": avif_file(c, a, size, extra_props=((b"clap", struct.pack(">8I", 20, 1, 16, 1, 0, 1, 0, 1)),)),
        "box-pasp.avif": avif_file(c, a, size, extra_props=((b"pasp", struct.pack(">II", 1, 1)),)),
        "box-colr-icc.avif": avif_file(c, a, size, colr=(b"prof" + bytes(128),)),
        "box-colr-icc-and-nclx.avif": avif_file(c, a, size, colr=(b"prof" + bytes(64), nclx(1, 13, 1))),
        "box-alpha.avif": avif_file(rgba["color"], rgba["av1c"], rgba["size"], alpha=rgba["alpha"],
                                    alpha_av1c=rgba["alpha_av1c"]),
        "box-alpha-prem.avif": avif_file(rgba["color"], rgba["av1c"], rgba["size"], alpha=rgba["alpha"],
                                         alpha_av1c=rgba["alpha_av1c"], prem=True),
    }
    for mc, label in ((5, "bt601-5"), (6, "bt601"), (1, "bt709"), (9, "bt2020"), (2, "unspecified"), (12, "derived")):
        for full in (True, False):
            out[f"box-nclx-{label}-{'full' if full else 'limited'}.avif"] = avif_file(
                c, a, size, colr=(nclx(9 if mc == 12 else 1, 13, mc, full),))
    out["box-nclx-identity-444.avif"] = avif_file(b444["color"], b444["av1c"], b444["size"], colr=(nclx(1, 13, 0),))
    out["box-nclx-ycgco-444.avif"] = avif_file(b444["color"], b444["av1c"], b444["size"], colr=(nclx(1, 13, 8),))
    out["box-nclx-fcc-444.avif"] = avif_file(b444["color"], b444["av1c"], b444["size"], colr=(nclx(1, 13, 4),))
    out["box-nclx-bt709-444.avif"] = avif_file(b444["color"], b444["av1c"], b444["size"], colr=(nclx(1, 1, 1),))
    return out


def _avif_text(seed: int, h: int, w: int, colours: int = 4, density: float = 0.85) -> np.ndarray:
    """Lines of glyphs from a font of 16 random 12 x 8 bitmaps over a flat
    ground, and a few bars: screen content whose repeats aom copies with
    intra block copy."""
    r = np.random.default_rng(seed)
    pal = r.integers(0, 256, (colours, 3)).astype(np.uint8)
    glyphs = r.integers(0, 2, (16, 12, 8)).astype(bool)
    img = np.zeros((h, w, 3), np.uint8) + pal[0]
    for y in range(4, h - 12, 16):
        for x in range(4, w - 8, 9):
            if r.random() < density:
                img[y:y + 12, x:x + 8][glyphs[r.integers(0, 16)]] = pal[1 + (y // 40) % (colours - 1)]
    for _ in range(3):
        y, x = int(r.integers(0, h - 20)), int(r.integers(0, w - 30))
        img[y:y + 20, x:x + 30] = pal[r.integers(0, colours)]
    return img


def _avif_intrabc_layouts() -> Dict[str, bytes]:
    """Screen content that aom (Pillow's encoder, tune-content=screen) codes
    with intra block copy, from 192 px: each subsampling, palette colours
    on and off, lossless (quality 100), 128 px superblocks, 2 x 2 tiles,
    alpha, speeds 0 and 7 (aom searches no block copy from speed 8, so a
    speed 10 file holds none), a
    tiled texture whose copies keep residuals (every inter transform type
    and txfm_split), and the file PR 27 refused (``intrabc.avif``)."""
    screen = {"tune-content": "screen"}
    text = _avif_text(2800, 192, 192)
    out = {f"ibc-{ss.replace(':', '')}.avif": pil_avif(text, subsampling=ss, advanced=screen)
           for ss in ("4:2:0", "4:2:2", "4:4:4", "4:0:0")}
    out["ibc-420-no-palette.avif"] = pil_avif(text, advanced={**screen, "enable-palette": "0"})
    out["ibc-444-no-palette.avif"] = pil_avif(text, subsampling="4:4:4", advanced={**screen, "enable-palette": "0"})
    out["ibc-lossless-420.avif"] = pil_avif(text, quality=100, advanced=screen)
    out["ibc-lossless-444.avif"] = pil_avif(text, quality=100, subsampling="4:4:4", advanced=screen)
    out["ibc-sb128.avif"] = pil_avif(text, advanced={**screen, "sb-size": "128"})
    out["ibc-speed0.avif"] = pil_avif(_avif_text(2805, 256, 256), speed=0, advanced=screen)
    out["ibc-speed7.avif"] = pil_avif(text, speed=7, advanced=screen)
    out["ibc-q20.avif"] = pil_avif(text, quality=20, advanced=screen)
    out["ibc-alpha.avif"] = pil_avif(with_alpha(text), advanced=screen)
    band = np.full(text.shape[:2] + (1,), 255, np.uint8)  # premultiplied glyphs stay copies outside the band
    band[40:100, 20:150] = 96
    out["ibc-alpha-premultiplied.avif"] = pil_avif(np.concatenate([text, band], -1), alpha_premultiplied=True,
                                                   advanced=screen)
    out["ibc-tiles-2x2.avif"] = pil_avif(_avif_text(2803, 512, 512, density=0.3), tile_rows=1, tile_cols=1,
                                         advanced=screen)
    r = np.random.default_rng(2804)
    texture = np.tile(_avif_scene(2804, 64, 64), (4, 4, 1)).astype(np.int64)
    texture = np.clip(texture + r.integers(-4, 5, texture.shape), 0, 255).astype(np.uint8)
    out["ibc-texture-q70.avif"] = pil_avif(texture, quality=70, speed=4, advanced=screen)
    # aom turns intra block copy on for screen content from about 192 px
    out["intrabc.avif"] = pil_avif(_avif_screen(2722, 192, 192, colours=8), advanced=screen)
    return out


def deep_scene(seed: int, h: int, w: int, depth: int, subsampling: str = "4:2:0") -> List[np.ndarray]:
    """``deep_planes`` without their noise and bars: a scene smooth at
    ``depth`` bits (a random grid upsampled bilinearly in floats), the
    card's 10-bit photo."""
    r = np.random.default_rng(seed)
    cell = 64
    grid = r.random((h // cell + 2, w // cell + 2, 3))
    y, x = np.arange(h) / cell, np.arange(w) / cell
    y0, fy = y.astype(int), (y % 1)[:, None, None]
    x0, fx = x.astype(int), (x % 1)[None, :, None]
    rgb = ((1 - fy) * ((1 - fx) * grid[y0][:, x0] + fx * grid[y0][:, x0 + 1])
           + fy * ((1 - fx) * grid[y0 + 1][:, x0] + fx * grid[y0 + 1][:, x0 + 1])) * 255
    top = (1 << depth) - 1
    yy = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    planes = [yy, (rgb[..., 2] - yy) / 1.772 + 128, (rgb[..., 0] - yy) / 1.402 + 128]
    out = []
    for k, p in enumerate(planes if subsampling != "4:0:0" else planes[:1]):
        if k and subsampling != "4:4:4":
            sy = 2 if subsampling == "4:2:0" else 1
            p = p[::sy, ::2]
        out.append(np.clip(np.rint(p * top / 255), 0, top).astype(np.uint16))
    return out


def _avif_deep_layouts() -> Dict[str, bytes]:
    """10- and 12-bit files (``deep_avif``: the system's libavif over libaom
    3.6.0): every subsampling at both depths (profiles 0, 1 and 2) in full
    and limited range, BT.709 and BT.2020, alpha and premultiplied alpha on
    each of libavif's conversion paths (libyuv's 10-bit and 12-bit ones,
    the 8-bit one after its shift, I400, the float one), the identity
    matrix, YCgCo and FCC in 4:4:4, CDEF and restoration, lossless,
    screen content with palettes and intra block copy at 10 bits, and a
    Pillow file whose sequence header and av1C claim 10 bits."""
    out = {}
    for depth in (10, 12):
        for ss in ("4:2:0", "4:2:2", "4:4:4", "4:0:0"):
            planes = deep_planes(2810 + depth, 24, 40, depth, ss)
            for full in (True, False):
                out[f"deep-{depth}-{ss.replace(':', '')}-{'full' if full else 'limited'}.avif"] = deep_avif(
                    planes, depth, ss, full=full, quantizer=12)
    planes = {(d, ss): deep_planes(2830 + d, 30, 44, d, ss) for d in (10, 12) for ss in ("4:2:0", "4:2:2", "4:4:4",
                                                                                          "4:0:0")}
    alpha = {d: deep_planes(2840 + d, 30, 44, d, "4:0:0")[0] for d in (10, 12)}
    out["deep-10-420-bt709.avif"] = deep_avif(planes[10, "4:2:0"], 10, cicp=(1, 1, 1), full=False)
    out["deep-10-420-bt2020.avif"] = deep_avif(planes[10, "4:2:0"], 10, cicp=(9, 16, 9))
    out["deep-12-444-bt709-limited.avif"] = deep_avif(planes[12, "4:4:4"], 12, "4:4:4", cicp=(1, 1, 1), full=False)
    for depth, ss, cicp, prem in ((10, "4:2:0", (1, 13, 6), False), (10, "4:2:0", (1, 13, 6), True),
                                  (10, "4:2:2", (9, 16, 9), True), (10, "4:4:4", (1, 13, 1), False),
                                  (12, "4:2:0", (1, 13, 6), True), (12, "4:2:2", (1, 13, 1), False),
                                  (12, "4:4:4", (1, 13, 6), True), (10, "4:0:0", (2, 2, 2), True),
                                  (12, "4:0:0", (2, 2, 2), False), (10, "4:4:4", (1, 13, 0), True),
                                  (12, "4:4:4", (1, 13, 8), True), (10, "4:4:4", (1, 13, 4), True)):
        name = f"deep-{depth}-{ss.replace(':', '')}-mc{cicp[2]}-alpha{'-premultiplied' if prem else ''}.avif"
        out[name] = deep_avif(planes[depth, ss], depth, ss, cicp=cicp, alpha=alpha[depth], premultiplied=prem)
    out["deep-10-444-identity.avif"] = deep_avif(planes[10, "4:4:4"], 10, "4:4:4", cicp=(1, 13, 0))
    out["deep-12-444-ycgco.avif"] = deep_avif(planes[12, "4:4:4"], 12, "4:4:4", cicp=(1, 13, 8))
    out["deep-10-444-fcc-limited.avif"] = deep_avif(planes[10, "4:4:4"], 10, "4:4:4", cicp=(1, 13, 4), full=False)
    out["deep-10-444-lossless.avif"] = deep_avif([p[:16, :16] for p in planes[10, "4:4:4"]], 10, "4:4:4", quantizer=0)
    filtered = {"enable-cdef": "1", "enable-restoration": "1"}
    out["deep-10-420-cdef-restoration.avif"] = deep_avif(deep_planes(2850, 128, 256, 10), 10, quantizer=40, speed=1,
                                                         advanced=filtered)
    out["deep-12-420-cdef-restoration.avif"] = deep_avif(deep_planes(2851, 128, 256, 12), 12, quantizer=30, speed=1,
                                                         advanced=filtered)
    out["deep-12-422-q55.avif"] = deep_avif(deep_planes(2852, 64, 96, 12, "4:2:2"), 12, "4:2:2", quantizer=55,
                                            speed=2)
    text = _avif_text(2853, 192, 192).astype(np.uint16) * 4
    chroma = [text[::2, ::2, 1], text[::2, ::2, 2]]
    out["deep-10-420-screen-intrabc.avif"] = deep_avif([text[..., 0]] + chroma, 10, quantizer=20, speed=4,
                                                       advanced={"tune-content": "screen"})
    # PR 27's refusal of 10-bit streams: the 10-bit flags over 8-bit data,
    # which dav1d decodes as 10-bit samples
    out["high-bitdepth.avif"] = avif_stream_edit(pil_avif(_avif_scene(2720, 40, 48)), "high_bitdepth")
    return out


@functools.lru_cache(maxsize=None)
def avif_layouts() -> Dict[str, bytes]:
    """Every committed file of ``avif/`` the port reads (name under
    ``avif/`` -> bytes): Pillow's encoder over the subsamplings, ranges,
    qualities, speeds, sizes and aom's tool switches, containers this
    module writes around its streams (iloc versions, idat, extents, colr
    variants, alpha), screen content of intra block copy, 10- and 12-bit
    files of the system's libavif, and a file whose 10-bit flags sit over
    8-bit data (``high-bitdepth.avif``, read as Pillow reads it).  Made
    once a process (the encoders take seconds): not to be changed."""
    out = {**_avif_pillow_layouts(), **_avif_box_layouts(), **_avif_intrabc_layouts(), **_avif_deep_layouts()}
    return {f"{AVIF}/{k}": v for k, v in sorted(out.items())}


def avif_refusals() -> Dict[str, Tuple[bytes, str]]:
    """Files of this slice the port refuses (name -> (bytes, the reason its
    error names, a regular expression)): the kinds left out by name
    (ROADMAP §3 fault 7's AVIF queue), each the nearest file to its kind
    that can be made here, the 10- and 12-bit layouts of libavif's float
    bilinear path, and files Pillow refuses too."""
    scene = _avif_scene(2720, 40, 48)
    base = pil_avif(scene)
    parts = avif_parts(base)
    t1 = avif_parts(pil_avif(scene[:, :24]))
    t2 = avif_parts(pil_avif(scene[:, 24:]))
    seq = io.BytesIO()
    from PIL import Image

    Image.fromarray(scene).save(seq, "AVIF", save_all=True, append_images=[Image.fromarray(255 - scene)])
    seq = bytearray(seq.getvalue())
    for kind in (b"mvhd", b"tkhd", b"mdhd"):  # the creation and modification times, zeroed
        at = seq.index(kind) + 4
        n = 8 if seq[at] == 1 else 4
        seq[at + 4:at + 4 + 2 * n] = bytes(2 * n)
    seq = bytes(seq)
    pitm = seq.index(b"pitm")
    no_primary = seq[:pitm] + b"pitx" + seq[pitm + 4:]
    c, a, size = parts["color"], parts["av1c"], parts["size"]
    failed = "Failed to decode|not read|does not read|cannot identify|does not identify"
    deep = {10: deep_planes(2860, 40, 48, 10), 12: deep_planes(2861, 40, 48, 12, "4:2:2"),
            4: deep_planes(2862, 40, 48, 10, "4:4:4")}
    d10 = avif_parts(deep_avif(deep[10], 10))
    rgba = avif_parts(pil_avif(with_alpha(scene, 2863)))
    return {
        "grid-2x1.avif": (avif_file(b"", a, size, grid=(1, 2, [t1["color"], t2["color"]])), "grid derived image"),
        "sequence-no-primary-item.avif": (no_primary, "image sequence without a still primary item"),
        "film-grain.avif": (pil_avif(scene, advanced={"film-grain-test": "1"}), "film grain"),
        "qmatrix.avif": (pil_avif(scene, advanced={"enable-qm": "1"}), "quantizer matrices"),
        "superres.avif": (avif_stream_edit(base, "use_superres"), "superresolution"),
        "layered-a1lx.avif": (avif_file(c, a, size, extra_props=((b"a1lx", b"\0" + bytes(6)),)), "layered image"),
        "layered-lsel.avif": (avif_file(c, a, size, extra_props=((b"lsel", b"\0\0"),)), "layered image"),
        "cut-in-mdat.avif": (base[:len(base) - 40], failed),
        "cut-in-meta.avif": (base[:200], failed),
        "no-ispe.avif": (base.replace(b"ispe", b"ispx"), failed),
        "no-av1c.avif": (base.replace(b"av1C", b"av1X"), failed),
        "hdlr-not-pict.avif": (base.replace(b"pict", b"picx"), failed),
        "brand-not-avif.avif": (avif_file(c, a, size, major=b"mif1", brands=(b"mif1", b"miaf")), failed),
        "nclx-identity-420.avif": (avif_file(c, a, size, colr=(nclx(1, 13, 0),)), "Reformat failed|identity"),
        "nclx-ycgco-420.avif": (avif_file(c, a, size, colr=(nclx(1, 13, 8),)), "float bilinear"),
        "obu-size-past-end.avif": (avif_file(c[:2] + bytes([c[2] | 0x40]) + c[3:], a, size), failed),
        # 10- and 12-bit files of libavif's float bilinear path, YCgCo of
        # limited range, and an 8-bit alpha plane under a 10-bit image
        "deep-10-ycgco-420.avif": (deep_avif(deep[10], 10, cicp=(1, 13, 8)), "float bilinear"),
        "deep-12-fcc-422.avif": (deep_avif(deep[12], 12, "4:2:2", cicp=(1, 13, 4)), "float bilinear"),
        "deep-10-ycgco-444-limited.avif": (deep_avif(deep[4], 10, "4:4:4", cicp=(1, 13, 8), full=False),
                                           "Reformat failed|YCgCo of limited range"),
        "deep-10-alpha-8-bit.avif": (avif_file(d10["color"], d10["av1c"], d10["size"], alpha=rgba["alpha"],
                                               alpha_av1c=rgba["alpha_av1c"]), "alpha plane of another bit depth"),
    }


@functools.lru_cache(maxsize=None)
def avif_card_originals() -> Dict[str, bytes]:
    """The card's originals of ``AVIF_CARD``, all committed: name (under
    ``avif/card/``) -> bytes as Pillow's encoder writes them."""
    photo = smooth_scene(2730, 1024, 1024, cell=64, step=1)
    out = {
        "photo-1024.avif": pil_avif(photo),
        "photo-1024-444-cdef-lr-sb128-tiles.avif": pil_avif(photo, subsampling="4:4:4", speed=0, quality=50,
                                                            tile_rows=1, tile_cols=1, advanced={
                                                                "enable-cdef": "1", "enable-restoration": "1"}),
        "screen-1024-palette.avif": pil_avif(_avif_screen(2731, 1024, 1024, colours=8),
                                             advanced={"tune-content": "screen", "enable-intrabc": "0"}),
        "photo-512-premultiplied.avif": pil_avif(with_alpha(smooth_scene(2732, 512, 512, cell=64, step=1)),
                                                 alpha_premultiplied=True),
        # the screen original's recipe with aom's intra block copy left on
        "screen-1024-intrabc.avif": pil_avif(_avif_screen(2731, 1024, 1024, colours=8),
                                             advanced={"tune-content": "screen"}),
        # 4:2:0 at Pillow's defaults carried to the system's encoder (quality
        # 75, its quantizer 16; speed 6)
        "photo-1024-10bit.avif": deep_avif(deep_scene(2733, 1024, 1024, 10), 10, quantizer=16, speed=6),
    }
    assert sorted(out) == sorted(AVIF_CARD)
    return {f"{AVIF}/card/{k}": v for k, v in out.items()}


def avif_train() -> Dict[str, bytes]:
    """An AVIF file of each stage's size (4-512 px, under ``avif/train/``),
    which the card's "io train" puts in each stage's set under a listed
    name: the card's machine has no AVIF writer."""
    return {f"{AVIF}/train/{size}.avif": pil_avif(smooth_scene(2790 + k, size, size, cell=max(2, size // 8), step=1))
            for k, size in enumerate(4 * 2 ** s for s in range(8))}


def avif_fixtures() -> Dict[str, bytes]:
    """Every committed file under ``avif/`` (name -> bytes), written anew:
    the layouts, the refusals, the card's originals and the train set's."""
    refused = {f"{AVIF}/refused/{k}": v for k, (v, _) in avif_refusals().items()}
    return dict(sorted({**avif_layouts(), **refused, **avif_card_originals(), **avif_train()}.items()))


def committed_avif() -> Dict[str, bytes]:
    """The committed files under ``avif/``: name -> bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(FIXTURES, AVIF)):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, FIXTURES)] = f.read()
    return dict(sorted(out.items()))


def avif_manifest(scratch: str, files: Optional[Dict[str, bytes]] = None) -> dict:
    """The manifest's entries of this folder: each committed file as
    ``gif_tiff_entry`` records it with ``avif_refusals``."""
    files = committed_avif() if files is None else files
    reasons = avif_refusals()
    entries = {}
    for name, data in files.items():
        path = os.path.join(scratch, "avif" + os.path.splitext(name)[1])
        with open(path, "wb") as f:
            f.write(data)
        entries[name] = gif_tiff_entry(name, path, reasons)
    return {"files": entries}


def check_avif_card(decode: Callable[[str], np.ndarray]) -> Dict[str, str]:
    """Holds each committed card original of ``AVIF_CARD`` to the manifest:
    bytes and ``decode``'s RGB.  Returns name -> path of each; raises
    ``AssertionError`` naming the first that differs."""
    manifest = load_manifest()["files"]
    paths = {}
    for name in sorted(AVIF_CARD):
        key = f"{AVIF}/card/{name}"
        path = os.path.join(FIXTURES, key)
        with open(path, "rb") as f:
            if sha256(f.read()) != manifest[key]["sha256"]:
                raise AssertionError(f"{key}: the file is not the one the manifest records")
        got = decode(path)
        if list(got.shape[:2]) != manifest[key]["shape"] or sha256(got) != manifest[key]["sha256_rgb"]:
            raise AssertionError(f"{key}: decoded to other pixels than Pillow's")
        paths[name] = path
    return paths


class Dav1dPicture:
    """The Y, U and V planes the system's libdav1d (``libdav1d.so.6``,
    through ctypes; the loader's search path finds it) decodes from an AV1
    stream: ``planes(obus)`` -> (Y, U,
    V) uint8 arrays, uint16 of 10- or 12-bit samples (U and V None in
    4:0:0), or the library's error code."""

    def __init__(self, path: str = "libdav1d.so.6"):
        self.lib = ctypes.CDLL(path)
        self.lib.dav1d_data_create.restype = ctypes.c_void_p

    def planes(self, obus: bytes):
        lib = self.lib
        settings = ctypes.create_string_buffer(2048)
        lib.dav1d_default_settings(settings)
        ctx = ctypes.c_void_p()
        if lib.dav1d_open(ctypes.byref(ctx), settings):
            raise OSError("dav1d_open failed")
        data = ctypes.create_string_buffer(256)
        ptr = lib.dav1d_data_create(data, ctypes.c_size_t(len(obus)))
        ctypes.memmove(ptr, obus, len(obus))
        pic = ctypes.create_string_buffer(1024)
        rc = lib.dav1d_send_data(ctx, data)
        if rc in (0, -11):
            for _ in range(64):
                rc = lib.dav1d_get_picture(ctx, pic)
                if rc != -11:
                    break
        out = rc
        if rc == 0:
            raw = pic.raw
            ptrs = struct.unpack("<3Q", raw[16:40])
            strides = struct.unpack("<2q", raw[40:56])
            w, h, layout, _ = struct.unpack("<4i", raw[56:72])

            w, h, layout, bpc = struct.unpack("<4i", raw[56:72])
            kind = np.uint8 if bpc == 8 else np.uint16

            def plane(p, pw, ph, stride):
                buf = (ctypes.c_uint8 * (stride * ph)).from_address(p)
                return np.frombuffer(buf, kind).reshape(ph, stride // kind().itemsize)[:, :pw].copy()

            y = plane(ptrs[0], w, h, strides[0])
            if layout == 0:
                out = (y, None, None)
            else:
                sx, sy = (1, 1) if layout == 1 else (1, 0) if layout == 2 else (0, 0)
                cw, ch = (w + sx) >> sx, (h + sy) >> sy
                out = (y, plane(ptrs[1], cw, ch, strides[1]), plane(ptrs[2], cw, ch, strides[1]))
            lib.dav1d_picture_unref(pic)
        else:
            lib.dav1d_data_unref(data)
        lib.dav1d_close(ctypes.byref(ctx))
        return out


# --- every slice's originals of the Pillow lane in one cli.prep ----------------------------------

#: the manifest's key of the JAX package's prep of ``pillow_lane_originals``
PILLOW_LANE_PREP = "pillow_lane_prep"


def pillow_lane_sources() -> List[Tuple[str, str, Optional[str]]]:
    """Every original the card's "io prep" reads in its one ``cli.prep``
    of the Pillow lane: (listed name, the committed file's name under
    ``FIXTURES``, or None, the written card original's name): the committed
    WebP, JPEG kinds', Pillow lane's, GIF/TIFF and JPEG TIFF originals and
    the written ones of each slice that ``cli.prep`` reads, each under the
    listed name its slice gives it."""
    out = [(n, f"{WEBP}/card/{n}", None) for n in sorted(WEBP_CARD)]
    out += [(n, f"{KINDS}/card/{n}", None) for n in sorted(KINDS_CARD)]
    out += [(n, f"{PILLOW}/card/{n}", None) for n in PILLOW_CARD]
    out += [(GIF_TIFF_CARD[n], f"{GIF_TIFF}/card/{n}", None) for n in sorted(GIF_TIFF_CARD)]
    out += [(v, None, f"{ICO_PNM_TGA}/card/{k}") for k, v in sorted(CARD_ORIGINALS.items()) if v]
    out += [(RASTER_CARD[n], f"{RASTER}/card/{n}" if n in RASTER_COMMITTED_CARD else None,
             None if n in RASTER_COMMITTED_CARD else f"{RASTER}/card/{n}") for n in sorted(RASTER_CARD) if RASTER_CARD[n]]
    for folder, card in ((DBFIS, DBFIS_CARD), (LEGACY, LEGACY_CARD), (IMIPS, IMIPS_CARD)):
        out += [(v, None, f"{folder}/card/{k}") for k, v in sorted(card.items()) if v]
    out += [(LZO_CARD[n], f"{LZO}/card/{n}" if n in LZO_COMMITTED_CARD else None,
             None if n in LZO_COMMITTED_CARD else f"{LZO}/card/{n}") for n in sorted(LZO_CARD)]
    out += [(J2K_CARD[n], f"{J2K}/card/{n}", None) for n in sorted(J2K_CARD) if J2K_CARD[n]]
    out += [(AVIF_CARD[n], f"{AVIF}/card/{n}", None) for n in sorted(AVIF_CARD) if AVIF_CARD[n]]
    names = [n for n, _, _ in out]
    assert len(set(names)) == len(names), "two originals under one listed name"
    return out


def pillow_lane_images(listed: List[str]) -> List[str]:
    """The names ``cli.prep`` gives the originals of ``pillow_lane_sources``
    listed as ``listed`` in each set of ``PILLOW_LANE_PREP``: ``image-i.png``,
    ``i`` the original's place among the listed names in sorted order."""
    order = sorted(n for n, _, _ in pillow_lane_sources())
    return sorted(f"image-{order.index(n)}.png" for n in listed)


def pillow_lane_originals() -> Dict[str, bytes]:
    """``pillow_lane_sources``' originals: listed name -> bytes (the written
    ones made anew by their slices' writers)."""
    written = {**card_originals(), **raster_card_originals(), **dbfis_card_originals(), **legacy_card_originals(),
               **imips_card_originals(), **lzo_card_originals()}
    out = {}
    for listed, committed, made in pillow_lane_sources():
        if committed is not None:
            with open(os.path.join(FIXTURES, committed), "rb") as f:
                out[listed] = f.read()
        else:
            out[listed] = written[made]
    return out



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
