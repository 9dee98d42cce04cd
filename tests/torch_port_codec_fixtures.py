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
                   ico_pnm_tga: Optional[Dict[str, bytes]] = None, raster: Optional[Dict[str, bytes]] = None) -> dict:
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
    WebP originals, of its originals of the kinds, of its originals under
    ``pillow/card/`` and of those under ``gif_tiff/card/`` together with
    the written ones cli.prep reads (by their listed names,
    ``GIF_TIFF_CARD`` and ``CARD_ORIGINALS``), and of the PSD, PCX, SGI,
    QOI and TIFF originals of ``RASTER_CARD`` by their listed names."""
    import PIL
    from PIL import features

    webp = committed_webp() if webp is None else webp
    kinds = committed_kinds() if kinds is None else kinds
    pillow = committed_pillow() if pillow is None else pillow
    gif_tiff = committed_gif_tiff() if gif_tiff is None else gif_tiff
    ico_pnm_tga = committed_ico_pnm_tga() if ico_pnm_tga is None else ico_pnm_tga
    raster = committed_raster() if raster is None else raster
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
    raster_written = raster_card_originals()
    raster_card = {}
    for name, data in raster_written.items():
        path = os.path.join(scratch, os.path.basename(name))
        with open(path, "wb") as f:
            f.write(data)
        raster_card[name] = gif_tiff_entry(name, path, raster_refusals())
    raster_listed = {RASTER_CARD[os.path.basename(n)]: d for n, d in {**raster_written, **raster}.items()
                     if n.startswith(f"{RASTER}/card/") and RASTER_CARD[os.path.basename(n)]}
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
    card = {n: d for n, d in webp.items() if n.startswith(f"{WEBP}/card/")}
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
                      "raster_card: the originals raster_card_originals writes on the card, never committed",
        "files": entries, "card": card_entries, "sources": sources, "webp_prep": jax_prep_digests(scratch, card),
        "jpeg_prep": jax_prep_digests(scratch, kinds_card),
        "pillow_prep": jax_prep_digests(scratch, pillow_card_files),
        "gif_tiff_prep": jax_prep_digests(scratch, gif_tiff_card_files),
        "raster_card": raster_card, "raster_prep": jax_prep_digests(scratch, raster_listed),
    }


def write(scratch: str) -> dict:
    files = fixtures()
    webp = webp_fixtures()
    kinds = kinds_fixtures(scratch)
    pillow = pillow_fixtures(scratch)
    gif_tiff = gif_tiff_fixtures()
    ico_pnm_tga = ico_pnm_tga_fixtures()
    raster = raster_fixtures()
    for folder in (WEBP, KINDS, PILLOW, GIF_TIFF, ICO_PNM_TGA, RASTER):
        shutil.rmtree(os.path.join(FIXTURES, folder), ignore_errors=True)
    for name, data in {**{k: d for k, (d, _) in files.items()}, **webp, **kinds, **pillow, **gif_tiff,
                       **ico_pnm_tga, **raster}.items():
        os.makedirs(os.path.dirname(os.path.join(FIXTURES, name)), exist_ok=True)
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
    manifest = build_manifest(files, jax_lane(os.path.join(scratch, "build")), scratch, webp, kinds, pillow, gif_tiff,
                              ico_pnm_tga, raster)
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
    (``key`` "webp_prep"), its originals of the JPEG kinds ("jpeg_prep"),
    its originals under ``pillow/card/`` ("pillow_prep") or those under
    ``gif_tiff/card/`` with the written ones cli.prep reads
    (``card_originals``; "gif_tiff_prep") against the JAX
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


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, widened one code early as libtiff
    reads them): a Clear first, a Clear whenever the table reaches 4094
    entries, the end code last."""
    out = bytearray()
    acc = nbits = 0
    bits, decoder_next, first = 9, 258, True

    def emit(code):
        nonlocal acc, nbits, bits, decoder_next, first
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
            if decoder_next > (1 << bits) - 2 and bits < 12:
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
        out.append((acc << (8 - nbits)) & 255)
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
    return _pack(block.reshape(h, w * c, 1), bits)


def tiff_bytes(samples, bits: int = 8, photometric: int = 2, order: str = "<", compression: int = 1,
               predictor: int = 1, planar: int = 1, rows_per_strip: Optional[int] = None,
               tile: Optional[Tuple[int, int]] = None, extra=None, colormap=None, orientation: Optional[int] = None,
               tags: Optional[Dict[int, Tuple[int, list]]] = None, data: Optional[bytes] = None,
               chunks: Optional[List[bytes]] = None) -> bytes:
    """A TIFF of ``samples`` ((h, w) or (h, w, c) integers of ``bits``) in
    byte order ``order`` ("<" II, ">" MM): strips of ``rows_per_strip`` or
    tiles (th, tw), each plane apart where ``planar`` is 2, differenced
    horizontally where ``predictor`` is 2 (whatever the compression: a
    reader applies it under LZW and Deflate alone), then compressed
    (``TIFF_COMPRESS``, or ``data`` as every chunk, or ``chunks``, one
    each); ``tags`` (id -> (type, values), a RATIONAL's values numerator,
    denominator pairs, UNDEFINED (7) bytes) add to or replace the
    directory's."""
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
            coded.append(data if data is not None else TIFF_COMPRESS[compression](_tiff_rows(blk, bits, order).tobytes()))
    chunks = coded if chunks is None else chunks
    body = bytearray((b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, 0))
    offsets = []
    for chunk in chunks:
        offsets.append(len(body))
        body += chunk + b"\0" * (len(chunk) % 2)
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c), 259: (3, [compression]), 262: (3, [photometric]),
         277: (3, [c]), 284: (3, [planar])}
    if predictor != 1:
        t[317] = (3, [predictor])
    if tile:
        t.update({322: (3, [tile[1]]), 323: (3, [tile[0]]), 324: (4, offsets), 325: (4, list(map(len, chunks)))})
    else:
        t.update({273: (4, offsets), 278: (4, [rows_per_strip or h]), 279: (4, list(map(len, chunks)))})
    if extra is not None:
        t[338] = (3, list(extra))
    if colormap is not None:
        t[320] = (3, list(np.asarray(colormap).T.reshape(-1)))
    if orientation is not None:
        t[274] = (3, [orientation])
    t.update(tags or {})
    entries = sorted(t.items())
    ifd_at = len(body)
    values_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, values = bytearray(struct.pack(order + "H", len(entries))), bytearray()
    for tag, (typ, vals) in entries:
        # RATIONAL (5): vals are numerator, denominator pairs
        raw = struct.pack(order + {1: "B", 3: "H", 4: "I", 5: "I", 7: "B", 11: "f"}[typ] * len(vals), *map(int, vals))
        if len(raw) > 4:
            field = struct.pack(order + "I", values_at + len(values))
            values += raw + b"\0" * (len(raw) % 2)
        else:
            field = raw + bytes(4 - len(raw))
        ifd += struct.pack(order + "HHI", tag, typ, len(vals) // 2 if typ == 5 else len(vals)) + field
    body[4:8] = struct.pack(order + "I", ifd_at)
    return bytes(body + ifd + b"\0\0\0\0" + values)


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
    """TIFFs the port refuses by name (Pillow reads some of them: Lab,
    CCITT, a JPEG stream cut short): name -> (bytes, the reason the port's
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
        "bigtiff.tif": (b"II+\0\x08\0\0\0" + bytes(32), "BigTIFF"),
        "jpeg.tif": (tiff_bytes(rgb, compression=7, data=junk), "breaks the format's rules"),
        "old-jpeg.tif": (tiff_bytes(rgb, compression=6, data=junk), "old-style JPEG compression"),
        "jpeg-12-bit.tif": (jpeg12, "12-bit"),
        "jpeg-cut-short.tif": (_cut_strip(cut, 60), "truncated"),
        "jpeg-subsampling-tag-1x1.tif": (jpeg_tiff(photo, 6, 80, (2, 2), sampling_tag=(1, 1)),
                                         "does not match the file's tags"),
        "jpeg-rgba.tif": (tiff_bytes(np.zeros((h, w, 4), np.uint8), compression=7, extra=(2,), data=junk),
                          "JPEG compression of other samples"),
        "ycbcr-1x4-lzw.tif": (ycbcr_tiff(*lzw_planes, 1, 4), "YCbCr pixels in this layout"),
        "ycbcr-lzw-one-sample.tif": (tiff_bytes(rgb[..., 0], photometric=6, compression=5), "depth or sample layout"),
        "ccitt-group4.tif": (tiff_bytes(gray & 1, 1, photometric=0, compression=4, data=junk), "CCITT"),
        "logluv.tif": (tiff_bytes(rgb, photometric=32845, compression=34676, data=junk), "LogLuv"),
        "lzma.tif": (tiff_bytes(rgb, compression=34925, data=junk), "with this compression"),
        "lab.tif": (tiff_bytes(rgb, photometric=8), "photometric interpretation"),
        "fill-order-2-gray8-white-raw.tif": (tiff_bytes(gray, photometric=0, tags={266: (3, [2])}), "FillOrder 2"),
        "fill-order-2-palette4-raw.tif": (tiff_bytes(gray & 15, 4, photometric=3, colormap=r.integers(0, 65536, (16, 3)),
                                                     tags={266: (3, [2])}), "FillOrder 2"),
        "signed-white.tif": (tiff_bytes(gray, photometric=0, tags={339: (3, [2])}), "depth or sample layout"),
        "gray16-planar-raw.tif": (tiff_bytes(gray * 257, 16, 1, planar=2), "depth or sample layout"),
        "gray4-predictor-2.tif": (tiff_bytes(gray & 15, 4, photometric=1, compression=5, predictor=2), "predictor"),
        "predictor-3.tif": (tiff_bytes(rgb, compression=5, tags={317: (3, [3])}), "predictor"),
        "bilevel-predictor-2.tif": (tiff_bytes(gray & 1, 1, photometric=1, compression=5, predictor=2), "predictor"),
        "old-style-lzw.tif": (old_lzw, "old-style LZW"),
        "lzw-cut-short.tif": (tiff_bytes(rgb, compression=5, data=tiff_lzw(rgb.astype(np.uint8).tobytes())[:40]),
                              "refused the data|breaks the format"),
        "strip-past-the-end.tif": (_strip_at_the_end(lzw), "truncated"),
        "raw-past-the-end.tif": (_strip_at_the_end(tiff_bytes(rgb)), "truncated"),
        "no-width.tif": (_without_tag(tiff_bytes(rgb), 256), "first directory"),
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
               "photo-1024-jpeg-contig.tif": None}
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
    bytes; Pillow reads each): PSD of every mode but Lab, raw and PackBits,
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
    """PSD, PCX, SGI and QOI files Pillow 12.1.0 refuses (and PSD's Lab
    colour, which the port refuses by name): name -> (bytes, the reason the
    port's ``OSError`` names, a regular expression)."""
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
        "psd-lab.psd": (psd_file(planes[:3], 9, w), "Lab colour are not read"),
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


def raster_card_originals() -> Dict[str, bytes]:
    """The card's written originals of ``RASTER_CARD`` (all but the
    committed ones), from seeded numpy alone: name (under
    ``psd_pcx_sgi_qoi/card/``) -> bytes."""
    side = 1024
    photo = smooth_scene(2021, side, side, cell=128, step=4)
    poster = smooth_scene(2022, side, side, cell=128, step=32)
    planes = photo.transpose(2, 0, 1)
    pcx_rows = np.concatenate([poster[..., k] for k in range(3)], 1)
    out = {
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
    written anew: the layouts, the refusals and the committed card
    originals."""
    refused = {f"{RASTER}/refused/{k}": v for k, (v, _) in raster_refusals().items()}
    return dict(sorted({**raster_layouts(), **jpeg_planes_predictor_layouts(), **refused,
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
