"""Fixtures of the port's JPEG and PNG codecs, and the writers that make them.

    python tests/torch_port_codec_fixtures.py

writes ``tests/data/torch_port_codecs/``: small JPEG files (Pillow's, and
this module's own for the samplings Pillow cannot write), Adam7 and
16-bit PNGs, and ``manifest.json``.  For each file the manifest records
the SHA-256 of its bytes and of the RGB that libjpeg-turbo (or libpng)
decodes from it: the JAX package's native lane and Pillow, which must agree.
For each seeded source image it records the SHA-256 of the pixels and of
the JAX lane's JPEG bytes at every quality of ``QUALITIES``.  The machine
with the card has neither library, so ``chip_smoke.py`` holds the port's
codecs to these hashes there; ``tests/test_torch_port_codecs.py`` rebuilds
the manifest here and asserts that it is the committed one.

At import this module needs numpy alone: Pillow and the JAX lane (built
from ``byogan_tpu/native/byogan_io.cpp`` into a directory the caller
names, never the JAX package's own library) are reached inside the
functions that need them.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import zlib
from typing import Callable, Dict, List, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port_codecs")
MANIFEST = os.path.join(FIXTURES, "manifest.json")
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
        for r in range(rows.shape[0]):
            kind = kinds[r % len(kinds)]
            raw.append(bytes([kind]) + filter_rows(rows, bpp, kind)[r].tobytes())
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


def build_manifest(files: Dict[str, Tuple[bytes, object]], lib: ctypes.CDLL, scratch: str) -> dict:
    """The manifest of ``fixtures()``: each file decoded by the JAX lane,
    which must agree with Pillow or with the file's known RGB; each source
    encoded by the JAX lane."""
    import PIL

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
    sources = {}
    for name, (seed, h, w) in SOURCES.items():
        img = source_image(seed, h, w)
        sources[name] = {
            "seed": seed, "shape": [h, w], "sha256_pixels": sha256(img),
            "sha256_jpeg": {str(q): sha256(jax_encode(lib, img, q, os.path.join(scratch, f"{name}-{q}.jpg")))
                            for q in QUALITIES},
        }
    return {
        "decoded_by": f"the JAX package's native lane (libpng, libjpeg-turbo), held to Pillow {PIL.__version__} "
                      "(JPEG, 8-bit PNG) or to the samples (PNG)",
        "files": entries, "sources": sources,
    }


def write(scratch: str) -> dict:
    files = fixtures()
    manifest = build_manifest(files, jax_lane(os.path.join(scratch, "build")), scratch)
    os.makedirs(FIXTURES, exist_ok=True)
    for name, (data, _) in files.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
    with open(MANIFEST, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


def check(decode: Callable[[str], np.ndarray], encode: Callable[[np.ndarray, int], bytes]) -> List[str]:
    """The committed fixtures against ``decode`` (a path -> RGB) and
    ``encode`` (image, quality -> JPEG bytes): the names of those that
    match; raises ``AssertionError`` naming the first that does not."""
    with open(MANIFEST) as f:
        manifest = json.load(f)
    matched = []
    for name, want in sorted(manifest["files"].items()):
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            if sha256(f.read()) != want["sha256"]:
                raise AssertionError(f"{name}: the file is not the one the manifest records")
        got = decode(path)
        if list(got.shape) != want["shape"] + [3] or sha256(got) != want["sha256_rgb"]:
            raise AssertionError(f"{name}: decoded to other pixels than libjpeg-turbo's / libpng's")
        matched.append(name)
    for name, want in sorted(manifest["sources"].items()):
        img = source_image(want["seed"], *want["shape"])
        if sha256(img) != want["sha256_pixels"]:
            raise AssertionError(f"{name}: numpy made other source pixels")
        for q, digest in sorted(want["sha256_jpeg"].items(), key=lambda kv: int(kv[0])):
            if sha256(encode(img, int(q))) != digest:
                raise AssertionError(f"{name} at quality {q}: other bytes than the JAX lane's libjpeg")
            matched.append(f"{name}@q{q}")
    return matched


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = write(tmp)
    total = sum(e["bytes"] for e in out["files"].values())
    print(f"{len(out['files'])} files ({total} bytes), {len(out['sources'])} sources x {len(QUALITIES)} qualities "
          f"-> {FIXTURES}", file=sys.stderr)
