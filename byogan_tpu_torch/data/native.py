"""ctypes bridge to the native image-IO library (byogan_tpu/data/native.py).

``load_library()`` builds the port's codecs (``native/*.cpp``, linked to
zlib alone: ``native/build.py``) at first use and loads them once per
process.  ``decode_image`` reads PNG and JPEG files bit for bit with the
JAX package's libpng and libjpeg-turbo lane; the JPEG kinds that lane
refuses or reads otherwise (CMYK, YCCK, lossless, progressive files left
for block smoothing) and WebP files (VP8, VP8L, VP8X with its alpha
dropped, the first frame of an animation) bit for bit with its Pillow lane
(libjpeg-turbo 3.1.3, libwebp); ``encode_jpeg`` writes libjpeg's JPEG
bytes.  All of it runs on any machine with a C++ compiler and zlib.  A build
that fails raises, naming the compiler's error: there is no other lane
to fall back on.  ctypes releases the interpreter lock during each call,
so threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from byogan_tpu_torch.native import build as native_build

ABI_VERSION = 4
#: the library's return codes (native/codec.h)
ERRORS = {
    -1: "cannot open the file",
    -2: "not a PNG, JPEG or WebP file",
    -3: "out of memory",
    -4: "the decoder refused the data: it breaks the format's rules",
    -5: "its size changed while it was read",
    -6: "it does not decode to RGB",
    -8: "unknown PNG row filter",
    -9: "a PNG chunk's CRC does not match",
    -10: "the file is truncated",
    -12: "unsupported JPEG feature: samples of other than 8 bits (12-bit)",
    -14: "unsupported JPEG feature: a lossless frame that Pillow's libjpeg-turbo does not read (arithmetic coding "
         "(SOF11), a precision other than 8 bits, or a JFIF or Adobe YCbCr colour space)",
    -15: "unsupported JPEG feature: a hierarchical frame",
    -16: "unsupported JPEG feature: a fractional chroma sampling ratio",
    -18: "the animated WebP's first frame lies outside its canvas",
    -19: "the WebP's VP8X canvas is not its frame's size",
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_char_p
_IP = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "byogan_abi_version": [],
    "byogan_decode": [_S, _P, _IP, _IP],
    "byogan_unfilter": [_P, _I, _I, _I, _P],
    "byogan_encode_jpeg": [_S, _P, _I, _I, _I],
    "byogan_decode_vp8_yuv": [_S, _P, _P, _P, _IP, _IP],
}


class _Loaded:
    """The process's library handle, or the error that kept it from loading."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.error: Optional[Exception] = None


_LOADED = _Loaded()


def _open(force: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native_build.build(force=force)))
    for name, argtypes in SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = _I
    if lib.byogan_abi_version() != ABI_VERSION:
        raise OSError(f"ABI version {lib.byogan_abi_version()}, expected {ABI_VERSION}")
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed.  Raises ``RuntimeError``
    (the compiler's output) or ``OSError`` (the loader's) if it cannot be
    built or loaded, every time it is asked for."""
    with _LOADED.lock:
        if _LOADED.lib is None and _LOADED.error is None:
            try:
                try:
                    _LOADED.lib = _open(force=False)
                except OSError:  # built for another machine, or an older ABI: build it here
                    _LOADED.lib = _open(force=True)
            except (OSError, RuntimeError) as e:
                _LOADED.error = e
        if _LOADED.error is not None:
            raise type(_LOADED.error)(f"the native image-IO library did not build or load: {_LOADED.error}")
        return _LOADED.lib


def _failed(path: str, what: str, rc: int) -> OSError:
    return OSError(f"{path}: {what} failed: {ERRORS.get(rc, 'error')} ({rc})")


def decode_image(path: str, shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """A PNG, JPEG or WebP file (told apart by its first bytes) as uint8
    RGB (H, W, 3).  ``shape`` is the (H, W) the caller expects: where it is
    right, one call opens and decodes the file; otherwise the first call
    reads the size and a second decodes."""
    lib = load_library()
    h, w = shape or (0, 0)
    for _ in range(2):
        out = np.empty((h, w, 3), np.uint8)
        hc, wc = _I(h), _I(w)
        buf = out.ctypes.data if out.size else None
        rc = lib.byogan_decode(path.encode(), buf, ctypes.byref(hc), ctypes.byref(wc))
        if rc != -5:
            break
        h, w = hc.value, wc.value
    if rc != 0:
        raise _failed(path, "decode", rc)
    return out


def decode_vp8_yuv(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The Y (H, W), U and V ((H + 1) // 2, (W + 1) // 2) planes of a lossy
    WebP file's frame, before the RGB conversion (libwebp's
    ``WebPDecodeYUV``).  For the tests, which hold the decoder and the
    conversion apart; nothing else calls it."""
    lib = load_library()
    hc, wc = _I(0), _I(0)
    rc = lib.byogan_decode_vp8_yuv(path.encode(), None, None, None, ctypes.byref(hc), ctypes.byref(wc))
    if rc == -5:
        h, w = hc.value, wc.value
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        rc = lib.byogan_decode_vp8_yuv(path.encode(), y.ctypes.data, u.ctypes.data, v.ctypes.data,
                                       ctypes.byref(hc), ctypes.byref(wc))
    if rc != 0:
        raise _failed(path, "VP8 decode", rc)
    return y, u, v


def unfilter(raw: bytes, h: int, stride: int, bpp: int) -> Optional[np.ndarray]:
    """PNG's row filters undone on ``h`` inflated scanlines of ``stride``
    bytes (each after its filter byte), ``bpp`` bytes a pixel: (h, stride)
    uint8.  None where ``load_library`` gives None (a caller that took the
    library away, to run ``data/png.py`` in Python alone)."""
    lib = load_library()
    if lib is None:
        return None
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of scanlines, expected {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    rc = lib.byogan_unfilter(raw, h, stride, bpp, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"PNG: {ERRORS[rc]}")
    return out


def _rgb_u8(image: np.ndarray) -> np.ndarray:
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected uint8 (H, W, 3), got {image.dtype} {image.shape}")
    return image


def encode_jpeg(path: str, image: np.ndarray, quality: int = 92) -> None:
    """Write a uint8 RGB (H, W, 3) image as a JPEG file at ``quality``
    (1-100): the bytes libjpeg writes with its defaults (baseline, 4:2:0,
    the standard tables)."""
    image = _rgb_u8(image)
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality must be in [1, 100], got {quality}")
    rc = load_library().byogan_encode_jpeg(path.encode(), image.ctypes.data, image.shape[0], image.shape[1], quality)
    if rc != 0:
        raise _failed(path, "JPEG encode", rc)
