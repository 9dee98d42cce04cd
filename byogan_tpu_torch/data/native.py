"""ctypes bridge to the native image-IO library (byogan_tpu/data/native.py).

``load_library()`` builds ``native/byogan_io.cpp`` at first use
(``native/build.py``) and loads it once per process.  ``features()`` says
what it was compiled with: ``png`` and ``jpeg`` (libpng, libjpeg, found at
build time) and ``unfilter`` (the PNG row unfilter, in every build).  If the
library does not build or load, a warning naming the error is printed
once; PNG files then decode in Python alone (``data/png.py``) and every
call here that needs the library raises ``OSError`` naming the file and the
error.  ctypes releases the interpreter lock during each call, so threads
decode in parallel.
"""

from __future__ import annotations

import ctypes
import threading
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from byogan_tpu_torch.native import build as native_build

ABI_VERSION = 2
#: bits of byogan_io_features()
PNG, JPEG = 1, 2
#: the library's return codes
ERRORS = {
    -1: "cannot open the file",
    -2: "not a PNG or JPEG file",
    -3: "out of memory",
    -4: "the decoder refused the data",
    -5: "its size changed while it was read",
    -6: "it does not decode to RGB",
    -7: "the library for this format was not compiled in",
    -8: "unknown PNG row filter",
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_char_p
_IP = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "byogan_abi_version": [],
    "byogan_io_features": [],
    "byogan_decode": [_S, _P, _IP, _IP],
    "byogan_unfilter": [_P, _I, _I, _I, _P],
    "byogan_encode_jpeg": [_S, _P, _I, _I, _I],
}


class _Loaded:
    """The process's library handle, or the error that kept it from loading."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tried = False
        self.lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None


_LOADED = _Loaded()


def _open(force: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native_build.build(force=force)))
    for name, argtypes in SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = _I
    if lib.byogan_abi_version() != ABI_VERSION:
        raise OSError(f"ABI version {lib.byogan_abi_version()}, expected {ABI_VERSION}")
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if it failed (then
    ``build_error()`` says why)."""
    with _LOADED.lock:
        if not _LOADED.tried:
            _LOADED.tried = True
            try:
                try:
                    _LOADED.lib = _open(force=False)
                except OSError:  # built for another machine's libraries: build it here
                    _LOADED.lib = _open(force=True)
            except (OSError, RuntimeError) as e:
                _LOADED.error = f"{type(e).__name__}: {e}"
                warnings.warn(
                    f"the native image-IO library is unavailable ({_LOADED.error}); PNG files decode in "
                    "Python and JPEG files cannot be read or written", RuntimeWarning, stacklevel=2,
                )
        return _LOADED.lib


def build_error() -> Optional[str]:
    """Why the library did not load, or None."""
    load_library()
    return _LOADED.error


def features() -> Dict[str, bool]:
    """What the loaded library can do: ``png``, ``jpeg``, ``unfilter``."""
    lib = load_library()
    bits = lib.byogan_io_features() if lib is not None else 0
    return {"png": bool(bits & PNG), "jpeg": bool(bits & JPEG), "unfilter": lib is not None}


def unavailable(path: str, fmt: str) -> OSError:
    """The error for ``path`` when the library cannot handle ``fmt``."""
    lib = load_library()
    if lib is None:
        why = f"the native image-IO library did not build ({_LOADED.error})"
    else:
        header = {"PNG": "png.h", "JPEG": "jpeglib.h"}[fmt]
        why = f"the native image-IO library was built without lib{fmt.lower()} (no <{header}> on this machine)"
    return OSError(f"{path}: cannot read or write {fmt} files: {why}")


def _need(path: str, fmt: str, bit: int) -> ctypes.CDLL:
    lib = load_library()
    if lib is None or not lib.byogan_io_features() & bit:
        raise unavailable(path, fmt)
    return lib


def _failed(path: str, what: str, rc: int) -> OSError:
    return OSError(f"{path}: {what} failed: {ERRORS.get(rc, 'error')} ({rc})")


def decode_image(path: str, fmt: str, shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """A PNG or JPEG file (``fmt``, "PNG" or "JPEG" as ``images.sniff``
    read it) as uint8 RGB (H, W, 3), through libpng or libjpeg.  ``shape``
    is the (H, W) the caller expects: where it is right, one call opens
    and decodes the file; otherwise the first call reads the size and a
    second decodes."""
    lib = _need(path, fmt, JPEG if fmt == "JPEG" else PNG)
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


def unfilter(raw: bytes, h: int, stride: int, bpp: int) -> Optional[np.ndarray]:
    """PNG's row filters undone on ``h`` inflated scanlines of ``stride``
    bytes (each after its filter byte), ``bpp`` bytes a pixel: (h, stride)
    uint8.  None when the library is unavailable."""
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
    (1-100) through libjpeg."""
    image = _rgb_u8(image)
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality must be in [1, 100], got {quality}")
    lib = _need(path, "JPEG", JPEG)
    rc = lib.byogan_encode_jpeg(path.encode(), image.ctypes.data, image.shape[0], image.shape[1], quality)
    if rc != 0:
        raise _failed(path, "JPEG encode", rc)
