"""ctypes bridge to the native image-IO library (byogan_tpu/data/native.py).

``load_library()`` builds the port's codecs (``native/*.cpp``, linked to
zlib alone: ``native/build.py``) at first use and loads them once per
process.  ``decode_image`` reads PNG and JPEG files bit for bit with the
JAX package's libpng and libjpeg-turbo lane (16-bit gray PNGs, where its
lanes part, as either lane reads them); the JPEG kinds that lane
refuses or reads otherwise (CMYK, YCCK, lossless, progressive files left
for block smoothing), WebP files (VP8, VP8L, VP8X with its alpha
dropped, the first frame of an animation), GIF files (the first frame)
and TIFF files (the first page) bit for bit with its Pillow lane
(libjpeg-turbo 3.1.3, libwebp, Pillow 12.1.0's GIF decoder, libtiff
4.7.1); ``decode_buffer`` does the same for bytes in memory (an icon's PNG
frame); ``pnm_plain``, ``tga_rle``, ``packbits``, ``pcx_rle``, ``sgi_rle``
and ``qoi`` run the sequential loops of ``data/images.py``'s PNM, Targa,
PSD, PCX, SGI and QOI readers as Pillow's decoders do;
``encode_jpeg`` writes libjpeg's JPEG bytes.  All of it runs on
any machine with a C++ compiler and zlib.  A build that fails raises,
naming the compiler's error: there is no other lane to fall back on.
ctypes releases the interpreter lock during each call, so threads decode
in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from byogan_tpu_torch.native import build as native_build

ABI_VERSION = 9
#: the JAX package's lanes, where they part (``native/codec.h``'s Lane):
#: "native", its libpng lane (its loader), and "pillow", its Pillow lane
#: (its prep and cli.project); only 16-bit gray PNGs decode otherwise
LANES = {"native": 0, "pillow": 1}
#: the library's return codes (native/codec.h)
ERRORS = {
    -1: "cannot open the file",
    -2: "not a PNG, JPEG, WebP, GIF or TIFF file",
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
    -20: "the GIF is cut short or malformed before its image data, where Pillow cannot identify it",
    -21: "the GIF holds no image",
    -22: "broken GIF data stream: an LZW code past the table, where Pillow's decoder stops",
    -23: "the GIF's LZW minimum code size is above 12",
    -24: "the GIF's first frame has no width or no height",
    -25: "more pixels than Pillow opens (twice Image.MAX_IMAGE_PIXELS)",
    -26: "a TIFF header or first directory that does not describe an image Pillow reads (a bad version, a tag "
         "missing or not an integer, strip or tile offsets that do not match the image)",
    -27: "BigTIFF files are not read by the PyTorch port",
    -28: "TIFF files with old-style JPEG compression, or with JPEG compression of other samples than 8-bit gray, "
         "RGB, CMYK or YCbCr, are not read by the PyTorch port",
    -29: "TIFF files with CCITT (fax) compression are not read by the PyTorch port",
    -30: "TIFF files of LogLuv or LogL data are not read by the PyTorch port",
    -31: "TIFF files with this compression (LZMA, ZSTD, WebP, JBIG...) are not read by the PyTorch port",
    -32: "TIFF files of YCbCr pixels in this layout (a subsampling libtiff has no routine for, subsampled "
         "separate planes, one sample under compression, bad coefficients) are not read by the "
         "PyTorch port",
    -34: "TIFF files of this photometric interpretation (Lab, which Pillow converts through LittleCMS, a "
         "mask...) are not read by the PyTorch port",
    -37: "uncompressed TIFF files with FillOrder 2 of MinIsWhite 8-bit gray or 1-, 2- or 4-bit palettes, which "
         "Pillow's raw decoder has no raw mode for (unknown raw mode)",
    -38: "TIFF files of this depth or sample layout are not read by the PyTorch port (it reads 1-, 2-, 4- and "
         "8-bit gray, unsigned and signed 16-bit gray, 32-bit float gray, 8-bit gray with alpha, 8- and 16-bit "
         "RGB with extra samples, 1- to 8-bit palettes and 8- and 16-bit CMYK, as Pillow's keys list them)",
    -39: "a TIFF predictor that libtiff refuses on these samples",
    -40: "TIFF files of old-style LZW codes are not read by the PyTorch port",
    -41: "a plain PBM sample other than 0 or 1 (Pillow: Invalid token for this mode)",
    -42: "a plain PNM token longer than 10 characters (Pillow: Token too long found in data)",
    -43: "a plain PNM token that is not an integer (Pillow: invalid literal for int())",
    -44: "a negative plain PNM sample (Pillow: Channel value is negative)",
    -45: "a plain PNM sample above its maxval (Pillow: Channel value too large for this mode)",
    -46: "a Targa RLE run packet past the end of its row (Pillow: buffer overrun when reading image file)",
    -47: "a JPEG-compressed TIFF strip or tile that does not match the file's tags (its size, components or "
         "sampling factors), which libtiff refuses",
    -48: "a PCX RLE run past the end of its row (Pillow: buffer overrun when reading image file)",
    -49: "an SGI RLE offset or length table past the file's end, a row outside the file's data or a run past the "
         "end of its row (Pillow: buffer overrun when reading image file)",
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_char_p
_IP = ctypes.POINTER(ctypes.c_int)
_N = ctypes.c_size_t
SIGNATURES = {
    "byogan_abi_version": [],
    "byogan_decode": [_S, _P, _IP, _IP, _I],
    "byogan_decode_buffer": [_P, _N, _P, _IP, _IP, _I],
    "byogan_pnm_plain": [_P, _N, _I, _I, _I, _I, _I, _P],
    "byogan_tga_rle": [_P, _N, _I, _I, _I, _P],
    "byogan_packbits": [_P, _N, _I, _I, _P],
    "byogan_pcx_rle": [_P, _N, _I, _I, _P],
    "byogan_sgi_rle": [_P, _N, _I, _I, _I, _I, _P],
    "byogan_qoi": [_P, _N, _I, _N, _P],
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


def _decode(call, name: str, shape: Optional[Tuple[int, int]]) -> np.ndarray:
    """``call(out, h, w)`` (a decode with ``byogan_decode``'s size protocol)
    into a uint8 RGB array: one call where ``shape`` is right, else a
    first call reads the size and a second decodes."""
    h, w = shape or (0, 0)
    for _ in range(2):
        out = np.empty((h, w, 3), np.uint8)
        hc, wc = _I(h), _I(w)
        rc = call(out.ctypes.data if out.size else None, ctypes.byref(hc), ctypes.byref(wc))
        if rc != -5:
            break
        h, w = hc.value, wc.value
    if rc != 0:
        raise _failed(name, "decode", rc)
    return out


def decode_image(path: str, shape: Optional[Tuple[int, int]] = None, lane: str = "native") -> np.ndarray:
    """A PNG, JPEG, WebP, GIF or TIFF file (told apart by its first bytes)
    as uint8 RGB (H, W, 3).  ``shape`` is the (H, W) the caller expects: where it is
    right, one call opens and decodes the file; otherwise the first call
    reads the size and a second decodes.  ``lane`` (a key of ``LANES``)
    picks the JAX package's lane where its lanes part: a 16-bit gray PNG's
    samples cut to their high byte ("native") or clipped at 255
    ("pillow")."""
    flag = LANES[lane]
    lib = load_library()
    return _decode(lambda out, h, w: lib.byogan_decode(path.encode(), out, h, w, flag), path, shape)


def decode_buffer(data: bytes, name: str, lane: str = "native") -> np.ndarray:
    """``decode_image`` of a file's bytes held in memory (an ICO's PNG
    frame); ``name`` is the file errors name."""
    flag = LANES[lane]
    lib = load_library()
    return _decode(lambda out, h, w: lib.byogan_decode_buffer(data, len(data), out, h, w, flag), name, None)


def pnm_plain(data: bytes, name: str, h: int, w: int, bands: int, maxval: int, wide: bool) -> np.ndarray:
    """The samples of a plain PBM, PGM or PPM from ``data``, the bytes after
    its header, as uint8 (h, w, bands), as Pillow's ``PpmPlainDecoder``
    reads them (``maxval`` 0: P1, '1' black, '0' white; ``wide``: gray above
    maxval 255, which Pillow reads as mode I, scaled to 16 bits and then
    clipped at 255)."""
    out = np.empty((h, w, bands), np.uint8)
    rc = load_library().byogan_pnm_plain(data, len(data), bands, w, h, maxval, int(wide), out.ctypes.data)
    if rc != 0:
        raise _failed(name, "plain PNM decode", rc)
    return out


def tga_rle(data: bytes, name: str, pixel_bytes: int, row_bytes: int, rows: int) -> np.ndarray:
    """The rows of a Targa RLE image from ``data``, the bytes after its
    colour map, in file order: uint8 (rows, row_bytes), as Pillow's
    TgaRleDecode.c reads packets of ``pixel_bytes``-byte pixels."""
    out = np.empty((rows, row_bytes), np.uint8)
    rc = load_library().byogan_tga_rle(data, len(data), pixel_bytes, row_bytes, rows, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "Targa RLE decode", rc)
    return out


def packbits(data: bytes, name: str, row_bytes: int, rows: int) -> np.ndarray:
    """The rows of a PSD channel's PackBits stream, ``data`` from its first
    byte to the file's end: uint8 (rows, row_bytes), as Pillow's
    PackbitsDecode.c reads them (a packet cut at its row's end)."""
    out = np.empty((rows, row_bytes), np.uint8)
    rc = load_library().byogan_packbits(data, len(data), row_bytes, rows, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "PSD PackBits decode", rc)
    return out


def pcx_rle(data: bytes, name: str, row_bytes: int, rows: int) -> np.ndarray:
    """The rows of a PCX image from ``data``, the bytes after its header:
    uint8 (rows, row_bytes), as Pillow's PcxDecode.c reads them."""
    out = np.empty((rows, row_bytes), np.uint8)
    rc = load_library().byogan_pcx_rle(data, len(data), row_bytes, rows, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "PCX RLE decode", rc)
    return out


def sgi_rle(data: bytes, name: str, bpc: int, bands: int, xsize: int, ysize: int) -> np.ndarray:
    """The rows of an SGI RLE image from ``data``, the bytes after its
    header, in the file's order (bottom-up): uint8 (ysize, xsize, bands *
    bpc), samples interleaved (16-bit ones big-endian), as Pillow's
    SgiRleDecode.c reads them."""
    out = np.empty((ysize, xsize, bands * bpc), np.uint8)
    rc = load_library().byogan_sgi_rle(data, len(data), bpc, bands, xsize, ysize, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "SGI RLE decode", rc)
    return out


def qoi(data: bytes, name: str, bands: int, h: int, w: int) -> np.ndarray:
    """The pixels of a QOI image from ``data``, the bytes after its header:
    uint8 (h, w, bands), as Pillow's QoiDecoder reads them."""
    out = np.empty((h, w, bands), np.uint8)
    rc = load_library().byogan_qoi(data, len(data), bands, h * w, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "QOI decode", rc)
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
