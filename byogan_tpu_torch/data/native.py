"""ctypes bridge to the native image-IO library (byogan_tpu/data/native.py).

``load_library()`` builds the port's codecs (``native/*.cpp``, linked to
zlib alone: ``native/build.py``) at first use and loads them once per
process.  ``decode_image`` reads PNG and JPEG files bit for bit with the
JAX package's libpng and libjpeg-turbo lane (16-bit gray PNGs, where its
lanes part, as either lane reads them); the JPEG kinds that lane
refuses or reads otherwise (CMYK, YCCK, lossless, progressive files left
for block smoothing), WebP files (VP8, VP8L, VP8X with its alpha
dropped, the first frame of an animation), GIF files (the first frame)
and TIFF files (the first page; BigTIFF, CCITT fax and CIELab among
them) bit for bit with its Pillow lane (libjpeg-turbo 3.1.3, libwebp,
Pillow 12.1.0's GIF decoder, libtiff 4.7.1, LittleCMS 2.17's Lab -> sRGB
transform); ``lab_to_rgb`` runs that transform alone (a Lab PSD's
planes); ``decode_buffer`` does the same as ``decode_image`` for bytes in
memory (an icon's PNG frame), and ``decode_blp_jpeg`` for a BLP1 mip's
JPEG; ``pnm_plain``, ``tga_rle``, ``packbits``, ``pcx_rle``, ``sgi_rle``,
``qoi``, ``sun_rle``, ``icns_rle``, ``xbm``, ``msp_rle``, ``fli`` and
``im_bits`` run the sequential loops of ``data/images.py``'s PNM, Targa,
PSD, PCX, SGI, QOI, Sun raster, ICNS, XBM, MSP, FLI and IM readers as
Pillow's decoders do;
``bcn`` decodes the BCn blocks of DDS,
FTEX and BLP2 textures as Pillow's bcn decoder and BLP plugin do;
``decode_jpeg2000`` a JPEG 2000 codestream or JP2 file as Pillow's
decoder over OpenJPEG 2.5.4 fills an image of Pillow's mode;
``decode_avif`` an AVIF item's AV1 streams (the port's AV1 intra decoder)
into the RGB Pillow's decoder over libavif 1.3.0 and dav1d makes, and
``av1_planes`` a stream's planes before the colour conversion;
``encode_jpeg`` writes libjpeg's JPEG bytes.  All of it runs on
any machine with a C++ compiler and zlib.  A build that fails raises,
naming the compiler's error: there is no other lane to fall back on.
ctypes releases the interpreter lock during each call, so threads decode
in parallel.
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import Optional, Tuple

import numpy as np

from byogan_tpu_torch.native import build as native_build

ABI_VERSION = 17
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
    -27: "a big-endian (MM) BigTIFF, which Pillow 12.1.0 takes for a classic TIFF (it tests the version's first "
         "byte alone) and cannot identify",
    -28: "TIFF files with JPEG compression of other samples than 8-bit gray, RGB, CMYK or YCbCr, or 12-bit gray, "
         "are not read by the PyTorch port",
    -29: "TIFF files with CCITT (fax) compression of other samples than 1-bit gray or a 1-bit palette, which "
         "libtiff does not decode (Bits/sample must be 1 for Group 3/4 encoding/decoding)",
    -30: "TIFF files of LogLuv or LogL data are not read by the PyTorch port",
    -31: "TIFF files with this compression (WebP, JBIG, JPEG 2000, LERC...) are not read by the PyTorch port",
    -32: "TIFF files of YCbCr pixels in this layout (a subsampling libtiff has no routine for, subsampled "
         "separate planes, one sample under compression, bad coefficients) are not read by the "
         "PyTorch port",
    -34: "TIFF files of this photometric interpretation (ICCLab, ITULab, a mask...) are not read by the "
         "PyTorch port",
    -37: "uncompressed TIFF files with FillOrder 2 of MinIsWhite 8-bit gray or 1-, 2- or 4-bit palettes, which "
         "Pillow's raw decoder has no raw mode for (unknown raw mode)",
    -38: "TIFF files of this depth or sample layout are not read by the PyTorch port (it reads 1-, 2-, 4- and "
         "8-bit gray, II 12-bit gray, unsigned and signed 16-bit gray, 32-bit integer and float gray, 8-bit gray with alpha, 8- "
         "and 16-bit RGB with extra samples, 1- to 8-bit palettes, 8- and 16-bit CMYK and 8-bit Lab of three samples, as "
         "Pillow's keys list them)",
    -39: "a TIFF predictor that libtiff refuses on these samples",
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
    -50: "CCITT (fax) data that libtiff decodes only with errors, which Pillow shows as decoded (a bad code word, "
         "an uncompressed-mode extension, a row of the wrong length, data that end before the last row)",
    -51: "an ICNS RLE run past the end of its channel (Pillow: Error reading channel)",
    -52: "an MSP file cut short in its row map (Pillow: Truncated MSP file in row map)",
    -53: "an MSP row cut short by the file's end (Pillow: Truncated MSP file, expected more bytes on a row)",
    -54: "an MSP run cut short by its row's end (Pillow: Corrupted MSP file in row)",
    -55: "MSP rows that decode to fewer bytes than the image holds (Pillow: not enough image data)",
    -56: "FLI/FLC frame data past the frame's end or a run past its row (Pillow: image buffer overrun error)",
    -57: "an FLI/FLC chunk of no size (Pillow: decoding error)",
    -58: "an FLI/FLC frame of an unknown chunk, or a first frame that is not a frame chunk (Pillow: unknown "
         "error)",
    -59: "a big-endian (MM) 12-bit gray TIFF: Pillow's one key of 12-bit gray is little-endian's, so it cannot "
         "identify the file",
    -60: "a PNG chunk after the image data cut short by the file's end (Pillow: Truncated File Read)",
    -61: "a PNG chunk after the image data that Pillow's chunk handler refuses (a short IHDR, tRNS, gAMA, cHRM, "
         "sRGB, pHYs, acTL, fcTL or fdAT, an unknown filter or compression method, text inflating past "
         "MAX_TEXT_CHUNK, an APNG sequence or frame error)",
    -62: "an LZMA TIFF strip whose .xz block has a BCJ filter (x86, PowerPC, IA-64, ARM, ARM-Thumb, SPARC, ARM64, "
         "RISC-V), which liblzma decodes and libtiff never writes: not read by the PyTorch port",
    -63: "a ZSTD TIFF strip whose frame names a dictionary (libzstd: Dictionary mismatch)",
    -64: "an old-style JPEG TIFF in a layout the PyTorch port does not read (tiles, separate planes, other samples "
         "than 8-bit gray or YCbCr, FillOrder 2, a frame built from the tags taller than 65535 rows, whose height "
         "libtiff cuts to 16 bits and whose rows below that Pillow shows as libtiff's buffers held them), or whose "
         "tags libtiff's codec refuses (no JPEGQTables, strips that do not hold whole rows of blocks)",
    -65: "a 12-bit JPEG TIFF strip or tile of an odd width: libtiff packs the samples two at a time and leaves each "
         "row's last one unwritten, where Pillow shows whatever its buffer held",
    -66: "a JPEG 2000 codestream or JP2 box that OpenJPEG's strict mode refuses, or one cut short or damaged "
         "(Pillow: broken data stream when reading image file)",
    -67: "HTJ2K (JPEG 2000 Part 15) code-blocks, which OpenJPEG 2.5.4 decodes and the PyTorch port does not read",
    -68: "a JPEG 2000 codestream with Part 2 markers (MCT, MCC, MCO, CBD) or a component whose top resolution level "
         "has no packet, which the PyTorch port does not read",
    -69: "JPEG 2000 components, colour space and mode that Pillow's decoder has no unpacker for (five or more "
         "components, an ICC or unknown colour space, subsampled gray, a palette of gray...; Pillow: broken data "
         "stream when reading image file)",
    -70: "an AV1 stream dav1d refuses, or one cut short or damaged (libavif: Failed to decode image)",
    -72: "AVIF film grain (film_grain_params_present, apply_grain), which the PyTorch port does not read",
    -74: "AVIF quantizer matrices (using_qmatrix), which the PyTorch port does not read",
    -75: "AVIF superresolution (use_superres), which the PyTorch port does not read",
    -76: "AVIF layered image (spatial layers in the AV1 operating points), which the PyTorch port does not read",
    -77: "AVIF stream whose first frame is not a key or intra-only frame, which the PyTorch port does not read",
    -78: "AVIF frame of another size than its item's 'ispe', which libavif scales to that size and the PyTorch "
         "port does not read",
    -79: "the identity matrix with subsampled chroma, YCgCo of limited range, or a matrix libavif does not know (3, "
         "10, 11, 13, 14, 16 and above), which libavif does not convert (libavif: Reformat failed)",
    -80: "AVIF colour conversion of libavif's float bilinear chroma path (YCgCo or another matrix than BT.601, "
         "BT.709 and BT.2020 in subsampled chroma), of YCgCo-Re or of a chroma-derived matrix of other primaries, which "
         "the PyTorch port does not read",
    -81: "AVIF alpha plane of another size than its image, which libavif scales to that size and the PyTorch port "
         "does not read",
    -82: "AVIF alpha plane of another bit depth than its image (libavif: Decoding of alpha plane failed)",
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
    "byogan_decode_blp_jpeg": [_P, _N, _P, _IP, _IP],
    "byogan_pnm_plain": [_P, _N, _I, _I, _I, _I, _I, _P],
    "byogan_tga_rle": [_P, _N, _I, _I, _I, _P],
    "byogan_packbits": [_P, _N, _I, _I, _P],
    "byogan_pcx_rle": [_P, _N, _I, _I, _P],
    "byogan_sgi_rle": [_P, _N, _I, _I, _I, _I, _P],
    "byogan_qoi": [_P, _N, _I, _N, _P],
    "byogan_sun_rle": [_P, _N, _N, _N, _P],
    "byogan_icns_rle": [_P, _N, _N, _P],
    "byogan_xbm": [_P, _N, _I, _I, _P],
    "byogan_msp_rle": [_P, _N, _I, _I, _P],
    "byogan_fli": [_P, _N, _I, _I, _P],
    "byogan_im_bits": [_P, _N, _I, _I, _I, _P],
    "byogan_lab_rgb": [_P, _N, _P],
    "byogan_bcn": [_P, _N, _I, _I, _I, _P],
    "byogan_unfilter": [_P, _I, _I, _I, _P],
    "byogan_encode_jpeg": [_S, _P, _I, _I, _I],
    "byogan_decode_vp8_yuv": [_S, _P, _P, _P, _IP, _IP],
    "byogan_xz": [_P, _N, ctypes.c_longlong, _P, _N, ctypes.POINTER(_N)],
    "byogan_zstd": [_P, _N, ctypes.c_longlong, _P, _N, ctypes.POINTER(_N)],
    "byogan_decode_jpeg2000": [_P, _N, _I, _I, _I, _P],
    "byogan_decode_avif": [_P, _N, _P, _N, _P, _I, _I, _P, _P],
    "byogan_decode_av1": [_P, _N, _P, _P, _P, _P, _N],
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


def decode_blp_jpeg(data: bytes, name: str) -> np.ndarray:
    """A BLP1 mip's JPEG stream as uint8 RGB, as ``decode_buffer`` decodes a
    JPEG but for four components, which are read as CMYK whatever the Adobe
    marker says (BlpImagePlugin sets Pillow's jpegmode to CMYK: no YCCK
    conversion); ``name`` is the file errors name."""
    lib = load_library()
    return _decode(lambda out, h, w: lib.byogan_decode_blp_jpeg(data, len(data), out, h, w), name, None)


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


def sun_rle(data: bytes, name: str, row_bytes: int, rows: int) -> np.ndarray:
    """The rows of a Sun raster RLE image from ``data``, the bytes after its
    colour map: uint8 (rows, row_bytes), as Pillow's SunRleDecode.c reads
    them (rows not padded, a run going on into the next rows)."""
    out = np.empty((rows, row_bytes), np.uint8)
    rc = load_library().byogan_sun_rle(data, len(data), row_bytes, rows, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "Sun raster RLE decode", rc)
    return out


def xbm(data: bytes, name: str, row_bytes: int, rows: int) -> np.ndarray:
    """The rows of an XBM image from ``data``, the bytes after its header:
    uint8 (rows, row_bytes), each byte the two characters after the next
    'x' (a character other than a hex digit counts 0), as Pillow's
    XbmDecode.c reads them; bits least significant first."""
    out = np.empty((rows, row_bytes), np.uint8)
    rc = load_library().byogan_xbm(data, len(data), row_bytes, rows, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "XBM decode", rc)
    return out


def msp_rle(data: bytes, name: str, row_bytes: int, rows: int) -> np.ndarray:
    """The rows of an MSP version 2 image from ``data``, its bytes from
    offset 32 (the row map, then the rows): uint8 (rows, row_bytes) of 1-bit
    pixels, most significant first, as MspImagePlugin.py's MspDecoder
    writes its rows one after the other and reads them back."""
    out = np.empty((rows, row_bytes), np.uint8)
    rc = load_library().byogan_msp_rle(data, len(data), row_bytes, rows, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "MSP RLE decode", rc)
    return out


def fli(data: bytes, name: str, w: int, h: int) -> np.ndarray:
    """The first frame of an FLI/FLC animation from ``data``, its bytes from
    offset 128 to the file's end: uint8 (h, w) palette indices, as
    Pillow's FliDecode.c applies the frame's chunks (BLACK, BRUN, COPY,
    LC, SS2; colour and PSTAMP chunks skipped) fed as ImageFile.load feeds
    it."""
    out = np.empty((h, w), np.uint8)
    rc = load_library().byogan_fli(data, len(data), w, h, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "FLI frame decode", rc)
    return out


def im_bits(data: bytes, name: str, bits: int, w: int, h: int) -> np.ndarray:
    """An IM file's "L*n" samples from ``data``, its bytes from the end of
    its header: float32 (h, w), as Pillow's bit decoder reads them under
    ImImagePlugin's arguments (``bits`` a code, least significant bit
    first, rows bottom-up and padded to a byte)."""
    out = np.empty((h, w), np.float32)
    rc = load_library().byogan_im_bits(data, len(data), bits, w, h, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "IM bit decode", rc)
    return out


def icns_rle(data: bytes, name: str, pixels: int) -> np.ndarray:
    """The R, G and B channels of an ICNS 24-bit RLE element, ``data`` from
    its first byte to the file's end: uint8 (3, pixels), as Pillow's
    ``IcnsImagePlugin.read_32`` reads them."""
    out = np.empty((3, pixels), np.uint8)
    rc = load_library().byogan_icns_rle(data, len(data), pixels, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "ICNS RLE decode", rc)
    return out


#: the formats of ``bcn`` (``native/codec.h``'s BcnFormat) and the channels
#: each gives: BC1 to BC7 as Pillow's bcn decoder gives them (DDS, FTEX),
#: and BLP2's DXT1 (three channels, or four where the file has alpha),
#: DXT3 and DXT5 as BlpImagePlugin.py's Python decodes them
BCN = {"BC1": (1, 4), "BC2": (2, 4), "BC3": (3, 4), "BC4": (4, 1), "BC5": (5, 3), "BC5S": (6, 3), "BC6H": (7, 3),
       "BC6HS": (8, 3), "BC7": (9, 4), "BLP DXT1": (10, 3), "BLP DXT1 alpha": (11, 4), "BLP DXT3": (12, 4),
       "BLP DXT5": (13, 4)}


def bcn(data: bytes, name: str, pixel_format: str, w: int, h: int) -> np.ndarray:
    """The 4 x 4 blocks of a w x h BCn texture, ``data`` from its first
    block, as uint8 (h, w, channels) of ``BCN[pixel_format]`` (``native/bcn.cpp``):
    blocks in rows, the edge blocks' pixels past the image dropped."""
    code, channels = BCN[pixel_format]
    out = np.empty((h, w, channels), np.uint8)
    rc = load_library().byogan_bcn(data, len(data), code, w, h, out.ctypes.data)
    if rc != 0:
        raise _failed(name, f"{pixel_format} block decode", rc)
    return out


#: Pillow's JPEG 2000 modes in the order of ``native/jpeg2000.cpp``'s Mode,
#: and the bytes a pixel of each in Pillow's image
J2K_MODES = {"L": 1, "I;16": 2, "LA": 4, "RGB": 4, "RGBA": 4, "CMYK": 4, "P": 1, "PA": 4}


def decode_jpeg2000(data: bytes, name: str, mode: str, w: int, h: int) -> np.ndarray:
    """A JPEG 2000 codestream or JP2 file as Pillow 12.1.0's decoder
    (OpenJPEG 2.5.4, then Jpeg2KDecode.c's unpackers, YCbCr converted to
    RGB where they convert it) fills an image of Pillow's ``mode`` and
    w x h pixels (``native/jpeg2000.cpp``): uint8 (h, w, bytes a pixel),
    I;16 as its two little-endian bytes."""
    out = np.empty((h, w, J2K_MODES[mode]), np.uint8)
    rc = load_library().byogan_decode_jpeg2000(data, len(data), list(J2K_MODES).index(mode), w, h, out.ctypes.data)
    if rc != 0:
        raise _failed(name, "JPEG 2000 decode", rc)
    return out


#: the AVIF kinds the port refuses by name (ROADMAP §3 fault 7's AVIF queue)
AVIF_REFUSED = (-72, -74, -75, -76, -77, -78, -80, -81)
#: the fields of ``native/av1.h``'s Counts, in order, and their lengths
AV1_COUNTS = (("partition", 10), ("y_mode", 13), ("uv_mode", 14), ("filter_intra_mode", 5), ("palette_y", 9),
              ("palette_uv", 9), ("tx_size", 19), ("tx_type", 16), ("cdef_on", 1), ("cdef_off", 1), ("lr_type", 4),
              ("lossless", 1), ("superblock128", 1), ("tiles", 1), ("use_intrabc", 2), ("mv_joint", 4),
              ("mv_class", 11), ("txfm_split", 3), ("inter_tx_type", 16), ("bit_depth", 12))


def decode_avif(color: bytes, alpha: Optional[bytes], name: str, w: int, h: int,
                nclx: Optional[Tuple[int, int, int, int]],
                premultiplied: bool, counts: Optional[dict] = None) -> np.ndarray:
    """An AVIF image's RGB (uint8 (h, w, 3)) as Pillow 12.1.0 reads it and
    ``convert("RGB")`` keeps it: the colour item's AV1 stream (and the alpha
    item's, if any) through the port's AV1 decoder, then libavif 1.3.0's
    YUV-to-RGB (``native/avif_rgb.cpp``).  ``nclx`` is the item's nclx
    (primaries, transfer, matrix, full range) or None, where the stream's
    own colour description and range hold.  ``counts``, if given, is filled with what the
    colour stream met (``AV1_COUNTS``' fields, each a list)."""
    params = (ctypes.c_int32 * 8)(int(nclx is not None), *(nclx or (2, 2, 2, 0))[:3], int(premultiplied), 0, 0,
                                  (nclx or (0, 0, 0, 0))[3])
    raw = (ctypes.c_int32 * sum(n for _, n in AV1_COUNTS))() if counts is not None else None
    alpha = alpha or b""
    lib = load_library()
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.byogan_decode_avif(color, len(color), alpha or None, len(alpha), params, w, h, out.ctypes.data, raw)
    if rc in AVIF_REFUSED:
        what = re.sub(r",? which (the PyTorch port does not read|libavif scales to that size and the PyTorch port "
                      r"does not read)", "", ERRORS[rc])
        raise OSError(f"{name}: {what} is not read by the PyTorch port")
    if rc != 0:
        raise _failed(name, "AVIF decode", rc)
    if counts is not None:
        at = 0
        for field, n in AV1_COUNTS:
            counts[field] = list(raw[at:at + n])
            at += n
    return out


def av1_planes(obus: bytes, name: str = "AV1") -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """An AV1 stream's Y, U and V planes (uint8, or uint16 of 10- or 12-bit
    samples; U and V None in 4:0:0) as the port's AV1 decoder makes them
    (``native/av1_*.cpp``), before any colour conversion: what the tests
    hold to libdav1d's planes."""
    info = (ctypes.c_int32 * 6)()
    cap = max(1 << 16, 64 * len(obus))
    while True:
        bufs = [np.empty(cap, np.uint8) for _ in range(3)]
        rc = load_library().byogan_decode_av1(obus, len(obus), info, *(b.ctypes.data for b in bufs), cap)
        if rc != -5:
            break
        cap = 6 * info[0] * info[1]
    if rc != 0:
        raise _failed(name, "AV1 decode", rc)
    w, h, sx, sy, mono, depth = info
    if depth > 8:
        bufs = [b.view(np.uint16) for b in bufs]
    y = bufs[0][:w * h].reshape(h, w)
    if mono:
        return y, None, None
    cw, ch = (w + sx) >> sx, (h + sy) >> sy
    return y, bufs[1][:cw * ch].reshape(ch, cw), bufs[2][:cw * ch].reshape(ch, cw)


def stream_decode(kind: str, data: bytes, occ: Optional[int] = None, cap: int = 1 << 26) -> Tuple[int, bytes]:
    """``data`` decoded by the port's .xz (``kind`` "xz", ``native/xz.cpp``)
    or Zstandard (``"zstd"``, ``native/zstd.cpp``) decoder: ``occ`` bytes of
    a TIFF strip or tile as libtiff's LZMA or ZSTD codec reads them, or,
    where ``occ`` is None, the whole stream (at most ``cap`` bytes).  Returns
    the library's code (0, or ``ERRORS``' key) and the bytes made."""
    out = ctypes.create_string_buffer(max(1, cap if occ is None else occ))
    written = _N()
    call = {"xz": "byogan_xz", "zstd": "byogan_zstd"}[kind]
    rc = getattr(load_library(), call)(data, len(data), -1 if occ is None else occ, out, len(out),
                                       ctypes.byref(written))
    return rc, out.raw[:min(written.value, len(out))]


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """8-bit CIE Lab triples, uint8 (..., 3) of Pillow's LAB bands (L, then
    a and b with 128 as zero), as uint8 sRGB of the same shape: what
    Pillow 12.1.0's ``convert("RGB")`` of a LAB image makes of them through
    LittleCMS 2.17 (``native/lab.cpp``)."""
    lab = np.ascontiguousarray(lab, np.uint8)
    if lab.shape[-1:] != (3,):
        raise ValueError(f"expected (..., 3) Lab triples, got {lab.shape}")
    out = np.empty_like(lab)
    load_library().byogan_lab_rgb(lab.ctypes.data, lab.size // 3, out.ctypes.data)
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
