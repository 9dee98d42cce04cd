"""Image files of a dataset: which are listed, and how each is decoded.

A file is listed by its extension, as the JAX package lists them
(``IMAGE_EXTENSIONS``, byogan_tpu/data/prep.py:25-29), and decoded by its
bytes, as Pillow's ``Image.open`` identifies it: each plugin of Pillow
12.1.0 in its order, by its ``_accept`` test on the first 16 bytes or,
where it has none, by its ``_open`` on the file (``walk``).  PNG, JPEG,
WebP, GIF (the first frame) and TIFF (the first page; BigTIFF, CCITT fax,
Lab, 12-bit gray and old-style LZW among them) go through the port's own
codecs (``data/native.py``); BMP, DIB, ICO and CUR (``_bitmap``), PNM
(``decode_pnm``), Targa (``decode_tga``), PSD (``decode_psd``), PCX
(``decode_pcx``), SGI (``decode_sgi``), QOI (``decode_qoi``), DDS
(``decode_dds``), BLP (``decode_blp``), FTEX (``decode_ftex``), ICNS
(``decode_icns``), Sun raster (``decode_sun``), XBM (``decode_xbm``), XPM
(``decode_xpm``), MSP (``decode_msp``), FLI/FLC (``decode_fli``), DCX
(``decode_dcx``), GBR (``decode_gbr``), PIXAR (``decode_pixar``), FITS
(``decode_fits``), McIdas (``decode_mcidas``), XV thumbnail
(``decode_xv``), IM (``decode_im``), IMT (``decode_imt``), IPTC
(``decode_iptc``), PhotoCD (``decode_pcd``), SPIDER
(``decode_spider``), JPEG 2000 (``decode_jpeg2000``, its pixels from
the port's own decoder) and AVIF (``decode_avif``, its pixels from the
port's own AV1 decoder and libavif's YUV-to-RGB) in numpy below, their sequential loops (plain PNM
samples, Targa RLE packets, PackBits, PCX, SGI, Sun and ICNS RLE, QOI
ops, XBM's hex bytes, MSP's RLE, FLI's chunks, IM's bit decoder), BCn
blocks and a Lab PSD's conversion to sRGB in the native library; each as
the JAX package's lane for it reads it.  A file of another format that
Pillow opens raises ``OSError`` naming the file and the format ("<format>
files are not read by the PyTorch port", with Pillow's own verdict where
it cannot read the format either: MPEG), one that no Pillow plugin
accepts "unknown format", one whose plugin ends Pillow's walk with an
error (an IPTC field length above 132, an IM size that is no number)
Pillow's verdict, and one a decoder refuses names the reason: no listed
file is skipped.
"""

from __future__ import annotations

import gzip
import io
import math
import os
import re
import struct
import zlib
from types import SimpleNamespace
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from byogan_tpu_torch.data import native

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


class NotThisFormat(OSError):
    """Raised where Pillow's ``_open`` of the format fails with an error
    ``Image.open`` takes as "not this plugin's file" (SyntaxError,
    IndexError, TypeError, struct.error): Pillow then tries the plugins
    after it, and so does ``read_image``."""
#: the formats the port decodes; ``walk`` names any other Pillow opens
READ = ("PNG", "JPEG", "BMP", "WebP", "GIF", "TIFF", "DIB", "ICO", "CUR", "PPM", "PCX", "PSD", "QOI", "SGI", "TGA",
        "DDS", "BLP", "FTEX", "ICNS", "Sun raster", "XBM", "XPM", "MSP", "FLI", "DCX", "GBR", "PIXAR", "FITS", "McIdas",
        "XV thumbnail", "IM", "IMT", "IPTC", "PCD", "SPIDER", "JPEG 2000", "AVIF")


def is_image(name: str) -> bool:
    return os.path.splitext(name)[1].lower() in IMAGE_EXTENSIONS


def _u16(b: bytes, at: int, order: str = "<") -> int:
    return struct.unpack_from(order + "H", b, at)[0] if len(b) >= at + 2 else -1


def _u32(b: bytes, at: int, order: str = "<") -> int:
    return struct.unpack_from(order + "I", b, at)[0] if len(b) >= at + 4 else -1


def _raw(data: bytes, at: int, n: int, name: str, fmt: str) -> np.ndarray:
    """``n`` bytes of ``data`` from ``at``, which must hold them (Pillow's
    raw decoder: "image file is truncated")."""
    if at + n > len(data):
        raise OSError(f"{name}: {fmt} truncated ({len(data)} bytes, its pixels end at {at + n})")
    return np.frombuffer(data, np.uint8, n, at)


#: Pillow 12.1.0's plugins in the order ``Image.open`` tries them: the five
#: ``preinit`` loads first (BMP and DIB, GIF, JPEG, PPM, PNG), then the rest
#: as ``init`` registers them.  Each is paired with its ``_accept`` test on
#: the file's first 16 bytes, or with None where the plugin has none and
#: Pillow runs its ``_open`` on the file (``_opens``: IM, IMT, IPTC, PCD,
#: SPIDER and TGA)
ORDER = (
    ("BMP", lambda b: b.startswith(b"BM")),
    ("DIB", lambda b: _u32(b, 0) in (12, 40, 52, 56, 64, 108, 124)),
    ("GIF", lambda b: b.startswith((b"GIF87a", b"GIF89a"))),
    ("JPEG", lambda b: b.startswith(b"\xff\xd8\xff")),
    ("PPM", lambda b: len(b) >= 2 and b[:1] == b"P" and b[1] in b"0123456fy"),
    ("PNG", lambda b: b.startswith(b"\x89PNG\r\n\x1a\n")),
    ("AVIF", lambda b: b[4:8] == b"ftyp" and b[8:12] in (b"avif", b"avis", b"mif1", b"msf1")),
    ("BLP", lambda b: b.startswith((b"BLP1", b"BLP2"))),
    ("BUFR", lambda b: b.startswith((b"BUFR", b"ZCZC"))),
    ("CUR", lambda b: b.startswith(b"\0\0\2\0")),
    ("PCX", lambda b: len(b) >= 2 and b[0] == 10 and b[1] in (0, 2, 3, 5)),
    ("DCX", lambda b: _u32(b, 0) == 987654321),
    ("DDS", lambda b: b.startswith(b"DDS ")),
    ("EPS", lambda b: b.startswith(b"%!PS") or _u32(b, 0) == 0xC6D3D0C5),
    ("FITS", lambda b: b.startswith(b"SIMPLE")),
    ("FLI", lambda b: len(b) >= 16 and _u16(b, 4) in (0xAF11, 0xAF12) and _u16(b, 14) in (0, 3)),
    ("FTEX", lambda b: b.startswith(b"FTEX")),
    ("GBR", lambda b: len(b) >= 8 and _u32(b, 0, ">") >= 20 and _u32(b, 4, ">") in (1, 2)),
    ("GRIB", lambda b: len(b) >= 8 and b.startswith(b"GRIB") and b[7] == 1),
    ("HDF5", lambda b: b.startswith(b"\x89HDF\r\n\x1a\n")),
    ("JPEG 2000", lambda b: b.startswith((b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"))),
    ("ICNS", lambda b: b.startswith(b"icns")),
    ("ICO", lambda b: b.startswith(b"\0\0\1\0")),
    ("IM", None),
    ("IMT", None),
    ("IPTC", None),
    ("McIdas", lambda b: b.startswith(b"\0\0\0\0\0\0\0\x04")),
    ("MPEG", lambda b: b.startswith(b"\0\0\1\xb3")),
    ("TIFF", lambda b: b.startswith((b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                                      b"II\x2b\x00"))),
    ("MSP", lambda b: b.startswith((b"DanM", b"LinS"))),
    ("PCD", None),
    ("PIXAR", lambda b: b.startswith(b"\200\350\000\000")),
    ("PSD", lambda b: b.startswith(b"8BPS")),
    ("QOI", lambda b: b.startswith(b"qoif")),
    ("SGI", lambda b: _u16(b, 0, ">") == 474),
    ("SPIDER", None),
    ("Sun raster", lambda b: _u32(b, 0, ">") == 0x59A66A95),
    ("TGA", None),
    ("WebP", lambda b: b[:4] == b"RIFF" and b[8:12] == b"WEBP"),
    ("WMF", lambda b: b.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"))),
    ("XBM", lambda b: b.lstrip().startswith(b"#define")),
    ("XPM", lambda b: b.startswith(b"/* XPM */")),
    ("XV thumbnail", lambda b: b.startswith(b"P7 332")),
)


def _tga(head: bytes) -> bool:
    """TgaImagePlugin's header test: colour map type 0 or 1, a positive
    size, a depth of 1, 8, 16, 24 or 32 bits."""
    return (len(head) >= 18 and head[1] in (0, 1) and _u16(head, 12) > 0 and _u16(head, 14) > 0
            and head[16] in (1, 8, 16, 24, 32))


def _gbr(head: bytes) -> bool:
    """GbrImagePlugin's ``_open`` checks, which its ``_accept`` leaves to it
    (a QOI of width 1 or 2 passes that): a header of at least 20 bytes,
    version 1 or 2, a size, a depth of 1 or 4, version 2's magic."""
    version = _u32(head, 4, ">")
    return (len(head) >= 20 and _u32(head, 0, ">") >= 20 and version in (1, 2) and _u32(head, 8, ">") > 0
            and _u32(head, 12, ">") > 0 and _u32(head, 16, ">") in (1, 4)
            and (version == 1 or (len(head) >= 28 and head[20:24] == b"GIMP")))


#: what Pillow 12.1.0 makes of an MPEG file, which it identifies and cannot
#: read either (``unreadable`` names it beside the port's refusal)
MPEG_VERDICT = "Pillow identifies an MPEG stream's size and cannot load its pixels: OSError cannot load this image"

#: the first bytes of a file the ``_accept`` tests, GBR's ``_open`` checks
#: and TGA's header test read (the other plugins without an ``_accept``
#: read the file itself)
HEAD = 28


def _opens(fmt: str, f: BinaryIO, head: bytes, name: str):
    """The header that the plugin of ``fmt``, which has no ``_accept``,
    reads from the file ``f`` where it identifies it (its ``_open`` and
    ``ImageFile``'s checks as the port's reader runs them; TGA's: the
    first bytes), which the format's reader then takes; None where it
    does not (``NotThisFormat``).  What Pillow raises beyond SyntaxError,
    IndexError, TypeError and struct.error stops its walk, and raises here
    (``OSError`` naming the file and Pillow's verdict)."""
    if fmt == "TGA":
        return head if _tga(head) else None
    try:
        return _HEADERS[fmt](f, name)
    except NotThisFormat:
        return None


def walk(f: BinaryIO, name: str) -> Iterator[Tuple[str, object]]:
    """The formats that identify the open file ``f`` (``name`` the path
    errors name), in the order Pillow's ``Image.open`` tries them
    (``ORDER``), each with the header its plugin read: a plugin with an
    ``_accept`` by that test on the first 16 bytes (GBR by its ``_open``
    checks too, since its ``_accept`` takes a QOI of width 1 or 2; header
    None), one without by its ``_open`` on the file (``_opens``), which may
    raise Pillow's verdict and end the walk."""
    f.seek(0)
    head = f.read(HEAD)
    prefix = head[:16]
    for fmt, accept in ORDER:
        if accept is None:
            hd = _opens(fmt, f, head, name)
            if hd is not None:
                yield fmt, hd
        elif accept(prefix) and (fmt != "GBR" or _gbr(head)):
            yield fmt, None


def sniff(data: bytes) -> str:
    """The format of a file from its bytes (or its first bytes), as Pillow's
    ``Image.open`` identifies it: the first of ``walk``, a name of ``READ``
    or of another format Pillow opens, or "unknown" where no plugin
    identifies it.  Raises ``OSError`` where a plugin without an
    ``_accept`` stops Pillow's walk with an error (IPTC's illegal field
    length, IM's size that is not a number...)."""
    return next(walk(io.BytesIO(data), "<bytes>"), ("unknown", None))[0]


def identify(path: str) -> str:
    """``sniff`` of the file at ``path``, reading no more of it than the
    plugins' tests read."""
    with open(path, "rb") as f:
        return next(walk(f, path), ("unknown", None))[0]


#: the BMP header sizes Pillow reads (BmpImagePlugin): OS/2 1.x's 12 bytes,
#: then BITMAPINFOHEADER to BITMAPV5HEADER, OS/2 2.x's 64 among them
BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
#: the bitfield masks Pillow reads at 16 and 32 bits (at 24 bits only the
#: BGR one), by the shifts of R, G and B: at 32 bits alpha is dropped, and
#: all four masks zero read as BGRA
_MASKS_32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (16, 8, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (24, 16, 8),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (24, 8, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (24, 16, 8),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 8, 16),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (16, 8, 0),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (24, 8, 0),
    (0x0, 0x0, 0x0, 0x0): (16, 8, 0),
}
_MASKS_16 = {(0xF800, 0x7E0, 0x1F): (11, 5, 0, 63), (0x7C00, 0x3E0, 0x1F): (10, 5, 0, 31)}
_COMPRESSIONS = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS", 4: "BI_JPEG", 5: "BI_PNG"}
#: the most pixels Pillow opens (twice ``Image.MAX_IMAGE_PIXELS``: above
#: that it raises ``DecompressionBombError``)
MAX_PIXELS = 2 * 89478485


def _rle(data: bytes, at: int, w: int, h: int, rle4: bool) -> Optional[bytes]:
    """The index bytes of an RLE8 or RLE4 bitmap from ``data[at:]``, rows
    in file order, as Pillow's ``BmpRleDecoder`` reads them: a run is cut
    at the row's end (the column is not reset by a row that fills up, only
    by end of line and delta); end of line pads the row with zeros; a delta
    escape skips two bytes and reads (right, up) from the next two; an
    absolute run of n reads n bytes (RLE4: n // 2, two pixels each) and
    aligns to an even offset in the file.  None where the stream ends
    before ``w * h`` pixels."""
    out = bytearray()
    x, pos, end, need = 0, at, len(data), w * h
    while len(out) < need:
        if pos + 2 > end:
            break
        n, b = data[pos], data[pos + 1]
        pos += 2
        if n:
            n = max(0, w - x) if x + n > w else n
            if rle4:
                out += bytes((b >> 4, b & 15)) * (n // 2) + (bytes((b >> 4,)) if n % 2 else b"")
            else:
                out += bytes((b,)) * n
            x += n
        elif b == 0:  # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif b == 1:  # end of bitmap
            break
        elif b == 2:  # delta, after two bytes that are skipped
            if pos + 4 > end:
                return None
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # absolute
            count = b // 2 if rle4 else b
            raw = data[pos:pos + count]
            pos += len(raw)
            if rle4:
                nibbles = np.frombuffer(raw, np.uint8)
                out += np.stack([nibbles >> 4, nibbles & 15], 1).tobytes()
            else:
                out += raw
            if len(raw) < count:
                break
            x += b
            pos += pos % 2
    return bytes(out[:need]) if len(out) >= need else None


def _bitmap(data: bytes, at: int, offset: int, name: str, fmt: str = "BMP", halve: Optional[str] = None,
            mapped: bool = True) -> Tuple[np.ndarray, int]:
    """The bitmap whose header starts at ``data[at]``, as Pillow 12.1.0's
    ``BmpImageFile._bitmap(header, offset)`` reads it and its raw or RLE
    decoder decodes it: (uint8 RGB, the pixels' offset in the file).
    ``offset`` is the one a BMP's file header gives, or 0 where there is
    none (DIB, ICO and CUR: the pixels then follow the palette).  ``fmt``
    names the format in errors.  ``halve`` is "before" or "after" where
    the bitmap is an icon's frame, which holds its AND mask below the
    image: its height is halved before Pillow checks the size (CUR) or
    after (ICO).  ``mapped`` is false where Pillow's reader does not map
    the file (an ICO frame's), so rows that overlap cannot be read."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: {fmt} {why}, which Pillow (the JAX package's {fmt} lane) does not read")

    if at + 4 > len(data):
        raise NotThisFormat(f"{name}: {fmt} truncated before its bitmap header")
    header = _u32(data, at)
    if header not in BMP_HEADERS:
        raise refuse(f"with a {header}-byte header (Pillow reads {', '.join(map(str, BMP_HEADERS))})")
    pos = at + header
    if len(data) < pos:
        raise OSError(f"{name}: {fmt} truncated in its {header}-byte header")
    masks = ()
    if header == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", data, at + 4)
        compression, colors, entry, top_down = 0, 0, 3, False
    else:
        w, h, _, bits, compression = struct.unpack_from("<IIHHI", data, at + 4)
        (colors,) = struct.unpack_from("<I", data, at + 32)
        entry, top_down = 4, data[at + 11] == 0xFF
        if top_down:
            h = 2**32 - h
        if compression == 3:
            if header >= 52:
                masks = struct.unpack_from("<IIII" if header >= 56 else "<III", data, at + 40)
            else:
                if len(data) < pos + 12:
                    raise NotThisFormat(f"{name}: {fmt} truncated in its bitfield masks")
                masks = struct.unpack_from("<III", data, pos)
                pos += 12
            masks = (masks + (0,))[:4]
    if halve == "before":
        h //= 2
    if w <= 0 or h <= 0:  # Pillow raises SyntaxError: not its file
        raise NotThisFormat(f"{name}: {fmt} of {w} x {h} pixels, which Pillow does not identify")
    checked = h  # the height Pillow's size check sees
    if halve == "after":
        h //= 2
        if h <= 0:  # a frame of one row: Pillow's tile of no rows
            raise refuse(f"of {w} x {h} pixels (tile cannot extend outside image)")
    if w * checked > MAX_PIXELS:
        raise refuse(f"of {w} x {checked} pixels, more than {MAX_PIXELS}")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise refuse(f"with {bits}-bit pixels (Pillow reads 1, 4, 8, 16, 24 and 32)")
    colors = colors or 1 << bits
    if offset == 14 + header and bits <= 8:  # Pillow's guess that the pixels follow a palette of 4-byte entries
        offset += 4 * colors
    if compression not in (0, 1, 2, 3):
        raise refuse(f"with compression {compression} ({_COMPRESSIONS.get(compression, 'unknown')})")
    if compression == 3 and not ((bits == 32 and masks in _MASKS_32) or (bits == 16 and masks[:3] in _MASKS_16)
                                 or (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF))):
        raise refuse(f"with {bits}-bit bitfields R {masks[0]:#x}, G {masks[1]:#x}, B {masks[2]:#x}, A {masks[3]:#x}")

    gray = "RGB"
    lut = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise refuse(f"with a palette of {colors} colours")
        table = np.frombuffer(data[pos:pos + entry * colors], np.uint8)
        pos += table.size
        ramp = np.array((0, 255) if colors == 2 else np.arange(colors) & 255, np.uint8)
        if table.size == entry * colors and (table.reshape(colors, entry)[:, :3] == ramp[:, None]).all():
            gray = "1" if colors == 2 else "L"
        else:
            n = table.size // entry
            if n > 256:
                raise refuse(f"with a palette of {n} colours that is not a gray ramp (Pillow holds 256)")
            lut = np.zeros((256, 3), np.uint8)  # past the palette's end: black
            lut[:n] = table[: n * entry].reshape(n, entry)[:, 2::-1]
    if not offset:
        offset = pos

    if compression in (1, 2):
        if bits > 8 or gray == "1":
            raise refuse(f"{_COMPRESSIONS[compression]} with {bits}-bit pixels and "
                         + ("a black and white palette" if gray == "1" else "no palette"))
        rle = _rle(data, offset, w, h, compression == 2)
        if rle is None:
            raise OSError(f"{name}: {fmt} {_COMPRESSIONS[compression]} data end before its {w} x {h} pixels")
        px = np.frombuffer(rle, np.uint8).reshape(h, w)
    else:
        stride = (w * bits + 31) // 32 * 4
        depth = 8 if gray == "L" else 1 if gray == "1" else bits
        row = (w * depth + 7) // 8
        if stride < row and not mapped:  # the raw decoder's rows would overlap: "bad configuration"
            raise refuse(f"gray palette of {bits}-bit pixels read a byte a pixel, its rows overlapping")
        # 8-bit gray over rows of fewer bytes: Pillow maps the file, which must hold every row's stride
        _raw(data, offset, h * stride if stride < row else (h - 1) * stride + row, name, fmt)
        span = np.frombuffer(data[offset:offset + (h - 1) * stride + row], np.uint8)
        if span.size < (h - 1) * stride + row:  # overlapping rows: the last reads past the file's end as zeros
            span = np.concatenate([span, np.zeros((h - 1) * stride + row - span.size, np.uint8)])
        rows = np.lib.stride_tricks.as_strided(span, (h, row), (stride, 1))
        if depth < 8:
            px = _unpack_bits(rows, depth, w)
            if gray == "1":
                px = px * np.uint8(255)
        elif depth == 8:
            px = rows[:, :w]
        elif depth == 16:
            v = rows[:, : 2 * w].copy().view("<u2").astype(np.uint32)
            r, g, b, gmax = _MASKS_16[masks[:3]] if compression == 3 else _MASKS_16[(0x7C00, 0x3E0, 0x1F)]
            px = np.stack([((v >> r) & 31) * 255 // 31, ((v >> g) & gmax) * 255 // gmax, (v & 31) * 255 // 31], -1)
        elif depth == 24:
            px = rows[:, : 3 * w].reshape(h, w, 3)[:, :, ::-1]
        else:
            v = rows[:, : 4 * w].copy().view("<u4")
            shifts = _MASKS_32[masks] if compression == 3 else (16, 8, 0)
            px = np.stack([(v >> s) & 255 for s in shifts], -1)
    if not top_down:
        px = px[::-1]
    return _rgb(px, lut), offset


def _unpack_bits(rows: np.ndarray, depth: int, w: int) -> np.ndarray:
    """(h, bytes) rows of ``depth``-bit samples packed from each byte's
    most significant bit as (h, w) uint8 samples."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(rows.shape[0], -1)[:, :w]


def _rgb(px: np.ndarray, lut: Optional[np.ndarray] = None) -> np.ndarray:
    """Indices through ``lut``, gray repeated, or RGB, as uint8 (H, W, 3)."""
    if lut is not None:
        return lut[px]
    if px.ndim == 2:
        return np.repeat(px[:, :, None], 3, axis=2).astype(np.uint8)
    out = np.ascontiguousarray(px[:, :, :3], np.uint8)
    return out if out.flags.writeable else out.copy()  # not a view of the file's bytes


def decode_bmp(data: bytes, name: str = "BMP") -> np.ndarray:
    """A BMP file as uint8 RGB (H, W, 3), bit for bit with Pillow's
    ``Image.open(path).convert("RGB")`` (``BmpImagePlugin``, Pillow
    12.1.0), the lane through which the JAX package reads BMP files:

    - headers of 12 (OS/2 1.x, 3-byte palette entries), 40, 52, 56, 64,
      108 and 124 bytes; bottom-up rows, or top-down where the height's
      top byte is 0xFF;
    - 1-, 4- and 8-bit palettes of the header's colour count (or 2^bits),
      indices past a short palette black; a palette of 2 entries black and
      white reads as 1-bit pixels and any other gray ramp (entry i = (i, i,
      i)) as 8-bit gray, at every depth, as Pillow drops such palettes (so
      a 4-bit file with the 16-entry ramp reads a byte a pixel, rows
      overlapping, past the file's end as zeros);
    - 16-bit ``BI_RGB`` (555) and ``BI_BITFIELDS`` 555 and 565, each field
      expanded as v * 255 // max; 24-bit ``BI_RGB`` and BGR bitfields;
      32-bit ``BI_RGB`` and the eight bitfield layouts Pillow reads, alpha
      dropped;
    - RLE8 and RLE4 (``_rle``).

    What Pillow refuses raises ``OSError`` naming the file and the reason:
    another header size or depth, ``BI_JPEG``/``BI_PNG`` or an unknown
    compression, other bitfield masks, a palette of no or more than 65536
    colours (or more than 256 that are not a gray ramp), RLE without a
    palette, a truncated file."""
    if len(data) < 18 or data[:2] != b"BM":
        raise OSError(f"{name}: not a BMP file")
    return _bitmap(data, 14, _u32(data, 10), name)[0]


def decode_dib(data: bytes, name: str = "DIB") -> np.ndarray:
    """A headerless bitmap (Pillow's DIB: the file starts with the bitmap
    header, its first u32 a size of ``BMP_HEADERS``) as uint8 RGB, as
    Pillow's ``DibImageFile`` reads it: ``decode_bmp``'s layouts, the
    pixels right after the header, its bitfield masks and its palette
    (Pillow guesses no other offset without a file header)."""
    return _bitmap(data, 0, 0, name, "DIB")[0]


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def decode_ico(data: bytes, name: str = "ICO") -> np.ndarray:
    """A Windows icon's image as uint8 RGB, as Pillow 12.1.0's
    ``IcoImagePlugin`` opens it and ``convert("RGB")`` reads it: the entry
    first after its two stable sorts, by colour depth (``bpp``, or
    ceil(log2(colours)), or 256) ascending and then by area (a width or
    height byte of 0 is 256) descending; its frame a PNG (the port's PNG
    codec in the Pillow lane, a 16-bit gray sample clipped at 255) or a
    DIB whose height is halved (``_bitmap``), whatever size its entry
    gives.  Pillow reads a DIB frame's AND mask (or, where the
    entry's ``bpp`` is 32, its alpha bytes) before ``convert("RGB")``
    drops it, so a mask or alpha cut short by the file's end raises, as
    does an icon of no entry."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: ICO {why}, which Pillow (the JAX package's ICO lane) does not read")

    count = _u16(data, 4)
    if count <= 0:
        raise NotThisFormat(f"{name}: ICO with no image, which Pillow does not identify")
    entries = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise NotThisFormat(f"{name}: ICO directory cut short at entry {i} of {count}")
        width, height, colors, bpp = s[0] or 256, s[1] or 256, s[2], _u16(s, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append((width * height, depth, bpp, _u32(s, 8), _u32(s, 12)))
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, bpp, size, at = entries[0]
    if data[at:at + 8] == _PNG_MAGIC:
        rgb = native.decode_buffer(data[at:], name, "pillow")
        if rgb.shape[0] * rgb.shape[1] > MAX_PIXELS:
            raise refuse(f"PNG frame of {rgb.shape[1]} x {rgb.shape[0]} pixels, more than {MAX_PIXELS}")
        return rgb
    rgb, offset = _bitmap(data, at, 0, name, "ICO", halve="after", mapped=False)
    h, w = rgb.shape[:2]
    if bpp == 32:  # the alpha bytes, every fourth of 4 * w * h from the pixels' start
        if offset + 4 * w * h > len(data):
            raise refuse("32-bit frame whose alpha bytes end past the file's end (buffer is not large enough)")
    else:  # the AND mask, rows of 32-bit words, ending where the entry's bytes end
        stride = (w + 31) // 32 * 4
        mask_at = at + size - stride * h
        if mask_at < 0:
            raise refuse(f"frame whose AND mask would start before the file ({mask_at})")
        if mask_at + (h - 1) * stride + (w + 7) // 8 > len(data):
            raise refuse("frame whose AND mask ends past the file's end (not enough image data)")
    return rgb


def decode_cur(data: bytes, name: str = "CUR") -> np.ndarray:
    """A Windows cursor's image as uint8 RGB, as Pillow 12.1.0's
    ``CurImagePlugin`` reads it: the first entry, unless a later one is
    strictly wider and taller by its raw width and height bytes (so a 0,
    which means 256, never wins); its DIB read from the entry's offset
    (``_bitmap``; an offset of 0 reads on after the directory) with its
    height halved, and no mask read."""
    count = _u16(data, 4)
    best = b""
    for i in range(max(count, 0)):
        s = data[6 + 16 * i:22 + 16 * i]
        if not best:
            best = s
        elif not s or s[0] > best[0] and (len(s) < 2 or len(best) < 2):
            raise NotThisFormat(f"{name}: CUR directory cut short at entry {i} of {count}")
        elif s[0] > best[0] and s[1] > best[1]:
            best = s
    if not best:
        raise NotThisFormat(f"{name}: CUR with no entry (No cursors were found), which Pillow does not identify")
    if len(best) < 16:
        raise NotThisFormat(f"{name}: CUR directory cut short in the entry it reads")
    at = _u32(best, 12) or min(6 + 16 * count, len(data))
    return _bitmap(data, at, 0, name, "CUR", halve="before")[0]


#: Pillow 12.1.0's PPM modes by magic (``PpmImagePlugin.MODES``): P1-P6,
#: its float and CMYK extensions, and its test modes
PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK",
             b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
_WHITESPACE = b" \t\n\x0b\x0c\r"


def _pnm_magic(data: bytes) -> Tuple[bytes, int]:
    """``PpmImageFile``'s magic: up to 6 bytes before a whitespace byte,
    which it reads past.  Returns the magic and the position after it."""
    magic, pos = b"", 0
    while len(magic) < 6 and pos < len(data):
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    return magic, pos


def _pnm_token(data: bytes, pos: int, name: str) -> Tuple[bytes, int]:
    """``PpmImageFile._read_token`` from ``data[pos]``: leading whitespace
    skipped, a ``#`` comment dropped up to and through its CR or LF (the
    token goes on after it), the token ended by the whitespace it reads;
    at most 10 characters.  Returns the token and the position after it."""
    token = b""
    while len(token) <= 10:
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while data[pos:pos + 1] not in b"\r\n":  # b"" at the file's end is in it
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        raise OSError(f"{name}: PPM header: Reached EOF while reading header")
    if len(token) > 10:
        raise OSError(f"{name}: PPM header: Token too long in file header: {token!r}")
    return token, pos


def _pnm_int(token: bytes, name: str) -> int:
    try:
        return int(token)  # Python's int(), as Pillow parses the header
    except ValueError as e:
        raise OSError(f"{name}: PPM header: {e}") from e


def _cmyk2rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's ``cmyk2rgb`` (Convert.c): each of C, M, Y (uint8) taken off
    255 - K as MULDIV255."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _f2l(v: np.ndarray) -> np.ndarray:
    """Pillow's F -> L (``f2l``, Convert.c): 0 at or below 0 (and NaN),
    255 at or above 255, the integer part between."""
    out = np.zeros(v.shape, np.uint8)
    inside = (v > 0) & (v < 255)
    out[inside] = v[inside].astype(np.uint8)
    out[v >= 255] = 255
    return out


def decode_pnm(data: bytes, name: str = "PPM") -> np.ndarray:
    """A PBM, PGM, PPM (or Pillow's ``Pf`` float, ``P0CMYK`` and test
    ``Py*``) file as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``PpmImagePlugin`` and ``convert("RGB")``:

    - the header as Pillow reads it: a magic of up to 6 bytes up to the
      first whitespace, then tokens of at most 10 characters (``_pnm_token``),
      parsed by Python's ``int`` and ``float``;
    - raw P4 (1-bit, 1 black), P5 and P6: maxval 255 read raw, gray at
      65535 as big-endian 16-bit samples (mode I), any other maxval as
      samples of 1 byte (2 big-endian at 256 and above) scaled to
      min(out_max, round(v / maxval * out_max)) in float64 with
      round-half-even, out_max 65535 where gray is above 255 (mode I) and
      255 otherwise; mode I then clips at 255, as Pillow's I -> RGB does;
    - plain P1, P2 and P3 through the native library (``native.pnm_plain``:
      Pillow's ``PpmPlainDecoder``, block by block);
    - ``Pf``: float32, little-endian where the scale is negative, rows
      bottom-up, F -> RGB as ``f2l``; ``P0CMYK`` and ``PyCMYK`` through
      ``cmyk2rgb``; ``PyP`` has no palette, so reads black.

    Bytes Pillow does not identify raise "unknown format"; what it refuses
    (a bad token, maxval or scale, data cut short) raises ``OSError``
    naming the file and the reason."""
    magic, pos = _pnm_magic(data)
    mode = PNM_MODES.get(magic)
    if mode is None:
        raise NotThisFormat(f"{name}: unknown format: Pillow's PPM reader does not identify the magic {magic!r}")
    tok, pos = _pnm_token(data, pos, name)
    w = _pnm_int(tok, name)
    tok, pos = _pnm_token(data, pos, name)
    h = _pnm_int(tok, name)
    plain = magic in (b"P1", b"P2", b"P3")
    maxval, scale = 0, 0.0
    if mode == "F":
        tok, pos = _pnm_token(data, pos, name)
        try:
            scale = float(tok)
        except ValueError as e:
            raise OSError(f"{name}: PPM header: {e}") from e
        if scale == 0.0 or not math.isfinite(scale):
            raise OSError(f"{name}: PPM header: scale must be finite and non-zero")
    elif mode != "1":
        tok, pos = _pnm_token(data, pos, name)
        maxval = _pnm_int(tok, name)
        if not 0 < maxval < 65536:
            raise OSError(f"{name}: PPM header: maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: unknown format: a PPM of {w} x {h} pixels, which Pillow does not identify")
    if w * h > MAX_PIXELS:
        raise OSError(f"{name}: PPM of {w} x {h} pixels, more than {MAX_PIXELS}, which Pillow does not read")
    bands = _BANDS[mode]
    if plain:
        px = native.pnm_plain(data[pos:], name, h, w, bands, maxval, mode == "I")
        return _rgb(px if bands > 1 else px[:, :, 0])

    def body(n: int) -> np.ndarray:
        return _raw(data, pos, n, name, "PPM")

    if mode == "1":
        row = (w + 7) // 8
        return _rgb(np.where(_unpack_bits(body(h * row).reshape(h, row), 1, w), 0, 255).astype(np.uint8))
    if mode == "F":
        v = body(4 * w * h).view("<f4" if scale < 0 else ">f4").reshape(h, w)[::-1]
        return _rgb(_f2l(v))
    if maxval == 255:
        px = body(w * h * bands).reshape(h, w, bands)
    elif maxval == 65535 and mode == "I":
        px = np.minimum(body(2 * w * h).view(">u2").reshape(h, w, 1), 255).astype(np.uint8)
    else:
        size = 1 if maxval < 256 else 2
        v = body(size * w * h * bands).view(">u2" if size == 2 else np.uint8).reshape(h, w, bands)
        out_max = 65535 if mode == "I" else 255
        px = np.minimum(out_max, np.rint(v / maxval * out_max))
        px = np.minimum(px, 255).astype(np.uint8)
    if mode == "P":  # no palette: every index reads black
        return np.zeros((h, w, 3), np.uint8)
    if mode == "CMYK":
        return _cmyk2rgb(px)
    return _rgb(px if bands > 1 else px[:, :, 0])


#: Pillow 12.1.0's Targa raw modes (``TgaImagePlugin.MODES``) by (image
#: type & 7, depth), with their bits a pixel
TGA_MODES = {(1, 8): ("P", 8), (3, 1): ("1", 1), (3, 8): ("L", 8), (3, 16): ("LA", 16), (2, 16): ("BGRA;15Z", 16),
             (2, 24): ("BGR", 24), (2, 32): ("BGRA", 32)}


def _bgra15z(v: np.ndarray) -> np.ndarray:
    """Pillow's ``BGRA;15Z`` unpacker on little-endian 16-bit words: 5 bits
    a channel, each expanded as v * 255 // 31."""
    return np.stack([((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)], -1).astype(np.uint8)


def decode_tga(data: bytes, name: str = "TGA") -> np.ndarray:
    """A Targa file as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``TgaImagePlugin`` and ``convert("RGB")``:

    - image types 1/9 (colour-mapped), 2/10 (true colour) and 3/11 (gray),
      raw or RLE, at the depths of ``TGA_MODES`` (16-bit colour as
      ``BGRA;15Z``); the ID field skipped, rows bottom-up unless the flags
      hold 0x20, mirrored where they hold 0x10, a TGA 2.0 footer ignored;
    - the colour map (16- or 24-bit entries) after ``start`` black entries;
      an index past the map reads black; a gray image with a map reads
      through it, as Pillow's ``putpalette`` turns L into P;
    - RLE through the native library (``native.tga_rle``: Pillow's
      TgaRleDecode.c, whose run packets may not cross a row's end and
      whose literal ones may).

    What Pillow refuses raises ``OSError`` naming the file and the reason:
    another image type, map depth (8 or 32 bits) or depth, type 1 without
    a map, a map on true-colour or 1-bit pixels or of more than 256
    entries, RLE of 1-bit pixels (Pillow steps 0 bytes a packet), data cut
    short."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: TGA {why}, which Pillow (the JAX package's TGA lane) does not read")

    id_len, cmt, itype, depth, flags = data[0], data[1], data[2], data[16], data[17]
    w, h = _u16(data, 12), _u16(data, 14)
    if itype not in (1, 2, 3, 9, 10, 11):
        raise NotThisFormat(f"{name}: TGA of image type {itype} (unknown TGA mode), which Pillow does not identify")
    pos = 18 + id_len
    lut = None
    if cmt:
        start, size, map_depth = _u16(data, 3), _u16(data, 5), data[7]
        if map_depth not in (16, 24, 32):
            raise NotThisFormat(f"{name}: TGA with a {map_depth}-bit colour map (unknown TGA map depth), which Pillow "
                                "does not identify")
        k = map_depth // 8
        table = data[pos:pos + k * size]
        pos += len(table)
        entries = start + len(table) // k
        if map_depth == 32:
            raise refuse("with a 32-bit colour map (Pillow's palette has no BGRA raw mode)")
        if entries > 256:
            raise refuse(f"with a colour map of {entries} entries (invalid palette size)")
        lut = np.zeros((256, 3), np.uint8)
        raw = np.frombuffer(table, np.uint8, len(table) // k * k)
        lut[start:entries] = (_bgra15z(raw.view("<u2")) if k == 2 else raw.reshape(-1, 3)[:, ::-1])
    if (itype & 7, depth) not in TGA_MODES:
        raise refuse(f"of image type {itype} at {depth} bits (cannot load this image)")
    rawmode, bits = TGA_MODES[itype & 7, depth]
    if rawmode == "P" and lut is None:
        raise refuse("of a colour-mapped type without a colour map (unknown raw mode for given image mode)")
    if lut is not None and rawmode not in ("P", "L", "LA"):
        raise refuse(f"with a colour map on {rawmode} pixels (unrecognized image mode)")
    if w * h > MAX_PIXELS:
        raise refuse(f"of {w} x {h} pixels, more than {MAX_PIXELS}")
    row = (w * bits + 7) // 8
    if itype & 8:
        rows = native.tga_rle(data[pos:], name, bits // 8, row, h)
    else:
        rows = _raw(data, pos, h * row, name, "TGA").reshape(h, row)
    if not flags & 0x20:
        rows = rows[::-1]
    if rawmode == "1":
        px = _unpack_bits(rows, 1, w) * np.uint8(255)
    elif rawmode in ("P", "L", "LA"):
        px = rows.reshape(h, w, bits // 8)[:, :, 0]
    elif rawmode == "BGRA;15Z":
        px = _bgra15z(rows.copy().view("<u2"))
    else:
        px = rows.reshape(h, w, bits // 8)[:, :, 2::-1]
    if flags & 0x10:
        px = px[:, ::-1]
    return _rgb(px, lut)


class _Reader:
    """A file's bytes read as Pillow's plugins read a file object: ``read``
    returns what is left of the ``n`` asked for and moves on by as much,
    ``seek`` may go past the end (where ``read`` returns nothing); the
    big-endian fields raise ``NotThisFormat`` where they are cut short,
    as Pillow's struct.error and IndexError pass the file on."""

    def __init__(self, data: bytes, name: str, fmt: str, pos: int = 0):
        self.data, self.name, self.fmt, self.pos = data, name, fmt, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def u(self, n: int) -> int:
        b = self.read(n)
        if len(b) < n:
            raise NotThisFormat(f"{self.name}: {self.fmt} header cut short at byte {self.pos}, which Pillow does not "
                                "identify")
        return int.from_bytes(b, "big")


#: Pillow 12.1.0's PSD modes (``PsdImagePlugin.MODES``): (colour mode,
#: bits) -> (mode, channels it needs)
PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1), (3, 8): ("RGB", 3),
             (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def _too_large(name: str, fmt: str, w: int, h: int) -> None:
    if w * h > MAX_PIXELS:
        raise OSError(f"{name}: {fmt} of {w} x {h} pixels, more than {MAX_PIXELS}, which Pillow does not read")


def decode_psd(data: bytes, name: str = "PSD") -> np.ndarray:
    """A Photoshop file's merged image as uint8 RGB, bit for bit with Pillow
    12.1.0's ``PsdImagePlugin`` and ``convert("RGB")``:

    - the header, colour mode data, image resources and layer section as
      Pillow's ``_open`` walks them (``_Reader``), layers skipped by their
      section's length;
    - every (mode, bits) of ``PSD_MODES``: bitmap (1-bit, a set bit white,
      as Pillow reads it), gray, multichannel, duotone and 8-bit bitmap as
      L, indexed through the colour mode data where it is 768 bytes
      (planar R, G, B; black without), RGB from the first 3 channels (4
      channels: RGBA, the alpha dropped), CMYK inverted then ``cmyk2rgb``,
      Lab from the first 3 channels (each plane read as L, so a* and b*
      stay with 128 as zero) through LittleCMS's Lab -> sRGB transform as
      Pillow's ``convert`` applies it (``native.lab_to_rgb``);
    - raw channels, and PackBits through the native library
      (``native.packbits``: Pillow's PackbitsDecode.c, a channel's stream
      from the offset its row counts give to the file's end).

    What Pillow does not identify (another version, mode or depth, a
    header cut short) raises ``NotThisFormat``; what it refuses (too few
    channels, ZIP or another compression, data cut short, too many pixels)
    raises ``OSError`` naming the file and the reason."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: PSD {why}, which Pillow (the JAX package's PSD lane) does not read")

    f = _Reader(data, name, "PSD")
    head = f.read(26)
    if len(head) < 26 or head[:4] != b"8BPS" or _u16(head, 4, ">") != 1:
        raise NotThisFormat(f"{name}: not a PSD file of version 1, which Pillow does not identify")
    channels, h, w, bits, psd_mode = struct.unpack_from(">HIIHH", head, 12)
    if (psd_mode, bits) not in PSD_MODES:
        raise NotThisFormat(f"{name}: PSD of colour mode {psd_mode} at {bits} bits a channel, which Pillow does not "
                            "identify")
    mode, need = PSD_MODES[psd_mode, bits]
    if need > channels:
        raise refuse(f"of mode {mode} with {channels} channels (not enough channels)")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    palette = None
    size = f.u(4)  # colour mode data
    if size:
        colors = f.read(size)
        if mode == "P" and size == 768 and len(colors) == 768:  # cut short, the next field fails
            palette = np.frombuffer(colors, np.uint8).reshape(3, 256).T
    size = f.u(4)  # image resources, entry by entry as Pillow reads them
    end = f.pos + size
    while size and f.pos < end:
        f.read(4)
        f.u(2)
        n = f.read(1)
        if not n:
            raise NotThisFormat(f"{name}: PSD resource cut short, which Pillow does not identify")
        label = f.read(n[0])
        if not len(label) & 1:
            f.read(1)
        if len(f.read(f.u(4))) & 1:
            f.read(1)
    size = f.u(4)  # layers and masks, skipped
    if size:
        end = f.pos + size
        f.u(4)
        f.pos = end
    compression = f.u(2)
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: PSD of {w} x {h} pixels, which Pillow does not identify")
    _too_large(name, "PSD", w, h)
    row = (w + 7) // 8 if mode == "1" else w
    if compression == 0:
        planes = []
        for at in (f.pos + k * w * h for k in range(need)):
            planes.append(_raw(data, at, h * row, name, "PSD").reshape(h, row))
    elif compression == 1:
        counts = f.read(need * h * 2)
        if len(counts) < need * h * 2:
            raise NotThisFormat(f"{name}: PSD row byte counts cut short, which Pillow does not identify")
        per_channel = np.frombuffer(counts, ">u2").reshape(need, h).sum(axis=1, dtype=np.int64)
        at = f.pos
        planes = []
        for k in range(need):
            planes.append(native.packbits(data[at:], name, row, h))
            at += int(per_channel[k])
    else:
        raise refuse(f"with compression {compression} ({'ZIP' if compression in (2, 3) else 'unknown'}: cannot load "
                     "this image)")
    if mode == "1":
        return _rgb(_unpack_bits(planes[0], 1, w) * np.uint8(255))
    if mode == "P":
        if palette is None:
            return np.zeros((h, w, 3), np.uint8)
        return palette[planes[0]]
    if mode == "L":
        return _rgb(planes[0])
    px = np.stack(planes, -1)
    if mode == "CMYK":
        return _cmyk2rgb(255 - px)
    if mode == "LAB":
        return native.lab_to_rgb(px)
    return _rgb(px)


def decode_pcx(data: bytes, name: str = "PCX", at: int = 0, fmt: str = "PCX") -> np.ndarray:
    """A PCX file as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``PcxImagePlugin`` and ``convert("RGB")``: the size from the bbox; 1 bit
    in 1 plane as 1-bit pixels (the header's palette ignored), 1 bit in 2 or
    4 planes as ``P;2L``/``P;4L`` through the header's 16 colours, version 5
    with 8 bits in 1 plane as gray or, where the last 769 bytes start with
    12 and hold another palette than the gray ramp, through it, version 5
    with 8 bits in 3 planes as ``RGB;L``; Pillow's own stride (the header's
    only tells it to round up to even), and the row's planes moved as
    PcxDecode.c moves them; the RLE through the native library
    (``native.pcx_rle``).  A bad bbox or a header cut short raises
    ``NotThisFormat``; what Pillow refuses (another layout, "unknown PCX
    mode", which it passes to no other format; 8 bits in 1 plane in a file
    of fewer than 769 bytes, where its seek to the palette fails; a run
    past its row; data cut short) raises ``OSError`` naming the file.
    ``at`` is where the PCX starts in ``data`` (a DCX's first page: its
    palette is still the last 769 bytes of the whole file, as Pillow seeks
    from the file's end), ``fmt`` the format errors name."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: {fmt} {why}, which Pillow (the JAX package's {fmt} lane) does not read")

    head = data[at:at + 128]
    if len(head) < 68 or head[0] != 10 or head[1] not in (0, 2, 3, 5):
        raise NotThisFormat(f"{name}: {fmt} PCX header cut short or not a PCX's ({len(head)} bytes), which Pillow "
                            "does not identify")
    xmin, ymin, xmax, ymax = struct.unpack_from("<HHHH", head, 4)
    w, h = xmax + 1 - xmin, ymax + 1 - ymin
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: PCX of bbox ({xmin}, {ymin}, {xmax}, {ymax}) (bad PCX image size), which Pillow "
                            "does not identify")
    version, bits, planes, provided = head[1], head[3], head[65], _u16(head, 66)
    lut = None
    if bits == 1 and planes == 1:
        rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        rawmode = f"P;{planes}L"
        lut = np.zeros((256, 3), np.uint8)
        lut[:16] = np.frombuffer(head, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        rawmode = "L"
        if len(data) < 769:
            raise refuse(f"of 8 bits in 1 plane in {len(data)} bytes (its seek to the 769-byte palette before the "
                         "file's start fails)")
        tail = np.frombuffer(data, np.uint8, 769, len(data) - 769)
        if tail[0] == 12 and not (tail[1:].reshape(256, 3) == np.arange(256, dtype=np.uint8)[:, None]).all():
            lut = tail[1:].reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        rawmode = "RGB;L"
    else:
        raise refuse(f"version {version} of {bits} bits in {planes} planes (unknown PCX mode)")
    _too_large(name, fmt, w, h)
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    size = planes * stride
    rows = native.pcx_rle(data[at + 128:], name, size, h)
    # PcxDecode.c moves each plane after the first next to the one before
    # it: planes of (w + 7) // 8 bytes at size // planes apart for 1-bit
    # planes, else planes of w bytes at size // (size // w) apart
    span, bands = ((w + 7) // 8, planes) if rawmode.startswith("P;") else (w, size // w)
    step = size // bands if bands else 0
    if step > span:
        moved = rows.copy()
        for i in range(1, bands):
            moved[:, i * span:(i + 1) * span] = rows[:, i * step:i * step + span]
        rows = moved
    if rawmode == "1":
        return _rgb(_unpack_bits(rows, 1, w) * np.uint8(255))
    if rawmode.startswith("P;"):
        s = (w + 7) // 8
        idx = sum(_unpack_bits(rows[:, j * s:(j + 1) * s], 1, w) << j for j in range(planes))
        return lut[idx.astype(np.uint8)]
    if rawmode == "L":
        return _rgb(rows[:, :w], lut)
    return np.ascontiguousarray(rows[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1))


#: Pillow 12.1.0's SGI layouts (``SgiImagePlugin.MODES``): (bytes a
#: sample, dimension, channels) -> bands
SGI_MODES = {(1, 1, 1): 1, (1, 2, 1): 1, (2, 1, 1): 1, (2, 2, 1): 1, (1, 3, 3): 3, (2, 3, 3): 3, (1, 3, 4): 4,
             (2, 3, 4): 4}


def decode_sgi(data: bytes, name: str = "SGI") -> np.ndarray:
    """An SGI image as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``SgiImagePlugin`` and ``convert("RGB")``: the eight layouts of
    ``SGI_MODES`` (L, RGB, RGBA at 8 and 16 bits, 16-bit samples keeping
    their high byte, alpha dropped), rows bottom-up, raw (channel planes
    one after the other) or RLE through the native library
    (``native.sgi_rle``: SgiRleDecode.c, its offset and length tables, its
    row buffer kept across rows, a row left unterminated ending the image
    in black).  A header cut short raises ``NotThisFormat``; what Pillow
    refuses (another layout, another storage, data cut short, an RLE
    table or row past the file's end, a run past its row) raises
    ``OSError`` naming the file and the reason."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: SGI {why}, which Pillow (the JAX package's SGI lane) does not read")

    if len(data) < 12:
        raise NotThisFormat(f"{name}: SGI header cut short ({len(data)} bytes), which Pillow does not identify")
    storage, bpc = data[2], data[3]
    dimension, w, h, z = struct.unpack_from(">HHHH", data, 4)
    if (bpc, dimension, z) not in SGI_MODES:
        raise refuse(f"of {bpc} bytes a sample, dimension {dimension} and {z} channels (Unsupported SGI image mode)")
    bands = SGI_MODES[bpc, dimension, z]
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: SGI of {w} x {h} pixels, which Pillow does not identify")
    _too_large(name, "SGI", w, h)
    if storage == 0:
        page = w * h * bpc
        px = _raw(data, 512, bands * page, name, "SGI").reshape(bands, h, w, bpc)[..., 0].transpose(1, 2, 0)
    elif storage == 1:
        px = native.sgi_rle(data[512:], name, bpc, bands, w, h)[..., ::bpc]
    else:
        raise refuse(f"of storage {storage} (cannot load this image)")
    return _rgb(px[::-1] if bands > 1 else px[::-1, :, 0])


def decode_qoi(data: bytes, name: str = "QOI") -> np.ndarray:
    """A QOI file as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``QoiImagePlugin`` (its own decoder, through the native library:
    ``native.qoi``) and ``convert("RGB")``: 3 channels read as RGB and any
    other count as RGBA, its alpha then dropped; an INDEX op on an empty
    slot reads (0, 0, 0, 0), and a RUN leaves the index as it is, as
    Pillow's decoder does.  A header cut short raises ``NotThisFormat``;
    data that end before the last pixel raise ``OSError`` naming the
    file."""
    if len(data) < 13 or data[:4] != b"qoif":
        raise NotThisFormat(f"{name}: QOI header cut short ({len(data)} bytes), which Pillow does not identify")
    w, h = struct.unpack_from(">II", data, 4)
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: QOI of {w} x {h} pixels, which Pillow does not identify")
    _too_large(name, "QOI", w, h)
    bands = 3 if data[12] == 3 else 4
    if (len(data) - 14) * 62 < w * h:  # a byte gives at most a run of 62 pixels: it ends first
        raise OSError(f"{name}: QOI truncated ({len(data)} bytes for {w} x {h} pixels)")
    return _rgb(native.qoi(data[14:], name, bands, h, w))


#: Pillow 12.1.0's DDS formats (``DdsImagePlugin``): a FourCC -> the bcn
#: format it decodes, and a DX10 header's DXGI format -> the same (None:
#: R8G8B8A8, read raw as RGBA)
DDS_FOURCC = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3", b"BC4U": "BC4", b"ATI1": "BC4", b"BC5S": "BC5S",
              b"BC5U": "BC5", b"ATI2": "BC5"}
DDS_DXGI = {70: "BC1", 71: "BC1", 73: "BC2", 74: "BC2", 76: "BC3", 77: "BC3", 79: "BC4", 80: "BC4", 82: "BC5",
            83: "BC5", 84: "BC5S", 95: "BC6H", 96: "BC6HS", 97: "BC7", 98: "BC7", 99: "BC7", 27: None, 28: None,
            29: None}
_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PAL8, _DDPF_RGB, _DDPF_LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000


def _dds_masks(data: bytes, at: int, w: int, h: int, bitcount: int, masks: Tuple[int, ...]) -> np.ndarray:
    """Pillow's ``DdsRgbDecoder``: a little-endian value of ``bitcount // 8``
    bytes a pixel from ``data[at:]`` (past the file's end, zero bytes), and
    each of the R, G and B ``masks``' fields scaled to 8 bits as int(field /
    (mask >> shift) * 255) in float64: (h, w, 3)."""
    step, n = bitcount // 8, w * h
    value = np.zeros(n, np.uint64)
    if step:
        take = min(step, 4)  # the masks are 32-bit: bytes past the fourth of a value never reach them
        count = min(n, max(0, -(-(len(data) - at) // step)))
        base = at + np.arange(count, dtype=np.int64) * step
        tail = np.frombuffer(data + bytes(take), np.uint8)
        for k in range(take):
            idx = base + k
            byte = np.where(idx < len(data), tail[np.minimum(idx, len(data))], 0).astype(np.uint64)
            value[:count] |= byte << np.uint64(8 * k)
    out = np.zeros((n, 3), np.uint8)
    for c, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        field = ((value & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
        out[:, c] = (field / total * 255).astype(np.uint8)
    return out.reshape(h, w, 3)


def decode_dds(data: bytes, name: str = "DDS") -> np.ndarray:
    """A DirectDraw Surface's first surface as uint8 RGB, bit for bit with
    Pillow 12.1.0's ``DdsImagePlugin`` and ``convert("RGB")``: uncompressed
    RGB and RGBA by bit masks (``DdsRgbDecoder``: any byte count a pixel,
    each field scaled as ``_dds_masks`` does, pixels past the file's end
    zero), 8-bit luminance, 16-bit luminance with alpha, 8-bit palette
    (1024 bytes of RGBA entries after the header), the FourCCs of
    ``DDS_FOURCC`` and a DX10 header's DXGI formats of ``DDS_DXGI`` through
    the native BCn decoder (``native.bcn``), R8G8B8A8 raw; the data read
    from where Pillow's header reads stop (128 bytes, 148 after a DX10
    header, 1152 after a palette), as its plugin never seeks.  A header cut
    in its size field raises ``NotThisFormat``; what Pillow refuses (another
    header size, a header cut short, another luminance depth, an unknown
    FourCC or DXGI format or pixel format flags, data cut short) raises
    ``OSError`` naming the file and the kind."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: DDS {why}, which Pillow (the JAX package's DDS lane) does not read")

    if len(data) < 8:
        raise NotThisFormat(f"{name}: DDS cut short in its header size, which Pillow does not identify")
    size = _u32(data, 4)
    if size != 124:
        raise refuse(f"with a header of {size} bytes (Unsupported header size)")
    if len(data) < 128:
        raise refuse(f"header cut short at {len(data) - 8} of 120 bytes (Incomplete header)")
    h, w = _u32(data, 12), _u32(data, 16)
    pfflags, fourcc, bitcount = _u32(data, 80), data[84:88], _u32(data, 88)
    masks = struct.unpack_from("<4I", data, 92)
    _too_large(name, "DDS", w, h)
    if w <= 0 or h <= 0:
        raise refuse(f"of {w} x {h} pixels (tile cannot extend outside image)")
    if pfflags & _DDPF_RGB:
        return _dds_masks(data, 128, w, h, bitcount, masks[:3])  # RGBA's alpha mask: dropped by convert("RGB")
    if pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            return _rgb(_raw(data, 128, w * h, name, "DDS").reshape(h, w))
        if bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            return _rgb(_raw(data, 128, 2 * w * h, name, "DDS").reshape(h, w, 2)[:, :, 0])
        raise refuse(f"of {bitcount}-bit luminance with pixel format flags {pfflags:#x} (Unsupported bitcount)")
    if pfflags & _DDPF_PAL8:
        palette = np.zeros((256, 3), np.uint8)
        table = np.frombuffer(data, np.uint8, min(1024, len(data) - 128) // 4 * 4, 128).reshape(-1, 4)
        palette[:len(table)] = table[:, :3]
        return palette[_raw(data, 128 + 1024, w * h, name, "DDS").reshape(h, w)]
    if not pfflags & _DDPF_FOURCC:
        raise refuse(f"with pixel format flags {pfflags:#x} (Unknown pixel format flags)")
    at = 128
    if fourcc == b"DX10":
        if len(data) < 132:
            raise NotThisFormat(f"{name}: DDS cut short in its DX10 header, which Pillow does not identify")
        dxgi, at = _u32(data, 128), 148
        if dxgi not in DDS_DXGI:
            raise refuse(f"of DXGI format {dxgi} (Unimplemented DXGI format)")
        kind = DDS_DXGI[dxgi]
        if kind is None:
            return _rgb(_raw(data, at, 4 * w * h, name, "DDS").reshape(h, w, 4))
    elif fourcc in DDS_FOURCC:
        kind = DDS_FOURCC[fourcc]
    else:
        raise refuse(f"of FourCC {fourcc!r} (Unimplemented pixel format)")
    return _rgb(_bcn(data[at:], name, kind, w, h))


def _bcn(data: bytes, name: str, kind: str, w: int, h: int) -> np.ndarray:
    px = native.bcn(data, name, kind, w, h)
    return px[:, :, 0] if px.shape[2] == 1 else px


def decode_ftex(data: bytes, name: str = "FTEX") -> np.ndarray:
    """An FTEX texture's first mipmap as uint8 RGB, bit for bit with Pillow
    12.1.0's ``FtexImagePlugin`` and ``convert("RGB")``: format 0 as BC1
    through the native BCn decoder, format 1 raw RGB, from the mipmap whose
    offset and size the header gives (a size of -1 reads to the file's
    end).  A header cut short raises ``NotThisFormat``; what Pillow refuses
    (a file of other than one format, another format, data cut short)
    raises ``OSError`` naming the file and the kind."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: FTEX {why}, which Pillow (the JAX package's FTEX lane) does not read")

    if len(data) < 32:
        raise NotThisFormat(f"{name}: FTEX header cut short ({len(data)} bytes), which Pillow does not identify")
    w, h, _, formats, fmt, where = struct.unpack_from("<6i", data, 8)
    if formats != 1:
        raise refuse(f"of {formats} formats (Pillow asserts one)")
    if where < 0:
        raise refuse(f"whose mipmap offset {where} is negative")
    if len(data[where:where + 4]) < 4:
        raise NotThisFormat(f"{name}: FTEX mipmap size cut short, which Pillow does not identify")
    (size,) = struct.unpack_from("<i", data, where)
    if size < -1:
        raise refuse(f"of mipmap size {size} (read length must be non-negative or -1)")
    mip = data[where + 4:] if size == -1 else data[where + 4:where + 4 + size]
    _too_large(name, "FTEX", w, h)
    if w <= 0 or h <= 0:
        raise refuse(f"of {w} x {h} pixels")
    if fmt == 0:
        return _rgb(_bcn(mip, name, "BC1", w, h))
    if fmt == 1:
        return _raw(mip, 0, 3 * w * h, name, "FTEX").reshape(h, w, 3).copy()
    raise refuse(f"of format {fmt} (Invalid texture compression format)")


#: BLP2's alpha encodings (``BlpImagePlugin.AlphaEncoding``) -> its DXT decode
_BLP_DXT = {0: "BLP DXT1", 1: "BLP DXT3", 7: "BLP DXT5"}


def decode_blp(data: bytes, name: str = "BLP") -> np.ndarray:
    """A Blizzard Mipmap's first mip as uint8 RGB, bit for bit with Pillow
    12.1.0's ``BlpImagePlugin`` and ``convert("RGB")``:

    - BLP1 JPEG: the shared header in front of the first mip, decoded by the
      port's JPEG codec as Pillow's jpegmode CMYK reads it (four components
      read as CMYK, an Adobe YCCK stream not converted: ``native.decode_blp_jpeg``),
      its RGB bytes then read back as BGR rows of the BLP's width (alpha,
      where the file has it, 255);
    - BLP1 palette (encodings 4 and 5): the 256 BGRA entries, then the
      indices read right after them, wherever the mip offset points;
    - BLP2 palette (encoding 1) from the mip offset, and BLP2 DXT1 (with
      or without alpha), DXT3 and DXT5 through the native decoder's BLP
      variants, whose 5:6:5 colours do not replicate their top bits;
      each block row gives four rows of whole blocks, and the stream is
      read back as rows of the BLP's width, 3 bytes a pixel where the file
      has no alpha (so a DXT3 or DXT5 file without alpha, or a width not a
      multiple of 4, reads its pixels skewed, as Pillow shows them).

    A header cut short raises ``NotThisFormat``; what Pillow refuses
    (another compression or encoding, BLP2 JPEG, raw BGRA, tables or data
    cut short, too few pixels) raises ``OSError`` naming the file and the
    kind."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: BLP {why}, which Pillow (the JAX package's BLP lane) does not read")

    blp1 = data[:4] == b"BLP1"
    start = 28 if blp1 else 20
    if len(data) < start - (4 if blp1 else 0):  # BLP1's subtype is skipped, not read
        raise NotThisFormat(f"{name}: BLP header cut short ({len(data)} bytes), which Pillow does not identify")
    (compression,) = struct.unpack_from("<i", data, 4)
    if blp1:
        alpha = _u32(data, 8) != 0
        w, h = _u32(data, 12), _u32(data, 16)
        (encoding,) = struct.unpack_from("<i", data, 20)
    else:
        encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", data, 8)
        alpha = alpha != 0
        w, h = _u32(data, 12), _u32(data, 16)
    _too_large(name, "BLP", w, h)
    if w <= 0 or h <= 0:
        raise refuse(f"of {w} x {h} pixels")
    bands = 4 if alpha else 3
    if len(data) < start + 128:
        raise refuse("cut short in its mip offsets and lengths (Truncated File Read)")
    offsets = struct.unpack_from("<16I", data, start)
    lengths = struct.unpack_from("<16I", data, start + 64)
    pos = start + 128

    def read(at: int, n: int) -> bytes:
        if n > 0 and at + n > len(data):
            raise refuse(f"cut short: {n} bytes at {at} past its end at {len(data)} (Truncated File Read)")
        return data[at:at + max(n, 0)]

    def palette_at(at: int) -> np.ndarray:
        return np.frombuffer(read(at, 1024), np.uint8).reshape(256, 4)[:, 2::-1]  # BGRA entries -> RGB

    def by_index(at: int, table: np.ndarray) -> np.ndarray:
        idx = np.frombuffer(read(at, lengths[0]), np.uint8)
        if idx.size < w * h:
            raise refuse(f"palette mip of {idx.size} indices for {w} x {h} pixels (not enough image data)")
        return table[idx[:w * h]].reshape(h, w, 3)

    if blp1:
        if compression == 0:
            (head,) = struct.unpack_from("<I", read(pos, 4))
            at = max(offsets[0], pos + 4 + head)  # a skip of a negative count reads nothing
            stream = read(pos + 4, head) + read(at, lengths[0])
            if not stream.startswith(b"\xff\xd8\xff"):
                raise refuse("JPEG mip that is not a JPEG stream (not a JPEG file)")
            jpeg = native.decode_blp_jpeg(stream, name)
            _too_large(name, "BLP JPEG", jpeg.shape[1], jpeg.shape[0])
            flat = jpeg.reshape(-1)
            if flat.size < 3 * w * h:
                raise refuse(f"JPEG of {jpeg.shape[1]} x {jpeg.shape[0]} pixels for {w} x {h} (not enough image data)")
            return flat[:3 * w * h].reshape(h, w, 3)[:, :, ::-1].copy()
        if compression != 1:
            raise refuse(f"BLP1 of compression {compression} (Unsupported BLP compression)")
        if encoding not in (4, 5):
            raise refuse(f"BLP1 of encoding {encoding} (Unsupported BLP encoding)")
        return by_index(pos + 1024, palette_at(pos))
    table = palette_at(pos)
    if compression != 1:
        raise refuse(f"BLP2 of compression {compression} (Unknown BLP compression)")
    if encoding == 1:
        return by_index(offsets[0], table)
    if encoding != 2:
        raise refuse(f"BLP2 of encoding {encoding} (Unknown BLP encoding)")
    if alpha_encoding not in _BLP_DXT:
        raise refuse(f"BLP2 DXT of alpha encoding {alpha_encoding} (Unsupported alpha encoding)")
    kind = _BLP_DXT[alpha_encoding] + (" alpha" if alpha_encoding == 0 and alpha else "")
    across, down = (w + 3) // 4, (h + 3) // 4
    block = 8 if alpha_encoding == 0 else 16
    blocks = read(offsets[0], across * down * block)
    stream = native.bcn(blocks, name, kind, 4 * across, 4 * down).reshape(-1)
    return stream[:bands * w * h].reshape(h, w, bands)[:, :, :3].copy()


#: Pillow 12.1.0's ICNS sizes (``IcnsFile.SIZES``): (width, height, scale)
#: -> the elements read for it, in order, each "png" (a PNG or JPEG 2000
#: stream), "rle" (24-bit RGB, raw or RLE), "rle4" (it32: four zero bytes,
#: then as "rle") or "mask" (8-bit alpha)
ICNS_SIZES = {
    (512, 512, 2): ((b"ic10", "png"),), (512, 512, 1): ((b"ic09", "png"),), (256, 256, 2): ((b"ic14", "png"),),
    (256, 256, 1): ((b"ic08", "png"),), (128, 128, 2): ((b"ic13", "png"),),
    (128, 128, 1): ((b"ic07", "png"), (b"it32", "rle4"), (b"t8mk", "mask")), (64, 64, 1): ((b"icp6", "png"),),
    (32, 32, 2): ((b"ic12", "png"),), (48, 48, 1): ((b"ih32", "rle"), (b"h8mk", "mask")),
    (32, 32, 1): ((b"icp5", "png"), (b"il32", "rle"), (b"l8mk", "mask")), (16, 16, 2): ((b"ic11", "png"),),
    (16, 16, 1): ((b"icp4", "png"), (b"is32", "rle"), (b"s8mk", "mask")),
}


def decode_icns(data: bytes, name: str = "ICNS") -> np.ndarray:
    """A macOS icon's image as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``IcnsImagePlugin`` and ``convert("RGB")``: the elements found by
    walking the file up to the size its header gives (a later one of a
    type replacing an earlier), the largest size of ``ICNS_SIZES`` with
    an element (Pillow's ``bestsize``), and every element of that size
    read in order, as ``dataforsize`` reads them: a PNG through the port's
    PNG codec in Pillow's lane, a JPEG 2000 stream through
    ``decode_jpeg2000`` (either of its own size, which must be one of the
    file's sizes over a whole scale, as Pillow's size setter asks), 24-bit
    RGB raw where the element holds 3 bytes a pixel and else RLE through
    the native library (``native.icns_rle``, ``it32`` after four zero
    bytes), an 8-bit mask (read, then dropped with the alpha).  A PNG
    element wins; else the RGB.  A file Pillow does not identify (a
    directory cut short or holding an empty element, no element of a
    listed size) raises ``NotThisFormat``; what it refuses (a JPEG 2000
    element Pillow refuses, another stream, RLE that passes
    its channel or ends early, a mask or raw RGB cut short, a size holding
    a mask alone) raises ``OSError`` naming the file and the kind."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: ICNS {why}, which Pillow (the JAX package's ICNS lane) does not read")

    if len(data) < 8:
        raise NotThisFormat(f"{name}: ICNS header cut short, which Pillow does not identify")
    size = _u32(data, 4, ">")
    elements = {}
    i = 8
    while i < size:
        if i + 8 > len(data):
            raise NotThisFormat(f"{name}: ICNS directory cut short at byte {i}, which Pillow does not identify")
        sig, block = data[i:i + 4], _u32(data, i + 4, ">")
        if block <= 0:
            raise NotThisFormat(f"{name}: ICNS element {sig!r} of no bytes (invalid block header), which Pillow does "
                                "not identify")
        elements[sig] = (i + 8, block - 8)
        i += block
    present = [s for s, kinds in ICNS_SIZES.items() if any(code in elements for code, _ in kinds)]
    if not present:
        raise NotThisFormat(f"{name}: ICNS with no 32-bit icon element (No 32bit icon resources found), which "
                            "Pillow does not identify")
    best = max(present)
    pw, ph = best[0] * best[2], best[1] * best[2]
    png = rgb = None
    for code, kind in ICNS_SIZES[best]:
        if code not in elements:
            continue
        start, length = elements[code]
        if kind == "png":
            head = data[start:start + 12]
            if head.startswith(_PNG_MAGIC):
                png = native.decode_buffer(data[start:], name, "pillow")
                _too_large(name, "ICNS PNG element", png.shape[1], png.shape[0])
            elif head.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) or head == _JP2_MAGIC:
                # Pillow opens the element's bytes as a JPEG 2000 file, then
                # converts it to RGBA (the same RGB as convert("RGB") gives)
                element = f"{name} (ICNS element {code.decode()})"
                try:
                    png = decode_jpeg2000(data[start:start + length], element)
                except NotThisFormat as e:
                    raise refuse(f"element {code.decode()} that Pillow's JPEG 2000 plugin does not open ({e})") from e
                _too_large(name, "ICNS JPEG 2000 element", png.shape[1], png.shape[0])
            else:
                raise refuse(f"element {code.decode()} of another stream than PNG or JPEG 2000 (Unsupported icon "
                             "subimage format)")
        elif kind == "mask":
            if start + pw * ph > len(data):
                raise refuse(f"mask {code.decode()} cut short (buffer is not large enough)")
        else:
            if kind == "rle4":
                if data[start:start + 4] != bytes(4):
                    raise refuse(f"element {code.decode()} without its four zero bytes (Unknown signature)")
                start, length = start + 4, length - 4
            if length == 3 * pw * ph:
                raw = data[start:start + length]
                if len(raw) < length:
                    raise refuse(f"RGB element {code.decode()} cut short (not enough image data)")
                rgb = np.frombuffer(raw, np.uint8).reshape(ph, pw, 3)
            else:
                planes = native.icns_rle(data[start:], name, pw * ph)
                rgb = planes.reshape(3, ph, pw).transpose(1, 2, 0)
    if png is not None:
        # Pillow's load sets the image's size to the PNG's, which must be one
        # of the file's sizes over a whole scale
        png_h, png_w = png.shape[:2]
        if not any((s[0] * s[2]) // png_w == (s[1] * s[2]) / png_h for s in present):
            raise refuse(f"element of {png_w} x {png_h} pixels, none of its sizes {present} over a whole scale "
                         "(This is not one of the allowed sizes of this image)")
        return png
    if rgb is None:
        raise refuse(f"size {best} holding a mask alone (no RGB channels)")
    return np.ascontiguousarray(rgb)


#: the JP2 signature box Pillow's plugin accepts beside a bare codestream
#: (``FF4F FF51``: SOC, then SIZ)
_JP2_MAGIC = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"


class _Boxes:
    """Jpeg2KImagePlugin's ``BoxReader`` on the file ``f``: its reads bounded
    by ``length`` (where given) and by the box it is in."""

    def __init__(self, f: BinaryIO, length: int = -1):
        self.f, self.has_length, self.length, self.remaining = f, length >= 0, length, -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.f.tell() + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def _read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        data = self.f.read(n)
        if len(data) < n:
            raise OSError(f"Expected to read {n} bytes but only got {len(data)}.")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))

    def boxes(self) -> "_Boxes":
        n = self.remaining
        return _Boxes(io.BytesIO(self._read(n)), n)

    def has_next(self) -> bool:
        return self.f.tell() + self.remaining < self.length if self.has_length else True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.f.seek(self.remaining, os.SEEK_CUR)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


class _Palette:
    """``ImagePalette.getcolor`` as Jpeg2KImagePlugin fills a palette from a
    ``pclr`` box: a colour seen before keeps its index, a new one takes the
    index of the palette's length in colours of its mode (``len(mode)``
    bytes, whatever the entry's own length), overwriting the bytes there."""

    def __init__(self, mode: str):
        self.mode, self.palette, self.colors = mode, bytearray(), {}

    def getcolor(self, color: tuple) -> None:
        if color in self.colors:
            return
        n = len(self.mode)
        index = len(self.palette) // n
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        self.colors[color] = index
        if index * n < len(self.palette):
            self.palette = self.palette[:index * n] + bytes(color) + self.palette[index * n + n:]
        else:
            self.palette += bytes(color)

    def lut(self) -> np.ndarray:
        """The RGB of each index as the image's palette holds it after
        ``putpalette``: the whole colours of the bytes, then black."""
        n = len(self.mode)
        size = len(self.palette) // n
        lut = np.zeros((256, 3), np.uint8)
        lut[:size] = np.frombuffer(bytes(self.palette[:size * n]), np.uint8).reshape(size, n)[:, :3]
        return lut


def _j2k_siz(f: BinaryIO) -> Tuple[Tuple[int, int], str]:
    """``_parse_codestream``: the size and mode from the SIZ segment."""
    hdr = f.read(2)
    lsiz = struct.unpack(">H", hdr)[0]
    siz = hdr + f.read(lsiz - 2)
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    if csiz == 1:
        mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = ("LA", "RGB", "RGBA")[csiz - 2]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return (xsiz - xosiz, ysiz - yosiz), mode


def _j2k_comment(f: BinaryIO) -> None:
    """``_parse_comment``: the markers after SIZ walked up to SOT, EOC or a
    COM (their reads can fail as Pillow's do)."""
    for _ in range(1 << 16):
        marker = f.read(2)
        if not marker:
            return
        typ = marker[1]
        if typ in (0x90, 0xD9):
            return
        length = struct.unpack(">H", f.read(2))[0]
        if typ == 0x64:
            f.read(length - 2)
            return
        f.seek(length - 2, os.SEEK_CUR)


def _jp2_header(f: BinaryIO) -> Tuple[Tuple[int, int], str, Optional[_Palette]]:
    """``_parse_jp2_header``: the size, mode and palette from the ``jp2h``
    box (``ihdr``; ``colr`` read where ``ihdr`` gave four components; a
    ``pclr`` of at most 8 bits a column on L or LA)."""
    reader = _Boxes(f)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.boxes()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    size = mode = nc = palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1:
                mode = "I;16" if (bpc & 0x7F) > 8 else "L"
            elif nc in (2, 3, 4):
                mode = ("LA", "RGB", "RGBA")[nc - 2]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            if max(header.fields(">" + "B" * npc), default=0) <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(header.fields(">" + "B" * npc))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode, palette


def _jpeg2000_open(data: bytes, name: str) -> Tuple[Tuple[int, int], str, Optional[_Palette]]:
    """``Jpeg2KImageFile._open`` on a file's bytes: (size, mode, palette),
    ``NotThisFormat`` where Pillow does not identify the file, and Pillow's
    verdict where its reads stop the walk."""
    f = io.BytesIO(data)
    with _Opening(name, "JPEG 2000"):
        palette = None
        try:
            sig = f.read(4)
            if sig == b"\xff\x4f\xff\x51":
                size, mode = _j2k_siz(f)
                _j2k_comment(f)
            else:
                if sig + f.read(8) != _JP2_MAGIC:
                    raise SyntaxError("not a JPEG 2000 file")
                size, mode, palette = _jp2_header(f)
                if f.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
                    length = struct.unpack(">H", f.read(2))[0]
                    f.seek(length - 2, os.SEEK_CUR)
                    _j2k_comment(f)
        except OSError as e:  # a box cut short: Pillow's verdict stops its walk
            raise OSError(f"{name}: JPEG 2000 header that Pillow refuses ({e}), which Pillow (the JAX package's "
                          "JPEG 2000 lane) does not read") from e
    _checked(name, "JPEG 2000", mode, size)
    return size, mode, palette


def _jpeg2000_rgb(mode: str, px: np.ndarray, palette: Optional[_Palette]) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of a JPEG 2000 image of ``mode``."""
    if mode == "I;16":
        return _gray_rgb(px.view("<u2")[..., 0], mode)
    if mode in ("P", "PA"):
        return np.ascontiguousarray(palette.lut()[px[..., 0]])
    if mode == "CMYK":
        return _cmyk2rgb(px)
    if mode in ("L", "LA"):
        return _rgb(px[..., 0])
    return np.ascontiguousarray(px[..., :3])


def decode_jpeg2000(data: bytes, name: str = "JPEG 2000") -> np.ndarray:
    """A JPEG 2000 codestream or JP2 file as uint8 RGB, bit for bit with
    Pillow 12.1.0's ``Jpeg2KImagePlugin`` (OpenJPEG 2.5.4) and
    ``convert("RGB")``: the size and mode its ``_open`` reads (the SIZ
    segment's components and precision, or the JP2 header's ``ihdr``, a
    CMYK ``colr`` and a ``pclr`` palette, filled as ``ImagePalette`` fills
    it), the port's decoder (``native.decode_jpeg2000``) for the pixels
    Pillow's unpackers make of OpenJPEG's tiles, then the mode's
    conversion.  What Pillow does not identify raises ``NotThisFormat``;
    what OpenJPEG or Pillow's decoder refuses (a cut or damaged stream, an
    ``ihdr`` of another size than the codestream's, components and a
    colour space no unpacker takes) raises ``OSError`` naming the file and
    Pillow's verdict, and HTJ2K and Part 2 markers the port's refusal."""
    (w, h), mode, palette = _jpeg2000_open(data, name)
    return _jpeg2000_rgb(mode, native.decode_jpeg2000(data, name, mode, w, h), palette)


#: the auxiliary type URNs libavif takes for an alpha item ('auxC')
_AVIF_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
#: libavif's default limits (``imageSizeLimit``, ``imageDimensionLimit``)
_AVIF_SIZE_LIMIT = 16384 * 16384
_AVIF_DIMENSION_LIMIT = 32768


class _AvifReject(Exception):
    """libavif's verdict on a file's boxes: ``syntax`` where Pillow's
    ``_avif`` raises SyntaxError (Image.open goes on to the next plugin),
    else the RuntimeError it raises."""

    def __init__(self, what: str, syntax: bool = True):
        super().__init__(what)
        self.syntax = syntax


def _avif_boxes(data: bytes, at: int, end: int):
    """The boxes of ``data[at:end]`` as libavif's box reader walks them:
    (type, payload start, box end); a header cut short or a size past
    ``end`` is libavif's BMFF_PARSE_FAILED."""
    while at < end:
        if at + 8 > end:
            raise _AvifReject("box header cut short")
        size, kind = struct.unpack(">I4s", data[at:at + 8])
        head = 8
        if size == 1:
            if at + 16 > end:
                raise _AvifReject("box header cut short")
            size = struct.unpack(">Q", data[at + 8:at + 16])[0]
            head = 16
        elif size == 0:
            size = end - at
        if kind == b"uuid":
            head += 16
        if size < head or at + size > end:
            raise _AvifReject(f"box {kind!r} of {size} bytes past its parent")
        yield kind, at + head, at + size
        at += size


class _AvifReader:
    """Big-endian fields of a box's payload; a read past it is libavif's
    BMFF_PARSE_FAILED."""

    def __init__(self, data: bytes, at: int, end: int):
        self.data, self.at, self.end = data, at, end

    def u(self, n: int) -> int:
        if self.at + n > self.end:
            raise _AvifReject("box field past its end")
        v = int.from_bytes(self.data[self.at:self.at + n], "big")
        self.at += n
        return v

    def full(self) -> Tuple[int, int]:
        v = self.u(4)
        return v >> 24, v & 0xFFFFFF

    def string(self) -> bytes:
        z = self.data.find(b"\0", self.at, self.end)
        if z < 0:
            raise _AvifReject("string without its terminating zero")
        v = self.data[self.at:z]
        self.at = z + 1
        return v


def _avif_top(data: bytes) -> List[Tuple[bytes, int, int]]:
    """The file's top-level boxes as libavif's avifParse reads them: a
    header cut short is BMFF_PARSE_FAILED; ftyp, meta and moov must be
    whole (TRUNCATED_DATA); other boxes (mdat) are not read, so their sizes
    may run past the file; the walk ends once ftyp and meta are read (and
    moov, for the avis brand of image sequences)."""
    out, at, end = [], 0, len(data)
    needs_moov = False
    while at < end:
        if at + 8 > end:
            raise _AvifReject("box header cut short")
        size, kind = struct.unpack(">I4s", data[at:at + 8])
        head = 8
        if size == 1:
            if at + 16 > end:
                raise _AvifReject("box header cut short")
            size, head = struct.unpack(">Q", data[at + 8:at + 16])[0], 16
        elif size == 0:
            size = end - at
        if size < head:
            raise _AvifReject(f"box {kind!r} smaller than its header")
        if not out and kind != b"ftyp":
            raise _AvifReject("the first box is not ftyp")
        if kind in (b"ftyp", b"meta", b"moov") and at + size > end:
            raise _AvifReject(f"box {kind!r} cut short")
        out.append((kind, at + head, min(at + size, end)))
        if kind == b"ftyp":
            needs_moov = any(data[i:i + 4] == b"avis" for i in range(at + head, at + size - 3, 4))
        kinds = [k for k, _, _ in out]
        if b"meta" in kinds and (not needs_moov or b"moov" in kinds):
            break
        at += size
    return out


def _avif_meta(data: bytes, at: int, end: int) -> SimpleNamespace:
    """libavif's avifParseMetaBox: the items (type, extents, construction
    method), their properties (by ipma), references (iref) and the
    primary item (pitm)."""
    r = _AvifReader(data, at, end)
    version, _ = r.full()
    if version != 0:
        raise _AvifReject("meta box of another version than 0")
    meta = SimpleNamespace(items={}, props=[], assoc={}, refs=[], primary=None, idat=b"")
    first = True
    for kind, a, z in _avif_boxes(data, r.at, end):
        b = _AvifReader(data, a, z)
        if first:
            if kind != b"hdlr":
                raise _AvifReject("meta box whose first box is not hdlr")
            if b.full()[0] != 0:
                raise _AvifReject("hdlr of another version than 0")
            if b.u(4):
                raise _AvifReject("hdlr of a non-zero pre_defined")
            if data[b.at:b.at + 4] != b"pict":
                raise _AvifReject("handler type other than pict")
            b.u(4 + 12)
            b.string()
            first = False
        elif kind == b"pitm":
            version, _ = b.full()
            if version > 1:
                raise _AvifReject("pitm of version above 1")
            meta.primary = b.u(2 if version == 0 else 4)
        elif kind == b"idat":
            meta.idat = data[a:z]
        elif kind == b"iloc":
            version, _ = b.full()
            if version > 2:
                raise _AvifReject("iloc of version above 2")
            sizes = b.u(2)
            off_size, len_size, base_size = sizes >> 12, (sizes >> 8) & 15, (sizes >> 4) & 15
            index_size = sizes & 15 if version in (1, 2) else 0
            if any(n not in (0, 4, 8) for n in (off_size, len_size, base_size, index_size)):
                raise _AvifReject("iloc field size other than 0, 4 or 8")
            for _ in range(b.u(2 if version < 2 else 4)):
                item = b.u(2 if version < 2 else 4)
                field = b.u(2) if version in (1, 2) else 0
                method = field & 15
                if field >> 4:
                    raise _AvifReject("iloc reserved bits set")
                if method > 1:
                    raise _AvifReject(f"iloc construction method {method}", syntax=False)
                b.u(2)  # data_reference_index
                base = b.u(base_size)
                extents = []
                for _ in range(b.u(2)):
                    b.u(index_size)
                    extents.append((base + b.u(off_size), b.u(len_size)))
                if item in meta.items:
                    raise _AvifReject("iloc of an item listed twice")
                meta.items[item] = SimpleNamespace(type=None, extents=extents, method=method, hidden=False)
        elif kind == b"iinf":
            version, _ = b.full()
            if version > 1:
                raise _AvifReject("iinf of version above 1")
            count = b.u(2 if version == 0 else 4)
            entries = list(_avif_boxes(data, b.at, z))
            if len(entries) < count:
                raise _AvifReject("iinf of fewer entries than its count")
            for kind2, a2, z2 in entries[:count]:
                if kind2 != b"infe":
                    raise _AvifReject("iinf entry other than infe")
                e = _AvifReader(data, a2, z2)
                version2, flags = e.full()
                if version2 not in (2, 3):
                    raise _AvifReject("infe of another version than 2 or 3")
                item = e.u(2 if version2 == 2 else 4)
                e.u(2)
                typ = data[e.at:e.at + 4]
                e.u(4)
                e.string()  # item_name
                if typ == b"mime":
                    e.string()  # content_type
                meta.items.setdefault(item, SimpleNamespace(type=None, extents=None, method=0, hidden=False))
                meta.items[item].type = typ
                meta.items[item].hidden = bool(flags & 1)
        elif kind == b"iref":
            version, _ = b.full()
            if version > 1:
                raise _AvifReject("iref of version above 1")
            for kind2, a2, z2 in _avif_boxes(data, b.at, z):
                e = _AvifReader(data, a2, z2)
                src = e.u(2 if version == 0 else 4)
                for _ in range(e.u(2)):
                    meta.refs.append((kind2, src, e.u(2 if version == 0 else 4)))
        elif kind == b"iprp":
            for kind2, a2, z2 in _avif_boxes(data, a, z):
                if kind2 == b"ipco":
                    meta.props = [(k, pa, pz) for k, pa, pz in _avif_boxes(data, a2, z2)]
                elif kind2 == b"ipma":
                    e = _AvifReader(data, a2, z2)
                    version, flags = e.full()
                    if version > 1:
                        raise _AvifReject("ipma of version above 1")
                    for _ in range(e.u(4)):
                        item = e.u(2 if version < 1 else 4)
                        for _ in range(e.u(1)):
                            v = e.u(2 if flags & 1 else 1)
                            index = v & (0x7FFF if flags & 1 else 0x7F)
                            if index:
                                meta.assoc.setdefault(item, []).append(index)
    if first:
        raise _AvifReject("meta box without hdlr")
    if any(item not in meta.items for item in meta.assoc):
        raise _AvifReject("ipma of an item no iinf or iloc names")
    return meta


def _avif_props(data: bytes, meta: SimpleNamespace, item: int) -> dict:
    """The properties associated with ``item`` by kind (the first of each),
    each checked as libavif parses it: ispe, pixi and auxC of version 0,
    av1C's marker and version 1, pixi's depths one depth (else libavif's
    NOT_IMPLEMENTED) and av1C's (else BMFF_PARSE_FAILED)."""
    out = {}
    for index in meta.assoc.get(item, ()):
        if index > len(meta.props):
            raise _AvifReject("ipma index past ipco's properties")
        kind, a, z = meta.props[index - 1]
        out.setdefault(kind, (a, z))
    for kind in (b"ispe", b"pixi", b"auxC"):
        if kind in out and _AvifReader(data, *out[kind]).full()[0] != 0:
            raise _AvifReject(f"{kind.decode()} of another version than 0")
    if b"av1C" in out:
        a, z = out[b"av1C"]
        if z - a < 4 or data[a] != 0x81:
            raise _AvifReject("av1C of another marker or version than 1")
    if b"pixi" in out and b"av1C" in out:
        pixi = _AvifReader(data, *out[b"pixi"])
        pixi.full()
        depths = [pixi.u(1) for _ in range(pixi.u(1))]
        flags = data[out[b"av1C"][0] + 2]
        depth = 12 if flags & 0x20 else 10 if flags & 0x40 else 8
        if len(set(depths)) > 1:
            raise _AvifReject("Not implemented (pixi of unequal depths)", syntax=False)
        if depths and depths[0] != depth:
            raise _AvifReject("pixi depth other than av1C's")
    return out


def _avif_payload(data: bytes, meta: SimpleNamespace, item: int, name: str) -> bytes:
    """An item's bytes, its extents joined (from the file or from idat)."""
    it = meta.items[item]
    src = meta.idat if it.method == 1 else data
    out = bytearray()
    for off, length in it.extents or ():  # a length of 0 is no bytes, as libavif reads it
        if off + length > len(src):
            raise OSError(f"{name}: AVIF item data past the end of the file (Pillow: Failed to decode frame 0: "
                          "Truncated data), which Pillow does not read")
        out += src[off:off + length]
    return bytes(out)


def _avif_open(data: bytes, name: str) -> SimpleNamespace:
    """``AvifImageFile._open`` over libavif 1.3.0's avifDecoderParse, on a
    file's bytes: the size and mode Pillow reports, the colour and alpha
    items' AV1 streams, their nclx and the 'prem' reference.  What libavif
    refuses with a SyntaxError raises ``NotThisFormat`` (Pillow tries the
    next plugin), other verdicts ``OSError`` naming the file and Pillow's
    verdict, and the kinds the port does not read their refusal by name."""
    def refuse(what: str) -> OSError:
        return OSError(f"{name}: AVIF {what} is not read by the PyTorch port")

    try:
        top = _avif_top(data)
        if not top or top[0][0] != b"ftyp":
            raise _AvifReject("the first box is not ftyp")
        a, z = top[0][1], top[0][2]
        brands = [data[i:i + 4] for i in range(a, z - 3, 4) if i != a + 4]
        if not any(b in (b"avif", b"avis") for b in brands):
            raise _AvifReject("no avif or avis brand")
        metas = [(a, z) for kind, a, z in top if kind == b"meta"]
        if not metas:
            raise _AvifReject("no meta box")
        meta = _avif_meta(data, *metas[0])
        primary = meta.primary
        if primary is None or primary not in meta.items or meta.items[primary].type is None:
            if any(kind == b"moov" for kind, _, _ in top):
                raise refuse("image sequence without a still primary item")
            raise _AvifReject("no primary item")
        item = meta.items[primary]
        if item.type == b"grid":
            raise refuse("grid derived image")
        if item.type != b"av01":
            raise _AvifReject("Missing or empty image item", syntax=False)
        props = _avif_props(data, meta, primary)
        for layered in (b"a1lx", b"lsel"):
            if layered in props:
                raise refuse(f"layered image ({layered.decode()})")
        if b"av1C" not in props:
            raise _AvifReject("Missing or empty image item", syntax=False)
        if b"ispe" not in props:
            raise _AvifReject("no ispe")
        ispe = _AvifReader(data, *props[b"ispe"])
        ispe.full()
        w, h = ispe.u(4), ispe.u(4)
        if w == 0 or h == 0:
            raise _AvifReject("ispe of no pixels")
        if w * h > _AVIF_SIZE_LIMIT or w > _AVIF_DIMENSION_LIMIT or h > _AVIF_DIMENSION_LIMIT:
            raise _AvifReject("image larger than libavif's limits", syntax=False)
        nclx = None
        for kind, a, z in (meta.props[i - 1] for i in meta.assoc.get(primary, ())):
            if kind == b"colr" and data[a:a + 4] == b"nclx" and nclx is None:
                c = _AvifReader(data, a + 4, z)
                nclx = (c.u(2), c.u(2), c.u(2), c.u(1))
                if nclx[3] & 0x7F:
                    raise _AvifReject("nclx reserved bits set")
                nclx = nclx[:3] + (nclx[3] >> 7,)
        alpha = None
        premultiplied = False
        for kind, src, dst in meta.refs:
            if kind == b"auxl" and dst == primary and src in meta.items and meta.items[src].type == b"av01":
                aprops = _avif_props(data, meta, src)
                if b"auxC" in aprops and b"av1C" in aprops:
                    c = _AvifReader(data, *aprops[b"auxC"])
                    c.full()
                    if c.string() in _AVIF_ALPHA_URNS:
                        alpha = src
                        break
        if alpha is not None:
            premultiplied = any(kind == b"prem" and src == primary and dst == alpha for kind, src, dst in meta.refs)
        color = _avif_payload(data, meta, primary, name)
        alpha_bytes = _avif_payload(data, meta, alpha, name) if alpha is not None else None
        if not color:
            raise _AvifReject("Missing or empty image item", syntax=False)
    except _AvifReject as e:
        if e.syntax:
            raise NotThisFormat(f"{name}: AVIF boxes libavif does not parse ({e}), which Pillow does not "
                                "identify") from e
        raise OSError(f"{name}: AVIF file libavif refuses (Pillow: Failed to decode image: {e}), which Pillow "
                      "does not read") from e
    _too_large(name, "AVIF", w, h)
    return SimpleNamespace(size=(w, h), mode="RGBA" if alpha is not None else "RGB", color=color, alpha=alpha_bytes,
                           nclx=nclx, premultiplied=premultiplied)


def decode_avif(data: bytes, name: str = "AVIF", counts: Optional[dict] = None) -> np.ndarray:
    """An AVIF file as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``AvifImagePlugin`` (libavif 1.3.0 over dav1d 1.5.1 and libyuv) and
    ``convert("RGB")``: the boxes as libavif parses them (``_avif_open``),
    the primary item's AV1 stream (and its alpha item's) through the port's
    AV1 intra decoder, then libavif's YUV-to-RGB, a premultiplied image
    unpremultiplied first (``native.decode_avif``).  Rotation, mirroring and
    cropping properties are not applied, as libavif and Pillow do not apply
    them to the pixels.  ``counts``, if given, takes what the colour
    stream met (``native.AV1_COUNTS``)."""
    hd = _avif_open(data, name)
    w, h = hd.size
    return native.decode_avif(hd.color, hd.alpha, name, w, h, hd.nclx, hd.premultiplied, counts)


#: Pillow 12.1.0's Sun raster raw modes (``SunImagePlugin``) by depth:
#: (bits a pixel, the mode without a colour map)
_SUN_DEPTHS = {1: "1", 4: "L", 8: "L", 24: "RGB", 32: "RGB"}


def decode_sun(data: bytes, name: str = "Sun raster") -> np.ndarray:
    """A Sun raster file as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``SunImagePlugin`` and ``convert("RGB")``: depths 1 (a set bit black),
    4 and 8 (gray, or indices through a colour map of planar R, G and B of
    up to 1024 bytes, an index past it black), 24 (BGR; RGB where the type
    is 3) and 32 (BGRX; RGBX for type 3); types 0, 1, 3, 4 and 5 raw with
    rows padded to 16 bits, type 2 RLE through the native library
    (``native.sun_rle``: Pillow's SunRleDecode.c, rows not padded, a run
    going on into the next rows).  What Pillow does not identify (another
    depth or type, a colour map of another type or past 1024 bytes, a
    header cut short) raises ``NotThisFormat``; what it refuses (a colour
    map on 1-, 24- or 32-bit pixels, data cut short) raises ``OSError``
    naming the file and the kind."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: Sun raster {why}, which Pillow (the JAX package's Sun raster lane) does not read")

    if len(data) < 32:
        raise NotThisFormat(f"{name}: Sun raster header cut short, which Pillow does not identify")
    _, w, h, depth, _, ftype, ptype, plength = struct.unpack_from(">8I", data)
    if depth not in _SUN_DEPTHS:
        raise NotThisFormat(f"{name}: Sun raster of depth {depth} (Unsupported Mode/Bit Depth), which Pillow does "
                            "not identify")
    mode = _SUN_DEPTHS[depth]
    lut = None
    if plength:
        if plength > 1024 or ptype != 1:
            raise NotThisFormat(f"{name}: Sun raster colour map of {plength} bytes and type {ptype}, which Pillow "
                                "does not identify")
        table = np.frombuffer(data, np.uint8, max(0, min(plength, len(data) - 32)), 32)
        n = table.size // 3
        if mode != "L":
            raise refuse(f"of depth {depth} with a colour map (unrecognized image mode)")
        lut = np.zeros((256, 3), np.uint8)
        lut[:n] = table[:3 * n].reshape(3, n).T
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat(f"{name}: Sun raster of type {ftype} (Unsupported Sun Raster file type), which Pillow "
                            "does not identify")
    _too_large(name, "Sun raster", w, h)
    if w <= 0 or h <= 0:
        raise refuse(f"of {w} x {h} pixels")
    at = 32 + plength
    row = (w * depth + 7) // 8
    if ftype == 2:
        rows = native.sun_rle(data[at:], name, row, h)
    else:
        stride = (w * depth + 15) // 16 * 2
        span = _raw(data, at, (h - 1) * stride + row, name, "Sun raster")
        rows = np.lib.stride_tricks.as_strided(span, (h, row), (stride, 1))
    if depth == 1:
        return _rgb(np.where(_unpack_bits(rows, 1, w), 0, 255).astype(np.uint8))
    if depth in (4, 8):
        px = _unpack_bits(rows, depth, w) if depth == 4 else rows[:, :w]
        return _rgb(px * np.uint8(17) if depth == 4 and lut is None else px, lut)
    px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)
    return np.ascontiguousarray(px[:, :, :3] if ftype == 3 else px[:, :, 2::-1])


class _Opening:
    """``with _Opening(name, fmt):`` around the part of a reader that
    follows a Pillow plugin's ``_open``: the errors ``ImageFile`` takes as
    "not this plugin's file" (SyntaxError, and IndexError, TypeError,
    KeyError, EOFError and struct.error, which it turns into SyntaxError)
    become ``NotThisFormat``, and a ValueError, which Pillow lets through,
    an ``OSError`` naming the file."""

    def __init__(self, name: str, fmt: str):
        self.name, self.fmt = name, fmt

    def __enter__(self):
        return self

    def __exit__(self, kind, e, tb):
        if kind is not None and issubclass(kind, (SyntaxError, IndexError, TypeError, KeyError, EOFError,
                                                  struct.error)):
            raise NotThisFormat(f"{self.name}: {self.fmt} header that Pillow does not identify "
                                f"({kind.__name__}: {e})") from e
        if kind is not None and issubclass(kind, ValueError):
            raise OSError(f"{self.name}: {self.fmt} header that Pillow refuses ({e}), which Pillow (the JAX "
                          f"package's {self.fmt} lane) does not read") from e
        return False


def _identified(name: str, fmt: str, w: int, h: int) -> None:
    """``ImageFile``'s checks after ``_open`` and ``Image.open``'s: a size
    of no pixels is not the plugin's file; too many pixels are refused."""
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: {fmt} of {w} x {h} pixels, which Pillow does not identify")
    _too_large(name, fmt, w, h)


#: XbmImagePlugin's header: width, height, an optional hot spot, then
#: anything up to the last ``_bits[]`` of the first 512 bytes
_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)


def decode_xbm(data: bytes, name: str = "XBM") -> np.ndarray:
    """An X11 bitmap as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``XbmImagePlugin`` and ``convert("RGB")``: the header Pillow's pattern
    matches in the first 512 bytes, then each byte the two characters after
    the next 'x' (``native.xbm``: XbmDecode.c, a character other than a hex
    digit counted 0), rows padded to a byte, bits least significant first,
    a set bit white.  A header the pattern does not match raises
    ``NotThisFormat``; data that end before the last row raise ``OSError``
    naming the file."""
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise NotThisFormat(f"{name}: XBM header that Pillow's pattern does not match (not a XBM file), which Pillow "
                            "does not identify")
    w, h = int(m.group("width")), int(m.group("height"))
    _identified(name, "XBM", w, h)
    rows = native.xbm(data[m.end():], name, (w + 7) // 8, h)
    return _rgb(np.unpackbits(rows, axis=1, bitorder="little")[:, :w] * np.uint8(255))


#: XpmImagePlugin's values line: width, height, colours, characters a pixel
_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _xpm_keys(parts: List[bytes], bpp: int, table: dict, name: str) -> np.ndarray:
    """Each pixel's entry of ``table`` (key -> row of the colour table) for
    the keys of ``parts`` (each line's text between its first and last
    quote), ``bpp`` characters a key, the last of a line cut short where
    the line is; raises naming the first key the table lacks (Pillow's
    KeyError or ValueError)."""

    def missing(key: bytes) -> OSError:
        return OSError(f"{name}: XPM pixel key {key!r} not in its colour table, which Pillow (the JAX package's XPM "
                       "lane) does not read")

    full = sorted((k, v) for k, v in table.items() if len(k) == bpp)
    keys = np.array([k for k, _ in full], f"V{bpp}")
    rows = np.array([v for _, v in full], np.int64)
    out = []
    for line in parts:
        n, cut = divmod(len(line), bpp)
        if n:
            got = np.frombuffer(line, f"V{bpp}", n)
            at = np.minimum(np.searchsorted(keys, got), max(len(keys) - 1, 0))
            found = keys[at] == got if len(keys) else np.zeros(n, bool)
            if not found.all():
                raise missing(line[int(np.argmin(found)) * bpp:][:bpp])
            out.append(rows[at])
        if cut:
            if line[n * bpp:] not in table:
                raise missing(line[n * bpp:])
            out.append(np.array([table[line[n * bpp:]]], np.int64))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def decode_xpm(data: bytes, name: str = "XPM") -> np.ndarray:
    """An X11 pixmap as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``XpmImagePlugin`` and ``convert("RGB")``: the ``/* XPM */`` header,
    the first line that opens with the values, the colour table of that
    many lines as Pillow reads them (each key's ``c`` colour: ``#`` and hex
    digits through Python's int, its low 24 bits; ``None`` for no
    colour, which no pixel may use), a later entry of a key replacing its
    colour; then ``XpmDecoder``'s lines (a first ``/* pixels */`` line
    skipped, each line's text between its first and last quote, keys of
    that many characters, the last cut short where the line is) until the
    image is full, each key through the table (a palette of at most 256
    lines, RGB above: the same colours).  What Pillow does not identify
    raises ``NotThisFormat``; what it refuses (another colour, a key of no
    colour or not in the table, too few pixels) raises ``OSError`` naming
    the file."""
    f = io.BytesIO(data)
    with _Opening(name, "XPM"):
        if not f.read(9).startswith(b"/* XPM */"):
            raise SyntaxError("not an XPM file")
        while True:
            line = f.readline()
            if not line:
                raise SyntaxError("broken XPM file")
            m = _XPM_HEAD.match(line)
            if m:
                break
        w, h = int(m.group(1)), int(m.group(2))
        colors, bpp = int(m.group(3)), int(m.group(4))
        table = {}
        for _ in range(colors):
            line = f.readline().rstrip()
            key = line[1:bpp + 1]
            words = line[bpp + 1:-2].split()
            for i in range(0, len(words), 2):
                if words[i] == b"c":
                    rgb = words[i + 1]
                    if rgb == b"None":
                        pass  # transparency: in no entry of the table
                    elif rgb.startswith(b"#"):
                        v = int(rgb[1:], 16)
                        table[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                    else:
                        raise ValueError(f"cannot read this XPM file (colour {rgb!r})")
                    break
            else:
                raise ValueError(f"cannot read this XPM file (no c key on {line[:40]!r})")
    _identified(name, "XPM", w, h)
    need = w * h
    parts, got, header = [], 0, False
    while got < need:
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        if bpp == 0:
            raise OSError(f"{name}: XPM of 0 characters a pixel, which Pillow (the JAX package's XPM lane) does not "
                          "read")
        line = b'"'.join(line.split(b'"')[1:-1])
        parts.append(line)
        got += -(-len(line) // bpp)
    order = {k: i for i, k in enumerate(table)}
    idx = _xpm_keys(parts, bpp, order, name)
    if idx.size < need:
        raise OSError(f"{name}: XPM of {idx.size} pixels for {w} x {h} (not enough image data), which Pillow (the JAX "
                      "package's XPM lane) does not read")
    lut = np.array(list(table.values()), np.uint8).reshape(-1, 3)
    return lut[idx[:need]].reshape(h, w, 3)


def decode_msp(data: bytes, name: str = "MSP") -> np.ndarray:
    """A Windows Paint (MSP) file as uint8 RGB, bit for bit with Pillow
    12.1.0's ``MspImagePlugin`` and ``convert("RGB")``: the 32-byte header
    whose 16-bit words XOR to 0, version 1 (``DanM``) raw 1-bit rows from
    byte 32, version 2 (``LinS``) through the row map and RLE of Pillow's
    ``MspDecoder`` (``native.msp_rle``: a blank row white, every row's
    bytes written on after the last, however many it decodes to); a set
    bit white.  A header cut short or of a bad checksum raises
    ``NotThisFormat``; what Pillow refuses (data cut short, a run cut
    short, too few bytes) raises ``OSError`` naming the file."""
    s = data[:32]
    if len(s) < 32 or not s.startswith((b"DanM", b"LinS")):
        raise NotThisFormat(f"{name}: MSP header cut short ({len(s)} bytes), which Pillow does not identify")
    checksum = 0
    for (word,) in struct.iter_unpack("<H", s):
        checksum ^= word
    if checksum:
        raise NotThisFormat(f"{name}: MSP header of checksum {checksum:#x} (bad MSP checksum), which Pillow does not "
                            "identify")
    w, h = _u16(s, 4), _u16(s, 6)
    _identified(name, "MSP", w, h)
    row = (w + 7) // 8
    if s.startswith(b"DanM"):
        rows = _raw(data, 32, h * row, name, "MSP").reshape(h, row)
    else:
        rows = native.msp_rle(data[32:], name, row, h)
    return _rgb(_unpack_bits(rows, 1, w) * np.uint8(255))


def decode_fli(data: bytes, name: str = "FLI") -> np.ndarray:
    """An FLI or FLC animation's first frame as uint8 RGB, bit for bit with
    Pillow 12.1.0's ``FliImagePlugin`` and ``convert("RGB")``: the 128-byte
    header's checks; the palette of the first colour chunk (4: 8-bit
    values, 11: 6-bit ones shifted left by 2, the low 8 bits kept) among
    the subchunks of the first frame chunk (after a prefix chunk, which
    Pillow skips here), else a gray ramp; the frame read from byte 128,
    whatever precedes it there, its chunks applied by the native library
    (``native.fli``: FliDecode.c's BLACK, BRUN, COPY, LC and SS2, colour
    and PSTAMP chunks skipped) onto index 0.  What Pillow does not
    identify (a header or a palette chunk cut short, no frames, a colour
    past index 255) raises ``NotThisFormat``; what it refuses (a frame
    that is not a frame chunk, as a prefix chunk at byte 128 is, an
    unknown chunk, data past a chunk's or the frame's end, data cut short)
    raises ``OSError`` naming the file."""
    f = io.BytesIO(data)
    with _Opening(name, "FLI"):
        s = f.read(128)
        if not (len(s) >= 16 and _u16(s, 4) in (0xAF11, 0xAF12) and _u16(s, 14) in (0, 3) and s[20:22] == bytes(2)
                and s[42:80] == bytes(38) and s[88:] == bytes(40)):
            raise SyntaxError("not an FLI/FLC file")
        frames, w, h = struct.unpack_from("<HHH", s, 6)
        palette = [(a, a, a) for a in range(256)]
        s = f.read(16)
        if struct.unpack_from("<H", s, 4)[0] == 0xF100:  # a prefix chunk: skipped to find the palette
            f.seek(128 + struct.unpack_from("<I", s)[0])
            s = f.read(16)
        if struct.unpack_from("<H", s, 4)[0] == 0xF1FA:
            size = None
            for _ in range(struct.unpack_from("<H", s, 6)[0]):
                if size is not None:
                    f.seek(size - 6, os.SEEK_CUR)
                s = f.read(6)
                kind = struct.unpack_from("<H", s, 4)[0]
                if kind in (4, 11):
                    shift = 2 if kind == 11 else 0
                    i = 0
                    for _ in range(struct.unpack_from("<H", f.read(2))[0]):
                        s = f.read(2)
                        i += s[0]
                        s = f.read((s[1] or 256) * 3)
                        for n in range(0, len(s), 3):
                            palette[i] = (s[n] << shift, s[n + 1] << shift, s[n + 2] << shift)
                            i += 1
                    break
                size = struct.unpack_from("<I", s)[0]
                if not size:
                    break
        if frames == 0:
            raise EOFError("attempt to seek outside sequence")
        if len(data) < 128 + 4:
            raise EOFError("missing frame size")
    _identified(name, "FLI", w, h)
    lut = np.array(palette, np.int64).astype(np.uint8)  # o8: the low 8 bits
    return lut[native.fli(data[128:], name, w, h)]


def decode_dcx(data: bytes, name: str = "DCX") -> np.ndarray:
    """An Intel DCX fax file's first page as uint8 RGB, bit for bit with
    Pillow 12.1.0's ``DcxImagePlugin`` and ``convert("RGB")``: the offset
    table after the magic (up to 1024 entries, ended by a 0), then the PCX
    at the first offset through ``decode_pcx`` (its 8-bit palette the
    whole file's last 769 bytes, as Pillow seeks from the file's end).  A
    table cut short or empty, or no PCX at the offset, raises
    ``NotThisFormat``."""
    f = io.BytesIO(data)
    with _Opening(name, "DCX"):
        if _u32(f.read(4), 0) != 987654321:
            raise SyntaxError("not a DCX file")
        offsets = []
        for _ in range(1024):
            (offset,) = struct.unpack("<I", f.read(4))
            if not offset:
                break
            offsets.append(offset)
        if not offsets:
            raise EOFError("attempt to seek outside sequence")
    return decode_pcx(data, name, at=offsets[0], fmt="DCX")


def decode_gbr(data: bytes, name: str = "GBR") -> np.ndarray:
    """A GIMP brush as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``GbrImagePlugin`` and ``convert("RGB")``: versions 1 and 2 (its
    ``GIMP`` magic and spacing), the comment of the header's size less 20
    or 28 bytes read past (a negative count, as Python's read takes it,
    reads to the file's end), then depth 1 as gray and depth 4 as RGBA,
    its alpha dropped.  What Pillow's ``_open`` does not identify raises
    ``NotThisFormat``; pixels cut short (not enough image data) raise
    ``OSError`` naming the file."""
    f = io.BytesIO(data)
    with _Opening(name, "GBR"):
        header, version, w, h, depth = struct.unpack(">5I", f.read(20))
        if header < 20 or version not in (1, 2) or w == 0 or h == 0 or depth not in (1, 4):
            raise SyntaxError("not a GIMP brush")
        if version == 2:
            if f.read(4) != b"GIMP":
                raise SyntaxError("not a GIMP brush, bad magic number")
            struct.unpack(">I", f.read(4))
        f.read(header - (20 if version == 1 else 28))
    _identified(name, "GBR", w, h)
    px = f.read(w * h * depth)
    if len(px) < w * h * depth:
        raise OSError(f"{name}: GBR of {len(px)} bytes of pixels for {w} x {h} x {depth} (not enough image data), "
                      "which Pillow (the JAX package's GBR lane) does not read")
    return _rgb(np.frombuffer(px, np.uint8).reshape(h, w, depth)[..., :3] if depth == 4 else
                np.frombuffer(px, np.uint8).reshape(h, w))


def decode_pixar(data: bytes, name: str = "PIXAR") -> np.ndarray:
    """A PIXAR raster as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``PixarImagePlugin``: the size at bytes 416 and 418, the mode pair at
    424 and 426, of which Pillow reads (14, 2) alone, raw RGB at byte 1024.
    A header cut short or another mode pair raises ``NotThisFormat``
    (Pillow sets no mode); pixels cut short raise ``OSError`` naming the
    file."""
    s = data[:512]
    if len(s) < 428:
        raise NotThisFormat(f"{name}: PIXAR header cut short ({len(s)} bytes), which Pillow does not identify")
    h, w = _u16(s, 416), _u16(s, 418)
    mode = (_u16(s, 424), _u16(s, 426))
    if mode != (14, 2):
        raise NotThisFormat(f"{name}: PIXAR of channel and depth descriptions {mode} (Pillow reads (14, 2) alone and "
                            "sets no mode for others), which Pillow does not identify")
    _identified(name, "PIXAR", w, h)
    return _raw(data, 1024, 3 * w * h, name, "PIXAR").reshape(h, w, 3).copy()


#: FitsImagePlugin's modes by BITPIX, with the bytes of a sample read
_FITS_MODES = {8: ("L", 1), 16: ("I;16", 2), 32: ("I", 4), -32: ("F", 4), -64: ("F", 4)}


def _fits_headers(f: io.BytesIO):
    """FitsImageFile._open's walk of the header cards: (headers, the first
    header unit with a size's decoder, offset, args, the size), Pillow's
    errors raised as it raises them."""
    headers, in_progress, decoder, offset, args, size = {}, False, "", 0, (), None
    while True:
        card = f.read(80)
        if not card:
            raise OSError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break  # the data unit
        elif keyword == b"END":
            f.seek(math.ceil(f.tell() / 2880) * 2880)
            if not decoder:
                decoder, offset, args, size = _fits_parse(headers)
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[keyword] = value
    if not decoder:
        raise ValueError("No image data")
    return decoder, offset + f.tell() - 80, args, size


def _fits_size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _fits_parse(headers: dict):
    """FitsImageFile._parse_headers: (decoder, offset, args, (w, h))."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        table = _fits_size(headers, prefix) or (0, 0)
        offset = table[0] * table[1] * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _fits_size(headers, prefix)
    if not size:
        return "", 0, (), None
    bits = int(headers[prefix + b"BITPIX"])
    return decoder, offset, (bits,), size


def _gray_rgb(v: np.ndarray, mode: str) -> np.ndarray:
    """Pillow's L, I;16 (and I;16B), I and F -> RGB: I;16 clipped at 255, I
    at 0 and 255, F as ``f2l``."""
    if mode == "F":
        return _rgb(_f2l(v))
    if mode == "L":
        return _rgb(v.astype(np.uint8))
    return _rgb(np.clip(v.astype(np.int64), 0, 255).astype(np.uint8))


def decode_fits(data: bytes, name: str = "FITS") -> np.ndarray:
    """A FITS file's first image as uint8 RGB, bit for bit with Pillow
    12.1.0's ``FitsImagePlugin`` and ``convert("RGB")``: the 80-byte header
    cards as Pillow walks them (a value up to a ``/``, after an ``=``; the
    units padded to 2880 bytes; the first header of a size, NAXIS 1 read as
    1 x NAXIS1), BITPIX 8, 16, 32, -32 and -64 as Pillow's L, I;16, I and
    F, whose raw modes read little-endian samples (I;16 of 2 bytes, I and F
    of 4, so a -64 image reads its doubles' halves as floats), rows
    bottom-up; a ``GZIP_1`` tile of a binary table through gzip as
    ``FitsGzipDecoder`` reads it (the last BITPIX / 8 bytes of every 4,
    rows bottom-up: no bytes for a negative BITPIX); then I;16 clipped at
    255, I at 0 and 255, F as ``f2l`` (the integer part, NaN 0, infinities
    0 and 255).  What Pillow does not identify (the first card not SIMPLE
    = T, a missing NAXIS, another BITPIX, no pixels) raises
    ``NotThisFormat``; what it refuses (a header cut short, no image data,
    a value that is no integer, pixels cut short, a gzip stream that does
    not decompress) raises ``OSError`` naming the file."""
    f = io.BytesIO(data)
    with _Opening(name, "FITS"):
        try:
            decoder, offset, args, size = _fits_headers(f)
        except OSError as e:
            raise OSError(f"{name}: FITS header cut short ({e}), which Pillow (the JAX package's FITS lane) does not "
                          "read") from e
        if args[0] not in _FITS_MODES:
            raise SyntaxError(f"BITPIX {args[0]}: no mode")
    mode, k = _FITS_MODES[args[0]]
    w, h = size
    _identified(name, "FITS", w, h)
    dtype = {"L": np.uint8, "I;16": "<u2", "I": "<i4", "F": "<f4"}[mode]
    if decoder == "raw":
        v = _raw(data, offset, w * h * k, name, "FITS").view(dtype).reshape(h, w)[::-1]
        return _gray_rgb(v, mode)
    if offset < 0:
        raise OSError(f"{name}: FITS GZIP_1 tile at offset {offset}, which Pillow (the JAX package's FITS lane) does "
                      "not read")
    try:
        value = gzip.decompress(data[offset:])
    except (OSError, EOFError, zlib.error) as e:
        raise OSError(f"{name}: FITS GZIP_1 tile that does not decompress ({e}), which Pillow (the JAX package's "
                      "FITS lane) does not read") from e
    take = min(args[0] // 8, 4)
    if take <= 0 or len(value) < 4 * w * h:
        raise OSError(f"{name}: FITS GZIP_1 tile of {len(value)} bytes for {w} x {h} pixels of BITPIX {args[0]} (not "
                      "enough image data), which Pillow (the JAX package's FITS lane) does not read")
    px = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)[::-1, :, 4 - take:]
    return _gray_rgb(np.ascontiguousarray(px).view(dtype).reshape(h, w), mode)


#: McIdasImagePlugin's modes by bytes a sample: (mode, big-endian dtype)
_MCIDAS_MODES = {1: ("L", np.uint8), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}


def decode_mcidas(data: bytes, name: str = "McIdas") -> np.ndarray:
    """A McIdas area file as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``McIdasImagePlugin`` and ``convert("RGB")``: the 256-byte directory of
    big-endian words, 1, 2 or 4 bytes a sample as L, I;16B and I (from
    I;32B), the offset and row stride Pillow computes from words 15, 34,
    10, 11 and 14; L and I;16B rows as Pillow maps them where the file
    holds every row's stride (rows that overlap where the stride is short
    of a row, a stride of 0 or less taken as the row's size) and as its
    raw decoder reads them where it does not (the last row without its
    padding, a stride short of a row refused), I's always so; then I;16B
    clipped at 255 and I at 0 and 255.  A directory cut short or of
    another sample size raises ``NotThisFormat``; what Pillow refuses
    (pixels cut short, a negative offset, a stride short of a row) raises
    ``OSError`` naming the file."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: McIdas {why}, which Pillow (the JAX package's McIdas lane) does not read")

    s = data[:256]
    if len(s) != 256:
        raise NotThisFormat(f"{name}: McIdas directory cut short ({len(s)} bytes), which Pillow does not identify")
    word = (0,) + struct.unpack(">64i", s)
    if word[11] not in _MCIDAS_MODES:
        raise NotThisFormat(f"{name}: McIdas of {word[11]} bytes a sample (unsupported McIdas format), which Pillow "
                            "does not identify")
    mode, dtype = _MCIDAS_MODES[word[11]]
    w, h = word[10], word[9]
    _identified(name, "McIdas", w, h)
    offset, stride = word[34] + word[15], word[15] + word[10] * word[11] * word[14]
    row = w * word[11]
    if offset < 0:
        raise refuse(f"of pixel offset {offset} (a negative seek)")
    if mode != "I" and (stride <= 0 or offset + h * stride <= len(data)):  # mapped
        stride = stride if stride > 0 else row
        if offset + h * stride > len(data):
            raise refuse(f"of {h} rows of {stride} bytes from byte {offset} past its end at {len(data)} (buffer is not "
                         "large enough)")
    elif stride and stride < row:
        raise refuse(f"of row stride {stride} short of its {row}-byte rows (bad configuration)")
    else:
        stride = stride or row
        _raw(data, offset, (h - 1) * stride + row, name, "McIdas")
    span = np.frombuffer(data[offset:offset + (h - 1) * stride + row], np.uint8)
    if span.size < (h - 1) * stride + row:  # mapped rows that overlap: the last reads past the file's end as zeros
        span = np.concatenate([span, np.zeros((h - 1) * stride + row - span.size, np.uint8)])
    rows = np.lib.stride_tricks.as_strided(span, (h, row), (stride, 1))
    return _gray_rgb(np.ascontiguousarray(rows).view(dtype).reshape(h, w), "L" if mode == "L" else "I")


#: XVThumbImagePlugin's palette: index r << 5 | g << 2 | b of 3, 3 and 2 bits
_XV_PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                        for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def decode_xv(data: bytes, name: str = "XV thumbnail") -> np.ndarray:
    """An XV thumbnail as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``XVThumbImagePlugin`` and ``convert("RGB")``: the rest of the ``P7
    332`` line and the comment lines after it (each opening with ``#``)
    skipped, the width and height of the next line through Python's int,
    then a byte a pixel through the fixed 3-3-2 palette.  A file that ends
    before that line raises ``NotThisFormat``; what Pillow refuses (a size
    line of fewer than two integers, pixels cut short) raises ``OSError``
    naming the file."""
    f = io.BytesIO(data)
    with _Opening(name, "XV thumbnail"):
        if not f.read(6).startswith(b"P7 332"):
            raise SyntaxError("not an XV thumbnail file")
        f.readline()
        while True:
            s = f.readline()
            if not s:
                raise SyntaxError("Unexpected EOF reading XV thumbnail file")
            if s[0] != 35:
                break
        w, h = s.strip().split(maxsplit=2)[:2]
        w, h = int(w), int(h)
    _identified(name, "XV thumbnail", w, h)
    return _XV_PALETTE[_raw(data, f.tell(), w * h, name, "XV thumbnail").reshape(h, w)]


# --- IM, IMT, IPTC, PCD and SPIDER: the plugins Pillow runs without an _accept ---


def _c_round(v: np.ndarray) -> np.ndarray:
    """C's ``(int)(v + 0.5)``: a half away from zero above 0, toward it below."""
    return np.trunc(v + 0.5).astype(np.int64)


_I256 = np.arange(256)
#: Pillow's YCbCr -> RGB tables (ConvertYCbCr.c): the JFIF coefficients
#: times (i - 128) in 6 fraction bits, each rounded as C's (int)(v + 0.5)
_YCBCR_R = _c_round(1.402 * (_I256 - 128) * 64) >> 6
_YCBCR_G_CB = _c_round(-0.34414 * (_I256 - 128) * 64)
_YCBCR_G_CR = _c_round(-0.71414 * (_I256 - 128) * 64)
_YCBCR_B = _c_round(1.772 * (_I256 - 128) * 64) >> 6
#: Pillow's PhotoYCC tables (UnpackYCC.c, the "YCC;P" raw mode): luma
#: times 1.3584, C1 about 156 and C2 about 137 times 2.2179 and 1.8215, and
#: green's 0.194 of C1's and 0.509 of C2's, rounded as C's (int)(v + 0.5)
_YCC_L = _c_round(1.3584 * _I256)
_YCC_CB = _c_round(2.2179 * (_I256 - 156))
_YCC_CR = _c_round(1.8215 * (_I256 - 137))
_YCC_G_CB = _c_round(-0.4302726 * (_I256 - 156))
_YCC_G_CR = _c_round(-0.9271435 * (_I256 - 137))


def ycbcr_to_rgb(ycbcr: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of YCbCr (uint8 (..., 3) -> (..., 3)):
    luma plus each table's entry, the sum shifted down 6 bits, clipped."""
    y = ycbcr[..., 0].astype(np.int64)
    cb, cr = ycbcr[..., 1], ycbcr[..., 2]
    rgb = np.stack([y + _YCBCR_R[cr], y + ((_YCBCR_G_CB[cb] + _YCBCR_G_CR[cr]) >> 6), y + _YCBCR_B[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def ycc_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's "YCC;P" unpacker (Y, C1, C2 uint8 (..., 3) -> RGB): the luma
    table's entry plus the chroma ones, clipped."""
    y = _YCC_L[ycc[..., 0]]
    c1, c2 = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + _YCC_CR[c2], y + _YCC_G_CB[c1] + _YCC_G_CR[c2], y + _YCC_CB[c1]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _im_types() -> dict:
    """ImImagePlugin's "Image type" table (its ``OPEN``), built as the
    plugin builds it: type -> (mode, raw mode); "L*16 image" ends as F;16."""
    types = {
        "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
        "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
        "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
        "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"),
        "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
        "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
        "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
    for i in ("8", "8S", "16", "16S", "32", "32F"):
        types[f"L {i} image"] = types[f"L*{i} image"] = ("F", f"F;{i}")
    for i in ("16", "16L", "16B"):
        types[f"L {i} image"] = types[f"L*{i} image"] = (f"I;{i}", f"I;{i}")
    types["L 32S image"] = types["L*32S image"] = ("I", "I;32S")
    for j in range(2, 33):
        types[f"L*{j} image"] = ("F", f"F;{j}")
    return types


IM_TYPES = _im_types()
#: the header keys ImImagePlugin counts (its TAGS): a file needs one
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut", "Name",
            "Scale (x,y)", "Image size (x*y)", "Image type")
_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
#: the bits a pixel of each raw mode an IM file's one tile reads
_IM_BITS = {"1": 1, "L": 8, "P": 8, "P;2": 2, "P;4": 4, "RGB": 24, "RGB;L": 24, "RGBA;L": 32, "RGBX;L": 32,
            "CMYK;L": 32, "YCbCr;L": 24, "LA;L": 16, "PA;L": 16, "I;16": 16, "I;16L": 16, "I;16B": 16, "I;32": 32,
            "I;32S": 32, "F;8": 8, "F;8S": 8, "F;16": 16, "F;16S": 16, "F;32": 32, "F;32F": 32}
#: the raw modes Pillow 12.1.0 unpacks into each mode an IM header may
#: name (an "Image type" of the table, or one that is a mode itself and
#: keeps the raw mode of the type before it); RGB;T and RYB;T are three
#: whole planes, F;n of another n its bit decoder
_IM_PAIRS = {"1": ("1",), "L": ("L",), "P": ("L", "P", "P;2", "P;4"), "LAB": ("L",), "LA": ("LA;L",),
             "PA": ("PA;L",), "RGB": ("RGB", "RGB;L", "RGB;T", "RYB;T", "RGBA;L", "RGBX;L"),
             "RGBX": ("RGB", "RGB;L", "RGB;T", "RYB;T", "RGBX;L"), "RGBA": ("RGB;T", "RYB;T", "RGBA;L"),
             "CMYK": ("CMYK;L",), "YCbCr": ("YCbCr;L",), "I": ("I;16", "I;16B", "I;32", "I;32S"),
             "I;16": ("I;16", "I;16B"), "I;16L": ("I;16L",), "I;16B": ("I;16B",),
             "F": tuple(f"F;{j}" for j in ("8", "8S", "16", "16S", "32", "32F", *range(2, 32)))}
#: the sample type of each raw mode read as numbers
_IM_DTYPES = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4", "I;32S": "<i4", "F;8": "u1",
              "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4", "F;32F": "<f4"}


def _im_number(s: str):
    """ImImagePlugin's ``number``: an int, else a float (else ValueError)."""
    try:
        return int(s)
    except ValueError:
        return float(s)


def _checked(name: str, fmt: str, mode, size) -> None:
    """``ImageFile``'s checks after ``_open`` (a mode and a positive size,
    else the plugin does not identify the file; a size that cannot be
    indexed or compared passes it on too) and ``Image.open``'s (too many
    pixels stop the walk)."""
    with _Opening(name, fmt):
        if not mode or size[0] <= 0 or size[1] <= 0:
            raise SyntaxError("not identified by this plugin")
        pixels = max(1, size[0]) * max(1, size[1])
    if pixels > MAX_PIXELS:
        raise OSError(f"{name}: {fmt} of {size[0]} x {size[1]} pixels, more than {MAX_PIXELS}, which Pillow does not "
                      "read")


def _im_header(f: BinaryIO, name: str) -> SimpleNamespace:
    """``ImImageFile._open`` on the file ``f``: the text header's lines up
    to a 0x00 or 0x1a byte or the file's end, each of at most 100 bytes and
    ``key: value``; the size, frame count and scale through ``number``; an
    "Image type" of the table gives the mode and raw mode (any other value
    is the mode, the raw mode left as it was, L at first); L and 512 x 512
    by default; the data after the next 0x1a, the 768 bytes of a ``Lut``
    first, which make an L/LA/P/PA image P/PA where they are not gray
    (any other LUT Pillow keeps and never applies).  Raises
    ``NotThisFormat`` where Pillow passes the file on and ``OSError``
    where it stops (a number that is no number)."""
    f.seek(0)
    with _Opening(name, "IM"):
        if b"\n" not in f.read(100):
            raise SyntaxError("not an IM file")
        f.seek(0)
        info = {"Image type": "L", "Image size (x*y)": (512, 512), "File size (no of images)": 1}
        rawmode, n, s = "L", 0, b""
        while True:
            s = f.read(1)
            if s == b"\r":
                continue
            if not s or s == b"\0" or s == b"\x1a":
                break
            s = s + f.readline()
            if len(s) > 100:
                raise SyntaxError("not an IM file")
            s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
            m = _IM_LINE.match(s)
            if not m:
                raise SyntaxError(f"Syntax error in IM header: {s.decode('ascii', 'replace')}")
            k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
            if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
                v = tuple(map(_im_number, v.replace("*", ",").split(",")))
                v = v[0] if len(v) == 1 else v
            elif k == "Image type" and v in IM_TYPES:
                v, rawmode = IM_TYPES[v]
            info[k] = v
            n += k in _IM_TAGS
        if not n:
            raise SyntaxError("Not an IM file")
        size, mode = info["Image size (x*y)"], info["Image type"]
        while s and not s.startswith(b"\x1a"):
            s = f.read(1)
        if not s:
            raise SyntaxError("File truncated")
        palette = None
        if "Lut" in info:
            lut = f.read(768)
            gray = True
            for i in range(256):
                if not lut[i] == lut[i + 256] == lut[i + 512]:
                    gray = False
            if mode in ("L", "LA", "P", "PA") and not gray:
                mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
                palette = lut
        offset = f.tell()
    _checked(name, "IM", mode, size)
    return SimpleNamespace(mode=mode, rawmode=rawmode, size=size, palette=palette, offset=offset)


def decode_im(data: bytes, name: str, hd: SimpleNamespace) -> np.ndarray:
    """An IFUNC/LabEye IM file's first frame as uint8 RGB, bit for bit with
    Pillow 12.1.0's ``ImImagePlugin`` and ``convert("RGB")``: the header
    ``hd`` that ``_im_header`` read in the walk, then one raw tile of the
    mode's raw mode (``_IM_PAIRS``: 1-bit, L, 2- and 4-bit palettes, RGB,
    each row's planes of RGB;L, RGBA;L, RGBX;L, CMYK;L, YCbCr;L, LA;L and
    PA;L, 16- and 32-bit integers, F of 8, 16 and 32 bits) or, for RGB;T
    and RYB;T, three whole planes in the order G, R, B, or for F;n Pillow's
    bit decoder (``native.im_bits``); every row bottom-up; a palette image
    through its ``Lut`` (black without one); then Pillow's conversions
    (CMYK as ``cmyk2rgb``, YCbCr as ``ycbcr_to_rgb``, Lab through
    ``native.lab_to_rgb``, 16- and 32-bit integers clipped, F as ``f2l``).
    What Pillow refuses (a size that is no pair of integers, a mode without
    an unpacker, pixels cut short) raises ``OSError`` naming the file."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: IM {why}, which Pillow (the JAX package's IM lane) does not read")

    mode, rawmode, size = hd.mode, hd.rawmode, hd.size
    if not (isinstance(size, tuple) and len(size) == 2 and all(type(v) is int for v in size)):
        raise refuse(f"of size {size!r}, no pair of integers")
    if rawmode not in _IM_PAIRS.get(mode, ()):
        raise refuse(f"of mode {mode!r} and raw mode {rawmode!r} (unknown raw mode for given image mode)")
    w, h = size
    if rawmode in ("RGB;T", "RYB;T"):
        planes = _raw(data, hd.offset, 3 * w * h, name, "IM").reshape(3, h, w)[:, ::-1]
        return np.ascontiguousarray(planes[[1, 0, 2]].transpose(1, 2, 0))
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and int(rawmode[2:]) not in (8, 16, 32):
        return _gray_rgb(native.im_bits(data[hd.offset:], name, int(rawmode[2:]), w, h), "F")
    stride = (w * _IM_BITS[rawmode] + 7) // 8
    rows = _raw(data, hd.offset, stride * h, name, "IM").reshape(h, stride)[::-1]
    if rawmode in _IM_DTYPES:
        v = np.ascontiguousarray(rows).view(_IM_DTYPES[rawmode])[:, :w]
        return _gray_rgb(v, "F" if mode == "F" else "I")
    if rawmode == "1":
        return _rgb(np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255))
    if rawmode in ("P;2", "P;4"):
        rows = _unpack_bits(rows, int(rawmode[2]), w)
    if rawmode.endswith(";L"):  # a row of each band's plane after the other
        rows = rows[:, :w * (_IM_BITS[rawmode] // 8)].reshape(h, -1, w).transpose(0, 2, 1)
    elif rawmode == "RGB":
        rows = rows.reshape(h, w, 3)
    px = np.ascontiguousarray(rows)
    if mode in ("P", "PA"):
        lut = np.zeros((256, 3), np.uint8)
        if hd.palette is not None:
            lut = np.frombuffer(hd.palette, np.uint8).reshape(3, 256).T.copy()
        return _rgb(px[..., 0] if px.ndim == 3 else px, lut)
    if mode == "LAB":
        return native.lab_to_rgb(np.stack([px, np.zeros_like(px), np.zeros_like(px)], -1).reshape(-1, 3)).reshape(
            h, w, 3)
    if mode == "CMYK":
        return _cmyk2rgb(px)
    if mode == "YCbCr":
        return ycbcr_to_rgb(px)
    return _rgb(px[..., 0] if px.ndim == 3 and px.shape[2] == 2 else px)


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt_header(f: BinaryIO, name: str) -> SimpleNamespace:
    """``ImtImageFile._open`` on the file ``f``: ``width``, ``height`` and
    ``pixel n8`` lines (``*`` a comment) read in blocks of 100 bytes, up to
    a 0x0c byte, where the raw L data begin, a line that is no field, one of
    1 or more than 100 bytes, or the file's end (then no tile: Pillow
    identifies the file and cannot load it).  Raises ``NotThisFormat``
    where Pillow passes the file on (no mode, no size) and ``OSError``
    where it stops (a size that is no integer)."""
    f.seek(0)
    with _Opening(name, "IMT"):
        buffer = f.read(100)
        if b"\n" not in buffer:
            raise SyntaxError("not an IM file")
        xsize = ysize = 0
        size, mode, offset = (0, 0), "", None
        while True:
            if buffer:
                s, buffer = buffer[:1], buffer[1:]
            else:
                s = f.read(1)
            if not s:
                break
            if s == b"\x0c":
                offset = f.tell() - len(buffer)
                break
            if b"\n" not in buffer:
                buffer += f.read(100)
            lines = buffer.split(b"\n")
            s += lines.pop(0)
            buffer = b"\n".join(lines)
            if len(s) == 1 or len(s) > 100:
                break
            if s[0] == ord(b"*"):
                continue
            m = _IMT_FIELD.match(s)
            if not m:
                break
            k, v = m.group(1, 2)
            if k == b"width":
                xsize = int(v)
                size = xsize, ysize
            elif k == b"height":
                ysize = int(v)
                size = xsize, ysize
            elif k == b"pixel" and v == b"n8":
                mode = "L"
    _checked(name, "IMT", mode, size)
    return SimpleNamespace(size=size, offset=offset)


def decode_imt(data: bytes, name: str, hd: SimpleNamespace) -> np.ndarray:
    """An NIH IM Tools file as uint8 RGB, bit for bit with Pillow 12.1.0's
    ``ImtImagePlugin`` and ``convert("RGB")``: the header ``hd`` that
    ``_imt_header`` read in the walk, then the raw L rows after its 0x0c
    byte, top-down.  What Pillow refuses (a header without its 0x0c byte,
    pixels cut short) raises ``OSError`` naming the file."""
    if hd.offset is None:
        raise OSError(f"{name}: IMT header without the 0x0c byte its data follow (cannot load this image), which "
                      "Pillow (the JAX package's IMT lane) does not read")
    w, h = hd.size
    return _rgb(_raw(data, hd.offset, w * h, name, "IMT").reshape(h, w))


#: IptcImagePlugin's compressions: 1 raw, 5 an embedded image file
_IPTC_COMPRESSION = {1: "raw", 5: "jpeg"}


def _iptc_field(f: BinaryIO):
    """``IptcImageFile.field``: (record, dataset) and the size of the next
    field, or (None, 0) at five zero bytes or the file's end."""
    s = f.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise OSError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = struct.unpack(">I", (b"\0\0\0\0" + f.read(size - 128))[-4:])[0]
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size


def _iptc_int(info: dict, key) -> int:
    """``IptcImageFile.getint``: a field's last 4 bytes, big-endian."""
    return struct.unpack(">I", (b"\0\0\0\0" + info[key])[-4:])[0]


def _iptc_header(f: BinaryIO, name: str) -> SimpleNamespace:
    """``IptcImageFile._open`` on the file ``f``: the fields up to the first
    (8, 10), the data's; layers and component from (3, 60) (1 and 0: L;
    3 or 4 and a component: RGB or CMYK, of the band (3, 65) less 1), the
    size from (3, 20) and (3, 30), the compression from (3, 120).  Raises
    ``NotThisFormat`` where Pillow passes the file on and ``OSError`` where
    it stops: a field length byte above 132 (illegal field length), a
    compression missing or not 1 or 5 (Unknown IPTC image compression)."""
    f.seek(0)
    try:
        with _Opening(name, "IPTC"):
            info = {}
            while True:
                offset = f.tell()
                tag, size = _iptc_field(f)
                if not tag or tag == (8, 10):
                    break
                data = f.read(size) if size else None
                if tag in info:
                    info[tag] = (info[tag] if isinstance(info[tag], list) else [info[tag]]) + [data]
                else:
                    info[tag] = data
            layers, component = info[(3, 60)][0], info[(3, 60)][1]
            mode, band = "", None
            if layers == 1 and not component:
                mode = "L"
            else:
                mode = "RGB" if layers == 3 and component else "CMYK" if layers == 4 and component else ""
                band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
            size = _iptc_int(info, (3, 20)), _iptc_int(info, (3, 30))
            try:
                compression = _IPTC_COMPRESSION[_iptc_int(info, (3, 120))]
            except KeyError as e:
                raise OSError("Unknown IPTC image compression") from e
    except NotThisFormat:
        raise
    except OSError as e:
        raise OSError(f"{name}: IPTC file that Pillow refuses ({e}), which Pillow (the JAX package's IPTC lane) does "
                      "not read") from e
    _checked(name, "IPTC", mode, size)
    return SimpleNamespace(mode=mode, band=band, size=size, compression=compression,
                   offset=offset if tag == (8, 10) else None)


def _jpeg_components(data: bytes) -> Optional[int]:
    """The components of a JPEG stream's first frame header, or None."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker, length = data[pos + 1], _u16(data, pos + 2, ">")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return data[pos + 9] if pos + 9 < len(data) else None
        pos += 2 + length
    return None


def _tiff_mode(data: bytes) -> Optional[str]:
    """The mode Pillow opens a classic TIFF's first directory in, where its
    tags tell it plainly: unsigned gray of one sample (1, L of 2 to 8
    bits, I;16 or I;16B, I), F (SampleFormat 3) and LAB (CIELab); None for
    the others."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or _u16(data, 2, order) != 42:
        return None
    at, tags = _u32(data, 4, order), {}
    for i in range(max(_u16(data, at, order), 0) if at >= 0 else 0):
        entry = at + 2 + 12 * i
        if entry + 12 > len(data):
            break
        tag, kind = _u16(data, entry, order), _u16(data, entry + 2, order)
        tags[tag] = _u16(data, entry + 8, order) if kind == 3 else _u32(data, entry + 8, order)
    if tags.get(339) == 3:
        return "F"
    if tags.get(262) == 8:
        return "LAB"
    if tags.get(277, 1) != 1 or tags.get(262) not in (0, 1) or tags.get(339, 1) != 1:
        return None
    bits = tags.get(258, 1)
    return {1: "1", 2: "L", 4: "L", 8: "L", 12: "I;16", 16: "I;16" if order == "<" else "I;16B", 32: "I"}.get(bits)


def _embedded_mode(fmt: str, data: bytes, name: str, hd: Optional[SimpleNamespace]) -> Optional[str]:
    """The mode Pillow opens an IPTC file's embedded image in, where the
    port can tell it from the bytes or from the header ``hd`` its plugin's
    ``_open`` read (L, 1 and the modes Pillow's core cannot convert to RGB
    among them); None where it cannot."""
    if fmt == "JPEG":
        return {1: "L", 3: "RGB", 4: "CMYK"}.get(_jpeg_components(data))
    if fmt == "PNG" and len(data) >= 26:
        depth, color = data[24], data[25]
        return {0: "1" if depth == 1 else "I;16" if depth == 16 else "L", 2: "RGB", 3: "P", 4: "LA",
                6: "RGBA"}.get(color)
    if fmt == "PPM":
        magic, pos = _pnm_magic(data)
        mode = PNM_MODES.get(magic)
        if mode != "L":
            return mode
        try:
            for _ in range(3):
                tok, pos = _pnm_token(data, pos, name)
            return "I" if _pnm_int(tok, name) > 255 else "L"
        except OSError:
            return None
    if fmt == "SPIDER":
        return "F"
    if fmt == "IM":
        return hd.mode
    if fmt == "FITS":
        try:
            return _FITS_MODES[_fits_headers(io.BytesIO(data))[2][0]][0]
        except (OSError, SyntaxError, ValueError, KeyError, IndexError, TypeError):
            return None
    if fmt == "McIdas":
        return {1: "L", 2: "I;16B", 4: "I"}.get(_u32(data, 40, ">"))
    if fmt == "TIFF":
        return _tiff_mode(data)
    if fmt == "PSD":
        return "LAB" if _u16(data, 24, ">") == 9 else None
    return None


def decode_iptc(data: bytes, name: str, hd: SimpleNamespace) -> np.ndarray:
    """An IPTC/NAA file's image as uint8 RGB, bit for bit with Pillow
    12.1.0's ``IptcImagePlugin`` and ``convert("RGB")``: the header ``hd``
    that ``_iptc_header`` read in the walk, then the data of each (8, 10) field from the
    first on, joined; raw data (compression 1) wrapped as a P5 of the
    header's size, an embedded file (compression 5) opened in the port's
    own walk (``read_bytes``), as Pillow opens either; an L file shows that
    image as Pillow's core converts it (its size, not the header's; F,
    I;16B, I;16L and LAB, which the core does not convert, refused), a band
    of an RGB or CMYK one is that band of the mode, the others zero
    (``Image.merge``: an embedded image of another mode than L refused, as
    1 in the first band).  What Pillow refuses raises ``OSError`` naming the
    file and Pillow's verdict."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: IPTC {why}, which Pillow (the JAX package's IPTC lane) does not read")

    if hd.offset is None:
        raise refuse("file without image data fields (8, 10) (cannot load this image)")
    f = io.BytesIO(data)
    f.seek(hd.offset)
    embedded = bytearray(b"P5\n%d %d\n255\n" % hd.size if hd.compression == "raw" else b"")
    try:
        while True:
            tag, size = _iptc_field(f)
            if tag != (8, 10):
                break
            embedded += f.read(max(size, 0))
    except (SyntaxError, OSError, IndexError, struct.error) as e:
        raise refuse(f"data field that Pillow refuses ({type(e).__name__}: {e})") from e
    inner = f"{name} (its embedded image)"
    if hd.compression == "raw":
        fmt, mode = "PPM", "L"
    else:
        fmt, inner_hd = next(walk(io.BytesIO(bytes(embedded)), inner), ("unknown", None))
        mode = _embedded_mode(fmt, bytes(embedded), inner, inner_hd)
    if hd.band is None:
        if mode in ("F", "I;16B", "I;16L", "LAB", "La"):
            raise refuse(f"of an embedded {fmt} image of mode {mode} (conversion from {mode} to RGB not supported)")
        return read_bytes(bytes(embedded), inner)
    bands = 3 if hd.mode == "RGB" else 4
    if not -bands <= hd.band < bands:
        raise refuse(f"band {hd.band + 1} of a {hd.mode} image (list assignment index out of range)")
    at = hd.band % bands
    if mode is None:
        raise refuse(f"band of an embedded {fmt} image, whose mode the port does not tell (Image.merge's check)")
    if at and mode != "L":
        raise refuse(f"band {at + 1} of an embedded image of mode {mode} (mode mismatch)")
    if not at and mode not in ("L", "1", "P", "I", "F", "I;16", "I;16L", "I;16B"):
        raise refuse(f"first band of an embedded image of mode {mode} (image has wrong mode)")
    if mode not in ("L", "1"):
        raise OSError(f"{name}: IPTC first band of an embedded image of mode {mode}, whose stored bytes Pillow's "
                      "merge copies as they are: not read by the PyTorch port")
    gray = read_bytes(bytes(embedded), inner)[..., 0]
    px = np.zeros(gray.shape + (bands,), np.uint8)
    px[..., at] = gray
    return _cmyk2rgb(px) if bands == 4 else px


def _pcd_header(f: BinaryIO, name: str) -> SimpleNamespace:
    """``PcdImageFile._open`` on the file ``f``: ``PCD_`` at byte 2048 and
    the orientation, byte 3586's low two bits (1 and 3 turn the image by 90
    and 270 degrees); fewer bytes than that pass the file on
    (``NotThisFormat``)."""
    f.seek(2048)
    s = f.read(1539)
    with _Opening(name, "PCD"):
        if not s.startswith(b"PCD_"):
            raise SyntaxError("not a PCD file")
        orientation = s[1538] & 3
    return SimpleNamespace(rotate={1: 1, 3: 3}.get(orientation, 0))


#: a PhotoCD base image: 768 x 512, at byte 96 * 2048, in chunks of two luma
#: rows and one row each of the two chroma planes at half width
PCD_SIZE, PCD_OFFSET = (768, 512), 96 * 2048


def decode_pcd(data: bytes, name: str, hd: SimpleNamespace) -> np.ndarray:
    """A Kodak PhotoCD's base image as uint8 RGB, bit for bit with Pillow
    12.1.0's ``PcdImagePlugin`` and ``convert("RGB")``: 768 x 512 pixels at
    byte 96 * 2048, each chunk of two rows as Pillow's pcd decoder reads
    it (each row's luma, the chunk's two chroma rows at half width) through
    the "YCC;P" unpacker (``ycc_to_rgb``), then turned by 90 or 270 degrees
    as the orientation in the header ``hd`` that ``_pcd_header`` read in the
    walk asks (``rotate(expand=True)``).  Pixels cut short raise ``OSError``
    naming the file."""
    w, h = PCD_SIZE
    chunks = _raw(data, PCD_OFFSET, 3 * w * h // 2, name, "PCD").reshape(h // 2, 3 * w)
    luma = chunks[:, :2 * w].reshape(h, w)
    c1 = np.repeat(chunks[:, 2 * w:5 * w // 2], 2, axis=1)
    c2 = np.repeat(chunks[:, 5 * w // 2:], 2, axis=1)
    ycc = np.stack([luma, np.repeat(c1, 2, axis=0), np.repeat(c2, 2, axis=0)], -1)
    return np.ascontiguousarray(np.rot90(ycc_to_rgb(ycc), hd.rotate))


def _spider_header_len(t: Tuple[float, ...]) -> int:
    """SpiderImagePlugin's ``isSpiderHeader``: the header's bytes where its
    fields 1, 2, 5, 12, 13, 22 and 23 are integers, the form one of
    Pillow's and labbyt labrec * lenbyt, else 0."""
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] - int(h[i]) != 0:
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _spider_header(f: BinaryIO, name: str) -> SimpleNamespace:
    """``SpiderImageFile._open`` on the file ``f``: 27 big-endian floats,
    else little-endian ones, that ``_spider_header_len`` takes; form 1 (a 2D
    image); a single image's data at the header's length, a stack's first
    image at twice it.  Raises ``NotThisFormat`` where Pillow passes the
    file on and ``OSError`` where it stops (a stack field that is no
    number, an image of a stack, whose offset Pillow lacks)."""
    f.seek(0)
    s = f.read(108)
    with _Opening(name, "SPIDER"):
        if len(s) < 108:
            raise SyntaxError("not a valid Spider file")
        big, t = True, struct.unpack(">27f", s)
        hdrlen = _spider_header_len(t)
        if hdrlen == 0:
            big, t = False, struct.unpack("<27f", s)
            hdrlen = _spider_header_len(t)
        if hdrlen == 0:
            raise SyntaxError("not a valid Spider file")
        h = (99,) + t
        if int(h[5]) != 1:
            raise SyntaxError("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    try:
        istack, imgnumber = int(h[24]), int(h[27])
        if istack > 0 and imgnumber == 0:
            int(h[26])
    except (ValueError, OverflowError) as e:
        raise OSError(f"{name}: SPIDER header that Pillow refuses ({type(e).__name__}: {e}), which Pillow (the JAX "
                      "package's SPIDER lane) does not read") from e
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = 2 * hdrlen
    elif istack == 0 and imgnumber > 0:
        raise OSError(f"{name}: SPIDER image {imgnumber} of a stack opened alone (AttributeError: "
                      "'SpiderImageFile' object has no attribute 'stkoffset'), which Pillow (the JAX package's SPIDER "
                      "lane) does not read")
    else:
        raise NotThisFormat(f"{name}: SPIDER of inconsistent stack header values, which Pillow does not identify")
    _checked(name, "SPIDER", "F", size)
    return SimpleNamespace(size=size, offset=offset, big=big)


def decode_spider(data: bytes, name: str, hd: SimpleNamespace) -> np.ndarray:
    """A SPIDER image (the first of a stack) as uint8 RGB, bit for bit with
    Pillow 12.1.0's ``SpiderImagePlugin`` and ``convert("RGB")``: the header
    ``hd`` that ``_spider_header`` read in the walk, then 32-bit floats of
    its byte order, rows top-down, as ``f2l`` converts F.  What Pillow
    refuses (a negative offset, pixels cut short) raises ``OSError`` naming
    the file."""
    w, h = hd.size
    if hd.offset < 0:
        raise OSError(f"{name}: SPIDER data at offset {hd.offset} (negative seek position), which Pillow (the JAX "
                      "package's SPIDER lane) does not read")
    v = _raw(data, hd.offset, 4 * w * h, name, "SPIDER").view(">f4" if hd.big else "<f4").reshape(h, w)
    return _gray_rgb(v, "F")


#: the ``_open`` of each plugin without an ``_accept`` (``_opens``; TGA's
#: header test is ``_tga``)
_HEADERS = {"IM": _im_header, "IMT": _imt_header, "IPTC": _iptc_header, "PCD": _pcd_header, "SPIDER": _spider_header}


#: the formats read in numpy here, each from the whole file's bytes (those
#: of ``_HEADERS`` with the header their ``_open`` read in the walk too)
_DECODERS = {"BMP": decode_bmp, "DIB": decode_dib, "ICO": decode_ico, "CUR": decode_cur, "PPM": decode_pnm,
             "TGA": decode_tga, "PCX": decode_pcx, "PSD": decode_psd, "QOI": decode_qoi, "SGI": decode_sgi,
             "DDS": decode_dds, "BLP": decode_blp, "FTEX": decode_ftex, "ICNS": decode_icns, "Sun raster": decode_sun,
             "XBM": decode_xbm, "XPM": decode_xpm, "MSP": decode_msp, "FLI": decode_fli, "DCX": decode_dcx,
             "GBR": decode_gbr, "PIXAR": decode_pixar, "FITS": decode_fits, "McIdas": decode_mcidas,
             "XV thumbnail": decode_xv, "IM": decode_im, "IMT": decode_imt, "IPTC": decode_iptc, "PCD": decode_pcd,
             "SPIDER": decode_spider, "JPEG 2000": decode_jpeg2000, "AVIF": decode_avif}


def _read(f: BinaryIO, name: str, native_read) -> np.ndarray:
    """The walk of ``read_image`` on the open file ``f``; ``native_read()``
    decodes it as PNG, JPEG, WebP, GIF or TIFF.  A reader of ``_HEADERS``
    takes the header the walk's ``_open`` read."""
    last = data = None
    for fmt, hd in walk(f, name):
        if fmt not in READ:
            f.seek(0)
            raise unreadable(name, f.read(HEAD), fmt)
        if fmt not in _DECODERS:
            return native_read()
        if data is None:  # read once, whichever of the formats reads it
            f.seek(0)
            data = f.read()
        try:
            return _DECODERS[fmt](data, name, hd) if fmt in _HEADERS else _DECODERS[fmt](data, name)
        except NotThisFormat as e:
            last = e
    if last is not None:
        raise last
    f.seek(0)
    raise unreadable(name, f.read(HEAD))


def read_image(path: str, shape: Optional[Tuple[int, int]] = None, lane: str = "native") -> np.ndarray:
    """Decode an image file to uint8 RGB (H, W, 3) by its format.  ``shape``,
    the (H, W) the caller expects, lets the native library decode a PNG,
    JPEG, WebP, GIF or TIFF in one call (``native.decode_image``); any
    shape is still read.  ``lane`` is the JAX package's lane to follow
    where its lanes part (``native.LANES``): "native" for the loader, as
    its ``StageDataset`` reads, "pillow" for originals, as its prep and
    ``cli.project`` read them (``Image.open(path).convert("RGB")``).  The
    formats of ``_DECODERS`` reach the JAX package through Pillow alone, so
    they read alike in both lanes.  The formats are tried as ``Image.open``
    tries them (``walk``): a file that a format's reader does not identify
    (``NotThisFormat``) goes on to the next format that accepts or opens
    it (a true-colour Targa whose first bytes are a cursor's magic is read
    as Targa), and a plugin's verdict that ends Pillow's walk raises."""
    with open(path, "rb") as f:
        return _read(f, path, lambda: native.decode_image(path, shape, lane))


def read_bytes(data: bytes, name: str, lane: str = "pillow") -> np.ndarray:
    """``read_image`` of a file's bytes held in memory (an IPTC file's
    embedded image); ``name`` is what errors name."""
    return _read(io.BytesIO(data), name, lambda: native.decode_buffer(data, name, lane))


def unreadable(path: str, head: bytes, fmt: Optional[str] = None) -> OSError:
    """The error for a file of no format the port reads (``head``, its
    first bytes): it names the file and the format ``fmt`` Pillow would
    open it as, or "unknown" where no plugin identifies it."""
    fmt = fmt or "unknown"
    decodes = f"the PyTorch port decodes {', '.join(READ[:-1])} and {READ[-1]} files"
    if fmt == "unknown":
        return OSError(f"{path}: unknown format (first bytes {head[:4]!r}): no Pillow plugin accepts it, and {decodes}")
    verdict = f"{MPEG_VERDICT}; " if fmt == "MPEG" else ""
    return OSError(f"{path}: {fmt} files are not read by the PyTorch port ({verdict}{decodes})")
