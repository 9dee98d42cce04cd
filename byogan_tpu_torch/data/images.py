"""Image files of a dataset: which are listed, and how each is decoded.

A file is listed by its extension, as the JAX package lists them
(``IMAGE_EXTENSIONS``, byogan_tpu/data/prep.py:25-29), and decoded by its
first bytes, as Pillow's ``Image.open`` identifies it: PNG, JPEG, WebP,
GIF (the first frame) and TIFF (the first page) through the port's own
codecs (``data/native.py``); BMP, DIB, ICO and CUR (``_bitmap``), PNM
(``decode_pnm``), Targa (``decode_tga``), PSD (``decode_psd``), PCX
(``decode_pcx``), SGI (``decode_sgi``) and QOI (``decode_qoi``) in numpy
below, their sequential loops (plain PNM samples, Targa RLE packets,
PackBits, PCX and SGI RLE, QOI ops) in the native library; each as the
JAX package's lane for it reads it.  A file of another format that
Pillow opens raises ``OSError`` naming the file and the format ("<format>
files are not read by the PyTorch port"), one that no Pillow plugin
accepts "unknown format", and one a decoder refuses names the reason: no
listed file is skipped.
"""

from __future__ import annotations

import math
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from byogan_tpu_torch.data import native

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


class NotThisFormat(OSError):
    """Raised where Pillow's ``_open`` of the format fails with an error
    ``Image.open`` takes as "not this plugin's file" (SyntaxError,
    IndexError, TypeError, struct.error): Pillow then tries the plugins
    after it, and so does ``read_image``."""
#: the formats the port decodes; ``sniff`` names any other Pillow opens
READ = ("PNG", "JPEG", "BMP", "WebP", "GIF", "TIFF", "DIB", "ICO", "CUR", "PPM", "PCX", "PSD", "QOI", "SGI", "TGA")


def is_image(name: str) -> bool:
    return os.path.splitext(name)[1].lower() in IMAGE_EXTENSIONS


def _u16(b: bytes, at: int, order: str = "<") -> int:
    return struct.unpack_from(order + "H", b, at)[0] if len(b) >= at + 2 else -1


def _u32(b: bytes, at: int, order: str = "<") -> int:
    return struct.unpack_from(order + "I", b, at)[0] if len(b) >= at + 4 else -1


#: the ``_accept`` test of each Pillow 12.1.0 plugin, in the order
#: ``Image.open`` tries them (the five it loads first, then the rest as
#: ``Image.init`` registers them), on a file's first 16 bytes; TGA, which
#: has none, by the header fields its ``_open`` checks (18 bytes)
SIGNATURES = (
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
    ("McIdas", lambda b: b.startswith(b"\0\0\0\0\0\0\0\x04")),
    ("MPEG", lambda b: b.startswith(b"\0\0\1\xb3")),
    ("TIFF", lambda b: b.startswith((b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                                      b"II\x2b\x00"))),
    ("MSP", lambda b: b.startswith((b"DanM", b"LinS"))),
    ("PIXAR", lambda b: b.startswith(b"\200\350\000\000")),
    ("PSD", lambda b: b.startswith(b"8BPS")),
    ("QOI", lambda b: b.startswith(b"qoif")),
    ("SGI", lambda b: _u16(b, 0, ">") == 474),
    ("Sun raster", lambda b: _u32(b, 0, ">") == 0x59A66A95),
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


#: the first bytes of a file ``candidates`` reads
HEAD = 28


def candidates(head: bytes) -> List[str]:
    """The formats whose plugins accept a file by its first ``HEAD`` bytes,
    in the order Pillow's ``Image.open`` tries them (``SIGNATURES`` on the
    first 16 bytes, GBR where its ``_open`` identifies the file too, then
    TGA by its header checks)."""
    prefix = head[:16]
    names = [name for name, accept in SIGNATURES if accept(prefix) and (name != "GBR" or _gbr(head))]
    return names + ["TGA"] if _tga(head) else names


def sniff(head: bytes) -> str:
    """The format of a file from its first ``HEAD`` bytes, as Pillow's
    ``Image.open`` identifies it: the first of ``candidates``, a name of
    ``READ`` or of another format Pillow opens, or "unknown" (Pillow's
    other formats without a signature, IM, IPTC, PCD and SPIDER, among
    them)."""
    return (candidates(head) or ["unknown"])[0]


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
        need = offset + (h * stride if stride < row else (h - 1) * stride + row)
        if need > len(data):
            raise OSError(f"{name}: {fmt} truncated ({len(data)} bytes, its pixels end at {need})")
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
    magic, pos = b"", 0
    while len(magic) < 6 and pos < len(data):
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
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
        if pos + n > len(data):
            raise OSError(f"{name}: PPM truncated ({len(data)} bytes, its pixels end at {pos + n})")
        return np.frombuffer(data, np.uint8, n, pos)

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
        if pos + h * row > len(data):
            raise OSError(f"{name}: TGA truncated ({len(data)} bytes, its pixels end at {pos + h * row})")
        rows = np.frombuffer(data, np.uint8, h * row, pos).reshape(h, row)
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
    - every (mode, bits) of ``PSD_MODES`` but Lab: bitmap (1-bit, a set bit
      white, as Pillow reads it), gray, multichannel, duotone and 8-bit
      bitmap as L, indexed through the colour mode data where it is 768
      bytes (planar R, G, B; black without), RGB from the first 3 channels
      (4 channels: RGBA, the alpha dropped), CMYK inverted then ``cmyk2rgb``;
    - raw channels, and PackBits through the native library
      (``native.packbits``: Pillow's PackbitsDecode.c, a channel's stream
      from the offset its row counts give to the file's end).

    What Pillow does not identify (another version, mode or depth, a
    header cut short) raises ``NotThisFormat``; what it refuses (too few
    channels, ZIP or another compression, data cut short, too many pixels)
    and Lab colour raise ``OSError`` naming the file and the reason."""

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
    if mode == "LAB":
        raise OSError(f"{name}: PSD files in Lab colour are not read by the PyTorch port")
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
            if at + h * row > len(data):
                raise refuse(f"truncated ({len(data)} bytes, a channel's pixels end at {at + h * row})")
            planes.append(np.frombuffer(data, np.uint8, h * row, at).reshape(h, row))
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
    return _rgb(px)


def decode_pcx(data: bytes, name: str = "PCX") -> np.ndarray:
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
    past its row; data cut short) raises ``OSError`` naming the file."""

    def refuse(why: str) -> OSError:
        return OSError(f"{name}: PCX {why}, which Pillow (the JAX package's PCX lane) does not read")

    if len(data) < 68:
        raise NotThisFormat(f"{name}: PCX header cut short ({len(data)} bytes), which Pillow does not identify")
    xmin, ymin, xmax, ymax = struct.unpack_from("<HHHH", data, 4)
    w, h = xmax + 1 - xmin, ymax + 1 - ymin
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: PCX of bbox ({xmin}, {ymin}, {xmax}, {ymax}) (bad PCX image size), which Pillow "
                            "does not identify")
    version, bits, planes, provided = data[1], data[3], data[65], _u16(data, 66)
    lut = None
    if bits == 1 and planes == 1:
        rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        rawmode = f"P;{planes}L"
        lut = np.zeros((256, 3), np.uint8)
        lut[:16] = np.frombuffer(data, np.uint8, 48, 16).reshape(16, 3)
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
    _too_large(name, "PCX", w, h)
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    size = planes * stride
    rows = native.pcx_rle(data[128:], name, size, h)
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
        if 512 + bands * page > len(data):
            raise refuse(f"truncated ({len(data)} bytes, its pixels end at {512 + bands * page})")
        px = np.frombuffer(data, np.uint8, bands * page, 512).reshape(bands, h, w, bpc)[..., 0].transpose(1, 2, 0)
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


#: the formats read in numpy here, each from the whole file's bytes
_DECODERS = {"BMP": decode_bmp, "DIB": decode_dib, "ICO": decode_ico, "CUR": decode_cur, "PPM": decode_pnm,
             "TGA": decode_tga, "PCX": decode_pcx, "PSD": decode_psd, "QOI": decode_qoi, "SGI": decode_sgi}


def read_image(path: str, shape: Optional[Tuple[int, int]] = None, lane: str = "native") -> np.ndarray:
    """Decode an image file to uint8 RGB (H, W, 3) by its format.  ``shape``,
    the (H, W) the caller expects, lets the native library decode a PNG,
    JPEG, WebP, GIF or TIFF in one call (``native.decode_image``); any
    shape is still read.  ``lane`` is the JAX package's lane to follow
    where its lanes part (``native.LANES``): "native" for the loader, as
    its ``StageDataset`` reads, "pillow" for originals, as its prep and
    ``cli.project`` read them (``Image.open(path).convert("RGB")``).  The
    formats of ``_DECODERS`` reach the JAX package through Pillow alone, so
    they read alike in both lanes.  As ``Image.open`` does, a file that a
    format's reader does not identify (``NotThisFormat``) goes on to the
    next format that accepts its first bytes: a true-colour Targa whose
    first bytes are a cursor's magic is read as Targa."""
    with open(path, "rb") as f:
        head = f.read(HEAD)
    last = data = None
    for fmt in candidates(head):
        if fmt not in READ:
            raise unreadable(path, head, fmt)
        if fmt not in _DECODERS:
            return native.decode_image(path, shape, lane)
        if data is None:  # read once, whichever of the candidates reads it
            with open(path, "rb") as f:
                data = f.read()
        try:
            return _DECODERS[fmt](data, path)
        except NotThisFormat as e:
            last = e
    if last is not None:
        raise last
    raise unreadable(path, head)


def unreadable(path: str, head: bytes, fmt: Optional[str] = None) -> OSError:
    """The error for a file whose first bytes (``head``) are of no format
    the port reads: it names the file and the format (``fmt``, or the one
    ``sniff`` finds)."""
    fmt = fmt or sniff(head)
    decodes = f"the PyTorch port decodes {', '.join(READ[:-1])} and {READ[-1]} files"
    if fmt == "unknown":
        return OSError(f"{path}: unknown format (first bytes {head[:4]!r}): no Pillow plugin accepts it, and {decodes}")
    return OSError(f"{path}: {fmt} files are not read by the PyTorch port ({decodes})")
