// TIFF decode: the first page of a TIFF as uint8 RGB, bit for bit with
// Pillow 12.1.0's Image.open(path).convert("RGB") (TiffImagePlugin, libtiff
// 4.7.1), the lane through which the JAX package reads a TIFF under a
// listed extension (its prep, cli.project and its loader's fallback).
//
// What is read, as Pillow reads it:
//
// - classic TIFF, II or MM byte order, and little-endian BigTIFF (8-byte
//   offsets and counts, 20-byte entries, LONG8 values; Pillow takes an MM
//   BigTIFF for a classic one and cannot identify it), the first image file
//   directory; strips or tiles; PlanarConfiguration 1 and 2;
// - compression none, PackBits, LZW (libtiff's decoders: MSB-first codes,
//   the width one code early, a table that may grow past 4096 entries
//   without a Clear; and the old-style codes of libtiff before 5.0,
//   LSB-first, the width one code late, where the first strip or tile
//   begins 0x00 and an odd byte), Deflate (8 and 32946), LZMA (34925: an
//   .xz stream a strip, xz.cpp) and ZSTD (50000: Zstandard, zstd.cpp), with
//   Predictor 2 (horizontal differencing of 8-, 16- and 32-bit samples)
//   where libtiff applies it: under LZW, Deflate, LZMA and ZSTD (one table,
//   kCodecs); uncompressed and PackBits data take no predictor, as libtiff
//   installs none for them; CCITT of bilevel
//   samples: Modified Huffman (2, and 32771 word-aligned), T.4 1-D and 2-D
//   (3) and T.6 (4), libtiff's tif_fax3.c decoders in ccitt.cpp, data that
//   libtiff decodes only with errors refused, and the same of a 1-bit
//   palette (each decoded bit an index into the two-entry ColorMap);
// - the pixel kinds of Pillow's OPEN_INFO keys that need no codec library:
//   bilevel and 2- and 4-bit gray (MinIsWhite and MinIsBlack), 8-bit gray
//   (MinIsWhite inverted; signed samples read unsigned), II 12-bit gray
//   (Pillow's I;12 into I;16, clipped at 255 by convert("RGB")), 16-bit gray (I;16
//   and I;16B clipped at 255 by convert("RGB"), MinIsWhite not inverted),
//   signed 16-bit gray (I;16S, clipped at 0 and 255), 32-bit integer gray
//   (I;32N, I;32S, I;32BS: clipped at 0 and 255, an unsigned sample past
//   2^31 read as negative), 32-bit float gray (F,
//   Pillow's f2l), 8-bit gray with an unassociated alpha (LA), 8- and
//   16-bit RGB with extra samples (dropped; an associated alpha first is
//   divided out as Pillow's RGBa unpackers do; 16-bit samples keep their
//   high byte), 1-, 2-, 4- and 8-bit palettes (each 16-bit colour map entry
//   / 256), 8- and 16-bit CMYK (Pillow's cmyk2rgb) and 8-bit CIELab of three
//   samples (Pillow's LAB: a* and b* XOR 0x80 in one plane, as they are in
//   separate planes, then LittleCMS's Lab -> sRGB, lab.cpp);
// - FillOrder 2: Pillow's raw decoder reverses each byte's bits (its ;R raw
//   modes), libtiff the coded bytes' before it decodes them;
// - Pillow's quirks: a plane of separate planes read by one character of
//   the raw mode (so a single 8-bit or 1-bit sample reads neither inverted
//   nor reversed), big-endian signed and float samples byte-swapped under
//   libtiff (its native-order samples unpacked as I;16BS and F;32BF), a
//   single uncompressed strip of a mapped mode read at the size Orientation
//   5-8 swapped;
// - JPEG compression (7) of 8-bit gray (MinIsWhite inverted), RGB, CMYK
//   and YCbCr: libtiff's JPEG codec hands each strip's or tile's stream,
//   after the JPEGTables stream, to libjpeg with its own colour space
//   (YCbCr -> RGB under Pillow's JPEGCOLORMODE_RGB, else the components as
//   they are), holds the stream's size and sampling factors to the tags
//   (the luma factors to YCbCrSubsampling, which a file without the tag
//   takes from its first stream), and a last strip may say more rows than
//   it has; the decode is jpeg_decode.cpp's.  In separate planes each
//   plane's chunk is a one-component stream of 1 x 1 factors, its samples
//   kept as they are: gray, RGB and CMYK planes interleaved back, YCbCr 1 x 1
//   through TIFFRGBAImage's putseparate8bitYCbCr11tile (YcbcrTables); and
//   12-bit gray (Pillow's I;16 from libtiff's I;12 packing, libjpeg-turbo's
//   12-bit decoder) where a chunk's width is even;
// - old-style JPEG (6) in strips of 8-bit gray (as it is: Pillow keys old
//   JPEG as YCbCr whatever the tag) and YCbCr: the one stream libtiff's
//   codec rebuilds (ojpeg_rebuild), YCbCr read raw (libjpeg's
//   raw_data_out) into TIFFRGBAImage's put routine;
// - YCbCr: uncompressed, Pillow's raw decoder reads it as RGBX (four bytes
//   a pixel, unconverted); under LZW, Deflate or PackBits, Pillow's
//   _decodeAsRGBA, libtiff's TIFFRGBAImage (YcbcrTables, put_ycbcr), with
//   Predictor 2 undone under LZW and Deflate on libtiff's row unit (the
//   scanline of a row of blocks over vs, a tile's 3 bytes a column), or
//   left undone where libtiff's checks fail, as TIFFRGBAImage then shows
//   the bytes;
// - the Orientation tag, applied as Pillow's load does
//   (ImageOps.exif_transpose).
//
// Everything else returns a code of codec.h that names it: MM BigTIFF, MM
// 12-bit gray, JPEG of other samples, 12-bit JPEG of an odd width, old JPEG
// in tiles, planes or of other samples, CCITT of other samples, an .xz BCJ
// filter, a Zstandard dictionary, LogLuv and other compressions (WebP,
// JBIG...), YCbCr in a layout libtiff has no routine for (1x4, 2x4,
// subsampled planes), ICCLab, ITULab and other photometric interpretations,
// other depths and sample layouts, FillOrder 2 where Pillow has no raw
// mode for it, truncated or corrupt data (where libtiff or
// Pillow's raw decoder fails; YCbCr data short of the tags, and YCbCr
// planes whose JPEG stream libtiff refuses, which Pillow shows as the
// buffer's bytes, are refused too).

#include <zlib.h>

#include <algorithm>
#include <cstring>
#include <vector>

#include "codec.h"

namespace byogan {
namespace {

constexpr uint64_t kMaxPixels = 2ull * 89478485ull;  // Image._decompression_bomb_check

struct Bytes {
  const uint8_t* data;
  size_t size;
  bool big;  // MM
  uint32_t u16(size_t at) const { return big ? data[at] << 8 | data[at + 1] : data[at] | data[at + 1] << 8; }
  uint32_t u32(size_t at) const {
    return big ? (uint32_t)data[at] << 24 | data[at + 1] << 16 | data[at + 2] << 8 | data[at + 3]
               : data[at] | data[at + 1] << 8 | data[at + 2] << 16 | (uint32_t)data[at + 3] << 24;
  }
  uint64_t u64(size_t at) const {
    return big ? (uint64_t)u32(at) << 32 | u32(at + 4) : (uint64_t)u32(at + 4) << 32 | u32(at);
  }
};

// One tag's values, read as unsigned integers (BYTE, SHORT, LONG, and in
// BigTIFF LONG8, a value past 32 bits held as 0xffffffff: past any file this
// reader opens), or as floats (RATIONAL, as libtiff reads them), and where
// they lie in the file.
struct Tag {
  bool present = false;
  std::vector<uint32_t> v;
  std::vector<float> f;
  size_t at = 0;
};

enum TagId {
  kWidth = 256, kLength = 257, kBits = 258, kCompression = 259, kPhotometric = 262, kFillOrder = 266,
  kStripOffsets = 273, kOrientation = 274, kSamples = 277, kRowsPerStrip = 278, kStripBytes = 279,
  kPlanar = 284, kPredictor = 317, kColorMap = 320, kTileWidth = 322, kTileLength = 323, kTileOffsets = 324,
  kTileBytes = 325, kExtraSamples = 338, kSampleFormat = 339, kJpegTables = 347, kYcbcrCoefficients = 529,
  kYcbcrSubsampling = 530, kReferenceBlackWhite = 532, kT4Options = 292,
  // old-style JPEG (compression 6)
  kJpegInterchange = 513, kJpegInterchangeLength = 514, kJpegRestartInterval = 515, kJpegQTables = 519,
  kJpegDcTables = 520, kJpegAcTables = 521,
};
const int kTags[] = {kWidth, kLength, kBits, kCompression, kPhotometric, kFillOrder, kStripOffsets,
                     kOrientation, kSamples, kRowsPerStrip, kStripBytes, kPlanar, kPredictor, kColorMap,
                     kTileWidth, kTileLength, kTileOffsets, kTileBytes, kExtraSamples, kSampleFormat,
                     kJpegTables, kYcbcrCoefficients, kYcbcrSubsampling, kReferenceBlackWhite, kT4Options,
                     kJpegInterchange, kJpegInterchangeLength, kJpegRestartInterval, kJpegQTables, kJpegDcTables,
                     kJpegAcTables};

int tag_slot(int id) {
  for (int i = 0; i < (int)(sizeof(kTags) / sizeof(kTags[0])); i++)
    if (kTags[i] == id) return i;
  return -1;
}

// The directory's tags of kTags, read as Pillow's ImageFileDirectory_v2
// reads them: the entries up to the file's end (a directory cut short
// keeps those before the cut), a tag whose values lie past the end
// skipped.  *whole is false where either happened (libtiff refuses such a
// directory).  kTiffDirectory where a tag of kTags holds no integers (the
// JPEG tables: bytes; the YCbCr coefficients and reference black and
// white: rationals).  BigTIFF (`bigtiff`): an 8-byte entry count, 20-byte
// entries of an 8-byte count and an 8-byte value or offset, and LONG8 (16)
// among the integers; SLONG8 and IFD8, which Pillow's reader skips, are no
// integers here.
int read_directory(const Bytes& f, uint64_t at, bool bigtiff, std::vector<Tag>* tags, bool* whole) {
  tags->assign(sizeof(kTags) / sizeof(kTags[0]), Tag());
  *whole = true;
  const size_t head = bigtiff ? 8 : 2, entry = bigtiff ? 20 : 12, field = bigtiff ? 8 : 4;
  if (at < 2 * field || at > f.size || f.size - at < head) return kTiffDirectory;
  const uint64_t n = bigtiff ? f.u64(at) : f.u16(at);
  for (uint64_t i = 0; i < n; i++) {
    if ((f.size - at - head) / entry <= i) {
      *whole = false;
      break;
    }
    const size_t e = at + head + entry * i;
    const int slot = tag_slot((int)f.u16(e));
    if (slot < 0) continue;
    const uint32_t type = f.u16(e + 2);
    const uint64_t count = bigtiff ? f.u64(e + 4) : f.u32(e + 4);
    const int id = kTags[slot];
    const bool rational = id == kYcbcrCoefficients || id == kReferenceBlackWhite;
    const int size = rational ? (type == 5 ? 8 : 0)
                     : id == kJpegTables ? (type == 7 || type == 1 ? 1 : 0)
                     : type == 1 ? 1 : type == 3 ? 2 : type == 4 ? 4 : type == 16 && bigtiff ? 8 : 0;
    if (!size || count == 0) {
      if (id >= kJpegInterchange && id <= kJpegAcTables) continue;  // old JPEG's tags: libtiff ignores a bad one
      return kTiffDirectory;
    }
    size_t pos = e + 4 + field;
    if (count > f.size / size) {  // more values than the file holds
      *whole = false;
      continue;
    }
    if ((uint64_t)size * count > field) {
      const uint64_t where = bigtiff ? f.u64(pos) : f.u32(pos);
      if (where > f.size || (uint64_t)size * count > f.size - where) {
        *whole = false;
        continue;
      }
      pos = (size_t)where;
    }
    Tag& t = (*tags)[slot];
    t.present = true;
    t.at = pos;
    if (id == kJpegTables) {
      t.v.assign(1, count);  // the bytes stay in the file
      continue;
    }
    if (rational) {  // TIFFReadDirEntryFloatArray: 0 where the denominator is
      t.f.resize(count);
      for (uint32_t k = 0; k < count; k++) {
        const uint32_t num = f.u32(pos + 8 * k), den = f.u32(pos + 8 * k + 4);
        t.f[k] = den ? (float)((double)num / den) : 0.0f;
      }
      continue;
    }
    t.v.resize(count);
    for (uint32_t k = 0; k < count; k++) {
      const size_t p = pos + (size_t)size * k;
      t.v[k] = size == 1   ? f.data[p]
               : size == 2 ? f.u16(p)
               : size == 4 ? f.u32(p)
                           : (uint32_t)std::min<uint64_t>(f.u64(p), 0xffffffffu);
    }
  }
  return kOk;
}

// libtiff's LZW decoders (tif_lzw.c) filling out[0, occ): LZWDecode's
// new-style codes (most significant bit first, one code wider as the table
// reaches 2^bits - 1 entries) or, where `old_style`, LZWDecodeCompat's codes
// of libtiff before 5.0 (least significant bit first, one code wider as it
// reaches 2^bits).
int lzw_decode(const uint8_t* in, size_t n, uint8_t* out, size_t occ, bool old_style) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kBitsMax = 12;
  constexpr int kSize = (1 << kBitsMax) - 1 + 1024;  // CSIZE: room past 4096 for late Clears
  struct Entry {
    int next;  // -1: none
    uint16_t length;
    uint8_t value, first;
  };
  const int late = old_style ? 1 : 2;  // MAXCODE(bits) for the old codes, one less for the new
  std::vector<Entry> table(kSize);
  for (int i = 0; i < 256; i++) table[i] = {-1, 1, (uint8_t)i, (uint8_t)i};
  std::vector<uint8_t> string;
  size_t bitpos = 0;
  const size_t bits_total = n * 8;
  int nbits = 9, maxcode = (1 << 9) - late, free_ent = kFirst, old = -1;
  auto reset = [&]() {
    for (int i = kFirst; i < kSize; i++) table[i] = {-1, 0, 0, 0};
    nbits = 9;
    maxcode = (1 << 9) - late;
    free_ent = kFirst;
  };
  auto next_code = [&]() -> int {
    if (bits_total - bitpos < (size_t)nbits) return kEoi;  // "not terminated with EOI": the data end
    int code = 0;
    if (old_style)
      for (int k = 0; k < nbits; k++, bitpos++) code |= ((in[bitpos >> 3] >> (bitpos & 7)) & 1) << k;
    else
      for (int k = 0; k < nbits; k++, bitpos++) code = code << 1 | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return code;
  };
  size_t o = 0;
  while (o < occ) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        reset();
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return kCorrupt;
      out[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (old < 0 || free_ent >= kSize) return kCorrupt;
    // the new entry: the old string and the first byte of this one
    Entry& e = table[free_ent];
    e.next = old;
    e.first = table[old].first;
    e.length = (uint16_t)(table[old].length + 1);
    e.value = code < free_ent ? table[code].first : e.first;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = (1 << nbits) - late;
    }
    old = code;
    if (code >= 256) {
      const Entry& c = table[code];
      if (c.length == 0) return kCorrupt;
      // the string, written from its end; cut where the strip is full
      int k = code;
      if (c.length <= occ - o) {
        for (uint8_t* p = out + o + c.length - 1; p >= out + o; p--) {
          *p = table[k].value;
          k = table[k].next;
        }
        o += c.length;
      } else {
        string.resize(c.length);
        for (int i = c.length - 1; i >= 0; i--) {
          string[i] = table[k].value;
          k = table[k].next;
        }
        memcpy(out + o, string.data(), occ - o);
        o = occ;
      }
    } else {
      out[o++] = (uint8_t)code;
    }
  }
  return o < occ ? kCorrupt : kOk;  // "Not enough data at scanline"
}

// libtiff's PackBitsDecode.
int packbits_decode(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  size_t i = 0, o = 0;
  while (i < n && o < occ) {
    long c = (int8_t)in[i++];
    if (c < 0) {
      if (c == -128) continue;
      size_t run = (size_t)(-c + 1);
      if (run > occ - o) run = occ - o;
      if (i >= n) break;
      memset(out + o, in[i++], run);
      o += run;
    } else {
      size_t run = (size_t)c + 1;
      if (run > occ - o) run = occ - o;
      if (n - i < run) break;
      memcpy(out + o, in + i, run);
      o += run;
      i += run;
    }
  }
  return o < occ ? kCorrupt : kOk;
}

// libtiff's ZIPDecode: the strip inflated to exactly occ bytes.
int deflate_decode(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  z_stream z;
  memset(&z, 0, sizeof(z));
  if (inflateInit(&z) != Z_OK) return kNoMemory;
  z.next_in = const_cast<uint8_t*>(in);
  z.avail_in = (uInt)n;
  z.next_out = out;
  z.avail_out = (uInt)occ;
  int rc;
  do {
    rc = inflate(&z, Z_PARTIAL_FLUSH);
  } while (rc == Z_OK && z.avail_out > 0 && z.avail_in > 0);
  const bool full = z.avail_out == 0;
  inflateEnd(&z);
  if (rc == Z_DATA_ERROR || rc == Z_NEED_DICT || rc == Z_MEM_ERROR) return kCorrupt;
  return full ? kOk : kCorrupt;
}

// An .xz stream (xz.cpp) or Zstandard frame (zstd.cpp) into exactly occ
// bytes, as libtiff's LZMADecode and ZSTDDecode fill a strip.
int stream_decode(int (*decode)(const uint8_t*, size_t, size_t, std::vector<uint8_t>*), const uint8_t* in,
                  size_t n, uint8_t* out, size_t occ) {
  std::vector<uint8_t> bytes;
  const int rc = decode(in, n, occ, &bytes);
  if (rc) return rc;
  memcpy(out, bytes.data(), occ);
  return kOk;
}

// The compressions read, by their tag's value: which decoder, and whether
// libtiff's codec installs its predictor (TIFFPredictorInit: LZW, Deflate,
// LZMA and ZSTD; none, PackBits, CCITT and JPEG take none).
enum Codec { kRaw, kPackBits, kLzw, kDeflate, kLzma, kZstd, kCcitt, kJpeg, kOldJpeg };
struct CodecOf {
  uint32_t compression;
  Codec codec;
  bool predictor;
};
constexpr CodecOf kCodecs[] = {
    {1, kRaw, false},      {2, kCcitt, false},         {3, kCcitt, false},   {4, kCcitt, false},
    {5, kLzw, true},       {6, kOldJpeg, false},       {7, kJpeg, false},    {8, kDeflate, true},
    {32771, kCcitt, false}, {32773, kPackBits, false}, {32946, kDeflate, true}, {34925, kLzma, true},
    {50000, kZstd, true},
};

// One strip's or tile's coded bytes into exactly occ bytes, by the
// codec libtiff reads them with (not CCITT, JPEG or old JPEG).
int inflate_chunk(Codec codec, const uint8_t* in, size_t n, uint8_t* out, size_t occ, bool lzw_old) {
  switch (codec) {
    case kLzw: return lzw_decode(in, n, out, occ, lzw_old);
    case kDeflate: return deflate_decode(in, n, out, occ);
    case kLzma: return stream_decode(xz_decode, in, n, out, occ);
    case kZstd: return stream_decode(zstd_decode, in, n, out, occ);
    default: return packbits_decode(in, n, out, occ);
  }
}

// Old-style JPEG (tif_ojpeg.c): the one JPEG stream libtiff's codec hands
// libjpeg for a file of strips.  It reads one byte stream, the
// JPEGInterchangeFormat's bytes and then every strip's, for the markers
// up to SOS (OJPEGReadHeaderInfoSec: SOI, APPn and COM skipped, DRI, DQT,
// DHT a table each, SOF0/1/3 held to the tags, SOS); where the stream
// holds no SOF it builds the frame from the tags (JPEGQTables,
// JPEGDcTables, JPEGAcTables, YCbCrSubsampling: the tables route).  Then
// it writes SOI, the tables, DRI, SOF and SOS anew (Ss 0, Se 63) and the
// rest of the byte stream as the scan, a restart marker after each strip
// but the last (a strip a restart interval, where there are several),
// and EOI.  YCbCr takes its subsampling from the stream's SOF where that
// has a TIFF equivalent (OJPEGSubsamplingCorrect); where it has none
// (`forced`), libtiff would have libjpeg upsample, and its read fails.
struct Ojpeg {
  uint32_t width, height, strip_rows;
  int samples;
  bool ycbcr;
  uint32_t hs, vs;              // in: the tag's (or 2, 2); out: the codec's
  bool forced = false;          // YCbCr factors TIFF has no name for
  std::vector<uint8_t> stream;  // what libjpeg reads
};

int ojpeg_rebuild(const uint8_t* file, size_t size, uint64_t jif, uint64_t jif_len, int64_t restart_tag,
                  const std::vector<uint32_t>& qt, const std::vector<uint32_t>& dct, const std::vector<uint32_t>& act,
                  const std::vector<uint32_t>& offsets, const std::vector<uint32_t>& counts, Ojpeg* o) {
  // the byte stream: JPEGInterchangeFormat's bytes, then the strips' (OJPEGReadBufferFill)
  std::vector<uint8_t> in;
  std::vector<size_t> strip_end;  // where each strip's bytes end in `in`
  if (jif != 0 && jif < size) {
    const uint64_t len = jif_len == 0 || jif_len > size - jif ? size - jif : jif_len;
    in.insert(in.end(), file + jif, file + jif + len);
  }
  for (size_t c = 0; c < offsets.size(); c++) {
    const uint64_t at = offsets[c];
    if (at == 0 || at >= size) continue;
    const uint64_t n = c < counts.size() && counts[c] != 0 && counts[c] <= size - at ? counts[c] : size - at;
    in.insert(in.end(), file + at, file + at + n);
    strip_end.push_back(in.size());
  }
  const bool multi = o->strip_rows < o->height;
  // OJPEGSubsamplingCorrect: a YCbCr stream's SOF sets the subsampling
  uint32_t hs = o->samples == 3 && o->ycbcr ? o->hs : 1, vs = o->samples == 3 && o->ycbcr ? o->vs : 1;
  struct Segment {
    uint8_t marker;
    std::vector<uint8_t> body;
  };
  std::vector<uint8_t> qtable[4], dctable[4], actable[4];  // whole markers, as they are written again
  bool have_q[4] = {false}, have_dc[4] = {false}, have_ac[4] = {false};
  int64_t restart = restart_tag;
  bool sof = false, sos = false;
  uint8_t sof_marker = 0xC0;
  uint32_t sof_y = 0, sof_x = 0;
  uint8_t sof_c[3] = {0, 1, 2}, sof_hv[3] = {0x11, 0x11, 0x11}, sof_tq[3] = {0, 0, 0}, sos_cs[3] = {0, 1, 2},
          sos_tda[3] = {0, 0, 0};
  size_t p = 0;
  auto byte = [&]() -> int {
    if (p >= in.size()) throw 0;
    return in[p++];
  };
  auto word = [&]() { const int hi = byte(); return hi << 8 | byte(); };
  // the first pass (subsamplingcorrect): up to the first SOF, for the YCbCr factors
  auto scan_markers = [&](bool correct) -> int {
    p = 0;
    while (true) {
      if (p >= in.size()) return kTiffJpegStream;
      if (in[p] != 0xFF) return kOk;
      p++;
      int m;
      do m = byte(); while (m == 0xFF);
      if (m == 0xD8) continue;
      if (m == 0xFE || (m >= 0xE0 && m <= 0xEF)) {
        const int n = word();
        if (n < 2) return kTiffJpegStream;
        p += (size_t)n - 2;
        continue;
      }
      if (m == 0xDD) {  // DRI
        if (word() != 4) return kTiffJpegStream;
        const int r = word();
        if (!correct) restart = r;
        continue;
      }
      if (m == 0xDB) {  // DQT: tables of 65 bytes
        int n = word();
        if (n < 3) return kTiffJpegStream;
        n -= 2;
        while (n > 0) {
          if (n < 65) return kTiffJpegStream;
          if (p + 65 > in.size()) throw 0;
          const int id = in[p] & 15;
          if (id > 3) return kTiffJpegStream;
          if (!correct) {
            qtable[id].assign({0xFF, 0xDB, 0, 67});
            qtable[id].insert(qtable[id].end(), in.begin() + p, in.begin() + p + 65);
            have_q[id] = true;
          }
          p += 65;
          n -= 65;
        }
        continue;
      }
      if (m == 0xC4) {  // DHT: the whole marker, one table
        const int n = word();
        if (n <= 2) return kTiffJpegStream;
        if (p + n - 2 > in.size()) throw 0;
        if (!correct) {
          const int id = in[p];
          std::vector<uint8_t> marker = {0xFF, 0xC4, (uint8_t)(n >> 8), (uint8_t)n};
          marker.insert(marker.end(), in.begin() + p, in.begin() + p + n - 2);
          if ((id & 0xF0) == 0 && id <= 3) {
            dctable[id] = marker;
            have_dc[id] = true;
          } else if ((id & 0xF0) == 0x10 && (id & 15) <= 3) {
            actable[id & 15] = marker;
            have_ac[id & 15] = true;
          } else {
            return kTiffJpegStream;
          }
        }
        p += (size_t)n - 2;
        continue;
      }
      if (m == 0xC0 || m == 0xC1 || m == 0xC3) {  // OJPEGReadHeaderInfoSecStreamSof
        if (!correct && sof) return kTiffJpegStream;
        int n = word();
        if (n < 11 || (n - 8) % 3) return kTiffJpegStream;
        n = (n - 8) / 3;
        if (!correct && n != o->samples) return kTiffJpegStream;
        if (byte() != 8) return kTiffJpegStream;
        const uint32_t y = (uint32_t)word(), x = (uint32_t)word();
        if (byte() != n) return kTiffJpegStream;
        if (!correct) {
          if (y < o->height || x != o->width)
            return kTiffJpegStream;  // "unexpected height", "unexpected width", "width exceeds expected"
          sof_y = y, sof_x = x;
          sof_marker = (uint8_t)m;
        }
        for (int q = 0; q < n; q++) {
          const int c = byte(), hv = byte(), tq = byte();
          if (correct) {
            if (q == 0) {
              hs = (uint32_t)hv >> 4, vs = (uint32_t)hv & 15;
              auto ok = [](uint32_t v) { return v == 1 || v == 2 || v == 4; };
              if (!ok(hs) || !ok(vs)) o->forced = true;
            } else if (hv != 0x11) {
              o->forced = true;
            }
            continue;
          }
          if (q < 3) sof_c[q] = (uint8_t)c, sof_hv[q] = (uint8_t)hv, sof_tq[q] = (uint8_t)tq;
          if (!o->forced && hv != (q == 0 ? (int)(hs << 4 | vs) : 0x11)) return kTiffJpegStream;
        }
        if (correct) return kOk;
        sof = true;
        continue;
      }
      if (m == 0xDA) {  // OJPEGReadHeaderInfoSecStreamSos
        if (correct) return kOk;
        if (!sof) return kTiffJpegStream;
        if (word() != 6 + o->samples * 2 || byte() != o->samples) return kTiffJpegStream;
        for (int q = 0; q < o->samples; q++) sos_cs[q] = (uint8_t)byte(), sos_tda[q] = (uint8_t)byte();
        p += 3;
        sos = true;
        return kOk;
      }
      return kTiffJpegStream;  // "Unknown marker type"
    }
  };
  if (o->samples == 3 && o->ycbcr) {
    try {
      scan_markers(true);  // its faults are libtiff's silent ones: the pass just stops
    } catch (int) {
    }
    if (o->forced) hs = vs = 1;
  }
  try {
    if (multi) {
      auto ok = [](uint32_t v) { return v == 1 || v == 2 || v == 4; };
      if (!ok(hs) || !ok(vs)) return kTiffOjpeg;  // "Invalid subsampling values"
      if (o->strip_rows % (vs * 8)) return kTiffOjpeg;  // "Incompatible vertical subsampling and image strip/tile length"
      restart = (int64_t)((o->width + hs * 8 - 1) / (hs * 8)) * (o->strip_rows / (vs * 8));
    }
    const int rc = scan_markers(false);
    if (rc) return rc;
  } catch (int) {
    return kTruncated;  // the bytes end inside a marker
  }
  if (sof && !sos) return kTiffJpegStream;
  const size_t sos_end = p;
  if (!sof) {  // the tables route: the frame from the tags
    // OJPEGWriteStreamSof writes the tags' size in 16 bits.  A width past
    // 65535 then differs from the frame libjpeg decodes, which libtiff
    // refuses after jpeg_start_decompress (or libjpeg refuses first, a
    // size of 0 or past 65500); a height past it leaves the rows below the
    // cut height to whatever libtiff's buffers held, which Pillow shows
    if (o->width > 0xFFFF) return kTiffJpegStream;
    if (o->height > 0xFFFF) return (o->height & 0xFFFF) - 1u < 65500u ? kTiffOjpeg : kTiffJpegStream;
    auto fetch = [&](uint32_t at, size_t n, std::vector<uint8_t>* out) {
      if (at > size || n > size - at) return false;
      out->insert(out->end(), file + at, file + at + n);
      return true;
    };
    if (qt.empty() || qt[0] == 0) return kTiffOjpeg;  // "Missing JPEG tables"
    for (int m = 0; m < o->samples; m++) {
      auto table_of = [&](const std::vector<uint32_t>& offs, int m) -> uint32_t { return m < (int)offs.size() ? offs[m] : 0; };
      auto repeats = [&](const std::vector<uint32_t>& offs) {
        for (int n = 0; n < m - 1; n++)
          if (table_of(offs, m) == table_of(offs, n)) return true;
        return false;
      };
      const uint32_t q = table_of(qt, m), d = table_of(dct, m), a = table_of(act, m);
      if (q != 0 && (m == 0 || q != table_of(qt, m - 1))) {
        if (repeats(qt)) return kTiffJpegStream;  // "Corrupt JpegQTables tag value"
        qtable[m] = {0xFF, 0xDB, 0, 67, (uint8_t)m};
        if (!fetch(q, 64, &qtable[m])) return kTruncated;
        have_q[m] = true;
        sof_tq[m] = (uint8_t)m;
      } else if (m > 0) {
        sof_tq[m] = sof_tq[m - 1];
      }
      for (int ac = 0; ac < 2; ac++) {
        const uint32_t at = ac ? a : d;
        const std::vector<uint32_t>& offs = ac ? act : dct;
        std::vector<uint8_t>* table = ac ? actable : dctable;
        bool* have = ac ? have_ac : have_dc;
        if (at != 0 && (m == 0 || at != table_of(offs, m - 1))) {
          if (repeats(offs)) return kTiffJpegStream;
          std::vector<uint8_t> counts16;
          if (!fetch(at, 16, &counts16)) return kTruncated;
          size_t total = 0;
          for (uint8_t c : counts16) total += c;
          table[m] = {0xFF, 0xC4, (uint8_t)((19 + total) >> 8), (uint8_t)(19 + total), (uint8_t)(ac << 4 | m)};
          table[m].insert(table[m].end(), counts16.begin(), counts16.end());
          if (!fetch(at + 16, total, &table[m])) return kTruncated;
          have[m] = true;
          sos_tda[m] = (uint8_t)(ac ? (sos_tda[m] | m) : m << 4);
        } else if (m > 0) {
          sos_tda[m] = (uint8_t)(ac ? ((sos_tda[m] & 0xF0) | (sos_tda[m - 1] & 15)) : (sos_tda[m - 1] & 0xF0));
        }
      }
    }
    sof_marker = 0xC0;
    for (int m = 0; m < o->samples; m++) sof_c[m] = (uint8_t)m, sof_hv[m] = 0x11, sos_cs[m] = (uint8_t)m;
    sof_hv[0] = (uint8_t)(hs << 4 | vs);
    sof_x = o->width;
    sof_y = o->height;
  }
  // OJPEGWriteStream
  std::vector<uint8_t>& s = o->stream;
  s = {0xFF, 0xD8};
  for (int m = 0; m < 4; m++)
    if (have_q[m]) s.insert(s.end(), qtable[m].begin(), qtable[m].end());
  for (int m = 0; m < 4; m++)
    if (have_dc[m]) s.insert(s.end(), dctable[m].begin(), dctable[m].end());
  for (int m = 0; m < 4; m++)
    if (have_ac[m]) s.insert(s.end(), actable[m].begin(), actable[m].end());
  if (restart > 0) s.insert(s.end(), {0xFF, 0xDD, 0, 4, (uint8_t)(restart >> 8), (uint8_t)restart});
  const int n = o->samples;
  s.insert(s.end(), {0xFF, sof_marker, 0, (uint8_t)(8 + 3 * n), 8, (uint8_t)(sof_y >> 8), (uint8_t)sof_y,
                     (uint8_t)(sof_x >> 8), (uint8_t)sof_x, (uint8_t)n});
  for (int m = 0; m < n; m++) s.insert(s.end(), {sof_c[m], sof_hv[m], sof_tq[m]});
  s.insert(s.end(), {0xFF, 0xDA, 0, (uint8_t)(6 + 2 * n), (uint8_t)n});
  for (int m = 0; m < n; m++) s.insert(s.end(), {sos_cs[m], sos_tda[m]});
  s.insert(s.end(), {0, 63, 0});
  size_t at = sos_end;
  int rst = 0;
  for (size_t k = 0; k < strip_end.size(); k++) {
    if (strip_end[k] <= at) continue;
    s.insert(s.end(), in.begin() + at, in.begin() + strip_end[k]);
    at = strip_end[k];
    if (k + 1 < strip_end.size()) {
      s.insert(s.end(), {0xFF, (uint8_t)(0xD0 + rst)});
      rst = (rst + 1) & 7;
    }
  }
  if (at < in.size()) s.insert(s.end(), in.begin() + at, in.end());
  s.insert(s.end(), {0xFF, 0xD9});
  o->hs = hs, o->vs = vs;
  return kOk;
}

// The pixel kinds read (Pillow's mode and raw mode).
enum Kind { kBilevel, kGray, kGray16, kSigned16, kInt32, kFloat, kGrayAlpha, kRgb, kPalette, kCmyk, kLab };

// Each byte's bits in reverse order (FillOrder 2).
void reverse_bits(uint8_t* p, size_t n) {
  for (size_t i = 0; i < n; i++) {
    uint8_t b = p[i];
    b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
    p[i] = (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
  }
}

// Pillow's F -> L (f2l): 0 at or below 0 and for NaN, 255 at or above 255,
// the integer part between.
uint8_t f2l(uint32_t word) {
  float v;
  memcpy(&v, &word, 4);
  return v > 0.0f && v < 255.0f ? (uint8_t)v : v >= 255.0f ? 255 : 0;
}

// Pillow's cmyk2rgb: each of C, M, Y taken off 255 - K as MULDIV255.
void cmyk2rgb(const uint32_t* c, uint8_t* o) {
  const int nk = 255 - (int)c[3];
  for (int k = 0; k < 3; k++) {
    const int t = (int)c[k] * nk + 128;
    o[k] = (uint8_t)(nk - (((t >> 8) + t) >> 8));
  }
}

// n pixels of a row, per samples each, read at `bits` a sample (MSB first
// under 8 bits and at 12; 16 and 32 bits big-endian where be) into dst, a pixel every
// step entries: the depth is picked once a row, not once a sample.
template <typename T>
void unpack(const uint8_t* row, uint32_t bits, bool be, size_t n, uint32_t per, uint32_t step, T* dst) {
  auto put = [&](auto read) {
    for (size_t x = 0, i = 0; x < n; x++)
      for (uint32_t s = 0; s < per; s++, i++) dst[x * step + s] = (T)read(i);
  };
  switch (bits) {
    case 1: put([&](size_t i) { return (row[i >> 3] >> (7 - (i & 7))) & 1; }); break;
    case 2: put([&](size_t i) { return (row[i >> 2] >> (6 - 2 * (i & 3))) & 3; }); break;
    case 4: put([&](size_t i) { return (row[i >> 1] >> (4 - 4 * (i & 1))) & 15; }); break;
    case 8: put([&](size_t i) { return row[i]; }); break;
    case 12:  // Pillow's I;12: two samples in three bytes, the first's high bits first
      put([&](size_t i) {
        const uint8_t* p = row + 3 * (i >> 1);
        return i & 1 ? (p[1] & 15) << 8 | p[2] : p[0] << 4 | p[1] >> 4;
      });
      break;
    case 16:
      if (be)
        put([&](size_t i) { return row[2 * i] << 8 | row[2 * i + 1]; });
      else
        put([&](size_t i) { return row[2 * i] | row[2 * i + 1] << 8; });
      break;
    default:
      if (be)
        put([&](size_t i) {
          const uint8_t* p = row + 4 * i;
          return (uint32_t)p[0] << 24 | p[1] << 16 | p[2] << 8 | p[3];
        });
      else
        put([&](size_t i) {
          const uint8_t* p = row + 4 * i;
          return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24;
        });
  }
}

// Predictor 2 undone on a row of 8-, 16- or 32-bit words in the file's
// order, each word the sum of itself and the word per samples before it.
void undo_predictor(uint8_t* row, size_t row_bytes, uint32_t bps, uint32_t per, bool big) {
  if (bps == 8) {
    for (size_t i = per; i < row_bytes; i++) row[i] = (uint8_t)(row[i] + row[i - per]);
  } else if (bps == 16) {
    const int hi = big ? 0 : 1;
    for (size_t i = per; i < row_bytes / 2; i++) {
      const uint8_t* q = row + 2 * (i - per);
      uint8_t* p = row + 2 * i;
      const uint32_t v = (p[hi] << 8 | p[1 - hi]) + (q[hi] << 8 | q[1 - hi]);
      p[hi] = (uint8_t)(v >> 8);
      p[1 - hi] = (uint8_t)v;
    }
  } else {
    auto word = [big](const uint8_t* p) -> uint32_t {
      return big ? (uint32_t)p[0] << 24 | p[1] << 16 | p[2] << 8 | p[3]
                 : p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24;
    };
    for (size_t i = per; i < row_bytes / 4; i++) {
      uint8_t* p = row + 4 * i;
      const uint32_t v = word(p) + word(p - 4 * per);
      for (int b = 0; b < 4; b++) p[big ? 3 - b : b] = (uint8_t)(v >> (8 * b));
    }
  }
}

// libtiff's TIFFYCbCrToRGBInit (tif_color.c) for one file's coefficients
// and reference black and white, in its float arithmetic, and
// TIFFYCbCrtoRGB: the conversion TIFFRGBAImage's put routines make.
struct YcbcrTables {
  int32_t y[256], cr_r[256], cb_b[256], cr_g[256], cb_g[256];

  YcbcrTables(const float* luma, const float* rbw) {
    auto clamp = [](float f, float lo, float hi) { return f < lo ? lo : f > hi ? hi : f; };
    auto clampw = [](float f, float lo, float hi) { return !(f >= lo) ? lo : f > hi ? hi : f; };  // NaN -> lo
    auto fix = [](float x) { return (int32_t)(x * (float)(1L << 16) + 0.5); };
    auto code2v = [](int c, float rb, float rw, int cr) {
      return ((float)(c - (int32_t)rb) * (float)cr) / (rw - rb != 0 ? rw - rb : 1.0f);
    };
    const float f1 = 2 - 2 * luma[0], f2 = luma[0] * f1 / luma[1];
    const float f3 = 2 - 2 * luma[2], f4 = luma[2] * f3 / luma[1];
    const int32_t d1 = fix(clamp(f1, 0.0f, 2.0f)), d2 = -fix(clamp(f2, 0.0f, 2.0f));
    const int32_t d3 = fix(clamp(f3, 0.0f, 2.0f)), d4 = -fix(clamp(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; i++, x++) {
      const int32_t cr = (int32_t)clampw(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127), -128.0f * 32, 128.0f * 32);
      const int32_t cb = (int32_t)clampw(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127), -128.0f * 32, 128.0f * 32);
      cr_r[i] = (d1 * cr + (1 << 15)) >> 16;
      cb_b[i] = (d3 * cb + (1 << 15)) >> 16;
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + (1 << 15);
      y[i] = (int32_t)clampw(code2v(x + 128, rbw[0], rbw[1], 255), -128.0f * 32, 128.0f * 32);
    }
  }

  void rgb(int yv, int cb, int cr, uint16_t* o) const {
    auto c255 = [](int32_t v) { return (uint16_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    o[0] = c255(y[yv] + cr_r[cr]);
    o[1] = c255(y[yv] + (int32_t)((cb_g[cb] + cr_g[cr]) >> 16));
    o[2] = c255(y[yv] + cb_b[cb]);
  }
};

// One call of a TIFFRGBAImage put routine (tif_getimage.c,
// putcontig8bitYCbCr{11,12,21,22,41,42,44}tile) over rows x cols pixels
// of packed YCbCr blocks (hs x vs luma samples, then Cb and Cr): a block
// for every hs columns, the last one partly shown, then `skip` bytes at
// the end of each row of blocks, as the routine steps over a tile's
// columns past the image's right edge.
void put_ycbcr(const YcbcrTables& t, const uint8_t* pp, uint32_t rows, uint32_t cols, uint32_t hs, uint32_t vs,
               size_t skip, uint16_t* px, size_t pitch) {
  const uint32_t k = hs * vs + 2;
  for (uint32_t by = 0; by * vs < rows; by++) {
    for (uint32_t bx = 0; bx * hs < cols; bx++, pp += k)
      for (uint32_t dy = 0; dy < vs && by * vs + dy < rows; dy++)
        for (uint32_t dx = 0; dx < hs && bx * hs + dx < cols; dx++)
          t.rgb(pp[dy * hs + dx], pp[k - 2], pp[k - 1], px + (size_t)(by * vs + dy) * pitch + 3 * (bx * hs + dx));
    pp += skip;
  }
}

}  // namespace

int decode_tiff(const uint8_t* file, size_t size, uint8_t* rgb, int* h, int* w) {
  if (size < 8) return kTiffDirectory;
  Bytes f{file, size, file[0] == 'M'};
  if (!((file[0] == 'I' && file[1] == 'I') || (file[0] == 'M' && file[1] == 'M'))) return kNotImage;
  const uint32_t version = f.u16(2);
  if (version != 42 && version != 43) return kTiffDirectory;  // libtiff: "bad version number"
  // BigTIFF: the first directory's offset in 8 bytes after the offset size
  // (8) and a zero, which libtiff checks and Pillow's own reader does not
  const bool bigtiff = version == 43;
  if (bigtiff && f.big) return kTiffBig;  // Pillow tests byte 2 alone for 43: an MM BigTIFF reads as classic
  if (bigtiff && size < 16) return kTiffDirectory;
  const bool libtiff_header = !bigtiff || (f.u16(4) == 8 && f.u16(6) == 0);
  std::vector<Tag> tags;
  bool whole;
  int rc = read_directory(f, bigtiff ? f.u64(8) : f.u32(4), bigtiff, &tags, &whole);
  if (rc) return rc;
  auto tag = [&](int id) -> const Tag& { return tags[tag_slot(id)]; };
  auto one = [&](int id, uint32_t fallback) -> uint32_t { return tag(id).present ? tag(id).v[0] : fallback; };
  if (!tag(kWidth).present || !tag(kLength).present || tag(kWidth).v.size() != 1 || tag(kLength).v.size() != 1)
    return kTiffDirectory;
  const uint32_t width = tag(kWidth).v[0], height = tag(kLength).v[0];
  if (width == 0 || height == 0 || width > 0x7fffffff || height > 0x7fffffff) return kTiffDirectory;
  if ((uint64_t)width * height > kMaxPixels) return kTooLarge;

  // compression and pixel kind, by Pillow's OPEN_INFO key
  const uint32_t compression = one(kCompression, 1);
  if (compression == 34676 || compression == 34677) return kTiffLogLuv;
  const CodecOf* found = nullptr;
  for (const CodecOf& c : kCodecs)
    if (c.compression == compression) found = &c;
  if (!found) return kTiffCompression;
  const Codec codec = found->codec;
  const bool ojpeg = codec == kOldJpeg;
  const bool jpeg = codec == kJpeg;
  const bool ccitt = codec == kCcitt;
  const bool raw = codec == kRaw;  // Pillow's own raw decoder; libtiff for the rest
  const uint32_t photometric = one(kPhotometric, 0);  // Pillow's default: MinIsWhite
  if (photometric == 32844 || photometric == 32845) return kTiffLogLuv;
  if (photometric > 3 && photometric != 5 && photometric != 6 && photometric != 8) return kTiffPhotometric;
  // SampleFormat: one value, or one a sample all 1 (Pillow's (1,))
  std::vector<uint32_t> formats = tag(kSampleFormat).present ? tag(kSampleFormat).v : std::vector<uint32_t>{1};
  if (formats.size() > 1 && *std::max_element(formats.begin(), formats.end()) == 1 &&
      *std::min_element(formats.begin(), formats.end()) == 1)
    formats.assign(1, 1);
  if (formats.size() != 1 || formats[0] < 1 || formats[0] > 3) return kTiffLayout;
  const uint32_t format = formats[0];
  const uint32_t fill = one(kFillOrder, 1);
  if (fill != 1 && fill != 2) return kTiffLayout;
  const std::vector<uint32_t>& extras = tag(kExtraSamples).v;
  const uint32_t samples = one(kSamples, 1);
  if (samples > 6) return kTiffDirectory;  // MAX_SAMPLESPERPIXEL
  std::vector<uint32_t> bits = tag(kBits).present ? tag(kBits).v : std::vector<uint32_t>{1};
  if (samples < bits.size())
    bits.resize(samples);
  else if (samples > bits.size() && bits.size() == 1)
    bits.assign(samples, bits[0]);
  if (bits.size() != samples) return kTiffDirectory;  // "unknown data organization"
  for (uint32_t b : bits)
    if (b != bits[0]) return kTiffLayout;
  const uint32_t bps = bits[0];
  const bool planar = one(kPlanar, 1) == 2;
  if (one(kPlanar, 1) != 1 && !planar) return kTiffDirectory;
  const bool big = f.big;
  Kind kind;
  bool invert = photometric == 0, unpremultiply = false, fill_known = fill == 1;
  if (ojpeg) {
    // Pillow keys old JPEG as YCbCr whatever the tag (L of one sample, RGB of three);
    // libtiff's codec gives gray samples as they are and YCbCr to TIFFRGBAImage
    if (!tag(kSamples).present || planar || fill != 1 || format != 1 || !extras.empty() || bps != 8 ||
        !((samples == 1 && photometric <= 1) || (samples == 3 && photometric == 6)))
      return kTiffOjpeg;
    kind = samples == 1 ? kGray : kRgb;
    invert = false;
  } else if (photometric <= 1 && samples == 1 && extras.empty() && format == 1 && (bps == 1 || bps == 2 || bps == 4)) {
    kind = bps == 1 ? kBilevel : kGray;  // 1;I 1 L;2I L;2 L;4I L;4, and each with R (FillOrder 2)
    fill_known = true;
  } else if (photometric <= 1 && samples == 1 && extras.empty() && bps == 8 && format <= 2 &&
             (format == 1 || photometric == 1)) {
    kind = kGray;  // L;I L, signed L, and L;R; L;IR is no raw mode
    fill_known = fill == 1 || (format == 1 && (photometric == 1 || !raw));
  } else if (photometric <= 1 && samples == 1 && extras.empty() && bps == 16 && format == 1 &&
             (photometric == 1 || !big) && (fill == 1 || (photometric == 1 && !big))) {
    kind = kGray16;  // I;16 I;16B, and I;16R (II, FillOrder 2)
    invert = false;
    fill_known = true;
  } else if (photometric == 1 && samples == 1 && extras.empty() && bps == 12 && format == 1 && fill == 1) {
    if (big) return kTiffMm12;  // Pillow's one key of 12-bit gray is II's: an MM file it cannot identify
    kind = kGray16;             // I;16 from I;12: samples MSB first, rows padded to a byte
    invert = false;
  } else if (photometric == 1 && samples == 1 && extras.empty() && bps == 16 && format == 2) {
    kind = kSigned16;  // I;16S I;16BS
  } else if (photometric == 1 && samples == 1 && extras.empty() && bps == 32 && (format == 2 || (format == 1 && !big))) {
    kind = kInt32;  // I;32N I;32S I;32BS (Pillow has no key of big-endian unsigned 32-bit gray)
  } else if (photometric <= 1 && samples == 1 && extras.empty() && bps == 32 && format == 3) {
    kind = kFloat;  // F;32F F;32BF
    invert = false;
  } else if (photometric == 1 && samples == 2 && bps == 8 && format == 1 && extras.size() == 1 && extras[0] == 2) {
    kind = kGrayAlpha;
  } else if (photometric == 2 && format == 1 && bps == 8 && samples >= 3 &&
             (extras.empty() ? samples <= 4 : extras.size() == samples - 3)) {
    // Pillow's keys: RGB (and RGB;R), RGBA without ExtraSamples, then extra
    // samples (0|1|2, 0, 0) or (999,): the first an alpha where it is 1 or 2
    kind = kRgb;
    for (size_t k = 1; k < extras.size(); k++)
      if (extras[k] != 0) return kTiffLayout;
    if (!extras.empty() && !(extras[0] <= 2 || (extras[0] == 999 && samples == 4))) return kTiffLayout;
    unpremultiply = !extras.empty() && extras[0] == 1;
    fill_known = fill == 1 || (samples == 3 && extras.empty());
  } else if (photometric == 2 && format == 1 && bps == 16 &&
             (samples == 3 ? extras.empty() : samples == 4 && extras.size() <= 1 && (extras.empty() || extras[0] <= 2))) {
    kind = kRgb;  // RGB;16 RGBA;16 RGBX;16 RGBa;16
    unpremultiply = extras.size() == 1 && extras[0] == 1;
  } else if (photometric == 3 && samples == 1 && extras.empty() && format == 1 &&
             (bps == 1 || bps == 2 || bps == 4 || bps == 8)) {
    kind = kPalette;  // P;1 P;2 P;4 P, and P;R; P;1R P;2R P;4R are no raw modes
    fill_known = fill == 1 || bps == 8 || !raw;
  } else if (photometric == 5 && format == 1 && ((bps == 8 && samples >= 4 && extras.size() == samples - 4) ||
                                                  (bps == 16 && samples == 4 && extras.empty()))) {
    kind = kCmyk;  // CMYK CMYKX CMYKXX CMYK;16
    for (uint32_t e : extras)
      if (e != 0) return kTiffLayout;
  } else if (photometric == 8 && format == 1 && bps == 8 && samples == 3 && extras.empty() && fill == 1) {
    kind = kLab;  // Pillow's LAB, its one key of CIELab: 8 bits, three samples, FillOrder 1
  } else if (photometric == 6 && format == 1 && bps == 8 && extras.empty() && (samples == 3 || raw)) {
    // Pillow's keys: RGB (raw mode RGBX; RGB under JPEG) and L, FillOrder 1
    // alone; one sample is read by the raw decoder alone (libtiff refuses it)
    if (fill != 1) return kTiffLayout;
    if (samples == 1) kind = kGray;
    else if (samples == 3) kind = kRgb;
    else return kTiffLayout;
  } else {
    return kTiffLayout;
  }
  // Fax3SetupState: 1-bit samples; Pillow's 1, 1;I and P;1 (a palette of two entries, each index a fax bit)
  if (ccitt && kind != kBilevel && !(kind == kPalette && bps == 1)) return kTiffCcitt;
  if (jpeg && !(bps == 8 && format == 1 && extras.empty() && fill == 1 &&
                ((kind == kGray && samples == 1) || ((kind == kRgb || kind == kLab) && samples == 3) ||
                 (kind == kCmyk && samples == 4))) &&
      !(bps == 12 && kind == kGray16))
    return kTiffJpeg;  // libtiff's JPEG codec: 8-bit samples and 12-bit gray, as Pillow reads them here
  // YCbCr: Pillow's raw decoder reads an uncompressed file as RGBX, four
  // bytes a pixel, unconverted; libjpeg converts it under JPEG in one
  // plane; libtiff's TIFFRGBAImage under LZW, Deflate and PackBits
  // (ycbcr_rgba) and under JPEG in separate planes (ycbcr_planes: each a
  // one-component stream, read as it is)
  const bool ycbcr = photometric == 6 && samples == 3;
  const bool rgbx = ycbcr && raw && !planar;
  const bool ycbcr_rgba = ycbcr && !raw && !jpeg && !ojpeg;
  const bool ycbcr_planes = ycbcr && jpeg && planar;
  uint32_t hs = 2, vs = 2;  // YCbCrSubsampling: libtiff's default 2, 2
  if (ycbcr && tag(kYcbcrSubsampling).present) {
    if (tag(kYcbcrSubsampling).v.size() != 2) return kTiffDirectory;
    hs = tag(kYcbcrSubsampling).v[0];
    vs = tag(kYcbcrSubsampling).v[1];
  }
  float luma[3] = {0.299f, 0.587f, 0.114f}, rbw[6] = {0, 255, 128, 255, 128, 255};
  auto put_routine = [](uint32_t h, uint32_t v) {  // TIFFRGBAImage's putcontig8bitYCbCr routines
    const uint32_t code = h << 4 | v;
    return code == 0x11 || code == 0x12 || code == 0x21 || code == 0x22 || code == 0x41 || code == 0x42 || code == 0x44;
  };
  if (ycbcr_rgba || ycbcr_planes || (ojpeg && ycbcr)) {
    // libtiff's strip and scanline sizes take 1, 2 or 4 alone; put routines
    // exist for these; separate planes, 1 x 1 alone (old JPEG's are the codec's, checked later)
    const uint32_t code = hs << 4 | vs;
    if (!ojpeg && !put_routine(hs, vs)) return kTiffYcbcr;
    if (planar && code != 0x11) return kTiffYcbcr;
    if (tag(kYcbcrCoefficients).present) {
      if (tag(kYcbcrCoefficients).f.size() != 3) return kTiffDirectory;
      std::copy_n(tag(kYcbcrCoefficients).f.begin(), 3, luma);
      if (luma[1] == 0.0f) return kTiffYcbcr;  // "Invalid values for YCbCrCoefficients tag"
    }
    if (tag(kReferenceBlackWhite).present) {
      if (tag(kReferenceBlackWhite).f.size() != 6) return kTiffDirectory;
      std::copy_n(tag(kReferenceBlackWhite).f.begin(), 6, rbw);
      for (float v : rbw)
        if (!(v > (float)(-0x7FFFFFFF + 128) && v < (float)0x7FFFFFFF)) return kTiffYcbcr;
    }
  }
  if (fill == 2 && kind != kBilevel && kind != kGray && kind != kGray16 && kind != kPalette &&
      !(kind == kRgb && bps == 8 && samples == 3 && extras.empty()))
    return kTiffLayout;  // no key of Pillow's holds FillOrder 2 with these samples
  if (!raw && !(whole && libtiff_header)) return kTiffDirectory;
  const bool tiled = tag(kTileOffsets).present || (!tag(kStripOffsets).present && tag(kTileWidth).present);
  if (ojpeg && tiled) return kTiffOjpeg;
  // Pillow's raw decoder reads each plane of separate planes with one
  // character of the raw mode: 1 (1-bit, not inverted), L, P, R, G, B, A, C,
  // M, Y, K (a byte, whatever the samples' depth: a 2- or 4-bit or a 16-bit
  // plane reads as bytes), I (a native 32-bit integer, for signed 16-bit)
  // and F (a native float); so samples read neither inverted nor reversed
  const bool by_char = raw && planar;
  uint32_t rbits = bps;  // the bits a sample is read at
  bool native = false;   // read little-endian whatever the file's order
  if (by_char) {
    if (kind == kGray16 || kind == kGrayAlpha || samples > 4 ||
        (samples == 4 && kind == kRgb && !extras.empty() && extras[0] != 2 && extras[0] != 999))
      return kTiffLayout;  // "unknown raw mode for given image mode" (I, LA's A, a, X)
    rbits = kind == kBilevel ? 1 : kind == kSigned16 || kind == kInt32 || kind == kFloat ? 32 : 8;
    native = rbits == 32;
    invert = false;
    fill_known = true;
  }
  if (!fill_known) return kTiffFillOrder;  // L;IR, P;1R...: "unknown raw mode for given image mode"
  if (planar && samples > 1 && !raw) {
    // what Pillow's libtiff lane makes of separate planes
    if (!tiled && (kind == kRgb ? samples > 4 || (samples == 4 && !extras.empty() && extras[0] == 0)
                                : kind == kCmyk && samples > 4))
      return kTiffLayout;  // "decoder error -2"
    if (kind == kRgb && samples == 4 && extras.empty()) unpremultiply = true;
  }
  const bool reverse = fill == 2 && !by_char;  // the raw bytes' bits, least significant first
  // libtiff hands Pillow native-order (little-endian) samples, which Pillow
  // unpacks as big-endian where its raw mode names the order and is not
  // renamed (I;16BS, F;32BF): each such sample reads byte-swapped
  const bool byteswap = !raw && big && (kind == kSigned16 || kind == kInt32 || kind == kFloat);
  const uint32_t predictor = one(kPredictor, 1);
  const bool predict = found->predictor && predictor != 1;
  if (predict && (predictor != 2 || (bps != 8 && bps != 16 && bps != 32)))
    return kTiffPredictor;  // libtiff's PredictorSetup
  std::vector<uint8_t> cmap;  // Pillow's "RGB;L" palette: every red, then every green, then every blue
  size_t entries = 0;
  if (kind == kPalette) {
    const Tag& cm = tag(kColorMap);
    // libtiff wants 3 * 2^bits entries; Pillow's raw lane reads what there is
    if (!cm.present || !(cm.v.size() == 3u << bps || (raw && cm.v.size() == 768))) return kTiffDirectory;
    entries = cm.v.size() / 3;
    cmap.resize(cm.v.size());
    for (size_t i = 0; i < cm.v.size(); i++) cmap[i] = (uint8_t)(cm.v[i] / 256);
  }

  // the chunks: strips, or tiles, each plane after the other where planar
  // a pixel's samples in a chunk's row: one, a plane apart; RGBX's four
  const uint32_t planes = planar ? samples : 1, per_plane = planar ? 1 : rgbx ? 4 : samples;
  const uint32_t px_samples = rgbx ? 4 : samples;  // the samples kept a pixel
  uint32_t cw, ch;  // a chunk's width and rows
  if (tiled) {
    if (!tag(kTileWidth).present || !tag(kTileLength).present || !tag(kTileOffsets).present) return kTiffDirectory;
    cw = tag(kTileWidth).v[0];
    ch = tag(kTileLength).v[0];
    if (cw == 0 || ch == 0) return kTiffDirectory;
  } else {
    if (!tag(kStripOffsets).present) return kTiffDirectory;
    cw = width;
    ch = one(kRowsPerStrip, height);
    if (ch == 0) return kTiffDirectory;
    if (ch > height) ch = height;
  }
  // libtiff packs a 12-bit JPEG row's samples two at a time: an odd row's
  // last is never written, and Pillow shows what its buffer held there
  if (jpeg && bps == 12 && (cw & 1)) return kTiffJpeg12Odd;
  const uint64_t across = (width + cw - 1) / cw, down = (height + ch - 1) / ch;
  const uint64_t chunks = across * down * planes;
  const std::vector<uint32_t>& offsets = tag(tiled ? kTileOffsets : kStripOffsets).v;
  const Tag& counts = tag(tiled ? kTileBytes : kStripBytes);
  if (offsets.size() != chunks) return kTiffDirectory;
  if (!raw && (!counts.present || counts.v.size() != chunks)) return kTiffDirectory;
  const size_t row_bytes = ((size_t)cw * per_plane * rbits + 7) / 8;
  // Pillow's raw decoder steps the rows of a tile past the right edge by
  // int(w * sum(bits) / 8), over the planes' count Pillow expects where
  // planar (3 + the extra samples for RGB); other rows by their width
  const uint32_t expected =
      (photometric == 2 || photometric == 6 || photometric == 8 ? 3 : photometric == 5 ? 4 : 1) + (uint32_t)extras.size();
  const size_t edge_stride = (size_t)((uint64_t)cw * samples * bps / (8ull * (planar ? expected : 1)));

  // a single uncompressed chunk of a mode Pillow maps (L, P, I;16, I;16B,
  // RGBA, CMYK): it maps the file at the size it reports, which Orientation
  // 5-8 has swapped, before it applies the orientation
  const uint32_t orientation = one(kOrientation, 1);
  const bool swap = orientation >= 5 && orientation <= 8;
  const bool mappable = (by_char && (kind == kGray || kind == kPalette)) ||
                        (kind == kGray && bps == 8 && (photometric == 1 || photometric == 6) && fill == 1) ||
                        (kind == kPalette && bps == 8 && fill == 1) || (kind == kGray16 && bps == 16 && fill == 1) ||
                        (kind == kRgb && bps == 8 && samples == 4 && !planar &&
                         (extras.empty() || extras[0] == 2 || extras[0] == 999)) ||
                        (kind == kCmyk && bps == 8 && samples == 4 && !planar);
  bool mapped = raw && chunks == 1 && mappable;
  size_t map_stride = 0;
  uint32_t ih = height, iw = width;  // the image before the orientation
  if (mapped) {
    const size_t pixel = kind == kGray16 ? 2 : kind == kRgb || kind == kCmyk ? 4 : 1;  // L, P, I;16, RGBA, CMYK
    const uint32_t mh = swap ? width : height, mw = swap ? height : width;
    const size_t arg = tiled && cw > width ? edge_stride : 0;
    if (arg && offsets[0] + (uint64_t)mh * arg > size) {
      mapped = false;  // load()'s own check fails: Pillow decodes instead
    } else {
      map_stride = arg ? arg : (size_t)mw * pixel;
      if (offsets[0] + (uint64_t)mh * map_stride > size) return kTruncated;  // "buffer is not large enough"
      ih = mh;
      iw = mw;
    }
  }
  const int out_h = (int)(swap ? iw : ih), out_w = (int)(swap ? ih : iw);
  if (!rgb || *h != out_h || *w != out_w) {
    *h = out_h;
    *w = out_w;
    return kSize;
  }

  // every sample of the image, as an integer: (ih, iw, samples), 16 bits
  // a sample but where it is read as a 32-bit word (F, and I by one character)
  const bool wide = rbits == 32;
  std::vector<uint16_t> px16;
  std::vector<uint32_t> px32;
  std::vector<uint8_t> buffer, reversed;
  try {
    if (wide)
      px32.resize((size_t)ih * iw * px_samples);
    else
      px16.resize((size_t)ih * iw * px_samples);
    buffer.resize(mapped ? 0 : row_bytes * ch);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  // libtiff picks its LZW decoder once, on the first strip or tile read
  // (LZWPreDecode): the old codes where that chunk's data (their bits
  // reversed under FillOrder 2) begin with 0x00 and an odd byte
  bool lzw_old = false;
  if (codec == kLzw && chunks && offsets[0] <= size && counts.v[0] >= 2 && counts.v[0] <= size - offsets[0]) {
    uint8_t first[2] = {file[offsets[0]], file[offsets[0] + 1]};
    if (reverse) reverse_bits(first, 2);
    lzw_old = first[0] == 0 && (first[1] & 1);
  }
  const bool be = big && !native;
  auto read_px = [&](auto* px) -> int {
    if (mapped) {
      for (uint32_t y = 0; y < ih; y++)
        unpack(file + offsets[0] + (size_t)y * map_stride, rbits, be, iw, samples, px_samples,
               px + (size_t)y * iw * px_samples);
      return kOk;
    }
    for (uint64_t c = 0; c < chunks; c++) {
      const uint32_t plane = (uint32_t)(c / (across * down)), at = (uint32_t)(c % (across * down));
      const uint32_t x0 = (uint32_t)(at % across) * cw, y0 = (uint32_t)(at / across) * ch;
      // rows of this chunk: a strip's last is short; a tile is whole in the data
      const uint32_t rows = tiled ? ch : std::min(ch, height - y0);
      const uint32_t used = std::min(ch, height - y0), cols = std::min(cw, width - x0);
      size_t stride = row_bytes;
      const uint8_t* data;
      const uint64_t offset = offsets[c];
      if (raw) {
        // Pillow's raw decoder reads the rows it shows, the last as far as the image's right edge
        if (tiled && x0 + cw > width) stride = edge_stride;
        const size_t last = ((size_t)cols * per_plane * rbits + 7) / 8;
        if (stride < last) return kTiffLayout;  // its rows overlap: "bad configuration"
        if (offset + stride * (used - 1) + last > size) return kTruncated;
        data = file + offset;
        if (reverse) {  // the raw modes of FillOrder 2 (1;R, L;2R, I;16R, RGB;R...) reverse each byte first
          reversed.assign(data, data + stride * (used - 1) + last);
          reverse_bits(reversed.data(), reversed.size());
          data = reversed.data();
        }
      } else {
        const uint64_t count = counts.v[c];
        if (offset > size || count > size - offset) return kTruncated;  // libtiff: "Read error on strip"
        const uint8_t* in = file + offset;
        if (reverse) {  // libtiff reverses the coded bytes' bits before it decodes them
          reversed.assign(in, in + count);
          reverse_bits(reversed.data(), reversed.size());
          in = reversed.data();
        }
        const size_t need = row_bytes * rows;
        int rc;
        if (ccitt)
          rc = decode_ccitt(in, count, offset, compression, one(kT4Options, 0), cw, rows, row_bytes, buffer.data());
        else
          rc = inflate_chunk(codec, in, count, buffer.data(), need, lzw_old);
        if (rc) return rc;
        if (predict)
          for (uint32_t r = 0; r < rows; r++) undo_predictor(buffer.data() + row_bytes * r, row_bytes, bps, per_plane, big);
        data = buffer.data();
      }
      // the chunk's samples into the image, clipped at its right and bottom edges
      for (uint32_t r = 0; r < used; r++)
        unpack(data + stride * r, rbits, be, cols, per_plane, px_samples,
               px + ((size_t)(y0 + r) * width + x0) * px_samples + plane);
    }
    return kOk;
  };
  // every chunk's bytes as libtiff reads them: "Read error on strip" past the file's end
  auto coded = [&](uint64_t c, const uint8_t** in, size_t* count) -> int {
    const uint64_t offset = offsets[c];
    *count = counts.v[c];
    if (offset > size || *count > size - offset) return kTruncated;
    *in = file + offset;
    return kOk;
  };
  auto inflate = [&](const uint8_t* in, size_t count, uint8_t* out, size_t need) -> int {
    return inflate_chunk(codec, in, count, out, need, lzw_old);
  };
  // JPEG: each strip or tile a JPEG stream after the JPEGTables stream, held
  // to the tags as libtiff's JPEGPreDecode holds it; in separate planes
  // each plane's chunk a one-component stream of 1 x 1 factors, its
  // samples as they are (YCbCr 1 x 1 then through TIFFRGBAImage's
  // putseparate8bitYCbCr11tile and the tables of the file's tags)
  auto read_jpeg = [&]() -> int {
    const Tag& jt = tag(kJpegTables);
    const uint8_t* tables = jt.present ? file + jt.at : nullptr;
    const size_t tables_size = jt.present ? jt.v[0] : 0;
    const uint32_t components = planar ? 1 : samples;
    const bool convert = ycbcr && !planar;  // libjpeg's YCbCr -> RGB
    JpegFrame frame;
    std::vector<uint8_t> pixels;
    std::vector<uint16_t> pixels12;
    for (uint64_t c = 0; c < chunks; c++) {
      const uint32_t plane = (uint32_t)(c / (across * down)), at = (uint32_t)(c % (across * down));
      const uint32_t x0 = (uint32_t)(at % across) * cw, y0 = (uint32_t)(at / across) * ch;
      const uint32_t used = std::min(ch, height - y0), cols = std::min(cw, width - x0);
      const uint8_t* in;
      size_t count;
      int rc = coded(c, &in, &count);
      if (!rc && bps == 12)
        rc = decode_jpeg_tiff12(tables, tables_size, in, count, &frame, &pixels12);
      else if (!rc)
        rc = decode_jpeg_tiff(tables, tables_size, in, count, convert, (int)components, &frame, &pixels);
      if (rc) return rc;
      if (c == 0 && convert && !tag(kYcbcrSubsampling).present) {
        // JPEGFixupTagsSubsampling: without the tag, the first chunk's luma
        // factors, where the frame is one it scans and they have a TIFF
        // equivalent; else the default 2, 2 stays
        const int m = frame.marker;
        const bool scanned = m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA;
        const int ph = frame.hsamp[0], pv = frame.vsamp[0];
        if (scanned && frame.hsamp[1] == 1 && frame.vsamp[1] == 1 && frame.hsamp[2] == 1 && frame.vsamp[2] == 1 &&
            (ph == 1 || ph == 2 || ph == 4) && (pv == 1 || pv == 2 || pv == 4))
          hs = ph, vs = pv;
      }
      // the sampling factors: the first component's the YCbCr tag's, every other 1 x 1
      for (int k = 0; k < frame.components; k++)
        if (frame.hsamp[k] != (k == 0 && convert ? (int)hs : 1) || frame.vsamp[k] != (k == 0 && convert ? (int)vs : 1))
          return kTiffJpegStream;  // "Improper JPEG sampling factors"
      // the size: a tile's, or a strip's rows; a last strip may say more rows than it has
      const uint32_t seg_h = tiled ? ch : used;
      if ((uint32_t)frame.w != cw ||
          !((uint32_t)frame.h == seg_h || (!tiled && (uint32_t)frame.h > seg_h && y0 + seg_h == height)))
        return kTiffJpegStream;
      if (bps == 12) {
        for (uint32_t r = 0; r < used; r++)
          for (uint32_t x = 0; x < cols; x++)
            px16[(size_t)(y0 + r) * width + x0 + x] = pixels12[(size_t)r * frame.w + x];
        continue;
      }
      for (uint32_t r = 0; r < used; r++)
        for (uint32_t x = 0; x < cols; x++)
          for (uint32_t k = 0; k < components; k++)
            px16[((size_t)(y0 + r) * width + x0 + x) * samples + plane + k] =
                pixels[((size_t)r * frame.w + x) * components + k];
    }
    if (ycbcr_planes) {
      const YcbcrTables tabs(luma, rbw);
      for (size_t i = 0; i < (size_t)height * width; i++) {
        uint16_t* p = px16.data() + 3 * i;
        tabs.rgb(p[0], p[1], p[2], p);
      }
    }
    return kOk;
  };
  // old JPEG: the stream ojpeg_rebuild makes, its YCbCr read raw (libjpeg's
  // raw_data_out) into TIFFRGBAImage's put routine (each pixel its own Y
  // and its block's Cb and Cr, libtiff's conversion), gray as it is
  auto read_ojpeg = [&]() -> int {
    Ojpeg o;
    o.width = width, o.height = height, o.strip_rows = ch, o.samples = (int)samples, o.ycbcr = ycbcr, o.hs = hs,
    o.vs = vs;
    auto first = [&](int id) -> uint64_t { return tag(id).present ? tag(id).v[0] : 0; };
    int rc = ojpeg_rebuild(file, size, first(kJpegInterchange), first(kJpegInterchangeLength),
                           (int64_t)first(kJpegRestartInterval), tag(kJpegQTables).v, tag(kJpegDcTables).v,
                           tag(kJpegAcTables).v, offsets, counts.v, &o);
    if (rc) return rc;
    // a stream whose factors TIFF has no name for: libtiff 4.7.1's codec
    // would upsample inside libjpeg, and its reading fails there
    if (o.forced) return kTiffOjpeg;
    if (ycbcr && !put_routine(o.hs, o.vs)) return kTiffYcbcr;
    const YcbcrTables tabs(luma, rbw);
    JpegFrame frame;
    if (ycbcr) {
      std::vector<uint8_t> planes[4];
      int strides[4];
      rc = decode_jpeg_planes(o.stream.data(), o.stream.size(), &frame, planes, strides);
      if (rc) return rc;
      if ((uint32_t)frame.w != width || (uint32_t)frame.h < height) return kTiffJpegStream;
      for (uint32_t y = 0; y < height; y++)
        for (uint32_t x = 0; x < width; x++) {
          const size_t c = (size_t)(y / o.vs) * strides[1] + x / o.hs;
          tabs.rgb(planes[0][(size_t)y * strides[0] + x], planes[1][c], planes[2][(size_t)(y / o.vs) * strides[2] + x / o.hs],
                   px16.data() + 3 * ((size_t)y * width + x));
        }
      return kOk;
    }
    std::vector<uint8_t> pixels;  // gray: the samples as they are
    rc = decode_jpeg_tiff(nullptr, 0, o.stream.data(), o.stream.size(), false, 1, &frame, &pixels);
    if (rc) return rc;
    if ((uint32_t)frame.w != width || (uint32_t)frame.h < height) return kTiffJpegStream;
    for (uint32_t y = 0; y < height; y++)
      for (uint32_t x = 0; x < width; x++) px16[(size_t)y * width + x] = pixels[(size_t)y * frame.w + x];
    return kOk;
  };
  // YCbCr under LZW, Deflate or PackBits: Pillow's _decodeAsRGBA, one
  // TIFFRGBAImageGet a strip or a row of tiles.  gtStripContig decodes a
  // strip's rows rounded up to the block height at TIFFScanlineSize, the
  // bytes of a row of blocks over the block height rounded down, into a
  // zeroed buffer (4 x 4 blocks, an odd number across: the last block's
  // last bytes are never decoded); gtTileContig a whole tile, and the put
  // routine steps over the columns past the image's edge by whole blocks,
  // putcontig8bitYCbCr44tile by 10 bytes a block
  // Predictor 2 on YCbCr: libtiff's PredictorDecodeTile undoes horAcc8 on
  // each `rowsize` bytes of what it decoded, a sample `stride` bytes back
  // (3 in one plane, whatever the blocks' size); where the bytes are not
  // whole rows or a row not whole strides it fails before it changes a
  // byte, and TIFFRGBAImage (Pillow's stoponerr 0) shows the bytes as
  // decoded
  auto undo_ycbcr_predictor = [&](uint8_t* p, size_t n, size_t rowsize, size_t stride) -> int {
    if (!predict || rowsize % stride || n % rowsize) return kOk;
    for (size_t at = 0; at < n; at += rowsize)
      for (size_t i = stride; i < rowsize; i++) p[at + i] = (uint8_t)(p[at + i] + p[at + i - stride]);
    return kOk;
  };
  auto read_ycbcr = [&]() -> int {
    const YcbcrTables tabs(luma, rbw);
    const uint32_t k = hs * vs + 2;
    const size_t row_blocks = (cw + hs - 1) / hs;
    const uint64_t per_plane_chunks = across * down;
    std::vector<uint8_t> planes_buf[3];
    for (uint64_t c = 0; c < per_plane_chunks; c++) {
      const uint32_t x0 = (uint32_t)(c % across) * cw, y0 = (uint32_t)(c / across) * ch;
      const uint32_t used = std::min(ch, height - y0), cols = std::min(cw, width - x0);
      const uint32_t rows = tiled ? ch : used;  // the rows in the chunk's data
      uint16_t* out = px16.data() + ((size_t)y0 * width + x0) * 3;
      if (planar) {  // putseparate8bitYCbCr11tile
        for (uint32_t p = 0; p < 3; p++) {
          const uint8_t* in;
          size_t count;
          planes_buf[p].assign((size_t)rows * cw, 0);
          int rc = coded(c + p * per_plane_chunks, &in, &count);
          if (!rc) rc = inflate(in, count, planes_buf[p].data(), planes_buf[p].size());
          if (!rc) rc = undo_ycbcr_predictor(planes_buf[p].data(), planes_buf[p].size(), cw, 1);
          if (rc) return rc;
        }
        for (uint32_t r = 0; r < used; r++)
          for (uint32_t x = 0; x < cols; x++) {
            const size_t i = (size_t)r * cw + x;
            tabs.rgb(planes_buf[0][i], planes_buf[1][i], planes_buf[2][i], out + (size_t)r * width * 3 + 3 * x);
          }
        continue;
      }
      const size_t sampling_row = row_blocks * k, full = (rows + vs - 1) / vs * sampling_row;
      const size_t read = tiled ? full : std::min(full, (size_t)(rows + vs - 1) / vs * vs * (sampling_row / vs));
      const uint8_t* in;
      size_t count;
      buffer.assign(full, 0);
      int rc = coded(c, &in, &count);
      if (!rc) rc = inflate(in, count, buffer.data(), read);
      // the predictor's row: TIFFTileRowSize (3 bytes a column) or TIFFScanlineSize (a row of blocks over vs)
      if (!rc) rc = undo_ycbcr_predictor(buffer.data(), read, tiled ? (size_t)cw * 3 : sampling_row / vs, 3);
      if (rc) return rc;
      const size_t fromskew = tiled && x0 + cw > width ? cw - cols : 0;
      put_ycbcr(tabs, buffer.data(), used, cols, hs, vs, fromskew / hs * (k == 18 ? 10 : k), out, (size_t)width * 3);
    }
    return kOk;
  };
  if (jpeg)
    rc = read_jpeg();
  else if (ojpeg)
    rc = read_ojpeg();
  else if (ycbcr_rgba)
    rc = read_ycbcr();
  else
    rc = wide ? read_px(px32.data()) : read_px(px16.data());
  if (rc) return rc;

  // convert("RGB") of Pillow's mode, then the orientation
  std::vector<uint8_t> img((size_t)ih * iw * 3);
  const uint32_t scale = rbits < 8 ? 255 / ((1u << rbits) - 1) : 1;  // L;2 and L;4 expand a sample to 8 bits
  const int high = rbits == 16 ? 8 : 0;  // 16-bit RGB and CMYK keep each sample's high byte
  auto to_rgb = [&](const auto* px) {
    for (size_t i = 0; i < (size_t)ih * iw; i++) {
      const auto* s = px + i * px_samples;
      uint8_t* o = img.data() + 3 * i;
      switch (kind) {
        case kBilevel:
          o[0] = o[1] = o[2] = (s[0] ^ invert) ? 255 : 0;
          break;
        case kGray:
          o[0] = o[1] = o[2] = (uint8_t)(invert ? 255 - s[0] * scale : s[0] * scale);
          break;
        case kGray16:
          o[0] = o[1] = o[2] = (uint8_t)std::min<uint32_t>(s[0], 255);
          break;
        case kSigned16: {  // Pillow's I -> RGB clips at 0 and 255
          const uint32_t v = byteswap ? ((uint32_t)s[0] >> 8 | (s[0] & 255) << 8) : s[0];
          const int value = rbits == 32 ? (int)(int32_t)v : (int)(int16_t)(uint16_t)v;
          o[0] = o[1] = o[2] = (uint8_t)std::min(255, std::max(0, value));
          break;
        }
        case kInt32: {  // Pillow's I -> RGB clips at 0 and 255; an unsigned sample past 2^31 reads negative
          const int32_t value = (int32_t)(byteswap ? __builtin_bswap32((uint32_t)s[0]) : (uint32_t)s[0]);
          o[0] = o[1] = o[2] = (uint8_t)std::min<int32_t>(255, std::max<int32_t>(0, value));
          break;
        }
        case kFloat:
          o[0] = o[1] = o[2] = f2l(byteswap ? __builtin_bswap32(s[0]) : s[0]);
          break;
        case kGrayAlpha:
          o[0] = o[1] = o[2] = (uint8_t)s[0];
          break;
        case kRgb: {
          const uint32_t a = samples > 3 ? (uint32_t)s[3] >> high : 255;
          if (unpremultiply && a != 255) {
            for (int k = 0; k < 3; k++) o[k] = a ? (uint8_t)std::min<uint32_t>(255, ((uint32_t)s[k] >> high) * 255 / a) : 0;
          } else {
            for (int k = 0; k < 3; k++) o[k] = (uint8_t)(s[k] >> high);
          }
          break;
        }
        case kPalette:  // an index past the palette (a plane read a byte a sample) reads black
          for (int k = 0; k < 3; k++) o[k] = s[0] < entries ? cmap[entries * k + s[0]] : 0;
          break;
        case kCmyk: {
          const uint32_t c[4] = {(uint32_t)s[0] >> high, (uint32_t)s[1] >> high, (uint32_t)s[2] >> high,
                                 (uint32_t)s[3] >> high};
          cmyk2rgb(c, o);
          break;
        }
        case kLab: {
          // TIFF's a* and b* are signed: Pillow's LAB unpacker turns them
          // into band values (128 the zero) by XOR 0x80; separate planes
          // are read by its L, A and B unpackers, which copy the bytes
          const uint8_t lab[3] = {(uint8_t)s[0], (uint8_t)(s[1] ^ (planar ? 0 : 0x80)),
                                  (uint8_t)(s[2] ^ (planar ? 0 : 0x80))};
          lab_to_rgb(lab, 1, o);
          break;
        }
      }
    }
  };
  if (wide)
    to_rgb(px32.data());
  else
    to_rgb(px16.data());
  // exif_transpose: where output pixel (y, x) comes from
  for (int y = 0; y < out_h; y++) {
    for (int x = 0; x < out_w; x++) {
      int sy = y, sx = x;
      switch (orientation) {
        case 2: sx = out_w - 1 - x; break;
        case 3: sy = out_h - 1 - y; sx = out_w - 1 - x; break;
        case 4: sy = out_h - 1 - y; break;
        case 5: sy = x; sx = y; break;
        case 6: sy = out_w - 1 - x; sx = y; break;
        case 7: sy = out_w - 1 - x; sx = out_h - 1 - y; break;
        case 8: sy = x; sx = out_h - 1 - y; break;
        default: break;
      }
      memcpy(rgb + 3 * ((size_t)y * out_w + x), img.data() + 3 * ((size_t)sy * iw + sx), 3);
    }
  }
  return kOk;
}

}  // namespace byogan
