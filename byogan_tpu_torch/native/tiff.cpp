// TIFF decode: the first page of a baseline TIFF as uint8 RGB, bit for bit
// with Pillow 12.1.0's Image.open(path).convert("RGB") (TiffImagePlugin,
// libtiff 4.7.1), the lane through which the JAX package reads a TIFF under
// a listed extension (its prep, cli.project and its loader's fallback).
//
// What is read, as Pillow reads it:
//
// - classic TIFF, II or MM byte order, the first image file directory;
//   strips or tiles; PlanarConfiguration 1 and 2;
// - compression none, PackBits, LZW (libtiff's decoder: MSB-first codes,
//   the width one code early, a table that may grow past 4096 entries
//   without a Clear) and Deflate (8 and 32946), with Predictor 2
//   (horizontal differencing of 8- and 16-bit samples) where libtiff
//   applies it: under LZW and Deflate; uncompressed and PackBits data take
//   no predictor, as libtiff installs none for them;
// - bilevel (1-bit MinIsWhite and MinIsBlack), 8-bit gray (MinIsWhite
//   inverted), 16-bit gray (Pillow's I;16 and I;16B: each sample clipped at
//   255 by convert("RGB"), MinIsWhite not inverted), 8-bit gray with an
//   unassociated alpha (LA), 8-bit RGB with 0 to 3 extra samples (dropped;
//   an associated alpha first is divided out as Pillow's RGBa unpacker
//   does), and 8-bit palettes (each 16-bit colour map entry / 256);
// - the Orientation tag, applied as Pillow's load does
//   (ImageOps.exif_transpose).
//
// Everything else returns a code of codec.h that names it: BigTIFF, JPEG
// and old JPEG, CCITT, LogLuv and other compressions, float and signed
// samples, YCbCr, CMYK and other photometric interpretations, FillOrder 2,
// other depths and sample layouts, old-style LZW, truncated or corrupt
// data (where libtiff or Pillow's raw decoder fails).

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
};

// One tag's values, read as unsigned integers (BYTE, SHORT, LONG).
struct Tag {
  bool present = false;
  std::vector<uint32_t> v;
};

enum TagId {
  kWidth = 256, kLength = 257, kBits = 258, kCompression = 259, kPhotometric = 262, kFillOrder = 266,
  kStripOffsets = 273, kOrientation = 274, kSamples = 277, kRowsPerStrip = 278, kStripBytes = 279,
  kPlanar = 284, kPredictor = 317, kColorMap = 320, kTileWidth = 322, kTileLength = 323, kTileOffsets = 324,
  kTileBytes = 325, kExtraSamples = 338, kSampleFormat = 339,
};
const int kTags[] = {kWidth, kLength, kBits, kCompression, kPhotometric, kFillOrder, kStripOffsets,
                     kOrientation, kSamples, kRowsPerStrip, kStripBytes, kPlanar, kPredictor, kColorMap,
                     kTileWidth, kTileLength, kTileOffsets, kTileBytes, kExtraSamples, kSampleFormat};

int tag_slot(int id) {
  for (int i = 0; i < (int)(sizeof(kTags) / sizeof(kTags[0])); i++)
    if (kTags[i] == id) return i;
  return -1;
}

// The directory's tags of kTags, read as Pillow's ImageFileDirectory_v2
// reads them: the entries up to the file's end (a directory cut short
// keeps those before the cut), a tag whose values lie past the end
// skipped.  *whole is false where either happened (libtiff refuses such a
// directory).  kTiffDirectory where a tag of kTags holds no integers.
int read_directory(const Bytes& f, size_t at, std::vector<Tag>* tags, bool* whole) {
  tags->assign(sizeof(kTags) / sizeof(kTags[0]), Tag());
  *whole = true;
  if (at < 8 || at + 2 > f.size) return kTiffDirectory;
  const uint32_t n = f.u16(at);
  for (uint32_t i = 0; i < n; i++) {
    const size_t e = at + 2 + 12 * i;
    if (e + 12 > f.size) {
      *whole = false;
      break;
    }
    const int slot = tag_slot((int)f.u16(e));
    if (slot < 0) continue;
    const uint32_t type = f.u16(e + 2), count = f.u32(e + 4);
    const int size = type == 1 ? 1 : type == 3 ? 2 : type == 4 ? 4 : 0;
    if (!size || count == 0) return kTiffDirectory;
    size_t pos = e + 8;
    if ((uint64_t)size * count > 4) {
      pos = f.u32(e + 8);
      if (pos + (uint64_t)size * count > f.size) {
        *whole = false;
        continue;
      }
    }
    Tag& t = (*tags)[slot];
    t.present = true;
    t.v.resize(count);
    for (uint32_t k = 0; k < count; k++) {
      const size_t p = pos + (size_t)size * k;
      t.v[k] = size == 1 ? f.data[p] : size == 2 ? f.u16(p) : f.u32(p);
    }
  }
  return kOk;
}

// libtiff's LZW decoder (tif_lzw.c, new-style codes) filling out[0, occ).
int lzw_decode(const uint8_t* in, size_t n, uint8_t* out, size_t occ) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kBitsMax = 12;
  constexpr int kSize = (1 << kBitsMax) - 1 + 1024;  // CSIZE: room past 4096 for late Clears
  struct Entry {
    int next;  // -1: none
    uint16_t length;
    uint8_t value, first;
  };
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) return kTiffOldLzw;  // LZWPreDecode's test for the old codes
  std::vector<Entry> table(kSize);
  for (int i = 0; i < 256; i++) table[i] = {-1, 1, (uint8_t)i, (uint8_t)i};
  std::vector<uint8_t> string;
  size_t bitpos = 0;
  const size_t bits_total = n * 8;
  int nbits = 9, maxcode = (1 << 9) - 2, free_ent = kFirst, old = -1;
  auto reset = [&]() {
    for (int i = kFirst; i < kSize; i++) table[i] = {-1, 0, 0, 0};
    nbits = 9;
    maxcode = (1 << 9) - 2;
    free_ent = kFirst;
  };
  auto next_code = [&]() -> int {
    if (bits_total - bitpos < (size_t)nbits) return kEoi;  // "not terminated with EOI": the data end
    int code = 0;
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
      maxcode = (1 << nbits) - 2;
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

// The pixel kinds read (Pillow's mode and raw mode).
enum Kind { kBilevel, kGray8, kGray16, kGrayAlpha, kRgb, kPalette };

}  // namespace

int decode_tiff(const uint8_t* file, size_t size, uint8_t* rgb, int* h, int* w) {
  if (size < 8) return kTiffDirectory;
  Bytes f{file, size, file[0] == 'M'};
  if (!((file[0] == 'I' && file[1] == 'I') || (file[0] == 'M' && file[1] == 'M'))) return kNotImage;
  const uint32_t version = f.u16(2);
  if (version == 43) return kTiffBig;
  if (version != 42) return kTiffDirectory;  // libtiff: "bad version number"
  std::vector<Tag> tags;
  bool whole;
  int rc = read_directory(f, f.u32(4), &tags, &whole);
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
  if (compression == 6 || compression == 7) return kTiffJpeg;
  if ((compression >= 2 && compression <= 4) || compression == 32771) return kTiffCcitt;
  if (compression == 34676 || compression == 34677) return kTiffLogLuv;
  const bool deflate = compression == 8 || compression == 32946;
  if (compression != 1 && compression != 5 && compression != 32773 && !deflate) return kTiffCompression;
  const uint32_t photometric = one(kPhotometric, 0);  // Pillow's default: MinIsWhite
  if (photometric == 6) return kTiffYcbcr;
  if (photometric == 5) return kTiffCmyk;
  if (photometric == 32844 || photometric == 32845) return kTiffLogLuv;
  if (photometric > 3) return kTiffPhotometric;
  for (uint32_t s : tag(kSampleFormat).v) {
    if (s == 3) return kTiffFloat;
    if (s == 2) return kTiffSigned;
    if (s != 1) return kTiffLayout;
  }
  if (one(kFillOrder, 1) != 1) return kTiffFillOrder;
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
  Kind kind;
  bool unpremultiply = false;
  if (photometric <= 1 && samples == 1 && extras.empty() && bps == 1) {
    kind = kBilevel;
  } else if (photometric <= 1 && samples == 1 && extras.empty() && bps == 8) {
    kind = kGray8;
  } else if (samples == 1 && extras.empty() && bps == 16 && (photometric == 1 || (photometric == 0 && !f.big))) {
    kind = kGray16;
  } else if (photometric == 1 && samples == 2 && bps == 8 && extras.size() == 1 && extras[0] == 2) {
    kind = kGrayAlpha;
  } else if (photometric == 2 && bps == 8 && samples >= 3 &&
             (extras.empty() ? samples <= 4 : extras.size() == samples - 3)) {
    // Pillow's keys: RGB, RGBA without ExtraSamples, then extra samples
    // (0|1|2, 0, 0) or (999,): the first an alpha where it is 1 or 2
    kind = kRgb;
    for (size_t k = 1; k < extras.size(); k++)
      if (extras[k] != 0) return kTiffLayout;
    if (!extras.empty() && !(extras[0] <= 2 || (extras[0] == 999 && samples == 4))) return kTiffLayout;
    unpremultiply = !extras.empty() && extras[0] == 1;
  } else if (photometric == 3 && samples == 1 && extras.empty() && bps == 8) {
    kind = kPalette;
  } else {
    return kTiffLayout;
  }
  const bool raw = compression == 1;  // Pillow's own raw decoder; libtiff for the rest
  if (!raw && !whole) return kTiffDirectory;
  const bool tiled = tag(kTileOffsets).present || (!tag(kStripOffsets).present && tag(kTileWidth).present);
  if (planar && samples > 1) {
    // what each of Pillow's lanes makes of separate planes
    if (raw) {
      if (kind == kGrayAlpha || samples > 4 || (samples == 4 && !extras.empty() && extras[0] != 2 && extras[0] != 999))
        return kTiffLayout;  // "unknown raw mode for given image mode"
    } else {
      if (!tiled && (samples > 4 || (samples == 4 && !extras.empty() && extras[0] == 0)))
        return kTiffLayout;  // "decoder error -2"
      if (samples == 4 && extras.empty()) unpremultiply = true;
    }
  }
  const uint32_t predictor = one(kPredictor, 1);
  const bool predict = (compression == 5 || deflate) && predictor != 1;
  if (predict && (predictor != 2 || bps == 1)) return kTiffPredictor;  // libtiff's PredictorSetup
  std::vector<uint8_t> cmap;
  if (kind == kPalette) {
    const Tag& cm = tag(kColorMap);
    if (!cm.present || cm.v.size() != 768) return kTiffDirectory;
    cmap.resize(768);
    for (int i = 0; i < 768; i++) cmap[i] = (uint8_t)(cm.v[i] / 256);
  }

  // the chunks: strips, or tiles, each plane after the other where planar
  const uint32_t planes = planar ? samples : 1, per_plane = planar ? 1 : samples;
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
  const uint64_t across = (width + cw - 1) / cw, down = (height + ch - 1) / ch;
  const uint64_t chunks = across * down * planes;
  const std::vector<uint32_t>& offsets = tag(tiled ? kTileOffsets : kStripOffsets).v;
  const Tag& counts = tag(tiled ? kTileBytes : kStripBytes);
  if (offsets.size() != chunks) return kTiffDirectory;
  if (!raw && (!counts.present || counts.v.size() != chunks)) return kTiffDirectory;
  const size_t row_bytes = ((size_t)cw * per_plane * bps + 7) / 8;
  // Pillow's raw decoder steps the rows of a tile past the right edge by
  // int(w * sum(bits) / 8), over the planes' count Pillow expects where
  // planar (3 + the extra samples for RGB); other rows by their width
  const uint32_t expected = (photometric == 2 ? 3 : 1) + (uint32_t)extras.size();
  const size_t edge_stride = (size_t)((uint64_t)cw * samples * bps / (8ull * (planar ? expected : 1)));

  // a single uncompressed chunk of a mode Pillow maps (L, P, I;16, I;16B,
  // RGBA): it maps the file at the size it reports, which Orientation 5-8
  // has swapped, before it applies the orientation
  const uint32_t orientation = one(kOrientation, 1);
  const bool swap = orientation >= 5 && orientation <= 8;
  const bool mappable = (kind == kGray8 && photometric == 1) || kind == kPalette || kind == kGray16 ||
                        (kind == kRgb && samples == 4 && !planar && (extras.empty() || extras[0] == 2 || extras[0] == 999));
  bool mapped = raw && chunks == 1 && mappable;
  size_t map_stride = 0;
  uint32_t ih = height, iw = width;  // the image before the orientation
  if (mapped) {
    const size_t pixel = kind == kGray16 ? 2 : kind == kRgb ? 4 : 1;
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

  // every sample of the image, as an integer: (ih, iw, samples)
  std::vector<uint16_t> px;
  std::vector<uint8_t> buffer;
  try {
    px.resize((size_t)ih * iw * samples);
    buffer.resize(mapped ? 0 : row_bytes * ch);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  auto sample = [&](const uint8_t* row, size_t i) -> uint32_t {
    if (bps == 1) return (row[i >> 3] >> (7 - (i & 7))) & 1;
    if (bps == 8) return row[i];
    return f.big ? (row[2 * i] << 8 | row[2 * i + 1]) : (row[2 * i] | row[2 * i + 1] << 8);
  };
  if (mapped) {
    for (uint32_t y = 0; y < ih; y++) {
      const uint8_t* row = file + offsets[0] + (size_t)y * map_stride;
      for (size_t i = 0; i < (size_t)iw * samples; i++) px[(size_t)y * iw * samples + i] = (uint16_t)sample(row, i);
    }
  }
  for (uint64_t c = 0; c < (mapped ? 0 : chunks); c++) {
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
      const size_t last = ((size_t)cols * per_plane * bps + 7) / 8;
      if (stride < last) return kTiffLayout;  // its rows overlap: "bad configuration"
      if (offset + stride * (used - 1) + last > size) return kTruncated;
      data = file + offset;
    } else {
      const uint64_t count = counts.v[c];
      if (offset > size || count > size - offset) return kTruncated;  // libtiff: "Read error on strip"
      const uint8_t* in = file + offset;
      const size_t need = row_bytes * rows;
      if (compression == 5)
        rc = lzw_decode(in, count, buffer.data(), need);
      else if (deflate)
        rc = deflate_decode(in, count, buffer.data(), need);
      else
        rc = packbits_decode(in, count, buffer.data(), need);
      if (rc) return rc;
      if (predict) {
        for (uint32_t r = 0; r < rows; r++) {
          uint8_t* row = buffer.data() + row_bytes * r;
          if (bps == 8) {
            for (size_t i = per_plane; i < row_bytes; i++) row[i] = (uint8_t)(row[i] + row[i - per_plane]);
          } else {  // 16-bit words in the file's order
            for (size_t i = per_plane; i < row_bytes / 2; i++) {
              const uint32_t v = sample(row, i) + sample(row, i - per_plane);
              row[2 * i + (f.big ? 0 : 1)] = (uint8_t)(v >> 8);
              row[2 * i + (f.big ? 1 : 0)] = (uint8_t)v;
            }
          }
        }
      }
      data = buffer.data();
    }
    // the chunk's samples into the image, clipped at its right and bottom edges
    for (uint32_t r = 0; r < used; r++) {
      const uint8_t* row = data + stride * r;
      uint16_t* dst = px.data() + ((size_t)(y0 + r) * width + x0) * samples + plane;
      for (uint32_t x = 0; x < cols; x++)
        for (uint32_t s = 0; s < per_plane; s++)
          dst[(size_t)x * samples + s] = (uint16_t)sample(row, (size_t)x * per_plane + s);
    }
  }

  // convert("RGB") of Pillow's mode, then the orientation
  std::vector<uint8_t> img((size_t)ih * iw * 3);
  for (size_t i = 0; i < (size_t)ih * iw; i++) {
    const uint16_t* s = px.data() + i * samples;
    uint8_t* o = img.data() + 3 * i;
    switch (kind) {
      case kBilevel:
        o[0] = o[1] = o[2] = (s[0] ^ (photometric == 0)) ? 255 : 0;
        break;
      case kGray8:
        o[0] = o[1] = o[2] = (uint8_t)(photometric == 0 ? 255 - s[0] : s[0]);
        break;
      case kGray16:
        o[0] = o[1] = o[2] = (uint8_t)std::min<uint16_t>(s[0], 255);
        break;
      case kGrayAlpha:
        o[0] = o[1] = o[2] = (uint8_t)s[0];
        break;
      case kRgb:
        if (unpremultiply && s[3] != 255) {
          for (int k = 0; k < 3; k++) o[k] = s[3] ? (uint8_t)std::min(255, s[k] * 255 / s[3]) : 0;
        } else {
          for (int k = 0; k < 3; k++) o[k] = (uint8_t)s[k];
        }
        break;
      case kPalette:
        for (int k = 0; k < 3; k++) o[k] = cmap[256 * k + s[0]];
        break;
    }
  }
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
