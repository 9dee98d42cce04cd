// A PNG decoder over zlib that gives the JAX package's libpng lane's RGB
// (byogan_tpu/native/byogan_io.cpp:32-91), bit for bit: every colour type
// and depth, Adam7 interlacing, 16-bit samples cut to their high byte,
// palettes and low-depth gray expanded, tRNS and alpha dropped, gray
// repeated into three channels.
//
// As libpng does by default: the CRC of every critical chunk is checked
// (an ancillary chunk's is not: libpng would drop the chunk, and none
// changes these pixels), an unknown critical chunk fails, and the decode
// stops once the image's bytes are inflated (what follows them in the
// zlib stream, its checksum included, is not read).

#include <zlib.h>

#include <cstring>
#include <new>
#include <vector>

#include "codec.h"

namespace byogan {
namespace {

inline uint32_t be32(const uint8_t* p) { return (uint32_t)p[0] << 24 | p[1] << 16 | p[2] << 8 | p[3]; }

constexpr uint32_t kMaxSide = 1000000;  // libpng's PNG_USER_WIDTH_MAX and _HEIGHT_MAX

// Adam7's passes: first column and row, then the steps between them.
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                              {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

struct Layout {
  int w, h, depth, color, channels;
  bool interlaced;
  int bits() const { return depth * channels; }
  size_t stride(int pw) const { return ((size_t)pw * bits() + 7) / 8; }
};

// Pass p's width and height (the whole image where not interlaced).
void pass_size(const Layout& l, int p, int* pw, int* ph) {
  if (!l.interlaced) {
    *pw = l.w, *ph = l.h;
    return;
  }
  const int* a = kAdam7[p];
  *pw = l.w > a[0] ? (l.w - a[0] + a[2] - 1) / a[2] : 0;
  *ph = l.h > a[1] ? (l.h - a[1] + a[3] - 1) / a[3] : 0;
}

// One unfiltered row of n pixels to RGB at out, pixels `step` apart.
void expand_row(const Layout& l, const uint8_t* row, int n, const uint8_t (*palette)[3], uint8_t* out,
                int step) {
  const int d = l.depth;
  if (d < 8) {  // gray or palette indices, packed from the most significant bit
    const int mask = (1 << d) - 1, scale = 255 / mask;
    for (int x = 0; x < n; x++) {
      const int bit = x * d;
      const int v = (row[bit >> 3] >> (8 - d - (bit & 7))) & mask;
      uint8_t* o = out + (size_t)x * step * 3;
      if (l.color == 3) {
        o[0] = palette[v][0], o[1] = palette[v][1], o[2] = palette[v][2];
      } else {
        o[0] = o[1] = o[2] = (uint8_t)(v * scale);
      }
    }
    return;
  }
  const int bytes = d / 8, px = bytes * l.channels;
  for (int x = 0; x < n; x++) {
    const uint8_t* s = row + (size_t)x * px;  // the high byte of each sample comes first
    uint8_t* o = out + (size_t)x * step * 3;
    switch (l.color) {
      case 0:
      case 4:
        o[0] = o[1] = o[2] = s[0];
        break;
      case 3:
        o[0] = palette[s[0]][0], o[1] = palette[s[0]][1], o[2] = palette[s[0]][2];
        break;
      default:  // 2, 6
        o[0] = s[0], o[1] = s[bytes], o[2] = s[2 * bytes];
        break;
    }
  }
}

struct Inflater {
  z_stream z;
  bool open = false;
  ~Inflater() {
    if (open) inflateEnd(&z);
  }
};

int decode(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (size < 8 || memcmp(data, sig, 8) != 0) return kNotImage;
  size_t pos = 8;
  // chunk at pos: its body, length and type; kTruncated past the end
  auto chunk = [&](const uint8_t** body, uint32_t* len, uint32_t* type) {
    if (size - pos < 12) return kTruncated;
    *len = be32(data + pos);
    *type = be32(data + pos + 4);
    if (*len > 0x7FFFFFFFu || size - pos - 12 < *len) return kTruncated;
    *body = data + pos + 8;
    const bool critical = !(data[pos + 4] & 0x20);
    if (critical && (uint32_t)crc32(0, data + pos + 4, *len + 4) != be32(data + pos + 8 + *len)) return kBadCrc;
    pos += 12 + (size_t)*len;
    return kOk;
  };
  const uint8_t* body;
  uint32_t len, type;
  int rc = chunk(&body, &len, &type);
  if (rc) return rc;
  if (type != 0x49484452u || len != 13) return kCorrupt;  // IHDR first
  Layout l;
  const uint32_t iw = be32(body), ih = be32(body + 4);
  l.depth = body[8], l.color = body[9];
  static const int channels[7] = {1, 0, 3, 1, 2, 0, 4};
  const bool depth_ok = l.color == 0   ? (l.depth == 1 || l.depth == 2 || l.depth == 4 || l.depth == 8 || l.depth == 16)
                        : l.color == 3 ? (l.depth == 1 || l.depth == 2 || l.depth == 4 || l.depth == 8)
                        : (l.color == 2 || l.color == 4 || l.color == 6) && (l.depth == 8 || l.depth == 16);
  if (!depth_ok || body[10] != 0 || body[11] != 0 || body[12] > 1) return kCorrupt;
  if (iw == 0 || ih == 0 || iw > kMaxSide || ih > kMaxSide) return kCorrupt;
  l.channels = channels[l.color];
  l.interlaced = body[12] == 1;
  l.w = (int)iw, l.h = (int)ih;
  if (!out || l.h != *h || l.w != *w) {
    *h = l.h, *w = l.w;
    return kSize;
  }

  uint8_t palette[256][3];
  memset(palette, 0, sizeof(palette));  // indices past the palette read as black, as libpng's
  bool has_palette = false;
  size_t need = 0;  // the inflated bytes: each pass's rows with their filter bytes
  for (int p = 0; p < (l.interlaced ? 7 : 1); p++) {
    int pw, ph;
    pass_size(l, p, &pw, &ph);
    if (pw && ph) need += (size_t)ph * (l.stride(pw) + 1);
  }
  std::vector<uint8_t> raw(need);
  Inflater inf;
  memset(&inf.z, 0, sizeof(inf.z));
  if (inflateInit(&inf.z) != Z_OK) return kNoMemory;
  inf.open = true;
  inf.z.next_out = raw.data();
  inf.z.avail_out = (uInt)need;
  bool seen_idat = false, done = false;
  while (!done) {
    rc = chunk(&body, &len, &type);
    if (rc) return rc;
    switch (type) {
      case 0x504C5445u:  // PLTE
        if (seen_idat) return kCorrupt;
        if (l.color == 3) {
          if (len % 3 || len == 0 || len > 3 * 256) return kCorrupt;
          memcpy(palette, body, len);  // entries past 2^depth are never indexed
          has_palette = true;
        }
        break;
      case 0x49444154u:  // IDAT
        if (l.color == 3 && !has_palette) return kCorrupt;
        seen_idat = true;
        if (inf.z.avail_out) {
          inf.z.next_in = const_cast<uint8_t*>(body);
          inf.z.avail_in = len;
          const int z = inflate(&inf.z, Z_NO_FLUSH);
          if (z == Z_STREAM_END && inf.z.avail_out) return kCorrupt;  // not enough image data
          if (z != Z_OK && z != Z_STREAM_END && z != Z_BUF_ERROR) return kCorrupt;
        }
        break;
      case 0x49454E44u:  // IEND
        done = true;
        break;
      default:
        if (!(type & 0x20000000u)) return kCorrupt;  // an unknown critical chunk
        break;
    }
    if (inf.z.avail_out == 0 && seen_idat) done = true;
    if (pos == size && !done) return kTruncated;
  }
  if (inf.z.avail_out) return seen_idat ? kTruncated : kCorrupt;

  const int bpp = (l.bits() + 7) / 8;
  std::vector<uint8_t> rows;
  const uint8_t* src = raw.data();
  for (int p = 0; p < (l.interlaced ? 7 : 1); p++) {
    int pw, ph;
    pass_size(l, p, &pw, &ph);
    if (!pw || !ph) continue;
    const size_t stride = l.stride(pw);
    // 8-bit RGB, not interlaced: unfilter straight into out
    const bool direct = !l.interlaced && l.color == 2 && l.depth == 8;
    uint8_t* dst = out;
    if (!direct) {
      rows.resize((size_t)ph * stride);
      dst = rows.data();
    }
    if (unfilter_rows(src, ph, (int)stride, bpp, dst) != 0) return kBadFilter;
    src += (size_t)ph * (stride + 1);
    if (direct) continue;
    static constexpr int kWhole[4] = {0, 0, 1, 1};
    const int* a = l.interlaced ? kAdam7[p] : kWhole;
    const int x0 = a[0], y0 = a[1], dx = a[2], dy = a[3];
    for (int y = 0; y < ph; y++)
      expand_row(l, dst + (size_t)y * stride, pw, palette,
                 out + ((size_t)(y0 + y * dy) * l.w + x0) * 3, dx);
  }
  return kOk;
}

}  // namespace

int decode_png(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w) {
  try {
    return decode(data, size, out, h, w);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace byogan
