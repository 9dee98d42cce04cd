// A PNG decoder over zlib that gives the JAX package's libpng lane's RGB
// (byogan_tpu/native/byogan_io.cpp:32-91), bit for bit: every colour type
// and depth, Adam7 interlacing, 16-bit samples cut to their high byte,
// palettes and low-depth gray expanded, tRNS and alpha dropped, gray
// repeated into three channels.  In the Pillow lane (kPillowLane) a 16-bit
// gray sample is clipped at 255 instead, as Pillow's I;16 -> RGB does, and
// the chunks are read as PngImagePlugin reads them: every chunk's CRC
// checked before the image data, none of the IDATs', each chunk before
// them through its handler (pillow_chunk: a short or wrong body fails, an
// unknown one is skipped, a name that is not four word characters
// fails), the first 13 bytes of a longer IHDR, the data read as far
// as the image's last byte and ended by any other chunk, then the chunks
// after it up to IEND as load_end reads them (pillow_load_end: a body cut
// short or one a chunk handler refuses fails, the file's end or a chunk
// name that is not four word characters ends the walk); a palette image
// without PLTE reads black, as Pillow's empty palette shows it.  Every
// other kind decodes alike in Pillow and libpng.
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
                int step, Lane lane) {
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
  if (lane == kPillowLane && l.color == 0 && d == 16) {
    for (int x = 0; x < n; x++) {
      const uint8_t* s = row + (size_t)x * 2;
      uint8_t* o = out + (size_t)x * step * 3;
      o[0] = o[1] = o[2] = s[0] ? 255 : s[1];  // min(sample, 255)
    }
    return;
  }
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

// Pillow's _safe_zlib_decompress (MAX_TEXT_CHUNK, 1 MiB): fails where the
// text or profile inflates past 1 MiB with input left over; a zlib error
// is no failure (the handler drops the text).
bool inflates_too_large(const uint8_t* in, size_t n) {
  z_stream z;
  memset(&z, 0, sizeof(z));
  if (inflateInit(&z) != Z_OK) return false;
  std::vector<uint8_t> out(1 << 20);
  z.next_in = const_cast<uint8_t*>(in);
  z.avail_in = (uInt)n;
  z.next_out = out.data();
  z.avail_out = (uInt)out.size();
  int rc;
  do {
    rc = inflate(&z, Z_SYNC_FLUSH);
  } while (rc == Z_OK && z.avail_out > 0 && z.avail_in > 0);
  const bool too_large = (rc == Z_OK || rc == Z_BUF_ERROR) && z.avail_out == 0 && z.avail_in > 0;
  inflateEnd(&z);
  return too_large;
}

// What PngImagePlugin knows of the file when its image data end: the
// IHDR's mode (bit depth, colour type), its size, and the APNG state.
struct PillowState {
  int depth, color;
  uint32_t w, h;
  bool animated = false;
  int64_t seq = -1;  // _seq_num; -1: None
};

bool word(uint8_t c) { return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') || c == '_'; }

// The chunk handler PngStream.chunk_<type> on a whole body s of len bytes,
// as PngImageFile._open (before the image data) and load_end (after them)
// call it: kPngChunkRefused where it raises (a short IHDR, gAMA, cHRM,
// sRGB, pHYs, tRNS, acTL or fcTL, a filter method, a compression method,
// text inflating past 1 MiB, an APNG sequence or frame error), else kOk;
// IHDR and fcTL update st.  PLTE, IDAT, fdAT, tEXt, eXIf and unknown
// chunks only have their body read.
int pillow_chunk(uint32_t type, const uint8_t* s, uint32_t len, PillowState& st) {
  auto need = [&](uint32_t n) { return len < n ? kPngChunkRefused : kOk; };
  switch (type) {
    case 0x49484452u:  // IHDR
      if (len < 13) return kPngChunkRefused;
      if (s[11]) return kPngChunkRefused;  // "unknown filter category"
      {
        const int d = s[8], c = s[9];
        const bool known = (c == 0 && (d == 1 || d == 2 || d == 4 || d == 8 || d == 16)) ||
                           (c == 3 && (d == 1 || d == 2 || d == 4 || d == 8)) ||
                           ((c == 2 || c == 4 || c == 6) && (d == 8 || d == 16));
        if (known) st.depth = d, st.color = c;
        st.w = be32(s), st.h = be32(s + 4);
      }
      return kOk;
    case 0x74524E53u:  // tRNS: one 16-bit value of gray, three of RGB
      if (st.color == 0) return need(2);
      if (st.color == 2) return need(6);
      return kOk;
    case 0x67414D41u: return need(4);  // gAMA
    case 0x6348524Du: return len % 4 ? kPngChunkRefused : kOk;  // cHRM: struct.unpack of whole words
    case 0x73524742u: return need(1);  // sRGB
    case 0x70485973u: return need(9);  // pHYs
    case 0x6163544Cu: return need(8);  // acTL
    case 0x69434350u: {  // iCCP: the byte after the name's NUL, which must be 0, then the profile
      const uint8_t* nul = (const uint8_t*)memchr(s, 0, len);
      const size_t i = nul ? (size_t)(nul - s) + 1 : 0;
      if (i >= len) return kPngChunkRefused;  // IndexError
      if (s[i] != 0) return kPngChunkRefused;
      return inflates_too_large(s + i + 1, len - i - 1) ? kPngChunkRefused : kOk;
    }
    case 0x7A545874u: {  // zTXt
      const uint8_t* nul = (const uint8_t*)memchr(s, 0, len);
      if (nul && (size_t)(nul - s) + 1 < len) {
        const size_t i = (size_t)(nul - s) + 1;
        if (s[i] != 0) return kPngChunkRefused;
        if (inflates_too_large(s + i + 1, len - i - 1)) return kPngChunkRefused;
      }
      return kOk;
    }
    case 0x69545874u: {  // iTXt: keyword, flag, method, language, translated keyword, text
      const uint8_t* e = s + len;
      const uint8_t* p = (const uint8_t*)memchr(s, 0, len);
      if (!p || e - (p + 1) < 2) return kOk;
      const int flag = p[1], method = p[2];
      p += 3;
      for (int k = 0; k < 2 && p; k++) {
        const uint8_t* q = (const uint8_t*)memchr(p, 0, e - p);
        p = q ? q + 1 : nullptr;
      }
      return p && flag != 0 && method == 0 && inflates_too_large(p, e - p) ? kPngChunkRefused : kOk;
    }
    case 0x6663544Cu: {  // fcTL
      if (len < 26) return kPngChunkRefused;
      const int64_t seq = be32(s);
      if ((st.seq < 0 && seq != 0) || (st.seq >= 0 && st.seq != seq - 1)) return kPngChunkRefused;
      st.seq = seq;
      if ((uint64_t)be32(s + 12) + be32(s + 4) > st.w || (uint64_t)be32(s + 16) + be32(s + 8) > st.h)
        return kPngChunkRefused;  // "APNG contains invalid frames"
      return kOk;
    }
    default:
      return kOk;
  }
}

// PngImageFile.load_end from `pos` (after the last image IDAT's body and
// CRC): each chunk's handler (pillow_chunk) or, for an unknown name, a
// _safe_read of its body; the CRCs are read, never checked.  Fails with
// kPngChunkCut where a body runs past the file's end ("Truncated File
// Read") and kPngChunkRefused where a handler raises (an fdAT out of
// sequence too).
int pillow_load_end(const uint8_t* data, size_t size, size_t pos, PillowState st) {
  while (true) {
    if (pos >= size || size - pos < 8) return kOk;  // struct.error or a short name: the walk ends
    const uint32_t len = be32(data + pos);
    const uint8_t* id = data + pos + 4;
    if (!(word(id[0]) && word(id[1]) && word(id[2]) && word(id[3]))) return kOk;  // "broken PNG file"
    const uint32_t type = be32(id);
    if (type == 0x49454E44u) return kOk;  // IEND
    if (type == 0x6663544Cu && st.animated) return kOk;  // fcTL: the next frame's
    const size_t at = pos + 8;
    const uint8_t* s = data + at;
    if (type == 0x66644154u) {  // fdAT: its sequence number, then the data skipped as an IDAT's
      if (len < 4) return kPngChunkRefused;
      if (size - at < 4) return kPngChunkCut;
      if (st.seq < 0 || st.seq != (int64_t)be32(s) - 1) return kPngChunkRefused;  // None != seq - 1
      st.seq = be32(s);
    }
    if (size - at < len) return kPngChunkCut;  // every handler reads the whole body first
    const int rc = pillow_chunk(type, s, len, st);
    if (rc) return rc;
    pos = at + len + 4;
  }
}

struct Inflater {
  z_stream z;
  bool open = false;
  ~Inflater() {
    if (open) inflateEnd(&z);
  }
};

int decode(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w, Lane lane) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (size < 8 || memcmp(data, sig, 8) != 0) return kNotImage;
  size_t pos = 8;
  // chunk at pos: its body, length and type; kTruncated past the end
  auto chunk = [&](const uint8_t** body, uint32_t* len, uint32_t* type) {
    if (size - pos < 12) return kTruncated;
    *len = be32(data + pos);
    *type = be32(data + pos + 4);
    if (*len > 0x7FFFFFFFu || size - pos - 12 < *len) return kTruncated;
    // libpng's png_check_chunk_name: four ASCII letters (Pillow's walk tests word characters itself)
    for (int k = 4; k < 8 && lane != kPillowLane; k++) {
      const uint8_t c = data[pos + k] & 0xDF;
      if (c < 'A' || c > 'Z') return kCorrupt;
    }
    *body = data + pos + 8;
    // libpng checks the critical chunks' CRCs; Pillow every chunk's before its image data
    const bool checked = !(data[pos + 4] & 0x20) || lane == kPillowLane;
    if (checked && (uint32_t)crc32(0, data + pos + 4, *len + 4) != be32(data + pos + 8 + *len)) return kBadCrc;
    pos += 12 + (size_t)*len;
    return kOk;
  };
  const uint8_t* body;
  uint32_t len, type;
  int rc = chunk(&body, &len, &type);
  if (rc) return rc;
  // IHDR first: libpng's of 13 bytes; Pillow reads the first 13 of a longer one (a shorter one fails its handler)
  if (type != 0x49484452u || len < 13 || (len != 13 && lane != kPillowLane)) return kCorrupt;
  Layout l;
  const uint32_t iw = be32(body), ih = be32(body + 4);
  l.depth = body[8], l.color = body[9];
  static const int channels[7] = {1, 0, 3, 1, 2, 0, 4};
  const bool depth_ok = l.color == 0   ? (l.depth == 1 || l.depth == 2 || l.depth == 4 || l.depth == 8 || l.depth == 16)
                        : l.color == 3 ? (l.depth == 1 || l.depth == 2 || l.depth == 4 || l.depth == 8)
                        : (l.color == 2 || l.color == 4 || l.color == 6) && (l.depth == 8 || l.depth == 16);
  // Pillow never reads the compression method (its zip decoder inflates whatever it says)
  if (!depth_ok || (body[10] != 0 && lane != kPillowLane) || body[11] != 0 || body[12] > 1) return kCorrupt;
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
  constexpr uint32_t kIdat = 0x49444154u;
  auto feed = [&](const uint8_t* in, size_t n) -> int {  // an IDAT's bytes into the inflater
    if (!inf.z.avail_out) return kOk;
    inf.z.next_in = const_cast<uint8_t*>(in);
    inf.z.avail_in = (uInt)n;
    const int z = inflate(&inf.z, Z_NO_FLUSH);
    if (z == Z_STREAM_END && inf.z.avail_out) return kCorrupt;  // not enough image data
    if (z != Z_OK && z != Z_STREAM_END && z != Z_BUF_ERROR) return kCorrupt;
    return kOk;
  };
  bool seen_idat = false, done = false;
  // the APNG state PngImageFile._open leaves: acTL's frame count, the last fcTL's sequence number
  bool frames_set = false, fctl_seen = false;
  uint32_t frames = 0;
  PillowState st{l.depth, l.color, iw, ih};
  while (!done) {
    if (lane == kPillowLane && (seen_idat || (size - pos >= 8 && be32(data + pos + 4) == kIdat))) {
      // Pillow's reading of the image data (PngImageFile.load_read): each IDAT's body as far as the file
      // holds it, its CRC skipped unread, then the next chunk's header; the data end at any other chunk or
      // at the file's end; then load_end reads the rest of the IDAT that held the image's last byte, its
      // CRC and the chunks after it
      if (seen_idat) pos += std::min<size_t>(4, size - pos);
      if (size - pos < 8 || be32(data + pos + 4) != kIdat) return kTruncated;
      len = be32(data + pos);
      const size_t held = std::min<size_t>(len, size - pos - 8);
      rc = feed(data + pos + 8, held);
      if (rc) return rc;
      const size_t after = pos + 8 + (size_t)len + 4;
      pos += 8 + held;
      seen_idat = true;
      if (!inf.z.avail_out) {
        // n_frames counts the IDAT image where no fcTL came before it
        st.animated = frames_set && (uint64_t)frames + (fctl_seen ? 0 : 1) > 1;
        rc = pillow_load_end(data, size, after, st);
        if (rc) return rc;
        break;
      }
      if (held < len) return kTruncated;
      continue;
    }
    rc = chunk(&body, &len, &type);
    if (rc) return rc;
    if (lane == kPillowLane) {
      // PngImageFile._open's walk: a name of four word characters, then the chunk's handler
      const uint8_t* id = body - 4;
      if (!(word(id[0]) && word(id[1]) && word(id[2]) && word(id[3]))) return kPngChunkRefused;
      rc = pillow_chunk(type, body, len, st);
      if (rc) return rc;
    }
    switch (type) {
      case 0x504C5445u:  // PLTE
        if (seen_idat) return kCorrupt;
        if (l.color == 3) {
          if (len % 3 || len == 0 || len > 3 * 256) return kCorrupt;
          memcpy(palette, body, len);  // entries past 2^depth are never indexed
          has_palette = true;
        }
        break;
      case kIdat:  // the native lane's (libpng's): a palette image needs its PLTE
        if (l.color == 3 && !has_palette) return kCorrupt;
        seen_idat = true;
        rc = feed(body, len);
        if (rc) return rc;
        break;
      case 0x49454E44u:  // IEND
        done = true;
        break;
      case 0x6163544Cu:  // acTL: a second one leaves no frame count (PngStream.chunk_acTL)
        if (len >= 8) {
          const uint32_t n = be32(body);
          if (frames_set) frames_set = false;
          else if (n != 0 && n <= 0x80000000u) frames_set = true, frames = n;
        }
        break;
      case 0x6663544Cu:  // fcTL (its sequence number kept by pillow_chunk)
        fctl_seen = true;
        break;
      default:  // an unknown critical chunk: libpng fails, Pillow reads past its body
        if (!(type & 0x20000000u) && lane != kPillowLane) return kCorrupt;
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
                 out + ((size_t)(y0 + y * dy) * l.w + x0) * 3, dx, lane);
  }
  return kOk;
}

}  // namespace

int decode_png(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w, Lane lane) {
  try {
    return decode(data, size, out, h, w, lane);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace byogan
