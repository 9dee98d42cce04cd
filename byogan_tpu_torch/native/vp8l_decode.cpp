// A VP8L (lossless WebP, RFC 9649) decoder: the ARGB pixels libwebp's
// VP8LDecodeImage gives, which are exact by design.
//
// The header (signature 0x2f, 14-bit sizes minus one, the alpha hint,
// version 0); the transforms read in order and undone in reverse
// (predictor with its 14 modes, cross-colour, subtract-green, colour
// indexing with 2, 4 and 16 colours bundled into one pixel); canonical
// Huffman codes, simple (1 or 2 symbols) or normal (code-length codes, the
// repeat codes 16-18, max_symbol), five a group and groups chosen per tile
// by the entropy image; the colour cache; LZ77 copies with the 120
// distance-map codes.  libwebp's rules hold where the RFC leaves room:
// predictor modes 14 and 15 predict black, a colour index past the palette
// gives transparent black, a code with one symbol reads no bits, and a
// stream is at its end only after more bits than it holds, or than 64 for
// a shorter one, have been read.

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "webp.h"

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "the bit reader loads little-endian words");

namespace byogan {
namespace {

// Bits are read least significant first.  Past the end they read as zeros.
class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size), limit_(8 * std::max<size_t>(size, 8)) {}

  // The next 57 bits or more, the next one in bit 0.
  uint64_t window() const {
    const size_t byte = pos_ >> 3;
    uint64_t v = 0;
    if (byte + 8 <= size_) {
      memcpy(&v, data_ + byte, 8);
    } else {
      for (size_t i = byte; i < size_ && i < byte + 8; i++) v |= (uint64_t)data_[i] << (8 * (i - byte));
    }
    return v >> (pos_ & 7);
  }

  uint32_t read(int n) {
    const uint32_t v = (uint32_t)(window() & ((1ull << n) - 1));
    pos_ += n;
    return v;
  }

  void skip(int n) { pos_ += n; }

  // libwebp's end of stream: more bits read than the stream holds.
  bool eos() const { return pos_ > limit_; }

 private:
  const uint8_t* data_;
  size_t size_;
  uint64_t limit_;
  uint64_t pos_ = 0;
};

constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24, kNumDistanceCodes = 40;
constexpr int kMaxCacheBits = 11, kMaxCodeLength = 15, kRootBits = 8;
constexpr uint32_t kLink = 0x80000000u;
const int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, kNumLiteralCodes, kNumLiteralCodes,
                              kNumLiteralCodes, kNumDistanceCodes};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// A canonical Huffman code as a two-level table read by the next bits:
// the root by 8 of them, a leaf holding (length << 16) | symbol, a link
// kLink | (bits of its sub-table << 24) | the sub-table's offset.
struct Huffman {
  std::vector<uint32_t> table;
  int single = -1;  // the symbol of a code with one symbol, which reads no bits

  // Build the code of these lengths; false where they make no code (none,
  // or more than one symbol and the lengths over- or under-fill the tree).
  bool build(const int* lengths, int n) {
    int count[kMaxCodeLength + 1] = {0};
    int used = 0, last = -1;
    for (int s = 0; s < n; s++) {
      if (lengths[s] > kMaxCodeLength) return false;
      if (lengths[s]) {
        count[lengths[s]]++;
        used++;
        last = s;
      }
    }
    if (used == 0) return false;
    table.clear();
    single = -1;
    if (used == 1) {
      single = last;
      return true;
    }
    int left = 1;  // the tree must be full
    for (int len = 1; len <= kMaxCodeLength; len++) {
      left = (left << 1) - count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int next[kMaxCodeLength + 2];
    next[1] = 0;
    for (int len = 1; len <= kMaxCodeLength; len++) next[len + 1] = (next[len] + count[len]) << 1;
    std::vector<uint32_t> rev(n);  // each symbol's code, bit-reversed: the first bit read in bit 0
    int sub_bits[1 << kRootBits] = {0};
    for (int s = 0; s < n; s++) {
      const int len = lengths[s];
      if (!len) continue;
      const uint32_t code = next[len]++;
      uint32_t r = 0;
      for (int i = 0; i < len; i++) r |= ((code >> i) & 1) << (len - 1 - i);
      rev[s] = r;
      if (len > kRootBits) {
        int& b = sub_bits[r & ((1 << kRootBits) - 1)];
        b = std::max(b, len - kRootBits);
      }
    }
    table.assign(1 << kRootBits, 0);
    for (int p = 0; p < (1 << kRootBits); p++) {
      if (!sub_bits[p]) continue;
      table[p] = kLink | (uint32_t)sub_bits[p] << 24 | (uint32_t)table.size();
      table.resize(table.size() + ((size_t)1 << sub_bits[p]), 0);
    }
    for (int s = 0; s < n; s++) {
      const int len = lengths[s];
      if (!len) continue;
      const uint32_t leaf = (uint32_t)len << 16 | (uint32_t)s;
      if (len <= kRootBits) {
        for (uint32_t i = rev[s]; i < (1u << kRootBits); i += 1u << len) table[i] = leaf;
      } else {
        const uint32_t link = table[rev[s] & ((1 << kRootBits) - 1)];
        const int bits = (link >> 24) & 0x7f;
        uint32_t* sub = &table[link & 0xffffff];
        for (uint32_t i = rev[s] >> kRootBits; i < (1u << bits); i += 1u << (len - kRootBits)) sub[i] = leaf;
      }
    }
    return true;
  }

  int read(BitReader& br) const {
    if (single >= 0) return single;
    const uint64_t w = br.window();
    uint32_t e = table[w & ((1 << kRootBits) - 1)];
    if (e & kLink) {
      const int bits = (e >> 24) & 0x7f;
      e = table[(e & 0xffffff) + ((w >> kRootBits) & ((1u << bits) - 1))];
    }
    br.skip(e >> 16);
    return e & 0xffff;
  }
};

struct Group {  // green (+ lengths + cache), red, blue, alpha, distance
  Huffman codes[5];
};

struct Meta {
  int cache_bits = 0;
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;  // each tile's group
  std::vector<Group> groups;
};

enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndexing = 3 };

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline int sub3(int a, int b, int c) { return abs(b - c) - abs(a - c); }

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // a or b
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) + sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) + sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= clip255((uint32_t)(int)(((c0 >> s) & 0xff) + ((c1 >> s) & 0xff) - ((c2 >> s) & 0xff))) << s;
  return out;
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255((uint32_t)(a + (a - b) / 2)) << s;
  }
  return out;
}

// Predictor `mode` of the pixel whose left neighbour is *left and whose
// upper row starts at top (top[-1] upper-left, top[1] upper-right).
inline uint32_t predict(int mode, const uint32_t* left, const uint32_t* top) {
  switch (mode) {
    case 1: return *left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(*left, top[1]), top[0]);
    case 6: return average2(*left, top[-1]);
    case 7: return average2(*left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(*left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], *left, top[-1]);
    case 12: return clamped_add_subtract_full(*left, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(*left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

inline int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : br_(data, size) {}

  void run(const uint8_t* data, size_t size, std::vector<uint32_t>* argb, int* w, int* h) {
    if (const int rc = vp8l_info(data, size, w, h)) webp_fail(rc);
    br_.skip(8 + 14 + 14 + 1 + 3);  // the signature, the sizes, the alpha hint, the version
    std::vector<uint32_t> image = decode_stream(*w, *h, true);
    for (int n = num_transforms_ - 1; n >= 0; n--) image = inverse(transforms_[n], image);
    *argb = std::move(image);
  }

 private:
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    int txsize = xsize;
    if (level0)
      while (br_.read(1)) read_transform(&txsize, ysize);
    Meta meta;
    if (br_.read(1)) {
      meta.cache_bits = (int)br_.read(4);
      if (meta.cache_bits < 1 || meta.cache_bits > kMaxCacheBits) webp_fail(kCorrupt);
    }
    read_huffman_codes(txsize, ysize, level0, &meta);
    std::vector<uint32_t> data((size_t)txsize * ysize);
    decode_pixels(meta, txsize, ysize, data.data());
    return data;
  }

  void read_transform(int* xsize, int ysize) {
    const int type = (int)br_.read(2);
    if (seen_ & (1u << type)) webp_fail(kCorrupt);  // each type at most once
    seen_ |= 1u << type;
    Transform& t = transforms_[num_transforms_++];
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    if (type == kPredictor || type == kCrossColor) {
      t.bits = (int)br_.read(3) + 2;
      t.data = decode_stream(subsample(t.xsize, t.bits), subsample(ysize, t.bits), false);
    } else if (type == kColorIndexing) {
      const int num_colors = (int)br_.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> palette = decode_stream(num_colors, 1, false);
      t.data.assign((size_t)1 << (8 >> t.bits), 0);  // transparent black past the palette
      t.data[0] = palette[0];
      for (int i = 1; i < num_colors; i++) t.data[i] = add_pixels(palette[i], t.data[i - 1]);
    }
  }

  void read_code(int alphabet_size, Huffman* code) {
    std::vector<int> lengths(std::max(alphabet_size, kNumLiteralCodes), 0);
    if (br_.read(1)) {  // simple: one or two symbols of length 1
      const int num_symbols = (int)br_.read(1) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (num_symbols == 2) lengths[br_.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = (int)br_.read(4) + 4;
      for (int i = 0; i < num_codes; i++) cl_lengths[kCodeLengthCodeOrder[i]] = (int)br_.read(3);
      Huffman cl;
      if (!cl.build(cl_lengths, 19)) webp_fail(kCorrupt);
      int max_symbol = alphabet_size;
      if (br_.read(1)) {
        const int length_nbits = 2 + 2 * (int)br_.read(3);
        max_symbol = 2 + (int)br_.read(length_nbits);
        if (max_symbol > alphabet_size) webp_fail(kCorrupt);
      }
      int prev = 8;
      for (int symbol = 0; symbol < alphabet_size;) {
        if (max_symbol-- == 0) break;
        const int len = cl.read(br_);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len) prev = len;
        } else {
          static const int kExtraBits[3] = {2, 3, 7}, kOffsets[3] = {3, 3, 11};
          const int slot = len - 16;
          const int repeat = (int)br_.read(kExtraBits[slot]) + kOffsets[slot];
          if (symbol + repeat > alphabet_size) webp_fail(kCorrupt);
          const int value = len == 16 ? prev : 0;
          for (int i = 0; i < repeat; i++) lengths[symbol++] = value;
        }
      }
    }
    if (br_.eos()) webp_fail(kTruncated);
    if (!code->build(lengths.data(), alphabet_size)) webp_fail(kCorrupt);
  }

  void read_huffman_codes(int xsize, int ysize, bool allow_meta, Meta* meta) {
    int num_groups = 1;
    if (allow_meta && br_.read(1)) {
      meta->huffman_bits = (int)br_.read(3) + 2;
      meta->huffman_xsize = subsample(xsize, meta->huffman_bits);
      meta->huffman_image =
          decode_stream(meta->huffman_xsize, subsample(ysize, meta->huffman_bits), false);
      for (uint32_t& g : meta->huffman_image) {
        g = (g >> 8) & 0xffff;
        num_groups = std::max(num_groups, (int)g + 1);
      }
    }
    if (br_.eos()) webp_fail(kTruncated);
    // Groups no tile uses are read and checked, not kept.
    std::vector<int> slot(num_groups, -1);
    int kept = 0;
    if (meta->huffman_image.empty()) {
      slot[0] = kept++;
    } else {
      for (uint32_t& g : meta->huffman_image) {
        if (slot[g] < 0) slot[g] = kept++;
        g = (uint32_t)slot[g];
      }
    }
    meta->groups.resize(kept);
    Huffman unused;
    for (int i = 0; i < num_groups; i++) {
      for (int j = 0; j < 5; j++) {
        const int size = kAlphabetSize[j] + (j == 0 && meta->cache_bits ? 1 << meta->cache_bits : 0);
        read_code(size, slot[i] >= 0 ? &meta->groups[slot[i]].codes[j] : &unused);
      }
    }
  }

  int copy_distance(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)br_.read(extra) + 1;
  }

  static int plane_to_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int dist_code = kVp8lCodeToPlane[code - 1];
    const int dist = (dist_code >> 4) * xsize + 8 - (dist_code & 0xf);
    return dist >= 1 ? dist : 1;
  }

  void decode_pixels(const Meta& meta, int width, int height, uint32_t* data) {
    const int cache_bits = meta.cache_bits;
    std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
    const int len_limit = kNumLiteralCodes + kNumLengthCodes;
    const int cache_limit = len_limit + (int)cache.size();
    const int hbits = meta.huffman_bits;
    const uint32_t mask = hbits ? (1u << hbits) - 1 : ~0u;
    const size_t total = (size_t)width * height;
    auto group_at = [&](int x, int y) -> const Group* {
      if (!hbits) return &meta.groups[0];
      return &meta.groups[meta.huffman_image[(size_t)meta.huffman_xsize * (y >> hbits) + (x >> hbits)]];
    };
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
    };
    size_t pos = 0;
    int col = 0, row = 0;
    const Group* g = total ? group_at(0, 0) : nullptr;
    while (pos < total) {
      if ((col & mask) == 0) g = group_at(col, row);
      const int code = g->codes[0].read(br_);
      if (code < kNumLiteralCodes || code >= len_limit) {
        uint32_t argb;
        if (code < kNumLiteralCodes) {
          const int red = g->codes[1].read(br_);
          const int blue = g->codes[2].read(br_);
          const int alpha = g->codes[3].read(br_);
          argb = (uint32_t)alpha << 24 | (uint32_t)red << 16 | (uint32_t)code << 8 | (uint32_t)blue;
        } else if (code < cache_limit) {
          argb = cache[code - len_limit];
        } else {
          webp_fail(kCorrupt);
        }
        if (br_.eos()) webp_fail(kTruncated);
        data[pos++] = argb;
        insert(argb);
        if (++col >= width) {
          col = 0;
          row++;
        }
      } else {
        const int length = copy_distance(code - kNumLiteralCodes);
        const int dist = plane_to_distance(width, copy_distance(g->codes[4].read(br_)));
        if (br_.eos()) webp_fail(kTruncated);
        if (pos < (size_t)dist || total - pos < (size_t)length) webp_fail(kCorrupt);
        for (int i = 0; i < length; i++, pos++) {
          data[pos] = data[pos - dist];
          insert(data[pos]);
        }
        col += length;
        while (col >= width) {
          col -= width;
          row++;
        }
        if (col & mask) g = group_at(col, row);
      }
    }
    if (br_.eos()) webp_fail(kTruncated);
  }

  // One transform undone: `in` is its output's input, the image after the
  // transforms read later have been undone.
  static std::vector<uint32_t> inverse(const Transform& t, const std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    std::vector<uint32_t> out((size_t)w * h);
    switch (t.type) {
      case kSubtractGreen:
        for (size_t i = 0; i < out.size(); i++) {
          const uint32_t argb = in[i], green = (argb >> 8) & 0xff;
          out[i] = (argb & 0xff00ff00u) | (((argb & 0x00ff00ffu) + (green << 16 | green)) & 0x00ff00ffu);
        }
        break;
      case kPredictor: {
        const int tiles_per_row = subsample(w, t.bits);
        out[0] = add_pixels(in[0], 0xff000000u);
        for (int x = 1; x < w; x++) out[x] = add_pixels(in[x], out[x - 1]);
        for (int y = 1; y < h; y++) {
          const uint32_t* modes = &t.data[(size_t)(y >> t.bits) * tiles_per_row];
          uint32_t* o = &out[(size_t)y * w];
          const uint32_t* i = &in[(size_t)y * w];
          o[0] = add_pixels(i[0], o[-w]);
          for (int x = 1; x < w; x++) o[x] = add_pixels(i[x], predict((modes[x >> t.bits] >> 8) & 0xf, &o[x - 1], &o[x - w]));
        }
        break;
      }
      case kCrossColor: {
        const int tiles_per_row = subsample(w, t.bits);
        for (int y = 0; y < h; y++) {
          const uint32_t* codes = &t.data[(size_t)(y >> t.bits) * tiles_per_row];
          for (int x = 0; x < w; x++) {
            const uint32_t code = codes[x >> t.bits];
            const uint32_t argb = in[(size_t)y * w + x];
            const int8_t green = (int8_t)(argb >> 8);
            int red = (argb >> 16) & 0xff;
            int blue = argb & 0xff;
            red = (red + color_delta((int8_t)(code & 0xff), green)) & 0xff;
            blue += color_delta((int8_t)((code >> 8) & 0xff), green);
            blue += color_delta((int8_t)((code >> 16) & 0xff), (int8_t)red);
            out[(size_t)y * w + x] = (argb & 0xff00ff00u) | (uint32_t)red << 16 | (uint32_t)(blue & 0xff);
          }
        }
        break;
      }
      case kColorIndexing: {
        const int in_w = subsample(w, t.bits);
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        for (int y = 0; y < h; y++) {
          const uint32_t* src = &in[(size_t)y * in_w];
          uint32_t* dst = &out[(size_t)y * w];
          uint32_t packed = 0;
          for (int x = 0; x < w; x++) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        break;
      }
    }
    return out;
  }

  BitReader br_;
  Transform transforms_[4];
  int num_transforms_ = 0;
  unsigned seen_ = 0;
};

}  // namespace

int vp8l_info(const uint8_t* data, size_t size, int* w, int* h) {
  if (size < 5) return kTruncated;
  if (data[0] != 0x2f || (data[4] >> 5) != 0) return kCorrupt;  // signature, version
  BitReader br(data, size);
  br.read(8);
  *w = (int)br.read(14) + 1;
  *h = (int)br.read(14) + 1;
  return kOk;
}

void vp8l_decode(const uint8_t* data, size_t size, std::vector<uint32_t>* argb, int* w, int* h) {
  Decoder dec(data, size);
  dec.run(data, size, argb, w, h);
}

}  // namespace byogan
