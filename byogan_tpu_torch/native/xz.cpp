// An .xz stream decoder for LZMA-compressed TIFF strips and tiles
// (compression 34925), as libtiff 4.7.1's tif_lzma.c drives liblzma 5.8.2's
// stream decoder (lzma_stream_decoder with no flags): the stream header,
// each block's header (its sizes where it records them, its filter chain),
// the LZMA2 chunks (dictionary resets, uncompressed chunks, property and
// state resets), the Delta filter before LZMA2 where a block names it, the
// block's padding and check (none, CRC32, CRC64, SHA-256; an unknown check
// kind skipped unverified, as liblzma skips it without LZMA_TELL_ flags),
// then the index and the stream footer.
//
// libtiff's LZMADecode calls lzma_code until the strip's buffer is full,
// the stream ends or an error is returned, and fails only where the buffer
// is not full by then: so an error liblzma finds once the last byte is out
// (a bad check, index or footer after the strip's data) leaves the strip
// read, and a stream that ends short of the strip fails it.  xz_decode
// (a strip's size) follows that loop; kWholeStream decodes a whole stream and
// verifies all of it, as lzma_code does to LZMA_STREAM_END.
//
// What liblzma checks on the way and this decoder follows, since on bad
// data it decides where a strip fails: the range coder's first byte 0, a
// match distance at or past the dictionary's filled part (capped at the
// dictionary's size rounded up to 16 bytes, 4096 at least), a repeated
// match in an empty dictionary, an end marker inside a chunk of known size,
// a chunk whose range coder is not finished at its end or whose compressed
// size is not what its header says (checked, as liblzma checks it, where
// the decode returns: the chunk's end, or the edge of liblzma's circular
// dictionary buffer), a match past its chunk's end, a control byte out of
// order, and the block header's sizes.  The BCJ filters, which liblzma
// decodes and libtiff never writes, are refused by name (kXzFilter).

#include <zlib.h>

#include <cstring>
#include <new>
#include <vector>

#include "codec.h"

namespace byogan {
namespace {

struct Stop {
  int code;  // kOk: the strip's buffer is full
};
[[noreturn]] void fail(int code) { throw Stop{code}; }

// CRC64 of ECMA-182 (reflected), as liblzma's lzma_crc64.
uint64_t crc64(const uint8_t* p, size_t n) {
  static uint64_t table[256];
  static bool made = [] {
    for (int i = 0; i < 256; i++) {
      uint64_t c = (uint64_t)i;
      for (int k = 0; k < 8; k++) c = c & 1 ? (c >> 1) ^ 0xC96C5795D7870F42ull : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)made;
  uint64_t crc = ~0ull;
  for (size_t i = 0; i < n; i++) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// SHA-256 (FIPS 180-4).
void sha256(const uint8_t* p, size_t n, uint8_t out[32]) {
  static const uint32_t k[64] = {
      0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98,
      0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
      0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152, 0xa831c66d, 0xb00327c8,
      0xbf597fc7, 0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
      0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
      0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
      0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7,
      0xc67178f2};
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  auto rotr = [](uint32_t x, int r) { return x >> r | x << (32 - r); };
  std::vector<uint8_t> m(p, p + n);
  m.push_back(0x80);
  while (m.size() % 64 != 56) m.push_back(0);
  for (int i = 7; i >= 0; i--) m.push_back((uint8_t)((uint64_t)n * 8 >> (8 * i)));
  for (size_t at = 0; at < m.size(); at += 64) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t)m[at + 4 * i] << 24 | m[at + 4 * i + 1] << 16 | m[at + 4 * i + 2] << 8 | m[at + 4 * i + 3];
    for (int i = 16; i < 64; i++) {
      const uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      const uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      const uint32_t t1 = hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + k[i] + w[i];
      const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
      hh = g, g = f, f = e, e = d + t1, d = c, c = b, b = a, a = t1 + t2;
    }
    h[0] += a, h[1] += b, h[2] += c, h[3] += d, h[4] += e, h[5] += f, h[6] += g, h[7] += hh;
  }
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 4; j++) out[4 * i + j] = (uint8_t)(h[i] >> (24 - 8 * j));
}

inline uint32_t le32(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24; }

constexpr uint64_t kUnknown = ~0ull;
constexpr size_t kRepeatMax = 288;  // liblzma's LZ_DICT_REPEAT_MAX; a reset puts the buffer at twice it

// The range decoder over in[pos, end): end is the block's input limit.
struct Rc {
  const uint8_t* in;
  size_t pos, end;
  uint32_t range = 0, code = 0;
  bool init_needed = false;  // an LZMA chunk's first five bytes are still to read
  uint8_t next() {
    if (pos >= end) fail(kTruncated);
    return in[pos++];
  }
  void init() {
    if (next() != 0) fail(kCorrupt);
    code = 0;
    for (int i = 0; i < 4; i++) code = code << 8 | next();
    range = 0xFFFFFFFFu;
  }
  void normalize() {
    if (range < (1u << 24)) {
      range <<= 8;
      code = code << 8 | next();
    }
  }
  int bit(uint16_t& p) {
    normalize();
    const uint32_t bound = (range >> 11) * p;
    if (code < bound) {
      range = bound;
      p += (2048 - p) >> 5;
      return 0;
    }
    range -= bound;
    code -= bound;
    p -= p >> 5;
    return 1;
  }
  uint32_t tree(uint16_t* probs, int bits) {
    uint32_t m = 1;
    for (int i = 0; i < bits; i++) m = m << 1 | bit(probs[m]);
    return m - (1u << bits);
  }
  uint32_t reverse(uint16_t* probs, int bits) {
    uint32_t m = 1, sym = 0;
    for (int i = 0; i < bits; i++) {
      const int b = bit(probs[m]);
      m = m << 1 | b;
      sym |= (uint32_t)b << i;
    }
    return sym;
  }
  uint32_t direct(int bits) {
    uint32_t r = 0;
    for (int i = 0; i < bits; i++) {
      normalize();
      range >>= 1;
      code -= range;
      const uint32_t t = 0u - (code >> 31);
      code += range & t;
      r = (r << 1) + (t + 1);
    }
    return r;
  }
};

struct LenCoder {
  uint16_t choice, choice2, low[16][8], mid[16][8], high[256];
  uint32_t decode(Rc& rc, int ps) {
    if (!rc.bit(choice)) return 2 + rc.tree(low[ps], 3);
    if (!rc.bit(choice2)) return 10 + rc.tree(mid[ps], 3);
    return 18 + rc.tree(high, 8);
  }
};

// LZMA2 (lzma2_decoder.c over lzma_decoder.c and lz_decoder.c) into raw,
// the block's filtered-out bytes.
class Lzma2 {
 public:
  Lzma2(const uint8_t* in, size_t pos, size_t end, uint32_t dict_size) {
    rc_.in = in;
    rc_.pos = pos;
    rc_.end = end;
    size_t d = dict_size < 4096 ? 4096 : dict_size;
    cap_ = (d + 15) & ~(size_t)15;
    alloc_ = cap_ + 2 * kRepeatMax;
  }
  size_t pos() const { return rc_.pos; }

  // Where the block's uncompressed size is reached short of the strip's
  // end: the chunk must end there and the end marker follow, or the block
  // decoder fails.
  void finish() {
    if (overread_ || chunk_left_ != 0) fail(kCorrupt);
    if (in_chunk_) end_chunk();
    if (rc_.next() != 0) fail(kCorrupt);
  }

  // Decodes until the LZMA2 data end (true) or raw holds `limit` bytes (false).
  bool run(std::vector<uint8_t>* raw, size_t limit) {
    raw_ = raw;
    while (true) {
      if (raw_->size() >= limit) return false;
      if (chunk_left_ == 0) {
        if (in_chunk_) end_chunk();
        if (control()) return true;
        continue;
      }
      // one return of liblzma's lz decoder: as far as the output, the chunk's end or the dictionary buffer's edge
      size_t room = limit - raw_->size();
      if (dict_pos_ == alloc_) dict_pos_ = kRepeatMax;
      room = room < alloc_ - dict_pos_ ? room : alloc_ - dict_pos_;
      const size_t part = chunk_left_ < room ? chunk_left_ : room;
      const size_t before = raw_->size(), in_before = rc_.pos;
      if (lzma_chunk_) decode(before + part);
      else copy(part);
      const size_t made = raw_->size() - before;
      dict_pos_ += made;
      chunk_left_ -= made;
      if (lzma_chunk_) {
        // lzma2_decode's "in_used > compressed_size" at each return
        const size_t used = rc_.pos - in_before;
        if (used > packed_left_) {
          if (raw_->size() < limit) fail(kCorrupt);
          overread_ = true;  // an error only where the strip's buffer is not full by now
          return false;
        }
        packed_left_ -= used;
      }
    }
  }

 private:
  Rc rc_;
  std::vector<uint8_t>* raw_ = nullptr;
  size_t cap_, alloc_, dict_pos_ = 0;
  size_t reset_at_ = 0;  // raw's size at the last dictionary reset
  bool need_dict_reset_ = true, need_props_ = true;
  bool in_chunk_ = false, lzma_chunk_ = false;
  size_t chunk_left_ = 0, packed_left_ = 0;
  bool overread_ = false;
  uint32_t pending_ = 0;  // a match's bytes still to copy
  int lc_ = 0, lp_ = 0, pb_ = 0;
  int state_ = 0;
  uint32_t rep_[4] = {0, 0, 0, 0};
  uint16_t is_match_[12][16], is_rep_[12], is_rep0_[12], is_rep1_[12], is_rep2_[12], is_rep0_long_[12][16];
  uint16_t dist_slot_[4][64], dist_special_[114], dist_align_[16];
  LenCoder match_len_, rep_len_;
  std::vector<uint16_t> literal_;

  size_t full() const {
    const size_t made = raw_->size() - reset_at_;
    return made < cap_ ? made : cap_;
  }

  void reset_state() {
    auto fill = [](uint16_t* p, size_t n) {
      for (size_t i = 0; i < n; i++) p[i] = 1024;
    };
    fill(&is_match_[0][0], 12 * 16);
    fill(is_rep_, 12);
    fill(is_rep0_, 12);
    fill(is_rep1_, 12);
    fill(is_rep2_, 12);
    fill(&is_rep0_long_[0][0], 12 * 16);
    fill(&dist_slot_[0][0], 4 * 64);
    fill(dist_special_, 114);
    fill(dist_align_, 16);
    fill(reinterpret_cast<uint16_t*>(&match_len_), sizeof(LenCoder) / 2);
    fill(reinterpret_cast<uint16_t*>(&rep_len_), sizeof(LenCoder) / 2);
    literal_.assign((size_t)0x300 << (lc_ + lp_), 1024);
    state_ = 0;
    rep_[0] = rep_[1] = rep_[2] = rep_[3] = 0;
    pending_ = 0;
  }

  // An LZMA chunk's end: the range decoder finished and its bytes all used.
  void end_chunk() {
    in_chunk_ = false;
    if (!lzma_chunk_) return;
    if (pending_) fail(kCorrupt);  // a match past the chunk's end
    const size_t before = rc_.pos;
    rc_.normalize();
    if (rc_.code != 0) fail(kCorrupt);
    const size_t used = rc_.pos - before;
    if (used > packed_left_ || packed_left_ - used != 0) fail(kCorrupt);
    packed_left_ = 0;
  }

  // The next chunk's header; true at the end marker.
  bool control() {
    const uint32_t c = rc_.next();
    if (c == 0) return true;
    if (c >= 0xE0 || c == 1) {
      need_props_ = true;
      need_dict_reset_ = true;
    } else if (need_dict_reset_) {
      fail(kCorrupt);
    }
    if (c >= 0x80) {
      size_t u = (size_t)(c & 0x1F) << 16;
      u += (size_t)rc_.next() << 8;
      u += rc_.next() + 1u;
      size_t p = (size_t)rc_.next() << 8;
      p += rc_.next() + 1u;
      if (c >= 0xC0) {
        need_props_ = false;
        uint32_t b = rc_.next();
        if (b > (4 * 5 + 4) * 9 + 8) fail(kCorrupt);
        pb_ = (int)(b / 45);
        b -= (uint32_t)pb_ * 45;
        lp_ = (int)(b / 9);
        lc_ = (int)(b - (uint32_t)lp_ * 9);
        if (lc_ + lp_ > 4) fail(kCorrupt);
        reset_state();
      } else if (need_props_) {
        fail(kCorrupt);
      } else if (c >= 0xA0) {
        reset_state();
      }
      chunk_left_ = u;  // the properties byte is no part of the chunk's compressed size
      packed_left_ = p;
      lzma_chunk_ = true;
      pending_ = 0;
      rc_.init_needed = true;
    } else {
      if (c > 2) fail(kCorrupt);
      size_t p = (size_t)rc_.next() << 8;
      p += rc_.next() + 1u;
      chunk_left_ = p;
      lzma_chunk_ = false;
    }
    if (need_dict_reset_) {
      need_dict_reset_ = false;
      reset_at_ = raw_->size();
      dict_pos_ = 2 * kRepeatMax;
    }
    in_chunk_ = true;
    return false;
  }

  void copy(size_t n) {
    if (rc_.end - rc_.pos < n) fail(kTruncated);
    raw_->insert(raw_->end(), rc_.in + rc_.pos, rc_.in + rc_.pos + n);
    rc_.pos += n;
  }

  uint8_t back(uint32_t dist) const { return (*raw_)[raw_->size() - 1 - dist]; }

  void put_match(size_t stop) {
    while (pending_ && raw_->size() < stop) {
      raw_->push_back(back(rep_[0]));
      pending_--;
    }
  }

  // lzma_decode up to raw's size `stop`.
  void decode(size_t stop) {
    if (rc_.init_needed) {
      rc_.init();
      rc_.init_needed = false;
    }
    put_match(stop);
    const uint32_t pb_mask = (1u << pb_) - 1, lp_mask = (1u << lp_) - 1;
    while (raw_->size() < stop) {
      const size_t at = raw_->size() - reset_at_;
      const uint32_t ps = (uint32_t)at & pb_mask;
      if (!rc_.bit(is_match_[state_][ps])) {
        const uint32_t prev = at ? raw_->back() : 0;
        uint16_t* probs = literal_.data() + 0x300 * ((((uint32_t)at & lp_mask) << lc_) + (prev >> (8 - lc_)));
        uint32_t sym = 1;
        if (state_ < 7) {
          while (sym < 0x100) sym = sym << 1 | rc_.bit(probs[sym]);
        } else {
          uint32_t match_byte = (uint32_t)back(rep_[0]) << 1, offset = 0x100;
          do {
            const uint32_t match_bit = match_byte & offset;
            match_byte <<= 1;
            if (rc_.bit(probs[offset + match_bit + sym])) {
              sym = sym << 1 | 1;
              offset = match_bit;
            } else {
              sym <<= 1;
              offset ^= match_bit;
            }
          } while (sym < 0x100);
        }
        raw_->push_back((uint8_t)sym);
        state_ = state_ < 4 ? 0 : state_ < 10 ? state_ - 3 : state_ - 6;
        continue;
      }
      uint32_t len;
      if (!rc_.bit(is_rep_[state_])) {  // a match: length, then distance
        state_ = state_ < 7 ? 7 : 10;
        len = match_len_.decode(rc_, (int)ps);
        const int ls = len < 6 ? (int)len - 2 : 3;
        const uint32_t slot = rc_.tree(dist_slot_[ls], 6);
        uint32_t dist;
        if (slot < 4) {
          dist = slot;
        } else {
          const int direct = (int)(slot >> 1) - 1;
          dist = (2 | (slot & 1)) << direct;
          if (slot < 14) {
            dist += rc_.reverse(dist_special_ + dist - slot - 1, direct);
          } else {
            dist += rc_.direct(direct - 4) << 4;
            dist += rc_.reverse(dist_align_, 4);
          }
        }
        rep_[3] = rep_[2];
        rep_[2] = rep_[1];
        rep_[1] = rep_[0];
        rep_[0] = dist;
        if (dist == 0xFFFFFFFFu) fail(kCorrupt);  // an end marker in a chunk of known size
        if (dist >= full()) fail(kCorrupt);
      } else {
        if (full() == 0) fail(kCorrupt);  // a repeated match in an empty dictionary
        if (!rc_.bit(is_rep0_[state_])) {
          if (!rc_.bit(is_rep0_long_[state_][ps])) {  // a short repeat: one byte
            state_ = state_ < 7 ? 9 : 11;
            raw_->push_back(back(rep_[0]));
            continue;
          }
        } else {
          uint32_t d;
          if (!rc_.bit(is_rep1_[state_])) {
            d = rep_[1];
          } else {
            if (!rc_.bit(is_rep2_[state_])) {
              d = rep_[2];
            } else {
              d = rep_[3];
              rep_[3] = rep_[2];
            }
            rep_[2] = rep_[1];
          }
          rep_[1] = rep_[0];
          rep_[0] = d;
        }
        state_ = state_ < 7 ? 8 : 11;
        len = rep_len_.decode(rc_, (int)ps);
      }
      pending_ = len;
      put_match(stop);
    }
  }
};

// A variable-length integer of the .xz format at in[*p, end).
uint64_t vli(const uint8_t* in, size_t* p, size_t end) {
  uint64_t v = 0;
  for (int i = 0; i < 9; i++) {
    if (*p >= end) fail(kCorrupt);
    const uint8_t b = in[(*p)++];
    if (b == 0 && i > 0) fail(kCorrupt);  // not the shortest encoding
    v |= (uint64_t)(b & 0x7F) << (7 * i);
    if (!(b & 0x80)) return v;
  }
  fail(kCorrupt);
}

constexpr int kCheckSize[16] = {0, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64};

class Xz {
 public:
  Xz(const uint8_t* in, size_t n, size_t occ) : in_(in), n_(n), occ_(occ) {}

  // Decodes into out: up to occ bytes (a strip's: Stop{kOk} once full) or
  // the whole stream (kUnknown).
  void run(std::vector<uint8_t>* out) {
    out_ = out;
    static const uint8_t magic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
    if (n_ < 12) fail(kTruncated);
    if (memcmp(in_, magic, 6) != 0) fail(kCorrupt);
    if ((uint32_t)crc32(0, in_ + 6, 2) != le32(in_ + 8)) fail(kCorrupt);
    if (in_[6] != 0 || (in_[7] & 0xF0)) fail(kCorrupt);
    flags_[0] = in_[6], flags_[1] = in_[7];
    check_ = in_[7] & 15;
    ip_ = 12;
    while (true) {
      if (ip_ >= n_) fail(kTruncated);
      if (in_[ip_] == 0) break;
      block();
    }
    if (occ_ != kUnknown) fail(kTruncated);  // the stream ends short of the strip: "Not enough data"
    index();
  }

 private:
  const uint8_t* in_;
  size_t n_, ip_ = 0;
  uint64_t occ_;
  std::vector<uint8_t>* out_ = nullptr;
  uint8_t flags_[2];
  int check_ = 0;
  std::vector<std::pair<uint64_t, uint64_t>> records_;  // (unpadded size, uncompressed size)

  void block() {
    const size_t hsize = ((size_t)in_[ip_] + 1) * 4;
    if (n_ - ip_ < hsize) fail(kTruncated);
    if ((uint32_t)crc32(0, in_ + ip_, (uInt)(hsize - 4)) != le32(in_ + ip_ + hsize - 4)) fail(kCorrupt);
    const uint8_t flags = in_[ip_ + 1];
    if (flags & 0x3C) fail(kCorrupt);
    size_t p = ip_ + 2;
    const size_t hend = ip_ + hsize - 4;
    const uint64_t csize = flags & 0x40 ? vli(in_, &p, hend) : kUnknown;
    const uint64_t usize = flags & 0x80 ? vli(in_, &p, hend) : kUnknown;
    if (csize == 0) fail(kCorrupt);
    const int nf = (flags & 3) + 1;
    uint64_t ids[4];
    int deltas[4];
    uint32_t dict = 0;
    bool bcj = false;
    for (int i = 0; i < nf; i++) {
      ids[i] = vli(in_, &p, hend);
      const uint64_t psize = vli(in_, &p, hend);
      if (psize > hend - p) fail(kCorrupt);
      const uint8_t* props = in_ + p;
      p += psize;
      const bool last = i == nf - 1;
      if (ids[i] == 0x21) {  // LZMA2: one byte, the dictionary's size
        if (!last || psize != 1 || props[0] > 40) fail(kCorrupt);
        dict = props[0] == 40 ? 0xFFFFFFFFu : (2u | (props[0] & 1)) << (props[0] / 2 + 11);
      } else if (ids[i] == 0x03) {  // Delta: one byte, the distance less 1
        if (last || psize != 1) fail(kCorrupt);
        deltas[i] = props[0] + 1;
      } else if (ids[i] >= 0x04 && ids[i] <= 0x0B) {  // BCJ: x86, PowerPC, IA-64, ARM, ARM-Thumb, SPARC, ARM64, RISC-V
        if (last || (psize != 0 && psize != 4)) fail(kCorrupt);
        bcj = true;
      } else {
        fail(kCorrupt);  // an unknown filter
      }
    }
    for (; p < hend; p++)
      if (in_[p] != 0) fail(kCorrupt);
    if (bcj) fail(kXzFilter);
    ip_ += hsize;
    const size_t data = ip_;
    const size_t in_stop = csize != kUnknown && csize < n_ - data ? data + (size_t)csize : n_;
    Lzma2 lz(in_, data, in_stop, dict);
    std::vector<uint8_t> raw;
    const size_t room = occ_ == kUnknown ? SIZE_MAX : (size_t)occ_ - out_->size();
    const size_t limit = usize != kUnknown && usize < room ? (size_t)usize : room;
    const bool ended = lz.run(&raw, limit);
    // the filters before LZMA2, last first: Delta adds the byte `distance` before it in its own output
    for (int i = nf - 2; i >= 0; i--) {
      const size_t d = (size_t)deltas[i];
      for (size_t k = d; k < raw.size(); k++) raw[k] = (uint8_t)(raw[k] + raw[k - d]);
    }
    const size_t first = out_->size();
    out_->insert(out_->end(), raw.begin(), raw.end());
    if (occ_ != kUnknown && out_->size() == occ_) throw Stop{kOk};
    if (!ended) lz.finish();  // the block's recorded uncompressed size reached
    const uint64_t cs = lz.pos() - data;
    if ((csize != kUnknown && cs != csize) || (usize != kUnknown && raw.size() != usize)) fail(kCorrupt);
    ip_ = lz.pos();
    for (uint64_t k = cs; k & 3; k++) {
      if (ip_ >= n_) fail(kTruncated);
      if (in_[ip_++] != 0) fail(kCorrupt);
    }
    const int size = kCheckSize[check_];
    if ((size_t)size > n_ - ip_) fail(kTruncated);
    const uint8_t* got = in_ + ip_;
    const uint8_t* bytes = out_->data() + first;
    bool ok = true;
    if (check_ == 1) {
      ok = (uint32_t)crc32(0, bytes, (uInt)raw.size()) == le32(got);
    } else if (check_ == 4) {
      const uint64_t c = crc64(bytes, raw.size());
      ok = c == ((uint64_t)le32(got + 4) << 32 | le32(got));
    } else if (check_ == 10) {
      uint8_t h[32];
      sha256(bytes, raw.size(), h);
      ok = memcmp(h, got, 32) == 0;
    }
    if (!ok) fail(kCorrupt);
    ip_ += size;
    records_.push_back({(uint64_t)hsize + cs + size, raw.size()});
  }

  // The index (its records against the blocks read) and the stream footer.
  void index() {
    const size_t start = ip_;
    size_t p = ip_ + 1;
    if (vli(in_, &p, n_) != records_.size()) fail(kCorrupt);
    for (const auto& r : records_)
      if (vli(in_, &p, n_) != r.first || vli(in_, &p, n_) != r.second) fail(kCorrupt);
    for (; (p - start) & 3; p++) {
      if (p >= n_) fail(kTruncated);
      if (in_[p] != 0) fail(kCorrupt);
    }
    if (n_ - p < 4 + 12) fail(kTruncated);
    if ((uint32_t)crc32(0, in_ + start, (uInt)(p - start)) != le32(in_ + p)) fail(kCorrupt);
    const size_t size = p + 4 - start;
    const uint8_t* f = in_ + p + 4;
    if ((uint32_t)crc32(0, f + 4, 6) != le32(f) || ((uint64_t)le32(f + 4) + 1) * 4 != size ||
        f[8] != flags_[0] || f[9] != flags_[1] || f[10] != 'Y' || f[11] != 'Z')
      fail(kCorrupt);
  }
};

}  // namespace

int xz_decode(const uint8_t* in, size_t n, size_t occ, std::vector<uint8_t>* out) {
  out->clear();
  try {
    Xz(in, n, occ == kWholeStream ? kUnknown : occ).run(out);
    return kOk;
  } catch (const Stop& s) {
    return s.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace byogan
