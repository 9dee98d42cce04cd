// A Zstandard decoder (RFC 8878) for ZSTD-compressed TIFF strips and tiles
// (compression 50000), as libtiff 4.7.1's tif_zstd.c drives libzstd 1.5.7's
// ZSTD_decompressStream: frame headers (window size, dictionary ID,
// content size, content checksum), raw, RLE and compressed blocks,
// literals raw, RLE and Huffman-coded in 1 or 4 streams (treeless blocks
// reusing the frame's last table), sequences with FSE tables in
// predefined, RLE, compressed and repeat modes, repeat offsets, skippable
// frames and frames that follow one another.
//
// Each step is libzstd's own where it decides a fault: FSE_readNCount and
// the table spreads as zstd writes them, HUF_readStats, the bit reader of
// bitstream.h to the bit, libzstd's choice of its single- or
// double-symbol Huffman decoder and its fast loop over four streams (which
// may read a stream's bits on into the stream before it, and checks no
// stream's end), the checks of ZSTD_decodeLiteralsBlock,
// ZSTD_decodeSeqHeaders, ZSTD_execSequence (a sequence section used to its
// last bit) and ZSTD_decompressFrame, and the XXH64 content checksum.  A
// frame that names a dictionary fails as libzstd fails it without one
// (kZstdDictionary, "Dictionary mismatch").
//
// libtiff's ZSTDDecode loops until the strip's buffer is full, the input is
// used up or a call returns 0 (a frame's end), and fails on any error or a
// buffer not full: so only the first frame counts (a skippable frame first
// ends the strip empty).  ZSTD_decompressStream decodes a frame whose
// content size fits the buffer and whose bytes are all there in one pass,
// every check included; otherwise block by block, each block decoded whole
// before its bytes are copied out, stopping once a block's bytes no longer
// fit (after a block that fills the buffer exactly it still reads the next
// block, or the checksum).  zstd_decode follows both (a strip's size), or
// decodes a whole stream as ZSTD_decompress does (kWholeStream).

#include <cstring>
#include <new>
#include <vector>

#include "codec.h"

namespace byogan {
namespace {

struct Fault {
  int code;
};
[[noreturn]] void fail(int code) { throw Fault{code}; }
struct Full {};  // the strip's buffer is full: the decode stops, read

inline uint32_t le16(const uint8_t* p) { return p[0] | p[1] << 8; }
inline uint32_t le24(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16; }
inline uint32_t le32(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24; }
inline uint64_t le64(const uint8_t* p) { return (uint64_t)le32(p + 4) << 32 | le32(p); }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// XXH64, seed 0.
uint64_t xxh64(const uint8_t* p, size_t n) {
  constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull, P3 = 1609587929392839161ull,
                     P4 = 9650029242287828579ull, P5 = 2870177450012600261ull;
  auto rotl = [](uint64_t x, int r) { return x << r | x >> (64 - r); };
  auto round = [&](uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; };
  auto merge = [&](uint64_t acc, uint64_t v) { return (acc ^ round(0, v)) * P1 + P4; };
  const uint8_t* e = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; e - p >= 32; p += 32) {
      v1 = round(v1, le64(p));
      v2 = round(v2, le64(p + 8));
      v3 = round(v3, le64(p + 16));
      v4 = round(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(merge(merge(merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; e - p >= 8; p += 8) h = rotl(h ^ round(0, le64(p)), 27) * P1 + P4;
  if (e - p >= 4) {
    h = rotl(h ^ (uint64_t)le32(p) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < e; p++) h = rotl(h ^ *p * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// bitstream.h's BIT_DStream_t, read backward from the end of [s, s + n).
struct Bits {
  enum { kUnfinished, kEndOfBuffer, kCompleted, kOverflow };
  const uint8_t* s = nullptr;
  int64_t ptr = 0;  // offset of the container's first byte; -1: the zero word of an overflow
  uint64_t c = 0;
  uint32_t used = 0;

  // BIT_initDStream: fails on no bytes or a last byte of 0 (no end mark)
  void init(const uint8_t* src, size_t n) {
    if (n < 1) fail(kCorrupt);
    s = src;
    const uint8_t last = src[n - 1];
    if (n >= 8) {
      ptr = (int64_t)n - 8;
      c = le64(src + ptr);
      used = last ? 8 - highbit(last) : 0;
    } else {
      ptr = 0;
      c = 0;
      for (size_t i = 0; i < n; i++) c |= (uint64_t)src[i] << (8 * i);
      used = last ? 8 - highbit(last) : 0;
      used += (uint32_t)(8 - n) * 8;
    }
    if (!last) fail(kCorrupt);
  }
  uint64_t look(uint32_t nb) const { return nb ? (c >> ((64 - used - nb) & 63)) & ((1ull << nb) - 1) : 0; }
  uint64_t look_fast(uint32_t nb) const { return (c << (used & 63)) >> ((64 - nb) & 63); }
  uint64_t read(uint32_t nb) {
    const uint64_t v = look(nb);
    used += nb;
    return v;
  }
  uint64_t read_fast(uint32_t nb) {
    const uint64_t v = look_fast(nb);
    used += nb;
    return v;
  }
  int reload() {
    if (used > 64) {
      ptr = -1;
      return kOverflow;
    }
    if (ptr >= 8) {
      ptr -= used >> 3;
      used &= 7;
      c = le64(s + ptr);
      return kUnfinished;
    }
    if (ptr == 0) return used < 64 ? kEndOfBuffer : kCompleted;
    uint32_t nb = used >> 3;
    int result = kUnfinished;
    if (ptr - (int64_t)nb < 0) {
      nb = (uint32_t)ptr;
      result = kEndOfBuffer;
    }
    ptr -= nb;
    used -= nb * 8;
    c = le64(s + ptr);
    return result;
  }
  bool finished() const { return ptr == 0 && used == 64; }
};

// FSE_readNCount (entropy_common.c): the normalized counts of an FSE
// table description at [in, in + n); returns its size in bytes.
size_t read_ncount(int16_t* norm, unsigned* max_sv, unsigned* table_log, const uint8_t* in, size_t n) {
  if (n < 8) {
    uint8_t buffer[8] = {0};
    memcpy(buffer, in, n);
    const size_t size = read_ncount(norm, max_sv, table_log, buffer, 8);
    if (size > n) fail(kCorrupt);
    return size;
  }
  const uint8_t* ip = in;
  const uint8_t* const iend = in + n;
  const unsigned max_sv1 = *max_sv + 1;
  memset(norm, 0, max_sv1 * sizeof(int16_t));
  uint32_t stream = le32(ip);
  int nb = (int)(stream & 0xF) + 5;
  if (nb > 15) fail(kCorrupt);
  stream >>= 4;
  int count_bits = 4;
  *table_log = (unsigned)nb;
  int remaining = (1 << nb) + 1, threshold = 1 << nb;
  nb++;
  unsigned charnum = 0;
  int previous0 = 0;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
      ip += count_bits >> 3;
      count_bits &= 7;
    } else {
      count_bits -= (int)(8 * (iend - 4 - ip));
      count_bits &= 31;
      ip = iend - 4;
    }
    stream = le32(ip) >> count_bits;
  };
  while (true) {
    if (previous0) {
      int repeats = __builtin_ctz(~stream | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          count_bits -= (int)(8 * (iend - 7 - ip));
          count_bits &= 31;
          ip = iend - 4;
        }
        stream = le32(ip) >> count_bits;
        repeats = __builtin_ctz(~stream | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      stream >>= 2 * repeats;
      count_bits += 2 * repeats;
      charnum += stream & 3;
      count_bits += 2;
      if (charnum >= max_sv1) break;
      advance();
    }
    {
      const int max = (2 * threshold - 1) - remaining;
      int count;
      if ((stream & (threshold - 1)) < (uint32_t)max) {
        count = (int)(stream & (threshold - 1));
        count_bits += nb - 1;
      } else {
        count = (int)(stream & (2 * threshold - 1));
        if (count >= threshold) count -= max;
        count_bits += nb;
      }
      count--;
      if (count >= 0) remaining -= count;
      else remaining += count;
      norm[charnum++] = (int16_t)count;
      previous0 = !count;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nb = highbit((uint32_t)remaining) + 1;
        threshold = 1 << (nb - 1);
      }
      if (charnum >= max_sv1) break;
      advance();
    }
  }
  if (remaining != 1) fail(kCorrupt);
  if (charnum > max_sv1) fail(kCorrupt);
  if (count_bits > 32) fail(kCorrupt);
  *max_sv = charnum - 1;
  ip += (count_bits + 7) >> 3;
  return (size_t)(ip - in);
}

// FSE's spread of symbols over a table of 2^log cells: the low-probability
// symbols (-1) at the top, the rest stepped over the others.  cell[u] gets
// the symbol; next[u] and bits[u] the state's baseline and bits to read.
struct FseCell {
  uint16_t symbol, next;
  uint8_t bits;
};
bool spread(const int16_t* norm, unsigned max_sv, unsigned log, std::vector<FseCell>* table) {
  const uint32_t size = 1u << log;
  uint32_t high = size - 1;
  std::vector<uint16_t> symbol_next(max_sv + 1);
  table->assign(size, FseCell{0, 0, 0});
  bool fast = true;
  const int16_t large = (int16_t)(1 << (log - 1));
  for (unsigned s = 0; s <= max_sv; s++) {
    if (norm[s] == -1) {
      (*table)[high--].symbol = (uint16_t)s;
      symbol_next[s] = 1;
    } else {
      if (norm[s] >= large) fast = false;
      symbol_next[s] = (uint16_t)norm[s];
    }
  }
  const uint32_t mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
  uint32_t position = 0;
  for (unsigned s = 0; s <= max_sv; s++)
    for (int i = 0; i < norm[s]; i++) {
      (*table)[position].symbol = (uint16_t)s;
      position = (position + step) & mask;
      while (position > high) position = (position + step) & mask;
    }
  if (position != 0) fail(kCorrupt);
  for (uint32_t u = 0; u < size; u++) {
    FseCell& e = (*table)[u];
    const uint32_t next = symbol_next[e.symbol]++;
    e.bits = (uint8_t)(log - highbit(next));
    e.next = (uint16_t)((next << e.bits) - size);
  }
  return fast;
}

// HUF_readStats then HUF_readDTableX1: a Huffman table description's
// size, and the single-symbol decoding table of 2^log entries.
struct HufTable {
  int log = 0;
  bool x2 = false;  // decoded as HUF's double-symbol table (HUF_readDTableX2)
  std::vector<uint8_t> symbol, bits;
  int dt_log = 11;
  std::vector<uint32_t> entry;  // symbol | second symbol << 8 | bits << 16 | symbols << 24
};

// HUF_selectDecoder: libzstd's choice of its double-symbol decoder for 4
// streams of `size` literals from `csize` bytes, by its timing estimates.
bool select_x2(size_t size, size_t csize) {
  static const uint32_t kTime[16][2][2] = {
      {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},         {{150, 216}, {381, 119}},  {{170, 205}, {514, 112}},
      {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}}, {{221, 192}, {735, 107}},  {{256, 189}, {881, 106}},
      {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}}, {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}}, {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
  const uint32_t q = csize >= size ? 15 : (uint32_t)(csize * 16 / size);
  const uint32_t d256 = (uint32_t)(size >> 8);
  const uint32_t t0 = kTime[q][0][0] + kTime[q][0][1] * d256;
  uint32_t t1 = kTime[q][1][0] + kTime[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

size_t read_huffman(const uint8_t* in, size_t n, HufTable* t) {
  if (!n) fail(kCorrupt);
  uint8_t weight[256];
  size_t isize = in[0], osize;
  if (isize >= 128) {
    osize = isize - 127;
    isize = (osize + 1) / 2;
    if (isize + 1 > n) fail(kCorrupt);
    if (osize >= 256) fail(kCorrupt);
    for (size_t i = 0; i < osize; i += 2) {
      weight[i] = in[1 + i / 2] >> 4;
      weight[i + 1] = in[1 + i / 2] & 15;
    }
  } else {
    // the weights FSE-coded (FSE_decompress_wksp, accuracy log at most 6)
    if (isize + 1 > n) fail(kCorrupt);
    const uint8_t* src = in + 1;
    int16_t norm[256];
    unsigned max_sv = 255, log;
    const size_t head = read_ncount(norm, &max_sv, &log, src, isize);
    if (log > 6) fail(kCorrupt);
    std::vector<FseCell> table;
    const bool fast = spread(norm, max_sv, log, &table);
    Bits b;
    b.init(src + head, isize - head);
    uint32_t s1 = (uint32_t)b.read(log);
    b.reload();
    uint32_t s2 = (uint32_t)b.read(log);
    b.reload();
    if (b.reload() == Bits::kOverflow) fail(kCorrupt);
    auto symbol = [&](uint32_t& st) {
      const FseCell& e = table[st];
      st = e.next + (uint32_t)(fast ? b.read_fast(e.bits) : b.read(e.bits));
      return (uint8_t)e.symbol;
    };
    uint8_t* op = weight;
    uint8_t* const omax = weight + 255;
    uint8_t* const olimit = omax - 3;
    for (; b.reload() == Bits::kUnfinished && op < olimit; op += 4) {
      op[0] = symbol(s1);
      op[1] = symbol(s2);
      op[2] = symbol(s1);
      op[3] = symbol(s2);
    }
    while (true) {
      if (op > omax - 2) fail(kCorrupt);
      *op++ = symbol(s1);
      if (b.reload() == Bits::kOverflow) {
        *op++ = symbol(s2);
        break;
      }
      if (op > omax - 2) fail(kCorrupt);
      *op++ = symbol(s2);
      if (b.reload() == Bits::kOverflow) {
        *op++ = symbol(s1);
        break;
      }
    }
    osize = (size_t)(op - weight);
  }
  uint32_t rank[13] = {0}, total = 0;
  for (size_t i = 0; i < osize; i++) {
    if (weight[i] > 12) fail(kCorrupt);
    rank[weight[i]]++;
    total += (1u << weight[i]) >> 1;
  }
  if (total == 0) fail(kCorrupt);
  const int log = highbit(total) + 1;
  if (log > 12) fail(kCorrupt);
  const uint32_t rest = (1u << log) - total, last = (uint32_t)highbit(rest) + 1;
  if ((1u << highbit(rest)) != rest) fail(kCorrupt);
  weight[osize] = (uint8_t)last;
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1)) fail(kCorrupt);
  const size_t nsym = osize + 1;
  t->log = log;
  t->symbol.assign((size_t)1 << log, 0);
  t->bits.assign((size_t)1 << log, 0);
  size_t at = 0;  // by weight from 1, each weight's symbols in order
  for (int w = 1; w <= log; w++)
    for (size_t s = 0; s < nsym; s++)
      if (weight[s] == w) {
        const size_t len = (size_t)1 << (w - 1);
        for (size_t k = 0; k < len; k++) {
          t->symbol[at + k] = (uint8_t)s;
          t->bits[at + k] = (uint8_t)(log + 1 - w);
        }
        at += len;
      }
  return isize + 1;
}

// A table's lookup at dt_log bits (t.entry): the symbol or pair of
// symbols, the bits they take.  HUF's single-symbol table (X1) is scaled
// to 11 bits where its codes are no longer; its double-symbol table (X2)
// holds a second symbol wherever both codes fit the 11 bits (12 for a
// 12-bit code).
void build_entries(HufTable* t) {
  t->dt_log = t->log <= 11 ? 11 : 12;
  const int dt = t->dt_log, shift = dt - t->log;
  t->entry.resize((size_t)1 << dt);
  for (uint32_t v = 0; v < (1u << dt); v++) {
    const uint32_t s1 = t->symbol[v >> shift], nb1 = t->bits[v >> shift];
    uint32_t e = s1 | nb1 << 16 | 1u << 24;
    if (t->x2) {
      const uint32_t rest = (v << nb1) & ((1u << dt) - 1);
      const uint32_t s2 = t->symbol[rest >> shift], nb2 = t->bits[rest >> shift];
      if (nb1 + nb2 <= (uint32_t)dt) e = s1 | s2 << 8 | (nb1 + nb2) << 16 | 2u << 24;
    }
    t->entry[v] = e;
  }
}

// HUF_decodeStreamX1 / HUF_decodeStreamX2 from out[p] to out[end]: the
// double-symbol decoder ends on HUF_decodeLastSymbolX2, which skips a
// pair's bits for its last symbol, clamped at the container's end.
void huffman_stream(const HufTable& t, Bits& b, uint8_t* out, size_t p, size_t end) {
  const uint32_t dt = (uint32_t)t.dt_log;
  auto one = [&]() {
    const uint32_t e = t.entry[b.look_fast(dt)];
    out[p] = (uint8_t)e;
    if (e >> 24 == 2) out[p + 1] = (uint8_t)(e >> 8);
    b.used += (e >> 16) & 0xFF;
    p += e >> 24;
  };
  if (!t.x2) {
    if (end - p > 3) {
      while (b.reload() == Bits::kUnfinished && p < end - 3) {
        one();
        one();
        one();
        one();
      }
    } else {
      b.reload();
    }
    while (p < end) one();
    return;
  }
  if (end - p >= 8) {
    const size_t room = dt <= 11 ? 9 : 7;
    while (b.reload() == Bits::kUnfinished && p < end - room)
      for (int k = 0; k < (dt <= 11 ? 5 : 4); k++) one();
  } else {
    b.reload();
  }
  if (end - p >= 2) {
    while (b.reload() == Bits::kUnfinished && p <= end - 2) one();
    while (p <= end - 2) one();
  }
  if (p < end) {
    const uint32_t e = t.entry[b.look_fast(dt)];
    out[p] = (uint8_t)e;
    const uint32_t nb = (e >> 16) & 0xFF;
    if (e >> 24 == 1) {
      b.used += nb;
    } else if (b.used < 64) {
      b.used = b.used + nb > 64 ? 64 : b.used + nb;
    }
  }
}

// The literals of 1 or 4 Huffman streams (HUF_decompress1X / 4X).  Four
// streams of an 11-bit table, each of 8 bytes or more, go through
// libzstd's fast loop (HUF_decompress4X{1,2}_usingDTable_internal_fast):
// 5 lookups a stream between reloads from a 64-bit word whose lowest set
// bit marks the bits used, each stream free to read down into the bytes
// before it, then the rest of each stream by the plain decoder, its reader
// starting at the first stream's start, and no stream's end checked.
// Elsewhere every stream must end exactly where its bits do.
void huffman_literals(const HufTable& t, const uint8_t* in, size_t n, uint8_t* out, size_t size, bool single) {
  if (single) {
    Bits b;
    b.init(in, n);
    huffman_stream(t, b, out, 0, size);
    if (!b.finished()) fail(kCorrupt);
    return;
  }
  if (n < 10) fail(kCorrupt);
  const size_t l1 = le16(in), l2 = le16(in + 2), l3 = le16(in + 4);
  const size_t l4 = n - (l1 + l2 + l3 + 6);  // wraps where the first three run past the data
  const size_t segment = (size + 3) / 4;
  bool fast = t.dt_log == 11 && size > 0 && l1 >= 8 && l2 >= 8 && l3 >= 8 && l4 >= 8;
  if (fast && l4 > n) fail(kCorrupt);
  fast = fast && 3 * segment < size;
  if (fast) {
    const int64_t iend[4] = {6, (int64_t)(6 + l1), (int64_t)(6 + l1 + l2), (int64_t)(6 + l1 + l2 + l3)};
    int64_t ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8, (int64_t)n - 8};
    int64_t op[4] = {0, (int64_t)segment, 2 * (int64_t)segment, 3 * (int64_t)segment};
    const int64_t oend[4] = {op[1], op[2], op[3], (int64_t)size};
    uint64_t bits[4];
    for (int k = 0; k < 4; k++) {
      const uint8_t last = in[ip[k] + 7];
      bits[k] = (le64(in + ip[k]) | 1) << (last ? 8 - highbit(last) : 0);
    }
    auto reload = [&](int k) {
      const int ctz = __builtin_ctzll(bits[k]);
      ip[k] -= ctz >> 3;
      bits[k] = (le64(in + ip[k]) | 1) << (ctz & 7);
    };
    auto entry = [&](int k) {
      const uint32_t e = t.entry[bits[k] >> 53];
      out[op[k]] = (uint8_t)e;
      if (e >> 24 == 2) out[op[k] + 1] = (uint8_t)(e >> 8);
      bits[k] <<= (e >> 16) & 0x3F;
      op[k] += e >> 24;
    };
    while (true) {
      int64_t iters = ip[0] / 7;
      for (int k = 0; k < 4; k++) {
        const int64_t o = t.x2 ? (oend[k] - op[k]) / 10 : (int64_t)(size - op[3]) / 5;
        iters = o < iters ? o : iters;
      }
      const int64_t olimit = op[3] + iters * 5;
      if (op[3] == olimit) break;
      bool crossed = false;
      for (int k = 1; k < 4; k++) crossed = crossed || ip[k] < ip[k - 1];
      if (crossed) break;
      do {
        for (int sym = 0; sym < 5; sym++)
          for (int k = 0; k < 4; k++) entry(k);
        for (int k = 0; k < 4; k++) reload(k);
      } while (op[3] < olimit);
    }
    for (int k = 0; k < 4; k++) {
      const int64_t seg_end = (int64_t)((size_t)(k + 1) * segment < size ? (size_t)(k + 1) * segment : size);
      if (op[k] > seg_end) fail(kCorrupt);
      if (ip[k] < iend[k] - 8) fail(kCorrupt);
      Bits b;
      b.s = in;
      b.ptr = ip[k];
      b.c = le64(in + ip[k]);
      b.used = (uint32_t)__builtin_ctzll(bits[k]);
      huffman_stream(t, b, out, (size_t)op[k], (size_t)seg_end);
    }
    return;
  }
  if (size < 6) fail(kCorrupt);
  if (l4 > n) fail(kCorrupt);
  if (3 * segment > size) fail(kCorrupt);
  const uint8_t* s = in + 6;
  const size_t lens[4] = {l1, l2, l3, l4};
  Bits b[4];
  for (int k = 0; k < 4; k++) {
    b[k].init(s, lens[k]);
    s += lens[k];
  }
  for (int k = 0; k < 4; k++)
    huffman_stream(t, b[k], out, k * segment, k < 3 ? (k + 1) * segment : size);
  for (int k = 0; k < 4; k++)
    if (!b[k].finished()) fail(kCorrupt);
}

// A sequence code's table: each cell's baseline and extra bits.
struct SeqCell {
  uint32_t base;
  uint8_t extra, bits;
  uint16_t next;
};
struct SeqTable {
  int log = 0;
  std::vector<SeqCell> cell;
};

constexpr uint32_t kLlBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                  12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLlBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint8_t kMlBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0, 0,
                                 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLlNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMlNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1,  1, 1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOfNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// kind: 0 literal lengths, 1 offsets, 2 match lengths
void seq_values(int kind, unsigned symbol, uint32_t* base, uint8_t* extra) {
  if (kind == 0) {
    *base = kLlBase[symbol], *extra = kLlBits[symbol];
  } else if (kind == 1) {
    *base = symbol < 2 ? symbol : (1u << symbol) - 3;  // ZSTD's OF_base
    *extra = (uint8_t)symbol;
  } else {
    static uint32_t ml_base[53];
    static bool made = [] {
      uint32_t v = 3;
      for (int i = 0; i < 53; i++) {
        ml_base[i] = v;
        v += 1u << kMlBits[i];
      }
      return true;
    }();
    (void)made;
    *base = ml_base[symbol], *extra = kMlBits[symbol];
  }
}

void build_seq(int kind, const int16_t* norm, unsigned max_sv, unsigned log, SeqTable* t) {
  std::vector<FseCell> table;
  spread(norm, max_sv, log, &table);
  t->log = (int)log;
  t->cell.resize(table.size());
  for (size_t u = 0; u < table.size(); u++) {
    SeqCell& c = t->cell[u];
    seq_values(kind, table[u].symbol, &c.base, &c.extra);
    c.bits = table[u].bits;
    c.next = table[u].next;
  }
}

class Frames {
 public:
  Frames(const uint8_t* in, size_t n, size_t occ) : in_(in), n_(n), occ_(occ) {}

  void run(std::vector<uint8_t>* out) {
    out_ = out;
    if (occ_ == kWholeStream) {
      whole();
      return;
    }
    strip();
  }

 private:
  const uint8_t* in_;
  size_t n_, occ_;
  std::vector<uint8_t>* out_ = nullptr;
  // the frame's state
  size_t frame_start_ = 0;  // out's size at the frame's start
  uint64_t window_ = 0, fcs_ = 0, block_max_ = 0;
  bool fcs_known_ = false, checksum_ = false;
  bool lit_entropy_ = false, fse_entropy_ = false;
  HufTable huf_;
  SeqTable ll_, of_, ml_;
  const SeqTable *llp_ = nullptr, *ofp_ = nullptr, *mlp_ = nullptr;
  SeqTable ll_default_, of_default_, ml_default_, ll_rle_, of_rle_, ml_rle_;
  uint32_t rep_[3];
  std::vector<uint8_t> lit_;

  static constexpr uint32_t kMagic = 0xFD2FB528u;

  bool skippable(size_t at) const { return n_ - at >= 4 && (le32(in_ + at) & 0xFFFFFFF0u) == 0x184D2A50u; }

  // A frame header's size from its descriptor byte: magic, descriptor,
  // window, dictionary ID and content size.
  static size_t header_size(uint8_t fhd) {
    const int dict_code = fhd & 3, fcs_code = fhd >> 6;
    const bool single = (fhd >> 5) & 1;
    return 5 + !single + (dict_code == 3 ? 4 : dict_code) + (fcs_code == 0 ? single : 1 << fcs_code);
  }

  // The frame header at *at (ZSTD_getFrameHeader, ZSTD_decodeFrameHeader).
  void header(size_t* at) {
    if (n_ - *at < 5) fail(kTruncated);
    if (le32(in_ + *at) != kMagic) fail(kCorrupt);
    const uint8_t fhd = in_[*at + 4];
    const int dict_code = fhd & 3, fcs_code = fhd >> 6;
    const bool single = (fhd >> 5) & 1;
    const size_t size = header_size(fhd);
    if (n_ - *at < size) fail(kTruncated);
    if (fhd & 0x08) fail(kCorrupt);
    size_t p = *at + 5;
    if (!single) {
      const uint8_t wb = in_[p++];
      const int wlog = (wb >> 3) + 10;
      if (wlog > 31) fail(kCorrupt);
      window_ = 1ull << wlog;
      window_ += (window_ >> 3) * (wb & 7);
    }
    uint32_t dict = 0;
    if (dict_code == 1) dict = in_[p];
    if (dict_code == 2) dict = le16(in_ + p);
    if (dict_code == 3) dict = le32(in_ + p);
    p += dict_code == 3 ? 4 : dict_code;
    fcs_known_ = true;
    if (fcs_code == 0) {
      if (single) fcs_ = in_[p];
      else fcs_known_ = false;
    } else if (fcs_code == 1) {
      fcs_ = le16(in_ + p) + 256;
    } else if (fcs_code == 2) {
      fcs_ = le32(in_ + p);
    } else {
      fcs_ = le64(in_ + p);
    }
    if (single) window_ = fcs_;
    block_max_ = window_ < 131072 ? window_ : 131072;
    checksum_ = (fhd >> 2) & 1;
    if (dict) fail(kZstdDictionary);
    *at += size;
    frame_start_ = out_->size();
    lit_entropy_ = fse_entropy_ = false;
    llp_ = ofp_ = mlp_ = nullptr;
    rep_[0] = 1, rep_[1] = 4, rep_[2] = 8;
  }

  // ZSTD_findFrameCompressedSize: the frame's bytes, or 0 where its blocks
  // run past the input.
  size_t frame_size(size_t at) const {
    size_t p = at + header_size(in_[at + 4]);
    while (true) {
      if (n_ - p < 3) return 0;
      const uint32_t bh = le24(in_ + p);
      const int type = (bh >> 1) & 3;
      if (type == 3) return 0;
      const size_t csize = type == 1 ? 1 : bh >> 3;
      if (n_ - p < 3 + csize) return 0;
      p += 3 + csize;
      if (bh & 1) break;
    }
    if (checksum_) {
      if (n_ - p < 4) return 0;
      p += 4;
    }
    return p - at;
  }

  // One block's bytes appended to out, at most `room` of them (the
  // output's space); ZSTD_decompressContinue (`streaming`) also holds them
  // to the block's maximum size.
  void block(int type, const uint8_t* src, size_t csize, size_t orig, size_t room, bool streaming) {
    const size_t before = out_->size();
    if (type == 0) {
      if (csize > room) fail(kCorrupt);
      out_->insert(out_->end(), src, src + csize);
    } else if (type == 1) {
      if (orig > room) fail(kCorrupt);
      out_->insert(out_->end(), orig, src[0]);
    } else {
      if (csize > block_max_) fail(kCorrupt);
      const size_t used = literals(src, csize, room);
      sequences(src + used, csize - used, room);
    }
    if (streaming && out_->size() - before > block_max_) fail(kCorrupt);  // "Decompressed Block Size Exceeds Maximum"
  }

  // ZSTD_decodeLiteralsBlock: the block's literals into lit_; its size.
  size_t literals(const uint8_t* in, size_t n, size_t room) {
    if (n < 2) fail(kCorrupt);
    const int type = in[0] & 3, code = (in[0] >> 2) & 3;
    const size_t expected = room < block_max_ ? room : (size_t)block_max_;
    if (type == 0 || type == 1) {
      size_t lh, size;
      if (code == 1) {
        if (type == 1 && n < 3) fail(kCorrupt);
        lh = 2, size = le16(in) >> 4;
      } else if (code == 3) {
        if (n < (type == 1 ? 4u : 3u)) fail(kCorrupt);
        lh = 3, size = le24(in) >> 4;
      } else {
        lh = 1, size = in[0] >> 3;
      }
      if (size > block_max_ || size > expected) fail(kCorrupt);
      if (type == 0) {
        if (lh + size > n) fail(kCorrupt);
        lit_.assign(in + lh, in + lh + size);
        return lh + size;
      }
      lit_.assign(size, in[lh]);
      return lh + 1;
    }
    if (n < 5) fail(kCorrupt);
    const uint32_t lhc = le32(in);
    size_t lh, size, csize;
    bool single = false;
    if (code <= 1) {
      single = code == 0;
      lh = 3, size = (lhc >> 4) & 0x3FF, csize = (lhc >> 14) & 0x3FF;
    } else if (code == 2) {
      lh = 4, size = (lhc >> 4) & 0x3FFF, csize = lhc >> 18;
    } else {
      lh = 5, size = (lhc >> 4) & 0x3FFFF, csize = (lhc >> 22) + ((size_t)in[4] << 10);
    }
    if (size > block_max_) fail(kCorrupt);
    if (!single && size < 6) fail(kCorrupt);
    if (csize + lh > n) fail(kCorrupt);
    if (expected < size) fail(kCorrupt);
    const uint8_t* p = in + lh;
    size_t left = csize;
    if (type == 3) {
      if (!lit_entropy_) fail(kCorrupt);  // a treeless block with no table before it
    } else {
      const size_t t = read_huffman(p, left, &huf_);
      if (t >= left) fail(kCorrupt);
      p += t;
      left -= t;
      huf_.x2 = !single && select_x2(size, csize);
      build_entries(&huf_);
    }
    lit_.resize(size);
    huffman_literals(huf_, p, left, lit_.data(), size, single);
    lit_entropy_ = true;
    return csize + lh;
  }

  // ZSTD_buildSeqTable for one code of the block.
  size_t seq_table(int kind, int mode, const uint8_t* in, size_t n, const SeqTable** use) {
    static const unsigned max_sv[3] = {35, 31, 52}, max_log[3] = {9, 8, 9};
    SeqTable* own = kind == 0 ? &ll_ : kind == 1 ? &of_ : &ml_;
    if (mode == 0) {
      SeqTable* d = kind == 0 ? &ll_default_ : kind == 1 ? &of_default_ : &ml_default_;
      if (d->cell.empty()) {
        const int16_t* norm = kind == 0 ? kLlNorm : kind == 1 ? kOfNorm : kMlNorm;
        build_seq(kind, norm, kind == 0 ? 35 : kind == 1 ? 28 : 52, kind == 1 ? 5 : 6, d);
      }
      *use = d;
      return 0;
    }
    if (mode == 1) {
      if (!n) fail(kCorrupt);
      if (in[0] > max_sv[kind]) fail(kCorrupt);
      SeqTable* r = kind == 0 ? &ll_rle_ : kind == 1 ? &of_rle_ : &ml_rle_;
      r->log = 0;
      r->cell.assign(1, SeqCell{0, 0, 0, 0});
      seq_values(kind, in[0], &r->cell[0].base, &r->cell[0].extra);
      *use = r;
      return 1;
    }
    if (mode == 2) {
      int16_t norm[53];
      unsigned sv = max_sv[kind], log;
      const size_t size = read_ncount(norm, &sv, &log, in, n);
      if (log > max_log[kind]) fail(kCorrupt);
      build_seq(kind, norm, sv, log, own);
      *use = own;
      return size;
    }
    if (!fse_entropy_ || !*use) fail(kCorrupt);  // repeat: the frame's last table of this code
    return 0;
  }

  void sequences(const uint8_t* in, size_t n, size_t cap) {
    if (n < 1) fail(kCorrupt);
    const uint8_t* ip = in;
    const uint8_t* const iend = in + n;
    uint32_t nb_seq = *ip++;
    if (nb_seq > 0x7F) {
      if (nb_seq == 0xFF) {
        if (ip + 2 > iend) fail(kCorrupt);
        nb_seq = le16(ip) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) fail(kCorrupt);
        nb_seq = ((nb_seq - 0x80) << 8) + *ip++;
      }
    }
    const size_t block_start = out_->size();
    if (nb_seq == 0) {
      if (ip != iend) fail(kCorrupt);
      if (lit_.size() > cap) fail(kCorrupt);
      out_->insert(out_->end(), lit_.begin(), lit_.end());
      return;
    }
    if (ip + 1 > iend) fail(kCorrupt);
    if (*ip & 3) fail(kCorrupt);
    const int ll_mode = *ip >> 6, of_mode = (*ip >> 4) & 3, ml_mode = (*ip >> 2) & 3;
    ip++;
    ip += seq_table(0, ll_mode, ip, iend - ip, &llp_);
    ip += seq_table(1, of_mode, ip, iend - ip, &ofp_);
    ip += seq_table(2, ml_mode, ip, iend - ip, &mlp_);
    fse_entropy_ = true;
    Bits b;
    b.init(ip, iend - ip);
    uint32_t sll = (uint32_t)b.read(llp_->log);
    b.reload();
    uint32_t sof = (uint32_t)b.read(ofp_->log);
    b.reload();
    uint32_t sml = (uint32_t)b.read(mlp_->log);
    b.reload();
    size_t lit_at = 0;
    uint64_t rep[3] = {rep_[0], rep_[1], rep_[2]};
    const size_t limit = block_start + cap;
    for (uint32_t k = nb_seq; k > 0; k--) {
      const SeqCell& l = llp_->cell[sll];
      const SeqCell& m = mlp_->cell[sml];
      const SeqCell& o = ofp_->cell[sof];
      uint64_t ll = l.base, ml = m.base, offset;
      if (o.extra > 1) {
        offset = o.base + b.read_fast(o.extra);
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        const int ll0 = l.base == 0;
        if (o.extra == 0) {
          offset = rep[ll0];
          rep[1] = rep[!ll0];
          rep[0] = offset;
        } else {
          offset = o.base + ll0 + b.read_fast(1);
          uint64_t temp = offset == 3 ? rep[0] - 1 : rep[offset];
          temp -= !temp;  // 0 is no offset: libzstd makes it -1, which fails below
          if (offset != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset = temp;
        }
      }
      if (m.extra > 0) ml += b.read_fast(m.extra);
      if (l.extra + m.extra + o.extra >= 64 - (9 + 9 + 8)) b.reload();
      if (l.extra > 0) ll += b.read_fast(l.extra);
      if (k > 1) {
        sll = l.next + (uint32_t)b.read(l.bits);
        sml = m.next + (uint32_t)b.read(m.bits);
        sof = o.next + (uint32_t)b.read(o.bits);
        b.reload();
      }
      // ZSTD_execSequence
      if (ll + ml > limit - out_->size()) fail(kCorrupt);
      if (ll > lit_.size() - lit_at) fail(kCorrupt);
      out_->insert(out_->end(), lit_.begin() + lit_at, lit_.begin() + lit_at + ll);
      lit_at += ll;
      if (offset > out_->size() - frame_start_) fail(kCorrupt);
      for (uint64_t i = 0; i < ml; i++) out_->push_back((*out_)[out_->size() - offset]);
    }
    if (!b.finished()) fail(kCorrupt);  // the sequences' bits used exactly (BIT_endOfDStream)
    rep_[0] = (uint32_t)rep[0], rep_[1] = (uint32_t)rep[1], rep_[2] = (uint32_t)rep[2];
    const size_t last = lit_.size() - lit_at;
    if (last > limit - out_->size()) fail(kCorrupt);
    out_->insert(out_->end(), lit_.begin() + lit_at, lit_.end());
  }

  void verify_checksum(size_t at) const {
    const uint32_t want = (uint32_t)xxh64(out_->data() + frame_start_, out_->size() - frame_start_);
    if (le32(in_ + at) != want) fail(kCorrupt);
  }

  // ZSTD_decompressFrame: every block, the content size and the checksum;
  // blocks hold at most `room` bytes in all.  Returns the frame's end.
  size_t frame_whole(size_t at, size_t room) {
    header(&at);
    const size_t end_room = out_->size() + room;
    while (true) {
      if (n_ - at < 3) fail(kTruncated);
      const uint32_t bh = le24(in_ + at);
      const int type = (bh >> 1) & 3;
      if (type == 3) fail(kCorrupt);
      const size_t orig = bh >> 3, csize = type == 1 ? 1 : orig;
      at += 3;
      if (n_ - at < csize) fail(kTruncated);
      block(type, in_ + at, csize, orig, end_room - out_->size(), false);
      at += csize;
      if (bh & 1) break;
    }
    if (fcs_known_ && out_->size() - frame_start_ != fcs_) fail(kCorrupt);
    if (checksum_) {
      if (n_ - at < 4) fail(kTruncated);
      verify_checksum(at);
      at += 4;
    }
    return at;
  }

  // ZSTD_decompress: every frame, skippable ones skipped; no bytes after.
  void whole() {
    size_t at = 0;
    while (n_ - at >= 5) {
      if (skippable(at)) {
        if (n_ - at < 8) fail(kTruncated);
        const uint64_t size = (uint64_t)le32(in_ + at + 4) + 8;
        if (size > n_ - at) fail(kTruncated);
        at += size;
        continue;
      }
      at = frame_whole(at, SIZE_MAX - out_->size());
    }
    if (at != n_) fail(kTruncated);
  }

  // A strip: the first frame, as ZSTD_decompressStream in libtiff's loop.
  void strip() {
    size_t at = 0;
    if (skippable(at)) fail(kTruncated);  // the call returns 0 with nothing out: "Not enough data"
    if (n_ < 5) fail(kTruncated);
    if (le32(in_) != kMagic) fail(kCorrupt);
    {
      size_t probe = 0;
      header(&probe);
      out_->clear();
    }
    if (fcs_known_ && occ_ >= fcs_) {
      const size_t size = frame_size(0);
      if (size && size <= n_) {  // one pass
        frame_whole(0, occ_);
        if (out_->size() != occ_) fail(kTruncated);
        throw Full{};
      }
    }
    if (window_ > (1ull << 27) + 1) fail(kCorrupt);  // frameParameter_windowTooLarge
    header(&at);
    // each block decoded whole into the stream's buffer, then copied out
    const size_t fcs_room = fcs_known_ ? (size_t)fcs_ : SIZE_MAX;
    bool full = false;
    while (true) {
      if (n_ - at < 3) break;
      const uint32_t bh = le24(in_ + at);
      const int type = (bh >> 1) & 3;
      if (type == 3) fail(kCorrupt);
      const size_t orig = bh >> 3, csize = type == 1 ? 1 : orig;
      if (type != 1 && csize > block_max_) fail(kCorrupt);  // "Block Size Exceeds Maximum"
      at += 3;
      const size_t before = out_->size();
      if (n_ - at < csize) {
        if (type != 0 || full) break;  // a raw block streams out as far as its bytes go
        out_->insert(out_->end(), in_ + at, in_ + n_);
        if (out_->size() >= occ_) full = true;
        break;
      }
      block(type, in_ + at, csize, orig, fcs_room - (before - frame_start_), true);
      at += csize;
      if (bh & 1) {
        if (fcs_known_ && out_->size() - frame_start_ != fcs_) fail(kCorrupt);
        if (full || out_->size() > occ_) break;  // the bytes no longer fit: the stream stops here
        if (checksum_ && n_ - at >= 4) verify_checksum(at);
        break;
      }
      if (full || out_->size() > occ_) {
        full = true;
        break;
      }
      if (out_->size() == occ_) full = true;  // filled exactly: the next block is read still
    }
    if (out_->size() < occ_) fail(kTruncated);
    out_->resize(occ_);
    throw Full{};
  }
};

}  // namespace

int zstd_decode(const uint8_t* in, size_t n, size_t occ, std::vector<uint8_t>* out) {
  out->clear();
  try {
    Frames(in, n, occ).run(out);
    return kOk;
  } catch (const Full&) {
    return kOk;
  } catch (const Fault& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace byogan
