// What the JPEG decoder's sources share (jpeg_decode.cpp, jpeg_arith.cpp,
// jpeg_lossless.cpp): the fault that unwinds a decode, the Huffman tables
// and bit reader, a frame's components and the interface the scan loop
// calls for either entropy coding.  Nothing here keeps state between
// calls: each decode owns its objects, so threads decode in parallel.

#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

#include "codec.h"

namespace byogan {
namespace jpeg {

struct Error {
  int code;
};

[[noreturn]] inline void fail(int code) { throw Error{code}; }

constexpr int kLookBits = 9;

// A Huffman table derived as jpeg_make_d_derived_tbl does, with a
// kLookBits lookahead: look[bits] = (length << 8) | symbol, 0 where the
// code is longer.
struct Huff {
  uint16_t look[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

// max_symbol: 15 for DCT DC tables (a larger one is bad data), 16 for a
// lossless frame's (category 16), 255 for AC tables.
void derive(const HuffSpec& spec, int max_symbol, Huff* t);

// The entropy-coded bits of a scan: bytes with their 0xFF 0x00 stuffing
// removed, stopping at the first marker.  Past it the reader gives zero
// bits, as libjpeg does, but remembers whether any of them were consumed.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // n valid bits at the top
  int n = 0;
  int pad = 0;       // zero bits appended past the data, at the bottom of acc
  bool stopped = false;
  bool overrun = false;

  void fill() {
    while (n <= 56) {
      uint32_t b = 0;
      if (!stopped && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;  // fill bytes
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {
            stopped = true;  // a marker: p stays on its 0xFF
            p = q - 1;
            b = 0;
          }
        } else {
          p++;
        }
      } else {
        stopped = true;
      }
      if (stopped) pad += 8;
      acc |= (uint64_t)b << (56 - n);
      n += 8;
    }
  }
  void skip(int k) {
    acc <<= k;
    n -= k;
    if (n < pad) overrun = true;
  }
  int get(int k) {  // k in 1..16
    if (n < k) fill();
    const int v = (int)(acc >> (64 - k));
    skip(k);
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huff& t) {
    if (n < 16) fill();
    const uint16_t e = t.look[acc >> (64 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = (int32_t)(acc >> (64 - l));
    while (code > t.maxcode[l]) {
      l++;
      code = (int32_t)(acc >> (64 - l));
    }
    if (l > 16) fail(kCorrupt);  // no code of 16 bits or fewer matches
    skip(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // Start on the data at q, throwing away the bits left before the marker
  // (a restart's byte padding).
  void reset(const uint8_t* q) {
    p = q;
    acc = 0;
    n = pad = 0;
    stopped = overrun = false;
  }
  // Where the data stopped; fails if bits past a marker or the file's end
  // were consumed.
  const uint8_t* stop() const {
    if (overrun) fail(p >= end ? kTruncated : kCorrupt);
    return p;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;         // the current scan's tables
  int dw = 0, dh = 0;         // downsampled_width / _height
  int bw = 0, bh = 0;         // blocks covering them (a lossless frame: samples)
  int bwp = 0, bhp = 0;       // blocks in whole MCUs
  std::vector<int16_t> coef;  // bwp * bhp blocks of 64, natural order
  std::vector<uint8_t> plane; // a lossless frame's samples, bwp x bhp
  int pred = 0;
  bool latched = false;
  int16_t q[64] = {0};        // the quantiser latched at the first scan (ISLOW_MULT_TYPE: short)
  int bits[64];               // progressive: the Al of the last scan of each coefficient, -1 before
  int16_t* block(int row, int col) { return coef.data() + ((size_t)row * bwp + col) * 64; }
};

// A scan's header: its components and spectral selection.
struct Scan {
  int n = 0;
  Component* comp[4];
  int ss = 0, se = 0, ah = 0, al = 0;
  bool progressive = false;
};

// One entropy coding's decoder for a scan of DCT blocks.  The scan loop
// calls start() at the scan's data and again after each restart marker
// (which resets the predictions and statistics), mcu() for every MCU and
// stop() where a restart marker or the scan's end is due.
class Entropy {
 public:
  virtual ~Entropy() = default;
  virtual void start(const uint8_t* p) = 0;
  // blocks[i] belongs to the scan's component which[i]
  virtual void mcu(int16_t* const* blocks, const int* which, int count) = 0;
  // Where the data stopped, for the marker reader; fails where the data
  // ran past the file's end (or, Huffman, past a marker).
  virtual const uint8_t* stop() = 0;
};

// Arithmetic conditioning (the DAC marker): per table, L and U of the DC
// statistics and Kx of the AC statistics; T.81's defaults L = 0, U = 1,
// Kx = 5 until a DAC marker sets them.
struct ArithConditioning {
  uint8_t dc_l[16], dc_u[16], ac_k[16];
  ArithConditioning() {
    memset(dc_l, 0, sizeof(dc_l));
    memset(dc_u, 1, sizeof(dc_u));
    memset(ac_k, 5, sizeof(ac_k));
  }
};

// jdarith.c's decoder for this scan (jpeg_arith.cpp).
Entropy* new_arith_decoder(const Scan& scan, const ArithConditioning& cond, const uint8_t* end);

// jdlhuff.c, jddiffct.c and jdlossls.c (jpeg_lossless.cpp): one lossless
// scan of 8-bit samples into the components' planes, from p; reads restart
// markers every `restart` MCUs.  Returns where the scan's data stopped.
const uint8_t* lossless_scan(const Scan& scan, const Huff* const* tables, int restart, int mcux, int mcuy,
                             const uint8_t* p, const uint8_t* end);

// The next marker's code from *p, skipping anything before it as libjpeg's
// next_marker does; -1 at the end of the file.
inline int next_marker(const uint8_t** p, const uint8_t* end) {
  const uint8_t* q = *p;
  while (true) {
    while (q < end && *q != 0xFF) q++;
    while (q < end && *q == 0xFF) q++;
    if (q >= end) {
      *p = q;
      return -1;
    }
    const int m = *q++;
    if (m != 0) {
      *p = q;
      return m;
    }
  }
}

}  // namespace jpeg
}  // namespace byogan
