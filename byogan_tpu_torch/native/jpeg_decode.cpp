// A JPEG decoder that gives the RGB of the JAX package's lanes, bit for bit:
// libjpeg-turbo's for its native call (byogan_tpu/native/byogan_io.cpp:
// 101-132: jpeg_read_header, then out_color_space = JCS_RGB and the
// library's defaults) and Pillow's (Image.open(...).convert("RGB"), over
// the libjpeg-turbo 3.1.3 that Pillow 12.1.0 bundles) where the native lane
// refuses a file or the two lanes differ.
//
// Every stage of that output is integer arithmetic, so each is libjpeg's
// own: Huffman decoding (sequential and progressive, restart intervals) and
// arithmetic decoding (jdarith.c, in jpeg_arith.cpp), the whole coefficient
// image kept until the last scan (as libjpeg does for multi-scan files
// outside buffered-image mode), dequantisation and the accurate integer
// IDCT (JDCT_ISLOW) as libjpeg-turbo's SIMD code (jidctint-avx2/-sse2,
// which both lanes run) computes it in 16-bit lanes, the block smoothing of
// jdcoefct.c (libjpeg-turbo 3.1.3) for progressive files whose scans leave
// low-frequency coefficients unfinished, the chroma upsampling of jdsample.c
// with do_fancy_upsampling (the h2v1, h2v2 and h1v2 triangle filters, boxes
// for the other integral ratios), and the colour conversions of jdcolor.c:
// YCbCr -> RGB, and YCCK -> CMYK for 4-component files, whose CMYK Pillow
// then inverts (rawmode "CMYK;I") and converts to RGB (cmyk2rgb).  Lossless
// frames (SOF3, 8-bit: jpeg_lossless.cpp) take the same upsampling (boxes)
// and colour path.  A JPEG-compressed TIFF's strips and tiles take the same
// path (decode_jpeg_tiff): the JPEGTables stream read first, the colour
// space set by libtiff's codec, not by the stream's markers.
//
// Not read, each with its own return code: samples of other than 8 bits in
// a DCT frame, hierarchical frames, lossless frames that Pillow's
// libjpeg-turbo refuses (arithmetic coding, precision other than 8 bits, a
// colour conversion), two components, and fractional sampling ratios.  A
// file that ends before its EOI marker or breaks the format's rules fails:
// libjpeg would fill the missing blocks and warn.

#include <climits>
#include <memory>
#include <new>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#include "jpeg.h"

namespace byogan {
namespace jpeg {

void derive(const HuffSpec& spec, int max_symbol, Huff* t) {
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < spec.bits[l]; i++) size[p++] = (uint8_t)l;
  size[p] = 0;
  const int count = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) fail(kCorrupt);  // more codes than the lengths hold
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (spec.bits[l]) {
      t->valoffset[l] = p - (int)code[p];
      p += spec.bits[l];
      t->maxcode[l] = (int32_t)code[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0xFFFFF;
  memset(t->look, 0, sizeof(t->look));
  for (p = 0; p < count && size[p] <= kLookBits; p++) {
    const int l = size[p];
    const int base = (int)code[p] << (kLookBits - l);
    for (int k = 0; k < (1 << (kLookBits - l)); k++) t->look[base + k] = (uint16_t)((l << 8) | spec.vals[p]);
  }
  memcpy(t->vals, spec.vals, sizeof(t->vals));
  for (int i = 0; i < count; i++)
    if (spec.vals[i] > max_symbol) fail(kCorrupt);
}

namespace {

// jdhuff.c and jdphuff.c: the Huffman decoder of a scan of DCT blocks.
class HuffmanDecoder final : public Entropy {
 public:
  HuffmanDecoder(const Scan& scan, const Huff* dc[4], const Huff* ac[4], const uint8_t* end) : scan_(scan) {
    for (int i = 0; i < scan.n; i++) dc_[i] = dc[i], ac_[i] = ac[i];
    b_.end = end;
    if (!scan.progressive) kind_ = kSeq;
    else if (scan.ss == 0) kind_ = scan.ah ? kDcRefine : kDcFirst;
    else kind_ = scan.ah ? kAcRefine : kAcFirst;
  }

  void start(const uint8_t* p) override {
    b_.reset(p);
    for (int i = 0; i < scan_.n; i++) scan_.comp[i]->pred = 0;
    eobrun_ = 0;
  }

  const uint8_t* stop() override { return b_.stop(); }

  void mcu(int16_t* const* blocks, const int* which, int count) override {
    const int al = scan_.al;
    for (int i = 0; i < count; i++) {
      Component& k = *scan_.comp[which[i]];
      int16_t* blk = blocks[i];
      switch (kind_) {
        case kSeq:
          sequential(k, *dc_[which[i]], *ac_[which[i]], blk);
          break;
        case kDcFirst:
          dc_first(k, *dc_[which[i]], blk, al);
          break;
        case kDcRefine:
          if (b_.bit()) blk[0] = (int16_t)(blk[0] | (1 << al));
          break;
        case kAcFirst:
          ac_first(*ac_[which[i]], blk, scan_.ss, scan_.se, al);
          break;
        case kAcRefine:
          ac_refine(*ac_[which[i]], blk, scan_.ss, scan_.se, al);
          break;
      }
    }
  }

 private:
  enum Kind { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine };
  Scan scan_;
  const Huff* dc_[4] = {nullptr};
  const Huff* ac_[4] = {nullptr};
  Kind kind_;
  Bits b_;
  int eobrun_ = 0;

  // The DC predictor plus a difference; libjpeg-turbo refuses a sum past
  // int's range (JERR_BAD_DCT_COEF).
  static void add_dc(Component& k, int s) {
    if ((k.pred >= 0 && s > INT_MAX - k.pred) || (k.pred < 0 && s < INT_MIN - k.pred)) fail(kCorrupt);
    k.pred += s;
  }

  void sequential(Component& k, const Huff& dc, const Huff& ac, int16_t* blk) {
    int s = b_.decode(dc);
    if (s) s = extend(b_.get(s), s);
    add_dc(k, s);
    blk[0] = (int16_t)k.pred;
    for (int i = 1; i < 64; i++) {
      const int rs = b_.decode(ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        if (i > 63) fail(kCorrupt);
        blk[kNatural[i]] = (int16_t)extend(b_.get(s), s);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void dc_first(Component& k, const Huff& dc, int16_t* blk, int al) {
    int s = b_.decode(dc);
    if (s) s = extend(b_.get(s), s);
    add_dc(k, s);
    blk[0] = (int16_t)((unsigned)k.pred << al);
  }

  void ac_first(const Huff& ac, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
      eobrun_--;
      return;
    }
    for (int i = ss; i <= se; i++) {
      const int rs = b_.decode(ac);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        if (i > se) fail(kCorrupt);
        blk[kNatural[i]] = (int16_t)(extend(b_.get(s), s) * (1 << al));
      } else if (r == 15) {
        i += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += b_.get(r);
        eobrun_--;
        break;
      }
    }
  }

  // jdphuff.c's decode_mcu_AC_refine.
  void ac_refine(const Huff& ac, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    if (eobrun_ == 0) {
      for (; i <= se; i++) {
        const int rs = b_.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = b_.bit() ? p1 : m1;  // a size other than 1 is bad data, which libjpeg decodes as 1
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += b_.get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[i];
          if (*c != 0) {
            if (b_.bit() && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          } else {
            if (--r < 0) break;
          }
          i++;
        } while (i <= se);
        if (s) {
          if (i > se) fail(kCorrupt);
          blk[kNatural[i]] = (int16_t)s;
        }
      }
    }
    if (eobrun_ > 0) {
      for (; i <= se; i++) {
        int16_t* c = blk + kNatural[i];
        if (*c != 0 && b_.bit() && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
      }
      eobrun_--;
    }
  }
};

// jdcolor.c's YCbCr -> RGB tables, as constants of x = C - 128.
constexpr int kScale = 16;
constexpr int32_t kHalf = 1 << (kScale - 1);
constexpr int32_t fix(double x) { return (int32_t)(x * (1 << kScale) + 0.5); }
inline int cr_r(int x) { return (fix(1.40200) * x + kHalf) >> kScale; }
inline int cb_b(int x) { return (fix(1.77200) * x + kHalf) >> kScale; }
inline int cbcr_g(int cb, int cr) { return ((-fix(0.34414)) * cb + kHalf + (-fix(0.71414)) * cr) >> kScale; }
inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// Pillow's cmyk2rgb (Convert.c) on the inverted samples of rawmode "CMYK;I":
// with k the inverted K, each of R, G and B is nk - nk * c / 255 rounded
// (MULDIV255), nk = 255 - k = the sample libjpeg gave.
inline uint8_t cmyk_channel(int sample, int nk) {
  const int c = 255 - sample;
  const int t = c * nk + 128;
  return clamp255(nk - (((t >> 8) + t) >> 8));
}

// The IDCT's last step as libjpeg-turbo's SIMD islow IDCT takes it (both
// JAX lanes run it): the sample packed to 16 bits, then to a signed byte,
// each with saturation, and 128 added: x + 128 clamped to [0, 255].
// (jidctint.c masks x with RANGE_MASK and looks it up in range_limit
// instead, which wraps where |x| >= 512.)
inline uint8_t idct_limit(int64_t x) { return (uint8_t)(x < -128 ? 0 : x > 127 ? 255 : x + 128); }

constexpr int kConst = 13, kPass1 = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                  F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

// Below this sum of |dequantised coefficient| in every column, no
// intermediate of the 16-bit SIMD IDCT leaves its range: a pass-1 output is
// at most 5.5484 times the column's sum, so |w| <= 16091 and pass 2's 16-bit
// sums of two outputs cannot wrap.  There jidctint.c's arithmetic in 64 bits
// (idct_wide) gives the SIMD's samples; elsewhere idct_simd16 follows the
// 16-bit lanes, to the same samples where both hold, more slowly.  A
// photograph's blocks stay below it.
constexpr uint32_t kWideColumnSum = 2900;

// Each |coefficient x quantiser| is saturated to 16 bits and summed down
// its column with saturation: a block a single test, 8 rows of 8 lanes.
bool wide_is_exact(const int16_t* coef, const int16_t* q) {
#if defined(__SSE2__)
  const __m128i zero = _mm_setzero_si128(), ones = _mm_set1_epi16(-1);
  __m128i acc = zero;
  for (int r = 0; r < 8; r++) {
    const __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(coef + 8 * r));
    const __m128i k = _mm_loadu_si128(reinterpret_cast<const __m128i*>(q + 8 * r));
    const __m128i a = _mm_max_epi16(c, _mm_sub_epi16(zero, c));  // |c|, -32768 read as 32768
    const __m128i fits = _mm_cmpeq_epi16(_mm_mulhi_epu16(a, k), zero);
    const __m128i p = _mm_or_si128(_mm_and_si128(_mm_mullo_epi16(a, k), fits), _mm_andnot_si128(fits, ones));
    acc = _mm_adds_epu16(acc, p);
  }
  const __m128i over = _mm_subs_epu16(acc, _mm_set1_epi16((short)kWideColumnSum));
  return _mm_movemask_epi8(_mm_cmpeq_epi16(over, zero)) == 0xFFFF;
#else
  uint16_t col[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 64; i++) {
    const uint32_t a = (uint32_t)(coef[i] < 0 ? -coef[i] : coef[i]) * (uint16_t)q[i];
    const uint32_t t = (uint32_t)col[i & 7] + (a < 65535u ? a : 65535u);
    col[i & 7] = (uint16_t)(t < 65535u ? t : 65535u);
  }
  for (int c = 0; c < 8; c++)
    if (col[c] > kWideColumnSum) return false;
  return true;
#endif
}

inline int16_t wrap16(int64_t v) { return (int16_t)(uint16_t)(uint64_t)v; }
inline int32_t wrap32(int64_t v) { return (int32_t)(uint32_t)(uint64_t)v; }

// One 1-D pass of jidctint-avx2/-sse2 over 8 samples of 16 bits: the sums
// in0 + in4, in0 - in4, in7 + in3 and in5 + in1 in 16 bits (they wrap), the
// products in 32 (pmaddwd), the results in 32-bit lanes, rounded and
// shifted right by `shift`.
void simd16_pass(const int16_t* in, int shift, int32_t* out) {
  const int64_t tmp3 = in[2] * (F0541 + F0765) + in[6] * F0541;
  const int64_t tmp2 = in[2] * F0541 + in[6] * (F0541 - F1847);
  const int64_t tmp0 = (int64_t)wrap16(in[0] + in[4]) * (1 << kConst);
  const int64_t tmp1 = (int64_t)wrap16(in[0] - in[4]) * (1 << kConst);
  const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  const int64_t z3 = wrap16(in[7] + in[3]), z4 = wrap16(in[5] + in[1]);
  const int64_t z3p = z3 * (F1175 - F1961) + z4 * F1175, z4p = z3 * F1175 + z4 * (F1175 - F0390);
  const int64_t a0 = in[7] * (F0298 - F0899) - in[1] * F0899 + z3p;
  const int64_t a3 = -in[7] * F0899 + in[1] * (F1501 - F0899) + z4p;
  const int64_t a1 = in[5] * (F2053 - F2562) - in[3] * F2562 + z4p;
  const int64_t a2 = -in[5] * F2562 + in[3] * (F3072 - F2562) + z3p;
  const int64_t v[8] = {t10 + a3, t11 + a2, t12 + a1, t13 + a0, t13 - a0, t12 - a1, t11 - a2, t10 - a3};
  for (int k = 0; k < 8; k++) out[k] = wrap32(v[k] + (1 << (shift - 1))) >> shift;
}

// jidctint-avx2/-sse2 (libjpeg-turbo's SIMD islow IDCT) on one block, where
// its 16-bit lanes part from jidctint.c: the dequantisation product kept to
// 16 bits; where rows 1-7 of the whole block are zero (before
// dequantisation), each column's DC shifted left in 16 bits; otherwise
// pass 1's outputs packed to 16 bits with saturation; the final pack with
// saturation (idct_limit).
void idct_simd16(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  int16_t ws[64];
  bool ac_zero = true;
  for (int i = 8; i < 64; i++) ac_zero &= coef[i] == 0;
  int16_t col[8];
  int32_t res[8];
  for (int c = 0; c < 8; c++) {
    if (ac_zero) {
      const int16_t dc = wrap16(wrap16((int32_t)coef[c] * q[c]) * (1 << kPass1));
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
      continue;
    }
    for (int r = 0; r < 8; r++) col[r] = wrap16((int32_t)coef[r * 8 + c] * q[r * 8 + c]);
    simd16_pass(col, kConst - kPass1, res);
    for (int r = 0; r < 8; r++) ws[r * 8 + c] = (int16_t)(res[r] < -32768 ? -32768 : res[r] > 32767 ? 32767 : res[r]);
  }
  for (int r = 0; r < 8; r++) {
    simd16_pass(ws + r * 8, kConst + kPass1 + 3, res);
    for (int k = 0; k < 8; k++) out[(size_t)r * stride + k] = idct_limit(res[k]);
  }
}

// jidctint.c's jpeg_idct_islow on one dequantised block, in JLONG's 64 bits,
// with the SIMD's final limit: exact where wide_is_exact holds.
void idct_wide(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int16_t* qc = q + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      const int dc = (int)((int64_t)(in[0] * qc[0]) * (1 << kPass1));
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = in[16] * qc[16], z3 = in[48] * qc[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = in[0] * qc[0];
    z3 = in[32] * qc[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConst);
    int64_t tmp1 = (z2 - z3) * (1 << kConst);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = in[56] * qc[56];
    tmp1 = in[40] * qc[40];
    tmp2 = in[24] * qc[24];
    tmp3 = in[8] * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * -F1961 + z5;
    z4 = z4 * -F0390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConst - kPass1;
    constexpr int64_t rnd = 1 << (sh - 1);
    ws[0 * 8 + c] = (int)((t10 + tmp3 + rnd) >> sh);
    ws[7 * 8 + c] = (int)((t10 - tmp3 + rnd) >> sh);
    ws[1 * 8 + c] = (int)((t11 + tmp2 + rnd) >> sh);
    ws[6 * 8 + c] = (int)((t11 - tmp2 + rnd) >> sh);
    ws[2 * 8 + c] = (int)((t12 + tmp1 + rnd) >> sh);
    ws[5 * 8 + c] = (int)((t12 - tmp1 + rnd) >> sh);
    ws[3 * 8 + c] = (int)((t13 + tmp0 + rnd) >> sh);
    ws[4 * 8 + c] = (int)((t13 - tmp0 + rnd) >> sh);
  }
  constexpr int sh = kConst + kPass1 + 3;
  constexpr int64_t rnd = 1 << (sh - 1);
  for (int r = 0; r < 8; r++) {
    const int* w = ws + r * 8;
    uint8_t* o = out + (size_t)r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t dc = idct_limit(((int64_t)w[0] + (1 << (kPass1 + 2))) >> (kPass1 + 3));
      memset(o, dc, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConst);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConst);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * -F1961 + z5;
    z4 = z4 * -F0390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit((t10 + tmp3 + rnd) >> sh);
    o[7] = idct_limit((t10 - tmp3 + rnd) >> sh);
    o[1] = idct_limit((t11 + tmp2 + rnd) >> sh);
    o[6] = idct_limit((t11 - tmp2 + rnd) >> sh);
    o[2] = idct_limit((t12 + tmp1 + rnd) >> sh);
    o[5] = idct_limit((t12 - tmp1 + rnd) >> sh);
    o[3] = idct_limit((t13 + tmp0 + rnd) >> sh);
    o[4] = idct_limit((t13 - tmp0 + rnd) >> sh);
  }
}

// jidctint.c's jpeg_idct_islow compiled for 12-bit samples, as
// libjpeg-turbo 3 decodes a 12-bit frame (no SIMD code there): PASS1_BITS
// 1, products in JLONG, the workspace in int, and the range limit's
// table: the sample masked to 14 bits and read as x + 2048 clamped to
// [0, 4095], wrapping where |x| passes 8191.
void idct12(const int16_t* coef, const int32_t* q, uint16_t* out, int stride) {
  constexpr int kConst = 13, kPass1 = 1;
  auto fix = [](double x) { return (int64_t)(x * (1 << kConst) + 0.5); };
  const int64_t f0298 = fix(0.298631336), f0390 = fix(0.390180644), f0541 = fix(0.541196100),
                f0765 = fix(0.765366865), f0899 = fix(0.899976223), f1175 = fix(1.175875602),
                f1501 = fix(1.501321110), f1847 = fix(1.847759065), f1961 = fix(1.961570560),
                f2053 = fix(2.053119869), f2562 = fix(2.562915447), f3072 = fix(3.072711026);
  auto descale = [](int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; };
  auto limit = [](int64_t x) -> uint16_t {
    const int v = (int)(x & 16383), s = v < 8192 ? v : v - 16384;
    const int r = s + 2048;
    return (uint16_t)(r < 0 ? 0 : r > 4095 ? 4095 : r);
  };
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int32_t* qq = q + c;
    auto dq = [&](int r) { return (int64_t)in[8 * r] * qq[8 * r]; };
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      const int dc = (int)(dq(0) * (1 << kPass1));
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
      continue;
    }
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * f0541;
    const int64_t t2 = z1 + z3 * -f1847, t3 = z1 + z2 * f0765;
    z2 = dq(0), z3 = dq(4);
    const int64_t t0 = (z2 + z3) * (1 << kConst), t1 = (z2 - z3) * (1 << kConst);
    const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    int64_t o0 = dq(7), o1 = dq(5), o2 = dq(3), o3 = dq(1);
    z1 = o0 + o3, z2 = o1 + o2, z3 = o0 + o2;
    int64_t z4 = o1 + o3;
    const int64_t z5 = (z3 + z4) * f1175;
    o0 *= f0298, o1 *= f2053, o2 *= f3072, o3 *= f1501;
    z1 *= -f0899, z2 *= -f2562, z3 *= -f1961, z4 *= -f0390;
    z3 += z5, z4 += z5;
    o0 += z1 + z3, o1 += z2 + z4, o2 += z2 + z3, o3 += z1 + z4;
    ws[c] = (int)descale(t10 + o3, kConst - kPass1);
    ws[56 + c] = (int)descale(t10 - o3, kConst - kPass1);
    ws[8 + c] = (int)descale(t11 + o2, kConst - kPass1);
    ws[48 + c] = (int)descale(t11 - o2, kConst - kPass1);
    ws[16 + c] = (int)descale(t12 + o1, kConst - kPass1);
    ws[40 + c] = (int)descale(t12 - o1, kConst - kPass1);
    ws[24 + c] = (int)descale(t13 + o0, kConst - kPass1);
    ws[32 + c] = (int)descale(t13 - o0, kConst - kPass1);
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint16_t* o = out + (size_t)r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint16_t dc = limit(descale(w[0], kPass1 + 3));
      for (int k = 0; k < 8; k++) o[k] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * f0541;
    const int64_t t2 = z1 + z3 * -f1847, t3 = z1 + z2 * f0765;
    const int64_t t0 = ((int64_t)w[0] + w[4]) * (1 << kConst), t1 = ((int64_t)w[0] - w[4]) * (1 << kConst);
    const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    int64_t o0 = w[7], o1 = w[5], o2 = w[3], o3 = w[1];
    z1 = o0 + o3, z2 = o1 + o2, z3 = o0 + o2;
    int64_t z4 = o1 + o3;
    const int64_t z5 = (z3 + z4) * f1175;
    o0 *= f0298, o1 *= f2053, o2 *= f3072, o3 *= f1501;
    z1 *= -f0899, z2 *= -f2562, z3 *= -f1961, z4 *= -f0390;
    z3 += z5, z4 += z5;
    o0 += z1 + z3, o1 += z2 + z4, o2 += z2 + z3, o3 += z1 + z4;
    const int n = kConst + kPass1 + 3;
    o[0] = limit(descale(t10 + o3, n)), o[7] = limit(descale(t10 - o3, n));
    o[1] = limit(descale(t11 + o2, n)), o[6] = limit(descale(t11 - o2, n));
    o[2] = limit(descale(t12 + o1, n)), o[5] = limit(descale(t12 - o1, n));
    o[3] = limit(descale(t13 + o0, n)), o[4] = limit(descale(t13 - o0, n));
  }
}

// libjpeg-turbo's islow IDCT on one block as its SIMD code computes it (what
// both of the JAX package's lanes run): the 64-bit arithmetic where the
// block's coefficients keep it exact, the 16-bit lanes elsewhere.
void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  if (wide_is_exact(coef, q)) {
    idct_wide(coef, q, out, stride);
  } else {
    idct_simd16(coef, q, out, stride);
  }
}

// jdcoefct.c's estimate of one coefficient from the neighbours' DC values
// (libjpeg-turbo 3.1.3's decompress_smooth_data): num / (q << 8) rounded
// half away from zero, kept below 2^al where the coefficient's low bits
// are still to come.
inline int16_t smooth_estimate(int64_t num, int64_t q, int al) {
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return (int16_t)pred;
}

// The natural places of zigzag 0-9, the coefficients block smoothing reads.
constexpr int kSaved[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), end_(data + size) {}

  // four components read as CMYK whatever the Adobe marker says (no YCCK
  // conversion): BLP1's JPEG, whose reader sets Pillow's jpegmode to CMYK
  bool force_cmyk_ = false;

  int run(uint8_t* out, int* h, int* w) {
    if (end_ - d_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail(kNotImage);
    p_ = d_ + 2;
    int m = read_header();  // up to the first SOS
    if (!out || height_ != *h || width_ != *w) {
      *h = height_, *w = width_;
      return kSize;
    }
    decode(m, out);
    return kOk;
  }

  // One strip or tile of a JPEG-compressed TIFF as libtiff's JPEG codec
  // decodes it: the JPEGTables stream first (its tables persist, as
  // jpeg_read_header(FALSE) leaves them), then the image's, whose SOI
  // resets the restart interval, the arithmetic conditioning and the
  // JFIF and Adobe markers; the colour space is the codec's, not the
  // stream's.  `ycbcr` (PHOTOMETRIC_YCBCR under JPEGCOLORMODE_RGB): YCbCr
  // -> RGB, 3 samples a pixel; else JCS_UNKNOWN, every component as it is.
  // A stream's components after the IDCT, each at its own sampling
  // (libjpeg's raw_data_out, as libtiff's old-JPEG codec reads YCbCr):
  // planes[c] of bw * 8 columns (strides[c]) and bh * 8 rows.
  int run_planes(JpegFrame* f, std::vector<uint8_t>* planes, int* strides) {
    if (end_ - d_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail(kCorrupt);
    p_ = d_ + 2;
    forced_ = kUnknown;
    const int m = read_header();
    if (lossless_ || progressive_) fail(kCorrupt);
    f->h = height_, f->w = width_, f->components = ncomp_, f->marker = sof_;
    for (int c = 0; c < ncomp_; c++) f->hsamp[c] = comp_[c].h, f->vsamp[c] = comp_[c].v;
    raw_planes_ = planes;
    raw_strides_ = strides;
    decode(m, nullptr);
    return kOk;
  }

  // One strip or tile of a 12-bit gray JPEG-compressed TIFF (libtiff's
  // JPEG codec over libjpeg-turbo's 12-bit decoder): the JPEGTables stream
  // first, then a one-component frame of 12-bit precision, its samples.
  int run_tiff12(const uint8_t* tables, size_t tables_size, JpegFrame* f, std::vector<uint16_t>* out) {
    allow12_ = true;
    if (tables_size) read_tables(tables, tables_size);
    if (end_ - d_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail(kCorrupt);
    p_ = d_ + 2;
    forced_ = kUnknown;
    const int m = read_header();
    f->h = height_, f->w = width_, f->components = ncomp_, f->marker = sof_;
    f->hsamp[0] = comp_[0].h, f->vsamp[0] = comp_[0].v;
    // "Improper JPEG data precision", "Improper JPEG component count"; the
    // sequential frames alone
    if (precision_ != 12 || ncomp_ != 1 || (sof_ != 0xC0 && sof_ != 0xC1)) return kTiffJpegStream;
    out->resize((size_t)height_ * width_);
    out12_ = out->data();
    decode(m, nullptr);
    return kOk;
  }

  int run_tiff(const uint8_t* tables, size_t tables_size, bool ycbcr, int components, JpegFrame* f,
               std::vector<uint8_t>* out) {
    if (tables_size) read_tables(tables, tables_size);
    if (end_ - d_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail(kCorrupt);  // "Not a JPEG file"
    p_ = d_ + 2;
    forced_ = ycbcr ? kYCbCr : kUnknown;
    const int m = read_header();
    f->h = height_, f->w = width_, f->components = ncomp_, f->marker = sof_;
    for (int c = 0; c < ncomp_; c++) f->hsamp[c] = comp_[c].h, f->vsamp[c] = comp_[c].v;
    if (ncomp_ != components) return kTiffJpegStream;  // "Improper JPEG component count"
    out->resize((size_t)height_ * width_ * (ycbcr ? 3 : ncomp_));
    decode(m, out->data());
    return kOk;
  }

 private:
  enum Space { kGray, kYCbCr, kRgb, kCmyk, kYcck, kUnknown };
  const uint8_t* d_;
  const uint8_t* end_;
  const uint8_t* p_ = nullptr;
  int forced_ = -1;  // a colour space the caller sets (run_tiff), or -1
  int sof_ = 0;      // the frame's marker
  std::vector<uint8_t>* raw_planes_ = nullptr;  // run_planes: where the IDCT's planes go
  int* raw_strides_ = nullptr;
  bool allow12_ = false;  // run_tiff12: a 12-bit frame is read
  int precision_ = 8;
  uint16_t* out12_ = nullptr;

  void read_tables(const uint8_t* t, size_t n) {
    const uint8_t *save_p = p_, *save_end = end_;
    p_ = t, end_ = t + n;
    if (n < 2 || t[0] != 0xFF || t[1] != 0xD8) fail(kCorrupt);
    p_ += 2;
    while (true) {
      const int m = next_marker(&p_, end_);
      if (m == 0xD9) break;
      if (m < 0) fail(kTruncated);
      if (m == 0xDA || (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC))
        fail(kCorrupt);  // a frame: "Bogus JPEGTables field"
      marker(m);
    }
    p_ = save_p, end_ = save_end;
    restart_ = 0;
    cond_ = ArithConditioning();
    jfif_ = adobe_ = false;
    adobe_transform_ = -1;
  }

  void decode(int m, uint8_t* out) {
    allocate();
    bool eoi = false;
    while (true) {
      if (m == 0xDA) {
        scan();
      } else if (m == 0xD9) {
        eoi = true;
        break;
      } else if (m < 0) {
        break;  // the file ended
      } else {
        marker(m);
      }
      m = next_marker(&p_, end_);
    }
    if (!eoi) fail(kTruncated);
    if (out12_) output12();
    else output(out);
  }

  // A 12-bit frame's one component: the IDCT of each block, its rows cut
  // to the image.
  void output12() {
    Component& k = comp_[0];
    const int stride = k.bw * 8;
    std::vector<uint16_t> plane((size_t)stride * k.bh * 8);
    for (int by = 0; by < k.bh; by++)
      for (int bx = 0; bx < k.bw; bx++)
        idct12(k.block(by, bx), k.q12, plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
    for (int y = 0; y < height_; y++)
      memcpy(out12_ + (size_t)y * width_, plane.data() + (size_t)y * stride, (size_t)width_ * 2);
  }

  int width_ = 0, height_ = 0, ncomp_ = 0;
  bool frame_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  Space space_ = kGray;
  int restart_ = 0;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  Component comp_[4];
  bool has_q_[4] = {false, false, false, false};
  uint16_t qt_[4][64];
  bool has_h_[2][4] = {{false}};  // [ac][slot]
  HuffSpec hspec_[2][4];
  Huff huff_[2][4];  // derived at each scan's start
  ArithConditioning cond_;

  int byte() {
    if (p_ >= end_) fail(kTruncated);
    return *p_++;
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  // The body of a marker with a length field: [start, end).
  const uint8_t* segment(int* len) {
    const int n = word();
    if (n < 2) fail(kCorrupt);
    if (end_ - p_ < n - 2) fail(kTruncated);
    *len = n - 2;
    const uint8_t* s = p_;
    p_ += n - 2;
    return s;
  }

  int read_header() {
    while (true) {
      const int m = next_marker(&p_, end_);
      if (m < 0) fail(kTruncated);
      if (m == 0xDA) {
        if (!frame_) fail(kCorrupt);
        space_ = forced_ >= 0 ? (Space)forced_ : color_space();  // fixed at the first scan, as jpeg_read_header fixes it
        if (lossless_ && space_ == kYCbCr && forced_ >= 0) fail(kJpegLossless);
        return m;
      }
      if (m == 0xD9) fail(kCorrupt);  // no image
      marker(m);
    }
  }

  void marker(int m) {
    int len;
    if (m >= 0xD0 && m <= 0xD7) return;  // a stray restart: libjpeg ignores it
    if (m == 0x01) return;               // TEM
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
      case 0xC3:
      case 0xC9:
      case 0xCA:
      case 0xCB:
        frame(m);
        return;
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
      case 0xDE:
      case 0xDF:
        fail(kJpegHierarchical);
      case 0xC4:
        dht();
        return;
      case 0xCC:
        dac();
        return;
      case 0xDB:
        dqt();
        return;
      case 0xDD: {
        const uint8_t* s = segment(&len);
        if (len != 2) fail(kCorrupt);
        restart_ = (s[0] << 8) | s[1];
        return;
      }
      default:
        break;
    }
    if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {  // APPn, COM, DNL
      const uint8_t* s = segment(&len);
      if (m == 0xE0 && len >= 14 && memcmp(s, "JFIF\0", 5) == 0) jfif_ = true;
      if (m == 0xEE && len >= 12 && memcmp(s, "Adobe", 5) == 0) {
        adobe_ = true;
        adobe_transform_ = s[11];
      }
      return;
    }
    fail(kCorrupt);  // a marker JPEG does not define here
  }

  void frame(int m) {
    if (frame_) fail(kCorrupt);
    int len;
    const uint8_t* s = segment(&len);
    if (len < 6) fail(kCorrupt);
    const int precision = s[0];
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    ncomp_ = s[5];
    sof_ = m;
    lossless_ = m == 0xC3 || m == 0xCB;
    arith_ = m >= 0xC9;
    progressive_ = m == 0xC2 || m == 0xCA;
    // Pillow reads 8-bit samples alone; its libjpeg-turbo has no lossless
    // arithmetic decoder.
    if (lossless_ && (arith_ || precision != 8)) fail(kJpegLossless);
    if (precision == 12 && allow12_) precision_ = 12;
    else if (precision != 8) fail(kJpeg12Bit);
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4) fail(kNotRgb);
    if (len != 6 + 3 * ncomp_ || height_ == 0 || width_ == 0) fail(kCorrupt);
    if (height_ > 65500 || width_ > 65500) fail(kCorrupt);  // libjpeg's JPEG_MAX_DIMENSION
    for (int c = 0; c < ncomp_; c++) {
      Component& k = comp_[c];
      k.id = s[6 + 3 * c];
      k.h = s[7 + 3 * c] >> 4;
      k.v = s[7 + 3 * c] & 15;
      k.tq = s[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) fail(kCorrupt);
      hmax_ = k.h > hmax_ ? k.h : hmax_;
      vmax_ = k.v > vmax_ ? k.v : vmax_;
    }
    for (int c = 0; c < ncomp_; c++)
      if (hmax_ % comp_[c].h || vmax_ % comp_[c].v) fail(kJpegSampling);  // jdsample.c's JERR_FRACT_SAMPLE_NOTIMPL
    frame_ = true;
  }

  void dqt() {
    int len;
    const uint8_t* s = segment(&len);
    const uint8_t* e = s + len;
    while (s < e) {
      const int prec = *s >> 4, slot = *s & 15;
      s++;
      if (slot > 3 || prec > 1 || e - s < 64 * (prec + 1)) fail(kCorrupt);
      for (int i = 0; i < 64; i++) {
        qt_[slot][kNatural[i]] = prec ? (uint16_t)((s[2 * i] << 8) | s[2 * i + 1]) : s[i];
      }
      s += 64 * (prec + 1);
      has_q_[slot] = true;
    }
  }

  void dht() {
    int len;
    const uint8_t* s = segment(&len);
    const uint8_t* e = s + len;
    while (e - s > 16) {
      const int index = *s++;
      const int ac = (index >> 4) & 1, slot = index & 15;
      if (slot > 3 || (index >> 4) > 1) fail(kCorrupt);
      HuffSpec& spec = hspec_[ac][slot];
      memset(&spec, 0, sizeof(spec));
      int count = 0;
      for (int l = 1; l <= 16; l++) count += spec.bits[l] = *s++;
      if (count > 256 || e - s < count) fail(kCorrupt);
      memcpy(spec.vals, s, count);
      s += count;
      has_h_[ac][slot] = true;
    }
    if (s != e) fail(kCorrupt);
  }

  // jdmarker.c's get_dac: (table, value) pairs; an AC table's Kx, a DC
  // table's L (low nibble) and U, with L <= U.
  void dac() {
    int len;
    const uint8_t* s = segment(&len);
    if (len & 1) fail(kCorrupt);
    for (int i = 0; i < len; i += 2) {
      const int index = s[i], val = s[i + 1];
      if (index >= 32) fail(kCorrupt);
      if (index >= 16) {
        cond_.ac_k[index - 16] = (uint8_t)val;
      } else {
        cond_.dc_l[index] = (uint8_t)(val & 15);
        cond_.dc_u[index] = (uint8_t)(val >> 4);
        if ((val & 15) > (val >> 4)) fail(kCorrupt);
      }
    }
  }

  void allocate() {
    // a lossless frame's data unit is one sample, a DCT frame's a block of 8 x 8
    const int unit = lossless_ ? 1 : 8;
    mcux_ = (width_ + unit * hmax_ - 1) / (unit * hmax_);
    mcuy_ = (height_ + unit * vmax_ - 1) / (unit * vmax_);
    for (int c = 0; c < ncomp_; c++) {
      Component& k = comp_[c];
      k.dw = (int)(((long)width_ * k.h + hmax_ - 1) / hmax_);
      k.dh = (int)(((long)height_ * k.v + vmax_ - 1) / vmax_);
      k.bw = (k.dw + unit - 1) / unit;
      k.bh = (k.dh + unit - 1) / unit;
      k.bwp = mcux_ * k.h;
      k.bhp = mcuy_ * k.v;
      if (lossless_) k.plane.assign((size_t)k.bwp * k.bhp, 0);
      else k.coef.assign((size_t)k.bwp * k.bhp * 64, 0);
      for (int i = 0; i < 64; i++) k.bits[i] = -1;
    }
  }

  // Derive a Huffman table a scan uses; libjpeg-turbo's std_huff_tables
  // stand in for the first two slots where no DHT defined them.
  const Huff* use_table(int ac, int slot) {
    if (slot > 3) fail(kCorrupt);
    if (!has_h_[ac][slot]) {
      if (slot > 1) fail(kCorrupt);
      hspec_[ac][slot] = ac ? (slot ? kStdAcChroma : kStdAcLuma) : (slot ? kStdDcChroma : kStdDcLuma);
      has_h_[ac][slot] = true;
    }
    derive(hspec_[ac][slot], ac ? 255 : lossless_ ? 16 : 15, &huff_[ac][slot]);
    return &huff_[ac][slot];
  }

  void scan() {
    int len;
    const uint8_t* s = segment(&len);
    if (len < 1) fail(kCorrupt);
    Scan sc;
    sc.n = s[0];
    const int n = sc.n;
    if (n < 1 || n > 4 || n > ncomp_ || len != 4 + 2 * n) fail(kCorrupt);
    for (int i = 0; i < n; i++) {
      const int id = s[1 + 2 * i];
      int c = 0;
      while (c < ncomp_ && comp_[c].id != id) c++;
      if (c == ncomp_) fail(kCorrupt);
      for (int j = 0; j < i; j++)
        if (sc.comp[j] == &comp_[c]) fail(kCorrupt);
      sc.comp[i] = &comp_[c];
      sc.comp[i]->td = s[2 + 2 * i] >> 4;
      sc.comp[i]->ta = s[2 + 2 * i] & 15;
    }
    sc.ss = s[1 + 2 * n], sc.se = s[2 + 2 * n], sc.ah = s[3 + 2 * n] >> 4, sc.al = s[3 + 2 * n] & 15;
    sc.progressive = progressive_;
    if (lossless_) {
      lossless(sc);
      return;
    }
    // latch_quant_tables: a component keeps the table of its first scan
    for (int i = 0; i < n; i++) {
      Component& k = *sc.comp[i];
      if (k.latched) continue;
      if (!has_q_[k.tq]) fail(kCorrupt);
      for (int j = 0; j < 64; j++) k.q[j] = (int16_t)qt_[k.tq][j], k.q12[j] = qt_[k.tq][j];
      k.latched = true;
    }
    if (n > 1) {  // jdinput.c's per_scan_setup: D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (int i = 0; i < n; i++) blocks += sc.comp[i]->h * sc.comp[i]->v;
      if (blocks > 10) fail(kCorrupt);
    }
    int rows, cols;  // MCUs
    if (n == 1) {
      cols = sc.comp[0]->bw;
      rows = sc.comp[0]->bh;
    } else {
      cols = mcux_;
      rows = mcuy_;
    }
    if (progressive_) {
      bool bad = sc.ss == 0 ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || n != 1);
      if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
      if (sc.al > 13) bad = true;
      if (bad) fail(kCorrupt);
      for (int i = 0; i < n; i++)  // the progression status (coef_bits)
        for (int j = sc.ss; j <= sc.se; j++) sc.comp[i]->bits[j] = sc.al;
    }
    std::unique_ptr<Entropy> entropy;
    if (arith_) {
      entropy.reset(new_arith_decoder(sc, cond_, end_));
    } else {
      for (int i = 0; i < n; i++)
        if (sc.comp[i]->td > 3 || sc.comp[i]->ta > 3) fail(kCorrupt);
      const Huff* dc[4] = {nullptr};
      const Huff* ac[4] = {nullptr};
      const bool dc_used = !progressive_ || (sc.ss == 0 && sc.ah == 0);
      const bool ac_used = !progressive_ || sc.ss != 0;
      for (int i = 0; i < n; i++) {
        if (dc_used) dc[i] = use_table(0, sc.comp[i]->td);
        if (ac_used) ac[i] = use_table(1, sc.comp[i]->ta);
      }
      entropy.reset(new HuffmanDecoder(sc, dc, ac, end_));
    }

    int16_t* blocks[64];
    int which[64];
    entropy->start(p_);
    int left = restart_, next_rst = 0;
    for (int my = 0; my < rows; my++) {
      for (int mx = 0; mx < cols; mx++) {
        if (restart_ && left == 0) {
          p_ = entropy->stop();
          const int m = next_marker(&p_, end_);
          if (m < 0) fail(kTruncated);
          if (m != 0xD0 + next_rst) fail(kCorrupt);
          next_rst = (next_rst + 1) & 7;
          entropy->start(p_);
          left = restart_;
        }
        int count = 0;
        for (int i = 0; i < n; i++) {
          Component& k = *sc.comp[i];
          if (n == 1) {
            blocks[count] = k.block(my, mx);
            which[count++] = 0;
            continue;
          }
          for (int y = 0; y < k.v; y++)
            for (int x = 0; x < k.h; x++) {
              blocks[count] = k.block(my * k.v + y, mx * k.h + x);
              which[count++] = i;
            }
        }
        entropy->mcu(blocks, which, count);
        if (restart_) left--;
      }
    }
    p_ = entropy->stop();
  }

  void lossless(const Scan& sc) {
    const int n = sc.n;
    // jdlossls.c's start_pass_lossless: Ss the predictor 1-7, Se and Ah
    // zero, Al (the point transform) below the precision
    if (sc.ss < 1 || sc.ss > 7 || sc.se != 0 || sc.ah != 0 || sc.al >= 8) fail(kCorrupt);
    if (n > 1) {
      int blocks = 0;
      for (int i = 0; i < n; i++) blocks += sc.comp[i]->h * sc.comp[i]->v;
      if (blocks > 10) fail(kCorrupt);  // D_MAX_BLOCKS_IN_MCU
    }
    const Huff* tables[4];
    for (int i = 0; i < n; i++) tables[i] = use_table(0, sc.comp[i]->td);
    const int mcus_per_row = n == 1 ? sc.comp[0]->bw : mcux_;
    // jddiffct.c: restarts fall on whole MCU rows
    if (restart_ && restart_ % mcus_per_row) fail(kCorrupt);
    p_ = lossless_scan(sc, tables, restart_, mcux_, mcuy_, p_, end_);
  }

  // jdcoefct.c's smoothing_ok after the last scan: libjpeg smooths every
  // block when each component's DC is known and its quantisers of zigzag
  // 0-9 are not zero, and some component has one of the first nine AC
  // coefficients unfinished.
  bool smoothing() const {
    bool useful = false;
    for (int c = 0; c < ncomp_; c++) {
      const Component& k = comp_[c];
      if (!k.latched) return false;
      for (int z = 0; z < 10; z++)
        if (k.q[kSaved[z]] == 0) return false;
      if (k.bits[0] < 0) return false;
      for (int z = 1; z < 10; z++)
        if (k.bits[z] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data for component k: each block's
  // unfinished coefficients of zigzag 1-9 that are still zero estimated
  // from the DC values of the 5 x 5 blocks around it (the edges' repeated),
  // and where no AC coefficient was ever sent, the DC too; then the IDCT.
  void smooth_idct(Component& k, uint8_t* plane, int stride) const {
    const int* bits = k.bits;
    bool change_dc = true;
    for (int z = 1; z < 10; z++)
      if (bits[z] != -1) change_dc = false;
    const int64_t q00 = k.q[0], q01 = k.q[1], q10 = k.q[8], q20 = k.q[16], q11 = k.q[9], q02 = k.q[2],
                  q03 = k.q[3], q12 = k.q[10], q21 = k.q[17], q30 = k.q[24];
    const int last_col = k.bw - 1;
    int16_t ws[64];
    for (int by = 0; by < k.bh; by++) {
      // The rows above and below as libjpeg counts them: iMCU row ir holds
      // block_rows real rows (fewer in the last), and the row's index and
      // the rows' count are taken in units of this iMCU row's block_rows,
      // so a vertically sampled component's rows near the bottom read a
      // row of whole MCUs below the image, or repeat a row, as libjpeg does.
      const int ir = by / k.v, br = by % k.v;
      const int block_rows = ir < mcuy_ - 1 || k.bh % k.v == 0 ? k.v : k.bh % k.v;
      const int ibr = ir * block_rows + br, ibrs = block_rows * mcuy_;
      int16_t* row[5];
      row[2] = k.block(by, 0);
      row[1] = ibr > 0 ? k.block(by - 1, 0) : row[2];
      row[0] = ibr > 1 ? k.block(by - 2, 0) : row[1];
      row[3] = ibr < ibrs - 1 ? k.block(by + 1, 0) : row[2];
      row[4] = ibr < ibrs - 2 ? k.block(by + 2, 0) : row[3];
      for (int bx = 0; bx < k.bw; bx++) {
        int dc[5][5];
        for (int r = 0; r < 5; r++)
          for (int c = 0; c < 5; c++) {
            int x = bx + c - 2;
            x = x < 0 ? 0 : x > last_col ? last_col : x;
            dc[r][c] = row[r][(size_t)x * 64];
          }
        const int DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2], DC04 = dc[0][3], DC05 = dc[0][4];
        const int DC06 = dc[1][0], DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3], DC10 = dc[1][4];
        const int DC11 = dc[2][0], DC12 = dc[2][1], DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4];
        const int DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2], DC19 = dc[3][3], DC20 = dc[3][4];
        const int DC21 = dc[4][0], DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3], DC25 = dc[4][4];
        memcpy(ws, k.block(by, bx), sizeof(ws));
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
          const int64_t num = q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                                  3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                                  3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                                  DC24 + DC25)
                                               : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = smooth_estimate(num, q01, al);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
          const int64_t num = q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                                  13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 -
                                                  38 * DC18 - 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                                                  3 * DC24 + DC25)
                                               : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = smooth_estimate(num, q10, al);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
          const int64_t num = q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                                  5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                                               : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = smooth_estimate(num, q20, al);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
          const int64_t num = q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                                                  DC21 - DC25)
                                               : (-DC02 + DC04 - DC06 + 10 * DC07 - 10 * DC09 + DC10 + DC16 -
                                                  10 * DC17 + 10 * DC19 - DC20 + DC22 - DC24));
          ws[9] = smooth_estimate(num, q11, al);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
          const int64_t num = q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                                  7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                                               : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = smooth_estimate(num, q02, al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
            ws[3] = smooth_estimate(q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), q03, al);
          if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
            ws[10] = smooth_estimate(q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), q12, al);
          if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
            ws[17] = smooth_estimate(q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), q21, al);
          if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
            ws[24] = smooth_estimate(q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), q30, al);
          // the DC itself, known to be at least partly right: no clamp
          const int64_t num = q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                                     42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                                     42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                                     6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          ws[0] = smooth_estimate(num, q00, 0);
        }
        idct_islow(ws, k.q, plane + (size_t)by * 8 * stride + bx * 8, stride);
      }
    }
  }

  void output(uint8_t* out) {
    // every component's samples: the IDCT of every block that covers the
    // downsampled planes, or a lossless frame's own
    std::vector<uint8_t> plane[4];
    int stride[4];
    const bool smooth = progressive_ && smoothing();
    for (int c = 0; c < ncomp_; c++) {
      Component& k = comp_[c];
      if (lossless_) {
        stride[c] = k.bwp;
        continue;
      }
      stride[c] = k.bw * 8;
      plane[c].resize((size_t)stride[c] * k.bh * 8);
      if (smooth) {
        smooth_idct(k, plane[c].data(), stride[c]);
        continue;
      }
      for (int by = 0; by < k.bh; by++)
        for (int bx = 0; bx < k.bw; bx++)
          idct_islow(k.block(by, bx), k.q, plane[c].data() + (size_t)by * 8 * stride[c] + bx * 8, stride[c]);
    }
    if (raw_planes_) {
      for (int c = 0; c < ncomp_; c++) {
        raw_planes_[c].swap(plane[c]);
        raw_strides_[c] = stride[c];
      }
      return;
    }
    // upsample each component's row to the image's width, then convert
    const int oc = space_ == kUnknown ? ncomp_ : 3;  // samples a pixel out
    const size_t pitch = (size_t)width_ + 16;
    std::vector<uint8_t> rows((size_t)ncomp_ * pitch);
    const uint8_t* r0 = rows.data();
    const uint8_t *r1 = r0 + pitch, *r2 = r1 + pitch, *r3 = r2 + pitch;
    for (int y = 0; y < height_; y++) {
      for (int c = 0; c < ncomp_; c++) {
        const uint8_t* samples = lossless_ ? comp_[c].plane.data() : plane[c].data();
        upsample_row(c, y, samples, stride[c], rows.data() + (size_t)c * pitch);
      }
      uint8_t* o = out + (size_t)y * width_ * oc;
      switch (space_) {
        case kUnknown:  // null_convert: the components as they are
          for (int x = 0; x < width_; x++)
            for (int c = 0; c < ncomp_; c++) o[oc * x + c] = rows[(size_t)c * pitch + x];
          break;
        case kGray:
          for (int x = 0; x < width_; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r0[x];
          break;
        case kRgb:
          for (int x = 0; x < width_; x++) {
            o[3 * x] = r0[x];
            o[3 * x + 1] = r1[x];
            o[3 * x + 2] = r2[x];
          }
          break;
        case kYCbCr:
          for (int x = 0; x < width_; x++) {
            const int yy = r0[x], cb = r1[x] - 128, cr = r2[x] - 128;
            o[3 * x] = clamp255(yy + cr_r(cr));
            o[3 * x + 1] = clamp255(yy + cbcr_g(cb, cr));
            o[3 * x + 2] = clamp255(yy + cb_b(cb));
          }
          break;
        case kCmyk:
          for (int x = 0; x < width_; x++) {
            const int nk = r3[x];
            o[3 * x] = cmyk_channel(r0[x], nk);
            o[3 * x + 1] = cmyk_channel(r1[x], nk);
            o[3 * x + 2] = cmyk_channel(r2[x], nk);
          }
          break;
        case kYcck:  // jdcolor.c's ycck_cmyk_convert: C, M, Y = 255 - the YCbCr -> RGB of Y, Cb, Cr; K kept
          for (int x = 0; x < width_; x++) {
            const int yy = r0[x], cb = r1[x] - 128, cr = r2[x] - 128, nk = r3[x];
            o[3 * x] = cmyk_channel(clamp255(255 - (yy + cr_r(cr))), nk);
            o[3 * x + 1] = cmyk_channel(clamp255(255 - (yy + cbcr_g(cb, cr))), nk);
            o[3 * x + 2] = cmyk_channel(clamp255(255 - (yy + cb_b(cb))), nk);
          }
          break;
      }
    }
  }

  // jdapimin.c's default_decompress_parms, and what Pillow asks of it: RGB
  // out of 1 or 3 components, CMYK out of 4.  A lossless frame is not
  // converted: libjpeg-turbo refuses any colour conversion there.
  Space color_space() const {
    if (ncomp_ == 1) return kGray;
    if (ncomp_ == 4) {
      const Space s = adobe_ && adobe_transform_ != 0 && !force_cmyk_ ? kYcck : kCmyk;
      if (lossless_ && s != kCmyk) fail(kJpegLossless);
      return s;
    }
    Space s;
    if (jfif_) {
      s = kYCbCr;
    } else if (adobe_) {
      s = adobe_transform_ == 0 ? kRgb : kYCbCr;
    } else if (comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B') {
      s = kRgb;
    } else {
      s = lossless_ ? kRgb : kYCbCr;  // component ids 1, 2, 3, or others: YCbCr, in a lossless frame RGB
    }
    if (lossless_ && s != kRgb) fail(kJpegLossless);
    return s;
  }

  // jdsample.c: output row y of component c, width_ samples.  A lossless
  // frame's data unit is one sample (min_DCT_scaled_size 1), which turns
  // the triangle filters off.
  void upsample_row(int c, int y, const uint8_t* plane, int stride, uint8_t* o) const {
    const Component& k = comp_[c];
    const int rh = hmax_ / k.h, rv = vmax_ / k.v, dw = k.dw;
    const bool fancy = !lossless_ && ((dw > 2 && rh == 2 && rv <= 2) || (rh == 1 && rv == 2));
    if (!fancy) {  // fullsize, or int_upsample's boxes (h2v1_upsample, h2v2_upsample alike)
      const uint8_t* in = plane + (size_t)(y / rv) * stride;
      if (rh == 1) {
        memcpy(o, in, width_);
      } else {
        for (int x = 0; x < width_; x++) o[x] = in[x / rh];
      }
      return;
    }
    if (rh == 1) {  // h1v2_fancy_upsample: the nearer input row 3 : 1 with the one above (bias 1) or below (2)
      const int r = y >> 1;
      int far = (y & 1) ? r + 1 : r - 1;
      far = far < 0 ? 0 : far > k.dh - 1 ? k.dh - 1 : far;
      const uint8_t* in0 = plane + (size_t)r * stride;
      const uint8_t* in1 = plane + (size_t)far * stride;
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width_; x++) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    // the triangle filters write 2 * dw samples: width_, or one more
    uint8_t* dst = o;
    if (rv == 1) {  // h2v1_fancy_upsample
      const uint8_t* in = plane + (size_t)y * stride;
      int v = in[0];
      dst[0] = (uint8_t)v;
      dst[1] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; i++) {
        v = in[i] * 3;
        dst[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        dst[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      dst[2 * dw - 2] = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
      dst[2 * dw - 1] = (uint8_t)v;
      return;
    }
    // h2v2_fancy_upsample: the nearer input row and the one above (even
    // output rows) or below (odd), the edges' rows repeated
    const int r = y >> 1;
    int far = (y & 1) ? r + 1 : r - 1;
    far = far < 0 ? 0 : far > k.dh - 1 ? k.dh - 1 : far;
    const uint8_t* in0 = plane + (size_t)r * stride;
    const uint8_t* in1 = plane + (size_t)far * stride;
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    dst[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
    dst[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int i = 1; i < dw - 1; i++) {
      next_sum = in0[i + 1] * 3 + in1[i + 1];
      dst[2 * i] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      dst[2 * i + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    dst[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
    dst[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
  }
};

}  // namespace
}  // namespace jpeg

int decode_jpeg_tiff(const uint8_t* tables, size_t tables_size, const uint8_t* data, size_t size, bool ycbcr,
                     int components, JpegFrame* frame, std::vector<uint8_t>* out) {
  try {
    jpeg::Decoder dec(data, size);
    return dec.run_tiff(tables, tables_size, ycbcr, components, frame, out);
  } catch (const jpeg::Error& e) {
    return e.code == kNotImage ? kCorrupt : e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

int decode_jpeg_tiff12(const uint8_t* tables, size_t tables_size, const uint8_t* data, size_t size, JpegFrame* frame,
                       std::vector<uint16_t>* out) {
  try {
    jpeg::Decoder dec(data, size);
    return dec.run_tiff12(tables, tables_size, frame, out);
  } catch (const jpeg::Error& e) {
    return e.code == kNotImage ? kCorrupt : e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

int decode_jpeg_planes(const uint8_t* data, size_t size, JpegFrame* frame, std::vector<uint8_t>* planes,
                       int* strides) {
  try {
    jpeg::Decoder dec(data, size);
    return dec.run_planes(frame, planes, strides);
  } catch (const jpeg::Error& e) {
    return e.code == kNotImage ? kCorrupt : e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

int decode_jpeg(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w, bool force_cmyk) {
  try {
    jpeg::Decoder dec(data, size);
    dec.force_cmyk_ = force_cmyk;
    return dec.run(out, h, w);
  } catch (const jpeg::Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace byogan
