// A JPEG decoder that gives libjpeg-turbo's RGB for the JAX package's call
// (byogan_tpu/native/byogan_io.cpp:101-132: jpeg_read_header, then
// out_color_space = JCS_RGB and the library's defaults), bit for bit.
//
// Every stage of that output is integer arithmetic, so each is libjpeg's
// own: Huffman decoding (sequential and progressive, restart intervals),
// the whole coefficient image kept until the last scan (as libjpeg does for
// multi-scan files outside buffered-image mode), dequantisation and the
// accurate integer IDCT (jidctint.c's jpeg_idct_islow, JDCT_ISLOW), the
// chroma upsampling of jdsample.c with do_fancy_upsampling (the h2v1 and
// h2v2 triangle filters, boxes for the other integral ratios) and the
// YCbCr -> RGB tables of jdcolor.c.
//
// Not read, each with its own return code: 4 components (CMYK, YCCK),
// samples of other than 8 bits, arithmetic coding, lossless and
// hierarchical frames, h1v2 (4:4:0) or fractional sampling ratios, and
// progressive files whose scans leave low-frequency coefficients unfinished
// (libjpeg smooths those blocks).  A file that ends before its EOI marker
// or breaks the format's rules fails, as Pillow fails on it: libjpeg would
// fill the missing blocks and warn.

#include <climits>
#include <cstring>
#include <new>
#include <vector>

#include "codec.h"

namespace byogan {
namespace {

struct Error {
  int code;
};

[[noreturn]] void fail(int code) { throw Error{code}; }

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

void derive(const HuffSpec& spec, bool dc, Huff* t) {
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
  if (dc)
    for (int i = 0; i < count; i++)
      if (spec.vals[i] > 15) fail(kCorrupt);
}

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
  // Throw away the bits left before the marker (a restart's byte padding).
  void reset() {
    acc = 0;
    n = pad = 0;
    stopped = overrun = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;         // the current scan's tables
  int dw = 0, dh = 0;         // downsampled_width / _height
  int bw = 0, bh = 0;         // blocks covering them
  int bwp = 0, bhp = 0;       // blocks in whole MCUs
  std::vector<int16_t> coef;  // bwp * bhp blocks of 64, natural order
  int pred = 0;
  bool latched = false;
  int16_t q[64] = {0};        // the quantiser latched at the first scan (ISLOW_MULT_TYPE: short)
  int bits[64];               // progressive: the Al of the last scan of each coefficient, -1 before
  int16_t* block(int row, int col) { return coef.data() + ((size_t)row * bwp + col) * 64; }
};

// jdcolor.c's YCbCr -> RGB tables, as constants of x = C - 128.
constexpr int kScale = 16;
constexpr int32_t kHalf = 1 << (kScale - 1);
constexpr int32_t fix(double x) { return (int32_t)(x * (1 << kScale) + 0.5); }
inline int cr_r(int x) { return (fix(1.40200) * x + kHalf) >> kScale; }
inline int cb_b(int x) { return (fix(1.77200) * x + kHalf) >> kScale; }
inline int cbcr_g(int cb, int cr) { return ((-fix(0.34414)) * cb + kHalf + (-fix(0.71414)) * cr) >> kScale; }
inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// The post-IDCT range limit of jdmaster.c's prepare_range_limit_table:
// x + 128 clamped, indexed by x & 1023 (so far-off values wrap as
// libjpeg's table does).
inline uint8_t idct_limit(int x) {
  const int v = x & 1023;
  return (uint8_t)(v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896);
}

// jidctint.c's jpeg_idct_islow on one dequantised block, in JLONG's 64 bits
// so that the far-off values of bad data wrap as libjpeg's do.
void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                    F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
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
      const uint8_t dc = idct_limit((int)(((int64_t)w[0] + (1 << (kPass1 + 2))) >> (kPass1 + 3)));
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
    o[0] = idct_limit((int)((t10 + tmp3 + rnd) >> sh));
    o[7] = idct_limit((int)((t10 - tmp3 + rnd) >> sh));
    o[1] = idct_limit((int)((t11 + tmp2 + rnd) >> sh));
    o[6] = idct_limit((int)((t11 - tmp2 + rnd) >> sh));
    o[2] = idct_limit((int)((t12 + tmp1 + rnd) >> sh));
    o[5] = idct_limit((int)((t12 - tmp1 + rnd) >> sh));
    o[3] = idct_limit((int)((t13 + tmp0 + rnd) >> sh));
    o[4] = idct_limit((int)((t13 - tmp0 + rnd) >> sh));
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), end_(data + size) {}

  int run(uint8_t* out, int* h, int* w) {
    if (end_ - d_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail(kNotImage);
    p_ = d_ + 2;
    int m = read_header();  // up to the first SOS
    if (!out || height_ != *h || width_ != *w) {
      *h = height_, *w = width_;
      return kSize;
    }
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
      m = next_marker();
    }
    if (!eoi) fail(kTruncated);
    if (progressive_ && smoothing()) fail(kJpegSmoothing);
    output(out);
    return kOk;
  }

 private:
  const uint8_t* d_;
  const uint8_t* end_;
  const uint8_t* p_ = nullptr;
  int width_ = 0, height_ = 0, ncomp_ = 0;
  bool frame_ = false, progressive_ = false;
  bool jfif_ = false, adobe_ = false, rgb_ = false;
  int adobe_transform_ = -1;
  int restart_ = 0;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  Component comp_[4];
  bool has_q_[4] = {false, false, false, false};
  uint16_t qt_[4][64];
  bool has_h_[2][4] = {{false}};  // [ac][slot]
  HuffSpec hspec_[2][4];
  Huff huff_[2][4];  // derived at each scan's start

  int byte() {
    if (p_ >= end_) fail(kTruncated);
    return *p_++;
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  // The next marker's code, skipping anything before it as libjpeg's
  // next_marker does; -1 at the end of the file.
  int next_marker() {
    while (true) {
      while (p_ < end_ && *p_ != 0xFF) p_++;
      while (p_ < end_ && *p_ == 0xFF) p_++;
      if (p_ >= end_) return -1;
      const int m = *p_++;
      if (m != 0) return m;
    }
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
      const int m = next_marker();
      if (m < 0) fail(kTruncated);
      if (m == 0xDA) {
        if (!frame_) fail(kCorrupt);
        rgb_ = ncomp_ == 3 && rgb();  // the colour space, fixed at the first scan as jpeg_read_header fixes it
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
        frame(m == 0xC2);
        return;
      case 0xC3:
        fail(kJpegLossless);
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
      case 0xDE:
      case 0xDF:
        fail(kJpegHierarchical);
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCC:
        fail(kJpegArithmetic);
      case 0xC4:
        dht();
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

  void frame(bool progressive) {
    if (frame_) fail(kCorrupt);
    int len;
    const uint8_t* s = segment(&len);
    if (len < 6) fail(kCorrupt);
    const int precision = s[0];
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    ncomp_ = s[5];
    if (precision != 8) fail(kJpeg12Bit);
    if (ncomp_ == 4) fail(kJpegCmyk);
    if (ncomp_ != 1 && ncomp_ != 3) fail(kNotRgb);
    if (len != 6 + 3 * ncomp_ || height_ == 0 || width_ == 0) fail(kCorrupt);
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
    for (int c = 0; c < ncomp_; c++) {
      const Component& k = comp_[c];
      const int rh = hmax_ / k.h, rv = vmax_ / k.v;
      if (hmax_ % k.h || vmax_ % k.v || (rh == 1 && rv == 2)) fail(kJpegSampling);
    }
    progressive_ = progressive;
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

  void allocate() {
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int c = 0; c < ncomp_; c++) {
      Component& k = comp_[c];
      k.dw = (int)(((long)width_ * k.h + hmax_ - 1) / hmax_);
      k.dh = (int)(((long)height_ * k.v + vmax_ - 1) / vmax_);
      k.bw = (k.dw + 7) / 8;
      k.bh = (k.dh + 7) / 8;
      k.bwp = mcux_ * k.h;
      k.bhp = mcuy_ * k.v;
      k.coef.assign((size_t)k.bwp * k.bhp * 64, 0);
      for (int i = 0; i < 64; i++) k.bits[i] = -1;
    }
  }

  // Derive a table a scan uses; libjpeg-turbo's std_huff_tables stand in
  // for the first two slots where no DHT defined them.
  void use_table(int ac, int slot) {
    if (!has_h_[ac][slot]) {
      if (slot > 1) fail(kCorrupt);
      hspec_[ac][slot] = ac ? (slot ? kStdAcChroma : kStdAcLuma) : (slot ? kStdDcChroma : kStdDcLuma);
      has_h_[ac][slot] = true;
    }
    derive(hspec_[ac][slot], !ac, &huff_[ac][slot]);
  }

  void scan() {
    int len;
    const uint8_t* s = segment(&len);
    if (len < 1) fail(kCorrupt);
    const int n = s[0];
    if (n < 1 || n > 4 || n > ncomp_ || len != 4 + 2 * n) fail(kCorrupt);
    Component* in[4];
    for (int i = 0; i < n; i++) {
      const int id = s[1 + 2 * i];
      int c = 0;
      while (c < ncomp_ && comp_[c].id != id) c++;
      if (c == ncomp_) fail(kCorrupt);
      for (int j = 0; j < i; j++)
        if (in[j] == &comp_[c]) fail(kCorrupt);
      in[i] = &comp_[c];
      in[i]->td = s[2 + 2 * i] >> 4;
      in[i]->ta = s[2 + 2 * i] & 15;
      if (in[i]->td > 3 || in[i]->ta > 3) fail(kCorrupt);
    }
    const int ss = s[1 + 2 * n], se = s[2 + 2 * n], ah = s[3 + 2 * n] >> 4, al = s[3 + 2 * n] & 15;
    // latch_quant_tables: a component keeps the table of its first scan
    for (int i = 0; i < n; i++) {
      Component& k = *in[i];
      if (k.latched) continue;
      if (!has_q_[k.tq]) fail(kCorrupt);
      for (int j = 0; j < 64; j++) k.q[j] = (int16_t)qt_[k.tq][j];
      k.latched = true;
    }
    int rows, cols;  // MCUs
    if (n == 1) {
      cols = in[0]->bw;
      rows = in[0]->bh;
    } else {
      cols = mcux_;
      rows = mcuy_;
    }
    enum { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine } kind = kSeq;
    if (progressive_) {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || n != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(kCorrupt);
      kind = ss == 0 ? (ah ? kDcRefine : kDcFirst) : (ah ? kAcRefine : kAcFirst);
      for (int i = 0; i < n; i++)
        for (int j = ss; j <= se; j++) in[i]->bits[j] = al;
    }
    for (int i = 0; i < n; i++) {
      const bool dc_used = kind == kSeq || kind == kDcFirst;
      const bool ac_used = kind == kSeq || kind == kAcFirst || kind == kAcRefine;
      if (dc_used) use_table(0, in[i]->td);
      if (ac_used) use_table(1, in[i]->ta);
      in[i]->pred = 0;
    }

    Bits b;
    b.p = p_;
    b.end = end_;
    int eobrun = 0, left = restart_, next_rst = 0;
    for (int my = 0; my < rows; my++) {
      for (int mx = 0; mx < cols; mx++) {
        if (restart_ && left == 0) {
          if (b.overrun) fail(b.p >= end_ ? kTruncated : kCorrupt);
          p_ = b.p;
          const int m = next_marker();
          if (m < 0) fail(kTruncated);
          if (m != 0xD0 + next_rst) fail(kCorrupt);
          next_rst = (next_rst + 1) & 7;
          b.reset();
          b.p = p_;
          for (int i = 0; i < n; i++) in[i]->pred = 0;
          eobrun = 0;
          left = restart_;
        }
        for (int i = 0; i < n; i++) {
          Component& k = *in[i];
          const int bv = n == 1 ? 1 : k.v, bh = n == 1 ? 1 : k.h;
          for (int y = 0; y < bv; y++) {
            for (int x = 0; x < bh; x++) {
              int16_t* blk = n == 1 ? k.block(my, mx) : k.block(my * k.v + y, mx * k.h + x);
              switch (kind) {
                case kSeq:
                  sequential(b, k, blk);
                  break;
                case kDcFirst:
                  dc_first(b, k, blk, al);
                  break;
                case kDcRefine:
                  if (b.bit()) blk[0] = (int16_t)(blk[0] | (1 << al));
                  break;
                case kAcFirst:
                  ac_first(b, huff_[1][k.ta], blk, ss, se, al, &eobrun);
                  break;
                case kAcRefine:
                  ac_refine(b, huff_[1][k.ta], blk, ss, se, al, &eobrun);
                  break;
              }
            }
          }
        }
        if (restart_) left--;
      }
    }
    if (b.overrun) fail(b.p >= end_ ? kTruncated : kCorrupt);
    p_ = b.p;
  }

  // The DC predictor plus a difference; libjpeg-turbo refuses a sum past
  // int's range (JERR_BAD_DCT_COEF).
  static void add_dc(Component& k, int s) {
    if ((k.pred >= 0 && s > INT_MAX - k.pred) || (k.pred < 0 && s < INT_MIN - k.pred)) fail(kCorrupt);
    k.pred += s;
  }

  void sequential(Bits& b, Component& k, int16_t* blk) {
    int s = b.decode(huff_[0][k.td]);
    if (s) s = extend(b.get(s), s);
    add_dc(k, s);
    blk[0] = (int16_t)k.pred;
    const Huff& ac = huff_[1][k.ta];
    for (int i = 1; i < 64; i++) {
      const int rs = b.decode(ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        if (i > 63) fail(kCorrupt);
        blk[kNatural[i]] = (int16_t)extend(b.get(s), s);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void dc_first(Bits& b, Component& k, int16_t* blk, int al) {
    int s = b.decode(huff_[0][k.td]);
    if (s) s = extend(b.get(s), s);
    add_dc(k, s);
    blk[0] = (int16_t)((unsigned)k.pred << al);
  }

  static void ac_first(Bits& b, const Huff& ac, int16_t* blk, int ss, int se, int al, int* eobrun) {
    if (*eobrun > 0) {
      (*eobrun)--;
      return;
    }
    for (int i = ss; i <= se; i++) {
      const int rs = b.decode(ac);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        if (i > se) fail(kCorrupt);
        blk[kNatural[i]] = (int16_t)(extend(b.get(s), s) * (1 << al));
      } else if (r == 15) {
        i += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += b.get(r);
        (*eobrun)--;
        break;
      }
    }
  }

  // jdphuff.c's decode_mcu_AC_refine.
  static void ac_refine(Bits& b, const Huff& ac, int16_t* blk, int ss, int se, int al, int* eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    if (*eobrun == 0) {
      for (; i <= se; i++) {
        const int rs = b.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = b.bit() ? p1 : m1;  // a size other than 1 is bad data, which libjpeg decodes as 1
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += b.get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[i];
          if (*c != 0) {
            if (b.bit() && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
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
    if (*eobrun > 0) {
      for (; i <= se; i++) {
        int16_t* c = blk + kNatural[i];
        if (*c != 0 && b.bit() && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
      }
      (*eobrun)--;
    }
  }

  // jdcoefct.c's smoothing_ok after the last scan: libjpeg smooths the
  // blocks where the DC is known and one of the first nine AC
  // coefficients is not finished.
  bool smoothing() const {
    static constexpr int kSaved[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // natural places of zigzag 0-9
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

  void output(uint8_t* out) {
    // IDCT every block that covers the downsampled planes
    std::vector<uint8_t> plane[4];
    for (int c = 0; c < ncomp_; c++) {
      Component& k = comp_[c];
      const int stride = k.bw * 8;
      plane[c].resize((size_t)stride * k.bh * 8);
      for (int by = 0; by < k.bh; by++)
        for (int bx = 0; bx < k.bw; bx++)
          idct_islow(k.block(by, bx), k.q, plane[c].data() + (size_t)by * 8 * stride + bx * 8, stride);
    }
    // upsample each component's row to the image's width, then convert
    std::vector<uint8_t> rows((size_t)ncomp_ * (width_ + 16));
    for (int y = 0; y < height_; y++) {
      for (int c = 0; c < ncomp_; c++) upsample_row(c, y, plane[c].data(), rows.data() + (size_t)c * (width_ + 16));
      uint8_t* o = out + (size_t)y * width_ * 3;
      const uint8_t* r0 = rows.data();
      if (ncomp_ == 1) {
        for (int x = 0; x < width_; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r0[x];
        continue;
      }
      const uint8_t* r1 = r0 + width_ + 16;
      const uint8_t* r2 = r1 + width_ + 16;
      if (rgb_) {
        for (int x = 0; x < width_; x++) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        continue;
      }
      for (int x = 0; x < width_; x++) {
        const int yy = r0[x], cb = r1[x] - 128, cr = r2[x] - 128;
        o[3 * x] = clamp255(yy + cr_r(cr));
        o[3 * x + 1] = clamp255(yy + cbcr_g(cb, cr));
        o[3 * x + 2] = clamp255(yy + cb_b(cb));
      }
    }
  }

  // default_decompress_parms (jdapimin.c) for three components.
  bool rgb() const {
    if (jfif_) return false;
    if (adobe_) return adobe_transform_ == 0;
    return comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
  }

  // jdsample.c: output row y of component c, width_ samples.
  void upsample_row(int c, int y, const uint8_t* plane, uint8_t* o) const {
    const Component& k = comp_[c];
    const int rh = hmax_ / k.h, rv = vmax_ / k.v, stride = k.bw * 8, dw = k.dw;
    const bool fancy = dw > 2 && rh == 2 && rv <= 2;
    if (!fancy) {  // fullsize, or int_upsample's boxes (h2v1_upsample, h2v2_upsample alike)
      const uint8_t* in = plane + (size_t)(y / rv) * stride;
      if (rh == 1) {
        memcpy(o, in, width_);
      } else {
        for (int x = 0; x < width_; x++) o[x] = in[x / rh];
      }
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

int decode_jpeg(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w) {
  try {
    Decoder dec(data, size);
    return dec.run(out, h, w);
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace byogan
