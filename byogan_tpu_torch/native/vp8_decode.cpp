// A VP8 key-frame decoder (RFC 6386) that gives libwebp's planes and RGB
// for a lossy WebP, bit for bit.
//
// The bitstream is decoded as RFC 6386 sets out: the boolean decoder in
// libwebp's form (the range kept minus one, one zero byte fed past the end
// and the frame refused where libwebp checks for it), the frame header
// with segments, loop-filter deltas and 1-8 token partitions, the intra
// modes, the tokens with their probability updates, dequantisation (the
// Y2 DC x2, the Y2 AC x155/100 floored at 8, the UV DC capped at 132), the
// inverse WHT and DCT, intra prediction from the unfiltered neighbours
// (127 above the frame, 129 left of it) and the simple or normal loop
// filter over the whole frame in macroblock order.  The planes are then
// cropped to the frame and turned into RGB as libwebp's WebPDecode does
// into MODE_RGBA: its fancy upsampling of U and V and its fixed-point
// YUV -> RGB (src/dsp/upsampling.c, src/dsp/yuv.h).

#include <cstdlib>
#include <cstring>
#include <vector>

#include "webp.h"

namespace byogan {
namespace {

// --- the boolean decoder ----------------------------------------------------

class BoolReader {
 public:
  void init(const uint8_t* p, size_t n) {
    buf_ = p;
    end_ = p + n;
    value_ = 0;
    bits_ = -8;
    range_ = 255 - 1;
    eof_ = false;
    load();
  }

  int bit(int prob) {
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range_ * (uint32_t)prob) >> 8;
    const uint32_t value = (uint32_t)(value_ >> pos);
    uint32_t range;  // the new range itself, not minus one
    int bit;
    if (value > split) {
      range = range_ - split;
      value_ -= (uint64_t)(split + 1) << pos;
      bit = 1;
    } else {
      range = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(range));
    bits_ -= shift;
    range_ = (range << shift) - 1;
    return bit;
  }

  int value(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }

  int signed_value(int n) {
    const int v = value(n);
    return bit(0x80) ? -v : v;
  }

  int flag() { return bit(0x80); }
  bool eof() const { return eof_; }

 private:
  // Eight more bits below the window; past the end one zero byte and eof.
  void load() {
    if (buf_ < end_) {
      value_ = (value_ << 8) | *buf_++;
      bits_ += 8;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }

  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = 0;
  uint32_t range_ = 0;
  bool eof_ = false;
};

// --- tables and small helpers -----------------------------------------------

constexpr int kBps = 32;  // stride of the work buffer
constexpr int kYOff = kBps * 1 + 8;
constexpr int kUOff = kYOff + kBps * 16 + kBps;
constexpr int kVOff = kUOff + 16;
constexpr int kYuvSize = kBps * 17 + kBps * 9;

// The 16x16 and chroma DC predictors where the frame's edge hides a side.
constexpr int kDcNoTop = 10, kDcNoLeft = 11, kDcNoTopLeft = 12;

// The 4x4 mode tree: node i reads prob[i]; a leaf holds minus its mode.
const int8_t kYModesIntra4[18] = {
    -kDcPred, 1, -kTmPred, 2, -kVePred, 3, 4, 6, -kHePred, 5, -kRdPred, -kVrPred, -kLdPred, 7, -kVlPred, 8,
    -kHdPred, -kHuPred,
};

const int kScan[16] = {
    0 + 0 * kBps, 4 + 0 * kBps, 8 + 0 * kBps, 12 + 0 * kBps, 0 + 4 * kBps, 4 + 4 * kBps, 8 + 4 * kBps, 12 + 4 * kBps,
    0 + 8 * kBps, 4 + 8 * kBps, 8 + 8 * kBps, 12 + 8 * kBps, 0 + 12 * kBps, 4 + 12 * kBps, 8 + 12 * kBps, 12 + 12 * kBps,
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020] -> [-128, 127]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112] -> [-16, 15]

// --- prediction -------------------------------------------------------------

inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; j++) memset(dst + j * kBps, v, size);
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  const int tl = top[-1];
  for (int y = 0; y < size; y++) {
    const int left = dst[-1];
    for (int x = 0; x < size; x++) dst[x] = clip8(top[x] + left - tl);
    dst += kBps;
  }
}

void vertical(uint8_t* dst, int size) {
  for (int j = 0; j < size; j++) memcpy(dst + j * kBps, dst - kBps, size);
}

void horizontal(uint8_t* dst, int size) {
  for (int j = 0; j < size; j++) memset(dst + j * kBps, dst[j * kBps - 1], size);
}

// The 16x16 (size 16) and chroma (size 8) predictors.
void predict_block(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 4 : 3;
  int dc = 0;
  switch (mode) {
    case kDcPred:
      for (int j = 0; j < size; j++) dc += dst[-1 + j * kBps] + dst[j - kBps];
      fill(dst, size, (dc + size) >> (shift + 1));
      break;
    case kDcNoTop:
      for (int j = 0; j < size; j++) dc += dst[-1 + j * kBps];
      fill(dst, size, (dc + size / 2) >> shift);
      break;
    case kDcNoLeft:
      for (int j = 0; j < size; j++) dc += dst[j - kBps];
      fill(dst, size, (dc + size / 2) >> shift);
      break;
    case kDcNoTopLeft:
      fill(dst, size, 0x80);
      break;
    case kTmPred:
      true_motion(dst, size);
      break;
    case kVePred:
      vertical(dst, size);
      break;
    case kHePred:
      horizontal(dst, size);
      break;
    default:
      webp_fail(kCorrupt);
  }
}

#define DST(x, y) dst[(x) + (y) * kBps]

void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - kBps;
  const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], L = dst[-1 + 3 * kBps];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case kDcPred: {
      int dc = 4;
      for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * kBps];
      fill(dst, 4, dc >> 3);
      break;
    }
    case kTmPred:
      true_motion(dst, 4);
      break;
    case kVePred: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; i++) memcpy(dst + i * kBps, vals, 4);
      break;
    }
    case kHePred:
      memset(dst + 0 * kBps, avg3(X, I, J), 4);
      memset(dst + 1 * kBps, avg3(I, J, K), 4);
      memset(dst + 2 * kBps, avg3(J, K, L), 4);
      memset(dst + 3 * kBps, avg3(K, L, L), 4);
      break;
    case kRdPred:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case kLdPred:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case kVrPred:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case kVlPred:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case kHuPred:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    case kHdPred:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:
      webp_fail(kCorrupt);
  }
}

#undef DST

// --- inverse transforms -----------------------------------------------------

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The inverse DCT of one 4x4 block added to the prediction at dst.
void transform(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; i++) {  // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * kBps;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

// The inverse Walsh-Hadamard transform of the Y2 block into the DC of the
// 16 luma blocks (out[16 * n]).
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// --- the loop filter --------------------------------------------------------

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it && abs(q3 - q2) <= it &&
         abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

// 4 pixels in, 2 out
inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

// 4 pixels in, 4 out
inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

// 6 pixels in, 6 out
inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

// One edge of `size` pixels: `hstride` crosses it, `vstride` runs along it.
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; i++, p += vstride)
    if (needs_filter(p, hstride, thresh2)) filter2(p, hstride);
}

void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; i++, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) {
      filter2(p, hstride);
    } else if (mb_edge) {
      filter6(p, hstride);
    } else {
      filter4(p, hstride);
    }
  }
}

struct FilterInfo {
  uint8_t limit = 0;  // 0: not filtered
  uint8_t ilevel = 0;
  uint8_t inner = 0;
  uint8_t hev_thresh = 0;
};

// --- the decoder ------------------------------------------------------------

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct BandProbas {
  uint8_t probas[3][11];
};

struct MacroBlock {  // the token contexts: non-zero flags above and left
  uint8_t nz = 0, nz_dc = 0;
};

struct BlockData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t nonzero;  // bit n: luma block n (0-15), then U (16-19) and V (20-23), has coefficients
};

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  void run(Vp8Planes* out) {
    parse_headers();
    frame();
    out->width = width_;
    out->height = height_;
    out->uv_width = (width_ + 1) / 2;
    out->uv_height = (height_ + 1) / 2;
    out->y.resize((size_t)width_ * height_);
    out->u.resize((size_t)out->uv_width * out->uv_height);
    out->v.resize(out->u.size());
    for (int j = 0; j < height_; j++) memcpy(&out->y[(size_t)j * width_], &y_[(size_t)j * ystride_], width_);
    for (int j = 0; j < out->uv_height; j++) {
      memcpy(&out->u[(size_t)j * out->uv_width], &u_[(size_t)j * uvstride_], out->uv_width);
      memcpy(&out->v[(size_t)j * out->uv_width], &v_[(size_t)j * uvstride_], out->uv_width);
    }
  }

 private:
  void parse_headers() {
    if (const int rc = vp8_info(data_, size_, &width_, &height_)) webp_fail(rc);
    const uint32_t part0 = (data_[0] | data_[1] << 8 | data_[2] << 16) >> 5;
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    const uint8_t* buf = data_ + 10;
    size_t left = size_ - 10;
    if (part0 > left) webp_fail(kTruncated);
    br_.init(buf, part0);
    buf += part0;
    left -= part0;

    br_.flag();  // colour space
    br_.flag();  // clamping type
    // segment header
    if ((use_segment_ = br_.flag())) {
      update_map_ = br_.flag();
      if (br_.flag()) {  // update the segments' data
        absolute_delta_ = br_.flag();
        for (int s = 0; s < 4; s++) quantizer_[s] = br_.flag() ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; s++) filter_strength_[s] = br_.flag() ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; s++) segment_proba_[s] = br_.flag() ? br_.value(8) : 255;
    }
    if (br_.eof()) webp_fail(kTruncated);
    // filter header
    const bool simple = br_.flag();
    level_ = br_.value(6);
    sharpness_ = br_.value(3);
    if ((use_lf_delta_ = br_.flag())) {
      if (br_.flag()) {
        for (int i = 0; i < 4; i++)
          if (br_.flag()) ref_lf_delta_[i] = br_.signed_value(6);
        for (int i = 0; i < 4; i++)
          if (br_.flag()) mode_lf_delta_[i] = br_.signed_value(6);
      }
    }
    filter_type_ = level_ == 0 ? 0 : simple ? 1 : 2;
    if (br_.eof()) webp_fail(kTruncated);
    // token partitions
    num_parts_minus_one_ = (1 << br_.value(2)) - 1;
    const int last = num_parts_minus_one_;
    if (left < (size_t)3 * last) webp_fail(kTruncated);
    const uint8_t* sz = buf;
    const uint8_t* part_start = buf + 3 * last;
    size_t size_left = left - 3 * last;
    for (int p = 0; p < last; p++, sz += 3) {
      size_t psize = sz[0] | sz[1] << 8 | sz[2] << 16;
      if (psize > size_left) psize = size_left;
      parts_[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
    }
    parts_[last].init(part_start, size_left);
    if (part_start >= buf + left) webp_fail(kTruncated);
    parse_quant();
    br_.flag();  // refresh the entropy probabilities: a single frame ignores it
    for (int t = 0; t < 4; t++)
      for (int b = 0; b < 8; b++)
        for (int c = 0; c < 3; c++)
          for (int p = 0; p < 11; p++)
            bands_[t][b].probas[c][p] =
                br_.bit(kVp8CoeffsUpdateProba[t][b][c][p]) ? br_.value(8) : kVp8CoeffsProba0[t][b][c][p];
    for (int t = 0; t < 4; t++)
      for (int n = 0; n < 17; n++) bands_ptr_[t][n] = &bands_[t][kVp8Bands[n]];
    if ((use_skip_proba_ = br_.flag())) skip_p_ = br_.value(8);
  }

  void parse_quant() {
    const int base_q0 = br_.value(7);
    const int dqy1_dc = br_.flag() ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.flag() ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.flag() ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.flag() ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.flag() ? br_.signed_value(4) : 0;
    for (int i = 0; i < 4; i++) {
      int q;
      if (use_segment_) {
        q = quantizer_[i] + (absolute_delta_ ? 0 : base_q0);
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm_[i];
      m.y1[0] = kVp8DcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kVp8AcTable[clip(q, 127)];
      m.y2[0] = kVp8DcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = kVp8AcTable[clip(q + dqy2_ac, 127)] * 101581 >> 16;  // x * 155 / 100 for every table entry
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kVp8DcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kVp8AcTable[clip(q + dquv_ac, 127)];
    }
  }

  void precompute_filter_strengths() {
    for (int s = 0; s < 4; s++) {
      int base = level_;
      if (use_segment_) base = filter_strength_[s] + (absolute_delta_ ? 0 : level_);
      for (int i4x4 = 0; i4x4 <= 1; i4x4++) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = clip(level, 63);
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = (uint8_t)ilevel;
          info.limit = (uint8_t)(2 * level + ilevel);
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = (uint8_t)i4x4;
      }
    }
  }

  void parse_intra_mode(int mb_x, BlockData* block) {
    uint8_t* top = &intra_t_[4 * mb_x];
    uint8_t* left = intra_l_;
    if (update_map_) {
      block->segment = !br_.bit(segment_proba_[0]) ? br_.bit(segment_proba_[1])
                                                   : br_.bit(segment_proba_[2]) + 2;
    } else {
      block->segment = 0;
    }
    block->skip = use_skip_proba_ ? br_.bit(skip_p_) : 0;
    block->is_i4x4 = !br_.bit(145);
    if (!block->is_i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? kTmPred : kHePred) : (br_.bit(163) ? kVePred : kDcPred);
      block->imodes[0] = (uint8_t)ymode;
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = block->imodes;
      for (int y = 0; y < 4; y++) {
        int ymode = left[y];
        for (int x = 0; x < 4; x++) {
          const uint8_t* prob = kVp8BModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
          ymode = -i;
          top[x] = (uint8_t)ymode;
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    block->uvmode = !br_.bit(142) ? kDcPred : !br_.bit(114) ? kVePred : br_.bit(183) ? kTmPred : kHePred;
  }

  static int large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      static const uint8_t* const kCat3456[] = {kVp8Cat3, kVp8Cat4, kVp8Cat5, kVp8Cat6};
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // The tokens of one block from position n: the index after its last
  // non-zero coefficient (or 16), the coefficients dequantised into out.
  static int get_coeffs(BoolReader& br, const BandProbas* const* prob, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = prob[n]->probas[ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;  // end of block
      while (!br.bit(p[1])) {       // a zero coefficient
        p = prob[++n]->probas[0];
        if (n == 16) return 16;
      }
      const BandProbas* next = prob[n + 1];
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = next->probas[1];
      } else {
        v = large_value(br, p);
        p = next->probas[2];
      }
      out[kVp8Zigzag[n]] = (int16_t)((br.bit(0x80) ? -v : v) * dq[n > 0]);
    }
    return 16;
  }

  // The tokens of one macroblock; false where it has no coefficient.
  bool parse_residuals(MacroBlock* mb, MacroBlock* left_mb, BoolReader& tbr, BlockData* block) {
    const Quant& q = dqm_[block->segment];
    int16_t* dst = block->coeffs;
    memset(dst, 0, sizeof(block->coeffs));
    const BandProbas* const* ac_proba;
    int first;
    uint32_t nonzero = 0;
    if (!block->is_i4x4) {  // the Y2 block
      int16_t dc[16] = {0};
      const int ctx = mb->nz_dc + left_mb->nz_dc;
      const int nz = get_coeffs(tbr, bands_ptr_[1], ctx, q.y2, 0, dc);
      mb->nz_dc = left_mb->nz_dc = (nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_proba = bands_ptr_[0];
    } else {
      first = 0;
      ac_proba = bands_ptr_[3];
    }
    uint8_t tnz = mb->nz & 0x0f;
    uint8_t lnz = left_mb->nz & 0x0f;
    for (int y = 0; y < 4; y++) {
      int l = lnz & 1;
      for (int x = 0; x < 4; x++) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tbr, ac_proba, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (uint8_t)((tnz >> 1) | (l << 7));
        if (nz > 1 || dst[0] != 0) nonzero |= 1u << (4 * y + x);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (uint8_t)((lnz >> 1) | (l << 7));
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      tnz = (uint8_t)(mb->nz >> (4 + ch));
      lnz = (uint8_t)(left_mb->nz >> (4 + ch));
      for (int y = 0; y < 2; y++) {
        int l = lnz & 1;
        for (int x = 0; x < 2; x++) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(tbr, bands_ptr_[2], ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (uint8_t)((tnz >> 1) | (l << 3));
          if (nz > 1 || dst[0] != 0) nonzero |= 1u << (16 + 2 * ch + 2 * y + x);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (uint8_t)((lnz >> 1) | (l << 5));
      }
      out_t_nz |= (uint32_t)(tnz << 4) << ch;
      out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
    }
    mb->nz = (uint8_t)out_t_nz;
    left_mb->nz = (uint8_t)out_l_nz;
    block->nonzero = nonzero;
    return nonzero != 0;
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode != kDcPred) return mode;
    if (mb_x == 0) return mb_y == 0 ? kDcNoTopLeft : kDcNoLeft;
    return mb_y == 0 ? kDcNoTop : (int)kDcPred;
  }

  void reconstruct_row(int mb_y, const std::vector<BlockData>& row) {
    uint8_t* const y_dst = yuv_b_ + kYOff;
    uint8_t* const u_dst = yuv_b_ + kUOff;
    uint8_t* const v_dst = yuv_b_ + kVOff;
    for (int j = 0; j < 16; j++) y_dst[j * kBps - 1] = 129;
    for (int j = 0; j < 8; j++) u_dst[j * kBps - 1] = v_dst[j * kBps - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - kBps] = u_dst[-1 - kBps] = v_dst[-1 - kBps] = 129;
    } else {
      memset(y_dst - kBps - 1, 127, 16 + 4 + 1);
      memset(u_dst - kBps - 1, 127, 8 + 1);
      memset(v_dst - kBps - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w_; mb_x++) {
      const BlockData& block = row[mb_x];
      if (mb_x > 0) {  // the left samples: the previous macroblock's right columns
        for (int j = -1; j < 16; j++) memcpy(&y_dst[j * kBps - 4], &y_dst[j * kBps + 12], 4);
        for (int j = -1; j < 8; j++) {
          memcpy(&u_dst[j * kBps - 4], &u_dst[j * kBps + 4], 4);
          memcpy(&v_dst[j * kBps - 4], &v_dst[j * kBps + 4], 4);
        }
      }
      TopSamples& top = top_[mb_x];
      if (mb_y > 0) {
        memcpy(y_dst - kBps, top.y, 16);
        memcpy(u_dst - kBps, top.u, 8);
        memcpy(v_dst - kBps, top.v, 8);
      }
      const int16_t* coeffs = block.coeffs;
      if (block.is_i4x4) {
        uint8_t* top_right = y_dst - kBps + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1) {
            memset(top_right, top.y[15], 4);
          } else {
            memcpy(top_right, top_[mb_x + 1].y, 4);
          }
        }
        // the sub-blocks of the right column, rows 1-3, see the same pixels above-right
        for (int r = 1; r < 4; r++) memcpy(top_right + 4 * r * kBps, top_right, 4);
        for (int n = 0; n < 16; n++) {
          uint8_t* dst = y_dst + kScan[n];
          predict4(block.imodes[n], dst);
          if (block.nonzero >> n & 1) transform(coeffs + n * 16, dst);
        }
      } else {
        predict_block(check_mode(mb_x, mb_y, block.imodes[0]), y_dst, 16);
        for (int n = 0; n < 16; n++)
          if (block.nonzero >> n & 1) transform(coeffs + n * 16, y_dst + kScan[n]);
      }
      const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
      predict_block(uvmode, u_dst, 8);
      predict_block(uvmode, v_dst, 8);
      for (int n = 0; n < 4; n++) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * kBps;
        if (block.nonzero >> (16 + n) & 1) transform(coeffs + (16 + n) * 16, u_dst + off);
        if (block.nonzero >> (20 + n) & 1) transform(coeffs + (20 + n) * 16, v_dst + off);
      }
      if (mb_y < mb_h_ - 1) {
        memcpy(top.y, y_dst + 15 * kBps, 16);
        memcpy(top.u, u_dst + 7 * kBps, 8);
        memcpy(top.v, v_dst + 7 * kBps, 8);
      }
      uint8_t* ydst = &y_[(size_t)mb_y * 16 * ystride_ + mb_x * 16];
      uint8_t* udst = &u_[(size_t)mb_y * 8 * uvstride_ + mb_x * 8];
      uint8_t* vdst = &v_[(size_t)mb_y * 8 * uvstride_ + mb_x * 8];
      for (int j = 0; j < 16; j++) memcpy(ydst + (size_t)j * ystride_, y_dst + j * kBps, 16);
      for (int j = 0; j < 8; j++) {
        memcpy(udst + (size_t)j * uvstride_, u_dst + j * kBps, 8);
        memcpy(vdst + (size_t)j * uvstride_, v_dst + j * kBps, 8);
      }
    }
  }

  void filter_macroblock(int mb_x, int mb_y, const FilterInfo& f) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y = &y_[(size_t)mb_y * 16 * ystride_ + mb_x * 16];
    const int ys = ystride_;
    if (filter_type_ == 1) {  // simple: luma only
      if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, limit);
      if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, limit);
      return;
    }
    const int uvs = uvstride_;
    uint8_t* u = &u_[(size_t)mb_y * 8 * uvs + mb_x * 8];
    uint8_t* v = &v_[(size_t)mb_y * 8 * uvs + mb_x * 8];
    const int il = f.ilevel, hev_t = f.hev_thresh;
    if (mb_x > 0) {
      normal_edge(y, 1, ys, 16, limit + 4, il, hev_t, true);
      normal_edge(u, 1, uvs, 8, limit + 4, il, hev_t, true);
      normal_edge(v, 1, uvs, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 4; k < 16; k += 4) normal_edge(y + k, 1, ys, 16, limit, il, hev_t, false);
      normal_edge(u + 4, 1, uvs, 8, limit, il, hev_t, false);
      normal_edge(v + 4, 1, uvs, 8, limit, il, hev_t, false);
    }
    if (mb_y > 0) {
      normal_edge(y, ys, 1, 16, limit + 4, il, hev_t, true);
      normal_edge(u, uvs, 1, 8, limit + 4, il, hev_t, true);
      normal_edge(v, uvs, 1, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 4; k < 16; k += 4) normal_edge(y + k * ys, ys, 1, 16, limit, il, hev_t, false);
      normal_edge(u + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
      normal_edge(v + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
    }
  }

  // Every macroblock decoded and reconstructed from unfiltered neighbours,
  // then the loop filter over the frame in macroblock order.
  void frame() {
    ystride_ = mb_w_ * 16;
    uvstride_ = mb_w_ * 8;
    y_.assign((size_t)ystride_ * mb_h_ * 16, 0);
    u_.assign((size_t)uvstride_ * mb_h_ * 8, 0);
    v_.assign(u_.size(), 0);
    intra_t_.assign((size_t)4 * mb_w_, kDcPred);
    top_.assign(mb_w_, TopSamples{});
    std::vector<MacroBlock> mb_info(mb_w_ + 1);  // [0]: the left neighbour
    std::vector<BlockData> row(mb_w_);
    std::vector<FilterInfo> finfo(filter_type_ > 0 ? (size_t)mb_w_ * mb_h_ : 0);
    if (filter_type_ > 0) precompute_filter_strengths();
    memset(yuv_b_, 0, sizeof(yuv_b_));
    for (int mb_y = 0; mb_y < mb_h_; mb_y++) {
      MacroBlock* left = &mb_info[0];
      left->nz = left->nz_dc = 0;
      memset(intra_l_, kDcPred, sizeof(intra_l_));
      for (int mb_x = 0; mb_x < mb_w_; mb_x++) parse_intra_mode(mb_x, &row[mb_x]);
      if (br_.eof()) webp_fail(kTruncated);
      BoolReader& tbr = parts_[mb_y & num_parts_minus_one_];
      for (int mb_x = 0; mb_x < mb_w_; mb_x++) {
        BlockData& block = row[mb_x];
        MacroBlock* mb = &mb_info[1 + mb_x];
        bool coded;
        if (!block.skip) {
          coded = parse_residuals(mb, left, tbr, &block);
        } else {
          left->nz = mb->nz = 0;
          if (!block.is_i4x4) left->nz_dc = mb->nz_dc = 0;
          block.nonzero = 0;
          coded = false;
        }
        if (filter_type_ > 0) {
          FilterInfo& f = finfo[(size_t)mb_y * mb_w_ + mb_x];
          f = fstrengths_[block.segment][block.is_i4x4];
          f.inner |= coded;
        }
        if (tbr.eof()) webp_fail(kTruncated);
      }
      reconstruct_row(mb_y, row);
    }
    if (filter_type_ > 0)
      for (int mb_y = 0; mb_y < mb_h_; mb_y++)
        for (int mb_x = 0; mb_x < mb_w_; mb_x++) filter_macroblock(mb_x, mb_y, finfo[(size_t)mb_y * mb_w_ + mb_x]);
  }

  const uint8_t* data_;
  size_t size_;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolReader br_, parts_[8];
  int num_parts_minus_one_ = 0;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  int segment_proba_[3] = {255, 255, 255};
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  bool use_lf_delta_ = false;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  Quant dqm_[4];
  BandProbas bands_[4][8];
  const BandProbas* bands_ptr_[4][17];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  FilterInfo fstrengths_[4][2];
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4];
  std::vector<TopSamples> top_;
  uint8_t yuv_b_[kYuvSize];
  int ystride_ = 0, uvstride_ = 0;
  std::vector<uint8_t> y_, u_, v_;
};

// --- YUV -> RGB -------------------------------------------------------------

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }

inline uint8_t yuv_clip8(int v) { return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255; }

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = mult_hi(y, 19077);
  rgb[0] = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
}

// One pair of output rows from the chroma rows around them (libwebp's
// UpsampleRgbaLinePair): the top row leans on top_u/top_v, the bottom row
// (if any) on cur_u/cur_v, each sample (9, 3, 3, 1) / 16 in two rounding
// steps.  U and V are computed apart; libwebp packs them into one word,
// whose lanes never carry into each other.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y) yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; x++) {
    const int t_u = top_u[x], t_v = top_v[x], c_u = cur_u[x], c_v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + (2 * x - 1) * 3);
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 3);
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1, bottom_dst + 2 * x * 3);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = c_u;
    l_v = c_v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst + (len - 1) * 3);
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + (len - 1) * 3);
  }
}

}  // namespace

int vp8_info(const uint8_t* data, size_t size, int* w, int* h) {
  if (size < 10) return kTruncated;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kCorrupt;  // the start code
  const uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
  // a key frame (bit 0 clear), profile 0-3, shown
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1)) return kCorrupt;
  if ((bits >> 5) >= size) return kTruncated;  // the first partition ends past the chunk
  *w = (data[7] << 8 | data[6]) & 0x3fff;  // the scale bits are ignored, as libwebp does
  *h = (data[9] << 8 | data[8]) & 0x3fff;
  return *w > 0 && *h > 0 ? kOk : kCorrupt;
}

void vp8_decode(const uint8_t* data, size_t size, Vp8Planes* planes) {
  Decoder dec(data, size);
  dec.run(planes);
}

// Rows 0 and, for an even height, h - 1 see one chroma row; every other
// pair of rows (2k - 1, 2k) sees chroma rows k - 1 and k (EmitFancyRGB).
void vp8_to_rgb(const Vp8Planes& p, uint8_t* out, size_t stride) {
  const int w = p.width, h = p.height, uvw = p.uv_width;
  const uint8_t* y = p.y.data();
  const uint8_t* u = p.u.data();
  const uint8_t* v = p.v.data();
  upsample_pair(y, nullptr, u, v, u, v, out, nullptr, w);
  int row = 0;
  for (; row + 2 < h; row += 2) {
    const size_t k = (size_t)(row / 2);
    upsample_pair(y + (size_t)(row + 1) * w, y + (size_t)(row + 2) * w, u + k * uvw, v + k * uvw,
                  u + (k + 1) * uvw, v + (k + 1) * uvw, out + (row + 1) * stride, out + (row + 2) * stride, w);
  }
  if (!(h & 1)) {
    const size_t k = (size_t)(row / 2);
    upsample_pair(y + (size_t)(row + 1) * w, nullptr, u + k * uvw, v + k * uvw, u + k * uvw, v + k * uvw,
                  out + (row + 1) * stride, nullptr, w);
  }
}

}  // namespace byogan
