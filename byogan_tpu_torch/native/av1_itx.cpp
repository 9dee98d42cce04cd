// The inverse transforms (AV1 specification 7.13): the DCT of 4 to 64
// points as the specification's butterfly steps, the ADST of 4, 8 and 16
// points, the identity transforms, the Walsh-Hadamard transform of lossless
// blocks, and the 2D process with its intermediate rounding and clamps.

#include <algorithm>

#include "av1_decoder.h"

namespace byogan {
namespace av1 {

namespace {

int cos128_of(int angle) {
  int a = angle & 255;
  if (a <= 64) return kCos128[a];
  if (a <= 128) return -kCos128[128 - a];
  if (a <= 192) return -kCos128[a - 128];
  return kCos128[256 - a];
}

// cos128 of every angle modulo 256, and the bit reversals of 2..6 bits.
struct Lookups {
  int cos[256];
  uint8_t brev[7][64];
  Lookups() {
    for (int a = 0; a < 256; a++) cos[a] = cos128_of(a);
    for (int n = 2; n <= 6; n++)
      for (int i = 0; i < (1 << n); i++) brev[n][i] = (uint8_t)brev_bits(n, i);
  }
  static int brev_bits(int numBits, int x) {
    int r = 0;
    for (int i = 0; i < numBits; i++) r |= ((x >> i) & 1) << (numBits - 1 - i);
    return r;
  }
};

const Lookups& lookups() {
  static const Lookups l;
  return l;
}

struct Tx {
  int32_t* T;
  int r;
  const int* cos = lookups().cos;
  void B(int a, int b, int angle, int flip) {
    int c = cos[angle & 255], s = cos[(angle - 64) & 255];
    int64_t x = (int64_t)T[a] * c - (int64_t)T[b] * s;
    int64_t y = (int64_t)T[a] * s + (int64_t)T[b] * c;
    int32_t xa = (int32_t)((x + 2048) >> 12), yb = (int32_t)((y + 2048) >> 12);
    T[a] = flip ? yb : xa;
    T[b] = flip ? xa : yb;
  }
  void H(int a, int b, int flip) {
    if (flip) std::swap(a, b);
    int64_t x = T[a], y = T[b];
    int64_t lo = -((int64_t)1 << (r - 1)), hi = ((int64_t)1 << (r - 1)) - 1;
    int64_t s = x + y, d = x - y;
    T[a] = (int32_t)(s < lo ? lo : s > hi ? hi : s);
    T[b] = (int32_t)(d < lo ? lo : d > hi ? hi : d);
  }
};

void idct(int32_t* T, int n, int r) {
  int n0 = 1 << n;
  int32_t copyT[64];
  std::memcpy(copyT, T, sizeof(int32_t) * n0);
  const uint8_t* rev = lookups().brev[n];
  for (int i = 0; i < n0; i++) T[i] = copyT[rev[i]];
  Tx t{T, r};
  if (n == 6)
    for (int i = 0; i < 16; i++) t.B(32 + i, 63 - i, 63 - 4 * lookups().brev[4][i], 0);
  if (n >= 5)
    for (int i = 0; i < 8; i++) t.B(16 + i, 31 - i, 62 - 8 * lookups().brev[3][i], 0);
  if (n == 6)
    for (int i = 0; i < 16; i++) t.H(32 + i * 2, 33 + i * 2, i & 1);
  if (n >= 4)
    for (int i = 0; i < 4; i++) t.B(8 + i, 15 - i, 60 - 16 * lookups().brev[2][i], 0);
  if (n >= 5)
    for (int i = 0; i < 8; i++) t.H(16 + 2 * i, 17 + 2 * i, i & 1);
  if (n == 6)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++) t.B(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * lookups().brev[2][i] + 64 * j, 1);
  if (n >= 3)
    for (int i = 0; i < 2; i++) t.B(4 + i, 7 - i, 56 - 32 * i, 0);
  if (n >= 4)
    for (int i = 0; i < 4; i++) t.H(8 + 2 * i, 9 + 2 * i, i & 1);
  if (n >= 5)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) t.B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1);
  if (n == 6)
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 2; j++) t.H(32 + i * 4 + j, 35 + i * 4 - j, i & 1);
  for (int i = 0; i < 2; i++) t.B(2 * i, 2 * i + 1, 32 + 16 * i, 1 - i);
  if (n >= 3)
    for (int i = 0; i < 2; i++) t.H(4 + 2 * i, 5 + 2 * i, i);
  if (n >= 4)
    for (int i = 0; i < 2; i++) t.B(14 - i, 9 + i, 48 + 64 * i, 1);
  if (n >= 5)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++) t.H(16 + 4 * i + j, 19 + 4 * i - j, i & 1);
  if (n == 6)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 4; j++) t.B(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + 64 * (j >> 1), 1);
  for (int i = 0; i < 2; i++) t.H(i, 3 - i, 0);
  if (n >= 3) t.B(6, 5, 32, 1);
  if (n >= 4)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) t.H(8 + 4 * i + j, 11 + 4 * i - j, i);
  if (n >= 5)
    for (int i = 0; i < 4; i++) t.B(29 - i, 18 + i, 48 + 64 * (i >> 1), 1);
  if (n == 6)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) t.H(32 + 8 * i + j, 39 + 8 * i - j, i & 1);
  if (n >= 3)
    for (int i = 0; i < 4; i++) t.H(i, 7 - i, 0);
  if (n >= 4)
    for (int i = 0; i < 2; i++) t.B(13 - i, 10 + i, 32, 1);
  if (n >= 5)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 4; j++) t.H(16 + i * 8 + j, 23 + i * 8 - j, i);
  if (n == 6)
    for (int i = 0; i < 8; i++) t.B(59 - i, 36 + i, i < 4 ? 48 : 112, 1);
  if (n >= 4)
    for (int i = 0; i < 8; i++) t.H(i, 15 - i, 0);
  if (n >= 5)
    for (int i = 0; i < 4; i++) t.B(27 - i, 20 + i, 32, 1);
  if (n == 6) {
    for (int i = 0; i < 8; i++) t.H(32 + i, 47 - i, 0);
    for (int i = 0; i < 8; i++) t.H(48 + i, 63 - i, 1);
  }
  if (n >= 5)
    for (int i = 0; i < 16; i++) t.H(i, 31 - i, 0);
  if (n == 6)
    for (int i = 0; i < 8; i++) t.B(55 - i, 40 + i, 32, 1);
  if (n == 6)
    for (int i = 0; i < 32; i++) t.H(i, 63 - i, 0);
}

void iadst4(int32_t* T) {
  const int64_t SINPI_1_9 = 1321, SINPI_2_9 = 2482, SINPI_3_9 = 3344, SINPI_4_9 = 3803;
  int64_t s0 = SINPI_1_9 * T[0], s1 = SINPI_2_9 * T[0], s2 = SINPI_3_9 * T[1], s3 = SINPI_4_9 * T[2];
  int64_t s4 = SINPI_1_9 * T[2], s5 = SINPI_2_9 * T[3], s6 = SINPI_4_9 * T[3];
  int64_t a7 = (int64_t)T[0] - T[2];
  int64_t b7 = a7 + T[3];
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = SINPI_3_9 * b7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  int64_t x0 = s0 + s3, x1 = s1 + s3, x2 = s2, x3 = s0 + s1;
  x3 = x3 - s3;
  T[0] = round2(x0, 12);
  T[1] = round2(x1, 12);
  T[2] = round2(x2, 12);
  T[3] = round2(x3, 12);
}

void iadst8(int32_t* T, int r) {
  int32_t c[8];
  std::memcpy(c, T, sizeof(c));
  for (int i = 0; i < 8; i++) T[i] = c[(i & 1) ? i - 1 : 8 - i - 1];
  Tx t{T, r};
  for (int i = 0; i < 4; i++) t.B(2 * i, 2 * i + 1, 60 - 16 * i, 1);
  for (int i = 0; i < 4; i++) t.H(i, i + 4, 0);
  t.B(4, 5, 48, 1);
  t.B(7, 6, 16, 1);
  for (int j = 0; j < 2; j++)
    for (int i = 0; i < 2; i++) t.H(i + 4 * j, i + 2 + 4 * j, 0);
  t.B(2, 3, 32, 1);
  t.B(6, 7, 32, 1);
  std::memcpy(c, T, sizeof(c));
  static const int kOut[8] = {0, 4, 6, 2, 3, 7, 5, 1};
  for (int i = 0; i < 8; i++) T[i] = (i & 1) ? -c[kOut[i]] : c[kOut[i]];
}

void iadst16(int32_t* T, int r) {
  int32_t c[16];
  std::memcpy(c, T, sizeof(c));
  for (int i = 0; i < 16; i++) T[i] = c[(i & 1) ? i - 1 : 16 - i - 1];
  Tx t{T, r};
  for (int i = 0; i < 8; i++) t.B(2 * i, 2 * i + 1, 62 - 8 * i, 1);
  for (int i = 0; i < 8; i++) t.H(i, i + 8, 0);
  t.B(8, 9, 56, 1);
  t.B(10, 11, 24, 1);
  t.B(13, 12, 8, 1);
  t.B(15, 14, 40, 1);
  for (int j = 0; j < 2; j++)
    for (int i = 0; i < 4; i++) t.H(i + 8 * j, i + 4 + 8 * j, 0);
  t.B(4, 5, 48, 1);
  t.B(7, 6, 16, 1);
  t.B(12, 13, 48, 1);
  t.B(15, 14, 16, 1);
  for (int j = 0; j < 4; j++)
    for (int i = 0; i < 2; i++) t.H(i + 4 * j, i + 2 + 4 * j, 0);
  for (int j = 0; j < 4; j++) t.B(2 + 4 * j, 3 + 4 * j, 32, 1);
  std::memcpy(c, T, sizeof(c));
  static const int kOut[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
  for (int i = 0; i < 16; i++) T[i] = (i & 1) ? -c[kOut[i]] : c[kOut[i]];
}

void identity(int32_t* T, int n) {
  int n0 = 1 << n;
  for (int i = 0; i < n0; i++) {
    switch (n) {
      case 2: T[i] = round2((int64_t)T[i] * 5793, 12); break;
      case 3: T[i] = T[i] * 2; break;
      case 4: T[i] = round2((int64_t)T[i] * 11586, 12); break;
      default: T[i] = T[i] * 4; break;
    }
  }
}

void iwht(int32_t* T, int shift) {
  int32_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
  a += c;
  d -= b;
  int32_t e = (a - d) >> 1;
  b = e - b;
  c = e - c;
  a -= b;
  d += c;
  T[0] = a;
  T[1] = b;
  T[2] = c;
  T[3] = d;
}

enum { kDct, kAdst, kIdentity };

void transform_1d(int32_t* T, int kind, int n, int r) {
  if (kind == kDct)
    idct(T, n, r);
  else if (kind == kIdentity)
    identity(T, n);
  else if (n == 2)
    iadst4(T);
  else if (n == 3)
    iadst8(T, r);
  else
    iadst16(T, r);
}

}  // namespace

void inverse_transform_2d(const int32_t (*coefs)[32], int txSz, int txType, int lossless, int bitDepth,
                          int32_t* residual) {
  int log2W = kTxWidthLog2[txSz], log2H = kTxHeightLog2[txSz];
  int w = 1 << log2W, h = 1 << log2H;
  int rowShift = lossless ? 0 : kTransformRowShift[txSz];
  int colShift = lossless ? 0 : 4;
  int rowClampRange = bitDepth + 8, colClampRange = std::max(bitDepth + 6, 16);
  int rowKind, colKind;
  switch (txType) {
    case DCT_DCT: case ADST_DCT: case FLIPADST_DCT: case H_DCT: rowKind = kDct; break;
    case IDTX: case V_DCT: case V_ADST: case V_FLIPADST: rowKind = kIdentity; break;
    default: rowKind = kAdst; break;
  }
  switch (txType) {
    case DCT_DCT: case DCT_ADST: case DCT_FLIPADST: case V_DCT: colKind = kDct; break;
    case IDTX: case H_DCT: case H_ADST: case H_FLIPADST: colKind = kIdentity; break;
    default: colKind = kAdst; break;
  }
  int32_t T[64];
  for (int i = 0; i < h; i++) {
    int32_t* res = residual + i * w;
    if (i >= 32) {  // no coefficients: the row transforms to zeros
      std::memset(res, 0, sizeof(int32_t) * w);
      continue;
    }
    for (int j = 0; j < w; j++) T[j] = (i < 32 && j < 32) ? coefs[i][j] : 0;
    if (std::abs(log2W - log2H) == 1)
      for (int j = 0; j < w; j++) T[j] = round2((int64_t)T[j] * 2896, 12);
    if (lossless)
      iwht(T, 2);
    else
      transform_1d(T, rowKind, log2W, rowClampRange);
    for (int j = 0; j < w; j++) res[j] = round2(T[j], rowShift);
  }
  if (!lossless) {
    int32_t lo = -(1 << (colClampRange - 1)), hi = (1 << (colClampRange - 1)) - 1;
    for (int k = 0; k < w * h; k++) residual[k] = std::min(hi, std::max(lo, residual[k]));
  }
  for (int j = 0; j < w; j++) {
    for (int i = 0; i < h; i++) T[i] = residual[i * w + j];
    if (lossless)
      iwht(T, 0);
    else
      transform_1d(T, colKind, log2H, colClampRange);
    for (int i = 0; i < h; i++) residual[i * w + j] = round2(T[i], colShift);
  }
}

}  // namespace av1
}  // namespace byogan
