// BCn block decode (S3TC / RGTC / BPTC): the 4 x 4 blocks of DDS, FTEX and
// BLP2 textures, bit for bit with what Pillow 12.1.0 makes of them, the lane
// through which the JAX package reads those files (its prep, cli.project
// and its loader's fallback call Image.open(path).convert("RGB")).
//
// - BC1 to BC7 as Pillow's C "bcn" decoder gives them (DDS and FTEX): BC1,
//   BC2, BC3 and BC7 as RGBA, BC4 as L, BC5, BC5S, BC6H and BC6HS as RGB.
//   BC1's colours expand 5 and 6 bits by replicating their top bits; its
//   three-colour mode (color0 <= color1) holds a transparent black; BC2 and
//   BC3 always take the four-colour mode.  BC5S reads its endpoints as
//   signed bytes plus 128, and its blue is 128 (BC5's is 0).  BC6H interpolates the unquantised endpoints,
//   scales them by 31/64 (31/32 signed) into a half float, and writes
//   (uint8)(f * 255) clamped to [0, 255].  BC7's reserved mode (a first
//   byte of 0) is opaque black.
// - BLP2's DXT1, DXT3 and DXT5, which Pillow decodes with Python functions
//   of its own (BlpImagePlugin.py): the same blocks, but its unpack_565
//   shifts the 5- and 6-bit fields up without replicating their top bits,
//   and DXT1 gives three bytes a pixel unless the file has alpha.
//
// A block row that is cut by the image's right or bottom edge writes the
// pixels inside it alone, as Pillow's put_block does.

#include <algorithm>
#include <cstring>

#include "codec.h"

namespace byogan {
namespace {

struct Rgba {
  uint8_t r, g, b, a;
};
static_assert(sizeof(Rgba) == 4, "a block's 16 pixels copy out as 64 bytes");

inline uint32_t u16le(const uint8_t* p) { return p[0] | p[1] << 8; }
inline uint32_t u32le(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24; }

// the 5:6:5 colour of a BC1 colour block, its fields widened to 8 bits by
// replicating their top bits (bcn) or by a shift alone (BLP's unpack_565)
inline Rgba unpack_565(uint32_t c, bool replicate) {
  Rgba p;
  p.r = (uint8_t)((c >> 11 & 31) << 3);
  p.g = (uint8_t)((c >> 5 & 63) << 2);
  p.b = (uint8_t)((c & 31) << 3);
  if (replicate) {
    p.r |= p.r >> 5;
    p.g |= p.g >> 6;
    p.b |= p.b >> 5;
  }
  p.a = 255;
  return p;
}

// A BC1 colour block (8 bytes) into 16 pixels; `four` forces the
// four-colour mode (BC2, BC3 and BLP's DXT3 and DXT5), where it is false
// color0 <= color1 selects three colours and a transparent black.
void bc1_colour(const uint8_t* src, bool four, bool replicate, Rgba* col) {
  const uint32_t c0 = u16le(src), c1 = u16le(src + 2), lut = u32le(src + 4);
  Rgba p[4];
  p[0] = unpack_565(c0, replicate);
  p[1] = unpack_565(c1, replicate);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four) {
    p[2] = {(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3), (uint8_t)((2 * b0 + b1) / 3), 255};
    p[3] = {(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3), (uint8_t)((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = {(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2), (uint8_t)((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) col[n] = p[lut >> (2 * n) & 3];
}

// A BC3 alpha block (8 bytes): two endpoints and 16 3-bit indices into a
// ramp of 8 (a0 > a1) or 6 values with 0 and 255; `sign` reads the
// endpoints as signed bytes plus 128 (BC5S).  Value n goes to dst[n * step].
void bc3_alpha(const uint8_t* src, bool sign, uint8_t* dst, int step) {
  const int a0 = sign ? (int8_t)src[0] + 128 : src[0], a1 = sign ? (int8_t)src[1] + 128 : src[1];
  uint8_t a[8] = {(uint8_t)a0, (uint8_t)a1};
  if (a0 > a1) {
    for (int k = 1; k < 7; k++) a[k + 1] = (uint8_t)(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; k++) a[k + 1] = (uint8_t)(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  const uint32_t lo = src[2] | src[3] << 8 | src[4] << 16, hi = src[5] | src[6] << 8 | src[7] << 16;
  for (int n = 0; n < 16; n++) dst[n * step] = a[(n < 8 ? lo >> (3 * n) : hi >> (3 * (n - 8))) & 7];
}

// --- BC7 and BC6H (BPTC) -----------------------------------------------

inline int bit_at(const uint8_t* src, int bit) { return src[bit >> 3] >> (bit & 7) & 1; }

// `count` (at most 8) bits from bit `bit`, least significant first
inline int bits_at(const uint8_t* src, int bit, int count) {
  if (!count) return 0;
  const int by = bit >> 3, sh = bit & 7;
  const int x = sh + count <= 8 ? src[by] : src[by] | src[by + 1] << 8;
  return x >> sh & ((1 << count) - 1);
}

// the subset of each pixel of the 64 partitions of two subsets (bit n:
// pixel n's) and of three (two bits a pixel)
const uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8,
    0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110,
    0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696,
    0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720,
    0xc936, 0x936c, 0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0, 0x5a5a5050,
    0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250,
    0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200,
    0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50,
    0x500aa550, 0xaaaa4444, 0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
// the anchor pixel of subset 1 of two, and of subsets 1 and 2 of three
const uint8_t kAnchor2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8,
                              8,  15, 2,  8,  2,  2,  8,  8,  2,  2,  15, 15, 6,  8,  2,  8,  15, 15, 2, 8, 2, 2,
                              2,  15, 15, 6,  6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2, 15};
const uint8_t kAnchor3a[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,  3,  3,  8,  15, 3, 3,
                               6,  10, 5,  8,  8,  6,  8,  5,  15, 15, 8,  15, 3,  5,  6,  10, 8,  15, 15, 3, 15, 5,
                               15, 15, 15, 15, 3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,  15, 8, 15, 3,  15, 8,
                               15, 8,  3,  15, 6,  10, 15, 15, 10, 8,  15, 3,  15, 10, 10, 8,  9, 10, 6,  15, 8,  15,
                               3,  6,  6,  8,  15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8};

const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};
inline const uint8_t* weights(int bits) { return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4; }

inline int subset_of(int subsets, int partition, int n) {
  if (subsets == 2) return kPartition2[partition] >> n & 1;
  if (subsets == 3) return kPartition3[partition] >> (2 * n) & 3;
  return 0;
}

// BC7's modes: subsets, partition bits, rotation bits, index selection
// bits, colour bits, alpha bits, p-bits an endpoint, p-bits a subset,
// index bits, second index bits
struct Bc7Mode {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                              {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                              {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                              {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

inline uint8_t expand_bits(int v, int bits) {
  v <<= 8 - bits;
  return (uint8_t)(v | v >> bits);
}

void bc7_block(const uint8_t* src, Rgba* col) {
  if (!src[0]) {  // the reserved mode: opaque black
    for (int n = 0; n < 16; n++) col[n] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] >> mode & 1)) mode++;
  const Bc7Mode& m = kBc7Modes[mode];
  int bit = mode + 1;
  auto load = [&](int n) {
    const int v = bits_at(src, bit, n);
    bit += n;
    return v;
  };
  const int partition = load(m.pb), rotation = load(m.rb), index_sel = load(m.isb);
  const int numep = m.ns * 2;
  int ep[6][4];
  for (int c = 0; c < 3; c++)
    for (int i = 0; i < numep; i++) ep[i][c] = load(m.cb);
  for (int i = 0; i < numep; i++) ep[i][3] = m.ab ? load(m.ab) : 255;
  int cb = m.cb, ab = m.ab;
  if (m.epb || m.spb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i++) {
      if (m.epb || i % 2 == 0) {
        const int p = load(1);
        for (int j = i; j < (m.epb ? i + 1 : i + 2); j++)
          for (int c = 0; c < (ab ? 4 : 3); c++) ep[j][c] = ep[j][c] << 1 | p;
      }
    }
  }
  for (int i = 0; i < numep; i++) {
    for (int c = 0; c < 3; c++) ep[i][c] = expand_bits(ep[i][c], cb);
    if (ab) ep[i][3] = expand_bits(ep[i][3], ab);
  }
  const uint8_t* cw = weights(m.ib);
  const uint8_t* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  int cibit = bit, aibit = bit + 16 * m.ib - m.ns;
  for (int n = 0; n < 16; n++) {
    const int s = subset_of(m.ns, partition, n);
    int ib = m.ib;
    if (n == 0 || (m.ns == 2 && n == kAnchor2[partition]) ||
        (m.ns == 3 && ((s == 1 && n == kAnchor3a[partition]) || (s == 2 && n == kAnchor3b[partition]))))
      ib--;
    const int i0 = bits_at(src, cibit, ib);
    cibit += ib;
    int sc = cw[i0], sa = cw[i0];
    if (ab && m.ib2) {
      const int ib2 = n == 0 ? m.ib2 - 1 : m.ib2;
      const int i1 = bits_at(src, aibit, ib2);
      aibit += ib2;
      if (index_sel) {
        sc = aw[i1];
        sa = cw[i0];
      } else {
        sa = aw[i1];
      }
    }
    const int* e0 = ep[2 * s];
    const int* e1 = ep[2 * s + 1];
    uint8_t v[4];
    for (int c = 0; c < 4; c++) {
      const int t = c < 3 ? sc : sa;
      v[c] = (uint8_t)(((64 - t) * e0[c] + t * e1[c] + 32) >> 6);
    }
    if (rotation) std::swap(v[rotation - 1], v[3]);
    col[n] = {v[0], v[1], v[2], v[3]};
  }
}

// BC6H's 14 modes: subsets, whether the endpoints after the first are
// deltas, partition bits, endpoint bits, delta bits of red, green, blue
struct Bc6Mode {
  uint8_t ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode kBc6Modes[14] = {{2, 1, 5, 10, 5, 5, 5},   {2, 1, 5, 7, 6, 6, 6},    {2, 1, 5, 11, 5, 4, 4},
                               {2, 1, 5, 11, 4, 5, 4},   {2, 1, 5, 11, 4, 4, 5},   {2, 1, 5, 9, 5, 5, 5},
                               {2, 1, 5, 8, 6, 5, 5},    {2, 1, 5, 8, 5, 6, 5},    {2, 1, 5, 8, 5, 5, 6},
                               {2, 0, 5, 6, 6, 6, 6},    {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
                               {1, 1, 0, 12, 8, 8, 8},   {1, 1, 0, 16, 4, 4, 4}};

// Each mode's endpoint bits in the order they are stored, as the BC6H
// format lists them: "<endpoint><channel>[hi:lo]", endpoints w x y z (0-3)
// and channels r g b; a range written lo:hi is stored reversed (its high
// bit first).
const char* const kBc6Layouts[14] = {
    "y g4 y b4 z b4 w r9:0 w g9:0 w b9:0 x r4:0 z g4 y g3:0 x g4:0 z b0 z g3:0 x b4:0 z b1 y b3:0 y r4:0 z b2 "
    "z r4:0 z b3",
    "y g5 z g4 z g5 w r6:0 z b0 z b1 y b4 w g6:0 y b5 z b2 y g4 w b6:0 z b3 z b5 z b4 x r5:0 y g3:0 x g5:0 "
    "z g3:0 x b5:0 y b3:0 y r5:0 z r5:0",
    "w r9:0 w g9:0 w b9:0 x r4:0 w r10 y g3:0 x g3:0 w g10 z b0 z g3:0 x b3:0 w b10 z b1 y b3:0 y r4:0 z b2 "
    "z r4:0 z b3",
    "w r9:0 w g9:0 w b9:0 x r3:0 w r10 z g4 y g3:0 x g4:0 w g10 z g3:0 x b3:0 w b10 z b1 y b3:0 y r3:0 z b0 "
    "z b2 z r3:0 y g4 z b3",
    "w r9:0 w g9:0 w b9:0 x r3:0 w r10 y b4 y g3:0 x g3:0 w g10 z b0 z g3:0 x b4:0 w b10 y b3:0 y r3:0 z b1 "
    "z b2 z r3:0 z b4 z b3",
    "w r8:0 y b4 w g8:0 y g4 w b8:0 z b4 x r4:0 z g4 y g3:0 x g4:0 z b0 z g3:0 x b4:0 z b1 y b3:0 y r4:0 z b2 "
    "z r4:0 z b3",
    "w r7:0 z g4 y b4 w g7:0 z b2 y g4 w b7:0 z b3 z b4 x r5:0 y g3:0 x g4:0 z b0 z g3:0 x b4:0 z b1 y b3:0 "
    "y r5:0 z r5:0",
    "w r7:0 z b0 y b4 w g7:0 y g5 y g4 w b7:0 z g5 z b4 x r4:0 z g4 y g3:0 x g5:0 z g3:0 x b4:0 z b1 y b3:0 "
    "y r4:0 z b2 z r4:0 z b3",
    "w r7:0 z b1 y b4 w g7:0 y b5 y g4 w b7:0 z b5 z b4 x r4:0 z g4 y g3:0 x g4:0 z b0 z g3:0 x b5:0 y b3:0 "
    "y r4:0 z b2 z r4:0 z b3",
    "w r5:0 z g4 z b0 z b1 y b4 w g5:0 y g5 y b5 z b2 y g4 w b5:0 z g5 z b3 z b5 z b4 x r5:0 y g3:0 x g5:0 "
    "z g3:0 x b5:0 y b3:0 y r5:0 z r5:0",
    "w r9:0 w g9:0 w b9:0 x r9:0 x g9:0 x b9:0",
    "w r9:0 w g9:0 w b9:0 x r8:0 w r10 x g8:0 w g10 x b8:0 w b10",
    "w r9:0 w g9:0 w b9:0 x r7:0 w r10:11 x g7:0 w g10:11 x b7:0 w b10:11",
    "w r9:0 w g9:0 w b9:0 x r3:0 w r10:15 x g3:0 w g10:15 x b3:0 w b10:15",
};

// kBc6Bits[mode][i]: where the i-th endpoint bit goes, endpoint value
// (w r, w g, w b, x r, ... z b: 0-11) << 4 | its bit; built from the layouts
struct Bc6Bits {
  uint8_t at[14][75];
  int count[14];
  Bc6Bits() {
    for (int m = 0; m < 14; m++) {
      int n = 0;
      for (const char* p = kBc6Layouts[m]; *p;) {
        while (*p == ' ') p++;
        const int e = p[0] - 'w', c = p[2] == 'r' ? 0 : p[2] == 'g' ? 1 : 2;
        p += 3;
        int hi = 0, lo;  // the first number and the second
        while (*p >= '0' && *p <= '9') hi = hi * 10 + (*p++ - '0');
        lo = hi;
        if (*p == ':') {
          p++;
          lo = 0;
          while (*p >= '0' && *p <= '9') lo = lo * 10 + (*p++ - '0');
        }
        // "hi:lo" is stored from its low bit up, "lo:hi" from its high bit
        // down: either way from the second number towards the first
        const int step = hi >= lo ? 1 : -1;
        for (int b = lo;; b += step) {
          at[m][n++] = (uint8_t)((e * 3 + c) << 4 | b);
          if (b == hi) break;
        }
      }
      count[m] = n;
    }
  }
};
const Bc6Bits kBc6Bits;

inline int sign_extend(int v, int bits) { return v & (1 << (bits - 1)) ? v | -(1 << bits) : v & ((1 << bits) - 1); }

int bc6_unquantize(int v, int prec, bool sign) {
  if (!sign) {
    if (prec >= 15 || v == 0) return v;
    if (v == (1 << prec) - 1) return 0xffff;
    return ((v << 15) + 0x4000) >> (prec - 1);
  }
  v = (int16_t)v;
  if (prec >= 16) return v;
  const bool negative = v < 0;
  if (negative) v = -v;
  if (v != 0) v = v >= (1 << (prec - 1)) - 1 ? 0x7fff : ((v << 15) + 0x4000) >> (prec - 1);
  return negative ? -v : v;
}

inline float half_to_float(uint32_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = (h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= (h & 0x8000) << 16;
  return o.f;
}

inline uint8_t bc6_byte(int v, bool sign) {
  float f;
  if (sign)
    f = v < 0 ? half_to_float(0x8000 | (uint32_t)((-v) * 31 / 32)) : half_to_float((uint32_t)(v * 31 / 32));
  else
    f = half_to_float((uint32_t)(v * 31 / 64));
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return (uint8_t)(f * 255.0f);
}

void bc6_block(const uint8_t* src, bool sign, uint8_t* rgb) {
  int mode = src[0] & 0x1f, bit = 5, ib = 3;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
  } else {
    mode = 10 + (mode >> 2);
    ib = 4;
  }
  if (mode >= 14) {  // a reserved mode: black
    memset(rgb, 0, 48);
    return;
  }
  const Bc6Mode& m = kBc6Modes[mode];
  int ep[12] = {0};
  for (int i = 0; i < kBc6Bits.count[mode]; i++) {
    const int at = kBc6Bits.at[mode][i];
    ep[at >> 4] |= bit_at(src, bit + i) << (at & 15);
  }
  bit += kBc6Bits.count[mode];
  const int partition = bits_at(src, bit, m.pb);
  bit += m.pb;
  const int numep = m.ns == 2 ? 12 : 6, mask = (1 << m.epb) - 1;
  // the endpoints as Pillow holds them, 16-bit words
  auto word = [](int v) { return v & 0xffff; };
  if (sign)
    for (int c = 0; c < 3; c++) ep[c] = word(sign_extend(ep[c], m.epb));
  if (sign || m.tr) {
    const int db[3] = {m.rb, m.gb, m.bb};
    for (int i = 3; i < numep; i++) ep[i] = word(sign_extend(ep[i], db[i % 3]));
  }
  if (m.tr)  // the sums are not sign-extended again (Pillow's decoder)
    for (int i = 3; i < numep; i++) ep[i] = (ep[i] + ep[i % 3]) & mask;
  int uq[12];
  for (int i = 0; i < numep; i++) uq[i] = bc6_unquantize(ep[i], m.epb, sign);
  const uint8_t* cw = weights(ib);
  for (int n = 0; n < 16; n++) {
    const int s = subset_of(m.ns, partition, n) * 6;
    const int bits = n == 0 || (m.ns == 2 && n == kAnchor2[partition]) ? ib - 1 : ib;
    const int w = cw[bits_at(src, bit, bits)];
    bit += bits;
    for (int c = 0; c < 3; c++) rgb[3 * n + c] = bc6_byte((uq[s + c] * (64 - w) + uq[s + 3 + c] * w) / 64, sign);
  }
}

// the block bytes and output channels of each of bcn's formats
struct Format {
  int block, channels;
};
Format format_of(int f) {
  switch (f) {
    case kBc1: case kBc2: case kBc3: case kBc7: case kBlpDxt1Alpha: case kBlpDxt3: case kBlpDxt5:
      return {f == kBc1 || f == kBlpDxt1Alpha ? 8 : 16, 4};
    case kBc4:
      return {8, 1};
    case kBc5: case kBc5s: case kBc6h: case kBc6hs:
      return {16, 3};
    case kBlpDxt1:
      return {8, 3};
    default:
      return {0, 0};
  }
}

}  // namespace

int decode_bcn(const uint8_t* data, size_t size, int pixel_format, int w, int h, uint8_t* out) {
  const Format fmt = format_of(pixel_format);
  if (!fmt.block || w <= 0 || h <= 0) return kCorrupt;
  const size_t across = ((size_t)w + 3) / 4, down = ((size_t)h + 3) / 4;
  if (size / fmt.block < across * down) return kTruncated;
  const bool blp = pixel_format >= kBlpDxt1;
  const int C = fmt.channels;
  Rgba col[16];
  uint8_t px[16 * 4];
  for (size_t by = 0; by < down; by++) {
    for (size_t bx = 0; bx < across; bx++) {
      const uint8_t* src = data + (by * across + bx) * fmt.block;
      switch (pixel_format) {
        case kBc1: case kBlpDxt1: case kBlpDxt1Alpha:
          bc1_colour(src, false, !blp, col);
          break;
        case kBc2: case kBlpDxt3:
          bc1_colour(src + 8, true, !blp, col);
          for (int n = 0; n < 16; n++) col[n].a = (uint8_t)((src[n >> 1] >> (4 * (n & 1)) & 15) * 17);
          break;
        case kBc3: case kBlpDxt5:
          bc1_colour(src + 8, true, !blp, col);
          bc3_alpha(src, false, &col[0].a, 4);
          break;
        case kBc4:
          bc3_alpha(src, false, px, 1);
          break;
        case kBc5: case kBc5s:
          bc3_alpha(src, pixel_format == kBc5s, px, 3);
          bc3_alpha(src + 8, pixel_format == kBc5s, px + 1, 3);
          for (int n = 0; n < 16; n++) px[3 * n + 2] = pixel_format == kBc5s ? 128 : 0;  // Pillow's blue
          break;
        case kBc6h: case kBc6hs:
          bc6_block(src, pixel_format == kBc6hs, px);
          break;
        case kBc7:
          bc7_block(src, col);
          break;
      }
      if (C == 4) {
        memcpy(px, col, sizeof(col));
      } else if (pixel_format == kBlpDxt1) {
        for (int n = 0; n < 16; n++) memcpy(px + 3 * n, &col[n], 3);
      }
      // the block's rows, each cut at the image's right edge
      const size_t x0 = bx * 4, cols = std::min<size_t>(4, (size_t)w - x0);
      for (int j = 0; j < 4 && by * 4 + j < (size_t)h; j++)
        memcpy(out + ((by * 4 + j) * w + x0) * C, px + j * 4 * C, cols * C);
    }
  }
  return kOk;
}

}  // namespace byogan
