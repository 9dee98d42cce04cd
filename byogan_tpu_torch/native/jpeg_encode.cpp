// A baseline JPEG encoder that writes the bytes libjpeg-turbo writes for
// the JAX package's call (byogan_tpu/native/byogan_io.cpp:265-297:
// jpeg_set_defaults, then jpeg_set_quality(q, TRUE)):
//
//   SOI, a JFIF 1.01 APP0 (density unit 0, 1:1), DQT 0 and 1 (the standard
//   tables scaled by jpeg_quality_scaling, clamped to 1-255), SOF0 with
//   Y 2x2 and Cb, Cr 1x1 (4:2:0), DHT of the four standard tables, SOS,
//   the Huffman-coded blocks, EOI.
//
// The samples go through jccolor.c's RGB -> YCbCr tables, jcsample.c's
// h2v2_downsample (bias 1, 2 alternating, edges repeated to whole MCUs, as
// jcprepct.c pads), jfdctint.c's islow forward DCT and libjpeg-turbo's
// quantiser (jcdctmgr.c: a reciprocal, a correction and a shift per
// coefficient), then jchuff.c's encode_one_block with the final bits
// padded with 1s.  Blocks past the image's right and bottom edges inside
// an MCU are jccoefct.c's dummy blocks: zero but for the DC of the block
// before.

#include <cstring>
#include <new>
#include <vector>

#include "codec.h"

namespace byogan {
namespace {

const uint8_t kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
};
const uint8_t kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
};

// jcparam.c: jpeg_quality_scaling, then jpeg_add_quant_table with
// force_baseline.  Natural order.
void scale_table(const uint8_t* basic, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (basic[i] * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    out[i] = (uint16_t)t;
  }
}

// jcdctmgr.c's compute_reciprocal for 16-bit DCTELEMs (the build with
// SIMD): quantising x is ((|x| + corr) * recip) >> shift, with x's sign.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor);
  const uint32_t fr = (uint32_t)((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

inline int quantize(int x, const Divisor& d) {
  if (x < 0) return -(int)(((uint64_t)(uint32_t)(-x + (int)d.corr) * d.recip) >> d.shift);
  return (int)(((uint64_t)(uint32_t)(x + (int)d.corr) * d.recip) >> d.shift);
}

// jfdctint.c's jpeg_fdct_islow, in place: samples - 128 in, coefficients
// scaled up by 8 out.
void fdct_islow(int* data) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                    F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  auto descale = [](int32_t x, int n) { return (x + (1 << (n - 1))) >> n; };
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    const int odd_shift = pass ? kConst + kPass1 : kConst - kPass1;
    for (int i = 0; i < 8; i++) {
      int* d = data + i * next;
      const int32_t t0 = d[0] + d[7 * step], t7 = d[0] - d[7 * step];
      const int32_t t1 = d[step] + d[6 * step], t6 = d[step] - d[6 * step];
      const int32_t t2 = d[2 * step] + d[5 * step], t5 = d[2 * step] - d[5 * step];
      const int32_t t3 = d[3 * step] + d[4 * step], t4 = d[3 * step] - d[4 * step];
      const int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      if (pass == 0) {
        d[0] = (t10 + t11) * (1 << kPass1);
        d[4 * step] = (t10 - t11) * (1 << kPass1);
      } else {
        d[0] = descale(t10 + t11, kPass1);
        d[4 * step] = descale(t10 - t11, kPass1);
      }
      const int32_t z1 = (t12 + t13) * F0541;
      d[2 * step] = descale(z1 + t13 * F0765, odd_shift);
      d[6 * step] = descale(z1 + t12 * -F1847, odd_shift);
      int32_t a1 = t4 + t7, a2 = t5 + t6, a3 = t4 + t6, a4 = t5 + t7;
      const int32_t z5 = (a3 + a4) * F1175;
      const int32_t b4 = t4 * F0298, b5 = t5 * F2053, b6 = t6 * F3072, b7 = t7 * F1501;
      a1 *= -F0899;
      a2 *= -F2562;
      a3 = a3 * -F1961 + z5;
      a4 = a4 * -F0390 + z5;
      d[7 * step] = descale(b4 + a1 + a3, odd_shift);
      d[5 * step] = descale(b5 + a2 + a4, odd_shift);
      d[3 * step] = descale(b6 + a2 + a3, odd_shift);
      d[step] = descale(b7 + a1 + a4, odd_shift);
    }
  }
}

// Code and length of every symbol (jchuff.c's jpeg_make_c_derived_tbl).
struct Codes {
  uint16_t code[256];
  uint8_t size[256];
};

void derive(const HuffSpec& spec, Codes* t) {
  memset(t, 0, sizeof(*t));
  uint32_t c = 0;
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < spec.bits[l]; i++, p++) {
      t->code[spec.vals[p]] = (uint16_t)c++;
      t->size[spec.vals[p]] = (uint8_t)l;
    }
    c <<= 1;
  }
}

// Bits into bytes, 0xFF followed by a stuffed 0x00.
struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t bits, int k) {
    acc = (acc << k) | (bits & ((1u << k) - 1));
    n += k;
    while (n >= 8) {
      const uint8_t b = (uint8_t)(acc >> (n - 8));
      out->push_back(b);
      if (b == 0xFF) out->push_back(0);
      n -= 8;
    }
  }
  // jchuff.c's flush_bits: seven 1s, then the partial byte is dropped.
  void flush() {
    put(0x7F, 7);
    n = 0;
  }
};

inline int nbits(int v) { return v ? 32 - __builtin_clz((uint32_t)v) : 0; }

// jchuff.c's encode_one_block.
void encode_block(BitWriter& bw, const int16_t* blk, int* last_dc, const Codes& dc, const Codes& ac) {
  int t = blk[0] - *last_dc;
  *last_dc = blk[0];
  int t2 = t;
  if (t < 0) {
    t = -t;
    t2--;
  }
  int nb = nbits(t);
  bw.put(dc.code[nb], dc.size[nb]);
  if (nb) bw.put((uint32_t)t2, nb);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    t = blk[kNatural[k]];
    if (t == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    t2 = t;
    if (t < 0) {
      t = -t;
      t2--;
    }
    nb = nbits(t);
    const int sym = (r << 4) + nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put((uint32_t)t2, nb);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>* f, int v) {
  f->push_back((uint8_t)(v >> 8));
  f->push_back((uint8_t)v);
}

void put_dht(std::vector<uint8_t>* f, const HuffSpec& spec, int index) {
  int count = 0;
  for (int l = 1; l <= 16; l++) count += spec.bits[l];
  f->push_back(0xFF);
  f->push_back(0xC4);
  put16(f, 2 + 1 + 16 + count);
  f->push_back((uint8_t)index);
  for (int l = 1; l <= 16; l++) f->push_back(spec.bits[l]);
  f->insert(f->end(), spec.vals, spec.vals + count);
}

// The block of a plane at (row, col), through the FDCT and the quantiser.
void forward_block(const uint8_t* plane, int stride, int row, int col, const Divisor* div, int16_t* out) {
  int d[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) d[y * 8 + x] = plane[(size_t)(row + y) * stride + col + x] - 128;
  fdct_islow(d);
  for (int i = 0; i < 64; i++) out[i] = (int16_t)quantize(d[i], div[i]);
}

}  // namespace

int encode_jpeg(const uint8_t* rgb, int h, int w, int quality, std::vector<uint8_t>* file) {
  try {
    if (h < 1 || w < 1 || h > 65500 || w > 65500) return kCorrupt;
    const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
    // Y: the image's pixels, its last column and row repeated over whole
    // blocks; Cb, Cr: h2v2_downsample of the full-size planes (columns
    // repeated to whole MCUs, an odd last row paired with itself), then
    // the last downsampled row repeated to whole MCUs (jcprepct.c).
    const int ys = mcux * 16, yr = mcuy * 16, cs = mcux * 8, cr = mcuy * 8;
    std::vector<uint8_t> ypl((size_t)ys * yr), cbf((size_t)ys * 2), crf((size_t)ys * 2);
    std::vector<uint8_t> cb((size_t)cs * cr), crp((size_t)cs * cr);
    constexpr int S = 16;
    constexpr int32_t half = 1 << (S - 1), off = 128 << S;
    auto fx = [](double x) { return (int32_t)(x * (1 << S) + 0.5); };
    const int32_t ry = fx(0.29900), gy = fx(0.58700), by = fx(0.11400), rcb = -fx(0.16874), gcb = -fx(0.33126),
                  bcb = fx(0.50000), gcr = -fx(0.41869), bcr = -fx(0.08131);
    const int chroma_rows = (h + 1) / 2;
    for (int y = 0; y < yr; y++) {
      const int sy = y < h ? y : h - 1;
      const uint8_t* src = rgb + (size_t)sy * w * 3;
      uint8_t* yrow = ypl.data() + (size_t)y * ys;
      uint8_t* cbrow = cbf.data() + (size_t)(y & 1) * ys;
      uint8_t* crrow = crf.data() + (size_t)(y & 1) * ys;
      for (int x = 0; x < ys; x++) {
        const uint8_t* px = src + 3 * (x < w ? x : w - 1);
        const int r = px[0], g = px[1], b = px[2];
        yrow[x] = (uint8_t)((ry * r + gy * g + by * b + half) >> S);
        cbrow[x] = (uint8_t)((rcb * r + gcb * g + bcb * b + off + half - 1) >> S);
        crrow[x] = (uint8_t)((bcb * r + gcr * g + bcr * b + off + half - 1) >> S);
      }
      if ((y & 1) && y / 2 < chroma_rows) {
        for (int pl = 0; pl < 2; pl++) {
          const uint8_t* f = pl ? crf.data() : cbf.data();
          uint8_t* o = (pl ? crp.data() : cb.data()) + (size_t)(y / 2) * cs;
          for (int x = 0; x < cs; x++) {
            const int bias = (x & 1) ? 2 : 1;
            o[x] = (uint8_t)((f[2 * x] + f[2 * x + 1] + f[ys + 2 * x] + f[ys + 2 * x + 1] + bias) >> 2);
          }
        }
      }
    }
    for (int y = chroma_rows; y < cr; y++) {
      memcpy(cb.data() + (size_t)y * cs, cb.data() + (size_t)(chroma_rows - 1) * cs, cs);
      memcpy(crp.data() + (size_t)y * cs, crp.data() + (size_t)(chroma_rows - 1) * cs, cs);
    }

    uint16_t qt[2][64];
    scale_table(kLumaQuant, quality, qt[0]);
    scale_table(kChromaQuant, quality, qt[1]);
    Divisor div[2][64];
    for (int t = 0; t < 2; t++)
      for (int i = 0; i < 64; i++) div[t][i] = reciprocal(qt[t][i] * 8u);

    std::vector<uint8_t>& f = *file;
    f.clear();
    f.reserve((size_t)w * h / 2 + 1024);
    const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    f.insert(f.end(), head, head + sizeof(head));
    for (int t = 0; t < 2; t++) {
      f.push_back(0xFF);
      f.push_back(0xDB);
      put16(&f, 2 + 1 + 64);
      f.push_back((uint8_t)t);
      for (int i = 0; i < 64; i++) f.push_back((uint8_t)qt[t][kNatural[i]]);
    }
    const uint8_t sof[] = {0xFF, 0xC0, 0, 17, 8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8), (uint8_t)w,
                           3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    f.insert(f.end(), sof, sof + sizeof(sof));
    put_dht(&f, kStdDcLuma, 0x00);
    put_dht(&f, kStdAcLuma, 0x10);
    put_dht(&f, kStdDcChroma, 0x01);
    put_dht(&f, kStdAcChroma, 0x11);
    const uint8_t sos[] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
    f.insert(f.end(), sos, sos + sizeof(sos));

    Codes dc[2], ac[2];
    derive(kStdDcLuma, &dc[0]);
    derive(kStdAcLuma, &ac[0]);
    derive(kStdDcChroma, &dc[1]);
    derive(kStdAcChroma, &ac[1]);
    BitWriter bw{&f};
    int last[3] = {0, 0, 0};
    const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;  // Y's blocks inside the image
    int16_t blk[4][64];
    int16_t c[64];
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++) {
        for (int by = 0; by < 2; by++) {
          const int row = my * 2 + by;
          for (int bx = 0; bx < 2; bx++) {
            const int col = mx * 2 + bx, n = by * 2 + bx;
            if (row < ybh && col < ybw) {
              forward_block(ypl.data(), ys, row * 8, col * 8, div[0], blk[n]);
            } else {  // dummy: the DC of the block before it in the MCU
              memset(blk[n], 0, sizeof(blk[n]));
              blk[n][0] = blk[row < ybh ? n - 1 : 1][0];
            }
          }
        }
        for (int n = 0; n < 4; n++) encode_block(bw, blk[n], &last[0], dc[0], ac[0]);
        forward_block(cb.data(), cs, my * 8, mx * 8, div[1], c);
        encode_block(bw, c, &last[1], dc[1], ac[1]);
        forward_block(crp.data(), cs, my * 8, mx * 8, div[1], c);
        encode_block(bw, c, &last[2], dc[1], ac[1]);
      }
    }
    bw.flush();
    f.push_back(0xFF);
    f.push_back(0xD9);
    return kOk;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace byogan
