// AVIF planes to Pillow's RGB, as libavif 1.3.0's avifImageYUVToRGB makes
// the RGB (or RGBA) image of 8-bit samples Pillow 12.1.0 asks for and
// Image.convert("RGB") keeps its colour bands:
//
//   * 8-bit 4:2:0, 4:2:2 and 4:4:4 of a BT.601, BT.709 or BT.2020 matrix
//     (or an unspecified one, or chroma-derived from those primaries) go
//     through libyuv 1909: the chroma upsampled by its bilinear filter
//     (ScaleRowUp2_Bilinear / ScaleRowUp2_Linear with their edge rules, the
//     filter libavif picks in its AUTOMATIC mode), then YuvPixel's fixed
//     point with the kYuv*Constants of the range;
//   * 10- and 12-bit samples of those matrices go the same way shifted down
//     to 8 bits (libavif's avifImageDownshiftTo8bpc), but for an image
//     with alpha (the RGBA Pillow asks for): 10-bit ones through libyuv's
//     I010/I210/I410ToARGBMatrix(Filter) (the chroma upsampled at 16 bits,
//     YuvPixel10), 12-bit 4:2:0 through I012ToARGBMatrix (nearest chroma,
//     YuvPixel12);
//   * 4:0:0 with alpha through libyuv's I400ToARGBMatrix (shifted down to
//     8 bits), without alpha through libavif's own float path;
//   * the identity matrix, YCgCo and the matrices libyuv lacks in 4:4:4 go
//     through libavif's float path (avifImageYUV8ToRGB8Color,
//     avifImageYUVAnyToRGBAnySlow and the 16-bit ones);
//   * alpha: the alpha item's plane, limited range widened as libavif
//     widens it, brought to 8 bits as each path does (a shift in libyuv's,
//     a rounded float in libavif's); a premultiplied image ('prem') is
//     unpremultiplied as libyuv 1909's ARGBUnattenuate does (opaque pixels
//     left), or in float where libavif's slow path divides, before Pillow
//     drops the alpha band.
//
// Other matrices in subsampled chroma go through libavif's float bilinear
// path, which the port does not read (refused by name).

#include <algorithm>
#include <new>

#include "av1.h"
#include "codec.h"

namespace byogan {

namespace {

struct YuvConstants {
  int ub, ug, vg, vr, yg, yb;
};

// libyuv's kYuvI601Constants, kYuvJPEGConstants, kYuvH709Constants,
// kYuvF709Constants, kYuv2020Constants, kYuvV2020Constants (x86 builds:
// the limited-range U-to-B coefficient held at 128).
const YuvConstants kI601 = {128, 25, 52, 102, 18997, -1160};
const YuvConstants kJpeg = {113, 22, 46, 90, 16320, 32};
const YuvConstants kH709 = {128, 14, 34, 115, 18997, -1160};
const YuvConstants kF709 = {119, 12, 30, 101, 16320, 32};
const YuvConstants k2020 = {128, 12, 42, 107, 19003, -1160};
const YuvConstants kV2020 = {120, 11, 37, 94, 16320, 32};

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// libyuv's YuvPixel (row_common.cc), written to R, G, B, from the 16-bit
// luma its row functions make (y * 0x0101 of 8 bits, y << 6 | y >> 4 of
// 10, y << 4 | y >> 8 of 12) and 8-bit chroma.
inline void yuv_pixel32(uint32_t y32, int u, int v, const YuvConstants& k, uint8_t* rgb) {
  int32_t y1 = (int32_t)((uint32_t)(y32 * (uint32_t)k.yg) >> 16) + k.yb;
  int ui = u - 128, vi = v - 128;
  int b16 = y1 + ui * k.ub;
  int g16 = y1 - (ui * k.ug + vi * k.vg);
  int r16 = y1 + vi * k.vr;
  rgb[0] = clamp255(r16 >> 6);
  rgb[1] = clamp255(g16 >> 6);
  rgb[2] = clamp255(b16 >> 6);
}

// ScaleRowUp2_Bilinear_Any_C (and its 16-bit twin) of chroma rows s and t
// into d (width w).
template <typename T>
void up2_bilinear(const T* s, const T* t, T* d, int w) {
  int work = (w - 1) & ~1;
  d[0] = (T)((3 * s[0] + t[0] + 2) >> 2);
  for (int x = 0; x < work / 2; x++) {
    d[2 * x + 1] = (T)((s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4);
    d[2 * x + 2] = (T)((s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4);
  }
  int l = (w - 1) / 2;
  d[w - 1] = (T)((3 * s[l] + t[l] + 2) >> 2);
}

// ScaleRowUp2_Linear_Any_C (and its 16-bit twin).
template <typename T>
void up2_linear(const T* s, T* d, int w) {
  int work = (w - 1) & ~1;
  d[0] = s[0];
  for (int x = 0; x < work / 2; x++) {
    d[2 * x + 1] = (T)((s[x] * 3 + s[x + 1] + 2) >> 2);
    d[2 * x + 2] = (T)((s[x] + s[x + 1] * 3 + 2) >> 2);
  }
  d[w - 1] = s[(w - 1) / 2];
}

// libyuv's rows of upsampled chroma: emit(j, u, v) with the chroma of row j
// at full width.  I420ToRGB24MatrixBilinear (and its 16-bit twins): the
// first row from chroma row 0, then pairs of rows from chroma rows k and
// k + 1, the last row of an even height from the last chroma row.
template <typename T, typename Emit>
void upsampled_rows(const T* U, const T* V, int cs, int w, int h, int subX, int subY, Emit emit) {
  std::vector<T> urow(w), vrow(w), u2(w), v2(w);
  if (!subX && !subY) {
    for (int j = 0; j < h; j++) emit(j, U + (size_t)j * cs, V + (size_t)j * cs);
  } else if (!subY) {
    for (int j = 0; j < h; j++) {
      up2_linear(U + (size_t)j * cs, urow.data(), w);
      up2_linear(V + (size_t)j * cs, vrow.data(), w);
      emit(j, urow.data(), vrow.data());
    }
  } else {
    up2_bilinear(U, U, urow.data(), w);
    up2_bilinear(V, V, vrow.data(), w);
    emit(0, urow.data(), vrow.data());
    int kk = 0, j = 1;
    for (int y = 0; y < h - 2; y += 2, kk++) {
      const T* us = U + (size_t)kk * cs;
      const T* vs = V + (size_t)kk * cs;
      up2_bilinear(us, us + cs, urow.data(), w);
      up2_bilinear(us + cs, us, u2.data(), w);
      up2_bilinear(vs, vs + cs, vrow.data(), w);
      up2_bilinear(vs + cs, vs, v2.data(), w);
      emit(j++, urow.data(), vrow.data());
      emit(j++, u2.data(), v2.data());
    }
    if (!(h & 1)) {
      const T* us = U + (size_t)kk * cs;
      const T* vs = V + (size_t)kk * cs;
      up2_bilinear(us, us, urow.data(), w);
      up2_bilinear(vs, vs, vrow.data(), w);
      emit(j, urow.data(), vrow.data());
    }
  }
}

// libavif's avifLimitedToFullY / avifLimitedToFullUV at 8, 10 or 12 bits.
int limited_to_full(int v, int depth, bool uv) {
  int s = depth - 8, lo = 16 << s, hi = (uv ? 240 : 235) << s, top = (1 << depth) - 1;
  return std::max(0, std::min(top, ((v - lo) * top + (hi - lo) / 2) / (hi - lo)));
}

const YuvConstants* libyuv_matrix(int full, int mc, int cp) {
  if (mc == 12) {  // chroma-derived: by the primaries
    if (cp == 1 || cp == 2) mc = 1;
    else if (cp == 5 || cp == 6) mc = 6;
    else if (cp == 9) mc = 9;
    else return nullptr;
  }
  switch (mc) {
    case 1: return full ? &kF709 : &kH709;
    case 2: case 5: case 6: return full ? &kJpeg : &kI601;
    case 9: return full ? &kV2020 : &k2020;
    default: return nullptr;
  }
}

// avifCalcYUVCoefficients: kr and kb of the matrix (BT.601's by default).
void coefficients(int mc, float* kr, float* kb) {
  *kr = 0.299f;
  *kb = 0.114f;
  switch (mc) {
    case 1: *kr = 0.2126f; *kb = 0.0722f; break;
    case 4: *kr = 0.30f; *kb = 0.11f; break;
    case 5: case 6: *kr = 0.299f; *kb = 0.114f; break;
    case 7: *kr = 0.212f; *kb = 0.087f; break;
    case 9: case 10: *kr = 0.2627f; *kb = 0.0593f; break;
    default: break;
  }
}

// A plane's sample (8 or 16 bits a sample).
inline int sample(const av1::Planes& p, int c, int x, int y) {
  size_t at = (size_t)y * p.stride[c] + x;
  return p.bitDepth > 8 ? p.plane16[c][at] : p.plane[c][at];
}

// ARGBUnattenuate: each sample widened to 16 bits (c | c << 8) times the
// 16-bit reciprocal of alpha, >> 16; opaque pixels kept.  The product
// wraps as a signed 32-bit integer (alpha 1 and 2 turn bright samples
// negative, which clamp to 0), as libyuv's does.
void unattenuate(uint8_t* o, int a) {
  if (a == 255) return;
  uint32_t ia = a == 0 ? 0 : a == 1 ? 0xffff : 0x10000u / (uint32_t)a;
  for (int c = 0; c < 3; c++) o[c] = clamp255((int32_t)((((uint32_t)o[c] | ((uint32_t)o[c] << 8)) * ia)) >> 16);
}

}  // namespace

// The RGB of decoded AVIF planes (see the file's comment) into out
// (h x w x 3).  `alpha` is the alpha item's planes or null; `mc`/`cp` the
// effective CICP and `range` the effective full-range flag (an nclx box's,
// else the sequence header's); `premultiplied` the 'prem' reference.  0 or a
// kAvif code.
int avif_to_rgb(const av1::Planes& p, const av1::Planes* alpha, int cp, int mc, int range, int premultiplied,
                uint8_t* out) {
  int w = p.width, h = p.height;
  int full = range, depth = p.bitDepth, shift = depth - 8;
  uint8_t* rgb = out;
  // libavif 1.3.0 refuses these matrices (Reformat failed), and converts
  // YCgCo-Re and chroma-derived ones of other primaries by formulas the
  // port does not follow.
  if (mc == 3 || mc == 10 || mc == 11 || mc == 13 || mc == 14 || mc >= 16) return kAvifColour;
  if (mc == 15 || (mc == 12 && cp != 1 && cp != 2 && cp != 5 && cp != 6 && cp != 9)) return kAvifConversion;
  int mode = mc == 0 ? 1 : (mc == 8 ? 2 : 0);  // 0 YUV coefficients, 1 identity, 2 YCgCo
  if (mode == 2 && !full) return kAvifColour;  // libavif: YCgCo of limited range, Reformat failed
  if (mode != 0 && !p.mono && (p.subX || p.subY)) {
    // libavif: identity needs 4:4:4; YCgCo subsampled takes the float bilinear path.
    return mode == 1 ? kAvifColour : kAvifConversion;
  }
  // The alpha samples at 8 bits: shifted down (libyuv's paths) or rounded
  // from a float (libavif's); lossy where a premultiplied image divides.
  bool alphaFloat = false, unpremultiplied = false;
  auto alpha8 = [&](int i, int j) {
    int a = sample(*alpha, 0, i, j), ad = alpha->bitDepth;
    if (!alpha->colorRange) a = limited_to_full(a, ad, false);
    if (ad == 8) return a;
    if (!alphaFloat) return a >> (ad - 8);
    float A = (float)a / (float)((1 << ad) - 1);
    return (int)(uint8_t)(0.5f + std::min(1.0f, std::max(0.0f, A)) * 255.0f);
  };
  const YuvConstants* k = nullptr;
  if (p.mono && alpha) k = libyuv_matrix(full, mc == 0 ? 2 : mc, cp);  // I400ToARGBMatrix
  else if (mode == 0 && !p.mono) k = libyuv_matrix(full, mc, cp);
  if (k && p.mono) {
    alphaFloat = true;
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++)
        yuv_pixel32((uint32_t)(sample(p, 0, i, j) >> shift) * 0x0101, 128, 128, *k, &rgb[((size_t)j * w + i) * 3]);
  } else if (k && depth == 10 && alpha) {
    // I010/I210/I410ToARGBMatrix(Filter): 16-bit chroma upsampled, YuvPixel10.
    const uint16_t* Y = p.plane16[0].data();
    upsampled_rows(p.plane16[1].data(), p.plane16[2].data(), p.stride[1], w, h, p.subX, p.subY,
                   [&](int j, const uint16_t* ur, const uint16_t* vr) {
                     for (int i = 0; i < w; i++) {
                       uint32_t y = Y[(size_t)j * p.stride[0] + i];
                       yuv_pixel32(y << 6 | y >> 4, std::min(255, ur[i] >> 2), std::min(255, vr[i] >> 2), *k,
                                   &rgb[((size_t)j * w + i) * 3]);
                     }
                   });
  } else if (k && depth == 12 && alpha && p.subX && p.subY) {
    // I012ToARGBMatrix: nearest chroma, YuvPixel12.
    alphaFloat = true;
    for (int j = 0; j < h; j++) {
      for (int i = 0; i < w; i++) {
        uint32_t y = (uint32_t)sample(p, 0, i, j);
        int u = sample(p, 1, i >> 1, j >> 1) >> 4, v = sample(p, 2, i >> 1, j >> 1) >> 4;
        yuv_pixel32(y << 4 | y >> 8, std::min(255, u), std::min(255, v), *k, &rgb[((size_t)j * w + i) * 3]);
      }
    }
  } else if (k) {
    // 8-bit samples, or 10- and 12-bit ones shifted down to 8
    // (avifImageDownshiftTo8bpc, libyuv's Convert16To8Plane).
    std::vector<uint8_t> down[3];
    const uint8_t* planes[3];
    for (int c = 0; c < 3; c++) {
      if (depth == 8) {
        planes[c] = p.plane[c].data();
        continue;
      }
      down[c].resize(p.plane16[c].size());
      for (size_t n = 0; n < down[c].size(); n++) down[c][n] = clamp255(p.plane16[c][n] >> shift);
      planes[c] = down[c].data();
    }
    upsampled_rows(planes[1], planes[2], p.stride[1], w, h, p.subX, p.subY,
                   [&](int j, const uint8_t* ur, const uint8_t* vr) {
                     for (int i = 0; i < w; i++)
                       yuv_pixel32(planes[0][(size_t)j * p.stride[0] + i] * 0x0101u, ur[i], vr[i], *k,
                                   &rgb[((size_t)j * w + i) * 3]);
                   });
  } else if (p.mono || (!p.subX && !p.subY)) {
    // libavif's float path: avifImageYUV8ToRGB8Mono and ...Color, their
    // 16-bit twins and avifImageYUVAnyToRGBAnySlow (no upsampling), from
    // tables of each sample value.
    alphaFloat = true;
    int top = (1 << depth) - 1;
    std::vector<float> tableY(top + 1), tableUV(top + 1);
    for (int c = 0; c <= top; c++) {
      if (depth == 8 && p.mono) {  // avifImageYUV8ToRGB8Mono: the range widened in integers
        tableY[c] = (float)(full ? c : limited_to_full(c, 8, false)) / 255.0f;
      } else {
        float biasY = full ? 0.0f : (float)(16 << shift), rangeY = full ? (float)top : (float)(219 << shift);
        float rangeUV = full ? (float)top : (float)(224 << shift);
        tableY[c] = ((float)c - biasY) / rangeY;
        tableUV[c] = mode == 1 ? tableY[c] : ((float)c - (float)(1 << (depth - 1))) / rangeUV;
      }
    }
    float kr, kb;
    coefficients(mc, &kr, &kb);
    float kg = 1.0f - kr - kb;
    // The slow path divides by alpha in float where it converts identity
    // and YCgCo (but 8-bit full-range identity, which libyuv's
    // MergeRGBPlane takes); the others are unpremultiplied after.
    unpremultiplied = alpha && premultiplied && mode != 0 && !(depth == 8 && mode == 1 && full);
    float alphaTop = alpha ? (float)((1 << alpha->bitDepth) - 1) : 1.0f;
    for (int j = 0; j < h; j++) {
      for (int i = 0; i < w; i++) {
        float Y = tableY[std::min(top, sample(p, 0, i, j))];
        float R, G, B;
        if (p.mono) {
          R = G = B = Y;
        } else {
          float Cb = tableUV[std::min(top, sample(p, 1, i, j))];
          float Cr = tableUV[std::min(top, sample(p, 2, i, j))];
          if (mode == 1) {
            G = Y;
            B = Cb;
            R = Cr;
          } else if (mode == 2) {
            float t = Y - Cb;
            G = Y + Cb;
            B = t - Cr;
            R = t + Cr;
          } else {
            R = Y + (2 * (1 - kr)) * Cr;
            B = Y + (2 * (1 - kb)) * Cb;
            G = Y - ((2 * ((kr * (1 - kr) * Cr) + (kb * (1 - kb) * Cb))) / kg);
          }
        }
        float c3[3] = {std::min(1.0f, std::max(0.0f, R)), std::min(1.0f, std::max(0.0f, G)),
                       std::min(1.0f, std::max(0.0f, B))};
        if (unpremultiplied) {
          int a = sample(*alpha, 0, i, j);
          if (!alpha->colorRange) a = limited_to_full(a, alpha->bitDepth, false);
          float Ac = std::min(1.0f, std::max(0.0f, (float)a / alphaTop));
          for (float& c : c3) {
            if (Ac >= 1.0f) continue;
            c = Ac <= 0.0f ? 0.0f : std::min(c / Ac, 1.0f);
          }
        }
        uint8_t* o = &rgb[((size_t)j * w + i) * 3];
        for (int c = 0; c < 3; c++) o[c] = (uint8_t)(0.5f + c3[c] * 255.0f);
      }
    }
  } else {
    return kAvifConversion;
  }
  if (alpha && premultiplied && !unpremultiplied) {
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++) unattenuate(&rgb[((size_t)j * w + i) * 3], alpha8(i, j));
  }
  return 0;
}

}  // namespace byogan

namespace byogan {

int decode_avif(const uint8_t* color, size_t csize, const uint8_t* alpha, size_t asize, int32_t* params, int w,
                int h, uint8_t* out, int32_t* counts) {
  static const int kFaultCode[] = {kAvifBroken,   kAvifBroken, kAvifFilmGrain, kAvifQmatrix,
                                   kAvifSuperres, kAvifLayers, kAvifNotIntra};
  av1::Planes p, a;
  bool haveAlpha = alpha && asize;
  try {
    av1::decode(color, csize, &p, reinterpret_cast<av1::Counts*>(counts));
    params[5] = p.width;
    params[6] = p.height;
    if (p.width != w || p.height != h) return kAvifSize;
    if (haveAlpha) {
      av1::decode(alpha, asize, &a, nullptr);
      if (a.width != w || a.height != h) return kAvifAlpha;
      if (a.bitDepth != p.bitDepth) return kAvifAlphaDepth;
    }
  } catch (const av1::Error& e) {
    return kFaultCode[e.fault];
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  int cp = params[0] ? params[1] : p.colorPrimaries;
  int mc = params[0] ? params[3] : p.matrixCoefficients;
  int range = params[0] ? params[7] : p.colorRange;
  return avif_to_rgb(p, haveAlpha ? &a : nullptr, cp, mc, range, params[4], out);
}

}  // namespace byogan

namespace byogan {

int decode_av1_planes(const uint8_t* data, size_t size, int32_t* info, uint8_t* y, uint8_t* u, uint8_t* v,
                      size_t cap) {
  static const int kFaultCode[] = {kAvifBroken,   kAvifBroken, kAvifFilmGrain, kAvifQmatrix,
                                   kAvifSuperres, kAvifLayers, kAvifNotIntra};
  av1::Planes p;
  try {
    av1::decode(data, size, &p, nullptr);
  } catch (const av1::Error& e) {
    return kFaultCode[e.fault];
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  info[0] = p.width;
  info[1] = p.height;
  info[2] = p.subX;
  info[3] = p.subY;
  info[4] = p.mono;
  info[5] = p.bitDepth;
  uint8_t* out[3] = {y, u, v};
  for (int i = 0; i < (p.mono ? 1 : 3); i++) {
    const void* src = p.bitDepth > 8 ? (const void*)p.plane16[i].data() : (const void*)p.plane[i].data();
    size_t n = p.bitDepth > 8 ? p.plane16[i].size() * 2 : p.plane[i].size();
    if (n > cap) return kSize;
    std::memcpy(out[i], src, n);
  }
  return 0;
}

}  // namespace byogan
