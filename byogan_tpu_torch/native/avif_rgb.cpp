// AVIF planes to Pillow's RGB, as libavif 1.3.0's avifImageYUVToRGB makes
// the RGB (or RGBA) image Pillow 12.1.0 asks for and Image.convert("RGB")
// keeps its colour bands:
//
//   * 8-bit 4:2:0, 4:2:2 and 4:4:4 of a BT.601, BT.709 or BT.2020 matrix
//     (or an unspecified one, or chroma-derived from those primaries) go
//     through libyuv 1909: the chroma upsampled by its bilinear filter
//     (ScaleRowUp2_Bilinear / ScaleRowUp2_Linear with their edge rules, the
//     filter libavif picks in its AUTOMATIC mode), then YuvPixel's fixed
//     point with the kYuv*Constants of the range;
//   * 4:0:0, the identity matrix and YCgCo in 4:4:4 go through libavif's
//     own float path (avifImageYUV8ToRGB8Mono, avifImageYUVAnyToRGBAnySlow);
//   * alpha: the alpha item's plane, limited range widened as libavif
//     widens it; a premultiplied image ('prem') is unpremultiplied as
//     libyuv 1909's ARGBUnattenuate does (opaque pixels left) before Pillow
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

// libyuv's YuvPixel (row_common.cc), written to R, G, B.
inline void yuv_pixel(int y, int u, int v, const YuvConstants& k, uint8_t* rgb) {
  uint32_t y32 = (uint32_t)y * 0x0101;
  int32_t y1 = (int32_t)((uint32_t)(y32 * (uint32_t)k.yg) >> 16) + k.yb;
  int ui = u - 128, vi = v - 128;
  int b16 = y1 + ui * k.ub;
  int g16 = y1 - (ui * k.ug + vi * k.vg);
  int r16 = y1 + vi * k.vr;
  rgb[0] = clamp255(r16 >> 6);
  rgb[1] = clamp255(g16 >> 6);
  rgb[2] = clamp255(b16 >> 6);
}

// ScaleRowUp2_Bilinear_Any_C of chroma rows s and t into d (width w).
void up2_bilinear(const uint8_t* s, const uint8_t* t, uint8_t* d, int w) {
  int work = (w - 1) & ~1;
  d[0] = (uint8_t)((3 * s[0] + t[0] + 2) >> 2);
  for (int x = 0; x < work / 2; x++) {
    d[2 * x + 1] = (uint8_t)((s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4);
    d[2 * x + 2] = (uint8_t)((s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4);
  }
  int l = (w - 1) / 2;
  d[w - 1] = (uint8_t)((3 * s[l] + t[l] + 2) >> 2);
}

// ScaleRowUp2_Linear_Any_C.
void up2_linear(const uint8_t* s, uint8_t* d, int w) {
  int work = (w - 1) & ~1;
  d[0] = s[0];
  for (int x = 0; x < work / 2; x++) {
    d[2 * x + 1] = (uint8_t)((s[x] * 3 + s[x + 1] + 2) >> 2);
    d[2 * x + 2] = (uint8_t)((s[x] + s[x + 1] * 3 + 2) >> 2);
  }
  d[w - 1] = s[(w - 1) / 2];
}

// libavif's avifLimitedToFullY / avifLimitedToFullUV at 8 bits.
int limited_to_full_y(int v) { return std::max(0, std::min(255, ((v - 16) * 255 + (235 - 16) / 2) / (235 - 16))); }
int limited_to_full_uv(int v) { return std::max(0, std::min(255, ((v - 16) * 255 + (240 - 16) / 2) / (240 - 16))); }

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

}  // namespace

// The RGB of decoded AVIF planes (see the file's comment) into out
// (h x w x 3).  `alpha` is the alpha item's planes or null; `mc`/`cp` the
// effective CICP and `range` the effective full-range flag (an nclx box's,
// else the sequence header's); `premultiplied` the 'prem' reference.  0 or a
// kAvif code.
int avif_to_rgb(const av1::Planes& p, const av1::Planes* alpha, int cp, int mc, int range, int premultiplied,
                uint8_t* out) {
  int w = p.width, h = p.height;
  int full = range;
  std::vector<uint8_t> rgb((size_t)w * h * 3);
  // libavif 1.3.0 refuses these matrices (Reformat failed), and converts
  // YCgCo-Re and chroma-derived ones of other primaries by formulas the
  // port does not follow.
  if (mc == 3 || mc == 10 || mc == 11 || mc == 13 || mc == 14 || mc >= 16) return kAvifColour;
  if (mc == 15 || (mc == 12 && cp != 1 && cp != 2 && cp != 5 && cp != 6 && cp != 9)) return kAvifConversion;
  int mode = mc == 0 ? 1 : (mc == 8 ? 2 : 0);  // 0 YUV coefficients, 1 identity, 2 YCgCo
  if (mode != 0 && !p.mono && (p.subX || p.subY)) {
    // libavif: identity needs 4:4:4; YCgCo subsampled takes the float bilinear path.
    return mode == 1 ? kAvifColour : kAvifConversion;
  }
  const YuvConstants* k = (mode == 0 && !p.mono) ? libyuv_matrix(full, mc, cp) : nullptr;
  if (k) {
    const uint8_t* Y = p.plane[0].data();
    const uint8_t* U = p.plane[1].data();
    const uint8_t* V = p.plane[2].data();
    int cs = p.stride[1];
    std::vector<uint8_t> urow(w), vrow(w);
    auto emit = [&](int j, const uint8_t* ur, const uint8_t* vr) {
      for (int i = 0; i < w; i++) yuv_pixel(Y[(size_t)j * p.stride[0] + i], ur[i], vr[i], *k, &rgb[((size_t)j * w + i) * 3]);
    };
    if (!p.subX && !p.subY) {
      for (int j = 0; j < h; j++) emit(j, U + (size_t)j * cs, V + (size_t)j * cs);
    } else if (p.subX && !p.subY) {
      for (int j = 0; j < h; j++) {
        up2_linear(U + (size_t)j * cs, urow.data(), w);
        up2_linear(V + (size_t)j * cs, vrow.data(), w);
        emit(j, urow.data(), vrow.data());
      }
    } else {
      // I420ToRGB24MatrixBilinear: the first row from chroma row 0, then
      // pairs of rows from chroma rows k and k + 1, the last row of an even
      // height from the last chroma row.
      std::vector<uint8_t> u2(w), v2(w);
      up2_bilinear(U, U, urow.data(), w);
      up2_bilinear(V, V, vrow.data(), w);
      emit(0, urow.data(), vrow.data());
      int kk = 0, j = 1;
      for (int y = 0; y < h - 2; y += 2, kk++) {
        const uint8_t* us = U + (size_t)kk * cs;
        const uint8_t* vs = V + (size_t)kk * cs;
        up2_bilinear(us, us + cs, urow.data(), w);
        up2_bilinear(us + cs, us, u2.data(), w);
        up2_bilinear(vs, vs + cs, vrow.data(), w);
        up2_bilinear(vs + cs, vs, v2.data(), w);
        emit(j++, urow.data(), vrow.data());
        emit(j++, u2.data(), v2.data());
      }
      if (!(h & 1)) {
        const uint8_t* us = U + (size_t)kk * cs;
        const uint8_t* vs = V + (size_t)kk * cs;
        up2_bilinear(us, us, urow.data(), w);
        up2_bilinear(vs, vs, vrow.data(), w);
        emit(j, urow.data(), vrow.data());
      }
    }
  } else if (p.mono) {
    // avifImageYUV8ToRGB8Mono.
    for (int j = 0; j < h; j++) {
      for (int i = 0; i < w; i++) {
        int y = p.plane[0][(size_t)j * p.stride[0] + i];
        if (!full) y = limited_to_full_y(y);
        float Y = (float)y / 255.0f;
        float Yc = std::min(1.0f, std::max(0.0f, Y));
        uint8_t v = (uint8_t)(0.5f + (Yc * 255.0f));
        uint8_t* o = &rgb[((size_t)j * w + i) * 3];
        o[0] = o[1] = o[2] = v;
      }
    }
  } else if (!p.subX && !p.subY) {
    // avifImageYUV8ToRGB8Color (other matrices) and avifImageYUVAnyToRGBAnySlow
    // (identity, YCgCo), 4:4:4.
    float kr, kb;
    coefficients(mc, &kr, &kb);
    float kg = 1.0f - kr - kb;
    float tableY[256], tableUV[256];
    for (int c = 0; c < 256; c++) {
      int y = full ? c : limited_to_full_y(c);
      tableY[c] = (float)y / 255.0f;
      int uv = full ? c : limited_to_full_uv(c);
      tableUV[c] = mode == 1 ? tableY[c] : ((float)uv - 128.0f) / 255.0f;
    }
    for (int j = 0; j < h; j++) {
      for (int i = 0; i < w; i++) {
        float Y = tableY[p.plane[0][(size_t)j * p.stride[0] + i]];
        float Cb = tableUV[p.plane[1][(size_t)j * p.stride[1] + i]];
        float Cr = tableUV[p.plane[2][(size_t)j * p.stride[2] + i]];
        float R, G, B;
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
        uint8_t* o = &rgb[((size_t)j * w + i) * 3];
        o[0] = (uint8_t)(0.5f + std::min(1.0f, std::max(0.0f, R)) * 255.0f);
        o[1] = (uint8_t)(0.5f + std::min(1.0f, std::max(0.0f, G)) * 255.0f);
        o[2] = (uint8_t)(0.5f + std::min(1.0f, std::max(0.0f, B)) * 255.0f);
      }
    }
  } else {
    return kAvifConversion;
  }
  if (alpha && premultiplied) {
    // ARGBUnattenuate: each sample widened to 16 bits (c | c << 8) times
    // the 16-bit reciprocal of alpha, >> 16; opaque pixels kept.
    for (int j = 0; j < h; j++) {
      for (int i = 0; i < w; i++) {
        int a = alpha->plane[0][(size_t)j * alpha->stride[0] + i];
        if (!alpha->colorRange) a = limited_to_full_y(a);
        if (a == 255) continue;
        uint32_t ia = a == 0 ? 0 : a == 1 ? 0xffff : 0x10000u / (uint32_t)a;
        uint8_t* o = &rgb[((size_t)j * w + i) * 3];
        // The product wraps as a signed 32-bit integer (alpha 1 and 2 turn
        // bright samples negative, which clamp to 0), as libyuv's does.
        for (int c = 0; c < 3; c++)
          o[c] = clamp255((int32_t)((((uint32_t)o[c] | ((uint32_t)o[c] << 8)) * ia)) >> 16);
      }
    }
  }
  std::memcpy(out, rgb.data(), rgb.size());
  return 0;
}

}  // namespace byogan

namespace byogan {

int decode_avif(const uint8_t* color, size_t csize, const uint8_t* alpha, size_t asize, int32_t* params, int w,
                int h, uint8_t* out, int32_t* counts) {
  static const int kFaultCode[] = {kAvifBroken, kAvifBroken,  kAvifDepth,    kAvifFilmGrain, kAvifIntrabc,
                                   kAvifQmatrix, kAvifSuperres, kAvifLayers, kAvifNotIntra};
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
  static const int kFaultCode[] = {kAvifBroken, kAvifBroken,  kAvifDepth,    kAvifFilmGrain, kAvifIntrabc,
                                   kAvifQmatrix, kAvifSuperres, kAvifLayers, kAvifNotIntra};
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
  uint8_t* out[3] = {y, u, v};
  for (int i = 0; i < (p.mono ? 1 : 3); i++) {
    if (p.plane[i].size() > cap) return kSize;
    std::memcpy(out[i], p.plane[i].data(), p.plane[i].size());
  }
  return 0;
}

}  // namespace byogan
