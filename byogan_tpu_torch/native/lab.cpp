// CIE Lab -> sRGB as Pillow 12.1.0 converts a LAB image to RGB: Image.convert
// builds ImageCms.buildTransform(createProfile("LAB"), createProfile("sRGB"),
// "LAB", "RGB"), LittleCMS 2.17's cmsCreateTransform of cmsCreateLab2Profile
// and cmsCreate_sRGBProfile, perceptual intent, no flags.  This file rebuilds
// that transform from its parts, stage by stage, with lcms2's names in the
// comments; it matches Pillow on all 2^24 Lab triples.
//
// What cmsCreateTransform makes of the two profiles:
//
//   _cmsLinkProfiles -> DefaultICCintents.  The Lab profile is an abstract
//   profile whose A2B0 is a V2 (Lut16Type) identity CLUT, so
//   _cmsReadDevicelinkLUT gives [LabV4toV2, identity CLUT, LabV2toV4].  The
//   sRGB profile is V4, so _cmsLinkProfiles forces black-point compensation on
//   it under the perceptual intent; but cmsDetectBlackPoint of an abstract
//   profile is 0 and cmsDetectDestinationBlackPoint of sRGB (a matrix shaper:
//   BlackPointAsDarkerColorant) is 0 too, so ComputeConversion leaves the
//   identity and AddConversion (Lab -> XYZ) adds one Lab2XYZ stage.
//   _cmsReadOutputLUT of sRGB is BuildRGBOutputMatrixShaper: the inverse of the
//   colorant matrix times OutpAdj, then the three TRCs reversed
//   (cmsReverseToneCurve: the parametric type -4).
//
//   _cmsOptimizePipeline -> PreOptimize drops the identity CLUT (_Remove1Op)
//   and the LabV4toV2/LabV2toV4 pair (_Remove2Op), leaving
//   [Lab2XYZ, matrix, curves].  No other optimisation takes a Lab input, so
//   OptimizeByResampling samples it into a 33-point 16-bit CLUT
//   (_cmsReasonableGridpointsByColorspace; XFormSampler16 evaluates each node
//   in float, cmsPipelineEvalFloat, and saturates it to 16 bits).
//   FixWhiteMisalignment finds that Lab white (0xffff, 0x8080, 0x8080) lies on
//   no node, so it patches nothing.  The CLUT's Eval16 is TetrahedralInterp16.
//
//   The transform: Pillow's "LAB" format, COLORSPACE_SH(PT_LabV2) |
//   CHANNELS_SH(3) | BYTES_SH(1) | EXTRA_SH(1), has no formatter of its own,
//   so UnrollChunkyBytes widens each byte by FROM_8_TO_16 (x * 257), as for
//   V4 Lab; TYPE_RGBA_8's packer narrows each output by FROM_16_TO_8.

#include <cmath>
#include <cstring>

#include "codec.h"

namespace byogan {
namespace {

constexpr int kGrid = 33;  // _cmsReasonableGridpointsByColorspace: 33 for three channels

struct Mat3 {
  double v[3][3];
};

// _cmsMAT3per: a * b.
Mat3 mat_per(const Mat3& a, const Mat3& b) {
  Mat3 r;
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) r.v[i][j] = a.v[i][0] * b.v[0][j] + a.v[i][1] * b.v[1][j] + a.v[i][2] * b.v[2][j];
  return r;
}

// _cmsMAT3eval: a * v.
void mat_eval(const Mat3& a, const double v[3], double r[3]) {
  for (int i = 0; i < 3; i++) r[i] = a.v[i][0] * v[0] + a.v[i][1] * v[1] + a.v[i][2] * v[2];
}

// _cmsMAT3inverse, in its order of operations.
Mat3 mat_inverse(const Mat3& m) {
  const auto& a = m.v;
  const double c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  const double c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0];
  const double c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  const double det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2;
  Mat3 b;
  b.v[0][0] = c0 / det;
  b.v[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det;
  b.v[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det;
  b.v[1][0] = c1 / det;
  b.v[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det;
  b.v[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det;
  b.v[2][0] = c2 / det;
  b.v[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det;
  b.v[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det;
  return b;
}

// cmsD50_XYZ.
constexpr double kD50[3] = {0.9642, 1.0, 0.8249};

// _cmsAdaptationMatrix with the Bradford cone matrix (ComputeChromaticAdaptation).
Mat3 bradford(const double from[3], const double to[3]) {
  const Mat3 cone_matrix = {{{0.8951, 0.2664, -0.1614}, {-0.7502, 1.7135, 0.0367}, {0.0389, -0.0685, 1.0296}}};
  const Mat3 inverse = mat_inverse(cone_matrix);
  double src[3], dst[3];
  mat_eval(cone_matrix, from, src);
  mat_eval(cone_matrix, to, dst);
  const Mat3 cone = {{{dst[0] / src[0], 0.0, 0.0}, {0.0, dst[1] / src[1], 0.0}, {0.0, 0.0, dst[2] / src[2]}}};
  return mat_per(inverse, mat_per(cone, cone_matrix));
}

// cmsCreate_sRGBProfile's colorants: _cmsBuildRGB2XYZtransferMatrix of the
// Rec. 709 primaries under D65 (x 0.3127, y 0.3290), adapted to D50
// (_cmsAdaptMatrixToD50).  ReadICCMatrixRGB2XYZ reads them back as this matrix.
Mat3 srgb_to_xyz() {
  const double xn = 0.3127, yn = 0.3290;
  const double xr = 0.64, yr = 0.33, xg = 0.30, yg = 0.60, xb = 0.15, yb = 0.06;
  const Mat3 primaries = {{{xr, xg, xb}, {yr, yg, yb}, {1 - xr - yr, 1 - xg - yg, 1 - xb - yb}}};
  const double white[3] = {xn / yn, 1.0, (1.0 - xn - yn) / yn};
  double coef[3];
  mat_eval(mat_inverse(primaries), white, coef);
  const Mat3 r = {{{coef[0] * xr, coef[1] * xg, coef[2] * xb},
                   {coef[0] * yr, coef[1] * yg, coef[2] * yb},
                   {coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)}}};
  const double d65[3] = {(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0};  // cmsxyY2XYZ
  return mat_per(bradford(d65, kD50), r);
}

// MAX_ENCODEABLE_XYZ: XYZ's 1.15 fixed point, 0xffff.
constexpr double kMaxEncodeableXyz = 1.0 + 32767.0 / 32768.0;

// cmsLab2XYZ's f_1.
double f_1(double t) {
  const double limit = 24.0 / 116.0;
  if (t <= limit) return (108.0 / 841.0) * (t - (16.0 / 116.0));
  return t * t * t;
}

// DefaultEvalParametricFn, type -4: Build_sRGBGamma's curve (IEC 61966-2.1,
// g 2.4, a 1/1.055, b 0.055/1.055, c 1/12.92, d 0.04045) reversed.
double srgb_reverse(double r) {
  const double g = 2.4, a = 1. / 1.055, b = 0.055 / 1.055, c = 1. / 12.92, d = 0.04045;
  const double e = a * d + b;
  const double disc = e < 0 ? 0 : pow(e, g);
  if (r >= disc) return (pow(r, 1.0 / g) - b) / a;
  return r / c;
}

// _cmsQuickFloor: floor after rounding to 1/65536 (2^36 * 1.5 added).
int quick_floor(double val) {
  const double t = val + 68719476736.0 * 1.5;
  uint64_t bits;
  memcpy(&bits, &t, sizeof bits);
  return int32_t(uint32_t(bits)) >> 16;
}

// _cmsQuickSaturateWord.
uint16_t quick_saturate_word(double d) {
  d += 0.5;
  if (d <= 0) return 0;
  if (d >= 65535.0) return 0xffff;
  return uint16_t(quick_floor(d - 32767.0) + 32767);  // _cmsQuickFloorWord
}

struct Clut {
  uint16_t table[kGrid * kGrid * kGrid * 3];

  // OptimizeByResampling's cmsStageSampleCLut16bit with XFormSampler16: each
  // node's input (_cmsQuantizeVal) over 65535 in float, the stages in
  // cmsFloat32Number between them (_LUTevalFloat), the output saturated.
  Clut() {
    const Mat3 inv = mat_inverse(srgb_to_xyz());
    double m[9];  // BuildRGBOutputMatrixShaper: Inv * OutpAdj (OutpAdj = MAX_ENCODEABLE_XYZ)
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) m[i * 3 + j] = inv.v[i][j] * kMaxEncodeableXyz;
    uint16_t node[kGrid];
    for (int i = 0; i < kGrid; i++) node[i] = quick_saturate_word(double(i) * 65535. / double(kGrid - 1));
    uint16_t* out = table;
    for (int i0 = 0; i0 < kGrid; i0++)
      for (int i1 = 0; i1 < kGrid; i1++)
        for (int i2 = 0; i2 < kGrid; i2++) {
          const float in[3] = {float(node[i0] / 65535.0), float(node[i1] / 65535.0), float(node[i2] / 65535.0)};
          // EvaluateLab2XYZ: V4 rules, then cmsLab2XYZ under D50, over MAX_ENCODEABLE_XYZ
          const double L = in[0] * 100.0, a = in[1] * 255.0 - 128.0, b = in[2] * 255.0 - 128.0;
          const double y = (L + 16.0) / 116.0, x = y + 0.002 * a, z = y - 0.005 * b;
          const float xyz[3] = {float(f_1(x) * kD50[0] / kMaxEncodeableXyz),
                                float(f_1(y) * kD50[1] / kMaxEncodeableXyz),
                                float(f_1(z) * kD50[2] / kMaxEncodeableXyz)};
          for (int k = 0; k < 3; k++) {
            double tmp = 0;  // EvaluateMatrix
            for (int j = 0; j < 3; j++) tmp += xyz[j] * m[k * 3 + j];
            const float linear = float(tmp);
            const float v = float(srgb_reverse(linear));  // EvaluateCurves: cmsEvalToneCurveFloat -> EvalSegmentedFn
            *out++ = quick_saturate_word(v * 65535.0);
          }
        }
  }
};

const Clut& clut() {
  static const Clut built;  // once per process, thread-safe
  return built;
}

// _cmsToFixedDomain.
inline int to_fixed_domain(int a) { return a + ((a + 0x7fff) / 0xffff); }

// TetrahedralInterp16 on the 33-point CLUT, in lcms2's fixed point.
void tetrahedral(const uint16_t* lut, const uint16_t in[3], uint16_t out[3]) {
  constexpr int opta0 = 3, opta1 = 3 * kGrid, opta2 = 3 * kGrid * kGrid;
  const int fx = to_fixed_domain(in[0] * (kGrid - 1)), fy = to_fixed_domain(in[1] * (kGrid - 1)),
            fz = to_fixed_domain(in[2] * (kGrid - 1));
  const int rx = fx & 0xffff, ry = fy & 0xffff, rz = fz & 0xffff;
  int X1 = in[0] == 0xffff ? 0 : opta2, Y1 = in[1] == 0xffff ? 0 : opta1, Z1 = in[2] == 0xffff ? 0 : opta0;
  lut += opta2 * (fx >> 16) + opta1 * (fy >> 16) + opta0 * (fz >> 16);
  // Which of the six tetrahedra, and the order of its corner differences.
  int order;
  if (rx >= ry) {
    if (ry >= rz) {
      Y1 += X1;
      Z1 += Y1;
      order = 0;
    } else if (rz >= rx) {
      X1 += Z1;
      Y1 += X1;
      order = 1;
    } else {
      Z1 += X1;
      Y1 += Z1;
      order = 2;
    }
  } else {
    if (rx >= rz) {
      X1 += Y1;
      Z1 += X1;
      order = 3;
    } else if (ry >= rz) {
      Z1 += Y1;
      X1 += Z1;
      order = 4;
    } else {
      Y1 += Z1;
      X1 += Y1;
      order = 5;
    }
  }
  for (int k = 0; k < 3; k++, lut++) {
    int c1 = lut[X1], c2 = lut[Y1], c3 = lut[Z1];
    const int c0 = lut[0];
    switch (order) {
      case 0: c3 -= c2; c2 -= c1; c1 -= c0; break;
      case 1: c2 -= c1; c1 -= c3; c3 -= c0; break;
      case 2: c2 -= c3; c3 -= c1; c1 -= c0; break;
      case 3: c3 -= c1; c1 -= c2; c2 -= c0; break;
      case 4: c1 -= c3; c3 -= c2; c2 -= c0; break;
      default: c1 -= c2; c2 -= c3; c3 -= c0; break;
    }
    // lcms2's sum in int32, wrapping as its build does: in uint32, then back
    const int32_t rest = int32_t(uint32_t(c1) * uint32_t(rx) + uint32_t(c2) * uint32_t(ry) +
                                 uint32_t(c3) * uint32_t(rz) + 0x8001u);
    out[k] = uint16_t(c0 + ((rest + (rest >> 16)) >> 16));
  }
}

}  // namespace

void lab_to_rgb(const uint8_t* lab, size_t n, uint8_t* rgb) {
  const uint16_t* lut = clut().table;
  for (size_t i = 0; i < n; i++, lab += 3, rgb += 3) {
    const uint16_t in[3] = {uint16_t(lab[0] * 257), uint16_t(lab[1] * 257), uint16_t(lab[2] * 257)};  // FROM_8_TO_16
    uint16_t out[3];
    tetrahedral(lut, in, out);
    for (int k = 0; k < 3; k++) rgb[k] = uint8_t((uint32_t(out[k]) * 65281u + 8388608u) >> 24);  // FROM_16_TO_8
  }
}

}  // namespace byogan
