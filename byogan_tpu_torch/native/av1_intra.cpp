// Intra prediction (AV1 specification 7.11.2): the edges with their
// availability at tile and frame borders (the base values of BitDepth), the directional modes with the
// intra edge filter and upsampling, DC, the three smooth modes, Paeth,
// recursive filter intra; chroma from luma (7.11.5) and palette (7.11.4).

#include <algorithm>

#include "av1_decoder.h"

namespace byogan {
namespace av1 {

namespace {

int is_smooth_mode(int m) { return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED; }

int edge_filter_strength(int w, int h, int filterType, int delta) {
  int d = std::abs(delta), blkWh = w + h, strength = 0;
  if (filterType == 0) {
    if (blkWh <= 8) {
      if (d >= 56) strength = 1;
    } else if (blkWh <= 12) {
      if (d >= 40) strength = 1;
    } else if (blkWh <= 16) {
      if (d >= 40) strength = 1;
    } else if (blkWh <= 24) {
      if (d >= 8) strength = 1;
      if (d >= 16) strength = 2;
      if (d >= 32) strength = 3;
    } else if (blkWh <= 32) {
      if (d >= 1) strength = 1;
      if (d >= 4) strength = 2;
      if (d >= 32) strength = 3;
    } else {
      if (d >= 1) strength = 3;
    }
  } else {
    if (blkWh <= 8) {
      if (d >= 40) strength = 1;
      if (d >= 64) strength = 2;
    } else if (blkWh <= 16) {
      if (d >= 20) strength = 1;
      if (d >= 48) strength = 2;
    } else if (blkWh <= 24) {
      if (d >= 4) strength = 3;
    } else {
      if (d >= 1) strength = 3;
    }
  }
  return strength;
}

int use_upsample(int w, int h, int filterType, int delta) {
  int d = std::abs(delta), blkWh = w + h;
  if (d <= 0 || d >= 40) return 0;
  return filterType ? blkWh <= 8 : blkWh <= 16;
}

// buf points at element 0 of an edge whose element -1 exists.
void edge_filter(int* buf, int sz, int strength) {
  if (!strength) return;
  int edge[300];
  for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
  for (int i = 1; i < sz; i++) {
    int s = 0;
    for (int j = 0; j < 5; j++) {
      int k = clip3(0, sz - 1, i - 2 + j);
      s += kIntraEdgeKernel[strength - 1][j] * edge[k];
    }
    buf[i - 1] = (s + 8) >> 4;
  }
}

void edge_upsample(int* buf, int numPx, int maxV) {
  int dup[300];
  dup[0] = buf[-1];
  for (int i = -1; i < numPx; i++) dup[i + 2] = buf[i];
  dup[numPx + 2] = buf[numPx - 1];
  buf[-2] = dup[0];
  for (int i = 0; i < numPx; i++) {
    int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
    s = clip3(0, maxV, round2(s, 4));
    buf[2 * i - 1] = s;
    buf[2 * i] = dup[i + 2];
  }
}

}  // namespace

template <typename Pixel>
void Decoder<Pixel>::predict_intra(int plane, int x, int y, int haveLeft, int haveAbove, int haveAboveRt, int haveBelowLft,
                            int mode, int log2W, int log2H) {
  int w = 1 << log2W, h = 1 << log2H;
  int sx = plane ? subX : 0, sy = plane ? subY : 0;
  int maxX = ((fh.miCols * 4) >> sx) - 1, maxY = ((fh.miRows * 4) >> sy) - 1;
  int maxV = pixel_max(), base = (maxV + 1) >> 1;
  int aboveBuf[320], leftBuf[320];
  int* aboveRow = aboveBuf + 16;
  int* leftCol = leftBuf + 16;
  int n = w + h;
  if (!haveAbove && haveLeft) {
    int v = px(plane, y, x - 1);
    for (int i = 0; i < n; i++) aboveRow[i] = v;
  } else if (!haveAbove && !haveLeft) {
    for (int i = 0; i < n; i++) aboveRow[i] = base - 1;
  } else {
    int aboveLimit = std::min(maxX, x + (haveAboveRt ? 2 * w : w) - 1);
    const Pixel* src = &px(plane, y - 1, 0);
    for (int i = 0; i < n; i++) aboveRow[i] = src[std::min(aboveLimit, x + i)];
  }
  if (!haveLeft && haveAbove) {
    int v = px(plane, y - 1, x);
    for (int i = 0; i < n; i++) leftCol[i] = v;
  } else if (!haveLeft && !haveAbove) {
    for (int i = 0; i < n; i++) leftCol[i] = base + 1;
  } else {
    int leftLimit = std::min(maxY, y + (haveBelowLft ? 2 * h : h) - 1);
    for (int i = 0; i < n; i++) leftCol[i] = px(plane, std::min(leftLimit, y + i), x - 1);
  }
  if (haveAbove && haveLeft)
    aboveRow[-1] = px(plane, y - 1, x - 1);
  else if (haveAbove)
    aboveRow[-1] = px(plane, y - 1, x);
  else if (haveLeft)
    aboveRow[-1] = px(plane, y, x - 1);
  else
    aboveRow[-1] = base;
  leftCol[-1] = aboveRow[-1];

  static thread_local int pred[64][64];
  if (plane == 0 && useFilterIntra) {
    int w4 = w >> 2, h2 = h >> 1;
    for (int i2 = 0; i2 < h2; i2++) {
      for (int j4 = 0; j4 < w4; j4++) {
        int p[7];
        for (int i = 0; i < 7; i++) {
          if (i < 5) {
            if (i2 == 0)
              p[i] = aboveRow[(j4 << 2) + i - 1];
            else if (j4 == 0 && i == 0)
              p[i] = leftCol[(i2 << 1) - 1];
            else
              p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
          } else {
            if (j4 == 0)
              p[i] = leftCol[(i2 << 1) + i - 5];
            else
              p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
          }
        }
        for (int i = 0; i < 8; i++) {
          int pr = 0;
          for (int j = 0; j < 7; j++) pr += kFilterIntraTaps[filterIntraMode][i][j] * p[j];
          pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = clip3(0, maxV, round2signed(pr, 4));
        }
      }
    }
  } else if (mode >= V_PRED && mode <= D67_PRED) {
    int angleDelta = plane == 0 ? angleDeltaY : angleDeltaUV;
    int pAngle = kModeToAngle[mode] + angleDelta * 3;
    int upsampleAbove = 0, upsampleLeft = 0;
    if (seq.enableIntraEdgeFilter) {
      if (pAngle != 90 && pAngle != 180) {
        if (pAngle > 90 && pAngle < 180 && (w + h) >= 24) {
          int v = round2(leftCol[0] * 5 + aboveRow[-1] * 6 + aboveRow[0] * 5, 4);
          leftCol[-1] = aboveRow[-1] = v;
        }
        // get_filter_type()
        int aboveSmooth = 0, leftSmooth = 0;
        if (plane == 0 ? availU : availUChroma) {
          int r = miRow - 1, c = miCol;
          if (plane > 0) {
            if (subX && !(miCol & 1)) c++;
            if (subY && (miRow & 1)) r--;
          }
          aboveSmooth = is_smooth_mode(plane == 0 ? yModes[mi(r, c)] : uvModes[mi(r, c)]);
        }
        if (plane == 0 ? availL : availLChroma) {
          int r = miRow, c = miCol - 1;
          if (plane > 0) {
            if (subX && (miCol & 1)) c--;
            if (subY && !(miRow & 1)) r++;
          }
          leftSmooth = is_smooth_mode(plane == 0 ? yModes[mi(r, c)] : uvModes[mi(r, c)]);
        }
        int filterType = aboveSmooth || leftSmooth;
        if (haveAbove) {
          int strength = edge_filter_strength(w, h, filterType, pAngle - 90);
          int numPx = std::min(w, maxX - x + 1) + (pAngle < 90 ? h : 0) + 1;
          edge_filter(aboveRow, numPx, strength);
        }
        if (haveLeft) {
          int strength = edge_filter_strength(w, h, filterType, pAngle - 180);
          int numPx = std::min(h, maxY - y + 1) + (pAngle > 180 ? w : 0) + 1;
          edge_filter(leftCol, numPx, strength);
        }
        upsampleAbove = use_upsample(w, h, filterType, pAngle - 90);
        int numPx = w + (pAngle < 90 ? h : 0);
        if (upsampleAbove) edge_upsample(aboveRow, numPx, maxV);
        upsampleLeft = use_upsample(w, h, filterType, pAngle - 180);
        numPx = h + (pAngle > 180 ? w : 0);
        if (upsampleLeft) edge_upsample(leftCol, numPx, maxV);
      }
    }
    int dx = 0, dy = 0;
    if (pAngle < 90)
      dx = kDrIntraDerivative[pAngle];
    else if (pAngle > 90 && pAngle < 180)
      dx = kDrIntraDerivative[180 - pAngle];
    if (pAngle > 90 && pAngle < 180)
      dy = kDrIntraDerivative[pAngle - 90];
    else if (pAngle > 180)
      dy = kDrIntraDerivative[270 - pAngle];
    for (int i = 0; i < h; i++) {
      for (int j = 0; j < w; j++) {
        int v;
        if (pAngle < 90) {
          int idx = (i + 1) * dx;
          int base = (idx >> (6 - upsampleAbove)) + (j << upsampleAbove);
          int shift = ((idx << upsampleAbove) >> 1) & 0x1F;
          int maxBaseX = (w + h - 1) << upsampleAbove;
          if (base < maxBaseX)
            v = round2(aboveRow[base] * (32 - shift) + aboveRow[base + 1] * shift, 5);
          else
            v = aboveRow[maxBaseX];
        } else if (pAngle > 90 && pAngle < 180) {
          int idx = (j << 6) - (i + 1) * dx;
          int base = idx >> (6 - upsampleAbove);
          if (base >= -(1 << upsampleAbove)) {
            int shift = ((idx * (1 << upsampleAbove)) >> 1) & 0x1F;
            v = round2(aboveRow[base] * (32 - shift) + aboveRow[base + 1] * shift, 5);
          } else {
            idx = (i << 6) - (j + 1) * dy;
            base = idx >> (6 - upsampleLeft);
            int shift = ((idx * (1 << upsampleLeft)) >> 1) & 0x1F;
            v = round2(leftCol[base] * (32 - shift) + leftCol[base + 1] * shift, 5);
          }
        } else if (pAngle > 180) {
          int idx = (j + 1) * dy;
          int base = (idx >> (6 - upsampleLeft)) + (i << upsampleLeft);
          int shift = ((idx << upsampleLeft) >> 1) & 0x1F;
          v = round2(leftCol[base] * (32 - shift) + leftCol[base + 1] * shift, 5);
        } else if (pAngle == 90) {
          v = aboveRow[j];
        } else {
          v = leftCol[i];
        }
        pred[i][j] = v;
      }
    }
  } else if (mode == SMOOTH_PRED) {
    const uint8_t* wX = kSmWeights + w;
    const uint8_t* wY = kSmWeights + h;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++)
        pred[i][j] = round2(wY[i] * aboveRow[j] + (256 - wY[i]) * leftCol[h - 1] + wX[j] * leftCol[i] +
                                (256 - wX[j]) * aboveRow[w - 1],
                            9);
  } else if (mode == SMOOTH_V_PRED) {
    const uint8_t* wY = kSmWeights + h;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) pred[i][j] = round2(wY[i] * aboveRow[j] + (256 - wY[i]) * leftCol[h - 1], 8);
  } else if (mode == SMOOTH_H_PRED) {
    const uint8_t* wX = kSmWeights + w;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) pred[i][j] = round2(wX[j] * leftCol[i] + (256 - wX[j]) * aboveRow[w - 1], 8);
  } else if (mode == DC_PRED) {
    int avg;
    if (haveLeft && haveAbove) {
      int sum = 0;
      for (int k = 0; k < h; k++) sum += leftCol[k];
      for (int k = 0; k < w; k++) sum += aboveRow[k];
      sum += (w + h) >> 1;
      avg = sum / (w + h);
    } else if (haveLeft) {
      int sum = 0;
      for (int k = 0; k < h; k++) sum += leftCol[k];
      avg = clip3(0, maxV, (sum + (h >> 1)) >> log2H);
    } else if (haveAbove) {
      int sum = 0;
      for (int k = 0; k < w; k++) sum += aboveRow[k];
      avg = clip3(0, maxV, (sum + (w >> 1)) >> log2W);
    } else {
      avg = base;
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) pred[i][j] = avg;
  } else {  // PAETH_PRED
    for (int i = 0; i < h; i++) {
      for (int j = 0; j < w; j++) {
        int base = aboveRow[j] + leftCol[i] - aboveRow[-1];
        int pLeft = std::abs(base - leftCol[i]);
        int pTop = std::abs(base - aboveRow[j]);
        int pTopLeft = std::abs(base - aboveRow[-1]);
        if (pLeft <= pTop && pLeft <= pTopLeft)
          pred[i][j] = leftCol[i];
        else if (pTop <= pTopLeft)
          pred[i][j] = aboveRow[j];
        else
          pred[i][j] = aboveRow[-1];
      }
    }
  }
  for (int i = 0; i < h; i++) {
    Pixel* dst = &px(plane, y + i, x);
    for (int j = 0; j < w; j++) dst[j] = (Pixel)pred[i][j];
  }
}

template <typename Pixel>
void Decoder<Pixel>::predict_cfl(int plane, int startX, int startY, int txSz) {
  int w = tx_w(txSz), h = tx_h(txSz);
  int alpha = plane == 1 ? cflAlphaU : cflAlphaV;
  static thread_local int L[32][32];
  int lumaAvg = 0;
  for (int i = 0; i < h; i++) {
    int lumaY = std::min(startY + i, (maxLumaH >> subY) - 1) << subY;
    for (int j = 0; j < w; j++) {
      int lumaX = std::min(startX + j, (maxLumaW >> subX) - 1) << subX;
      int t = 0;
      for (int dy = 0; dy <= subY; dy++)
        for (int dx = 0; dx <= subX; dx++) t += px(0, lumaY + dy, lumaX + dx);
      int v = t << (3 - subX - subY);
      L[i][j] = v;
      lumaAvg += v;
    }
  }
  lumaAvg = round2(lumaAvg, kTxWidthLog2[txSz] + kTxHeightLog2[txSz]);
  int maxV = pixel_max();
  for (int i = 0; i < h; i++) {
    Pixel* dst = &px(plane, startY + i, startX);
    for (int j = 0; j < w; j++) {
      int scaledLuma = round2signed((int64_t)alpha * (L[i][j] - lumaAvg), 6);
      dst[j] = (Pixel)clip3(0, maxV, dst[j] + scaledLuma);
    }
  }
}

template <typename Pixel>
void Decoder<Pixel>::predict_palette(int plane, int startX, int startY, int x, int y, int txSz) {
  int w = tx_w(txSz), h = tx_h(txSz);
  const Pixel* palette = plane == 0 ? paletteColorsY : plane == 1 ? paletteColorsU : paletteColorsV;
  for (int i = 0; i < h; i++) {
    Pixel* dst = &px(plane, startY + i, startX);
    for (int j = 0; j < w; j++) {
      int idx = plane == 0 ? colorMapY[y * 4 + i][x * 4 + j] : colorMapUV[y * 4 + i][x * 4 + j];
      dst[j] = palette[idx];
    }
  }
}

template struct Decoder<uint8_t>;
template struct Decoder<uint16_t>;

}  // namespace av1
}  // namespace byogan
