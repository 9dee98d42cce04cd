// The loop filter (AV1 specification 7.14): every vertical edge of a plane,
// then every horizontal one, at each transform edge; levels per plane and
// direction with the segment's and the delta's adjustments, sharpness, the
// intra reference delta; the 4-, 6-, 8- and 14-tap filters, their limits
// and the narrow filter's range scaled to BitDepth.

#include <algorithm>

#include "av1_decoder.h"

namespace byogan {
namespace av1 {

namespace {

struct Strength {
  int lvl, limit, blimit, thresh;
};

}  // namespace

template <typename Pixel>
void Decoder<Pixel>::loop_filter_frame() {
  const FrameHeader& h = fh;
  if (!h.loopFilterLevel[0] && !h.loopFilterLevel[1]) return;
  auto strength = [&](int row, int col, int plane, int pass) {
    int m = mi(row, col);
    int segment = segmentIds[m];
    int deltaLF = fh.deltaLfMulti ? deltaLFs[(size_t)m * 4 + (plane == 0 ? pass : plane + 1)] : deltaLFs[(size_t)m * 4];
    int i = plane == 0 ? pass : plane + 1;
    int baseFilterLevel = clip3(0, 63, deltaLF + h.loopFilterLevel[i]);
    int lvlSeg = baseFilterLevel;
    int feature = 1 + i;
    if (h.segmentationEnabled && h.featureEnabled[segment][feature])
      lvlSeg = clip3(0, 63, baseFilterLevel + h.featureData[segment][feature]);
    if (h.loopFilterDeltaEnabled) {
      int nShift = lvlSeg >> 5;
      lvlSeg = clip3(0, 63, lvlSeg + (h.loopFilterRefDeltas[0] * (1 << nShift)));
    }
    Strength s;
    s.lvl = lvlSeg;
    int sharp = h.loopFilterSharpness;
    int shift = sharp > 4 ? 2 : (sharp > 0 ? 1 : 0);
    s.limit = sharp > 0 ? clip3(1, 9 - sharp, s.lvl >> shift) : std::max(1, s.lvl >> shift);
    s.blimit = 2 * (s.lvl + 2) + s.limit;
    s.thresh = s.lvl >> 4;
    return s;
  };
  const int shift = depth_shift();
  const int half = 128 << shift, flatThresh = 1 << shift;
  // filter4_clamp: the signed range of BitDepth bits.
  auto c8 = [half](int v) { return clip3(-half, half - 1, v); };
  for (int plane = 0; plane < numPlanes; plane++) {
    if (plane > 0 && !h.loopFilterLevel[1 + plane]) continue;
    int sx = plane ? subX : 0, sy = plane ? subY : 0;
    int n4w = (int)aboveLevel[plane].size();
    int st = stride[plane];
    for (int pass = 0; pass < 2; pass++) {
      int rowStep = plane == 0 ? 1 : (1 << sy), colStep = plane == 0 ? 1 : (1 << sx);
      int dx = pass == 0 ? 1 : 0, dy = pass == 1 ? 1 : 0;
      for (int row0 = 0; row0 < h.miRows; row0 += rowStep) {
        for (int col0 = 0; col0 < h.miCols; col0 += colStep) {
          int x = col0 * 4, y = row0 * 4;
          if (x >= h.frameWidth || y >= h.frameHeight) continue;
          if (pass == 0 && x == 0) continue;
          if (pass == 1 && y == 0) continue;
          int row = row0 | sy, col = col0 | sx;
          int xP = x >> sx, yP = y >> sy;
          int prevRow = row - (dy << sy), prevCol = col - (dx << sx);
          int txSz = lfTxSizes[plane][(size_t)(row >> sy) * n4w + (col >> sx)];
          int prevTxSz = lfTxSizes[plane][(size_t)(prevRow >> sy) * n4w + (prevCol >> sx)];
          int isTxEdge = pass == 0 ? (xP % tx_w(txSz)) == 0 : (yP % tx_h(txSz)) == 0;
          if (!isTxEdge) continue;  // intra blocks filter every transform edge
          int baseSize = pass == 0 ? std::min(tx_w(prevTxSz), tx_w(txSz)) : std::min(tx_h(prevTxSz), tx_h(txSz));
          int filterSize = plane == 0 ? std::min(16, baseSize) : (baseSize == 4 ? 4 : 6);
          Strength s = strength(row, col, plane, pass);
          if (s.lvl == 0) s = strength(prevRow, prevCol, plane, pass);
          if (s.lvl == 0) continue;
          int limit = s.limit << shift, blimit = s.blimit << shift, thresh = s.thresh << shift;
          for (int i = 0; i < 4; i++) {
            int px0 = xP + dy * i, py0 = yP + dx * i;
            Pixel* q = &cur[plane][(size_t)py0 * st + px0];
            ptrdiff_t step = dx ? 1 : st;
            auto P = [&](int k) -> Pixel& { return q[-(k + 1) * step]; };
            auto Q = [&](int k) -> Pixel& { return q[k * step]; };
            int p0 = P(0), p1 = P(1), q0 = Q(0), q1 = Q(1);
            int hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
            int mask = std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit &&
                       std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
            int p2 = 0, q2 = 0, p3 = 0, q3 = 0;
            int flat = 0, flat2 = 0;
            if (filterSize >= 6) {
              p2 = P(2);
              q2 = Q(2);
              mask = mask && std::abs(p2 - p1) <= limit && std::abs(q2 - q1) <= limit;
              flat = std::abs(p1 - p0) <= flatThresh && std::abs(q1 - q0) <= flatThresh &&
                     std::abs(p2 - p0) <= flatThresh && std::abs(q2 - q0) <= flatThresh;
            }
            if (filterSize >= 8) {
              p3 = P(3);
              q3 = Q(3);
              mask = mask && std::abs(p3 - p2) <= limit && std::abs(q3 - q2) <= limit;
              flat = flat && std::abs(p3 - p0) <= flatThresh && std::abs(q3 - q0) <= flatThresh;
            }
            if (!mask) continue;
            if (filterSize == 16) {
              flat2 = 1;
              for (int k = 4; k <= 6; k++)
                flat2 = flat2 && std::abs(P(k) - p0) <= flatThresh && std::abs(Q(k) - q0) <= flatThresh;
            }
            if (filterSize == 4 || !flat) {
              // narrow filter
              int ps1 = p1 - half, ps0 = p0 - half, qs0 = q0 - half, qs1 = q1 - half;
              int filter = hev ? c8(ps1 - qs1) : 0;
              filter = c8(filter + 3 * (qs0 - ps0));
              int filter1 = c8(filter + 4) >> 3;
              int filter2 = c8(filter + 3) >> 3;
              Q(0) = (Pixel)(c8(qs0 - filter1) + half);
              P(0) = (Pixel)(c8(ps0 + filter2) + half);
              if (!hev) {
                filter = round2(filter1, 1);
                Q(1) = (Pixel)(c8(qs1 - filter) + half);
                P(1) = (Pixel)(c8(ps1 + filter) + half);
              }
            } else {
              int log2Size = (filterSize == 16 && flat2) ? 4 : 3;
              int n = log2Size == 4 ? 6 : (plane == 0 ? 3 : 2);
              int n2 = (log2Size == 3 && plane == 0) ? 0 : 1;
              int F[16], F2[16];
              for (int k = -(n + 1); k <= n; k++) F[k + 8] = k < 0 ? P(-k - 1) : Q(k);
              for (int k = -n; k < n; k++) {
                int t = 0;
                for (int j = -n; j <= n; j++) {
                  int p = clip3(-(n + 1), n, k + j);
                  int tap = std::abs(j) <= n2 ? 2 : 1;
                  t += F[p + 8] * tap;
                }
                F2[k + 8] = round2(t, log2Size);
              }
              for (int k = -n; k < n; k++) {
                if (k < 0)
                  P(-k - 1) = (Pixel)F2[k + 8];
                else
                  Q(k) = (Pixel)F2[k + 8];
              }
            }
          }
        }
      }
    }
  }
}

template struct Decoder<uint8_t>;
template struct Decoder<uint16_t>;

}  // namespace av1
}  // namespace byogan
