// CDEF (AV1 specification 7.15): each 8x8 block not skipped whole, in each
// 64x64 unit with a strength index, finds its direction and variance on the
// deblocked luma (7.15.2) and is filtered with the primary and secondary
// taps and their damping (7.15.3), reading the deblocked frame; strengths
// and damping scaled by coeff_shift (BitDepth - 8).

#include <algorithm>
#include <climits>

#include "av1_decoder.h"

namespace byogan {
namespace av1 {

namespace {

const int kCdefPriTaps[2][2] = {{4, 2}, {3, 3}};
const int kCdefSecTaps[2][2] = {{2, 1}, {2, 1}};

// constrain() with its damping already adjusted by the threshold's log2.
inline int constrain(int diff, int threshold, int dampingAdj) {
  int ad = diff < 0 ? -diff : diff;
  int val = std::min(ad, std::max(0, threshold - (ad >> dampingAdj)));
  return diff < 0 ? -val : val;
}

}  // namespace

template <typename Pixel>
void Decoder<Pixel>::cdef_frame(std::vector<Pixel> (&pre)[3]) {
  const FrameHeader& h = fh;
  // The deblocked planes with a border of 2 (the taps' reach) marked
  // unavailable, as is_inside_filter_region marks what lies outside the
  // frame's 4x4 blocks.
  const int16_t kNone = INT16_MIN;
  std::vector<int16_t> padded[3];
  int pstride[3] = {0, 0, 0};
  for (int p = 0; p < numPlanes; p++) {
    int sx = p ? subX : 0, sy = p ? subY : 0;
    int w = (h.miCols * 4) >> sx, hgt = (h.miRows * 4) >> sy;
    pstride[p] = w + 4;
    padded[p].assign((size_t)(hgt + 4) * pstride[p], kNone);
    for (int y = 0; y < hgt; y++) {
      const Pixel* src = &pre[p][(size_t)y * stride[p]];
      int16_t* dst = &padded[p][(size_t)(y + 2) * pstride[p] + 2];
      for (int x = 0; x < w; x++) dst[x] = src[x];
    }
  }
  const int coeffShift = depth_shift();
  for (int fbr = 0; fbr < h.miRows; fbr += 16) {
    for (int fbc = 0; fbc < h.miCols; fbc += 16) {
      int idx = cdefIdx[(fbr >> 4) * cdefStride + (fbc >> 4)];
      if (idx == -1) continue;
      for (int r = fbr; r < std::min(fbr + 16, h.miRows); r += 2) {
        for (int c = fbc; c < std::min(fbc + 16, h.miCols); c += 2) {
          int skip = skips[mi(r, c)] && skips[mi(r + 1, c)] && skips[mi(r, c + 1)] && skips[mi(r + 1, c + 1)];
          if (skip) continue;
          // cdef_direction()
          int cost[8] = {0}, partial[8][15] = {{0}};
          int x0 = c << 2, y0 = r << 2;
          for (int i = 0; i < 8; i++) {
            const int16_t* row = &padded[0][(size_t)(y0 + i + 2) * pstride[0] + x0 + 2];
            for (int j = 0; j < 8; j++) {
              int x = (row[j] >> coeffShift) - 128;
              partial[0][i + j] += x;
              partial[1][i + j / 2] += x;
              partial[2][i] += x;
              partial[3][3 + i - j / 2] += x;
              partial[4][7 + i - j] += x;
              partial[5][3 - i / 2 + j] += x;
              partial[6][j] += x;
              partial[7][i / 2 + j] += x;
            }
          }
          for (int i = 0; i < 8; i++) {
            cost[2] += partial[2][i] * partial[2][i];
            cost[6] += partial[6][i] * partial[6][i];
          }
          cost[2] *= kDivTable[8];
          cost[6] *= kDivTable[8];
          for (int i = 0; i < 7; i++) {
            cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * kDivTable[i + 1];
            cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * kDivTable[i + 1];
          }
          cost[0] += partial[0][7] * partial[0][7] * kDivTable[8];
          cost[4] += partial[4][7] * partial[4][7] * kDivTable[8];
          for (int i = 1; i < 8; i += 2) {
            for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
            cost[i] *= kDivTable[8];
            for (int j = 0; j < 3; j++)
              cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * kDivTable[2 * j + 2];
          }
          int bestCost = 0, yDir = 0;
          for (int i = 0; i < 8; i++) {
            if (cost[i] > bestCost) {
              bestCost = cost[i];
              yDir = i;
            }
          }
          int var = (bestCost - cost[(yDir + 4) & 7]) >> 10;
          auto filter = [&](int plane, int priStr, int secStr, int damping, int dir) {
            if (!priStr && !secStr) return;  // every tap constrained to 0
            int sx = plane ? subX : 0, sy = plane ? subY : 0;
            int px0 = (c * 4) >> sx, py0 = (r * 4) >> sy;
            int w = 8 >> sx, hh = 8 >> sy;
            int ps = pstride[plane];
            int priAdj = priStr ? std::max(0, damping - floor_log2(priStr)) : 0;
            int secAdj = secStr ? std::max(0, damping - floor_log2(secStr)) : 0;
            int t = (priStr >> coeffShift) & 1;
            int priTaps[2] = {kCdefPriTaps[t][0], kCdefPriTaps[t][1]};
            int secTaps[2] = {kCdefSecTaps[t][0], kCdefSecTaps[t][1]};
            // The 12 taps: the primary direction's 4, then dir + 2's and
            // dir - 2's 8, each with its weight, threshold and damping.
            ptrdiff_t off[12];
            int wt[12], thr[12], adj[12];
            for (int k = 0, n = 0; k < 2; k++) {
              for (int sign = -1; sign <= 1; sign += 2) {
                for (int d = 0; d < 3; d++, n++) {
                  int dd = d == 0 ? dir : d == 1 ? (dir + 2) & 7 : (dir + 6) & 7;
                  off[n] = sign * (kCdefDirections[dd][k][0] * ps + kCdefDirections[dd][k][1]);
                  wt[n] = d == 0 ? priTaps[k] : secTaps[k];
                  thr[n] = d == 0 ? priStr : secStr;
                  adj[n] = d == 0 ? priAdj : secAdj;
                }
              }
            }
            for (int i = 0; i < hh; i++) {
              const int16_t* src = &padded[plane][(size_t)(py0 + i + 2) * ps + px0 + 2];
              Pixel* dst = &px(plane, py0 + i, px0);
              for (int j = 0; j < w; j++) {
                const int16_t* q = src + j;
                int x = *q;
                int sum = 0, mx = x, mn = x;
                // An unavailable tap (kNone) constrains to 0, is below every
                // maximum and, compared unsigned, above every minimum.
                for (int n = 0; n < 12; n++) {
                  int p = q[off[n]];
                  sum += wt[n] * constrain(p - x, thr[n], adj[n]);
                  mx = std::max(p, mx);
                  mn = (unsigned)p < (unsigned)mn ? p : mn;
                }
                dst[j] = (Pixel)clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
              }
            }
          };
          int priStr = h.cdefYPri[idx] << coeffShift, secStr = h.cdefYSec[idx] << coeffShift;
          int dir = priStr == 0 ? 0 : yDir;
          int varStr = (var >> 6) ? std::min(floor_log2(var >> 6), 12) : 0;
          priStr = var ? (priStr * (4 + varStr) + 8) >> 4 : 0;
          int damping = h.cdefDamping + coeffShift;
          filter(0, priStr, secStr, damping, dir);
          if (numPlanes == 1) continue;
          priStr = h.cdefUvPri[idx] << coeffShift;
          secStr = h.cdefUvSec[idx] << coeffShift;
          dir = priStr == 0 ? 0 : kCdefUvDir[subX][subY][yDir];
          filter(1, priStr, secStr, damping - 1, dir);
          filter(2, priStr, secStr, damping - 1, dir);
        }
      }
    }
  }
}

template struct Decoder<uint8_t>;
template struct Decoder<uint16_t>;

}  // namespace av1
}  // namespace byogan
