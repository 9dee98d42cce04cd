// Loop restoration (AV1 specification 7.17): each 4x4 block (in luma units)
// of a plane with a restoration type takes its unit's Wiener (12-bit
// samples with their own rounding) or self-guided filter (its variance of
// samples brought to 8 bits); samples come from the CDEF output inside the block's 64-row
// stripe and from the deblocked frame within two rows outside it.  A
// stripe's samples are gathered once, with summed-area tables of them and
// of their squares for the self-guided filter's box sums.

#include <algorithm>

#include "av1_decoder.h"

namespace byogan {
namespace av1 {

template <typename Pixel>
void Decoder<Pixel>::lr_frame(std::vector<Pixel> (&deblocked)[3], std::vector<Pixel> (&cdefed)[3]) {
  const FrameHeader& h = fh;
  const int maxV = pixel_max(), shift8 = depth_shift();
  for (int plane = 0; plane < numPlanes; plane++) {
    if (h.frameRestorationType[plane] == RESTORE_NONE) continue;
    int sx = plane ? subX : 0, sy = plane ? subY : 0;
    int st = stride[plane];
    int unitSize = h.loopRestorationSize[plane];
    int unitRows = lrUnitRows[plane], unitCols = lrUnitCols[plane];
    int planeEndX = ((h.upscaledWidth + sx) >> sx) - 1;
    int planeEndY = ((h.frameHeight + sy) >> sy) - 1;
    const Pixel* cdefP = cdefed[plane].data();
    const Pixel* curP = deblocked[plane].data();
    // One 64-row stripe (in luma rows, 8 above the frame's first) at a time:
    // its samples as get_source_sample reads them, 3 rows and 4 columns
    // around, and the running sums of those samples and their squares.
    const int pad = 4;
    int bw = planeEndX + 1 + 2 * pad;
    std::vector<int32_t> buf;
    std::vector<uint32_t> sum, sq;  // wrap modulo 2^32: a box's difference is exact
    for (int stripeNum = 0; stripeNum * 64 - 8 < h.frameHeight; stripeNum++) {
      int stripeStartY = (-8 + stripeNum * 64) >> sy;
      int stripeEndY = stripeStartY + (64 >> sy) - 1;
      int y0 = std::max(0, stripeStartY), y1 = std::min(planeEndY, stripeEndY);
      if (y0 > y1) continue;
      int by0 = y0 - 3, bh = y1 + 3 - by0 + 1;
      buf.assign((size_t)bw * bh, 0);
      for (int r = 0; r < bh; r++) {
        int y = std::max(0, std::min(planeEndY, by0 + r));
        const Pixel* src;
        if (y < stripeStartY)
          src = curP + (size_t)std::max(stripeStartY - 2, y) * st;
        else if (y > stripeEndY)
          src = curP + (size_t)std::min(stripeEndY + 2, y) * st;
        else
          src = cdefP + (size_t)y * st;
        int32_t* row = &buf[(size_t)r * bw];
        for (int c = 0; c < bw; c++) row[c] = src[std::max(0, std::min(planeEndX, c - pad))];
      }
      bool sgr = false;
      for (int y = y0; y <= y1 && !sgr; y++) {
        int unitRow = std::min(unitRows - 1, (((y << sy) + 8) >> sy) / unitSize);
        for (int u = 0; u < unitCols; u++) sgr |= lrType[plane][(size_t)unitRow * unitCols + u] == RESTORE_SGRPROJ;
      }
      if (sgr) {  // summed-area tables, one row and column of zeros before
        sum.assign((size_t)(bw + 1) * (bh + 1), 0);
        sq.assign((size_t)(bw + 1) * (bh + 1), 0);
        for (int r = 0; r < bh; r++) {
          uint32_t rs = 0, rq = 0;
          for (int c = 0; c < bw; c++) {
            uint32_t v = (uint32_t)buf[(size_t)r * bw + c];
            rs += v;
            rq += v * v;
            sum[(size_t)(r + 1) * (bw + 1) + c + 1] = sum[(size_t)r * (bw + 1) + c + 1] + rs;
            sq[(size_t)(r + 1) * (bw + 1) + c + 1] = sq[(size_t)r * (bw + 1) + c + 1] + rq;
          }
        }
      }
      auto box = [&](const std::vector<uint32_t>& t, int x, int y, int r) {
        int c0 = x - r + pad, c1 = x + r + pad + 1, r0 = y - r - by0, r1 = y + r - by0 + 1;
        return (uint32_t)(t[(size_t)r1 * (bw + 1) + c1] - t[(size_t)r0 * (bw + 1) + c1] -
                          t[(size_t)r1 * (bw + 1) + c0] + t[(size_t)r0 * (bw + 1) + c0]);
      };
      int rowStep = 4 >> sy, colStep = 4 >> sx;
      for (int y = y0; y <= y1; y += rowStep) {
        int hh = std::min(rowStep, y1 - y + 1);
        int unitRow = std::min(unitRows - 1, (((y << sy) + 8) >> sy) / unitSize);
        for (int x = 0; x <= planeEndX; x += colStep) {
          int w = std::min(colStep, planeEndX - x + 1);
          int unitCol = std::min(unitCols - 1, x / unitSize);
          size_t u = (size_t)unitRow * unitCols + unitCol;
          int rType = lrType[plane][u];
          if (rType == RESTORE_WIENER) {
            int filter[2][7];
            for (int pass = 0; pass < 2; pass++) {
              filter[pass][3] = 128;
              for (int i = 0; i < 3; i++) {
                int c = lrWiener[plane][u * 6 + pass * 3 + i];
                filter[pass][i] = filter[pass][6 - i] = c;
                filter[pass][3] -= 2 * c;
              }
            }
            const int* vfilter = filter[0];
            const int* hfilter = filter[1];
            const int round0 = bitDepth == 12 ? 5 : 3, round1 = bitDepth == 12 ? 9 : 11;
            int offset = 1 << (bitDepth + 7 - round0 - 1);
            int limit = (1 << (bitDepth + 1 + 7 - round0)) - 1;
            int inter[10][4];
            for (int r = 0; r < hh + 6; r++) {
              const int32_t* row = &buf[(size_t)(y + r - 3 - by0) * bw + x + pad - 3];
              for (int c = 0; c < w; c++) {
                int s = 0;
                for (int t = 0; t < 7; t++) s += hfilter[t] * row[c + t];
                inter[r][c] = clip3(-offset, limit - offset, (s + (1 << (round0 - 1))) >> round0);
              }
            }
            for (int r = 0; r < hh; r++) {
              for (int c = 0; c < w; c++) {
                int s = 0;
                for (int t = 0; t < 7; t++) s += vfilter[t] * inter[r + t][c];
                px(plane, y + r, x + c) = (Pixel)clip3(0, maxV, round2(s, round1));
              }
            }
          } else if (rType == RESTORE_SGRPROJ) {
            int set = lrSgrSet[plane][u];
            int flt[2][4][4];
            for (int pass = 0; pass < 2; pass++) {
              int r = kSgrParams[set][pass * 2];
              if (!r) continue;
              int s = kSgrParams[set][pass * 2 + 1];
              int n = (2 * r + 1) * (2 * r + 1);
              int oneOverN = ((1 << 12) + (n / 2)) / n;
              int A[6][6], B[6][6];
              for (int i = -1; i < hh + 1; i++) {
                for (int j = -1; j < w + 1; j++) {
                  uint32_t a = box(sq, x + j, y + i, r), b = box(sum, x + j, y + i, r);
                  uint32_t d = b;
                  if (shift8) {
                    a = (uint32_t)round2(a, 2 * shift8);
                    d = (uint32_t)round2(b, shift8);
                  }
                  int64_t p = std::max<int64_t>(0, (int64_t)a * n - (int64_t)d * d);
                  uint32_t z = (uint32_t)round2(p * s, 20);
                  int a2 = z >= 255 ? 256 : z == 0 ? 1 : (int)(((z << 8) + (z / 2)) / (z + 1));
                  A[i + 1][j + 1] = a2;
                  B[i + 1][j + 1] = round2((uint64_t)(256 - a2) * b * (uint32_t)oneOverN, 12);
                }
              }
              for (int i = 0; i < hh; i++) {
                int shift = (pass == 0 && (i & 1)) ? 4 : 5;
                for (int j = 0; j < w; j++) {
                  int a = 0, b = 0;
                  for (int dy = -1; dy <= 1; dy++) {
                    for (int dx = -1; dx <= 1; dx++) {
                      int weight;
                      if (pass == 0)
                        weight = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                      else
                        weight = (dx == 0 || dy == 0) ? 4 : 3;
                      a += weight * A[i + dy + 1][j + dx + 1];
                      b += weight * B[i + dy + 1][j + dx + 1];
                    }
                  }
                  int v = a * cdefP[(size_t)(y + i) * st + x + j] + b;
                  flt[pass][i][j] = round2(v, 8 + shift - 4);
                }
              }
            }
            int w0 = lrSgrXqd[plane][u * 2], w1 = lrSgrXqd[plane][u * 2 + 1];
            int w2 = (1 << 7) - w0 - w1;
            int r0 = kSgrParams[set][0], r1 = kSgrParams[set][2];
            for (int i = 0; i < hh; i++) {
              for (int j = 0; j < w; j++) {
                int uu = cdefP[(size_t)(y + i) * st + x + j] << 4;
                int v = w1 * uu;
                v += r0 ? w0 * flt[0][i][j] : w0 * uu;
                v += r1 ? w2 * flt[1][i][j] : w2 * uu;
                px(plane, y + i, x + j) = (Pixel)clip3(0, maxV, round2(v, 4 + 7));
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
