// Intra block copy (AV1 specification 5.11.7's use_intrabc branch): the
// vector stack of an intra frame (7.10.2's find_mv_stack, its spatial scans
// alone), the reference vector and its default (assign_mv), the vector's
// difference under MV_INTRABC_CONTEXT (read_mv), the vector held to the
// decoded part of the tile as dav1d 1.5.1 holds it, and the block's copy
// from the frame being decoded through the BILINEAR filter (7.11.3's
// predict_inter, motion_vector_scaling and block_inter_prediction), which
// a half-sample chroma vector of 4:2:0 or 4:2:2 really filters.

#include <algorithm>

#include "av1_decoder.h"

namespace byogan {
namespace av1 {

namespace {

const int kRefCatLevel = 640;
const int kMvBorder = 128;           // MV_BORDER, in eighths of a sample
const int kIntrabcDelayPixels = 256;  // INTRABC_DELAY_PIXELS

}  // namespace

template <typename Pixel>
int Decoder<Pixel>::read_mv_component(int comp) {
  int sign = sd.symbol(cdf.mvSign[comp], 2);
  int mvClass = sd.symbol(cdf.mvClass[comp], 11);
  if (counts) counts->mvClass[mvClass]++;
  // force_integer_mv is 1 in an intra frame: mv_fr 3, mv_hp 1, neither read.
  int mag;
  if (mvClass == 0) {
    mag = (sd.symbol(cdf.mvClass0Bit[comp], 2) << 3 | 7) + 1;
  } else {
    int d = 0;
    for (int i = 0; i < mvClass; i++) d |= sd.symbol(cdf.mvBit[comp][i], 2) << i;
    mag = (2 << (mvClass + 2)) + (d << 3 | 7) + 1;
  }
  return sign ? -mag : mag;
}

template <typename Pixel>
void Decoder<Pixel>::intrabc_mode_info() {
  int bw4 = block_w4(miSize), bh4 = block_h4(miSize);
  // find_mv_stack(0): RefStackMv (row, column) and WeightStack.
  int stack[8][2], weight[8], numMvFound = 0;
  auto add_candidate = [&](int mvRow, int mvCol, int w) {
    int m = mi(mvRow, mvCol);
    if (blockKinds[m] != kIntrabc) return;
    int cand[2];
    for (int i = 0; i < 2; i++) {  // lower_mv_precision under force_integer_mv
      int v = mvs[(size_t)m * 2 + i], a = (std::abs(v) + 3) >> 3;
      cand[i] = v > 0 ? a << 3 : -(a << 3);
    }
    int idx = 0;
    while (idx < numMvFound && !(stack[idx][0] == cand[0] && stack[idx][1] == cand[1])) idx++;
    if (idx < numMvFound) {
      weight[idx] += w;
    } else if (numMvFound < 8) {
      stack[numMvFound][0] = cand[0];
      stack[numMvFound][1] = cand[1];
      weight[numMvFound++] = w;
    }
  };
  auto scan_row = [&](int deltaRow) {
    int end4 = std::min(std::min(bw4, fh.miCols - miCol), 16), deltaCol = 0;
    if (std::abs(deltaRow) > 1) {
      deltaRow += miRow & 1;
      deltaCol = 1 - (miCol & 1);
    }
    for (int i = 0; i < end4;) {
      int mvRow = miRow + deltaRow, mvCol = miCol + deltaCol + i;
      if (!is_inside(mvRow, mvCol)) break;
      int len = std::min(bw4, block_w4(miSizes[mi(mvRow, mvCol)]));
      if (std::abs(deltaRow) > 1) len = std::max(2, len);
      if (bw4 >= 16) len = std::max(4, len);
      add_candidate(mvRow, mvCol, len * 2);
      i += len;
    }
  };
  auto scan_col = [&](int deltaCol) {
    int end4 = std::min(std::min(bh4, fh.miRows - miRow), 16), deltaRow = 0;
    if (std::abs(deltaCol) > 1) {
      deltaRow = 1 - (miRow & 1);
      deltaCol += miCol & 1;
    }
    for (int i = 0; i < end4;) {
      int mvRow = miRow + deltaRow + i, mvCol = miCol + deltaCol;
      if (!is_inside(mvRow, mvCol)) break;
      int len = std::min(bh4, block_h4(miSizes[mi(mvRow, mvCol)]));
      if (std::abs(deltaCol) > 1) len = std::max(2, len);
      if (bh4 >= 16) len = std::max(4, len);
      add_candidate(mvRow, mvCol, len * 2);
      i += len;
    }
  };
  auto scan_point = [&](int deltaRow, int deltaCol) {
    int mvRow = miRow + deltaRow, mvCol = miCol + deltaCol;
    if (is_inside(mvRow, mvCol) && blockKinds[mi(mvRow, mvCol)] != kNotDecoded) add_candidate(mvRow, mvCol, 4);
  };
  auto sorting = [&](int start, int end) {
    while (end > start) {
      int newEnd = start;
      for (int idx = start + 1; idx < end; idx++) {
        if (weight[idx - 1] < weight[idx]) {
          std::swap(weight[idx - 1], weight[idx]);
          std::swap(stack[idx - 1][0], stack[idx][0]);
          std::swap(stack[idx - 1][1], stack[idx][1]);
          newEnd = idx;
        }
      }
      end = newEnd;
    }
  };
  scan_row(-1);
  scan_col(-1);
  if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
  int numNearest = numMvFound;
  for (int idx = 0; idx < numNearest; idx++) weight[idx] += kRefCatLevel;
  scan_point(-1, -1);
  scan_row(-3);
  scan_col(-3);
  if (bh4 > 1) scan_row(-5);
  if (bw4 > 1) scan_col(-5);
  sorting(0, numNearest);
  sorting(numNearest, numMvFound);
  // extra_search finds nothing in an intra frame (no candidate references
  // another frame); context_and_clamping clamps the stack, and the places
  // past it hold the zero global vector.
  int bottom = (fh.miRows - bh4 - miRow) * 32, right = (fh.miCols - bw4 - miCol) * 32;
  for (int idx = 0; idx < numMvFound; idx++) {
    stack[idx][0] = clip3(-miRow * 32 - kMvBorder - bh4 * 32, bottom + kMvBorder + bh4 * 32, stack[idx][0]);
    stack[idx][1] = clip3(-miCol * 32 - kMvBorder - bw4 * 32, right + kMvBorder + bw4 * 32, stack[idx][1]);
  }
  for (int idx = numMvFound; idx < 2; idx++) stack[idx][0] = stack[idx][1] = 0;

  // assign_mv(0): the nearest vector, else the near one, else the default.
  int pred[2] = {stack[0][0], stack[0][1]};
  if (!pred[0] && !pred[1]) {
    pred[0] = stack[1][0];
    pred[1] = stack[1][1];
  }
  int sbSize4 = seq.use128 ? 32 : 16;
  if (!pred[0] && !pred[1]) {
    if (miRow - sbSize4 < miRowStart) {
      pred[0] = 0;
      pred[1] = -(sbSize4 * 4 + kIntrabcDelayPixels) * 8;
    } else {
      pred[0] = -(sbSize4 * 4 * 8);
      pred[1] = 0;
    }
  }
  // read_mv(0)
  int joint = sd.symbol(cdf.mvJoint, 4);
  if (counts) counts->mvJoint[joint]++;
  int diff[2] = {0, 0};
  if (joint == 2 || joint == 3) diff[0] = read_mv_component(0);
  if (joint == 1 || joint == 3) diff[1] = read_mv_component(1);
  mv[0] = pred[0] + diff[0];
  mv[1] = pred[1] + diff[1];

  // dav1d's hold of the vector to what is decoded: the source block moved
  // inside the tile's left, right and top edges, out of the current
  // superblock (up into the superblock row above, else left) and above the
  // bottom of its row; a stream whose source still meets the current
  // superblock is refused.
  int borderLeft = miColStart * 4, borderTop = miRowStart * 4;
  if (hasChroma) {
    if (bw4 < 2 && subX) borderLeft += 4;
    if (bh4 < 2 && subY) borderTop += 4;
  }
  int srcLeft = miCol * 4 + (mv[1] >> 3), srcTop = miRow * 4 + (mv[0] >> 3);
  int srcRight = srcLeft + bw4 * 4, srcBottom = srcTop + bh4 * 4;
  int borderRight = ((miColEnd + (bw4 - 1)) & ~(bw4 - 1)) * 4;
  if (srcLeft < borderLeft) {
    srcRight += borderLeft - srcLeft;
    srcLeft = borderLeft;
  } else if (srcRight > borderRight) {
    srcLeft -= srcRight - borderRight;
    srcRight = borderRight;
  }
  if (srcTop < borderTop) {
    srcBottom += borderTop - srcTop;
    srcTop = borderTop;
  }
  int sbShift = seq.use128 ? 5 : 4;
  int sbx = (miCol >> sbShift) << (sbShift + 2), sby = (miRow >> sbShift) << (sbShift + 2);
  int sbPixels = 4 << sbShift;
  if (srcBottom > sby && srcRight > sbx) {
    if (srcTop - borderTop >= srcBottom - sby) {
      srcTop -= srcBottom - sby;
      srcBottom = sby;
    } else if (srcLeft - borderLeft >= srcRight - sbx) {
      srcLeft -= srcRight - sbx;
      srcRight = sbx;
    }
  }
  if (srcBottom > sby + sbPixels) {
    srcTop -= srcBottom - (sby + sbPixels);
    srcBottom = sby + sbPixels;
  }
  if (srcBottom > sby && srcRight > sbx) fail(kFaultBroken);
  mv[0] = (srcTop - miRow * 4) * 8;
  mv[1] = (srcLeft - miCol * 4) * 8;
}

template <typename Pixel>
void Decoder<Pixel>::predict_inter(int plane, int baseX, int baseY, int w, int h) {
  int sx = plane ? subX : 0, sy = plane ? subY : 0;
  // The sample position in sixteenths (motion_vector_scaling at scale 1);
  // block_inter_prediction reads the frame being decoded clamped to its
  // 4x4 blocks, through the BILINEAR taps (128 - 8 f, 8 f).
  int posX = (baseX << 4) + ((2 * mv[1]) >> sx), posY = (baseY << 4) + ((2 * mv[0]) >> sy);
  int x0 = posX >> 4, fx = posX & 15, y0 = posY >> 4, fy = posY & 15;
  int lastX = ((fh.miCols * 4 + sx) >> sx) - 1, lastY = ((fh.miRows * 4 + sy) >> sy) - 1;
  int round0 = bitDepth == 12 ? 5 : 3, round1 = bitDepth == 12 ? 9 : 11;
  int maxV = pixel_max();
  // The intermediate rows: h + 1 filtered across, at rows y0 .. y0 + h.
  static thread_local int inter[129][128];
  for (int r = 0; r <= h; r++) {
    const Pixel* row = &px(plane, clip3(0, lastY, y0 + r), 0);
    for (int c = 0; c < w; c++) {
      int a = row[clip3(0, lastX, x0 + c)], b = row[clip3(0, lastX, x0 + c + 1)];
      inter[r][c] = round2((128 - 8 * fx) * a + 8 * fx * b, round0);
    }
  }
  for (int r = 0; r < h; r++) {
    Pixel* dst = &px(plane, baseY + r, baseX);
    for (int c = 0; c < w; c++)
      dst[c] = (Pixel)clip3(0, maxV, round2((128 - 8 * fy) * inter[r][c] + 8 * fy * inter[r + 1][c], round1));
  }
}

template struct Decoder<uint8_t>;
template struct Decoder<uint16_t>;

}  // namespace av1
}  // namespace byogan
