// Transform sizes and types, the coefficients of each transform block with
// every context the specification names (all_zero, the EOB classes and
// extra bits, base levels, the BR ranges, Golomb remainders, DC signs), and
// the dequantization and reconstruction of 7.12.3 (AV1 specification
// 5.11.15-5.11.39 and 7.12).  An intra block copy block is an inter block:
// its luma transform sizes a txfm_split tree, its types the inter sets.

#include <algorithm>

#include "av1_decoder.h"

namespace byogan {
namespace av1 {

namespace {

const uint8_t kFilterIntraModeToIntraDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
const uint8_t kMaxTxDepth[BLOCK_SIZES] = {0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4};
const uint8_t kTxTypeIntraInvSet1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const uint8_t kTxTypeIntraInvSet2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const uint8_t kTxTypeInterInvSet1[16] = {IDTX,         V_DCT,         H_DCT,        V_ADST,    H_ADST,
                                         V_FLIPADST,   H_FLIPADST,    DCT_DCT,      ADST_DCT,  DCT_ADST,
                                         FLIPADST_DCT, DCT_FLIPADST,  ADST_ADST,    FLIPADST_FLIPADST,
                                         ADST_FLIPADST, FLIPADST_ADST};
const uint8_t kTxTypeInterInvSet2[12] = {IDTX,         V_DCT,        H_DCT,     DCT_DCT,
                                         ADST_DCT,     DCT_ADST,     FLIPADST_DCT, DCT_FLIPADST,
                                         ADST_ADST,    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const int8_t kSigRefDiffOffset[3][5][2] = {{{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
                                           {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
                                           {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
const int8_t kMagRefOffset[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};

enum { TX_CLASS_2D = 0, TX_CLASS_HORIZ = 1, TX_CLASS_VERT = 2 };
enum { TX_SET_DCTONLY = 0, TX_SET_INTRA_1 = 1, TX_SET_INTRA_2 = 2 };
enum { TX_SET_INTER_1 = 1, TX_SET_INTER_2 = 2, TX_SET_INTER_3 = 3 };

int get_tx_class(int t) {
  if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
  if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
  return TX_CLASS_2D;
}

int get_tx_set(int txSz, int reducedTxSet, int isInter) {
  int sqrUp = kTxSizeSqrUp[txSz];
  if (sqrUp > TX_32X32) return TX_SET_DCTONLY;
  if (isInter) {
    if (reducedTxSet || sqrUp == TX_32X32) return TX_SET_INTER_3;
    if (kTxSizeSqr[txSz] == TX_16X16) return TX_SET_INTER_2;
    return TX_SET_INTER_1;
  }
  if (sqrUp == TX_32X32) return TX_SET_DCTONLY;
  if (reducedTxSet) return TX_SET_INTRA_2;
  if (kTxSizeSqr[txSz] == TX_16X16) return TX_SET_INTRA_2;
  return TX_SET_INTRA_1;
}

// is_tx_type_in_set: Tx_Type_In_Set_Intra and Tx_Type_In_Set_Inter.
bool in_set(int set, int t, int isInter) {
  if (set == TX_SET_DCTONLY) return t == DCT_DCT;
  if (isInter) {
    if (set == TX_SET_INTER_3) return t == DCT_DCT || t == IDTX;
    return set == TX_SET_INTER_1 || t < V_ADST;  // set 2: all but the 1D ADSTs
  }
  if (t == DCT_DCT || t == ADST_DCT || t == DCT_ADST || t == ADST_ADST || t == IDTX) return true;
  return set == TX_SET_INTRA_1 && (t == V_DCT || t == H_DCT);
}

}  // namespace

template <typename Pixel>
void Decoder<Pixel>::read_block_tx_size() {
  int bw4 = block_w4(miSize), bh4 = block_h4(miSize);
  if (fh.txModeSelect && miSize > BLOCK_4X4 && useIntrabc && !skip && !lossless) {
    int maxTxSz = kMaxTxSizeRect[miSize];
    int txW4 = tx_w(maxTxSz) >> 2, txH4 = tx_h(maxTxSz) >> 2;
    for (int row = miRow; row < miRow + bh4; row += txH4)
      for (int col = miCol; col < miCol + bw4; col += txW4) read_var_tx_size(row, col, maxTxSz, 0);
    return;
  }
  // read_tx_size(!skip || !is_inter)
  if (lossless) {
    txSize = TX_4X4;
  } else {
    txSize = kMaxTxSizeRect[miSize];
    if (miSize > BLOCK_4X4 && (!skip || !useIntrabc) && fh.txModeSelect) read_tx_depth();
  }
  for (int row = miRow; row < miRow + bh4; row++)
    for (int col = miCol; col < miCol + bw4; col++) interTxSizes[mi(row, col)] = (uint8_t)txSize;
}

// The width (or height) of the transform above (or left of) 4x4 (row, col)
// of the block, get_above_tx_width and get_left_tx_height.
template <typename Pixel>
int Decoder<Pixel>::above_tx_width(int row, int col) {
  if (row == miRow) {
    if (!availU) return 64;
    int m = mi(row - 1, col);
    if (skips[m] && blockKinds[m] == kIntrabc) return 4 * block_w4(miSizes[m]);
  }
  return tx_w(interTxSizes[mi(row - 1, col)]);
}

template <typename Pixel>
int Decoder<Pixel>::left_tx_height(int row, int col) {
  if (col == miCol) {
    if (!availL) return 64;
    int m = mi(row, col - 1);
    if (skips[m] && blockKinds[m] == kIntrabc) return 4 * block_h4(miSizes[m]);
  }
  return tx_h(interTxSizes[mi(row, col - 1)]);
}

template <typename Pixel>
void Decoder<Pixel>::read_var_tx_size(int row, int col, int txSz, int depth) {
  if (row >= fh.miRows || col >= fh.miCols) return;
  int split = 0;
  if (txSz != TX_4X4 && depth != 2) {
    int above = above_tx_width(row, col) < tx_w(txSz);
    int left = left_tx_height(row, col) < tx_h(txSz);
    int size = std::min(64, 4 * std::max(block_w4(miSize), block_h4(miSize)));
    int maxTxSz = floor_log2(size) - 2;  // find_tx_size(size, size): the square of that size
    int ctx = (kTxSizeSqrUp[txSz] != maxTxSz) * 3 + (TX_64X64 - maxTxSz) * 6 + above + left;
    split = sd.symbol(cdf.txfmSplit[ctx], 2);
  }
  int w4 = tx_w(txSz) >> 2, h4 = tx_h(txSz) >> 2;
  if (split) {
    int sub = kSplitTxSize[txSz];
    int stepW = tx_w(sub) >> 2, stepH = tx_h(sub) >> 2;
    for (int i = 0; i < h4; i += stepH)
      for (int j = 0; j < w4; j += stepW) read_var_tx_size(row + i, col + j, sub, depth + 1);
  } else {
    for (int i = 0; i < h4; i++)
      for (int j = 0; j < w4; j++) interTxSizes[mi(row + i, col + j)] = (uint8_t)txSz;
    txSize = txSz;
    if (counts) counts->txfmSplit[depth]++;
  }
}

// tx_depth of read_tx_size.
template <typename Pixel>
void Decoder<Pixel>::read_tx_depth() {
  int maxTxWidth = tx_w(txSize), maxTxHeight = tx_h(txSize);
  int aboveW = 0, leftH = 0;
  if (availU) {
    int m = mi(miRow - 1, miCol);
    aboveW = blockKinds[m] == kIntrabc ? 4 * block_w4(miSizes[m]) : above_tx_width(miRow, miCol);
  }
  if (availL) {
    int m = mi(miRow, miCol - 1);
    leftH = blockKinds[m] == kIntrabc ? 4 * block_h4(miSizes[m]) : left_tx_height(miRow, miCol);
  }
  int ctx = (aboveW >= maxTxWidth) + (leftH >= maxTxHeight);
  int depth;
  switch (kMaxTxDepth[miSize]) {
    case 1: depth = sd.symbol(cdf.tx8x8[ctx], 2); break;
    case 2: depth = sd.symbol(cdf.tx16x16[ctx], 3); break;
    case 3: depth = sd.symbol(cdf.tx32x32[ctx], 3); break;
    default: depth = sd.symbol(cdf.tx64x64[ctx], 3); break;
  }
  for (int i = 0; i < depth; i++) txSize = kSplitTxSize[txSize];
}

template <typename Pixel>
void Decoder<Pixel>::reset_block_context(int bw4, int bh4) {
  for (int plane = 0; plane < 1 + 2 * hasChroma; plane++) {
    int sx = plane ? subX : 0, sy = plane ? subY : 0;
    for (int i = miCol >> sx; i < ((miCol + bw4) >> sx); i++) aboveLevel[plane][i] = aboveDc[plane][i] = 0;
    for (int i = miRow >> sy; i < ((miRow + bh4) >> sy); i++) leftLevel[plane][i] = leftDc[plane][i] = 0;
  }
}

template <typename Pixel>
void Decoder<Pixel>::residual() {
  int widthChunks = std::max(1, block_w4(miSize) >> 4);
  int heightChunks = std::max(1, block_h4(miSize) >> 4);
  int miSizeChunk = (widthChunks > 1 || heightChunks > 1) ? BLOCK_64X64 : miSize;
  for (int chunkY = 0; chunkY < heightChunks; chunkY++) {
    for (int chunkX = 0; chunkX < widthChunks; chunkX++) {
      for (int plane = 0; plane < 1 + hasChroma * 2; plane++) {
        int sx = plane ? subX : 0, sy = plane ? subY : 0;
        if (useIntrabc && !lossless && !plane) {
          int planeSz = get_plane_residual_size(miSizeChunk, 0, 0, 0);
          transform_tree((miCol + (chunkX << 4)) * 4, (miRow + (chunkY << 4)) * 4, 4 * block_w4(planeSz),
                         4 * block_h4(planeSz));
          continue;
        }
        int txSz;
        if (lossless) {
          txSz = TX_4X4;
        } else if (plane == 0) {
          txSz = txSize;
        } else {
          // get_tx_size(): the largest transform of the chroma residual, 64 cut to 32.
          int uvTx = kMaxTxSizeRect[get_plane_residual_size(miSize, plane, sx, sy)];
          if (tx_w(uvTx) == 64 || tx_h(uvTx) == 64) {
            if (tx_w(uvTx) == 16) uvTx = TX_16X32;
            else if (tx_h(uvTx) == 16) uvTx = TX_32X16;
            else uvTx = TX_32X32;
          }
          txSz = uvTx;
        }
        int stepX = tx_w(txSz) >> 2, stepY = tx_h(txSz) >> 2;
        int planeSz = get_plane_residual_size(miSizeChunk, plane, sx, sy);
        int num4x4W = block_w4(planeSz), num4x4H = block_h4(planeSz);
        int baseX = (miCol >> sx) * 4, baseY = (miRow >> sy) * 4;
        for (int y = 0; y < num4x4H; y += stepY)
          for (int x = 0; x < num4x4W; x += stepX)
            transform_block(plane, baseX, baseY, txSz, x + ((chunkX << 4) >> sx), y + ((chunkY << 4) >> sy));
      }
    }
  }
}

// The luma transform blocks of an inter block, InterTxSizes' tree.
template <typename Pixel>
void Decoder<Pixel>::transform_tree(int startX, int startY, int w, int h) {
  if (startX >= fh.miCols * 4 || startY >= fh.miRows * 4) return;
  int txSz = interTxSizes[mi(startY >> 2, startX >> 2)];
  if (w <= tx_w(txSz) && h <= tx_h(txSz)) {
    transform_block(0, startX, startY, txSz, 0, 0);
  } else if (w > h) {
    transform_tree(startX, startY, w / 2, h);
    transform_tree(startX + w / 2, startY, w / 2, h);
  } else if (w < h) {
    transform_tree(startX, startY, w, h / 2);
    transform_tree(startX, startY + h / 2, w, h / 2);
  } else {
    transform_tree(startX, startY, w / 2, h / 2);
    transform_tree(startX + w / 2, startY, w / 2, h / 2);
    transform_tree(startX, startY + h / 2, w / 2, h / 2);
    transform_tree(startX + w / 2, startY + h / 2, w / 2, h / 2);
  }
}

template <typename Pixel>
void Decoder<Pixel>::transform_block(int plane, int baseX, int baseY, int txSz, int x, int y) {
  int startX = baseX + 4 * x, startY = baseY + 4 * y;
  int sx = plane ? subX : 0, sy = plane ? subY : 0;
  int row = (startY << sy) >> 2, col = (startX << sx) >> 2;
  int sbMask = seq.use128 ? 31 : 15;
  int subBlockMiRow = row & sbMask, subBlockMiCol = col & sbMask;
  int stepX = tx_w(txSz) >> 2, stepY = tx_h(txSz) >> 2;
  int maxX = (fh.miCols * 4) >> sx, maxY = (fh.miRows * 4) >> sy;
  if (startX >= maxX || startY >= maxY) return;
  if (useIntrabc) {
    // predict_inter predicted the whole block (decode_block)
  } else if ((plane == 0 && paletteSizeY) || (plane != 0 && paletteSizeUV)) {
    predict_palette(plane, startX, startY, x, y, txSz);
  } else {
    int isCfl = plane > 0 && uvMode == UV_CFL_PRED;
    int mode = plane == 0 ? yMode : (isCfl ? DC_PRED : uvMode);
    int log2W = kTxWidthLog2[txSz], log2H = kTxHeightLog2[txSz];
    int by = (subBlockMiRow >> sy), bx = (subBlockMiCol >> sx);
    predict_intra(plane, startX, startY, (plane == 0 ? availL : availLChroma) || x > 0,
                  (plane == 0 ? availU : availUChroma) || y > 0, blockDecoded[plane][by - 1 + 1][bx + stepX + 1],
                  blockDecoded[plane][by + stepY + 1][bx - 1 + 1], mode, log2W, log2H);
    if (isCfl) predict_cfl(plane, startX, startY, txSz);
  }
  if (plane == 0) {
    maxLumaW = startX + stepX * 4;
    maxLumaH = startY + stepY * 4;
  }
  if (!skip) {
    int eob = coeffs(startX, startY, plane, txSz);
    if (eob > 0) reconstruct(plane, startX, startY, txSz);
  }
  int n4w = (int)(aboveLevel[plane].size());
  for (int i = 0; i < stepY; i++) {
    for (int j = 0; j < stepX; j++) {
      lfTxSizes[plane][(size_t)((row >> sy) + i) * n4w + (col >> sx) + j] = (uint8_t)txSz;
      blockDecoded[plane][(subBlockMiRow >> sy) + i + 1][(subBlockMiCol >> sx) + j + 1] = 1;
    }
  }
  if (counts && plane == 0) counts->txSize[txSz]++;
}

template <typename Pixel>
int Decoder<Pixel>::coeffs(int startX, int startY, int plane, int txSz) {
  int x4 = startX >> 2, y4 = startY >> 2;
  int w4 = tx_w(txSz) >> 2, h4 = tx_h(txSz) >> 2;
  int sx = plane ? subX : 0, sy = plane ? subY : 0;
  int txSzCtx = (kTxSizeSqr[txSz] + kTxSizeSqrUp[txSz] + 1) >> 1;
  int ptype = plane > 0;
  int segEob = (txSz == TX_16X64 || txSz == TX_64X16) ? 512 : std::min(1024, tx_w(txSz) * tx_h(txSz));
  std::memset(quant, 0, sizeof(int32_t) * segEob);
  int eob = 0, culLevel = 0, dcCategory = 0;
  int maxX4 = fh.miCols >> sx, maxY4 = fh.miRows >> sy;
  int w = tx_w(txSz), h = tx_h(txSz);
  int bsize = get_plane_residual_size(miSize, plane, sx, sy);
  int ctx;
  if (plane == 0) {
    int top = 0, left = 0;
    for (int k = 0; k < w4; k++)
      if (x4 + k < maxX4) top = std::max(top, (int)aboveLevel[plane][x4 + k]);
    for (int k = 0; k < h4; k++)
      if (y4 + k < maxY4) left = std::max(left, (int)leftLevel[plane][y4 + k]);
    top = std::min(top, 255);
    left = std::min(left, 255);
    if (4 * block_w4(bsize) == w && 4 * block_h4(bsize) == h)
      ctx = 0;
    else if (top == 0 && left == 0)
      ctx = 1;
    else if (top == 0 || left == 0)
      ctx = 2 + (std::max(top, left) > 3);
    else if (std::max(top, left) <= 3)
      ctx = 4;
    else if (std::min(top, left) <= 3)
      ctx = 5;
    else
      ctx = 6;
  } else {
    int above = 0, left = 0;
    for (int i = 0; i < w4; i++)
      if (x4 + i < maxX4) above |= aboveLevel[plane][x4 + i] | aboveDc[plane][x4 + i];
    for (int i = 0; i < h4; i++)
      if (y4 + i < maxY4) left |= leftLevel[plane][y4 + i] | leftDc[plane][y4 + i];
    ctx = (above != 0) + (left != 0) + 7;
    if (4 * block_w4(bsize) * 4 * block_h4(bsize) > w * h) ctx += 3;
  }
  int allZero = sd.symbol(cdf.txbSkip[txSzCtx][ctx], 2);
  if (allZero && plane == 0 && useIntrabc) {
    for (int i = 0; i < h4; i++) std::memset(&txTypes[y4 + i - miRow][x4 - miCol], DCT_DCT, w4);
  }
  if (!allZero) {
    int txSet = get_tx_set(txSz, fh.reducedTxSet, useIntrabc);
    if (plane == 0) {
      // transform_type()
      int txType = DCT_DCT;
      int qidx = fh.segmentationEnabled ? get_qindex(1, segmentId) : fh.baseQIdx;
      if (txSet > 0 && qidx > 0) {
        int sqr = kTxSizeSqr[txSz];
        if (useIntrabc) {
          if (txSet == TX_SET_INTER_1)
            txType = kTxTypeInterInvSet1[sd.symbol(cdf.interTxSet1[sqr], 16)];
          else if (txSet == TX_SET_INTER_2)
            txType = kTxTypeInterInvSet2[sd.symbol(cdf.interTxSet2, 12)];
          else
            txType = sd.symbol(cdf.interTxSet3[sqr], 2) ? DCT_DCT : IDTX;
        } else {
          int intraDir = useFilterIntra ? kFilterIntraModeToIntraDir[filterIntraMode] : yMode;
          if (txSet == TX_SET_INTRA_1)
            txType = kTxTypeIntraInvSet1[sd.symbol(cdf.intraTxSet1[sqr][intraDir], 7)];
          else
            txType = kTxTypeIntraInvSet2[sd.symbol(cdf.intraTxSet2[sqr][intraDir], 5)];
        }
      }
      planeTxType = txType;
      // TxTypes, which an intra block copy block's chroma reads
      if (useIntrabc)
        for (int i = 0; i < h4; i++) std::memset(&txTypes[y4 + i - miRow][x4 - miCol], txType, w4);
    }
    // compute_tx_type()
    if (lossless || kTxSizeSqrUp[txSz] > TX_32X32) {
      planeTxType = DCT_DCT;
    } else if (plane != 0) {
      int t = useIntrabc ? txTypes[std::max(miRow, y4 << sy) - miRow][std::max(miCol, x4 << sx) - miCol]
                         : kModeToTxfm[uvMode];
      planeTxType = in_set(txSet, t, useIntrabc) ? t : DCT_DCT;
    }
    if (counts && plane == 0) (useIntrabc ? counts->interTxType : counts->txType)[planeTxType]++;
    int txClass = get_tx_class(planeTxType);
    const int16_t* scan;
    if (txSz == TX_16X64)
      scan = default_scan(TX_16X32);
    else if (txSz == TX_64X16)
      scan = default_scan(TX_32X16);
    else if (kTxSizeSqrUp[txSz] == TX_64X64)
      scan = default_scan(TX_32X32);
    else if (planeTxType == IDTX)
      scan = default_scan(txSz);
    else if (txClass == TX_CLASS_VERT)
      scan = mrow_scan(txSz);
    else if (txClass == TX_CLASS_HORIZ)
      scan = mcol_scan(txSz);
    else
      scan = default_scan(txSz);
    int eobMultisize = std::min((int)kTxWidthLog2[txSz], 5) + std::min((int)kTxHeightLog2[txSz], 5) - 4;
    int ectx = txClass == TX_CLASS_2D ? 0 : 1;
    int eobPt;
    switch (eobMultisize) {
      case 0: eobPt = sd.symbol(cdf.eobPt16[ptype][ectx], 5) + 1; break;
      case 1: eobPt = sd.symbol(cdf.eobPt32[ptype][ectx], 6) + 1; break;
      case 2: eobPt = sd.symbol(cdf.eobPt64[ptype][ectx], 7) + 1; break;
      case 3: eobPt = sd.symbol(cdf.eobPt128[ptype][ectx], 8) + 1; break;
      case 4: eobPt = sd.symbol(cdf.eobPt256[ptype][ectx], 9) + 1; break;
      case 5: eobPt = sd.symbol(cdf.eobPt512[ptype], 10) + 1; break;
      default: eobPt = sd.symbol(cdf.eobPt1024[ptype], 11) + 1; break;
    }
    eob = eobPt < 2 ? eobPt : (1 << (eobPt - 2)) + 1;
    int eobShift = eobPt - 3;
    if (eobShift >= 0) {
      if (sd.symbol(cdf.eobExtra[txSzCtx][ptype][eobPt - 3], 2)) eob += 1 << eobShift;
      for (int i = 1; i < std::max(0, eobPt - 2); i++) {
        eobShift = std::max(0, eobPt - 2) - 1 - i;
        if (sd.literal(1)) eob += 1 << eobShift;
      }
    }
    int adj = kAdjustedTxSize[txSz];
    int bwl = kTxWidthLog2[adj];
    int txw = tx_w(adj), txh = tx_h(adj);
    for (int c = eob - 1; c >= 0; c--) {
      int pos = scan[c];
      int level;
      int row = pos >> bwl, col = pos - (row << bwl);
      if (c == eob - 1) {
        int ectx2 = c == 0 ? 0 : c <= (txh * txw) / 8 ? 1 : c <= (txh * txw) / 4 ? 2 : 3;
        level = sd.symbol(cdf.coeffBaseEob[txSzCtx][ptype][ectx2], 3) + 1;
      } else {
        int bctx;
        if (txClass == TX_CLASS_2D && row == 0 && col == 0) {
          bctx = 0;
        } else {
          int mag = 0;
          for (int idx = 0; idx < 5; idx++) {
            int refRow = row + kSigRefDiffOffset[txClass][idx][0];
            int refCol = col + kSigRefDiffOffset[txClass][idx][1];
            if (refRow >= 0 && refCol >= 0 && refRow < txh && refCol < (1 << bwl))
              mag += std::min(std::abs(quant[(refRow << bwl) + refCol]), 3);
          }
          int cctx = std::min((mag + 1) >> 1, 4);
          if (txClass == TX_CLASS_2D) {
            bctx = cctx + kCoeffBaseCtxOffset[txSz][std::min(row, 4)][std::min(col, 4)];
          } else {
            int idx = txClass == TX_CLASS_VERT ? row : col;
            static const int kPosOffset[3] = {26, 31, 36};
            bctx = cctx + kPosOffset[std::min(idx, 2)];
          }
        }
        level = sd.symbol(cdf.coeffBase[txSzCtx][ptype][bctx], 4);
      }
      if (level > 2) {
        int mag = 0;
        for (int idx = 0; idx < 3; idx++) {
          int refRow = row + kMagRefOffset[txClass][idx][0];
          int refCol = col + kMagRefOffset[txClass][idx][1];
          if (refRow >= 0 && refCol >= 0 && refRow < txh && refCol < (1 << bwl))
            mag += std::min(quant[refRow * txw + refCol], 15);
        }
        mag = std::min((mag + 1) >> 1, 6);
        int brctx;
        if (pos == 0)
          brctx = mag;
        else if (txClass == TX_CLASS_2D)
          brctx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
        else if (txClass == TX_CLASS_HORIZ)
          brctx = col == 0 ? mag + 7 : mag + 14;
        else
          brctx = row == 0 ? mag + 7 : mag + 14;
        for (int idx = 0; idx < 4; idx++) {
          int br = sd.symbol(cdf.coeffBr[std::min(txSzCtx, 3)][ptype][brctx], 4);
          level += br;
          if (br < 3) break;
        }
      }
      quant[pos] = level;
    }
    for (int c = 0; c < eob; c++) {
      int pos = scan[c];
      int sign = 0;
      if (quant[pos] != 0) {
        if (c == 0) {
          int dcSign = 0;
          for (int k = 0; k < w4; k++) {
            if (x4 + k < maxX4) {
              int s = aboveDc[plane][x4 + k];
              if (s == 1) dcSign--;
              else if (s == 2) dcSign++;
            }
          }
          for (int k = 0; k < h4; k++) {
            if (y4 + k < maxY4) {
              int s = leftDc[plane][y4 + k];
              if (s == 1) dcSign--;
              else if (s == 2) dcSign++;
            }
          }
          int sctx = dcSign < 0 ? 1 : dcSign > 0 ? 2 : 0;
          sign = sd.symbol(cdf.dcSign[ptype][sctx], 2);
        } else {
          sign = sd.literal(1);
        }
      }
      if (quant[pos] > 14) {
        // read_golomb as dav1d reads it: at most 32 zero bits.
        int length = 0;
        while (!sd.literal(1) && length < 32) length++;
        uint32_t x = 1;
        for (int i = 0; i < length; i++) x = (x << 1) | (uint32_t)sd.literal(1);
        quant[pos] = (int32_t)((x - 1 + 15) & 0xFFFFF);
      }
      if (pos == 0 && quant[pos] > 0) dcCategory = sign ? 1 : 2;
      quant[pos] &= 0xFFFFF;
      culLevel += quant[pos];
      if (sign) quant[pos] = -quant[pos];
    }
    culLevel = std::min(63, culLevel);
  }
  for (int i = 0; i < w4; i++) {
    aboveLevel[plane][x4 + i] = (uint8_t)culLevel;
    aboveDc[plane][x4 + i] = (uint8_t)dcCategory;
  }
  for (int i = 0; i < h4; i++) {
    leftLevel[plane][y4 + i] = (uint8_t)culLevel;
    leftDc[plane][y4 + i] = (uint8_t)dcCategory;
  }
  return eob;
}

template <typename Pixel>
void Decoder<Pixel>::reconstruct(int plane, int startX, int startY, int txSz) {
  int w = tx_w(txSz), h = tx_h(txSz);
  int pels = w * h;
  int dqDenom = (pels > 256) + (pels > 1024);
  int tw = std::min(32, w), th = std::min(32, h);
  int qindex = get_qindex(0, segmentId);
  int dcDelta = plane == 0 ? fh.deltaQYDc : plane == 1 ? fh.deltaQUDc : fh.deltaQVDc;
  int acDelta = plane == 0 ? 0 : plane == 1 ? fh.deltaQUAc : fh.deltaQVAc;
  int dcQ = kDcQLookup[depth_shift() >> 1][clip3(0, 255, qindex + dcDelta)];
  int acQ = kAcQLookup[depth_shift() >> 1][clip3(0, 255, qindex + acDelta)];
  int64_t dqMax = ((int64_t)1 << (7 + bitDepth)) - 1;
  for (int i = 0; i < 32; i++)
    for (int j = 0; j < 32; j++) dequant[i][j] = 0;
  for (int i = 0; i < th; i++) {
    for (int j = 0; j < tw; j++) {
      int32_t q = quant[i * tw + j];
      if (!q) continue;
      int64_t mag = q < 0 ? -(int64_t)q : q;
      int64_t dq = (mag * (i == 0 && j == 0 ? dcQ : acQ)) & 0xFFFFFF;
      dq >>= dqDenom;
      if (q < 0) dq = -dq;
      dequant[i][j] = (int32_t)std::max<int64_t>(-dqMax - 1, std::min<int64_t>(dqMax, dq));
    }
  }
  static thread_local int32_t residual[64 * 64];
  inverse_transform_2d(dequant, txSz, planeTxType, lossless, bitDepth, residual);
  int flipUD = planeTxType == FLIPADST_DCT || planeTxType == FLIPADST_ADST || planeTxType == V_FLIPADST ||
               planeTxType == FLIPADST_FLIPADST;
  int flipLR = planeTxType == DCT_FLIPADST || planeTxType == ADST_FLIPADST || planeTxType == H_FLIPADST ||
               planeTxType == FLIPADST_FLIPADST;
  int maxV = pixel_max();
  for (int i = 0; i < h; i++) {
    int yy = flipUD ? h - i - 1 : i;
    Pixel* dst = &px(plane, startY + yy, startX);
    for (int j = 0; j < w; j++) {
      int xx = flipLR ? w - j - 1 : j;
      dst[xx] = (Pixel)clip3(0, maxV, dst[xx] + residual[i * w + j]);
    }
  }
}

template struct Decoder<uint8_t>;
template struct Decoder<uint16_t>;

}  // namespace av1
}  // namespace byogan
