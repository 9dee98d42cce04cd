// Partitions and the intra mode info of a block (AV1 specification 5.11.4-
// 5.11.46 for an intra frame): segment ids, skip, CDEF indices, delta q and
// delta lf, use_intrabc (av1_intrabc.cpp reads the rest of such a block),
// the luma and chroma modes with their angle deltas and CfL alphas, filter
// intra, palette sizes, colours of BitDepth bits and colour-index maps, and
// the loop restoration units each superblock reads.

#include <algorithm>

#include "av1_decoder.h"

namespace byogan {
namespace av1 {

namespace {

const uint8_t kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int8_t kPaletteColorContext[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};

int neg_deinterleave(int diff, int ref, int max) {
  if (!ref) return diff;
  if (ref >= max - 1) return max - diff - 1;
  if (2 * ref < max) {
    if (diff <= 2 * ref) return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
    return diff;
  }
  if (diff <= 2 * (max - ref - 1)) return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
  return max - (diff + 1);
}

int inverse_recenter(int r, int v) {
  if (v > 2 * r) return v;
  if (v & 1) return r - ((v + 1) >> 1);
  return r + (v >> 1);
}

int decode_subexp_bool(SymbolDecoder& sd, int numSyms, int k) {
  int i = 0, mk = 0;
  while (true) {
    int b2 = i ? k + i - 1 : k;
    int a = 1 << b2;
    if (numSyms <= mk + 3 * a) return sd.ns(numSyms - mk) + mk;
    if (sd.literal(1)) {
      i++;
      mk += a;
    } else {
      return sd.literal(b2) + mk;
    }
  }
}

int decode_signed_subexp_with_ref_bool(SymbolDecoder& sd, int low, int high, int k, int r) {
  int mx = high - low;
  r -= low;
  int v = decode_subexp_bool(sd, mx, k);
  int x = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
  return x + low;
}

}  // namespace

template <typename Pixel>
void Decoder<Pixel>::read_lr(int r, int c, int bSize) {
  int w = block_w4(bSize), h = block_h4(bSize);
  for (int plane = 0; plane < numPlanes; plane++) {
    if (fh.frameRestorationType[plane] == RESTORE_NONE) continue;
    int sx = plane ? subX : 0, sy = plane ? subY : 0;
    int unitSize = fh.loopRestorationSize[plane];
    int unitRows = lrUnitRows[plane], unitCols = lrUnitCols[plane];
    int unitRowStart = (r * (4 >> sy) + unitSize - 1) / unitSize;
    int unitRowEnd = std::min(unitRows, ((r + h) * (4 >> sy) + unitSize - 1) / unitSize);
    int numerator = 4 >> sx, denominator = unitSize;
    int unitColStart = (c * numerator + denominator - 1) / denominator;
    int unitColEnd = std::min(unitCols, ((c + w) * numerator + denominator - 1) / denominator);
    for (int unitRow = unitRowStart; unitRow < unitRowEnd; unitRow++) {
      for (int unitCol = unitColStart; unitCol < unitColEnd; unitCol++) {
        size_t u = (size_t)unitRow * unitCols + unitCol;
        int type;
        if (fh.frameRestorationType[plane] == RESTORE_WIENER)
          type = sd.symbol(cdf.useWiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
        else if (fh.frameRestorationType[plane] == RESTORE_SGRPROJ)
          type = sd.symbol(cdf.useSgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
        else
          type = sd.symbol(cdf.restorationType, 3);
        lrType[plane][u] = (uint8_t)type;
        if (counts) counts->lrType[type]++;
        if (type == RESTORE_WIENER) {
          for (int pass = 0; pass < 2; pass++) {
            int firstCoeff = 0;
            if (plane) {
              firstCoeff = 1;
              lrWiener[plane][u * 6 + pass * 3] = 0;
            }
            for (int j = firstCoeff; j < 3; j++) {
              int v = decode_signed_subexp_with_ref_bool(sd, kWienerTapsMin[j], kWienerTapsMax[j] + 1, kWienerTapsK[j],
                                                         refLrWiener[plane][pass][j]);
              lrWiener[plane][u * 6 + pass * 3 + j] = (int8_t)v;
              refLrWiener[plane][pass][j] = v;
            }
          }
        } else if (type == RESTORE_SGRPROJ) {
          int set = sd.literal(4);
          lrSgrSet[plane][u] = (uint8_t)set;
          for (int i = 0; i < 2; i++) {
            int radius = kSgrParams[set][i * 2];
            int mn = kSgrprojXqdMin[i], mx = kSgrprojXqdMax[i];
            int v;
            if (radius) {
              v = decode_signed_subexp_with_ref_bool(sd, mn, mx + 1, 4, refSgrXqd[plane][i]);
            } else {
              v = 0;
              if (i == 1) v = clip3(mn, mx, (1 << 7) - refSgrXqd[plane][0]);
            }
            lrSgrXqd[plane][u * 2 + i] = (int16_t)v;
            refSgrXqd[plane][i] = v;
          }
        }
      }
    }
  }
}

template <typename Pixel>
void Decoder<Pixel>::decode_partition(int r, int c, int bSize) {
  if (r >= fh.miRows || c >= fh.miCols) return;
  int availUp = is_inside(r - 1, c), availLeft = is_inside(r, c - 1);
  int num4x4 = block_w4(bSize);
  int halfBlock4x4 = num4x4 >> 1, quarterBlock4x4 = halfBlock4x4 >> 1;
  int hasRows = (r + halfBlock4x4) < fh.miRows;
  int hasCols = (c + halfBlock4x4) < fh.miCols;
  int partition;
  if (bSize < BLOCK_8X8) {
    partition = PARTITION_NONE;
  } else {
    int bsl = kBlockWidthLog2[bSize];
    int above = availUp && (kBlockWidthLog2[miSizes[mi(r - 1, c)]] < bsl);
    int left = availLeft && (kBlockHeightLog2[miSizes[mi(r, c - 1)]] < bsl);
    int ctx = left * 2 + above;
    uint16_t* pcdf;
    int n;
    switch (bsl) {
      case 1: pcdf = cdf.partitionW8[ctx]; n = 4; break;
      case 2: pcdf = cdf.partitionW16[ctx]; n = 10; break;
      case 3: pcdf = cdf.partitionW32[ctx]; n = 10; break;
      case 4: pcdf = cdf.partitionW64[ctx]; n = 10; break;
      default: pcdf = cdf.partitionW128[ctx]; n = 8; break;
    }
    if (hasRows && hasCols) {
      partition = sd.symbol(pcdf, n);
    } else if (hasCols || hasRows) {
      auto prob = [&](int k) { return (k < n ? pcdf[k] : 32768) - (k > 0 ? (k - 1 < n ? pcdf[k - 1] : 32768) : 0); };
      int psum;
      // The partitions a missing bottom half (split_or_horz) or right half
      // (split_or_vert) turns into a split.
      if (hasCols) {  // split_or_horz
        psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) +
               prob(PARTITION_VERT_B) + (bSize != BLOCK_128X128 ? prob(PARTITION_VERT_4) : 0);
      } else {  // split_or_vert
        psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) +
               prob(PARTITION_VERT_A) + (bSize != BLOCK_128X128 ? prob(PARTITION_HORZ_4) : 0);
      }
      // The specification reads the bool with the CDF {32768 - psum, 32768}, not adapted.
      uint16_t tmp[3] = {(uint16_t)((1 << 15) - psum), 1 << 15, 0};
      bool u = sd.update;
      sd.update = false;
      int v = sd.symbol(tmp, 2);
      sd.update = u;
      partition = v ? PARTITION_SPLIT : (hasCols ? PARTITION_HORZ : PARTITION_VERT);
    } else {
      partition = PARTITION_SPLIT;
    }
  }
  if (counts && bSize >= BLOCK_8X8) counts->partition[partition]++;
  int subSize = kPartitionSubsize[partition][bSize];
  // A partition whose blocks have no chroma size in this subsampling breaks
  // the specification's rule, and libaom and dav1d refuse the frame.
  if (numPlanes > 1 && get_plane_residual_size(subSize, 1, subX, subY) == BLOCK_INVALID) fail(kFaultBroken);
  int splitSize = kPartitionSubsize[PARTITION_SPLIT][bSize];
  switch (partition) {
    case PARTITION_NONE: decode_block(r, c, subSize); break;
    case PARTITION_HORZ:
      decode_block(r, c, subSize);
      if (hasRows) decode_block(r + halfBlock4x4, c, subSize);
      break;
    case PARTITION_VERT:
      decode_block(r, c, subSize);
      if (hasCols) decode_block(r, c + halfBlock4x4, subSize);
      break;
    case PARTITION_SPLIT:
      decode_partition(r, c, subSize);
      decode_partition(r, c + halfBlock4x4, subSize);
      decode_partition(r + halfBlock4x4, c, subSize);
      decode_partition(r + halfBlock4x4, c + halfBlock4x4, subSize);
      break;
    case PARTITION_HORZ_A:
      decode_block(r, c, splitSize);
      decode_block(r, c + halfBlock4x4, splitSize);
      decode_block(r + halfBlock4x4, c, subSize);
      break;
    case PARTITION_HORZ_B:
      decode_block(r, c, subSize);
      decode_block(r + halfBlock4x4, c, splitSize);
      decode_block(r + halfBlock4x4, c + halfBlock4x4, splitSize);
      break;
    case PARTITION_VERT_A:
      decode_block(r, c, splitSize);
      decode_block(r + halfBlock4x4, c, splitSize);
      decode_block(r, c + halfBlock4x4, subSize);
      break;
    case PARTITION_VERT_B:
      decode_block(r, c, subSize);
      decode_block(r, c + halfBlock4x4, splitSize);
      decode_block(r + halfBlock4x4, c + halfBlock4x4, splitSize);
      break;
    case PARTITION_HORZ_4:
      for (int i = 0; i < 4; i++)
        if (i < 3 || r + quarterBlock4x4 * 3 < fh.miRows) decode_block(r + quarterBlock4x4 * i, c, subSize);
      break;
    default:  // PARTITION_VERT_4
      for (int i = 0; i < 4; i++)
        if (i < 3 || c + quarterBlock4x4 * 3 < fh.miCols) decode_block(r, c + quarterBlock4x4 * i, subSize);
      break;
  }
}

// Subsampled_Size: the residual size of a block in a chroma plane of
// subsampling (sx, sy), BLOCK_INVALID where the specification forbids the
// partition (in 4:2:2, the blocks twice as tall as wide).
static int plane_residual_size(int bs, int sx, int sy) {
  static const uint8_t kSs[BLOCK_SIZES][2][2] = {
      {{BLOCK_4X4, BLOCK_4X4}, {BLOCK_4X4, BLOCK_4X4}},
      {{BLOCK_4X8, BLOCK_4X4}, {BLOCK_INVALID, BLOCK_4X4}},
      {{BLOCK_8X4, BLOCK_INVALID}, {BLOCK_4X4, BLOCK_4X4}},
      {{BLOCK_8X8, BLOCK_8X4}, {BLOCK_4X8, BLOCK_4X4}},
      {{BLOCK_8X16, BLOCK_8X8}, {BLOCK_INVALID, BLOCK_4X8}},
      {{BLOCK_16X8, BLOCK_INVALID}, {BLOCK_8X8, BLOCK_8X4}},
      {{BLOCK_16X16, BLOCK_16X8}, {BLOCK_8X16, BLOCK_8X8}},
      {{BLOCK_16X32, BLOCK_16X16}, {BLOCK_INVALID, BLOCK_8X16}},
      {{BLOCK_32X16, BLOCK_INVALID}, {BLOCK_16X16, BLOCK_16X8}},
      {{BLOCK_32X32, BLOCK_32X16}, {BLOCK_16X32, BLOCK_16X16}},
      {{BLOCK_32X64, BLOCK_32X32}, {BLOCK_INVALID, BLOCK_16X32}},
      {{BLOCK_64X32, BLOCK_INVALID}, {BLOCK_32X32, BLOCK_32X16}},
      {{BLOCK_64X64, BLOCK_64X32}, {BLOCK_32X64, BLOCK_32X32}},
      {{BLOCK_64X128, BLOCK_64X64}, {BLOCK_INVALID, BLOCK_32X64}},
      {{BLOCK_128X64, BLOCK_INVALID}, {BLOCK_64X64, BLOCK_64X32}},
      {{BLOCK_128X128, BLOCK_128X64}, {BLOCK_64X128, BLOCK_64X64}},
      {{BLOCK_4X16, BLOCK_4X8}, {BLOCK_INVALID, BLOCK_4X8}},
      {{BLOCK_16X4, BLOCK_INVALID}, {BLOCK_8X4, BLOCK_8X4}},
      {{BLOCK_8X32, BLOCK_8X16}, {BLOCK_INVALID, BLOCK_4X16}},
      {{BLOCK_32X8, BLOCK_INVALID}, {BLOCK_16X8, BLOCK_16X4}},
      {{BLOCK_16X64, BLOCK_16X32}, {BLOCK_INVALID, BLOCK_8X32}},
      {{BLOCK_64X16, BLOCK_INVALID}, {BLOCK_32X16, BLOCK_32X8}},
  };
  return kSs[bs][sx][sy];
}

int get_plane_residual_size(int bs, int plane, int sx, int sy) {
  return plane ? plane_residual_size(bs, sx, sy) : bs;
}

template <typename Pixel>
void Decoder<Pixel>::decode_block(int r, int c, int subSize) {
  miRow = r;
  miCol = c;
  miSize = subSize;
  int bw4 = block_w4(subSize), bh4 = block_h4(subSize);
  if (bh4 == 1 && subY && (miRow & 1) == 0)
    hasChroma = 0;
  else if (bw4 == 1 && subX && (miCol & 1) == 0)
    hasChroma = 0;
  else
    hasChroma = numPlanes > 1;
  availU = is_inside(r - 1, c);
  availL = is_inside(r, c - 1);
  availUChroma = availU;
  availLChroma = availL;
  if (hasChroma) {
    if (subY && bh4 == 1) availUChroma = is_inside(r - 2, c);
    if (subX && bw4 == 1) availLChroma = is_inside(r, c - 2);
  } else {
    availUChroma = availLChroma = 0;
  }
  intra_frame_mode_info();
  palette_tokens();
  read_block_tx_size();
  if (skip) reset_block_context(bw4, bh4);
  for (int y = 0; y < bh4; y++) {
    for (int x = 0; x < bw4; x++) {
      int m = mi(r + y, c + x);
      yModes[m] = (uint8_t)yMode;
      if (hasChroma) uvModes[m] = (uint8_t)uvMode;
      if (fh.allowIntrabc) {
        blockKinds[m] = useIntrabc ? kIntrabc : kIntra;
        mvs[(size_t)m * 2] = mv[0];
        mvs[(size_t)m * 2 + 1] = mv[1];
      }
      skips[m] = (uint8_t)skip;
      miSizes[m] = (uint8_t)miSize;
      segmentIds[m] = (uint8_t)segmentId;
      paletteSizes[0][m] = (uint8_t)paletteSizeY;
      paletteSizes[1][m] = (uint8_t)paletteSizeUV;
      for (int i = 0; i < paletteSizeY; i++) paletteColors[0][(size_t)m * 8 + i] = paletteColorsY[i];
      for (int i = 0; i < paletteSizeUV; i++) paletteColors[1][(size_t)m * 8 + i] = paletteColorsU[i];
      for (int i = 0; i < 4; i++) deltaLFs[(size_t)m * 4 + i] = (int8_t)deltaLF[i];
    }
  }
  if (useIntrabc) {
    // compute_prediction: in an intra frame every block's RefFrame[0] is
    // INTRA_FRAME, so each plane is one prediction of the plane's residual
    // size with this block's vector (sub-8x8 chroma too).
    for (int plane = 0; plane < 1 + 2 * hasChroma; plane++) {
      int sx = plane ? subX : 0, sy = plane ? subY : 0;
      int planeSz = get_plane_residual_size(miSize, plane, sx, sy);
      predict_inter(plane, (miCol >> sx) * 4, (miRow >> sy) * 4, 4 * block_w4(planeSz), 4 * block_h4(planeSz));
    }
  }
  residual();
}

template <typename Pixel>
void Decoder<Pixel>::read_cdef() {
  if (skip || fh.codedLossless || !seq.enableCdef || fh.allowIntrabc) return;
  int r = miRow & ~15, c = miCol & ~15;
  int8_t& idx = cdefIdx[(r >> 4) * cdefStride + (c >> 4)];
  if (idx == -1) {
    idx = (int8_t)sd.literal(fh.cdefBits);
    int w4 = block_w4(miSize), h4 = block_h4(miSize);
    for (int y = r; y < r + h4; y += 16)
      for (int x = c; x < c + w4; x += 16) cdefIdx[(y >> 4) * cdefStride + (x >> 4)] = idx;
  }
}

template <typename Pixel>
void Decoder<Pixel>::intra_frame_mode_info() {
  skip = 0;
  // intra_segment_id(), read_skip()
  auto read_segment_id = [&]() {
    int prevUL = -1, prevU = -1, prevL = -1;
    if (availU && availL) prevUL = segmentIds[mi(miRow - 1, miCol - 1)];
    if (availU) prevU = segmentIds[mi(miRow - 1, miCol)];
    if (availL) prevL = segmentIds[mi(miRow, miCol - 1)];
    int pred;
    if (prevU == -1)
      pred = prevL == -1 ? 0 : prevL;
    else if (prevL == -1)
      pred = prevU;
    else
      pred = prevUL == prevU ? prevU : prevL;
    if (skip) {
      segmentId = pred;
      return;
    }
    int ctx;
    if (prevUL < 0)
      ctx = 0;
    else if (prevUL == prevU && prevUL == prevL)
      ctx = 2;
    else if (prevUL == prevU || prevUL == prevL || prevU == prevL)
      ctx = 1;
    else
      ctx = 0;
    int s = sd.symbol(cdf.segmentId[ctx], 8);
    segmentId = clip3(0, fh.lastActiveSegId, neg_deinterleave(s, pred, fh.lastActiveSegId + 1));
  };
  auto intra_segment_id = [&]() {
    if (fh.segmentationEnabled)
      read_segment_id();
    else
      segmentId = 0;
    lossless = fh.losslessArray[segmentId];
  };
  if (fh.segIdPreSkip) intra_segment_id();
  if (fh.segIdPreSkip && fh.segmentationEnabled && fh.featureEnabled[segmentId][6]) {
    skip = 1;
  } else {
    int ctx = (availU ? skips[mi(miRow - 1, miCol)] : 0) + (availL ? skips[mi(miRow, miCol - 1)] : 0);
    skip = sd.symbol(cdf.skip[ctx], 2);
  }
  if (!fh.segIdPreSkip) intra_segment_id();
  read_cdef();
  // read_delta_qindex(), read_delta_lf()
  int sbSize = seq.use128 ? BLOCK_128X128 : BLOCK_64X64;
  if (!(miSize == sbSize && skip)) {
    if (readDeltas) {
      int deltaQAbs = sd.symbol(cdf.deltaQ, 4);
      if (deltaQAbs == 3) {
        int remBits = sd.literal(3) + 1;
        int absBits = sd.literal(remBits);
        deltaQAbs = absBits + (1 << remBits) + 1;
      }
      if (deltaQAbs) {
        int sign = sd.literal(1);
        int reduced = sign ? -deltaQAbs : deltaQAbs;
        currentQIndex = clip3(1, 255, currentQIndex + (reduced << fh.deltaQRes));
      }
      if (fh.deltaLfPresent) {
        int frameLfCount = 1;
        if (fh.deltaLfMulti) frameLfCount = numPlanes > 1 ? 4 : 2;
        for (int i = 0; i < frameLfCount; i++) {
          uint16_t* lcdf = fh.deltaLfMulti ? cdf.deltaLfMulti[i] : cdf.deltaLf;
          int deltaLfAbs = sd.symbol(lcdf, 4);
          if (deltaLfAbs == 3) {
            int n = sd.literal(3) + 1;
            int absBits = sd.literal(n);
            deltaLfAbs = absBits + (1 << n) + 1;
          }
          if (deltaLfAbs) {
            int sign = sd.literal(1);
            int reduced = sign ? -deltaLfAbs : deltaLfAbs;
            deltaLF[i] = clip3(-63, 63, deltaLF[i] + (reduced << fh.deltaLfRes));
          }
        }
      }
    }
  }
  readDeltas = 0;
  useIntrabc = fh.allowIntrabc ? sd.symbol(cdf.intrabc, 2) : 0;
  if (counts && fh.allowIntrabc) counts->useIntrabc[useIntrabc]++;
  useFilterIntra = 0;
  paletteSizeY = paletteSizeUV = 0;
  if (useIntrabc) {
    // An inter block of the BILINEAR filter, DC_PRED in the mode arrays.
    yMode = uvMode = DC_PRED;
    angleDeltaY = angleDeltaUV = 0;
    cflAlphaU = cflAlphaV = 0;
    intrabc_mode_info();
    return;
  }
  int aboveMode = availU ? yModes[mi(miRow - 1, miCol)] : DC_PRED;
  int leftMode = availL ? yModes[mi(miRow, miCol - 1)] : DC_PRED;
  yMode = sd.symbol(cdf.yMode[kIntraModeContext[aboveMode]][kIntraModeContext[leftMode]], 13);
  int useAngleDelta = miSize >= BLOCK_8X8;
  angleDeltaY = 0;
  if (useAngleDelta && yMode >= V_PRED && yMode <= D67_PRED) angleDeltaY = sd.symbol(cdf.angleDelta[yMode - V_PRED], 7) - 3;
  uvMode = DC_PRED;
  angleDeltaUV = 0;
  cflAlphaU = cflAlphaV = 0;
  if (hasChroma) {
    int cflAllowed;
    if (lossless)
      cflAllowed = plane_residual_size(miSize, subX, subY) == BLOCK_4X4;
    else
      cflAllowed = std::max(block_w4(miSize), block_h4(miSize)) <= 8;
    if (cflAllowed)
      uvMode = sd.symbol(cdf.uvModeCflAllowed[yMode], 14);
    else
      uvMode = sd.symbol(cdf.uvModeCflNotAllowed[yMode], 13);
    if (uvMode == UV_CFL_PRED) {
      int signs = sd.symbol(cdf.cflSign, 8);
      int signU = (signs + 1) / 3, signV = (signs + 1) % 3;
      if (signU) {
        int a = sd.symbol(cdf.cflAlpha[(signU - 1) * 3 + signV], 16) + 1;
        cflAlphaU = signU == 1 ? -a : a;
      }
      if (signV) {
        int a = sd.symbol(cdf.cflAlpha[(signV - 1) * 3 + signU], 16) + 1;
        cflAlphaV = signV == 1 ? -a : a;
      }
    }
    if (useAngleDelta && uvMode >= V_PRED && uvMode <= D67_PRED)
      angleDeltaUV = sd.symbol(cdf.angleDelta[uvMode - V_PRED], 7) - 3;
  }
  if (counts) {
    counts->yMode[yMode]++;
    if (hasChroma) counts->uvMode[uvMode]++;
  }
  if (miSize >= BLOCK_8X8 && block_w4(miSize) <= 16 && block_h4(miSize) <= 16 && fh.allowScreenContentTools)
    palette_mode_info();
  if (counts) {
    if (paletteSizeY) counts->paletteY[paletteSizeY]++;
    if (paletteSizeUV) counts->paletteUv[paletteSizeUV]++;
  }
  // filter_intra_mode_info()
  if (seq.enableFilterIntra && yMode == DC_PRED && paletteSizeY == 0 &&
      std::max(block_w4(miSize), block_h4(miSize)) <= 8) {
    useFilterIntra = sd.symbol(cdf.filterIntra[miSize], 2);
    if (useFilterIntra) {
      filterIntraMode = sd.symbol(cdf.filterIntraMode, 5);
      if (counts) counts->filterIntraMode[filterIntraMode]++;
    }
  }
}

template <typename Pixel>
void Decoder<Pixel>::palette_mode_info() {
  int maxVal = 1 << bitDepth;
  int bsizeCtx = kBlockWidthLog2[miSize] + kBlockHeightLog2[miSize] - 2;
  auto get_palette_cache = [&](int plane, Pixel* cache) {
    int aboveN = 0, leftN = 0;
    if (((miRow * 4) % 64) && availU) aboveN = paletteSizes[plane][mi(miRow - 1, miCol)];
    if (availL) leftN = paletteSizes[plane][mi(miRow, miCol - 1)];
    const Pixel* aboveC = &paletteColors[plane][(size_t)mi(miRow - 1, miCol) * 8];
    const Pixel* leftC = &paletteColors[plane][(size_t)mi(miRow, miCol - 1) * 8];
    int aboveIdx = 0, leftIdx = 0, n = 0;
    while (aboveIdx < aboveN && leftIdx < leftN) {
      int a = aboveC[aboveIdx], l = leftC[leftIdx];
      if (l < a) {
        if (n == 0 || l != cache[n - 1]) cache[n++] = (Pixel)l;
        leftIdx++;
      } else {
        if (n == 0 || a != cache[n - 1]) cache[n++] = (Pixel)a;
        aboveIdx++;
        if (l == a) leftIdx++;
      }
    }
    while (aboveIdx < aboveN) {
      int v = aboveC[aboveIdx++];
      if (n == 0 || v != cache[n - 1]) cache[n++] = (Pixel)v;
    }
    while (leftIdx < leftN) {
      int v = leftC[leftIdx++];
      if (n == 0 || v != cache[n - 1]) cache[n++] = (Pixel)v;
    }
    return n;
  };
  if (yMode == DC_PRED) {
    int ctx = 0;
    if (availU && paletteSizes[0][mi(miRow - 1, miCol)] > 0) ctx++;
    if (availL && paletteSizes[0][mi(miRow, miCol - 1)] > 0) ctx++;
    if (sd.symbol(cdf.paletteYMode[bsizeCtx][ctx], 2)) {
      paletteSizeY = sd.symbol(cdf.paletteYSize[bsizeCtx], 7) + 2;
      Pixel cache[16];
      int cacheN = get_palette_cache(0, cache);
      int idx = 0;
      for (int i = 0; i < cacheN && idx < paletteSizeY; i++)
        if (sd.literal(1)) paletteColorsY[idx++] = cache[i];
      if (idx < paletteSizeY) paletteColorsY[idx++] = (Pixel)sd.literal(bitDepth);
      int paletteBits = 0;
      if (idx < paletteSizeY) paletteBits = bitDepth - 3 + sd.literal(2);
      while (idx < paletteSizeY) {
        int delta = sd.literal(paletteBits) + 1;
        int v = std::min(maxVal - 1, paletteColorsY[idx - 1] + delta);
        paletteColorsY[idx] = (Pixel)v;
        int range = maxVal - v - 1;
        paletteBits = std::min(paletteBits, ceil_log2(range));
        idx++;
      }
      std::sort(paletteColorsY, paletteColorsY + paletteSizeY);
    }
  }
  if (hasChroma && uvMode == DC_PRED) {
    int ctx = paletteSizeY > 0;
    if (sd.symbol(cdf.paletteUvMode[ctx], 2)) {
      paletteSizeUV = sd.symbol(cdf.paletteUvSize[bsizeCtx], 7) + 2;
      Pixel cache[16];
      int cacheN = get_palette_cache(1, cache);
      int idx = 0;
      for (int i = 0; i < cacheN && idx < paletteSizeUV; i++)
        if (sd.literal(1)) paletteColorsU[idx++] = cache[i];
      if (idx < paletteSizeUV) paletteColorsU[idx++] = (Pixel)sd.literal(bitDepth);
      int paletteBits = 0;
      if (idx < paletteSizeUV) paletteBits = bitDepth - 3 + sd.literal(2);
      while (idx < paletteSizeUV) {
        int delta = sd.literal(paletteBits);
        int v = std::min(maxVal - 1, paletteColorsU[idx - 1] + delta);
        paletteColorsU[idx] = (Pixel)v;
        int range = maxVal - v;
        paletteBits = std::min(paletteBits, ceil_log2(range));
        idx++;
      }
      std::sort(paletteColorsU, paletteColorsU + paletteSizeUV);
      if (sd.literal(1)) {  // delta_encode_palette_colors_v
        int bits = bitDepth - 4 + sd.literal(2);
        paletteColorsV[0] = (Pixel)sd.literal(bitDepth);
        for (idx = 1; idx < paletteSizeUV; idx++) {
          int delta = sd.literal(bits);
          if (delta && sd.literal(1)) delta = -delta;
          int val = paletteColorsV[idx - 1] + delta;
          if (val < 0) val += maxVal;
          if (val >= maxVal) val -= maxVal;
          paletteColorsV[idx] = (Pixel)clip3(0, maxVal - 1, val);
        }
      } else {
        for (idx = 0; idx < paletteSizeUV; idx++) paletteColorsV[idx] = (Pixel)sd.literal(bitDepth);
      }
    }
  }
}

template <typename Pixel>
void Decoder<Pixel>::palette_tokens() {
  int blockHeight = 4 * block_h4(miSize), blockWidth = 4 * block_w4(miSize);
  int onscreenHeight = std::min(blockHeight, (fh.miRows - miRow) * 4);
  int onscreenWidth = std::min(blockWidth, (fh.miCols - miCol) * 4);
  auto read_map = [&](uint8_t (*map)[64], int n, uint16_t (*ccdf)[9], int bw, int bh, int ow, int oh) {
    map[0][0] = (uint8_t)sd.ns(n);
    for (int i = 1; i < oh + ow - 1; i++) {
      for (int j = std::min(i, ow - 1); j >= std::max(0, i - oh + 1); j--) {
        int r = i - j, c = j;
        int scores[8] = {0}, order[8] = {0, 1, 2, 3, 4, 5, 6, 7};
        if (c > 0) scores[map[r][c - 1]] += 2;
        if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
        if (r > 0) scores[map[r - 1][c]] += 2;
        for (int k = 0; k < 3; k++) {
          int maxScore = scores[k], maxIdx = k;
          for (int l = k + 1; l < n; l++) {
            if (scores[l] > maxScore) {
              maxScore = scores[l];
              maxIdx = l;
            }
          }
          if (maxIdx != k) {
            maxScore = scores[maxIdx];
            int maxOrder = order[maxIdx];
            for (int l = maxIdx; l > k; l--) {
              scores[l] = scores[l - 1];
              order[l] = order[l - 1];
            }
            scores[k] = maxScore;
            order[k] = maxOrder;
          }
        }
        int hash = scores[0] * 1 + scores[1] * 2 + scores[2] * 2;
        int ctx = kPaletteColorContext[hash];
        int idx = sd.symbol(ccdf[ctx], n);
        map[r][c] = (uint8_t)order[idx];
      }
    }
    for (int i = 0; i < oh; i++)
      for (int j = ow; j < bw; j++) map[i][j] = map[i][ow - 1];
    for (int i = oh; i < bh; i++)
      for (int j = 0; j < bw; j++) map[i][j] = map[oh - 1][j];
  };
  if (paletteSizeY)
    read_map(colorMapY, paletteSizeY, cdf.paletteYColor[paletteSizeY - 2], blockWidth, blockHeight, onscreenWidth,
             onscreenHeight);
  if (paletteSizeUV) {
    blockHeight >>= subY;
    blockWidth >>= subX;
    onscreenHeight >>= subY;
    onscreenWidth >>= subX;
    if (blockWidth < 4) {
      blockWidth += 2;
      onscreenWidth += 2;
    }
    if (blockHeight < 4) {
      blockHeight += 2;
      onscreenHeight += 2;
    }
    read_map(colorMapUV, paletteSizeUV, cdf.paletteUvColor[paletteSizeUV - 2], blockWidth, blockHeight,
             onscreenWidth, onscreenHeight);
  }
}

template struct Decoder<uint8_t>;
template struct Decoder<uint16_t>;

}  // namespace av1
}  // namespace byogan
