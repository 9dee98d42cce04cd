// OBUs, the sequence header, the frame header of a key or intra-only frame,
// tile info and the tile groups (AV1 specification 5.3-5.11 and 6.8), the
// tiles' decode (5.11's decode_tile), and the frame's post-filters in the
// specification's order: the loop filter, CDEF, loop restoration (none of
// them in a frame that allows intra block copy).  8-bit streams decode into
// Decoder<uint8_t>, 10- and 12-bit ones into Decoder<uint16_t>.  Where a
// stream breaks the specification's rules, the decode stops as dav1d 1.5.1
// stops (kFaultBroken): a header that reads past its OBU, an OBU past the
// data, a tile past its tile group, tiles missing at the end of the data.

#include <algorithm>

#include "av1_decoder.h"

namespace byogan {
namespace av1 {

namespace {

// The header bit reader (spec 4.10's f(n), su(n), ns(n), le(n), leb128).
struct Bits {
  const uint8_t* data;
  size_t size;  // bytes
  size_t pos = 0;

  int bit() {
    size_t byte = pos >> 3;
    if (byte >= size) fail(kFaultBroken);
    int b = (data[byte] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  uint32_t f(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; i++) x = 2 * x + bit();
    return x;
  }
  int su(int n) {
    int value = (int)f(n);
    int signMask = 1 << (n - 1);
    if (value & signMask) value -= 2 * signMask;
    return value;
  }
  int ns(int n) {
    int w = floor_log2(n) + 1;
    int m = (1 << w) - n;
    int v = (int)f(w - 1);
    if (v < m) return v;
    int extra = (int)f(1);
    return (v << 1) - m + extra;
  }
  uint32_t uvlc() {
    int leadingZeros = 0;
    while (!bit()) {
      leadingZeros++;
      if (leadingZeros >= 32) fail(kFaultBroken);
    }
    return leadingZeros >= 32 ? 0xffffffffu : f(leadingZeros) + ((1u << leadingZeros) - 1);
  }
  void byte_alignment() {
    while (pos & 7) f(1);
  }
};

uint64_t leb128(const uint8_t* p, size_t avail, size_t* len) {
  uint64_t value = 0;
  for (size_t i = 0; i < 8; i++) {
    if (i >= avail) fail(kFaultBroken);
    value |= (uint64_t)(p[i] & 0x7f) << (i * 7);
    if (!(p[i] & 0x80)) {
      *len = i + 1;
      return value;
    }
  }
  fail(kFaultBroken);
}

int tile_log2(int blkSize, int target) {
  int k = 0;
  while ((blkSize << k) < target) k++;
  return k;
}

void parse_sequence_header(Bits& b, SequenceHeader& s) {
  s = SequenceHeader();
  s.profile = (int)b.f(3);
  if (s.profile > 2) fail(kFaultBroken);
  s.stillPicture = (int)b.f(1);
  s.reducedStillPictureHeader = (int)b.f(1);
  if (s.reducedStillPictureHeader && !s.stillPicture) fail(kFaultBroken);
  int bufferDelayLength = 0;
  if (s.reducedStillPictureHeader) {
    s.operatingPoints = 1;
    s.operatingPointIdc[0] = 0;
    b.f(5);  // seq_level_idx[0]
  } else {
    s.timingInfoPresent = (int)b.f(1);
    if (s.timingInfoPresent) {
      b.f(32);  // num_units_in_display_tick
      b.f(32);  // time_scale
      s.equalPictureInterval = (int)b.f(1);
      if (s.equalPictureInterval) b.uvlc();
      s.decoderModelInfoPresent = (int)b.f(1);
      if (s.decoderModelInfoPresent) {
        bufferDelayLength = (int)b.f(5) + 1;
        b.f(32);  // num_units_in_decoding_tick
        s.bufferRemovalTimeLength = (int)b.f(5) + 1;
        s.framePresentationTimeLength = (int)b.f(5) + 1;
      }
    }
    int initialDisplayDelayPresent = (int)b.f(1);
    s.operatingPoints = (int)b.f(5) + 1;
    for (int i = 0; i < s.operatingPoints; i++) {
      s.operatingPointIdc[i] = (int)b.f(12);
      int seqLevelIdx = (int)b.f(5);
      if (seqLevelIdx > 7) b.f(1);  // seq_tier
      if (s.decoderModelInfoPresent) {
        s.decoderModelPresentForOp[i] = (int)b.f(1);
        if (s.decoderModelPresentForOp[i]) {
          b.f(bufferDelayLength);  // decoder_buffer_delay
          b.f(bufferDelayLength);  // encoder_buffer_delay
          b.f(1);                  // low_delay_mode_flag
        }
      }
      if (initialDisplayDelayPresent) {
        if (b.f(1)) b.f(4);
      }
    }
  }
  s.frameWidthBits = (int)b.f(4) + 1;
  s.frameHeightBits = (int)b.f(4) + 1;
  s.maxFrameWidth = (int)b.f(s.frameWidthBits) + 1;
  s.maxFrameHeight = (int)b.f(s.frameHeightBits) + 1;
  s.frameIdNumbersPresent = s.reducedStillPictureHeader ? 0 : (int)b.f(1);
  if (s.frameIdNumbersPresent) {
    s.deltaFrameIdLength = (int)b.f(4) + 2;
    s.frameIdLength = (int)b.f(3) + 1 + s.deltaFrameIdLength;
  }
  s.use128 = (int)b.f(1);
  s.enableFilterIntra = (int)b.f(1);
  s.enableIntraEdgeFilter = (int)b.f(1);
  if (s.reducedStillPictureHeader) {
    s.seqForceScreenContentTools = 2;
    s.seqForceIntegerMv = 2;
    s.orderHintBits = 0;
  } else {
    b.f(1);  // enable_interintra_compound
    b.f(1);  // enable_masked_compound
    b.f(1);  // enable_warped_motion
    b.f(1);  // enable_dual_filter
    s.enableOrderHint = (int)b.f(1);
    if (s.enableOrderHint) {
      b.f(1);  // enable_jnt_comp
      b.f(1);  // enable_ref_frame_mvs
    }
    if (b.f(1))
      s.seqForceScreenContentTools = 2;
    else
      s.seqForceScreenContentTools = (int)b.f(1);
    if (s.seqForceScreenContentTools > 0) {
      if (b.f(1))
        s.seqForceIntegerMv = 2;
      else
        s.seqForceIntegerMv = (int)b.f(1);
    } else {
      s.seqForceIntegerMv = 2;
    }
    if (s.enableOrderHint) s.orderHintBits = (int)b.f(3) + 1;
  }
  s.enableSuperres = (int)b.f(1);
  s.enableCdef = (int)b.f(1);
  s.enableRestoration = (int)b.f(1);
  // color_config()
  int highBitdepth = (int)b.f(1);
  if (s.profile == 2 && highBitdepth)
    s.bitDepth = b.f(1) ? 12 : 10;
  else
    s.bitDepth = highBitdepth ? 10 : 8;
  s.mono = s.profile == 1 ? 0 : (int)b.f(1);
  s.colorDescriptionPresent = (int)b.f(1);
  if (s.colorDescriptionPresent) {
    s.colorPrimaries = (int)b.f(8);
    s.transferCharacteristics = (int)b.f(8);
    s.matrixCoefficients = (int)b.f(8);
  }
  if (s.mono) {
    s.colorRange = (int)b.f(1);
    s.subX = s.subY = 1;
    s.separateUvDeltaQ = 0;
  } else {
    if (s.colorPrimaries == 1 && s.transferCharacteristics == 13 && s.matrixCoefficients == 0) {
      s.colorRange = 1;
      s.subX = s.subY = 0;
      if (s.profile != 1 && !(s.profile == 2 && s.bitDepth == 12)) fail(kFaultBroken);
    } else {
      s.colorRange = (int)b.f(1);
      if (s.profile == 0) {
        s.subX = s.subY = 1;
      } else if (s.profile == 1) {
        s.subX = s.subY = 0;
      } else if (s.bitDepth == 12) {
        s.subX = (int)b.f(1);
        s.subY = s.subX ? (int)b.f(1) : 0;
      } else {
        s.subX = 1;
        s.subY = 0;
      }
      if (s.subX && s.subY) s.chromaSamplePosition = (int)b.f(2);
    }
    s.separateUvDeltaQ = (int)b.f(1);
  }
  s.filmGrainParamsPresent = (int)b.f(1);
}

int read_delta_q(Bits& b) { return b.f(1) ? b.su(7) : 0; }

const int kSegFeatureBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int kSegFeatureSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int kSegFeatureMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};

void parse_frame_header(Bits& b, const SequenceHeader& s, FrameHeader& h, int temporalId, int spatialId) {
  h = FrameHeader();
  int frameIsIntra = 1;
  if (s.reducedStillPictureHeader) {
    h.frameType = 0;
    h.showFrame = 1;
  } else {
    if (b.f(1)) fail(kFaultBroken);  // show_existing_frame: no frame to show
    h.frameType = (int)b.f(2);
    frameIsIntra = h.frameType == 0 || h.frameType == 2;
    h.showFrame = (int)b.f(1);
    if (h.showFrame && s.decoderModelInfoPresent && !s.equalPictureInterval) b.f(s.framePresentationTimeLength);
    h.showableFrame = h.showFrame ? h.frameType != 0 : (int)b.f(1);
    if (h.frameType == 3 || (h.frameType == 0 && h.showFrame))
      h.errorResilient = 1;
    else
      h.errorResilient = (int)b.f(1);
  }
  if (!frameIsIntra) fail(kFaultNotIntra);
  h.disableCdfUpdate = (int)b.f(1);
  h.allowScreenContentTools = s.seqForceScreenContentTools == 2 ? (int)b.f(1) : s.seqForceScreenContentTools;
  if (h.allowScreenContentTools && s.seqForceIntegerMv == 2) b.f(1);
  if (s.frameIdNumbersPresent) b.f(s.frameIdLength);
  h.frameSizeOverride = s.reducedStillPictureHeader ? 0 : (int)b.f(1);
  b.f(s.orderHintBits);  // order_hint
  // primary_ref_frame is PRIMARY_REF_NONE in an intra frame.
  if (s.decoderModelInfoPresent) {
    if (b.f(1)) {
      for (int op = 0; op < s.operatingPoints; op++) {
        if (!s.decoderModelPresentForOp[op]) continue;
        int idc = s.operatingPointIdc[op];
        int inTemporal = (idc >> temporalId) & 1, inSpatial = (idc >> (spatialId + 8)) & 1;
        if (idc == 0 || (inTemporal && inSpatial)) b.f(s.bufferRemovalTimeLength);
      }
    }
  }
  int refreshFrameFlags = 0xff;
  if (!(h.frameType == 0 && h.showFrame)) refreshFrameFlags = (int)b.f(8);
  if (h.frameType == 2 && refreshFrameFlags == 0xff) fail(kFaultBroken);
  if (refreshFrameFlags != 0xff && h.errorResilient && s.enableOrderHint) {
    for (int i = 0; i < 8; i++) b.f(s.orderHintBits);
  }
  // frame_size()
  if (h.frameSizeOverride) {
    h.frameWidth = (int)b.f(s.frameWidthBits) + 1;
    h.frameHeight = (int)b.f(s.frameHeightBits) + 1;
  } else {
    h.frameWidth = s.maxFrameWidth;
    h.frameHeight = s.maxFrameHeight;
  }
  if (s.enableSuperres && b.f(1)) fail(kFaultSuperres);
  h.upscaledWidth = h.frameWidth;
  h.miCols = 2 * ((h.frameWidth + 7) >> 3);
  h.miRows = 2 * ((h.frameHeight + 7) >> 3);
  // render_size()
  if (b.f(1)) {
    h.renderWidth = (int)b.f(16) + 1;
    h.renderHeight = (int)b.f(16) + 1;
  } else {
    h.renderWidth = h.upscaledWidth;
    h.renderHeight = h.frameHeight;
  }
  if (h.allowScreenContentTools && h.upscaledWidth == h.frameWidth) h.allowIntrabc = (int)b.f(1);
  h.disableFrameEndUpdateCdf = (s.reducedStillPictureHeader || h.disableCdfUpdate) ? 1 : (int)b.f(1);

  // tile_info()
  int sbCols = s.use128 ? ((h.miCols + 31) >> 5) : ((h.miCols + 15) >> 4);
  int sbRows = s.use128 ? ((h.miRows + 31) >> 5) : ((h.miRows + 15) >> 4);
  int sbShift = s.use128 ? 5 : 4;
  int sbSize = sbShift + 2;
  int maxTileWidthSb = 4096 >> sbSize;
  int maxTileAreaSb = (4096 * 2304) >> (2 * sbSize);
  int minLog2TileCols = tile_log2(maxTileWidthSb, sbCols);
  int maxLog2TileCols = tile_log2(1, std::min(sbCols, 64));
  int maxLog2TileRows = tile_log2(1, std::min(sbRows, 64));
  int minLog2Tiles = std::max(minLog2TileCols, tile_log2(maxTileAreaSb, sbRows * sbCols));
  if (b.f(1)) {  // uniform_tile_spacing_flag
    h.tileColsLog2 = minLog2TileCols;
    while (h.tileColsLog2 < maxLog2TileCols) {
      if (b.f(1))
        h.tileColsLog2++;
      else
        break;
    }
    int tileWidthSb = (sbCols + (1 << h.tileColsLog2) - 1) >> h.tileColsLog2;
    int i = 0;
    for (int startSb = 0; startSb < sbCols; startSb += tileWidthSb) h.miColStarts[i++] = startSb << sbShift;
    h.miColStarts[i] = h.miCols;
    h.tileCols = i;
    int minLog2TileRows = std::max(minLog2Tiles - h.tileColsLog2, 0);
    h.tileRowsLog2 = minLog2TileRows;
    while (h.tileRowsLog2 < maxLog2TileRows) {
      if (b.f(1))
        h.tileRowsLog2++;
      else
        break;
    }
    int tileHeightSb = (sbRows + (1 << h.tileRowsLog2) - 1) >> h.tileRowsLog2;
    i = 0;
    for (int startSb = 0; startSb < sbRows; startSb += tileHeightSb) h.miRowStarts[i++] = startSb << sbShift;
    h.miRowStarts[i] = h.miRows;
    h.tileRows = i;
  } else {
    int widestTileSb = 0, startSb = 0, i;
    for (i = 0; startSb < sbCols; i++) {
      if (i >= 64) fail(kFaultBroken);
      h.miColStarts[i] = startSb << sbShift;
      int maxWidth = std::min(sbCols - startSb, maxTileWidthSb);
      int sizeSb = b.ns(maxWidth) + 1;
      widestTileSb = std::max(sizeSb, widestTileSb);
      startSb += sizeSb;
    }
    h.miColStarts[i] = h.miCols;
    h.tileCols = i;
    h.tileColsLog2 = tile_log2(1, h.tileCols);
    int area = minLog2Tiles > 0 ? (sbRows * sbCols) >> (minLog2Tiles + 1) : sbRows * sbCols;
    int maxTileHeightSb = std::max(area / widestTileSb, 1);
    startSb = 0;
    for (i = 0; startSb < sbRows; i++) {
      if (i >= 64) fail(kFaultBroken);
      h.miRowStarts[i] = startSb << sbShift;
      int maxHeight = std::min(sbRows - startSb, maxTileHeightSb);
      int sizeSb = b.ns(maxHeight) + 1;
      startSb += sizeSb;
    }
    h.miRowStarts[i] = h.miRows;
    h.tileRows = i;
    h.tileRowsLog2 = tile_log2(1, h.tileRows);
  }
  if (h.tileColsLog2 > 0 || h.tileRowsLog2 > 0) {
    h.contextUpdateTileId = (int)b.f(h.tileRowsLog2 + h.tileColsLog2);
    h.tileSizeBytes = (int)b.f(2) + 1;
    if (h.contextUpdateTileId >= h.tileCols * h.tileRows) fail(kFaultBroken);
  }

  // quantization_params()
  h.baseQIdx = (int)b.f(8);
  h.deltaQYDc = read_delta_q(b);
  if (!s.mono) {
    int diffUvDelta = s.separateUvDeltaQ ? (int)b.f(1) : 0;
    h.deltaQUDc = read_delta_q(b);
    h.deltaQUAc = read_delta_q(b);
    if (diffUvDelta) {
      h.deltaQVDc = read_delta_q(b);
      h.deltaQVAc = read_delta_q(b);
    } else {
      h.deltaQVDc = h.deltaQUDc;
      h.deltaQVAc = h.deltaQUAc;
    }
  }
  h.usingQmatrix = (int)b.f(1);
  if (h.usingQmatrix) fail(kFaultQmatrix);

  // segmentation_params()
  h.segmentationEnabled = (int)b.f(1);
  if (h.segmentationEnabled) {
    for (int i = 0; i < 8; i++) {
      for (int j = 0; j < 8; j++) {
        int clipped = 0;
        h.featureEnabled[i][j] = (int)b.f(1);
        if (h.featureEnabled[i][j]) {
          int bitsToRead = kSegFeatureBits[j], limit = kSegFeatureMax[j];
          if (kSegFeatureSigned[j])
            clipped = clip3(-limit, limit, b.su(1 + bitsToRead));
          else
            clipped = clip3(0, limit, (int)b.f(bitsToRead));
        }
        h.featureData[i][j] = clipped;
      }
    }
  }
  for (int i = 0; i < 8; i++) {
    for (int j = 0; j < 8; j++) {
      if (h.featureEnabled[i][j]) {
        h.lastActiveSegId = i;
        if (j >= 5) h.segIdPreSkip = 1;
      }
    }
  }
  // delta_q_params(), delta_lf_params()
  if (h.baseQIdx > 0) h.deltaQPresent = (int)b.f(1);
  if (h.deltaQPresent) {
    h.deltaQRes = (int)b.f(2);
    if (!h.allowIntrabc) h.deltaLfPresent = (int)b.f(1);
    if (h.deltaLfPresent) {
      h.deltaLfRes = (int)b.f(2);
      h.deltaLfMulti = (int)b.f(1);
    }
  }
  h.codedLossless = 1;
  for (int segId = 0; segId < 8; segId++) {
    int q = h.baseQIdx;
    if (h.segmentationEnabled && h.featureEnabled[segId][0]) q = clip3(0, 255, h.baseQIdx + h.featureData[segId][0]);
    h.losslessArray[segId] = q == 0 && h.deltaQYDc == 0 && h.deltaQUAc == 0 && h.deltaQUDc == 0 &&
                             h.deltaQVAc == 0 && h.deltaQVDc == 0;
    if (!h.losslessArray[segId]) h.codedLossless = 0;
  }
  h.allLossless = h.codedLossless && h.frameWidth == h.upscaledWidth;

  // loop_filter_params()
  if (!h.codedLossless && !h.allowIntrabc) {
    h.loopFilterLevel[0] = (int)b.f(6);
    h.loopFilterLevel[1] = (int)b.f(6);
    if (!s.mono && (h.loopFilterLevel[0] || h.loopFilterLevel[1])) {
      h.loopFilterLevel[2] = (int)b.f(6);
      h.loopFilterLevel[3] = (int)b.f(6);
    }
    h.loopFilterSharpness = (int)b.f(3);
    h.loopFilterDeltaEnabled = (int)b.f(1);
    if (h.loopFilterDeltaEnabled) {
      if (b.f(1)) {  // loop_filter_delta_update
        for (int i = 0; i < 8; i++)
          if (b.f(1)) h.loopFilterRefDeltas[i] = b.su(7);
        for (int i = 0; i < 2; i++)
          if (b.f(1)) h.loopFilterModeDeltas[i] = b.su(7);
      }
    }
  }
  // cdef_params()
  if (!h.codedLossless && !h.allowIntrabc && s.enableCdef) {
    h.cdefDamping = (int)b.f(2) + 3;
    h.cdefBits = (int)b.f(2);
    for (int i = 0; i < (1 << h.cdefBits); i++) {
      h.cdefYPri[i] = (int)b.f(4);
      h.cdefYSec[i] = (int)b.f(2);
      if (h.cdefYSec[i] == 3) h.cdefYSec[i]++;
      if (!s.mono) {
        h.cdefUvPri[i] = (int)b.f(4);
        h.cdefUvSec[i] = (int)b.f(2);
        if (h.cdefUvSec[i] == 3) h.cdefUvSec[i]++;
      }
    }
  }
  // lr_params()
  if (!h.allLossless && !h.allowIntrabc && s.enableRestoration) {
    static const int kRemapLrType[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ};
    int usesChromaLr = 0;
    for (int i = 0; i < (s.mono ? 1 : 3); i++) {
      h.frameRestorationType[i] = kRemapLrType[b.f(2)];
      if (h.frameRestorationType[i] != RESTORE_NONE) {
        h.usesLr = 1;
        if (i > 0) usesChromaLr = 1;
      }
    }
    if (h.usesLr) {
      int lrUnitShift;
      if (s.use128) {
        lrUnitShift = (int)b.f(1) + 1;
      } else {
        lrUnitShift = (int)b.f(1);
        if (lrUnitShift) lrUnitShift += (int)b.f(1);
      }
      h.loopRestorationSize[0] = 256 >> (2 - lrUnitShift);
      int lrUvShift = (s.subX && s.subY && usesChromaLr) ? (int)b.f(1) : 0;
      h.loopRestorationSize[1] = h.loopRestorationSize[2] = h.loopRestorationSize[0] >> lrUvShift;
    }
  }
  // read_tx_mode()
  h.txModeSelect = h.codedLossless ? 0 : (int)b.f(1);
  // frame_reference_mode(), skip_mode_params(), allow_warped_motion read nothing in an intra frame.
  h.reducedTxSet = (int)b.f(1);
  // global_motion_params() reads nothing in an intra frame; film_grain_params():
  if (s.filmGrainParamsPresent && (h.showFrame || h.showableFrame)) {
    if (b.f(1)) fail(kFaultFilmGrain);  // apply_grain
  }
}

}  // namespace

template <typename Pixel>
int Decoder<Pixel>::get_qindex(int ignoreDeltaQ, int segId) const {
  if (fh.segmentationEnabled && fh.featureEnabled[segId][0]) {
    int data = fh.featureData[segId][0];
    int qindex = fh.baseQIdx + data;
    if (!ignoreDeltaQ && fh.deltaQPresent) qindex = currentQIndex + data;
    return clip3(0, 255, qindex);
  }
  if (!ignoreDeltaQ && fh.deltaQPresent) return currentQIndex;
  return fh.baseQIdx;
}

template <typename Pixel>
void Decoder<Pixel>::decode_tile() {
  for (int p = 0; p < numPlanes; p++) {
    int sx = p ? subX : 0;
    int x0 = miColStart >> sx, x1 = std::min<int>((miColEnd + (1 << sx) - 1) >> sx, (int)aboveLevel[p].size());
    std::fill(aboveLevel[p].begin() + x0, aboveLevel[p].begin() + x1, 0);
    std::fill(aboveDc[p].begin() + x0, aboveDc[p].begin() + x1, 0);
  }
  for (int i = 0; i < 4; i++) deltaLF[i] = 0;
  static const int kWienerTapsMid[3] = {3, -7, 15};
  static const int kSgrprojXqdMid[2] = {-32, 31};
  for (int p = 0; p < numPlanes; p++) {
    for (int pass = 0; pass < 2; pass++) {
      refSgrXqd[p][pass] = kSgrprojXqdMid[pass];
      for (int i = 0; i < 3; i++) refLrWiener[p][pass][i] = kWienerTapsMid[i];
    }
  }
  int sbSize = seq.use128 ? BLOCK_128X128 : BLOCK_64X64;
  int sbSize4 = block_w4(sbSize);
  for (int r = miRowStart; r < miRowEnd; r += sbSize4) {
    for (int p = 0; p < numPlanes; p++) {
      int sy = p ? subY : 0;
      int y0 = r >> sy, y1 = std::min<int>((miRowEnd + (1 << sy) - 1) >> sy, (int)leftLevel[p].size());
      std::fill(leftLevel[p].begin() + y0, leftLevel[p].begin() + y1, 0);
      std::fill(leftDc[p].begin() + y0, leftDc[p].begin() + y1, 0);
    }
    for (int c = miColStart; c < miColEnd; c += sbSize4) {
      readDeltas = fh.deltaQPresent;
      // clear_cdef
      int ci = (r >> 4) * cdefStride + (c >> 4);
      cdefIdx[ci] = -1;
      if (seq.use128) {
        cdefIdx[ci + 1] = -1;
        cdefIdx[ci + cdefStride] = -1;
        cdefIdx[ci + cdefStride + 1] = -1;
      }
      // clear_block_decoded_flags
      for (int p = 0; p < numPlanes; p++) {
        int sx = p ? subX : 0, sy = p ? subY : 0;
        int sbWidth4 = (miColEnd - c) >> sx, sbHeight4 = (miRowEnd - r) >> sy;
        for (int y = -1; y <= (sbSize4 >> sy); y++) {
          for (int x = -1; x <= (sbSize4 >> sx); x++) {
            uint8_t v;
            if (y < 0 && x < sbWidth4)
              v = 1;
            else if (x < 0 && y < sbHeight4)
              v = 1;
            else
              v = 0;
            blockDecoded[p][y + 1][x + 1] = v;
          }
        }
        blockDecoded[p][(sbSize4 >> sy) + 1][0] = 0;
      }
      read_lr(r, c, sbSize);
      decode_partition(r, c, sbSize);
    }
  }
}

namespace {

// A sequence header of samples of the other decoder's width, met before
// any frame header.
struct DepthSwitch {};

template <typename Pixel>
void decode_frame(const uint8_t* data, size_t size, Planes* out, Counts* counts) {
  Decoder<Pixel>* dp = new Decoder<Pixel>();
  struct Guard {
    Decoder<Pixel>* d;
    ~Guard() { delete d; }
  } guard{dp};
  Decoder<Pixel>& d = *dp;
  d.counts = counts;
  bool haveSeq = false, haveFrame = false, done = false;
  int tileNum = 0;
  int operatingPointIdc = 0;
  size_t pos = 0;
  while (pos < size && !done) {
    Bits hb{data + pos, size - pos};
    hb.f(1);  // obu_forbidden_bit
    int type = (int)hb.f(4);
    int ext = (int)hb.f(1);
    int hasSize = (int)hb.f(1);
    hb.f(1);
    int temporalId = 0, spatialId = 0;
    if (ext) {
      temporalId = (int)hb.f(3);
      spatialId = (int)hb.f(2);
      hb.f(3);
    }
    size_t headerLen = 1 + ext;
    uint64_t obuSize;
    if (hasSize) {
      size_t len;
      obuSize = leb128(data + pos + headerLen, size - pos - headerLen, &len);
      headerLen += len;
    } else {
      if (size - pos < headerLen) fail(kFaultBroken);
      obuSize = size - pos - headerLen;
    }
    if (obuSize > size - pos - headerLen) fail(kFaultBroken);
    const uint8_t* payload = data + pos + headerLen;
    size_t psize = (size_t)obuSize;
    pos += headerLen + psize;
    if (type != 1 && type != 2 && ext && operatingPointIdc != 0) {
      int inTemporal = (operatingPointIdc >> temporalId) & 1;
      int inSpatial = (operatingPointIdc >> (spatialId + 8)) & 1;
      if (!inTemporal || !inSpatial) continue;
    }
    if (type == 1) {  // OBU_SEQUENCE_HEADER
      Bits b{payload, psize};
      SequenceHeader s;
      parse_sequence_header(b, s);
      for (int i = 0; i < s.operatingPoints; i++) {
        int spatial = s.operatingPointIdc[i] >> 8;
        if (spatial & (spatial - 1)) fail(kFaultLayers);
      }
      if ((s.bitDepth > 8) != (sizeof(Pixel) > 1)) {
        if (haveFrame) fail(kFaultBroken);
        throw DepthSwitch{};
      }
      d.seq = s;
      d.bitDepth = s.bitDepth;
      operatingPointIdc = s.operatingPointIdc[0];
      haveSeq = true;
    } else if (type == 3 || type == 6 || type == 4) {  // FRAME_HEADER, FRAME, TILE_GROUP
      if (!haveSeq) fail(kFaultBroken);
      Bits b{payload, psize};
      if (type != 4) {
        if (haveFrame) continue;  // a redundant copy of the header
        parse_frame_header(b, d.seq, d.fh, temporalId, spatialId);
        haveFrame = true;
        // Set up the frame.
        const SequenceHeader& s = d.seq;
        FrameHeader& h = d.fh;
        d.numPlanes = s.mono ? 1 : 3;
        d.subX = s.subX;
        d.subY = s.subY;
        int align = 128;
        int alignedW = ((h.miCols * 4) + align - 1) / align * align;
        int alignedH = ((h.miRows * 4) + align - 1) / align * align;
        for (int p = 0; p < d.numPlanes; p++) {
          int sx = p ? s.subX : 0, sy = p ? s.subY : 0;
          d.stride[p] = (alignedW >> sx) + 16;
          d.allocH[p] = (alignedH >> sy) + 16;
          d.cur[p].assign((size_t)d.stride[p] * d.allocH[p], 0);
          int n4w = (alignedW >> sx) / 4 + 4, n4h = (alignedH >> sy) / 4 + 4;
          d.aboveLevel[p].assign(n4w, 0);
          d.aboveDc[p].assign(n4w, 0);
          d.leftLevel[p].assign(n4h, 0);
          d.leftDc[p].assign(n4h, 0);
          d.lfTxSizes[p].assign((size_t)n4w * n4h, 0);
        }
        d.miStride = alignedW / 4 + 32;
        d.miRowsAlloc = alignedH / 4 + 32;
        size_t nmi = (size_t)d.miStride * d.miRowsAlloc;
        d.yModes.assign(nmi, 0);
        d.uvModes.assign(nmi, 0);
        d.skips.assign(nmi, 0);
        d.miSizes.assign(nmi, 0);
        d.segmentIds.assign(nmi, 0);
        d.paletteSizes[0].assign(nmi, 0);
        d.paletteSizes[1].assign(nmi, 0);
        d.paletteColors[0].assign(nmi * 8, 0);
        d.paletteColors[1].assign(nmi * 8, 0);
        d.blockKinds.assign(nmi, 0);
        d.interTxSizes.assign(nmi, 0);
        if (h.allowIntrabc) d.mvs.assign(nmi * 2, 0);
        d.deltaLFs.assign(nmi * 4, 0);
        d.cdefStride = alignedW / 64 + 2;
        d.cdefIdx.assign((size_t)d.cdefStride * (alignedH / 64 + 2), -1);
        for (int p = 0; p < d.numPlanes; p++) {
          if (h.frameRestorationType[p] == RESTORE_NONE) continue;
          int sx = p ? s.subX : 0, sy = p ? s.subY : 0;
          int unitSize = h.loopRestorationSize[p];
          int pw = ((h.upscaledWidth + sx) >> sx), ph = ((h.frameHeight + sy) >> sy);
          auto count_units = [](int sz, int unit) { return std::max((sz + (unit >> 1)) / unit, 1); };
          d.lrUnitCols[p] = count_units(pw, unitSize);
          d.lrUnitRows[p] = count_units(ph, unitSize);
          size_t n = (size_t)d.lrUnitCols[p] * d.lrUnitRows[p];
          d.lrType[p].assign(n, 0);
          d.lrWiener[p].assign(n * 6, 0);
          d.lrSgrSet[p].assign(n, 0);
          d.lrSgrXqd[p].assign(n * 2, 0);
        }
        if (counts) {
          counts->bitDepth[(s.bitDepth - 8) >> 1][s.mono ? 3 : s.subY ? 0 : s.subX ? 1 : 2]++;
          counts->superblock128 += s.use128;
          counts->tiles += h.tileCols * h.tileRows;
          if (h.codedLossless) counts->lossless++;
        }
        if (type == 3) continue;
        b.byte_alignment();
      } else if (!haveFrame) {
        fail(kFaultBroken);
      }
      // tile_group_obu(sz)
      FrameHeader& h = d.fh;
      size_t startBitPos = b.pos;
      int numTiles = h.tileCols * h.tileRows;
      int tgStart = 0, tgEnd = numTiles - 1;
      int tileStartAndEndPresent = numTiles > 1 ? (int)b.f(1) : 0;
      if (tileStartAndEndPresent) {
        int tileBits = h.tileColsLog2 + h.tileRowsLog2;
        tgStart = (int)b.f(tileBits);
        tgEnd = (int)b.f(tileBits);
      }
      b.byte_alignment();
      if (tgStart != tileNum || tgEnd < tgStart || tgEnd >= numTiles) fail(kFaultBroken);
      size_t headerBytes = (b.pos - startBitPos) / 8;
      size_t off = startBitPos / 8 + headerBytes;
      size_t sz = psize - off;
      for (int t = tgStart; t <= tgEnd; t++) {
        int tileRow = t / h.tileCols, tileCol = t % h.tileCols;
        size_t tileSize;
        if (t == tgEnd) {
          tileSize = sz;
        } else {
          if (sz < (size_t)h.tileSizeBytes) fail(kFaultBroken);
          size_t v = 0;
          for (int i = 0; i < h.tileSizeBytes; i++) v |= (size_t)payload[off + i] << (8 * i);
          tileSize = v + 1;
          off += h.tileSizeBytes;
          sz -= h.tileSizeBytes;
          if (tileSize > sz) fail(kFaultBroken);
        }
        if (tileSize == 0) fail(kFaultBroken);
        d.miRowStart = h.miRowStarts[tileRow];
        d.miRowEnd = h.miRowStarts[tileRow + 1];
        d.miColStart = h.miColStarts[tileCol];
        d.miColEnd = h.miColStarts[tileCol + 1];
        d.currentQIndex = h.baseQIdx;
        d.cdf.init(h.baseQIdx);
        d.sd.init(payload + off, tileSize, h.disableCdfUpdate);
        d.decode_tile();
        // exit_symbol's conformance bound, which dav1d enforces: no more than
        // 14 bits read past the tile's data.
        if (d.sd.maxBits < -14) fail(kFaultBroken);
        off += tileSize;
        sz -= tileSize;
      }
      tileNum = tgEnd + 1;
      if (tileNum == numTiles) done = true;
    }
    // Temporal delimiters, metadata, padding and other OBUs carry nothing for the still frame.
  }
  if (!done) fail(kFaultBroken);

  // decode_frame_wrapup: the loop filter, CDEF and loop restoration.
  const FrameHeader& h = d.fh;
  d.loop_filter_frame();
  bool cdefOn = d.seq.enableCdef && !h.codedLossless && !h.allowIntrabc;
  bool lrOn = h.usesLr;
  std::vector<Pixel> deblocked[3];
  if (lrOn)
    for (int p = 0; p < d.numPlanes; p++) deblocked[p] = d.cur[p];
  if (d.counts) (cdefOn ? d.counts->cdefOn : d.counts->cdefOff)++;
  if (cdefOn) {
    std::vector<Pixel> pre[3];
    for (int p = 0; p < d.numPlanes; p++) pre[p] = d.cur[p];
    d.cdef_frame(pre);
  }
  if (lrOn) {
    std::vector<Pixel> cdefed[3];
    for (int p = 0; p < d.numPlanes; p++) cdefed[p] = d.cur[p];
    d.lr_frame(deblocked, cdefed);
  }

  Planes& o = *out;
  o.width = h.upscaledWidth;
  o.height = h.frameHeight;
  o.bitDepth = d.bitDepth;
  o.subX = d.subX;
  o.subY = d.subY;
  o.mono = d.seq.mono;
  o.colorRange = d.seq.colorRange;
  o.colorPrimaries = d.seq.colorPrimaries;
  o.transferCharacteristics = d.seq.transferCharacteristics;
  o.matrixCoefficients = d.seq.matrixCoefficients;
  for (int p = 0; p < d.numPlanes; p++) {
    int sx = p ? d.subX : 0, sy = p ? d.subY : 0;
    int pw = (o.width + sx) >> sx, ph = (o.height + sy) >> sy;
    o.planeWidth[p] = pw;
    o.planeHeight[p] = ph;
    o.stride[p] = pw;
    Pixel* dst;
    if constexpr (sizeof(Pixel) == 1) {
      o.plane[p].resize((size_t)pw * ph);
      dst = o.plane[p].data();
    } else {
      o.plane16[p].resize((size_t)pw * ph);
      dst = o.plane16[p].data();
    }
    for (int y = 0; y < ph; y++) std::memcpy(dst + (size_t)y * pw, &d.px(p, y, 0), pw * sizeof(Pixel));
  }
}

}  // namespace

void decode(const uint8_t* data, size_t size, Planes* out, Counts* counts) {
  try {
    decode_frame<uint8_t>(data, size, out, counts);
  } catch (const DepthSwitch&) {
    try {
      decode_frame<uint16_t>(data, size, out, counts);
    } catch (const DepthSwitch&) {
      fail(kFaultBroken);  // sequence headers of both widths before the frame
    }
  }
}

template struct Decoder<uint8_t>;
template struct Decoder<uint16_t>;

}  // namespace av1
}  // namespace byogan
