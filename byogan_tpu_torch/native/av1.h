// What the AV1 intra decoder's files share.  The decoder reads the still
// frame of an AVIF item (a key frame, or an intra-only frame, intra block
// copy among its tools) as the AV1 Bitstream & Decoding Process
// Specification decodes it, samples of 8, 10 or 12 bits in 4:2:0, 4:2:2,
// 4:4:4 or 4:0:0:
//
//   av1_obu.cpp      OBUs, the sequence header, the frame header, tile info,
//                    the tile groups and the decode's entry
//   av1_symbol.cpp   the multi-symbol arithmetic decoder (spec 8.2)
//   av1_cdfs.cpp     the default CDFs
//   av1_tables.cpp   the other constants
//   av1_modes.cpp    partitions and intra mode info, palette colours and maps
//   av1_intrabc.cpp  intra block copy: the vector stack, the vector and the
//                    block's copy (spec 7.10.2, 5.11.32, 7.11.3)
//   av1_coefs.cpp    transform sizes and types, coefficients, dequantization
//                    and reconstruction
//   av1_intra.cpp    intra prediction (spec 7.11.2), CfL and palette
//   av1_itx.cpp      the inverse transforms (spec 7.13)
//   av1_deblock.cpp  the loop filter (spec 7.14)
//   av1_cdef.cpp     CDEF (spec 7.15)
//   av1_lr.cpp       loop restoration (spec 7.17)
//
// avif_rgb.cpp turns the planes into RGB as libavif 1.3.0 does.  Names of
// variables follow the specification's where a reader would look them up.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace byogan {
namespace av1 {

// Why a stream is not decoded (codec.h's kAvif* codes).
enum Fault {
  kFaultBroken = 1,     // a stream dav1d refuses, or cut short
  kFaultFilmGrain,      // film grain parameters
  kFaultQmatrix,        // quantizer matrices
  kFaultSuperres,       // a superresolved frame
  kFaultLayers,         // spatial layers (operating points of more than one layer)
  kFaultNotIntra,       // no key or intra-only frame shown first
};

struct Error {
  int fault;
};

[[noreturn]] inline void fail(int fault) { throw Error{fault}; }

// Block sizes, in the specification's order.
enum BlockSize {
  BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16, BLOCK_16X32, BLOCK_32X16,
  BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128, BLOCK_4X16,
  BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16, BLOCK_SIZES, BLOCK_INVALID = BLOCK_SIZES
};

enum Partition {
  PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_HORZ_B,
  PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4
};

enum TxSize {
  TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X64,
  TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16, TX_SIZES_ALL
};

enum TxType {
  DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST, ADST_FLIPADST,
  FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST
};

enum PredMode {
  DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED, SMOOTH_PRED,
  SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED
};

enum RestorationType { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

// Tables (av1_tables.cpp).
extern const uint8_t kBlockWidthLog2[BLOCK_SIZES];   // log2 of the width in 4x4 units
extern const uint8_t kBlockHeightLog2[BLOCK_SIZES];
extern const uint8_t kPartitionSubsize[10][BLOCK_SIZES];
extern const uint8_t kMaxTxSizeRect[BLOCK_SIZES];
extern const uint8_t kTxWidthLog2[TX_SIZES_ALL];     // log2 of the width in pixels
extern const uint8_t kTxHeightLog2[TX_SIZES_ALL];
extern const uint8_t kTxSizeSqr[TX_SIZES_ALL];
extern const uint8_t kTxSizeSqrUp[TX_SIZES_ALL];
extern const uint8_t kSplitTxSize[TX_SIZES_ALL];
extern const uint8_t kAdjustedTxSize[TX_SIZES_ALL];
extern const uint8_t kTransformRowShift[TX_SIZES_ALL];
extern const int16_t kDcQLookup[3][256];          // by (BitDepth - 8) / 2
extern const int16_t kAcQLookup[3][256];
extern const uint8_t kModeToAngle[13];
extern const int16_t kDrIntraDerivative[90];
extern const uint8_t kSmWeights[128];                // the weights of size n at [n .. 2n)
extern const int8_t kFilterIntraTaps[5][8][7];
extern const uint8_t kIntraEdgeKernel[3][5];
extern const uint8_t kModeToTxfm[14];
extern const uint8_t kCoeffBaseCtxOffset[TX_SIZES_ALL][5][5];
extern const int16_t kCos128[65];
extern const int8_t kCdefDirections[8][2][2];
extern const uint8_t kCdefUvDir[2][2][8];
extern const int16_t kSgrParams[16][4];
extern const int8_t kWienerTapsMin[3], kWienerTapsMax[3], kWienerTapsK[3];
extern const int8_t kSgrprojXqdMin[2], kSgrprojXqdMax[2];
extern const int16_t kDivTable[9];

// Scans (av1_tables.cpp builds them at first use): the default scan of each
// size up to 32x32, and the row and column scans up to 16.
const int16_t* default_scan(int txSz);
const int16_t* mrow_scan(int txSz);
const int16_t* mcol_scan(int txSz);

// Default CDFs (av1_cdfs.cpp), each row as the specification writes it.
extern const uint16_t kYMode[5][5][14];
extern const uint16_t kUvModeCflNotAllowed[13][14];
extern const uint16_t kUvModeCflAllowed[13][15];
extern const uint16_t kAngleDelta[8][8];
extern const uint16_t kPartitionW8[4][5];
extern const uint16_t kPartitionW16[4][11];
extern const uint16_t kPartitionW32[4][11];
extern const uint16_t kPartitionW64[4][11];
extern const uint16_t kPartitionW128[4][9];
extern const uint16_t kTx8x8[3][3];
extern const uint16_t kTx16x16[3][4];
extern const uint16_t kTx32x32[3][4];
extern const uint16_t kTx64x64[3][4];
extern const uint16_t kSegmentId[3][9];
extern const uint16_t kSkip[3][3];
extern const uint16_t kIntrabc[3];
extern const uint16_t kDeltaQ[5];
extern const uint16_t kDeltaLf[5];
extern const uint16_t kFilterIntra[22][3];
extern const uint16_t kFilterIntraMode[6];
extern const uint16_t kCflSign[9];
extern const uint16_t kCflAlpha[6][17];
extern const uint16_t kPaletteYSize[7][8];
extern const uint16_t kPaletteUvSize[7][8];
extern const uint16_t kPaletteYMode[7][3][3];
extern const uint16_t kPaletteUvMode[2][3];
extern const uint16_t kPaletteYColor[7][5][9];
extern const uint16_t kPaletteUvColor[7][5][9];
extern const uint16_t kIntraTxSet1[2][13][8];
extern const uint16_t kIntraTxSet2[3][13][6];
extern const uint16_t kRestorationType[4];
extern const uint16_t kUseWiener[3];
extern const uint16_t kUseSgrproj[3];
extern const uint16_t kTxbSkip[4][5][13][3];
extern const uint16_t kEobPt16[4][2][2][6];
extern const uint16_t kEobPt32[4][2][2][7];
extern const uint16_t kEobPt64[4][2][2][8];
extern const uint16_t kEobPt128[4][2][2][9];
extern const uint16_t kEobPt256[4][2][2][10];
extern const uint16_t kEobPt512[4][2][11];
extern const uint16_t kEobPt1024[4][2][12];
extern const uint16_t kEobExtra[4][5][2][9][3];
extern const uint16_t kDcSign[4][2][3][3];
extern const uint16_t kCoeffBaseEob[4][5][2][4][4];
extern const uint16_t kCoeffBase[4][5][2][42][5];
extern const uint16_t kCoeffBr[4][5][2][21][5];
extern const uint16_t kMvJoint[5];
extern const uint16_t kMvClass[12];
extern const uint16_t kMvClass0Bit[3];
extern const uint16_t kMvBit[10][3];
extern const uint16_t kMvSign[3];
extern const uint16_t kTxfmSplit[21][3];
extern const uint16_t kInterTxSet1[2][17];
extern const uint16_t kInterTxSet2[13];
extern const uint16_t kInterTxSet3[4][3];

// The CDFs a tile adapts, initialised from the defaults (spec 7.20's
// init_non_coeff_cdfs and init_coeff_cdfs).
struct Cdfs {
  uint16_t yMode[5][5][14];
  uint16_t uvModeCflNotAllowed[13][14];
  uint16_t uvModeCflAllowed[13][15];
  uint16_t angleDelta[8][8];
  uint16_t partitionW8[4][5];
  uint16_t partitionW16[4][11];
  uint16_t partitionW32[4][11];
  uint16_t partitionW64[4][11];
  uint16_t partitionW128[4][9];
  uint16_t tx8x8[3][3];
  uint16_t tx16x16[3][4];
  uint16_t tx32x32[3][4];
  uint16_t tx64x64[3][4];
  uint16_t segmentId[3][9];
  uint16_t skip[3][3];
  uint16_t deltaQ[5];
  uint16_t deltaLf[5];
  uint16_t deltaLfMulti[4][5];
  uint16_t filterIntra[22][3];
  uint16_t filterIntraMode[6];
  uint16_t cflSign[9];
  uint16_t cflAlpha[6][17];
  uint16_t paletteYSize[7][8];
  uint16_t paletteUvSize[7][8];
  uint16_t paletteYMode[7][3][3];
  uint16_t paletteUvMode[2][3];
  uint16_t paletteYColor[7][5][9];
  uint16_t paletteUvColor[7][5][9];
  uint16_t intraTxSet1[2][13][8];
  uint16_t intraTxSet2[3][13][6];
  uint16_t restorationType[4];
  uint16_t useWiener[3];
  uint16_t useSgrproj[3];
  uint16_t txbSkip[5][13][3];
  uint16_t eobPt16[2][2][6];
  uint16_t eobPt32[2][2][7];
  uint16_t eobPt64[2][2][8];
  uint16_t eobPt128[2][2][9];
  uint16_t eobPt256[2][2][10];
  uint16_t eobPt512[2][11];
  uint16_t eobPt1024[2][12];
  uint16_t eobExtra[5][2][9][3];
  uint16_t dcSign[2][3][3];
  uint16_t coeffBaseEob[5][2][4][4];
  uint16_t coeffBase[5][2][42][5];
  uint16_t coeffBr[5][2][21][5];
  // Intra block copy: use_intrabc, the vector (MV_INTRABC_CONTEXT's CDFs,
  // [comp] the row's and the column's), txfm_split, the inter transform sets.
  uint16_t intrabc[3];
  uint16_t mvJoint[5];
  uint16_t mvClass[2][12];
  uint16_t mvClass0Bit[2][3];
  uint16_t mvBit[2][10][3];
  uint16_t mvSign[2][3];
  uint16_t txfmSplit[21][3];
  uint16_t interTxSet1[2][17];
  uint16_t interTxSet2[13];
  uint16_t interTxSet3[4][3];

  void init(int base_q_idx);
};

// The symbol decoder of one tile (spec 8.2.2-8.2.6).
struct SymbolDecoder {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t bitpos = 0;
  int64_t maxBits = 0;
  uint32_t range = 0, value = 0;
  bool update = true;

  void init(const uint8_t* d, size_t sz, bool disable_cdf_update);
  int symbol(uint16_t* cdf, int n);
  int boolean();
  int literal(int n);
  int ns(int n);  // the non-symmetric value of read_literal bits (spec 4.10.7 with L(1))

 private:
  uint32_t bits(int n);
};

// The counts of what a decode met (the coverage test's struct; the
// loader passes none).
struct Counts {
  int32_t partition[10];
  int32_t yMode[13];
  int32_t uvMode[14];
  int32_t filterIntraMode[5];
  int32_t paletteY[9];   // by palette size
  int32_t paletteUv[9];
  int32_t txSize[TX_SIZES_ALL];
  int32_t txType[16];    // luma transform blocks by type
  int32_t cdefOn, cdefOff;       // frames with CDEF, and without
  int32_t lrType[4];             // restoration units by type (none, Wiener, self-guided)
  int32_t lossless;
  int32_t superblock128;
  int32_t tiles;
  int32_t useIntrabc[2];         // blocks of a frame that allows intra block copy, by use_intrabc
  int32_t mvJoint[4];            // intra block copy vectors by mv_joint
  int32_t mvClass[11];           // their components by mv_class
  int32_t txfmSplit[3];          // variable transform sizes by their depth in the txfm_split tree
  int32_t interTxType[16];       // luma transform blocks of intra block copy by type
  int32_t bitDepth[3][4];        // frames by (BitDepth - 8) / 2 and 4:2:0, 4:2:2, 4:4:4, 4:0:0
};

struct SequenceHeader {
  int profile = 0;
  int stillPicture = 0, reducedStillPictureHeader = 0;
  int operatingPoints = 1;
  int operatingPointIdc[32] = {0};
  int timingInfoPresent = 0, decoderModelInfoPresent = 0, equalPictureInterval = 0;
  int bufferRemovalTimeLength = 0, framePresentationTimeLength = 0;
  int decoderModelPresentForOp[32] = {0};
  int frameWidthBits = 0, frameHeightBits = 0;
  int maxFrameWidth = 0, maxFrameHeight = 0;
  int frameIdNumbersPresent = 0, deltaFrameIdLength = 0, frameIdLength = 0;
  int use128 = 0, enableFilterIntra = 0, enableIntraEdgeFilter = 0;
  int enableOrderHint = 0, orderHintBits = 0;
  int seqForceScreenContentTools = 0, seqForceIntegerMv = 0;
  int enableSuperres = 0, enableCdef = 0, enableRestoration = 0;
  int bitDepth = 8, mono = 0;
  int colorDescriptionPresent = 0;
  int colorPrimaries = 2, transferCharacteristics = 2, matrixCoefficients = 2;
  int colorRange = 0, subX = 1, subY = 1, chromaSamplePosition = 0;
  int separateUvDeltaQ = 0;
  int filmGrainParamsPresent = 0;
};

struct FrameHeader {
  int frameType = 0, showFrame = 1, showableFrame = 0, errorResilient = 1;
  int disableCdfUpdate = 0, allowScreenContentTools = 0, forceIntegerMv = 0;
  int frameSizeOverride = 0, allowIntrabc = 0;
  int frameWidth = 0, frameHeight = 0, upscaledWidth = 0, renderWidth = 0, renderHeight = 0;
  int miCols = 0, miRows = 0;
  int disableFrameEndUpdateCdf = 1;
  // Tile info.
  int tileCols = 1, tileRows = 1, tileColsLog2 = 0, tileRowsLog2 = 0;
  int miColStarts[65] = {0}, miRowStarts[65] = {0};
  int contextUpdateTileId = 0, tileSizeBytes = 4;
  // Quantization.
  int baseQIdx = 0;
  int deltaQYDc = 0, deltaQUDc = 0, deltaQUAc = 0, deltaQVDc = 0, deltaQVAc = 0;
  int usingQmatrix = 0;
  // Segmentation.
  int segmentationEnabled = 0;
  int featureEnabled[8][8] = {{0}};
  int featureData[8][8] = {{0}};
  int segIdPreSkip = 0, lastActiveSegId = 0;
  int deltaQPresent = 0, deltaQRes = 0, deltaLfPresent = 0, deltaLfRes = 0, deltaLfMulti = 0;
  int codedLossless = 0, allLossless = 0;
  int losslessArray[8] = {0};
  // Loop filter.
  int loopFilterLevel[4] = {0};
  int loopFilterSharpness = 0, loopFilterDeltaEnabled = 0;
  int loopFilterRefDeltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
  int loopFilterModeDeltas[2] = {0, 0};
  // CDEF.
  int cdefDamping = 3, cdefBits = 0;
  int cdefYPri[8] = {0}, cdefYSec[8] = {0}, cdefUvPri[8] = {0}, cdefUvSec[8] = {0};
  // Loop restoration.
  int frameRestorationType[3] = {0};
  int loopRestorationSize[3] = {0};
  int usesLr = 0;
  int txModeSelect = 0, reducedTxSet = 0;
};

// One decoded frame: planes of the frame's size (chroma subsampled), of
// 8-bit samples in plane, of 10 or 12 in plane16.
struct Planes {
  int width = 0, height = 0, bitDepth = 8;
  int subX = 1, subY = 1, mono = 0;
  int colorRange = 0, colorPrimaries = 2, transferCharacteristics = 2, matrixCoefficients = 2;
  std::vector<uint8_t> plane[3];
  std::vector<uint16_t> plane16[3];
  int stride[3] = {0, 0, 0};
  int planeWidth[3] = {0, 0, 0}, planeHeight[3] = {0, 0, 0};
};

// Decode the AV1 stream of an AVIF item (its OBUs) into planes.  Throws
// Error.  `counts` may be null.
void decode(const uint8_t* data, size_t size, Planes* out, Counts* counts);

}  // namespace av1
}  // namespace byogan
