// The AV1 decoder's state across its files: the headers, the frame being
// reconstructed (the specification's CurrFrame), the per-4x4 arrays the
// contexts, the loop filter and CDEF read, and the block being decoded.
// Decoder<uint8_t> decodes 8-bit samples, Decoder<uint16_t> 10- and 12-bit
// ones; each file instantiates both (its members, which it defines).

#pragma once

#include "av1.h"

namespace byogan {
namespace av1 {

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline int round2(int64_t x, int n) { return n == 0 ? (int)x : (int)((x + ((int64_t)1 << (n - 1))) >> n); }
inline int round2signed(int64_t x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline int floor_log2(uint32_t x) { int s = 0; while (x > 1) { x >>= 1; s++; } return s; }
inline int ceil_log2(uint32_t x) { if (x < 2) return 0; int i = 1; uint32_t p = 2; while (p < x) { i++; p <<= 1; } return i; }
inline int block_w4(int bs) { return 1 << kBlockWidthLog2[bs]; }
inline int block_h4(int bs) { return 1 << kBlockHeightLog2[bs]; }
inline int tx_w(int t) { return 1 << kTxWidthLog2[t]; }
inline int tx_h(int t) { return 1 << kTxHeightLog2[t]; }

template <typename Pixel>
struct Decoder {
  SequenceHeader seq;
  FrameHeader fh;
  Counts* counts = nullptr;
  int numPlanes = 3, subX = 1, subY = 1;
  int bitDepth = 8;
  // Clip1's bound, and BitDepth - 8: constants of 8-bit samples.
  int pixel_max() const { return sizeof(Pixel) == 1 ? 255 : (1 << bitDepth) - 1; }
  int depth_shift() const { return sizeof(Pixel) == 1 ? 0 : bitDepth - 8; }

  // CurrFrame: plane p at cur[p][y * stride[p] + x], allocated to whole
  // superblocks.
  std::vector<Pixel> cur[3];
  int stride[3] = {0, 0, 0}, allocH[3] = {0, 0, 0};
  Pixel& px(int p, int y, int x) { return cur[p][(size_t)y * stride[p] + x]; }

  // Per 4x4 (mi) arrays over the allocated frame, miStride a row.
  int miStride = 0, miRowsAlloc = 0;
  std::vector<uint8_t> yModes, uvModes, skips, miSizes, segmentIds, paletteSizes[2];
  std::vector<Pixel> paletteColors[2];  // 8 a mi
  // kNotDecoded, kIntra or kIntrabc (the RefFrames and IsInters of a frame
  // that allows intra block copy; kNotDecoded throughout one that does
  // not); the vectors of intra block copy (Mvs: row, column in eighths of
  // a sample); InterTxSizes.
  enum { kNotDecoded, kIntra, kIntrabc };
  std::vector<uint8_t> blockKinds, interTxSizes;
  std::vector<int32_t> mvs;  // 2 a mi
  std::vector<int8_t> deltaLFs;           // 4 a mi
  std::vector<uint8_t> lfTxSizes[3];      // transform size a 4x4 of each plane (in that plane's units)
  std::vector<int8_t> cdefIdx;            // a 64x64 unit
  int cdefStride = 0;
  std::vector<uint8_t> aboveLevel[3], aboveDc[3], leftLevel[3], leftDc[3];

  // Loop restoration units (spec 7.10's LrType, LrWiener, LrSgrSet, LrSgrXqd).
  int lrUnitRows[3] = {0}, lrUnitCols[3] = {0};
  std::vector<uint8_t> lrType[3];
  std::vector<int8_t> lrWiener[3];   // 2 x 3 a unit
  std::vector<uint8_t> lrSgrSet[3];
  std::vector<int16_t> lrSgrXqd[3];  // 2 a unit
  int refLrWiener[3][2][3];
  int refSgrXqd[3][2];

  // The tile.
  int miRowStart = 0, miRowEnd = 0, miColStart = 0, miColEnd = 0;
  Cdfs cdf;
  SymbolDecoder sd;
  int currentQIndex = 0;
  int deltaLF[4] = {0, 0, 0, 0};
  int readDeltas = 0;

  // The block.
  int miRow = 0, miCol = 0, miSize = 0;
  int hasChroma = 0, availU = 0, availL = 0, availUChroma = 0, availLChroma = 0;
  int skip = 0, segmentId = 0, lossless = 0;
  int useIntrabc = 0, mv[2] = {0, 0};
  int yMode = 0, uvMode = 0, angleDeltaY = 0, angleDeltaUV = 0;
  int useFilterIntra = 0, filterIntraMode = 0;
  int cflAlphaU = 0, cflAlphaV = 0;
  int paletteSizeY = 0, paletteSizeUV = 0;
  Pixel paletteColorsY[8] = {0}, paletteColorsU[8] = {0}, paletteColorsV[8] = {0};
  uint8_t colorMapY[64][64];
  uint8_t colorMapUV[64][64];
  int txSize = 0;
  int maxLumaW = 0, maxLumaH = 0;
  uint8_t blockDecoded[3][35][35];  // [plane][y + 1][x + 1]
  int planeTxType = 0;
  uint8_t txTypes[32][32];  // an intra block copy block's TxTypes of its luma 4x4s, [y4 - miRow][x4 - miCol]
  int32_t quant[1024];
  int32_t dequant[32][32];

  // av1_obu.cpp
  void decode_tile();
  // av1_modes.cpp
  void decode_partition(int r, int c, int bSize);
  void decode_block(int r, int c, int subSize);
  void intra_frame_mode_info();
  void palette_mode_info();
  void read_cdef();
  void read_lr(int r, int c, int bSize);
  void palette_tokens();
  int is_inside(int r, int c) const {
    return c >= miColStart && c < miColEnd && r >= miRowStart && r < miRowEnd;
  }
  int mi(int r, int c) const { return r * miStride + c; }
  int get_qindex(int ignoreDeltaQ, int segId) const;
  // av1_intrabc.cpp
  void intrabc_mode_info();
  int read_mv_component(int comp);
  void predict_inter(int plane, int baseX, int baseY, int w, int h);
  // av1_coefs.cpp
  void read_block_tx_size();
  void read_tx_depth();
  void read_var_tx_size(int row, int col, int txSz, int depth);
  int above_tx_width(int row, int col);
  int left_tx_height(int row, int col);
  void transform_tree(int startX, int startY, int w, int h);
  void reset_block_context(int bw4, int bh4);
  void residual();
  void transform_block(int plane, int baseX, int baseY, int txSz, int x, int y);
  int coeffs(int startX, int startY, int plane, int txSz);
  void reconstruct(int plane, int startX, int startY, int txSz);
  // av1_intra.cpp
  void predict_intra(int plane, int x, int y, int haveLeft, int haveAbove, int haveAboveRt, int haveBelowLft,
                     int mode, int log2W, int log2H);
  void predict_cfl(int plane, int startX, int startY, int txSz);
  void predict_palette(int plane, int startX, int startY, int x, int y, int txSz);
  // av1_deblock.cpp, av1_cdef.cpp, av1_lr.cpp
  void loop_filter_frame();
  void cdef_frame(std::vector<Pixel> (&pre)[3]);
  void lr_frame(std::vector<Pixel> (&deblocked)[3], std::vector<Pixel> (&cdefed)[3]);
};

// The residual size of a block in plane `plane` (subsampling sx, sy): the
// block size, or in chroma its subsampled size, at least 4x4, BLOCK_INVALID
// where that is no block size (av1_modes.cpp).
int get_plane_residual_size(int bs, int plane, int sx, int sy);

// av1_itx.cpp: the 2D inverse transform of `coefs` (h x w, only the top
// left 32x32 non-zero) into residual (h x w), spec 7.13.3, its intermediate
// clamps of BitDepth.
void inverse_transform_2d(const int32_t (*coefs)[32], int txSz, int txType, int lossless, int bitDepth,
                          int32_t* residual);

}  // namespace av1
}  // namespace byogan
