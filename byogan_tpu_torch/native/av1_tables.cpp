// The AV1 specification's constant tables other than the CDFs (those are
// av1_cdfs.cpp), each under the specification's name, and the scan orders,
// which are built from their rule at first use.

#include "av1.h"

namespace byogan {
namespace av1 {

// Num_4x4_Blocks_Wide / High, as log2 (Mi_Width_Log2, Mi_Height_Log2).
const uint8_t kBlockWidthLog2[BLOCK_SIZES] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const uint8_t kBlockHeightLog2[BLOCK_SIZES] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};

#define X BLOCK_INVALID
// Partition_Subsize[partition][bSize] (only the square sizes have entries).
const uint8_t kPartitionSubsize[10][BLOCK_SIZES] = {
    {BLOCK_4X4, X, X, BLOCK_8X8, X, X, BLOCK_16X16, X, X, BLOCK_32X32, X, X, BLOCK_64X64, X, X, BLOCK_128X128, X, X, X, X, X, X},
    {X, X, X, BLOCK_8X4, X, X, BLOCK_16X8, X, X, BLOCK_32X16, X, X, BLOCK_64X32, X, X, BLOCK_128X64, X, X, X, X, X, X},
    {X, X, X, BLOCK_4X8, X, X, BLOCK_8X16, X, X, BLOCK_16X32, X, X, BLOCK_32X64, X, X, BLOCK_64X128, X, X, X, X, X, X},
    {X, X, X, BLOCK_4X4, X, X, BLOCK_8X8, X, X, BLOCK_16X16, X, X, BLOCK_32X32, X, X, BLOCK_64X64, X, X, X, X, X, X},
    {X, X, X, BLOCK_8X4, X, X, BLOCK_16X8, X, X, BLOCK_32X16, X, X, BLOCK_64X32, X, X, BLOCK_128X64, X, X, X, X, X, X},
    {X, X, X, BLOCK_8X4, X, X, BLOCK_16X8, X, X, BLOCK_32X16, X, X, BLOCK_64X32, X, X, BLOCK_128X64, X, X, X, X, X, X},
    {X, X, X, BLOCK_4X8, X, X, BLOCK_8X16, X, X, BLOCK_16X32, X, X, BLOCK_32X64, X, X, BLOCK_64X128, X, X, X, X, X, X},
    {X, X, X, BLOCK_4X8, X, X, BLOCK_8X16, X, X, BLOCK_16X32, X, X, BLOCK_32X64, X, X, BLOCK_64X128, X, X, X, X, X, X},
    {X, X, X, X, X, X, BLOCK_16X4, X, X, BLOCK_32X8, X, X, BLOCK_64X16, X, X, X, X, X, X, X, X, X},
    {X, X, X, X, X, X, BLOCK_4X16, X, X, BLOCK_8X32, X, X, BLOCK_16X64, X, X, X, X, X, X, X, X, X},
};
#undef X

// Max_Tx_Size_Rect.
const uint8_t kMaxTxSizeRect[BLOCK_SIZES] = {TX_4X4,   TX_4X8,   TX_8X4,   TX_8X8,   TX_8X16,  TX_16X8,
                                             TX_16X16, TX_16X32, TX_32X16, TX_32X32, TX_32X64, TX_64X32,
                                             TX_64X64, TX_64X64, TX_64X64, TX_64X64, TX_4X16,  TX_16X4,
                                             TX_8X32,  TX_32X8,  TX_16X64, TX_64X16};
// Tx_Width_Log2, Tx_Height_Log2.
const uint8_t kTxWidthLog2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const uint8_t kTxHeightLog2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
// Tx_Size_Sqr, Tx_Size_Sqr_Up.
const uint8_t kTxSizeSqr[TX_SIZES_ALL] = {0, 1, 2, 3, 4, 0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 1, 1, 2, 2};
const uint8_t kTxSizeSqrUp[TX_SIZES_ALL] = {0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4, 2, 2, 3, 3, 4, 4};
// Split_Tx_Size.
const uint8_t kSplitTxSize[TX_SIZES_ALL] = {TX_4X4,   TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_4X4,  TX_4X4,
                                            TX_8X8,   TX_8X8,   TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X8,
                                            TX_8X4,   TX_8X16,  TX_16X8,  TX_16X32, TX_32X16};
// Adjusted_Tx_Size.
const uint8_t kAdjustedTxSize[TX_SIZES_ALL] = {TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_32X32, TX_4X8,  TX_8X4,
                                               TX_8X16,  TX_16X8,  TX_16X32, TX_32X16, TX_32X32, TX_32X32, TX_4X16,
                                               TX_16X4,  TX_8X32,  TX_32X8,  TX_16X32, TX_32X16};
// Transform_Row_Shift.
const uint8_t kTransformRowShift[TX_SIZES_ALL] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};

// Dc_Qlookup[0] and Ac_Qlookup[0] (8-bit samples).
const int16_t kDcQLookup[256] = {
    4,   8,   8,   9,   10,  11,  12,  12,  13,  14,  15,   16,   17,   18,   19,   19,   20,   21,   22,   23,
    24,  25,  26,  26,  27,  28,  29,  30,  31,  32,  32,   33,   34,   35,   36,   37,   38,   38,   39,   40,
    41,  42,  43,  43,  44,  45,  46,  47,  48,  48,  49,   50,   51,   52,   53,   53,   54,   55,   56,   57,
    57,  58,  59,  60,  61,  62,  62,  63,  64,  65,  66,   66,   67,   68,   69,   70,   70,   71,   72,   73,
    74,  74,  75,  76,  77,  78,  78,  79,  80,  81,  81,   82,   83,   84,   85,   85,   87,   88,   90,   92,
    93,  95,  96,  98,  99,  101, 102, 104, 105, 107, 108,  110,  111,  113,  114,  116,  117,  118,  120,  121,
    123, 125, 127, 129, 131, 134, 136, 138, 140, 142, 144,  146,  148,  150,  152,  154,  156,  158,  161,  164,
    166, 169, 172, 174, 177, 180, 182, 185, 187, 190, 192,  195,  199,  202,  205,  208,  211,  214,  217,  220,
    223, 226, 230, 233, 237, 240, 243, 247, 250, 253, 257,  261,  265,  269,  272,  276,  280,  284,  288,  292,
    296, 300, 304, 309, 313, 317, 322, 326, 330, 335, 340,  344,  349,  354,  359,  364,  369,  374,  379,  384,
    389, 395, 400, 406, 411, 417, 423, 429, 435, 441, 447,  454,  461,  467,  475,  482,  489,  497,  505,  513,
    522, 530, 539, 549, 559, 569, 579, 590, 602, 614, 626,  640,  654,  668,  684,  700,  717,  736,  755,  775,
    796, 819, 843, 869, 896, 925, 955, 988, 1022, 1058, 1098, 1139, 1184, 1232, 1282, 1336};
const int16_t kAcQLookup[256] = {
    4,    8,    9,    10,   11,   12,   13,   14,   15,   16,   17,   18,   19,   20,   21,   22,   23,   24,
    25,   26,   27,   28,   29,   30,   31,   32,   33,   34,   35,   36,   37,   38,   39,   40,   41,   42,
    43,   44,   45,   46,   47,   48,   49,   50,   51,   52,   53,   54,   55,   56,   57,   58,   59,   60,
    61,   62,   63,   64,   65,   66,   67,   68,   69,   70,   71,   72,   73,   74,   75,   76,   77,   78,
    79,   80,   81,   82,   83,   84,   85,   86,   87,   88,   89,   90,   91,   92,   93,   94,   95,   96,
    97,   98,   99,   100,  101,  102,  104,  106,  108,  110,  112,  114,  116,  118,  120,  122,  124,  126,
    128,  130,  132,  134,  136,  138,  140,  142,  144,  146,  148,  150,  152,  155,  158,  161,  164,  167,
    170,  173,  176,  179,  182,  185,  188,  191,  194,  197,  200,  203,  207,  211,  215,  219,  223,  227,
    231,  235,  239,  243,  247,  251,  255,  260,  265,  270,  275,  280,  285,  290,  295,  300,  305,  311,
    317,  323,  329,  335,  341,  347,  353,  359,  366,  373,  380,  387,  394,  401,  408,  416,  424,  432,
    440,  448,  456,  465,  474,  483,  492,  501,  510,  520,  530,  540,  550,  560,  571,  582,  593,  604,
    615,  627,  639,  651,  663,  676,  689,  702,  715,  729,  743,  757,  771,  786,  801,  816,  832,  848,
    864,  881,  898,  915,  933,  951,  969,  988,  1007, 1026, 1046, 1066, 1087, 1108, 1129, 1151, 1173, 1196,
    1219, 1243, 1267, 1292, 1317, 1343, 1369, 1396, 1423, 1451, 1479, 1508, 1537, 1567, 1597, 1628, 1660, 1692,
    1725, 1759, 1793, 1828};

// Mode_To_Angle.
const uint8_t kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};

// Dr_Intra_Derivative.
const int16_t kDrIntraDerivative[90] = {
    0, 0, 0, 1023, 0, 0, 547, 0, 0, 372, 0,  0, 0,  0,  273, 0, 0,  215, 0, 0,  178, 0, 0,  151, 0, 0,  132, 0, 0,  116,
    0, 0, 102, 0,  0, 0, 90,  0, 0, 80,  0,  0, 71, 0,  0,   64, 0, 0,  57,  0, 0,  51, 0, 0,  45,  0, 0,  0,  40, 0,
    0, 35, 0,  0,  31, 0, 0,  27, 0, 0,  23, 0, 0,  19, 0,   0, 15, 0,  0,   0, 0,  11, 0, 0,  7,   0, 0,  3,  0,  0};

// Sm_Weights_Tx_4x4 .. Sm_Weights_Tx_64x64, the weights of size n at [n, 2n).
const uint8_t kSmWeights[128] = {
    0,   0,   0,   0,   255, 149, 85,  64,  255, 197, 146, 105, 73,  50,  37,  32,  255, 225, 196, 170, 145, 123,
    102, 84,  68,  54,  43,  33,  26,  20,  17,  16,  255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111,
    101, 92,  83,  74,  66,  59,  52,  45,  39,  34,  29,  25,  21,  17,  14,  12,  10,  9,   8,   8,   255, 248,
    240, 233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163, 156, 150, 144, 138, 133, 127, 121, 116, 111, 106,
    101, 96,  91,  86,  82,  77,  73,  69,  65,  61,  57,  54,  50,  47,  44,  41,  38,  35,  32,  29,  27,  25,
    22,  20,  18,  16,  15,  13,  12,  10,  9,   8,   7,   6,   6,   5,   5,   4,   4,   4};

// Filter_Intra_Taps.
const int8_t kFilterIntraTaps[5][8][7] = {
    {{-6, 10, 0, 0, 0, 12, 0}, {-5, 2, 10, 0, 0, 9, 0}, {-3, 1, 1, 10, 0, 7, 0}, {-3, 1, 1, 2, 10, 5, 0},
     {-4, 6, 0, 0, 0, 2, 12}, {-3, 2, 6, 0, 0, 2, 9}, {-3, 2, 2, 6, 0, 2, 7}, {-3, 1, 2, 2, 6, 3, 5}},
    {{-10, 16, 0, 0, 0, 10, 0}, {-6, 0, 16, 0, 0, 6, 0}, {-4, 0, 0, 16, 0, 4, 0}, {-2, 0, 0, 0, 16, 2, 0},
     {-10, 16, 0, 0, 0, 0, 10}, {-6, 0, 16, 0, 0, 0, 6}, {-4, 0, 0, 16, 0, 0, 4}, {-2, 0, 0, 0, 16, 0, 2}},
    {{-8, 8, 0, 0, 0, 16, 0}, {-8, 0, 8, 0, 0, 16, 0}, {-8, 0, 0, 8, 0, 16, 0}, {-8, 0, 0, 0, 8, 16, 0},
     {-4, 4, 0, 0, 0, 0, 16}, {-4, 0, 4, 0, 0, 0, 16}, {-4, 0, 0, 4, 0, 0, 16}, {-4, 0, 0, 0, 4, 0, 16}},
    {{-2, 8, 0, 0, 0, 10, 0}, {-1, 3, 8, 0, 0, 6, 0}, {-1, 2, 3, 8, 0, 4, 0}, {0, 1, 2, 3, 8, 2, 0},
     {-1, 4, 0, 0, 0, 3, 10}, {-1, 3, 4, 0, 0, 4, 6}, {-1, 2, 3, 4, 0, 4, 4}, {-1, 2, 2, 3, 4, 3, 3}},
    {{-12, 14, 0, 0, 0, 14, 0}, {-10, 0, 14, 0, 0, 12, 0}, {-9, 0, 0, 14, 0, 11, 0}, {-8, 0, 0, 0, 14, 10, 0},
     {-10, 12, 0, 0, 0, 0, 14}, {-9, 1, 12, 0, 0, 0, 12}, {-8, 0, 0, 12, 0, 1, 11}, {-7, 0, 0, 1, 12, 1, 9}}};

// Intra_Edge_Kernel.
const uint8_t kIntraEdgeKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

// Mode_To_Txfm (intra modes and UV_CFL_PRED).
const uint8_t kModeToTxfm[14] = {DCT_DCT,   ADST_DCT,  DCT_ADST, DCT_DCT,  ADST_ADST, ADST_DCT, DCT_ADST,
                                 DCT_ADST,  ADST_DCT,  ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};

// Coeff_Base_Ctx_Offset.
#define SQ {{0, 1, 6, 6, 21}, {1, 6, 6, 21, 21}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}}
#define TALL {{0, 11, 11, 11, 11}, {11, 11, 11, 11, 11}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}}
#define WIDE {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}}
const uint8_t kCoeffBaseCtxOffset[TX_SIZES_ALL][5][5] = {
    {{0, 1, 6, 6, 0}, {1, 6, 6, 21, 0}, {6, 6, 21, 21, 0}, {6, 21, 21, 21, 0}, {0, 0, 0, 0, 0}},
    SQ, SQ, SQ, SQ,
    {{0, 11, 11, 11, 0}, {11, 11, 11, 11, 0}, {6, 6, 21, 21, 0}, {6, 21, 21, 21, 0}, {21, 21, 21, 21, 0}},
    {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}, {0, 0, 0, 0, 0}},
    TALL, WIDE, TALL, WIDE, TALL, WIDE,
    {{0, 11, 11, 11, 0}, {11, 11, 11, 11, 0}, {6, 6, 21, 21, 0}, {6, 21, 21, 21, 0}, {21, 21, 21, 21, 0}},
    {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}, {0, 0, 0, 0, 0}},
    TALL, WIDE, TALL, WIDE};
#undef SQ
#undef TALL
#undef WIDE

// Cos128_Lookup: round(4096 * cos(k * pi / 128)).
const int16_t kCos128[65] = {4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948, 3920,
                             3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564, 3513, 3461, 3406, 3349,
                             3290, 3229, 3166, 3102, 3035, 2967, 2896, 2824, 2751, 2675, 2598, 2520, 2440,
                             2359, 2276, 2191, 2106, 2019, 1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285,
                             1189, 1092, 995,  897,  799,  700,  601,  501,  401,  301,  201,  101,  0};

// Cdef_Directions (row and column offsets of the two taps of each direction).
const int8_t kCdefDirections[8][2][2] = {{{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
                                         {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},  {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
// Cdef_Uv_Dir[subsampling_x][subsampling_y].
const uint8_t kCdefUvDir[2][2][8] = {{{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
                                     {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};
// Div_Table.
const int16_t kDivTable[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};

// Sgr_Params: r0, e0, r1, e1.
const int16_t kSgrParams[16][4] = {{2, 140, 1, 3236}, {2, 112, 1, 2158}, {2, 93, 1, 1618}, {2, 80, 1, 1438},
                                   {2, 70, 1, 1295},  {2, 58, 1, 1177},  {2, 47, 1, 1079}, {2, 37, 1, 996},
                                   {2, 30, 1, 925},   {2, 25, 1, 863},   {0, -1, 1, 2589}, {0, -1, 1, 1618},
                                   {0, -1, 1, 1177},  {0, -1, 1, 925},   {2, 56, 0, -1},   {2, 22, 0, -1}};
// Wiener_Taps_Min, Wiener_Taps_Max, Wiener_Taps_K; Sgrproj_Xqd_Min, Sgrproj_Xqd_Max.
const int8_t kWienerTapsMin[3] = {-5, -23, -17};
const int8_t kWienerTapsMax[3] = {10, 8, 46};
const int8_t kWienerTapsK[3] = {1, 2, 3};
const int8_t kSgrprojXqdMin[2] = {-96, -32};
const int8_t kSgrprojXqdMax[2] = {31, 95};

// The scans.  Default: zig-zag for square sizes, the diagonals from the top
// row down for the tall ones and from the left column up for the wide ones;
// Mrow row by row, Mcol column by column.  Positions are row * width + col.
namespace {

struct Scans {
  std::vector<int16_t> def[TX_SIZES_ALL], row[TX_SIZES_ALL], col[TX_SIZES_ALL];
  Scans() {
    for (int t = 0; t < TX_SIZES_ALL; t++) {
      int w = 1 << kTxWidthLog2[t], h = 1 << kTxHeightLog2[t];
      if (w > 32 || h > 32) continue;
      std::vector<int16_t>& d = def[t];
      for (int s = 0; s < w + h - 1; s++) {
        std::vector<int16_t> diag;
        for (int r = 0; r < h; r++) {
          int c = s - r;
          if (c >= 0 && c < w) diag.push_back((int16_t)(r * w + c));
        }
        bool reverse = (w == h) ? (s % 2 == 0) : (w > h);
        if (reverse)
          d.insert(d.end(), diag.rbegin(), diag.rend());
        else
          d.insert(d.end(), diag.begin(), diag.end());
      }
      for (int i = 0; i < w * h; i++) {
        row[t].push_back((int16_t)i);
        col[t].push_back((int16_t)((i % h) * w + i / h));
      }
    }
  }
};

const Scans& scans() {
  static const Scans s;
  return s;
}

}  // namespace

const int16_t* default_scan(int txSz) { return scans().def[txSz].data(); }
const int16_t* mrow_scan(int txSz) { return scans().row[txSz].data(); }
const int16_t* mcol_scan(int txSz) { return scans().col[txSz].data(); }

}  // namespace av1
}  // namespace byogan
