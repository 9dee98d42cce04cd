// The symbol decoder (AV1 specification 8.2.2-8.2.6) and the CDFs a tile
// starts from (init_non_coeff_cdfs and init_coeff_cdfs of 7.20).

#include <algorithm>

#include "av1_decoder.h"

namespace byogan {
namespace av1 {

uint32_t SymbolDecoder::bits(int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; i++, bitpos++) {
    size_t byte = bitpos >> 3;
    int bit = byte < size ? (data[byte] >> (7 - (bitpos & 7))) & 1 : 0;
    v = (v << 1) | bit;
  }
  return v;
}

void SymbolDecoder::init(const uint8_t* d, size_t sz, bool disable_cdf_update) {
  data = d;
  size = sz;
  bitpos = 0;
  update = !disable_cdf_update;
  int numBits = (int)std::min<size_t>(sz * 8, 15);
  uint32_t buf = bits(numBits);
  uint32_t paddedBuf = buf << (15 - numBits);
  value = ((1u << 15) - 1) ^ paddedBuf;
  range = 1u << 15;
  maxBits = (int64_t)8 * sz - 15;
}

int SymbolDecoder::symbol(uint16_t* cdf, int n) {
  uint32_t cur = range, prev;
  int sym = -1;
  do {
    sym++;
    prev = cur;
    uint32_t f = (1u << 15) - cdf[sym];
    cur = ((range >> 8) * (f >> 6) >> 1) + 4 * (uint32_t)(n - sym - 1);
  } while (value < cur);
  range = prev - cur;
  value -= cur;
  int b = 15 - floor_log2(range);
  range <<= b;
  int numBits = (int)std::min<int64_t>(b, std::max<int64_t>(0, maxBits));
  uint32_t newData = bits(numBits);
  uint32_t paddedData = newData << (b - numBits);
  value = paddedData ^ (((value + 1) << b) - 1);
  maxBits -= b;
  if (update) {
    int rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + std::min(floor_log2(n), 2);
    uint32_t tmp = 0;
    for (int i = 0; i < n - 1; i++) {
      if (i == sym) tmp = 1u << 15;
      if (tmp < cdf[i])
        cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
      else
        cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
    }
    cdf[n] += (cdf[n] < 32);
  }
  return sym;
}

int SymbolDecoder::boolean() {
  uint16_t cdf[3] = {1 << 14, 1 << 15, 0};
  bool u = update;
  update = false;
  int b = symbol(cdf, 2);
  update = u;
  return b;
}

int SymbolDecoder::literal(int n) {
  int x = 0;
  for (int i = 0; i < n; i++) x = 2 * x + boolean();
  return x;
}

int SymbolDecoder::ns(int n) {
  int w = floor_log2(n) + 1;
  int m = (1 << w) - n;
  int v = literal(w - 1);
  if (v < m) return v;
  int extra = literal(1);
  return (v << 1) - m + extra;
}

#define COPY(dst, src) std::memcpy(dst, src, sizeof(dst))

void Cdfs::init(int base_q_idx) {
  COPY(yMode, kYMode);
  COPY(uvModeCflNotAllowed, kUvModeCflNotAllowed);
  COPY(uvModeCflAllowed, kUvModeCflAllowed);
  COPY(angleDelta, kAngleDelta);
  COPY(partitionW8, kPartitionW8);
  COPY(partitionW16, kPartitionW16);
  COPY(partitionW32, kPartitionW32);
  COPY(partitionW64, kPartitionW64);
  COPY(partitionW128, kPartitionW128);
  COPY(tx8x8, kTx8x8);
  COPY(tx16x16, kTx16x16);
  COPY(tx32x32, kTx32x32);
  COPY(tx64x64, kTx64x64);
  COPY(segmentId, kSegmentId);
  COPY(skip, kSkip);
  COPY(deltaQ, kDeltaQ);
  COPY(deltaLf, kDeltaLf);
  for (int i = 0; i < 4; i++) COPY(deltaLfMulti[i], kDeltaLf);
  COPY(filterIntra, kFilterIntra);
  COPY(filterIntraMode, kFilterIntraMode);
  COPY(cflSign, kCflSign);
  COPY(cflAlpha, kCflAlpha);
  COPY(paletteYSize, kPaletteYSize);
  COPY(paletteUvSize, kPaletteUvSize);
  COPY(paletteYMode, kPaletteYMode);
  COPY(paletteUvMode, kPaletteUvMode);
  COPY(paletteYColor, kPaletteYColor);
  COPY(paletteUvColor, kPaletteUvColor);
  COPY(intraTxSet1, kIntraTxSet1);
  COPY(intraTxSet2, kIntraTxSet2);
  COPY(restorationType, kRestorationType);
  COPY(useWiener, kUseWiener);
  COPY(useSgrproj, kUseSgrproj);
  COPY(intrabc, kIntrabc);
  COPY(mvJoint, kMvJoint);
  for (int comp = 0; comp < 2; comp++) {
    COPY(mvClass[comp], kMvClass);
    COPY(mvClass0Bit[comp], kMvClass0Bit);
    COPY(mvBit[comp], kMvBit);
    COPY(mvSign[comp], kMvSign);
  }
  COPY(txfmSplit, kTxfmSplit);
  COPY(interTxSet1, kInterTxSet1);
  COPY(interTxSet2, kInterTxSet2);
  COPY(interTxSet3, kInterTxSet3);
  int idx = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
  COPY(txbSkip, kTxbSkip[idx]);
  COPY(eobPt16, kEobPt16[idx]);
  COPY(eobPt32, kEobPt32[idx]);
  COPY(eobPt64, kEobPt64[idx]);
  COPY(eobPt128, kEobPt128[idx]);
  COPY(eobPt256, kEobPt256[idx]);
  COPY(eobPt512, kEobPt512[idx]);
  COPY(eobPt1024, kEobPt1024[idx]);
  COPY(eobExtra, kEobExtra[idx]);
  COPY(dcSign, kDcSign[idx]);
  COPY(coeffBaseEob, kCoeffBaseEob[idx]);
  COPY(coeffBase, kCoeffBase[idx]);
  COPY(coeffBr, kCoeffBr[idx]);
}

#undef COPY

}  // namespace av1
}  // namespace byogan
