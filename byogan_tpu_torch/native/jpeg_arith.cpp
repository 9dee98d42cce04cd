// The arithmetic entropy decoder of JPEG (T.81 Annex D and F.2.4, G.1.3),
// as libjpeg-turbo's jdarith.c decodes it: the QM coder's registers and
// probability state machine (jaricom.c's jpeg_aritab), the DC and AC
// statistics areas of each table with their conditioning from the DAC
// marker, restart intervals that reset the statistics, sequential scans and
// the four progressive passes (DC first and refine, AC first and refine).
// It fills the coefficient image that the Huffman decoder fills, for the
// same dequantisation, IDCT, upsampling and colour path.
//
// Reaching a marker inside a scan's data is legal here (the encoder drops
// the final zero bytes): the decoder reads zero bytes from there on, as
// libjpeg does.  Running off the file's end is "truncated"; the codes that
// libjpeg decodes with a warning and then ignores until the next restart
// (a magnitude or a run past its range) break the format's rules.

#include "jpeg.h"

namespace byogan {
namespace jpeg {

// jaricom.c's jpeg_aritab, T.81's Table D.3: for each state, Qe_Value << 16
// | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS.  State 113 is
// the fixed even probability of the sign and refinement bits.
#define V(qe, lps, mps, sw) (((int32_t)(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
extern const int32_t kAriTab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0),
};
#undef V

namespace {

constexpr int kDcBins = 64, kAcBins = 256;

class ArithDecoder final : public Entropy {
 public:
  ArithDecoder(const Scan& scan, const ArithConditioning& cond, const uint8_t* end)
      : scan_(scan), cond_(cond), end_(end) {
    if (!scan.progressive) kind_ = kSeq;
    else if (scan.ss == 0) kind_ = scan.ah ? kDcRefine : kDcFirst;
    else kind_ = scan.ah ? kAcRefine : kAcFirst;
    dc_used_ = kind_ == kSeq || kind_ == kDcFirst;
    ac_used_ = kind_ == kSeq || kind_ == kAcFirst || kind_ == kAcRefine;
  }

  // start_pass and process_restart: the statistics of the tables this scan
  // uses, the DC predictions and contexts, and the coder's registers reset.
  void start(const uint8_t* p) override {
    for (int i = 0; i < scan_.n; i++) {
      const Component& k = *scan_.comp[i];
      if (dc_used_) memset(dc_stats_[k.td], 0, kDcBins);
      if (ac_used_) memset(ac_stats_[k.ta], 0, kAcBins);
      last_dc_[i] = 0;
      dc_context_[i] = 0;
    }
    p_ = p;
    marker_ = false;
    c_ = 0;
    a_ = 0;
    ct_ = -16;  // two bytes to read into C first
    fixed_bin_ = 113;
  }

  const uint8_t* stop() override {
    if (ended_) fail(kTruncated);
    return p_;
  }

  void mcu(int16_t* const* blocks, const int* which, int count) override {
    switch (kind_) {
      case kSeq:
        for (int i = 0; i < count; i++) {
          const Component& k = *scan_.comp[which[i]];
          int16_t* blk = blocks[i];
          blk[0] = (int16_t)dc_diff(which[i], k.td);
          ac(blk, k.ta, 1, 63, 0);
        }
        break;
      case kDcFirst:
        for (int i = 0; i < count; i++)
          blocks[i][0] = (int16_t)((unsigned)dc_diff(which[i], scan_.comp[which[i]]->td) << scan_.al);
        break;
      case kDcRefine:  // the next bit of the two's-complement DC value
        for (int i = 0; i < count; i++)
          if (decode(&fixed_bin_)) blocks[i][0] = (int16_t)(blocks[i][0] | (1 << scan_.al));
        break;
      case kAcFirst:
        ac(blocks[0], scan_.comp[0]->ta, scan_.ss, scan_.se, scan_.al);
        break;
      case kAcRefine:
        ac_refine(blocks[0], scan_.comp[0]->ta);
        break;
    }
  }

 private:
  enum Kind { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine };
  Scan scan_;
  const ArithConditioning& cond_;
  Kind kind_;
  bool dc_used_, ac_used_;
  const uint8_t* end_;
  const uint8_t* p_ = nullptr;
  bool marker_ = false;  // reached a marker: zero bytes from here on
  bool ended_ = false;   // ran off the file's end
  int64_t c_ = 0;        // C register: the base of the interval, with the input bits below it
  int64_t a_ = 0;        // A register: the interval's size, normalised
  int ct_ = -16;         // bits left in C's input part
  int last_dc_[4] = {0};
  int dc_context_[4] = {0};
  uint8_t fixed_bin_ = 113;
  uint8_t dc_stats_[16][kDcBins];
  uint8_t ac_stats_[16][kAcBins];

  // get_byte with the marker handling of arith_decode: 0xFF 0x00 is 0xFF;
  // at a marker or the file's end, zero bytes.
  int next_byte() {
    if (marker_) return 0;
    if (p_ >= end_) {
      ended_ = true;
      return 0;
    }
    int data = *p_++;
    if (data == 0xFF) {
      const uint8_t* q = p_;
      while (q < end_ && *q == 0xFF) q++;  // fill bytes
      if (q >= end_) {
        ended_ = true;
        p_ = q;
        return 0;
      }
      if (*q == 0) {
        p_ = q + 1;
      } else {
        marker_ = true;  // p_ stays on the marker's 0xFF for the marker reader
        p_ = q - 1;
        data = 0;
      }
    }
    return data;
  }

  // arith_decode: one binary decision with the adaptive state *st.
  int decode(uint8_t* st) {
    // renormalisation and data input (D.2.6)
    while (a_ < 0x8000) {
      if (--ct_ < 0) {
        c_ = (c_ << 8) | next_byte();
        if ((ct_ += 8) < 0) {
          if (++ct_ == 0) a_ = 0x8000;  // two initial bytes read: A becomes 0x10000 below
        }
      }
      a_ <<= 1;
    }
    int sv = *st;
    int32_t qe = kAriTab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    // decoding and probability estimation (D.2.4, D.2.5)
    int64_t temp = a_ - qe;
    a_ = temp;
    temp <<= ct_;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {  // conditional exchange: the LPS interval was the larger
        a_ = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_ < 0x8000) {
      if (a_ < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // F.1.4.4.1 / F.2.4.1: one DC difference of the scan's component i,
  // added to its prediction (kept to 16 bits, as JCOEF keeps it); returns
  // the new prediction.
  int dc_diff(int i, int tbl) {
    uint8_t* st = dc_stats_[tbl] + dc_context_[i];
    if (decode(st) == 0) {
      dc_context_[i] = 0;
      return last_dc_[i];
    }
    const int sign = decode(st + 1);
    st += 2 + sign;
    int m = decode(st);
    if (m != 0) {
      st = dc_stats_[tbl] + 20;  // X1
      while (decode(st)) {
        if ((m <<= 1) == 0x8000) fail(kCorrupt);  // magnitude overflow
        st++;
      }
    }
    // the conditioning category of the next difference (F.1.4.4.1.2)
    if (m < (int)((1L << cond_.dc_l[tbl]) >> 1)) dc_context_[i] = 0;
    else if (m > (int)((1L << cond_.dc_u[tbl]) >> 1)) dc_context_[i] = 12 + sign * 4;
    else dc_context_[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc_[i] = (last_dc_[i] + v) & 0xFFFF;
    return last_dc_[i];
  }

  // F.1.4.4.2 / F.2.4.2 (decode_mcu's AC loop and decode_mcu_AC_first):
  // coefficients ss..se, each scaled by 2^al.
  void ac(int16_t* blk, int tbl, int ss, int se, int al) {
    uint8_t* stats = ac_stats_[tbl];
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (decode(st)) break;  // end of block
      while (decode(st + 1) == 0) {
        st += 3;
        if (++k > se) fail(kCorrupt);  // spectral overflow
      }
      const int sign = decode(&fixed_bin_);
      st += 2;
      int m = decode(st);
      if (m != 0) {
        if (decode(st)) {
          m <<= 1;
          st = stats + (k <= cond_.ac_k[tbl] ? 189 : 217);
          while (decode(st)) {
            if ((m <<= 1) == 0x8000) fail(kCorrupt);  // magnitude overflow
            st++;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)((unsigned)v << al);
    }
  }

  // G.1.3.3 (decode_mcu_AC_refine): a correction bit for each coefficient
  // already nonzero, new coefficients of +-2^al, up to the end of block.
  void ac_refine(int16_t* blk, int tbl) {
    const int ss = scan_.ss, se = scan_.se;
    const int p1 = 1 << scan_.al, m1 = (int)(-1u << scan_.al);
    uint8_t* stats = ac_stats_[tbl];
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && decode(st)) break;  // end of block
      while (true) {
        int16_t* c = blk + kNatural[k];
        if (*c) {  // previously nonzero
          if (decode(st + 2)) *c = (int16_t)(*c < 0 ? *c + m1 : *c + p1);
          break;
        }
        if (decode(st + 1)) {  // newly nonzero
          *c = (int16_t)(decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) fail(kCorrupt);  // spectral overflow
      }
    }
  }
};

}  // namespace

Entropy* new_arith_decoder(const Scan& scan, const ArithConditioning& cond, const uint8_t* end) {
  return new ArithDecoder(scan, cond, end);
}

}  // namespace jpeg
}  // namespace byogan
