// JPEG 2000 tier-1 (ISO/IEC 15444-1 Annexes C and D): the MQ arithmetic
// decoder, the raw (bypass) bit reader and the three coding passes of a
// code-block, as OpenJPEG 2.5.4's t1.c and mqc.c decode them.  A segment is
// read as if two 0xFF bytes followed it (OpenJPEG writes them past each
// segment), so the decoder feeds ones past its end as the standard's
// BYTEIN does.

#include <cstring>
#include <vector>

#include "jpeg2000.h"

namespace byogan {
namespace j2k {
namespace {

// Table C.2: each state's Qe, the next state after an MPS and after an LPS,
// and whether an LPS switches the MPS.
struct QeState {
  uint32_t qe;
  uint8_t nmps, nlps, flip;
};
constexpr QeState kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1C01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02A1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

// The contexts (Table D.7): zero coding 0-8, sign 9-13, refinement 14-16,
// run length 17, uniform 18.
constexpr int kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kContexts = 19;

struct Mq {
  const uint8_t* bp = nullptr;
  uint32_t c = 0, a = 0, ct = 0;
  uint8_t state[kContexts] = {}, mps[kContexts] = {};

  void reset_contexts() {
    memset(state, 0, sizeof state);
    memset(mps, 0, sizeof mps);
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[0] = 4;
  }

  void bytein() {
    if (bp[0] == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += (uint32_t)bp[0] << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += (uint32_t)bp[0] << 8;
      ct = 8;
    }
  }

  // INITDEC on a segment followed by two 0xFF bytes.
  void init(const uint8_t* data) {
    bp = data;
    c = (uint32_t)bp[0] << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }

  int decode(int cx) {
    const QeState& q = kQe[state[cx]];
    int d;
    a -= q.qe;
    if ((c >> 16) < q.qe) {
      if (a < q.qe) {
        d = mps[cx];
        state[cx] = q.nmps;
      } else {
        d = 1 - mps[cx];
        if (q.flip) mps[cx] ^= 1;
        state[cx] = q.nlps;
      }
      a = q.qe;
      renorm();
    } else {
      c -= q.qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < q.qe) {
          d = 1 - mps[cx];
          if (q.flip) mps[cx] ^= 1;
          state[cx] = q.nlps;
        } else {
          d = mps[cx];
          state[cx] = q.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// The raw bits of a bypassed segment (OpenJPEG's opj_mqc_raw_decode): a byte
// after 0xFF gives 7 bits, and past the end the reader stays on 0xFF.
struct Raw {
  const uint8_t* bp = nullptr;
  uint32_t c = 0, ct = 0;

  void init(const uint8_t* data) {
    bp = data;
    c = 0;
    ct = 0;
  }

  int decode() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (bp[0] > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = bp[0];
          bp++;
          ct = 7;
        }
      } else {
        c = bp[0];
        bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

// Zero-coding context from the significant neighbours (Table D.1): h, v and
// d the horizontal, vertical and diagonal counts.  OpenJPEG swaps h and v
// for its orientation 2.
inline int zc_context(int h, int v, int d, int orient) {
  if (orient == 3) {
    int hv = h + v;
    if (d == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
    if (d == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
    if (d == 2) return hv == 0 ? 6 : 7;
    return 8;
  }
  if (orient == 1) {
    int t = h;
    h = v;
    v = t;
  }
  if (h == 0) {
    if (v == 0) return d == 0 ? 0 : d == 1 ? 1 : 2;
    return v == 1 ? 3 : 4;
  }
  if (h == 1) return v == 0 ? (d == 0 ? 5 : 6) : 7;
  return 8;
}

// A code-block's state: coefficients and flags on a grid with a border of
// one, so that every neighbour of a coefficient exists.
class Block {
 public:
  Block(int w, int h, int orient, int cblksty)
      : w_(w), h_(h), stride_(w + 2), orient_(orient), vsc_((cblksty & kVsc) != 0),
        sig_((size_t)(w + 2) * (h + 2)), neg_((size_t)(w + 2) * (h + 2)), visited_((size_t)(w + 2) * (h + 2)),
        refined_((size_t)(w + 2) * (h + 2)), data_((size_t)w * h) {}

  int32_t* data() { return data_.data(); }

  // Whether the row below (x, y) counts: not in vertically causal mode
  // from the last row of a stripe.
  bool south(int y) const { return !(vsc_ && (y & 3) == 3); }

  int zc(int i, int y) const {
    const uint8_t* s = sig_.data();
    int h = s[i - 1] + s[i + 1];
    int v = s[i - stride_];
    int d = s[i - stride_ - 1] + s[i - stride_ + 1];
    if (south(y)) {
      v += s[i + stride_];
      d += s[i + stride_ - 1] + s[i + stride_ + 1];
    }
    return zc_context(h, v, d, orient_);
  }

  bool any_neighbour(int i, int y) const {
    const uint8_t* s = sig_.data();
    if (s[i - 1] | s[i + 1] | s[i - stride_] | s[i - stride_ - 1] | s[i - stride_ + 1]) return true;
    return south(y) && (s[i + stride_] | s[i + stride_ - 1] | s[i + stride_ + 1]);
  }

  int contribution(int j) const { return sig_[j] ? (neg_[j] ? -1 : 1) : 0; }

  // The sign's context and the bit it is XORed with (Table D.3).
  void sc(int i, int y, int* ctx, int* flip) const {
    int hc = contribution(i - 1) + contribution(i + 1);
    int vc = contribution(i - stride_) + (south(y) ? contribution(i + stride_) : 0);
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    if (hc == 0) {
      *ctx = kCtxSc + (vc == 0 ? 0 : 1);
      *flip = vc < 0;
    } else {
      *ctx = kCtxSc + 2 + (vc == 0 ? 1 : (vc == hc ? 2 : 0));
      *flip = hc < 0;
    }
  }

  int mag(int i, int y) const { return kCtxMag + (refined_[i] ? 2 : any_neighbour(i, y) ? 1 : 0); }

  void significant(int i, int x, int y, int negative, int32_t value) {
    sig_[i] = 1;
    neg_[i] = (uint8_t)negative;
    data_[(size_t)y * w_ + x] = negative ? -value : value;
  }

  void refine(int i, int x, int y, int bit, int32_t half) {
    int32_t& v = data_[(size_t)y * w_ + x];
    v += (bit ^ (v < 0)) ? half : -half;
    refined_[i] = 1;
  }

  // The passes at bit-plane bpno (plus OpenJPEG's half step): from the MQ
  // decoder, or from raw bits where `raw` is given (bypass).
  void sigpass(Mq& mq, Raw* raw, int bpno);
  void refpass(Mq& mq, Raw* raw, int bpno);
  void clnpass(Mq& mq, int bpno, bool segsym);

 private:
  int index(int x, int y) const { return (y + 1) * stride_ + x + 1; }

  int w_, h_, stride_, orient_;
  bool vsc_;
  std::vector<uint8_t> sig_, neg_, visited_, refined_;
  std::vector<int32_t> data_;
};

void Block::sigpass(Mq& mq, Raw* raw, int bpno) {
  const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
  for (int y0 = 0; y0 < h_; y0 += 4)
    for (int x = 0; x < w_; x++)
      for (int y = y0; y < y0 + 4 && y < h_; y++) {
        int i = index(x, y);
        if (sig_[i] || visited_[i] || !any_neighbour(i, y)) continue;
        int bit, negative = 0;
        if (raw) {
          bit = raw->decode();
          if (bit) negative = raw->decode();
        } else {
          bit = mq.decode(zc(i, y));
          if (bit) {
            int ctx, flip;
            sc(i, y, &ctx, &flip);
            negative = mq.decode(ctx) ^ flip;
          }
        }
        if (bit) significant(i, x, y, negative, oneplushalf);
        visited_[i] = 1;
      }
}

void Block::refpass(Mq& mq, Raw* raw, int bpno) {
  const int32_t half = (1 << bpno) >> 1;
  for (int y0 = 0; y0 < h_; y0 += 4)
    for (int x = 0; x < w_; x++)
      for (int y = y0; y < y0 + 4 && y < h_; y++) {
        int i = index(x, y);
        if (!sig_[i] || visited_[i]) continue;
        int bit = raw ? raw->decode() : mq.decode(mag(i, y));
        refine(i, x, y, bit, half);
      }
}

void Block::clnpass(Mq& mq, int bpno, bool segsym) {
  const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
  auto step = [&](int x, int y, bool known) {
    int i = index(x, y);
    if (!known) {
      if (sig_[i] || visited_[i]) return;
      if (!mq.decode(zc(i, y))) return;
    }
    int ctx, flip;
    sc(i, y, &ctx, &flip);
    significant(i, x, y, mq.decode(ctx) ^ flip, oneplushalf);
  };
  for (int y0 = 0; y0 < h_; y0 += 4)
    for (int x = 0; x < w_; x++) {
      int first = y0;
      if (y0 + 4 <= h_) {
        // run-length mode where the four coefficients of the column are
        // insignificant, unvisited and without a significant neighbour
        bool zero = true;
        for (int y = y0; y < y0 + 4 && zero; y++) {
          int i = index(x, y);
          zero = !sig_[i] && !visited_[i] && !any_neighbour(i, y);
        }
        if (zero) {
          if (!mq.decode(kCtxAgg)) continue;
          int run = mq.decode(kCtxUni);
          run = (run << 1) | mq.decode(kCtxUni);
          step(x, y0 + run, true);
          first = y0 + run + 1;
        }
      }
      for (int y = first; y < y0 + 4 && y < h_; y++) step(x, y, false);
    }
  std::fill(visited_.begin(), visited_.end(), 0);
  if (segsym)  // four bits with the uniform context (0xA), which OpenJPEG only warns about
    for (int k = 0; k < 4; k++) mq.decode(kCtxUni);
}

}  // namespace

bool decode_codeblock(const uint8_t* data, const std::vector<Segment>& segments, int w, int h, int orient,
                      int numbps, int roishift, int cblksty, int32_t* out) {
  int bpno_plus_one = roishift + numbps;
  if (bpno_plus_one >= 31) return false;
  Block block(w, h, orient, cblksty);
  Mq mq;
  Raw raw;
  mq.reset_contexts();
  std::vector<uint8_t> buffer;
  int passtype = 2;
  size_t at = 0;
  for (const Segment& seg : segments) {
    bool bypass = bpno_plus_one <= numbps - 4 && passtype < 2 && (cblksty & kBypass);
    buffer.assign(data + at, data + at + seg.len);
    buffer.insert(buffer.end(), {0xFF, 0xFF, 0xFF, 0xFF});
    at += seg.len;
    if (bypass)
      raw.init(buffer.data());
    else
      mq.init(buffer.data());
    for (int pass = 0; pass < seg.passes && bpno_plus_one >= 1; pass++) {
      if (passtype == 0) {
        block.sigpass(mq, bypass ? &raw : nullptr, bpno_plus_one);
      } else if (passtype == 1) {
        block.refpass(mq, bypass ? &raw : nullptr, bpno_plus_one);
      } else {
        block.clnpass(mq, bpno_plus_one, (cblksty & kSegsym) != 0);
      }
      if ((cblksty & kReset) && !bypass) mq.reset_contexts();
      if (++passtype == 3) {
        passtype = 0;
        bpno_plus_one--;
      }
    }
  }
  const int32_t* d = block.data();
  if (roishift) {
    // the max-shift region: magnitudes at or above 2^roishift shifted down
    if (roishift >= 31) {
      std::fill(out, out + (size_t)w * h, 0);
      return true;
    }
    const int32_t thresh = 1 << roishift;
    for (size_t k = 0; k < (size_t)w * h; k++) {
      int32_t v = d[k], m = v < 0 ? -v : v;
      if (m >= thresh) {
        m >>= roishift;
        v = v < 0 ? -m : m;
      }
      out[k] = v;
    }
    return true;
  }
  memcpy(out, d, sizeof(int32_t) * w * h);
  return true;
}

}  // namespace j2k
}  // namespace byogan
