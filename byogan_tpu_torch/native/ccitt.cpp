// CCITT (fax) decode of one TIFF strip or tile, as libtiff 4.7.1's
// tif_fax3.c decodes it for Pillow 12.1.0: compression 2 (Modified Huffman,
// Fax3DecodeRLE, each row byte-aligned), 32771 (the same, each row aligned
// to 16 bits), 3 (T.4: Fax3Decode1D, or Fax3Decode2D where T4Options has
// its 2-D bit) and 4 (T.6: Fax4Decode).  The decoders below follow
// tif_fax3.c and tif_fax3.h macro by macro (NeedBits8, NeedBits16, SYNC_EOL,
// EXPAND1D, EXPAND2D, CHECK_b1, SETVALUE, CLEANUP_RUNS), with their names
// in the comments, on the same bit accumulator, so that a stream decodes to
// the runs libtiff finds.
//
// libtiff goes on past a bad code word (Fax3Unexpected), an uncompressed-
// mode extension (Fax3Extension, "not supported"), a row of the wrong
// length (Fax3BadLength), data that end early (Fax3PrematureEOF) and a run
// array overflow, and Pillow then shows what was decoded: each of these is
// refused here (kTiffCcittData), as is a strip libtiff fails outright.
// FillOrder 2 is undone by the caller (the bytes' bits reversed), which is
// what libtiff's bit-reversal table does.

#include <cstring>
#include <utility>
#include <vector>

#include "codec.h"

namespace byogan {
namespace {

// mkg3states' states.  Its S_Ext (an uncompressed-mode extension) and
// S_EOL (an EOL inside a row) end a row with an error or a warning in
// libtiff, so here they are kNull with every bad code word: each refused.
enum State : uint8_t { kNull, kPass, kHoriz, kV0, kVR, kVL, kTermW, kTermB, kMakeUpW, kMakeUpB, kMakeUp };

struct TabEnt {
  uint8_t state = kNull, width = 0;
  uint16_t param = 0;
};

struct Code {
  const char* bits;  // as T.4 writes it, first bit first
  uint16_t param;
};

// T.4 tables 1-3: terminating and make-up codes, white and black, and the
// extended make-up codes both colours share.
const Code kWhiteTerm[] = {
    {"00110101", 0},  {"000111", 1},   {"0111", 2},     {"1000", 3},     {"1011", 4},     {"1100", 5},
    {"1110", 6},      {"1111", 7},     {"10011", 8},    {"10100", 9},    {"00111", 10},   {"01000", 11},
    {"001000", 12},   {"000011", 13},  {"110100", 14},  {"110101", 15},  {"101010", 16},  {"101011", 17},
    {"0100111", 18},  {"0001100", 19}, {"0001000", 20}, {"0010111", 21}, {"0000011", 22}, {"0000100", 23},
    {"0101000", 24},  {"0101011", 25}, {"0010011", 26}, {"0100100", 27}, {"0011000", 28}, {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35},
    {"00010101", 36}, {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46}, {"00001010", 47},
    {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53},
    {"00100101", 54}, {"01011000", 55}, {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59},
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63}};
const Code kWhiteMakeUp[] = {
    {"11011", 64},      {"10010", 128},     {"010111", 192},    {"0110111", 256},   {"00110110", 320},
    {"00110111", 384},  {"01100100", 448},  {"01100101", 512},  {"01101000", 576},  {"01100111", 640},
    {"011001100", 704}, {"011001101", 768}, {"011010010", 832}, {"011010011", 896}, {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664},   {"010011011", 1728}};
const Code kBlackTerm[] = {
    {"0000110111", 0},   {"010", 1},          {"11", 2},           {"10", 3},           {"011", 4},
    {"0011", 5},         {"0010", 6},         {"00011", 7},        {"000101", 8},       {"000100", 9},
    {"0000100", 10},     {"0000101", 11},     {"0000111", 12},     {"00000100", 13},    {"00000111", 14},
    {"000011000", 15},   {"0000010111", 16},  {"0000011000", 17},  {"0000001000", 18},  {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23}, {"00000010111", 24},
    {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54},
    {"000000100111", 55}, {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63}};
const Code kBlackMakeUp[] = {
    {"0000001111", 64},     {"000011001000", 128},  {"000011001001", 192},  {"000001011011", 256},
    {"000000110011", 320},  {"000000110100", 384},  {"000000110101", 448},  {"0000001101100", 512},
    {"0000001101101", 576}, {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728}};
const Code kExtMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},  {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176}, {"000000010110", 2240},
    {"000000010111", 2304}, {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
// T.4's 2-D modes (mkg3states' Pass, Horiz, V0, VR and VL).
const Code kMain[] = {{"0001", 0}, {"001", 0},    {"1", 0},      {"011", 1},     {"000011", 2},
                      {"0000011", 3}, {"010", 1}, {"000010", 2}, {"0000010", 3}};
const State kMainState[] = {kPass, kHoriz, kV0, kVR, kVR, kVR, kVL, kVL, kVL};

// mkg3states' FillTable: every index whose low bits, read first bit
// lowest, are the code.
void fill(TabEnt* table, int size, const Code* codes, size_t n, State state, const State* states = nullptr) {
  for (size_t i = 0; i < n; i++) {
    const int width = (int)strlen(codes[i].bits);
    int code = 0;
    for (int b = 0; b < width; b++) code |= (codes[i].bits[b] - '0') << b;
    const TabEnt e = {uint8_t(states ? states[i] : state), uint8_t(width), codes[i].param};
    for (int c = code; c < 1 << size; c += 1 << width) table[c] = e;
  }
}

struct Tables {
  TabEnt main[128], white[4096], black[8192];
  uint8_t reverse[256];
  Tables() {
    fill(main, 7, kMain, sizeof kMain / sizeof *kMain, kNull, kMainState);
    fill(white, 12, kWhiteTerm, 64, kTermW);
    fill(white, 12, kWhiteMakeUp, sizeof kWhiteMakeUp / sizeof *kWhiteMakeUp, kMakeUpW);
    fill(white, 12, kExtMakeUp, sizeof kExtMakeUp / sizeof *kExtMakeUp, kMakeUp);
    fill(black, 13, kBlackTerm, 64, kTermB);
    fill(black, 13, kBlackMakeUp, sizeof kBlackMakeUp / sizeof *kBlackMakeUp, kMakeUpB);
    fill(black, 13, kExtMakeUp, sizeof kExtMakeUp / sizeof *kExtMakeUp, kMakeUp);
    for (int b = 0; b < 256; b++) {  // TIFFGetBitRevTable(1): the decoder reads each byte's bits lowest first
      int r = 0;
      for (int k = 0; k < 8; k++) r |= ((b >> k) & 1) << (7 - k);
      reverse[b] = (uint8_t)r;
    }
  }
};

const Tables& tables() {
  static const Tables built;
  return built;
}

// One strip's or tile's decoder state (Fax3CodecState and the locals of
// DECLARE_STATE / DECLARE_STATE_2D).  Every method returns false where
// libtiff would report an error or a warning, or give up on the strip.
struct Fax {
  const Tables& t = tables();
  const uint8_t* cp;  // next byte of input data
  const uint8_t* ep;  // end of input data
  uint64_t file_at;   // the file offset of the data's first byte (WORDALIGN tests cp's alignment)
  const uint8_t* start;
  uint32_t acc = 0;  // BitAcc
  int avail = 0;     // BitsAvail
  int lastx;
  std::vector<uint32_t> runs;
  uint32_t nruns;
  uint32_t *cur, *ref;

  Fax(const uint8_t* in, size_t n, uint64_t at, int width, bool two_d)
      : cp(in), ep(in + n), file_at(at), start(in), lastx(width) {
    // Fax3SetupState: TIFFroundup_32(rowpixels + 1, 32) runs a row, twice where a reference line is kept
    nruns = (uint32_t)((width + 1 + 31) / 32 * 32) * (two_d ? 2 : 1);
    runs.assign((size_t)nruns * 2, 0);
    cur = runs.data();
    ref = two_d ? cur + nruns : nullptr;
    if (ref) {  // Fax3PreDecode: the reference line is white
      ref[0] = (uint32_t)width;
      ref[1] = 0;
    }
  }

  // NeedBits8 / NeedBits16: false at the end of the data with no bits left;
  // past the end the accumulator is padded with zeros.
  bool need8(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)t.reverse[*cp++] << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)t.reverse[*cp++] << avail;
        if ((avail += 8) < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= (uint32_t)t.reverse[*cp++] << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  // LOOKUP8 / LOOKUP16
  bool lookup(const TabEnt* table, int width, bool wide, const TabEnt** e) {
    if (!(wide ? need16(width) : need8(width))) return false;
    *e = table + get(width);
    clr((*e)->width);
    return true;
  }

  // SYNC_EOL: skip to the bit after the next EOL.  EOLcnt is always 0
  // here: a row that meets an EOL is refused before the next row starts.
  bool sync_eol() {
    for (;;) {
      if (!need16(11)) return false;
      if (get(11) == 0) break;
      clr(1);
    }
    for (;;) {
      if (!need8(8)) return false;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    return true;
  }

  // One row into thisrun (EXPAND1D or EXPAND2D), then CLEANUP_RUNS; *pa is
  // the end of its runs.  False on every path libtiff reports or fails.
  struct Row {
    uint32_t* thisrun;
    uint32_t* pa;
    int a0 = 0, run = 0;  // a0, RunLength
  };
  bool setvalue(Row& r, int x) {  // SETVALUE
    if (r.pa >= r.thisrun + nruns) return false;  // "Buffer overflow"
    *r.pa++ = (uint32_t)(r.run + x);
    r.a0 += x;
    r.run = 0;
    return true;
  }
  // CLEANUP_RUNS on a row that reached its end: any other length is Fax3BadLength.
  bool cleanup(Row& r) {
    if (r.run && !setvalue(r, 0)) return false;
    return r.a0 == lastx;
  }
  // One colour's run: make-up codes, then a terminating code.
  bool colour_run(Row& r, bool white) {
    for (;;) {
      const TabEnt* e;
      if (!lookup(white ? t.white : t.black, white ? 12 : 13, true, &e)) return false;  // Fax3PrematureEOF
      if (e->state == (white ? kTermW : kTermB)) return setvalue(r, e->param);
      if (e->state == (white ? kMakeUpW : kMakeUpB) || e->state == kMakeUp) {
        r.a0 += e->param;
        r.run += e->param;
        continue;
      }
      return false;  // an EOL or a bad code word
    }
  }
  bool expand1d(Row& r) {  // EXPAND1D
    for (;;) {
      if (!colour_run(r, true)) return false;
      if (r.a0 >= lastx) break;
      if (!colour_run(r, false)) return false;
      if (r.a0 >= lastx) break;
      if (*(r.pa - 1) == 0 && *(r.pa - 2) == 0) r.pa -= 2;
    }
    return cleanup(r);
  }
  bool expand2d(Row& r) {  // EXPAND2D
    uint32_t* pb = ref;
    int b1 = (int)*pb++;
    auto check_b1 = [&]() -> bool {  // CHECK_b1
      if (r.pa != r.thisrun)
        while (b1 <= r.a0 && b1 < lastx) {
          if (pb + 1 >= ref + nruns) return false;
          b1 += (int)(pb[0] + pb[1]);
          pb += 2;
        }
      return true;
    };
    while (r.a0 < lastx) {
      if (r.pa >= r.thisrun + nruns) return false;
      const TabEnt* e;
      if (!lookup(t.main, 7, false, &e)) return false;
      switch (e->state) {
        case kPass:
          if (!check_b1() || pb + 1 >= ref + nruns) return false;
          b1 += (int)*pb++;
          r.run += b1 - r.a0;
          r.a0 = b1;
          b1 += (int)*pb++;
          break;
        case kHoriz: {
          const bool black_first = (r.pa - r.thisrun) & 1;
          if (!colour_run(r, !black_first) || !colour_run(r, black_first) || !check_b1()) return false;
          break;
        }
        case kV0:
          if (!check_b1() || !setvalue(r, b1 - r.a0) || pb >= ref + nruns) return false;
          b1 += (int)*pb++;
          break;
        case kVR:
          if (!check_b1() || !setvalue(r, b1 - r.a0 + e->param) || pb >= ref + nruns) return false;
          b1 += (int)*pb++;
          break;
        case kVL:
          if (!check_b1() || b1 < r.a0 + e->param || !setvalue(r, b1 - r.a0 - e->param)) return false;
          b1 -= (int)*--pb;
          break;
        default:  // an extension (uncompressed mode), an EOL inside the row
          return false;
      }
    }
    if (r.run) {
      if (r.run + r.a0 < lastx) {  // expect a final V0
        if (!need8(1) || !get(1)) return false;
        clr(1);
      }
      if (!setvalue(r, 0)) return false;
    }
    return cleanup(r);
  }

  // _TIFFFax3fillruns of a whole row: white runs 0 bits, black runs 1 bits.
  static void fill_row(uint8_t* buf, const uint32_t* run, const uint32_t* end) {
    uint32_t x = 0;
    for (bool black = false; run < end; run++, black = !black) {
      if (black)
        for (uint32_t i = x; i < x + *run; i++) buf[i >> 3] |= (uint8_t)(0x80 >> (i & 7));
      x += *run;
    }
  }
};

}  // namespace

int decode_ccitt(const uint8_t* in, size_t n, uint64_t file_at, uint32_t compression, uint32_t t4options,
                 uint32_t width, uint32_t rows, size_t row_bytes, uint8_t* out) {
  const bool two_d = compression == 4 || (compression == 3 && (t4options & 1));
  Fax f(in, n, file_at, (int)width, two_d);
  memset(out, 0, row_bytes * rows);
  for (uint32_t line = 0; line < rows; line++) {
    Fax::Row r{f.cur, f.cur};
    bool ok;
    if (compression == 2 || compression == 32771) {  // Fax3DecodeRLE
      ok = f.expand1d(r);
      if (ok && compression == 2) {  // FAXMODE_BYTEALIGN
        f.clr(f.avail & 7);
      } else if (ok) {  // FAXMODE_WORDALIGN: and a byte more where the data's next byte is odd
        f.clr(f.avail & 15);
        if (f.avail == 0 && ((f.file_at + (uint64_t)(f.cp - f.start)) & 1)) f.cp++;
      }
    } else if (compression == 3) {  // Fax3Decode1D / Fax3Decode2D
      ok = f.sync_eol();
      if (ok && two_d) {
        ok = f.need8(1);
        const bool is1d = ok && f.get(1);
        if (ok) {
          f.clr(1);
          ok = is1d ? f.expand1d(r) : f.expand2d(r);
        }
      } else if (ok) {
        ok = f.expand1d(r);
      }
    } else {  // Fax4Decode
      ok = f.expand2d(r);
    }
    if (!ok) return kTiffCcittData;
    Fax::fill_row(out + row_bytes * line, r.thisrun, r.pa);
    if (two_d) {
      if (r.pa < r.thisrun + f.nruns) *r.pa++ = 0;  // SETVALUE(0): an imaginary change for the reference line
      std::swap(f.cur, f.ref);
    }
  }
  return kOk;
}

}  // namespace byogan
