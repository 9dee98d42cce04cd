// Lossless JPEG (T.81 Annex H: SOF3, Huffman) as libjpeg-turbo 3.1.3
// decodes it for 8-bit samples: jdlhuff.c's difference decoding (the DC
// tables' categories 0-15, and 16, which is 32768 with no extra bits),
// jddiffct.c's MCU rows and restarts (which fall on whole MCU rows), and
// jdlossls.c's undifferencing (predictors 1-7; the first row of a scan and
// of each restart interval predicted from the left, its first sample from
// 2^(P-Pt-1); the first column from above; everything modulo 2^16) and
// point transform (the sample shifted up by Pt, kept to 8 bits).  The
// components' planes then take the DCT frames' upsampling and colour path.

#include "jpeg.h"

namespace byogan {
namespace jpeg {

namespace {

// One component's undifferencing state (jdlossls.c): the previous row, and
// whether the next row is predicted as a first row.
struct Undiff {
  std::vector<int> prev, row;
  bool first = true;
};

inline int predict(int psv, int ra, int rb, int rc) {
  switch (psv) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) >> 1;
  }
}

}  // namespace

const uint8_t* lossless_scan(const Scan& scan, const Huff* const* tables, int restart, int mcux, int mcuy,
                             const uint8_t* p, const uint8_t* end) {
  const int n = scan.n, psv = scan.ss, pt = scan.al;
  const int initial = 1 << (8 - pt - 1);  // 2^(P-Pt-1), P = 8
  // the differences of one iMCU row: for each component v rows (or, in a
  // scan of one component, its MCU rows) of its MCUs' width
  const int per_row = n == 1 ? scan.comp[0]->bw : mcux;
  std::vector<int> diff[4];
  Undiff state[4];
  for (int i = 0; i < n; i++) {
    const Component& k = *scan.comp[i];
    const int width = n == 1 ? k.bw : mcux * k.h;
    diff[i].assign((size_t)width * k.v, 0);
    state[i].prev.assign(k.bw, 0);
    state[i].row.assign(k.bw, 0);
  }
  Bits b;
  b.end = end;
  b.reset(p);
  int rows_to_go = restart / per_row, next_rst = 0;
  for (int iy = 0; iy < mcuy; iy++) {
    const bool last = iy == mcuy - 1;
    int mcu_rows = 1;
    if (n == 1) {
      const Component& k = *scan.comp[0];
      mcu_rows = last && k.bh % k.v ? k.bh % k.v : k.v;
    }
    for (int yoff = 0; yoff < mcu_rows; yoff++) {
      if (restart && rows_to_go == 0) {  // process_restart: the next marker, new bits, first rows
        p = b.stop();
        const int m = next_marker(&p, end);
        if (m < 0) fail(kTruncated);
        if (m != 0xD0 + next_rst) fail(kCorrupt);
        next_rst = (next_rst + 1) & 7;
        b.reset(p);
        for (int i = 0; i < n; i++) state[i].first = true;
        rows_to_go = restart / per_row;
      }
      for (int mx = 0; mx < per_row; mx++) {
        for (int i = 0; i < n; i++) {
          const Component& k = *scan.comp[i];
          const int bh = n == 1 ? 1 : k.h, bv = n == 1 ? 1 : k.v;
          const int width = n == 1 ? k.bw : mcux * k.h;
          for (int y = 0; y < bv; y++) {
            for (int x = 0; x < bh; x++) {
              int s = b.decode(*tables[i]);
              if (s) s = s == 16 ? 32768 : extend(b.get(s), s);
              const int row = n == 1 ? yoff : y;
              diff[i][(size_t)row * width + mx * bh + x] = s;
            }
          }
        }
      }
      if (restart) rows_to_go--;
    }
    // undifference and scale each component's real rows of this iMCU row
    for (int i = 0; i < n; i++) {
      Component& k = *scan.comp[i];
      Undiff& u = state[i];
      const int width = n == 1 ? k.bw : mcux * k.h;
      const int rows = last && k.bh % k.v ? k.bh % k.v : k.v;
      for (int r = 0; r < rows; r++) {
        const int* d = diff[i].data() + (size_t)r * width;
        int* out = u.row.data();
        if (u.first) {  // jpeg_undifference_first_row
          int ra = (d[0] + initial) & 0xFFFF;
          out[0] = ra;
          for (int x = 1; x < k.bw; x++) out[x] = ra = (d[x] + ra) & 0xFFFF;
          u.first = false;
        } else {
          const int* above = u.prev.data();
          int ra = (d[0] + above[0]) & 0xFFFF;
          out[0] = ra;
          for (int x = 1; x < k.bw; x++) out[x] = ra = (d[x] + predict(psv, ra, above[x], above[x - 1])) & 0xFFFF;
        }
        uint8_t* samples = k.plane.data() + (size_t)(iy * k.v + r) * k.bwp;
        for (int x = 0; x < k.bw; x++) samples[x] = (uint8_t)(out[x] << pt);
        u.prev.swap(u.row);
      }
    }
  }
  return b.stop();
}

}  // namespace jpeg
}  // namespace byogan
