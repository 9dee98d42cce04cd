// JPEG 2000 (ISO/IEC 15444-1) as Pillow 12.1.0 reads it through OpenJPEG
// 2.5.4: the JP2 boxes OpenJPEG reads, the codestream's markers and
// tile-parts, tier-2 (progression orders and POC, precincts, layers, tag
// trees, packed packet headers, SOP and EPH), the code-blocks' tier-1
// (jpeg2000_t1.cpp), dequantization, the inverse 5/3 and 9/7 wavelets, the
// inverse RCT and ICT and the DC level shift, each as OpenJPEG computes it
// (the 9/7 and the ICT in float, in OpenJPEG's order of operations, with
// no fused multiply-add); then, tile by tile, Pillow's Jpeg2KDecode.c
// unpackers into the image of the mode Pillow's plugin chose.  What
// OpenJPEG refuses in its strict mode (Pillow's default), and what Pillow
// finds no unpacker for, fails with Pillow's "broken data stream".

#include <algorithm>
#include <cmath>
#include <cstring>
#include <map>
#include <new>
#include <set>
#include <tuple>
#include <vector>

#include "codec.h"
#include "jpeg2000.h"

namespace byogan {
namespace {

using j2k::Segment;

struct Fail {
  int code;
};

[[noreturn]] void fail(int code = kJ2kBroken) { throw Fail{code}; }

uint32_t be16(const uint8_t* p) { return (uint32_t)p[0] << 8 | p[1]; }
uint32_t be32(const uint8_t* p) { return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3]; }
int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceildivpow2(int64_t a, int b) { return (a + ((int64_t)1 << b) - 1) >> b; }
int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// OpenJPEG's colour spaces (opj_image_t.color_space).
enum ColorSpace { kUnspecified = 0, kSrgb = 1, kGray = 2, kSycc = 3, kEycc = 4, kCmyk = 5 };

struct Comp {
  int prec = 0, sgnd = 0, dx = 1, dy = 1;
};

// A component's coding style and quantization in a tile (OpenJPEG's tccp).
struct Tccp {
  int csty = 0, numres = 0, cbw = 0, cbh = 0, cblksty = 0, qmfbid = 0;
  int prcw[33], prch[33];
  int qntsty = 0, numgbits = 0;
  int expn[97] = {}, mant[97] = {};
  int roishift = 0;
};

struct Poc {
  int res0, comp0, lay1, res1, comp1, prg;
};

// A tile's coding parameters and the data of its tile-parts (OpenJPEG's tcp).
struct Tcp {
  int csty = 0, prg = 0, numlayers = 0, mct = 0;
  std::vector<Tccp> tccps;
  std::vector<Poc> pocs;
  std::map<int, std::vector<uint8_t>> ppt;
  std::vector<uint8_t> data;
  int parts = 0, nparts = 0;
  bool has_data = false;
};

// A tag tree (B.10.2) over w x h leaves, its nodes level by level.
struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;

  void build(int w, int h) {
    nodes.clear();
    std::vector<std::pair<int, int>> levels;
    int lw = w, lh = h;
    while (true) {
      levels.push_back({lw, lh});
      if (lw * lh <= 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    int at = 0;
    for (size_t l = 0; l < levels.size(); l++) {
      int cw = levels[l].first, ch = levels[l].second, next = at + cw * ch;
      for (int j = 0; j < ch; j++)
        for (int i = 0; i < cw; i++) {
          int parent = -1;
          if (l + 1 < levels.size()) parent = next + (j / 2) * levels[l + 1].first + i / 2;
          nodes.push_back({parent, 999, 0});
        }
      at = next;
    }
  }

  void reset() {
    for (Node& n : nodes) {
      n.value = 999;
      n.low = 0;
    }
  }

  template <class Bio>
  int decode(Bio& bio, int leaf, int threshold) {
    int stack[32], depth = 0, k = leaf;
    while (nodes[k].parent >= 0) {
      stack[depth++] = k;
      k = nodes[k].parent;
    }
    int low = 0;
    while (true) {
      Node& n = nodes[k];
      if (low > n.low)
        n.low = low;
      else
        low = n.low;
      while (low < threshold && low < n.value) {
        if (bio.read(1))
          n.value = low;
        else
          ++low;
      }
      n.low = low;
      if (depth == 0) break;
      k = stack[--depth];
    }
    return nodes[k].value < threshold ? 1 : 0;
  }
};

// The packet header's bit reader (OpenJPEG's bio): a byte after 0xFF gives
// 7 bits, and past the end it reads zeros.
struct Bio {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* data, size_t n) : start(data), bp(data), end(data + n) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) {
      if (ct == 0) bytein();
      ct--;
      v |= ((buf >> ct) & 1u) << i;
    }
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
  size_t numbytes() const { return bp - start; }
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0;
  size_t first_new = 0;  // the segment the packet's first new passes continue
  std::vector<Segment> segs;
  std::vector<int> maxpasses;
  std::vector<uint32_t> newlens;
  std::vector<int> seg_newpasses;
  std::vector<uint8_t> data;
};

struct Precinct {
  int x0, y0, x1, y1, cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno = 0, x0 = 0, y0 = 0, x1 = 0, y1 = 0, numbps = 0;
  float stepsize = 0;
  std::vector<Precinct> precincts;
  bool empty() const { return x0 == x1 || y0 == y1; }
};

struct Res {
  int x0, y0, x1, y1, pdx, pdy, pw, ph, numbands;
  Band bands[3];
};

struct TileComp {
  int x0, y0, x1, y1;
  std::vector<Res> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
};

// The codestream's main header and the state of its tiles.
struct Codestream {
  int x0, y0, x1, y1, tx0, ty0, tdx, tdy, tw, th;
  std::vector<Comp> comps;
  Tcp defaults;
  std::vector<Tcp> tcps;
  std::vector<uint8_t> ppm;
  size_t ppm_at = 0;
  bool has_ppm = false;
  std::vector<int> order;  // tiles in the order OpenJPEG decodes them
  std::vector<int> resno_decoded;
};

constexpr int kSoc = 0xFF4F, kSiz = 0xFF51, kCod = 0xFF52, kCoc = 0xFF53, kTlm = 0xFF55, kPlm = 0xFF57,
              kPlt = 0xFF58, kQcd = 0xFF5C, kQcc = 0xFF5D, kRgn = 0xFF5E, kPoc = 0xFF5F, kPpm = 0xFF60,
              kPpt = 0xFF61, kCrg = 0xFF63, kCom = 0xFF64, kSot = 0xFF90, kSod = 0xFF93, kEoc = 0xFFD9,
              kCap = 0xFF50, kCpf = 0xFF59;

bool part2_marker(int m) { return m == 0xFF74 || m == 0xFF75 || m == 0xFF77 || m == 0xFF78; }

// The markers of OpenJPEG's handler table, and those it reads in the main
// header and in a tile-part header.
bool known_marker(int m) {
  return m == kSot || m == kCod || m == kCoc || m == kRgn || m == kQcd || m == kQcc || m == kPoc || m == kSiz ||
         m == kTlm || m == kPlm || m == kPlt || m == kPpm || m == kPpt || m == 0xFF91 || m == kCrg || m == kCom ||
         m == kCap || m == kCpf || part2_marker(m);
}
bool main_marker(int m) {
  return m == kCod || m == kCoc || m == kRgn || m == kQcd || m == kQcc || m == kPoc || m == kTlm || m == kPlm ||
         m == kPpm || m == kCrg || m == kCom || m == kCap || m == kCpf || part2_marker(m);
}
bool tile_marker(int m) {
  return m == kCod || m == kCoc || m == kRgn || m == kQcd || m == kQcc || m == kPoc || m == kPlt || m == kPpt ||
         m == kCom || m == 0xFF74 || m == 0xFF75 || m == 0xFF77;
}

// SPcod / SPcoc (A.6.1, A.6.2) into t; returns the bytes read.
size_t read_spcod(const uint8_t* p, size_t n, Tccp* t) {
  if (n < 5) fail();
  t->numres = p[0] + 1;
  if (t->numres > 33) fail();
  t->cbw = p[1] + 2;
  t->cbh = p[2] + 2;
  if (t->cbw > 10 || t->cbh > 10 || t->cbw + t->cbh > 12) fail();
  t->cblksty = p[3];
  if (t->cblksty & 0x80) fail();  // "Unsupported Mixed HT code-block style found"
  if (t->cblksty & j2k::kHt) fail(kJ2kHt);
  t->qmfbid = p[4];
  if (t->qmfbid > 1) fail();
  size_t at = 5;
  if (t->csty & 1) {
    if (n < at + t->numres) fail();
    for (int r = 0; r < t->numres; r++) {
      int v = p[at++];
      if (r != 0 && ((v & 0xF) == 0 || (v >> 4) == 0)) fail();
      t->prcw[r] = v & 0xF;
      t->prch[r] = v >> 4;
    }
  } else {
    for (int r = 0; r < t->numres; r++) t->prcw[r] = t->prch[r] = 15;
  }
  return at;
}

// SQcd / SQcc (A.6.4, A.6.5) into t; returns the bytes read.
size_t read_sqcd(const uint8_t* p, size_t n, Tccp* t) {
  if (n < 1) fail();
  t->qntsty = p[0] & 0x1F;
  t->numgbits = p[0] >> 5;
  size_t at = 1;
  if (t->qntsty == 1) {
    if (n < 3) fail();
    uint32_t v = be16(p + 1);
    t->expn[0] = v >> 11;
    t->mant[0] = v & 0x7FF;
    for (int b = 1; b < 97; b++) {
      int e = t->expn[0] - (b - 1) / 3;
      t->expn[b] = e > 0 ? e : 0;
      t->mant[b] = t->mant[0];
    }
    return 3;
  }
  size_t bands = t->qntsty == 0 ? n - 1 : (n - 1) / 2;
  for (size_t b = 0; b < bands; b++) {
    if (t->qntsty == 0) {
      if (b < 97) {
        t->expn[b] = p[at] >> 3;
        t->mant[b] = 0;
      }
      at += 1;
    } else {
      uint32_t v = be16(p + at);
      if (b < 97) {
        t->expn[b] = v >> 11;
        t->mant[b] = v & 0x7FF;
      }
      at += 2;
    }
  }
  return at;
}

// One marker segment of the main header (tile < 0) or of a tile-part
// header; p and n its body after the length.
void read_marker(Codestream& cs, int marker, const uint8_t* p, size_t n, int tile) {
  Tcp& tcp = tile < 0 ? cs.defaults : cs.tcps[tile];
  const int ncomp = (int)cs.comps.size();
  const size_t comp_room = ncomp <= 256 ? 1 : 2;
  auto comp_of = [&](const uint8_t* q) { return (int)(comp_room == 1 ? q[0] : be16(q)); };
  switch (marker) {
    case kCod: {
      if (n < 5) fail();
      tcp.csty = p[0];
      if (tcp.csty & ~7) fail();
      tcp.prg = p[1];
      if (tcp.prg > 4) fail();
      tcp.numlayers = (int)be16(p + 2);
      if (tcp.numlayers < 1) fail();
      tcp.mct = p[4];
      if (tcp.mct > 1) fail();
      Tccp t0 = tcp.tccps[0];
      t0.csty = tcp.csty & 1;
      if (5 + read_spcod(p + 5, n - 5, &t0) != n) fail();
      for (Tccp& t : tcp.tccps) {
        int qntsty = t.qntsty, numgbits = t.numgbits, roishift = t.roishift;
        int expn[97], mant[97];
        memcpy(expn, t.expn, sizeof expn);
        memcpy(mant, t.mant, sizeof mant);
        t = t0;
        t.qntsty = qntsty;
        t.numgbits = numgbits;
        t.roishift = roishift;
        memcpy(t.expn, expn, sizeof expn);
        memcpy(t.mant, mant, sizeof mant);
      }
      break;
    }
    case kCoc: {
      if (n < comp_room + 1) fail();
      int c = comp_of(p);
      if (c >= ncomp) fail();
      Tccp& t = tcp.tccps[c];
      t.csty = p[comp_room];
      if (comp_room + 1 + read_spcod(p + comp_room + 1, n - comp_room - 1, &t) != n) fail();
      break;
    }
    case kQcd: {
      Tccp q = tcp.tccps[0];
      if (read_sqcd(p, n, &q) != n) fail();
      for (Tccp& t : tcp.tccps) {
        t.qntsty = q.qntsty;
        t.numgbits = q.numgbits;
        memcpy(t.expn, q.expn, sizeof q.expn);
        memcpy(t.mant, q.mant, sizeof q.mant);
      }
      break;
    }
    case kQcc: {
      if (n < comp_room) fail();
      int c = comp_of(p);
      if (c >= ncomp) fail();
      if (comp_room + read_sqcd(p + comp_room, n - comp_room, &tcp.tccps[c]) != n) fail();
      break;
    }
    case kRgn: {
      if (n != comp_room + 2) fail();
      int c = comp_of(p);
      if (c >= ncomp) fail();
      tcp.tccps[c].roishift = p[comp_room + 1];
      break;
    }
    case kPoc: {
      size_t chunk = 5 + 2 * comp_room;
      if (n == 0 || n % chunk) fail();
      for (size_t at = 0; at < n; at += chunk) {
        const uint8_t* q = p + at;
        Poc poc;
        poc.res0 = q[0];
        poc.comp0 = comp_of(q + 1);
        poc.lay1 = std::min((int)be16(q + 1 + comp_room), tcp.numlayers);
        poc.res1 = q[3 + comp_room];
        poc.comp1 = std::min(comp_of(q + 4 + comp_room), ncomp);
        poc.prg = q[4 + 2 * comp_room];
        tcp.pocs.push_back(poc);
      }
      if (tcp.pocs.size() >= 32) fail();
      break;
    }
    case kPpm: {
      if (n < 1) fail();
      cs.has_ppm = true;
      cs.ppm.insert(cs.ppm.end(), p + 1, p + n);  // Zppm in order; Nppm fields stripped below
      break;
    }
    case kPpt: {
      if (n < 1 || cs.has_ppm) fail();
      if (tcp.ppt.count(p[0])) fail();
      tcp.ppt[p[0]].assign(p + 1, p + n);
      break;
    }
    case kTlm: {
      if (n < 2) fail();
      int st = (p[1] >> 4) & 3, sp = (p[1] >> 6) & 1;
      if (st == 3) fail();
      size_t q = (st ? st : 0) + (sp ? 4 : 2);
      if ((n - 2) % q) fail();
      break;
    }
    case kCrg:
      if (n != (size_t)ncomp * 4) fail();
      break;
    case kPlt: {  // Zplt, then packet lengths of 7 bits a byte, the last byte of each below 0x80
      if (n < 1) fail();
      uint32_t len = 0;
      for (size_t k = 1; k < n; k++) {
        len |= p[k] & 0x7F;
        len = (p[k] & 0x80) ? len << 7 : 0;
      }
      if (len) fail();
      break;
    }
    case kPlm:
      if (n < 1) fail();
      break;
    case kCom:
    case kCap:  // Part 15's capabilities: OpenJPEG decodes HT code-blocks by their style alone
    case kCpf:
      break;
    default:
      fail(part2_marker(marker) ? kJ2kMarker : kJ2kBroken);
  }
}

// The main header from SIZ to the first SOT; returns the offset of that SOT.
size_t read_main_header(const uint8_t* d, size_t n, Codestream& cs) {
  if (n < 4 || be16(d) != kSoc || be16(d + 2) != kSiz) fail();
  size_t at = 4;
  if (at + 2 > n) fail();
  size_t lsiz = be16(d + at);
  if (lsiz < 41 || at + lsiz > n) fail();
  const uint8_t* p = d + at + 2;
  int64_t x1 = be32(p + 2), y1 = be32(p + 6), x0 = be32(p + 10), y0 = be32(p + 14);
  int64_t tdx = be32(p + 18), tdy = be32(p + 22), tx0 = be32(p + 26), ty0 = be32(p + 30);
  int ncomp = (int)be16(p + 34);
  if ((lsiz - 38) % 3 || (int)((lsiz - 38) / 3) != ncomp || ncomp < 1 || ncomp > 16384) fail();
  if (x0 >= x1 || y0 >= y1 || tdx == 0 || tdy == 0) fail();
  if (tx0 > x0 || ty0 > y0 || tx0 + tdx <= x0 || ty0 + tdy <= y0) fail();
  cs.x0 = (int)x0;
  cs.y0 = (int)y0;
  cs.x1 = (int)x1;
  cs.y1 = (int)y1;
  if (x1 > 0x7FFFFFFF || y1 > 0x7FFFFFFF) fail();
  cs.tx0 = (int)tx0;
  cs.ty0 = (int)ty0;
  cs.tdx = (int)std::min<int64_t>(tdx, 0x7FFFFFFF);
  cs.tdy = (int)std::min<int64_t>(tdy, 0x7FFFFFFF);
  int64_t tw = ceildiv(x1 - tx0, tdx), th = ceildiv(y1 - ty0, tdy);
  if (tw == 0 || th == 0 || tw > 65535 / th) fail();
  cs.tw = (int)tw;
  cs.th = (int)th;
  cs.comps.resize(ncomp);
  for (int c = 0; c < ncomp; c++) {
    const uint8_t* q = p + 36 + 3 * c;
    cs.comps[c].prec = (q[0] & 0x7F) + 1;
    cs.comps[c].sgnd = q[0] >> 7;
    cs.comps[c].dx = q[1];
    cs.comps[c].dy = q[2];
    if (cs.comps[c].dx == 0 || cs.comps[c].dy == 0 || cs.comps[c].prec > 31) fail();
  }
  cs.defaults.tccps.resize(ncomp);
  at += lsiz;
  bool cod = false, qcd = false;
  while (true) {
    if (at + 2 > n) fail();
    int marker = (int)be16(d + at);
    if (marker < 0xFF00) fail();
    if (!known_marker(marker)) {
      // OpenJPEG's opj_j2k_read_unk: the 16-bit words after an unknown
      // marker skipped up to the next marker it knows
      do {
        at += 2;
        if (at + 2 > n) fail();
        marker = (int)be16(d + at);
      } while (marker < 0xFF00 || !known_marker(marker));
    }
    if (marker == kSot) break;
    if (!main_marker(marker)) fail();
    if (at + 4 > n) fail();
    size_t len = be16(d + at + 2);
    if (len < 2 || at + 2 + len > n) fail();
    read_marker(cs, marker, d + at + 4, len - 2, -1);
    cod |= marker == kCod;
    qcd |= marker == kQcd;
    at += 2 + len;
  }
  if (!cod || !qcd) fail();
  if (cs.has_ppm) {
    // the PPM markers' Ippm bytes, one after the other, without their Nppm
    std::vector<uint8_t> headers;
    size_t k = 0;
    while (k < cs.ppm.size()) {
      if (k + 4 > cs.ppm.size()) fail();
      size_t len = be32(&cs.ppm[k]);
      k += 4;
      if (k + len > cs.ppm.size()) fail();
      headers.insert(headers.end(), cs.ppm.begin() + k, cs.ppm.begin() + k + len);
      k += len;
    }
    cs.ppm.swap(headers);
  }
  cs.tcps.assign((size_t)cs.tw * cs.th, cs.defaults);
  cs.resno_decoded.assign(ncomp, 0);
  return at;
}

// The tile-parts from `at` to EOC, each one's header markers read into its
// tile and its data appended to the tile's, in the order OpenJPEG's
// opj_j2k_read_tile_header reads them: a tile is decoded once its last
// part (by TNsot) is read, the rest in tile order at EOC.  A stream that
// ends right after a marker's code (where OpenJPEG finds no bytes for its
// length: J2K_STATE_NEOC) ends the walk; OpenJPEG then fails on a tile it
// has data for and has not decoded (from the last SOT's tile on), and
// else decodes no more.  A stream that ends anywhere else before EOC
// fails ("Stream too short", or the strict mode's check of Psot).
void read_tile_parts(const uint8_t* d, size_t n, size_t at, Codestream& cs) {
  const int ntiles = cs.tw * cs.th;
  std::vector<char> done(ntiles, 0);
  int current = 0;  // the last SOT's tile
  auto neoc = [&]() {
    for (int t = current; t < ntiles; t++)
      if (!done[t] && cs.tcps[t].has_data) fail();
  };
  while (true) {
    if (at + 2 > n) fail();
    int marker = (int)be16(d + at);
    if (marker == kEoc) break;
    if (marker != kSot) fail();
    if (at + 2 == n) return neoc();
    if (at + 12 > n || be16(d + at + 2) != 10) fail();
    int tile = (int)be16(d + at + 4);
    uint32_t psot = be32(d + at + 6);
    int part = d[at + 10], nparts = d[at + 11];
    if (tile >= ntiles) fail();
    if (psot != 0 && psot < 14) fail();
    current = tile;
    Tcp& tcp = cs.tcps[tile];
    if (tcp.parts != part) fail();
    if (tcp.nparts && part >= tcp.nparts) fail();
    if (nparts) {
      if (part >= nparts) fail();
      tcp.nparts = nparts;
    }
    size_t end = psot ? at + psot : n - 2;
    size_t k = at + 12;
    while (true) {
      if (k + 2 > n) fail();
      int m = (int)be16(d + k);
      if (m == kSod) {
        k += 2;
        break;
      }
      if (k + 2 == n) return neoc();
      if (k + 4 > n) fail();
      size_t len = be16(d + k + 2);
      if (len < 2 || k + 2 + len > n) fail();
      if (psot == 0 || k + 2 + len > end) fail();  // "Sot length is not correct"
      if (!tile_marker(m)) fail(part2_marker(m) ? kJ2kMarker : kJ2kBroken);
      read_marker(cs, m, d + k + 4, len - 2, tile);
      k += 2 + len;
    }
    if (psot == 0 && n < k + 2) fail();
    if (end > n || k > end) fail();  // OpenJPEG's strict mode: the tile-part runs past the stream
    tcp.data.insert(tcp.data.end(), d + k, d + end);
    tcp.has_data = true;
    tcp.parts++;
    if (tcp.nparts && tcp.parts == tcp.nparts && !done[tile]) {
      done[tile] = 1;
      cs.order.push_back(tile);
    }
    at = end;
  }
  for (int t = 0; t < ntiles; t++)
    if (!done[t] && cs.tcps[t].has_data) cs.order.push_back(t);
}

// The geometry of tile `tile`'s components down to their code-blocks
// (OpenJPEG's opj_tcd_init_decode_tile).
void init_tile(const Codestream& cs, const Tcp& tcp, int tx0, int ty0, int tx1, int ty1, std::vector<TileComp>* tcs) {
  tcs->resize(cs.comps.size());
  for (size_t c = 0; c < cs.comps.size(); c++) {
    const Comp& comp = cs.comps[c];
    const Tccp& tccp = tcp.tccps[c];
    TileComp& tc = (*tcs)[c];
    tc.x0 = (int)ceildiv(tx0, comp.dx);
    tc.y0 = (int)ceildiv(ty0, comp.dy);
    tc.x1 = (int)ceildiv(tx1, comp.dx);
    tc.y1 = (int)ceildiv(ty1, comp.dy);
    tc.res.resize(tccp.numres);
    for (int r = 0; r < tccp.numres; r++) {
      Res& res = tc.res[r];
      int level = tccp.numres - 1 - r;
      res.x0 = (int)ceildivpow2(tc.x0, level);
      res.y0 = (int)ceildivpow2(tc.y0, level);
      res.x1 = (int)ceildivpow2(tc.x1, level);
      res.y1 = (int)ceildivpow2(tc.y1, level);
      res.pdx = tccp.prcw[r];
      res.pdy = tccp.prch[r];
      int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx, py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
      int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx, py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
      res.pw = res.x0 == res.x1 ? 0 : (int)((px1 - px0) >> res.pdx);
      res.ph = res.y0 == res.y1 ? 0 : (int)((py1 - py0) >> res.pdy);
      if ((int64_t)res.pw * res.ph > (1 << 26)) fail(kNoMemory);
      int64_t cbgx0, cbgy0;
      int cbgw, cbgh;
      if (r == 0) {
        cbgx0 = px0;
        cbgy0 = py0;
        cbgw = res.pdx;
        cbgh = res.pdy;
        res.numbands = 1;
      } else {
        cbgx0 = ceildivpow2(px0, 1);
        cbgy0 = ceildivpow2(py0, 1);
        cbgw = res.pdx - 1;
        cbgh = res.pdy - 1;
        res.numbands = 3;
      }
      int cbw = std::min(tccp.cbw, cbgw), cbh = std::min(tccp.cbh, cbgh);
      for (int b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        if (r == 0) {
          band.bandno = 0;
          band.x0 = (int)ceildivpow2(tc.x0, level);
          band.y0 = (int)ceildivpow2(tc.y0, level);
          band.x1 = (int)ceildivpow2(tc.x1, level);
          band.y1 = (int)ceildivpow2(tc.y1, level);
        } else {
          band.bandno = b + 1;
          int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
          band.x0 = (int)ceildivpow2(tc.x0 - (xob << level), level + 1);
          band.y0 = (int)ceildivpow2(tc.y0 - (yob << level), level + 1);
          band.x1 = (int)ceildivpow2(tc.x1 - (xob << level), level + 1);
          band.y1 = (int)ceildivpow2(tc.y1 - (yob << level), level + 1);
        }
        int stepno = r == 0 ? 0 : 3 * (r - 1) + band.bandno;
        int gain = tccp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
        int rb = comp.prec + gain;
        band.stepsize = (float)((1.0 + tccp.mant[stepno] / 2048.0) * pow(2.0, rb - tccp.expn[stepno])) * 1.0f;
        band.numbps = tccp.expn[stepno] + tccp.numgbits - 1;
        band.precincts.clear();
        if (band.empty()) continue;
        band.precincts.resize((size_t)res.pw * res.ph);
        for (int pno = 0; pno < res.pw * res.ph; pno++) {
          Precinct& prc = band.precincts[pno];
          int64_t sx = cbgx0 + (int64_t)(pno % res.pw) * ((int64_t)1 << cbgw);
          int64_t sy = cbgy0 + (int64_t)(pno / res.pw) * ((int64_t)1 << cbgh);
          prc.x0 = (int)std::max<int64_t>(sx, band.x0);
          prc.y0 = (int)std::max<int64_t>(sy, band.y0);
          prc.x1 = (int)std::min<int64_t>(sx + ((int64_t)1 << cbgw), band.x1);
          prc.y1 = (int)std::min<int64_t>(sy + ((int64_t)1 << cbgh), band.y1);
          int64_t bx0 = floordivpow2(prc.x0, cbw) << cbw, by0 = floordivpow2(prc.y0, cbh) << cbh;
          int64_t bx1 = ceildivpow2(prc.x1, cbw) << cbw, by1 = ceildivpow2(prc.y1, cbh) << cbh;
          prc.cw = bx1 > bx0 ? (int)((bx1 - bx0) >> cbw) : 0;
          prc.ch = by1 > by0 ? (int)((by1 - by0) >> cbh) : 0;
          prc.cblks.resize((size_t)prc.cw * prc.ch);
          for (int k = 0; k < prc.cw * prc.ch; k++) {
            Cblk& cb = prc.cblks[k];
            int64_t cx = bx0 + (int64_t)(k % prc.cw) * ((int64_t)1 << cbw);
            int64_t cy = by0 + (int64_t)(k / prc.cw) * ((int64_t)1 << cbh);
            cb.x0 = (int)std::max<int64_t>(cx, prc.x0);
            cb.y0 = (int)std::max<int64_t>(cy, prc.y0);
            cb.x1 = (int)std::min<int64_t>(cx + ((int64_t)1 << cbw), prc.x1);
            cb.y1 = (int)std::min<int64_t>(cy + ((int64_t)1 << cbh), prc.y1);
          }
          if (prc.cw > 0 && prc.ch > 0) {
            prc.incl.build(prc.cw, prc.ch);
            prc.imsb.build(prc.cw, prc.ch);
          }
        }
      }
    }
  }
}

struct Packet {
  int layer, res, comp, prec;
};

// The packets of a tile in the order of its progression (or of its POC
// list), each once (OpenJPEG's pi.c iterators with their include table).
void packet_order(const Codestream& cs, const Tcp& tcp, const std::vector<TileComp>& tcs, int tx0, int ty0, int tx1,
                  int ty1, std::vector<Packet>* out) {
  const int ncomp = (int)cs.comps.size();
  int maxres = 0;
  for (const Tccp& t : tcp.tccps) maxres = std::max(maxres, t.numres);
  std::vector<Poc> pocs = tcp.pocs;
  if (pocs.empty()) pocs.push_back({0, 0, tcp.numlayers, maxres, ncomp, tcp.prg});
  std::set<std::tuple<int, int, int, int>> seen;
  auto emit = [&](int l, int r, int c, int p) {
    if (seen.insert({l, r, c, p}).second) out->push_back({l, r, c, p});
  };
  for (const Poc& poc : pocs) {
    int res1 = poc.res1, comp1 = poc.comp1, lay1 = std::min(poc.lay1, tcp.numlayers);
    int prg = poc.prg;
    if (prg > 4) continue;  // OpenJPEG's opj_pi_next has no iterator for it: the entry yields no packet
    auto nres = [&](int c) { return (int)tcs[c].res.size(); };
    auto nprec = [&](int c, int r) { return tcs[c].res[r].pw * tcs[c].res[r].ph; };
    if (prg == 0) {  // LRCP
      for (int l = 0; l < lay1; l++)
        for (int r = poc.res0; r < res1; r++)
          for (int c = poc.comp0; c < comp1; c++)
            if (r < nres(c))
              for (int p = 0; p < nprec(c, r); p++) emit(l, r, c, p);
      continue;
    }
    if (prg == 1) {  // RLCP
      for (int r = poc.res0; r < res1; r++)
        for (int l = 0; l < lay1; l++)
          for (int c = poc.comp0; c < comp1; c++)
            if (r < nres(c))
              for (int p = 0; p < nprec(c, r); p++) emit(l, r, c, p);
      continue;
    }
    // the position-driven orders: the precinct of (c, r) that starts at
    // (x, y) on the reference grid, if any
    auto precinct_at = [&](int c, int r, uint32_t x, uint32_t y) -> int {
      const Comp& comp = cs.comps[c];
      const Res& res = tcs[c].res[r];
      uint32_t level = (uint32_t)(nres(c) - 1 - r);
      if (level >= 32 || (((uint32_t)comp.dx << level) >> level) != (uint32_t)comp.dx ||
          (((uint32_t)comp.dy << level) >> level) != (uint32_t)comp.dy)
        return -1;
      uint64_t ddx = (uint64_t)comp.dx << level, ddy = (uint64_t)comp.dy << level;
      uint64_t trx0 = ceildiv(tx0, ddx), try0 = ceildiv(ty0, ddy), trx1 = ceildiv(tx1, ddx), try1 = ceildiv(ty1, ddy);
      uint32_t rpx = res.pdx + level, rpy = res.pdy + level;
      if (rpx >= 31 || (((uint32_t)comp.dx << rpx) >> rpx) != (uint32_t)comp.dx || rpy >= 31 ||
          (((uint32_t)comp.dy << rpy) >> rpy) != (uint32_t)comp.dy)
        return -1;
      if (!((uint64_t)y % ((uint64_t)comp.dy << rpy) == 0 ||
            ((int)y == ty0 && ((try0 << level) % ((uint64_t)1 << rpy)))))
        return -1;
      if (!((uint64_t)x % ((uint64_t)comp.dx << rpx) == 0 ||
            ((int)x == tx0 && ((trx0 << level) % ((uint64_t)1 << rpx)))))
        return -1;
      if (res.pw == 0 || res.ph == 0) return -1;
      if (trx0 == trx1 || try0 == try1) return -1;
      uint64_t prci = (ceildiv(x, ddx) >> res.pdx) - (trx0 >> res.pdx);
      uint64_t prcj = (ceildiv(y, ddy) >> res.pdy) - (try0 >> res.pdy);
      return (int)(prci + prcj * res.pw);
    };
    auto step_of = [&](int c_lo, int c_hi, uint32_t* dx, uint32_t* dy) {
      *dx = *dy = 0;
      for (int c = c_lo; c < c_hi; c++)
        for (int r = 0; r < nres(c); r++) {
          const Comp& comp = cs.comps[c];
          const Res& res = tcs[c].res[r];
          uint32_t lv = (uint32_t)(nres(c) - 1 - r);
          if (res.pdx + lv < 32 && (uint32_t)comp.dx <= UINT32_MAX / (1u << (res.pdx + lv))) {
            uint32_t v = comp.dx * (1u << (res.pdx + lv));
            *dx = *dx ? std::min(*dx, v) : v;
          }
          if (res.pdy + lv < 32 && (uint32_t)comp.dy <= UINT32_MAX / (1u << (res.pdy + lv))) {
            uint32_t v = comp.dy * (1u << (res.pdy + lv));
            *dy = *dy ? std::min(*dy, v) : v;
          }
        }
      if (*dx == 0 || *dy == 0) fail();
    };
    auto positions = [&](uint32_t dx, uint32_t dy, auto&& body) {
      for (uint64_t y = (uint32_t)ty0; y < (uint32_t)ty1; y += dy - (y % dy))
        for (uint64_t x = (uint32_t)tx0; x < (uint32_t)tx1; x += dx - (x % dx)) body((uint32_t)x, (uint32_t)y);
    };
    uint32_t dx, dy;
    if (prg == 2) {  // RPCL
      step_of(0, ncomp, &dx, &dy);
      for (int r = poc.res0; r < res1; r++)
        positions(dx, dy, [&](uint32_t x, uint32_t y) {
          for (int c = poc.comp0; c < comp1; c++) {
            if (r >= nres(c)) continue;
            int p = precinct_at(c, r, x, y);
            if (p >= 0)
              for (int l = 0; l < lay1; l++) emit(l, r, c, p);
          }
        });
    } else if (prg == 3) {  // PCRL
      step_of(0, ncomp, &dx, &dy);
      positions(dx, dy, [&](uint32_t x, uint32_t y) {
        for (int c = poc.comp0; c < comp1; c++)
          for (int r = poc.res0; r < std::min(res1, nres(c)); r++) {
            int p = precinct_at(c, r, x, y);
            if (p >= 0)
              for (int l = 0; l < lay1; l++) emit(l, r, c, p);
          }
      });
    } else {  // CPRL
      for (int c = poc.comp0; c < comp1; c++) {
        step_of(c, c + 1, &dx, &dy);
        positions(dx, dy, [&](uint32_t x, uint32_t y) {
          for (int r = poc.res0; r < std::min(res1, nres(c)); r++) {
            int p = precinct_at(c, r, x, y);
            if (p >= 0)
              for (int l = 0; l < lay1; l++) emit(l, r, c, p);
          }
        });
      }
    }
  }
}

// A segment's most passes (OpenJPEG's opj_t2_init_seg).
int max_passes(int cblksty, bool first, int previous) {
  if (cblksty & j2k::kTermAll) return 1;
  if (cblksty & j2k::kBypass) return first ? 10 : (previous == 1 || previous == 10) ? 2 : 1;
  return 109;
}

// One packet (B.9, B.10) from data[*at, n): its header (from the packed
// headers where PPM or PPT carry them) and its code-blocks' bytes.
void read_packet(Codestream& cs, Tcp& tcp, std::vector<TileComp>& tcs, const Packet& pk, const uint8_t* data,
                 size_t n, size_t* at, std::vector<uint8_t>* ppt, size_t* ppt_at) {
  Res& res = tcs[pk.comp].res[pk.res];
  const int cblksty = tcp.tccps[pk.comp].cblksty;
  if (pk.layer == 0)
    for (int b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& prc = band.precincts[pk.prec];
      prc.incl.reset();
      prc.imsb.reset();
      for (Cblk& cb : prc.cblks) {
        cb.segs.clear();
        cb.maxpasses.clear();
      }
    }
  size_t cur = *at;
  if (tcp.csty & 2) {  // SOP
    if (n - cur >= 6 && data[cur] == 0xFF && data[cur + 1] == 0x91) cur += 6;
  }
  const uint8_t* hdata;
  size_t hlen;
  if (cs.has_ppm) {
    hdata = cs.ppm.data() + cs.ppm_at;
    hlen = cs.ppm.size() - cs.ppm_at;
  } else if (ppt) {
    hdata = ppt->data() + *ppt_at;
    hlen = ppt->size() - *ppt_at;
  } else {
    hdata = data + cur;
    hlen = n - cur;
  }
  Bio bio(hdata, hlen);
  bool present = bio.read(1);
  if (present) {
    for (int b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& prc = band.precincts[pk.prec];
      for (int k = 0; k < prc.cw * prc.ch; k++) {
        Cblk& cb = prc.cblks[k];
        int included;
        if (cb.segs.empty())
          included = prc.incl.decode(bio, k, pk.layer + 1);
        else
          included = bio.read(1);
        if (!included) continue;
        if (cb.segs.empty()) {
          int i = 0;
          while (!prc.imsb.decode(bio, k, i)) ++i;
          cb.numbps = band.numbps + 1 - i;
          cb.numlenbits = 3;
        }
        int passes;
        if (!bio.read(1))
          passes = 1;
        else if (!bio.read(1))
          passes = 2;
        else if ((passes = (int)bio.read(2)) != 3)
          passes += 3;
        else if ((passes = (int)bio.read(5)) != 31)
          passes += 6;
        else
          passes = 37 + (int)bio.read(7);
        int increment = 0;
        while (bio.read(1)) ++increment;
        cb.numlenbits += increment;
        size_t segno;
        if (cb.segs.empty()) {
          cb.segs.push_back({});
          cb.maxpasses.push_back(max_passes(cblksty, true, 0));
          segno = 0;
        } else {
          segno = cb.segs.size() - 1;
          if (cb.segs[segno].passes == cb.maxpasses[segno]) {
            cb.segs.push_back({});
            cb.maxpasses.push_back(max_passes(cblksty, false, cb.maxpasses[segno]));
            ++segno;
          }
        }
        cb.newlens.clear();
        cb.seg_newpasses.clear();
        int left = passes;
        size_t s = segno;
        while (true) {
          int take = std::min(cb.maxpasses[s] - cb.segs[s].passes, left);
          int bits = cb.numlenbits;
          for (int v = take; v > 1; v >>= 1) bits++;
          if (bits > 32) fail();
          cb.seg_newpasses.push_back(take);
          cb.newlens.push_back(bio.read(bits));
          left -= take;
          if (left <= 0) break;
          cb.segs.push_back({});
          cb.maxpasses.push_back(max_passes(cblksty, false, cb.maxpasses[s]));
          ++s;
        }
        cb.first_new = segno;
      }
    }
  }
  bio.inalign();
  size_t hbytes = bio.numbytes();
  if (tcp.csty & 4) {  // EPH, which OpenJPEG requires after every packet header
    if (hlen - hbytes < 2 || hdata[hbytes] != 0xFF || hdata[hbytes + 1] != 0x92) fail();
    hbytes += 2;
  }
  if (cs.has_ppm)
    cs.ppm_at += hbytes;
  else if (ppt)
    *ppt_at += hbytes;
  else
    cur += hbytes;
  if (present) {
    for (int b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& prc = band.precincts[pk.prec];
      for (Cblk& cb : prc.cblks) {
        if (cb.seg_newpasses.empty()) continue;
        size_t s = cb.first_new;
        for (size_t k = 0; k < cb.seg_newpasses.size(); k++, s++) {
          uint32_t len = cb.newlens[k];
          if (len > n - cur) fail();  // OpenJPEG's strict mode: a segment past the tile's data
          cb.data.insert(cb.data.end(), data + cur, data + cur + len);
          cur += len;
          cb.segs[s].len += len;
          cb.segs[s].passes += cb.seg_newpasses[k];
        }
        cb.seg_newpasses.clear();
      }
    }
  }
  cs.resno_decoded[pk.comp] = std::max(cs.resno_decoded[pk.comp], pk.res);
  *at = cur;
}

// The inverse 5/3 of one line of len samples, interleaved (x0's parity
// `cas`), with the standard's symmetric extension (OpenJPEG's
// opj_idwt53_h/v).
void idwt53_line(int32_t* x, int len, int cas) {
  if (len == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  auto at = [&](int i) { return x[i < 0 ? -i : i >= len ? 2 * (len - 1) - i : i]; };
  for (int i = cas; i < len; i += 2) x[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int i = 1 - cas; i < len; i += 2) x[i] += (at(i - 1) + at(i + 1)) >> 1;
}

constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f, kDelta = 0.443506852f,
                kK = 1.230174105f, kTwoInvK = 1.625732422f;

// OpenJPEG's opj_v8dwt_decode_step2 on one line: w[fw - 1] plus (w[fl] +
// w[fw]) times c, along the line; past m the last one plus 2c times its
// left neighbour.
void step2(float* w, int fl, int fw, uint32_t end, uint32_t m, float c) {
  uint32_t imax = std::min(end, m);
  for (uint32_t i = 0; i < imax; i++) {
    w[fw - 1] = w[fw - 1] + ((w[fl] + w[fw]) * c);
    fl = fw;
    fw += 2;
  }
  if (m < end) {
    c += c;
    w[fw - 1] = w[fw - 1] + w[fl] * c;
  }
}

// The inverse 9/7 of one interleaved line of sn low and dn high samples
// (OpenJPEG's opj_v8dwt_decode, K and 2/K as its two_invK).
void idwt97_line(float* w, int sn, int dn, int cas) {
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int i = 0; i < sn; i++) w[a + 2 * i] *= kK;
  for (int i = 0; i < dn; i++) w[b + 2 * i] *= kTwoInvK;
  auto um = [](int v) { return v < 0 ? UINT32_MAX : (uint32_t)v; };
  step2(w, b, a + 1, sn, um(std::min(sn, dn - a)), -kDelta);
  step2(w, a, b + 1, dn, um(std::min(dn, sn - b)), -kGamma);
  step2(w, b, a + 1, sn, um(std::min(sn, dn - a)), -kBeta);
  step2(w, a, b + 1, dn, um(std::min(dn, sn - b)), -kAlpha);
}

// The inverse wavelet of a tile-component, level by level, rows then
// columns (OpenJPEG's opj_dwt_decode_tile / _97).
template <class T>
void idwt(TileComp& tc, int numres, std::vector<T>& a) {
  const int w = tc.x1 - tc.x0;
  std::vector<T> line;
  for (int r = 1; r < numres; r++) {
    const Res& prev = tc.res[r - 1];
    const Res& res = tc.res[r];
    int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
    int sn = prev.x1 - prev.x0, dn = rw - sn, cas = res.x0 % 2;
    line.assign((size_t)std::max(rw, res.y1 - res.y0) + 2, T());
    for (int j = 0; j < rh; j++) {
      T* row = &a[(size_t)j * w];
      for (int i = 0; i < sn; i++) line[cas + 2 * i] = row[i];
      for (int i = 0; i < dn; i++) line[1 - cas + 2 * i] = row[sn + i];
      if constexpr (std::is_same<T, float>::value)
        idwt97_line(line.data(), sn, dn, cas);
      else
        idwt53_line(line.data(), rw, cas);
      memcpy(row, line.data(), sizeof(T) * rw);
    }
    sn = prev.y1 - prev.y0;
    dn = rh - sn;
    cas = res.y0 % 2;
    for (int i = 0; i < rw; i++) {
      T* col = &a[i];
      for (int k = 0; k < sn; k++) line[cas + 2 * k] = col[(size_t)k * w];
      for (int k = 0; k < dn; k++) line[1 - cas + 2 * k] = col[(size_t)(sn + k) * w];
      if constexpr (std::is_same<T, float>::value)
        idwt97_line(line.data(), sn, dn, cas);
      else
        idwt53_line(line.data(), rh, cas);
      for (int k = 0; k < rh; k++) col[(size_t)k * w] = line[k];
    }
  }
}

// One tile decoded into its components' samples after the level shift and
// clamp: out[c] of (x1 - x0) x (y1 - y0) of tile-component c.
void decode_tile(Codestream& cs, int tile, std::vector<TileComp>* tcs_out) {
  Tcp& tcp = cs.tcps[tile];
  int p = tile % cs.tw, q = tile / cs.tw;
  int tx0 = (int)std::max<int64_t>((int64_t)cs.tx0 + (int64_t)p * cs.tdx, cs.x0);
  int ty0 = (int)std::max<int64_t>((int64_t)cs.ty0 + (int64_t)q * cs.tdy, cs.y0);
  int tx1 = (int)std::min<int64_t>((int64_t)cs.tx0 + (int64_t)(p + 1) * cs.tdx, cs.x1);
  int ty1 = (int)std::min<int64_t>((int64_t)cs.ty0 + (int64_t)(q + 1) * cs.tdy, cs.y1);
  std::vector<TileComp>& tcs = *tcs_out;
  init_tile(cs, tcp, tx0, ty0, tx1, ty1, &tcs);
  std::vector<Packet> packets;
  packet_order(cs, tcp, tcs, tx0, ty0, tx1, ty1, &packets);
  std::vector<uint8_t> ppt;
  bool has_ppt = !tcp.ppt.empty();
  for (auto& kv : tcp.ppt) ppt.insert(ppt.end(), kv.second.begin(), kv.second.end());
  size_t at = 0, ppt_at = 0;
  for (const Packet& pk : packets)
    read_packet(cs, tcp, tcs, pk, tcp.data.data(), tcp.data.size(), &at, has_ppt ? &ppt : nullptr, &ppt_at);

  const size_t ncomp = cs.comps.size();
  for (size_t c = 0; c < ncomp; c++) {
    const Tccp& tccp = tcp.tccps[c];
    TileComp& tc = tcs[c];
    const int w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
    if (w > 0 && h > 0 && cs.resno_decoded[c] != tccp.numres - 1) fail(kJ2kMarker);
    const bool irreversible = tccp.qmfbid == 0;
    if (irreversible)
      tc.fdata.assign((size_t)w * h, 0.f);
    else
      tc.idata.assign((size_t)w * h, 0);
    std::vector<int32_t> block;
    for (int r = 0; r < tccp.numres; r++) {
      Res& res = tc.res[r];
      for (int b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        const float stepsize = 0.5f * band.stepsize;
        for (Precinct& prc : band.precincts)
          for (Cblk& cb : prc.cblks) {
            int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
            if (cw <= 0 || ch <= 0) continue;
            block.assign((size_t)cw * ch, 0);
            if (!cb.segs.empty() &&
                !j2k::decode_codeblock(cb.data.data(), cb.segs, cw, ch, band.bandno, cb.numbps, tccp.roishift,
                                       tccp.cblksty, block.data()))
              fail();
            int x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
            if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
            for (int j = 0; j < ch; j++) {
              const int32_t* src = &block[(size_t)j * cw];
              if (irreversible) {
                float* dst = &tc.fdata[(size_t)(y + j) * w + x];
                for (int i = 0; i < cw; i++) dst[i] = (float)src[i] * stepsize;
              } else {
                int32_t* dst = &tc.idata[(size_t)(y + j) * w + x];
                for (int i = 0; i < cw; i++) dst[i] = src[i] / 2;
              }
            }
          }
      }
    }
    if (irreversible)
      idwt(tc, tccp.numres, tc.fdata);
    else
      idwt(tc, tccp.numres, tc.idata);
  }

  // the inverse component transform (Annex G) on the first three
  // components, where they are of one size
  if (tcp.mct == 1 && ncomp >= 3) {
    size_t n0 = (size_t)(tcs[0].x1 - tcs[0].x0) * (tcs[0].y1 - tcs[0].y0);
    bool same = true;
    for (int c = 1; c < 3; c++)
      same &= (size_t)(tcs[c].x1 - tcs[c].x0) * (tcs[c].y1 - tcs[c].y0) == n0;
    for (int c = 1; c < 3; c++) same &= tcp.tccps[c].numres == tcp.tccps[0].numres;
    if (!same) fail();  // OpenJPEG: "Tiles don't all have the same dimension. Skip the MCT step." (an error)
    {
      if (tcp.tccps[0].qmfbid == 0) {
        float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
        if (tcs[1].fdata.empty() || tcs[2].fdata.empty()) fail();
        for (size_t i = 0; i < n0; i++) {
          float y = c0[i], u = c1[i], v = c2[i];
          float r = y + (v * 1.402f);
          float g = y - (u * 0.34413f) - (v * 0.71414f);
          float b = y + (u * 1.772f);
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      } else {
        int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
        if (tcs[1].idata.empty() || tcs[2].idata.empty()) fail();
        for (size_t i = 0; i < n0; i++) {
          int32_t y = c0[i], u = c1[i], v = c2[i];
          int32_t g = y - ((u + v) >> 2);
          int32_t r = v + g;
          int32_t b = u + g;
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      }
    }
  }

  // the DC level shift and the clamp to the component's range
  for (size_t c = 0; c < ncomp; c++) {
    const Comp& comp = cs.comps[c];
    TileComp& tc = tcs[c];
    int64_t lo = comp.sgnd ? -((int64_t)1 << (comp.prec - 1)) : 0;
    int64_t hi = comp.sgnd ? ((int64_t)1 << (comp.prec - 1)) - 1 : ((int64_t)1 << comp.prec) - 1;
    int64_t shift = comp.sgnd ? 0 : (int64_t)1 << (comp.prec - 1);
    if (tcp.tccps[c].qmfbid == 1) {
      for (int32_t& v : tc.idata) v = (int32_t)std::min(hi, std::max(lo, (int64_t)v + shift));
    } else {
      tc.idata.resize(tc.fdata.size());
      for (size_t i = 0; i < tc.fdata.size(); i++) {
        float f = tc.fdata[i];
        int64_t v;
        if (f > (float)INT32_MAX)
          v = hi;
        else if (f < (float)INT32_MIN)
          v = lo;
        else
          v = std::min(hi, std::max(lo, (int64_t)lrintf(f) + shift));
        tc.idata[i] = (int32_t)v;
      }
      std::vector<float>().swap(tc.fdata);
    }
  }
}

// Pillow's modes (Jpeg2KImagePlugin's) and the bytes a pixel of each.
enum Mode { kL = 0, kI16, kLA, kRGB, kRGBA, kCMYK, kP, kPA };
int mode_bytes(int mode) { return mode == kL || mode == kP ? 1 : mode == kI16 ? 2 : 4; }

// Pillow's unpackers (Jpeg2KDecode.c's j2k_unpackers): mode, colour space,
// components, whether subsampled components are placed, unpacker.
enum Unpacker { kGrayL, kGrayI, kGrayRgb, kGrayaLa, kSrgbRgb, kSyccRgb, kSrgbaRgba, kSyccaRgba };
struct UnpackerEntry {
  int mode, color_space, components, subsampling, unpacker;
};
constexpr UnpackerEntry kUnpackers[] = {
    {kL, kGray, 1, 0, kGrayL},         {kP, kSrgb, 1, 0, kGrayL},          {kPA, kSrgb, 2, 0, kGrayaLa},
    {kI16, kGray, 1, 0, kGrayI},       {kLA, kGray, 2, 0, kGrayaLa},       {kRGB, kGray, 1, 0, kGrayRgb},
    {kRGB, kGray, 2, 0, kGrayRgb},     {kRGB, kSrgb, 3, 1, kSrgbRgb},      {kRGB, kSycc, 3, 1, kSyccRgb},
    {kRGB, kSrgb, 4, 1, kSrgbRgb},     {kRGB, kSycc, 4, 1, kSyccRgb},      {kRGBA, kGray, 1, 0, kGrayRgb},
    {kRGBA, kGray, 2, 0, kGrayaLa},    {kRGBA, kSrgb, 3, 1, kSrgbRgb},     {kRGBA, kSycc, 3, 1, kSyccRgb},
    {kRGBA, kSrgb, 4, 1, kSrgbaRgba},  {kRGBA, kSycc, 4, 1, kSyccaRgba},   {kCMYK, kCmyk, 4, 1, kSrgbaRgba},
    {kRGBA, kGray, 4, 1, kSrgbaRgba},
};

// What opj_tcd_update_tile_data hands Pillow for a tile: each component's
// samples as 1, 2 or 4 bytes (3 read as 4), one component after another.
void tile_bytes(const Codestream& cs, const std::vector<TileComp>& tcs, std::vector<uint8_t>* buf, size_t minimum) {
  size_t total = 0;
  for (size_t c = 0; c < tcs.size(); c++) {
    int csiz = (cs.comps[c].prec + 7) >> 3;
    if (csiz == 3) csiz = 4;
    total += (size_t)csiz * tcs[c].idata.size();
  }
  buf->assign(std::max(total, minimum), 0);
  uint8_t* o = buf->data();
  for (size_t c = 0; c < tcs.size(); c++) {
    int csiz = (cs.comps[c].prec + 7) >> 3;
    if (csiz == 3) csiz = 4;
    for (int32_t v : tcs[c].idata) {
      uint32_t u = (uint32_t)v;
      if (csiz == 1) {
        *o++ = (uint8_t)u;
      } else if (csiz == 2) {
        uint16_t s = (uint16_t)u;
        memcpy(o, &s, 2);
        o += 2;
      } else {
        memcpy(o, &u, 4);
        o += 4;
      }
    }
  }
}

struct Channel {
  int shift, offset, csiz;
  uint32_t dx, dy;
  const uint8_t* data;
};

uint32_t word_at(const uint8_t* p, int csiz, size_t i) {
  if (csiz == 1) return p[i];
  if (csiz == 2) {
    uint16_t v;
    memcpy(&v, p + 2 * i, 2);
    return v;
  }
  uint32_t v;
  memcpy(&v, p + 4 * i, 4);
  return v;
}

uint32_t j2ku_shift(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

// Pillow's ImagingConvertYCbCr2RGB on n pixels of 4 bytes in place (alpha
// kept): its tables are the JFIF coefficients times (i - 128) in 6
// fraction bits, each rounded as C's (int)(v + 0.5).
void ycbcr_to_rgb(uint8_t* px, unsigned n) {
  static const struct Tables {
    int r[256], gcb[256], gcr[256], b[256];
    Tables() {
      auto round = [](double v) { return (int)std::trunc(v + 0.5); };
      for (int i = 0; i < 256; i++) {
        r[i] = round(1.402 * (i - 128) * 64);
        gcb[i] = round(-0.34414 * (i - 128) * 64);
        gcr[i] = round(-0.71414 * (i - 128) * 64);
        b[i] = round(1.772 * (i - 128) * 64);
      }
    }
  } t;
  auto clip = [](int v) { return (uint8_t)(v <= 0 ? 0 : v >= 255 ? 255 : v); };
  for (unsigned x = 0; x < n; x++, px += 4) {
    int y = px[0], cb = px[1], cr = px[2];
    px[0] = clip(y + (t.r[cr] >> 6));
    px[1] = clip(y + ((t.gcb[cb] + t.gcr[cr]) >> 6));
    px[2] = clip(y + (t.b[cb] >> 6));
  }
}

Channel channel(const Comp& comp, int bits, const uint8_t* data) {
  Channel ch;
  ch.shift = bits - comp.prec;
  ch.offset = comp.sgnd ? 1 << (comp.prec - 1) : 0;
  ch.csiz = (comp.prec + 7) >> 3;
  if (ch.csiz == 3) ch.csiz = 4;
  if (ch.shift < 0) ch.offset += 1 << (-ch.shift - 1);
  ch.dx = comp.dx;
  ch.dy = comp.dy;
  ch.data = data;
  return ch;
}

// Pillow's unpacker `kind` of one tile (reference-grid bounds x0..y1) into
// the image `im` of im_w pixels a row.
void unpack(const Codestream& cs, int kind, int mode, const uint8_t* tiledata, int x0, int y0, int x1, int y1,
            uint8_t* im, int im_w) {
  const unsigned w = x1 - x0, h = y1 - y0;
  const unsigned ox = x0 - cs.x0, oy = y0 - cs.y0;
  const int bpp = mode_bytes(mode);
  auto row_of = [&](unsigned y) { return im + ((size_t)(oy + y) * im_w + ox) * bpp; };
  if (kind == kGrayL || kind == kGrayI || kind == kGrayRgb) {
    Channel ch = channel(cs.comps[0], kind == kGrayI ? 16 : 8, tiledata);
    for (unsigned y = 0; y < h; y++) {
      uint8_t* row = row_of(y);
      for (unsigned x = 0; x < w; x++) {
        uint32_t v = j2ku_shift(ch.offset + word_at(ch.data, ch.csiz, (size_t)y * w + x), ch.shift);
        if (kind == kGrayL) {
          row[x] = (uint8_t)v;
        } else if (kind == kGrayI) {
          uint16_t s = (uint16_t)v;
          memcpy(row + 2 * x, &s, 2);
        } else {
          row[4 * x] = row[4 * x + 1] = row[4 * x + 2] = (uint8_t)v;
          row[4 * x + 3] = 0xFF;
        }
      }
    }
    return;
  }
  if (kind == kGrayaLa) {
    Channel g = channel(cs.comps[0], 8, tiledata);
    Channel a = channel(cs.comps[1], 8, tiledata + (size_t)g.csiz * w * h);
    for (unsigned y = 0; y < h; y++) {
      uint8_t* row = row_of(y);
      for (unsigned x = 0; x < w; x++) {
        uint8_t v = (uint8_t)j2ku_shift(g.offset + word_at(g.data, g.csiz, (size_t)y * w + x), g.shift);
        row[4 * x] = row[4 * x + 1] = row[4 * x + 2] = v;
        row[4 * x + 3] = (uint8_t)j2ku_shift(a.offset + word_at(a.data, a.csiz, (size_t)y * w + x), a.shift);
      }
    }
    return;
  }
  const int n = kind == kSrgbRgb || kind == kSyccRgb ? 3 : 4;
  Channel chs[4];
  const uint8_t* cptr = tiledata;
  for (int c = 0; c < n; c++) {
    chs[c] = channel(cs.comps[c], 8, cptr);
    cptr += (size_t)chs[c].csiz * (w / chs[c].dx) * (h / chs[c].dy);
  }
  for (unsigned y = 0; y < h; y++) {
    uint8_t* row = row_of(y);
    for (unsigned x = 0; x < w; x++) {
      for (int c = 0; c < n; c++) {
        const Channel& ch = chs[c];
        size_t i = (size_t)(y / ch.dy) * (w / ch.dx) + x / ch.dx;
        row[4 * x + c] = (uint8_t)j2ku_shift(ch.offset + word_at(ch.data, ch.csiz, i), ch.shift);
      }
      if (n == 3) row[4 * x + 3] = 0xFF;
    }
    if (kind == kSyccRgb || kind == kSyccaRgba) ycbcr_to_rgb(row, w);
  }
}

// The JP2 boxes OpenJPEG reads before the codestream (opj_jp2_read_header):
// the signature, ftyp, jp2h with ihdr and its first colr; returns the
// offset of the codestream and sets the colour space it gives the image.
size_t read_jp2(const uint8_t* d, size_t n, int* color_space) {
  size_t at = 0;
  bool signature = false, ftyp = false, jp2h = false;
  int enumcs = 0;
  while (true) {
    if (at + 8 > n) fail();
    uint64_t len = be32(d + at);
    uint32_t type = be32(d + at + 4);
    size_t head = 8;
    if (len == 1) {
      if (at + 16 > n) fail();
      len = (uint64_t)be32(d + at + 8) << 32 | be32(d + at + 12);
      head = 16;
    }
    if (type == 0x6A703263) {  // jp2c
      if (!jp2h) fail();
      at += head;
      break;
    }
    if (len == 0 || len < head || len - head > n - at - head) fail();
    const uint8_t* body = d + at + head;
    size_t size = (size_t)(len - head);
    if (type == 0x6A502020) {  // jP
      if (at != 0 || size != 4 || be32(body) != 0x0D0A870A) fail();
      signature = true;
    } else if (type == 0x66747970) {  // ftyp
      if (!signature || ftyp || size < 8 || (size - 8) % 4) fail();
      ftyp = true;
    } else if (type == 0x6A703268) {  // jp2h
      if (!signature || !ftyp || jp2h) fail();
      bool ihdr = false, colr = false, pclr = false, cmap = false, cdef = false;
      size_t k = 0;
      while (k < size) {
        if (k + 8 > size) fail();
        uint64_t blen = be32(body + k);
        uint32_t btype = be32(body + k + 4);
        size_t bhead = 8;
        if (blen == 1) {
          if (k + 16 > size) fail();
          blen = (uint64_t)be32(body + k + 8) << 32 | be32(body + k + 12);
          bhead = 16;
        }
        if (blen == 0) blen = size - k;
        if (blen < bhead || blen > size - k) fail();
        const uint8_t* b = body + k + bhead;
        size_t bn = (size_t)(blen - bhead);
        if (btype == 0x69686472) {  // ihdr
          if (ihdr || bn != 14) fail();
          uint32_t hh = be32(b), ww = be32(b + 4), nc = be16(b + 8);
          if (nc == 0 || nc > 16384 || hh == 0 || ww == 0) fail();
          ihdr = true;
        } else if (btype == 0x636F6C72) {  // colr: the first one counts
          if (bn < 3) fail();
          if (!colr) {
            int meth = b[0];
            if (meth == 1) {
              if (bn < 7) fail();
              enumcs = (int)be32(b + 3);
              colr = true;
            } else if (meth == 2) {
              colr = true;
            }
          }
        } else if (btype == 0x70636C72) {  // pclr
          if (pclr || bn < 3) fail();
          uint32_t entries = be16(b);
          uint32_t ch = b[2];
          if (entries == 0 || entries > 1024 || ch == 0 || bn < 3 + ch) fail();
          size_t need = 3 + ch;
          size_t per = 0;
          for (uint32_t i = 0; i < ch; i++) {
            size_t bytes = (((b[3 + i] & 0x7F) + 1) + 7) >> 3;
            per += bytes > 4 ? 4 : bytes;
          }
          if (bn < need + per * entries) fail();
          pclr = true;
        } else if (btype == 0x636D6170) {  // cmap
          if (!pclr || cmap) fail();
          cmap = true;
        } else if (btype == 0x63646566) {  // cdef
          if (cdef || bn < 2) fail();
          uint32_t count = be16(b);
          if (count == 0 || bn < 2 + (size_t)count * 6) fail();
          cdef = true;
        }
        k += (size_t)blen;
      }
      if (!ihdr) fail();
      jp2h = true;
    } else if (!signature || !ftyp) {
      fail();
    }
    at += (size_t)len;
  }
  if (!jp2h) fail();
  switch (enumcs) {
    case 16: *color_space = kSrgb; break;
    case 17: *color_space = kGray; break;
    case 18: *color_space = kSycc; break;
    case 24: *color_space = kEycc; break;
    case 12: *color_space = kCmyk; break;
    default: *color_space = kUnspecified;  // no colr, an ICC profile, another method or enumeration
  }
  return at;
}

}  // namespace

int decode_jpeg2000(const uint8_t* data, size_t size, int mode, int im_w, int im_h, uint8_t* out) {
  try {
    int color_space = kUnspecified;
    size_t start = 0;
    if (size >= 4 && be32(data) == 0xFF4FFF51) {
      start = 0;
    } else if (size >= 12 && memcmp(data, "\0\0\0\x0cjP  \r\n\x87\n", 12) == 0) {
      start = read_jp2(data, size, &color_space);
    } else {
      return kJ2kBroken;
    }
    const uint8_t* d = data + start;
    const size_t n = size - start;
    Codestream cs;
    size_t at = read_main_header(d, n, cs);
    read_tile_parts(d, n, at, cs);

    // Pillow's checks before it decodes (Jpeg2KDecode.c): the components,
    // the colour space, the unpacker of its mode
    const int ncomp = (int)cs.comps.size();
    if (ncomp < 1 || ncomp > 4) return kJ2kUnpack;
    if (im_w != cs.x1 - cs.x0 || im_h != cs.y1 - cs.y0) return kJ2kBroken;  // a JP2 ihdr of another size
    int subsampling = -1;
    for (int c = 0; c < ncomp; c++)
      if (cs.comps[c].dx != 1 || cs.comps[c].dy != 1) {
        subsampling = c;
        break;
      }
    if (color_space == kUnspecified)
      color_space = ncomp <= 2 ? kGray : (subsampling == 1 || subsampling == 2) ? kSycc : kSrgb;
    int kind = -1;
    for (const UnpackerEntry& e : kUnpackers)
      if (e.color_space == color_space && e.components == ncomp && (subsampling == -1 || e.subsampling) &&
          e.mode == mode) {
        kind = e.unpacker;
        break;
      }
    if (kind < 0) return kJ2kUnpack;

    const size_t bpp = mode_bytes(mode);
    memset(out, 0, (size_t)im_w * im_h * bpp);
    std::vector<TileComp> tcs;
    std::vector<uint8_t> buf;
    for (int tile : cs.order) {
      int p = tile % cs.tw, q = tile / cs.tw;
      int tx0 = (int)std::max<int64_t>((int64_t)cs.tx0 + (int64_t)p * cs.tdx, cs.x0);
      int ty0 = (int)std::max<int64_t>((int64_t)cs.ty0 + (int64_t)q * cs.tdy, cs.y0);
      int tx1 = (int)std::min<int64_t>((int64_t)cs.tx0 + (int64_t)(p + 1) * cs.tdx, cs.x1);
      int ty1 = (int)std::min<int64_t>((int64_t)cs.ty0 + (int64_t)(q + 1) * cs.tdy, cs.y1);
      if (tx0 >= tx1 || ty0 >= ty1 || tx0 < cs.x0 || ty0 < cs.y0 || tx1 - cs.x0 > im_w || ty1 - cs.y0 > im_h)
        return kJ2kBroken;
      decode_tile(cs, tile, &tcs);
      size_t width = 0;
      for (int c = 0; c < ncomp; c++) {
        int csiz = (cs.comps[c].prec + 7) >> 3;
        width += csiz == 3 ? 4 : csiz;
      }
      tile_bytes(cs, tcs, &buf, (size_t)(tx1 - tx0) * (ty1 - ty0) * width);
      unpack(cs, kind, mode, buf.data(), tx0, ty0, tx1, ty1, out, im_w);
    }
    return kOk;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace byogan
