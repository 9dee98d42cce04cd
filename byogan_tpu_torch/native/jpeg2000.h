// What the JPEG 2000 decoder's two files share (jpeg2000.cpp: the JP2 boxes,
// the codestream's markers, tier-2, dequantization, the inverse wavelet and
// colour transforms and Pillow's unpacking; jpeg2000_t1.cpp: the MQ decoder
// and tier-1).  Every step does what OpenJPEG 2.5.4 does, in its order of
// operations, so that its float steps round as OpenJPEG's do.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace byogan {
namespace j2k {

// The code-block style flags of COD/COC (SPcod's fifth byte).
enum CblkStyle {
  kBypass = 0x01,   // arithmetic coding bypassed below the fourth bit-plane
  kReset = 0x02,    // contexts reset after each pass
  kTermAll = 0x04,  // a terminated segment a pass
  kVsc = 0x08,      // vertically causal contexts
  kErterm = 0x10,   // predictable termination (nothing for a decoder to do)
  kSegsym = 0x20,   // a segmentation symbol after each cleanup pass
  kHt = 0x40,       // HTJ2K (Part 15) code-blocks
};

// One codeword segment of a code-block: its bytes and its coding passes.
struct Segment {
  uint32_t len = 0;
  int passes = 0;
};

// Tier-1 of one code-block of w x h coefficients into out (w * h, row by
// row): the passes of `segments`, their bytes one after the other in data,
// from bit-plane numbps (plus roishift) down, as OpenJPEG's
// opj_t1_decode_cblk does; the coefficients carry one bit below the
// decoded bit-planes (OpenJPEG's half step).  `orient` is the band (0 LL,
// 1 HL, 2 LH, 3 HH).  False where OpenJPEG refuses the code-block (31 or
// more bit-planes).
bool decode_codeblock(const uint8_t* data, const std::vector<Segment>& segments, int w, int h, int orient,
                      int numbps, int roishift, int cblksty, int32_t* out);

}  // namespace j2k
}  // namespace byogan
