// What the WebP decoders share (webp.cpp, vp8_decode.cpp, vp8l_decode.cpp,
// webp_tables.cpp): the constant tables, the two bitstream decoders and the
// container's frame.  Each function below throws WebpError with a code of
// codec.h; decode_webp (webp.cpp) catches it.  Nothing is kept between
// calls, so threads decode in parallel.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

#include "codec.h"

namespace byogan {

struct WebpError {
  int code;
};

[[noreturn]] inline void webp_fail(int code) { throw WebpError{code}; }

// --- tables (webp_tables.cpp) ----------------------------------------------

// The 4x4 intra modes in libwebp's order; the 16x16 and chroma modes are
// the first four of them.
enum Vp8Mode {
  kDcPred = 0, kTmPred, kVePred, kHePred, kRdPred, kVrPred, kLdPred, kVlPred, kHdPred, kHuPred,
};

extern const uint8_t kVp8DcTable[128];
extern const uint16_t kVp8AcTable[128];
extern const uint8_t kVp8Zigzag[16];
extern const uint8_t kVp8Bands[17];
extern const uint8_t kVp8Cat3[4], kVp8Cat4[5], kVp8Cat5[6], kVp8Cat6[12];
extern const uint8_t kVp8CoeffsProba0[4][8][3][11];
extern const uint8_t kVp8CoeffsUpdateProba[4][8][3][11];
extern const uint8_t kVp8BModesProba[10][10][9];  // [above][left][node]
extern const uint8_t kVp8lCodeToPlane[120];

// --- VP8, the lossy format (vp8_decode.cpp) ---------------------------------

// A key frame's width and height from its first 10 bytes, as VP8GetInfo
// reads them: kOk, or kTruncated or kCorrupt where they are not a
// displayable key frame's within `size` bytes.
int vp8_info(const uint8_t* data, size_t size, int* w, int* h);

// The decoded planes, cropped to the frame: Y (height x width), U and V
// ((height + 1) / 2 x (width + 1) / 2).
struct Vp8Planes {
  int width = 0, height = 0, uv_width = 0, uv_height = 0;
  std::vector<uint8_t> y, u, v;
};

// Decode the payload of a "VP8 " chunk.
void vp8_decode(const uint8_t* data, size_t size, Vp8Planes* planes);

// libwebp's fancy upsampling and YUV -> RGB of the planes into RGB rows of
// `stride` bytes.
void vp8_to_rgb(const Vp8Planes& planes, uint8_t* out, size_t stride);

// --- VP8L, the lossless format (vp8l_decode.cpp) ----------------------------

// The width and height of a "VP8L" payload's header: kOk, or kTruncated
// or kCorrupt (a wrong signature or version).
int vp8l_info(const uint8_t* data, size_t size, int* w, int* h);

// Decode a "VP8L" payload to ARGB pixels (h x w, row-major).
void vp8l_decode(const uint8_t* data, size_t size, std::vector<uint32_t>* argb, int* w, int* h);

// --- the RIFF container (webp.cpp) ------------------------------------------

// The one frame a decode draws: the bitstream of a still image, or the
// first frame of an animation, placed at (x, y) on a canvas cleared to
// black.
struct WebpFrame {
  const uint8_t* data = nullptr;  // the VP8 or VP8L payload
  size_t size = 0;
  bool lossless = false;
  int x = 0, y = 0, width = 0, height = 0;
  int canvas_w = 0, canvas_h = 0;
};

void webp_locate(const uint8_t* data, size_t size, WebpFrame* frame);

// The planes of a lossy file's frame, for the tests; a code of codec.h, or
// kNotImage where the frame is lossless.  Returns, never throws.
int decode_webp_planes(const uint8_t* data, size_t size, Vp8Planes* planes);

}  // namespace byogan
