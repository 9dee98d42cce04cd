// What the codecs of byogan_io share: the return codes, the entry points
// byogan_io.cpp wraps, and the JPEG tables the decoder and the encoder both
// read (the WebP decoders' own are in webp.h).  The tables are constant; no
// codec keeps mutable state between calls, so threads decode in parallel.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace byogan {

// Every entry returns 0 on success or one of these (data/native.py names
// them in its ERRORS table).
enum Status {
  kOk = 0,
  kCannotOpen = -1,        // the file cannot be opened or written
  kNotImage = -2,          // not a PNG, JPEG or WebP file
  kNoMemory = -3,          // out of memory
  kCorrupt = -4,           // the data break the format's rules
  kSize = -5,              // the image's size is not the buffer's
  kNotRgb = -6,            // the image does not decode to RGB
  kBadFilter = -8,         // an unknown PNG row filter
  kBadCrc = -9,            // a PNG critical chunk's CRC does not match
  kTruncated = -10,        // the file ends before its image data do
  kJpeg12Bit = -12,        // a DCT frame's samples of other than 8 bits
  kJpegLossless = -14,     // a lossless frame Pillow's libjpeg-turbo refuses: arithmetic (SOF11), not 8-bit, or converted
  kJpegHierarchical = -15, // a hierarchical (differential) frame
  kJpegSampling = -16,     // a fractional sampling ratio (a component's factors do not divide the largest)
  kWebpFrameOutside = -18, // an animated WebP's first frame lies outside its canvas
  kWebpCanvas = -19,       // a still WebP's VP8X canvas is not its frame's size
};

// Decode a whole file held in memory into out, uint8 RGB (*h, *w, 3).  Where
// out is null or the image has another size, *h and *w get the image's and
// the return is kSize.
int decode_png(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w);
int decode_jpeg(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w);
int decode_webp(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w);

// An RGB uint8 (h, w, 3) image as the bytes of a baseline JPEG file.
int encode_jpeg(const uint8_t* rgb, int h, int w, int quality, std::vector<uint8_t>* file);

// PNG's row filters undone (byogan_unfilter in byogan_io.cpp).
int unfilter_rows(const uint8_t* raw, int h, int stride, int bpp, uint8_t* out);

// kNatural[k]: the natural (row-major) place of the k-th coefficient in
// zigzag order.
extern const uint8_t kNatural[64];

// A Huffman table as DHT carries it: bits[l] codes of length l (bits[0]
// unused), then the symbols in code order.
struct HuffSpec {
  uint8_t bits[17];
  uint8_t vals[256];
};

// The tables of the JPEG standard's K.3 (libjpeg's std_huff_tables).
extern const HuffSpec kStdDcLuma, kStdAcLuma, kStdDcChroma, kStdAcChroma;

}  // namespace byogan
