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
  kNotImage = -2,          // not a PNG, JPEG, WebP, GIF or TIFF file
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
  kGifHeader = -20,        // a GIF cut short or malformed before its first image's data (Pillow cannot identify it)
  kGifNoImage = -21,       // a GIF with no image before its trailer or its end
  kGifBroken = -22,        // GIF LZW data that Pillow's decoder refuses (a code past the table)
  kGifCodeSize = -23,      // a GIF LZW minimum code size above 12
  kGifEmptyFrame = -24,    // a GIF whose first frame has no width or no height
  kTooLarge = -25,         // more pixels than Pillow opens (twice Image.MAX_IMAGE_PIXELS)
  kTiffDirectory = -26,    // a TIFF header or first directory that does not describe an image Pillow reads
  kTiffBig = -27,          // BigTIFF
  kTiffJpeg = -28,         // TIFF with old-style JPEG compression, or JPEG of samples the port does not read
  kTiffCcitt = -29,        // TIFF with CCITT (fax) compression
  kTiffLogLuv = -30,       // TIFF with LogLuv or LogL data
  kTiffCompression = -31,  // TIFF with another compression (LZMA, ZSTD, WebP, JBIG...)
  kTiffYcbcr = -32,        // TIFF with YCbCr pixels in a layout the port does not read
  kTiffPhotometric = -34,  // TIFF with another photometric interpretation (Lab, a mask...)
  kTiffFillOrder = -37,    // TIFF with FillOrder 2 of samples Pillow's raw decoder has no raw mode for
  kTiffLayout = -38,       // TIFF samples of another depth or layout than the port reads
  kTiffPredictor = -39,    // a TIFF predictor libtiff refuses on these samples
  kTiffOldLzw = -40,       // TIFF with old-style LZW codes
  kPnmBitonal = -41,       // a plain PBM sample other than 0 or 1
  kPnmToken = -42,         // a plain PNM token longer than 10 characters
  kPnmInteger = -43,       // a plain PNM token that is not an integer
  kPnmNegative = -44,      // a negative plain PNM sample
  kPnmValue = -45,         // a plain PNM sample above its maxval
  kTgaOverrun = -46,       // a Targa RLE run packet past its row's end
  kTiffJpegStream = -47,   // a JPEG-compressed TIFF strip or tile that does not match the file's tags
  kPcxOverrun = -48,       // a PCX RLE run past the end of its row
  kSgiOverrun = -49,       // an SGI RLE table or row past the file's end, or a run past its row's end
};

// Which of the JAX package's lanes a decode follows where they part: its
// native lane (libpng; its loader), or its Pillow lane (its prep and
// cli.project).  Only 16-bit gray PNGs tell them apart: libpng keeps each
// sample's high byte, Pillow's I;16 -> RGB clips the sample at 255.
enum Lane { kNativeLane = 0, kPillowLane = 1 };

// Decode a whole file held in memory into out, uint8 RGB (*h, *w, 3).  Where
// out is null or the image has another size, *h and *w get the image's and
// the return is kSize.
int decode_png(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w, Lane lane);
int decode_jpeg(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w);
int decode_webp(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w);
int decode_gif(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w);
int decode_tiff(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w);

// The loops of the PNM, Targa, PSD, PCX, SGI and QOI readers (byogan_pnm_plain,
// byogan_tga_rle, byogan_packbits, byogan_pcx_rle, byogan_sgi_rle and
// byogan_qoi in byogan_io.cpp).
int decode_pnm_plain(const uint8_t* data, size_t size, int bands, int w, int h, int maxval, int wide, uint8_t* out);
int decode_tga_rle(const uint8_t* data, size_t size, int pixel_bytes, int row_bytes, int rows, uint8_t* out);
int decode_packbits_rows(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out);
int decode_pcx_rle(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out);
int decode_sgi_rle(const uint8_t* data, size_t size, int bpc, int bands, int xsize, int ysize, uint8_t* out);
int decode_qoi(const uint8_t* data, size_t size, int bands, size_t pixels, uint8_t* out);

// One strip or tile of a JPEG-compressed TIFF (tiff.cpp): `tables` (the
// JPEGTables tag, empty where there is none) read before `data`; YCbCr ->
// RGB where `ycbcr`, else the components as they are.  Fails with
// kTiffJpegStream where the stream has other than `components`
// components; *frame gets the stream's size and sampling factors, *out
// frame->h x frame->w pixels of 3 (ycbcr) or `components` samples.
struct JpegFrame {
  int h = 0, w = 0, components = 0, marker = 0;  // marker: the SOF's
  int hsamp[4] = {1, 1, 1, 1}, vsamp[4] = {1, 1, 1, 1};
};
int decode_jpeg_tiff(const uint8_t* tables, size_t tables_size, const uint8_t* data, size_t size, bool ycbcr,
                     int components, JpegFrame* frame, std::vector<uint8_t>* out);

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
