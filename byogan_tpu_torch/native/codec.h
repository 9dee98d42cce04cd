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
  kJpeg12Bit = -12,        // a DCT frame's samples of other than 8 bits (12-bit gray TIFF strips aside)
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
  kTiffBig = -27,          // a big-endian (MM) BigTIFF, which Pillow reads as a classic TIFF and cannot identify
  kTiffJpeg = -28,         // TIFF with JPEG compression of samples the port does not read
  kTiffCcitt = -29,        // TIFF with CCITT (fax) compression of other samples than 1-bit gray
  kTiffLogLuv = -30,       // TIFF with LogLuv or LogL data
  kTiffCompression = -31,  // TIFF with another compression (WebP, JBIG, JPEG 2000...)
  kTiffYcbcr = -32,        // TIFF with YCbCr pixels in a layout the port does not read
  kTiffPhotometric = -34,  // TIFF with another photometric interpretation (ICCLab, ITULab, a mask...)
  kTiffFillOrder = -37,    // TIFF with FillOrder 2 of samples Pillow's raw decoder has no raw mode for
  kTiffLayout = -38,       // TIFF samples of another depth or layout than the port reads
  kTiffPredictor = -39,    // a TIFF predictor libtiff refuses on these samples
  kPnmBitonal = -41,       // a plain PBM sample other than 0 or 1
  kPnmToken = -42,         // a plain PNM token longer than 10 characters
  kPnmInteger = -43,       // a plain PNM token that is not an integer
  kPnmNegative = -44,      // a negative plain PNM sample
  kPnmValue = -45,         // a plain PNM sample above its maxval
  kTgaOverrun = -46,       // a Targa RLE run packet past its row's end
  kTiffJpegStream = -47,   // a JPEG-compressed TIFF strip or tile that does not match the file's tags
  kPcxOverrun = -48,       // a PCX RLE run past the end of its row
  kSgiOverrun = -49,       // an SGI RLE table or row past the file's end, or a run past its row's end
  kTiffCcittData = -50,    // CCITT data libtiff decodes only with errors (a bad code word, a row of the wrong length...)
  kIcnsOverrun = -51,      // an ICNS RLE run past the end of its channel
  kMspRowMap = -52,        // an MSP version 2 file cut short in its row map
  kMspRowCut = -53,        // an MSP version 2 row cut short by the file's end
  kMspCorrupt = -54,       // an MSP version 2 run cut short by its row's end
  kMspShort = -55,         // MSP version 2 rows that decode to fewer bytes than the image holds
  kFliOverrun = -56,       // FLI/FLC frame data past the frame's end, or a run past its row
  kFliBroken = -57,        // an FLI/FLC chunk of no size
  kFliUnknown = -58,       // an FLI/FLC frame of an unknown chunk, or not a frame chunk
  kTiffMm12 = -59,         // a big-endian (MM) 12-bit gray TIFF, which Pillow cannot identify
  kPngChunkCut = -60,      // a PNG chunk after the image data cut short by the file's end
  kPngChunkRefused = -61,  // a PNG chunk after the image data that Pillow's chunk handler refuses
  kXzFilter = -62,         // an .xz block of a BCJ filter, which liblzma decodes and libtiff never writes
  kZstdDictionary = -63,   // a Zstandard frame that names a dictionary (libzstd: Dictionary mismatch)
  kTiffOjpeg = -64,        // an old-style JPEG TIFF in a layout the port does not read (tiles, separate planes)
  kTiffJpeg12Odd = -65,    // a 12-bit JPEG TIFF strip or tile of odd width (libtiff leaves a sample of each row unset)
  kJ2kBroken = -66,        // a JPEG 2000 file OpenJPEG refuses or that is cut short (Pillow: broken data stream)
  kJ2kHt = -67,            // HTJ2K (Part 15) code-blocks
  kJ2kMarker = -68,        // a JPEG 2000 codestream of Part 2 markers, or a component whose top level has no packet
  kJ2kUnpack = -69,        // components, colour space and mode Pillow's JPEG 2000 decoder has no unpacker for
  kAvifBroken = -70,       // an AV1 stream dav1d refuses, or one cut short (libavif: failed to decode)
  kAvifFilmGrain = -72,    // an AV1 frame with film grain to apply
  kAvifQmatrix = -74,      // an AV1 frame of quantizer matrices
  kAvifSuperres = -75,     // a superresolved AV1 frame
  kAvifLayers = -76,       // an AV1 stream of spatial layers
  kAvifNotIntra = -77,     // an AV1 stream whose first frame is not a key or intra-only frame
  kAvifSize = -78,         // a decoded frame of another size than its item ('ispe')
  kAvifColour = -79,       // a colour conversion libavif refuses (identity with subsampled chroma, YCgCo of limited
                           // range, unknown matrices)
  kAvifConversion = -80,   // libavif's float conversion of subsampled chroma (YCgCo and other matrices)
  kAvifAlpha = -81,        // an alpha plane of another size than the image
  kAvifAlphaDepth = -82,   // an alpha plane of another bit depth than the image
};

// Which of the JAX package's lanes a decode follows where they part: its
// native lane (libpng; its loader), or its Pillow lane (its prep and
// cli.project).  Only 16-bit gray PNGs tell them apart: libpng keeps each
// sample's high byte, Pillow's I;16 -> RGB clips the sample at 255.
enum Lane { kNativeLane = 0, kPillowLane = 1 };

// Decode a whole file held in memory into out, uint8 RGB (*h, *w, 3).  Where
// out is null or the image has another size, *h and *w get the image's and
// the return is kSize.  decode_jpeg's force_cmyk reads four components as
// CMYK whatever the Adobe marker says (no YCCK conversion), as BLP1's
// reader sets Pillow's jpegmode to CMYK.
int decode_png(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w, Lane lane);
int decode_jpeg(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w, bool force_cmyk = false);
int decode_webp(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w);
int decode_gif(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w);
int decode_tiff(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w);

// The loops of the PNM, Targa, PSD, PCX, SGI, QOI, Sun raster and ICNS
// readers (byogan_pnm_plain, byogan_tga_rle, byogan_packbits,
// byogan_pcx_rle, byogan_sgi_rle, byogan_qoi, byogan_sun_rle and
// byogan_icns_rle in byogan_io.cpp).
int decode_pnm_plain(const uint8_t* data, size_t size, int bands, int w, int h, int maxval, int wide, uint8_t* out);
int decode_tga_rle(const uint8_t* data, size_t size, int pixel_bytes, int row_bytes, int rows, uint8_t* out);
int decode_packbits_rows(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out);
int decode_pcx_rle(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out);
int decode_sgi_rle(const uint8_t* data, size_t size, int bpc, int bands, int xsize, int ysize, uint8_t* out);
int decode_qoi(const uint8_t* data, size_t size, int bands, size_t pixels, uint8_t* out);
int decode_sun_rle(const uint8_t* data, size_t size, size_t row_bytes, size_t rows, uint8_t* out);
int decode_icns_rle(const uint8_t* data, size_t size, size_t pixels, uint8_t* out);

// The loops of the XBM, MSP and FLI readers (fli_msp_xbm.cpp; byogan_xbm,
// byogan_msp_rle and byogan_fli in byogan_io.cpp): XBM's hex bytes and MSP
// version 2's RLE into rows * row_bytes packed bytes, an FLI/FLC file's
// first frame (its bytes from offset 128 to the file's end) into w * h
// palette indices.
int decode_xbm(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out);
int decode_msp_rle(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out);
int decode_fli(const uint8_t* data, size_t size, int w, int h, uint8_t* out);

// The loop of the IM reader's "L*n" images (im_bit.cpp; byogan_im_bits in
// byogan_io.cpp): h rows of w samples of `bits` bits into w * h floats.
int decode_im_bits(const uint8_t* data, size_t size, int bits, int w, int h, float* out);

// The formats of decode_bcn (byogan_bcn in byogan_io.cpp): BC1 to BC7 as
// Pillow's bcn decoder gives them (BC1, BC2, BC3, BC7: RGBA; BC4: L; BC5,
// BC5S, BC6H, BC6HS: RGB), and BLP2's DXT1 (RGB, or RGBA where the file has
// alpha), DXT3 and DXT5 (RGBA) as BlpImagePlugin.py's Python decodes them.
enum BcnFormat {
  kBc1 = 1, kBc2, kBc3, kBc4, kBc5, kBc5s, kBc6h, kBc6hs, kBc7,
  kBlpDxt1, kBlpDxt1Alpha, kBlpDxt3, kBlpDxt5
};

// The 4 x 4 blocks of a BCn texture of w x h pixels (bcn.cpp), blocks in
// rows, into out: h * w pixels of the format's channels.  kTruncated where
// the data hold fewer blocks than the image needs.
int decode_bcn(const uint8_t* data, size_t size, int pixel_format, int w, int h, uint8_t* out);

// One strip or tile of CCITT data (compression 2, 3, 4 or 32771; T4Options
// `t4options`) of rows of `width` pixels, as libtiff's tif_fax3.c decodes
// it (ccitt.cpp): rows * row_bytes bytes into out, a bit a pixel, most
// significant first, 1 for black runs.  `file_at` is the data's offset in
// the file (32771 aligns each row to 16 bits of the file).  Fails with
// kTiffCcittData where libtiff reports an error or a warning.
int decode_ccitt(const uint8_t* in, size_t n, uint64_t file_at, uint32_t compression, uint32_t t4options,
                 uint32_t width, uint32_t rows, size_t row_bytes, uint8_t* out);

// An .xz stream (xz.cpp) or a Zstandard frame (zstd.cpp) held in memory,
// decoded into *out: `occ` bytes of a TIFF strip or tile as libtiff 4.7.1's
// LZMA and ZSTD codecs read them (the rest of the data unread once the
// buffer is full), or, where occ is kWholeStream, the whole stream as
// lzma_code reads it to LZMA_STREAM_END (one .xz stream, its index and
// footer verified) and as ZSTD_decompress reads it (every frame, skippable
// ones skipped).  kOk, or the code of the first fault.
constexpr size_t kWholeStream = ~(size_t)0;
int xz_decode(const uint8_t* in, size_t n, size_t occ, std::vector<uint8_t>* out);
int zstd_decode(const uint8_t* in, size_t n, size_t occ, std::vector<uint8_t>* out);

// n 8-bit CIE Lab triples (L, then a and b with 128 as zero: Pillow's LAB
// bands) to n sRGB triples, as Pillow 12.1.0's convert("RGB") of a LAB
// image makes them through LittleCMS 2.17 (lab.cpp).
void lab_to_rgb(const uint8_t* lab, size_t n, uint8_t* rgb);

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

// One strip or tile of a 12-bit gray JPEG-compressed TIFF: the samples
// (frame->h x frame->w, 0-4095) libjpeg-turbo's 12-bit decoder gives;
// kTiffJpegStream where the stream is not one 12-bit component.
int decode_jpeg_tiff12(const uint8_t* tables, size_t tables_size, const uint8_t* data, size_t size, JpegFrame* frame,
                       std::vector<uint16_t>* out);

// A sequential DCT stream's components after the IDCT, not upsampled and
// not converted (libjpeg's raw_data_out): planes[c] of strides[c] columns
// (whole blocks) and 8 rows a block row.
int decode_jpeg_planes(const uint8_t* data, size_t size, JpegFrame* frame, std::vector<uint8_t>* planes,
                       int* strides);

// A JPEG 2000 codestream or JP2 file (jpeg2000.cpp) as Pillow's Jpeg2KDecode
// unpacks it into an image of Pillow's `mode` (jpeg2000.cpp's Mode: L, I;16,
// LA, RGB, RGBA, CMYK, P, PA) of im_w x im_h pixels, 1, 2 or 4 bytes each,
// into out (YCbCr converted to RGB where Pillow's unpacker converts it).
int decode_jpeg2000(const uint8_t* data, size_t size, int mode, int im_w, int im_h, uint8_t* out);

// An AVIF image's RGB (avif_rgb.cpp): the AV1 streams of its colour item
// and of its alpha item (null, 0 if none) decoded by the port's AV1 decoder
// (av1.h) and converted as libavif 1.3.0 converts them for Pillow 12.1.0,
// into out (h x w x 3).  params: whether the item has an nclx 'colr', its
// colour primaries, transfer characteristics and matrix coefficients, and
// whether the alpha is premultiplied ('prem'), then two slots that receive
// the decoded frame's width and height (kAvifSize where they are not w and
// h), then the nclx's full-range flag.  counts, if not null, takes av1::Counts of the colour
// stream.
int decode_avif(const uint8_t* color, size_t csize, const uint8_t* alpha, size_t asize, int32_t* params, int w,
                int h, uint8_t* out, int32_t* counts);

// An AV1 stream's planes as the port's AV1 decoder makes them (avif_rgb.cpp):
// info receives width, height, subsampling x and y, monochrome and the bit
// depth; y, u and v (cap bytes each; u and v unused in 4:0:0) the planes,
// rows packed, samples of 10 or 12 bits as native-endian 16-bit words.
int decode_av1_planes(const uint8_t* data, size_t size, int32_t* info, uint8_t* y, uint8_t* u, uint8_t* v,
                      size_t cap);

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
