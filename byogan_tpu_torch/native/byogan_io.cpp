// byogan_io: the port's native image IO (byogan_tpu/native/byogan_io.cpp).
//
// Its own codecs, needing nothing but zlib: PNG decode (png.cpp), JPEG
// decode (jpeg_decode.cpp) and JPEG encode (jpeg_encode.cpp), each bit for
// bit with the JAX package's libpng and libjpeg-turbo lane, WebP decode
// (webp.cpp, vp8_decode.cpp, vp8l_decode.cpp), GIF decode (gif.cpp) and
// TIFF decode (tiff.cpp, with ccitt.cpp's fax decoders and lab.cpp's Lab ->
// sRGB transform), bit for bit with the JAX package's Pillow lane,
// the plain PNM and Targa RLE loops of the PNM and Targa readers
// (pnm_tga.cpp), the PackBits, PCX RLE, SGI RLE, QOI, Sun raster RLE and
// ICNS RLE loops of the PSD, PCX, SGI, QOI, Sun raster and ICNS readers
// (psd_pcx_sgi_qoi.cpp), the BCn block decoder of the DDS, FTEX and BLP
// readers (bcn.cpp), the XBM, MSP and FLI loops of their readers
// (fli_msp_xbm.cpp), the IM reader's bit decoder (im_bit.cpp), the AVIF
// reader's AV1 decoder and YUV-to-RGB conversion (av1_*.cpp, avif_rgb.cpp),
// and the PNG row unfilter below.  The
// data loader, dataset preparation, the projection CLI and the JPEG frame
// writer reach them through the C functions here, by ctypes
// (byogan_tpu_torch/data/native.py).  No codec keeps state between calls,
// so threads decode in parallel.
//
// Build: python -m byogan_tpu_torch.native.build (one g++ -O3 -c a source,
// all at once, then g++ -shared ... -lz).
//
// Every entry returns 0 on success or a negative code of codec.h.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "codec.h"
#include "webp.h"

namespace {

// a if pa <= pb and pa <= pc, else b if pb <= pc, else c, with masks in
// place of branches (the choice follows the data, so branches mispredict).
inline int paeth_select(int a, int b, int c, int pa, int pb, int pc) {
  const int take_b = -(pb <= pc);
  const int bc = (b & take_b) | (c & ~take_b);
  const int take_a = -(pa <= pb && pa <= pc);
  return (a & take_a) | (bc & ~take_a);
}

// Paeth rows of a known pixel size: the left pixel and the one above it
// stay in registers, so the per-byte chain is arithmetic, not a store and
// a reload of the byte just written.
template <int BPP>
void paeth_row(const uint8_t* line, const uint8_t* up, uint8_t* cur, int stride) {
  int a[BPP], c[BPP];
  for (int k = 0; k < BPP; k++) {
    a[k] = cur[k] = uint8_t(line[k] + up[k]);  // Paeth(0, b, 0) = b
    c[k] = up[k];
  }
  for (int i = BPP; i + BPP <= stride; i += BPP) {
    for (int k = 0; k < BPP; k++) {
      const int b = up[i + k];
      // libpng's form of the predictor: |p-a|, |p-b|, |p-c| without p
      const int pa = abs(b - c[k]), pb = abs(a[k] - c[k]), pc = abs(a[k] + b - 2 * c[k]);
      a[k] = cur[i + k] = uint8_t(line[i + k] + paeth_select(a[k], b, c[k], pa, pb, pc));
      c[k] = b;
    }
  }
}

void paeth_row_any(const uint8_t* line, const uint8_t* up, uint8_t* cur, int stride, int bpp) {
  const int lead = bpp < stride ? bpp : stride;
  for (int i = 0; i < lead; i++) cur[i] = line[i] + up[i];
  for (int i = lead; i < stride; i++) {
    const int a = cur[i - bpp], b = up[i], c = up[i - bpp];
    const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
    cur[i] = line[i] + paeth_select(a, b, c, pa, pb, pc);
  }
}

// The whole file, or an empty vector and *rc set.
std::vector<uint8_t> read_file(const char* path, int* rc) {
  std::vector<uint8_t> data;
  FILE* fp = fopen(path, "rb");
  if (!fp) {
    *rc = byogan::kCannotOpen;
    return data;
  }
  if (fseek(fp, 0, SEEK_END) == 0) {
    const long size = ftell(fp);
    if (size > 0 && fseek(fp, 0, SEEK_SET) == 0) {
      data.resize((size_t)size);
      if (fread(data.data(), 1, data.size(), fp) != data.size()) data.clear();
    }
  }
  fclose(fp);
  *rc = byogan::kOk;
  return data;
}

}  // namespace

namespace byogan {

int unfilter_rows(const uint8_t* raw, int h, int stride, int bpp, uint8_t* out) {
  const int lead = bpp < stride ? bpp : stride;  // bytes with no left neighbour
  for (int y = 0; y < h; y++) {
    const uint8_t* line = raw + (size_t)y * (stride + 1);
    uint8_t* cur = out + (size_t)y * stride;
    const uint8_t* up = y ? cur - stride : nullptr;  // null: the zero row above the image
    int kind = *line++;
    if (!up && kind == 4) kind = 1;  // Paeth over a zero row is Sub
    if (!up && kind == 2) kind = 0;  // Up over a zero row is None
    switch (kind) {
      case 0:
        memcpy(cur, line, stride);
        break;
      case 1:
        memcpy(cur, line, lead);
        for (int i = lead; i < stride; i++) cur[i] = line[i] + cur[i - bpp];
        break;
      case 2:
        for (int i = 0; i < stride; i++) cur[i] = line[i] + up[i];
        break;
      case 3:
        if (!up) {
          memcpy(cur, line, lead);
          for (int i = lead; i < stride; i++) cur[i] = line[i] + (cur[i - bpp] >> 1);
          break;
        }
        for (int i = 0; i < lead; i++) cur[i] = line[i] + (up[i] >> 1);
        for (int i = lead; i < stride; i++) cur[i] = line[i] + ((cur[i - bpp] + up[i]) >> 1);
        break;
      case 4:
        if (bpp == 3 && stride % 3 == 0) {
          paeth_row<3>(line, up, cur, stride);
        } else if (bpp == 4 && stride % 4 == 0) {
          paeth_row<4>(line, up, cur, stride);
        } else {
          paeth_row_any(line, up, cur, stride, bpp);
        }
        break;
      default:
        return kBadFilter;
    }
  }
  return kOk;
}

}  // namespace byogan

extern "C" {

int byogan_abi_version() { return 17; }

// Decode one PNG, JPEG, WebP, GIF or TIFF file held in memory (told apart
// by its first bytes) into out, RGB of size (*h, *w).  Where out is null or
// the image has another size, *h and *w get the image's and the return is
// -5: the caller sizes its buffer and calls again, so a right guess costs
// one call.  `lane` (codec.h's Lane) picks the JAX package's lane where its
// lanes part.
int byogan_decode_buffer(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w, int lane) {
  static const uint8_t png_sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (size >= 8 && memcmp(data, png_sig, 8) == 0)
    return byogan::decode_png(data, size, out, h, w,
                              lane == byogan::kPillowLane ? byogan::kPillowLane : byogan::kNativeLane);
  if (size >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF)
    return byogan::decode_jpeg(data, size, out, h, w);
  if (size >= 12 && memcmp(data, "RIFF", 4) == 0 && memcmp(data + 8, "WEBP", 4) == 0)
    return byogan::decode_webp(data, size, out, h, w);
  if (size >= 6 && (memcmp(data, "GIF87a", 6) == 0 || memcmp(data, "GIF89a", 6) == 0))
    return byogan::decode_gif(data, size, out, h, w);
  if (size >= 4 && ((data[0] == 'I' && data[1] == 'I') || (data[0] == 'M' && data[1] == 'M')) &&
      ((data[2] == 42 || data[2] == 43) ? data[3] == 0 : data[2] == 0 && (data[3] == 42 || data[3] == 43)))
    return byogan::decode_tiff(data, size, out, h, w);
  return byogan::kNotImage;
}

// An .xz stream (byogan_xz) or Zstandard data (byogan_zstd) in memory
// decoded into out (room for cap bytes): `occ` bytes of a TIFF strip or
// tile as libtiff's codec reads them, or, where occ is negative, the whole
// stream (codec.h's xz_decode, zstd_decode).  *written gets the bytes made,
// also where the decode fails; -3 where they do not fit in cap.
static int stream_decode(int (*decode)(const uint8_t*, size_t, size_t, std::vector<uint8_t>*), const uint8_t* in,
                         size_t n, long long occ, uint8_t* out, size_t cap, size_t* written) {
  std::vector<uint8_t> bytes;
  int rc;
  try {
    rc = decode(in, n, occ < 0 ? byogan::kWholeStream : (size_t)occ, &bytes);
  } catch (const std::bad_alloc&) {
    return byogan::kNoMemory;
  }
  *written = bytes.size();
  if (bytes.size() > cap) return byogan::kNoMemory;
  if (!bytes.empty()) memcpy(out, bytes.data(), bytes.size());
  return rc;
}

// A JPEG 2000 codestream or JP2 file in memory as Pillow's decoder unpacks it
// into an image of Pillow's mode `mode` (codec.h's decode_jpeg2000).
int byogan_decode_jpeg2000(const uint8_t* data, size_t size, int mode, int w, int h, uint8_t* out) {
  return byogan::decode_jpeg2000(data, size, mode, w, h, out);
}

// An AVIF image's colour and alpha AV1 streams into RGB (codec.h's
// decode_avif; counts may be null).
int byogan_decode_avif(const uint8_t* color, size_t csize, const uint8_t* alpha, size_t asize, int32_t* params,
                       int w, int h, uint8_t* out, int32_t* counts) {
  return byogan::decode_avif(color, csize, alpha, asize, params, w, h, out, counts);
}

// An AV1 stream's planes (codec.h's decode_av1_planes).
int byogan_decode_av1(const uint8_t* data, size_t size, int32_t* info, uint8_t* y, uint8_t* u, uint8_t* v,
                      size_t cap) {
  return byogan::decode_av1_planes(data, size, info, y, u, v, cap);
}

int byogan_xz(const uint8_t* in, size_t n, long long occ, uint8_t* out, size_t cap, size_t* written) {
  return stream_decode(byogan::xz_decode, in, n, occ, out, cap, written);
}

int byogan_zstd(const uint8_t* in, size_t n, long long occ, uint8_t* out, size_t cap, size_t* written) {
  return stream_decode(byogan::zstd_decode, in, n, occ, out, cap, written);
}

// byogan_decode_buffer on a file's bytes.
int byogan_decode(const char* path, uint8_t* out, int* h, int* w, int lane) {
  int rc;
  std::vector<uint8_t> data;
  try {
    data = read_file(path, &rc);
  } catch (const std::bad_alloc&) {
    return byogan::kNoMemory;
  }
  if (rc) return rc;
  return byogan_decode_buffer(data.data(), data.size(), out, h, w, lane);
}

// The samples of a plain (ASCII) PBM, PGM or PPM from the bytes after its
// header: w * h * bands uint8 into out, as Pillow's PpmPlainDecoder reads
// them block by block (maxval 0: P1, '1' black; `wide`: gray above maxval
// 255, scaled to 16 bits and clipped at 255 as Pillow's I -> RGB does).
int byogan_pnm_plain(const uint8_t* data, size_t size, int bands, int w, int h, int maxval, int wide, uint8_t* out) {
  return byogan::decode_pnm_plain(data, size, bands, w, h, maxval, wide, out);
}

// The rows of a Targa RLE image from the bytes after its colour map, in file
// order: rows * row_bytes bytes into out, as Pillow's TgaRleDecode.c reads
// packets of `pixel_bytes`-byte pixels.
int byogan_tga_rle(const uint8_t* data, size_t size, int pixel_bytes, int row_bytes, int rows, uint8_t* out) {
  return byogan::decode_tga_rle(data, size, pixel_bytes, row_bytes, rows, out);
}

// The rows of a PackBits channel of a PSD (Pillow's PackbitsDecode.c): from
// the channel's first byte to the file's end, rows * row_bytes bytes into
// out, a packet cut at its row's end, 0x80 a no-op.
int byogan_packbits(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out) {
  return byogan::decode_packbits_rows(data, size, row_bytes, rows, out);
}

// The rows of a PCX image from the bytes after its 128-byte header (Pillow's
// PcxDecode.c): rows * row_bytes bytes into out, a run cut at its row's
// end and then refused (-48) once every row is decoded.
int byogan_pcx_rle(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out) {
  return byogan::decode_pcx_rle(data, size, row_bytes, rows, out);
}

// The rows of an SGI RLE image from the bytes after its 512-byte header
// (Pillow's SgiRleDecode.c): ysize rows of xsize * bands samples of bpc
// bytes, interleaved, in the file's row order (bottom-up), into out; rows
// after an unterminated one stay zero.
int byogan_sgi_rle(const uint8_t* data, size_t size, int bpc, int bands, int xsize, int ysize, uint8_t* out) {
  return byogan::decode_sgi_rle(data, size, bpc, bands, xsize, ysize, out);
}

// The pixels of a QOI image from the bytes after its 14-byte header
// (Pillow's QoiDecoder): `pixels` pixels of `bands` (3 or 4) bytes into out.
int byogan_qoi(const uint8_t* data, size_t size, int bands, size_t pixels, uint8_t* out) {
  return byogan::decode_qoi(data, size, bands, pixels, out);
}

// A BLP1 mip's JPEG stream held in memory into out, RGB of size (*h, *w), as
// the byogan_decode_buffer of a JPEG but for four components, which are
// read as CMYK whatever the Adobe marker says (Pillow's jpegmode CMYK, which
// BlpImagePlugin sets: no YCCK conversion).
int byogan_decode_blp_jpeg(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w) {
  return byogan::decode_jpeg(data, size, out, h, w, true);
}

// The 4 x 4 blocks of a w x h BCn texture (bcn.cpp, codec.h's BcnFormat):
// h * w pixels of the format's channels into out, as Pillow 12.1.0's bcn
// decoder (DDS, FTEX) or BlpImagePlugin.py's DXT functions (BLP2) give them.
int byogan_bcn(const uint8_t* data, size_t size, int pixel_format, int w, int h, uint8_t* out) {
  return byogan::decode_bcn(data, size, pixel_format, w, h, out);
}

// The rows of a Sun raster RLE image from the bytes after its colour map
// (Pillow's SunRleDecode.c): rows * row_bytes bytes into out, a run going on
// into the rows after its own.
int byogan_sun_rle(const uint8_t* data, size_t size, size_t row_bytes, size_t rows, uint8_t* out) {
  return byogan::decode_sun_rle(data, size, row_bytes, rows, out);
}

// The three channels of an ICNS 24-bit RLE element from its first byte to
// the file's end (IcnsImagePlugin.read_32): 3 * pixels bytes into out, a
// channel after the other.
int byogan_icns_rle(const uint8_t* data, size_t size, size_t pixels, uint8_t* out) {
  return byogan::decode_icns_rle(data, size, pixels, out);
}

// An XBM's bytes from the end of its header (XbmDecode.c): rows * row_bytes
// bytes into out, each the two characters after the next 'x', bits least
// significant first.
int byogan_xbm(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out) {
  return byogan::decode_xbm(data, size, row_bytes, rows, out);
}

// An MSP version 2 file's row map and RLE rows from its byte 32
// (MspImagePlugin.py's MspDecoder): rows * row_bytes bytes of 1-bit pixels,
// most significant first, into out.
int byogan_msp_rle(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out) {
  return byogan::decode_msp_rle(data, size, row_bytes, rows, out);
}

// An FLI/FLC file's first frame from its byte 128 to the file's end, as
// FliDecode.c applies its chunks and ImageFile.load feeds it: w * h palette
// indices into out, zero where no chunk writes.
int byogan_fli(const uint8_t* data, size_t size, int w, int h, uint8_t* out) {
  return byogan::decode_fli(data, size, w, h, out);
}

// An IM file's "L*n" pixel data from the end of its header (Pillow's Bit.c
// under ImImagePlugin's arguments): h rows of w samples of `bits` bits,
// least significant first, rows bottom-up and padded to a byte, into w * h
// floats.
int byogan_im_bits(const uint8_t* data, size_t size, int bits, int w, int h, float* out) {
  return byogan::decode_im_bits(data, size, bits, w, h, out);
}

// n 8-bit CIE Lab triples (L, a + 128, b + 128: Pillow's LAB bands) into n
// sRGB triples, as Pillow 12.1.0 converts a LAB image to RGB through
// LittleCMS 2.17 (lab.cpp).  The PSD reader's Lab planes go through it.
int byogan_lab_rgb(const uint8_t* lab, size_t n, uint8_t* rgb) {
  byogan::lab_to_rgb(lab, n, rgb);
  return byogan::kOk;
}

// For the tests alone: the Y, U and V planes of a lossy WebP file's frame
// (libwebp's WebPDecodeYUV), Y (*h, *w) and U, V ((*h + 1) / 2, (*w + 1) / 2),
// with byogan_decode's size protocol (-5 and the frame's size where y is null
// or the size is another).  -2 where the frame is lossless.
int byogan_decode_vp8_yuv(const char* path, uint8_t* y, uint8_t* u, uint8_t* v, int* h, int* w) {
  int rc;
  std::vector<uint8_t> data;
  byogan::Vp8Planes planes;
  try {
    data = read_file(path, &rc);
    if (rc) return rc;
    rc = byogan::decode_webp_planes(data.data(), data.size(), &planes);
  } catch (const std::bad_alloc&) {
    return byogan::kNoMemory;
  }
  if (rc) return rc;
  if (!y || *h != planes.height || *w != planes.width) {
    *h = planes.height;
    *w = planes.width;
    return byogan::kSize;
  }
  memcpy(y, planes.y.data(), planes.y.size());
  memcpy(u, planes.u.data(), planes.u.size());
  memcpy(v, planes.v.data(), planes.v.size());
  return byogan::kOk;
}

// Undo PNG's row filters (None, Sub, Up, Average, Paeth) of h zlib-inflated
// scanlines, each a filter byte and `stride` bytes, `bpp` bytes a pixel
// (at least 1), into out, h*stride bytes.
int byogan_unfilter(const uint8_t* raw, int h, int stride, int bpp, uint8_t* out) {
  return byogan::unfilter_rows(raw, h, stride, bpp, out);
}

// An RGB uint8 HWC image as a JPEG file at `quality` (1-100): the bytes
// libjpeg writes with its defaults (byogan_tpu/native/byogan_io.cpp:264-298).
int byogan_encode_jpeg(const char* path, const uint8_t* data, int h, int w, int quality) {
  std::vector<uint8_t> file;
  const int rc = byogan::encode_jpeg(data, h, w, quality, &file);
  if (rc) return rc;
  FILE* fp = fopen(path, "wb");
  if (!fp) return byogan::kCannotOpen;
  const bool written = fwrite(file.data(), 1, file.size(), fp) == file.size();
  return fclose(fp) == 0 && written ? byogan::kOk : byogan::kCannotOpen;
}

}  // extern "C"
