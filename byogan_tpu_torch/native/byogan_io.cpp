// byogan_io: the port's native image IO (byogan_tpu/native/byogan_io.cpp).
//
// Its own codecs, needing nothing but zlib: PNG decode (png.cpp), JPEG
// decode (jpeg_decode.cpp) and JPEG encode (jpeg_encode.cpp), each bit for
// bit with the JAX package's libpng and libjpeg-turbo lane, WebP decode
// (webp.cpp, vp8_decode.cpp, vp8l_decode.cpp), GIF decode (gif.cpp) and
// TIFF decode (tiff.cpp), bit for bit with the JAX package's Pillow lane,
// the plain PNM and Targa RLE loops of the PNM and Targa readers
// (pnm_tga.cpp), the PackBits, PCX RLE, SGI RLE and QOI loops of the PSD,
// PCX, SGI and QOI readers (psd_pcx_sgi_qoi.cpp), and the PNG row unfilter
// below.  The
// data loader, dataset preparation, the projection CLI and the JPEG frame
// writer reach them through the C functions here, by ctypes
// (byogan_tpu_torch/data/native.py).  No codec keeps state between calls,
// so threads decode in parallel.
//
// Build: python -m byogan_tpu_torch.native.build (one g++ -O3 -shared of
// the sources, -lz).
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

int byogan_abi_version() { return 9; }

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
