// byogan_io: the port's native image IO (byogan_tpu/native/byogan_io.cpp).
//
// PNG decode through libpng and JPEG decode through libjpeg, straight into
// the caller's uint8 RGB buffer, JPEG encode, and a PNG row unfilter that
// needs no library: the data loader, dataset preparation and the JPEG
// frame writer reach it through ctypes
// (byogan_tpu_torch/data/native.py).  The libraries are optional: each
// part is compiled where its header is found, and byogan_io_features() says
// which were.  Without libpng, PNG files decode in Python (data/png.py)
// with byogan_unfilter doing the per-byte work; without libjpeg, JPEG
// files cannot be read or written.
//
// Build: python -m byogan_tpu_torch.native.build (g++ -O3 -shared; links
// -lpng -lz and -ljpeg for the headers it finds).
//
// Every entry returns 0 on success or a negative code:
//   -1 the file cannot be opened      -5 the image's size is not the buffer's
//   -2 not a PNG or JPEG file         -6 the image does not decode to RGB
//   -3 out of memory                  -7 the format's library was not compiled in
//   -4 the library refused the data   -8 an unknown PNG row filter

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#if __has_include(<png.h>)
#include <png.h>
#define BYOGAN_HAVE_PNG 1
#else
#define BYOGAN_HAVE_PNG 0
#endif

#if __has_include(<jpeglib.h>)
#include <jpeglib.h>
#define BYOGAN_HAVE_JPEG 1
#else
#define BYOGAN_HAVE_JPEG 0
#endif

namespace {

enum Format { kUnknown, kPng, kJpeg };

Format sniff(FILE* fp) {
  unsigned char head[8] = {0};
  size_t got = fread(head, 1, 8, fp);
  rewind(fp);
  static const unsigned char png_sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (got == 8 && memcmp(head, png_sig, 8) == 0) return kPng;
  if (got >= 3 && head[0] == 0xFF && head[1] == 0xD8 && head[2] == 0xFF) return kJpeg;
  return kUnknown;
}

#if BYOGAN_HAVE_PNG
// Any PNG to 8-bit RGB, as byogan_tpu/native/byogan_io.cpp:32-91 does:
// 16-bit stripped to its high byte, palette and low-depth gray expanded,
// tRNS and alpha dropped.  *h, *w hold out's size; where out is null or
// the image has another size, they get the image's and the return is -5.
int decode_png(FILE* fp, uint8_t* out, int* h, int* w) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -3;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -3;
  }
  png_bytep* volatile rows = nullptr;  // volatile: read after a longjmp
  if (setjmp(png_jmpbuf(png))) {
    if (rows) png_free(png, rows);
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  const int ih = png_get_image_height(png, info), iw = png_get_image_width(png, info);
  if (!out || ih != *h || iw != *w) {
    png_destroy_read_struct(&png, &info, nullptr);
    *h = ih, *w = iw;
    return -5;
  }
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  bool trns = png_get_valid(png, info, PNG_INFO_tRNS);
  if (trns) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA) png_set_gray_to_rgb(png);
  // The tRNS conversion adds an alpha channel too: strip it in both cases.
  if ((color & PNG_COLOR_MASK_ALPHA) || trns) png_set_strip_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);
  if (png_get_channels(png, info) != 3 || png_get_rowbytes(png, info) != (size_t)(*w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -6;
  }
  rows = static_cast<png_bytep*>(png_malloc(png, sizeof(png_bytep) * (size_t)(*h)));
  for (int y = 0; y < *h; y++) rows[y] = out + (size_t)y * (*w) * 3;
  png_read_image(png, rows);
  png_read_end(png, nullptr);
  png_free(png, rows);
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}
#endif

#if BYOGAN_HAVE_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jmp, 1);
}

void jpeg_quiet(j_common_ptr) {}  // libjpeg's warnings would go to stderr

// Any JPEG libjpeg reads, to RGB (JCS_RGB, libjpeg's default IDCT and
// upsampling: byogan_tpu/native/byogan_io.cpp:101-132).  Sizes as
// decode_png's.
int decode_jpeg(FILE* fp, uint8_t* out, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.output_message = jpeg_quiet;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  const int ih = cinfo.output_height, iw = cinfo.output_width;
  if (!out || ih != *h || iw != *w) {
    jpeg_destroy_decompress(&cinfo);
    *h = ih, *w = iw;
    return -5;
  }
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -6;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
#endif

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

}  // namespace

extern "C" {

int byogan_abi_version() { return 2; }

// Bit 0: PNG through libpng; bit 1: JPEG through libjpeg.
int byogan_io_features() { return (BYOGAN_HAVE_PNG ? 1 : 0) | (BYOGAN_HAVE_JPEG ? 2 : 0); }

// Decode one PNG or JPEG file (told apart by its first bytes) into out, RGB
// of size (*h, *w).  Where out is null or the image has another size,
// *h and *w get the image's and the return is -5: the caller sizes its
// buffer and calls again, so a right guess costs one call.
int byogan_decode(const char* path, uint8_t* out, int* h, int* w) {
  (void)out, (void)h, (void)w;  // unused where neither library was compiled in
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  int rc = -2;
  switch (sniff(fp)) {
    case kPng:
#if BYOGAN_HAVE_PNG
      rc = decode_png(fp, out, h, w);
#else
      rc = -7;
#endif
      break;
    case kJpeg:
#if BYOGAN_HAVE_JPEG
      rc = decode_jpeg(fp, out, h, w);
#else
      rc = -7;
#endif
      break;
    case kUnknown:
      break;
  }
  fclose(fp);
  return rc;
}

// Undo PNG's row filters (None, Sub, Up, Average, Paeth) of h zlib-inflated
// scanlines, each a filter byte and `stride` bytes, `bpp` bytes a pixel
// (at least 1), into out, h*stride bytes.  Needs no library.
int byogan_unfilter(const uint8_t* raw, int h, int stride, int bpp, uint8_t* out) {
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
        return -8;
    }
  }
  return 0;
}

// An RGB uint8 HWC image as a JPEG file at `quality` (1-100), libjpeg's
// defaults otherwise (byogan_tpu/native/byogan_io.cpp:264-298).
int byogan_encode_jpeg(const char* path, const uint8_t* data, int h, int w, int quality) {
#if BYOGAN_HAVE_JPEG
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.output_message = jpeg_quiet;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_compress(&cinfo);
    fclose(fp);
    return -4;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, fp);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(data + (size_t)cinfo.next_scanline * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return fclose(fp) == 0 ? 0 : -1;
#else
  (void)path, (void)data, (void)h, (void)w, (void)quality;
  return -7;
#endif
}

}  // extern "C"
