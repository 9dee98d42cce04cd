/* A JPEG writer over the system's libjpeg, for the codec fixtures
 * (tests/torch_port_codec_fixtures.py compiles it with -ljpeg into a
 * directory it names and calls it through ctypes).  It reaches what Pillow
 * cannot ask libjpeg for: arithmetic coding with the DAC conditioning
 * values set, YCCK, CMYK without an Adobe marker, 4:4:0 and other
 * sampling factors, progressive scripts with arithmetic coding.
 */

#include <stdio.h>
#include <string.h>

#include <jpeglib.h>

/* What byogan_write_jpeg is asked for; -1 keeps libjpeg's default. */
struct byogan_jpeg_options {
  int quality;
  int arith;            /* arithmetic coding */
  int progressive;      /* jpeg_simple_progression */
  int restart_interval; /* in MCUs */
  int restart_rows;     /* in MCU rows */
  int jpeg_space;       /* J_COLOR_SPACE of the file, or -1 for jpeg_default_colorspace */
  int adobe;            /* write_Adobe_marker */
  int jfif;             /* write_JFIF_header */
  int dc_l, dc_u, ac_k; /* arith_dc_L / _U and arith_ac_K of every table */
  int sampling[8];      /* (h, v) of each component, 0 for libjpeg's */
};

/* samples: h x w x components uint8 in in_space (JCS_RGB, JCS_GRAYSCALE or
 * JCS_CMYK).  Returns 0, or -1 if the file cannot be opened. */
int byogan_write_jpeg(const char *path, const unsigned char *samples, int h, int w, int in_space,
                      const struct byogan_jpeg_options *o) {
  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = (JDIMENSION)w;
  cinfo.image_height = (JDIMENSION)h;
  cinfo.in_color_space = (J_COLOR_SPACE)in_space;
  cinfo.input_components = in_space == JCS_GRAYSCALE ? 1 : in_space == JCS_CMYK ? 4 : 3;
  jpeg_set_defaults(&cinfo);
  if (o->jpeg_space >= 0) jpeg_set_colorspace(&cinfo, (J_COLOR_SPACE)o->jpeg_space);
  if (o->quality >= 0) jpeg_set_quality(&cinfo, o->quality, TRUE);
  for (int c = 0; c < cinfo.num_components && c < 4; c++) {
    if (o->sampling[2 * c]) {
      cinfo.comp_info[c].h_samp_factor = o->sampling[2 * c];
      cinfo.comp_info[c].v_samp_factor = o->sampling[2 * c + 1];
    }
  }
  if (o->arith >= 0) cinfo.arith_code = (boolean)o->arith;
  for (int i = 0; i < NUM_ARITH_TBLS; i++) {
    if (o->dc_l >= 0) cinfo.arith_dc_L[i] = (UINT8)o->dc_l;
    if (o->dc_u >= 0) cinfo.arith_dc_U[i] = (UINT8)o->dc_u;
    if (o->ac_k >= 0) cinfo.arith_ac_K[i] = (UINT8)o->ac_k;
  }
  if (o->restart_interval >= 0) cinfo.restart_interval = (unsigned int)o->restart_interval;
  if (o->restart_rows >= 0) cinfo.restart_in_rows = o->restart_rows;
  if (o->adobe >= 0) cinfo.write_Adobe_marker = (boolean)o->adobe;
  if (o->jfif >= 0) cinfo.write_JFIF_header = (boolean)o->jfif;
  if (o->progressive > 0) jpeg_simple_progression(&cinfo);
  jpeg_start_compress(&cinfo, TRUE);
  const int stride = w * cinfo.input_components;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = (JSAMPROW)(samples + (size_t)cinfo.next_scanline * stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return 0;
}
