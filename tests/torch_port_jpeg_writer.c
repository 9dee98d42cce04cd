/* A JPEG writer over the system's libjpeg, for the codec fixtures
 * (tests/torch_port_codec_fixtures.py compiles it with -ljpeg into a
 * directory it names and calls it through ctypes).  It reaches what Pillow
 * cannot ask libjpeg for: arithmetic coding with the DAC conditioning
 * values set, YCCK, CMYK without an Adobe marker, 4:4:0 and other
 * sampling factors, progressive scripts with arithmetic coding; and files
 * of coefficients chosen by the caller, with quantisers of its own
 * (byogan_write_coefficients: jpeg_write_coefficients), so a block's
 * dequantised coefficients can leave the 16-bit range.
 */

#include <setjmp.h>
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

struct byogan_error {
  struct jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void byogan_error_exit(j_common_ptr cinfo) { longjmp(((struct byogan_error *)cinfo->err)->jump, 1); }

/* An h x w file of ncomp components (1: gray, 3: YCbCr) with the (h, v)
 * factors sampling[2c], sampling[2c + 1], component c quantised by the 64
 * values quant[64c...] (natural order, 1-255) and holding the coefficients
 * coef[c] (its blocks row by row over the component's block grid rounded
 * up to whole MCUs, 64 natural-order values each); Huffman coding
 * (optimal tables) or arithmetic, sequential or progressive
 * (jpeg_simple_progression).  Returns 0, -1 if the file cannot be opened,
 * -2 if libjpeg refuses (a coefficient it cannot code). */
int byogan_write_coefficients(const char *path, int h, int w, int ncomp, const int *sampling,
                              const unsigned short *quant, const short *const *coef, int arith,
                              int progressive) {
  struct jpeg_compress_struct cinfo;
  struct byogan_error err;
  jvirt_barray_ptr arrays[4];
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = byogan_error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return -2;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = (JDIMENSION)w;
  cinfo.image_height = (JDIMENSION)h;
  cinfo.input_components = ncomp;
  cinfo.in_color_space = ncomp == 1 ? JCS_GRAYSCALE : JCS_YCbCr;
  jpeg_set_defaults(&cinfo);
  jpeg_set_colorspace(&cinfo, ncomp == 1 ? JCS_GRAYSCALE : JCS_YCbCr);
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; c++) {
    jpeg_component_info *comp = &cinfo.comp_info[c];
    comp->h_samp_factor = sampling[2 * c];
    comp->v_samp_factor = sampling[2 * c + 1];
    if (comp->h_samp_factor > hmax) hmax = comp->h_samp_factor;
    if (comp->v_samp_factor > vmax) vmax = comp->v_samp_factor;
    comp->quant_tbl_no = c;
    if (!cinfo.quant_tbl_ptrs[c]) cinfo.quant_tbl_ptrs[c] = jpeg_alloc_quant_table((j_common_ptr)&cinfo);
    for (int k = 0; k < DCTSIZE2; k++) cinfo.quant_tbl_ptrs[c]->quantval[k] = quant[64 * c + k];
    cinfo.quant_tbl_ptrs[c]->sent_table = FALSE;
  }
  cinfo.arith_code = (boolean)arith;
  cinfo.optimize_coding = (boolean)!arith;
  if (progressive) jpeg_simple_progression(&cinfo);
  int bw[4], bh[4];
  const int mcux = (w + 8 * hmax - 1) / (8 * hmax), mcuy = (h + 8 * vmax - 1) / (8 * vmax);
  for (int c = 0; c < ncomp; c++) {
    bw[c] = mcux * sampling[2 * c];
    bh[c] = mcuy * sampling[2 * c + 1];
    arrays[c] = (*cinfo.mem->request_virt_barray)((j_common_ptr)&cinfo, JPOOL_IMAGE, TRUE, (JDIMENSION)bw[c],
                                                   (JDIMENSION)bh[c], (JDIMENSION)sampling[2 * c + 1]);
  }
  jpeg_write_coefficients(&cinfo, arrays);
  for (int c = 0; c < ncomp; c++) {
    for (int by = 0; by < bh[c]; by++) {
      JBLOCKARRAY row = (*cinfo.mem->access_virt_barray)((j_common_ptr)&cinfo, arrays[c], (JDIMENSION)by, 1, TRUE);
      memcpy(row[0], coef[c] + (size_t)by * bw[c] * DCTSIZE2, (size_t)bw[c] * sizeof(JBLOCK));
    }
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return 0;
}
