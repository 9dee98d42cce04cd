// PackBits, PCX RLE, SGI RLE, QOI, Sun raster RLE and ICNS RLE: the
// byte-sequential loops of the PSD, PCX, SGI, QOI, Sun raster and ICNS
// readers (data/images.py reads their headers and raw pixels in numpy), bit
// for bit with Pillow 12.1.0's PackbitsDecode.c, PcxDecode.c,
// SgiRleDecode.c, QoiImagePlugin.py's QoiDecoder, SunRleDecode.c and
// IcnsImagePlugin.py's read_32, the lane through which the JAX package reads
// those files.

#include <algorithm>
#include <cstring>
#include <new>

#include "codec.h"

namespace byogan {

int decode_packbits_rows(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out) {
  const size_t need = (size_t)row_bytes * rows;
  if (need == 0) return kOk;
  size_t pos = 0, o = 0, x = 0;  // x: bytes of the current row
  while (true) {
    if (pos >= size) return kTruncated;  // "image file is truncated"
    const uint8_t b = data[pos];
    if (b == 0x80) {  // a no-op
      pos++;
      continue;
    }
    if (b & 0x80) {  // a run of 257 - b copies, cut at the row's end
      if (size - pos < 2) return kTruncated;
      for (int n = 257 - b; n > 0 && x < (size_t)row_bytes; n--, x++) out[o + x] = data[pos + 1];
      pos += 2;
    } else {  // b + 1 literal bytes, cut at the row's end
      const size_t n = (size_t)b + 1;
      if (size - pos < 1 + n) return kTruncated;
      for (size_t i = 0; i < n && x < (size_t)row_bytes; i++, x++) out[o + x] = data[pos + 1 + i];
      pos += 1 + n;
    }
    if (x >= (size_t)row_bytes) {  // a whole row: the next packet starts the next one
      x = 0;
      o += row_bytes;
      if (o >= need) return kOk;
    }
  }
}

int decode_pcx_rle(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out) {
  const size_t need = (size_t)row_bytes * rows;
  size_t pos = 0, o = 0, x = 0;
  bool overrun = false;
  while (o < need) {
    if (pos >= size) return kTruncated;
    const uint8_t b = data[pos];
    if ((b & 0xC0) == 0xC0) {  // a run of b & 0x3F copies; past the row's end the rest is dropped
      if (size - pos < 2) return kTruncated;
      for (int n = b & 0x3F; n > 0; n--) {
        if (x >= (size_t)row_bytes) {
          overrun = true;  // IMAGING_CODEC_OVERRUN, raised once every row is decoded
          break;
        }
        out[o + x++] = data[pos + 1];
      }
      pos += 2;
    } else {
      out[o + x++] = b;
      pos++;
    }
    if (x >= (size_t)row_bytes) {
      x = 0;
      o += row_bytes;
    }
  }
  return overrun ? kPcxOverrun : kOk;
}

namespace {

// Pillow's expandrow (8-bit) and expandrow2 (16-bit, each atom big-endian,
// its low byte the opcode): at most n packets from data[at] into dest, a
// sample every z; -1 where a run passes the row's end or a read passes the
// last byte (data[last]), 1 where the n-th packet is not the terminating 0
// (the decoder then stops, with no error), 0 at a terminator.
int expand_row(uint8_t* dest, const uint8_t* data, size_t at, size_t last, uint32_t n, int z, int xsize, int bpc) {
  int x = 0;
  for (; n > 0; n--) {
    if (at + (bpc - 1) > last) return -1;
    const uint8_t op = data[at + bpc - 1];
    at += bpc;
    if (n == 1 && op != 0) return 1;
    int count = op & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (op & 0x80) {  // copy
      if (at + (size_t)bpc * count > last) return -1;
      for (; count > 0; count--, at += bpc, dest += (size_t)z * bpc) memcpy(dest, data + at, bpc);
    } else {  // a run of the next atom (expandrow2 asks for a byte past it)
      if (at + (bpc == 2 ? 2 : 0) > last) return -1;
      for (; count > 0; count--, dest += (size_t)z * bpc) memcpy(dest, data + at, bpc);
      at += bpc;
    }
  }
  return 0;
}

uint32_t be32(const uint8_t* p) { return (uint32_t)p[0] << 24 | p[1] << 16 | p[2] << 8 | p[3]; }

}  // namespace

int decode_sgi_rle(const uint8_t* data, size_t size, int bpc, int bands, int xsize, int ysize, uint8_t* out) {
  const size_t tablen = (size_t)bands * ysize, row = (size_t)xsize * bands * bpc;
  if (size < 8 * tablen) return kSgiOverrun;  // the offset and length tables pass the file's end
  std::memset(out, 0, row * ysize);
  uint8_t* buffer = new (std::nothrow) uint8_t[row]();  // kept across rows, as Pillow's state->buffer
  if (!buffer) return kNoMemory;
  int rc = kOk;
  for (int r = 0; r < ysize && rc == kOk; r++) {
    int status = 0;
    for (int ch = 0; ch < bands; ch++) {
      uint32_t offset = be32(data + 4 * ((size_t)r + (size_t)ch * ysize));
      const uint32_t length = be32(data + 4 * (tablen + r + (size_t)ch * ysize));
      if (offset < 512) {  // before the data
        rc = kSgiOverrun;
        break;
      }
      offset -= 512;  // the length bounds the packets, not the bytes: each read is held to the file's end
      status = expand_row(buffer + (size_t)ch * bpc, data, offset, size - 1, length, bands, xsize, bpc);
      if (status == -1) rc = kSgiOverrun;
      if (status != 0) break;
    }
    if (rc != kOk || status == 1) break;  // an unterminated row: Pillow stops, the rest stays black
    memcpy(out + (size_t)r * row, buffer, row);
  }
  delete[] buffer;
  return rc;
}

int decode_qoi(const uint8_t* data, size_t size, int bands, size_t pixels, uint8_t* out) {
  uint8_t index[64][4];
  bool seen[64] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  size_t pos = 0, n = 0;
  auto remember = [&](const uint8_t* v) {
    memcpy(prev, v, 4);
    const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    memcpy(index[h], v, 4);
    seen[h] = true;
  };
  while (n < pixels) {
    if (pos >= size) return kTruncated;  // fd.read(1)[0]: IndexError
    const uint8_t b = data[pos++];
    uint8_t v[4];
    if (b == 0xFE) {  // QOI_OP_RGB
      if (size - pos < 3) return kTruncated;
      memcpy(v, data + pos, 3);
      v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {  // QOI_OP_RGBA
      if (size - pos < 4) return kTruncated;
      memcpy(v, data + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {  // QOI_OP_INDEX: an empty slot reads (0, 0, 0, 0)
      if (seen[b])
        memcpy(v, index[b], 4);
      else
        memset(v, 0, 4);
    } else if ((b >> 6) == 1) {  // QOI_OP_DIFF
      v[0] = (uint8_t)(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = (uint8_t)(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = (uint8_t)(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {  // QOI_OP_LUMA
      if (pos >= size) return kTruncated;
      const uint8_t b2 = data[pos++];
      const int dg = (b & 0x3F) - 32;
      v[0] = (uint8_t)(prev[0] + dg + ((b2 >> 4) - 8));
      v[1] = (uint8_t)(prev[1] + dg);
      v[2] = (uint8_t)(prev[2] + dg + ((b2 & 15) - 8));
      v[3] = prev[3];
    } else {  // QOI_OP_RUN: the previous pixel again, which the index does not take in
      for (int k = (b & 0x3F) + 1; k > 0 && n < pixels; k--, n++) memcpy(out + n * bands, prev, bands);
      continue;
    }
    remember(v);
    memcpy(out + n * bands, v, bands);
    n++;
  }
  return kOk;
}

int decode_sun_rle(const uint8_t* data, size_t size, size_t row_bytes, size_t rows, uint8_t* out) {
  const size_t need = row_bytes * rows;
  size_t pos = 0, o = 0;
  while (o < need) {
    if (pos >= size) return kTruncated;
    if (data[pos] != 0x80) {  // a literal byte
      out[o++] = data[pos++];
      continue;
    }
    if (size - pos < 2) return kTruncated;
    if (data[pos + 1] == 0) {  // 0x80 0: a literal 0x80
      out[o++] = 0x80;
      pos += 2;
      continue;
    }
    if (size - pos < 3) return kTruncated;
    // 0x80 n v: n + 1 copies of v, the rest of a row's end carried into
    // the rows after it
    const size_t n = std::min<size_t>((size_t)data[pos + 1] + 1, need - o);
    memset(out + o, data[pos + 2], n);
    o += n;
    pos += 3;
  }
  return kOk;
}

int decode_icns_rle(const uint8_t* data, size_t size, size_t pixels, uint8_t* out) {
  size_t pos = 0;
  for (int band = 0; band < 3; band++) {
    uint8_t* o = out + band * pixels;
    size_t left = pixels;
    while (left > 0) {
      if (pos >= size) return kTruncated;  // "Error reading channel"
      const uint8_t b = data[pos++];
      if (b & 0x80) {  // b - 125 copies of the next byte
        const size_t n = (size_t)b - 125;
        if (n > left) return kIcnsOverrun;
        if (pos >= size) return kTruncated;
        memset(o, data[pos++], n);
        o += n;
        left -= n;
      } else {  // b + 1 literal bytes
        const size_t n = (size_t)b + 1;
        if (n > left) return kIcnsOverrun;
        if (size - pos < n) return kTruncated;
        memcpy(o, data + pos, n);
        o += n;
        pos += n;
        left -= n;
      }
    }
  }
  return kOk;
}

}  // namespace byogan
