// XBM's hex bytes, MSP version 2's RLE and an FLI/FLC animation's first
// frame: the sequential loops of the XBM, MSP and FLI readers
// (data/images.py reads their headers and palettes in numpy), bit for bit
// with Pillow 12.1.0's XbmDecode.c, MspImagePlugin.py's MspDecoder and
// FliDecode.c, the lane through which the JAX package reads those files.

#include <algorithm>
#include <climits>
#include <cstring>

#include "codec.h"

namespace byogan {

namespace {

// XbmDecode.c's HEX: a hex digit's value, 0 for any other character.
inline int hex_value(uint8_t c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return 0;
}

inline int u16le(const uint8_t* p) { return p[0] | p[1] << 8; }

// FliDecode.c's I32: four bytes little-endian, held in a C int.
inline int i32le(const uint8_t* p) { return (int)((uint32_t)p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24); }

}  // namespace

int decode_xbm(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out) {
  // each byte is the two characters after the next 'x', whatever precedes
  // it; the stream ends before the last row's last byte: truncated
  size_t pos = 0, o = 0;
  const size_t need = (size_t)row_bytes * rows;
  while (o < need) {
    while (pos < size && data[pos] != 'x') pos++;
    if (size - pos < 3) return kTruncated;  // "image file is truncated"
    out[o++] = (uint8_t)(hex_value(data[pos + 1]) << 4 | hex_value(data[pos + 2]));
    pos += 3;
  }
  return kOk;
}

int decode_msp_rle(const uint8_t* data, size_t size, int row_bytes, int rows, uint8_t* out) {
  // the row map (a 16-bit length a row), then each row's runs written on
  // one after the other, whatever length each row decodes to; the stream
  // then read as rows of row_bytes
  if (size < 2 * (size_t)rows) return kMspRowMap;
  const size_t need = (size_t)row_bytes * rows;
  size_t pos = 2 * (size_t)rows, o = 0;
  auto put = [&](const uint8_t* src, uint8_t value, size_t n) {
    const size_t k = o < need ? std::min(n, need - o) : 0;
    if (k && src)
      memcpy(out + o, src, k);
    else if (k)
      memset(out + o, value, k);
    o += n;
  };
  for (int r = 0; r < rows; r++) {
    const size_t len = (size_t)u16le(data + 2 * (size_t)r);
    if (len == 0) {  // a blank row: white
      put(nullptr, 0xFF, row_bytes);
      continue;
    }
    if (size - pos < len) return kMspRowCut;  // "Truncated MSP file, expected ... bytes on row ..."
    const uint8_t* row = data + pos;
    pos += len;
    size_t i = 0;
    while (i < len) {
      const uint8_t type = row[i++];
      if (type == 0) {  // a run: count, then the byte
        if (len - i < 2) return kMspCorrupt;  // struct.error: "Corrupted MSP file in row ..."
        put(nullptr, row[i + 1], row[i]);
        i += 2;
      } else {  // `type` literal bytes, cut at the row's end
        put(row + i, 0, std::min<size_t>(type, len - i));
        i += type;
      }
    }
  }
  return o < need ? kMspShort : kOk;  // "not enough image data"
}

namespace {

enum FliState { kFliMore = 0, kFliEnd = 1 };

// One call of FliDecode.c's ImagingFliDecode on buf[0, bytes): the bytes it
// consumed (*consumed, kFliMore: 0 where it waits for a whole frame, or a
// COPY chunk's start where its data are not all there), or kFliEnd and
// *err (0 at the frame's end, else Pillow's error code).
int fli_decode_once(const uint8_t* buf, long bytes, int w, int h, uint8_t* img, long* consumed, int* err) {
  *consumed = 0;
  *err = 0;
  if (bytes < 4) return kFliMore;
  const uint8_t* ptr = buf;
  const int framesize = i32le(ptr);
  if (bytes + (bytes % 2) < framesize) return kFliMore;  // there can be one pad byte in the frame size
  if (bytes < 8) {
    *err = -1;
    return kFliEnd;
  }
  if (u16le(ptr + 4) != 0xF1FA) {  // not a frame chunk
    *err = -3;
    return kFliEnd;
  }
  const int chunks = u16le(ptr + 6);
  ptr += 16;
  bytes -= 16;
#define OOB(offset)                 \
  if (data + (offset) > ptr + bytes) { \
    *err = -1;                      \
    return kFliEnd;                 \
  }
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) {
      *err = -1;
      return kFliEnd;
    }
    const uint8_t* data = ptr + 6;
    switch (u16le(ptr + 4)) {
      case 4:
      case 11:  // colour chunks: the palette, read by the header's reader
        break;
      case 7: {  // SS2: word delta
        const int lines = u16le(data);
        data += 2;
        int l, y;
        for (l = y = 0; l < lines && y < h; l++, y++) {
          uint8_t* row = img + (size_t)y * w;
          OOB(2)
          int packets = u16le(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {  // skip lines
              y += 65536 - packets;
              if (y >= h) {
                *err = -1;
                return kFliEnd;
              }
              row = img + (size_t)y * w;
            } else {  // the last byte of an odd row
              row[w - 1] = (uint8_t)packets;
            }
            OOB(2)
            packets = u16le(data);
            data += 2;
          }
          int p, x;
          for (p = x = 0; p < packets; p++) {
            OOB(2)
            x += data[0];
            if (data[1] >= 128) {  // a run of words
              OOB(4)
              const int i = 256 - data[1];
              if (x + i + i > w) break;
              for (int j = 0; j < i; j++) {
                row[x++] = data[2];
                row[x++] = data[3];
              }
              data += 4;
            } else {  // literal words
              const int i = 2 * (int)data[1];
              if (x + i > w) break;
              OOB(2 + i)
              memcpy(row + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) {
          *err = -1;
          return kFliEnd;
        }
        break;
      }
      case 12: {  // LC: byte delta
        int y = u16le(data);
        const int ymax = y + u16le(data + 2);
        data += 4;
        for (; y < ymax && y < h; y++) {
          uint8_t* row = img + (size_t)y * w;
          OOB(1)
          const int packets = *data++;
          int p, x, i = 0;
          for (p = x = 0; p < packets; p++, x += i) {
            OOB(2)
            x += data[0];
            if (data[1] & 0x80) {  // a run
              i = 256 - data[1];
              if (x + i > w) break;
              OOB(3)
              memset(row + x, data[2], i);
              data += 3;
            } else {  // literal bytes
              i = data[1];
              if (x + i > w) break;
              OOB(2 + i)
              memcpy(row + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) {
          *err = -1;
          return kFliEnd;
        }
        break;
      }
      case 13:  // BLACK
        memset(img, 0, (size_t)w * h);
        break;
      case 15: {  // BRUN: byte run length, every row whole
        for (int y = 0; y < h; y++) {
          uint8_t* row = img + (size_t)y * w;
          data += 1;  // the packet count, ignored
          int x, i = 0;
          for (x = 0; x < w; x += i) {
            OOB(2)
            if (data[0] & 0x80) {  // literal bytes
              i = 256 - data[0];
              if (x + i > w) break;
              OOB(i + 1)
              memcpy(row + x, data + 1, i);
              data += i + 1;
            } else {  // a run
              i = data[0];
              if (x + i > w) break;
              memset(row + x, data[1], i);
              data += 2;
            }
          }
          if (x != w) {
            *err = -1;
            return kFliEnd;
          }
        }
        break;
      }
      case 16:  // COPY: the frame's pixels as they are
        if (INT_MAX / w < h) {
          *err = -1;
          return kFliEnd;
        }
        if (data + (long)w * h > ptr + bytes) {  // not all there yet: consumed up to this chunk
          *consumed = ptr - buf;
          return kFliMore;
        }
        memcpy(img, data, (size_t)w * h);
        break;
      case 18:  // PSTAMP: ignored
        break;
      default:  // an unknown chunk
        *err = -3;
        return kFliEnd;
    }
    const int advance = i32le(ptr);
    if (advance == 0) {  // no advance: it would loop forever
      *err = -2;
      return kFliEnd;
    }
    if (advance < 0 || advance > bytes) {
      *err = -1;
      return kFliEnd;
    }
    ptr += advance;
    bytes -= advance;
  }
#undef OOB
  return kFliEnd;
}

}  // namespace

int decode_fli(const uint8_t* data, size_t size, int w, int h, uint8_t* out) {
  // ImageFile.load's loop over the frame: reads of the frame size's bytes
  // (the field's unsigned value) appended to what the decoder left, until
  // it ends the frame; a read at the file's end: truncated
  memset(out, 0, (size_t)w * h);
  if (size < 4) return kTruncated;
  const size_t block = (size_t)((uint32_t)data[0] | data[1] << 8 | data[2] << 16 | (uint32_t)data[3] << 24);
  size_t start = 0, end = 0;
  while (true) {
    const size_t s = std::min(block, size - end);
    if (s == 0) return kTruncated;  // "image file is truncated"
    end += s;
    long consumed;
    int err;
    if (fli_decode_once(data + start, (long)(end - start), w, h, out, &consumed, &err) == kFliEnd) {
      if (err == -1) return kFliOverrun;
      if (err == -2) return kFliBroken;
      if (err == -3) return kFliUnknown;
      return kOk;
    }
    start += consumed;
  }
}

}  // namespace byogan
