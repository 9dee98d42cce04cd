// GIF decode: the first frame as uint8 RGB, bit for bit with Pillow 12.1.0's
// Image.open(path).convert("RGB"), the lane through which the JAX package
// reads a GIF under a listed extension (its prep, cli.project and its
// loader's fallback).
//
// Pillow's control flow, not the GIF specification's, is what is followed:
//
// - the header and the blocks before the first image are parsed as
//   GifImagePlugin._open and _seek(0) parse them (data() sub-blocks, which
//   a short block may end; extensions skipped by their sub-blocks, a
//   graphic control extension read for its transparency index; any other
//   byte skipped one at a time);
// - a colour table that is the gray ramp (entry i = (i, i, i)) is dropped,
//   so the frame is "L" and an index reads as its own gray, unless a
//   global table that is not a ramp stands behind a local ramp: then the
//   global table colours the frame (Pillow's image takes the palette it
//   holds at load);
// - an index past the table's end reads black;
// - the screen grows to hold a frame that leaves it; outside the frame the
//   screen holds the transparency index, or 0;
// - the LZW data follow libImaging's GifDecode.c: the same table of 4096
//   entries, a clear code ignored right after a clear, codes past the next
//   free entry refused, no entry added once the table is full, the code
//   size up to 12 bits (minimum code sizes 0-12), interlaced passes, and
//   the end as Pillow's ImageFile.load sees it: the frame ends when its
//   last pixel is written; an end code before that, or data that run out,
//   fail where the file holds no more bytes to read (Pillow reads the file
//   in blocks of 65536 bytes and gives each to the decoder, which goes on
//   past an end code with the next block).

#include <cstring>
#include <vector>

#include "codec.h"

namespace byogan {
namespace {

constexpr int kTable = 4096;      // GIFTABLE
constexpr int kMaxCodeBits = 12;  // GIFBITS
constexpr size_t kReadBlock = 65536;  // ImageFile.decodermaxblock
// Image._decompression_bomb_check: more pixels than twice MAX_IMAGE_PIXELS raise
constexpr uint64_t kMaxPixels = 2ull * 89478485ull;

// The file as Pillow's fp reads it: a short read at the end, never past it.
struct Reader {
  const uint8_t* data;
  size_t size, pos;
  size_t read(size_t n, const uint8_t** at) {
    *at = data + pos;
    const size_t got = pos + n <= size ? n : size - pos;
    pos += got;
    return got;
  }
  int byte() { return pos < size ? data[pos++] : -1; }
  // GifImageFile.data(): a sub-block's bytes (possibly cut short by the
  // file's end), or none where its length byte is 0 or missing.
  bool sub_block(const uint8_t** at, size_t* n) {
    const int len = byte();
    if (len <= 0) return false;
    *n = read((size_t)len, at);
    return true;
  }
};

// GifImageFile._is_palette_needed: false for the gray ramp.  Python's
// chained i // 3 == p[i] == p[i + 1] == p[i + 2] reads each byte only where
// the comparison before it held; one past a table cut short raises
// IndexError: -1.
int palette_needed(const uint8_t* p, size_t n) {
  for (size_t i = 0; i < n; i += 3) {
    if (i / 3 != p[i]) return 1;
    if (i + 1 >= n) return -1;
    if (p[i] != p[i + 1]) return 1;
    if (i + 2 >= n) return -1;
    if (p[i + 1] != p[i + 2]) return 1;
  }
  return 0;
}

// The LZW data of one frame (GifDecode.c) from stream[0, n) into the
// frame's rows of `image` (row stride `stride`), as ImageFile.load feeds
// the decoder.  kOk once the frame's last pixel is written.
int lzw_frame(const uint8_t* stream, size_t n, int bits, bool interlace, int xsize, int ysize, uint8_t* image,
              size_t stride) {
  if (bits < 0 || bits > kMaxCodeBits) return kGifCodeSize;
  if (n == 0) return kTruncated;
  std::vector<uint8_t> data(kTable), buffer(kTable);
  std::vector<uint16_t> link(kTable);
  const int clear = 1 << bits, end = clear + 1;
  int pass = interlace ? 1 : 0, step = interlace ? 8 : 1;
  int x = 0, y = 0;
  int state = 1, next = 0, codesize = 0, codemask = 0, lastcode = 0;
  uint8_t lastdata = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  size_t ptr = 0;
  size_t fed = n < kReadBlock ? n : kReadBlock;  // the bytes ImageFile.load has handed over
  // the decoder returned to load(): go on with the next block, or fail where the file holds none
  auto more = [&]() -> bool {
    if (fed == n) return false;
    fed = n - fed < kReadBlock ? n : fed + kReadBlock;
    return true;
  };
  uint8_t* out = image;
  // NEWLINE of GifDecode.c: false once the frame is whole
  auto newline = [&]() -> bool {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (pass) {
        case 1:
          y = 4;
          pass = 2;
          break;
        case 2:
          step = 4;
          y = 2;
          pass = 3;
          break;
        case 3:
          step = 2;
          y = 1;
          pass = 0;
          break;
        default:
          return false;
      }
    }
    out = image + (size_t)y * stride;
    return true;
  };
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
    }
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuffer |= (uint32_t)stream[ptr++] << bitcount;
        bitcount += 8;
        blocksize--;
      } else {
        // a new sub-block, decoded only once all of it has been handed over
        while (ptr + 1 > fed || ptr + 1 + stream[ptr] > fed)
          if (!more()) return kTruncated;
        blocksize = stream[ptr++];
      }
    }
    int c = (int)(bitbuffer & (uint32_t)codemask);
    bitbuffer >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      if (state != 2) state = 1;
      continue;
    }
    if (c == end) {
      if (!more()) return kTruncated;
      continue;
    }
    const uint8_t* p;
    int len;
    int index = kTable;  // the string, right-aligned in buffer
    if (state == 2) {
      if (c > clear) return kGifBroken;
      lastdata = (uint8_t)c;
      lastcode = c;
      state = 3;
      p = &lastdata;
      len = 1;
    } else {
      const int thiscode = c;
      if (c > next) return kGifBroken;
      if (c == next) {  // the string of the last code and its first byte
        buffer[--index] = lastdata;
        c = lastcode;
      }
      while (c >= clear) {
        if (index <= 0 || c >= kTable) return kGifBroken;
        buffer[--index] = data[c];
        c = link[c];
      }
      lastdata = (uint8_t)c;
      if (next < kTable) {
        data[next] = (uint8_t)c;
        link[next] = (uint16_t)lastcode;
        if (next == codemask && codesize < kMaxCodeBits) {
          codesize++;
          codemask = (1 << codesize) - 1;
        }
        next++;
      }
      lastcode = thiscode;
      // GifDecode.c returns lastdata, then the buffered string
      if (index == kTable) {
        p = &lastdata;
        len = 1;
      } else {
        out[x] = lastdata;
        if (++x >= xsize && !newline()) return kOk;
        p = buffer.data() + index;
        len = kTable - index;
      }
    }
    for (int i = 0; i < len; i++) {
      out[x] = p[i];
      if (++x >= xsize && !newline()) return kOk;
    }
  }
}

}  // namespace

int decode_gif(const uint8_t* file, size_t size, uint8_t* rgb, int* h, int* w) {
  Reader fp{file, size, 0};
  const uint8_t* s;
  if (fp.read(13, &s) < 11) return kGifHeader;  // i16(s, 8) and s[10] of a short header
  if (memcmp(s, "GIF87a", 6) != 0 && memcmp(s, "GIF89a", 6) != 0) return kNotImage;
  int width = s[6] | s[7] << 8, height = s[8] | s[9] << 8;
  const int flags = s[10];
  const uint8_t* global = nullptr;
  size_t global_n = 0;
  if (flags & 128) {
    if (fp.pos < 12) return kGifHeader;  // s[11]: the background index
    const uint8_t* p;
    const size_t n = fp.read((size_t)3 << ((flags & 7) + 1), &p);
    const int needed = palette_needed(p, n);
    if (needed < 0) return kGifHeader;
    if (needed) {
      global = p;
      global_n = n;
    }
  }
  // _seek(0): the blocks before the first image
  int b = fp.byte();
  if (b < 0 || b == ';') return kGifNoImage;
  int transparency = -1;
  bool found = false, local = false, interlace = false;
  const uint8_t* local_p = nullptr;
  size_t local_n = 0;
  int x0 = 0, y0 = 0, fw = 0, fh = 0, bits = 0;
  size_t offset = 0;
  for (;;) {
    if (b < 0) b = fp.byte();
    if (b < 0 || b == ';') break;
    if (b == '!') {
      const int label = fp.byte();
      if (label < 0) return kGifHeader;  // s[0] of an empty read
      const uint8_t* block;
      size_t block_n = 0;
      bool has = fp.sub_block(&block, &block_n);
      if (label == 249 && has) {  // graphic control extension
        if (block_n < 1) return kGifHeader;
        if ((block[0] & 1) && block_n < 4) return kGifHeader;
        if (block_n < 3) return kGifHeader;  // i16(block, 1): the delay
        if (block[0] & 1) transparency = block[3];
      } else if (label == 254) {  // comment: its sub-blocks are read to their end
        while (has && block_n) has = fp.sub_block(&block, &block_n);
        b = -1;
        continue;
      } else if (label == 255 && has) {  // application extension
        if (block_n >= 11 && memcmp(block, "NETSCAPE2.0", 11) == 0) fp.sub_block(&block, &block_n);
      }
      while (fp.sub_block(&block, &block_n)) {
      }
    } else if (b == ',') {
      const uint8_t* d;
      const size_t got = fp.read(9, &d);
      if (got < 9) return kGifHeader;
      x0 = d[0] | d[1] << 8;
      y0 = d[2] | d[3] << 8;
      fw = d[4] | d[5] << 8;
      fh = d[6] | d[7] << 8;
      const int x1 = x0 + fw, y1 = y0 + fh;
      width = x1 > width ? x1 : width;  // the screen grows to hold the frame
      height = y1 > height ? y1 : height;
      interlace = (d[8] & 64) != 0;
      if (d[8] & 128) {
        const size_t n = fp.read((size_t)3 << ((d[8] & 7) + 1), &local_p);
        const int needed = palette_needed(local_p, n);
        if (needed < 0) return kGifHeader;
        local = true;
        local_n = needed ? n : 0;  // 0: a ramp, dropped (Pillow's palette = False)
      }
      bits = fp.byte();
      if (bits < 0) return kGifHeader;
      offset = fp.pos;
      found = true;
      break;
    }
    b = -1;
  }
  if (!found) return kGifNoImage;
  if ((uint64_t)(width > 1 ? width : 1) * (uint64_t)(height > 1 ? height : 1) > kMaxPixels) return kTooLarge;
  if (x0 == 0 && fw == 0) {  // decode.c's setimage reads extents (0, y0, 0, y1) as the whole image
    y0 = 0;
    fw = width;
    fh = height;
  }
  if (fw <= 0 || fh <= 0) return kGifEmptyFrame;  // "tile cannot extend outside image"
  // the table that colours the frame: the frame's own where it is not a
  // ramp; behind a local ramp or no local table, the global one
  const uint8_t* table = nullptr;
  size_t table_n = 0;
  if (local && local_n) {
    table = local_p;
    table_n = local_n;
  } else if (global) {
    table = global;
    table_n = global_n;
  }
  const bool gray = !table;  // "L" with no palette: each index its own gray
  if (!rgb || *h != height || *w != width) {
    *h = height;
    *w = width;
    return kSize;
  }
  std::vector<uint8_t> index((size_t)height * width, (uint8_t)(transparency >= 0 ? transparency : 0));
  const int rc = lzw_frame(file + offset, size - offset, bits, interlace, fw, fh,
                           index.data() + (size_t)y0 * width + x0, (size_t)width);
  if (rc) return rc;
  uint8_t lut[256][3];
  for (int i = 0; i < 256; i++) {
    for (int k = 0; k < 3; k++) {
      if (gray)
        lut[i][k] = (uint8_t)i;
      else
        lut[i][k] = (size_t)i < table_n / 3 ? table[3 * i + k] : 0;  // past the table's end: black
    }
  }
  for (size_t i = 0; i < index.size(); i++) memcpy(rgb + 3 * i, lut[index[i]], 3);
  return kOk;
}

}  // namespace byogan
