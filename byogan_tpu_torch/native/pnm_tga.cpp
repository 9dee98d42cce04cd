// Plain PNM samples and Targa RLE packets: the two sequential loops of the
// PNM and Targa readers (data/images.py reads their headers and raw pixels
// in numpy), bit for bit with Pillow 12.1.0's PpmPlainDecoder
// (PpmImagePlugin.py) and TgaRleDecode.c, the lane through which the JAX
// package reads those files.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

#include "codec.h"

namespace byogan {
namespace {

constexpr size_t kSafeBlock = 1 << 20;  // ImageFile.SAFEBLOCK: the plain decoder reads blocks of this

inline bool is_space(uint8_t c) { return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r'; }

// The file's bytes after the header, handed out a SAFEBLOCK at a time, with
// the plain decoder's comment removal (_ignore_comments), which may read on
// into later blocks while a comment spans them.
class Blocks {
 public:
  Blocks(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  // The next block as read: empty at the file's end.
  std::vector<uint8_t> read() {
    const size_t n = std::min(kSafeBlock, size_ - pos_);
    std::vector<uint8_t> block(data_ + pos_, data_ + pos_ + n);
    pos_ += n;
    return block;
  }

  // _ignore_comments: a comment that began in an earlier block ends at its
  // first CR or LF here (or in a later block); then every comment of the
  // block goes, '#' through its CR or LF, and one left open at the block's
  // end spans into the next.
  void strip(std::vector<uint8_t>* block) {
    if (spans_) {
      while (!block->empty()) {
        const long end = comment_end(*block, 0);
        if (end != -1) {
          block->erase(block->begin(), block->begin() + end + 1);
          break;
        }
        *block = read();
      }
    }
    spans_ = false;
    size_t from = 0;
    while (true) {
      const auto hash = std::find(block->begin() + from, block->end(), '#');
      if (hash == block->end()) break;
      const long start = hash - block->begin();
      const long end = comment_end(*block, start);
      if (end != -1) {
        block->erase(block->begin() + start, block->begin() + end + 1);
        from = start;
      } else {
        block->resize(start);
        spans_ = true;
        break;
      }
    }
  }

 private:
  // _find_comment_end: the lower of the first LF and the first CR from
  // `start`, by Pillow's test `min(a, b) if a * b > 0 else max(a, b)`, so
  // an LF or CR at index 0 loses to a later one of the other.
  static long comment_end(const std::vector<uint8_t>& block, long start) {
    auto find = [&](uint8_t c) -> long {
      const auto it = std::find(block.begin() + start, block.end(), c);
      return it == block.end() ? -1 : it - block.begin();
    };
    const long a = find('\n'), b = find('\r');
    return a * b > 0 ? std::min(a, b) : std::max(a, b);
  }

  const uint8_t* data_;
  size_t size_, pos_ = 0;
  bool spans_ = false;
};

// Python's int() of a token of at most 10 bytes: an optional sign, then
// digits with single underscores between them.  false where int() raises.
bool parse_int(const uint8_t* t, size_t n, long long* value) {
  size_t i = 0;
  bool negative = false;
  if (i < n && (t[i] == '+' || t[i] == '-')) negative = t[i++] == '-';
  if (i >= n) return false;
  long long v = 0;
  bool digit_before = false;
  for (; i < n; i++) {
    if (t[i] == '_') {
      if (!digit_before || i + 1 >= n || t[i + 1] < '0' || t[i + 1] > '9') return false;
      digit_before = false;
      continue;
    }
    if (t[i] < '0' || t[i] > '9') return false;
    v = v * 10 + (t[i] - '0');
    digit_before = true;
  }
  *value = negative ? -v : v;
  return true;
}

}  // namespace

int decode_pnm_plain(const uint8_t* data, size_t size, int bands, int w, int h, int maxval, int wide, uint8_t* out) {
  const size_t total = (size_t)w * h * bands;
  size_t count = 0;
  Blocks blocks(data, size);
  if (maxval == 0) {  // P1: every non-whitespace byte a sample, '1' black
    while (count != total) {
      std::vector<uint8_t> block = blocks.read();
      if (block.empty()) break;
      blocks.strip(&block);
      for (uint8_t c : block)  // the whole block is checked, past the samples the image needs too
        if (!is_space(c) && c != '0' && c != '1') return kPnmBitonal;
      for (uint8_t c : block) {
        if (is_space(c)) continue;
        if (count == total) break;
        out[count++] = c == '0' ? 255 : 0;
      }
    }
    return count == total ? kOk : kTruncated;  // "not enough image data"
  }
  const double out_max = wide ? 65535.0 : 255.0;  // mode I (gray above 255) scales to 16 bits, then clips at 255
  std::vector<uint8_t> half;  // a token cut by the block's end
  while (count != total) {
    std::vector<uint8_t> block = blocks.read();
    if (block.empty()) {
      if (half.empty()) break;
      block.assign(1, ' ');  // flush the half token
    }
    blocks.strip(&block);
    if (!half.empty()) {
      block.insert(block.begin(), half.begin(), half.end());
      half.clear();
    }
    size_t end = block.size();
    if (!block.empty() && !is_space(block.back())) {  // the last token may go on in the next block
      size_t start = end;
      while (start > 0 && !is_space(block[start - 1])) start--;
      half.assign(block.begin() + start, block.end());
      if (half.size() > 10) return kPnmToken;
      end = start;
    }
    for (size_t i = 0; i < end && count != total;) {
      if (is_space(block[i])) {
        i++;
        continue;
      }
      size_t j = i;
      while (j < end && !is_space(block[j])) j++;
      if (j - i > 10) return kPnmToken;
      long long v;
      if (!parse_int(block.data() + i, j - i, &v)) return kPnmInteger;
      if (v < 0) return kPnmNegative;
      if (v > maxval) return kPnmValue;
      const double q = std::nearbyint((double)v / (double)maxval * out_max);  // round(): half to even
      out[count++] = (uint8_t)(q > 255.0 ? 255.0 : q);
      i = j;
    }
  }
  return count == total ? kOk : kTruncated;
}

int decode_tga_rle(const uint8_t* data, size_t size, int pixel_bytes, int row_bytes, int rows, uint8_t* out) {
  if (pixel_bytes == 0) return kTruncated;  // 1-bit pixels: each packet covers 0 bytes, so the rows never fill
  const size_t need = (size_t)row_bytes * rows;
  size_t pos = 0, o = 0;  // o: bytes of rows written, in file order
  while (o < need) {
    if (pos >= size) return kTruncated;
    const size_t n = (size_t)pixel_bytes * ((data[pos] & 0x7f) + 1);
    if (data[pos] & 0x80) {  // a run: one pixel repeated, within one row
      if (size - pos < 1 + (size_t)pixel_bytes) return kTruncated;
      if (o % row_bytes + n > (size_t)row_bytes) return kTgaOverrun;
      for (size_t k = 0; k < n; k += pixel_bytes) memcpy(out + o + k, data + pos + 1, pixel_bytes);
      o += n;
      pos += 1 + pixel_bytes;
    } else {  // literal pixels, on across rows; past the last row they are dropped
      if (size - pos < 1 + n) return kTruncated;
      const size_t take = std::min(n, need - o);
      memcpy(out + o, data + pos + 1, take);
      o += take;
      pos += 1 + n;
    }
  }
  return kOk;
}

}  // namespace byogan
