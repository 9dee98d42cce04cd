// The WebP container (RIFF) around the VP8 and VP8L decoders: what
// Pillow's WebP lane reads, PIL.Image.open(path).convert("RGB"), which
// opens every file through libwebp's WebPAnimDecoder.
//
// A still image is a bare "VP8 " or "VP8L" chunk, or a "VP8X" header and
// then optional ALPH, ICCP, EXIF, XMP and unknown chunks around the image
// chunk; its canvas must be the frame's size.  An animation is a "VP8X"
// header with the animation flag, "ANIM" and one "ANMF" chunk a frame; its
// first frame is drawn at its offset (x2) on a canvas cleared to
// transparent black, and the background colour is ignored, as
// WebPAnimDecoder does.  Alpha never changes RGB in that lane (RGBA out,
// not premultiplied), so ALPH is checked and skipped and the ICC profile
// is not applied.  Chunks are padded to even lengths; bytes past the RIFF
// size are ignored.  A file that ends inside a chunk is truncated.

#include <cstring>
#include <new>

#include "webp.h"

namespace byogan {
namespace {

inline uint32_t le32(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24; }
inline uint32_t le24(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16; }

constexpr uint32_t fourcc(const char (&s)[5]) {
  return (uint32_t)(uint8_t)s[0] | (uint32_t)(uint8_t)s[1] << 8 | (uint32_t)(uint8_t)s[2] << 16 |
         (uint32_t)(uint8_t)s[3] << 24;
}

constexpr uint32_t kVp8 = fourcc("VP8 "), kVp8l = fourcc("VP8L"), kVp8x = fourcc("VP8X"), kAlph = fourcc("ALPH"),
                   kAnim = fourcc("ANIM"), kAnmf = fourcc("ANMF");
constexpr uint32_t kAnimationFlag = 0x02;

struct Chunk {
  uint32_t tag = 0;
  const uint8_t* payload = nullptr;
  size_t size = 0;
};

// The chunks of [pos, end), each a tag, a little-endian size and a payload
// padded to an even length.
class Chunks {
 public:
  Chunks(const uint8_t* pos, const uint8_t* end) : pos_(pos), end_(end) {}

  bool next(Chunk* c) {
    if (pos_ == end_) return false;
    if (end_ - pos_ < 8) webp_fail(kTruncated);
    c->tag = le32(pos_);
    c->size = le32(pos_ + 4);
    const size_t padded = c->size + (c->size & 1);
    if (padded > (size_t)(end_ - pos_ - 8)) webp_fail(kTruncated);
    c->payload = pos_ + 8;
    pos_ += 8 + padded;
    return true;
  }

  const uint8_t* pos() const { return pos_; }
  void rewind(const uint8_t* pos) { pos_ = pos; }

 private:
  const uint8_t* pos_;
  const uint8_t* end_;
};

// ALPH: its header byte (compression 0-1, filter 0-3, preprocessing 0-1,
// reserved 0), as libwebp's ALPHInit checks it.
void check_alpha(const Chunk& c) {
  if (c.size < 1) webp_fail(kCorrupt);
  const int h = c.payload[0];
  if ((h & 3) > 1 || ((h >> 4) & 3) > 1 || (h >> 6) != 0) webp_fail(kCorrupt);
}

// One frame's chunks (libwebp's StoreFrame): an ALPH chunk at most, then
// the VP8 or VP8L chunk.  The frame's size is its bitstream's.
void read_frame(Chunks& it, WebpFrame* f) {
  Chunk c;
  bool alpha = false;
  while (it.next(&c)) {
    if (c.tag == kAlph && !alpha) {
      check_alpha(c);
      alpha = true;
      continue;
    }
    if (c.tag == kVp8 || c.tag == kVp8l) {
      f->lossless = c.tag == kVp8l;
      if (f->lossless && alpha) webp_fail(kCorrupt);  // VP8L carries its own alpha
      f->data = c.payload;
      f->size = c.size;
      const int rc = f->lossless ? vp8l_info(c.payload, c.size, &f->width, &f->height)
                                 : vp8_info(c.payload, c.size, &f->width, &f->height);
      if (rc) webp_fail(rc);
      return;
    }
    break;
  }
  webp_fail(kCorrupt);  // no image chunk
}

}  // namespace

void webp_locate(const uint8_t* data, size_t size, WebpFrame* f) {
  if (size < 12 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WEBP", 4) != 0) webp_fail(kNotImage);
  const uint32_t riff = le32(data + 4);
  if (riff < 12) webp_fail(kCorrupt);
  if (riff > size - 8) webp_fail(kTruncated);
  Chunks it(data + 12, data + 8 + riff);
  const uint8_t* first = it.pos();
  Chunk c;
  if (!it.next(&c)) webp_fail(kTruncated);
  if (c.tag != kVp8x) {  // the simple format: the image chunk alone
    it.rewind(first);
    read_frame(it, f);
    f->canvas_w = f->width;
    f->canvas_h = f->height;
    return;
  }
  if (c.size < 10) webp_fail(kCorrupt);
  const bool animated = le32(c.payload) & kAnimationFlag;
  f->canvas_w = 1 + (int)le24(c.payload + 4);
  f->canvas_h = 1 + (int)le24(c.payload + 7);
  if ((uint64_t)f->canvas_w * f->canvas_h >= (1ull << 32)) webp_fail(kCorrupt);
  bool anim = false, found = false;
  while (true) {
    const uint8_t* at = it.pos();
    if (!it.next(&c)) break;
    if (c.tag == kAlph || c.tag == kVp8 || c.tag == kVp8l) {
      if (animated || anim || found) webp_fail(kCorrupt);  // a still image's one frame
      it.rewind(at);
      read_frame(it, f);
      found = true;
    } else if (c.tag == kAnim) {
      if (c.size < 6) webp_fail(kCorrupt);
      anim = true;
    } else if (c.tag == kAnmf) {
      if (!anim) webp_fail(kCorrupt);  // ANIM comes before the frames
      if (c.size < 16) webp_fail(kCorrupt);
      if (animated && !found) {
        Chunks frame(c.payload + 16, c.payload + c.size);
        read_frame(frame, f);
        f->x = 2 * (int)le24(c.payload);
        f->y = 2 * (int)le24(c.payload + 3);
        found = true;
      }
    }  // ICCP, EXIF, XMP and unknown chunks are skipped
  }
  if (!found) webp_fail(kCorrupt);
  if (animated) {
    if ((int64_t)f->x + f->width > f->canvas_w || (int64_t)f->y + f->height > f->canvas_h)
      webp_fail(kWebpFrameOutside);
  } else if (f->width != f->canvas_w || f->height != f->canvas_h) {
    webp_fail(kWebpCanvas);
  }
}

int decode_webp(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w) {
  try {
    WebpFrame f;
    webp_locate(data, size, &f);
    if (!out || *h != f.canvas_h || *w != f.canvas_w) {
      *h = f.canvas_h;
      *w = f.canvas_w;
      return kSize;
    }
    const size_t stride = (size_t)f.canvas_w * 3;
    if (f.width != f.canvas_w || f.height != f.canvas_h) memset(out, 0, stride * f.canvas_h);
    uint8_t* dst = out + (size_t)f.y * stride + (size_t)f.x * 3;
    if (f.lossless) {
      std::vector<uint32_t> argb;
      int fw, fh;
      vp8l_decode(f.data, f.size, &argb, &fw, &fh);
      for (int y = 0; y < fh; y++) {
        uint8_t* row = dst + (size_t)y * stride;
        for (int x = 0; x < fw; x++) {
          const uint32_t p = argb[(size_t)y * fw + x];
          row[3 * x] = (uint8_t)(p >> 16);
          row[3 * x + 1] = (uint8_t)(p >> 8);
          row[3 * x + 2] = (uint8_t)p;
        }
      }
    } else {
      Vp8Planes planes;
      vp8_decode(f.data, f.size, &planes);
      vp8_to_rgb(planes, dst, stride);
    }
    return kOk;
  } catch (const WebpError& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

int decode_webp_planes(const uint8_t* data, size_t size, Vp8Planes* planes) {
  try {
    WebpFrame f;
    webp_locate(data, size, &f);
    if (f.lossless) return kNotImage;
    vp8_decode(f.data, f.size, planes);
    return kOk;
  } catch (const WebpError& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace byogan
