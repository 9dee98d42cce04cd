// An IM file's "L*n" samples of n bits (2 to 31 but 8 and 16) as floats:
// the sequential loop of the IM reader (data/images.py reads the header
// in numpy), bit for bit with Pillow 12.1.0's "bit" decoder (Bit.c) under
// the arguments ImImagePlugin gives it, (bits, 8, 3, 0, -1): codes least
// significant bit first, rows bottom-up and padded to a byte.

#include "codec.h"

namespace byogan {

int decode_im_bits(const uint8_t* data, size_t size, int bits, int w, int h, float* out) {
  if (bits < 1 || bits >= 32 || w <= 0 || h <= 0) return kCorrupt;  // Bit.c: "bad configuration"
  const uint64_t mask = ((uint64_t)1 << bits) - 1;
  uint64_t buffer = 0;
  int count = 0, x = 0, y = h - 1;
  for (size_t i = 0; i < size; i++) {
    const uint8_t byte = data[i];
    buffer |= (uint64_t)byte << count;  // fill order 1: each byte above the bits held
    count += 8;
    while (count >= bits) {
      const uint64_t value = buffer & mask;  // fill order 2: the low bits first
      if (count > 32)
        buffer = byte >> (8 - (count - bits));  // Bit.c's refill from the last byte on overflow
      else
        buffer >>= bits;
      count -= bits;
      out[(size_t)y * w + x] = (float)value;
      if (++x >= w) {
        if (--y < 0) return kOk;
        x = 0;
        count = 0;  // pad 8: the next row starts on a byte, the bits left in the buffer stay
      }
    }
  }
  return kTruncated;  // "image file is truncated"
}

}  // namespace byogan
