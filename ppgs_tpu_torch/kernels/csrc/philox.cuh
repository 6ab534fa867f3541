// Philox4x32-10 dropout bits on the card: the same stream as the plain
// version in ppgs_tpu_torch/ops/dropout.py, so a kernel and its plain
// version drop the same elements.
//
// The keep bit of the element at flat index i of a site's array is
//   word (i % 4) of philox4x32_10(ctr = (g_lo, g_hi, site, 0),
//                                 key = (seed_lo, seed_hi)),  g = i / 4,
// kept when that word >= threshold. It depends on the element alone, not
// on how a kernel tiles the array.
#pragma once

#include <stdint.h>

namespace ppgs {

struct Dropout {
  uint32_t seed_lo, seed_hi;   // the step's 64-bit seed
  uint32_t site;               // which dropout point (ops/dropout.py)
  uint32_t threshold;          // drop when the draw is below it; 0 = off
  float scale;                 // 1 / (1 - rate)
};

// The site of a C entry point's (seed_lo, seed_hi, site, threshold, scale)
// arguments (ops/dropout.py Drop.c_args); scale is 1 when it is off.
inline Dropout make_dropout(uint32_t seed_lo, uint32_t seed_hi, uint32_t site,
                            uint32_t threshold, float scale) {
  Dropout d;
  d.seed_lo = seed_lo;
  d.seed_hi = seed_hi;
  d.site = site;
  d.threshold = threshold;
  d.scale = threshold ? scale : 1.f;
  return d;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Keep bits of consecutive flat indices, reusing one Philox call for the
// four indices of a group.
struct KeepStream {
  Dropout d;
  unsigned long long group;
  uint4 words;

  __device__ __forceinline__ explicit KeepStream(const Dropout& d_)
      : d(d_), group(~0ull), words(make_uint4(0u, 0u, 0u, 0u)) {}

  __device__ __forceinline__ bool keep(unsigned long long index) {
    if (d.threshold == 0u) return true;
    const unsigned long long g = index >> 2;
    if (g != group) {
      group = g;
      words = philox4x32_10(
          make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32),
                     d.site, 0u),
          d.seed_lo, d.seed_hi);
    }
    const uint32_t w[4] = {words.x, words.y, words.z, words.w};
    return w[index & 3] >= d.threshold;
  }
};

}  // namespace ppgs
