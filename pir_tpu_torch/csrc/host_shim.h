// Lets a host C++ compiler build the kernels' per-thread headers
// (aes_lanes.cuh, stacked_tail.cuh, compat_stage.cuh, fast_tail.cuh):
// CUDA qualifiers defined away, the uint4 vector type, and host versions
// of the funnel-shift, byte-permute and find-first-set intrinsics.

#pragma once

#include <cstdint>

#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__

static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned s) {
  s &= 31;
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
static inline int __ffs(int x) { return x ? __builtin_ctz((unsigned)x) + 1 : 0; }

struct uint4 {
  uint32_t x, y, z, w;
};
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return uint4{x, y, z, w};
}
// Byte n of the result is byte (s >> 4n) & 7 of the 8 bytes y:x.
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) r |= (uint32_t)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n);
  return r;
}
