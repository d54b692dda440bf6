// Lets a host C++ compiler build the kernels' per-thread headers
// (stacked_tail.cuh, compat_stage.cuh, fast_tail.cuh): CUDA qualifiers
// defined away and host versions of the funnel-shift and find-first-set
// intrinsics.

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
