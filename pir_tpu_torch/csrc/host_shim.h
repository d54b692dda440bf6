// Lets a host C++ compiler build the kernels' per-thread headers
// (stacked_tail.cuh, compat_stage.cuh): CUDA qualifiers defined away and
// host versions of the funnel-shift intrinsics.

#pragma once

#include <cstdint>

#define __device__
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
