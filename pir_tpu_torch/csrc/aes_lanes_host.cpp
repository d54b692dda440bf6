// Host build of the kernels' AES and bit-plane transpose, for checking
// them without a GPU: aes_lanes.cuh's per-bank table read as one lane
// sees it, and the lockstep model of warp_unbitslice.
// tests/test_torch_aes_host.py compiles this file with a host C++
// compiler and holds it against FIPS-197 and numpy.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libaes_lanes_host.so aes_lanes_host.cpp

#include <cstring>

#include "host_shim.h"
#include "stacked_tail.cuh"

using namespace pir_tail;

// n blocks in (n, 4) words, each under its own 44 round-key words of
// rk (n, 44), into out (n, 4), with the per-bank table as lane `lane`
// (0..31) reads it.
extern "C" void pir_aes_host(const uint32_t* rk, const uint32_t* in, uint32_t* out, int n,
                             int lane) {
  static AesLaneTable lanes;
  for (int i = 0; i < 2048; ++i) fill_lane_table(lanes, i);
  const AesLanes T = lanes_of(lanes, lane);
  for (int b = 0; b < n; ++b) {
    alignas(16) uint32_t key[44];
    std::memcpy(key, rk + (size_t)b * 44, sizeof key);
    aes128(T, key, in + (size_t)b * 4, out + (size_t)b * 4);
  }
}

// The 32 lanes' blocks (32, 4) of warp_unbitslice from the plane words
// at p, word (bit k, byte i) at p[k * bit_stride + i * byte_stride].
extern "C" void pir_unbitslice_host(const uint32_t* p, long long bit_stride,
                                    long long byte_stride, uint32_t* blocks) {
  unbitslice_lockstep(p, (size_t)bit_stride, (size_t)byte_stride,
                      reinterpret_cast<uint32_t(*)[4]>(blocks));
}
