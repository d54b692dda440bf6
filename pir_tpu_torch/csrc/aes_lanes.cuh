// Byte-oriented AES-128 with a bank-conflict-free T-table, for kernels
// whose warps look up table entries at data-dependent addresses: the
// stacked tail (stacked_tail.cu), the compat stage (compat_stage.cu), the
// per-query tail (fast_tail.cu) and the fused kernel's tail items
// (fused_scan_expand.cu).
//
// A one-copy 256-word table in shared memory would put a warp's 32
// lookups in random banks: a load then takes as many shared-memory passes
// as the most-loaded bank holds, ~3.5 for 32 random picks of 32 banks.
// Here the table holds T0 once per bank: word 32 x + j is T0[x], so lane
// j always reads bank j and every lookup is one pass (32 KB a block). The
// last round's S-box byte is byte 1 of T0[x], assembled with __byte_perm,
// so there is no second table; round keys are read as 16-byte
// warp-uniform loads, 11 a block.
//
// Block convention as in stacked_tail.cuh: a block is 4 little-endian
// 32-bit words, word c = state column c; round keys are 44 words in the
// same packing, 16-byte aligned.

#pragma once

#include <cstdint>

namespace pir_tail {

__device__ const uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

// T0[x] = (2S[x], S[x], S[x], 3S[x]) as little-endian bytes: the
// MixColumns column of a state byte at row 0; rows 1..3 are rotations.
__device__ __forceinline__ uint32_t t0_entry(uint32_t v) {
  const uint32_t v2 = ((v << 1) ^ ((v & 0x80u) ? 0x1Bu : 0u)) & 0xFFu;
  return v2 | (v << 8) | (v << 16) | ((v2 ^ v) << 24);
}

// T0 replicated once per bank: word 32 x + j holds T0[x].
struct AesLaneTable {
  uint32_t t[256 * 32];
};

// Words 4i .. 4i + 3 (i < 2048) as one 16-byte store: T0[i / 8] for
// lanes 4 (i % 8) .. 4 (i % 8) + 3.
__device__ __forceinline__ void fill_lane_table(AesLaneTable& tb, int i) {
  const uint32_t v = t0_entry(kSbox[i >> 3]);
  reinterpret_cast<uint4*>(tb.t)[i] = make_uint4(v, v, v, v);
}

// One lane's view of the table: T0[x] in the lane's bank. On the card it
// holds the shared-memory address of T0[0] for the lane, so a lookup is
// one multiply-add and one shared load (indexing the array instead folds
// the lane into a word index and rescales it, an extra instruction).
struct AesLanes {
#ifdef __CUDACC__
  uint32_t base;
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
    uint32_t v;
    asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(base + x * 128u));
    return v;
  }
#else
  const uint32_t* t;
  uint32_t operator()(uint32_t x) const { return t[x << 5]; }
#endif
};

__device__ __forceinline__ AesLanes lanes_of(const AesLaneTable& tb, int lane) {
#ifdef __CUDACC__
  return AesLanes{static_cast<uint32_t>(__cvta_generic_to_shared(tb.t + lane))};
#else
  return AesLanes{tb.t + lane};
#endif
}

// Byte k of s in the low byte, one instruction each (a byte permute,
// which the compiler does not merge into the address arithmetic).
__device__ __forceinline__ uint32_t byte0(uint32_t s) { return __byte_perm(s, 0u, 0x4440u); }
__device__ __forceinline__ uint32_t byte1(uint32_t s) { return __byte_perm(s, 0u, 0x4441u); }
__device__ __forceinline__ uint32_t byte2(uint32_t s) { return __byte_perm(s, 0u, 0x4442u); }
__device__ __forceinline__ uint32_t byte3(uint32_t s) { return __byte_perm(s, 0u, 0x4443u); }

// One AES-128 encryption: rk = 44 round-key words, 16-byte aligned.
__device__ __forceinline__ void aes128(const AesLanes& T, const uint32_t* rk,
                                       const uint32_t in[4], uint32_t out[4]) {
  const uint4* k4 = reinterpret_cast<const uint4*>(rk);
  uint4 k = k4[0];
  uint32_t s0 = in[0] ^ k.x, s1 = in[1] ^ k.y, s2 = in[2] ^ k.z, s3 = in[3] ^ k.w;
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    // SubBytes + ShiftRows + MixColumns: new column c takes row j from
    // old column (c + j) % 4
    k = k4[r];
    const uint32_t n0 = T(byte0(s0)) ^ rotl(T(byte1(s1)), 8) ^ rotl(T(byte2(s2)), 16) ^
                        rotl(T(byte3(s3)), 24) ^ k.x;
    const uint32_t n1 = T(byte0(s1)) ^ rotl(T(byte1(s2)), 8) ^ rotl(T(byte2(s3)), 16) ^
                        rotl(T(byte3(s0)), 24) ^ k.y;
    const uint32_t n2 = T(byte0(s2)) ^ rotl(T(byte1(s3)), 8) ^ rotl(T(byte2(s0)), 16) ^
                        rotl(T(byte3(s1)), 24) ^ k.z;
    const uint32_t n3 = T(byte0(s3)) ^ rotl(T(byte1(s0)), 8) ^ rotl(T(byte2(s1)), 16) ^
                        rotl(T(byte3(s2)), 24) ^ k.w;
    s0 = n0; s1 = n1; s2 = n2; s3 = n3;
  }
  // last round: SubBytes + ShiftRows; S[x] is byte 1 of T0[x]
  k = k4[10];
  const uint32_t c[4] = {s0, s1, s2, s3};
  const uint32_t kw[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    const uint32_t lo = __byte_perm(T(byte0(c[col])), T(byte1(c[(col + 1) & 3])), 0x0051u);
    const uint32_t hi = __byte_perm(T(byte2(c[(col + 2) & 3])), T(byte3(c[(col + 3) & 3])),
                                    0x5100u);
    out[col] = __byte_perm(lo, hi, 0x7610u) ^ kw[col];
  }
}

}  // namespace pir_tail
