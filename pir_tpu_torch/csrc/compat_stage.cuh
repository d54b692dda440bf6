// Per-thread pieces of the compat kernels (compat_stage.cu): for the
// stage kernel, the per-query constants a block rebuilds into shared
// memory, the walk of one node's whole subtree below it, and the
// Go-varint selection bit; for the head kernel, its constants, the walk
// from a query's root seed down its one-child prefix, and where a head
// leaf lands in the output planes. Kept apart from the kernels so that a
// host compiler can exercise the same functions (compat_stage_host.cpp).
// AES (the per-bank table of aes_lanes.cuh), the PRG, the DPF child step,
// the depth-first subtree walk and the warp transpose that brings a
// node's seed to its lane come from stacked_tail.cuh.

#pragma once

#include <cstdint>

#include "stacked_tail.cuh"

namespace pir_compat {

constexpr int kMaxTail = 3;  // levels per stage
constexpr int kMaxLeaves = 1 << kMaxTail;
constexpr int kKeyBytes = 11 * 16;
constexpr int kTreeKeys = 3;

// Operands of one launch, laid out as the TPU kernel's (uint32 words):
// seeds (Q,8,NC,16,W), t (Q,NC,1,W), cw_s (Q,tail,8,16,1),
// cw_tl / cw_tr (Q,tail), rk (Q,11,8,3,16,1), fcw (Q,) (emit_bits only).
struct CompatArgs {
  const uint32_t* seeds;
  const uint32_t* t;
  const uint32_t* cw_s;
  const uint32_t* cw_tl;
  const uint32_t* cw_tr;
  const uint32_t* rk;
  const uint32_t* fcw;
  int nc;
  int w;
  int tail;
};

// One query's constants: its three tree keys (44 words each, 16-byte
// aligned for the AES's round-key loads), each level's seed correction
// word as a block and its tL / tR bits, and the final-CW parity bit.
struct alignas(16) QueryConsts {
  uint32_t keys[kTreeKeys][44];
  uint32_t cw[kMaxTail][4];
  uint32_t tcw[kMaxTail][2];
  uint32_t fcw;
};

constexpr int kQueryItems = kTreeKeys * kKeyBytes + kMaxTail * 16 + kMaxTail * 2 + 1;

// Item idx of query q's constants, idx < kQueryItems: a round-key byte,
// a correction-word byte, a tL / tR bit or the fcw bit. Every mask
// operand is 0 / ~0; its bit 0 is read.
__device__ __forceinline__ void fill_query(QueryConsts& k, const CompatArgs& a, int q, int idx) {
  if (idx < kTreeKeys * kKeyBytes) {
    const int key = idx / kKeyBytes, rb = idx % kKeyBytes;
    reinterpret_cast<uint8_t*>(k.keys[key])[rb] = static_cast<uint8_t>(pir_tail::key_byte(
        a.rk + (size_t)q * 11 * 8 * 3 * 16, a.rk, 1, 0, 0, key, rb));
    return;
  }
  idx -= kTreeKeys * kKeyBytes;
  if (idx < kMaxTail * 16) {
    const int l = idx / 16, byte = idx % 16;
    if (l < a.tail) {
      uint32_t v = 0;
      for (int bit = 0; bit < 8; ++bit)
        v |= (a.cw_s[(((size_t)q * a.tail + l) * 8 + bit) * 16 + byte] & 1u) << bit;
      reinterpret_cast<uint8_t*>(k.cw[l])[byte] = static_cast<uint8_t>(v);
    }
    return;
  }
  idx -= kMaxTail * 16;
  if (idx < kMaxTail * 2) {
    const int l = idx / 2, side = idx % 2;
    if (l < a.tail) k.tcw[l][side] = (side ? a.cw_tr : a.cw_tl)[(size_t)q * a.tail + l] & 1u;
    return;
  }
  k.fcw = a.fcw ? a.fcw[q] & 1u : 0u;
}

// The 2^tail descendants, tail levels down, of a node whose seed and t
// bit the caller puts in s[0] and t[0]: seeds in s and t bits in t, leaf
// c at index c (the first level's branch is its most significant bit, as
// the stage's output chunk order wants). The subtree is expanded level by
// level in place, 2^tail - 1 node expansions of three AES blocks each.
// Neither loop is unrolled, so a kernel holds one copy of the PRG (three
// AES bodies) whatever the tail; s and t then live in local memory,
// whose ~60 bytes a node moves are nothing beside its ~1300 AES operations.
__device__ __forceinline__ void expand_subtree(const pir_tail::AesLanes& tb, const QueryConsts& k,
                                               int tail, uint32_t s[kMaxLeaves][4],
                                               uint32_t t[kMaxLeaves]) {
#pragma unroll 1
  for (int l = 0; l < tail; ++l) {
    // node n's children go to 2n and 2n + 1, so walking n downwards
    // never overwrites a node not yet expanded
#pragma unroll 1
    for (int n = (1 << l) - 1; n >= 0; --n) {
      uint32_t sl[4], tl, sr[4], tr;
      pir_tail::prg_children(tb, &k.keys[0][0], s[n], true, true, sl, &tl, sr, &tr);
      pir_tail::correct_child(sl, &tl, k.cw[l], t[n], k.tcw[l][0]);
      pir_tail::correct_child(sr, &tr, k.cw[l], t[n], k.tcw[l][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[2 * n][i] = sl[i];
        s[2 * n + 1][i] = sr[i];
      }
      t[2 * n] = tl;
      t[2 * n + 1] = tr;
    }
  }
}

// The PIR selection bit of a leaf: its value is the Go signed varint of
// seed bytes 0..7 plus t * final_cw, and the bit is (value % 2 == 0)
// (db.go:140-146). The varint's parity is byte 0's bit 0 ^ bit 1, unless
// all 8 bytes carry the continuation bit (value 0, parity 0).
__device__ __forceinline__ uint32_t select_bit(const uint32_t s[4], uint32_t t, uint32_t fcw) {
  const uint32_t parity = (s[0] ^ (s[0] >> 1)) & 1u;
  const uint32_t allcont = (s[0] & s[1] & 0x80808080u) == 0x80808080u;
  return ((parity & (allcont ^ 1u)) ^ (t & fcw)) ^ 1u;
}


// ---- the head walk (compat_head_kernel) ------------------------------------

constexpr int kMaxHeadLevels = 40;  // prefix + root-start levels a launch walks
constexpr int kHeadGroupBits = 3;   // at most 2^3 warps a block

// Operands of one head launch (uint32 words), as the payload unpack makes
// them: seeds (Q,8,16,1) with bit 0 = bit k of byte i of the root seed,
// t (Q,1), cw_s (Q,d,8,16,1), cw_tl / cw_tr (Q,d) and rk (Q,11,8,3,16,1)
// 0 / ~0 masks. The walk keeps one child on each of the first `prefix`
// levels (right where bit prefix-1-l of `path` is set), then expands
// `split` levels in full.
struct HeadArgs {
  const uint32_t* seeds;
  const uint32_t* t;
  const uint32_t* cw_s;
  const uint32_t* cw_tl;
  const uint32_t* cw_tr;
  const uint32_t* rk;
  int d;
  int prefix;
  int path;
  int split;
};

// One query's head constants: the three tree keys (QueryConsts, whose
// correction words stay unused) and every head level's seed correction
// word and tL / tR bits.
struct alignas(16) HeadConsts {
  QueryConsts q;
  uint32_t cw[kMaxHeadLevels][4];
  uint32_t tcw[kMaxHeadLevels][2];
};

constexpr int kHeadItems = kTreeKeys * kKeyBytes + kMaxHeadLevels * 16 + kMaxHeadLevels * 2;

// Item idx of query q's head constants, idx < kHeadItems: a round-key
// byte (fill_query's), a correction-word byte or a tL / tR bit of a level
// below prefix + split.
__device__ __forceinline__ void fill_head(HeadConsts& k, const HeadArgs& a, int q, int idx) {
  if (idx < kTreeKeys * kKeyBytes) {
    CompatArgs c{};
    c.rk = a.rk;
    fill_query(k.q, c, q, idx);
    return;
  }
  idx -= kTreeKeys * kKeyBytes;
  const int levels = a.prefix + a.split;
  if (idx < kMaxHeadLevels * 16) {
    const int l = idx / 16, byte = idx % 16;
    if (l < levels) {
      uint32_t v = 0;
      for (int bit = 0; bit < 8; ++bit)
        v |= (a.cw_s[(((size_t)q * a.d + l) * 8 + bit) * 16 + byte] & 1u) << bit;
      reinterpret_cast<uint8_t*>(k.cw[l])[byte] = static_cast<uint8_t>(v);
    }
    return;
  }
  idx -= kMaxHeadLevels * 16;
  const int l = idx / 2, side = idx % 2;
  if (l < levels) k.tcw[l][side] = (side ? a.cw_tr : a.cw_tl)[(size_t)q * a.d + l] & 1u;
}

// The wanted children of a node at head level l, corrected.
__device__ __forceinline__ void head_children(const pir_tail::AesLanes& tb, const HeadConsts& k,
                                              int l, const uint32_t s[4], uint32_t t,
                                              bool want_left, bool want_right, uint32_t sl[4],
                                              uint32_t* tl, uint32_t sr[4], uint32_t* tr) {
  pir_tail::prg_children(tb, &k.q.keys[0][0], s, want_left, want_right, sl, tl, sr, tr);
  if (want_left) pir_tail::correct_child(sl, tl, k.cw[l], t, k.tcw[l][0]);
  if (want_right) pir_tail::correct_child(sr, tr, k.cw[l], t, k.tcw[l][1]);
}

// Query q's root seed and t bit from the operands, walked down the
// prefix levels, one child (and two AES blocks) a level: the node whose
// subtree the root-start levels expand.
__device__ __forceinline__ void head_root(const pir_tail::AesLanes& tb, const HeadConsts& k,
                                          const HeadArgs& a, int q, uint32_t s[4], uint32_t* t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = 0;
  for (int r = 0; r < 128; ++r) {
    const int bit = r / 16, byte = r % 16;
    s[byte >> 2] |= (a.seeds[(size_t)q * 128 + r] & 1u) << (8 * (byte & 3) + bit);
  }
  *t = a.t[q] & 1u;
#pragma unroll 1
  for (int l = 0; l < a.prefix; ++l) {
    const bool right = (a.path >> (a.prefix - 1 - l)) & 1;
    uint32_t sl[4] = {}, tl = 0, sr[4] = {}, tr = 0;
    head_children(tb, k, l, s, *t, !right, right, sl, &tl, sr, &tr);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = right ? sr[i] : sl[i];
    *t = right ? tr : tl;
  }
}

// Warp groups of a head block: 2^g warps, g = min(split - 5, kHeadGroupBits).
__host__ __device__ __forceinline__ int head_group_bits(int split) {
  return split - 5 < kHeadGroupBits ? split - 5 : kHeadGroupBits;
}

// The first of the 2^g output lane words that leaf c (branches MSB
// first) of the r-level subtrees below a block's 2^g warps lands in;
// warp v's leaf goes to this word + v. The root-start order puts the
// first 5 levels' branches in the word's bits (the lane), later levels
// in the lane word, the earliest of them least significant: the warp
// supplies the low g bits, c reversed the rest.
__device__ __forceinline__ int head_words(int g, int r, int c) {
  int rev = 0;
  for (int j = 0; j < r; ++j) rev |= ((c >> (r - 1 - j)) & 1) << j;
  return rev << g;
}

}  // namespace pir_compat
