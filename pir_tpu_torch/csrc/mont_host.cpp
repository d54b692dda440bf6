// Host build of the per-thread Montgomery arithmetic of mont.cuh, for
// checking it without a GPU: kernel 9's powmod and kernel 10's chunked
// Straus scan and merge run here once per thread of the kernels' grids,
// each thread's words interleaved [word][thread] with the others' as the
// kernels keep them in global scratch. tests/test_torch_mont_host.py
// compiles this file with a host C++ compiler and holds it against
// CPython pow.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libmont_host.so mont_host.cpp

#include <cstddef>
#include <vector>

#include "host_shim.h"
#include "mont.cuh"

using namespace pir_mont;

// Same operands and output as pir_mont_powmod in mont_exp.cu. Returns 0,
// or 1 for an operand shape the kernel refuses.
extern "C" int pir_mont_powmod_host(const uint32_t* base, const uint32_t* e, uint32_t* out,
                                    const uint32_t* n, const uint32_t* n0inv,
                                    const uint32_t* r2, int b, int L, int ew, int e_max,
                                    int wbits, int per_row) {
  if (b < 1 || L < 1 || e_max < 1 || (wbits != 1 && wbits != 4) || (e_max + 31) / 32 > ew) {
    return 1;
  }
  const long long nth = b;
  std::vector<uint32_t> state((std::size_t)(2 * (L + 1)) * nth);
  std::vector<uint32_t> tables((std::size_t)(L << wbits) * nth);
  for (long long row = 0; row < b; ++row) {
    Words acc{state.data() + row, nth}, t{state.data() + row + (L + 1) * nth, nth};
    const CWords nv = per_row ? CWords{n + row, b} : CWords{n, 1};
    powmod(CWords{base + row * L, 1}, e + row * ew, 1, e_max, nv, n0inv[per_row ? row : 0],
           CWords{r2 + (per_row ? row * L : 0), 1}, L, wbits, Words{tables.data() + row, nth},
           acc, t, Words{out + row * L, 1});
  }
  return 0;
}

// Kernel 10 (pir_mont_scan with rc rows a chunk, then pir_mont_merge):
// out (w, L) words = prod_r bases[r]^e[r][col] mod n. Returns 0, or 1 for
// an operand shape the kernel refuses.
extern "C" int pir_mont_scan_host(const uint32_t* bases, const uint32_t* e, uint32_t* out,
                                  const uint32_t* n, uint32_t n0inv, const uint32_t* r2, int h,
                                  int w, int L, int ew, int e_max, int wbits, int rc) {
  if (h < 1 || w < 1 || rc < 1 || L < 1 || e_max < 1 || (wbits != 1 && wbits != 4) ||
      (e_max + 31) / 32 > ew) {
    return 1;
  }
  const int chunks = (h + rc - 1) / rc;
  const long long row_words = (long long)L << wbits;
  const long long nth = (long long)chunks * w;
  const CWords nv{n, 1};
  std::vector<uint32_t> partials((std::size_t)chunks * L * w);
  std::vector<uint32_t> tables((std::size_t)rc * row_words);
  std::vector<uint32_t> state((std::size_t)(2 * (L + 1)) * nth);
  for (int c = 0; c < chunks; ++c) {
    const int r0 = c * rc, rows = rc < h - r0 ? rc : h - r0;
    for (int r = 0; r < rows; ++r) {
      const long long tid = (long long)c * w + r % w;
      Words t{state.data() + tid + (L + 1) * nth, nth};
      build_table(CWords{bases + (long long)(r0 + r) * L, 1}, CWords{r2, 1}, nv, n0inv, L, wbits,
                  Words{tables.data() + r * row_words, 1}, t);
    }
    for (long long col = 0; col < w; ++col) {
      const long long tid = (long long)c * w + col;
      Words acc{state.data() + tid, nth}, t{state.data() + tid + (L + 1) * nth, nth};
      straus_rows(tables.data(), 1, rows, e + ((long long)r0 * w + col) * ew, (long long)w * ew,
                  1, e_max, wbits, nv, n0inv, L, acc, t);
      copy_words(acc, Words{partials.data() + (long long)c * L * w + col, w}, L);
    }
  }
  for (long long col = 0; col < w; ++col) {
    Words acc{state.data() + col, nth}, t{state.data() + col + (L + 1) * nth, nth};
    copy_words(CWords{partials.data() + col, w}, acc, L);
    for (int c = 1; c < chunks; ++c) {
      mont_mul(CWords{partials.data() + (long long)c * L * w + col, w}, acc, nv, n0inv, L, t);
      swap_words(acc, t);
    }
    mont_mul(Unit{}, acc, nv, n0inv, L, t);
    copy_words(t, Words{out + col * L, 1}, L);
  }
  return 0;
}
