// A copy of pir_tpu/native/bigmod.cpp, unchanged below this header, which the
// port builds from its own tree (pir_tpu_torch/_build.py, g++ into
// pir_tpu_torch/_build/) and loads through pir_tpu_torch/native/__init__.py.
//
// Montgomery modular exponentiation on 64-bit limbs.
//
// Stands in for the reference's GMP dependency (ncw/gmp, imported at
// db.go:8 etc.): every Paillier ciphertext operation bottoms out in
// modexp. CIOS Montgomery multiplication with __uint128_t products and a
// fixed 4-bit window; odd moduli only (Paillier moduli N^k are odd).
//
// Batch entry points thread independent modexps across cores and reuse
// the per-modulus Montgomery constants (and, when the base is shared,
// the 4-bit window table) across the whole batch. paillier_scan is the
// native analogue of the reference's nprocs-partitioned AHE scan with a
// partial-product merge (db.go:193-261).
//
// Build: g++ -O3 -shared -fPIC -pthread bigmod.cpp -o libbigmod.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;

extern "C" {

// n0inv = -mod[0]^-1 mod 2^64
static uint64_t inv64(uint64_t a) {
  uint64_t x = 1;
  for (int i = 0; i < 6; i++) x *= 2 - a * x;  // Newton, a odd
  return (uint64_t)(0 - x);
}

// CIOS Montgomery multiply: out = a*b*R^-1 mod m (R = 2^(64n))
static void mont_mul(const uint64_t* a, const uint64_t* b, const uint64_t* m,
                     uint64_t n0inv, size_t n, uint64_t* out, uint64_t* t) {
  memset(t, 0, (n + 2) * 8);
  for (size_t i = 0; i < n; i++) {
    // t += a[i] * b
    uint64_t carry = 0;
    for (size_t j = 0; j < n; j++) {
      u128 cur = (u128)a[i] * b[j] + t[j] + carry;
      t[j] = (uint64_t)cur;
      carry = (uint64_t)(cur >> 64);
    }
    u128 cur = (u128)t[n] + carry;
    t[n] = (uint64_t)cur;
    t[n + 1] = (uint64_t)(cur >> 64);
    // reduce
    uint64_t mfac = t[0] * n0inv;
    carry = 0;
    {
      u128 c0 = (u128)mfac * m[0] + t[0];
      carry = (uint64_t)(c0 >> 64);
    }
    for (size_t j = 1; j < n; j++) {
      u128 c = (u128)mfac * m[j] + t[j] + carry;
      t[j - 1] = (uint64_t)c;
      carry = (uint64_t)(c >> 64);
    }
    u128 c = (u128)t[n] + carry;
    t[n - 1] = (uint64_t)c;
    t[n] = t[n + 1] + (uint64_t)(c >> 64);
    t[n + 1] = 0;
  }
  // conditional subtract
  uint64_t borrow = 0;
  std::vector<uint64_t> sub(n);
  for (size_t j = 0; j < n; j++) {
    u128 d = (u128)t[j] - m[j] - borrow;
    sub[j] = (uint64_t)d;
    borrow = (uint64_t)((d >> 64) & 1);
  }
  bool take_sub = t[n] != 0 || !borrow;
  for (size_t j = 0; j < n; j++) out[j] = take_sub ? sub[j] : t[j];
}

// Per-modulus Montgomery constants, computed once and shared.
struct MontCtx {
  const uint64_t* m;
  size_t n;
  uint64_t n0inv;
  std::vector<uint64_t> r;   // R mod m (Montgomery form of 1)
  std::vector<uint64_t> r2;  // R^2 mod m
};

static void mont_init(const uint64_t* m, size_t n, MontCtx* c) {
  c->m = m;
  c->n = n;
  c->n0inv = inv64(m[0]);
  std::vector<uint64_t> cur(n, 0);
  cur[0] = 1;
  auto dbl = [&](std::vector<uint64_t>& x) {
    uint64_t carry = 0;
    for (size_t j = 0; j < n; j++) {
      uint64_t nx = (x[j] << 1) | carry;
      carry = x[j] >> 63;
      x[j] = nx;
    }
    // subtract m if >= m (or if overflowed)
    uint64_t borrow = 0;
    std::vector<uint64_t> sub(n);
    for (size_t j = 0; j < n; j++) {
      u128 d = (u128)x[j] - m[j] - borrow;
      sub[j] = (uint64_t)d;
      borrow = (uint64_t)((d >> 64) & 1);
    }
    if (carry || !borrow) x = sub;
  };
  for (size_t i = 0; i < 64 * n; i++) dbl(cur);
  c->r = cur;  // R mod m
  for (size_t i = 0; i < 64 * n; i++) dbl(cur);
  c->r2 = cur;  // R^2 mod m
}

// 4-bit window table of base powers in Montgomery form (16*n limbs).
static void mont_table(const uint64_t* base, const MontCtx& c,
                       uint64_t* table, uint64_t* t) {
  size_t n = c.n;
  std::vector<uint64_t> bm(n);
  mont_mul(base, c.r2.data(), c.m, c.n0inv, n, bm.data(), t);
  memcpy(table, c.r.data(), n * 8);  // base^0 = 1 (Mont form = R)
  memcpy(table + n, bm.data(), n * 8);
  for (int k = 2; k < 16; k++)
    mont_mul(table + (k - 1) * n, bm.data(), c.m, c.n0inv, n, table + k * n, t);
}

// acc(Mont) = table_base^exp; exp little-endian, exp_n limbs.
static void pow_with_table(const uint64_t* table, const uint64_t* exp,
                           size_t exp_n, const MontCtx& c, uint64_t* acc,
                           uint64_t* t) {
  size_t n = c.n;
  long top = (long)exp_n * 16 - 1;  // nibble index
  while (top >= 0) {
    uint64_t nib = (exp[top / 16] >> ((top % 16) * 4)) & 0xF;
    if (nib) break;
    top--;
  }
  if (top < 0) {  // exp == 0
    memcpy(acc, c.r.data(), n * 8);
    return;
  }
  uint64_t nib = (exp[top / 16] >> ((top % 16) * 4)) & 0xF;
  memcpy(acc, table + nib * n, n * 8);
  std::vector<uint64_t> tmp(n);
  for (long i = top - 1; i >= 0; i--) {
    for (int s = 0; s < 4; s++) {
      mont_mul(acc, acc, c.m, c.n0inv, n, tmp.data(), t);
      memcpy(acc, tmp.data(), n * 8);
    }
    nib = (exp[i / 16] >> ((i % 16) * 4)) & 0xF;
    if (nib) {
      mont_mul(acc, table + nib * n, c.m, c.n0inv, n, tmp.data(), t);
      memcpy(acc, tmp.data(), n * 8);
    }
  }
}

static void from_mont(const uint64_t* a, const MontCtx& c, uint64_t* out,
                      uint64_t* t) {
  std::vector<uint64_t> one(c.n, 0);
  one[0] = 1;
  mont_mul(a, one.data(), c.m, c.n0inv, c.n, out, t);
}

static int resolve_threads(int nthreads, size_t work) {
  int hw = (int)std::thread::hardware_concurrency();
  if (hw < 1) hw = 1;
  int k = nthreads > 0 ? nthreads : hw;
  if ((size_t)k > work) k = (int)(work ? work : 1);
  return k;
}

// out = base^exp mod m. All little-endian u64 limb arrays; m odd, n limbs;
// base < m; exp has exp_n limbs.
void mg_powmod(const uint64_t* base, const uint64_t* exp, size_t exp_n,
               const uint64_t* m, size_t n, uint64_t* out) {
  MontCtx c;
  mont_init(m, n, &c);
  std::vector<uint64_t> t(n + 2), table(16 * n), acc(n);
  mont_table(base, c, table.data(), t.data());
  pow_with_table(table.data(), exp, exp_n, c, acc.data(), t.data());
  from_mont(acc.data(), c, out, t.data());
}

// Batched modexp over one modulus: out[i] = bases[i]^exps[i] mod m.
// bases: count*n limbs (or n limbs if common_base, sharing one window
// table across the batch); exps: count*exp_n limbs. Threads split the
// batch; nthreads <= 0 uses all cores.
void mg_powmod_batch(const uint64_t* bases, const uint64_t* exps,
                     size_t exp_n, const uint64_t* m, size_t n, size_t count,
                     int common_base, int nthreads, uint64_t* out) {
  MontCtx c;
  mont_init(m, n, &c);
  std::vector<uint64_t> shared_table;
  if (common_base) {
    shared_table.resize(16 * n);
    std::vector<uint64_t> t(n + 2);
    mont_table(bases, c, shared_table.data(), t.data());
  }
  int k = resolve_threads(nthreads, count);
  auto run = [&](size_t lo, size_t hi) {
    std::vector<uint64_t> t(n + 2), table, acc(n);
    if (!common_base) table.resize(16 * n);
    for (size_t i = lo; i < hi; i++) {
      const uint64_t* tab;
      if (common_base) {
        tab = shared_table.data();
      } else {
        mont_table(bases + i * n, c, table.data(), t.data());
        tab = table.data();
      }
      pow_with_table(tab, exps + i * exp_n, exp_n, c, acc.data(), t.data());
      from_mont(acc.data(), c, out + i * n, t.data());
    }
  };
  if (k <= 1) {
    run(0, count);
    return;
  }
  std::vector<std::thread> threads;
  size_t per = (count + k - 1) / k;
  for (int i = 0; i < k; i++) {
    size_t lo = i * per, hi = lo + per < count ? lo + per : count;
    if (lo >= hi) break;
    threads.emplace_back(run, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// The AHE scan hot loop (db.go:193-261): out[j] = prod_row ebits[row]^
// vals[row*width_cts + j] mod m, for j in [0, width_cts). Rows are
// partitioned across threads, each accumulating Montgomery-form partial
// products, merged at the end (the reference's nprocs partial merge).
// The per-row window table is built once and reused across all
// width_cts exponentiations of that row — an O(width) saving no
// per-ciphertext API can get.
void paillier_scan(const uint64_t* ebits, size_t height, const uint64_t* vals,
                   size_t exp_n, size_t width_cts, const uint64_t* m,
                   size_t n, int nthreads, uint64_t* out) {
  MontCtx c;
  mont_init(m, n, &c);
  int k = resolve_threads(nthreads, height);
  std::vector<std::vector<uint64_t>> partials(
      k, std::vector<uint64_t>(width_cts * n));
  auto run = [&](int ti, size_t lo, size_t hi) {
    std::vector<uint64_t>& acc = partials[ti];
    for (size_t j = 0; j < width_cts; j++)
      memcpy(acc.data() + j * n, c.r.data(), n * 8);  // Mont(1)
    std::vector<uint64_t> t(n + 2), table(16 * n), sel(n), tmp(n);
    for (size_t row = lo; row < hi; row++) {
      mont_table(ebits + row * n, c, table.data(), t.data());
      const uint64_t* vrow = vals + row * width_cts * exp_n;
      for (size_t j = 0; j < width_cts; j++) {
        pow_with_table(table.data(), vrow + j * exp_n, exp_n, c, sel.data(),
                       t.data());
        mont_mul(acc.data() + j * n, sel.data(), c.m, c.n0inv, n, tmp.data(),
                 t.data());
        memcpy(acc.data() + j * n, tmp.data(), n * 8);
      }
    }
  };
  if (k <= 1) {
    run(0, 0, height);
  } else {
    std::vector<std::thread> threads;
    size_t per = (height + k - 1) / k;
    for (int i = 0; i < k; i++) {
      size_t lo = i * per, hi = lo + per < height ? lo + per : height;
      if (lo >= hi) break;
      threads.emplace_back(run, i, lo, hi);
    }
    for (auto& th : threads) th.join();
    // partial merge into partials[0] (db.go:256-261); only spawned
    // threads initialized their accumulators
    std::vector<uint64_t> t(n + 2), tmp(n);
    for (int i = 1; i < (int)threads.size(); i++) {
      for (size_t j = 0; j < width_cts; j++) {
        mont_mul(partials[0].data() + j * n, partials[i].data() + j * n, c.m,
                 c.n0inv, n, tmp.data(), t.data());
        memcpy(partials[0].data() + j * n, tmp.data(), n * 8);
      }
    }
  }
  std::vector<uint64_t> t(n + 2);
  for (size_t j = 0; j < width_cts; j++)
    from_mont(partials[0].data() + j * n, c, out + j * n, t.data());
}

}  // extern "C"
