"""Batched Montgomery modexps and the cPIR scan on the card (counterpart of
``pir_tpu/crypto/mont_tpu.py``).

The single-server cPIR hot loop is a batched multi-exponentiation: per
column, answer = prod_row Enc(bit_row)^chunk(row, col) mod N^k (db.go:
176-271). pir_tpu runs it, and the batched modexps of query generation,
decryption and the DDLEQ proofs, as jitted jnp in radix-2^15 limbs. Here
they run in two hand-written CUDA kernels (``csrc/mont_exp.cu``, on the
group product of ``csrc/mont.cuh``: a number's 32-bit words spread over
G lanes of a warp, K a lane, in registers):

* kernel 9, ``mont_powmod``: out[i] = base[i]^e[i] mod m[i], one modulus
  or one a row, one group a modexp;
* kernel 10, ``mont_scan``: out[w] = prod_r base[r]^e[r, w] mod m, one
  group a (column, row chunk), then a merge.

``powmod_plan`` and ``scan_plan`` choose G, the window and (kernel 10)
the chunking from a cost model of the group product on an H100;
``least_powmod_products`` and ``least_scan_products`` count the fewest
products the functions need, for their bounds.

Each wrapper takes tensors of 32-bit words (int32, little-endian, values
below their modulus) and the moduli as Python ints; it launches its
kernel for CUDA tensors and runs its plain version for CPU tensors. The
plain versions are pir_tpu's algorithm in torch: radix-2^15 limbs in
int64 tensors (every CIOS intermediate fits; CPU ``uint32`` lacks the
operators), the lazy-carry ``mont_mul``, both ladders, the tree product
and the scan chunk, limb for limb as ``mont_tpu``'s. Both give the same
integers as CPython ``pow``.

``device_paillier_scan``, ``device_powmod_batch`` and
``device_powmod_batch_multi`` take the arguments of pir_tpu's
``tpu_paillier_scan``, ``tpu_powmod_batch`` and ``tpu_powmod_batch_multi``
and ``device=``: None is the card (and raises with no CUDA), ``"cpu"``
runs the plain versions. The port compiles nothing per shape, so the
scan keeps its exponent bound as given (pir_tpu rounds it to a power of
two to bound its jit shapes) and takes any row and column count.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build

RADIX = 15
MASK = (1 << RADIX) - 1
ROW_CHUNK = 2048  # rows of a plain scan's chunk (pir_tpu's default)


# --------------------------------------------------------------------------
# host packing (pir_tpu's radix-2^15 limbs, exponent words, 32-bit words)
# --------------------------------------------------------------------------

def limbs_for_modulus(m: int) -> int:
    """pir_tpu's limb count: R = 2^(15 L) >= 4 m, rounded up to 16 limbs."""
    exact = (m.bit_length() + 2 + RADIX - 1) // RADIX
    return -(-exact // 16) * 16


def ints_to_limbs(xs, L: int) -> np.ndarray:
    """(len(xs), L) uint32 little-endian radix-2^15 limbs."""
    out = np.zeros((len(xs), L), dtype=np.uint32)
    for i, x in enumerate(xs):
        j = 0
        while x:
            out[i, j] = x & MASK
            x >>= RADIX
            j += 1
    return out


def limbs_to_int(arr) -> int:
    """Value of one (possibly redundant) limb vector."""
    x = 0
    for j in range(len(arr) - 1, -1, -1):
        x = (x << RADIX) + int(arr[j])
    return x


def pack_exponents(xs, e_max: int) -> np.ndarray:
    """(len(xs), ceil(e_max/32)) uint32 little-endian exponent words.

    Exponents wider than e_max fail loudly (IndexError / OverflowError /
    ValueError) rather than truncating silently."""
    ew = max(1, (e_max + 31) // 32)
    if e_max <= 64:
        arr = np.asarray(xs, dtype=np.uint64)  # raises on >= 2^64
        if len(xs) and e_max < 64 and int(arr.max()) >> e_max:
            # the ladder scans only e_max bits: a wider exponent inside the
            # last word would be truncated silently
            raise ValueError("exponent exceeds e_max bits")
        out = np.zeros((len(xs), ew), dtype=np.uint32)
        out[:, 0] = (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        if ew > 1:
            out[:, 1] = (arr >> np.uint64(32)).astype(np.uint32)
        return out
    out = np.zeros((len(xs), ew), dtype=np.uint32)
    for i, x in enumerate(xs):
        j = 0
        while x:
            out[i, j] = x & 0xFFFFFFFF
            x >>= 32
            j += 1
    return out


def words_for_modulus(m: int) -> int:
    """The kernels' word count: L = ceil(bits(m) / 32), R = 2^(32 L) > m."""
    return max(1, (m.bit_length() + 31) // 32)


def ints_to_words(xs, L: int) -> np.ndarray:
    """(len(xs), L) uint32 little-endian 32-bit words; raises OverflowError
    for a value of more than L words."""
    raw = b"".join(int(x).to_bytes(4 * L, "little") for x in xs)
    return np.frombuffer(raw, dtype="<u4").reshape(len(xs), L).astype(np.uint32)


def words_to_ints(arr: np.ndarray) -> list[int]:
    """Values of (n, L) 32-bit words (any integer dtype of 4 bytes)."""
    raw = np.ascontiguousarray(arr).astype("<u4", copy=False)
    return [int.from_bytes(row.tobytes(), "little") for row in raw]


@dataclass(frozen=True)
class MontCtx:
    """Precomputed per-modulus constants of the radix-2^15 plain version."""

    m: int
    L: int
    n_limbs: np.ndarray   # (L,) canonical limbs of m
    n_inv: int            # -m^{-1} mod 2^15
    r2_limbs: np.ndarray  # R^2 mod m
    one_limbs: np.ndarray  # R mod m (Montgomery form of 1)


@functools.lru_cache(maxsize=64)
def mont_ctx(m: int, L: int | None = None) -> MontCtx:
    """pir_tpu's constants of m, at its limb count or at L limbs (per-row
    moduli of one batch share the largest)."""
    if m % 2 == 0 or m <= 1:
        raise ValueError("Montgomery arithmetic needs an odd modulus > 1")
    L = limbs_for_modulus(m) if L is None else L
    if (1 << (RADIX * L)) < 4 * m:
        raise ValueError(f"{L} limbs are too few for a {m.bit_length()}-bit modulus")
    r = 1 << (RADIX * L)
    return MontCtx(
        m=m,
        L=L,
        n_limbs=ints_to_limbs([m], L)[0],
        n_inv=(-pow(m, -1, 1 << RADIX)) & MASK,
        r2_limbs=ints_to_limbs([r * r % m], L)[0],
        one_limbs=ints_to_limbs([r % m], L)[0],
    )


@dataclass(frozen=True)
class WordCtx:
    """Per-modulus constants of the kernels: L words, -m^-1 mod 2^32, and
    R^2 mod m and R mod m for R = 2^(32 L)."""

    m: int
    L: int
    n_words: np.ndarray   # (L,) uint32
    n0inv: int
    r2_words: np.ndarray  # (L,) uint32
    one_words: np.ndarray  # (L,) uint32, the Montgomery domain's 1


@functools.lru_cache(maxsize=64)
def word_ctx(m: int, L: int | None = None) -> WordCtx:
    if m % 2 == 0 or m <= 1:
        raise ValueError("Montgomery arithmetic needs an odd modulus > 1")
    L = words_for_modulus(m) if L is None else L
    r = 1 << (32 * L)
    if r <= m:
        raise ValueError(f"{L} words are too few for a {m.bit_length()}-bit modulus")
    return WordCtx(m, L, ints_to_words([m], L)[0], (-pow(m, -1, 1 << 32)) & 0xFFFFFFFF,
                   ints_to_words([r * r % m], L)[0], ints_to_words([r % m], L)[0])


# --------------------------------------------------------------------------
# the plain version: pir_tpu's radix-2^15 arithmetic in int64 torch tensors
# --------------------------------------------------------------------------

def _canon(t):
    """Two local-carry passes: limbs <= 2^17 -> limbs <= 2^15."""
    for _ in range(2):
        hi = t >> RADIX
        lo = t & MASK
        t = lo + torch.cat([torch.zeros_like(hi[..., :1]), hi[..., :-1]], dim=-1)
    return t


def mont_mul(a, b, n, n_inv):
    """Montgomery product a*b/R mod m (value < 2m for inputs < 2m).

    a, b: int64 (..., L) canonical limbs (<= 2^15), broadcastable; n: (L,)
    or per-row (B, L) modulus limbs; n_inv: an int or a (B, 1) tensor.
    Returns canonical (..., L) limbs, equal to mont_tpu.mont_mul's."""
    L = n.shape[-1]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    t = torch.zeros(shape, dtype=torch.int64, device=n.device)
    for i in range(L):
        ai = a[..., i:i + 1]
        u0 = t[..., :1] + ai * b[..., :1]
        mi = ((u0 & MASK) * n_inv) & MASK
        u = t + ai * b + mi * n
        t = (u >> RADIX) + torch.cat([(u & MASK)[..., 1:], torch.zeros_like(u[..., :1])],
                                     dim=-1)
    return _canon(t)


def mont_exp(base, e, e_max: int, n, n_inv, one_mont):
    """Batched base^e in the Montgomery domain (mont_tpu.mont_exp): the
    4-bit fixed-window ladder for e_max >= 64 while the table stays under
    256 MiB, else square and multiply. e: (..., EW) int64 exponent words."""
    out_shape = torch.broadcast_shapes(base.shape, e.shape[:-1] + (n.shape[-1],))
    table_bytes = 16 * 4 * int(np.prod(out_shape, dtype=np.int64))
    if e_max >= 64 and table_bytes <= 256 * 1024 * 1024:
        return _mont_exp_win4(base, e, e_max, n, n_inv, one_mont, out_shape)
    return _mont_exp_bin(base, e, e_max, n, n_inv, one_mont, out_shape)


def _mont_exp_bin(base, e, e_max: int, n, n_inv, one_mont, out_shape):
    """MSB-first square-and-always-multiply, the bit selecting lanes."""
    acc = one_mont.expand(out_shape)
    for k in range(e_max):
        kk = e_max - 1 - k
        acc = mont_mul(acc, acc, n, n_inv)
        bit = (e[..., kk // 32:kk // 32 + 1] >> (kk % 32)) & 1
        acc = torch.where(bit.bool(), mont_mul(acc, base, n, n_inv), acc)
    return acc


def _mont_exp_win4(base, e, e_max: int, n, n_inv, one_mont, out_shape):
    """MSB-first 4-bit fixed-window ladder; the window digit picks from the
    16-entry table by a one-hot sum."""
    g = one_mont.expand(out_shape)
    table = [g]
    for _ in range(15):
        table.append(mont_mul(table[-1], base, n, n_inv))
    tbl = torch.stack(table, dim=-2)  # (..., 16, L)
    ks = torch.arange(16, dtype=torch.int64, device=tbl.device)
    nwin = (e_max + 3) // 4
    acc = g
    for w in range(nwin):
        bitpos = (nwin - 1 - w) * 4
        for _ in range(4):
            acc = mont_mul(acc, acc, n, n_inv)
        digit = (e[..., bitpos // 32] >> (bitpos % 32)) & 15
        onehot = (digit[..., None] == ks).to(torch.int64)
        acc = mont_mul(acc, (tbl * onehot[..., None]).sum(dim=-2), n, n_inv)
    return acc


def tree_product(x, n, n_inv):
    """Montgomery product over axis 0 (a power-of-two length)."""
    r = x.shape[0]
    if r & (r - 1):
        raise ValueError(f"tree reduction needs a power-of-two rows, got {r}")
    while r > 1:
        r //= 2
        x = mont_mul(x[:r], x[r:], n, n_inv)
    return x[0]


def _unit_limbs(L: int, device) -> torch.Tensor:
    """The integer 1 as L limbs: the operand that leaves the domain."""
    one = torch.zeros(L, dtype=torch.int64, device=device)
    one[0] = 1
    return one


def _scan_chunk_mont(bases, exps, n, n_inv, one_mont, r2, e_max: int):
    base_m = mont_mul(bases, r2, n, n_inv)[:, None, :]  # (RC, 1, L)
    return tree_product(mont_exp(base_m, exps, e_max, n, n_inv, one_mont), n, n_inv)


def scan_chunk(bases, exps, n, n_inv, one_mont, r2, e_max: int):
    """One row chunk of the cPIR scan (mont_tpu._scan_chunk): bases (RC, L)
    limbs < m, RC a power of two; exps (RC, W, EW) words. Returns (W, L)
    normal-domain limbs of prod_r bases[r]^exps[r, w] (value < 2m)."""
    prod = _scan_chunk_mont(bases, exps, n, n_inv, one_mont, r2, e_max)
    return mont_mul(prod, _unit_limbs(n.shape[-1], n.device), n, n_inv)


def powmod_core(bases, exps, n, n_inv, one_mont, r2, e_max: int):
    """mont_tpu._powmod_core: (B, L) limbs of bases^exps (value < 2m)."""
    pows = mont_exp(mont_mul(bases, r2, n, n_inv), exps, e_max, n, n_inv, one_mont)
    return mont_mul(pows, _unit_limbs(n.shape[-1], n.device), n, n_inv)


def _u32(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & 0xFFFFFFFF


def _bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """(..., K) int64 digits of `width` bits -> (..., K * width) bits, LSB first."""
    sh = torch.arange(width, dtype=torch.int64, device=x.device)
    return ((x[..., None] >> sh) & 1).flatten(-2)


def _regroup(bits: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """(..., K) bits -> (..., count) int64 digits of `width` bits; bits
    past count * width must be 0."""
    k = bits.shape[-1]
    if k < count * width:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (count * width - k,))], dim=-1)
    bits = bits[..., :count * width].reshape(bits.shape[:-1] + (count, width))
    sh = torch.arange(width, dtype=torch.int64, device=bits.device)
    return (bits << sh).sum(dim=-1)


def words_to_limbs(words: torch.Tensor, L: int) -> torch.Tensor:
    """(..., Lw) int32 words -> (..., L) int64 radix-2^15 limbs."""
    return _regroup(_bits(_u32(words), 32), RADIX, L)


def limbs_to_words(limbs: torch.Tensor, L: int) -> torch.Tensor:
    """(..., K) int64 limbs of a value below 2^(32 L) -> (..., L) int32 words."""
    norm = [None] * limbs.shape[-1]
    carry = torch.zeros_like(limbs[..., 0])
    for j in range(limbs.shape[-1]):
        v = limbs[..., j] + carry
        norm[j], carry = v & MASK, v >> RADIX
    w = _regroup(_bits(torch.stack(norm, dim=-1), RADIX), 32, L)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _reduce_once(x, n):
    """x (..., L) limbs of a value < 2m -> x mod m (limbs < 2^15): x - m
    where that does not borrow, else x."""
    norm, diff = [], []
    carry = borrow = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        v = x[..., j] + carry
        norm.append(v & MASK)
        carry = v >> RADIX
        d = norm[-1] - n[..., j] - borrow
        borrow = (d < 0).to(torch.int64)
        diff.append(d & MASK)
    keep = (borrow > carry)[..., None]
    return torch.where(keep, torch.stack(norm, dim=-1), torch.stack(diff, dim=-1))


def _plain_consts(mods: list[int], device):
    """Radix-2^15 constants of per-row moduli at one limb count: n, n_inv,
    one and r2 as (B, L) / (B, 1) tensors (shared rows for one modulus)."""
    L = max(limbs_for_modulus(m) for m in set(mods))
    ctxs = {m: mont_ctx(m, L) for m in set(mods)}

    def rows(field):
        return torch.from_numpy(np.stack([getattr(ctxs[m], field) for m in mods]).astype(
            np.int64)).to(device)

    n_inv = torch.tensor([[ctxs[m].n_inv] for m in mods], dtype=torch.int64, device=device)
    return L, rows("n_limbs"), n_inv, rows("one_limbs"), rows("r2_limbs")


def _check_words(name: str, x: torch.Tensor, dim: int) -> None:
    if x.dtype != torch.int32 or x.dim() != dim:
        raise ValueError(f"{name} must be a {dim}-D int32 tensor of 32-bit words")


def _mods_list(mods, b: int) -> list[int]:
    mods = [mods] * b if isinstance(mods, int) else [int(m) for m in mods]
    if len(mods) != b:
        raise ValueError(f"{len(mods)} moduli for {b} rows")
    return mods


def mont_powmod_plain(bases: torch.Tensor, exps: torch.Tensor, mods, e_max: int) -> torch.Tensor:
    """Plain version of kernel 9: (B, Lw) words of bases^exps mod m, fully
    reduced, through mont_tpu's radix-2^15 arithmetic on bases' device."""
    b, lw = bases.shape
    mods = _mods_list(mods, b)
    L, n, n_inv, one, r2 = _plain_consts(mods, bases.device)
    limbs = powmod_core(words_to_limbs(bases, L), _u32(exps), n, n_inv, one, r2, e_max)
    return limbs_to_words(_reduce_once(limbs, n), lw)


def mont_scan_plain(bases: torch.Tensor, exps: torch.Tensor, mod: int, e_max: int,
                    row_chunk: int = ROW_CHUNK) -> torch.Tensor:
    """Plain version of kernel 10: (W, Lw) words of prod_r bases[r]^exps[r, w]
    mod m, fully reduced: pir_tpu's scan chunks of row_chunk rows (each
    padded to a power of two with base 1, exponent 0), merged in the
    Montgomery domain."""
    h, lw = bases.shape
    w = exps.shape[1]
    L, n, n_inv, one, r2 = _plain_consts([mod], bases.device)
    n, one, r2, n_inv = n[0], one[0], r2[0], int(n_inv[0, 0])
    limbs, e = words_to_limbs(bases, L), _u32(exps)
    acc = None
    for lo in range(0, h, row_chunk):
        rows = min(row_chunk, h - lo)
        rc = 1 << (rows - 1).bit_length()
        cb = torch.cat([limbs[lo:lo + rows], _unit_limbs(L, n.device).expand(rc - rows, L)])
        ce = torch.cat([e[lo:lo + rows], e.new_zeros((rc - rows,) + e.shape[1:])])
        part = _scan_chunk_mont(cb, ce, n, n_inv, one, r2, e_max)
        acc = part if acc is None else mont_mul(acc, part, n, n_inv)
    if acc is None:
        acc = one.expand(w, L)
    out = mont_mul(acc, _unit_limbs(L, n.device), n, n_inv)
    return limbs_to_words(_reduce_once(out, n), lw)


# --------------------------------------------------------------------------
# kernel wrappers and their planners
# --------------------------------------------------------------------------

_POWMOD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_TABLES_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_uint] + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_SCAN_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_uint] + [ctypes.c_int] * 12
              + [ctypes.c_void_p])
_MERGE_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_uint] + [ctypes.c_int] * 7
               + [ctypes.c_void_p])
GROUP_LANES = (4, 8, 16, 32)  # lanes a number spans (G), aligned in a warp
LANE_WORDS = (1, 2, 3, 4, 6, 8, 12, 16, 24)  # words a lane holds (K): mont_exp.cu's instances
MAX_WINDOW = 8  # window bits the kernels take
BLOCK = 128  # kernel 10's columns a block at most, by default (col_chunk)
SCRATCH_BYTES = 256 << 20  # kernel 10's tables a launch, and its partials, at most

# The planners' cost model, in clock cycles of one warp scheduler (an SM
# has four), from the group product's SASS (chip_smoke.py phase 1: an
# integer instruction takes the FMA or ALU pipe two cycles a warp, an
# IMAD.WIDE four) and fitted to forced-plan timings on an H100
# (benchmarks_mont.py --sweep).
ROUND_ISSUE = (12, 14)  # pipe cycles a warp a round: 12 + 14 K
ROUND_LATENCY = (100, 10, 23)  # a round's dependent chain: 100 + 10 K, 100 + 23 K rolled (K > 8)
SHUFFLE_LATENCY = 24  # the shift's shuffle, on that chain when K = 1
FINISH = (80, 24, 400)  # carry and borrow resolution: 80 + 24 K pipe cycles, ~400 latency
READ_ISSUE = (4, 6)  # a masked table read: 4 + 6 K pipe cycles an entry
LAUNCH_CYCLES = 8000  # a launch's fixed cost, ~4 us


def _lib(fn: str, argtypes):
    f = getattr(_build.load("mont_exp"), fn)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    return f


@functools.lru_cache(maxsize=8)
def _smem_optin(index: int) -> int:
    out = ctypes.c_int()
    with torch.cuda.device(index):
        _build.check(_lib("pir_mont_smem_optin", [ctypes.c_void_p])(ctypes.byref(out)),
                     "mont smem query")
    return out.value


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def upload_words(a: np.ndarray, device) -> torch.Tensor:
    """uint32 words -> their int32 bit pattern on `device`. To a CUDA
    device through pinned memory, enqueued on the current stream without
    waiting for it, so a batch's uploads do not wait for the scans queued
    before them."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def lane_words(L: int, G: int) -> int | None:
    """K: the fewest words of LANE_WORDS a lane holds so that G lanes hold
    L words (None past 24 a lane)."""
    return next((k for k in LANE_WORDS if G * k >= L), None)


def scan_threads(K: int) -> int:
    """Threads a block of kernel 10's chunk pass holds at K words a lane
    (mont_exp.cu scan_threads: ~6 K + 32 registers a thread)."""
    return 1024 if K <= 4 else 512 if K <= 8 else 256 if K <= 16 else 128


def _product_cost(G: int, K: int) -> tuple[int, int]:
    """(issue cycles a warp, cycles of dependent latency) of one product."""
    rounds = G * K
    issue = rounds * (ROUND_ISSUE[0] + ROUND_ISSUE[1] * K) + FINISH[0] + FINISH[1] * K
    per_word = ROUND_LATENCY[1] if K <= 8 else ROUND_LATENCY[2]
    latency = rounds * (ROUND_LATENCY[0] + per_word * K + (SHUFFLE_LATENCY if K == 1 else 0))
    latency += FINISH[2]
    return issue, latency


def _read_cost(wbits: int, K: int) -> tuple[int, int]:
    issue = (READ_ISSUE[0] + READ_ISSUE[1] * K) << wbits
    return issue, issue + 40


def _resident_warps(threads: int, smem: int, smem_optin: int, K: int) -> int:
    """Warps an SM holds: blocks by threads and shared memory, then registers."""
    blocks = min(32, 2048 // threads, (smem_optin + 1024) // (smem + 1024))
    return max(1, min(blocks * threads // 32, 65536 // (32 * min(255, 6 * K + 32))))


def _stage_cycles(groups: int, G: int, issue: int, latency: int, warps_per_sm: int,
                  sms: int) -> int:
    """Cycles of a launch of `groups` groups, each a chain of `issue`
    cycles a warp over `latency` cycles of dependences: a scheduler
    takes its warps in waves of what it holds at once, and a wave lasts the
    longer of one chain's latency and its warps' issue."""
    warps = -(-groups * G // 32)
    per = -(-warps // (4 * sms))
    resident = max(1, warps_per_sm // 4)
    return -(-per // resident) * max(latency, min(per, resident) * issue)


def powmod_products(e_max: int, rows: int, wbits: int) -> int:
    """Montgomery products of `rows` modexps at a fixed window of wbits as
    the bound counts them: the table (2^wbits), the ladder (wbits + 1 a
    window) and leaving the domain."""
    return rows * ((1 << wbits) + -(-e_max // wbits) * (wbits + 1) + 1)


def least_powmod_products(e_max: int, rows: int = 1) -> int:
    """The fewest Montgomery products of `rows` modexps of e_max-bit
    exponents, each with its own base, over every fixed window."""
    return min(powmod_products(e_max, rows, wb) for wb in range(1, 17))


@functools.lru_cache(maxsize=256)
def powmod_plan(b: int, L: int, e_max: int, sms: int, smem_optin: int) -> dict:
    """Kernel 9's launch shape for b modexps of L words and e_max-bit
    exponents: G lanes of K words a modexp, the window, warps a block (the
    tables of a warp's groups in shared memory), the products it runs and
    the cycles the cost model reckons. Over every G and window that fits,
    the fewest cycles: a larger G shortens each chain (fewer rounds a lane
    does work in), a smaller G spends fewer shuffles and masked reads a
    product and leaves more warps for the schedulers."""
    best = None
    for G in GROUP_LANES:
        K = lane_words(L, G)
        if K is None:
            continue
        pi, pl = _product_cost(G, K)
        for wb in range(1, MAX_WINDOW + 1):
            warp_smem = 4 * K * 32 << wb
            if warp_smem > smem_optin:
                break
            warps = min(4, smem_optin // warp_smem)
            nwin = -(-e_max // wb)
            prods = (1 << wb) - 1 + (nwin - 1) * (wb + 1) + 1
            ri, rl = _read_cost(wb, K)
            issue = prods * pi + nwin * ri + (K << wb)
            cycles = LAUNCH_CYCLES + _stage_cycles(
                b, G, issue, prods * pl + nwin * rl,
                _resident_warps(32 * warps, warps * warp_smem, smem_optin, K), sms)
            key = (cycles, -(-b * G // 32) * issue)
            if best is None or key < best[0]:
                best = (key, {"G": G, "K": K, "wbits": wb, "warps": warps,
                              "smem": warps * warp_smem, "products": b * prods,
                              "cycles": cycles})
    if best is None:
        raise ValueError(f"no group of {GROUP_LANES[-1]} lanes holds {L} words")
    return best[1]


def _row_counts(lo: int, hi: int, h: int) -> list[int]:
    """Candidate rows a chunk in [lo, hi]: every count to 8, then one for
    each of a geometric run of chunk counts."""
    out = {lo, hi} | set(range(lo, min(hi, 8) + 1))
    c = 1
    while c <= h:
        rc = -(-h // c)
        if lo <= rc <= hi:
            out.add(rc)
        c = max(c + 1, c * 5 // 4)
    return sorted(out)


def _col_counts(G: int, K: int, w: int, col_chunk: int) -> list[int]:
    """Candidate columns (groups) a block: whole warps, doubling, up to the
    block's threads, col_chunk and the columns there are."""
    warp = 32 // G
    most = max(warp, min(scan_threads(K) // G, col_chunk // warp * warp, -(-w // warp) * warp))
    out, cols = {most}, warp
    while cols < most:
        out.add(cols)
        cols *= 2
    return sorted(out)


@functools.lru_cache(maxsize=256)
def scan_plan(h: int, w: int, L: int, e_max: int, sms: int, smem_optin: int,
              row_chunk: int = ROW_CHUNK, col_chunk: int = BLOCK) -> dict:
    """Kernel 10's launch shape for an (h, w) scan of L words and e_max-bit
    exponents, the fewest cycles of the cost model over G (and K), the
    window, rows a chunk (rc; at most row_chunk and what shared memory
    holds, at most 65535 chunks), Straus or Horner chunks and columns a
    block (at most col_chunk, a whole warp at least). It counts the table
    pass (2^wbits - 1 products a row), each chunk's chain (its products
    and its masked table reads; Straus repeats the squarings in every
    chunk, Horner leaves them to the merge at one partial a window), the
    merge, the copy of each block's tables and the lanes in flight.
    slab_chunks: the chunks a table pass covers (SCRATCH_BYTES of tables
    at most)."""
    best = None
    rc_min = -(-h // 65535)
    for G in GROUP_LANES:
        K = lane_words(L, G)
        if K is None:
            continue
        Lp = G * K
        pi, pl = _product_cost(G, K)
        small = _resident_warps(128, 0, smem_optin, K)
        for wb in range(1, MAX_WINDOW + 1):
            count, nwin = 1 << wb, -(-e_max // wb)
            row_bytes = 4 * Lp * count
            rc_max = min(h, row_chunk, smem_optin // row_bytes)
            if rc_max < rc_min:
                break
            ri, rl = _read_cost(wb, K)
            tables = _stage_cycles(h, G, (count - 1) * pi + count * K, (count - 1) * pl, small,
                                   sms)
            for rc in _row_counts(rc_min, rc_max, h):
                chunks = -(-h // rc)
                for horner in (0, 1):
                    P = nwin if horner else 1
                    if chunks * P * w * Lp * 4 > SCRATCH_BYTES:
                        continue
                    chain = nwin * (rc - 1) if horner else nwin * rc - 1 + (nwin - 1) * wb
                    m_chain = (P - 1) * wb + P * chunks
                    merge = _stage_cycles(w, G, m_chain * pi + P * chunks * K, m_chain * pl,
                                          small, sms)
                    for cols in _col_counts(G, K, w, col_chunk):
                        threads = cols * G
                        copy = 3 * rc * Lp * count // (4 * threads)
                        scan = _stage_cycles(
                            -(-w // cols) * cols * chunks, G,
                            chain * pi + nwin * rc * ri + copy,
                            chain * pl + nwin * rc * rl + copy + 800,
                            _resident_warps(threads, rc * row_bytes, smem_optin, K), sms)
                        plan = {"G": G, "K": K, "wbits": wb, "rc": rc, "chunks": chunks,
                                "horner": horner, "cols": cols, "threads": threads,
                                "smem": rc * row_bytes,
                                "slab_chunks": max(1, SCRATCH_BYTES // (rc * row_bytes)),
                                "cycles": tables + scan + merge + 3 * LAUNCH_CYCLES}
                        plan["products"] = scan_products(plan, h, w, e_max)
                        key = (plan["cycles"], plan["products"])
                        if best is None or key < best[0]:
                            best = (key, plan)
    if best is None:
        raise ValueError(f"no plan holds a {L}-word modulus's table in shared memory")
    return best[1]


def scan_products(plan: dict, h: int, w: int, e_max: int) -> int:
    """Montgomery products kernel 10 runs on a plan: the tables (2^wbits -
    1 a row), each (column, chunk)'s chain (a run's first multiplicand is
    a copy), the merge (squarings between windows, leaving the domain)."""
    wb, chunks = plan["wbits"], plan["chunks"]
    nwin = -(-e_max // wb)
    if plan["horner"]:
        scan, P = nwin * (h - chunks), nwin
    else:
        scan, P = nwin * h - chunks + chunks * (nwin - 1) * wb, 1
    return h * ((1 << wb) - 1) + w * scan + w * ((P - 1) * wb + P * chunks)


def least_scan_products(h: int, w: int, e_max: int) -> int:
    """The fewest Montgomery products of the scan's function over every
    fixed window: Straus's method in one chunk, each row's table built
    once and shared by all w columns, the squarings shared by the rows."""
    return min(h * (1 << wb) + w * -(-e_max // wb) * (wb + h) + w for wb in range(1, 17))


def _consts(mods: list[int], Lp: int, dev) -> tuple:
    """n, n0inv, R^2 and R mod m at Lp words: one row for one modulus, else
    a row for each of mods (gathered from the distinct moduli's rows)."""
    distinct = sorted(set(mods))
    ctxs = [word_ctx(m, Lp) for m in distinct]
    pos = {m: i for i, m in enumerate(distinct)}
    rows = (np.fromiter((pos[m] for m in mods), np.int64, len(mods)) if len(distinct) > 1
            else np.zeros(1, np.int64))

    def table(field):
        return upload_words(np.stack([getattr(c, field) for c in ctxs])[rows], dev)

    return (table("n_words"), upload_words(np.array([c.n0inv for c in ctxs])[rows], dev),
            table("r2_words"), table("one_words"))


def mont_powmod(bases: torch.Tensor, exps: torch.Tensor, mods, e_max: int,
                plan: dict | None = None) -> torch.Tensor:
    """(B, L) int32 words of bases < m, (B, EW) int32 exponent words (EW >=
    ceil(e_max / 32), e_max >= 1), one odd modulus or B of them (of at
    most L words) -> (B, L) int32 words of bases^exps mod m. On the card
    one launch on powmod_plan's shape (or `plan`, one of its dicts)."""
    _check_words("bases", bases, 2)
    _check_words("exps", exps, 2)
    b, L = bases.shape
    if exps.shape[0] != b or exps.shape[1] < max(1, (e_max + 31) // 32) or e_max < 1:
        raise ValueError(f"exponents {tuple(exps.shape)} do not cover {b} rows of {e_max} bits")
    if bases.device != exps.device:
        raise ValueError("bases and exponents are on different devices")
    mods = _mods_list(mods, b)
    if b == 0:
        return bases.clone()
    if max(mods).bit_length() > 32 * L:
        raise ValueError(f"a modulus is wider than {L} words")
    if bases.device.type == "cpu":
        return mont_powmod_plain(bases, exps, mods, e_max)
    if bases.device.type != "cuda":
        raise ValueError(f"no Montgomery engine for device {bases.device}")
    if not bases.is_contiguous() or not exps.is_contiguous():
        raise ValueError("the kernel reads bases and exponents as they lie: both contiguous")
    dev = bases.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        if plan is None:
            plan = powmod_plan(b, L, e_max, _sms(index), _smem_optin(index))
        G, K = plan["G"], plan["K"]
        per_row = len(set(mods)) > 1
        n, n0, r2, one = _consts(mods, G * K, dev)
        out = torch.empty_like(bases)
        err = _lib("pir_mont_powmod", _POWMOD_ARGS)(
            bases.data_ptr(), exps.data_ptr(), out.data_ptr(), n.data_ptr(), n0.data_ptr(),
            r2.data_ptr(), one.data_ptr(), b, L, exps.shape[1], e_max, plan["wbits"], G, K,
            int(per_row), plan["warps"], torch.cuda.current_stream().cuda_stream)
        _build.check(err, "mont_powmod")
        _build.count_launch(mont_powmod)
    return out


mont_powmod.launches = 0


def mont_scan(bases: torch.Tensor, exps: torch.Tensor, mod: int, e_max: int,
              row_chunk: int = ROW_CHUNK, col_chunk: int = BLOCK,
              plan: dict | None = None) -> torch.Tensor:
    """(H, L) int32 words of bases < mod, (H, W, EW) int32 exponent words
    -> (W, L) int32 words of prod_r bases[r]^exps[r, w] mod mod. On the card
    on scan_plan's shape (or `plan`, one of its dicts): the rows' tables,
    the chunks' products, then their merge."""
    _check_words("bases", bases, 2)
    _check_words("exps", exps, 3)
    h, L = bases.shape
    if h < 1 or exps.shape[0] != h or exps.shape[1] < 1 or e_max < 1:
        raise ValueError(f"exponents {tuple(exps.shape)} do not cover {h} rows")
    if exps.shape[2] < (e_max + 31) // 32:
        raise ValueError(f"{exps.shape[2]} exponent words hold fewer than {e_max} bits")
    if bases.device != exps.device:
        raise ValueError("bases and exponents are on different devices")
    if mod.bit_length() > 32 * L:
        raise ValueError(f"the modulus is wider than {L} words")
    if bases.device.type == "cpu":
        return mont_scan_plain(bases, exps, mod, e_max, row_chunk)
    if bases.device.type != "cuda":
        raise ValueError(f"no Montgomery engine for device {bases.device}")
    if not bases.is_contiguous() or not exps.is_contiguous():
        raise ValueError("the kernel reads bases and exponents as they lie: both contiguous")
    dev = bases.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    w, ew = exps.shape[1], exps.shape[2]
    with torch.cuda.device(dev):
        if plan is None:
            plan = scan_plan(h, w, L, e_max, _sms(index), _smem_optin(index), row_chunk,
                             col_chunk)
        G, K, wb, rc, chunks = plan["G"], plan["K"], plan["wbits"], plan["rc"], plan["chunks"]
        Lp = G * K
        n, _, r2, one = _consts([mod], Lp, dev)
        n0inv = word_ctx(mod, Lp).n0inv
        P = -(-e_max // wb) if plan["horner"] else 1
        partials = torch.empty(chunks * P * w * Lp, dtype=torch.int32, device=dev)
        slab = plan["slab_chunks"]
        tables = torch.empty(min(h, slab * rc) * (Lp << wb), dtype=torch.int32, device=dev)
        out = torch.empty((w, L), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, chunks, slab):
            nc = min(slab, chunks - c0)
            r0 = c0 * rc
            err = _lib("pir_mont_tables", _TABLES_ARGS)(
                bases.data_ptr() + 4 * r0 * L, tables.data_ptr(), n.data_ptr(), n0inv,
                r2.data_ptr(), one.data_ptr(), min(h, (c0 + nc) * rc) - r0, L, wb, G, K, stream)
            _build.check(err, "mont_scan tables")
            err = _lib("pir_mont_scan", _SCAN_ARGS)(
                tables.data_ptr(), exps.data_ptr(), partials.data_ptr(), n.data_ptr(), n0inv, h,
                w, ew, e_max, wb, G, K, rc, plan["horner"], plan["cols"], c0, nc, stream)
            _build.check(err, "mont_scan")
        err = _lib("pir_mont_merge", _MERGE_ARGS)(
            partials.data_ptr(), out.data_ptr(), n.data_ptr(), n0inv, chunks, P, w, L, wb, G, K,
            stream)
        _build.check(err, "mont_merge")
        _build.count_launch(mont_scan)
    return out


mont_scan.launches = 0


# --------------------------------------------------------------------------
# public entry points (the arguments of pir_tpu's tpu_* functions + device)
# --------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """None is the card (RuntimeError with no CUDA); "cpu" the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the device Montgomery engine needs a CUDA device; pass "
                               "device='cpu' to run its plain version on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device}")
    return device


def _pow2ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length() if x > 1 else 1


def paillier_scan_words(ebits: list, emat: np.ndarray, mod: int, e_max: int,
                        device=None, row_chunk: int = ROW_CHUNK,
                        col_chunk: int = BLOCK) -> list:
    """out[j] = prod_row ebits[row]^emat[row, j] mod mod, for an exponent
    matrix already packed as (height, width, EW) uint32 words."""
    dev = resolve_device(device)
    h, w = emat.shape[:2]
    if h == 0 or w == 0:
        return [1] * w
    L = words_for_modulus(mod)
    word_ctx(mod)  # refuses an even modulus
    bases = upload_words(ints_to_words([b % mod for b in ebits], L), dev)
    out = mont_scan(bases, upload_words(emat, dev), mod, max(1, e_max), row_chunk, col_chunk)
    return words_to_ints(out.cpu().numpy())


def device_paillier_scan(
    ebits: list, vals: list, width_cts: int, mod: int,
    e_max: int | None = None, row_chunk: int = ROW_CHUNK, col_chunk: int = BLOCK,
    device=None,
) -> list:
    """out[j] = prod_row ebits[row]^vals[row*width_cts+j] mod mod
    (tpu_paillier_scan's semantics: exponent 0 is the identity, the
    reference's out-of-range `continue`). `e_max`, the protocol's bound on
    exponent bits, defaults to the batch's own; row_chunk bounds the rows a
    group multiplies together (a plain chunk's rows on the CPU) and
    col_chunk the columns of a block; both powers of two as in pir_tpu."""
    height = len(ebits)
    if len(vals) != height * width_cts:
        raise ValueError("vals must be a (height, width_cts) matrix")
    if row_chunk & (row_chunk - 1) or col_chunk & (col_chunk - 1):
        raise ValueError("row_chunk and col_chunk must be powers of two")
    if height == 0 or width_cts == 0:
        return [1] * width_cts
    if e_max is None:
        e_max = max((v.bit_length() for v in vals), default=1)
    emat = pack_exponents(vals, max(1, e_max)).reshape(height, width_cts, -1)
    return paillier_scan_words(ebits, emat, mod, e_max, device, row_chunk, col_chunk)


def _powmod_rows(bases, exps, mods, e_max, batch_chunk, device):
    dev = resolve_device(device)
    L = max(words_for_modulus(m) for m in set(mods))
    for m in set(mods):
        word_ctx(m, L)  # refuses an even modulus
    out: list = []
    for lo in range(0, len(bases), batch_chunk):
        hi = min(len(bases), lo + batch_chunk)
        b = upload_words(ints_to_words([bases[i] % mods[i] for i in range(lo, hi)], L), dev)
        e = upload_words(pack_exponents(exps[lo:hi], e_max), dev)
        out.extend(words_to_ints(mont_powmod(b, e, mods[lo:hi], e_max).cpu().numpy()))
    return out


def device_powmod_batch(
    bases: list, exps: list, mod: int, e_max: int | None = None,
    batch_chunk: int = 4096, device=None,
) -> list:
    """Batched pow(base, exp, mod) (tpu_powmod_batch): kernel 9 on the card,
    batch_chunk rows a launch. e_max rounds up to a power of two, at least
    32, as in pir_tpu: the ladder's length then says little of the
    exponents."""
    if len(bases) != len(exps):
        raise ValueError("bases and exps must have equal length")
    if batch_chunk & (batch_chunk - 1):
        raise ValueError("batch_chunk must be a power of two")
    if not bases:
        return []
    word_ctx(mod)
    if e_max is None:
        e_max = max((e.bit_length() for e in exps), default=1)
    e_max = max(32, _pow2ceil(e_max))
    return _powmod_rows(list(bases), list(exps), [mod] * len(bases), e_max, batch_chunk, device)


def device_powmod_batch_multi(
    bases: list, exps: list, mods: list, e_max: int | None = None,
    batch_chunk: int = 4096, device=None,
) -> list:
    """Batched pow(base, exp, mod) with a modulus per row, one launch per
    batch_chunk rows (tpu_powmod_batch_multi): the secret key's CRT halves
    mod p^s and q^s ride one launch. The rows share the largest modulus's
    word count. e_max rounds up to 256 bits, as in pir_tpu."""
    if not (len(bases) == len(exps) == len(mods)):
        raise ValueError("bases, exps and mods must have equal length")
    if batch_chunk & (batch_chunk - 1):
        raise ValueError("batch_chunk must be a power of two")
    if not bases:
        return []
    for m in set(mods):
        word_ctx(m)
    if e_max is None:
        e_max = max((e.bit_length() for e in exps), default=1)
    e_max = max(32, -(-e_max // 256) * 256) if e_max > 32 else 32
    return _powmod_rows(list(bases), list(exps), list(mods), e_max, batch_chunk, device)
