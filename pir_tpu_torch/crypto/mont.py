"""Batched Montgomery modexps and the cPIR scan on the card (counterpart of
``pir_tpu/crypto/mont_tpu.py``).

The single-server cPIR hot loop is a batched multi-exponentiation: per
column, answer = prod_row Enc(bit_row)^chunk(row, col) mod N^k (db.go:
176-271). pir_tpu runs it, and the batched modexps of query generation,
decryption and the DDLEQ proofs, as jitted jnp in radix-2^15 limbs. Here
they run in two hand-written CUDA kernels (``csrc/mont_exp.cu``, on the
per-thread arithmetic of ``csrc/mont.cuh``, 32-bit words):

* kernel 9, ``mont_powmod``: out[i] = base[i]^e[i] mod m[i], one modulus
  or one a row;
* kernel 10, ``mont_scan``: out[w] = prod_r base[r]^e[r, w] mod m.

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
    """Per-modulus constants of the kernels: L words, -m^-1 mod 2^32 and
    R^2 mod m for R = 2^(32 L)."""

    m: int
    L: int
    n_words: np.ndarray   # (L,) uint32
    n0inv: int
    r2_words: np.ndarray  # (L,) uint32


@functools.lru_cache(maxsize=64)
def word_ctx(m: int, L: int | None = None) -> WordCtx:
    if m % 2 == 0 or m <= 1:
        raise ValueError("Montgomery arithmetic needs an odd modulus > 1")
    L = words_for_modulus(m) if L is None else L
    r = 1 << (32 * L)
    if r <= m:
        raise ValueError(f"{L} words are too few for a {m.bit_length()}-bit modulus")
    return WordCtx(m, L, ints_to_words([m], L)[0], (-pow(m, -1, 1 << 32)) & 0xFFFFFFFF,
                   ints_to_words([r * r % m], L)[0])


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
# kernel wrappers
# --------------------------------------------------------------------------

_POWMOD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_SCAN_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_uint] + [ctypes.c_void_p] * 2
              + [ctypes.c_int] * 9 + [ctypes.c_void_p])
_MERGE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_uint, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
BLOCK = 128  # threads a block (the kernels' __launch_bounds__)


def window_bits(e_max: int) -> int:
    """The kernels' window: 4 bits for e_max >= 64 (as mont_tpu.mont_exp),
    else 1 (square and multiply)."""
    return 4 if e_max >= 64 else 1


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


def _u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(device)


def powmod_products(e_max: int, rows: int = 1, wbits: int | None = None) -> int:
    """Montgomery products of `rows` modexps at a fixed window of wbits
    (kernel 9's window_bits by default): the table (2^wbits), the ladder
    (wbits + 1 a window) and leaving the domain."""
    wb = window_bits(e_max) if wbits is None else wbits
    return rows * ((1 << wb) + -(-e_max // wb) * (wb + 1) + 1)


def least_powmod_products(e_max: int, rows: int = 1) -> int:
    """The fewest Montgomery products of `rows` modexps of e_max-bit
    exponents, each with its own base, over every fixed window."""
    return min(powmod_products(e_max, rows, wb) for wb in range(1, 17))


def scan_plan(h: int, w: int, L: int, e_max: int, sms: int, smem_optin: int,
              row_chunk: int = ROW_CHUNK, col_chunk: int = BLOCK) -> dict:
    """Kernel 10's launch shape: threads a block (columns), rows a chunk
    (rc, at most row_chunk and what shared memory holds), chunks, and
    whether the threads' state fits in shared memory. Enough (column,
    chunk) threads to fill every SM, as few chunks as that
    allows (each chunk repeats the squarings): a chunk for each block the
    SMs hold at once."""
    wb = window_bits(e_max)
    block = min(BLOCK, col_chunk, 32 * -(-w // 32))
    tiles = -(-w // block)
    state = 2 * (L + 1) * block
    table = L << wb
    smem_state = 4 * (L + table + state) <= smem_optin
    room = smem_optin // 4 - L - (state if smem_state else 0)
    if room < table:
        raise ValueError(f"a {L}-word modulus's table does not fit in shared memory")
    # blocks an SM holds at one row a chunk (shared memory, 2048 threads)
    per_block = 4 * (L + table + (state if smem_state else 0)) + 1024
    resident = max(1, min(2048 // block, (smem_optin + 1024) // per_block))
    chunks = min(h, max(1, -(-sms * resident * block // (tiles * block))))
    rc = min(-(-h // chunks), row_chunk, room // table)
    rc = max(rc, -(-h // 65535))
    if rc * table > room:
        raise ValueError(f"{h} rows need more than 65535 chunks of {room // table}")
    return {"block": block, "rc": rc, "chunks": -(-h // rc), "smem_state": smem_state,
            "wbits": wb}


def scan_products(plan: dict, h: int, w: int, e_max: int) -> int:
    """Montgomery products kernel 10 runs: the chunks' tables, Straus's
    squarings and row products per (column, chunk), the merge."""
    wb, chunks = plan["wbits"], plan["chunks"]
    nwin = -(-e_max // wb)
    return (h * (1 << wb) + chunks * w * nwin * wb + w * nwin * h + w * chunks)


def least_scan_products(h: int, w: int, e_max: int) -> int:
    """The fewest Montgomery products of the scan's function over every
    fixed window: Straus's method in one chunk, each row's table built
    once and shared by all w columns, the squarings shared by the rows."""
    return min(scan_products({"wbits": wb, "chunks": 1}, h, w, e_max) for wb in range(1, 17))


def mont_powmod(bases: torch.Tensor, exps: torch.Tensor, mods, e_max: int) -> torch.Tensor:
    """(B, L) int32 words of bases < m, (B, EW) int32 exponent words (EW >=
    ceil(e_max / 32), e_max >= 1), one odd modulus or B of them (of at
    most L words) -> (B, L) int32 words of bases^exps mod m."""
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
    distinct = sorted(set(mods))
    ctxs = {m: word_ctx(m, L) for m in distinct}
    per_row = len(distinct) > 1
    if per_row:
        n = _u32_tensor(np.stack([ctxs[m].n_words for m in mods]).T, dev)  # (L, B)
        n0 = _u32_tensor(np.array([ctxs[m].n0inv for m in mods]), dev)
        r2 = _u32_tensor(np.stack([ctxs[m].r2_words for m in mods]), dev)
    else:
        c = ctxs[distinct[0]]
        n, n0, r2 = (_u32_tensor(x, dev) for x in (c.n_words, np.array([c.n0inv]), c.r2_words))
    wb = window_bits(e_max)
    out = torch.empty_like(bases)
    fn = _lib("pir_mont_powmod", _POWMOD_ARGS)
    with torch.cuda.device(dev):
        block = BLOCK
        smem_state = 4 * 2 * (L + 1) * block <= _smem_optin(dev.index or 0)
        nth = -(-b // block) * block
        state = torch.empty(0 if smem_state else 2 * (L + 1) * nth, dtype=torch.int32,
                            device=dev)
        tables = torch.empty((L << wb) * nth, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(bases.data_ptr(), exps.data_ptr(), out.data_ptr(), n.data_ptr(), n0.data_ptr(),
                 r2.data_ptr(), state.data_ptr(), tables.data_ptr(), b, L, exps.shape[1], e_max,
                 wb, int(per_row), int(smem_state), block, stream)
        _build.check(err, "mont_powmod")
        _build.count_launch(mont_powmod)
    return out


mont_powmod.launches = 0


def mont_scan(bases: torch.Tensor, exps: torch.Tensor, mod: int, e_max: int,
              row_chunk: int = ROW_CHUNK, col_chunk: int = BLOCK) -> torch.Tensor:
    """(H, L) int32 words of bases < mod, (H, W, EW) int32 exponent words
    -> (W, L) int32 words of prod_r bases[r]^exps[r, w] mod mod. On the card
    a launch pair: the chunks' Straus products, then their merge."""
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
    w, ew = exps.shape[1], exps.shape[2]
    c = word_ctx(mod, L)
    n, r2 = _u32_tensor(c.n_words, dev), _u32_tensor(c.r2_words, dev)
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = scan_plan(h, w, L, e_max, sms, _smem_optin(dev.index or 0), row_chunk, col_chunk)
        block, chunks = plan["block"], plan["chunks"]
        nth = -(-w // block) * block * chunks
        state = torch.empty(0 if plan["smem_state"] else 2 * (L + 1) * nth, dtype=torch.int32,
                            device=dev)
        partials = torch.empty(chunks * L * w, dtype=torch.int32, device=dev)
        out = torch.empty((w, L), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("pir_mont_scan", _SCAN_ARGS)(
            bases.data_ptr(), exps.data_ptr(), partials.data_ptr(), n.data_ptr(), c.n0inv,
            r2.data_ptr(), state.data_ptr(), h, w, L, ew, e_max, plan["wbits"], plan["rc"],
            int(plan["smem_state"]), block, stream)
        _build.check(err, "mont_scan")
        merge_state = torch.empty(2 * (L + 1) * -(-w // BLOCK) * BLOCK, dtype=torch.int32,
                                  device=dev)
        err = _lib("pir_mont_merge", _MERGE_ARGS)(
            partials.data_ptr(), out.data_ptr(), n.data_ptr(), c.n0inv, merge_state.data_ptr(),
            chunks, w, L, BLOCK, stream)
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
    bases = _u32_tensor(ints_to_words([b % mod for b in ebits], L), dev)
    out = mont_scan(bases, _u32_tensor(emat, dev), mod, max(1, e_max), row_chunk, col_chunk)
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
    thread multiplies together (a plain chunk's rows on the CPU) and
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
        b = _u32_tensor(ints_to_words([bases[i] % mods[i] for i in range(lo, hi)], L), dev)
        e = _u32_tensor(pack_exponents(exps[lo:hi], e_max), dev)
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
