"""Host (client-side / golden) two-party DPF (counterpart of the two-party
subset of ``pir_tpu/dpf/host.py``).

Two key styles:

* reference-exact ("compat") keys, replicated bit for bit from the Go
  package ``pir/dpf`` (BGI'16 two-party DPF, fixed-key MMO AES PRG):
  ``generate_two_server[_batch]`` (dpf/client.go:56-150), the single
  point ``evaluate_2p`` (dpf/server.go:55-101) and the breadth-first
  ``eval_full_domain[_bits]``, the host golden model of the device path.
  Each leaf's value is the Go signed varint of its seed's first 8 bytes;
  the PIR selection bit is ``value % 2 == 0`` (db.go:140-146).
* fast keys, the early-termination DPF (BGI'16 §3.2.1): the tree stops
  ``log2(leaf_bits)`` levels early and each leaf seed CTR-extends with
  the 4th PRF key into ``leaf_bits`` selection bits, corrected by a
  ``leaf_bits``-wide final correction word. ``bits0 ^ bits1`` is one-hot
  at the target row, so answers recover exactly.

Keyword queries use reference-exact keys over the 32-bit keyword domain,
evaluated at each row's keyword (``eval_points``, the keyword golden).
Multi-party (>= 3 server) keys (``KeyMP``, ``generate_multi_server``,
``evaluate_mp``, ``eval_points_mp``) give XOR shares of the point
function (dpf/server.go:110-144; the reference's keygen is a stub that
the JAX package completes, and this is its copy).

Keygen draws its randomness from ``rand_bytes`` (default ``os.urandom``);
tests pass a seeded source to make a run repeatable.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..utils.bits import GO_UINT_BITS, bitrev_permutation, get_bit, go_varint, go_varint_vec
from .aes_host import BLOCK_SIZE, INIT_PRF_LEN, EcbCipher, prf_blocks

RandBytes = Callable[[int], bytes]


@dataclass
class PrfKey:
    """16-byte AES key; the PRG seed keys."""

    bytes: bytes


@dataclass
class Dpf:
    """Party state: the fixed PRF keys and their ciphers."""

    num_bits: int
    prf_keys: list[PrfKey]
    ciphers: list[EcbCipher] = field(repr=False)
    n: int = GO_UINT_BITS
    m: int = 4  # multi-party word size in bytes


def client_initialize(num_bits: int, rand_bytes: RandBytes = os.urandom) -> Dpf:
    """Sample the 4 fixed PRF keys."""
    keys = [rand_bytes(BLOCK_SIZE) for _ in range(INIT_PRF_LEN)]
    return Dpf(
        num_bits=num_bits,
        prf_keys=[PrfKey(k) for k in keys],
        ciphers=[EcbCipher(k) for k in keys],
    )


def server_initialize(prf_keys: list[PrfKey], num_bits: int) -> Dpf:
    """Rebuild the fixed ciphers from client-provided keys."""
    return Dpf(
        num_bits=num_bits,
        prf_keys=list(prf_keys),
        ciphers=[EcbCipher(k.bytes) for k in prf_keys],
    )


def _prf1(dpf: Dpf, x: bytes, num_blocks: int = 3) -> bytes:
    out = prf_blocks(np.frombuffer(x, dtype=np.uint8)[None, :], dpf.ciphers, num_blocks)
    return out[0].tobytes()


# --------------------------------------------------------------------------
# Reference-exact (compat) keys
# --------------------------------------------------------------------------

@dataclass
class Key2P:
    """Two-party DPF key (dpf/common.go:29-35)."""

    s_init: bytes  # 16 bytes
    t_init: int  # 0/1
    cw: list[bytes]  # num_bits entries of 18 bytes: 16B seed CW + tL + tR
    final_cw: int


def generate_two_server(dpf: Dpf, a: int, b: int,
                        rand_bytes: RandBytes = os.urandom) -> list[Key2P]:
    """BGI'16 two-party keygen for f(a)=b (dpf/client.go:56-150)."""
    nb = dpf.num_bits
    temp_rand = rand_bytes(BLOCK_SIZE + 1)
    s_init0 = temp_rand[:BLOCK_SIZE]
    t_init0 = temp_rand[BLOCK_SIZE] % 2
    s_init1 = rand_bytes(BLOCK_SIZE)
    t_init1 = t_init0 ^ 1

    s_curr0 = bytearray(s_init0)
    s_curr1 = bytearray(s_init1)
    t_curr0, t_curr1 = t_init0, t_init1

    cw = []
    left, right = 0, BLOCK_SIZE + 1
    for i in range(nb):
        out0 = _prf1(dpf, bytes(s_curr0))
        out1 = _prf1(dpf, bytes(s_curr1))
        t0l = out0[BLOCK_SIZE] % 2
        t0r = out0[BLOCK_SIZE * 2 + 1] % 2
        t1l = out1[BLOCK_SIZE] % 2
        t1r = out1[BLOCK_SIZE * 2 + 1] % 2
        a_bit = get_bit(a, dpf.n - nb + i + 1, dpf.n)
        keep, lose = (left, right) if a_bit == 0 else (right, left)

        cw_i = bytearray(BLOCK_SIZE + 2)
        for j in range(BLOCK_SIZE):
            cw_i[j] = out0[lose + j] ^ out1[lose + j]
        cw_i[BLOCK_SIZE] = t0l ^ t1l ^ a_bit ^ 1
        cw_i[BLOCK_SIZE + 1] = t0r ^ t1r ^ a_bit
        cw.append(bytes(cw_i))

        for j in range(BLOCK_SIZE):
            s_curr0[j] = out0[keep + j] ^ (t_curr0 * cw_i[j])
            s_curr1[j] = out1[keep + j] ^ (t_curr1 * cw_i[j])
        t_cw_keep = cw_i[BLOCK_SIZE] if keep == left else cw_i[BLOCK_SIZE + 1]
        t_curr0 = (out0[keep + BLOCK_SIZE] % 2) ^ (t_cw_keep * t_curr0)
        t_curr1 = (out1[keep + BLOCK_SIZE] % 2) ^ (t_cw_keep * t_curr1)

    s_final0, _ = go_varint(bytes(s_curr0[:8]))
    s_final1, _ = go_varint(bytes(s_curr1[:8]))
    final_cw = b - s_final0 + s_final1
    if t_curr1 == 1:
        final_cw = -final_cw
    return [
        Key2P(s_init0, t_init0, list(cw), final_cw),
        Key2P(s_init1, t_init1, list(cw), final_cw),
    ]


def generate_two_server_batch(dpf: Dpf, points: "list[int]", b: int,
                              rand_bytes: RandBytes = os.urandom) -> "list[list[Key2P]]":
    """Vectorised reference-semantics keygen: Q keys in one tree walk.

    Per key the same semantics as generate_two_server (including the
    signed-varint final CW); numpy replaces the per-byte loops. All Q
    keys share the caller's ``dpf`` PRF keys: those are public (sent to
    every server with the share), so security rests on the fresh
    per-query seeds. Returns [ [key_server0, key_server1] per point ].
    """
    nb = dpf.num_bits
    q = len(points)
    pts = np.asarray(points, dtype=np.uint64)

    rnd = np.frombuffer(rand_bytes(q * 33), np.uint8).reshape(q, 33)
    s0 = rnd[:, :16].copy()
    t0 = (rnd[:, 32] & 1).astype(np.uint8)
    s1 = rnd[:, 16:32].copy()
    t1 = t0 ^ 1

    s_curr0, s_curr1 = s0.copy(), s1.copy()
    t_curr0, t_curr1 = t0.copy(), t1.copy()
    cw = np.zeros((q, nb, 18), np.uint8)
    cols = np.arange(16)
    for i in range(nb):
        out0 = prf_blocks(s_curr0, dpf.ciphers, 3).reshape(q, 48)
        out1 = prf_blocks(s_curr1, dpf.ciphers, 3).reshape(q, 48)
        a_bit = ((pts >> np.uint64(nb - 1 - i)) & np.uint64(1)).astype(np.uint8)
        # keep/lose offsets into the 48-byte PRG output: left child at
        # byte 0, right at byte 17
        keep = np.where(a_bit == 0, 0, 17).astype(np.int64)[:, None]
        lose = 17 - keep
        cw_seed = (np.take_along_axis(out0, lose + cols, 1)
                   ^ np.take_along_axis(out1, lose + cols, 1))
        cw_tl = (out0[:, 16] & 1) ^ (out1[:, 16] & 1) ^ a_bit ^ 1
        cw_tr = (out0[:, 33] & 1) ^ (out1[:, 33] & 1) ^ a_bit
        cw[:, i, :16] = cw_seed
        cw[:, i, 16] = cw_tl
        cw[:, i, 17] = cw_tr
        s_curr0 = (np.take_along_axis(out0, keep + cols, 1)
                   ^ (t_curr0[:, None] * cw_seed))
        s_curr1 = (np.take_along_axis(out1, keep + cols, 1)
                   ^ (t_curr1[:, None] * cw_seed))
        t_cw_keep = np.where(a_bit == 0, cw_tl, cw_tr)
        t_curr0 = ((np.take_along_axis(out0, keep + 16, 1)[:, 0] & 1)
                   ^ (t_cw_keep * t_curr0))
        t_curr1 = ((np.take_along_axis(out1, keep + 16, 1)[:, 0] & 1)
                   ^ (t_cw_keep * t_curr1))

    s_finals0 = go_varint_vec(s_curr0[:, :8]) if q else []
    s_finals1 = go_varint_vec(s_curr1[:, :8]) if q else []
    out = []
    for j in range(q):
        final_cw = b - int(s_finals0[j]) + int(s_finals1[j])
        if t_curr1[j] == 1:
            final_cw = -final_cw
        cws = [cw[j, i].tobytes() for i in range(nb)]
        out.append([
            Key2P(s0[j].tobytes(), int(t0[j]), cws, final_cw),
            Key2P(s1[j].tobytes(), int(t1[j]), cws, final_cw),
        ])
    return out


def evaluate_2p(dpf: Dpf, server_num: int, key: Key2P, x: int) -> int:
    """Single-point two-party eval (dpf/server.go:55-101)."""
    nb = dpf.num_bits
    s_curr = bytearray(key.s_init)
    t_curr = key.t_init
    for i in range(nb):
        x_bit = 0 if i == dpf.n else get_bit(x, dpf.n - nb + i + 1, dpf.n)
        out = bytearray(_prf1(dpf, bytes(s_curr)))
        cw_i = key.cw[i]
        # G(s) ^ (t * [sCW || tLCW || sCW || tRCW]) (dpf/server.go:70-85)
        count = 0
        for j in range(BLOCK_SIZE * 2 + 2):
            if j == BLOCK_SIZE + 1:
                count = 0
            elif j == BLOCK_SIZE * 2 + 1:
                count = BLOCK_SIZE + 1
            out[j] ^= t_curr * cw_i[count]
            count += 1
        if x_bit == 0:
            s_curr[:] = out[:BLOCK_SIZE]
            t_curr = out[BLOCK_SIZE] % 2
        else:
            s_curr[:] = out[BLOCK_SIZE + 1:BLOCK_SIZE * 2 + 1]
            t_curr = out[BLOCK_SIZE * 2 + 1] % 2
    s_final, _ = go_varint(bytes(s_curr[:8]))
    res = s_final + t_curr * key.final_cw
    return res if server_num == 0 else -res


def expand_seeds_one_level(dpf: Dpf, seeds: np.ndarray, t_bits: np.ndarray,
                           cw_i: bytes) -> tuple[np.ndarray, np.ndarray]:
    """One breadth-first level: (n,16)+(n,) -> (2n,16)+(2n,). Children are
    stored [all left | all right], so the final leaves lie in the
    bit-reversal of the natural domain order."""
    flat = prf_blocks(seeds, dpf.ciphers, 3).reshape(seeds.shape[0], 48)
    s_l = flat[:, 0:16].copy()
    t_l = flat[:, 16] & 1
    s_r = flat[:, 17:33].copy()
    t_r = flat[:, 33] & 1

    cw_seed = np.frombuffer(cw_i[:16], dtype=np.uint8)
    t_mask = t_bits.astype(np.uint8)[:, None]
    s_l ^= cw_seed[None, :] * t_mask
    s_r ^= cw_seed[None, :] * t_mask
    t_l = t_l ^ (t_bits & cw_i[16])
    t_r = t_r ^ (t_bits & cw_i[17])
    return (np.concatenate([s_l, s_r], axis=0),
            np.concatenate([t_l, t_r], axis=0).astype(np.uint8))


def eval_full_domain(dpf: Dpf, server_num: int, key: Key2P) -> np.ndarray:
    """The key share's value on every point of the 2^num_bits domain:
    int64, natural order, equal to ``evaluate_2p`` point by point, with
    O(N) AES calls (db.go:128-171 re-walks the tree per row)."""
    nb = dpf.num_bits
    seeds = np.frombuffer(key.s_init, dtype=np.uint8)[None, :].copy()
    t_bits = np.array([key.t_init], dtype=np.uint8)
    for i in range(nb):
        seeds, t_bits = expand_seeds_one_level(dpf, seeds, t_bits, key.cw[i])
    res = go_varint_vec(seeds[:, :8]) + t_bits.astype(np.int64) * key.final_cw
    if server_num != 0:
        res = -res
    return res[bitrev_permutation(nb)]


def eval_full_domain_bits(dpf: Dpf, server_num: int, key: Key2P,
                          height: int) -> np.ndarray:
    """PIR selection bits for rows [0, height): bit = (value % 2 == 0),
    the inverted parity convention of db.go:140-146."""
    vals = eval_full_domain(dpf, server_num, key)
    return ((vals & 1) == 0)[:height]


def eval_points(dpf: Dpf, server_num: int, key: Key2P, xs: np.ndarray) -> np.ndarray:
    """``evaluate_2p`` at many points at once (the keyword golden model):
    all points walk the tree together, each following its own branch
    (dpf/server.go:55-94). Returns int64 values."""
    nb = dpf.num_bits
    xs = np.asarray(xs, dtype=np.uint64)
    n = len(xs)
    seeds = np.tile(np.frombuffer(key.s_init, dtype=np.uint8), (n, 1))
    t_bits = np.full(n, key.t_init, dtype=np.uint8)
    for i in range(nb):
        out = prf_blocks(seeds, dpf.ciphers, 3).reshape(n, 48)
        cw_i = key.cw[i]
        cw_seed = np.frombuffer(cw_i[:16], dtype=np.uint8)
        t_mask = t_bits[:, None]
        s_l = out[:, 0:16] ^ cw_seed[None, :] * t_mask
        s_r = out[:, 17:33] ^ cw_seed[None, :] * t_mask
        t_l = (out[:, 16] & 1) ^ (t_bits & cw_i[16])
        t_r = (out[:, 33] & 1) ^ (t_bits & cw_i[17])
        x_bit = ((xs >> np.uint64(nb - 1 - i)) & np.uint64(1)).astype(bool)
        seeds = np.where(x_bit[:, None], s_r, s_l)
        t_bits = np.where(x_bit, t_r, t_l).astype(np.uint8)
    s_final = go_varint_vec(np.ascontiguousarray(seeds[:, :8]))
    res = s_final + t_bits.astype(np.int64) * key.final_cw
    return res if server_num == 0 else -res


# --------------------------------------------------------------------------
# Fast keys
# --------------------------------------------------------------------------

LEAF_BITS = 128

# client-side default leaf width for fast keygen (power of two >= 128),
# clamped per height by fast_leaf_bits_for_height
DEFAULT_FAST_LEAF_BITS = 1024


@dataclass
class FastKey2P:
    """Early-termination two-party DPF key (bit output)."""

    s_init: bytes
    t_init: int
    cw: list[bytes]  # depth entries of 18 bytes: 16B seed CW + tL + tR
    final_cw_block: bytes  # 16*n bytes: leaf_bits-wide output correction
    depth: int
    height: int

    @property
    def leaf_bits(self) -> int:
        return len(self.final_cw_block) * 8


def fast_depth_for_height(height: int, leaf_bits: int = LEAF_BITS) -> int:
    leaves = -(-height // leaf_bits)
    return max(0, (leaves - 1).bit_length())


def _check_leaf_bits(leaf_bits: int) -> int:
    if leaf_bits < 128 or leaf_bits & (leaf_bits - 1):
        raise ValueError(f"leaf_bits must be a power of two >= 128, got {leaf_bits}")
    return leaf_bits // 128


def fast_leaf_bits_for_height(height: int, leaf_bits: int) -> int:
    """Clamp a requested leaf width so the tree keeps >= 5 levels (the
    root-start serving path needs them); never below 128."""
    _check_leaf_bits(leaf_bits)
    while leaf_bits > LEAF_BITS and fast_depth_for_height(height, leaf_bits) < 5:
        leaf_bits >>= 1
    return leaf_bits


def _leaf_blocks_wide(dpf: Dpf, seeds: np.ndarray, n_blk: int) -> np.ndarray:
    """(n,16) leaf seeds -> (n, 16*n_blk) leaf output bytes.

    Block b = AES_{k3}(seed ^ LE64(b)) ^ (seed ^ LE64(b))."""
    out = prf_blocks(seeds, [dpf.ciphers[3]], n_blk)
    return out.reshape(seeds.shape[0], 16 * n_blk)


def generate_two_server_fast(
    dpf: Dpf, a: int, height: int, leaf_bits: int = LEAF_BITS,
    rand_bytes: RandBytes = os.urandom,
) -> list[FastKey2P]:
    """Keygen for f(a)=1 over [0, height) with early termination."""
    if not 0 <= a < height:
        raise ValueError("requesting key outside of domain")
    n_blk = _check_leaf_bits(leaf_bits)
    depth = fast_depth_for_height(height, leaf_bits)
    saved_bits = dpf.num_bits
    dpf.num_bits = depth

    leaf_index = a // leaf_bits
    temp = rand_bytes(BLOCK_SIZE + 1)
    s0 = bytearray(temp[:BLOCK_SIZE])
    t0 = temp[BLOCK_SIZE] % 2
    s1 = bytearray(rand_bytes(BLOCK_SIZE))
    t1 = t0 ^ 1

    s_curr0, s_curr1 = bytearray(s0), bytearray(s1)
    t_curr0, t_curr1 = t0, t1
    cw = []
    for i in range(depth):
        out0 = _prf1(dpf, bytes(s_curr0))
        out1 = _prf1(dpf, bytes(s_curr1))
        t0l, t0r = out0[BLOCK_SIZE] % 2, out0[BLOCK_SIZE * 2 + 1] % 2
        t1l, t1r = out1[BLOCK_SIZE] % 2, out1[BLOCK_SIZE * 2 + 1] % 2
        a_bit = (leaf_index >> (depth - 1 - i)) & 1
        keep, lose = (0, BLOCK_SIZE + 1) if a_bit == 0 else (BLOCK_SIZE + 1, 0)
        cw_i = bytearray(BLOCK_SIZE + 2)
        for j in range(BLOCK_SIZE):
            cw_i[j] = out0[lose + j] ^ out1[lose + j]
        cw_i[BLOCK_SIZE] = t0l ^ t1l ^ a_bit ^ 1
        cw_i[BLOCK_SIZE + 1] = t0r ^ t1r ^ a_bit
        cw.append(bytes(cw_i))
        for j in range(BLOCK_SIZE):
            s_curr0[j] = out0[keep + j] ^ (t_curr0 * cw_i[j])
            s_curr1[j] = out1[keep + j] ^ (t_curr1 * cw_i[j])
        t_cw_keep = cw_i[BLOCK_SIZE] if keep == 0 else cw_i[BLOCK_SIZE + 1]
        t_curr0 = (out0[keep + BLOCK_SIZE] % 2) ^ (t_cw_keep * t_curr0)
        t_curr1 = (out1[keep + BLOCK_SIZE] % 2) ^ (t_cw_keep * t_curr1)

    dpf.num_bits = saved_bits

    blk0 = _leaf_blocks_wide(
        dpf, np.frombuffer(bytes(s_curr0), np.uint8)[None, :], n_blk)[0]
    blk1 = _leaf_blocks_wide(
        dpf, np.frombuffer(bytes(s_curr1), np.uint8)[None, :], n_blk)[0]
    within = a % leaf_bits
    e_a = np.zeros(16 * n_blk, dtype=np.uint8)
    e_a[within >> 3] = 1 << (within & 7)
    fcw = (blk0 ^ blk1 ^ e_a).tobytes()
    # exactly one of t_curr0/t_curr1 is 1 at the target leaf, so
    # bits0 ^ bits1 = blk0 ^ blk1 ^ fcw = e_a there, and 0 elsewhere.
    return [
        FastKey2P(bytes(s0), t0, list(cw), fcw, depth, height),
        FastKey2P(bytes(s1), t1, list(cw), fcw, depth, height),
    ]


def generate_two_server_fast_batch(
    dpf: Dpf, indices: "list[int]", height: int, leaf_bits: int = LEAF_BITS,
    rand_bytes: RandBytes = os.urandom,
) -> "list[list[FastKey2P]]":
    """Vectorised fast-mode keygen: one tree walk for Q queries at once.

    Semantically identical to Q calls of generate_two_server_fast. All Q
    keys share the caller's ``dpf`` PRF keys — those are public (every
    server receives them with the share), so security rests on the fresh
    per-query seeds. Returns [ [key_server0, key_server1] per index ].
    """
    n_blk = _check_leaf_bits(leaf_bits)
    depth = fast_depth_for_height(height, leaf_bits)
    q = len(indices)
    idx = np.asarray(indices, dtype=np.uint64)
    if q and (idx >= height).any():
        raise ValueError("requesting key outside of domain")
    leaf = (idx // np.uint64(leaf_bits)).astype(np.uint64)

    rnd = np.frombuffer(rand_bytes(q * 33), np.uint8).reshape(q, 33)
    s0 = rnd[:, :16].copy()
    t0 = (rnd[:, 32] & 1).astype(np.uint8)
    s1 = rnd[:, 16:32].copy()
    t1 = t0 ^ 1

    s_curr0, s_curr1 = s0.copy(), s1.copy()
    t_curr0, t_curr1 = t0.copy(), t1.copy()
    cw = np.zeros((q, depth, 18), np.uint8)
    cols = np.arange(16)
    for i in range(depth):
        out0 = prf_blocks(s_curr0, dpf.ciphers, 3).reshape(q, 48)
        out1 = prf_blocks(s_curr1, dpf.ciphers, 3).reshape(q, 48)
        a_bit = ((leaf >> np.uint64(depth - 1 - i)) & np.uint64(1)).astype(np.uint8)
        # keep/lose offsets into the 48-byte PRG output: left expansion
        # at byte 0, right at byte 17
        keep = np.where(a_bit == 0, 0, 17).astype(np.int64)[:, None]
        lose = 17 - keep
        cw_seed = (np.take_along_axis(out0, lose + cols, 1)
                   ^ np.take_along_axis(out1, lose + cols, 1))
        cw_tl = (out0[:, 16] & 1) ^ (out1[:, 16] & 1) ^ a_bit ^ 1
        cw_tr = (out0[:, 33] & 1) ^ (out1[:, 33] & 1) ^ a_bit
        cw[:, i, :16] = cw_seed
        cw[:, i, 16] = cw_tl
        cw[:, i, 17] = cw_tr
        s_curr0 = (np.take_along_axis(out0, keep + cols, 1)
                   ^ (t_curr0[:, None] * cw_seed))
        s_curr1 = (np.take_along_axis(out1, keep + cols, 1)
                   ^ (t_curr1[:, None] * cw_seed))
        t_cw_keep = np.where(a_bit == 0, cw_tl, cw_tr)
        t_next0 = np.take_along_axis(out0, keep + 16, 1)[:, 0] & 1
        t_next1 = np.take_along_axis(out1, keep + 16, 1)[:, 0] & 1
        t_curr0 = t_next0 ^ (t_cw_keep * t_curr0)
        t_curr1 = t_next1 ^ (t_cw_keep * t_curr1)

    blk0 = _leaf_blocks_wide(dpf, s_curr0, n_blk)
    blk1 = _leaf_blocks_wide(dpf, s_curr1, n_blk)
    within = (idx % np.uint64(leaf_bits)).astype(np.int64)
    e_a = np.zeros((q, 16 * n_blk), np.uint8)
    e_a[np.arange(q), within >> 3] = (1 << (within & 7)).astype(np.uint8)
    fcw = blk0 ^ blk1 ^ e_a

    return [
        [
            FastKey2P(s0[j].tobytes(), int(t0[j]),
                      [cw[j, i].tobytes() for i in range(depth)],
                      fcw[j].tobytes(), depth, height),
            FastKey2P(s1[j].tobytes(), int(t1[j]),
                      [cw[j, i].tobytes() for i in range(depth)],
                      fcw[j].tobytes(), depth, height),
        ]
        for j in range(q)
    ]


def eval_full_domain_fast_bits(dpf: Dpf, key: FastKey2P) -> np.ndarray:
    """(height,) bool selection-bit share, natural row order (host golden)."""
    seeds = np.frombuffer(key.s_init, dtype=np.uint8)[None, :].copy()
    t_bits = np.array([key.t_init], dtype=np.uint8)
    for i in range(key.depth):
        flat = prf_blocks(seeds, dpf.ciphers, 3).reshape(seeds.shape[0], 48)
        cw_i = key.cw[i]
        cw_seed = np.frombuffer(cw_i[:16], dtype=np.uint8)
        t_mask = t_bits[:, None]
        s_l = flat[:, 0:16] ^ cw_seed[None, :] * t_mask
        s_r = flat[:, 17:33] ^ cw_seed[None, :] * t_mask
        t_l = (flat[:, 16] & 1) ^ (t_bits & cw_i[16])
        t_r = (flat[:, 33] & 1) ^ (t_bits & cw_i[17])
        seeds = np.stack([s_l, s_r], axis=1).reshape(-1, 16)
        t_bits = np.stack([t_l, t_r], axis=1).reshape(-1).astype(np.uint8)

    n_blk = key.leaf_bits // 128
    blocks = _leaf_blocks_wide(dpf, seeds, n_blk)  # (2^depth, 16*n_blk)
    fcw = np.frombuffer(key.final_cw_block, dtype=np.uint8)
    blocks = blocks ^ fcw[None, :] * t_bits[:, None]
    bits = np.unpackbits(blocks, axis=1, bitorder="little").reshape(-1)
    return bits[: key.height].astype(bool)


# --------------------------------------------------------------------------
# Multi-party (>= 3 server) keys
# --------------------------------------------------------------------------

@dataclass
class KeyMP:
    """Multi-party DPF key (dpf/common.go:37-42)."""

    num_parties: int
    cw: list[np.ndarray]  # p2 uint32 arrays of mu words
    sigma: list[bytes]  # one row of p2 16-byte seed slots per gamma


def _mp_params(num_bits: int, num_parties: int):
    """(p2, mu, gamma_bits, delta_bits), exactly as the eval derives them
    (dpf/server.go:119-124)."""
    p2 = 1 << (num_parties - 1)
    mu = int(math.ceil(math.pow(2, num_bits / 2) * math.pow(2, (num_parties - 1) / 2)))
    return p2, mu, (num_bits + 1) // 2, num_bits // 2


def generate_multi_server(dpf: Dpf, a: int, b: int, num_parties: int,
                          rand_bytes: RandBytes = os.urandom) -> list[KeyMP]:
    """p-party (>= 3) keygen for f(a) = b with XOR-output shares: the
    seed-sharing construction the multi-party eval implies.

    * Each row gamma has 2^(p-1) seed slots; parties holding a slot share
      its seed. Presence vectors v_j XOR to all-ones at gamma_a and to
      zero elsewhere, so expansions cancel except at the target row.
    * Correction words satisfy XOR_i CW_i = XOR_i G(s_{gamma_a, i}) ^
      b * e_{delta_a}.
    * 1-private: presence vectors are re-drawn per row until no single
      party holds every slot of any row, so each party's per-row view is
      the same for every row.
    """
    if num_parties < 3:
        raise ValueError("use generate_two_server for 2 parties")
    p2, mu, gamma_bits, delta_bits = _mp_params(dpf.num_bits, num_parties)
    n_gamma = 1 << gamma_bits
    gamma_a = (a >> delta_bits) & (n_gamma - 1)
    delta_a = a & ((1 << delta_bits) - 1)
    num_blocks = -(-dpf.m * mu // BLOCK_SIZE)

    seeds = np.frombuffer(rand_bytes(n_gamma * p2 * 16), dtype=np.uint8).reshape(
        n_gamma, p2, 16).copy()
    # avoid the eval's all-zero-seed skip (dpf/server.go:127-136)
    seeds[~seeds.any(axis=2), 0] = 1

    g_out = prf_blocks(seeds[gamma_a], dpf.ciphers, num_blocks)  # (p2, nbl, 16)
    g_words = g_out.reshape(p2, -1)[:, : dpf.m * mu].copy().view("<u4").reshape(p2, mu)

    cw = np.frombuffer(rand_bytes(p2 * mu * 4), dtype="<u4").reshape(p2, mu).copy()
    target = np.zeros(mu, dtype=np.uint32)
    target[delta_a] = np.uint32(b & 0xFFFFFFFF)
    acc = np.bitwise_xor.reduce(cw[:-1], axis=0)
    cw[-1] = acc ^ np.bitwise_xor.reduce(g_words, axis=0) ^ target

    def presence(k: int, rows: np.ndarray) -> np.ndarray:
        """(p, k, p2) presence bits for `rows`: p - 1 random vectors and
        the last one fixing the XOR (all-ones at gamma_a)."""
        v = np.frombuffer(rand_bytes(k * (num_parties - 1) * p2), dtype=np.uint8).reshape(
            num_parties - 1, k, p2) & 1
        last = np.bitwise_xor.reduce(v, axis=0)
        last[rows == gamma_a] ^= 1
        return np.concatenate([v, last[None]], axis=0)

    v = presence(n_gamma, np.arange(n_gamma))
    for _ in range(64):
        full = v.all(axis=2).any(axis=0)  # rows where some party holds every slot
        if not full.any():
            break
        rows = np.flatnonzero(full)
        v[:, full] = presence(len(rows), rows)
    else:  # pragma: no cover
        raise RuntimeError("presence-vector sampling failed to converge")

    cw_list = [cw[i] for i in range(p2)]
    return [KeyMP(num_parties, [c.copy() for c in cw_list],
                  [(seeds[g] * v[j, g][:, None]).tobytes() for g in range(n_gamma)])
            for j in range(num_parties)]


def evaluate_mp(dpf: Dpf, key: KeyMP, x: int) -> int:
    """Multi-party XOR-homomorphic eval at one point (dpf/server.go:110-144)."""
    p2, mu, gamma_bits, delta_bits = _mp_params(dpf.num_bits, key.num_parties)
    delta = x & ((1 << delta_bits) - 1)
    gamma = (x >> delta_bits) & ((1 << gamma_bits) - 1)
    num_blocks = -(-dpf.m * mu // BLOCK_SIZE)
    y = np.zeros(mu, dtype=np.uint32)
    for i in range(p2):
        s = key.sigma[gamma][i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE]
        if not any(s):
            continue  # zero-seed slots skip G and CW
        out = prf_blocks(np.frombuffer(s, dtype=np.uint8)[None, :], dpf.ciphers,
                         num_blocks)[0].reshape(-1)
        y ^= out[: dpf.m * mu].view("<u4")[:mu]
        y ^= np.asarray(key.cw[i][:mu], dtype=np.uint32)
    return int(y[delta])


def eval_points_mp(dpf: Dpf, key: KeyMP, xs) -> np.ndarray:
    """``evaluate_mp`` at many points (the multi-party golden model),
    block-sparse: output word delta of a row's CTR-extended MMO stream
    depends only on its own 16-byte block b = delta // 4,
    AES_{k_{b%4}}(seed ^ LE64(b//4)) ^ (seed ^ LE64(b//4)), so only the
    (gamma, block) pairs the points address are computed. Returns
    (len(xs),) int64 values; the XOR bit share is ``y & 1``."""
    p2, mu, gamma_bits, delta_bits = _mp_params(dpf.num_bits, key.num_parties)
    xs = np.asarray(xs, dtype=np.int64)
    deltas = xs & ((1 << delta_bits) - 1)
    gammas = (xs >> delta_bits) & ((1 << gamma_bits) - 1)
    blocks = deltas >> 2  # u32 word delta lies in 16-byte block delta // 4

    num_blocks = -(-dpf.m * mu // BLOCK_SIZE)
    uniq, inv = np.unique(gammas * num_blocks + blocks, return_inverse=True)
    ug, ub = uniq // num_blocks, uniq % num_blocks

    sigma = np.frombuffer(b"".join(key.sigma), dtype=np.uint8).reshape(-1, p2, BLOCK_SIZE)
    seeds = sigma[ug]  # (m, p2, 16)
    present = seeds.any(axis=2)  # zero-seed slots skip G and CW (go:127-136)
    xin = seeds.copy()
    xin[:, :, :8] ^= (ub >> 2).astype("<u8").view(np.uint8).reshape(-1, 8)[:, None, :]
    flat_x = xin.reshape(-1, BLOCK_SIZE)
    flat_k = np.repeat(ub & 3, p2)  # fixed key of block b: ciphers[b % 4]
    out = np.empty_like(flat_x)
    for k in range(4):
        sel = flat_k == k
        if sel.any():
            out[sel] = dpf.ciphers[k].encrypt_blocks(flat_x[sel]) ^ flat_x[sel]
    words = np.ascontiguousarray(out).view("<u4").reshape(len(uniq), p2, 4)

    w_pt = words[inv, :, deltas & 3]  # (n, p2)
    cw_pt = np.stack([np.asarray(key.cw[i], dtype=np.uint32)[deltas] for i in range(p2)],
                     axis=1)
    y = np.bitwise_xor.reduce(np.where(present[inv], w_pt ^ cw_pt, np.uint32(0)), axis=1)
    return y.astype(np.int64)
