"""The benchmark's own two-party DPF: AES-128, the fixed-key MMO PRG, the
clients' batch keygen and the servers' full-domain evaluation, for fast
(early-termination) keys and reference-exact ("compat") keys.

A frozen copy of the semantics of the Go library's DPF (dpf/client.go,
dpf/server.go) and of its fast-key extension, written in plain PyTorch
so that it runs on the card as well as on the CPU. It imports nothing of
the system under test: the keygen makes the inputs that both the system
and the reference get, and the evaluation is the reference's half of the
comparison that decides ``correct``.

Tensors of bytes are uint8; a key's correction words are (Q, levels, 18)
rows of a 16-byte seed correction and the two t bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 16

# FIPS-197 S-box
SBOX = bytes.fromhex(
    "637c777bf26b6fc53001672bfed7ab76ca82c97dfa5947f0add4a2af9ca472c0"
    "b7fd9326363ff7cc34a5e5f171d8311504c723c31896059a071280e2eb27b275"
    "09832c1a1b6e5aa0523bd6b329e32f8453d100ed20fcb15b6acbbe394a4c58cf"
    "d0efaafb434d338545f9027f503c9fa851a3408f929d38f5bcb6da2110fff3d2"
    "cd0c13ec5f974417c4a77e3d645d197360814fdc222a908846eeb814de5e0bdb"
    "e0323a0a4906245cc2d3ac629195e479e7c8376d8dd54ea96c56f4ea657aae08"
    "ba78252e1ca6b4c6e8dd741f4bbd8b8a703eb5664803f60e613557b986c11d9e"
    "e1f8981169d98e949b1e87e9ce5528df8ca1890dbfe6426841992d0fb054bb16")
RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)
XTIME = bytes(((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF for x in range(256))
# ShiftRows: new byte r + 4c = old byte r + 4((c + r) % 4)
SHIFT_ROWS = tuple((i % 4) + 4 * (((i // 4) + (i % 4)) % 4) for i in range(16))
# AES calls are cut into pieces of this many blocks (bounds the temporaries)
AES_CHUNK = 1 << 21

_tables: dict = {}


def _consts(device: torch.device):
    """(S-box, xtime, ShiftRows index) tensors on `device`, cached."""
    key = str(device)
    if key not in _tables:
        _tables[key] = (
            torch.tensor(list(SBOX), dtype=torch.uint8, device=device),
            torch.tensor(list(XTIME), dtype=torch.uint8, device=device),
            torch.tensor(SHIFT_ROWS, dtype=torch.long, device=device),
        )
    return _tables[key]


def key_schedule(key: bytes) -> np.ndarray:
    """AES-128 key expansion (FIPS-197 5.2) -> (11, 16) uint8 round keys."""
    if len(key) != 16:
        raise ValueError("AES-128 keys are 16 bytes")
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [SBOX[t[1]] ^ RCON[i // 4 - 1], SBOX[t[2]], SBOX[t[3]], SBOX[t[0]]]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return np.array(w, dtype=np.uint8).reshape(11, 16)


def round_keys(prf_keys, device) -> list[torch.Tensor]:
    """The (11, 16) round keys of each 16-byte PRF key, on `device`."""
    return [torch.from_numpy(key_schedule(bytes(k))).to(device) for k in prf_keys]


def _aes(s: torch.Tensor, rk: torch.Tensor) -> torch.Tensor:
    sbox, xtime, shift = _consts(s.device)
    n = s.shape[0]
    s = s ^ rk[0]
    for r in range(1, 11):
        s = sbox[s[:, shift].long()]
        if r < 10:
            a = s.view(n, 4, 4)  # (block, column, row)
            total = a[:, :, 0] ^ a[:, :, 1] ^ a[:, :, 2] ^ a[:, :, 3]
            # MixColumns: b_r = a_r ^ total ^ xtime(a_r ^ a_{r+1})
            s = (a ^ total[:, :, None] ^ xtime[(a ^ a.roll(-1, dims=2)).long()]).reshape(n, 16)
        s = s ^ rk[r]
    return s


def aes_encrypt(blocks: torch.Tensor, rk: torch.Tensor) -> torch.Tensor:
    """AES-128 encryption of (n, 16) uint8 blocks under (11, 16) round keys."""
    if blocks.shape[0] <= AES_CHUNK:
        return _aes(blocks, rk)
    return torch.cat([_aes(blocks[i:i + AES_CHUNK], rk)
                      for i in range(0, blocks.shape[0], AES_CHUNK)])


def prg(x: torch.Tensor, rks: list[torch.Tensor], num_blocks: int) -> torch.Tensor:
    """Fixed-key MMO PRG: (n, 16) -> (n, num_blocks, 16), block i =
    AES_{k_{i mod K}}(x ^ c) ^ x ^ c with c = LE64(i // K) in the first 8
    bytes (c is 0 for the first K blocks)."""
    k = len(rks)
    out = torch.empty((x.shape[0], num_blocks, BLOCK), dtype=torch.uint8, device=x.device)
    for i in range(num_blocks):
        xi = x
        if i // k:
            ctr = torch.zeros(BLOCK, dtype=torch.uint8, device=x.device)
            ctr[:8] = torch.from_numpy(
                np.frombuffer(np.uint64(i // k).astype("<u8").tobytes(), np.uint8).copy())
            xi = x ^ ctr
        out[:, i] = aes_encrypt(xi, rks[i % k]) ^ xi
    return out


def go_varint(b: torch.Tensor) -> torch.Tensor:
    """Go encoding/binary.Varint of each row of (..., 8) uint8 -> int64:
    the zigzag-decoded signed varint, 0 when no byte ends it."""
    b = b.long()
    is_term = b < 0x80
    has_term = is_term.any(dim=-1)
    first = torch.argmax(is_term.to(torch.uint8), dim=-1, keepdim=True)
    j = torch.arange(8, device=b.device)
    contrib = (b & 0x7F) << (7 * j)
    ux = torch.where(j <= first, contrib, torch.zeros_like(contrib)).sum(dim=-1)
    ux = torch.where(has_term, ux, torch.zeros_like(ux))
    val = ux >> 1
    return torch.where((ux & 1) == 1, -(val + 1), val)


def _children(out: torch.Tensor, t: torch.Tensor, cw: torch.Tensor):
    """One level of the walk: PRG outputs (Q, m, 48), t bits (Q, m) and
    the level's correction words (Q, 18) -> (s_l, t_l, s_r, t_r)."""
    t_mask = t[..., None]
    cw_seed = cw[:, None, :16]
    s_l = out[..., 0:16] ^ cw_seed * t_mask
    s_r = out[..., 17:33] ^ cw_seed * t_mask
    t_l = (out[..., 16] & 1) ^ (t & cw[:, None, 16])
    t_r = (out[..., 33] & 1) ^ (t & cw[:, None, 17])
    return s_l, t_l, s_r, t_r


def _walk(rks, s_init, t_init, cw, levels: int, keep=None):
    """Breadth-first walk of Q trees in natural leaf order: (Q, 16) seeds,
    (Q,) t bits, (Q, L, 18) correction words -> (Q, m, 16), (Q, m) at
    `levels` down; keep(i) caps the nodes kept below level i."""
    q = s_init.shape[0]
    seeds, t = s_init[:, None, :], t_init[:, None]
    for i in range(levels):
        m = seeds.shape[1]
        out = prg(seeds.reshape(-1, BLOCK), rks, 3).view(q, m, 48)
        s_l, t_l, s_r, t_r = _children(out, t, cw[:, i])
        seeds = torch.stack([s_l, s_r], dim=2).reshape(q, 2 * m, BLOCK)
        t = torch.stack([t_l, t_r], dim=2).reshape(q, 2 * m)
        if keep is not None:
            n = keep(i)
            seeds, t = seeds[:, :n], t[:, :n]
    return seeds, t


def unpack_bits(b: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 -> (..., 8n) uint8 bits, little-endian in each byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=b.device)
    return ((b[..., None] >> shifts) & 1).reshape(*b.shape[:-1], b.shape[-1] * 8)


# ---------------------------------------------------------------- fast keys

def fast_depth(height: int, leaf_bits: int) -> int:
    """Tree depth of a fast key over [0, height) with leaf_bits-wide leaves."""
    leaves = -(-height // leaf_bits)
    return max(0, (leaves - 1).bit_length())


def fast_keygen(rks, indices: np.ndarray, height: int, leaf_bits: int, rnd: np.ndarray,
                device) -> dict:
    """Fast-key batch keygen for f(a) = 1 at each index (one tree walk for
    the batch, the keys sharing the PRF keys of `rks`). rnd: (Q, 33) uint8
    randomness (two seeds and the t bit). Returns numpy arrays: s0, s1
    (Q, 16), t0, t1 (Q,), cw (Q, depth, 18), fcw (Q, leaf_bits / 8)."""
    n_blk = leaf_bits // 128
    depth = fast_depth(height, leaf_bits)
    idx = torch.from_numpy(np.asarray(indices, np.int64)).to(device)
    leaf = idx // leaf_bits
    r = torch.from_numpy(np.array(rnd, dtype=np.uint8)).to(device)
    s0, s1 = r[:, :16].clone(), r[:, 16:32].clone()
    t0 = r[:, 32] & 1
    t1 = t0 ^ 1
    q = len(indices)
    cur = [s0, s1]
    tc = [t0.clone(), t1.clone()]
    cw = torch.zeros((q, depth, 18), dtype=torch.uint8, device=device)
    for i in range(depth):
        o0 = prg(cur[0], rks, 3).view(q, 48)
        o1 = prg(cur[1], rks, 3).view(q, 48)
        a = ((leaf >> (depth - 1 - i)) & 1).to(torch.uint8)
        right = (a == 1)[:, None]
        keep0 = torch.where(right, o0[:, 17:33], o0[:, 0:16])
        keep1 = torch.where(right, o1[:, 17:33], o1[:, 0:16])
        lose0 = torch.where(right, o0[:, 0:16], o0[:, 17:33])
        lose1 = torch.where(right, o1[:, 0:16], o1[:, 17:33])
        cw_seed = lose0 ^ lose1
        cw_tl = (o0[:, 16] & 1) ^ (o1[:, 16] & 1) ^ a ^ 1
        cw_tr = (o0[:, 33] & 1) ^ (o1[:, 33] & 1) ^ a
        cw[:, i, :16], cw[:, i, 16], cw[:, i, 17] = cw_seed, cw_tl, cw_tr
        t_keep = torch.where(a == 1, cw_tr, cw_tl)
        kt0 = torch.where(a == 1, o0[:, 33], o0[:, 16]) & 1
        kt1 = torch.where(a == 1, o1[:, 33], o1[:, 16]) & 1
        cur = [keep0 ^ cw_seed * tc[0][:, None], keep1 ^ cw_seed * tc[1][:, None]]
        tc = [kt0 ^ (t_keep * tc[0]), kt1 ^ (t_keep * tc[1])]
    blk0 = prg(cur[0], [rks[3]], n_blk).view(q, 16 * n_blk)
    blk1 = prg(cur[1], [rks[3]], n_blk).view(q, 16 * n_blk)
    within = idx % leaf_bits
    e_a = torch.zeros((q, 16 * n_blk), dtype=torch.uint8, device=device)
    e_a[torch.arange(q, device=device), within >> 3] = (1 << (within & 7)).to(torch.uint8)
    fcw = blk0 ^ blk1 ^ e_a
    host = lambda x: x.cpu().numpy()  # noqa: E731
    return {"s0": host(s0), "s1": host(s1), "t0": host(t0), "t1": host(t1),
            "cw": host(cw), "fcw": host(fcw)}


def fast_bits(rks, s_init, t_init, cw, fcw, height: int) -> torch.Tensor:
    """Full-domain evaluation of Q fast-key shares (sharing the PRF keys of
    `rks`): (Q, height) uint8 selection bits, natural row order."""
    q, depth = cw.shape[0], cw.shape[1]
    n_blk = fcw.shape[1] // 16
    seeds, t = _walk(rks, s_init, t_init, cw, depth)
    m = seeds.shape[1]
    blocks = prg(seeds.reshape(-1, BLOCK), [rks[3]], n_blk).view(q, m, 16 * n_blk)
    blocks = blocks ^ fcw[:, None, :] * t[..., None]
    return unpack_bits(blocks.reshape(q, -1))[:, :height]


# -------------------------------------------------------------- compat keys

def num_bits_for_height(height: int) -> int:
    """The Go library's DPF domain: uint(log2(h) + 1) (query.go:61), so a
    power-of-two height has a dead right half."""
    return int(math.log2(height) + 1)


def compat_keygen(rks, points: np.ndarray, num_bits: int, rnd: np.ndarray, device,
                  b: int = 1) -> dict:
    """Reference-exact batch keygen for f(a) = b at each point
    (dpf/client.go:56-150, one walk for the batch, the keys sharing the
    PRF keys of `rks`). Returns numpy arrays: s0, s1 (Q, 16), t0, t1 (Q,),
    cw (Q, num_bits, 18), final_cw (Q,) int64."""
    pts = torch.from_numpy(np.asarray(points, np.int64)).to(device)
    r = torch.from_numpy(np.array(rnd, dtype=np.uint8)).to(device)
    s0, s1 = r[:, :16].clone(), r[:, 16:32].clone()
    t0 = r[:, 32] & 1
    t1 = t0 ^ 1
    q = len(points)
    cur = [s0, s1]
    tc = [t0.clone(), t1.clone()]
    cw = torch.zeros((q, num_bits, 18), dtype=torch.uint8, device=device)
    for i in range(num_bits):
        o0 = prg(cur[0], rks, 3).view(q, 48)
        o1 = prg(cur[1], rks, 3).view(q, 48)
        a = ((pts >> (num_bits - 1 - i)) & 1).to(torch.uint8)
        right = (a == 1)[:, None]
        cw_seed = (torch.where(right, o0[:, 0:16], o0[:, 17:33])
                   ^ torch.where(right, o1[:, 0:16], o1[:, 17:33]))
        cw_tl = (o0[:, 16] & 1) ^ (o1[:, 16] & 1) ^ a ^ 1
        cw_tr = (o0[:, 33] & 1) ^ (o1[:, 33] & 1) ^ a
        cw[:, i, :16], cw[:, i, 16], cw[:, i, 17] = cw_seed, cw_tl, cw_tr
        t_keep = torch.where(a == 1, cw_tr, cw_tl)
        new = []
        for o, s_t in zip((o0, o1), tc):
            new.append((torch.where(right, o[:, 17:33], o[:, 0:16]) ^ cw_seed * s_t[:, None],
                        (torch.where(a == 1, o[:, 33], o[:, 16]) & 1) ^ (t_keep * s_t)))
        cur = [n[0] for n in new]
        tc = [n[1] for n in new]
    final_cw = b - go_varint(cur[0][:, :8]) + go_varint(cur[1][:, :8])
    final_cw = torch.where(tc[1] == 1, -final_cw, final_cw)
    host = lambda x: x.cpu().numpy()  # noqa: E731
    return {"s0": host(s0), "s1": host(s1), "t0": host(t0), "t1": host(t1),
            "cw": host(cw), "final_cw": host(final_cw)}


def compat_values(rks, server: int, s_init, t_init, cw, final_cw,
                  height: int) -> torch.Tensor:
    """Values of Q reference-exact shares at the points [0, height), natural
    order (dpf/server.go:55-101 at every point; the walk keeps only the
    nodes above those points): (Q, height) int64."""
    nb = cw.shape[1]
    seeds, t = _walk(rks, s_init, t_init, cw, nb,
                     keep=lambda i: -(-height // (1 << (nb - i - 1))))
    res = go_varint(seeds[..., :8]) + t.long() * final_cw[:, None]
    return res if server == 0 else -res


def compat_bits(rks, server: int, s_init, t_init, cw, final_cw, height: int) -> torch.Tensor:
    """Selection bits of Q reference-exact shares: value % 2 == 0
    (db.go:140-146), (Q, height) uint8."""
    return ((compat_values(rks, server, s_init, t_init, cw, final_cw, height) & 1) == 0
            ).to(torch.uint8)
