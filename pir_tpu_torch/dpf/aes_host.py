"""Host-side AES-128 for the DPF fixed-key PRG (counterpart of
``pir_tpu/dpf/aes_host.py``).

The PRG is Matyas–Meyer–Oseas over ``INIT_PRF_LEN`` fixed AES-128 keys:
``out_i = AES_{k_i}(x) ^ x``. Encryption here is a vectorised numpy
AES-128-ECB over whole batches of blocks (no third-party crypto
package); the key schedule is also computed here so the device code can
consume precomputed round keys.
"""

from __future__ import annotations

import numpy as np

INIT_PRF_LEN = 4
BLOCK_SIZE = 16

# FIPS-197 S-box.
SBOX = np.array([
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
    0xb0, 0x54, 0xbb, 0x16,
], dtype=np.uint8)

RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
                dtype=np.uint8)
RCON_B = bytes(RCON)
_SBOX_BYTES = bytes(SBOX)

# GF(2^8) doubling table and the ShiftRows byte permutation:
# new[r + 4c] = old[r + 4((c + r) % 4)] (byte i = row i % 4, column i // 4)
_XTIME = np.array([((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF
                   for x in range(256)], dtype=np.uint8)
_SHIFT_ROWS = np.array([(i % 4) + 4 * (((i // 4) + (i % 4)) % 4)
                        for i in range(16)], dtype=np.intp)


def key_schedule(key: bytes | np.ndarray) -> np.ndarray:
    """AES-128 key expansion -> (11, 16) uint8 round keys (FIPS-197 §5.2)."""
    kb = bytes(key) if not isinstance(key, np.ndarray) else key.tobytes()
    if len(kb) != 16:
        raise ValueError("AES-128 keys are 16 bytes")
    sbox = _SBOX_BYTES
    w = [kb[4 * i:4 * i + 4] for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = bytes((
                sbox[t[1]] ^ RCON_B[i // 4 - 1], sbox[t[2]], sbox[t[3]],
                sbox[t[0]],
            ))
        prev = w[i - 4]
        w.append(bytes((prev[0] ^ t[0], prev[1] ^ t[1], prev[2] ^ t[2],
                        prev[3] ^ t[3])))
    return np.frombuffer(b"".join(w), dtype=np.uint8).reshape(11, 16)


def key_schedule_batch(keys: np.ndarray) -> np.ndarray:
    """Vectorised AES-128 key expansion: (K, 16) uint8 -> (K, 11, 16)."""
    keys = np.asarray(keys, dtype=np.uint8)
    k = keys.shape[0]
    w = np.zeros((k, 44, 4), np.uint8)
    w[:, :4] = keys.reshape(k, 4, 4)
    for i in range(4, 44):
        t = w[:, i - 1]
        if i % 4 == 0:
            t = SBOX[np.roll(t, -1, axis=1)]
            t[:, 0] ^= RCON[i // 4 - 1]
        w[:, i] = w[:, i - 4] ^ t
    return w.reshape(k, 11, 16)


def aes_encrypt_blocks(blocks: np.ndarray, round_keys: np.ndarray) -> np.ndarray:
    """AES-128 encryption of (n, 16) uint8 blocks under (11, 16) round keys."""
    s = np.asarray(blocks, dtype=np.uint8) ^ round_keys[0]
    n = s.shape[0]
    for r in range(1, 11):
        s = SBOX[s][:, _SHIFT_ROWS]
        if r < 10:
            a = s.reshape(n, 4, 4)  # (block, column, row)
            total = a[:, :, 0] ^ a[:, :, 1] ^ a[:, :, 2] ^ a[:, :, 3]
            # MixColumns: b_r = a_r ^ total ^ xtime(a_r ^ a_{r+1})
            s = (a ^ total[:, :, None]
                 ^ _XTIME[a ^ np.roll(a, -1, axis=2)]).reshape(n, 16)
        s = s ^ round_keys[r]
    return s


class EcbCipher:
    """Batched AES-128-ECB encryption of many 16-byte blocks at once."""

    def __init__(self, key: bytes):
        self.key = bytes(key)
        self.round_keys = key_schedule(self.key)

    def encrypt_blocks(self, blocks: np.ndarray) -> np.ndarray:
        """(n, 16) uint8 -> (n, 16) uint8 of AES_k(block)."""
        return aes_encrypt_blocks(blocks.reshape(-1, 16), self.round_keys
                                  ).reshape(blocks.shape)


def prf_blocks(x: np.ndarray, ciphers: list[EcbCipher], num_blocks: int) -> np.ndarray:
    """Vectorised fixed-key MMO PRG.

    x: (n, 16) uint8 input blocks -> (n, num_blocks, 16) uint8 with
    out[:, i] = AES_{k_i}(x) ^ x for i < len(ciphers). Beyond that the
    PRG extends as out_i = AES_{k_{i mod K}}(x ^ ctr) ^ x ^ ctr with
    ctr = LE64(i // K), which for a single cipher is the wide-leaf CTR
    extension of fast mode. The blocks of one cipher encrypt together.
    """
    n = x.shape[0]
    k = len(ciphers)
    out = np.empty((n, num_blocks, 16), dtype=np.uint8)
    idx = np.arange(num_blocks)
    ctr = np.zeros((num_blocks, 16), dtype=np.uint8)  # zero for i < K
    ctr[:, :8] = (idx // k).astype("<u8").view(np.uint8).reshape(-1, 8)
    for c in range(min(k, num_blocks)):
        sel = idx[c::k]
        xi = x[:, None, :] ^ ctr[None, sel, :]
        out[:, sel] = ciphers[c].encrypt_blocks(xi) ^ xi
    return out
