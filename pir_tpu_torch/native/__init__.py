"""The native C++ host engine (counterpart of ``pir_tpu/native``): AES-NI
full-domain, fast and point DPF expansions and the masked-XOR scans
(``pir_native.cpp``), and threaded Montgomery modexps and the AHE scan of
single-server cPIR (``bigmod.cpp``), through ``ctypes``.

The sources are the port's own copies. ``_build.build_host`` compiles each
with the host C++ compiler at first use, with pir_tpu's flags, into
``_build/`` under a hash of source and flags (never beside the sources,
as pir_tpu does); a failed build raises with the compiler's log, and
nothing falls back to numpy. It runs on the host only: the callers that
name it are ``server.NativePirServer``, ``PirConfig(engine="native")``,
``encrypted.scan_engine("native")`` and ``crypto.paillier``'s native
modexp route (``paillier_engine="native"``, ``paillier.native_modexp()``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

_VP = ctypes.c_void_p
_typed: set[str] = set()  # the libraries whose argument types are set


def load():
    """The DPF/scan library, built at first use, its argument types set."""
    lib = _build.load_host("pirnative")
    if "pirnative" not in _typed:
        lib.pir_expand_bits.argtypes = [
            _VP, ctypes.c_uint32, _VP, ctypes.c_uint8, _VP, ctypes.c_int64, ctypes.c_uint64, _VP,
        ]
        lib.pir_eval_point_bits.argtypes = [
            _VP, ctypes.c_uint32, _VP, ctypes.c_uint8, _VP, ctypes.c_int64, _VP,
            ctypes.c_uint64, _VP,
        ]
        lib.pir_expand_fast_bits.argtypes = [
            _VP, ctypes.c_uint32, _VP, ctypes.c_uint8, _VP, _VP, ctypes.c_uint64,
            ctypes.c_uint32, _VP,
        ]
        lib.pir_scan_xor.argtypes = [_VP, ctypes.c_uint64, ctypes.c_uint64, _VP, _VP]
        lib.pir_scan_xor_batch.argtypes = [
            _VP, ctypes.c_uint64, ctypes.c_uint64, _VP, ctypes.c_uint64, _VP,
        ]
        _typed.add("pirnative")
    return lib


def available() -> bool:
    """True when the DPF/scan library builds and loads here."""
    try:
        return load() is not None
    except Exception:
        return False


def load_bigmod():
    """The Montgomery modexp library (the Paillier hot path), built at
    first use, its argument types set."""
    lib = _build.load_host("bigmod")
    if "bigmod" not in _typed:
        lib.mg_powmod.argtypes = [_VP, _VP, ctypes.c_size_t, _VP, ctypes.c_size_t, _VP]
        lib.mg_powmod_batch.argtypes = [
            _VP, _VP, ctypes.c_size_t, _VP, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_int, _VP,
        ]
        lib.paillier_scan.argtypes = [
            _VP, ctypes.c_size_t, _VP, ctypes.c_size_t, ctypes.c_size_t, _VP,
            ctypes.c_size_t, ctypes.c_int, _VP,
        ]
        _typed.add("bigmod")
    return lib


def bigmod_available() -> bool:
    """True when the Montgomery library builds and loads here."""
    try:
        return load_bigmod() is not None
    except Exception:
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_VP)


def _ints_to_limbs(vals, limbs: int) -> np.ndarray:
    """list[int] -> contiguous little-endian u64 limb matrix."""
    w = limbs * 8
    buf = bytearray(len(vals) * w)
    for i, v in enumerate(vals):
        buf[i * w:i * w + w] = v.to_bytes(w, "little")
    return np.frombuffer(bytes(buf), dtype=np.uint64)


def _limbs_to_ints(arr: np.ndarray, limbs: int) -> list[int]:
    raw = arr.tobytes()
    w = limbs * 8
    return [int.from_bytes(raw[i:i + w], "little") for i in range(0, len(raw), w)]


def _check_modulus(mod: int) -> None:
    # the library's Montgomery arithmetic needs an odd modulus
    if mod < 3 or not mod & 1:
        raise ValueError("the native modexp takes an odd modulus > 1")


def powmod(base: int, exp: int, mod: int) -> int:
    """base^exp mod mod (odd mod, exp >= 0) on the native Montgomery engine."""
    _check_modulus(mod)
    lib = load_bigmod()
    n = (mod.bit_length() + 63) // 64
    exp_n = max(1, (exp.bit_length() + 63) // 64)
    b = _ints_to_limbs([base % mod], n)
    e = _ints_to_limbs([exp], exp_n)
    m = _ints_to_limbs([mod], n)
    out = np.zeros(n, dtype=np.uint64)
    lib.mg_powmod(_ptr(b), _ptr(e), exp_n, _ptr(m), n, _ptr(out))
    return int.from_bytes(out.tobytes(), "little")


def powmod_batch(bases, exps, mod: int, common_base: bool = False,
                 nthreads: int = 0) -> list[int]:
    """out[i] = bases[i]^exps[i] mod mod (odd mod), threaded across cores
    (nthreads <= 0: all of them). common_base=True: `bases` is ONE int whose
    window table the whole batch shares (the DDLEQ ct^e_i pattern)."""
    _check_modulus(mod)
    lib = load_bigmod()
    n = (mod.bit_length() + 63) // 64
    count = len(exps)
    exp_n = max(1, (max((e.bit_length() for e in exps), default=1) + 63) // 64)
    b = _ints_to_limbs([bases % mod] if common_base else [v % mod for v in bases], n)
    e = _ints_to_limbs(exps, exp_n)
    m = _ints_to_limbs([mod], n)
    out = np.zeros(count * n, dtype=np.uint64)
    lib.mg_powmod_batch(_ptr(b), _ptr(e), exp_n, _ptr(m), n, count, int(common_base),
                        nthreads, _ptr(out))
    return _limbs_to_ints(out, n)


def paillier_scan(ebits: list[int], vals: list[int], width_cts: int, mod: int,
                  nthreads: int = 0) -> list[int]:
    """out[j] = prod_row ebits[row]^vals[row*width_cts+j] mod mod: the AHE
    scan (db.go:193-261), rows split over `nthreads` threads (<= 0: all
    cores) with a merge of partial products. `vals` is the flattened
    (height, width_cts) exponent matrix; exponent 0 contributes the
    identity (the reference's out-of-range `continue`)."""
    _check_modulus(mod)
    lib = load_bigmod()
    height = len(ebits)
    if len(vals) != height * width_cts:
        raise ValueError("vals must hold height * width_cts exponents")
    n = (mod.bit_length() + 63) // 64
    exp_n = max(1, (max((v.bit_length() for v in vals), default=1) + 63) // 64)
    eb = _ints_to_limbs([v % mod for v in ebits], n)
    vl = _ints_to_limbs(vals, exp_n)
    m = _ints_to_limbs([mod], n)
    out = np.zeros(width_cts * n, dtype=np.uint64)
    lib.paillier_scan(_ptr(eb), height, _ptr(vl), exp_n, width_cts, _ptr(m), n, nthreads,
                      _ptr(out))
    return _limbs_to_ints(out, n)


def _key_blobs(query_share, key, levels: int, prf_keys: int) -> tuple[bytes, bytes]:
    """(PRF key blob, correction-word blob) of a share, its lengths checked
    against what the C walk reads: `prf_keys` 16-byte keys, a 16-byte
    seed and `levels` 18-byte correction words."""
    prf = b"".join(bytes(k.bytes) for k in query_share.prf_keys)
    cws = [bytes(c) for c in key.cw]
    if (len(prf) < 16 * prf_keys or len(key.s_init) != 16 or len(cws) < levels
            or any(len(c) != 18 for c in cws)):
        raise ValueError("key material does not match the walk's geometry")
    return prf, b"".join(cws)


def expand_bits(query_share, num_bits: int, height: int) -> np.ndarray:
    """Full-domain expansion of a reference-exact share -> (height,) uint8
    selection bits, height <= 2^num_bits."""
    if not 0 <= height <= 1 << num_bits:
        raise ValueError("height exceeds the key's domain")
    lib = load()
    key = query_share.key_two_party
    prf, cw = _key_blobs(query_share, key, num_bits, 3)
    out = np.empty(height, dtype=np.uint8)
    lib.pir_expand_bits(prf, num_bits, key.s_init, key.t_init, cw, key.final_cw, height,
                        _ptr(out))
    return out


def eval_point_bits(query_share, num_bits: int, points: np.ndarray) -> np.ndarray:
    """A reference-exact share evaluated at `points` -> (len,) uint8 bits."""
    lib = load()
    key = query_share.key_two_party
    prf, cw = _key_blobs(query_share, key, num_bits, 3)
    pts = np.ascontiguousarray(points, dtype=np.uint64)
    out = np.empty(len(pts), dtype=np.uint8)
    lib.pir_eval_point_bits(prf, num_bits, key.s_init, key.t_init, cw, key.final_cw,
                            _ptr(pts), len(pts), _ptr(out))
    return out


def expand_fast_bits(query_share) -> np.ndarray:
    """Early-termination expansion of a fast share -> (height,) uint8 bits."""
    lib = load()
    key = query_share.key_fast
    prf, cw = _key_blobs(query_share, key, key.depth, 4)
    n_blk = len(key.final_cw_block) // 16
    if not n_blk or len(key.final_cw_block) % 16 or key.height > (128 * n_blk) << key.depth:
        raise ValueError("fast key geometry does not cover its height")
    out = np.empty(key.height, dtype=np.uint8)
    lib.pir_expand_fast_bits(prf, key.depth, key.s_init, key.t_init, cw, key.final_cw_block,
                             key.height, n_blk, _ptr(out))
    return out


def scan_xor(db_rows: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """db_rows (H, row_bytes) uint8, bits (H,) uint8 -> (row_bytes,) uint8."""
    lib = load()
    db_rows = np.ascontiguousarray(db_rows)
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if bits.shape != (db_rows.shape[0],):
        raise ValueError("one selection bit a row")
    out = np.empty(db_rows.shape[1], dtype=np.uint8)
    lib.pir_scan_xor(_ptr(db_rows), db_rows.shape[0], db_rows.shape[1], _ptr(bits), _ptr(out))
    return out


def scan_xor_batch(db_rows: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """db_rows (H, row_bytes) u8, bits (Q, H) u8 -> (Q, row_bytes) u8: one
    cache-blocked pass over the table answers all Q queries."""
    lib = load()
    db_rows = np.ascontiguousarray(db_rows)
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if bits.ndim != 2 or bits.shape[1] != db_rows.shape[0]:
        raise ValueError("one selection bit a row for each query")
    out = np.empty((bits.shape[0], db_rows.shape[1]), dtype=np.uint8)
    lib.pir_scan_xor_batch(_ptr(db_rows), db_rows.shape[0], db_rows.shape[1], _ptr(bits),
                           bits.shape[0], _ptr(out))
    return out
