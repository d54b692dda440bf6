"""The Montgomery kernels' per-thread code, built for the host.

csrc/mont_host.cpp compiles csrc/mont.cuh (the product, the fixed-window
ladder, the table build and Straus's row product) with a host C++
compiler, and runs kernel 9's powmod and kernel 10's chunked scan and
merge once per thread of their grids, each thread's words interleaved
with the others' as the kernels keep them in global scratch. Its output
must equal CPython pow on tests/test_mont_tpu.py's moduli (61 to 2049
bits: the all-ones 511-bit modulus and m - 1 operands stress the carry
chains and the final subtraction), with per-row moduli of different word
counts, and row counts and chunk sizes that are not powers of two.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from pir_tpu_torch.crypto import mont

CSRC = Path(__file__).resolve().parent.parent / "pir_tpu_torch" / "csrc"
rng = random.Random(0xC0FFEE)


def _odd(bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


MODULI = [_odd(61), _odd(256), (1 << 255) - 19, (1 << 511) - 1, _odd(1024), _odd(2049)]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib = tmp_path_factory.mktemp("mont_host") / "libmont_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(lib),
                    str(CSRC / "mont_host.cpp")], check=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    powmod, scan = so.pir_mont_powmod_host, so.pir_mont_scan_host
    powmod.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    scan.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_uint, ctypes.c_void_p] + [ctypes.c_int] * 7
    powmod.restype = scan.restype = ctypes.c_int
    return powmod, scan


def _ptr(a):
    return a.ctypes.data


def _powmod(fn, bases, exps, mods, e_max):
    """Kernel 9's operands (per-row moduli word-major) through the host build."""
    b = len(bases)
    L = max(mont.words_for_modulus(m) for m in mods)
    ctxs = [mont.word_ctx(m, L) for m in mods]
    per_row = len(set(mods)) > 1
    base = mont.ints_to_words([x % m for x, m in zip(bases, mods)], L)
    e = mont.pack_exponents(exps, e_max)
    if per_row:
        n = np.ascontiguousarray(np.stack([c.n_words for c in ctxs]).T)
        n0 = np.array([c.n0inv for c in ctxs], np.uint32)
        r2 = np.stack([c.r2_words for c in ctxs])
    else:
        n, n0, r2 = ctxs[0].n_words, np.array([ctxs[0].n0inv], np.uint32), ctxs[0].r2_words
    out = np.zeros((b, L), np.uint32)
    assert fn(_ptr(base), _ptr(e), _ptr(out), _ptr(n), _ptr(n0), _ptr(r2), b, L, e.shape[1],
              e_max, mont.window_bits(e_max), int(per_row)) == 0
    return mont.words_to_ints(out)


@pytest.mark.parametrize("m", MODULI, ids=lambda m: f"{m.bit_length()}b")
@pytest.mark.parametrize("e_max", [24, 256])
def test_host_powmod_matches_pow(host, m, e_max):
    bases = [rng.randrange(m) for _ in range(6)] + [m - 1, 0, 1]
    exps = [rng.getrandbits(e_max) for _ in range(7)] + [(1 << e_max) - 1, 0]
    assert _powmod(host[0], bases, exps, [m] * len(bases), e_max) == [
        pow(b, e, m) for b, e in zip(bases, exps)]


def test_host_powmod_per_row_moduli(host):
    """Rows of moduli of 256 to 2049 bits in one batch (the CRT halves
    share a launch): the shorter ones padded with zero words."""
    mods = [MODULI[k] for k in (1, 5, 3, 2, 4, 5, 1)]
    bases = [rng.randrange(m) for m in mods[:-1]] + [mods[-1] - 1]
    exps = [rng.getrandbits(300) for _ in mods]
    assert _powmod(host[0], bases, exps, mods, 300) == [
        pow(b, e, m) for b, e, m in zip(bases, exps, mods)]


@pytest.mark.parametrize("h,w,rc,bits,e_max", [
    (1, 1, 1, 61, 24), (11, 3, 4, 511, 24), (7, 1, 7, 1024, 24), (33, 2, 5, 2049, 24),
    (9, 2, 2, 256, 256), (5, 3, 3, (1 << 255) - 19, 64),
])
def test_host_scan_matches_pow(host, h, w, rc, bits, e_max):
    m = bits if bits > 1 << 64 else ((1 << 511) - 1 if bits == 511 else _odd(bits))
    L = mont.words_for_modulus(m)
    c = mont.word_ctx(m)
    ebits = [rng.randrange(m) for _ in range(h - 1)] + [m - 1]
    vals = [rng.getrandbits(e_max) if rng.random() < 0.8 else 0 for _ in range(h * w)]
    vals[-1] = (1 << e_max) - 1
    b = mont.ints_to_words(ebits, L)
    e = mont.pack_exponents(vals, e_max).reshape(h, w, -1)
    out = np.zeros((w, L), np.uint32)
    assert host[1](_ptr(b), _ptr(e), _ptr(out), _ptr(c.n_words), c.n0inv, _ptr(c.r2_words), h,
                   w, L, e.shape[2], e_max, mont.window_bits(e_max), rc) == 0
    want = []
    for col in range(w):
        acc = 1
        for r in range(h):
            acc = acc * pow(ebits[r], vals[r * w + col], m) % m
        want.append(acc)
    assert mont.words_to_ints(out) == want


def test_host_build_refuses_bad_shapes(host):
    powmod, scan = host
    one = np.ones(4, np.uint32)
    out = np.zeros(4, np.uint32)
    # window of 2 bits, an exponent word short of e_max, no rows
    assert powmod(_ptr(one), _ptr(one), _ptr(out), _ptr(one), _ptr(one), _ptr(one),
                  1, 1, 1, 24, 2, 0) == 1
    assert powmod(_ptr(one), _ptr(one), _ptr(out), _ptr(one), _ptr(one), _ptr(one),
                  1, 1, 1, 40, 1, 0) == 1
    assert scan(_ptr(one), _ptr(one), _ptr(out), _ptr(one), 1, _ptr(one), 0, 1, 1, 1, 24, 1,
                1) == 1
