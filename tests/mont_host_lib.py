"""The host model of kernels 9 and 10 (csrc/mont_host.cpp), built with a
host C++ compiler and called on the kernels' operands, laid out as
crypto/mont.py's wrappers lay them out for the card."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from pir_tpu_torch.crypto import mont

CSRC = Path(__file__).resolve().parent.parent / "pir_tpu_torch" / "csrc"


def build(tmp_dir: Path) -> ctypes.CDLL:
    """libmont_host.so in tmp_dir (the test skips with no C++ compiler)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib = tmp_dir / "libmont_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(lib),
                    str(CSRC / "mont_host.cpp")], check=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    so.pir_mont_powmod_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    so.pir_mont_scan_host.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_uint]
                                      + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10
                                      + [ctypes.c_void_p])
    so.pir_mont_powmod_host.restype = so.pir_mont_scan_host.restype = ctypes.c_int
    return so


def _ptr(a):
    return a.ctypes.data


def _consts(mods, Lp):
    ctxs = [mont.word_ctx(m, Lp) for m in mods]
    return (np.ascontiguousarray(np.stack([c.n_words for c in ctxs])),
            np.array([c.n0inv for c in ctxs], np.uint32),
            np.ascontiguousarray(np.stack([c.r2_words for c in ctxs])),
            np.ascontiguousarray(np.stack([c.one_words for c in ctxs])))


def powmod(lib, bases, exps, mods, e_max, G, wbits, K=None):
    """Kernel 9 on the host: ([base^e mod m], Montgomery products run)."""
    L = max(mont.words_for_modulus(m) for m in mods)
    K = mont.lane_words(L, G) if K is None else K
    per_row = len(set(mods)) > 1
    n, n0, r2, one = _consts(mods if per_row else mods[:1], G * K)
    base = mont.ints_to_words([x % m for x, m in zip(bases, mods)], L)
    e = mont.pack_exponents(exps, e_max)
    out = np.zeros((len(bases), L), np.uint32)
    products = ctypes.c_longlong(0)
    rc = lib.pir_mont_powmod_host(_ptr(base), _ptr(e), _ptr(out), _ptr(n), _ptr(n0), _ptr(r2),
                                  _ptr(one), len(bases), L, e.shape[1], e_max, wbits, G, K,
                                  int(per_row), ctypes.byref(products))
    assert rc == 0
    return mont.words_to_ints(out), products.value


def scan(lib, ebits, vals, h, w, m, e_max, G, wbits, rc, horner):
    """Kernel 10 on the host: ([prod_r ebits[r]^vals[r w + col] mod m],
    Montgomery products run)."""
    L = mont.words_for_modulus(m)
    K = mont.lane_words(L, G)
    n, n0, r2, one = _consts([m], G * K)
    b = mont.ints_to_words(ebits, L)
    e = mont.pack_exponents(vals, e_max).reshape(h, w, -1)
    out = np.zeros((w, L), np.uint32)
    products = ctypes.c_longlong(0)
    assert lib.pir_mont_scan_host(_ptr(b), _ptr(e), _ptr(out), _ptr(n), int(n0[0]), _ptr(r2),
                                  _ptr(one), h, w, L, e.shape[2], e_max, wbits, G, K, rc,
                                  horner, ctypes.byref(products)) == 0
    return mont.words_to_ints(out), products.value


def pow_scan(ebits, vals, w, m):
    out = []
    for col in range(w):
        acc = 1
        for r, b in enumerate(ebits):
            acc = acc * pow(b, vals[r * w + col], m) % m
        out.append(acc)
    return out
