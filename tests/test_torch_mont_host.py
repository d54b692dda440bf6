"""The Montgomery kernels' group product, built for the host.

csrc/mont_host.cpp runs csrc/mont.cuh's chains (kernel 9's modexp, kernel
10's tables, chunks and merge) on a host model of a group of G lanes in
lockstep, with the per-lane arithmetic the card runs between exchanges
and every shuffle and ballot as an array read. Its output must equal
CPython pow at every G on tests/test_mont_tpu.py's moduli (61 to 2049
bits: the all-ones 511-bit modulus and m - 1 operands stress the carry
chains and the final subtraction), with per-row moduli of different word
counts, word counts that are not a multiple of G, zero and all-ones
exponents, e_max not a multiple of the window, and row counts and chunk
sizes that are not powers of two, in Straus and Horner chunks; and it
must run the Montgomery products crypto/mont.py's planners count.
"""

import random

import numpy as np
import pytest

from pir_tpu_torch.crypto import mont

import mont_host_lib as hl

rng = random.Random(0xC0FFEE)


def _odd(bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


MODULI = [_odd(61), _odd(256), (1 << 255) - 19, (1 << 511) - 1, _odd(1024), _odd(2049)]
GS = [4, 8, 16, 32]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return hl.build(tmp_path_factory.mktemp("mont_host"))


def _powmod_products(e_max, wbits, rows):
    nwin = -(-e_max // wbits)
    return rows * ((1 << wbits) - 1 + (nwin - 1) * (wbits + 1) + 1)


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("m", MODULI, ids=lambda m: f"{m.bit_length()}b")
@pytest.mark.parametrize("e_max,wbits", [(24, 5), (256, 3)])
def test_host_powmod_matches_pow(host, m, e_max, wbits, G):
    bases = [rng.randrange(m) for _ in range(6)] + [m - 1, 0, 1]
    exps = [rng.getrandbits(e_max) for _ in range(6)] + [(1 << e_max) - 1, 0, 0]
    got, products = hl.powmod(host, bases, exps, [m] * len(bases), e_max, G, wbits)
    assert got == [pow(b, e, m) for b, e in zip(bases, exps)]
    assert products == _powmod_products(e_max, wbits, len(bases))


@pytest.mark.parametrize("G", GS)
def test_host_powmod_per_row_moduli(host, G):
    """Rows of moduli of 256 to 2049 bits in one batch (the CRT halves
    share a launch): the shorter ones padded with zero words."""
    mods = [MODULI[k] for k in (1, 5, 3, 2, 4, 5, 1)]
    bases = [rng.randrange(m) for m in mods[:-1]] + [mods[-1] - 1]
    exps = [rng.getrandbits(300) for _ in mods]
    got, _ = hl.powmod(host, bases, exps, mods, 300, G, 4)
    assert got == [pow(b, e, m) for b, e, m in zip(bases, exps, mods)]


@pytest.mark.parametrize("horner", [0, 1])
@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("h,w,rc,bits,e_max,wbits", [
    (1, 1, 1, 61, 24, 5), (11, 3, 4, 511, 24, 3), (7, 1, 7, 1024, 24, 6),
    (33, 2, 5, 2049, 24, 4), (9, 2, 2, 256, 256, 3), (5, 3, 3, (1 << 255) - 19, 64, 5),
])
def test_host_scan_matches_pow(host, h, w, rc, bits, e_max, wbits, G, horner):
    m = bits if bits > 1 << 64 else ((1 << 511) - 1 if bits == 511 else _odd(bits))
    ebits = [rng.randrange(m) for _ in range(h - 1)] + [m - 1]
    vals = [rng.getrandbits(e_max) if rng.random() < 0.8 else 0 for _ in range(h * w)]
    vals[-1] = (1 << e_max) - 1
    got, products = hl.scan(host, ebits, vals, h, w, m, e_max, G, wbits, rc, horner)
    assert got == hl.pow_scan(ebits, vals, w, m)
    plan = {"wbits": wbits, "chunks": -(-h // rc), "horner": horner}
    assert products == mont.scan_products(plan, h, w, e_max)


def test_host_build_refuses_bad_shapes(host):
    one = np.ones(96, np.uint32)
    out = np.zeros(96, np.uint32)
    p = [hl._ptr(one)] * 2 + [hl._ptr(out)] + [hl._ptr(one)] * 4
    n = np.zeros(1, np.int64)
    # G of 2 lanes, no instance of 5 words a lane, more words than G K,
    # window of 9 bits, an exponent word short of e_max, no rows
    for G, K, Lw, wbits, e_max, b in ((2, 1, 1, 3, 24, 1), (4, 5, 4, 3, 24, 1),
                                      (4, 1, 5, 3, 24, 1), (4, 1, 4, 9, 24, 1),
                                      (4, 1, 4, 3, 40, 1), (4, 1, 4, 3, 24, 0)):
        assert host.pir_mont_powmod_host(*p, b, Lw, 1, e_max, wbits, G, K, 0,
                                         n.ctypes.data) == 1
    assert host.pir_mont_scan_host(p[0], p[1], p[2], p[3], 1, p[5], p[6], 0, 1, 4, 1, 24, 3,
                                   4, 1, 1, 0, n.ctypes.data) == 1
