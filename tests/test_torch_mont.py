"""pir_tpu_torch.crypto.mont (the device Montgomery engine) against
pir_tpu.crypto.mont_tpu, on the CPU.

The port's packing and constants equal pir_tpu's, error cases included;
its plain version (pir_tpu's radix-2^15 arithmetic in int64 torch
tensors) equals pir_tpu's ``mont_mul``, ladders, tree product and scan
chunk limb for limb on test_mont_tpu.py's moduli (61 to 2049 bits); and
``device_powmod_batch``, ``device_powmod_batch_multi`` and
``device_paillier_scan`` with ``device="cpu"`` equal ``tpu_powmod_batch``,
``tpu_powmod_batch_multi`` and ``tpu_paillier_scan`` on JAX's CPU backend
and CPython ``pow``. Exact integers, no tolerance. The kernels run in
tests/test_torch_cuda.py (on the card) and tests/test_torch_mont_host.py
(mont.cuh built by g++).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pir_tpu.crypto import mont_tpu as jm
from pir_tpu_torch.crypto import mont as tm

from torch_threads import one_torch_thread  # noqa: F401

rng = random.Random(0xC0FFEE)


def _odd(bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


# tests/test_mont_tpu.py's moduli
MODULI = [_odd(61), _odd(256), (1 << 255) - 19, (1 << 511) - 1, _odd(1024), _odd(2049)]


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _pow_scan(ebits, vals, width, m):
    out = []
    for w in range(width):
        acc = 1
        for r, b in enumerate(ebits):
            acc = acc * pow(b, vals[r * width + w], m) % m
        out.append(acc)
    return out


def test_packing_equals_pir_tpu():
    xs = [0, 1, tm.MASK, 1 << tm.RADIX, rng.getrandbits(300)]
    L = (300 + tm.RADIX) // tm.RADIX + 1
    assert np.array_equal(tm.ints_to_limbs(xs, L), jm.ints_to_limbs(xs, L))
    assert [tm.limbs_to_int(a) for a in tm.ints_to_limbs(xs, L)] == xs
    for e_max in (24, 48, 64, 200):
        es = [0, 1, (1 << e_max) - 1, rng.getrandbits(e_max)]
        assert np.array_equal(tm.pack_exponents(es, e_max), jm.pack_exponents(es, e_max))
    assert tm.pack_exponents([(1 << 48) - 1], 48).shape == (1, 2)
    assert [tm.limbs_for_modulus(m) for m in MODULI] == [jm.limbs_for_modulus(m) for m in MODULI]
    # the kernels' words: exact, 32 bits each
    words = tm.ints_to_words(xs, 10)
    assert tm.words_to_ints(words) == xs and words.dtype == np.uint32
    assert [tm.words_for_modulus(m) for m in MODULI] == [2, 8, 8, 16, 32, 65]
    with pytest.raises(OverflowError):
        tm.ints_to_words([1 << 64], 2)


def test_pack_exponents_rejects_overwide_in_last_word():
    for pkg in (tm, jm):
        with pytest.raises(ValueError):
            pkg.pack_exponents([1 << 50], 48)
        with pytest.raises(OverflowError):
            pkg.pack_exponents([1 << 64], 64)
        with pytest.raises(IndexError):
            pkg.pack_exponents([1 << 100], 96)


@pytest.mark.parametrize("m", MODULI, ids=lambda m: f"{m.bit_length()}b")
def test_mont_ctx_equals_pir_tpu(m):
    t, j = tm.mont_ctx(m), jm.mont_ctx(m)
    assert (t.m, t.L, t.n_inv) == (j.m, j.L, j.n_inv)
    for field in ("n_limbs", "r2_limbs", "one_limbs"):
        assert np.array_equal(getattr(t, field), getattr(j, field))
    w = tm.word_ctx(m)
    r = 1 << (32 * w.L)
    assert tm.words_to_ints(w.n_words[None])[0] == m and m * w.n0inv % (1 << 32) == (1 << 32) - 1
    assert tm.words_to_ints(w.r2_words[None])[0] == r * r % m


def test_mont_ctx_rejects_even_and_tiny_moduli():
    for m in (100, 1, 0):
        for ctx in (tm.mont_ctx, tm.word_ctx, jm.mont_ctx):
            with pytest.raises(ValueError):
                ctx(m)
    with pytest.raises(ValueError):
        tm.mont_ctx((1 << 61) - 1, 4)  # 60 bits of limbs hold no 61-bit modulus
    with pytest.raises(ValueError):
        tm.word_ctx(1 << 64 | 1, 2)


@pytest.mark.parametrize("m", MODULI, ids=lambda m: f"{m.bit_length()}b")
def test_plain_mont_mul_equals_pir_tpu(m):
    ctx = jm.mont_ctx(m)
    cases = [(rng.randrange(m), rng.randrange(m)) for _ in range(8)] + [
        (m - 1, m - 1), (0, m - 1), (1, 1), (m - 1, 1)]
    a = jm.ints_to_limbs([c[0] for c in cases], ctx.L)
    b = jm.ints_to_limbs([c[1] for c in cases], ctx.L)
    want = np.asarray(jm.mont_mul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ctx.n_limbs),
                                  jnp.uint32(ctx.n_inv)))
    got = tm.mont_mul(_t(a), _t(b), _t(ctx.n_limbs), ctx.n_inv)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    r_inv = pow(1 << (tm.RADIX * ctx.L), -1, m)
    for i, (x, y) in enumerate(cases):
        v = tm.limbs_to_int(got[i].tolist())
        assert v < 2 * m and v % m == x * y * r_inv % m


def test_plain_mont_mul_chains_redundant_inputs():
    """Outputs (< 2m, limbs <= 2^15) are valid inputs: 50 chained squarings
    of the all-ones modulus against the integer chain."""
    m = MODULI[3]
    ctx = tm.mont_ctx(m)
    r_inv = pow(1 << (tm.RADIX * ctx.L), -1, m)
    x = rng.randrange(1, m)
    acc, expect = _t(tm.ints_to_limbs([x], ctx.L)), x
    for _ in range(50):
        acc = tm.mont_mul(acc, acc, _t(ctx.n_limbs), ctx.n_inv)
        expect = expect * expect * r_inv % m
        assert int(acc.max()) <= 1 << tm.RADIX
    v = tm.limbs_to_int(acc[0].tolist())
    assert v < 2 * m and v % m == expect


@pytest.mark.parametrize("e_max", [32, 64])
def test_plain_ladders_equal_pir_tpu(e_max):
    """Square and multiply (e_max < 64) and the 4-bit window ladder, limb
    for limb, on Montgomery-domain bases of a 511-bit modulus."""
    m = MODULI[3]
    ctx = jm.mont_ctx(m)
    bases = [rng.randrange(m) for _ in range(5)] + [m - 1]
    exps = [rng.getrandbits(e_max) for _ in range(4)] + [0, (1 << e_max) - 1]
    b = jm.ints_to_limbs(bases, ctx.L)
    e = jm.pack_exponents(exps, e_max)
    want = np.asarray(jm.mont_exp(jnp.asarray(b), jnp.asarray(e), e_max,
                                  jnp.asarray(ctx.n_limbs), jnp.uint32(ctx.n_inv),
                                  jnp.asarray(ctx.one_limbs)))
    got = tm.mont_exp(_t(b), _t(e), e_max, _t(ctx.n_limbs), ctx.n_inv, _t(ctx.one_limbs))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    r = 1 << (tm.RADIX * ctx.L)
    r_inv = pow(r, -1, m)
    for i, (x, y) in enumerate(zip(bases, exps)):
        # base x read as Montgomery form of x / R: (x / R)^y, again * R
        assert tm.limbs_to_int(got[i].tolist()) % m == pow(x * r_inv, y, m) * r % m


def test_plain_scan_chunk_and_tree_product_equal_pir_tpu():
    m = MODULI[1]
    ctx = jm.mont_ctx(m)
    rc, w, e_max = 4, 3, 32
    bases = [rng.randrange(1, m) for _ in range(rc)]
    vals = [rng.getrandbits(e_max) for _ in range(rc * w)]
    vals[1] = 0
    b = jm.ints_to_limbs(bases, ctx.L)
    e = jm.pack_exponents(vals, e_max).reshape(rc, w, -1)
    consts = (ctx.n_limbs, ctx.n_inv, ctx.one_limbs, ctx.r2_limbs)
    want = np.asarray(jm._scan_chunk(jnp.asarray(b), jnp.asarray(e), jnp.asarray(consts[0]),
                                     jnp.uint32(consts[1]), jnp.asarray(consts[2]),
                                     jnp.asarray(consts[3]), e_max))
    got = tm.scan_chunk(_t(b), _t(e), _t(consts[0]), consts[1], _t(consts[2]), _t(consts[3]),
                        e_max)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert [tm.limbs_to_int(x.tolist()) % m for x in got] == _pow_scan(bases, vals, w, m)
    with pytest.raises(ValueError):
        tm.tree_product(_t(b[:3]), _t(consts[0]), consts[1])


@pytest.fixture(scope="module")
def powmod_700():
    """A 700-bit modulus and test_mont_tpu.py's batch: 33 random bases and
    exponents of 1 to 120 bits, then 0, 1 and m - 1 with 0, 1, 2^64 - 1."""
    m = _odd(700)
    bases = [rng.randrange(m) for _ in range(33)] + [0, 1, m - 1]
    exps = [rng.getrandbits(rng.randrange(1, 120)) for _ in range(33)] + [0, 1, (1 << 64) - 1]
    return m, bases, exps, jm.tpu_powmod_batch(bases, exps, m)


def test_device_powmod_batch_equals_pir_tpu(powmod_700):
    m, bases, exps, want = powmod_700
    assert want == [pow(b, e, m) for b, e in zip(bases, exps)]
    assert tm.device_powmod_batch(bases, exps, m, device="cpu") == want


def test_device_powmod_edge_cases():
    m = MODULI[1]
    assert tm.device_powmod_batch([0, 5, m - 1], [0, 0, 0], m, device="cpu") == [1, 1, 1]
    # a launch a batch_chunk rows
    assert tm.device_powmod_batch([3, 5, 7], [2, 3, 4], m, batch_chunk=2, device="cpu") == [
        9, 125, 2401]
    assert tm.device_powmod_batch([], [], m, device="cpu") == []
    with pytest.raises(ValueError):
        tm.device_powmod_batch([1, 2], [3], m, device="cpu")
    with pytest.raises(ValueError):
        tm.device_powmod_batch([1], [3], m, batch_chunk=3, device="cpu")
    with pytest.raises(ValueError):
        tm.device_powmod_batch([1], [3], m + 1, device="cpu")


def test_device_powmod_batch_multi_equals_pir_tpu():
    """Per-row moduli (the one-launch CRT split), an odd batch length;
    test_mont_tpu.py's case, and moduli of different word counts."""
    m1 = rng.randrange(1 << 299, 1 << 300) | 1
    m2 = rng.randrange(1 << 290, 1 << 291) | 1
    mods = [m1, m2, m1, m2, m1, m2, m1]
    bases = [rng.randrange(1, m) for m in mods]
    exps = [0, 1, rng.randrange(1 << 200), rng.randrange(1 << 300), 2, 3, rng.randrange(1 << 100)]
    want = [pow(b, e, m) for b, e, m in zip(bases, exps, mods)]
    assert jm.tpu_powmod_batch_multi(bases, exps, mods) == want
    assert tm.device_powmod_batch_multi(bases, exps, mods, device="cpu") == want
    m3 = _odd(200)  # 7 words beside m1's 10: pir_tpu refuses unequal limb counts
    mods = [m1, m3, m3]
    bases = [rng.randrange(m) for m in mods]
    exps = [rng.getrandbits(64) for _ in mods]
    assert tm.device_powmod_batch_multi(bases, exps, mods, device="cpu") == [
        pow(b, e, m) for b, e, m in zip(bases, exps, mods)]
    with pytest.raises(ValueError):
        tm.device_powmod_batch_multi([1], [1, 2], [m1], device="cpu")


@pytest.fixture(scope="module")
def scan_512():
    return _odd(512)


@pytest.mark.parametrize("height,width_cts", [(5, 3), (67, 1)])
def test_device_paillier_scan_equals_pir_tpu(scan_512, height, width_cts):
    """test_mont_tpu.py's scan shapes with level-1 exponents (24 bits), a
    fifth of them 0 (the identity), rows in chunks of 32 (67: a ragged
    last chunk; 5: one chunk padded to 8 rows)."""
    m = scan_512
    ebits = [rng.randrange(1, m) for _ in range(height)]
    vals = [rng.getrandbits(24) if rng.random() < 0.8 else 0 for _ in range(height * width_cts)]
    want = jm.tpu_paillier_scan(ebits, vals, width_cts, m, e_max=24, row_chunk=32)
    assert want == _pow_scan(ebits, vals, width_cts, m)
    assert tm.device_paillier_scan(ebits, vals, width_cts, m, e_max=24, row_chunk=32,
                                   device="cpu") == want


def test_device_paillier_scan_level2_shape():
    """Level-2 scans exponentiate by full ciphertext values (bits(N^2))."""
    m = _odd(384)
    ebits = [rng.randrange(1, m) for _ in range(6)]
    vals = [rng.randrange(m) for _ in range(6)]
    want = jm.tpu_paillier_scan(ebits, vals, 1, m, e_max=m.bit_length())
    assert want == _pow_scan(ebits, vals, 1, m)
    assert tm.device_paillier_scan(ebits, vals, 1, m, e_max=m.bit_length(), device="cpu") == want


def test_device_paillier_scan_empty_and_odd_chunks():
    m = MODULI[1]
    assert tm.device_paillier_scan([], [], 3, m, device="cpu") == [1, 1, 1]
    assert tm.device_paillier_scan([3, 4], [0, 0, 0, 0], 2, m, device="cpu") == [1, 1]
    with pytest.raises(ValueError):
        tm.device_paillier_scan([3], [5], 1, m, row_chunk=48, device="cpu")
    with pytest.raises(ValueError):
        tm.device_paillier_scan([3], [5, 6], 1, m, device="cpu")
    got = tm.device_paillier_scan([3, 5, 7], [2, 4, 6], 1, m, row_chunk=2, col_chunk=2,
                                  device="cpu")
    assert got == [pow(3, 2, m) * pow(5, 4, m) * pow(7, 6, m) % m]
    assert got == jm.tpu_paillier_scan([3, 5, 7], [2, 4, 6], 1, m, row_chunk=2, col_chunk=2)


def test_no_device_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; tests/test_torch_cuda.py runs the kernels there")
    m = MODULI[1]
    for call in (lambda: tm.device_powmod_batch([3], [5], m),
                 lambda: tm.device_powmod_batch_multi([3], [5], [m]),
                 lambda: tm.device_paillier_scan([3], [5], 1, m),
                 lambda: tm.device_powmod_batch([3], [5], m, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_words_and_limbs_convert_and_reduce():
    m = MODULI[5]
    L15, L32 = tm.limbs_for_modulus(m), tm.words_for_modulus(m)
    xs = [0, 1, m - 1, rng.randrange(m), (1 << 2048) + 12345]
    words = torch.from_numpy(tm.ints_to_words(xs, L32).view(np.int32))
    limbs = tm.words_to_limbs(words, L15)
    assert [tm.limbs_to_int(x.tolist()) for x in limbs] == xs
    assert torch.equal(tm.limbs_to_words(limbs, L32), words)
    # redundant limbs (<= 2^15) of values below 2m reduce to x mod m
    n = _t(tm.mont_ctx(m).n_limbs)
    vals = [m, 2 * m - 1, m - 1, 0, rng.randrange(m, 2 * m)]
    red = _t(tm.ints_to_limbs(vals, L15))
    move = red[:, 1] > 0  # the same values, limb 0 carrying 2^15 of limb 1
    red[move, 0] += 1 << tm.RADIX
    red[move, 1] -= 1
    assert [tm.limbs_to_int(x.tolist()) for x in red] == vals and bool(move.any())
    got = tm._reduce_once(red, n)
    assert [tm.limbs_to_int(x.tolist()) for x in got] == [v % m for v in vals]
    assert int(got.max()) < 1 << tm.RADIX


def test_wrappers_check_their_operands():
    m = MODULI[1]
    b = torch.zeros((4, 8), dtype=torch.int32)
    e = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tm.mont_powmod(b.long(), e, m, 24)
    with pytest.raises(ValueError, match="cover"):
        tm.mont_powmod(b, e, m, 40)
    with pytest.raises(ValueError, match="moduli"):
        tm.mont_powmod(b, e, [m, m], 24)
    with pytest.raises(ValueError, match="wider"):
        tm.mont_powmod(b[:, :2], e, m, 24)
    with pytest.raises(ValueError, match="no Montgomery engine"):
        tm.mont_powmod(b.to("meta"), e.to("meta"), m, 24)
    with pytest.raises(ValueError, match="cover"):
        tm.mont_scan(b, e.reshape(2, 2, 1), m, 24)
    with pytest.raises(ValueError, match="words"):
        tm.mont_scan(b, e.reshape(4, 1, 1), m, 40)
    # a CPU tensor runs the plain version (no launch counted)
    before = tm.mont_powmod.launches
    out = tm.mont_powmod(torch.from_numpy(tm.ints_to_words([3], 8).view(np.int32)),
                         torch.tensor([[5]], dtype=torch.int32), m, 24)
    assert tm.words_to_ints(out.numpy()) == [243] and tm.mont_powmod.launches == before


def test_scan_plan_covers_the_rows_and_counts_products():
    """The launch shape of the 2^20-slot grid (1024 x 1024 exponents of 24
    bits mod a 2048-bit N^2) and of a level-2 scan (32 rows, one column,
    2048-bit exponents mod a 6144-bit N^3) on an H100 (132 SMs, 227 KB of
    shared memory a block), and the products each runs."""
    optin = 232448
    p = tm.scan_plan(1024, 1024, 64, 24, 132, optin)
    assert p["rc"] * p["chunks"] >= 1024 > (p["chunks"] - 1) * p["rc"]
    assert p["smem"] == 4 * p["rc"] * (p["G"] * p["K"] << p["wbits"]) <= optin
    assert p["wbits"] not in (1, 4) and p["horner"]  # the window and chunking of the model
    assert p["products"] == tm.scan_products(p, 1024, 1024, 24) < 7_000_000
    q = tm.scan_plan(32, 1, 96, 2048, 132, optin)
    assert q["G"] == 32 and q["rc"] == 1 and q["chunks"] == 32 and not q["horner"]
    assert tm.scan_plan(5, 3, 16, 24, 132, optin, row_chunk=2)["rc"] <= 2
    assert tm.powmod_products(1024, 1, 4) == 16 + 256 * 5 + 1
    assert tm.powmod_products(24, 2, 1) == 2 * 51
    # the bounds' counts: the best fixed window, tables shared by a row's
    # columns in the scan (8-bit windows at 24-bit exponents)
    assert tm.least_scan_products(1024, 1024, 24) == 256 * 1024 + 1024 * 24 + 3 * 1024 ** 2 + 1024
    assert tm.least_scan_products(1024, 1024, 24) > p["products"] * 0.8
    assert tm.least_powmod_products(1024) == tm.powmod_products(1024, 1, 6) == 64 + 171 * 7 + 1
    assert tm.least_powmod_products(24, 2) == tm.powmod_products(24, 2, 2)


OPTIN = 232448
POWMOD_SHAPES = [(1024, 64, 1024), (2048, 32, 512), (64, 96, 2048), (16, 64, 256), (1, 2, 24),
                 (13, 65, 300), (3, 768, 64), (5000, 17, 40)]
SCAN_SHAPES = [(1024, 1024, 64, 24), (32, 1, 96, 2048), (64, 4, 64, 24), (1, 1, 2, 24),
               (67, 1, 16, 24), (130, 33, 8, 40), (33, 3, 96, 2048), (2, 1, 768, 64),
               (1 << 20, 1, 64, 24), (1 << 17, 2, 512, 24)]


@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("b,L,e_max", POWMOD_SHAPES)
def test_powmod_plan_covers_its_rows_and_fits(b, L, e_max, sms):
    """Kernel 9's plan: G lanes of an instance's K words hold L words, the
    table of each warp's groups fits in shared memory, and its products
    are those of its window's chain."""
    p = tm.powmod_plan(b, L, e_max, sms, OPTIN)
    assert p["G"] in tm.GROUP_LANES and p["K"] in tm.LANE_WORDS and p["G"] * p["K"] >= L
    assert p["K"] == tm.lane_words(L, p["G"]) and 1 <= p["wbits"] <= tm.MAX_WINDOW
    assert 1 <= p["warps"] <= 4 and p["smem"] == p["warps"] * 4 * p["K"] * 32 << p["wbits"]
    assert p["smem"] <= OPTIN
    nwin = -(-e_max // p["wbits"])
    assert p["products"] == b * ((1 << p["wbits"]) - 1 + (nwin - 1) * (p["wbits"] + 1) + 1)


@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("h,w,L,e_max", SCAN_SHAPES)
def test_scan_plan_covers_its_rows_and_fits(h, w, L, e_max, sms):
    """Kernel 10's plan: its chunks cover the rows, at most 65535 of them,
    a chunk's tables fit in 227 KB of shared memory, a block is whole warps
    within the instance's thread bound, and the scratch stays bounded."""
    p = tm.scan_plan(h, w, L, e_max, sms, OPTIN)
    Lp = p["G"] * p["K"]
    assert p["K"] == tm.lane_words(L, p["G"]) and 1 <= p["wbits"] <= tm.MAX_WINDOW
    assert p["rc"] * p["chunks"] >= h > (p["chunks"] - 1) * p["rc"] and p["chunks"] <= 65535
    assert p["smem"] == 4 * p["rc"] * Lp << p["wbits"] and p["smem"] <= OPTIN
    assert p["threads"] == p["cols"] * p["G"] and p["threads"] % 32 == 0
    assert p["threads"] <= tm.scan_threads(p["K"]) and p["horner"] in (0, 1)
    windows = -(-e_max // p["wbits"]) if p["horner"] else 1
    assert p["chunks"] * windows * w * Lp * 4 <= tm.SCRATCH_BYTES
    assert p["slab_chunks"] * p["smem"] <= max(tm.SCRATCH_BYTES, p["smem"])
    assert p["products"] == tm.scan_products(p, h, w, e_max)


def test_scan_plan_bounds_rows_and_columns():
    """row_chunk bounds the rows a chunk, col_chunk the columns a block
    (a whole warp at least); a table that fits no block raises."""
    for rc in (1, 2, 3):
        assert tm.scan_plan(40, 3, 16, 24, 132, OPTIN, row_chunk=rc)["rc"] <= rc
    p = tm.scan_plan(64, 64, 8, 24, 132, OPTIN, col_chunk=2)
    assert p["cols"] == 32 // p["G"] or p["cols"] <= 2
    with pytest.raises(ValueError):
        tm.scan_plan(4, 1, 1000, 24, 132, OPTIN)
    with pytest.raises(ValueError):
        tm.powmod_plan(4, 1000, 24, 132, OPTIN)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    import mont_host_lib
    return mont_host_lib.build(tmp_path_factory.mktemp("mont_host"))


@pytest.mark.parametrize("b,L,e_max,sms", [(3, 2, 24, 132), (5, 16, 96, 1), (2, 33, 64, 2)])
def test_powmod_plan_counts_what_the_host_model_runs(host, b, L, e_max, sms):
    import mont_host_lib
    p = tm.powmod_plan(b, L, e_max, sms, OPTIN)
    m = _odd(32 * L - 3)
    bases = [rng.randrange(m) for _ in range(b)]
    exps = [rng.getrandbits(e_max) for _ in range(b)]
    got, products = mont_host_lib.powmod(host, bases, exps, [m] * b, e_max, p["G"], p["wbits"],
                                         p["K"])
    assert got == [pow(x, y, m) for x, y in zip(bases, exps)] and products == p["products"]


@pytest.mark.parametrize("h,w,L,e_max,sms", [(9, 3, 4, 24, 132), (21, 2, 8, 64, 2),
                                             (6, 1, 12, 300, 132), (40, 5, 2, 24, 1)])
def test_scan_plan_counts_what_the_host_model_runs(host, h, w, L, e_max, sms):
    import mont_host_lib
    p = tm.scan_plan(h, w, L, e_max, sms, OPTIN)
    m = _odd(32 * L - 5)
    ebits = [rng.randrange(1, m) for _ in range(h)]
    vals = [rng.getrandbits(e_max) for _ in range(h * w)]
    got, products = mont_host_lib.scan(host, ebits, vals, h, w, m, e_max, p["G"], p["wbits"],
                                       p["rc"], p["horner"])
    assert got == _pow_scan(ebits, vals, w, m) and products == p["products"]
