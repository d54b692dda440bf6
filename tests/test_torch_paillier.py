"""pir_tpu_torch.crypto.paillier against pir_tpu.crypto.paillier.

A port key is built from a pir_tpu key's primes (``state.paillier_secret_key``)
and the other way round; each package decrypts the other's ciphertexts
at both levels and nested, their Fiat-Shamir challenge bits are equal,
each package's DDLEQ proof verifies in the other (and a tampered one in
neither), randomness extraction agrees, and the port's CRT modexps equal
plain ones. Under ``device_modexp`` (the card's Montgomery engine, here
its plain version with device="cpu") the batched modexps, both levels'
encryption and decryption batches, the CRT halves and the DDLEQ
verdicts equal pir_tpu's under ``tpu_modexp`` and CPython's. 128-bit
keys, as tests/test_encrypted.py (db_test.go:70).
"""

import random
import secrets

import pytest
import torch

from pir_tpu.crypto import paillier as jp
from pir_tpu_torch import state
from pir_tpu_torch.crypto import paillier as tp

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def keys():
    """(pir_tpu sk, port sk) of one key, and (port sk, pir_tpu sk) of a
    key the port generated."""
    sk_j, _ = jp.keygen(128)
    sk_t, _ = tp.keygen(128)
    return [(sk_j, state.paillier_secret_key(sk_j.p, sk_j.q)),
            (jp.SecretKey(sk_t.p, sk_t.q), sk_t)]


def _ct(c, pkg):
    if pkg == "torch":
        return state.ciphertext_from_fields(c.c, c.level)
    return jp.Ciphertext(c.c, c.level)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("enc_pkg", ["jax", "torch"])
def test_each_package_decrypts_the_others_ciphertexts(keys, which, enc_pkg):
    sk_j, sk_t = keys[which]
    enc_sk, dec_sk, dec_pkg = ((sk_j, sk_t, "torch") if enc_pkg == "jax"
                               else (sk_t, sk_j, "jax"))
    pk = enc_sk.public_key
    rnd = random.Random(which)
    for _ in range(4):
        m1 = rnd.randrange(pk.n)
        assert dec_sk.decrypt(_ct(pk.encrypt(m1), dec_pkg)) == m1
        m2 = rnd.randrange(pk.n2)
        assert dec_sk.decrypt_level2(_ct(pk.encrypt_at_level(m2, 2), dec_pkg)) == m2
        inner = pk.encrypt(m1)
        outer = _ct(pk.encrypt_at_level(inner.c, 2), dec_pkg)
        assert dec_sk.nested_decrypt(outer) == m1
        assert dec_sk.decrypt_nested_layer(outer).c == inner.c
    batch = [pk.encrypt(m) for m in (0, 1, 7)] + [(tp if enc_pkg == "torch" else jp)
                                                   .Ciphertext(0, 1)]
    assert dec_sk.decrypt_batch([_ct(c, dec_pkg) for c in batch]) == [0, 1, 7, 0]
    nested = [pk.encrypt_at_level(pk.encrypt(m).c, 2) for m in (3, 0)]
    assert dec_sk.nested_decrypt_batch([_ct(c, dec_pkg) for c in nested]) == [3, 0]


def test_public_operations_equal(keys):
    """Deterministic operations give equal ints in both packages: fixed-r
    encryption, null ciphertexts, add, const_mult, nested_sub."""
    sk_j, sk_t = keys[0]
    pj, pt = sk_j.public_key, state.paillier_public_key(sk_j.n)
    rnd = random.Random(2)
    for level in (1, 2):
        m, r, k = rnd.randrange(pj.n), rnd.randrange(1, pj.n), rnd.randrange(1 << 40)
        a, b = pj.encrypt_with_r_at_level(m, r, level), pt.encrypt_with_r_at_level(m, r, level)
        assert (a.c, a.level) == (b.c, b.level)
        assert pj.null_ciphertext(level).c == pt.null_ciphertext(level).c
        assert pj.const_mult(a, k).c == pt.const_mult(b, k).c
        assert pj.add(a, a).c == pt.add(b, b).c
    chal = pj.encrypt_at_level(pj.encrypt(99).c, 2)
    tok = pj.encrypt(44)
    assert pj.nested_sub(chal, tok).c == pt.nested_sub(_ct(chal, "torch"), _ct(tok, "torch")).c
    assert jp.msg_space_bytes(pj) == tp.msg_space_bytes(pt)


@pytest.mark.parametrize("reps", [1, 8, 64, 300])
def test_fiat_shamir_challenge_bits_equal(reps):
    rnd = random.Random(reps)
    n, c1, c2 = (rnd.getrandbits(256) | 1 for _ in range(3))
    comms = [rnd.getrandbits(384) for _ in range(reps)]
    assert (tp._fs_challenge_bits(n, c1, c2, comms, reps)
            == jp._fs_challenge_bits(n, c1, c2, comms, reps))


@pytest.mark.parametrize("prover", ["jax", "torch"])
def test_ddleq_proofs_verify_across_packages(keys, prover):
    sk_j, sk_t = keys[0]
    p_sk, v_pk, v_pkg = ((sk_j, sk_t.public_key, tp) if prover == "jax"
                         else (sk_t, sk_j.public_key, jp))
    ct1 = p_sk.public_key.encrypt_at_level(p_sk.public_key.encrypt(0).c, 2)
    ct2, a, b = p_sk.nested_randomize(ct1)
    proof = p_sk.prove_ddleq(2, ct1, ct2, a, b)
    vp = v_pkg.DDLEQProof(list(proof.commitments), [tuple(r) for r in proof.responses],
                          proof.secparam)
    c1, c2 = v_pkg.Ciphertext(ct1.c, 2), v_pkg.Ciphertext(ct2.c, 2)
    assert v_pk.verify_ddleq(c1, c2, vp)
    # the prover's own package agrees, and both refuse a tampered proof
    assert p_sk.public_key.verify_ddleq(ct1, ct2, proof)
    vp.commitments[0] = vp.commitments[0] * 2 % v_pk.n3
    proof.commitments[0] = proof.commitments[0] * 2 % v_pk.n3
    assert not v_pk.verify_ddleq(c1, c2, vp)
    assert not p_sk.public_key.verify_ddleq(ct1, ct2, proof)
    # and a proof for another ct1 verifies in neither
    other = v_pkg.Ciphertext(p_sk.public_key.encrypt_at_level(
        p_sk.public_key.encrypt(5).c, 2).c, 2)
    assert not v_pk.verify_ddleq(other, c2, v_pkg.DDLEQProof(
        [c for c in proof.commitments], list(proof.responses), proof.secparam))


def test_randomness_extraction_equal(keys):
    sk_j, sk_t = keys[0]
    pk = sk_j.public_key
    r, s = pk.random_r(), pk.random_r()
    inner = pk.encrypt_with_r_at_level(0, r, 1)
    outer = pk.encrypt_with_r_at_level(inner.c, s, 2)
    for ct in (inner, outer):
        assert sk_t.extract_randomness(_ct(ct, "torch")) == sk_j.extract_randomness(ct)
    assert sk_t.extract_randomness(_ct(inner, "torch")) == r % pk.n
    assert sk_t.extract_randomness(_ct(outer, "torch")) == s % pk.n


def test_crt_and_plain_powmods_equal(keys):
    """The port's sk-side CRT modexps equal plain pow and pir_tpu's, for
    unit bases, a common base and the non-unit fallback."""
    sk_j, sk_t = keys[0]
    rng = secrets.SystemRandom()
    for s in (1, 2, 3):
        m = sk_t.n ** s
        phi = sk_t._crt[s][2] * sk_t._crt[s][3]
        bases = [rng.randrange(1, m) | 1 for _ in range(5)]
        exps = [1, 2, sk_t.lam, phi + 3, rng.randrange(m)]
        want = [pow(b, e, m) for b, e in zip(bases, exps)]
        assert sk_t._powmod_batch_sk(bases, exps, s) == want
        assert sk_j._powmod_batch_sk(bases, exps, s) == want
        assert [sk_t._powmod_sk(b, e, s) for b, e in zip(bases, exps)] == want
        assert tp._powmod_batch(bases, exps, m) == want
        assert sk_t._powmod_batch_sk(bases[0], exps, s, common_base=True) == [
            pow(bases[0], e, m) for e in exps]
    assert sk_t._powmod_sk(sk_t.p, 5, 2) == pow(sk_t.p, 5, sk_t.n2)
    assert sk_t._powmod_batch_sk([sk_t.q, 3], [4, 5], 2) == [pow(sk_t.q, 4, sk_t.n2),
                                                            pow(3, 5, sk_t.n2)]


def test_port_keygen_is_a_valid_key():
    sk, pk = tp.keygen(128)
    assert sk.p != sk.q and pk.n == sk.p * sk.q
    assert 126 <= pk.n.bit_length() <= 128
    assert sk.decrypt(pk.encrypt(12345)) == 12345
    assert sk.nested_decrypt(pk.encrypt_at_level(pk.encrypt(9).c, 2)) == 9


# ---- the device route (device_modexp; the plain version on the CPU) ----

def test_device_route_batches_equal_pir_tpu_tpu_route(keys):
    """_powmod_batch (one modulus, common base) and the CRT batches
    (_powmod_batch_sk, the halves a modulus a row) under device_modexp
    equal pir_tpu's under tpu_modexp and CPython pow."""
    sk_j, sk_t = keys[0]
    rnd = random.Random(21)
    n2, n3 = sk_t.n2, sk_t.n3
    bases = [rnd.randrange(1, n3) for _ in range(16)]
    exps = [rnd.randrange(n2) for _ in range(15)] + [0]
    with tp.device_modexp(True, "cpu"), jp.tpu_modexp(True):
        got = tp._powmod_batch(bases, exps, n3)
        assert got == jp._powmod_batch(bases, exps, n3)
        assert tp._powmod_batch(bases[0], exps, n3, common_base=True) == [
            pow(bases[0], e, n3) for e in exps]
        for s in (2, 3):
            m = sk_t.n ** s
            bs = [b % m for b in bases[:8]]
            es = [sk_t.lam, 1, 0] + exps[:5]
            want = [pow(b, e, m) for b, e in zip(bs, es)]
            assert sk_t._powmod_batch_sk(bs, es, s) == want == sk_j._powmod_batch_sk(bs, es, s)
    assert got == [pow(b, e, n3) for b, e in zip(bases, exps)]


def test_encrypt_decrypt_batches_under_device_modexp(keys):
    _, sk_t = keys[0]
    pk = sk_t.public_key
    ms = [0, 1, 7, pk.n - 1] * 4  # 16: the route's smallest batch
    with tp.device_modexp(True, "cpu"):
        cts1 = pk.encrypt_batch(ms)
        cts2 = pk.encrypt_batch(ms, tp.ENC_LEVEL_TWO)
        assert sk_t.decrypt_batch(cts1) == ms
        assert sk_t.decrypt_level2_batch(cts2) == ms
        nested = pk.encrypt_batch([c.c for c in cts1], tp.ENC_LEVEL_TWO)
        assert sk_t.nested_decrypt_batch(nested) == ms
    assert sk_t.decrypt_batch(cts1) == ms  # CPython decrypts the device's ciphertexts


def test_ddleq_verdicts_under_device_modexp(keys):
    """A port proof made under device_modexp verifies in both packages
    (pir_tpu under tpu_modexp) and a tampered one in neither."""
    sk_j, sk_t = keys[0]
    pk = sk_t.public_key
    ct1 = pk.encrypt_at_level(pk.encrypt(0).c, 2)
    ct2, a, b = sk_t.nested_randomize(ct1)
    with tp.device_modexp(True, "cpu"):
        proof = sk_t.prove_ddleq(2, ct1, ct2, a, b)
        assert pk.verify_ddleq(ct1, ct2, proof)
        jproof = jp.DDLEQProof(list(proof.commitments), list(proof.responses), proof.secparam)
        with jp.tpu_modexp(True):
            assert sk_j.public_key.verify_ddleq(jp.Ciphertext(ct1.c, 2), jp.Ciphertext(ct2.c, 2),
                                                jproof)
        other = pk.encrypt_at_level(pk.encrypt(3).c, 2)
        assert not pk.verify_ddleq(other, ct2, proof)
        proof.commitments[0] = proof.commitments[0] * 2 % pk.n3
        assert not pk.verify_ddleq(ct1, ct2, proof)


def test_device_route_conditions(keys, monkeypatch):
    """The route takes what pir_tpu's TPU route takes: an odd modulus of
    >= 256 bits, no negative exponent, a batch of >= 16; e_max rounds up
    to a power of two of >= 256 bits. It is scoped, and off by default."""
    from pir_tpu_torch.crypto import mont

    calls = []

    def spy(bases, exps, m, e_max=None, batch_chunk=4096, device=None):
        calls.append((len(exps), e_max, device))  # the route, not the arithmetic
        return [pow(b, e, m) for b, e in zip(bases, exps)]

    monkeypatch.setattr(mont, "device_powmod_batch", spy)
    _, sk_t = keys[0]
    m = sk_t.n3  # >= 256 bits (N^2 of a 128-bit key may have 253)
    bases, exps = list(range(3, 19)), list(range(1, 17))
    want = [pow(b, e, m) for b, e in zip(bases, exps)]
    assert tp._powmod_batch(bases, exps, m) == want and not calls  # off
    with tp.device_modexp(True, "cpu"):
        assert tp._powmod_batch(bases, exps, m) == want
        assert calls == [(16, 256, "cpu")]
        assert tp._powmod_batch(bases[:15], exps[:15], m) == want[:15]  # too few
        assert tp._powmod_batch(bases, exps, sk_t.n) == [pow(b, e, sk_t.n)
                                                         for b, e in zip(bases, exps)]
        assert tp._powmod_batch(bases, exps, m + 1) == [pow(b, e, m + 1)
                                                        for b, e in zip(bases, exps)]
        assert tp._powmod_batch(bases, [-1] + exps[1:], m)[0] == pow(3, -1, m)
        assert tp._powmod_batch(bases, [1 << 300] + exps[1:], m)[0] == pow(3, 1 << 300, m)
    assert len(calls) == 2 and calls[1][1] == 512
    tp.enable_device_modexp(True, "cpu")
    try:
        assert tp._powmod_batch(bases, exps, m) == want and len(calls) == 3
    finally:
        tp.enable_device_modexp(False)
    assert tp._device_modexp is None


def test_device_modexp_is_scoped_to_its_thread(keys, monkeypatch):
    """device_modexp() routes the calling thread only: threads that enter
    and leave it interleaved (A in, B in, A out, B out) leave the route off
    for everyone, a thread outside sees it off meanwhile, and a scoped
    "off" overrides a process-wide "on"."""
    import threading

    from pir_tpu_torch.crypto import mont

    calls = []

    def spy(bases, exps, m, e_max=None, batch_chunk=4096, device=None):
        calls.append((threading.current_thread().name, device))
        return [pow(b, e, m) for b, e in zip(bases, exps)]

    monkeypatch.setattr(mont, "device_powmod_batch", spy)
    m = keys[0][1].n3
    bases, exps = list(range(3, 19)), list(range(1, 17))
    steps = [threading.Event() for _ in range(4)]

    def worker(enter, leave, device):
        with tp.device_modexp(True, device):
            steps[enter].set()
            steps[leave - 1].wait(5)
            tp._powmod_batch(bases, exps, m)
        steps[leave].set()

    a = threading.Thread(target=worker, args=(0, 2, "cpu"), name="A")
    b = threading.Thread(target=worker, args=(1, 3, "cpu:0"), name="B")
    a.start()
    steps[0].wait(5)
    b.start()
    steps[1].wait(5)
    tp._powmod_batch(bases, exps, m)  # this thread: off
    a.join(5)
    b.join(5)
    assert sorted(calls) == [("A", "cpu"), ("B", "cpu:0")]
    assert tp._route() is None and tp._device_modexp is None
    tp.enable_device_modexp(True, "cpu")
    try:
        with tp.device_modexp(False):
            tp._powmod_batch(bases, exps, m)
        assert len(calls) == 2
        tp._powmod_batch(bases, exps, m)
        assert len(calls) == 3
    finally:
        tp.enable_device_modexp(False)


def test_device_modexp_with_no_device_needs_cuda(keys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; tests/test_torch_cuda.py runs the route there")
    pk = keys[0][1].public_key
    with tp.device_modexp():
        with pytest.raises(RuntimeError, match="CUDA"):
            pk.encrypt_batch([0] * 16, tp.ENC_LEVEL_TWO)
        with pytest.raises(RuntimeError, match="CUDA"):
            keys[0][1].decrypt_batch([tp.Ciphertext(3, 1)] * 8)  # the CRT halves: 16 rows
