"""Two-level (nested) Paillier cryptosystem with DDLEQ proofs (counterpart
of ``pir_tpu/crypto/paillier.py``), on CPython integers only.

Generalized Damgard-Jurik encryption at levels s=1 (mod N^2) and s=2
(mod N^3, whose plaintext space Z_{N^2} holds a level-1 ciphertext:
"nested" Paillier), homomorphic Add/ConstMult, nested subtraction and
randomization, randomness extraction, and a zero-knowledge
re-randomization proof ("DDLEQ"): a Fiat-Shamir cut-and-choose sigma
protocol (binary challenges, ``8*secparam`` repetitions) proving
knowledge of (a, b) with ct2 = ct1^(a^N) * b^(N^2) mod N^3. Keys,
ciphertexts, proofs and challenge bits equal pir_tpu's on the same
inputs.

Single modexps are CPython ``pow``. Batched modexps (encryption batches,
decryption batches, the DDLEQ repetitions) run on the card's Montgomery
engine (``crypto/mont.py``, kernel 9) when ``enable_device_modexp()``
(process-wide) or the scoped ``device_modexp()`` (the calling thread,
until it exits) turns the route on, under pir_tpu's
conditions for its TPU route (``enable_tpu_modexp`` / ``tpu_modexp``).
The native route (the scoped ``native_modexp()``, which a service with
``PirConfig(paillier_engine="native")`` applies to its DDLEQ checks) runs single and batched modexps of odd moduli of >= 256 bits
on the threaded C++ Montgomery engine (``native.powmod``,
``native.powmod_batch``) where the device route does not take them: the
device route keeps precedence. Else CPython ``pow``. Every route gives
equal ints. pir_tpu takes its native route implicitly whenever its
library builds; the port takes it only where the caller names it, as it
takes no host engine unasked. The secret-key side keeps its CRT fast
path (``SecretKey._powmod_batch_sk``), whose two halves ride one launch
with a modulus per row on the device route.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import secrets
from dataclasses import dataclass

# Encryption levels (paillier.EncLevelOne / EncLevelTwo in the reference)
ENC_LEVEL_ONE = 1
ENC_LEVEL_TWO = 2

# the device route: None (off) or (device,), None being the card. The
# process-wide default (enable_device_modexp), which device_modexp()
# overrides in the calling thread's context only.
_device_modexp: tuple | None = None
_UNSET = object()
_scoped_modexp: contextvars.ContextVar = contextvars.ContextVar("device_modexp",
                                                               default=_UNSET)
_DEVICE_MODEXP_MIN_BATCH = 16
# the native route: on in the calling thread's context under native_modexp()
_scoped_native: contextvars.ContextVar = contextvars.ContextVar("native_modexp",
                                                               default=False)


def enable_device_modexp(enabled: bool = True, device=None) -> None:
    """Route batched modexps through the card's Montgomery engine
    (crypto/mont.py) when the batch is large enough, process-wide; device
    None is the card (raising at the first batch where no CUDA is
    present), "cpu" the engine's plain version."""
    global _device_modexp
    _device_modexp = (device,) if enabled else None


@contextlib.contextmanager
def device_modexp(enabled: bool = True, device=None):
    """Scoped route: on (to `device`) or off for the calling thread until
    exit, whatever the process-wide default; other threads keep theirs."""
    token = _scoped_modexp.set((device,) if enabled else None)
    try:
        yield
    finally:
        _scoped_modexp.reset(token)


def _route() -> tuple | None:
    route = _scoped_modexp.get()
    return _device_modexp if route is _UNSET else route


@contextlib.contextmanager
def native_modexp(enabled: bool = True):
    """Route modexps through the native C++ Montgomery engine (native/) in
    the calling thread until exit (on or off); other threads keep theirs.
    The library builds at the first modexp and raises if it cannot."""
    token = _scoped_native.set(enabled)
    try:
        yield
    finally:
        _scoped_native.reset(token)


def _native_route(m: int, exps) -> bool:
    """The native route takes odd moduli of >= 256 bits and no negative
    exponent (pir_tpu's conditions), where the caller turned it on."""
    return (_scoped_native.get() and bool(m & 1) and m.bit_length() >= 256
            and all(e >= 0 for e in exps))


def _powmod(b: int, e: int, m: int) -> int:
    if _native_route(m, (e,)):
        from .. import native

        return native.powmod(b, e, m)
    return pow(b, e, m)


def _powmod_batch(bases, exps, m: int, common_base: bool = False) -> list[int]:
    """Modexps over one modulus; common_base=True takes one base (an int)
    for every exponent. On the device route (an odd modulus of >= 256
    bits, no negative exponent, a batch of >= 16) kernel 9 runs them, the
    exponent bound rounded up to a power of two of >= 256 bits; else on
    the native route the C++ engine, threaded over the host's cores."""
    route = _route()
    if (route is not None and (m & 1) and m.bit_length() >= 256
            and len(exps) >= _DEVICE_MODEXP_MIN_BATCH and all(e >= 0 for e in exps)):
        from .mont import device_powmod_batch

        e_max = max((e.bit_length() for e in exps), default=1)
        e_max = max(256, 1 << (e_max - 1).bit_length())
        bs = [bases] * len(exps) if common_base else list(bases)
        return device_powmod_batch(bs, exps, m, e_max=e_max, device=route[0])
    if _native_route(m, exps):
        from .. import native

        return native.powmod_batch(bases, exps, m, common_base)
    if common_base:
        return [pow(bases, e, m) for e in exps]
    return [pow(b, e, m) for b, e in zip(bases, exps)]


@dataclass
class Ciphertext:
    c: int
    level: int = ENC_LEVEL_ONE


@dataclass
class DDLEQProof:
    commitments: list[int]
    responses: list[tuple[int, int]]  # per-rep opening, meaning depends on bit
    secparam: int


# --------------------------------------------------------------------------
# Prime generation (Miller-Rabin)
# --------------------------------------------------------------------------

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97]


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        p = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(p):
            return p


# --------------------------------------------------------------------------
# Keys
# --------------------------------------------------------------------------

class PublicKey:
    def __init__(self, n: int):
        self.n = n
        self.n2 = n * n
        self.n3 = self.n2 * n

    # -- helpers --

    def _mod(self, level: int) -> int:
        return self.n2 if level == ENC_LEVEL_ONE else self.n3

    def _g_pow(self, m: int, level: int) -> int:
        """(1+N)^m via the binomial shortcut (exact mod N^{level+1})."""
        n = self.n
        if level == ENC_LEVEL_ONE:
            return (1 + m * n) % self.n2
        m = m % self.n2
        return (1 + m * n + (m * (m - 1) // 2) * n * n) % self.n3

    def random_r(self) -> int:
        while True:
            r = secrets.randbelow(self.n)
            if r > 0:
                return r

    # -- encryption (query.go:137-139, 195-197; db.go:455-457) --

    def encrypt_with_r_at_level(self, m: int, r: int, level: int) -> Ciphertext:
        mod = self._mod(level)
        exp = self.n if level == ENC_LEVEL_ONE else self.n2
        c = self._g_pow(m, level) * _powmod(r, exp, mod) % mod
        return Ciphertext(c, level)

    def encrypt_at_level(self, m: int, level: int) -> Ciphertext:
        return self.encrypt_with_r_at_level(m, self.random_r(), level)

    def encrypt_batch(self, ms, level: int = ENC_LEVEL_ONE) -> list:
        """Encrypt a list of plaintexts with fresh randomness (the
        r^{N^level} blinding modexps through _powmod_batch). The hot path
        of cPIR query generation: a query is height (+ width) one-hot
        encryptions (query.go:134-141, 181-199)."""
        mod = self._mod(level)
        exp = self.n if level == ENC_LEVEL_ONE else self.n2
        rs = [self.random_r() for _ in ms]
        rpows = _powmod_batch(rs, [exp] * len(ms), mod)
        return [
            Ciphertext(self._g_pow(m, level) * rp % mod, level)
            for m, rp in zip(ms, rpows)
        ]

    def encrypt(self, m: int) -> Ciphertext:
        return self.encrypt_at_level(m, ENC_LEVEL_ONE)

    def encrypt_zero(self, level: int = ENC_LEVEL_ONE) -> Ciphertext:
        return self.encrypt_at_level(0, level)

    def encrypt_one(self, level: int = ENC_LEVEL_ONE) -> Ciphertext:
        return self.encrypt_at_level(1, level)

    def null_ciphertext(self, level: int) -> Ciphertext:
        """Enc(0; r=1): the additive identity (db.go:448-457)."""
        return self.encrypt_with_r_at_level(0, 1, level)

    # -- homomorphic ops (db.go:245-246, 334-335) --

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.level == b.level
        mod = self._mod(a.level)
        return Ciphertext(a.c * b.c % mod, a.level)

    def const_mult(self, ct: Ciphertext, k: int) -> Ciphertext:
        mod = self._mod(ct.level)
        return Ciphertext(_powmod(ct.c, k, mod), ct.level)

    def nested_sub(self, chal: Ciphertext, token: Ciphertext) -> Ciphertext:
        """Level-2 ct whose inner level-1 ct is divided by token.c.

        Subtracts the token's plaintext from the inner encryption
        (aspir.go:117-118, 187): Enc2(c1) -> Enc2(c1 * token.c^-1 mod N^2).
        """
        assert chal.level == ENC_LEVEL_TWO and token.level == ENC_LEVEL_ONE
        k = pow(token.c, -1, self.n2)
        return self.const_mult(chal, k)

    # -- DDLEQ verification --

    def verify_ddleq(self, ct1: Ciphertext, ct2: Ciphertext, proof: DDLEQProof) -> bool:
        n, n2, n3 = self.n, self.n2, self.n3
        reps = len(proof.commitments)
        if reps < 8 * proof.secparam:
            return False
        if len(proof.responses) < reps:
            return False
        bits = _fs_challenge_bits(self.n, ct1.c, ct2.c, proof.commitments, reps)
        xs = [proof.responses[i][0] for i in range(reps)]
        ys = [proof.responses[i][1] for i in range(reps)]
        if any(not (0 < y < n3) for y in ys):
            return False
        # the y^(N^2) and ct^(x^N) ladders share one mod-N^3 batch
        es = _powmod_batch(xs, [n] * reps, n2)
        # bit 0: opening w.r.t. ct2 (T = ct2^(u^N) * v^(N^2));
        # bit 1: opening w.r.t. ct1 (T = ct1^(z^N) * w^(N^2))
        bases = [ct1.c if bit else ct2.c for bit in bits]
        pows = _powmod_batch(ys + bases, [n2] * reps + es, n3)
        want = [cp * yp % n3 for cp, yp in zip(pows[reps:], pows[:reps])]
        return all(w == t_i for w, t_i in zip(want, proof.commitments))


class SecretKey(PublicKey):
    def __init__(self, p: int, q: int):
        super().__init__(p * q)
        self.p = p
        self.q = q
        self.lam = (p - 1) * (q - 1) // _gcd(p - 1, q - 1)
        # decryption constant for level 1: (L((1+N)^lam mod N^2))^-1 mod N
        u = pow(1 + self.n, self.lam, self.n2)
        self.mu1 = pow((u - 1) // self.n, -1, self.n)
        self.inv_lam_n2 = pow(self.lam, -1, self.n2)
        self.inv_n_lam = pow(self.n % self.lam, -1, self.lam)
        self.inv_n2_lam = pow((self.n2) % self.lam, -1, self.lam)
        # CRT constants per level for the sk-side modexp fast path
        # (_powmod_batch_sk): (p^s, q^s, phi(p^s), phi(q^s), (p^s)^-1 mod q^s)
        self._crt = {}
        for s in (1, 2, 3):
            ps, qs = p**s, q**s
            self._crt[s] = (ps, qs, ps // p * (p - 1), qs // q * (q - 1),
                            pow(ps, -1, qs))

    @property
    def public_key(self) -> PublicKey:
        return PublicKey(self.n)

    # -- CRT modexp fast path (sk-side only) --

    def _powmod_batch_sk(self, bases, exps, s: int,
                         common_base: bool = False) -> list:
        """Batched pow(base, exp, N^s) via the CRT over p^s / q^s with
        exponents reduced mod phi: knowing the factorization makes every
        sk-side ladder ~4x cheaper (half-width modulus, shorter exponent).
        Equal to the plain path: a mathematical identity. On the device
        route both halves ride one launch of kernel 9, a modulus per row."""
        ps, qs, phip, phiq, inv_ps_qs = self._crt[s]
        blist = [bases] * len(exps) if common_base else list(bases)
        if any(b % self.p == 0 or b % self.q == 0 for b in blist):
            # non-unit base (a factor leak; never a well-formed
            # ciphertext): exponent reduction is invalid, take the
            # plain single-modulus path
            return _powmod_batch(bases, exps, ps * qs, common_base=common_base)
        ep = [e % phip for e in exps]
        eq = [e % phiq for e in exps]
        route = _route()
        if route is not None and 2 * len(exps) >= _DEVICE_MODEXP_MIN_BATCH:
            from .mont import device_powmod_batch_multi

            res = device_powmod_batch_multi(
                [b % ps for b in blist] + [b % qs for b in blist],
                ep + eq, [ps] * len(exps) + [qs] * len(exps), device=route[0])
            xps, xqs = res[:len(exps)], res[len(exps):]
        elif common_base:
            xps = _powmod_batch(bases % ps, ep, ps, common_base=True)
            xqs = _powmod_batch(bases % qs, eq, qs, common_base=True)
        else:
            xps = _powmod_batch([b % ps for b in blist], ep, ps)
            xqs = _powmod_batch([b % qs for b in blist], eq, qs)
        return [xp + ps * ((xq - xp) * inv_ps_qs % qs)
                for xp, xq in zip(xps, xqs)]

    def _powmod_sk(self, b: int, e: int, s: int) -> int:
        """Single sk-side pow(b, e, N^s) (CRT; see _powmod_batch_sk)."""
        ps, qs, phip, phiq, inv_ps_qs = self._crt[s]
        if b % self.p == 0 or b % self.q == 0:
            return _powmod(b, e, ps * qs)
        xp = _powmod(b % ps, e % phip, ps)
        xq = _powmod(b % qs, e % phiq, qs)
        return xp + ps * ((xq - xp) * inv_ps_qs % qs)

    # -- decryption --

    def decrypt(self, ct: Ciphertext) -> int:
        assert ct.level == ENC_LEVEL_ONE
        if ct.c == 0:
            # all-zero nested queries produce inner value 0 (not a group
            # element); the reference's gmp pipeline decrypts it to 0
            # (db_test.go:159-196 relies on this), so mirror that.
            return 0
        u = self._powmod_sk(ct.c, self.lam, 2)
        return (u - 1) // self.n * self.mu1 % self.n

    def _dj_log(self, a: int, s: int) -> int:
        """Extract i from (1+N)^i mod N^{s+1} (Damgård–Jurik, Thm 1)."""
        n = self.n
        i = 0
        for j in range(1, s + 1):
            nj = n ** j
            nj1 = nj * n
            t1 = ((a % nj1) - 1) // n  # in Z_{n^j}
            t2 = i
            kfact = 1
            for k in range(2, j + 1):
                i = i - 1
                t2 = t2 * i % nj
                kfact *= k
                t1 = (t1 - t2 * (n ** (k - 1)) * pow(kfact, -1, nj)) % nj
            i = t1
        return i

    def decrypt_batch(self, cts) -> list:
        """Batched level-1 decryption (the c^lambda modexps through the
        CRT batch). The c == 0 quirk matches decrypt()."""
        assert all(ct.level == ENC_LEVEL_ONE for ct in cts)
        live = [i for i, ct in enumerate(cts) if ct.c != 0]
        out = [0] * len(cts)
        us = self._powmod_batch_sk([cts[i].c for i in live],
                                   [self.lam] * len(live), 2)
        for i, u in zip(live, us):
            out[i] = (u - 1) // self.n * self.mu1 % self.n
        return out

    def decrypt_level2(self, ct: Ciphertext) -> int:
        assert ct.level == ENC_LEVEL_TWO
        u = self._powmod_sk(ct.c, self.lam, 3)
        i = self._dj_log(u, 2)
        return i * self.inv_lam_n2 % self.n2

    def decrypt_level2_batch(self, cts) -> list:
        assert all(ct.level == ENC_LEVEL_TWO for ct in cts)
        us = self._powmod_batch_sk([ct.c for ct in cts],
                                   [self.lam] * len(cts), 3)
        return [self._dj_log(u, 2) * self.inv_lam_n2 % self.n2 for u in us]

    def decrypt_nested_layer(self, ct: Ciphertext) -> Ciphertext:
        """Level-2 -> the inner level-1 ciphertext (aspir.go:166)."""
        return Ciphertext(self.decrypt_level2(ct), ENC_LEVEL_ONE)

    def nested_decrypt(self, ct: Ciphertext) -> int:
        """query.go:325: peel both layers."""
        return self.decrypt(self.decrypt_nested_layer(ct))

    def nested_decrypt_batch(self, cts) -> list:
        """Batched two-layer decryption (query.go:325 over a vector)."""
        inner = self.decrypt_level2_batch(cts)
        return self.decrypt_batch(
            [Ciphertext(c, ENC_LEVEL_ONE) for c in inner]
        )

    # -- randomness extraction (aspir.go:164-168) --

    def extract_randomness(self, ct: Ciphertext) -> int:
        if ct.level == ENC_LEVEL_ONE:
            m = self.decrypt(ct)
            rn = ct.c * pow(self._g_pow(m, 1), -1, self.n2) % self.n2
            return self._powmod_sk(rn % self.n, self.inv_n_lam, 1)
        m2 = self.decrypt_level2(ct)
        sn = ct.c * pow(self._g_pow(m2, 2), -1, self.n3) % self.n3
        return self._powmod_sk(sn % self.n, self.inv_n2_lam, 1)

    # -- nested randomization + DDLEQ prove (aspir.go:156-158) --

    def nested_randomize(self, ct: Ciphertext) -> tuple[Ciphertext, int, int]:
        assert ct.level == ENC_LEVEL_TWO
        a = self.random_r()
        b = self.random_r()
        alpha = self._powmod_sk(a, self.n, 2)
        c2 = (self._powmod_sk(ct.c, alpha, 3)
              * self._powmod_sk(b, self.n2, 3) % self.n3)
        return Ciphertext(c2, ENC_LEVEL_TWO), a, b

    def prove_ddleq(
        self, secparam: int, ct1: Ciphertext, ct2: Ciphertext, a: int, b: int
    ) -> DDLEQProof:
        """PoK{(a,b): ct2 = ct1^(a^N) * b^(N^2)} — see module docstring.

        All `8*secparam` independent repetitions batch their modexps
        through the sk-side CRT fast path (_powmod_batch_sk: half-width
        moduli, phi-reduced exponents).
        """
        n, n2, n3 = self.n, self.n2, self.n3
        reps = 8 * secparam
        alpha = self._powmod_sk(a, n, 2)
        us = [self.random_r() for _ in range(reps)]
        vs = [self.random_r() for _ in range(reps)]
        es = self._powmod_batch_sk(us, [n] * reps, 2)  # u^N mod N^2
        # commitments T_i = ct2^(u^N) * v^(N^2): both mod-N^3 batches in one call
        tabs = self._powmod_batch_sk(
            [ct2.c] * reps + vs, es + [n2] * reps, 3)
        ts = [ta * tb % n3 for ta, tb in zip(tabs[:reps], tabs[reps:])]
        bits = _fs_challenge_bits(n, ct1.c, ct2.c, ts, reps)
        idx1 = [i for i, bit in enumerate(bits) if bit == 1]
        # bit 1 openings: T = ct2^(u^N) v^(N^2)
        #               = ct1^(alpha*u^N) b^(N^2 u^N) v^(N^2).
        # The exponent overshoot alpha*e_u - z^N is an exact non-negative
        # multiple of N^2 with (au)^N === (au mod N)^N (mod N^2) — expand
        # (z + kN)^N binomially: every term past z^N carries N^2 — so the
        # folded multiplier is simply floor(alpha*e_u / N^2); the old
        # z^N mod N^2 modexp batch cancels out of the algebra entirely.
        zs = [a * us[i] % n for i in idx1]
        deltas = [alpha * es[i] // n2 for i in idx1]
        pows = self._powmod_batch_sk(
            [b] * len(idx1) + [ct1.c] * len(idx1),
            [es[i] for i in idx1] + deltas, 3)
        b_pows, ct1_pows = pows[:len(idx1)], pows[len(idx1):]
        responses = []
        k = 0
        for i, bit in enumerate(bits):
            if bit == 0:
                responses.append((us[i], vs[i]))
            else:
                w = b_pows[k] * vs[i] * ct1_pows[k] % n3
                responses.append((zs[k], w))
                k += 1
        return DDLEQProof(ts, responses, secparam)


def _fs_challenge_bits(n: int, c1: int, c2: int, commitments: list[int], reps: int):
    h = hashlib.sha256()
    for v in (n, c1, c2, *commitments):
        b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        h.update(len(b).to_bytes(4, "big"))
        h.update(b)
    digest = h.digest()
    bits = []
    counter = 0
    while len(bits) < reps:
        d = hashlib.sha256(digest + counter.to_bytes(4, "big")).digest()
        for byte in d:
            for k in range(8):
                bits.append((byte >> k) & 1)
        counter += 1
    return bits[:reps]


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def keygen(bits: int) -> tuple[SecretKey, PublicKey]:
    """paillier.KeyGen(bits) -> (sk, pk); N is ~`bits` bits."""
    while True:
        p = _random_prime(bits // 2)
        q = _random_prime(bits - bits // 2)
        if p != q:
            n = p * q
            lam = (p - 1) * (q - 1) // _gcd(p - 1, q - 1)
            if _gcd(n, lam) == 1:
                break
    sk = SecretKey(p, q)
    return sk, sk.public_key


def msg_space_bytes(pk: PublicKey) -> int:
    """Bytes per plaintext chunk: len(N.Bytes()) - 2 (db.go:187)."""
    return (pk.n.bit_length() + 7) // 8 - 2
