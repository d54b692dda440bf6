"""cpir: single-server computational PIR under Paillier, the plain side.
The server holds the table as a grid of ``grid_height`` rows of
``grid_width`` slots. A client sends one level-1 Paillier ciphertext a
grid row under its own modulus N (g = N + 1): an encryption of 1 at its
target's row and of 0 elsewhere. The server answers each column with
``answer[col] = prod_row ebit[row]^slot(row, col) mod N^2`` (db.go:176-271),
slot(row, col) the big-endian int of the bytes of slot row * width + col
(one chunk a slot), and the client decrypts its target's column.

* ``make_pool``: each client's key (two primes of key_bits / 2 bits, by
  Miller-Rabin) and its queries' ebits, from the seed;
* ``answers``: the plain reference, every answer ciphertext from the
  pool's blinding exponents and the table made again from the seed, in
  Python integers;
* ``compare``: every kept answer against the reference, and its target's
  column decrypted with the client's secret key against the table.

The blinding factors. A Paillier encryption draws a fresh r a row (r^N
mod N^2: ~16 ms in CPython, 16 s for a query's 1,024 rows). Here a query
draws one rho and S = rho^N mod N^2, and row r's factor is S^k_r, k_r the
running sum of r + 1 steps in [1, 256): each ebit costs one modular
product through a table of S^1 .. S^255. Every ebit is still a
full-width residue mod N^2 and the server's work does not depend on it;
only the client's randomness is correlated (the configuration states it
under ``assumed``). The reference then computes a column as
(1 + slot(t, col) N) * S^(sum_r k_r slot(r, col)) mod N^2, t the target's
row: one modexp of an exponent below 2^52, not 1,024 of 24-bit ones.

It imports nothing of the system under test and takes nothing it made.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import traffic

CONFIG_KEYS = ("rows", "row_bytes", "servers", "group_size", "key_bits", "grid_height",
               "grid_width", "chunks", "server_options")
# the answers' key of what the chip answers
SERVED = "answers"
# name -> (limit, rule): the value must be <= the limit ("max") or >= it ("min")
LIMITS = {"mismatched": (0, "max"), "unrecovered": (0, "max"), "missing": (0, "max"),
          "checked": (1, "min")}
STEPS = 256  # a row's blinding step is in [1, STEPS)
SMALL_PRIMES = [p for p in range(3, 2000) if all(p % d for d in range(2, int(p ** 0.5) + 1))]
MR_BASES = SMALL_PRIMES[:24]


@dataclass
class Pool:
    """The pool of queries: targets (P,), the client of each query (P,),
    each client's primes (p, q), and per query its S = rho^N mod N^2, its
    blinding steps (P, grid_height) in [1, STEPS) and its ebits (P lists of
    grid_height ints)."""

    targets: np.ndarray
    client: np.ndarray
    primes: list[tuple[int, int]]
    blind: list[int]
    steps: np.ndarray
    ebits: list[list[int]]

    def modulus(self, i: int) -> int:
        """N of pool query i's client."""
        p, q = self.primes[int(self.client[i])]
        return p * q


def is_probable_prime(x: int) -> bool:
    """Trial division by the small primes, then Miller-Rabin to the bases
    MR_BASES (a random candidate passes by error with odds below 4^-24)."""
    if x < 2:
        return False
    for p in SMALL_PRIMES:
        if x % p == 0:
            return x == p
    d, s = x - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in MR_BASES:
        y = pow(a, d, x)
        if y in (1, x - 1):
            continue
        for _ in range(s - 1):
            y = y * y % x
            if y == x - 1:
                break
        else:
            return False
    return True


def make_prime(rng: np.random.Generator, bits: int) -> int:
    """The first prime from a random odd `bits`-bit start whose top two
    bits are set (so two such primes make a modulus of 2 * bits bits)."""
    x = int.from_bytes(rng.bytes(-(-bits // 8)), "big") >> (-bits % 8)
    x |= (3 << (bits - 2)) | 1
    while not is_probable_prime(x):
        x += 2
    return x


def ct_bytes(n: int) -> int:
    """Bytes of one answer ciphertext mod N^2, fixed width."""
    return (2 * n.bit_length() + 7) // 8


def make_pool(config: dict, mix: dict, seed: int, device=None) -> Pool:
    """The cell's pool of queries: with the mix's ``clients`` n, client c
    asks pool queries [c P / n, (c + 1) P / n) under its own key."""
    p_count, rows, n_clients = mix["pool"], config["rows"], mix.get("clients", 1)
    h, w, bits = config["grid_height"], config["grid_width"], config["key_bits"]
    if config["chunks"] != 1 or 8 * config["row_bytes"] > bits - 16:
        raise ValueError("one chunk a slot: a slot must fit Paillier's plaintext")
    if h * w < rows:
        raise ValueError("the grid does not hold the table")
    targets = traffic.rng(seed, "targets").integers(0, rows, p_count)
    client = np.arange(p_count) * n_clients // p_count
    r = traffic.rng(seed, "keys")
    primes = []
    for _ in range(n_clients):
        p = make_prime(r, bits // 2)
        q = make_prime(r, bits // 2)
        while q == p:
            q = make_prime(r, bits // 2)
        primes.append((p, q))
    steps = r.integers(1, STEPS, (p_count, h), dtype=np.int64)
    blind, ebits = [], []
    for i in range(p_count):
        n = primes[client[i]][0] * primes[client[i]][1]
        n2 = n * n
        rho = int.from_bytes(r.bytes(ct_bytes(n) // 2), "big") % (n - 2) + 2
        s = pow(rho, n, n2)
        powers = [1, s]
        for _ in range(STEPS - 2):
            powers.append(powers[-1] * s % n2)
        t_row = int(targets[i]) // w
        acc, bits_i = 1, []
        for row, d in enumerate(steps[i].tolist()):
            acc = acc * powers[d] % n2
            bits_i.append((1 + n) * acc % n2 if row == t_row else acc)
        blind.append(s)
        ebits.append(bits_i)
    return Pool(targets, client, primes, blind, steps, ebits)


def grid_slots(config: dict, table: np.ndarray) -> np.ndarray:
    """(grid_height, grid_width) int64 slot values, big-endian, 0 past the
    table."""
    h, w = config["grid_height"], config["grid_width"]
    vals = np.zeros(h * w, dtype=np.int64)
    for b in range(table.shape[1]):
        vals[:len(table)] = (vals[:len(table)] << 8) | table[:, b]
    return vals.reshape(h, w)


def answers(config: dict, seed: int, pool: Pool, idx: np.ndarray, device,
            broken: bool = False) -> dict:
    """For pool queries `idx`: each one's answer, its grid_width
    ciphertexts as fixed-width big-endian bytes ("answers", (len(idx),
    grid_width * ct_bytes) uint8), the slot asked for ("rows"), its column
    ("col") and its client's primes ("primes", objects). With `broken`,
    every slot loses its last byte (zero): the control's broken
    guarantee."""
    table = traffic.make_table(config, seed, device).cpu().numpy()
    if broken:
        table[:, config["row_bytes"] - 1] = 0
    grid = grid_slots(config, table)
    h, w = grid.shape
    if h * (STEPS - 1) * h * (1 << 8 * config["row_bytes"]) >= 1 << 63:
        raise ValueError("the blinding exponents overflow 64 bits at this grid")
    out, cols, primes = [], [], []
    for i in idx:
        n = pool.modulus(i)
        n2, width = n * n, ct_bytes(n)
        k = np.cumsum(pool.steps[i])
        e = (k @ grid).tolist()  # sum_r k_r slot(r, col), exact below 2^63
        t_row, t_col = divmod(int(pool.targets[i]), w)
        s = pool.blind[i]
        cts = [(1 + int(grid[t_row, c]) * n) * pow(s, e[c], n2) % n2 for c in range(w)]
        out.append(np.frombuffer(b"".join(c.to_bytes(width, "big") for c in cts), np.uint8))
        cols.append(t_col)
        primes.append(pool.primes[int(pool.client[i])])
    prim = np.empty(len(primes), dtype=object)
    prim[:] = primes
    return {"answers": np.stack(out), "rows": table[pool.targets[idx]],
            "col": np.array(cols, dtype=np.int64), "primes": prim}


def decrypt(c: int, p: int, q: int) -> int:
    """Paillier decryption by CRT (g = N + 1): m mod p from
    L_p(c^(p-1) mod p^2) over L_p(g^(p-1) mod p^2), the same mod q."""
    n = p * q
    parts = []
    for a in (p, q):
        a2 = a * a
        lc = (pow(c, a - 1, a2) - 1) // a
        lg = (pow(n + 1, a - 1, a2) - 1) // a
        parts.append(lc * pow(lg, -1, a) % a)
    mp, mq = parts
    return (mp + p * ((mq - mp) * pow(p, -1, q) % q)) % n


def compare(kept: list, draws: list, sample: np.ndarray, ref: dict, missing: int) -> dict:
    """Every kept answer against the reference: it has to equal the
    reference's answer byte for byte (``mismatched``), and its target's
    column, decrypted with the client's secret key, has to give the slot
    asked for (``unrecovered``). kept: (draw, position, answer bytes) of
    the run; draws: the pool positions of each draw; sample: the sorted
    pool queries the reference answered; ref: ``answers``' arrays;
    missing: the answers that never came."""
    mismatched = unrecovered = 0
    served = ref[SERVED]
    plain = {}  # (sample row, ciphertext) -> decrypted slot bytes
    for d, pos, ans in kept:
        i = int(np.searchsorted(sample, draws[d][pos]))
        got = np.frombuffer(ans, np.uint8)
        if len(got) != served.shape[1] or not np.array_equal(got, served[i]):
            mismatched += 1
        p, q = ref["primes"][i]
        width = ct_bytes(p * q)
        col = int(ref["col"][i])
        c = int.from_bytes(ans[col * width:(col + 1) * width], "big")
        if (i, c) not in plain:
            m = decrypt(c, p, q) if len(ans) >= (col + 1) * width else -1
            nb = ref["rows"].shape[1]
            plain[i, c] = m.to_bytes(nb, "big") if 0 <= m < 1 << 8 * nb else None
        if plain[i, c] != ref["rows"][i].tobytes():
            unrecovered += 1
    values = {"mismatched": mismatched, "unrecovered": unrecovered, "missing": missing,
              "checked": len(kept)}
    return {k: {"value": v, "limit": LIMITS[k][0], "rule": LIMITS[k][1]}
            for k, v in values.items()}
