"""dpf2: two-server DPF index PIR, the plain side. Each server holds the
table; a client splits a query into two DPF key shares, and each server
answers with the XOR of the table rows its share selects.

* ``make_pool``: the pool of queries from the seed, keys made by the
  frozen keygen of ``dpf_ref`` (fast or compat, as the configuration's
  ``keys`` states);
* ``answers``: the plain reference, both servers' answer shares of a set
  of pool queries from the seed's table and the pool's key bytes alone:
  each share evaluated over every row (``dpf_ref``), its answer the XOR of
  the rows it selects, gathered and folded in plain PyTorch;
* ``compare``: every kept answer against the reference (the numbers that
  decide ``correct``).

It imports nothing of the system under test and takes nothing it made:
the table is made again from the seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

import dpf_ref
import traffic

# what a configuration of this protocol states (fast keys add leaf_bits)
CONFIG_KEYS = ("rows", "row_bytes", "servers", "group_size", "keys", "server_options")
# the answers' key of what the chip, server 0, answers
SERVED = "share0"
# compat shares evaluated at once (each walk holds 2^20 seeds a query)
COMPAT_CHUNK = 8
FAST_CHUNK = 256
# name -> (limit, rule): the value must be <= the limit ("max") or >= it ("min")
LIMITS = {"mismatched": (0, "max"), "unrecovered": (0, "max"), "missing": (0, "max"),
          "checked": (1, "min")}


@dataclass
class Pool:
    """The pool of queries: targets (P,), the client of each query (P,),
    each client's public PRF keys (4 x 16 bytes), and per server s the key
    fields s{s}, t{s} and the shared cw and, for fast keys, fcw or, for
    compat keys, final_cw (numpy arrays)."""

    targets: np.ndarray
    client: np.ndarray
    prf_keys: list[list[bytes]]
    keys: dict
    style: str
    num_levels: int

    def fields(self, server: int, idx, device) -> tuple:
        """The key fields of pool queries `idx` for `server`, as tensors."""
        k = self.keys
        last = "fcw" if self.style == "fast" else "final_cw"
        return tuple(torch.from_numpy(np.ascontiguousarray(a[idx])).to(device)
                     for a in (k[f"s{server}"], k[f"t{server}"], k["cw"], k[last]))

    def by_client(self, idx: np.ndarray) -> list[tuple[int, np.ndarray]]:
        """(client, positions into idx) of the clients that queries `idx` hold."""
        c = self.client[idx]
        return [(int(u), np.flatnonzero(c == u)) for u in np.unique(c)]


def make_pool(config: dict, mix: dict, seed: int, device) -> Pool:
    """The cell's pool of queries, keys made on `device`: with the mix's
    ``clients`` n, client c asks pool queries [c P / n, (c + 1) P / n) with
    its own PRF keys."""
    p, rows, n = mix["pool"], config["rows"], mix.get("clients", 1)
    targets = traffic.rng(seed, "targets").integers(0, rows, p)
    client = np.arange(p) * n // p
    raw = traffic.rng(seed, "prf_keys").bytes(64 * n)
    prf_keys = [[raw[64 * c + 16 * i:64 * c + 16 * (i + 1)] for i in range(4)]
                for c in range(n)]
    rnd = np.frombuffer(traffic.rng(seed, "keys").bytes(p * 33), np.uint8).reshape(p, 33)
    parts = []
    for c in range(n):
        sel = np.flatnonzero(client == c)
        rks = dpf_ref.round_keys(prf_keys[c], device)
        if config["keys"] == "fast":
            parts.append(dpf_ref.fast_keygen(rks, targets[sel], rows, config["leaf_bits"],
                                             rnd[sel], device))
        else:
            parts.append(dpf_ref.compat_keygen(rks, targets[sel],
                                               dpf_ref.num_bits_for_height(rows), rnd[sel],
                                               device))
    keys = {k: np.concatenate([part[k] for part in parts]) for k in parts[0]}
    return Pool(targets, client, prf_keys, keys, config["keys"], keys["cw"].shape[1])


def xor_rows(table: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The XOR of the rows of (H, B) `table` where (H,) `bits` is 1: (B,)."""
    words = table.view(torch.int64) if table.shape[1] % 8 == 0 else table
    x = words[bits.bool()]
    if x.shape[0] == 0:
        return torch.zeros(table.shape[1], dtype=torch.uint8, device=table.device)
    while x.shape[0] > 1:
        n = x.shape[0]
        y = x[:n // 2] ^ x[n // 2:2 * (n // 2)]
        if n % 2:
            y[0] ^= x[-1]
        x = y
    return x[0].view(torch.uint8)


def share_bits(config: dict, pool: Pool, server: int, idx: np.ndarray, device) -> torch.Tensor:
    """(len(idx), rows) uint8 selection bits of `server`'s shares, each
    evaluated under its own client's PRF keys."""
    out = torch.empty((len(idx), config["rows"]), dtype=torch.uint8, device=device)
    for c, pos in pool.by_client(idx):
        rks = dpf_ref.round_keys(pool.prf_keys[c], device)
        fields = pool.fields(server, idx[pos], device)
        if pool.style == "fast":
            bits = dpf_ref.fast_bits(rks, *fields, config["rows"])
        else:
            bits = dpf_ref.compat_bits(rks, server, *fields, config["rows"])
        out[torch.from_numpy(pos).to(device)] = bits
    return out


def answers(config: dict, seed: int, pool: Pool, idx: np.ndarray, device,
            broken: bool = False) -> dict:
    """For pool queries `idx`: each server's answer share ("share0",
    "share1") and the table row asked for ("rows"), (len(idx), row_bytes)
    uint8 numpy arrays. With `broken`, the rows' last byte is left out
    (zero): the control's broken guarantee, rows one byte narrower."""
    table = traffic.make_table(config, seed, device)
    if broken:
        table[:, config["row_bytes"] - 1:] = 0
    chunk = FAST_CHUNK if pool.style == "fast" else COMPAT_CHUNK
    out = {"share0": [], "share1": []}
    for i in range(0, len(idx), chunk):
        part = idx[i:i + chunk]
        for s in (0, 1):
            bits = share_bits(config, pool, s, part, device)
            out[f"share{s}"].append(torch.stack([xor_rows(table, b) for b in bits]).cpu())
            del bits
    res = {k: torch.cat(v).numpy() for k, v in out.items()}
    res["rows"] = table[torch.from_numpy(pool.targets[idx]).to(device)].cpu().numpy()
    return res


def compare(kept: list, draws: list, sample: np.ndarray, ref: dict, missing: int) -> dict:
    """Every kept answer against the reference: it has to equal the
    reference's server-0 share byte for byte (``mismatched``), and with the
    reference's server-1 share it has to recover the row asked for
    (``unrecovered``). kept: (draw, position, answer bytes) of the run;
    draws: the pool positions of each draw; sample: the sorted pool queries
    the reference answered; ref: ``answers``' arrays; missing: the answers
    that never came."""
    mismatched = unrecovered = 0
    for d, pos, ans in kept:
        i = int(np.searchsorted(sample, draws[d][pos]))
        got = np.frombuffer(ans, np.uint8)
        if len(got) != ref["share0"].shape[1] or not np.array_equal(got, ref["share0"][i]):
            mismatched += 1
        if len(got) != ref["share1"].shape[1] or not np.array_equal(got ^ ref["share1"][i],
                                                                      ref["rows"][i]):
            unrecovered += 1
    values = {"mismatched": mismatched, "unrecovered": unrecovered, "missing": missing,
              "checked": len(kept)}
    return {k: {"value": v, "limit": LIMITS[k][0], "rule": LIMITS[k][1]}
            for k, v in values.items()}
