"""The plain reference: both servers' answer shares of a set of pool
queries, from the seed's table and the pool's key bytes alone.

Each share is evaluated over every row (``dpf_ref``), and its answer is
the XOR of the table rows it selects, gathered and folded in plain
PyTorch. It imports nothing of the system under test and takes nothing it
made: the table is made again from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

import dpf_ref
import traffic

# compat shares evaluated at once (each walk holds 2^20 seeds a query)
COMPAT_CHUNK = 8
FAST_CHUNK = 256


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


def share_bits(config: dict, pool: traffic.Pool, server: int, idx: np.ndarray,
               device) -> torch.Tensor:
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


def answers(config: dict, seed: int, pool: traffic.Pool, idx: np.ndarray, device,
            width: int | None = None) -> dict:
    """For pool queries `idx`: each server's answer share ("share0",
    "share1") and the table row asked for ("rows"), (len(idx), row_bytes)
    uint8 numpy arrays. With `width`, the rows' bytes from `width` on are
    left out (zero): the control's broken guarantee."""
    table = traffic.make_table(config, seed, device)
    if width is not None:
        table[:, width:] = 0
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
