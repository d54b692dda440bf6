"""Client-side fast-mode query construction and answer recovery
(counterpart of ``pir_tpu/query.py``). The port builds and serves
fast-mode 2-server index queries only, so the share builders take no
mode or share-count arguments."""

from __future__ import annotations

import os
from dataclasses import dataclass

from .database import DBMetadata
from .dpf import host as dpf
from .dpf.host import RandBytes
from .slot import Slot, new_empty_slot, xor_slots


@dataclass
class QueryShare:
    """One server's share of a fast-mode DPF query.

    The field set mirrors ``pir_tpu.query.QueryShare``; the reference-
    exact and multi-party keys are not served by the port and stay None.
    """

    key_two_party: None
    key_multi_party: None
    prf_keys: list[dpf.PrfKey]
    is_keyword_based: bool
    is_two_party: bool
    share_number: int
    group_size: int
    key_fast: dpf.FastKey2P | None = None


@dataclass
class SecretSharedQueryResult:
    """Shares of the resulting slots."""

    slot_bytes: int
    shares: list[Slot]


def _fast_geometry(dbmd: DBMetadata, group_size: int,
                   leaf_bits: int | None) -> tuple[int, int]:
    dim_height = dbmd.db_size // group_size
    if dim_height == 0:
        raise ValueError("database height is set to zero; something is wrong")
    lb = dpf.fast_leaf_bits_for_height(
        dim_height, leaf_bits or dpf.DEFAULT_FAST_LEAF_BITS
    )
    return dim_height, lb


def _shares(pf: dpf.Dpf, pair: list[dpf.FastKey2P], group_size: int) -> list[QueryShare]:
    return [
        QueryShare(
            key_two_party=None,
            key_multi_party=None,
            prf_keys=pf.prf_keys,
            is_keyword_based=False,
            is_two_party=True,
            share_number=i,
            group_size=group_size,
            key_fast=pair[i],
        )
        for i in range(2)
    ]


def new_fast_index_query_shares(
    dbmd: DBMetadata, index: int, group_size: int,
    leaf_bits: int | None = None, rand_bytes: RandBytes = os.urandom,
) -> list[QueryShare]:
    """One query with its own PRF keys (a distinct-key client); returns
    [share_0, share_1]."""
    dim_height, lb = _fast_geometry(dbmd, group_size, leaf_bits)
    pf = dpf.client_initialize(dpf.fast_depth_for_height(dim_height, lb),
                               rand_bytes)
    keys = dpf.generate_two_server_fast(pf, index, dim_height, leaf_bits=lb,
                                        rand_bytes=rand_bytes)
    return _shares(pf, keys, group_size)


def new_index_query_shares_batch(
    dbmd: DBMetadata, indices: list[int], group_size: int,
    leaf_bits: int | None = None, rand_bytes: RandBytes = os.urandom,
) -> list[list[QueryShare]]:
    """Batched fast-mode share construction: one vectorised keygen walk
    for the whole batch. All queries share one set of (public) PRF keys;
    seeds stay per-query. Returns one [share_0, share_1] pair per index."""
    dim_height, lb = _fast_geometry(dbmd, group_size, leaf_bits)
    pf = dpf.client_initialize(dpf.fast_depth_for_height(dim_height, lb),
                               rand_bytes)
    key_pairs = dpf.generate_two_server_fast_batch(
        pf, indices, dim_height, leaf_bits=lb, rand_bytes=rand_bytes)
    return [_shares(pf, pair, group_size) for pair in key_pairs]


def recover(res_shares: list[SecretSharedQueryResult]) -> list[Slot]:
    """XOR all servers' share vectors per column."""
    num_slots = len(res_shares[0].shares)
    out = [new_empty_slot(res_shares[0].slot_bytes) for _ in range(num_slots)]
    for share in res_shares:
        for j in range(num_slots):
            xor_slots(out[j], share.shares[j])
    return out
