"""Client-side query construction and answer recovery (counterpart of
``pir_tpu/query.py``). The port builds 2-server index queries of both
key styles: reference-exact ("compat") keys, the default as in the
reference, and fast keys (``fast=True``). Every builder makes two
shares, so none takes a share count; keygen randomness comes from
``rand_bytes``."""

from __future__ import annotations

import os
from dataclasses import dataclass

from .database import DBMetadata
from .dpf import host as dpf
from .dpf.host import RandBytes
from .slot import Slot, new_empty_slot, xor_slots
from .utils.bits import num_bits_for_height


@dataclass
class QueryShare:
    """One server's share of a DPF query (query.go:12-22).

    The field set mirrors ``pir_tpu.query.QueryShare``: exactly one of
    ``key_two_party`` (a reference-exact key) and ``key_fast`` is set.
    Multi-party keys are not built by the port and stay None.
    """

    key_two_party: dpf.Key2P | None
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


def _dim_height(dbmd: DBMetadata, group_size: int) -> int:
    dim_height = dbmd.db_size // group_size
    if dim_height == 0:
        raise ValueError("database height is set to zero; something is wrong")
    return dim_height


def _fast_geometry(dbmd: DBMetadata, group_size: int,
                   leaf_bits: int | None) -> tuple[int, int]:
    dim_height = _dim_height(dbmd, group_size)
    lb = dpf.fast_leaf_bits_for_height(
        dim_height, leaf_bits or dpf.DEFAULT_FAST_LEAF_BITS
    )
    return dim_height, lb


def _shares(pf: dpf.Dpf, pair: list, group_size: int) -> list[QueryShare]:
    """[share_0, share_1] around a key pair of either style."""
    compat = isinstance(pair[0], dpf.Key2P)
    return [
        QueryShare(
            key_two_party=pair[i] if compat else None,
            key_multi_party=None,
            prf_keys=pf.prf_keys,
            is_keyword_based=False,
            is_two_party=True,
            share_number=i,
            group_size=group_size,
            key_fast=None if compat else pair[i],
        )
        for i in range(2)
    ]


def new_fast_index_query_shares(
    dbmd: DBMetadata, index: int, group_size: int,
    leaf_bits: int | None = None, rand_bytes: RandBytes = os.urandom,
) -> list[QueryShare]:
    """One fast query with its own PRF keys (a distinct-key client);
    returns [share_0, share_1]."""
    dim_height, lb = _fast_geometry(dbmd, group_size, leaf_bits)
    pf = dpf.client_initialize(dpf.fast_depth_for_height(dim_height, lb),
                               rand_bytes)
    keys = dpf.generate_two_server_fast(pf, index, dim_height, leaf_bits=lb,
                                        rand_bytes=rand_bytes)
    return _shares(pf, keys, group_size)


def _new_query_shares(dbmd: DBMetadata, index: int, group_size: int,
                      rand_bytes: RandBytes = os.urandom) -> list[QueryShare]:
    """One reference-exact index query (query.go:52-101, two-party),
    including its domain check after keygen."""
    dim_height = _dim_height(dbmd, group_size)
    pf = dpf.client_initialize(num_bits_for_height(dim_height), rand_bytes)
    keys = dpf.generate_two_server(pf, index, 1, rand_bytes)
    if index >= dim_height:
        raise ValueError("requesting key outside of domain")
    return _shares(pf, keys, group_size)


def _new_query_shares_batch(dbmd: DBMetadata, indices: list[int], group_size: int,
                            rand_bytes: RandBytes = os.urandom) -> list[list[QueryShare]]:
    """Reference-exact index shares for a batch: one vectorised keygen
    walk, one set of (public) PRF keys, per-query seeds."""
    dim_height = _dim_height(dbmd, group_size)
    if any(i >= dim_height for i in indices):
        raise ValueError("requesting key outside of domain")
    pf = dpf.client_initialize(num_bits_for_height(dim_height), rand_bytes)
    pairs = dpf.generate_two_server_batch(pf, list(indices), 1, rand_bytes)
    return [_shares(pf, pair, group_size) for pair in pairs]


def new_index_query_shares(
    dbmd: DBMetadata, index: int, group_size: int, fast: bool = False,
    leaf_bits: int | None = None, rand_bytes: RandBytes = os.urandom,
) -> list[QueryShare]:
    """One index query (query.go:42-44): reference-exact keys, or fast
    keys with ``fast=True``; returns [share_0, share_1]."""
    if fast:
        return new_fast_index_query_shares(dbmd, index, group_size,
                                           leaf_bits=leaf_bits, rand_bytes=rand_bytes)
    return _new_query_shares(dbmd, index, group_size, rand_bytes)


def new_index_query_shares_batch(
    dbmd: DBMetadata, indices: list[int], group_size: int, fast: bool = False,
    leaf_bits: int | None = None, rand_bytes: RandBytes = os.urandom,
) -> list[list[QueryShare]]:
    """Batched share construction: one vectorised keygen walk for the
    whole batch, reference-exact keys or fast keys (``fast=True``). All
    queries share one set of (public) PRF keys; seeds stay per query.
    Returns one [share_0, share_1] pair per index."""
    if not fast:
        return _new_query_shares_batch(dbmd, indices, group_size, rand_bytes)
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
