"""Client-side query construction and answer recovery (counterpart of
``pir_tpu/query.py``). Index queries come in both key styles:
reference-exact ("compat") keys, the default as in the reference, and
fast keys (``fast=True``, two servers only). Keyword queries are
reference-exact keys over the 32-bit keyword domain. ``num_shares >= 3``
builds multi-party keys (one share per server). Keygen randomness comes
from ``rand_bytes``."""

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
    ``key_two_party`` (a reference-exact key), ``key_multi_party`` and
    ``key_fast`` is set.
    """

    key_two_party: dpf.Key2P | None
    key_multi_party: dpf.KeyMP | None
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


def _shares(pf: dpf.Dpf, keys: list, group_size: int,
            is_keyword_based: bool = False) -> list[QueryShare]:
    """One share per key of a key set of any style: compat or fast pair,
    or multi-party keys."""
    return [
        QueryShare(
            key_two_party=key if isinstance(key, dpf.Key2P) else None,
            key_multi_party=key if isinstance(key, dpf.KeyMP) else None,
            prf_keys=pf.prf_keys,
            is_keyword_based=is_keyword_based,
            is_two_party=len(keys) == 2,
            share_number=i,
            group_size=group_size,
            key_fast=key if isinstance(key, dpf.FastKey2P) else None,
        )
        for i, key in enumerate(keys)
    ]


def _check_two_party_fast(num_shares: int) -> None:
    if num_shares != 2:
        raise NotImplementedError("fast mode is two-party")


def new_fast_index_query_shares(
    dbmd: DBMetadata, index: int, group_size: int,
    leaf_bits: int | None = None, rand_bytes: RandBytes = os.urandom,
    num_shares: int = 2,
) -> list[QueryShare]:
    """One fast query with its own PRF keys (a distinct-key client);
    returns [share_0, share_1]."""
    _check_two_party_fast(num_shares)
    dim_height, lb = _fast_geometry(dbmd, group_size, leaf_bits)
    pf = dpf.client_initialize(dpf.fast_depth_for_height(dim_height, lb),
                               rand_bytes)
    keys = dpf.generate_two_server_fast(pf, index, dim_height, leaf_bits=lb,
                                        rand_bytes=rand_bytes)
    return _shares(pf, keys, group_size)


def _new_query_shares(dbmd: DBMetadata, key: int, group_size: int, num_shares: int,
                      is_index_query: bool,
                      rand_bytes: RandBytes = os.urandom) -> list[QueryShare]:
    """One reference-exact query (query.go:52-101): an index over the
    table's height, checked after keygen as the reference does, or a
    keyword over the 32-bit domain, unchecked; two-party keys, or
    multi-party keys for num_shares >= 3."""
    dim_height = _dim_height(dbmd, group_size)
    num_bits = num_bits_for_height(dim_height) if is_index_query else 32
    pf = dpf.client_initialize(num_bits, rand_bytes)
    if num_shares == 2:
        keys = dpf.generate_two_server(pf, key, 1, rand_bytes)
    else:
        keys = dpf.generate_multi_server(pf, key, 1, num_shares, rand_bytes)
    if is_index_query and key >= dim_height:
        raise ValueError("requesting key outside of domain")
    return _shares(pf, keys, group_size, not is_index_query)


def _new_query_shares_batch(dbmd: DBMetadata, keys: list[int], group_size: int,
                            num_shares: int, is_index_query: bool,
                            rand_bytes: RandBytes = os.urandom) -> list[list[QueryShare]]:
    """Reference-exact shares for a batch: for two parties one vectorised
    keygen walk, one set of (public) PRF keys, per-query seeds; for more,
    one keygen per query."""
    if num_shares != 2:
        return [_new_query_shares(dbmd, k, group_size, num_shares, is_index_query, rand_bytes)
                for k in keys]
    dim_height = _dim_height(dbmd, group_size)
    num_bits = num_bits_for_height(dim_height) if is_index_query else 32
    if is_index_query and any(k >= dim_height for k in keys):
        raise ValueError("requesting key outside of domain")
    pf = dpf.client_initialize(num_bits, rand_bytes)
    pairs = dpf.generate_two_server_batch(pf, list(keys), 1, rand_bytes)
    return [_shares(pf, pair, group_size, not is_index_query) for pair in pairs]


def new_index_query_shares(
    dbmd: DBMetadata, index: int, group_size: int, fast: bool = False,
    leaf_bits: int | None = None, rand_bytes: RandBytes = os.urandom,
    num_shares: int = 2,
) -> list[QueryShare]:
    """One index query (query.go:42-44): reference-exact keys, or fast
    keys with ``fast=True``; returns one share per server."""
    if fast:
        return new_fast_index_query_shares(dbmd, index, group_size, leaf_bits=leaf_bits,
                                           rand_bytes=rand_bytes, num_shares=num_shares)
    return _new_query_shares(dbmd, index, group_size, num_shares, True, rand_bytes)


def new_index_query_shares_batch(
    dbmd: DBMetadata, indices: list[int], group_size: int, fast: bool = False,
    leaf_bits: int | None = None, rand_bytes: RandBytes = os.urandom,
    num_shares: int = 2,
) -> list[list[QueryShare]]:
    """Batched share construction: for two parties one vectorised keygen
    walk for the whole batch, reference-exact keys or fast keys
    (``fast=True``), all queries sharing one set of (public) PRF keys,
    seeds per query. Returns one list of shares (one per server) per
    index."""
    if not fast:
        return _new_query_shares_batch(dbmd, indices, group_size, num_shares, True, rand_bytes)
    _check_two_party_fast(num_shares)
    dim_height, lb = _fast_geometry(dbmd, group_size, leaf_bits)
    pf = dpf.client_initialize(dpf.fast_depth_for_height(dim_height, lb),
                               rand_bytes)
    key_pairs = dpf.generate_two_server_fast_batch(
        pf, indices, dim_height, leaf_bits=lb, rand_bytes=rand_bytes)
    return [_shares(pf, pair, group_size) for pair in key_pairs]


def new_keyword_query_shares(
    dbmd: DBMetadata, keyword: int, group_size: int, num_shares: int = 2,
    rand_bytes: RandBytes = os.urandom,
) -> list[QueryShare]:
    """One keyword query over the 32-bit keyword domain (query.go:47-49);
    as in the reference there is no domain check."""
    return _new_query_shares(dbmd, keyword, group_size, num_shares, False, rand_bytes)


def new_keyword_query_shares_batch(
    dbmd: DBMetadata, keywords: list[int], group_size: int, num_shares: int = 2,
    rand_bytes: RandBytes = os.urandom,
) -> list[list[QueryShare]]:
    """Batched keyword shares (32-bit domain); one share list per keyword."""
    return _new_query_shares_batch(dbmd, keywords, group_size, num_shares, False, rand_bytes)


def recover(res_shares: list[SecretSharedQueryResult]) -> list[Slot]:
    """XOR all servers' share vectors per column."""
    num_slots = len(res_shares[0].shares)
    out = [new_empty_slot(res_shares[0].slot_bytes) for _ in range(num_slots)]
    for share in res_shares:
        for j in range(num_slots):
            xor_slots(out[j], share.shares[j])
    return out
