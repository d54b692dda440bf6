"""Carry the JAX package's state into the port.

The "weights" of a PIR server are its table (and its rows' keywords)
and the query shares it is asked to answer, and of a single answer step
its device key; of the Paillier protocols, the key pair and the
ciphertexts. All arrive here as plain numpy arrays, bytes and ints (the
fields of a ``pir_tpu`` database, share, key, device key or ciphertext),
so nothing of the JAX package is imported. Every other message crosses
as wire bytes: pir_tpu's ``serialize_*``, then the port's
``wire.deserialize_*``, and the reverse.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto.paillier import Ciphertext, PublicKey, SecretKey
from .database import Database
from .dpf.device import u32_tensor
from .dpf.host import FastKey2P, Key2P, KeyMP, PrfKey
from .query import QueryShare


def database_from_numpy(data: np.ndarray, slot_bytes: int, keywords=None) -> Database:
    """A port Database over (db_size, slot_bytes) uint8 rows (no copy
    when `data` already is a C-contiguous uint8 array), with `keywords`
    when given (a ``pir_tpu`` database's ``keywords``: grid row r of a
    keyword query holds keyword r)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.ndim != 2 or data.shape[1] != slot_bytes:
        raise ValueError(f"rows {data.shape} do not hold {slot_bytes}-byte slots")
    db = Database(slot_bytes=slot_bytes, db_size=data.shape[0], data=data)
    if keywords is not None:
        db.set_keywords(keywords)
        if db.keywords.ndim != 1:
            raise ValueError(f"keywords of shape {db.keywords.shape}: one a row expected")
    return db


def _prf_keys(prf_keys) -> list[PrfKey]:
    return [k if isinstance(k, PrfKey) else PrfKey(bytes(k)) for k in prf_keys]


def share_from_fields(*, prf_keys, s_init: bytes, t_init: int, cw, final_cw_block: bytes,
                      depth: int, height: int, share_number: int,
                      group_size: int) -> QueryShare:
    """A port QueryShare from the fields of a fast-mode share: prf_keys as
    16-byte strings (or PrfKey objects to share one list across a
    batch), the FastKey2P fields, the share number and group size."""
    keys = _prf_keys(prf_keys)
    key = FastKey2P(bytes(s_init), int(t_init), [bytes(c) for c in cw],
                    bytes(final_cw_block), int(depth), int(height))
    return QueryShare(key_two_party=None, key_multi_party=None, prf_keys=keys,
                      is_keyword_based=False, is_two_party=True,
                      share_number=int(share_number), group_size=int(group_size),
                      key_fast=key)


def compat_share_from_fields(*, prf_keys, s_init: bytes, t_init: int, cw, final_cw: int,
                             share_number: int, group_size: int,
                             is_keyword_based: bool = False) -> QueryShare:
    """A port QueryShare from the fields of a reference-exact (compat)
    share, index or keyword: prf_keys as in ``share_from_fields``, the
    Key2P fields (16-byte s_init, t bit, one 18-byte correction word per
    level, the signed final correction word), the share number and group
    size."""
    key = Key2P(bytes(s_init), int(t_init), [bytes(c) for c in cw], int(final_cw))
    return QueryShare(key_two_party=key, key_multi_party=None, prf_keys=_prf_keys(prf_keys),
                      is_keyword_based=bool(is_keyword_based), is_two_party=True,
                      share_number=int(share_number), group_size=int(group_size))


def key_mp_from_fields(num_parties: int, cw, sigma) -> KeyMP:
    """A port multi-party key from a ``pir_tpu`` KeyMP's fields: the
    party count, the p2 uint32 correction-word arrays and the sigma rows
    (bytes)."""
    return KeyMP(int(num_parties), [np.asarray(c, dtype=np.uint32).copy() for c in cw],
                 [bytes(r) for r in sigma])


def device_key_from_numpy(*, seeds0, t0, cw_seed_masks, cw_tl, cw_tr, rk_masks, fcw_mask, perm,
                          device=None) -> tuple[torch.Tensor, ...]:
    """The arrays of a compat device key (the fields of a ``pir_tpu``
    ``DeviceKey2P``, as numpy uint32 arrays, perm int64) -> the port's
    tensors on `device`, in ``models.pipeline.answer_query``'s order:
    (seeds, t_plane, cw_seed_masks, cw_tl, cw_tr, rk_masks, fcw_mask, perm)."""
    words = [u32_tensor(a, device) for a in (seeds0, t0, cw_seed_masks, cw_tl, cw_tr, rk_masks,
                                             fcw_mask)]
    return (*words, torch.from_numpy(np.asarray(perm, dtype=np.int64)).to(device))


def device_fast_key_from_numpy(*, seeds0, t0, cw_seed_masks, cw_tl, cw_tr, fcw_masks, rk_masks,
                               rk_leaf, perm, device=None) -> tuple[torch.Tensor, ...]:
    """The arrays of a fast device key (the fields of a ``pir_tpu``
    ``DeviceFastKey2P``) -> the port's tensors on `device`, in the order of
    ``dpf.device.unpack_fast_payload`` and then perm: (seeds, t, cw_s,
    cw_tl, cw_tr, fcw, rk, rk_leaf, perm)."""
    words = [u32_tensor(a, device) for a in (seeds0, t0, cw_seed_masks, cw_tl, cw_tr, fcw_masks,
                                             rk_masks, rk_leaf)]
    return (*words, torch.from_numpy(np.asarray(perm, dtype=np.int64)).to(device))


def paillier_secret_key(p: int, q: int) -> SecretKey:
    """The port's Paillier secret key of a ``pir_tpu`` key's primes p, q."""
    return SecretKey(int(p), int(q))


def paillier_public_key(n: int) -> PublicKey:
    """The port's Paillier public key of a ``pir_tpu`` key's modulus n."""
    return PublicKey(int(n))


def ciphertext_from_fields(c: int, level: int) -> Ciphertext:
    """The port's ciphertext of a ``pir_tpu`` ciphertext's (c, level)."""
    return Ciphertext(int(c), int(level))
