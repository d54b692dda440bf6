"""The port's single-chip example step (counterpart of
``__graft_entry__.entry``): one reference-exact 2-server PIR answer,
expansion and masked-XOR scan, on a small random table.

    from pir_tpu_torch.entry import entry
    fn, args = entry()          # tensors on the card
    share = fn(*args)           # (16,) int32 answer words
"""

from __future__ import annotations

import numpy as np
import torch

from .database import Database
from .dpf import device as dev
from .dpf import host as dpf_host
from .models.pipeline import make_answer_fn
from .ops.scan import pack_table_u32
from .query import new_index_query_shares
from .state import device_key_from_numpy
from .utils.bits import num_bits_for_height


def entry(device=None, height: int = 1 << 14, slot_bytes: int = 64, seed: int = 0):
    """(fn, args): fn = models.pipeline.make_answer_fn(d_levels) and args =
    (table words, seeds, t, cw_s, cw_tl, cw_tr, rk, fcw, perm) for one
    compat share of a random row, built through make_device_key from
    `seed`, as tensors on the card, or on `device` (``"cpu"`` runs the
    plain versions). With no device given and no GPU present it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("entry() needs a CUDA device; pass device='cpu' for the CPU")
        device = "cuda"
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(height, slot_bytes), dtype=np.uint8)
    db = Database(slot_bytes=slot_bytes, db_size=height, data=data)
    share = new_index_query_shares(db.metadata(), int(rng.integers(height)), 1,
                                   rand_bytes=rng.bytes)[0]
    pf = dpf_host.server_initialize(share.prf_keys, num_bits_for_height(height))
    dkey = dev.make_device_key(pf, share.key_two_party, height)
    table = torch.from_numpy(pack_table_u32(db.data, height, 1).view(np.int32)).to(device)
    key = device_key_from_numpy(
        seeds0=dkey.seeds0, t0=dkey.t0, cw_seed_masks=dkey.cw_seed_masks, cw_tl=dkey.cw_tl,
        cw_tr=dkey.cw_tr, rk_masks=dkey.rk_masks, fcw_mask=dkey.fcw_mask, perm=dkey.perm,
        device=device)
    return make_answer_fn(dkey.plan.device_levels), (table, *key)
