"""pir_tpu_torch stacked tail (ops/expand.py) vs the TPU kernel.

The plain torch version is held against
``fast_tail_expand_stacked_pallas(interpret=True)`` on the same words,
with equal bytes. The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from pir_tpu.dpf.device import _leaf_ctr_masks
from pir_tpu.ops.pallas_expand import fast_tail_expand_stacked_pallas
from pir_tpu_torch.ops.expand import fast_tail_expand_stacked
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FULL = np.uint32(0xFFFFFFFF)


def _operands(seed, s_n, w, tail, n_blk, distinct):
    """Random words for every operand; round keys as 0/~0 masks."""
    rng = np.random.default_rng(seed)

    def words(*shape):
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)

    def masks(*shape):
        return rng.integers(0, 2, size=shape).astype(np.uint32) * FULL

    ops = dict(seeds=words(s_n, 8, 1, 16, w), t=words(s_n, 1, 1, w),
               cw_s=words(s_n, tail, 8, 16, w), cw_tl=words(s_n, tail, 1, w),
               cw_tr=words(s_n, tail, 1, w), fcw=words(s_n, 8, n_blk, 16, w))
    if distinct:
        ops["rk"] = masks(s_n, 11, 8, 3, 16, w)
        ops["rk_leaf"] = masks(s_n, 11, 8, 16, w)
    else:
        ops["rk"] = masks(11, 8, 3, 16, 1)
        ops["rk_leaf"] = masks(11, 8, 16, 1)
    return ops


def _torch_args(ops, device="cpu"):
    names = ("seeds", "t", "cw_s", "cw_tl", "cw_tr", "rk", "fcw", "rk_leaf")
    return [torch.from_numpy(ops[n].view(np.int32)).to(device) for n in names]


@pytest.mark.parametrize("distinct,n_blk,tail", [
    (False, 1, 2), (False, 2, 1), (True, 1, 1), (True, 2, 2),
])
def test_plain_tail_matches_pallas_interpret(distinct, n_blk, tail):
    import jax.numpy as jnp

    s_n, w = 2, 8
    ops = _operands(20 + tail + 2 * n_blk, s_n, w, tail, n_blk, distinct)
    want = np.asarray(fast_tail_expand_stacked_pallas(
        ops["seeds"], ops["t"], ops["cw_s"], ops["cw_tl"], ops["cw_tr"], ops["rk"],
        ops["fcw"], ops["rk_leaf"], jnp.asarray(_leaf_ctr_masks(n_blk)),
        tail=tail, n_blk=n_blk, shared_rk=not distinct, interpret=True))
    got = fast_tail_expand_stacked(*_torch_args(ops), tail=tail, n_blk=n_blk)
    assert got.shape == want.shape == (s_n, 8, (1 << tail) * n_blk, 16, w)
    assert (got.numpy().view(np.uint32) == want).all()


def test_tail_wrapper_rejects_bad_operands():
    ops = _torch_args(_operands(1, 1, 8, 1, 1, False))
    with pytest.raises(ValueError, match="cw_s"):
        fast_tail_expand_stacked(*ops, tail=2, n_blk=1)
    ops[0] = ops[0].to(torch.int64)
    with pytest.raises(ValueError, match="seeds"):
        fast_tail_expand_stacked(*ops, tail=1, n_blk=1)

