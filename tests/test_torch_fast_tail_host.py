"""The per-query tail kernel's per-thread code, built for the host.

csrc/fast_tail_host.cpp compiles the query constants, the walk down to
a thread's node, depth-first subtree walk and leaf blocks of
csrc/fast_tail.cuh with a host C++ compiler, on the per-bank AES table as
each lane reads it, with the head seeds and the leaf blocks' words
through the lockstep model of the kernel's warp transposes; its output
must equal the plain torch version's (itself held against the TPU kernel
in test_torch_fast_tail.py) on real operands from the port's head walk:
1024-bit leaves (8 blocks) at the serving depth with 5 tail levels,
128-bit leaves at the stream's depth 13 (8 head lane words) with 5, and
depth-5 keys with no tail level, for shared and distinct keys; and on
random operands at both serving geometries (NW0 = 1, split 3, 8 leaf
blocks; NW0 = 8, split 0, 1 block), past the fcw words kept in shared
memory (16 blocks) and on a thread grid of 12 lane words (a block of 8
and one of 4).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pir_tpu_torch import query as tq
from pir_tpu_torch.database import DBMetadata
from pir_tpu_torch.dpf.device import make_fast_payload_batch
from pir_tpu_torch.dpf.device import u32_tensor
from pir_tpu_torch.models.pipeline import pertail_head
from pir_tpu_torch.ops.fast_tail import fast_tail_expand_plain, leaf_blocks_of
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(__file__).resolve().parent.parent / "pir_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def host_tail(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib = tmp_path_factory.mktemp("fast_tail_host") / "libfast_tail_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(lib),
                    str(CSRC / "fast_tail_host.cpp")], check=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).pir_fast_tail_host
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("height,leaf_bits,levels,n_blk", [
    (1 << 20, 1024, 5, 8), (1 << 20, 128, 5, 1), (1 << 13, 256, 0, 2), (1 << 12, 128, 0, 1),
])
@pytest.mark.parametrize("distinct", [False, True])
def test_host_build_matches_plain_tail(host_tail, height, leaf_bits, levels, n_blk, distinct):
    md = DBMetadata(8, height)
    rng = np.random.default_rng(height + distinct)
    idxs = [int(i) for i in rng.integers(0, height, size=2)]
    if distinct:
        shares = [tq.new_fast_index_query_shares(md, i, 1, leaf_bits=leaf_bits,
                                                 rand_bytes=rng.bytes)[0] for i in idxs]
    else:
        shares = [p[0] for p in tq.new_index_query_shares_batch(
            md, idxs, 1, fast=True, leaf_bits=leaf_bits, rand_bytes=rng.bytes)]
    pay, layout = make_fast_payload_batch(shares)
    ops, tail = pertail_head(u32_tensor(pay, "cpu"), layout, 5)
    assert (tail, leaf_blocks_of(ops[6]), layout.shared_rk) == (levels, n_blk, not distinct)
    want = fast_tail_expand_plain(*ops, levels=tail)
    got = torch.empty_like(want)
    q, nw0 = ops[0].shape[0], ops[0].shape[-1]
    assert host_tail(*(x.data_ptr() for x in ops), got.data_ptr(), q, nw0, tail, n_blk,
                     int(distinct)) == 0
    assert torch.equal(got, want)


FULL = np.uint32(0xFFFFFFFF)


@pytest.mark.parametrize("distinct,levels,n_blk,nw0,q", [
    (False, 5, 8, 1, 3), (True, 5, 8, 1, 2), (False, 5, 1, 8, 2), (True, 5, 1, 8, 2),
    (False, 2, 16, 2, 2), (True, 3, 2, 3, 2),
])
def test_host_build_matches_plain_tail_random(host_tail, distinct, levels, n_blk, nw0, q):
    """Random seed, t and fcw words; every other operand 0 / ~0 masks, the
    form the payload unpack gives them."""
    rng = np.random.default_rng(200 + levels + n_blk + nw0)

    def words(*shape):
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)

    def masks(*shape):
        return rng.integers(0, 2, size=shape).astype(np.uint32) * FULL

    rk, rkl = ((masks(q, 11, 8, 3, 16, 1), masks(q, 11, 8, 16, 1)) if distinct
               else (masks(11, 8, 3, 16, 1), masks(11, 8, 16, 1)))
    fcw = words(q, 8, n_blk, 16, 1) if n_blk > 1 else words(q, 8, 16, 1)
    ops = [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)) for x in (
        words(q, 8, 16, nw0), words(q, 1, nw0), masks(q, levels, 8, 16, 1), masks(q, levels),
        masks(q, levels), rk, fcw, rkl)]
    want = fast_tail_expand_plain(*ops, levels=levels)
    got = torch.empty_like(want)
    assert host_tail(*(x.data_ptr() for x in ops), got.data_ptr(), q, nw0, levels, n_blk,
                     int(distinct)) == 0
    assert torch.equal(got, want)
