"""The per-query tail kernel's per-thread code, built for the host.

csrc/fast_tail_host.cpp compiles the query constants, split walk,
depth-first subtree walk and leaf blocks of csrc/fast_tail.cuh with a
host C++ compiler; its output must equal the plain torch version's
(itself held against the TPU kernel in test_torch_fast_tail.py) on real
operands from the port's head walk: 1024-bit leaves (8 blocks) at the
serving depth with 5 tail levels, 128-bit leaves at the stream's depth
13 (8 head lane words) with 5, and depth-5 keys with no tail level, for
shared and distinct keys.
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
