"""The stacked tail kernel's per-thread code, built for the host.

csrc/stacked_tail_host.cpp compiles the per-bank table AES, the
depth-first tree walk, leaf blocks and round-key rebuild of
csrc/stacked_tail.cuh with a host C++ compiler, the head seeds and
correction words coming through the lockstep model of the kernel's warp
transpose; its output must equal the plain torch version's (itself held
against the TPU kernel in test_torch_expand.py) on real operands from
the port's head walk, at the serving geometry and a deeper-tail one, and
on random operands at tails of 0 and 4 and a width not a multiple of 8.
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
from pir_tpu_torch.models.pipeline import stacked_fast_geometry, stacked_head
from pir_tpu_torch.ops.expand import fast_tail_expand_stacked_plain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(__file__).resolve().parent.parent / "pir_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def host_tail(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib = tmp_path_factory.mktemp("tail_host") / "libstacked_tail_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(lib),
                    str(CSRC / "stacked_tail_host.cpp")], check=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).pir_stacked_tail_host
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn


def _host(fn, ops, tail, n_blk):
    s_n, w = ops[0].shape[0], ops[0].shape[-1]
    got = torch.empty((s_n, 8, (1 << tail) * n_blk, 16, w), dtype=torch.int32)
    assert fn(*(x.data_ptr() for x in ops), got.data_ptr(), s_n, w, tail, n_blk,
              1 if ops[5].dim() == 5 else w) == 0
    return got


@pytest.mark.parametrize("height,leaf_bits,distinct", [
    (1 << 20, 1024, False), (1 << 20, 1024, True), (1 << 16, 128, True),
])
def test_host_build_matches_plain_tail(host_tail, height, leaf_bits, distinct):
    md = DBMetadata(8, height)
    rng = np.random.default_rng(height + distinct)
    idxs = [int(i) for i in rng.integers(0, height, size=32)]
    if distinct:
        shares = [tq.new_fast_index_query_shares(md, i, 1, leaf_bits=leaf_bits,
                                                 rand_bytes=rng.bytes)[0] for i in idxs]
    else:
        shares = [p[0] for p in tq.new_index_query_shares_batch(
            md, idxs, 1, fast=True, leaf_bits=leaf_bits, rand_bytes=rng.bytes)]
    pay, layout = make_fast_payload_batch(shares)
    k, tail = stacked_fast_geometry(layout.depth, layout.leaf_blocks)
    assert tail > 0 and len(idxs) == k
    ops = [x.contiguous() for x in stacked_head(u32_tensor(pay, "cpu"), layout)]
    want = fast_tail_expand_stacked_plain(*ops, tail=tail, n_blk=layout.leaf_blocks)
    assert torch.equal(_host(host_tail, ops, tail, layout.leaf_blocks), want)


@pytest.mark.parametrize("distinct,n_blk,tail,w", [
    (True, 2, 0, 8), (False, 1, 4, 8), (True, 1, 2, 20),
])
def test_host_build_matches_plain_tail_random(host_tail, distinct, n_blk, tail, w):
    """Random seed, t, correction and fcw words; round keys as 0 / ~0
    masks, the form the payload unpack gives them."""
    rng = np.random.default_rng(100 + tail)
    s_n = 2

    def words(*shape):
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)

    def masks(*shape):
        return rng.integers(0, 2, size=shape).astype(np.uint32) * np.uint32(0xFFFFFFFF)

    rk, rkl = ((masks(s_n, 11, 8, 3, 16, w), masks(s_n, 11, 8, 16, w)) if distinct
               else (masks(11, 8, 3, 16, 1), masks(11, 8, 16, 1)))
    ops = [torch.from_numpy(x.view(np.int32)) for x in (
        words(s_n, 8, 1, 16, w), words(s_n, 1, 1, w), words(s_n, tail, 8, 16, w),
        words(s_n, tail, 1, w), words(s_n, tail, 1, w), rk, words(s_n, 8, n_blk, 16, w), rkl)]
    want = fast_tail_expand_stacked_plain(*ops, tail=tail, n_blk=n_blk)
    assert torch.equal(_host(host_tail, ops, tail, n_blk), want)
