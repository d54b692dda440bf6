"""The compat kernels' per-thread code, built for the host.

csrc/compat_stage_host.cpp compiles the query constants, subtree walk
and selection bit of csrc/compat_stage.cuh (with the AES and DPF child
step of csrc/stacked_tail.cuh) with a host C++ compiler; its output
must equal the plain torch version's (itself held against the TPU
kernel in test_torch_compat.py) on real operands from the port's compat
head, at every stage of the cascade, with and without emit_bits. The
head kernel's prefix walk, breadth-first levels and depth-first
subtrees, thread by thread, must equal the plain head walk's planes for
every lane width, skip and shard prefix.
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
from pir_tpu_torch.dpf.device import (
    compat_skip_levels,
    compat_stage_plan,
    make_compat_payload_batch,
)
from pir_tpu_torch.dpf.device import u32_tensor, unpack_compat_root_payload
from pir_tpu_torch.models.pipeline import compat_head
from pir_tpu_torch.ops.compat_head import compat_head_plain
from pir_tpu_torch.ops.compat_stage import compat_stage_plain
from pir_tpu_torch.utils.bits import num_bits_for_height
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(__file__).resolve().parent.parent / "pir_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib = tmp_path_factory.mktemp("compat_host") / "libcompat_stage_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(lib),
                    str(CSRC / "compat_stage_host.cpp")], check=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_stage(host_lib):
    fn = host_lib.pir_compat_stage_host
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def host_head(host_lib):
    fn = host_lib.pir_compat_head_host
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn


def _host(fn, ops, tail, emit_bits):
    seeds = ops[0]
    q, _, nc, _, w = seeds.shape
    words = torch.empty((q, nc << tail, 1, w), dtype=torch.int32)
    out_s = words if emit_bits else torch.empty((q, 8, nc << tail, 16, w), dtype=torch.int32)
    assert fn(*(x.data_ptr() for x in ops), out_s.data_ptr(), words.data_ptr(),
              q, nc, w, tail, int(emit_bits)) == 0
    return words if emit_bits else (out_s, words)


@pytest.mark.parametrize("height,w,max_tail,tails", [
    (1 << 14, 8, 3, (3, 3)),
    (1 << 11, 8, 2, (2, 1)),
    (1 << 15, 128, 3, (3,)),
    (1 << 16, 128, 3, (3, 1)),
])
def test_host_build_matches_plain_stage(host_stage, height, w, max_tail, tails):
    md = DBMetadata(8, height)
    rng = np.random.default_rng(height + w)
    # distinct PRF keys per query, so per-query key indexing is exercised
    shares = [tq.new_index_query_shares(md, int(i), 1, rand_bytes=rng.bytes)[0]
              for i in rng.integers(0, height, size=2)]
    pay, layout = make_compat_payload_batch(shares, height=height)
    nb = num_bits_for_height(height)
    assert layout.device_bits == nb - compat_skip_levels(nb, height)
    assert compat_stage_plan(layout.device_bits, w, max_tail)[1] == tails
    seeds, t, cw_s, cw_tl, cw_tr, rk, fcw = compat_head(u32_tensor(pay, "cpu"), layout, w)
    assert cw_s.shape[1] == sum(tails)
    off = 0
    for tl in tails:
        ops = (seeds, t, cw_s[:, off:off + tl].contiguous(), cw_tl[:, off:off + tl].contiguous(),
               cw_tr[:, off:off + tl].contiguous(), rk, fcw)
        want_bits = compat_stage_plain(*ops, tail=tl, emit_bits=True)
        assert torch.equal(_host(host_stage, ops, tl, True), want_bits)
        want_s, want_t = compat_stage_plain(*ops, tail=tl, emit_bits=False)
        got_s, got_t = _host(host_stage, ops, tl, False)
        assert torch.equal(got_s, want_s) and torch.equal(got_t, want_t)
        seeds, t = want_s, want_t
        off += tl


@pytest.mark.parametrize("height,w", [(1 << 14, 128), (1 << 10, 8), (3000, 32), (1 << 9, 1),
                                      (1000, 2)])
@pytest.mark.parametrize("shard", [None, (0, 1), (1, 1), (2, 2), (3, 2)])
def test_host_head_matches_plain(host_head, height, w, shard):
    """The head kernel's code at every warp-group width (w 1 and 2: one
    warp and one or two leaves a thread; w 8: one warp, 8 leaves; w 32
    and 128: 4 and 8 warps), skip 1 (power-of-two heights) and 0, after
    no shard prefix or one of 1 or 2 levels, both path bits."""
    md = DBMetadata(8, height)
    rng = np.random.default_rng(height + w + (shard[0] * 7 + shard[1] if shard else 0))
    shares = [tq.new_index_query_shares(md, int(i), 1, rand_bytes=rng.bytes)[0]
              for i in rng.integers(0, height, size=3)]
    pay, layout = make_compat_payload_batch(shares, height=height)
    seeds, t, cw_s, cw_tl, cw_tr, _, rk = unpack_compat_root_payload(u32_tensor(pay, "cpu"),
                                                                      layout)
    ops = (seeds.contiguous(), t.contiguous(), cw_s, cw_tl.contiguous(), cw_tr.contiguous(), rk)
    want_s, want_t = compat_head_plain(*ops, skip=layout.skip, w=w, shard=shard)
    index, levels = shard or (0, 0)
    q = len(shares)
    got_s = torch.empty((q, 8, 1, 16, w), dtype=torch.int32)
    got_t = torch.empty((q, 1, 1, w), dtype=torch.int32)
    assert host_head(*(x.data_ptr() for x in ops), got_s.data_ptr(), got_t.data_ptr(), q,
                     cw_s.shape[1], layout.skip + levels, index, 5 + w.bit_length() - 1) == 0
    assert torch.equal(got_s, want_s) and torch.equal(got_t, want_t)
