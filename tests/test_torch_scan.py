"""pir_tpu_torch scans (ops/scan.py, ops/packed_scan.py) vs pir_tpu.

The plain packed scan is held against
``mxu_batched_scan_packed_pallas(interpret=True)`` and the plain batched
scan against ``matmul_scan.mxu_batched_scan``, with equal bytes. The
CUDA kernel is held against the plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from pir_tpu.ops.matmul_scan import mxu_batched_scan
from pir_tpu.ops.matmul_scan import pad_rows_u8 as j_pad_rows_u8
from pir_tpu.ops.pallas_scan import mxu_batched_scan_packed_pallas
from pir_tpu.ops.scan import pack_table_u32 as j_pack_table_u32
from pir_tpu.ops.scan import unpack_result_u32 as j_unpack_result_u32
from pir_tpu_torch.ops.packed_scan import packed_scan, unpack_words_t
from pir_tpu_torch.ops.scan import (
    batched_xor_scan,
    pack_table_u32,
    pad_rows_u8,
    unpack_result_u32,
    xor_reduce,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _case(seed, h, b, q):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, size=(h, b), dtype=np.uint8)
    words = rng.integers(0, 1 << 32, size=(h // 32, q), dtype=np.uint64).astype(np.uint32)
    return table, words


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("h,b,q", [(2048, 256, 8), (4096, 128, 5)])
def test_plain_packed_scan_matches_pallas_interpret(h, b, q):
    table, words = _case(h + q, h, b, q)
    want = np.asarray(mxu_batched_scan_packed_pallas(
        table, words, block_rows=1024, block_cols=128, interpret=True))
    got = packed_scan(_t(table), _t(words.view(np.int32)))
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("h,b,q", [(2048, 16, 4), (1000, 6, 3)])
def test_batched_xor_scan_matches_mxu_scan(h, b, q):
    """Odd widths and heights: the fold handles odd row counts and the
    word view pads the width."""
    rng = np.random.default_rng(h)
    table = rng.integers(0, 256, size=(h, b), dtype=np.uint8)
    bits = rng.integers(0, 2, size=(q, h), dtype=np.uint8)
    padded = j_pad_rows_u8(table, 1024)
    assert (pad_rows_u8(table, 1024) == padded).all()
    want = np.asarray(mxu_batched_scan(padded, np.pad(bits, ((0, 0), (0, padded.shape[0] - h))),
                                       block=1024))
    got = batched_xor_scan(_t(table), _t(bits), max_elems=1 << 12)
    assert (got.numpy() == want).all()


def test_xor_reduce_odd_lengths():
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -2**31, 2**31, size=(7, 13), dtype=np.int64).astype(np.int32))
    want = np.bitwise_xor.reduce(x.numpy(), axis=1)
    assert (xor_reduce(x, 1)[:, 0].numpy() == want).all()


def test_unpack_words_t_bit_order():
    words = np.array([[1 | (1 << 31)], [2]], dtype=np.uint32)  # (H/32=2, Q=1)
    bits = unpack_words_t(_t(words.view(np.int32)))
    assert bits.shape == (1, 64)
    assert np.flatnonzero(bits.numpy()[0]).tolist() == [0, 31, 33]


def test_table_word_packing_matches_pir_tpu():
    data = np.random.default_rng(2).integers(0, 256, size=(12, 7), dtype=np.uint8)
    packed = pack_table_u32(data, 6, 2)
    assert (packed == j_pack_table_u32(data, 6, 2)).all()
    assert (unpack_result_u32(packed[1], 2, 7) == j_unpack_result_u32(packed[1], 2, 7)).all()
    assert (unpack_result_u32(packed[1], 2, 7) == data[2:4]).all()


def test_scan_wrapper_rejects_bad_operands():
    table, words = _case(3, 64, 8, 2)
    with pytest.raises(ValueError, match="cover"):
        packed_scan(_t(table), _t(words[:1].view(np.int32)))
    with pytest.raises(ValueError, match="int32"):
        packed_scan(_t(table), _t(words))

