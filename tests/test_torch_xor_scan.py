"""pir_tpu_torch's masked-XOR scan (ops/xor_scan.py, ops/scan.py) vs pir_tpu.

The plain version, which the wrapper runs for CPU tensors and which the
CUDA kernel (csrc/masked_xor_scan.cu) is held against on the card, must
give the bytes of the Pallas kernel in interpret mode and of the JAX
package's XLA scans. Answers are exact XORs: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pir_tpu.ops.pallas_scan import masked_xor_scan_pallas
from pir_tpu.ops.scan import masked_xor_scan as j_scan
from pir_tpu.ops.scan import masked_xor_scan_batched as j_scan_batched
from pir_tpu_torch.models.pipeline import small_batch_scan
from pir_tpu_torch.ops import scan as tscan
from pir_tpu_torch.ops.packed_scan import packed_scan_plain
from pir_tpu_torch.ops.xor_scan import masked_xor_scan, masked_xor_scan_plain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _table(rng, h, c):
    return rng.integers(0, 1 << 32, size=(h, c), dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(x):
    return x.numpy().view(np.uint32)


def test_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    table = _table(rng, 2048, 512)
    bits = rng.integers(0, 2, size=2048).astype(np.uint8)
    want = np.asarray(masked_xor_scan_pallas(jnp.asarray(table), jnp.asarray(bits),
                                             block_rows=512, block_cols=512, interpret=True))
    got = masked_xor_scan_plain(_t(table), torch.from_numpy(bits))
    assert got.shape == (512,) and (_u32(got) == want).all()


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("q", [1, 3, 8])
def test_plain_matches_xla_scans_at_ragged_shapes(c, q):
    """H = 1000 rows of 1 or 3 words, the word tables of 3-byte slots."""
    rng = np.random.default_rng(c * 10 + q)
    table = _table(rng, 1000, c)
    bits = rng.integers(0, 2, size=(q, 1000)).astype(np.uint8)
    want = np.asarray(j_scan_batched(jnp.asarray(table), jnp.asarray(bits)))
    got = masked_xor_scan(_t(table), torch.from_numpy(bits))
    assert got.shape == (q, c) and (_u32(got) == want).all()
    one = masked_xor_scan(_t(table), torch.from_numpy(bits[0]))
    assert (_u32(one) == np.asarray(j_scan(jnp.asarray(table), jnp.asarray(bits[0])))).all()


def test_row_chunks_change_no_byte():
    rng = np.random.default_rng(4)
    table, bits = _t(_table(rng, 300, 5)), torch.from_numpy(
        rng.integers(0, 2, size=(3, 300)).astype(np.uint8))
    whole = tscan.masked_xor_scan_batched(table, bits)
    assert torch.equal(whole, tscan.masked_xor_scan_batched(table, bits, max_elems=7 * 5))
    assert torch.equal(whole[1], tscan.masked_xor_scan(table, bits[1]))


@pytest.mark.parametrize("b", [20, 4])
def test_small_batch_scan_matches_packed_scan(b):
    """The fast paths' scan for <= 8 queries: the storage table read as
    words, the selection words unpacked; equal to the packed scan. 4-byte
    rows are the storage rows of 3-byte slots."""
    rng = np.random.default_rng(b)
    table = torch.from_numpy(rng.integers(0, 256, size=(1024, b), dtype=np.uint8))
    words = _t(rng.integers(0, 1 << 32, size=(32, 8), dtype=np.uint64).astype(np.uint32))
    for q in (1, 3, 8):
        got = small_batch_scan(table, words[:, :q])
        assert got.dtype == torch.uint8 and torch.equal(got, packed_scan_plain(table, words[:, :q]))


def test_wrapper_rejects_bad_operands():
    table = torch.zeros((64, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        masked_xor_scan(table.to(torch.int64), torch.zeros(64, dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        masked_xor_scan(table, torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError, match="cover"):
        masked_xor_scan(table, torch.zeros((2, 63), dtype=torch.uint8))
    with pytest.raises(ValueError, match="1-D or 2-D"):
        masked_xor_scan(table, torch.zeros((1, 1, 64), dtype=torch.uint8))
