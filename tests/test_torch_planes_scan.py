"""pir_tpu_torch's bit-plane batched scan (ops/planes_scan.py,
ops/matmul_scan.py) vs pir_tpu.

The plain version, which the wrapper runs for CPU tensors and which the
CUDA kernel (csrc/planes_scan.cu) is held against on the card, must give
the bytes of the Pallas kernel mxu_batched_scan_pallas in interpret mode,
of the JAX package's XLA twins (mxu_batched_scan, mxu_preplane_scan over
make_plane_table) and of the port's masked-XOR scan. Answers are exact
XORs: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pir_tpu.ops.matmul_scan import make_plane_table as j_make_plane_table
from pir_tpu.ops.matmul_scan import mxu_batched_scan as j_mxu_batched_scan
from pir_tpu.ops.matmul_scan import mxu_preplane_scan
from pir_tpu.ops.pallas_scan import mxu_batched_scan_pallas
from pir_tpu_torch.ops import matmul_scan as tms
from pir_tpu_torch.ops.planes_scan import planes_scan
from pir_tpu_torch.ops.scan import batched_xor_scan, pad_rows_u8
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BLOCK_ROWS, BLOCK_COLS = 256, 128  # the Pallas kernel's tiles here


def _operands(seed, q, h, b):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(h, b), dtype=np.uint8),
            rng.integers(0, 2, size=(q, h), dtype=np.uint8))


def _pallas(table, bits):
    """mxu_batched_scan_pallas in interpret mode on the table padded with
    zero rows and columns to whole tiles (XOR-neutral), sliced back."""
    h, b = table.shape
    padded = pad_rows_u8(table, BLOCK_ROWS)
    padded = np.pad(padded, ((0, 0), (0, (-b) % BLOCK_COLS)))
    bits_p = np.pad(bits, ((0, 0), (0, padded.shape[0] - h)))
    out = mxu_batched_scan_pallas(jnp.asarray(padded), jnp.asarray(bits_p), block_rows=BLOCK_ROWS,
                                  block_cols=BLOCK_COLS, interpret=True)
    return np.asarray(out)[:, :b]


@pytest.mark.parametrize("q,h,b", [
    (1, 700, 128),   # H not a multiple of a tile or of a plain block
    (5, 512, 200),
    (16, 1000, 3),   # 3-byte rows
    (33, 300, 64),   # a query tile and a ragged second one on the card
])
def test_plain_matches_pallas_interpret_and_xla(q, h, b):
    table, bits = _operands(q * 1000 + h + b, q, h, b)
    got = planes_scan(torch.from_numpy(table), torch.from_numpy(bits))
    assert got.dtype == torch.uint8 and got.shape == (q, b)
    assert (got.numpy() == _pallas(table, bits)).all()
    assert (got.numpy() == np.asarray(mxu_preplane_scan(jnp.asarray(j_make_plane_table(table)),
                                                        jnp.asarray(bits)))).all()
    assert torch.equal(got, batched_xor_scan(torch.from_numpy(table), torch.from_numpy(bits)))


def test_plain_matches_xla_blocked_scan(monkeypatch):
    """mxu_batched_scan (the XLA fori_loop over 2048-row blocks) on a table
    of whole blocks, against the port's plain version in 100-row blocks."""
    monkeypatch.setattr(tms, "BLOCK_ROWS", 100)
    table, bits = _operands(7, 9, 4096, 40)
    want = np.asarray(j_mxu_batched_scan(jnp.asarray(table), jnp.asarray(bits)))
    got = tms.mxu_batched_scan(torch.from_numpy(table), torch.from_numpy(bits))
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("block", [1, 37, 1 << 13])
def test_row_blocks_change_no_byte(block, monkeypatch):
    monkeypatch.setattr(tms, "BLOCK_ROWS", block)
    table, bits = _operands(11, 6, 513, 12)
    want = batched_xor_scan(torch.from_numpy(table), torch.from_numpy(bits))
    got = tms.mxu_batched_scan(torch.from_numpy(table), torch.from_numpy(bits))
    assert torch.equal(got, want)


def test_make_plane_table_matches_pir_tpu():
    table, _ = _operands(3, 1, 300, 17)
    got = tms.make_plane_table(torch.from_numpy(table))
    assert got.shape == (300, 17 * 8)
    assert (got.numpy() == j_make_plane_table(table).astype(np.uint8)).all()


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    table, bits = _operands(5, 4, 96, 8)
    before = planes_scan.launches
    got = planes_scan(torch.from_numpy(table), torch.from_numpy(bits))
    assert planes_scan.launches == before
    assert torch.equal(got, tms.mxu_batched_scan(torch.from_numpy(table),
                                                 torch.from_numpy(bits)))


def test_empty_and_all_zero_selections():
    table, _ = _operands(6, 1, 64, 8)
    t = torch.from_numpy(table)
    zeros = torch.zeros((3, 64), dtype=torch.uint8)
    assert not planes_scan(t, zeros).any()
    assert planes_scan(t, zeros[:0]).shape == (0, 8)
    one = torch.zeros((1, 64), dtype=torch.uint8)
    one[0, 17] = 1
    assert torch.equal(planes_scan(t, one)[0], t[17])


def test_wrapper_rejects_bad_operands():
    t = torch.zeros((8, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="cover"):
        planes_scan(t, torch.zeros((2, 9), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        planes_scan(t.to(torch.int32), torch.zeros((2, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        planes_scan(t, torch.zeros((2, 8), dtype=torch.int32))
