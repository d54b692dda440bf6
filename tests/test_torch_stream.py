"""pir_tpu_torch's FastServingStream vs pir_tpu's, in both modes.

Stacked mode (fast_stacked=True) rides the batch API's dispatch; fused
mode (fast_stacked=False) runs each batch's scan in the same kernel as
the next batch's tail. Three batches of 16 and a flush go through the
JAX stream (Pallas in interpret mode) and the port's, at 2^13 rows x 8 B
(where the JAX package's ``fused_geometry`` has a tiling: 4096 x 8);
answer shares must be equal bytes, equal the port's own batch API, and
recover every row. Then the refusals, recovery after a batch of another
shape, and rows of 3 bytes.
"""

import numpy as np
import pytest
from test_torch_server import to_port

from pir_tpu import query as jq
from pir_tpu.database import generate_random_db
from pir_tpu.server import TpuPirServer
from pir_tpu_torch.server import TorchPirServer
from pir_tpu_torch.state import database_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEIGHT = 1 << 13
SLOT = 8
BATCH = 16
MODES = ["stacked", "fused"]


def _rows(results):
    return np.stack([np.frombuffer(bytes(r.shares[0].data), np.uint8) for r in results])


def _batches(db, seed, n=3, leaf_bits=128):
    """n batches of BATCH batch-keygen share pairs and their indices."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idxs = [int(i) for i in rng.integers(0, db.db_size, size=BATCH)]
        out.append((idxs, jq.new_index_query_shares_batch(db.metadata(), idxs, 1, 2, fast=True,
                                                         leaf_bits=leaf_bits)))
    return out


def _run(stream, batches):
    """submit each batch, then flush; -> the answer rows of every batch."""
    futs = []
    for i, shares in enumerate(batches):
        fut = stream.submit(shares)
        assert (fut is None) == (i == 0)
        if fut is not None:
            futs.append(fut)
    futs.append(stream.flush())
    assert stream.flush() is None  # an empty stream drains to None
    return [_rows(f()) for f in futs]


def _port(db, slot=SLOT, **kw):
    return TorchPirServer(database_from_numpy(db.data, slot), device="cpu", **kw)


@pytest.fixture(scope="module")
def db():
    return generate_random_db(HEIGHT, SLOT)


@pytest.mark.parametrize("mode", MODES)
def test_stream_matches_pir_tpu_and_batch_api(db, mode):
    """Stacked mode takes the default (256-bit) leaves, fused mode 128-bit."""
    stacked = mode == "stacked"
    jsrv = TpuPirServer(db, use_pallas=True, fast_stacked=stacked)
    tsrv = _port(db, fast_stacked=stacked)
    batches = _batches(db, 3 + stacked, leaf_bits=None if stacked else 128)
    got = []
    for part in (0, 1):
        shares = [[p[part] for p in pairs] for _, pairs in batches]
        want = _run(jsrv.fast_serving_stream(), shares)
        mine = _run(tsrv.fast_serving_stream(), [to_port(s) for s in shares])
        for w, m, s in zip(want, mine, shares):
            assert (m == w).all(), f"share {part} differs from pir_tpu's stream"
            assert (m == _rows(tsrv.private_secret_shared_query_batch(to_port(s)))).all()
        got.append(mine)
    for (idxs, _), a, b in zip(batches, *got):
        assert ((a ^ b) == db.data[idxs]).all()


def test_fused_stream_refusals_match_pir_tpu(db):
    md = db.metadata()
    distinct = [jq.new_index_query_shares(md, i, 1, 2, fast=True, leaf_bits=128)[0]
                for i in range(BATCH)]
    wide = [p[0] for p in jq.new_index_query_shares_batch(md, list(range(BATCH)), 1, 2,
                                                          fast=True, leaf_bits=256)]
    jsrv = TpuPirServer(db, use_pallas=True, fast_stacked=False)
    tsrv = _port(db, fast_stacked=False)
    for shares, match in ((distinct, "batch-shared PRF keys"), (wide, "wide-leaf keys")):
        with pytest.raises(ValueError, match=match):
            jsrv.fast_serving_stream().submit(shares)
        stream = tsrv.fast_serving_stream()
        with pytest.raises(ValueError, match=match):
            stream.submit(to_port(shares))
        assert stream.flush() is None


@pytest.mark.parametrize("mode", MODES)
def test_stream_shape_mismatch_is_recoverable(db, mode):
    """A batch of another size is refused without desyncing the stream:
    the pending batch stays answerable."""
    tsrv = _port(db, fast_stacked=mode == "stacked")
    (i0, p0), (i1, p1) = _batches(db, 7, n=2)
    b0, b1 = (to_port([p[0] for p in pairs]) for pairs in (p0, p1))
    stream = tsrv.fast_serving_stream()
    assert stream.submit(b0) is None
    with pytest.raises(ValueError, match="one shape"):
        stream.submit(b0[:4])
    assert (_rows(stream.submit(b1)()) == _rows(tsrv.private_secret_shared_query_batch(b0))).all()
    assert (_rows(stream.flush()()) == _rows(tsrv.private_secret_shared_query_batch(b1))).all()


@pytest.mark.parametrize("mode", MODES)
def test_stream_serves_3_byte_rows(mode):
    """Rows that are not whole 4-byte words: both modes equal the port's
    batch API (held against pir_tpu in test_torch_fast_tail.py and
    test_torch_server.py) and recover every row."""
    db3 = generate_random_db(HEIGHT, 3)
    tsrv = _port(db3, slot=3, fast_stacked=mode == "stacked")
    batches = _batches(db3, 11)
    got = []
    for part in (0, 1):
        shares = [to_port([p[part] for p in pairs]) for _, pairs in batches]
        rows = _run(tsrv.fast_serving_stream(), shares)
        for r, s in zip(rows, shares):
            assert (r == _rows(tsrv.private_secret_shared_query_batch(s))).all()
        got.append(rows)
    for (idxs, _), a, b in zip(batches, *got):
        assert ((a ^ b) == db3.data[idxs]).all()
