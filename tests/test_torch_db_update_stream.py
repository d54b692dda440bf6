"""pir_tpu_torch's serving streams under live updates vs pir_tpu's.

The stream case of tests/test_torch_db_update.py, in a file of its own so
that a second test worker takes it: pir_tpu's fused stream (Pallas in
interpret mode) compiles for most of a minute. An update between two
submits reaches the second batch in both modes, and the first batch only
in fused mode, which scans a batch at the next submit. Answer shares
equal pir_tpu's; tolerance 0.
"""

import numpy as np
import pytest
from test_torch_db_update import BATCH, HEIGHT, MDN, SLOT, _port_db, _rows
from test_torch_single import to_port

from pir_tpu import query as jq
from pir_tpu.database import generate_random_db
from pir_tpu.server import TpuPirServer
from pir_tpu_torch.server import TorchPirServer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("mode", ["stacked", "fused"])
def test_streams_see_updates_like_pir_tpu(mode):
    """submit b0, apply_updates, submit b1, flush. Stacked mode scans b0 at
    its submit (old rows); fused mode scans b0 at the next submit (new
    rows), as pir_tpu's streams do."""
    db = generate_random_db(HEIGHT, SLOT)
    tdb = _port_db(db)
    stacked = mode == "stacked"
    jsrv = TpuPirServer(db, use_pallas=True, fast_stacked=stacked, min_device_nodes=MDN)
    tsrv = TorchPirServer(tdb, device="cpu", fast_stacked=stacked, min_device_nodes=MDN)
    rng = np.random.default_rng(9)
    idx = [[int(i) for i in rng.integers(0, HEIGHT, size=BATCH)] for _ in range(2)]
    updates = {i: rng.bytes(SLOT) for i in sorted(set(idx[0][:8] + idx[1][:8]))}
    pairs = [jq.new_index_query_shares_batch(db.metadata(), ix, 1, 2, fast=True,
                                             leaf_bits=None if stacked else 128) for ix in idx]
    old = np.array(db.data)
    # four streams, one a server and share: submit b0 on each, update both
    # servers, submit b1 on each, flush each
    streams = {(name, part): (srv.fast_serving_stream(), port)
               for name, srv, port in (("pir_tpu", jsrv, False), ("port", tsrv, True))
               for part in (0, 1)}

    def batch(b, part, port):
        shares = [p[part] for p in pairs[b]]
        return to_port(shares) if port else shares

    for (_, part), (stream, port) in streams.items():
        assert stream.submit(batch(0, part, port)) is None
    jsrv.apply_updates(updates)
    tsrv.apply_updates(updates)
    got = {}
    for key, (stream, port) in streams.items():
        f0 = stream.submit(batch(1, key[1], port))
        got[key] = (_rows(f0()), _rows(stream.flush()()))
    for part in (0, 1):
        for b in (0, 1):
            assert (got["port", part][b] == got["pir_tpu", part][b]).all(), (part, b)
    assert ((got["port", 0][0] ^ got["port", 1][0]) == (old if stacked else tdb.data)[idx[0]]).all()
    assert ((got["port", 0][1] ^ got["port", 1][1]) == tdb.data[idx[1]]).all()
    assert not (old[idx[0]] == tdb.data[idx[0]]).all()
