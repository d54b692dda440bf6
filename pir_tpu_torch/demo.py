"""End-to-end demo of the port: non-colluding PIR services and a client,
over TCP (counterpart of ``examples/demo.py``).

    python -m pir_tpu_torch.demo [--device cpu] [--paillier-engine python]

Runs all four served protocol families:
  1. secret-shared index PIR (2 servers), fast and reference-exact keys
  2. keyword PIR via the sqrt search tree and the PrivateBST
  3. single-server cPIR under Paillier (db.go:176-271)
  4. recursive (doubly-encrypted) cPIR (db.go:273-358)
plus a local ASPIR audit round (aspir_shared.py) and ASPIR served over
TCP. Every service answers on a TorchPirServer on the card, or with
``--device cpu`` on the CPU, and runs its cPIR scans on the same device
(the Montgomery kernels, or their plain versions on the CPU, which take
minutes there) unless ``--paillier-engine python`` names the CPython
loop; the client's Paillier work is CPython.
"""

from __future__ import annotations

import argparse

from .aspir_shared import (
    check_audit,
    generate_audit_for_shared_query,
    new_authenticated_index_query_shares,
)
from .config import PirConfig
from .crypto.paillier import keygen
from .database import generate_random_db
from .keyword import new_private_bst, new_private_sqrt_st, pad_to_power_of_2, pad_to_sqrt
from .server import TorchPirServer
from .service import PirClient, PirService


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the services' device: the card by default, 'cpu' for the CPU")
    ap.add_argument("--paillier-engine", default=None, choices=("torch", "python"),
                    help="the services' cPIR engine: 'torch' (the default) on --device, "
                         "'python' for CPython")
    args = ap.parse_args(argv)
    cfg = PirConfig(device=args.device, paillier_engine=args.paillier_engine)

    # --- 1. 2-server index PIR over TCP ---
    db = generate_random_db(1 << 12, 32)
    s0 = PirService(db, config=cfg).start()
    s1 = PirService(db, config=cfg).start()
    client = PirClient([s0.address, s1.address])
    idx = 1234
    for fast in (False, True):
        res = client.query_index(idx, fast=fast)
        assert bytes(res[0].data) == db.data[idx].tobytes()
    batch = list(range(0, db.db_size, 97))
    res = client.query_index_batch(batch)
    assert all(bytes(r[0].data) == db.data[i].tobytes() for r, i in zip(res, batch))
    print(f"index PIR: privately fetched row {idx} (both key styles) and a batch of "
          f"{len(batch)} ({db.db_size} rows x {db.slot_bytes} B) OK")

    # --- 3+4. single-server cPIR against one of the same services ---
    sk, pk = keygen(512)
    width, _ = db.get_dimensions_for_database(64, 1)
    row = 17
    slots = client.query_encrypted(row, sk, pk)
    assert bytes(slots[0].data) == db.data[row * width].tobytes()
    print(f"cPIR: retrieved grid row {row} from ONE server "
          f"({len(slots)} slots, Paillier {pk.n.bit_length()}-bit) OK")

    target = 2718
    slots = client.query_encrypted_recursive(target, sk, pk)
    assert bytes(slots[0].data) == db.data[target].tobytes()
    print(f"recursive cPIR: retrieved slot {target} with O(sqrt N) upload OK")

    stats = client.get_metrics()
    print(f"server metrics: {stats['queries']} queries, "
          f"p50 {stats['p50_ms']:.1f} ms, engine={stats['engine']}")
    client.close()
    s0.close()
    s1.close()

    # --- 2. keyword PIR via the sqrt search tree, over TCP ---
    data = sorted(pad_to_sqrt([f"user-{i:05d}" for i in range(900)]), reverse=True)
    sqst = new_private_sqrt_st()
    sqst.build_for_data(data)
    k0 = PirService(sqrt_st=sqst, config=cfg).start()
    k1 = PirService(sqrt_st=sqst, config=cfg).start()
    kclient = PirClient([k0.address, k1.address])
    key = "user-00417"
    present, gidx, _ = kclient.query_keyword(key)
    assert present and data[gidx] == key
    print(f"keyword PIR: found {key!r} privately over TCP (index {gidx}) OK")
    present, _, _ = kclient.query_keyword("user-55555")
    assert not present
    print("keyword PIR: absent key correctly not found OK")
    kclient.close()
    k0.close()
    k1.close()

    # --- keyword PIR via the PrivateBST: no cleartext keys at all ---
    bdata = sorted(pad_to_power_of_2([f"user-{i:05d}" for i in range(900)]), reverse=True)
    bst = new_private_bst()
    bst.build_for_data(bdata)
    b0 = PirService(bst=bst, config=cfg).start()
    b1 = PirService(bst=bst, config=cfg).start()
    bclient = PirClient([b0.address, b1.address])
    present, bidx, _ = bclient.query_keyword_bst("user-00233")
    assert present and bdata[bidx] == "user-00233"
    print(f"keyword PIR (BST): found 'user-00233' with {bst.depth} level "
          f"queries, zero cleartext keys OK")
    bclient.close()
    b0.close()
    b1.close()

    # --- authenticated (ASPIR) shared query with audit, in process ---
    keydb = generate_random_db(1 << 10, 8)
    key_srv = TorchPirServer(keydb, device=args.device)
    target = 77
    ashares = new_authenticated_index_query_shares(
        keydb.metadata(), target, keydb.slot(target), 1, 2, fast=True)
    audits = [generate_audit_for_shared_query(keydb, s, server=key_srv) for s in ashares]
    assert check_audit(*audits)
    print("ASPIR: audit passed for the legitimate auth key OK")

    # --- ASPIR served over TCP: audit-gated release (shared variant) ---
    adb = generate_random_db(1 << 8, 16)
    akeys = generate_random_db(1 << 8, 8)
    leader = PirService(adb, config=cfg, key_db=akeys).start()
    peer = PirService(adb, config=cfg, key_db=akeys, audit_leader=leader.address).start()
    aclient = PirClient([leader.address, peer.address])
    res = aclient.query_index_authenticated(33, akeys.slot(33))
    assert bytes(res[0].data) == adb.data[33].tobytes()
    print("ASPIR over TCP: authenticated retrieval released after audit OK")
    try:
        aclient.query_index_authenticated(34, akeys.slot(35))
        raise AssertionError("wrong key must be refused")
    except PermissionError:
        print("ASPIR over TCP: wrong auth key refused by the servers OK")
    aclient.close()
    leader.close()
    peer.close()

    print("demo complete")


if __name__ == "__main__":
    main()
