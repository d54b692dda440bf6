"""The reference: its AES against FIPS-197, its DPF evaluation against the
repo's golden vectors, its answers against the port's CPU path, and the
yardstick's arithmetic against the bounds PERF.md states."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from benchh100_util import BENCH, ROOT

import dpf_ref  # noqa: E402
import named  # noqa: E402
import peaks  # noqa: E402
import traffic  # noqa: E402

DPF2 = named.module("protocols", "dpf2")

GOLDEN = os.path.join(ROOT, "tests", "vectors", "dpf_golden.json")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.uint8):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.mark.parametrize("key,plain,cipher", [
    # FIPS-197 appendix C.1 and appendix B
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),
    ("2b7e151628aed2a6abf7158809cf4f3c", "3243f6a8885a308d313198a2e0370734",
     "3925841d02dc09fbdc118597196a0b32"),
])
def test_aes_fips197(key, plain, cipher):
    rk = torch.from_numpy(dpf_ref.key_schedule(bytes.fromhex(key)))
    out = dpf_ref.aes_encrypt(_t(list(bytes.fromhex(plain)))[None], rk)
    assert bytes(out[0].tolist()).hex() == cipher


def test_key_schedule_fips197():
    # FIPS-197 appendix A.1: the last round key
    rk = dpf_ref.key_schedule(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"))
    assert rk[10].tobytes().hex() == "d014f9a8c9ee2589e13f0cc8b6630ca6"


def test_aes_chunks_agree():
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (1000, 16), dtype=torch.uint8, generator=gen)
    rk = torch.from_numpy(dpf_ref.key_schedule(bytes(range(16))))
    whole = dpf_ref.aes_encrypt(x, rk)
    old = dpf_ref.AES_CHUNK
    try:
        dpf_ref.AES_CHUNK = 64
        assert torch.equal(dpf_ref.aes_encrypt(x, rk), whole)
    finally:
        dpf_ref.AES_CHUNK = old


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _compat_key(buf: bytes):
    """(s_init, t_init, cw, final_cw) of a serialised Key2P (16-byte seed,
    u8 t, u16 levels, 18 bytes a level, i64 final correction)."""
    t, nb = struct.unpack_from("<BH", buf, 16)
    cw = np.frombuffer(buf[19:19 + 18 * nb], np.uint8).reshape(nb, 18)
    (fcw,) = struct.unpack_from("<q", buf, 19 + 18 * nb)
    return np.frombuffer(buf[:16], np.uint8), t, cw, fcw


def _fast_key(buf: bytes):
    """(s_init, t_init, cw, fcw, height) of a serialised 128-bit-leaf FastKey2P."""
    t, depth = struct.unpack_from("<BH", buf, 16)
    cw = np.frombuffer(buf[19:19 + 18 * depth], np.uint8).reshape(depth, 18)
    off = 19 + 18 * depth
    (height,) = struct.unpack_from("<Q", buf, off + 16)
    fcw = np.frombuffer(buf[off:off + 16], np.uint8)
    return np.frombuffer(buf[:16], np.uint8), t, cw, fcw, height


@pytest.mark.parametrize("case", _golden()["two_party"], ids=lambda c: f"h{c['height']}-a{c['a']}")
def test_compat_golden(case):
    rks = dpf_ref.round_keys([bytes.fromhex(k) for k in case["prf_keys"]], "cpu")
    for s in (0, 1):
        s_init, t, cw, fcw = _compat_key(bytes.fromhex(case[f"key{s}"]))
        assert cw.shape[0] == case["num_bits"]
        args = (_t(s_init[None]), _t([t]), _t(cw[None]), torch.tensor([fcw]), case["height"])
        vals = dpf_ref.compat_values(rks, s, *args)[0].tolist()
        assert vals == case[f"values{s}"][:case["height"]]
        bits = dpf_ref.compat_bits(rks, s, *args)[0].tolist()
        assert bits == case[f"bits{s}"][:case["height"]]


@pytest.mark.parametrize("case", _golden()["fast_mode"], ids=lambda c: f"h{c['height']}-a{c['a']}")
def test_fast_golden(case):
    rks = dpf_ref.round_keys([bytes.fromhex(k) for k in case["prf_keys"]], "cpu")
    got = []
    for s in (0, 1):
        s_init, t, cw, fcw, height = _fast_key(bytes.fromhex(case[f"key{s}"]))
        assert height == case["height"] and cw.shape[0] == case["depth"]
        bits = dpf_ref.fast_bits(rks, _t(s_init[None]), _t([t]), _t(cw[None]), _t(fcw[None]),
                                 height)[0]
        assert bits.tolist() == case[f"bits{s}"]
        got.append(bits)
    x = got[0] ^ got[1]
    assert int(x.sum()) == 1 and int(x[case["a"]]) == 1


@pytest.mark.parametrize("style,rows,row_bytes,clients,extra", [
    ("fast", 1 << 12, 36, 1, {"leaf_bits": 128}),
    ("fast", 1 << 13, 36, 1, {"leaf_bits": 256}),
    ("fast", 1 << 12, 3, 3, {"leaf_bits": 128}),
    ("compat", 1 << 10, 36, 1, {}),
    ("compat", 1 << 10 | 300, 36, 1, {}),
    ("compat", 1 << 10, 3, 2, {}),
])
def test_reference_against_the_port_on_the_cpu(style, rows, row_bytes, clients, extra):
    """The only test that holds both: the port's CPU path (the kernels'
    plain versions) answers the benchmark's shares as the reference does,
    with one client's PRF keys or each client's own."""
    from pir_tpu_torch.server import TorchPirServer

    system = named.module("systems", "dpf2")
    config = {"rows": rows, "row_bytes": row_bytes, "group_size": 1, "keys": style,
              "server_options": {}, **extra}
    mix = {"pool": 24, "clients": clients}
    seed = 2**33 + 5
    table = traffic.make_table(config, seed, "cpu").numpy()
    pool = DPF2.make_pool(config, mix, seed, "cpu")
    assert len({tuple(k) for k in pool.prf_keys}) == clients
    idx = np.arange(mix["pool"])
    ref = DPF2.answers(config, seed, pool, idx, "cpu")
    assert (ref["rows"] == table[pool.targets]).all()
    assert ((ref["share0"] ^ ref["share1"]) == ref["rows"]).all()
    for s in (0, 1):
        sut = system.System(config, table, "cpu")
        assert isinstance(sut.server, TorchPirServer)
        res = sut.server.private_secret_shared_query_batch(sut.shares(pool, s))
        got = np.stack([np.frombuffer(system.answer_bytes(r), np.uint8) for r in res])
        assert (got == ref[f"share{s}"]).all()


def test_one_client_pool_is_the_batch_layout():
    config = {"rows": 1 << 12, "row_bytes": 8, "keys": "fast", "leaf_bits": 128}
    one = DPF2.make_pool(config, {"pool": 16}, 9, "cpu")
    assert len(one.prf_keys) == 1 and (one.client == 0).all()
    many = DPF2.make_pool(config, {"pool": 16, "clients": 4}, 9, "cpu")
    assert np.bincount(many.client).tolist() == [4, 4, 4, 4]
    assert (many.targets == one.targets).all()


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_scan_bound_reproduces_perf_md():
    # PERF.md section 6, row 2: 35.56 ms at Q = 4096, 8.89 ms at Q = 1024
    assert round(peaks.scan_s(4096, 1 << 20, 1024) * 1e3, 2) == 35.56
    assert round(peaks.scan_s(1024, 1 << 20, 1024) * 1e3, 2) == 8.89


def test_expansion_counts_the_key_format():
    fast, compat = _config("dpf2-fast-1mx256b"), _config("dpf2-compat-1mx3b")
    # a fast key over 2^20 rows and 1024-bit leaves: depth 10, 1023 nodes
    # above the 1024 leaves, 8 CTR blocks a leaf
    assert peaks.walk_nodes(1024, 10) == 1023
    assert peaks.expansion_blocks(4096, fast) == 4096 * (3 * 1023 + 1024 * 8)
    # a compat key over 2^20 rows: a 21-bit domain, every node above the rows
    assert peaks.walk_nodes(1 << 20, 21) == 1 << 20
    assert peaks.expansion_blocks(1024, compat) == 1024 * 3 * (1 << 20)
    # the AES-128 block binds on the integer pipe: 356 instructions
    assert peaks.AES_BLOCK_PIPES["alu"] == 356
    assert round(peaks.aes_s(peaks.expansion_blocks(4096, fast)) * 1e3, 4) == 0.9803
    assert round(peaks.aes_s(peaks.expansion_blocks(1024, compat)) * 1e3, 2) == 68.46


def test_scan_bound_at_the_cells():
    # 2^20 x 256 B at Q = 4096: the operations bind; 2^20 x 3 B at Q = 1024:
    # the selection bits' bytes at HBM's rate bind
    assert round(peaks.scan_s(4096, 1 << 20, 256) * 1e3, 3) == 8.889
    assert peaks.scan_s(1024, 1 << 20, 3) == pytest.approx(
        ((1 << 20) * 3 + 1024 * (1 << 20) // 8 + 1024 * 3) / peaks.HBM_BYTES_PER_S)


def _ctx(busy_s, trace_batches, window_s, window_batches, kernels=()):
    from types import SimpleNamespace

    import devtrace
    import named

    ops = [(n, 0.0, d, True) for n, d in kernels]
    t = devtrace.Summary(window_s=1.0, busy_s=busy_s, ops=ops, batches=trace_batches)
    w = SimpleNamespace(seconds=window_s, batches=window_batches)
    return SimpleNamespace(trace=t, window=w, peaks=peaks, kernel_set=named.kernel_set,
                           mix={"batch": 1024}, config=_config("dpf2-compat-1mx3b"))


def test_idle_share_holds_busy_time_against_the_windows_period():
    import harness

    read = harness.reader("device.idle_share")
    # 0.1 s busy a traced batch, a 0.4 s period in the window: 75% idle
    assert read(_ctx(1.2, 12, 40.0, 100)) == pytest.approx(75.0)
    assert read(_ctx(0.0, 12, 40.0, 100)) is None


def test_aes_roofline_sums_the_sets_kernels():
    import harness

    read = harness.reader("aes_expand_roofline")
    bound = peaks.aes_s(peaks.expansion_blocks(1024, _config("dpf2-compat-1mx3b")))
    ks = [("compat_stage_kernel<true>", bound), ("compat_stage_kernel<false>", bound),
          ("packed_scan_kernel", 5.0)]
    assert read(_ctx(1.0, 2, 1.0, 1, ks)) == pytest.approx(100.0)
    assert read(_ctx(1.0, 2, 1.0, 1, ks[2:])) is None
