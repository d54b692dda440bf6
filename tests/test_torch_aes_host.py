"""The kernels' AES-128 and bit-plane transpose, built for the host.

csrc/aes_lanes_host.cpp compiles the per-bank T-table AES of
csrc/aes_lanes.cuh (every AES kernel of the port: the stacked tail,
compat stage, per-query tail and fused kernels) and the lockstep model
of the kernels' warp transpose with a host C++ compiler. The AES must
give FIPS-197's ciphertext as every lane reads the table, and equal the
port's numpy AES on random blocks and keys; the transpose must hand each
lane the block that a plain un-bitslice of the planes gives.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from pir_tpu_torch.dpf.aes_host import aes_encrypt_blocks, key_schedule, key_schedule_batch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(__file__).resolve().parent.parent / "pir_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def host_aes(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib_path = tmp_path_factory.mktemp("aes_host") / "libaes_lanes_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path),
                    str(CSRC / "aes_lanes_host.cpp")], check=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.pir_aes_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.pir_aes_host.restype = None
    lib.pir_unbitslice_host.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_longlong, ctypes.c_void_p]
    lib.pir_unbitslice_host.restype = None
    return lib


def _encrypt(lib, round_keys, blocks, lane):
    """(n, 11, 16) uint8 round keys, (n, 16) uint8 blocks -> (n, 16) uint8."""
    rk = np.ascontiguousarray(round_keys, dtype=np.uint8).view(np.uint32).reshape(-1, 44)
    inp = np.ascontiguousarray(blocks, dtype=np.uint8).view(np.uint32).reshape(-1, 4)
    out = np.zeros_like(inp)
    lib.pir_aes_host(rk.ctypes.data, inp.ctypes.data, out.ctypes.data, inp.shape[0], lane)
    return out.view(np.uint8).reshape(-1, 16)


def test_fips197_c1_as_every_lane_reads_the_table(host_aes):
    """FIPS-197 appendix C.1: key 000102..0f, plaintext 00112233..ff."""
    rk = key_schedule(bytes(range(16)))[None]
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"), np.uint8)[None]
    want = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    for lane in range(32):
        assert _encrypt(host_aes, rk, pt, lane).tobytes() == want, lane


def test_lane_table_equals_one_copy_table_and_numpy(host_aes):
    """256 seeded random blocks, each under its own random key, as every
    lane reads the table, against the numpy AES (the one-copy table this
    test once also held them against is gone from the kernels)."""
    rng = np.random.default_rng(11)
    rk = key_schedule_batch(rng.integers(0, 256, size=(256, 16), dtype=np.uint8))
    blocks = rng.integers(0, 256, size=(256, 16), dtype=np.uint8)
    want = np.stack([aes_encrypt_blocks(b[None], k)[0] for b, k in zip(blocks, rk)])
    for lane in range(32):
        assert np.array_equal(_encrypt(host_aes, rk, blocks, lane), want), lane


def test_every_byte_value_in_every_lane(host_aes):
    """Blocks whose 16 state bytes cover all 256 values, so every table
    entry is read at least once in the first round, as each lane."""
    rk = key_schedule(bytes(16))[None].repeat(16, axis=0)  # round key 0 is zero
    blocks = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = np.stack([aes_encrypt_blocks(b[None], rk[0])[0] for b in blocks])
    for lane in range(32):
        assert np.array_equal(_encrypt(host_aes, rk, blocks, lane), want), lane


@pytest.mark.parametrize("bit_stride,byte_stride", [(16, 1), (16 * 20, 20), (16 * 3 * 8, 8)])
def test_unbitslice_lockstep_equals_plain_unbitslice(host_aes, bit_stride, byte_stride):
    """The warp transpose's lockstep model: lane j's block byte i bit k is
    bit j of plane word (bit k, byte i), at the strides the kernels use."""
    rng = np.random.default_rng(bit_stride + byte_stride)
    buf = rng.integers(0, 1 << 32, size=8 * bit_stride + 16 * byte_stride,
                       dtype=np.uint64).astype(np.uint32)
    planes = np.array([[buf[k * bit_stride + i * byte_stride] for i in range(16)]
                       for k in range(8)], dtype=np.uint32)  # (bit, byte)
    bits = (planes[None] >> np.arange(32, dtype=np.uint32)[:, None, None]) & 1  # (lane, bit, byte)
    want = (bits << np.arange(8, dtype=np.uint32)[None, :, None]).sum(axis=1).astype(np.uint8)
    got = np.zeros((32, 4), np.uint32)
    host_aes.pir_unbitslice_host(buf.ctypes.data, bit_stride, byte_stride, got.ctypes.data)
    assert np.array_equal(got.view(np.uint8).reshape(32, 16), want)
