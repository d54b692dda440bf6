"""Probe: do the card's integer pipes and its int8 tensor cores overlap?

Counterpart of ``benchmarks_overlap.py`` at the repository root, which
asks the same of a TPU's VPU and MXU inside one Pallas kernel. On the
card "vpu" means the integer pipes (shifts, logic, adds on 32-bit words)
and "mxu" the int8 tensor cores (``wgmma`` m64nNk32 s8). Three chains,
each equal word for word to its TPU counterpart:

  A (``vpu_chain``): ITERS dependent rounds of ``vpu_round`` over a
    (64, 512) uint32 tile, 32 integer operations an element a round;
  B (``mxu_chain``): ITERS dependent int8 products
    ``acc = (a + (acc[:, :1] & 1)) @ b``, a (128, 4096), b (4096, 256),
    int32 accumulators from zero;
  C (``mixed``): both chains in one kernel, on independent data, in two
    placements: ``mixed_probe`` runs the integer rounds inside the
    warpgroup that issues the bulk products, between their commit and
    their wait (the TPU's one body), ``mixed_split_probe`` in warps of
    their own.

If t_C ~ max(t_A, t_B) the units overlap; if t_C ~ t_A + t_B they take
turns. ``overlap`` = (t_A + t_B - t_C) / min(t_A, t_B), as in the TPU
probe; ``overlap_split`` is the same of the split placement, and
``streams_overlap`` of A's and B's kernels launched at once on two CUDA
streams (``streams``) in place of C.

The plain torch versions (``vpu_round``, ``vpu_chain``, ``mxu_chain``,
``mixed``) hold uint32 words as int32 bit patterns and compute in int64,
masked to 32 bits; the products are float64 (exact: |acc| <= 2^26). The
kernel wrappers (``vpu_probe``, ``mxu_probe``, ``mixed_probe``,
``mixed_split_probe``) launch ``csrc/overlap_probe.cu`` for CUDA tensors
and run the plain version for CPU tensors. ``chain_latencies`` measures
on the card the three latencies of the chains' dependent paths, and
``chain_floor_ms`` turns them into each chain's floor.

    python -m pir_tpu_torch.benchmarks_overlap [--iters N] [--reps N] [--device cpu]

prints one JSON line: vpu_ms, mxu_ms, mixed_ms, mixed_split_ms, overlap,
overlap_split, streams_ms, streams_overlap, max_active_clusters (A's
blocks an SM, each clustered kernel's clusters the card holds at once:
a launch is PROBE_BLOCKS / CLUSTER of them, and the B + A block pairs an
SM holds for the two-stream run), and the run's device, iters, reps. It
runs on the card unless ``--device cpu`` (then the plain versions, timed
on the host).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

import numpy as np
import torch

from . import _build

ITERS = 256
REPS = 30
VSHAPE = (64, 512)
M, K, N = 128, 4096, 256
V_OPS = 16  # the TPU probe's constant: V_OPS // 4 steps of 8 operations, 32 a round
ROUND_OPS = 2 * V_OPS  # integer operations an element a round
# instructions an element a round: a quarter round is 3 shift + LOP3 pairs
# and one add ((v & c) ^ s is one LOP3), 7 for its 8 operations
ROUND_INSTRS = 7 * V_OPS // 4
C = 0x9E3779B9
MASK32 = 0xFFFFFFFF
# The kernels' grid (csrc/overlap_probe.cu): B and C run 64 blocks, one an
# SM, in 4 clusters of 16, one cluster a 64-row m-tile and 128-column
# N-group of the product, its blocks the 16 slices of K, each block 512
# words of v; A alone runs 128 blocks of 256 words.
PROBE_BLOCKS = 64
CLUSTER = 16
# dependent m64n8k32 steps of a round's critical tile (a K slice of 256)
CRIT_STEPS = K // CLUSTER // 32
# chain_latencies: repetitions of each probe, and its kernels' ids
LATENCY_REPS = 1 << 14
LATENCY_PROBES = ("int_round", "wgmma_step", "dsmem_hop")

_ARGTYPES = {
    "vpu": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "mxu": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p],
    "mixed": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p],
    "mixed_split": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p],
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---- plain versions -------------------------------------------------------

def vpu_round(v: torch.Tensor) -> torch.Tensor:
    """One round of the integer chain on uint32 values held in int64
    (counterpart of ``_vpu_round``): 4 times v ^= v << 1; v |= v >> 3;
    v = (v & c) ^ (v << 2); v += c, every result modulo 2^32."""
    for _ in range(V_OPS // 4):
        v = v ^ ((v << 1) & MASK32)
        v = v | (v >> 3)
        v = (v & C) ^ ((v << 2) & MASK32)
        v = (v + C) & MASK32
    return v


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> their int32 bit patterns."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def vpu_chain(v: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """(64, 512) int32 words after `iters` rounds (``vpu_kernel``)."""
    x = v.to(torch.int64) & MASK32
    for _ in range(iters):
        x = vpu_round(x)
    return _to_i32(x)


def mxu_chain(a: torch.Tensor, b: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """(128, 256) int32 accumulators after `iters` dependent products
    (``mxu_kernel``): each round adds the parity of the previous round's
    column 0 to its row of a, as an int8 add that wraps, then multiplies
    by b. float64 products are exact here (at most 2^26)."""
    a64 = a.to(torch.int64)
    bf = b.to(torch.float64)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64, device=a.device)
    for _ in range(iters):
        ai = ((a64 + (acc[:, :1] & 1) + 128) & 255) - 128
        acc = (ai.to(torch.float64) @ bf).to(torch.int64)
    return acc.to(torch.int32)


def mixed(v: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          iters: int = ITERS) -> tuple[torch.Tensor, torch.Tensor]:
    """Both chains (``mixed_kernel``): (vpu_chain(v), mxu_chain(a, b))."""
    return vpu_chain(v, iters), mxu_chain(a, b, iters)


# ---- kernel wrappers --------------------------------------------------------

def check_operands(v=None, a=None, b=None) -> torch.device:
    """Raise unless the given operands have the probe's shapes and
    dtypes and lie on one device; returns that device."""
    given = []
    for name, x, shape, dtype in (("v", v, VSHAPE, torch.int32), ("a", a, (M, K), torch.int8),
                                  ("b", b, (K, N), torch.int8)):
        if x is None:
            continue
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be a {shape} {dtype} tensor, not "
                             f"{tuple(x.shape)} {x.dtype}")
        given.append(x)
    if len({x.device for x in given}) != 1:
        raise ValueError("the probe's operands are on different devices")
    dev = given[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no overlap probe for device {dev}")
    if dev.type == "cuda" and not all(x.is_contiguous() and x.data_ptr() % 16 == 0
                                      for x in given):
        raise ValueError("the kernels read contiguous, 16-byte aligned operands")
    return dev


def _launch(kind: str, dev: torch.device, ptrs: list[int], iters: int) -> None:
    if iters < 0:
        raise ValueError("iters must be >= 0")
    fn = getattr(_build.load("overlap_probe"), f"pir_overlap_{kind}")
    fn.argtypes, fn.restype = _ARGTYPES[kind], ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*ptrs, iters, torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"overlap_probe {kind}")


def vpu_probe(v: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """Chain A: the integer kernel for a CUDA tensor, vpu_chain for CPU."""
    dev = check_operands(v=v)
    if dev.type == "cpu":
        return vpu_chain(v, iters)
    out = torch.empty_like(v)
    _launch("vpu", dev, [v.data_ptr(), out.data_ptr()], iters)
    _build.count_launch(vpu_probe)
    return out


def mxu_probe(a: torch.Tensor, b: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """Chain B: the wgmma kernel for CUDA tensors, mxu_chain for CPU."""
    dev = check_operands(a=a, b=b)
    if dev.type == "cpu":
        return mxu_chain(a, b, iters)
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    _launch("mxu", dev, [a.data_ptr(), b.data_ptr(), out.data_ptr()], iters)
    _build.count_launch(mxu_probe)
    return out


def _mixed(kind: str, wrapper, v, a, b, iters):
    dev = check_operands(v=v, a=a, b=b)
    if dev.type == "cpu":
        return mixed(v, a, b, iters)
    vo = torch.empty_like(v)
    mo = torch.empty((M, N), dtype=torch.int32, device=dev)
    _launch(kind, dev, [v.data_ptr(), a.data_ptr(), b.data_ptr(), vo.data_ptr(),
                        mo.data_ptr()], iters)
    _build.count_launch(wrapper)
    return vo, mo


def mixed_probe(v: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                iters: int = ITERS) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain C in one body: the integer rounds inside the warpgroup that
    issues the bulk products, between their commit and their wait, for
    CUDA tensors; mixed for CPU."""
    return _mixed("mixed", mixed_probe, v, a, b, iters)


def mixed_split_probe(v: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      iters: int = ITERS) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain C split: the integer rounds in warps of their own beside the
    product warpgroups, for CUDA tensors; mixed for CPU."""
    return _mixed("mixed_split", mixed_split_probe, v, a, b, iters)


vpu_probe.launches = 0
mxu_probe.launches = 0
mixed_probe.launches = 0
mixed_split_probe.launches = 0


def max_active_clusters(device="cuda") -> dict:
    """Residency on the card: "vpu", A's blocks an SM; "mxu", "mixed",
    "mixed_split", the clusters of CLUSTER blocks of each kernel the card
    holds at once (``cudaOccupancyMaxActiveClusters``; a launch needs
    PROBE_BLOCKS / CLUSTER); "pair", the pairs of one B block and one A
    block an SM holds by registers, shared memory and threads (the
    two-stream run needs 1); "cluster", the cluster size."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("cluster residency needs a CUDA device")
    out = (ctypes.c_int * 6)()
    fn = _build.load("overlap_probe").pir_overlap_max_clusters
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(ctypes.addressof(out))
    _build.check(err, "overlap_probe max_clusters")
    return dict(zip(("vpu", "mxu", "mixed", "mixed_split", "pair", "cluster"), out))


def chain_latencies(device="cuda", reps: int = LATENCY_REPS) -> dict:
    """The latencies of the chains' dependent paths, measured on the card
    with clock64 and globaltimer over `reps` repetitions each:
    "int_round", one element's round of A (28 dependent SHF, LOP3 and
    IADD3 instructions) on one thread; "wgmma_step", one of CRIT_STEPS
    dependent m64n8k32 s8 products, a group of them committed and waited
    for as the critical tile runs them; "dsmem_hop", one 16-byte st.async
    into a peer's shared memory, counted on its transaction mbarrier and
    seen by the peer (half a round trip). Each {"cycles": per step,
    "ns": per step}."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the latency probes need a CUDA device")
    fn = _build.load("overlap_probe").pir_overlap_latency
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    steps = {"int_round": reps, "wgmma_step": CRIT_STEPS * reps, "dsmem_hop": 2 * reps}
    rng = np.random.default_rng(reps)
    io = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 512, dtype=np.int64)
                          .astype(np.int32)).to(dev)
    lat = {}
    with torch.cuda.device(dev):
        for which, name in enumerate(LATENCY_PROBES):
            out = torch.zeros(3, dtype=torch.int64, device=dev)
            err = fn(which, reps, io.data_ptr(), out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            _build.check(err, f"overlap_probe latency {name}")
            cycles, ns, bad = out.tolist()
            if bad:
                raise RuntimeError(f"the {name} probe read {bad} wrong words")
            lat[name] = {"cycles": cycles / steps[name], "ns": ns / steps[name]}
    return lat


def chain_floor_ms(lat: dict, iters: int) -> dict:
    """Each chain's floor in ms: `iters` rounds of its dependent path's
    least latency (`lat` as chain_latencies gives it). A: one element's
    round. B: CRIT_STEPS dependent products of the critical tile and one
    hop of its row bits. C: the larger of the two."""
    a = iters * lat["int_round"]["ns"] * 1e-6
    b = iters * (CRIT_STEPS * lat["wgmma_step"]["ns"] + lat["dsmem_hop"]["ns"]) * 1e-6
    return {"vpu": a, "mxu": b, "mixed": max(a, b), "mixed_split": max(a, b)}


def streams(v: torch.Tensor, a: torch.Tensor, b: torch.Tensor, iters: int = ITERS,
            pair: tuple | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """A's and B's kernels launched at once on two CUDA streams (`pair`,
    made here when None), both ordered after the current stream's work
    and joined back into it."""
    dev = check_operands(v=v, a=a, b=b)
    if dev.type != "cuda":
        raise ValueError("the two-stream run needs CUDA tensors")
    cur = torch.cuda.current_stream(dev)
    s_a, s_b = pair or (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    s_a.wait_stream(cur)
    s_b.wait_stream(cur)
    with torch.cuda.stream(s_a):
        vo = vpu_probe(v, iters)
    with torch.cuda.stream(s_b):
        mo = mxu_probe(a, b, iters)
    cur.wait_stream(s_a)
    cur.wait_stream(s_b)
    vo.record_stream(cur)
    mo.record_stream(cur)
    return vo, mo


# ---- the probe run ----------------------------------------------------------

def make_inputs(seed: int = 0, device="cpu"):
    """v, a, b from `seed`, drawn as the TPU probe draws them."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 32, size=VSHAPE, dtype=np.uint32)
    a = rng.integers(-64, 64, size=(M, K), dtype=np.int8)
    b = rng.integers(-64, 64, size=(K, N), dtype=np.int8)
    return tuple(torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(device)
                 for x in (v, a, b))


def _timer(dev: torch.device):
    """fn, reps -> ms per call: CUDA events on the card, the host clock
    on the CPU."""
    if dev.type == "cuda":
        def ms(fn, reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / reps
    else:
        def ms(fn, reps):
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t) * 1e3 / reps
    return ms


def overlap_of(ta: float, tb: float, tc: float) -> float:
    """(t_A + t_B - t_C) / min(t_A, t_B): 1.0 when the shorter chain is
    wholly hidden, <= 0 when the two take turns."""
    return (ta + tb - tc) / min(ta, tb) if min(ta, tb) > 0 else 0.0


def run(iters: int = ITERS, reps: int = REPS, device=None, seed: int = 0) -> dict:
    """The probe: inputs from `seed`, each kernel once checked against its
    plain version (equal words; on the card), then A, B, C in both
    placements and the two streams timed over `reps` calls after one
    warm-up call. Runs on the card unless device="cpu"."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the overlap probe needs a CUDA device; pass device='cpu' "
                               "to time the plain versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    v, a, b = make_inputs(seed, dev)
    ms = _timer(dev)
    calls = {"vpu": lambda: (vpu_probe(v, iters),), "mxu": lambda: (mxu_probe(a, b, iters),),
             "mixed": lambda: mixed_probe(v, a, b, iters),
             "mixed_split": lambda: mixed_split_probe(v, a, b, iters)}
    if dev.type == "cuda":
        pair = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
        calls["streams"] = lambda: streams(v, a, b, iters, pair)
        want = {"vpu": (vpu_chain(v, iters),), "mxu": (mxu_chain(a, b, iters),)}
        want["mixed"] = want["mixed_split"] = want["streams"] = want["vpu"] + want["mxu"]
        for name, call in calls.items():  # also the warm-up call
            if not all(torch.equal(g, w) for g, w in zip(call(), want[name])):
                raise RuntimeError(f"the {name} kernel disagrees with its plain version")
    else:
        for call in calls.values():
            call()
    rec = {f"{name}_ms": ms(call, reps) for name, call in calls.items()}
    rec["overlap"] = overlap_of(rec["vpu_ms"], rec["mxu_ms"], rec["mixed_ms"])
    rec["overlap_split"] = overlap_of(rec["vpu_ms"], rec["mxu_ms"], rec["mixed_split_ms"])
    if dev.type == "cuda":
        rec["streams_overlap"] = overlap_of(rec["vpu_ms"], rec["mxu_ms"], rec["streams_ms"])
        rec["max_active_clusters"] = max_active_clusters(dev)
        rec["device"] = torch.cuda.get_device_name(dev)
    else:
        rec["streams_ms"] = rec["streams_overlap"] = None  # no streams on the CPU
        rec["max_active_clusters"] = None
        rec["device"] = "cpu"
    rec.update(iters=iters, reps=reps)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    rec = run(args.iters, args.reps, args.device, args.seed)
    log(f"{rec['device']}: iters {args.iters}, serial sum {rec['vpu_ms'] + rec['mxu_ms']:.4f} "
        f"ms, max {max(rec['vpu_ms'], rec['mxu_ms']):.4f} ms, mixed {rec['mixed_ms']:.4f} ms, "
        f"mixed_split {rec['mixed_split_ms']:.4f} ms")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
