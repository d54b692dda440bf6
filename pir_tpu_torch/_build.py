"""Build and load the port's CUDA kernels and its native host libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries go
to ``_build/`` beside this file, named by a hash of the source and the
flags, so a changed source rebuilds and an unchanged one loads at once.
``build()`` starts one ``nvcc`` per source, all at the same time.

The native host engine's C++ sources (``native/*.cpp``, ``HOST_SOURCES``)
build the same way with the host C++ compiler (``build_host``,
``load_host``). Every library is written to a temporary file of its own
process and thread, then renamed into place, so processes building the
same library at once each load a whole one. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .utils.metrics import span

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("stacked_tail", "packed_scan", "compat_stage", "fast_tail", "fused_scan_expand",
           "masked_xor_scan", "planes_scan", "overlap_probe", "mont_exp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NATIVE = Path(__file__).parent / "native"
# the native host engine's libraries: name -> (source, g++ flags), the
# flags of pir_tpu/native/__init__.py
HOST_SOURCES = {
    "pirnative": (NATIVE / "pir_native.cpp", ("-O3", "-maes", "-mavx2", "-shared", "-fPIC")),
    "bigmod": (NATIVE / "bigmod.cpp", ("-O3", "-shared", "-fPIC", "-pthread")),
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every stale library, one nvcc process per source, all in
    parallel. Returns {name: compiler log} for the sources compiled now
    (ptxas reports registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                with span("pir.kernel_load", name):
                    path = _lib_path(name)
                    if not path.exists():
                        build((name,))
                    lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def cxx_path() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise RuntimeError("no host C++ compiler: install g++ or set CXX")
    return found


def host_lib_path(name: str) -> Path:
    src, flags = HOST_SOURCES[name]
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def host_command(name: str, out: Path) -> list[str]:
    """The compiler command that builds HOST_SOURCES[name] into `out`."""
    src, flags = HOST_SOURCES[name]
    return [cxx_path(), *flags, str(src), "-o", str(out)]


def build_host(name: str) -> str:
    """Compile a native host library if it is stale; returns the compiler's
    log ("" when the library was already built). A failed build raises
    with the log."""
    out = host_lib_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(host_command(name, tmp), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build of {name} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load_host(name: str) -> ctypes.CDLL:
    """The loaded native host library `name`, built first if needed."""
    key = "host:" + name
    lib = _libs.get(key)
    if lib is None:
        with _lock:
            lib = _libs.get(key)
            if lib is None:
                with span("pir.kernel_load", name):
                    build_host(name)
                    lib = _libs[key] = ctypes.CDLL(str(host_lib_path(name)))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def count_launch(wrapper, n: int = 1) -> None:
    """Add n to a kernel wrapper's launch count under a lock: a service's
    handler threads launch the same kernels at once."""
    with _count_lock:
        wrapper.launches += n
