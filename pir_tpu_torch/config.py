"""Runtime configuration (counterpart of ``pir_tpu/config.py``): one small
dataclass gathers the deployment knobs, and ``pick_engine`` resolves the
answer engine.

Engines: ``"torch"`` answers on a ``TorchPirServer`` (the card unless
``device="cpu"``), ``"mesh"`` on a ``parallel.mesh.MeshPirServer`` over
a grid of ``mesh_tp`` row shards by ``mesh_dp`` batch slices (the cards
of the process, or with ``device="cpu"`` CPU shards), ``"native"`` on a
``server.NativePirServer`` (the C++/AES-NI host engine, ``native/``),
``"host"`` on the numpy golden model; the caller asks for the host
engines by name. ``"auto"`` resolves to ``"torch"``, or to ``"mesh"``
when ``mesh_tp * mesh_dp > 1`` (so does ``"torch"``, as pir_tpu promotes
its ``"tpu"``), so a service with no GPU and no device given fails
instead of answering on the host. That is a deliberate difference from
pir_tpu's ``pick_engine`` (``pir_tpu/config.py:175-178``), whose
``"auto"`` falls back to its native engine, then to the host, where no
accelerator is attached: the port never moves a service to the host
unasked, even where the native library builds.

The cPIR engine ``paillier_engine`` is ``"torch"``, the batched
Montgomery engine on ``device`` (pir_tpu's ``"tpu"``, under the port's
engine name), ``"native"``, the threaded C++ scan and modexps on the
host, or ``"python"``, the CPython loop; the caller asks for the host
ones by name. None resolves to ``"torch"``, so the cPIR scans and the
AHE ASPIR proof checks of a config with no device run on the card and
fail without one, as ``"auto"`` does. pir_tpu's ``"tpu"`` names are
refused: they point to ``"torch"``. Its ``use_pallas`` and JAX
compile-cache knobs have no counterpart: the port compiles nothing per
shape, and its kernels build at first use.
"""

from __future__ import annotations

from dataclasses import dataclass

_REFUSED_ENGINES = {
    "tpu": "the TPU engine has no port; use engine='torch'",
}
_REFUSED_PAILLIER = {
    "tpu": "the TPU cPIR scan engine has no port; use paillier_engine='torch'",
}


# cPIR key size (db_test.go:330)
PAILLIER_BITS = 1024


@dataclass
class PirConfig:
    engine: str = "auto"  # auto | host | native | torch | mesh
    # cPIR engine (encrypted.scan_engine): None or "torch", the scans and
    # the AHE ASPIR proof checks on `device`; "native", the C++ engine on
    # the host; "python", the CPython loop
    paillier_engine: str | None = None
    min_device_nodes: int = 32  # host-prefix cutoff of per-query expansion
    # the torch engines' device: None is the card, "cpu" runs the kernels'
    # plain versions
    device: str | None = None

    # the mesh engine's grid (rows 'tp', queries 'dp'; parallel/mesh.py):
    # mesh_tp * mesh_dp > 1 with engine auto or torch selects it
    mesh_tp: int = 1
    mesh_dp: int = 1
    # lane words of the mesh's compat cascade head: the compat root step
    # takes device_bits - log2(tp) > 5 + log2(w) (pir_tpu's knob)
    mesh_compat_w: int = 128

    def validate(self) -> "PirConfig":
        if self.engine in _REFUSED_ENGINES:
            raise ValueError(_REFUSED_ENGINES[self.engine])
        if self.engine not in ("auto", "host", "native", "torch", "mesh"):
            raise ValueError(f"unknown engine {self.engine}")
        if self.paillier_engine in _REFUSED_PAILLIER:
            raise ValueError(_REFUSED_PAILLIER[self.paillier_engine])
        if self.paillier_engine not in (None, "python", "native", "torch"):
            raise ValueError(f"unknown paillier engine {self.paillier_engine}")
        if self.mesh_tp < 1 or self.mesh_dp < 1:
            raise ValueError("mesh_tp/mesh_dp must be >= 1")
        if self.mesh_compat_w < 1 or self.mesh_compat_w & (self.mesh_compat_w - 1):
            raise ValueError("mesh_compat_w must be a power of two")
        return self


def pick_engine(cfg: PirConfig) -> str:
    """The engine `cfg` names, "auto" resolved to "torch", and "auto" or
    "torch" promoted to "mesh" when mesh_tp * mesh_dp > 1 (pir_tpu's
    pick_engine); refused engines raise ValueError (PirConfig.validate)."""
    cfg.validate()
    if cfg.engine in ("auto", "torch"):
        return "mesh" if cfg.mesh_tp * cfg.mesh_dp > 1 else "torch"
    return cfg.engine
