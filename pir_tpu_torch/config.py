"""Runtime configuration (counterpart of ``pir_tpu/config.py``): one small
dataclass gathers the deployment knobs, and ``pick_engine`` resolves the
answer engine.

Engines: ``"torch"`` answers on a ``TorchPirServer`` (the card unless
``device="cpu"``), ``"host"`` on the numpy golden model, which the
caller asks for by name; ``"auto"`` resolves to ``"torch"``, so a
service with no GPU and no device given fails instead of answering on
the host. The cPIR engine ``paillier_engine`` is ``"torch"``, the
batched Montgomery engine on ``device`` (pir_tpu's ``"tpu"``, under the
port's engine name), or ``"python"``, the CPython loop, which the caller
asks for by name; None resolves to ``"torch"``, so the cPIR scans and
the AHE ASPIR proof checks of a config with no device run on the card
and fail without one, as ``"auto"`` does. pir_tpu's other
engines are refused by name: its mesh engine (ROADMAP queue 1 [14]), its
native C++ engine and native cPIR scan (queue 1 [18]), and its ``"tpu"``
names, which point to ``"torch"``. Its ``use_pallas`` and JAX
compile-cache knobs have no counterpart: the port compiles nothing per
shape, and its kernels build at first use.
"""

from __future__ import annotations

from dataclasses import dataclass

_REFUSED_ENGINES = {
    "mesh": "the mesh engine is not ported (ROADMAP queue 1 [14])",
    "native": "the native C++ engine is not ported (ROADMAP queue 1 [18])",
    "tpu": "the TPU engine has no port; use engine='torch'",
}
_REFUSED_PAILLIER = {
    "native": "the native cPIR scan engine is not ported (ROADMAP queue 1 [18])",
    "tpu": "the TPU cPIR scan engine has no port; use paillier_engine='torch'",
}


# cPIR key size (db_test.go:330)
PAILLIER_BITS = 1024


@dataclass
class PirConfig:
    engine: str = "auto"  # auto | host | torch
    # cPIR engine (encrypted.scan_engine): None or "torch", the scans and
    # the AHE ASPIR proof checks on `device`; "python", the CPython loop
    paillier_engine: str | None = None
    min_device_nodes: int = 32  # host-prefix cutoff of per-query expansion
    # the torch engines' device: None is the card, "cpu" runs the kernels'
    # plain versions
    device: str | None = None

    # pir_tpu's multi-chip mesh (rows 'tp', queries 'dp'): only 1 x 1
    mesh_tp: int = 1
    mesh_dp: int = 1

    def validate(self) -> "PirConfig":
        if self.engine in _REFUSED_ENGINES:
            raise ValueError(_REFUSED_ENGINES[self.engine])
        if self.engine not in ("auto", "host", "torch"):
            raise ValueError(f"unknown engine {self.engine}")
        if self.paillier_engine in _REFUSED_PAILLIER:
            raise ValueError(_REFUSED_PAILLIER[self.paillier_engine])
        if self.paillier_engine not in (None, "python", "torch"):
            raise ValueError(f"unknown paillier engine {self.paillier_engine}")
        if self.mesh_tp < 1 or self.mesh_dp < 1:
            raise ValueError("mesh_tp/mesh_dp must be >= 1")
        if self.mesh_tp * self.mesh_dp > 1:
            raise ValueError(_REFUSED_ENGINES["mesh"])
        return self


def pick_engine(cfg: PirConfig) -> str:
    """The engine `cfg` names, "auto" resolved to "torch"; refused engines
    raise ValueError (PirConfig.validate)."""
    cfg.validate()
    return "torch" if cfg.engine == "auto" else cfg.engine
