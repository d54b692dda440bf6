"""pir_tpu_torch — the PyTorch / CUDA port of pir_tpu for one NVIDIA H100.

It serves 2-server PIR index batches of both key styles: client keygen
and share construction on the host (numpy); on the device the root head
walk (plain torch), then for fast keys the stacked tail kernel (or the
per-query tail kernel, ``fast_stacked=False``) and for reference-exact
(compat) keys the compat-stage kernel, and the packed scan kernel; the
serving stream's fused mode runs the scan and the next batch's tail in
one kernel. Single queries and small batches expand per query and scan
with the masked-XOR scan kernel. Keyword queries (2-party, and with
multi-party shares for >= 3 servers) and multi-party index queries
evaluate on the device too; keyword batches scan with the bit-plane
scan kernel. ``MeshPirServer`` (``parallel/mesh.py``) answers the same
batches over a grid of devices: row shards (tp) by batch slices (dp),
the shards' partial answers folded with XOR.
``TorchPirServer.apply_updates`` changes rows live and
``Database.save`` / ``load`` checkpoint a table; ``benchmarks_overlap``
ports the TPU overlap probe. The kernels are hand-written CUDA
(``csrc/``).

The serving shell (``service.PirService`` / ``PirClient``, the same
frames and ``wire`` messages as pir_tpu's) answers every protocol family
over TCP: index, keyword and multi-party shares on a TorchPirServer,
single-server cPIR under Paillier (``encrypted``, ``crypto/paillier``:
CPython on the host, or with engine ``"torch"`` its batched modexps on
the card's Montgomery kernels, ``crypto/mont``) and both ASPIR variants
(``aspir``, ``aspir_shared``); ``config.PirConfig`` picks the engines and
device, and ``python -m pir_tpu_torch.demo`` runs them all. Nothing of JAX or of
pir_tpu is imported; each module names its pir_tpu counterpart.
"""

from .database import (
    Database,
    DBMetadata,
    generate_empty_db,
    generate_random_db,
    get_optimal_db_dimensions,
    get_optimal_weighted_db_dimensions,
    new_database,
)
from .query import (
    QueryShare,
    SecretSharedQueryResult,
    new_fast_index_query_shares,
    new_index_query_shares,
    new_index_query_shares_batch,
    new_keyword_query_shares,
    new_keyword_query_shares_batch,
    recover,
)
from .parallel.mesh import MeshPirServer, make_mesh
from .server import FastServingStream, TorchPirServer
from .slot import (
    Slot,
    get_required_slot_size,
    new_empty_slot,
    new_random_slot,
    new_slot,
    new_slot_from_string,
    xor_slots,
)

__all__ = [
    "Database",
    "DBMetadata",
    "FastServingStream",
    "MeshPirServer",
    "QueryShare",
    "SecretSharedQueryResult",
    "Slot",
    "TorchPirServer",
    "generate_empty_db",
    "generate_random_db",
    "get_optimal_db_dimensions",
    "get_optimal_weighted_db_dimensions",
    "get_required_slot_size",
    "make_mesh",
    "new_database",
    "new_empty_slot",
    "new_fast_index_query_shares",
    "new_index_query_shares",
    "new_index_query_shares_batch",
    "new_keyword_query_shares",
    "new_keyword_query_shares_batch",
    "new_random_slot",
    "new_slot",
    "new_slot_from_string",
    "recover",
    "xor_slots",
]
