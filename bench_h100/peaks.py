"""The yardstick's constants and work counts: the card's data-sheet peaks
and the least time of the work a batch needs, from its shapes alone.

Peaks are NVIDIA's H100 SXM data sheet, dense, at the 700 W limit. The
AES cost is one T-table AES-128 block counted by the pipe each of its
instructions needs (integer: 9 rounds of 16 byte extractions, 12
rotations and 8 three-input XORs, and a last round of 16 extractions,
12 byte assemblies and 4 XORs; FMA: one address a lookup; shared memory:
160 lookups); the busiest pipe bounds. The counts read the same work
whatever implements it: a kernel's time is set against them.
"""

from __future__ import annotations

import dpf_ref

INT8_TENSOR_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer lanes: 64 a clock an SM against the 128 float32 lanes
# behind the 67 TFLOP/s float32 figure (which counts an FMA as two)
INT32_OPS_PER_S = 67e12 / 4
# 32 banks of 4 bytes a clock an SM: one conflict-free 32-lane load a clock
SMEM_WORDS_PER_S = 67e12 / 8
AES_BLOCK_PIPES = {"alu": 9 * (16 + 12 + 8) + (16 + 12 + 4), "fma": 160, "lds": 160}
AES_PIPE_RATES = {"alu": INT32_OPS_PER_S, "fma": INT32_OPS_PER_S, "lds": SMEM_WORDS_PER_S}
# AES blocks a node of the tree walk expands with (left, right, t bits)
BLOCKS_PER_NODE = 3


def aes_s(blocks: int) -> float:
    """Least seconds of `blocks` AES-128 blocks: their busiest pipe."""
    return max(blocks * n / AES_PIPE_RATES[p] for p, n in AES_BLOCK_PIPES.items())


def scan_ops(queries: int, rows: int, row_bytes: int) -> int:
    """Operations of the GF(2) product of a batch's selection bits with the
    table's 8 bit planes: 8 x 2 x Q x H x B int8 multiply-adds."""
    return 8 * 2 * queries * rows * row_bytes


def scan_s(queries: int, rows: int, row_bytes: int) -> float:
    """Least seconds of a batch's scan: the larger of its int8 operations at
    the tensor cores' peak and its bytes (table once, bits, answers) at HBM's."""
    ops = scan_ops(queries, rows, row_bytes) / INT8_TENSOR_OPS_PER_S
    nbytes = rows * row_bytes + queries * rows // 8 + queries * row_bytes
    return max(ops, nbytes / HBM_BYTES_PER_S)


def walk_nodes(height: int, levels: int) -> int:
    """Nodes a full-domain walk of `levels` levels expands to reach the
    leaves above [0, height): at level i, the ceil(height / 2^(levels - i))
    nodes whose subtrees meet the rows."""
    return sum(-(-height // (1 << (levels - i))) for i in range(levels))


def expansion_blocks(queries: int, config: dict) -> int:
    """AES blocks of a batch's whole expansion, from the key format alone:
    every node of the key's tree whose subtree meets the rows expands once,
    and each fast leaf runs leaf_bits / 128 CTR blocks. However a program
    splits the levels between its walks and kernels, the count is the same."""
    rows = config["rows"]
    if config["keys"] == "fast":
        leaf_bits = config["leaf_bits"]
        leaves = -(-rows // leaf_bits)
        depth = dpf_ref.fast_depth(rows, leaf_bits)
        per_query = BLOCKS_PER_NODE * walk_nodes(leaves, depth) + leaves * (leaf_bits // 128)
    else:
        per_query = BLOCKS_PER_NODE * walk_nodes(rows, dpf_ref.num_bits_for_height(rows))
    return queries * per_query
