"""Peaks of the cards and the work of the engine's window step, frozen.

The step's bytes are counted from the cell's shapes and the state layout
of ``josefine_tpu_torch/raft/packed_step.py`` at commit 2a01ac5, so they
read the same work whatever implements the step later: the node's state
rows read once and written once, the membership mask read once, and per
row that the tick's input touches one packed inbox row up and one result
row down.
"""

from __future__ import annotations

# Published peaks (NVIDIA's data sheet, SXM part): HBM bytes per second.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

# One node's state per group: 12 int32 and 1 bool of (P,), 1 bool and
# 4 int32 of (P, N).
def state_bytes(groups: int, nodes: int) -> int:
    return groups * (12 * 4 + 1 + nodes * (1 + 4 * 4))


def inbox_row_bytes(nodes: int) -> int:
    """One touched row up: its index and its (10, N) packed int32 inbox."""
    return 4 + 10 * nodes * 4


def result_row_bytes(nodes: int) -> int:
    """One changed row down: its index, 10 scalar mirrors and (9, N) outbox."""
    return 4 + (10 + 9 * nodes) * 4


def step_bytes(groups: int, nodes: int, rows: int) -> int:
    """Bytes one engine tick's window step needs at ``rows`` touched rows."""
    return (2 * state_bytes(groups, nodes) + groups * nodes
            + rows * (inbox_row_bytes(nodes) + result_row_bytes(nodes)))
