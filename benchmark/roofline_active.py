"""The work of one engine tick on the active-set path, frozen.

A compacted tick's bytes are counted from the state layout of
``josefine_tpu_torch/raft/packed_step.py`` (``_gather_active``,
``_active_window_fn``, ``_decay_scatter_fn``) at commit b479532, so they
read the same work whatever implements the tick later: the ``K`` gathered
rows of the node's state read and written once, the idle decay over all
``P`` rows (its two timer columns read and written once, and the role,
leader and alive columns it decides by read once), ``K`` membership rows
read once, and per active row one packed inbox row up and one result row
down; an all-quiescent tick (no active row) gathers nothing and is the
decay alone. A fallback tick runs the sparse step:
:func:`roofline.step_bytes`.
"""

from __future__ import annotations

from benchmark import roofline

# The decay per group: elapsed and hb_elapsed (int32) read and written,
# role and leader (int32) and alive (bool) read.
DECAY_ROW_BYTES = 2 * 2 * 4 + 2 * 4 + 1


def state_row_bytes(nodes: int) -> int:
    """One group's row of the node's state (see ``roofline.state_bytes``)."""
    return roofline.state_bytes(1, nodes)


def result_row_bytes(nodes: int) -> int:
    """One active row down: its 13 scalar mirrors and (9, N) outbox."""
    return (13 + 9 * nodes) * 4


def compacted_bytes(groups: int, nodes: int, bucket: int, active: int) -> int:
    """Bytes one compacted tick needs: ``bucket`` rows gathered and
    scattered, ``active`` of them stepped with IO."""
    return (2 * bucket * state_row_bytes(nodes) + groups * DECAY_ROW_BYTES
            + bucket * nodes
            + active * (roofline.inbox_row_bytes(nodes) + result_row_bytes(nodes)))

