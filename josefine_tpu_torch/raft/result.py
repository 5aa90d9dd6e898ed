"""Engine result types shared across the engine's split modules.

Kept dependency-free so ``engine``, ``snap_transfer``, ``group_admin`` and
``hostio`` can all import them without cycles. Re-exported from
``josefine_tpu.raft.engine`` for compatibility (every external caller
imports them from there).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from josefine_tpu_torch.raft import rpc
from josefine_tpu_torch.raft.membership import ConfChange


class NotLeader(Exception):
    """Raised into proposal futures when this node cannot mint; carries the
    current leader hint for the server to re-route (reference proxy path,
    ``src/raft/follower.rs:258-269``)."""

    def __init__(self, group: int, leader: int):
        super().__init__(f"not leader of group {group}; leader hint {leader}")
        self.group = group
        self.leader = leader


@dataclass
class TickResult:
    outbound: list[rpc.WireMsg] = field(default_factory=list)
    committed: dict[int, int] = field(default_factory=dict)  # group -> new commit id
    became_leader: list[int] = field(default_factory=list)
    lost_leadership: list[int] = field(default_factory=list)
    conf_changes: list[ConfChange] = field(default_factory=list)
