"""Runtime cluster membership: conf-change entries and the member table.

The reference's peer set is static TOML config — no node add/remove at
runtime (``src/raft/config.rs:26``, SURVEY.md §5 "no membership change").
This module makes membership a replicated, durable part of cluster state:

* the device kernel already consumes membership as a boolean mask over the
  node axis (quorum = live-member majority), so changing membership is a
  host-side mask update — no recompilation, no new tensors;
* node slots are pre-allocated: the node axis has ``max_nodes`` columns and
  a cluster can grow into free slots and shrink by masking columns off.
  A re-added node id keeps its old slot (and its durable chain);
* changes ride the chain as conf blocks — payloads prefixed ``CONF_PREFIX``
  that the engine applies to the member table at COMMIT time on every node
  (one change in flight at a time: the standard single-server membership
  rule, which never creates two disjoint quorums);
* the member table (id -> slot, active, address) is persisted in the KV, so
  a restarted node recovers the current cluster shape even if its TOML is
  stale.

Disruption-proofing (round 2): messages from non-member slots are masked on
device, and the kernel's pre-vote mode (``StepParams.prevote``, default on)
means a node that cannot reach a quorum never bumps any term — so neither a
removed node nor a long-partitioned member can disrupt a healthy group on
rejoin (``tests/test_membership.py::test_partitioned_member_cannot_disrupt_on_rejoin``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

CONF_PREFIX = b"\x00CFG"

ADD = "add"
REMOVE = "remove"


@dataclass(frozen=True)
class ConfChange:
    op: str                # ADD or REMOVE
    node_id: int
    ip: str = ""
    port: int = 0
    slot: int = -1         # assigned by the proposing leader for ADD

    def encode(self) -> bytes:
        return CONF_PREFIX + json.dumps(
            {"op": self.op, "id": self.node_id, "ip": self.ip,
             "port": self.port, "slot": self.slot},
            separators=(",", ":"), sort_keys=True).encode()

    @classmethod
    def decode(cls, data: bytes) -> "ConfChange":
        """Strict decode: every failure mode is ValueError, so a malformed
        payload can never crash commit-time application with an uncaught
        KeyError/TypeError (it would be a poison block — committed, hence
        re-raised on every node at every restart)."""
        if not is_conf(data):
            raise ValueError("not a conf-change payload")
        try:
            d = json.loads(data[len(CONF_PREFIX):])
            op, node_id = d["op"], d["id"]
            ip = str(d.get("ip", ""))
            port = int(d.get("port", 0))
            slot = int(d.get("slot", -1))
        except (ValueError, KeyError, TypeError) as e:
            raise ValueError(f"malformed conf payload: {e!r}") from e
        if op not in (ADD, REMOVE):
            raise ValueError(f"unknown conf op {op!r}")
        if not isinstance(node_id, int) or isinstance(node_id, bool):
            raise ValueError(f"conf node id must be an int, got {node_id!r}")
        return cls(op=op, node_id=node_id, ip=ip, port=port, slot=slot)


def is_conf(data: bytes) -> bool:
    return data.startswith(CONF_PREFIX)


@dataclass
class Member:
    node_id: int
    slot: int
    active: bool
    ip: str = ""
    port: int = 0


class MemberTable:
    """id -> Member map with slot bookkeeping and KV persistence."""

    KEY = b"meta:members"

    def __init__(self, max_slots: int):
        self.max_slots = max_slots
        self.by_id: dict[int, Member] = {}

    # -------------------------------------------------------------- build

    @classmethod
    def bootstrap(cls, node_ids: list[int], max_slots: int) -> "MemberTable":
        t = cls(max_slots)
        for slot, nid in enumerate(sorted(node_ids)):
            t.by_id[nid] = Member(node_id=nid, slot=slot, active=True)
        return t

    @classmethod
    def load(cls, kv, max_slots: int) -> "MemberTable | None":
        raw = kv.get(cls.KEY)
        if raw is None:
            return None
        d = json.loads(raw)
        t = cls(max(max_slots, d["max_slots"]))
        for m in d["members"]:
            t.by_id[m["id"]] = Member(
                node_id=m["id"], slot=m["slot"], active=m["active"],
                ip=m.get("ip", ""), port=m.get("port", 0))
        return t

    def store(self, kv) -> None:
        kv.put(self.KEY, json.dumps({
            "max_slots": self.max_slots,
            "members": [
                {"id": m.node_id, "slot": m.slot, "active": m.active,
                 "ip": m.ip, "port": m.port}
                for m in sorted(self.by_id.values(), key=lambda m: m.slot)
            ],
        }, separators=(",", ":"), sort_keys=True).encode())

    # ------------------------------------------------------------- access

    def active_slots(self) -> set[int]:
        return {m.slot for m in self.by_id.values() if m.active}

    def slot_of(self, node_id: int) -> int | None:
        m = self.by_id.get(node_id)
        return m.slot if m else None

    def id_of(self, slot: int) -> int | None:
        for m in self.by_id.values():
            if m.slot == slot:
                return m.node_id
        return None

    def free_slot(self) -> int | None:
        used = {m.slot for m in self.by_id.values()}
        for s in range(self.max_slots):
            if s not in used:
                return s
        return None

    # -------------------------------------------------------------- apply

    def assign(self, change: ConfChange) -> ConfChange:
        """Leader-side slot assignment for an ADD (re-add keeps its slot)."""
        if change.op != ADD:
            return change
        existing = self.by_id.get(change.node_id)
        slot = existing.slot if existing else self.free_slot()
        if slot is None:
            raise ValueError(
                f"no free node slot (max_nodes={self.max_slots}); "
                "start the cluster with a larger raft.max_nodes")
        return ConfChange(op=ADD, node_id=change.node_id, ip=change.ip,
                          port=change.port, slot=slot)

    def apply(self, change: ConfChange) -> None:
        """Deterministic commit-time application (same on every node)."""
        if change.op == ADD:
            if change.slot < 0 or change.slot >= self.max_slots:
                raise ValueError(f"conf add with invalid slot {change.slot}")
            self.by_id[change.node_id] = Member(
                node_id=change.node_id, slot=change.slot, active=True,
                ip=change.ip, port=change.port)
        elif change.op == REMOVE:
            m = self.by_id.get(change.node_id)
            if m is not None:
                m.active = False
        else:
            raise ValueError(f"unknown conf op {change.op!r}")
