"""Consumer-group coordinator: the JoinGroup/SyncGroup/Heartbeat/LeaveGroup
rebalance state machine.

No reference implementation exists — the reference advertises the group APIs
in ApiVersions but stubs them all (``src/broker/handler/list_groups.rs:5-14``,
SURVEY.md §2 API table "Fetch, groups, offsets … advertised in ApiVersions
only"). This module supplies the real protocol:

* group states Empty → PreparingRebalance → CompletingRebalance → Stable,
  exactly the broker-side generic group protocol real Kafka coordinators run;
* member sessions with heartbeat-driven expiry;
* leader election (first joiner) and client-side assignment: the leader gets
  the full member<->subscription map from JoinGroup and pushes per-member
  assignments in SyncGroup.

Durability split: membership/generation state is coordinator-local and
in-memory (as in real Kafka — it is rebuilt by a rebalance when the
coordinator moves), while committed offsets are replicated through Raft to
the metadata store (``state.OffsetCommit``) so they survive coordinator loss;
real Kafka gets the same effect by writing them to __consumer_offsets.
FindCoordinator pins every group to the answering broker (reference
``find_coordinator.rs:7-21`` always returns self), so a single coordinator
instance per broker suffices.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable

from josefine_tpu_torch.kafka.codec import ErrorCode
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("broker.groups")

EMPTY = "Empty"
PREPARING_REBALANCE = "PreparingRebalance"
COMPLETING_REBALANCE = "CompletingRebalance"
STABLE = "Stable"
DEAD = "Dead"

# Grace period after the first join of a round before completing the
# rebalance, so a herd of consumers starting together lands in one
# generation (Kafka's group.initial.rebalance.delay.ms, scaled down).
INITIAL_REBALANCE_DELAY_S = 0.05
MIN_SESSION_TIMEOUT_MS = 10
MAX_SESSION_TIMEOUT_MS = 300_000
SESSION_SWEEP_INTERVAL_S = 0.25


@dataclass
class Member:
    member_id: str
    client_id: str
    client_host: str
    session_timeout_ms: int
    rebalance_timeout_ms: int
    protocols: list[tuple[str, bytes]]
    assignment: bytes = b""
    # Session deadline on the coordinator's clock (set by touch(); the
    # clock itself lives on the coordinator so it can be virtualized).
    deadline: float = 0.0
    # Set while a JoinGroup response is parked waiting for the rebalance.
    join_future: asyncio.Future | None = None
    # Set while a SyncGroup response waits for the leader's assignments.
    sync_future: asyncio.Future | None = None

    def touch(self, now: float) -> None:
        self.deadline = now + self.session_timeout_ms / 1000


@dataclass
class GroupMeta:
    group_id: str
    protocol_type: str = ""
    protocol_name: str = ""
    state: str = EMPTY
    generation: int = 0
    leader_id: str = ""
    members: dict[str, Member] = field(default_factory=dict)
    # Pending timer that completes the in-flight rebalance.
    rebalance_task: asyncio.Task | None = None
    # True while the in-flight rebalance started from an Empty group: it
    # completes on the initial-delay timer (a herd of first joiners lands in
    # one generation), never eagerly.
    initial_join: bool = False

    def rebalance_timeout_s(self) -> float:
        if not self.members:
            return INITIAL_REBALANCE_DELAY_S
        return max(m.rebalance_timeout_ms for m in self.members.values()) / 1000


class GroupCoordinator:
    """One coordinator per broker (FindCoordinator always answers self)."""

    def __init__(self, on_group_created=None,
                 clock: Callable[[], float] | None = None):
        self._groups: dict[str, GroupMeta] = {}
        # Fire-and-forget hook: replicate group existence (EnsureGroup) so
        # ListGroups is cluster-wide; never awaited on the join path.
        self._on_group_created = on_group_created
        # Injectable session clock (seconds, monotonic): the chaos harness
        # drives it with virtual ticks so a frozen clock never expires a
        # session and a skewed one expires them deterministically.  The
        # default is the only wall-clock read on the coordinator, and it
        # stays out of every replicated/journaled value.
        self._clock = clock if clock is not None else time.monotonic
        self._sweeper: asyncio.Task | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._sweeper is None:
            self._sweeper = asyncio.get_running_loop().create_task(self._sweep_loop())

    async def close(self) -> None:
        if self._sweeper is not None:
            self._sweeper.cancel()
            await asyncio.gather(self._sweeper, return_exceptions=True)
            self._sweeper = None
        for g in self._groups.values():
            if g.rebalance_task is not None:
                g.rebalance_task.cancel()
            for m in g.members.values():
                _resolve(m.join_future, {"error_code": ErrorCode.UNKNOWN_MEMBER_ID})
                _resolve(m.sync_future, {"error_code": ErrorCode.UNKNOWN_MEMBER_ID})

    # ------------------------------------------------------------ JoinGroup

    async def join_group(self, group_id: str, member_id: str, protocol_type: str,
                         protocols: list[tuple[str, bytes]], session_timeout_ms: int,
                         rebalance_timeout_ms: int, client_id: str = "",
                         client_host: str = "") -> dict:
        # Validate everything BEFORE creating/replicating the group — a
        # rejected join must leave no phantom group behind.
        if not group_id:
            return _join_err(ErrorCode.INVALID_GROUP_ID)
        if not (MIN_SESSION_TIMEOUT_MS <= session_timeout_ms <= MAX_SESSION_TIMEOUT_MS):
            return _join_err(ErrorCode.INVALID_SESSION_TIMEOUT)
        if not protocols:
            return _join_err(ErrorCode.INCONSISTENT_GROUP_PROTOCOL)
        group = self._groups.get(group_id)
        if group is not None and group.protocol_type and \
                protocol_type != group.protocol_type:
            return _join_err(ErrorCode.INCONSISTENT_GROUP_PROTOCOL)
        if member_id and (group is None or member_id not in group.members):
            return _join_err(ErrorCode.UNKNOWN_MEMBER_ID)
        if group is None:
            group = self._groups[group_id] = GroupMeta(group_id=group_id,
                                                       protocol_type=protocol_type)
            if self._on_group_created is not None:
                self._on_group_created(group_id)

        if not member_id:
            # graftlint: allow(det-uuid) — member identity; must stay unique across coordinator restarts, which a seeded RNG cannot guarantee
            member_id = f"{client_id or 'member'}-{uuid.uuid4()}"
            member = Member(member_id=member_id, client_id=client_id,
                            client_host=client_host,
                            session_timeout_ms=session_timeout_ms,
                            rebalance_timeout_ms=rebalance_timeout_ms or session_timeout_ms,
                            protocols=protocols)
            group.members[member_id] = member
        else:
            member = group.members[member_id]
            member.protocols = protocols
            member.session_timeout_ms = session_timeout_ms
            member.rebalance_timeout_ms = rebalance_timeout_ms or session_timeout_ms
        member.touch(self._clock())

        # A (re)join always forces the group through a rebalance round.
        self._prepare_rebalance(group)

        fut = asyncio.get_running_loop().create_future()
        _resolve(member.join_future, _join_err(ErrorCode.UNKNOWN_MEMBER_ID))
        member.join_future = fut
        self._maybe_complete_join(group)
        return await fut

    def _prepare_rebalance(self, group: GroupMeta) -> None:
        if group.state == PREPARING_REBALANCE:
            return
        group.initial_join = group.state == EMPTY
        group.state = PREPARING_REBALANCE
        # Members mid-SyncGroup must re-join: fail their sync waits.
        for m in group.members.values():
            _resolve(m.sync_future, {"error_code": ErrorCode.REBALANCE_IN_PROGRESS,
                                     "assignment": b""})
        if group.rebalance_task is not None:
            group.rebalance_task.cancel()
        timeout = (INITIAL_REBALANCE_DELAY_S if group.initial_join
                   else group.rebalance_timeout_s())
        group.rebalance_task = asyncio.get_running_loop().create_task(
            self._rebalance_deadline(group, timeout))

    async def _rebalance_deadline(self, group: GroupMeta, timeout: float) -> None:
        try:
            await asyncio.sleep(timeout)
        except asyncio.CancelledError:
            return
        group.rebalance_task = None
        # Members that did not (re)join in time are evicted (Kafka semantics).
        stale = [mid for mid, m in group.members.items() if m.join_future is None]
        for mid in stale:
            log.info("group %s: evicting member %s (missed rebalance)",
                     group.group_id, mid)
            del group.members[mid]
        self._complete_join(group)

    def _maybe_complete_join(self, group: GroupMeta) -> None:
        if group.state != PREPARING_REBALANCE or not group.members:
            return
        if group.initial_join:
            return  # the initial-delay timer completes this round
        if all(m.join_future is not None for m in group.members.values()):
            if group.rebalance_task is not None:
                group.rebalance_task.cancel()
                group.rebalance_task = None
            self._complete_join(group)

    def _complete_join(self, group: GroupMeta) -> None:
        joined = {mid: m for mid, m in group.members.items()
                  if m.join_future is not None}
        if not joined:
            group.state = EMPTY
            group.generation += 1
            return
        group.generation += 1
        group.state = COMPLETING_REBALANCE
        group.protocol_name = _select_protocol(joined.values())
        if group.leader_id not in joined:
            group.leader_id = next(iter(joined))
        members_payload = [
            {"member_id": mid,
             "metadata": _proto_metadata(m, group.protocol_name)}
            for mid, m in joined.items()
        ]
        for mid, m in joined.items():
            fut, m.join_future = m.join_future, None
            _resolve(fut, {
                "error_code": ErrorCode.NONE,
                "generation_id": group.generation,
                "protocol_name": group.protocol_name,
                "leader": group.leader_id,
                "member_id": mid,
                # Only the leader needs the full subscription map.
                "members": members_payload if mid == group.leader_id else [],
            })

    # ------------------------------------------------------------ SyncGroup

    async def sync_group(self, group_id: str, generation_id: int, member_id: str,
                         assignments: list[dict]) -> dict:
        group = self._groups.get(group_id)
        err = self._check_member(group, generation_id, member_id)
        if err is not None:
            return {"error_code": err, "assignment": b""}
        member = group.members[member_id]
        member.touch(self._clock())
        if group.state == STABLE:  # idempotent re-sync
            return {"error_code": ErrorCode.NONE, "assignment": member.assignment}
        if group.state != COMPLETING_REBALANCE:
            return {"error_code": ErrorCode.REBALANCE_IN_PROGRESS, "assignment": b""}

        if member_id == group.leader_id:
            known = set(group.members)
            for a in assignments or []:
                if a["member_id"] in known:
                    group.members[a["member_id"]].assignment = a.get("assignment") or b""
            group.state = STABLE
            for m in group.members.values():
                _resolve(m.sync_future, {"error_code": ErrorCode.NONE,
                                         "assignment": m.assignment})
                m.sync_future = None
            return {"error_code": ErrorCode.NONE, "assignment": member.assignment}

        fut = asyncio.get_running_loop().create_future()
        _resolve(member.sync_future, {"error_code": ErrorCode.REBALANCE_IN_PROGRESS,
                                      "assignment": b""})
        member.sync_future = fut
        return await fut

    # ------------------------------------------------------------ Heartbeat

    def heartbeat(self, group_id: str, generation_id: int, member_id: str) -> int:
        group = self._groups.get(group_id)
        err = self._check_member(group, generation_id, member_id)
        if err is not None:
            return err
        group.members[member_id].touch(self._clock())
        if group.state in (PREPARING_REBALANCE, COMPLETING_REBALANCE):
            return int(ErrorCode.REBALANCE_IN_PROGRESS)
        return int(ErrorCode.NONE)

    # ----------------------------------------------------------- LeaveGroup

    def leave_group(self, group_id: str, member_id: str) -> int:
        group = self._groups.get(group_id)
        if group is None or member_id not in group.members:
            return int(ErrorCode.UNKNOWN_MEMBER_ID)
        self._evict(group, member_id)
        return int(ErrorCode.NONE)

    # ------------------------------------------------------------- queries

    def describe(self, group_id: str) -> dict:
        group = self._groups.get(group_id)
        if group is None:
            return {"error_code": ErrorCode.NONE, "group_id": group_id,
                    "group_state": DEAD, "protocol_type": "", "protocol_data": "",
                    "members": []}
        return {
            "error_code": ErrorCode.NONE,
            "group_id": group_id,
            "group_state": group.state,
            "protocol_type": group.protocol_type,
            "protocol_data": group.protocol_name,
            "members": [
                {"member_id": m.member_id, "client_id": m.client_id,
                 "client_host": m.client_host,
                 "member_metadata": _proto_metadata(m, group.protocol_name),
                 "member_assignment": m.assignment}
                for m in group.members.values()
            ],
        }

    def validate_commit(self, group_id: str, generation_id: int, member_id: str) -> int:
        """Gate an OffsetCommit. Simple consumers (generation -1 and no
        member id) may commit only while no live group owns the id — a
        generation-less commit against an active group would clobber the
        members' offsets (Kafka rejects it the same way)."""
        group = self._groups.get(group_id)
        if generation_id < 0 and not member_id:
            if group is None or not group.members:
                return int(ErrorCode.NONE)
            return int(ErrorCode.UNKNOWN_MEMBER_ID)
        err = self._check_member(group, generation_id, member_id)
        return int(ErrorCode.NONE) if err is None else err

    # ------------------------------------------------------------ internals

    def _check_member(self, group: GroupMeta | None, generation_id: int,
                      member_id: str) -> int | None:
        if group is None or member_id not in group.members:
            return int(ErrorCode.UNKNOWN_MEMBER_ID)
        if generation_id != group.generation:
            return int(ErrorCode.ILLEGAL_GENERATION)
        return None

    def _evict(self, group: GroupMeta, member_id: str) -> None:
        member = group.members.pop(member_id, None)
        if member is not None:
            _resolve(member.join_future, _join_err(ErrorCode.UNKNOWN_MEMBER_ID))
            _resolve(member.sync_future, {"error_code": ErrorCode.UNKNOWN_MEMBER_ID,
                                          "assignment": b""})
        if group.leader_id == member_id:
            group.leader_id = ""
        if group.members:
            self._prepare_rebalance(group)
            self._maybe_complete_join(group)
        else:
            group.state = EMPTY
            group.generation += 1

    def _sweep_once(self) -> None:
        """One expiry pass over every group at the coordinator clock's
        current reading (split from the loop so tests and virtual-clock
        drivers can sweep without real time passing)."""
        now = self._clock()
        for group in list(self._groups.values()):
            expired = [mid for mid, m in group.members.items()
                       if m.deadline < now and m.join_future is None]
            for mid in expired:
                log.info("group %s: member %s session expired",
                         group.group_id, mid)
                self._evict(group, mid)

    async def _sweep_loop(self) -> None:
        while True:
            await asyncio.sleep(SESSION_SWEEP_INTERVAL_S)
            self._sweep_once()


def _select_protocol(members) -> str:
    """Pick the protocol every member supports, preferring earlier choices
    (Kafka's vote: each member ranks by list order)."""
    members = list(members)
    common = set.intersection(*(
        {name for name, _ in m.protocols} for m in members)) if members else set()
    if not common:
        # join_group validated non-empty protocol lists; a disjoint set gets
        # the first member's first pick (its sync will fail client-side).
        return members[0].protocols[0][0] if members else ""
    for name, _ in members[0].protocols:
        if name in common:
            return name
    # Unreachable when common is non-empty (common ⊆ members[0]'s names),
    # but keep the fallback total — and deterministic: min(), never an
    # arbitrary set draw (every member must compute the same pick).
    return min(common)


def _proto_metadata(member: Member, protocol_name: str) -> bytes:
    for name, meta in member.protocols:
        if name == protocol_name:
            return meta
    return b""


def _join_err(code: int) -> dict:
    return {"error_code": int(code), "generation_id": -1, "protocol_name": "",
            "leader": "", "member_id": "", "members": []}


def _resolve(fut: asyncio.Future | None, value) -> None:
    if fut is not None and not fut.done():
        fut.set_result(value)
