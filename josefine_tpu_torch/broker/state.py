"""Replicated broker metadata: state models + Store.

Parity: reference ``src/broker/state/`` — models (``topic.rs:8-16``,
``partition.rs:12-18``, ``broker.rs:5-9``, ``group.rs:1-4``) and the
sled-backed ``Store`` (``mod.rs:18-93``: topics map under "topics",
partitions under ``"{topic}:partition:{idx}"``, brokers under
``"broker:{id}"``, groups, bincode values :80-92).

Deltas (deliberate): every record is its own key (the reference serializes
the WHOLE topics map under one "topics" key, ``mod.rs:34-52`` — O(topics)
rewrite per create); values are canonical JSON (sorted keys) so every node's
store is byte-identical after applying the same committed sequence.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from josefine_tpu_torch.utils.kv import KV

_TOPIC = b"topic:"
_PARTITION = b"partition:"   # partition:{topic}:{idx:08d}
_BROKER = b"broker:"         # broker:{id:08d}
_GROUP = b"group:"
_OFFSET = b"offset:"         # offset:{group}:{topic}:{idx:08d}


def _dumps(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


@dataclass
class Topic:
    """Parity: reference ``topic.rs:8-16`` (id, name, partitions map
    idx -> replica broker ids, internal flag)."""

    name: str
    id: str = ""
    partitions: dict[int, list[int]] = field(default_factory=dict)
    internal: bool = False

    def encode(self) -> bytes:
        d = asdict(self)
        d["partitions"] = {str(k): v for k, v in self.partitions.items()}
        return _dumps(d)

    @classmethod
    def decode(cls, raw: bytes) -> "Topic":
        d = json.loads(raw)
        d["partitions"] = {int(k): v for k, v in d["partitions"].items()}
        return cls(**d)


@dataclass
class Partition:
    """Parity: reference ``partition.rs:12-18`` (id, idx, topic, isr,
    assigned replicas, leader).

    TPU-build addition: ``group`` is the consensus-group row this partition
    claims on the device state tensor (the (partitions x nodes) P axis).
    -1 = no group (legacy data-plane: leader-local log, no replication).
    Assigned deterministically at EnsurePartition commit time, so every node
    agrees on the mapping (reference partitions have no consensus at all —
    ``create_topics.rs:27-61`` only picks replica broker ids)."""

    topic: str
    idx: int
    id: str = ""
    isr: list[int] = field(default_factory=list)
    assigned_replicas: list[int] = field(default_factory=list)
    leader: int = 0
    group: int = -1

    def encode(self) -> bytes:
        return _dumps(asdict(self))

    @classmethod
    def decode(cls, raw: bytes) -> "Partition":
        return cls(**json.loads(raw))


@dataclass
class Broker:
    """Parity: reference ``broker.rs:5-9``."""

    id: int
    ip: str
    port: int

    def encode(self) -> bytes:
        return _dumps(asdict(self))

    @classmethod
    def decode(cls, raw: bytes) -> "Broker":
        return cls(**json.loads(raw))


@dataclass
class Group:
    """Parity: reference ``group.rs:1-4``."""

    id: str

    def encode(self) -> bytes:
        return _dumps(asdict(self))

    @classmethod
    def decode(cls, raw: bytes) -> "Group":
        return cls(**json.loads(raw))


@dataclass
class OffsetCommit:
    """A consumer group's committed position for one partition. No reference
    analog (its consumer-group APIs are stubs, ``list_groups.rs:5-14``);
    replicated through Raft so committed offsets survive coordinator loss."""

    group: str
    topic: str
    partition: int
    offset: int
    metadata: str | None = None

    def encode(self) -> bytes:
        return _dumps(asdict(self))

    @classmethod
    def decode(cls, raw: bytes) -> "OffsetCommit":
        return cls(**json.loads(raw))


@dataclass
class OffsetCommitBatch:
    """All offsets of one OffsetCommit request as a single replicated
    transition — one consensus round-trip regardless of partition count."""

    entries: list[OffsetCommit] = field(default_factory=list)

    def encode(self) -> bytes:
        return _dumps({"entries": [asdict(e) for e in self.entries]})

    @classmethod
    def decode(cls, raw: bytes) -> "OffsetCommitBatch":
        d = json.loads(raw)
        return cls(entries=[OffsetCommit(**e) for e in d["entries"]])


@dataclass
class PartitionBatch:
    """All partitions of one CreateTopics request as a SINGLE replicated
    transition: a 10k-partition topic is one consensus round-trip on the
    metadata group instead of 10k (the workload plane's bulk-create path).
    Applied exactly like a sequence of EnsurePartition transitions —
    deterministic group claims included — in entry order."""

    entries: list[Partition] = field(default_factory=list)

    def encode(self) -> bytes:
        return _dumps({"entries": [asdict(e) for e in self.entries]})

    @classmethod
    def decode(cls, raw: bytes) -> "PartitionBatch":
        d = json.loads(raw)
        return cls(entries=[Partition(**e) for e in d["entries"]])


@dataclass
class TopicTombstone:
    """Replicated topic deletion marker (DeleteTopics has no reference
    analog — advertised but unimplemented there)."""

    name: str

    def encode(self) -> bytes:
        return _dumps(asdict(self))

    @classmethod
    def decode(cls, raw: bytes) -> "TopicTombstone":
        return cls(**json.loads(raw))


@dataclass
class PidAlloc:
    """Idempotent-producer id allocation through Raft: the FSM fills in the
    id from a replicated counter at apply time, so ids are unique
    cluster-wide and survive leader failover."""

    id: int = -1

    def encode(self) -> bytes:
        return _dumps(asdict(self))

    @classmethod
    def decode(cls, raw: bytes) -> "PidAlloc":
        return cls(**json.loads(raw))


@dataclass
class Migration:
    """One live partition reassignment (Kafka-style), replicated through
    the metadata FSM. ``phase`` doubles as the transition verb: a proposer
    sends phase ``begin``/``ack``/``abort`` and the FSM applies it against
    the replicated migration record (``migr:{topic}:{idx}``), filling in
    the deterministic fields (src/dst rows, dst incarnation) at apply time
    exactly like EnsurePartition's group claim. ``acks`` is the handoff
    barrier: each replica host that installed the carried prefix into the
    target row appends itself; the last ack IS the cutover (partition
    re-pointed at ``dst_group``, source row released through the existing
    drain barrier)."""

    topic: str
    idx: int
    phase: str = "begin"
    src_group: int = -1
    dst_group: int = -1
    inc: int = -1            # dst row incarnation pinned at claim time
    broker_id: int = -1      # ack sender (phase == "ack")
    acks: list[int] = field(default_factory=list)

    def encode(self) -> bytes:
        return _dumps(asdict(self))

    @classmethod
    def decode(cls, raw: bytes) -> "Migration":
        return cls(**json.loads(raw))


@dataclass
class GroupReleased:
    """One replica host's ack that it reset its local state for a released
    consensus-group row (chain, device row, partition-FSM records). The row
    becomes reusable by claim_group once every replica host's ack commits —
    the distributed barrier that makes row recycling safe. ``inc`` pins the
    ack to the incarnation being drained: at-least-once retries can land
    after the row was reused and released AGAIN, and a stale duplicate must
    not satisfy the later drain cycle."""

    group: int
    broker_id: int
    inc: int = -1

    def encode(self) -> bytes:
        return _dumps(asdict(self))

    @classmethod
    def decode(cls, raw: bytes) -> "GroupReleased":
        return cls(**json.loads(raw))


class Store:
    """Metadata store over KV. All writes flow through the replicated FSM
    (``broker/fsm.py``) — handlers only read."""

    def __init__(self, kv: KV, prefix: bytes = b"store:"):
        self._kv = kv
        self._pfx = prefix

    # ----------------------------------------------------- snapshot dump

    def dump(self) -> bytes:
        """Canonical byte dump of the whole store (for Raft snapshots):
        sorted length-prefixed (key, value) pairs under our prefix."""
        pairs = sorted(self._kv.scan_prefix(self._pfx))
        out = bytearray()
        for k, v in pairs:
            k = k[len(self._pfx):]
            out += len(k).to_bytes(4, "big") + k
            out += len(v).to_bytes(4, "big") + v
        return bytes(out)

    def load(self, raw: bytes) -> None:
        """Replace the store's contents with a dump() image."""
        for k, _ in list(self._kv.scan_prefix(self._pfx)):
            self._kv.delete(k)
        i = 0
        while i < len(raw):
            klen = int.from_bytes(raw[i:i + 4], "big"); i += 4
            k = raw[i:i + klen]; i += klen
            vlen = int.from_bytes(raw[i:i + 4], "big"); i += 4
            v = raw[i:i + vlen]; i += vlen
            self._kv.put(self._pfx + k, v)

    # ------------------------------------------------------------- topics

    def create_topic(self, topic: Topic) -> Topic:
        self._kv.put(self._pfx + _TOPIC + topic.name.encode(), topic.encode())
        return topic

    def get_topic(self, name: str) -> Topic | None:
        raw = self._kv.get(self._pfx + _TOPIC + name.encode())
        return None if raw is None else Topic.decode(raw)

    def topic_exists(self, name: str) -> bool:
        return self._kv.get(self._pfx + _TOPIC + name.encode()) is not None

    def get_topics(self) -> list[Topic]:
        return [Topic.decode(v) for _, v in self._kv.scan_prefix(self._pfx + _TOPIC)]

    # --------------------------------------------------------- partitions

    def _partition_key(self, topic: str, idx: int) -> bytes:
        return self._pfx + _PARTITION + topic.encode() + b":%08d" % idx

    def create_partition(self, partition: Partition) -> Partition:
        self._kv.put(self._partition_key(partition.topic, partition.idx), partition.encode())
        return partition

    def get_partition(self, topic: str, idx: int) -> Partition | None:
        raw = self._kv.get(self._partition_key(topic, idx))
        return None if raw is None else Partition.decode(raw)

    def get_partitions(self, topic: str) -> list[Partition]:
        pfx = self._pfx + _PARTITION + topic.encode() + b":"
        return [Partition.decode(v) for _, v in self._kv.scan_prefix(pfx)]

    def get_all_partitions(self) -> list[Partition]:
        """Every partition of every topic (restart re-wiring of consensus
        groups scans this once)."""
        return [Partition.decode(v)
                for _, v in self._kv.scan_prefix(self._pfx + _PARTITION)]

    # ------------------------------------------------------------ brokers

    def ensure_broker(self, broker: Broker) -> Broker:
        self._kv.put(self._pfx + _BROKER + b"%08d" % broker.id, broker.encode())
        return broker

    def get_broker(self, broker_id: int) -> Broker | None:
        raw = self._kv.get(self._pfx + _BROKER + b"%08d" % broker_id)
        return None if raw is None else Broker.decode(raw)

    def get_brokers(self) -> list[Broker]:
        return [Broker.decode(v) for _, v in self._kv.scan_prefix(self._pfx + _BROKER)]

    def delete_topic(self, name: str) -> None:
        """Remove a topic, its partitions, and all groups' offsets for it."""
        self._kv.delete(self._pfx + _TOPIC + name.encode())
        pfx = self._pfx + _PARTITION + name.encode() + b":"
        for k, _ in list(self._kv.scan_prefix(pfx)):
            self._kv.delete(k)
        for k, _ in list(self._kv.scan_prefix(self._pfx + _OFFSET)):
            # key body = {group}:{topic}:{idx:08d}; topic names cannot contain
            # ':' (Kafka restricts them to [a-zA-Z0-9._-]) so parse from the
            # right — group ids are unrestricted.
            body = k[len(self._pfx + _OFFSET):-9]
            if body.rsplit(b":", 1)[-1] == name.encode():
                self._kv.delete(k)

    # ------------------------------------------- consensus-group allocation

    def claim_group(self, pool: int) -> int:
        """Allocate a consensus-group row in [1, pool): the lowest RECYCLED
        row if any (see release_group/ack_group_release — a freed row is
        reusable once every replica host has reset its local row state and
        had that ack committed), else the next fresh row; -1 when the pool
        is exhausted. Deterministic (pure function of store state), so
        every node applying the same committed EnsurePartition assigns the
        same row. Each claim bumps the row's INCARNATION counter; nodes
        compare it against their locally persisted value to detect a row
        they must reset before serving (a reused row must never inherit a
        dead topic's chain/log state)."""
        free = sorted(self._galloc_free_rows())
        if free:
            g = free[0]
            self._kv.delete(self._pfx + b"galloc:free:%d" % g)
        else:
            raw = self._kv.get(self._pfx + b"galloc:next")
            g = int(raw) if raw else 1
            if g >= pool:
                return -1
            self._kv.put(self._pfx + b"galloc:next", b"%d" % (g + 1))
        inc = self.group_incarnation(g) + 1
        self._kv.put(self._pfx + b"galloc:inc:%d" % g, b"%d" % inc)
        return g

    def _galloc_free_rows(self) -> list[int]:
        pfx = self._pfx + b"galloc:free:"
        return [int(k[len(pfx):]) for k, _ in self._kv.scan_prefix(pfx)]

    def group_incarnation(self, g: int) -> int:
        raw = self._kv.get(self._pfx + b"galloc:inc:%d" % g)
        return int(raw) if raw else 0

    def release_group(self, g: int, replica_ids) -> None:
        """Begin draining a released row (its topic was deleted): the row
        becomes claimable again only after every listed replica host acks
        that it reset its local row state (ack_group_release). A row with
        no holders frees immediately."""
        pending = sorted({int(b) for b in replica_ids})
        if not pending:
            self._kv.put(self._pfx + b"galloc:free:%d" % g, b"1")
            return
        self._kv.put(self._pfx + b"galloc:drain:%d" % g,
                     b",".join(b"%d" % b for b in pending))

    def ack_group_release(self, g: int, broker_id: int,
                          inc: int = -1) -> bool:
        """Record one replica host's reset ack; returns True when the row
        just became free. Idempotent: unknown rows / repeated acks no-op,
        and an ack pinned to a different incarnation (a straggler duplicate
        from a previous drain cycle of the same row) is ignored."""
        if inc != -1 and inc != self.group_incarnation(g):
            return False
        key = self._pfx + b"galloc:drain:%d" % g
        raw = self._kv.get(key)
        if raw is None:
            return False
        pending = {int(b) for b in raw.split(b",") if b}
        pending.discard(int(broker_id))
        if pending:
            self._kv.put(key, b",".join(b"%d" % b for b in sorted(pending)))
            return False
        self._kv.delete(key)
        self._kv.put(self._pfx + b"galloc:free:%d" % g, b"1")
        return True

    # ------------------------------------------------------- migrations

    def _migration_key(self, topic: str, idx: int) -> bytes:
        return self._pfx + b"migr:" + topic.encode() + b":%08d" % idx

    def put_migration(self, m) -> None:
        self._kv.put(self._migration_key(m.topic, m.idx), m.encode())

    def get_migration(self, topic: str, idx: int) -> "Migration | None":
        raw = self._kv.get(self._migration_key(topic, idx))
        return None if raw is None else Migration.decode(raw)

    def get_migrations(self) -> "list[Migration]":
        """Every in-flight migration record (restart re-arm scan)."""
        return [Migration.decode(v)
                for _, v in self._kv.scan_prefix(self._pfx + b"migr:")]

    def clear_migration(self, topic: str, idx: int) -> None:
        self._kv.delete(self._migration_key(topic, idx))

    def alloc_pid(self) -> int:
        """Next producer id from the replicated counter (deterministic)."""
        raw = self._kv.get(self._pfx + b"pid:next")
        pid = int(raw) if raw else 0
        self._kv.put(self._pfx + b"pid:next", b"%d" % (pid + 1))
        return pid

    def prune_drains(self, active_ids) -> list[int]:
        """Drop brokers that no longer exist in the cluster from every
        draining row's pending set (a removed broker can never ack, and a
        drain pinned to it would wedge the row out of the pool forever —
        ADVICE r2). Rows whose pending set empties become claimable.
        Deterministic from replicated state: called at conf-REMOVE apply
        on every node, and once at startup against the member table.
        Returns the rows freed."""
        active = {int(b) for b in active_ids}
        pfx = self._pfx + b"galloc:drain:"
        freed = []
        for k, raw in list(self._kv.scan_prefix(pfx)):
            pending = {int(b) for b in raw.split(b",") if b}
            kept = pending & active
            if kept == pending:
                continue
            g = int(k[len(pfx):])
            if kept:
                self._kv.put(k, b",".join(b"%d" % b for b in sorted(kept)))
            else:
                self._kv.delete(k)
                self._kv.put(self._pfx + b"galloc:free:%d" % g, b"1")
                freed.append(g)
        return freed

    def groups_pending_release(self, broker_id: int) -> list[int]:
        """Rows still draining on this broker's account (restart scan: a
        node that was down through a DeleteTopic must reset those rows and
        ack before they can ever be reused)."""
        pfx = self._pfx + b"galloc:drain:"
        out = []
        for k, raw in self._kv.scan_prefix(pfx):
            if int(broker_id) in {int(b) for b in raw.split(b",") if b}:
                out.append(int(k[len(pfx):]))
        return out

    # ------------------------------------------------------------- groups

    def create_group(self, group: Group) -> Group:
        self._kv.put(self._pfx + _GROUP + group.id.encode(), group.encode())
        return group

    def get_groups(self) -> list[Group]:
        return [Group.decode(v) for _, v in self._kv.scan_prefix(self._pfx + _GROUP)]

    # ------------------------------------------------------------- offsets

    def _offset_key(self, group: str, topic: str, partition: int) -> bytes:
        return (self._pfx + _OFFSET + group.encode() + b":" + topic.encode()
                + b":%08d" % partition)

    def commit_offset(self, oc: OffsetCommit) -> OffsetCommit:
        self._kv.put(self._offset_key(oc.group, oc.topic, oc.partition), oc.encode())
        return oc

    def get_offset(self, group: str, topic: str, partition: int) -> OffsetCommit | None:
        raw = self._kv.get(self._offset_key(group, topic, partition))
        return None if raw is None else OffsetCommit.decode(raw)

    def get_offsets(self, group: str) -> list[OffsetCommit]:
        # Group ids are unrestricted, so one id may be a ':'-extended prefix
        # of another and over-match the scan; filter on the decoded group.
        pfx = self._pfx + _OFFSET + group.encode() + b":"
        out = [OffsetCommit.decode(v) for _, v in self._kv.scan_prefix(pfx)]
        return [oc for oc in out if oc.group == group]
