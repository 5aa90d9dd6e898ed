"""Broker FSM: the replicated state machine over the metadata Store.

Parity: reference ``src/broker/fsm.rs`` — ``Transition::{EnsureTopic,
EnsurePartition, EnsureBroker}`` (:40-70) serialized into Raft block data
(the reference uses bincode :62-70; here a 1-byte kind tag + canonical JSON
so all nodes apply byte-identical values). ``transition`` returns the
serialized applied entity, which the FSM driver routes back to the awaiting
client (``src/raft/fsm.rs:64-81``).
"""

from __future__ import annotations

from josefine_tpu_torch.broker.state import (
    Broker,
    Group,
    Migration,
    OffsetCommit,
    OffsetCommitBatch,
    Partition,
    PartitionBatch,
    Store,
    GroupReleased,
    PidAlloc,
    Topic,
    TopicTombstone,
)

_ENSURE_TOPIC = 1
_ENSURE_PARTITION = 2
_ENSURE_BROKER = 3
_ENSURE_GROUP = 4
_COMMIT_OFFSET = 5
_DELETE_TOPIC = 6
_COMMIT_OFFSETS = 7
_GROUP_RELEASED = 8
_ALLOC_PID = 9
_ENSURE_PARTITIONS = 10
_MIGRATION = 11

_KINDS = {
    _ENSURE_TOPIC: Topic,
    _ENSURE_PARTITION: Partition,
    _ENSURE_BROKER: Broker,
    _ENSURE_GROUP: Group,
    _COMMIT_OFFSET: OffsetCommit,
    _DELETE_TOPIC: TopicTombstone,
    _COMMIT_OFFSETS: OffsetCommitBatch,
    _GROUP_RELEASED: GroupReleased,
    _ALLOC_PID: PidAlloc,
    _ENSURE_PARTITIONS: PartitionBatch,
    _MIGRATION: Migration,
}
_TAGS = {v: k for k, v in _KINDS.items()}


class Transition:
    """Serialize/deserialize replicated metadata mutations."""

    @staticmethod
    def ensure_topic(topic: Topic) -> bytes:
        return bytes([_ENSURE_TOPIC]) + topic.encode()

    @staticmethod
    def ensure_partition(partition: Partition) -> bytes:
        return bytes([_ENSURE_PARTITION]) + partition.encode()

    @staticmethod
    def ensure_partitions(partitions: list[Partition]) -> bytes:
        """Bulk form: every partition of one topic in ONE replicated
        transition (one consensus round-trip however many partitions)."""
        return (bytes([_ENSURE_PARTITIONS])
                + PartitionBatch(entries=list(partitions)).encode())

    @staticmethod
    def ensure_broker(broker: Broker) -> bytes:
        return bytes([_ENSURE_BROKER]) + broker.encode()

    @staticmethod
    def ensure_group(group: Group) -> bytes:
        return bytes([_ENSURE_GROUP]) + group.encode()

    @staticmethod
    def commit_offset(oc: OffsetCommit) -> bytes:
        return bytes([_COMMIT_OFFSET]) + oc.encode()

    @staticmethod
    def commit_offsets(batch: OffsetCommitBatch) -> bytes:
        return bytes([_COMMIT_OFFSETS]) + batch.encode()

    @staticmethod
    def delete_topic(name: str) -> bytes:
        return bytes([_DELETE_TOPIC]) + TopicTombstone(name=name).encode()

    @staticmethod
    def alloc_pid() -> bytes:
        return bytes([_ALLOC_PID]) + PidAlloc().encode()

    @staticmethod
    def group_released(group: int, broker_id: int, inc: int = -1) -> bytes:
        return (bytes([_GROUP_RELEASED])
                + GroupReleased(group=group, broker_id=broker_id,
                                inc=inc).encode())

    @staticmethod
    def migrate_partition(topic: str, idx: int) -> bytes:
        """Begin a live reassignment of one partition's consensus row (the
        Kafka AlterPartitionReassignments analog): the FSM claims the
        target row deterministically at apply time."""
        return (bytes([_MIGRATION])
                + Migration(topic=topic, idx=idx, phase="begin").encode())

    @staticmethod
    def migration_ack(topic: str, idx: int, dst_group: int,
                      broker_id: int) -> bytes:
        """One replica host's ack that it installed the carried prefix
        into the target row; the last ack cuts the partition over."""
        return (bytes([_MIGRATION])
                + Migration(topic=topic, idx=idx, phase="ack",
                            dst_group=dst_group,
                            broker_id=broker_id).encode())

    @staticmethod
    def migration_abort(topic: str, idx: int) -> bytes:
        """Abort an in-flight reassignment: the source row stays the
        single owner; the claimed target row drains back to the pool."""
        return (bytes([_MIGRATION])
                + Migration(topic=topic, idx=idx, phase="abort").encode())

    @staticmethod
    def decode(data: bytes):
        if not data:
            raise ValueError("empty transition")
        kind = data[0]
        cls = _KINDS.get(kind)
        if cls is None:
            raise ValueError(f"unknown transition kind {kind}")
        return cls.decode(data[1:])


class JosefineFsm:
    """Applies committed transitions to the Store (deterministic: same
    committed sequence -> same store bytes on every node)."""

    def __init__(self, store: Store, on_delete_topic=None, group_pool: int = 0):
        self.store = store
        # Node-local side-effect hooks: every node applies the same committed
        # transition; each runs its own local effects through these callbacks
        # (drop on-disk replica logs on DeleteTopic; wire a partition's
        # consensus group on EnsurePartition). The replicated store itself
        # stays deterministic.
        self.on_delete_topic = on_delete_topic
        self.on_partition_assigned = None
        self.on_partition_released = None
        # Live-migration hooks (same contract as the partition hooks:
        # fired at commit time on every node, node-local effects only —
        # freeze the source row at begin, install the carried prefix and
        # ack, purge the source at cutover, unwind at abort).
        self.on_migration_begin = None
        self.on_migration_cutover = None
        self.on_migration_abort = None
        # Consensus-group rows available on the device tensor (engine P);
        # pool <= 1 means only the metadata group exists and partitions run
        # in legacy (group-less) mode.
        self.group_pool = group_pool

    def _apply_partition(self, entity: Partition) -> Partition:
        """One EnsurePartition: idempotent re-ensure keeps the original
        group claim; a fresh partition gets a deterministic commit-time
        group allocation from the replicated counter (-1 on pool
        exhaustion = legacy mode, leader-local log). Shared by the single
        and bulk transition kinds so their folds can never diverge."""
        existing = self.store.get_partition(entity.topic, entity.idx)
        if existing is not None:
            entity.group = existing.group
        elif entity.group < 0 and self.group_pool > 1:
            entity.group = self.store.claim_group(self.group_pool)
        applied = self.store.create_partition(entity)
        if self.on_partition_assigned is not None:
            self.on_partition_assigned(applied)
        return applied

    def _apply_migration(self, m: Migration) -> Migration:
        """One replicated migration verb (begin / ack / abort) against the
        partition's migration record. Every branch is a pure function of
        store state, so all nodes applying the same committed sequence
        agree on the claimed target row, the ack set, and the cutover
        point; invalid or stale verbs degrade to an inert ``phase`` the
        proposer can read back (never an exception — a committed poison
        transition must not crash the apply loop)."""
        p = self.store.get_partition(m.topic, m.idx)
        cur = self.store.get_migration(m.topic, m.idx)
        if m.phase == "begin":
            if p is None or p.group < 1 or cur is not None:
                m.phase = "rejected"
                return m
            dst = self.store.claim_group(self.group_pool)
            if dst < 0 or dst == p.group:
                # Pool exhausted (or degenerately re-claimed the same row
                # — impossible while the source is live, but cheap to
                # refuse): nothing to migrate into.
                m.phase = "rejected"
                return m
            m.src_group = p.group
            m.dst_group = dst
            m.inc = self.store.group_incarnation(dst)
            m.phase = "handoff"
            m.acks = []
            self.store.put_migration(m)
            if self.on_migration_begin is not None:
                self.on_migration_begin(m, p)
            return m
        if cur is None or p is None:
            m.phase = "stale"
            return m
        if m.phase == "ack":
            if m.dst_group != cur.dst_group:
                m.phase = "stale"  # ack for a superseded attempt
                return m
            if m.broker_id not in cur.acks:
                cur.acks.append(int(m.broker_id))
                cur.acks.sort()
            hosts = sorted({int(b) for b in p.assigned_replicas})
            if set(cur.acks) >= set(hosts):
                # Cutover: the partition re-points at the target row; the
                # source row drains through the existing release barrier
                # (each host resets its local source-row state and acks
                # GroupReleased before the row re-enters the pool).
                p.group = cur.dst_group
                self.store.create_partition(p)
                self.store.release_group(cur.src_group, hosts)
                self.store.clear_migration(m.topic, m.idx)
                cur.phase = "cutover"
                if self.on_migration_cutover is not None:
                    self.on_migration_cutover(cur, p)
            else:
                cur.phase = "acked"
                self.store.put_migration(cur)
            return cur
        if m.phase == "abort":
            hosts = sorted({int(b) for b in p.assigned_replicas})
            # The target row was claimed at begin; hosts that already
            # adopted must reset it, so it drains like a released row.
            self.store.release_group(cur.dst_group, hosts)
            self.store.clear_migration(m.topic, m.idx)
            cur.phase = "aborted"
            if self.on_migration_abort is not None:
                self.on_migration_abort(cur, p)
            return cur
        m.phase = "stale"
        return m

    def transition(self, data: bytes) -> bytes:
        entity = Transition.decode(data)
        if isinstance(entity, Topic):
            applied = self.store.create_topic(entity)
        elif isinstance(entity, Partition):
            applied = self._apply_partition(entity)
        elif isinstance(entity, PartitionBatch):
            entity.entries = [self._apply_partition(p)
                              for p in entity.entries]
            applied = entity
        elif isinstance(entity, Broker):
            applied = self.store.ensure_broker(entity)
        elif isinstance(entity, Group):
            applied = self.store.create_group(entity)
        elif isinstance(entity, OffsetCommit):
            applied = self.store.commit_offset(entity)
        elif isinstance(entity, OffsetCommitBatch):
            for oc in entity.entries:
                self.store.commit_offset(oc)
            applied = entity
        elif isinstance(entity, PidAlloc):
            entity.id = self.store.alloc_pid()
            applied = entity
        elif isinstance(entity, Migration):
            applied = self._apply_migration(entity)
        elif isinstance(entity, GroupReleased):
            # One replica host reset its local row state; when the last ack
            # lands the row re-enters the claimable pool (claim_group).
            self.store.ack_group_release(entity.group, entity.broker_id,
                                         entity.inc)
            applied = entity
        elif isinstance(entity, TopicTombstone):
            released = self.store.get_partitions(entity.name)
            self.store.delete_topic(entity.name)
            for p in released:
                if p.group >= 1:
                    # Begin draining the row: reusable only after every
                    # replica host acks its local reset (GroupReleased).
                    self.store.release_group(p.group, p.assigned_replicas)
            if self.on_partition_released is not None:
                for p in released:
                    if p.group >= 1:
                        self.on_partition_released(p)
            if self.on_delete_topic is not None:
                self.on_delete_topic(entity.name)
            applied = entity
        else:  # unreachable: decode() gates kinds
            raise ValueError(f"unhandled entity {entity!r}")
        return bytes([_TAGS[type(entity)]]) + applied.encode()

    # Raft snapshot support (engine log compaction + follower snapshot
    # install — see josefine_tpu.raft.fsm.Fsm docs). The store dump is
    # deterministic (sorted pairs), so every node snapshots byte-identically
    # at the same commit point.

    def snapshot(self) -> bytes:
        return self.store.dump()

    def restore(self, data: bytes) -> None:
        """Replace store contents with a snapshot image (b"" = reset).

        Topics that existed locally but are absent from the snapshot were
        deleted while we were behind — fire the same node-local side-effect
        hooks a live DeleteTopic commit would, so replica logs for them are
        deregistered/purged and their consensus-group rows idled rather than
        silently served forever. Partitions present in the snapshot re-fire
        the assignment hook (idempotent) so their group wiring exists after
        a snapshot-install catch-up.
        """
        before_topics = {t.name for t in self.store.get_topics()}
        before_parts = {(p.topic, p.idx): p
                        for p in self.store.get_all_partitions() if p.group >= 1}
        before_migs = {(m.topic, m.idx): m for m in self.store.get_migrations()}
        self.store.load(data)
        after_parts = {(p.topic, p.idx): p
                       for p in self.store.get_all_partitions() if p.group >= 1}
        after_migs = {(m.topic, m.idx): m for m in self.store.get_migrations()}
        if self.on_partition_released is not None:
            for key, p in before_parts.items():
                if key not in after_parts:
                    self.on_partition_released(p)
        if self.on_delete_topic is not None:
            after_topics = {t.name for t in self.store.get_topics()}
            # sorted(): the hook fires at commit time on every node — the
            # order must not depend on set hashing (PYTHONHASHSEED).
            for name in sorted(before_topics - after_topics):
                self.on_delete_topic(name)
        if self.on_partition_assigned is not None:
            for p in after_parts.values():
                self.on_partition_assigned(p)
        # Migrations resolved while we were behind: the surviving partition
        # record tells the outcome — re-pointed at the target row means the
        # cutover happened, anything else is an abort's rollback. Still
        # in-flight ones re-fire begin (idempotent: freeze + re-arm).
        # sorted(): commit-time hook order must not depend on set hashing.
        for key in sorted(set(before_migs) - set(after_migs)):
            old = before_migs[key]
            p = after_parts.get(key)
            if p is None:
                continue  # topic died with the migration: release hooks ran
            if p.group == old.dst_group:
                if self.on_migration_cutover is not None:
                    old.phase = "cutover"
                    self.on_migration_cutover(old, p)
            elif self.on_migration_abort is not None:
                old.phase = "aborted"
                self.on_migration_abort(old, p)
        if self.on_migration_begin is not None:
            for key in sorted(after_migs):
                p = after_parts.get(key)
                if p is not None:
                    self.on_migration_begin(after_migs[key], p)


def decode_result(data: bytes):
    """Decode a transition result (same framing as the transition)."""
    return Transition.decode(data)


def noop() -> bytes:
    """A no-op payload (committed but mutates nothing)."""
    return b""
