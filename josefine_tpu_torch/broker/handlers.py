"""Broker request router + per-API handlers.

Parity: reference ``src/broker/mod.rs:107-144`` (router) and
``src/broker/handler/`` (one Handler impl per API — api_versions.rs,
metadata.rs, create_topics.rs, list_groups.rs, find_coordinator.rs,
leader_and_isr.rs, produce.rs). Here one class holds the route table and
the handlers; the raft client is the only write path (reference
``create_topics.rs:88-98``).

Deltas (deliberate, SURVEY.md quirks 2/8):
* Unknown / unsupported APIs get a protocol error or a closed connection —
  the reference panics the dispatcher (``mod.rs:140``).
* Produce and Fetch are fully implemented over the wire: offsets are
  assigned at append (rewriting the batch base offset), Fetch serves real
  data — the reference's Produce is unreachable and write-only, and it has
  no Fetch at all.
* ApiVersions advertises exactly the ranges the codec supports (the
  reference advertises 16 APIs it mostly cannot decode or route).
"""

from __future__ import annotations

import asyncio
import random
import re
import time
import uuid

from josefine_tpu_torch.broker import records
from josefine_tpu_torch.broker import partition_fsm
from josefine_tpu_torch.broker.fetch_frame import (
    RecordsSpan,
    materialize,
    max_bytes_bucket,
)
from josefine_tpu_torch.broker.fsm import Transition, decode_result as fsm_decode_result
from josefine_tpu_torch.broker.groups import GroupCoordinator
from josefine_tpu_torch.broker.replica import ReplicaRegistry
from josefine_tpu_torch.broker.state import Broker as BrokerInfo
from josefine_tpu_torch.broker.state import (
    Group,
    OffsetCommit,
    OffsetCommitBatch,
    Partition,
    Store,
    Topic,
)
from josefine_tpu_torch.config import BrokerConfig
from josefine_tpu_torch.kafka import client as kafka_client
from josefine_tpu_torch.kafka.codec import ApiKey, ErrorCode, supported_apis
from josefine_tpu_torch.raft.engine import NotLeader
from josefine_tpu_torch.raft.server import ProposalTimeout
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("broker.handlers")

_m_requests = REGISTRY.counter("broker_requests_total",
                               "Kafka API requests dispatched, by api key")
_m_errors = REGISTRY.counter("broker_request_errors_total",
                             "Kafka API handler exceptions, by api key")
_m_backpressure = REGISTRY.counter(
    "broker_produce_backpressure_total",
    "Replicated produces refused with THROTTLING_QUOTA_EXCEEDED because "
    "the partition's consensus-group proposal queue was over "
    "broker.max_group_inflight")

CLUSTER_ID = "josefine"  # reference metadata.rs cluster id

# Kafka's legal topic names. The store's offset keys and the replica dir
# layout rely on names never containing ':' or '/' — this is the gate that
# guarantees it.
_TOPIC_NAME = re.compile(r"^[a-zA-Z0-9._-]{1,249}$")


def valid_topic_name(name: str) -> bool:
    return bool(_TOPIC_NAME.match(name)) and name not in (".", "..")


class Broker:
    """Request router + handler state (reference ``Broker`` struct,
    ``src/broker/mod.rs:69-105``)."""

    def __init__(
        self,
        config: BrokerConfig,
        store: Store,
        raft_client,
        leader_hint=None,
        is_controller=None,
    ):
        self.config = config
        self.store = store
        self.client = raft_client
        self.replicas = ReplicaRegistry(config.data_directory)
        self.groups = GroupCoordinator(on_group_created=self._replicate_group)
        # Metadata-group leader lookup (controller identity + coordinator
        # placement anchor); defaults to self (the reference hardcodes
        # controller_id 1, metadata.rs:30). is_controller answers "does MY
        # raft node currently lead the metadata group" — the fallback
        # coordinator identity when leader_hint's id has no registry entry.
        self._leader_hint = leader_hint or (lambda: config.id)
        self._is_controller = is_controller or (lambda: True)
        # Short-TTL memo for coordinator_for's registry lookup.
        self._coord_cache: dict[int, tuple] = {}
        # Placement RNG seeded from cluster config: same (seed, broker id)
        # makes identical partition-assignment shuffles across runs
        # (graftlint det-unseeded-rng found the unseeded original;
        # test_broker_handlers pins this). The broker id is mixed in so
        # distinct brokers draw DIFFERENT streams — a cluster-wide shared
        # stream would land every broker's first shuffle on the same
        # leaders, a systematic placement skew the old unseeded RNG never
        # had.
        self._rng = random.Random((config.seed << 32) ^ config.id)
        # Strong refs: the loop holds tasks weakly; without this a pending
        # fire-and-forget proposal could be garbage-collected mid-flight.
        self._bg_tasks: set[asyncio.Task] = set()
        # Fetch long-poll wakeup. Event-epoch pattern: waiters grab the
        # current event; signal_append() replaces it and sets the old one,
        # waking every current waiter with no clear() race.
        self._append_event = asyncio.Event()
        # Read-path consistency mode (ARCHITECTURE.md "Leader leases"):
        # "local" serves reads from local state unchecked (seed behavior);
        # "lease" serves leader-local iff the partition's group lease is
        # unexpired, else pays a quorum read barrier; "consensus" always
        # barriers. Only meaningful when the raft client exposes the lease
        # surface (RaftClient / the workload driver's in-proc client — the
        # test shims don't, and degrade to "local").
        self._read_mode = getattr(config, "read_mode", "local")
        # Fetch serve path (config.broker.fetch_path): "zerocopy" threads
        # record spans as chunk lists straight to the socket writer;
        # "legacy" keeps the seed's join + native re-encode. Both read the
        # SAME blobs (identical budgets, shared span cache) — the
        # differential suite in tests/test_wire_fetch.py pins the frames
        # byte-identical.
        self._zero_copy = getattr(config, "fetch_path", "zerocopy") != "legacy"

    def signal_append(self) -> None:
        """Called by the data-plane PartitionFsm after each applied batch."""
        ev, self._append_event = self._append_event, asyncio.Event()
        ev.set()

    def _replicate_group(self, group_id: str) -> None:
        """Fire-and-forget EnsureGroup so ListGroups is cluster-wide."""
        async def proposer():
            try:
                await self.client.propose(Transition.ensure_group(Group(id=group_id)))
            except Exception as e:  # noqa: BLE001 - best-effort replication
                log.warning("EnsureGroup(%s) replication failed: %s", group_id, e)
        task = asyncio.get_running_loop().create_task(proposer())
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    # --------------------------------------------------------------- router

    async def handle_request(self, api_key: int, api_version: int, body: dict,
                             client_id: str | None = None,
                             client_host: str = "") -> dict | None:
        """Dispatch one decoded request; returns the response body, or None
        when the connection should be closed (undecodable API)."""
        _m_requests.inc(api=api_key)
        if body is None:
            if api_key == ApiKey.API_VERSIONS:
                return self._api_versions_unsupported()
            log.warning("closing connection: unsupported api %d v%d", api_key, api_version)
            return None
        try:
            if api_key == ApiKey.API_VERSIONS:
                return self.api_versions(api_version, body)
            if api_key == ApiKey.METADATA:
                return await self.metadata(api_version, body)
            if api_key == ApiKey.CREATE_TOPICS:
                return await self.create_topics(api_version, body)
            if api_key == ApiKey.DELETE_TOPICS:
                return await self.delete_topics(api_version, body)
            if api_key == ApiKey.LIST_GROUPS:
                return self.list_groups(api_version, body)
            if api_key == ApiKey.DESCRIBE_GROUPS:
                return self.describe_groups(api_version, body)
            if api_key == ApiKey.FIND_COORDINATOR:
                return self.find_coordinator(api_version, body)
            if api_key == ApiKey.LEADER_AND_ISR:
                return self.leader_and_isr(api_version, body)
            if api_key == ApiKey.PRODUCE:
                return await self.produce(api_version, body)
            if api_key == ApiKey.FETCH:
                return await self.fetch(api_version, body,
                                        zero_copy=self._zero_copy)
            if api_key == ApiKey.LIST_OFFSETS:
                return self.list_offsets(api_version, body)
            if api_key == ApiKey.JOIN_GROUP:
                return await self.join_group(api_version, body, client_id, client_host)
            if api_key == ApiKey.SYNC_GROUP:
                return await self.sync_group(api_version, body)
            if api_key == ApiKey.HEARTBEAT:
                return self.heartbeat(api_version, body)
            if api_key == ApiKey.LEAVE_GROUP:
                return self.leave_group(api_version, body)
            if api_key == ApiKey.OFFSET_COMMIT:
                return await self.offset_commit(api_version, body)
            if api_key == ApiKey.OFFSET_FETCH:
                return self.offset_fetch(api_version, body)
            if api_key == ApiKey.INIT_PRODUCER_ID:
                return await self.init_producer_id(api_version, body)
        except Exception:
            _m_errors.inc(api=api_key)
            log.exception("handler error api=%d v=%d", api_key, api_version)
            raise
        log.warning("closing connection: unrouted api %d", api_key)
        return None

    # ----------------------------------------------------------- ApiVersions

    def api_versions(self, version: int, body: dict) -> dict:
        """Advertise exactly what the codec implements (reference
        ``handler/api_versions.rs:14-81`` advertises its crate's full table)."""
        return {
            "error_code": ErrorCode.NONE,
            "api_keys": [
                {"api_key": k, "min_version": lo, "max_version": hi}
                for k, lo, hi in supported_apis()
            ],
            "throttle_time_ms": 0,
        }

    def _api_versions_unsupported(self) -> dict:
        # Kafka convention: answer an unsupported ApiVersions version with a
        # v0 body carrying UNSUPPORTED_VERSION plus the ranges we do speak.
        return self.api_versions(0, {}) | {"error_code": ErrorCode.UNSUPPORTED_VERSION}

    # ------------------------------------------------------------- Metadata

    async def metadata(self, version: int, body: dict) -> dict:
        """Reference ``handler/metadata.rs:12-110``: brokers from the store,
        per-topic partition/leader/ISR metadata, UnknownTopicOrPartition for
        misses (:57-61). Under broker.read_mode "lease"/"consensus" the
        response is gated on the metadata group's lease (:meth:`_metadata_gate`)
        so a partitioned ex-controller cannot keep advertising a stale
        cluster view past its lease expiry."""
        await self._metadata_gate()
        brokers = [
            {"node_id": b.id, "host": b.ip, "port": b.port, "rack": None}
            for b in self.store.get_brokers()
        ]
        if not brokers:  # self is always visible, even before registration
            brokers = [{"node_id": self.config.id, "host": self.config.ip,
                        "port": self.config.port, "rack": None}]
        requested = body.get("topics")
        if requested is None:
            topics = self.store.get_topics()
            names = [t.name for t in topics]
        else:
            names = [t["name"] for t in requested]
        found = [(name, topic,
                  self.store.get_partitions(name) if topic is not None else [])
                 for name, topic in ((n, self.store.get_topic(n)) for n in names)]
        # Live ISR for every group-backed partition we lead, across ALL
        # requested topics, in ONE engine fetch per request (per-partition
        # or per-topic calls would each cost two device transfers).
        isr_map = self.client.in_sync_ids_map(
            [g for g in (self._live_group(p)
                         for _, _, store_parts in found
                         for p in store_parts)
             if g is not None])
        out_topics = []
        for name, topic, store_parts in found:
            if topic is None:
                out_topics.append({
                    "error_code": ErrorCode.UNKNOWN_TOPIC_OR_PARTITION,
                    "name": name, "is_internal": False, "partitions": [],
                })
                continue
            parts = []
            for p in store_parts:
                leader = self._partition_leader(p)
                parts.append({
                    # Kafka semantics: a leaderless partition answers
                    # LEADER_NOT_AVAILABLE (retryable) with leader -1.
                    "error_code": (ErrorCode.NONE if leader >= 0
                                   else ErrorCode.LEADER_NOT_AVAILABLE),
                    "partition_index": p.idx,
                    "leader_id": leader,
                    "replica_nodes": p.assigned_replicas,
                    "isr_nodes": self._partition_isr(p, isr_map),
                    "offline_replicas": [],
                })
            out_topics.append({
                "error_code": ErrorCode.NONE, "name": name,
                "is_internal": topic.internal, "partitions": parts,
            })
        return {
            "throttle_time_ms": 0,
            "brokers": brokers,
            "cluster_id": CLUSTER_ID,
            "controller_id": self._leader_hint() or self.config.id,
            "topics": out_topics,
        }

    # ---------------------------------------------------------- CreateTopics

    def _make_partitions(self, name: str, num_partitions: int, replication_factor: int,
                         brokers: list[BrokerInfo]) -> list[Partition]:
        """Random-shuffle leader + replica assignment (reference
        ``create_topics.rs:27-61``)."""
        parts = []
        ids = [b.id for b in brokers]
        for idx in range(num_partitions):
            shuffled = ids[:]
            self._rng.shuffle(shuffled)
            replicas = shuffled[:replication_factor]
            parts.append(Partition(
                # graftlint: allow(det-uuid) — identity label naming the partition; never drives a decision or a journaled value
                topic=name, idx=idx, id=str(uuid.uuid4()),
                isr=replicas, assigned_replicas=replicas, leader=replicas[0],
            ))
        return parts

    async def create_topics(self, version: int, body: dict) -> dict:
        """Reference ``create_topics.rs:129-145``: propose EnsureTopic then
        EnsurePartition per partition via Raft (:88-98), then LeaderAndIsr
        fan-out to all brokers (:101-123)."""
        results = []
        validate_only = bool(body.get("validate_only"))
        brokers = self.store.get_brokers()
        if not brokers:
            brokers = [BrokerInfo(id=self.config.id, ip=self.config.ip, port=self.config.port)]
        for t in body.get("topics") or []:
            name = t.get("name") or ""
            num_partitions = t.get("num_partitions", 1)
            replication_factor = t.get("replication_factor", 1)
            err, msg = ErrorCode.NONE, None
            if not valid_topic_name(name):
                err, msg = ErrorCode.INVALID_TOPIC, (
                    f"topic name {name!r} is not legal ([a-zA-Z0-9._-], <=249 chars)")
            elif self.store.topic_exists(name):
                err, msg = ErrorCode.TOPIC_ALREADY_EXISTS, f"topic {name!r} exists"
            elif num_partitions < 1:
                err, msg = ErrorCode.INVALID_PARTITIONS, "num_partitions must be >= 1"
            elif not (1 <= replication_factor <= len(brokers)):
                err, msg = ErrorCode.INVALID_REPLICATION_FACTOR, (
                    f"replication_factor {replication_factor} not in [1, {len(brokers)}]")
            if err == ErrorCode.NONE and not validate_only:
                try:
                    await self._create_one_topic(t, name, num_partitions,
                                                 replication_factor, brokers)
                except (asyncio.TimeoutError, ProposalTimeout):
                    err, msg = ErrorCode.REQUEST_TIMED_OUT, "raft proposal timed out"
                except Exception as e:  # noqa: BLE001 - surfaced to the client
                    log.exception("create_topics %s failed", name)
                    err, msg = ErrorCode.UNKNOWN_SERVER_ERROR, str(e)
            results.append({"name": name, "error_code": err, "error_message": msg})
        return {"throttle_time_ms": 0, "topics": results}

    async def _create_one_topic(self, t: dict, name: str, num_partitions: int,
                                replication_factor: int, brokers: list[BrokerInfo]) -> None:
        if t.get("assignments"):
            parts = [
                # graftlint: allow(det-uuid) — identity label naming the partition; never drives a decision or a journaled value
                Partition(topic=name, idx=a["partition_index"], id=str(uuid.uuid4()),
                          isr=list(a["broker_ids"]), assigned_replicas=list(a["broker_ids"]),
                          leader=a["broker_ids"][0])
                for a in t["assignments"]
            ]
        else:
            parts = self._make_partitions(name, num_partitions, replication_factor, brokers)
        # graftlint: allow(det-uuid) — identity label naming the topic; never drives a decision or a journaled value
        topic = Topic(name=name, id=str(uuid.uuid4()),
                      partitions={p.idx: p.assigned_replicas for p in parts})
        await self.client.propose(Transition.ensure_topic(topic))
        # Bulk partition create: ONE replicated transition however many
        # partitions (the per-partition loop cost a consensus round-trip
        # each — a 10k-partition topic took 10k round-trips on group 0).
        await self.client.propose(Transition.ensure_partitions(parts))
        await self._leader_and_isr_fanout(parts, brokers)

    async def _leader_and_isr_fanout(self, parts: list[Partition],
                                     brokers: list[BrokerInfo]) -> None:
        """Reference ``create_topics.rs:101-123``: self in-process, peers via
        the internal Kafka client — which here actually works on the remote
        end (wire-decodable LeaderAndIsr)."""
        req = {
            "controller_id": self.config.id,
            "controller_epoch": 0,
            "partition_states": [{
                "topic": p.topic, "partition": p.idx, "controller_epoch": 0,
                "leader": p.leader, "leader_epoch": 0, "isr": p.isr,
                "zk_version": 0, "replicas": p.assigned_replicas,
            } for p in parts],
            "live_leaders": [{"broker_id": b.id, "host": b.ip, "port": b.port}
                             for b in brokers],
        }
        self.leader_and_isr(0, req)  # self, in-process (reference :107-110)

        async def notify(b: BrokerInfo) -> None:
            try:
                cl = await asyncio.wait_for(kafka_client.connect(b.ip, b.port), 3.0)
                try:
                    await cl.send(ApiKey.LEADER_AND_ISR, 0, req, timeout=5.0)
                finally:
                    await cl.close()
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                # Peer will learn assignments from the replicated store; the
                # fan-out is an eager hint, not the source of truth.
                log.warning("LeaderAndIsr fan-out to broker %d failed: %s", b.id, e)

        await asyncio.gather(*(notify(b) for b in brokers if b.id != self.config.id))

    # ------------------------------------------------------------ ListGroups

    def list_groups(self, version: int, body: dict) -> dict:
        """Reference stub returns empty (``list_groups.rs:5-14``); here the
        store's groups are listed."""
        return {
            "throttle_time_ms": 0,
            "error_code": ErrorCode.NONE,
            "groups": [{"group_id": g.id, "protocol_type": "consumer"}
                       for g in self.store.get_groups()],
        }

    # ------------------------------------------------------- FindCoordinator

    def coordinator_for(self, group_id: str):
        """Group -> broker placement anchored to Raft leadership: the
        coordinator for EVERY group is the current leader of the metadata
        consensus group — the exact analog of Kafka's
        ``__consumer_offsets``-partition-leader rule, with uniqueness
        inherited from Raft (at most one leader per term; a deposed
        coordinator stops believing within a leadership-transfer window,
        not an arbitrary network-view window — hashing over per-broker
        liveness views could seat two coordinators for one group under an
        asymmetric partition). The reference pins every group to whichever
        broker answered (``find_coordinator.rs:7-21``), which splits one
        consumer group into per-broker fictions. Non-coordinators answer
        NOT_COORDINATOR so clients re-route; coordinator death is a Raft
        election away from a new placement, where members rejoin with a
        fresh generation (in-memory rebalance state is disposable by
        design; committed offsets are Raft-replicated and survive).

        Returns the coordinator's BrokerInfo, or None while leaderless or
        before the leader has registered (bootstrap)."""
        lid = self._leader_hint()
        if lid is None:
            return None
        # Registry lookups hit sqlite under the KV lock on every group API
        # (heartbeats included) — memoize per leader id briefly; entries
        # only change on the rare broker re-registration.
        # graftlint: allow(det-wallclock) — cache-TTL only; the memo never reaches replicated state, responses, or journals
        now = time.monotonic()
        cached = self._coord_cache.get(lid)
        if cached is not None and now - cached[1] < 0.5:
            found = cached[0]
        else:
            found = next((b for b in self.store.get_brokers() if b.id == lid),
                         None)
            self._coord_cache[lid] = (found, now)
        if found is not None:
            return found
        if self._is_controller():
            # The leader's id has no registry entry — either bootstrap
            # (self-registration still in flight) or the legal
            # partitions=1 config where raft.id != broker.id (so
            # engine.leader_id(0) is not a broker id). If OUR raft node
            # leads the metadata group, we ARE the coordinator: answer
            # self so group APIs keep working; other brokers return
            # COORDINATOR_NOT_AVAILABLE and clients bootstrap-scan to us.
            return BrokerInfo(id=self.config.id, ip=self.config.ip,
                              port=self.config.port)
        return None

    def _coordinator_gate(self, group_id: str) -> int | None:
        """NOT_COORDINATOR / COORDINATOR_NOT_AVAILABLE if this broker must
        not serve group APIs for ``group_id``; None when it is the
        coordinator."""
        co = self.coordinator_for(group_id)
        if co is None:
            return int(ErrorCode.COORDINATOR_NOT_AVAILABLE)
        if co.id != self.config.id:
            return int(ErrorCode.NOT_COORDINATOR)
        return None

    def find_coordinator(self, version: int, body: dict) -> dict:
        group_id = body.get("key") or ""
        co = self.coordinator_for(group_id)
        if co is None:
            return {
                "throttle_time_ms": 0,
                "error_code": ErrorCode.COORDINATOR_NOT_AVAILABLE,
                "error_message": "broker registry empty",
                "node_id": -1, "host": "", "port": -1,
            }
        return {
            "throttle_time_ms": 0,
            "error_code": ErrorCode.NONE,
            "error_message": None,
            "node_id": co.id,
            "host": co.ip,
            "port": co.port,
        }

    # --------------------------------------------------------- LeaderAndIsr

    def leader_and_isr(self, version: int, body: dict) -> dict:
        """Create a replica (on-disk log) per partition this broker hosts
        (reference ``leader_and_isr.rs:8-29`` creates one per state row
    unconditionally; here only rows listing self as a replica)."""
        errors = []
        for ps in body.get("partition_states") or []:
            partition = Partition(
                topic=ps["topic"], idx=ps["partition"], isr=list(ps["isr"]),
                assigned_replicas=list(ps["replicas"]), leader=ps["leader"],
            )
            if self.config.id in partition.assigned_replicas:
                self.replicas.ensure(partition)
            errors.append({"topic": partition.topic, "partition": partition.idx,
                           "error_code": ErrorCode.NONE})
        return {"error_code": ErrorCode.NONE, "partition_errors": errors}

    # -------------------------------------------------------------- Produce

    def _live_group(self, p: Partition) -> int | None:
        """The partition's consensus group, if this process can actually
        consult it: the raft client must expose group leadership AND the
        engine must have the row (a store written under a larger
        engine.partitions can reference rows this process lacks — those
        partitions degrade to legacy static leadership, not a crash)."""
        if p.group < 1:
            return None
        if getattr(self.client, "is_leader", None) is None:
            return None
        has = getattr(self.client, "has_group", None)
        if has is not None and not has(p.group):
            return None
        return p.group

    def _partition_leader(self, p: Partition) -> int:
        """Live leader of a partition: for group-backed partitions this is
        its consensus group's CURRENT Raft leader (leadership moves with
        elections — the whole point of the P-axis wiring), and -1 while
        the row is LEADERLESS (mid-election, or freshly claimed before its
        first election — Kafka's leader-not-available answer; clients poll
        metadata until a leader appears). Answering the stored
        creation-time assignment instead sent produces to a broker that
        never led the row — a race bulk topic create made deterministic:
        one metadata round-trip now lands before the first election. Only
        legacy (group-less) partitions answer the static broker."""
        g = self._live_group(p)
        if g is not None:
            live = self.client.leader_id(g)
            return -1 if live is None else live
        return p.leader

    def _leads_partition(self, p: Partition) -> bool:
        g = self._live_group(p)
        if g is not None:
            return bool(self.client.is_leader(g))
        return p.leader == self.config.id

    def _partition_isr(self, p: Partition, isr_map: dict[int, list[int]]) -> list[int]:
        """Live ISR when this broker leads the partition's consensus group
        (derived from Raft match pointers + ack liveness — replicas actually
        keeping up); the stored creation-time ISR otherwise (the reference's
        only view: written once, never maintained, ``src/broker/state.rs``).
        ``isr_map`` is the request-scoped bulk fetch."""
        g = self._live_group(p)
        if g is not None and g in isr_map:
            return [b for b in isr_map[g] if b in p.assigned_replicas]
        return p.isr

    async def produce(self, version: int, body: dict) -> dict | None:
        """Append record batches with offset assignment (reference
        ``produce.rs:11-36`` writes raw bytes and assigns nothing). For
        group-backed partitions the batch is REPLICATED: it rides the
        partition's own consensus group and every replica's FSM appends it
        to its local log with an identical base offset — the reference's
        data plane is leader-local and write-only. acks=0 produces no
        response (Kafka semantics); the proposal still commits in the
        background."""
        topics_out = []
        acks = body.get("acks")
        for t in body.get("topics") or []:
            parts_out = []
            for p in t.get("partitions") or []:
                idx = p["index"]
                err, base = ErrorCode.NONE, -1
                got = self._writable_replica(t["name"], idx)
                if isinstance(got, int):
                    err = got
                else:
                    rep, part = got
                    batch = p.get("records") or b""
                    group = self._live_group(part)
                    bad = records.validate_batch(batch) if batch else None
                    if not batch:
                        pass
                    elif bad is not None:
                        # Refuse at ingress: once committed, a corrupt batch
                        # would replicate to every replica's log and poison
                        # the partition for CRC-checking consumers forever.
                        log.warning("rejecting produce to %s[%d]: %s",
                                    t["name"], idx, bad)
                        err = ErrorCode.CORRUPT_MESSAGE
                    elif (incoherent :=
                          records.validate_producer_coherence(batch)) is not None:
                        # A multi-batch field must be ONE producer's
                        # consecutive sequence run: the FSM attributes the
                        # whole field to the first batch's (pid, epoch), so
                        # mixed fields would corrupt dedup state.
                        log.warning("rejecting incoherent produce to "
                                    "%s[%d]: %s", t["name"], idx, incoherent)
                        err = ErrorCode.INVALID_RECORD
                    elif group is not None:
                        err, base = await self._produce_replicated(
                            group, batch, acks)
                    else:
                        count = records.record_count(batch)
                        base = rep.log.next_offset()
                        rep.log.append(records.set_base_offset(batch, base),
                                       count=count)
                        # Group-backed partitions signal from PartitionFsm
                        # at apply time; this direct-append path must wake
                        # long-poll fetchers itself.
                        self.signal_append()
                parts_out.append({"index": idx, "error_code": err,
                                  "base_offset": base, "log_append_time_ms": -1,
                                  "log_start_offset": 0})
            topics_out.append({"name": t["name"], "partitions": parts_out})
        if acks == 0:
            return {"__no_response__": True}
        return {"responses": topics_out, "throttle_time_ms": 0}

    async def _produce_replicated(self, group: int, batch: bytes,
                                  acks) -> tuple[int, int]:
        """One produced batch = one proposal on the partition's group.

        Admission gate (backpressure): while the group's proposal queue
        holds >= broker.max_group_inflight unminted entries, the produce is
        refused RETRYABLY instead of buffered — under sustained overload an
        unbounded queue grows without bound while every entry's latency
        climbs; refusing at the edge keeps memory bounded and pushes the
        wait into the client's (seeded, in the workload plane) backoff."""
        cap = self.config.max_group_inflight
        if cap:
            backlog = getattr(self.client, "proposal_backlog", None)
            if backlog is not None and backlog(group) >= cap:
                _m_backpressure.inc()
                if acks == 0:
                    # acks=0 has no response channel to carry the
                    # retryable code: the batch is SHED. That is the
                    # acks=0 contract (the client accepted silent loss —
                    # same as the fire() drop path below), and shedding
                    # the fire-and-forget tier first under overload is
                    # the gate working as intended; logged + counted so
                    # it is never invisible.
                    log.warning("acks=0 produce shed under backpressure "
                                "(group %d)", group)
                return int(ErrorCode.THROTTLING_QUOTA_EXCEEDED), -1
        try:
            if acks == 0:
                # Fire-and-forget: commit proceeds, nobody awaits the offset.
                # acks=0 means the client accepted silent loss — leadership
                # churn mid-flight is logged, never raised.
                async def fire():
                    try:
                        await self.client.propose_local(batch, group=group)
                    except Exception as e:  # noqa: BLE001 - acks=0 contract
                        log.warning("acks=0 produce dropped (group %d): %s",
                                    group, e)
                task = asyncio.get_running_loop().create_task(fire())
                self._bg_tasks.add(task)
                task.add_done_callback(self._bg_tasks.discard)
                return int(ErrorCode.NONE), -1
            result = await self.client.propose_local(batch, group=group)
            return partition_fsm.decode_produce_result(result)
        except NotLeader:
            return int(ErrorCode.NOT_LEADER_OR_FOLLOWER), -1
        except (ProposalTimeout, asyncio.TimeoutError):
            return int(ErrorCode.REQUEST_TIMED_OUT), -1
        except Exception:  # noqa: BLE001 - surfaced to the client
            log.exception("replicated produce failed (group %d)", group)
            return int(ErrorCode.UNKNOWN_SERVER_ERROR), -1

    async def init_producer_id(self, version: int, body: dict) -> dict:
        """Idempotent-producer id allocation: a replicated counter through
        Raft, so ids are unique cluster-wide and survive failover. No
        transactional support (transactional_id must be null) — same
        boundary real brokers had before transactions. No reference analog
        (its Produce path is unreachable; SURVEY.md quirk 8)."""
        resp = {"throttle_time_ms": 0, "error_code": ErrorCode.NONE,
                "producer_id": -1, "producer_epoch": -1}
        if body.get("transactional_id") is not None:
            resp["error_code"] = ErrorCode.INVALID_REQUEST
            return resp
        try:
            result = await self.client.propose(Transition.alloc_pid())
            entity = fsm_decode_result(result)
            resp["producer_id"] = entity.id
            resp["producer_epoch"] = 0
        except (ProposalTimeout, asyncio.TimeoutError):
            resp["error_code"] = ErrorCode.REQUEST_TIMED_OUT
        except Exception:  # noqa: BLE001 - surfaced to the client
            log.exception("producer id allocation failed")
            resp["error_code"] = ErrorCode.UNKNOWN_SERVER_ERROR
        return resp

    def _local_replica(self, topic: str, idx: int):
        """Replica this broker hosts, materialized from the replicated store
        on demand (fan-out raced the request, or the process restarted and
        the in-memory registry is empty while the log lives on disk). Returns
        an error code int when the partition is unknown or not hosted here."""
        rep = self.replicas.get(topic, idx)
        if rep is None:
            part = self.store.get_partition(topic, idx)
            if part is None:
                return int(ErrorCode.UNKNOWN_TOPIC_OR_PARTITION)
            if self.config.id not in part.assigned_replicas:
                return int(ErrorCode.NOT_LEADER_OR_FOLLOWER)
            rep = self.replicas.ensure(part)
        return rep

    def _writable_replica(self, topic: str, idx: int):
        """(replica, partition) if this broker leads (topic, idx), else an
        error code. For group-backed partitions leadership is the consensus
        group's live Raft leadership, not the statically stored assignment."""
        rep = self._local_replica(topic, idx)
        if isinstance(rep, int):
            return rep
        part = self.store.get_partition(topic, idx)
        if part is None:
            # Replica known only from a LeaderAndIsr fan-out hint (which
            # carries no consensus-group binding): the replicated store has
            # not applied EnsurePartition here yet. Serving a produce now
            # would take the group-less DIRECT-append path and ack a record
            # that was never replicated — it then squats at offset 0 and
            # diverges from the committed fold forever (found by chaos seed
            # 23). Refuse retryably; the client re-routes/retries and the
            # binding lands within a tick.
            return int(ErrorCode.NOT_LEADER_OR_FOLLOWER)
        if not self._leads_partition(part):
            return int(ErrorCode.NOT_LEADER_OR_FOLLOWER)
        return rep, part

    # ------------------------------------------------------ read-path gate

    async def _read_gate(self, group: int) -> int | None:
        """Per-group read-consistency gate (ARCHITECTURE.md "Leader
        leases"). Returns None when local state may be served now, else a
        retryable error code. Mode "lease": an unexpired tick-denominated
        lease serves immediately (raft_reads_leased_total counts it) and
        an invalid one falls back to the quorum read barrier
        (raft_reads_fallback_total says why); mode "consensus" always pays
        the barrier — the measured baseline, so it deliberately skips the
        lease counters. A False barrier means this node does not lead the
        group: answer NotLeader and let the client re-route."""
        if self._read_mode == "lease":
            ok, _reason = self.client.lease_serve(group)
            if ok:
                return None
        if await self.client.read_barrier(group):
            return None
        return int(ErrorCode.NOT_LEADER_OR_FOLLOWER)

    async def _metadata_gate(self) -> None:
        """Read gate for Metadata: group 0 — the replicated store IS the
        metadata FSM's applied state. Leased: serve immediately. Metadata
        leader without a valid lease: pay the quorum barrier. NOT the
        metadata leader: serve the local mirror as ever — Kafka metadata
        is advisory from any broker (clients bootstrap through followers),
        so refusing would break discovery; lease_serve still counts the
        fallback."""
        if self._read_mode == "local":
            return
        serve = getattr(self.client, "lease_serve", None)
        if serve is None:
            return
        if self._read_mode == "lease" and serve(0)[0]:
            return
        if self.client.is_leader(0):
            await self.client.read_barrier(0)

    async def _refused_reads(self, body: dict) -> dict | None:
        """(topic, partition) -> retryable error code for every group-backed
        partition in a Fetch body whose read gate refused, one gate per
        DISTINCT group (a request fanning over 100 partitions of one topic
        pays one lease check / barrier, not 100). None when the mode or the
        client cannot gate — the seed's ungated local serve."""
        if self._read_mode == "local" \
                or getattr(self.client, "lease_serve", None) is None:
            return None
        gate: dict[int, int | None] = {}
        refused: dict[tuple[str, int], int] = {}
        for t in body.get("topics") or []:
            for p in t.get("partitions") or []:
                key = (t["topic"], p["partition"])
                part = self.store.get_partition(*key)
                g = self._live_group(part) if part is not None else None
                if g is None:
                    continue  # group-less/unknown: legacy local serve
                if g not in gate:
                    gate[g] = await self._read_gate(g)
                if gate[g] is not None:
                    refused[key] = gate[g]
        return refused or None

    # ---------------------------------------------------------------- Fetch

    async def fetch(self, version: int, body: dict, *,
                    zero_copy: bool = False) -> dict:
        """Serve record batches from partition logs (no reference analog:
        its reader is a stub, ``src/broker/log/reader.rs:3-8``). An empty
        fetch long-polls the FULL max_wait_ms on an append-signaled event —
        consumers wake within a tick of data landing instead of sleeping a
        fixed interval (VERDICT r1 weak 3). Under broker.read_mode
        "lease"/"consensus" every serve — including each long-poll
        re-check — first passes the per-group read gate, so a lease that
        expires mid-poll stops being served the moment it lapses (the
        bounded-staleness contract; tests/test_lease_safety.py).

        ``zero_copy=True`` (the broker server path under
        broker.fetch_path="zerocopy") leaves each partition's records as a
        :class:`RecordsSpan` chunk list for writev-style frame assembly;
        the default materializes to the legacy joined ``bytes`` for
        in-process callers (tests, the workload driver)."""
        refused = await self._refused_reads(body)
        responses = self._fetch_once(body, refused)
        max_wait_ms = body.get("max_wait_ms") or 0
        if max_wait_ms > 0 and _fetch_should_wait(responses):
            loop = asyncio.get_running_loop()
            deadline = loop.time() + max_wait_ms / 1000
            while True:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                ev = self._append_event  # grab BEFORE re-checking the log
                refused = await self._refused_reads(body)
                responses = self._fetch_once(body, refused)
                if not _fetch_should_wait(responses):
                    break
                try:
                    await asyncio.wait_for(ev.wait(), remaining)
                except asyncio.TimeoutError:
                    refused = await self._refused_reads(body)
                    responses = self._fetch_once(body, refused)  # final re-check
                    break
        if not zero_copy:
            materialize(responses)
        return {"throttle_time_ms": 0, "responses": responses}

    def _fetch_once(self, body: dict,
                    refused: dict | None = None) -> list[dict]:
        out = []
        for t in body.get("topics") or []:
            parts_out = []
            for p in t.get("partitions") or []:
                idx = p["partition"]
                if refused is not None and (t["topic"], idx) in refused:
                    parts_out.append(
                        _fetch_err(idx, refused[(t["topic"], idx)]))
                    continue
                rep = self._local_replica(t["topic"], idx)
                if isinstance(rep, int):
                    parts_out.append(_fetch_err(idx, rep))
                    continue
                end = rep.log.next_offset()
                offset = p.get("fetch_offset") or 0
                if offset > end:
                    parts_out.append(_fetch_err(idx, ErrorCode.OFFSET_OUT_OF_RANGE,
                                                high_watermark=end))
                    continue
                # Hot-tail span cache: N consumers at the same (offset,
                # budget) of one hot partition share ONE log walk. The
                # budget is the pow2 bucket (fetch_frame.max_bytes_bucket)
                # on every path, so a cached span is exact for each
                # request that lands in its bucket.
                bucket = max_bytes_bucket(
                    p.get("partition_max_bytes") or (1 << 20))
                span = rep.fetch_cache.get(rep.log, offset, bucket)
                if span is None:
                    blobs = rep.log.read_from(offset, bucket)
                    span = RecordsSpan([b for _, _, b in blobs])
                    rep.fetch_cache.put(rep.log, offset, bucket, span)
                parts_out.append({
                    "partition": idx, "error_code": ErrorCode.NONE,
                    "high_watermark": end, "last_stable_offset": end,
                    "log_start_offset": 0, "aborted_transactions": None,
                    "records": span if span else None,
                })
            out.append({"topic": t["topic"], "partitions": parts_out})
        return out


    # ---------------------------------------------------------- ListOffsets

    def list_offsets(self, version: int, body: dict) -> dict:
        """Resolve log positions: timestamp -1 = latest (high watermark),
        -2 = earliest (log start). No reference analog (its reader is a
        stub). No time index: positive timestamps resolve to latest."""
        topics_out = []
        for t in body.get("topics") or []:
            parts_out = []
            for p in t.get("partitions") or []:
                idx = p["partition_index"]
                rep = self._local_replica(t["name"], idx)
                if isinstance(rep, int):
                    parts_out.append({"partition_index": idx, "error_code": rep,
                                      "timestamp": -1, "offset": -1})
                    continue
                ts = p.get("timestamp", -1)
                offset = 0 if ts == -2 else rep.log.next_offset()
                parts_out.append({"partition_index": idx,
                                  "error_code": ErrorCode.NONE,
                                  "timestamp": -1, "offset": offset})
            topics_out.append({"name": t["name"], "partitions": parts_out})
        return {"throttle_time_ms": 0, "topics": topics_out}

    # --------------------------------------------------------- DeleteTopics

    async def delete_topics(self, version: int, body: dict) -> dict:
        """Replicated topic deletion (the reference advertises DeleteTopics
        but cannot decode it). Metadata removal goes through Raft; each
        node's FSM drops its local replica logs on apply."""
        responses = []
        for name in body.get("topic_names") or []:
            err = ErrorCode.NONE
            if not self.store.topic_exists(name):
                err = ErrorCode.UNKNOWN_TOPIC_OR_PARTITION
            else:
                try:
                    await self.client.propose(Transition.delete_topic(name))
                except (asyncio.TimeoutError, ProposalTimeout):
                    err = ErrorCode.REQUEST_TIMED_OUT
                except Exception:
                    log.exception("delete_topics %s failed", name)
                    err = ErrorCode.UNKNOWN_SERVER_ERROR
            responses.append({"name": name, "error_code": err})
        return {"throttle_time_ms": 0, "responses": responses}

    # ------------------------------------------------- consumer group APIs

    async def join_group(self, version: int, body: dict, client_id: str | None,
                         client_host: str) -> dict:
        gate = self._coordinator_gate(body.get("group_id") or "")
        if gate is not None:
            return {"throttle_time_ms": 0, "error_code": gate,
                    "generation_id": -1, "protocol_name": "", "leader": "",
                    "member_id": "", "members": []}
        protocols = [(p["name"], p.get("metadata") or b"")
                     for p in body.get("protocols") or []]
        session_timeout_ms = body.get("session_timeout_ms")
        resp = await self.groups.join_group(
            group_id=body.get("group_id") or "",
            member_id=body.get("member_id") or "",
            protocol_type=body.get("protocol_type") or "",
            protocols=protocols,
            # `or` would coerce an (invalid) explicit 0 into the default and
            # mask the client bug; only absence gets the default.
            session_timeout_ms=30_000 if session_timeout_ms is None else session_timeout_ms,
            rebalance_timeout_ms=body.get("rebalance_timeout_ms") or 0,
            client_id=client_id or "",
            client_host=client_host,
        )
        members = [{"member_id": m["member_id"], "metadata": m["metadata"]}
                   for m in resp.get("members", [])]
        return {"throttle_time_ms": 0, "error_code": resp["error_code"],
                "generation_id": resp.get("generation_id", -1),
                "protocol_name": resp.get("protocol_name", ""),
                "leader": resp.get("leader", ""),
                "member_id": resp.get("member_id", ""),
                "members": members}

    async def sync_group(self, version: int, body: dict) -> dict:
        gate = self._coordinator_gate(body.get("group_id") or "")
        if gate is not None:
            return {"throttle_time_ms": 0, "error_code": gate,
                    "assignment": b""}
        resp = await self.groups.sync_group(
            group_id=body.get("group_id") or "",
            generation_id=body.get("generation_id", -1),
            member_id=body.get("member_id") or "",
            assignments=body.get("assignments") or [],
        )
        return {"throttle_time_ms": 0, "error_code": resp["error_code"],
                "assignment": resp.get("assignment", b"")}

    def heartbeat(self, version: int, body: dict) -> dict:
        err = (self._coordinator_gate(body.get("group_id") or "")
               or self.groups.heartbeat(body.get("group_id") or "",
                                        body.get("generation_id", -1),
                                        body.get("member_id") or ""))
        return {"throttle_time_ms": 0, "error_code": err}

    def leave_group(self, version: int, body: dict) -> dict:
        err = (self._coordinator_gate(body.get("group_id") or "")
               or self.groups.leave_group(body.get("group_id") or "",
                                          body.get("member_id") or ""))
        return {"throttle_time_ms": 0, "error_code": err}

    def describe_groups(self, version: int, body: dict) -> dict:
        out = []
        for g in body.get("groups") or []:
            gate = self._coordinator_gate(g)
            if gate is not None:
                out.append({"error_code": gate, "group_id": g,
                            "group_state": "", "protocol_type": "",
                            "protocol_data": "", "members": []})
            else:
                out.append(self.groups.describe(g))
        return {"throttle_time_ms": 0, "groups": out}

    # ------------------------------------------------------ offsets APIs

    async def offset_commit(self, version: int, body: dict) -> dict:
        """Commit offsets through Raft so they survive coordinator loss
        (real Kafka writes __consumer_offsets; the reference has nothing).
        The whole request is one replicated transition — one consensus
        round-trip regardless of partition count."""
        group_id = body.get("group_id") or ""
        gate = (self._coordinator_gate(group_id)
                or self.groups.validate_commit(group_id,
                                               body.get("generation_id", -1),
                                               body.get("member_id") or ""))
        batch = OffsetCommitBatch()
        results: dict[tuple[str, int], int] = {}
        for t in body.get("topics") or []:
            for p in t.get("partitions") or []:
                idx = p["partition_index"]
                err = gate
                if err == ErrorCode.NONE:
                    if self.store.get_partition(t["name"], idx) is None:
                        err = ErrorCode.UNKNOWN_TOPIC_OR_PARTITION
                    else:
                        batch.entries.append(OffsetCommit(
                            group=group_id, topic=t["name"], partition=idx,
                            offset=p.get("committed_offset", -1),
                            metadata=p.get("committed_metadata")))
                results[(t["name"], idx)] = int(err)
        if batch.entries:
            err = ErrorCode.NONE
            try:
                await self.client.propose(Transition.commit_offsets(batch))
            except (asyncio.TimeoutError, ProposalTimeout):
                err = ErrorCode.REQUEST_TIMED_OUT
            except Exception:
                log.exception("offset_commit %s failed", group_id)
                err = ErrorCode.UNKNOWN_SERVER_ERROR
            if err != ErrorCode.NONE:
                for oc in batch.entries:
                    results[(oc.topic, oc.partition)] = int(err)
        topics_out = [
            {"name": t["name"],
             "partitions": [{"partition_index": p["partition_index"],
                             "error_code": results[(t["name"], p["partition_index"])]}
                            for p in t.get("partitions") or []]}
            for t in body.get("topics") or []
        ]
        return {"throttle_time_ms": 0, "topics": topics_out}

    def offset_fetch(self, version: int, body: dict) -> dict:
        group_id = body.get("group_id") or ""
        gate = self._coordinator_gate(group_id)
        if gate is not None:
            # Pre-v2 responses have no top-level error_code on the wire, so
            # the gate must also ride per-partition errors or old clients
            # would read "no offsets committed" and auto-reset.
            topics_out = [
                {"name": t.get("name", ""),
                 "partitions": [{"partition_index": idx,
                                 "committed_offset": -1, "metadata": None,
                                 "error_code": gate}
                                for idx in t.get("partition_indexes") or []]}
                for t in body.get("topics") or []
            ]
            return {"throttle_time_ms": 0, "topics": topics_out,
                    "error_code": gate}
        requested = body.get("topics")
        topics_out = []
        if requested is None:
            # All committed offsets for the group (v2+ null topics).
            by_topic: dict[str, list] = {}
            for oc in self.store.get_offsets(group_id):
                by_topic.setdefault(oc.topic, []).append(
                    {"partition_index": oc.partition,
                     "committed_offset": oc.offset,
                     "metadata": oc.metadata, "error_code": ErrorCode.NONE})
            topics_out = [{"name": name, "partitions": parts}
                          for name, parts in sorted(by_topic.items())]
        else:
            for t in requested:
                parts_out = []
                for idx in t.get("partition_indexes") or []:
                    oc = self.store.get_offset(group_id, t["name"], idx)
                    parts_out.append({
                        "partition_index": idx,
                        "committed_offset": oc.offset if oc else -1,
                        "metadata": oc.metadata if oc else None,
                        "error_code": ErrorCode.NONE,
                    })
                topics_out.append({"name": t["name"], "partitions": parts_out})
        return {"throttle_time_ms": 0, "topics": topics_out,
                "error_code": ErrorCode.NONE}


def quota_refusal_body(api_key: int, body: dict | None) -> dict | None:
    """Response body carrying the retryable THROTTLING_QUOTA_EXCEEDED code
    for a first request refused by per-tenant accept admission
    (broker.max_connections_per_tenant). The refused connection still gets
    ONE well-formed response before the close, so a client with retry
    machinery backs off and retries instead of diagnosing a dead broker.
    Returns None for APIs with no error surface (acks=0 produce, metadata,
    ...) — those connections close silently and reconnect logic retries."""
    code = ErrorCode.THROTTLING_QUOTA_EXCEEDED
    if body is None:
        return None
    if api_key == ApiKey.PRODUCE:
        if not body.get("acks"):
            return None  # acks=0: the protocol has no response slot
        return {"throttle_time_ms": 0, "responses": [
            {"name": t.get("name") or "", "partitions": [
                {"index": p.get("index", 0), "error_code": code,
                 "base_offset": -1, "log_append_time_ms": -1,
                 "log_start_offset": -1}
                for p in t.get("partitions") or []]}
            for t in body.get("topics") or []]}
    if api_key == ApiKey.FETCH:
        return {"throttle_time_ms": 0, "responses": [
            {"topic": t.get("topic") or "", "partitions": [
                _fetch_err(p.get("partition", 0), code)
                for p in t.get("partitions") or []]}
            for t in body.get("topics") or []]}
    if api_key == ApiKey.FIND_COORDINATOR:
        return {"throttle_time_ms": 0, "error_code": code,
                "error_message": "tenant connection quota exceeded",
                "node_id": -1, "host": "", "port": -1}
    if api_key == ApiKey.JOIN_GROUP:
        return {"throttle_time_ms": 0, "error_code": code,
                "generation_id": -1, "protocol_name": "", "leader": "",
                "member_id": "", "members": []}
    if api_key == ApiKey.SYNC_GROUP:
        return {"throttle_time_ms": 0, "error_code": code, "assignment": b""}
    if api_key in (ApiKey.HEARTBEAT, ApiKey.LEAVE_GROUP):
        return {"throttle_time_ms": 0, "error_code": code}
    return None


def _fetch_err(idx: int, err: int, high_watermark: int = -1) -> dict:
    return {"partition": idx, "error_code": err, "high_watermark": high_watermark,
            "last_stable_offset": -1, "log_start_offset": -1,
            "aborted_transactions": None, "records": None}


def _fetch_has_data(responses: list[dict]) -> bool:
    return any(p.get("records") for t in responses for p in t["partitions"])


def _fetch_should_wait(responses: list[dict]) -> bool:
    """Long-poll only a healthy empty fetch. Any error partition (unknown
    topic, not-leader, offset-out-of-range) returns immediately — Kafka
    semantics — so a consumer on the wrong broker re-routes from metadata
    instead of stalling out its max_wait_ms."""
    if _fetch_has_data(responses):
        return False
    return all(p.get("error_code", 0) == 0
               for t in responses for p in t["partitions"])
