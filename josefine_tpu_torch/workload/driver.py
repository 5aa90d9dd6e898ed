"""In-process traffic driver: product load against a live engine at scale.

This is the scale path (``tools/traffic_soak.py``): ONE process hosts a
single-node :class:`~josefine_tpu.raft.engine.RaftEngine` with P = 10k to
100k consensus-group rows, the replicated metadata FSM, and the REAL
broker handlers in front of it — produce requests go through
``Broker.produce`` (validation, replica lookup, group resolution,
admission gate) into ``propose_local`` and come back as committed batches
applied by per-partition :class:`~josefine_tpu.broker.partition_fsm.
PartitionFsm` instances over in-memory logs. What it deliberately does
NOT exercise: the TCP codec (the wire driver's job,
:mod:`josefine_tpu.workload.wire`).

``replication > 1`` adds R-1 co-located chain-only replica engines so
every claimed row really replicates (AE out, ack back, quorum commit) —
and with ``device_route``/``payload_ring`` that replication leg runs
through the RouteFabric's device payload ring, which is the serve-path
measurement recorded in BENCH_traffic.json. Replica leadership is
pinned to the broker node (replica election timeouts past the horizon),
so the trace's NotLeader entries still mean row lifecycle, never replica
churn; chaotic multi-node replication remains the chaos workload's job
(:mod:`josefine_tpu.workload.chaos_traffic`).

Determinism contract (same as ``chaos/``): the driver owns a virtual tick
loop — no wall clock anywhere in this module — and every draw comes from
the schedule's seeded streams, so two runs with the same (spec, seed)
produce byte-identical workload traces (``WorkloadTrace.jsonl``). The
asyncio loop is used as a deterministic coroutine scheduler: tasks are
created in a fixed order, each tick gives them a fixed number of
scheduler passes, and completions are harvested by scanning the inflight
list in submission order — never by completion callbacks.

Single-node is a feature here, not a shortcut: leadership is stable by
construction, so every NotLeader the trace records comes from the row
lifecycle itself (topic delete → recycle → re-claim), which is exactly
the failure path the recycling tests need under live traffic.
"""

from __future__ import annotations

import asyncio

from josefine_tpu_torch.broker import records
from josefine_tpu_torch.broker.fsm import JosefineFsm, Transition
from josefine_tpu_torch.broker.handlers import Broker
from josefine_tpu_torch.broker.partition_fsm import PartitionFsm
from josefine_tpu_torch.broker.replica import ReplicaRegistry
from josefine_tpu_torch.broker.state import Store
from josefine_tpu_torch.config import BrokerConfig
from josefine_tpu_torch.kafka.codec import ErrorCode
from josefine_tpu_torch.models.types import step_params
from josefine_tpu_torch.raft.engine import NotLeader, RaftEngine
from josefine_tpu_torch.utils.kv import MemKV
from josefine_tpu_torch.utils.metrics import REGISTRY, Histogram, Registry
from josefine_tpu_torch.utils.spans import SpanLedger, SpanRecorder, bind_span
from josefine_tpu_torch.utils.tracing import get_logger
from josefine_tpu_torch.workload.model import TenantModel, WorkloadSpec
from josefine_tpu_torch.workload.schedule import (
    AdmissionState,
    ArrivalSchedule,
    ProduceArrival,
)
from josefine_tpu_torch.workload.trace import WorkloadTrace

log = get_logger("workload.driver")

# Process-global workload telemetry (the existing registry; /metrics).
# Tenant-labelled series are CAPPED — 10k tenants fold into the _other
# overflow series instead of exploding the exposition (utils.metrics).
_m_lat = REGISTRY.histogram(
    "workload_commit_latency_ticks",
    "Produce admission to commit-ack latency in virtual ticks, per tenant "
    "(capped label set with an _other overflow series)", max_series=256)
_m_produced = REGISTRY.counter(
    "workload_produced_total",
    "Produced batches committed and acked, per tenant (capped)",
    max_series=256)
_m_backpressure = REGISTRY.counter(
    "workload_backpressure_total",
    "Produces refused by the broker admission gate "
    "(THROTTLING_QUOTA_EXCEEDED) and retried")
_m_retries = REGISTRY.counter(
    "workload_retries_total",
    "Produce retries scheduled (NotLeader / backpressure, seeded backoff)")
_m_shed = REGISTRY.counter(
    "workload_shed_total",
    "Arrivals dropped because a tenant's bounded pending queue overflowed")
_m_inflight = REGISTRY.gauge(
    "workload_inflight", "Produce requests currently in flight")
_m_fetched = REGISTRY.counter(
    "workload_fetched_bytes_total", "Bytes served to consumer fetches")

# One scheduler pass lets a resolved proposal future wake its produce
# task; a couple more drain the chain (produce -> handler return -> task
# done). Fixed count = deterministic task states at harvest time.
_SETTLE_PASSES = 3

_RETRYABLE = (int(ErrorCode.THROTTLING_QUOTA_EXCEEDED),
              int(ErrorCode.NOT_LEADER_OR_FOLLOWER),
              int(ErrorCode.UNKNOWN_TOPIC_OR_PARTITION))


class _InprocClient:
    """RaftClient face over a directly-ticked engine — no server loop, the
    driver owns the virtual clock (proposal futures resolve inside
    ``engine.tick``)."""

    def __init__(self, engine: RaftEngine):
        self._engine = engine

    async def propose(self, payload: bytes, group: int = 0,
                      timeout: float = 0.0) -> bytes:
        return await self._engine.propose(group, payload)

    async def propose_local(self, payload: bytes, group: int = 0,
                            timeout: float = 0.0) -> bytes:
        eng = self._engine
        if not eng.is_leader(group):
            raise NotLeader(group, eng.leader_id(group) or -1)
        return await eng.propose(group, payload)

    def has_group(self, group: int) -> bool:
        return self._engine.has_group(group)

    def is_leader(self, group: int = 0) -> bool:
        return self._engine.is_leader(group)

    def leader_id(self, group: int = 0):
        return self._engine.leader_id(group)

    def in_sync_ids(self, group: int = 0):
        return self._engine.in_sync_ids(group)

    def in_sync_ids_map(self, groups):
        return self._engine.in_sync_ids_map(groups)

    def proposal_backlog(self, group: int) -> int:
        return self._engine.proposal_backlog(group)

    def lease_serve(self, group: int = 0):
        return self._engine.lease_serve(group)

    def read_barrier(self, group: int = 0):
        return self._engine.read_barrier(group)


class _PeerShimFsm:
    """Snapshot-capable stand-in registered on the chain-only replica
    engines at a migration TARGET row: replicas persist and ack while the
    broker node serves, so apply is a no-op — but ``migrate_adopt_row``
    refuses rows without a snapshot-capable FSM (an adoption that cannot
    restore its carried header would silently discard the handoff)."""

    def __init__(self):
        self._record = b""

    def transition(self, payload: bytes) -> bytes:
        return b""

    def snapshot(self) -> bytes:
        return self._record

    def restore(self, data: bytes) -> None:
        self._record = data


class _Consumer:
    """One consumer session of a tenant's group (modeled membership: the
    in-process plane drives assignment deterministically; the real
    JoinGroup/SyncGroup wire protocol is the wire driver's job)."""

    __slots__ = ("tenant", "idx", "live", "offsets", "last_commit")

    def __init__(self, tenant: int, idx: int):
        self.tenant = tenant
        self.idx = idx
        self.live = True
        self.offsets: dict[tuple[str, int], int] = {}
        self.last_commit = 0


def _consumed_end(data: bytes) -> int | None:
    """Last record offset + 1 actually covered by a fetch response body (a
    concatenation of Kafka record batches: baseOffset int64 BE +
    batchLength int32 BE + body). The consumer must advance to THIS, not
    the partition high watermark — a response truncated by
    partition_max_bytes covers less than the watermark, and skipping the
    gap would silently drop records from the consumed stream."""
    off, end = 0, None
    while off + 12 <= len(data):
        base = int.from_bytes(data[off:off + 8], "big")
        blen = int.from_bytes(data[off + 8:off + 12], "big")
        if off + 12 + blen > len(data):
            break  # trailing partial batch: not consumed
        end = base + records.record_count(data[off:off + 12 + blen])
        off += 12 + blen
    return end


class _Flight:
    __slots__ = ("task", "arr", "attempt", "first_tick")

    def __init__(self, task, arr: ProduceArrival, attempt: int,
                 first_tick: int):
        self.task = task
        self.arr = arr
        self.attempt = attempt
        self.first_tick = first_tick


class TrafficEngine:
    """The in-process multi-tenant traffic soak (see module docstring).

    Usage::

        drv = TrafficEngine(spec, seed=7)
        asyncio.run(drv.run(ticks=200))
        drv.trace.jsonl()     # byte-stable event trace
        drv.summary()         # quantiles + throughput + backpressure
    """

    def __init__(self, spec: WorkloadSpec, seed: int,
                 engine_groups: int | None = None,
                 active_set: bool = False, window: int = 1,
                 hb_ticks: int = 1, backend: str = "torch",
                 max_group_inflight: int | None = None,
                 replication: int = 1, device_route: bool = False,
                 payload_ring: bool = False,
                 request_spans: bool = False,
                 span_capacity: int = 4096,
                 leases: bool = False, flight_lease: bool = False,
                 read_mode: str = "local", timeout_min: int = 3,
                 health: bool = False, device="cuda"):
        self.spec = spec.validate()
        self.seed = seed
        self.model = TenantModel(spec)
        self.sched = ArrivalSchedule(spec, seed)
        self.trace = WorkloadTrace()
        self.window = window
        P = engine_groups or (spec.total_partitions + 1)
        self.kv = MemKV()
        self.store = Store(self.kv)
        self.fsm = JosefineFsm(self.store, group_pool=P)
        # Replicated serve mode (replication > 1): the broker node plus
        # R-1 co-located replica engines — every claimed row spans all R
        # slots, so each committed produce really replicates (AE out, ack
        # back, quorum commit) instead of self-acking. The replicas are
        # chain-only (no broker FSMs: they persist and ack, the broker
        # node serves), and their election timeouts are pushed past the
        # horizon so leadership of every row deterministically stays with
        # the broker node — NotLeader in the trace still means row
        # lifecycle, never replica churn. Pair with device_route /
        # payload_ring to serve the produce path through the RouteFabric:
        # with the ring on, the AE-with-blocks leg routes on-chip and the
        # serve loop's host share is the broker handlers themselves.
        self.replication = max(1, int(replication))
        # Read-path mode (config.BrokerConfig.read_mode): non-local modes
        # ride the engine's lease lane. timeout_min is a knob (not bumped
        # implicitly when leases turn on) so a leases-on/off BENCH pair
        # can run IDENTICAL election parameters — the twin-differential
        # digest comparison requires the consensus plane byte-identical.
        if read_mode not in ("local", "lease", "consensus"):
            raise ValueError(f"read_mode must be local|lease|consensus, "
                             f"got {read_mode!r}")
        if read_mode != "local" and not leases:
            raise ValueError(f"read_mode={read_mode!r} requires leases=True")
        self.read_mode = read_mode
        node_ids = list(range(1, self.replication + 1))
        self.engine = RaftEngine(
            self.kv, node_ids, 1, groups=P, fsms={0: self.fsm},
            params=step_params(timeout_min=timeout_min, timeout_max=8,
                               hb_ticks=hb_ticks, device="cpu"),
            base_seed=seed, backend=backend, active_set=active_set,
            request_spans=request_spans, leases=leases,
            flight_lease=flight_lease, device=device)
        # Request spans (in-process trace context: minted at first
        # enqueue — the "driver submit" of the wire path's frame decode —
        # finished at response harvest; every mark rides the ENGINE tick
        # axis via _flight_tick so phases are device-tick-denominated and
        # a tree's phases sum to its observed latency by construction).
        self.spans = (SpanRecorder(capacity=span_capacity,
                                   clock=self.engine._flight_tick)
                      if request_spans else None)
        # One-span-per-request bookkeeping, shared with the chaos
        # traffic adapter (utils/spans.SpanLedger — inert when spans
        # are off).
        self._ledger = SpanLedger(self.spans)
        self.peers = [
            RaftEngine(MemKV(), node_ids, nid, groups=P,
                       params=step_params(timeout_min=1 << 20,
                                          timeout_max=(1 << 20) + 8,
                                          hb_ticks=hb_ticks, device="cpu"),
                       base_seed=seed + nid, backend=backend,
                       device=device)
            for nid in node_ids[1:]
        ]
        self.engines = [self.engine] + self.peers  # slot-indexed
        self.fabric = None
        if device_route and self.replication < 2:
            # Refuse rather than silently measure the classic single-node
            # path: the soak row records these flags in its merge key, so
            # an ignored flag would label an unrouted run as ring-routed.
            raise ValueError("device_route requires replication >= 2 "
                             "(a single-node engine has no peers to route "
                             "to)")
        if payload_ring and not device_route:
            raise ValueError("payload_ring requires device_route")
        if device_route and self.replication > 1:
            from josefine_tpu_torch.raft.route import RouteFabric

            # ring_bytes=1024: produce record batches are ~100-300 B, but
            # the metadata group's bulk-partition transitions run 512-768 B
            # — a 512 B slot would spill every topic-lifecycle span.
            self.fabric = RouteFabric(payload_ring=payload_ring,
                                      ring_bytes=1024)
            for e in self.engines:
                self.fabric.register(e)
        cfg = BrokerConfig(id=1, ip="127.0.0.1", port=9092, seed=seed,
                           read_mode=read_mode)
        if max_group_inflight is not None:
            cfg.max_group_inflight = max_group_inflight
        self.broker = Broker(cfg, self.store, _InprocClient(self.engine))
        # 10k+ partitions in one process: in-memory replica logs (the
        # native seglog path is the wire driver's / durability suites').
        self.broker.replicas = ReplicaRegistry("workload-mem",
                                               in_memory=True)
        self.fsm.on_partition_assigned = self._wire_partition
        self.fsm.on_partition_released = self._release_partition
        # Drop dead replicas at DeleteTopic commit (Node wires the same
        # hook): without it the registry would hand a re-created topic its
        # predecessor's log and PartitionFsm's foreign-log reset fires.
        self.fsm.on_delete_topic = self.broker.replicas.drop_topic
        # Live migration: the metadata FSM's reassignment
        # transitions drive a row-to-row handoff under traffic.
        self.fsm.on_migration_begin = self._migration_begin
        self.fsm.on_migration_cutover = self._migration_cutover
        self.fsm.on_migration_abort = self._migration_abort
        # (topic, idx) -> pause ledger for the in-flight migration.
        self._active_migs: dict[tuple[str, int], dict] = {}
        self.migrations: list[dict] = []   # resolved, for the summary
        self._mig_tasks: list[tuple[str, object]] = []
        # Per-group commit heat (hot-tenant trigger input, paired with the
        # engine's wake gauges at trigger time).
        self._group_heat: dict[int, int] = {}

        self.tick = 0
        # Bootstrap batches membership claims into ONE mask rebuild
        # (configure_groups); per-row set_group_members re-uploads the
        # whole member mask per call, which at P=100k is prohibitive.
        self._bootstrapping = True
        self._boot_claims: dict[int, set[int]] = {}
        self._inflight: list[_Flight] = []
        self._commit_tasks: list[tuple[int, object]] = []  # (tenant, task)
        self._ack_tasks: list[tuple[int, object]] = []     # (group, task)
        # Gated reads (read_mode != "local") run as harvested tasks: a
        # lease-fallback read barrier resolves inside engine.tick, so an
        # inline await in the consumer round would deadlock the tick loop.
        self._fetch_tasks: list[tuple[int, object]] = []   # (tenant, task)
        # Bounded admission (queues/inflight/retry ledger): the ONE policy
        # implementation, shared with the chaos traffic adapter.
        self._adm = AdmissionState(spec)
        self._pending_acks: list[tuple[int, int]] = []
        self._consumers = [
            [_Consumer(t, i) for i in range(spec.consumers_per_tenant)]
            for t in range(spec.tenants)
        ]
        # Run-local latency histogram: the process-global registry
        # accumulates across runs in one process, and the summary must
        # describe THIS run only.
        self._run_registry = Registry()
        self._run_lat = Histogram("run_commit_latency_ticks", "",
                                  self._run_registry, max_series=100_000)
        # Run-local counters (the summary's backpressure/throughput view).
        self.n_offered = 0
        self.n_admitted = 0
        self.n_committed = 0
        self.n_replicated = 0
        self.n_direct = 0
        self.n_backpressured = 0
        self.n_rejected = 0
        self.n_retries = 0
        self.n_shed = 0
        self.n_gave_up = 0
        self.n_errors = 0
        self.n_fetched_bytes = 0
        self.n_offset_commits = 0
        self.n_recycle_acks = 0
        # Health plane (opt-in): a cluster-scope monitor fed once per
        # virtual tick with the workload's own aggregates — committed
        # progress vs open work (commit_stall), the cumulative
        # backpressure tally (backpressure_sat), and, when request spans
        # are on, the phase attribution totals (phase_regime: which
        # ladder rung dominates shifts under a fault). publish=False for
        # the same reason as _run_registry above: the process-global
        # gauge would accumulate across runs sharing a process.
        if health:
            from josefine_tpu_torch.utils.health import HealthMonitor

            self.health: HealthMonitor | None = HealthMonitor(
                groups=1, publish=False)
        else:
            self.health = None

    # ------------------------------------------------------------ wiring

    def _wire_partition(self, p) -> None:
        """Commit-time hook (EnsurePartition applied): claim the row for
        this node, tag it with its tenant, attach the data-plane FSM.

        No local-wipe step, unlike Node._sync_group_incarnation: this
        process starts empty and _release_partition already recycled any
        previous life's row, so a claim here never meets local leftovers.
        """
        eng = self.engine
        if p.group < 1 or p.group >= eng.P:
            return
        inc = self.store.group_incarnation(p.group)
        claim = set(range(self.replication))
        for e in self.engines:
            # Replicas mirror the claim + incarnation (they have no
            # metadata FSM of their own; the broker node's committed
            # transitions are the source of truth for row wiring).
            e.set_group_incarnation(p.group, inc)
        tenant = TenantModel.tenant_of(p.topic)
        eng.set_group_tag(p.group, TenantModel.tenant_label(tenant))
        if self._bootstrapping:
            self._boot_claims[p.group] = claim
        else:
            for e in self.engines:
                e.set_group_members(p.group, claim)
        rep = self.broker.replicas.ensure(p)
        if p.group not in eng.drivers:
            eng.register_fsm(p.group, PartitionFsm(
                self.kv, p.group, rep.log,
                on_append=self.broker.signal_append))

    def _release_partition(self, p) -> None:
        """Commit-time hook (DeleteTopic applied): idle + recycle the row
        and queue the reset ack, mirroring Node._release_partition for the
        single-host case."""
        eng = self.engine
        if p.group < 1 or p.group >= eng.P:
            return
        eng.unregister_fsm(p.group)
        for e in self.engines:
            e.set_group_members(p.group, set())
            e.recycle_group(p.group)
        self.kv.delete(b"pfsm:%d" % p.group)
        self.kv.delete(b"pfsm:r:%d" % p.group)
        self._pending_acks.append(
            (p.group, self.store.group_incarnation(p.group)))

    # --------------------------------------------------------- bootstrap

    async def _settle(self, passes: int = _SETTLE_PASSES) -> None:
        for _ in range(passes):
            await asyncio.sleep(0)

    def _engine_tick(self) -> None:
        res = self.engine.tick(
            window=self.engine.suggest_window(self.window))
        if self.replication > 1:
            # Replicated serve loop, one virtual tick: every engine ticks
            # first, THEN all outbound delivers, THEN the fabric barrier —
            # host-path and device-routed halves of one tick's traffic
            # must become consumable at the same receiver tick (the fabric's
            # byte-identity barrier; delivering the broker's host frames
            # mid-round while routed rows wait for the flush makes every
            # replica permanently route-dirty with slot conflicts).
            outs = list(res.outbound)
            for p in self.peers:
                outs.extend(p.tick(window=p.suggest_window(
                    self.window)).outbound)
            for m in outs:
                self.engines[m.dst].receive(m)
            if self.fabric is not None:
                self.fabric.flush()
        elif res.outbound:  # single node: nothing to send to nobody
            raise RuntimeError("single-node engine produced wire traffic")

    async def start(self, max_boot_ticks: int = 4096) -> None:
        """Elect the metadata group, create every topic (bulk partition
        transitions), wire + elect every claimed row."""
        # Idle every data row until a topic claims it: unclaimed rows
        # default to full membership and would all run elections for
        # nothing at P=100k.
        for e in self.engines:
            e.configure_groups({})
        for _ in range(64):
            if self.engine.is_leader(0):
                break
            self._engine_tick()
            await self._settle(1)
        if not self.engine.is_leader(0):
            raise RuntimeError("metadata group never elected")

        tasks = []
        for name in self.model.topic_names:
            self.trace.emit(self.tick, "topic_create", topic=name)
            tasks.append(asyncio.ensure_future(self.broker.create_topics(1, {
                "topics": [{"name": name,
                            "num_partitions": self.spec.partitions_per_topic,
                            "replication_factor": 1,
                            "assignments": [], "configs": []}],
                "timeout_ms": 0, "validate_only": False,
            })))
        for _ in range(max_boot_ticks):
            await self._settle()
            if all(t.done() for t in tasks):
                break
            self._engine_tick()
        for t in tasks:
            resp = t.result()
            if resp["topics"][0]["error_code"] != ErrorCode.NONE:
                raise RuntimeError(f"topic create failed: {resp}")

        # One mask rebuild for every claim collected during the commits.
        for e in self.engines:
            e.configure_groups(self._boot_claims)
        self._bootstrapping = False
        groups = sorted(self._boot_claims)
        for _ in range(max_boot_ticks):
            if all(self.engine.is_leader(g) for g in groups):
                break
            self._engine_tick()
        if groups and not all(self.engine.is_leader(g) for g in groups):
            raise RuntimeError("claimed rows never elected")
        self.trace.emit(self.tick, "topics_ready",
                        topics=len(self.model.topic_names),
                        groups=len(groups))

    # -------------------------------------------------------- tick loop

    async def run(self, ticks: int) -> dict:
        await self.start()
        await self.run_ticks(ticks)
        return self.summary()

    async def run_ticks(self, ticks: int) -> None:
        """The measured soak phase: ``ticks`` virtual ticks of open-loop
        load (callers time this phase; the driver itself reads no clock)."""
        for _ in range(ticks):
            await self._tick_once()
        # Drain: stop offering, let inflight work finish so the trace ends
        # at a quiesced state. The bound covers the worst retry chain
        # (max_retries attempts, each delayed up to backoff_max + jitter);
        # anything past it is aborted EXPLICITLY below — asyncio must
        # never tear down still-pending produce tasks at loop close.
        drain = (self.spec.max_retries + 2) * 2 * self.spec.retry_backoff_max
        for _ in range(drain):
            if not (self._inflight or self._adm.pending()
                    or self._commit_tasks or self._ack_tasks
                    or self._mig_tasks or self._fetch_tasks):
                break
            await self._tick_once(offer=False)
        aborted = len(self._inflight) + self._adm.pending()
        if aborted:
            for f in self._inflight:
                f.task.cancel()
            for _tenant, task in self._commit_tasks:
                task.cancel()
            for _g, task in self._ack_tasks:
                task.cancel()
            for _n, task in self._mig_tasks:
                task.cancel()
            for _t, task in self._fetch_tasks:
                task.cancel()
            await asyncio.gather(
                *(f.task for f in self._inflight),
                *(task for _, task in self._commit_tasks),
                *(task for _, task in self._ack_tasks),
                *(task for _, task in self._mig_tasks),
                *(task for _, task in self._fetch_tasks),
                return_exceptions=True)
            self._inflight = []
            self._commit_tasks = []
            self._ack_tasks = []
            self._mig_tasks = []
            self._fetch_tasks = []
            self._adm.clear()
            self.trace.emit(self.tick, "drain_aborted", pending=aborted)
        if self._ledger:
            # Anything still open after the drain epilogue was aborted
            # with its task — close the spans so the recorder's open
            # count drains to zero and the dump covers them; then seal
            # the sampling window (end of run = end of measurement), so
            # summary()/dump describe the same retained set.
            self._ledger.close_all()
            self.spans.seal()

    async def _tick_once(self, offer: bool = True) -> None:
        t = self.tick
        # 1. Matured retries re-enter their tenant queues (stable order).
        for arr, attempt, first in self._adm.mature(t):
            self._enqueue(arr, attempt, first)
        # 2. Open-loop arrivals.
        if offer:
            for arr in self.sched.produce_arrivals(t):
                self.n_offered += 1
                self._enqueue(arr, 0, t)
        # 3. Admission under the per-tenant inflight bound.
        for tenant in range(self.spec.tenants):
            for arr, attempt, first in self._adm.admit_ready(tenant):
                self._admit(arr, attempt, first)
        # 4. Consumer-group churn.
        if offer:
            for ev in self.sched.churn_events(t):
                self._apply_churn(ev)
        # 5. Consumer fetch/commit rounds.
        await self._consumer_round(t)
        # 6. Recycle acks for released rows.
        self._drain_release_acks()
        # 7. One device tick (resolves proposal futures).
        self._engine_tick()
        # 8. Fixed scheduler passes, then harvest by submission order.
        await self._settle()
        self._harvest(t)
        _m_inflight.set(len(self._inflight))
        if self.health is not None:
            sample = {
                "progress": [self.n_committed],
                "pending": [len(self._inflight) + self._adm.pending()],
                "backpressure": (self.n_backpressured + self.n_rejected
                                 + self.n_shed),
            }
            if self.spans is not None:
                sample["phases"] = self.spans.phase_totals()
            self.health.observe(t, sample)
        self.tick += 1

    # --------------------------------------------------------- produce

    def _enqueue(self, arr: ProduceArrival, attempt: int,
                 first_tick: int) -> None:
        if self._ledger and attempt == 0:
            # In-process trace context, one per REQUEST (not per attempt):
            # admission stretches over every backpressure refusal and
            # retry backoff until the attempt that finally submits.
            self._ledger.open(
                (arr.tenant, arr.seq), "produce",
                tenant=TenantModel.tenant_label(arr.tenant),
                topic=arr.topic, partition=arr.partition)
        if not self._adm.enqueue(arr, attempt, first_tick):
            self.n_shed += 1
            _m_shed.inc()
            self.trace.emit(self.tick, "shed", tenant=arr.tenant,
                            seq=arr.seq)
            self._ledger.finish((arr.tenant, arr.seq), "shed")

    def _admit(self, arr: ProduceArrival, attempt: int,
               first_tick: int) -> None:
        # admit_ready already claimed the inflight slot.
        self.n_admitted += 1
        self.trace.emit(self.tick, "produce", tenant=arr.tenant,
                        topic=arr.topic, part=arr.partition, seq=arr.seq,
                        attempt=attempt)
        task = asyncio.ensure_future(self._produce(arr))
        self._inflight.append(_Flight(task, arr, attempt, first_tick))

    async def _produce(self, arr: ProduceArrival) -> tuple[int, int]:
        if self._ledger:
            # Task-local bind: the engine's propose() (reached through the
            # real broker handler stack) stamps the span's rungs.
            span = self._ledger.get((arr.tenant, arr.seq))
            if span is not None:
                bind_span(span)
        batch = records.build_batch(arr.payload(self.spec),
                                    self.spec.records_per_batch)
        resp = await self.broker.produce(3, {
            "transactional_id": None, "acks": -1, "timeout_ms": 0,
            "topics": [{"name": arr.topic, "partitions": [
                {"index": arr.partition, "records": batch}]}],
        })
        p = resp["responses"][0]["partitions"][0]
        return int(p["error_code"]), int(p["base_offset"])

    def _harvest(self, t: int) -> None:
        still = []
        for f in self._inflight:
            if not f.task.done():
                still.append(f)
                continue
            arr = f.arr
            self._adm.done(arr.tenant)
            code, base = f.task.result()
            if code == int(ErrorCode.NONE):
                self._record_commit(t, f, base)
            elif code in _RETRYABLE:
                if code == int(ErrorCode.THROTTLING_QUOTA_EXCEEDED):
                    self.n_backpressured += 1
                    _m_backpressure.inc()
                    self.trace.emit(t, "backpressure", tenant=arr.tenant,
                                    seq=arr.seq)
                else:
                    self.n_rejected += 1
                    self.trace.emit(t, "produce_rejected",
                                    tenant=arr.tenant, seq=arr.seq,
                                    code=code)
                    mig = self._active_migs.get((arr.topic, arr.partition))
                    if mig is not None:
                        # Dual-ownership window: the frozen source refused
                        # this attempt; the retry ledger reroutes it to the
                        # target row after cutover — the migration pause in
                        # request terms.
                        mig["refused"] += 1
                if self.store.topic_exists(arr.topic):
                    self._schedule_retry(t, f)
                else:
                    self.trace.emit(t, "dropped", tenant=arr.tenant,
                                    seq=arr.seq, reason="topic_gone")
                    self._ledger.finish((arr.tenant, arr.seq), "dropped")
            else:
                self.n_errors += 1
                self.trace.emit(t, "produce_err", tenant=arr.tenant,
                                seq=arr.seq, code=code)
                self._ledger.finish((arr.tenant, arr.seq), "error")
        self._inflight = still

        still_c = []
        for tenant, task in self._commit_tasks:
            if not task.done():
                still_c.append((tenant, task))
                continue
            task.result()  # handler errors surface loudly
            self.n_offset_commits += 1
            self.trace.emit(t, "offset_commit", tenant=tenant)
        self._commit_tasks = still_c

        still_a = []
        for g, task in self._ack_tasks:
            if not task.done():
                still_a.append((g, task))
                continue
            task.result()
            self.n_recycle_acks += 1
            self.trace.emit(t, "recycle_ack", group=g)
        self._ack_tasks = still_a

        still_f = []
        for tenant, task in self._fetch_tasks:
            if not task.done():
                still_f.append((tenant, task))
                continue
            task.result()  # gated-fetch errors surface loudly
        self._fetch_tasks = still_f

        still_m = []
        for name, task in self._mig_tasks:
            if not task.done():
                still_m.append((name, task))
                continue
            task.result()  # handoff-drive errors surface loudly
        self._mig_tasks = still_m

    def _record_commit(self, t: int, f: _Flight, base: int) -> None:
        arr = f.arr
        lat = t - f.first_tick
        label = TenantModel.tenant_label(arr.tenant)
        self._run_lat.observe(lat, tenant=label)
        _m_lat.observe(lat, tenant=label)
        _m_produced.inc(tenant=label)
        self.n_committed += 1
        part = self.store.get_partition(arr.topic, arr.partition)
        if part is not None and part.group >= 1:
            self.n_replicated += 1
            self._group_heat[part.group] = \
                self._group_heat.get(part.group, 0) + 1
        else:
            self.n_direct += 1
        self.trace.emit(t, "produce_ok", tenant=arr.tenant, seq=arr.seq,
                        base=base, lat=lat)
        self._ledger.finish((arr.tenant, arr.seq), "ok")

    def _schedule_retry(self, t: int, f: _Flight) -> None:
        if not self._adm.schedule_retry(t, f.arr, f.attempt, f.first_tick,
                                        self.sched.retry_delay):
            self.n_gave_up += 1
            self.trace.emit(t, "gave_up", tenant=f.arr.tenant,
                            seq=f.arr.seq)
            self._ledger.finish((f.arr.tenant, f.arr.seq), "gave_up")
            return
        self.n_retries += 1
        _m_retries.inc()
        due, _arr, attempt, _first = self._adm.delayed[-1]
        self.trace.emit(t, "retry", tenant=f.arr.tenant, seq=f.arr.seq,
                        attempt=attempt, after=due - t)

    # -------------------------------------------------------- consumers

    def _assignment(self, tenant: int,
                    consumer: _Consumer) -> list[tuple[str, int]]:
        """Deterministic range assignment of the tenant's partitions over
        its LIVE sessions (recomputed on churn — the rebalance)."""
        live = [c.idx for c in self._consumers[tenant] if c.live]
        if consumer.idx not in live:
            return []
        rank = live.index(consumer.idx)
        parts = [(topic, p)
                 for topic in self.model.topics_of_tenant(tenant)
                 for p in range(self.spec.partitions_per_topic)]
        return [tp for i, tp in enumerate(parts)
                if i % len(live) == rank]

    def _apply_churn(self, ev) -> None:
        sessions = self._consumers[ev.tenant]
        if ev.kind == "leave":
            victim = next((c for c in reversed(sessions) if c.live), None)
            if victim is None:
                return
            victim.live = False
            self.trace.emit(self.tick, "consumer_leave", tenant=ev.tenant,
                            consumer=victim.idx)
        else:
            joiner = next((c for c in sessions if not c.live), None)
            if joiner is None:
                return
            joiner.live = True
            self.trace.emit(self.tick, "consumer_join", tenant=ev.tenant,
                            consumer=joiner.idx)
        self.trace.emit(self.tick, "rebalance", tenant=ev.tenant,
                        members=sum(1 for c in sessions if c.live))

    async def _consumer_round(self, t: int) -> None:
        every = self.spec.fetch_every_ticks
        if every <= 0:
            return
        for tenant in range(self.spec.tenants):
            for c in self._consumers[tenant]:
                if not c.live or (t + c.idx) % every:
                    continue
                if self.read_mode == "local":
                    await self._fetch_for(t, c)
                else:
                    self._fetch_tasks.append((c.tenant, asyncio.ensure_future(
                        self._fetch_for(t, c))))
                # Per-session commit cadence (ticks since THIS consumer's
                # last commit): a global t % commit_every gate composed
                # with the staggered fetch gate, and most sessions' two
                # residues never coincided — they silently never committed.
                if (self.spec.commit_every_ticks and t
                        and t - c.last_commit
                        >= self.spec.commit_every_ticks):
                    c.last_commit = t
                    self._commit_offsets(c)

    async def _fetch_for(self, t: int, c: _Consumer) -> None:
        parts = self._assignment(c.tenant, c)
        if not parts:
            return
        span = None
        if self.spans is not None:
            # Read-path span: the fetch never reaches propose(), so the
            # middle rungs collapse and serve carries the whole latency —
            # closing the read path the flight plane never sees.
            span = self.spans.begin(
                "fetch", tenant=TenantModel.tenant_label(c.tenant))
        by_topic: dict[str, list[dict]] = {}
        for topic, p in parts:
            by_topic.setdefault(topic, []).append({
                "partition": p,
                "fetch_offset": c.offsets.get((topic, p), 0),
                "partition_max_bytes": 1 << 22,
            })
        resp = await self.broker.fetch(4, {
            "replica_id": -1, "max_wait_ms": 0, "min_bytes": 0,
            "max_bytes": 1 << 22, "isolation_level": 0,
            "topics": [{"topic": name, "partitions": plist}
                       for name, plist in sorted(by_topic.items())],
        })
        total, n_parts = 0, 0
        for tr in resp["responses"]:
            for pr in tr["partitions"]:
                key = (tr["topic"], pr["partition"])
                if pr["error_code"] == int(ErrorCode.OFFSET_OUT_OF_RANGE):
                    # The partition restarted below us (topic recreated on
                    # a recycled row): auto-reset to earliest.
                    c.offsets[key] = 0
                    continue
                if pr["error_code"] != int(ErrorCode.NONE):
                    continue
                data = pr.get("records")
                if data:
                    total += len(data)
                    n_parts += 1
                    # Advance to what was actually read — a response
                    # truncated by partition_max_bytes covers less than
                    # the high watermark (see _consumed_end).
                    end = _consumed_end(data)
                    c.offsets[key] = (pr["high_watermark"] if end is None
                                      else end)
        if total:
            self.n_fetched_bytes += total
            _m_fetched.inc(total)
            self.trace.emit(t, "fetch", tenant=c.tenant, consumer=c.idx,
                            parts=n_parts, bytes=total)
        if span is not None:
            self.spans.finish(span, status="ok")

    def _commit_offsets(self, c: _Consumer) -> None:
        if not c.offsets:
            return
        by_topic: dict[str, list[dict]] = {}
        for (topic, p), off in sorted(c.offsets.items()):
            by_topic.setdefault(topic, []).append(
                {"partition_index": p, "committed_offset": off,
                 "committed_metadata": None})
        coro = self.broker.offset_commit(1, {
            "group_id": f"cg-{TenantModel.tenant_label(c.tenant)}",
            "generation_id": -1, "member_id": "", "retention_time_ms": -1,
            "topics": [{"name": name, "partitions": plist}
                       for name, plist in sorted(by_topic.items())],
        })
        if self.spans is not None:
            # Consumer-group write path: offset commits replicate through
            # the metadata group, so their spans traverse the full ladder.
            coro = self._spanned(coro, self.spans.begin(
                "offset_commit",
                tenant=TenantModel.tenant_label(c.tenant)))
        task = asyncio.ensure_future(coro)
        self._commit_tasks.append((c.tenant, task))

    async def _spanned(self, coro, span):
        """Run ``coro`` with ``span`` as the task's trace context and
        finish it on completion (idempotent-finish makes the error arm a
        no-op after a clean close)."""
        bind_span(span)
        try:
            r = await coro
            self.spans.finish(span, status="ok")
            return r
        finally:
            self.spans.finish(span, status="error")

    # --------------------------------------------------------- recycling

    def _drain_release_acks(self) -> None:
        for g, inc in self._pending_acks:
            payload = Transition.group_released(g, 1, inc)
            task = asyncio.ensure_future(
                self.broker.client.propose(payload))
            self._ack_tasks.append((g, task))
        self._pending_acks = []

    async def delete_topic(self, name: str, max_ticks: int = 256) -> None:
        """Delete a topic under live traffic and run the recycle barrier
        to completion (rows drained, acked, claimable again)."""
        self.trace.emit(self.tick, "topic_delete", topic=name)
        task = asyncio.ensure_future(self.broker.delete_topics(1, {
            "topic_names": [name], "timeout_ms": 0}))
        for _ in range(max_ticks):
            await self._tick_once()
            if task.done() and not self._ack_tasks \
                    and not self._pending_acks:
                break
        resp = task.result()
        if resp["responses"][0]["error_code"] != ErrorCode.NONE:
            raise RuntimeError(f"delete failed: {resp}")

    async def create_topic(self, name: str, partitions: int,
                           max_ticks: int = 256) -> None:
        """Create one topic mid-run (re-claim path for recycled rows)."""
        self.trace.emit(self.tick, "topic_create", topic=name)
        task = asyncio.ensure_future(self.broker.create_topics(1, {
            "topics": [{"name": name, "num_partitions": partitions,
                        "replication_factor": 1, "assignments": [],
                        "configs": []}],
            "timeout_ms": 0, "validate_only": False,
        }))
        for _ in range(max_ticks):
            await self._tick_once()
            if task.done():
                break
        resp = task.result()
        if resp["topics"][0]["error_code"] != ErrorCode.NONE:
            raise RuntimeError(f"create failed: {resp}")
        groups = [p.group for p in self.store.get_partitions(name)
                  if p.group >= 1]
        for _ in range(max_ticks):
            if all(self.engine.is_leader(g) for g in groups):
                break
            await self._tick_once()
        self.trace.emit(self.tick, "topic_ready", topic=name,
                        groups=len(groups))

    # ---------------------------------------------------- live migration

    def _migration_begin(self, m, p) -> None:
        """Commit-time hook (MigrationBegin applied): freeze the source
        row — the dual-ownership window opens, new proposals on it fail
        with a retryable NotLeader and ride the retry ledger across the
        cutover — then drive fence + handoff ack asynchronously."""
        eng = self.engine
        src, dst = m.src_group, m.dst_group
        if not (0 < src < eng.P and 0 < dst < eng.P):
            return
        for e in self.engines:
            e.freeze_group(src)
        drv = eng.drivers.get(src)
        if drv is not None:
            drv.fsm.on_fence = (
                lambda _bid, m=m, p=p: self._adopt_migration(m, p))
        self._active_migs[(m.topic, m.idx)] = {
            "topic": m.topic, "idx": m.idx, "src": src, "dst": dst,
            "begin_tick": self.tick, "refused": 0,
        }
        self.trace.emit(self.tick, "migration_begin", topic=m.topic,
                        part=m.idx, src=src, dst=dst)
        self._mig_tasks.append((
            f"{m.topic}/{m.idx}",
            asyncio.ensure_future(self._drive_migration(m, p))))

    async def _drive_migration(self, m, p) -> None:
        """The Node ``_drain_migrations`` lane collapsed to the in-process
        case: propose the fence on the frozen source row until its commit
        adopts the target, then ack the handoff until cutover commits."""
        from josefine_tpu_torch.raft.migration import migration_fence

        while True:
            cur = self.store.get_migration(m.topic, m.idx)
            if cur is None or cur.dst_group != m.dst_group:
                return  # resolved under us (cutover or abort)
            adopted = (m.dst_group in self.engine.drivers
                       and int(self.kv.get(b"ginc:%d" % m.dst_group) or -1)
                       == m.inc)
            try:
                if not adopted:
                    await self.broker.client.propose(
                        migration_fence(m.src_group, m.dst_group),
                        group=m.src_group)
                else:
                    await self.broker.client.propose(
                        Transition.migration_ack(m.topic, m.idx,
                                                 m.dst_group, 1))
            except asyncio.CancelledError:
                return
            except Exception:
                await self._settle(1)

    def _adopt_migration(self, m, p) -> None:
        """The handoff, at fence commit on the source row: the seglog
        belongs to the PARTITION and stays put — a header-only export at
        the log end carries position + producer-dedup state into a target
        PartitionFsm over the SAME log; chain/device/term state moves rows
        via migrate_adopt_row on every engine (replicas adopt through a
        snapshot shim: they only persist and ack)."""
        eng = self.engine
        src, dst = m.src_group, m.dst_group
        cur = self.store.get_migration(m.topic, m.idx)
        if cur is None or cur.dst_group != dst:
            return
        if dst in eng.drivers and \
                int(self.kv.get(b"ginc:%d" % dst) or -1) == m.inc:
            return  # duplicate fence: already adopted
        drv = eng.drivers.get(src)
        if drv is None:
            return
        src_fsm = drv.fsm
        record = src_fsm.snapshot()
        export = src_fsm.snapshot_export(
            record, start=src_fsm.snapshot_resume_offset())
        snap_id = src_fsm.applied_id()
        rep = self.broker.replicas.ensure(p)
        # Target position record BEFORE binding over the non-empty shared
        # log (the foreign-log guard wipes otherwise).
        self.kv.put(b"pfsm:%d" % dst, record)
        eng.register_fsm(dst, PartitionFsm(
            self.kv, dst, rep.log, on_append=self.broker.signal_append))
        eng.migrate_adopt_row(dst, snap_id, export, m.inc)
        for peer in self.peers:
            peer.register_fsm(dst, _PeerShimFsm())
            peer.migrate_adopt_row(dst, snap_id, export, m.inc)
        claim = set(range(self.replication))
        for e in self.engines:
            e.set_group_members(dst, claim)
        eng.set_group_tag(dst, TenantModel.tenant_label(
            TenantModel.tenant_of(p.topic)))
        self.kv.put(b"ginc:%d" % dst, b"%d" % m.inc)
        led = self._active_migs.get((m.topic, m.idx))
        if led is not None:
            led["handoff_tick"] = self.tick
        self.trace.emit(self.tick, "migration_handoff", topic=m.topic,
                        part=m.idx, src=src, dst=dst)

    def _migration_cutover(self, m, p) -> None:
        """Commit-time hook (last handoff ack applied): the store now
        points the partition at the target row. Purge the source exactly
        like a recycle on every engine — pending queues, route/ring
        planes, pipelined dispatches die at intake under the bumped
        incarnation — and queue its drain ack."""
        eng = self.engine
        src = m.src_group
        drv = eng.drivers.get(src)
        if drv is not None:
            drv.fsm.on_fence = None
        eng.unregister_fsm(src)
        inc = self.store.group_incarnation(src)
        for e in self.engines:
            e.migrate_purge_source(src, inc)
        self.kv.delete(b"pfsm:%d" % src)
        self.kv.delete(b"pfsm:r:%d" % src)
        self._pending_acks.append((src, inc))
        self._group_heat.pop(src, None)
        led = self._active_migs.pop((m.topic, m.idx), None)
        if led is not None:
            led["cutover_tick"] = self.tick
            led["pause_ticks"] = self.tick - led["begin_tick"]
            led["outcome"] = "cutover"
            self.migrations.append(led)
        self.trace.emit(self.tick, "migration_cutover", topic=m.topic,
                        part=m.idx, src=src, dst=m.dst_group)

    def _migration_abort(self, m, p) -> None:
        """Commit-time hook (MigrationAbort applied): single owner again —
        unfreeze the source, tear the adopted-or-claimed target back down
        and drain it to the pool like a released row."""
        eng = self.engine
        src, dst = m.src_group, m.dst_group
        drv = eng.drivers.get(src)
        if drv is not None:
            drv.fsm.on_fence = None
        for e in self.engines:
            e.unfreeze_group(src)
        if 0 < dst < eng.P:
            for e in self.engines:
                e.unregister_fsm(dst)
                e.set_group_members(dst, set())
                e.recycle_group(dst)
            self.kv.delete(b"pfsm:%d" % dst)
            self.kv.delete(b"pfsm:r:%d" % dst)
            self._pending_acks.append(
                (dst, self.store.group_incarnation(dst)))
        led = self._active_migs.pop((m.topic, m.idx), None)
        if led is not None:
            led["abort_tick"] = self.tick
            led["outcome"] = "aborted"
            self.migrations.append(led)
        self.trace.emit(self.tick, "migration_abort", topic=m.topic,
                        part=m.idx, src=src, dst=dst)

    async def migrate_partition(self, topic: str, idx: int,
                                max_ticks: int = 256) -> dict:
        """Migrate one live partition to a spare row under traffic: run
        the reassignment transition through the metadata FSM and tick the
        handoff to cutover, the target row's election, and the source
        drain. Returns the pause ledger (or outcome=rejected when the FSM
        refused — no spare row / already migrating)."""
        p0 = self.store.get_partition(topic, idx)
        if p0 is None or p0.group < 1:
            raise ValueError(f"{topic}/{idx} has no live group row")
        src = p0.group
        task = asyncio.ensure_future(self.broker.client.propose(
            Transition.migrate_partition(topic, idx)))
        for _ in range(max_ticks):
            await self._tick_once()
            if not task.done():
                continue
            if self.store.get_migration(topic, idx) is not None:
                continue
            p = self.store.get_partition(topic, idx)
            if p is None or p.group == src:
                task.result()
                self.trace.emit(self.tick, "migration_rejected",
                                topic=topic, part=idx, src=src)
                return {"topic": topic, "idx": idx, "src": src,
                        "outcome": "rejected"}
            if (self.engine.is_leader(p.group) and not self._mig_tasks
                    and not self._ack_tasks and not self._pending_acks):
                break
        else:
            raise RuntimeError(
                f"migration of {topic}/{idx} did not settle in "
                f"{max_ticks} ticks")
        task.result()
        for led in reversed(self.migrations):
            if (led["topic"], led["idx"]) == (topic, idx):
                return led
        raise RuntimeError(f"migration of {topic}/{idx} left no ledger")

    async def migrate_hot_tenant(self, max_ticks: int = 256) -> dict:
        """Hot-tenant trigger: migrate the partition behind the hottest
        live row — ranked by commit heat, stamped with the engine's wake
        gauge at trigger time (the active-set scheduler's view of who is
        keeping the device busy)."""
        if not self._group_heat:
            raise RuntimeError("no commit heat yet — run traffic first")
        g = max(sorted(self._group_heat),
                key=lambda k: self._group_heat[k])
        target = None
        for name in self.model.topic_names:
            for p in self.store.get_partitions(name):
                if p.group == g:
                    target = p
                    break
            if target is not None:
                break
        if target is None:
            raise RuntimeError(f"hot row {g} has no live partition")
        self.trace.emit(self.tick, "migrate_hot_trigger", topic=target.topic,
                        part=target.idx, group=g,
                        heat=self._group_heat[g],
                        wake_rows=self.engine._last_wake_rows)
        return await self.migrate_partition(target.topic, target.idx,
                                            max_ticks=max_ticks)

    # ----------------------------------------------------------- summary

    def tenant_latency(self, tenant: int) -> dict:
        return self._run_lat.summary(
            tenant=TenantModel.tenant_label(tenant))

    def summary(self) -> dict:
        """Run-scoped stats: aggregate + busiest-tenant latency quantiles
        (virtual ticks), throughput split by path, backpressure counters,
        the engine's device-tick latency view, and the trace digest."""
        agg = self._run_lat.summary()
        by_count = sorted(
            ((s.count, key) for key, s in self._run_lat.values.items()),
            reverse=True)
        top = {}
        for _, key in by_count[:8]:
            label = dict(key).get("tenant", "?")
            top[label] = self._run_lat.summary(tenant=label)
        return {
            "spec": {
                "tenants": self.spec.tenants,
                "topics": self.spec.total_topics,
                "partitions": self.spec.total_partitions,
                "skew": self.spec.skew,
                "offered_per_tick": self.spec.produce_per_tick,
                "records_per_batch": self.spec.records_per_batch,
                "max_inflight_per_tenant":
                    self.spec.max_inflight_per_tenant,
            },
            "seed": self.seed,
            "ticks": self.tick,
            "replication": self.replication,
            # Serve-path delivery split (replicated mode with a fabric):
            # consensus rows routed device-resident vs host-decoded, and
            # the payload ring's staged/routed/spill counts — how much of
            # the produce path left the host.
            "route_stats": ({
                "routed_msgs": sum(e.routed_msgs for e in self.engines),
                "ring": self.fabric.ring_stats(),
            } if self.fabric is not None else None),
            "latency_ticks": agg,
            "latency_by_tenant_top": top,
            "tenants_with_latency": len(self._run_lat.values),
            "engine_latency_device_ticks": self.engine.commit_latency(),
            "offered": self.n_offered,
            "admitted": self.n_admitted,
            "committed": self.n_committed,
            "path_stats": {"replicated": self.n_replicated,
                           "direct": self.n_direct},
            "backpressure": {
                "backpressured": self.n_backpressured,
                "rejected": self.n_rejected,
                "retries": self.n_retries,
                "shed": self.n_shed,
                "gave_up": self.n_gave_up,
                "errors": self.n_errors,
            },
            "fetched_bytes": self.n_fetched_bytes,
            "read_mode": self.read_mode,
            # Lease-lane epilogue (raft.leases): held rows, renewal credits,
            # queue-overflow refusals — None when leases are off.
            "lease": self.engine.lease_summary(),
            "offset_commits": self.n_offset_commits,
            "recycle_acks": self.n_recycle_acks,
            # Live migrations resolved this run: pause (begin -> cutover,
            # virtual ticks) and refused (dual-ownership NotLeader
            # rejections rerouted by the retry ledger) per migration.
            "migrations": self.migrations,
            "trace_events": len(self.trace.events),
            "trace_sha256": self.trace.sha256(),
            # Request-span epilogue (raft.request_spans): request counts,
            # sampling stats, and the aggregate where-did-the-ticks-go
            # split; the full per-tenant table rides the --spans-out
            # artifact (tools/traffic_soak.py), not every bench row.
            "span_summary": (self.spans.summary()
                             if self.spans is not None else None),
            # Health-plane epilogue (health=True): worst level + first
            # degraded/critical tick per detector, and the transition
            # journal — None when the plane is off.
            "health": ({"verdicts": self.health.verdicts(),
                        "events": self.health.events()}
                       if self.health is not None else None),
        }
