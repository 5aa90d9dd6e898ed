"""Node composition: wire store -> broker task -> raft task and join.

Parity: reference ``run()`` in ``src/lib.rs:31-56`` — one embedded store
(sled there, sqlite KV here) shared by the Raft chain and the broker
metadata store, one broker task, one raft task, joined until shutdown.

Addition over the reference: the node registers itself in the replicated
broker registry at startup (EnsureBroker through Raft), which the reference
defines a transition for but never invokes — its Metadata handler can only
see brokers that were registered by hand.
"""

from __future__ import annotations

import asyncio

from josefine_tpu_torch.broker.fsm import JosefineFsm, Transition
from josefine_tpu_torch.broker.partition_fsm import PartitionFsm
from josefine_tpu_torch.broker.server import JosefineBroker
from josefine_tpu_torch.broker.state import Broker as BrokerInfo
from josefine_tpu_torch.broker.state import Store
from josefine_tpu_torch.config import JosefineConfig
from josefine_tpu_torch.raft.client import RaftClient
from josefine_tpu_torch.raft.server import JosefineRaft, ProposalTimeout
from josefine_tpu_torch.utils.kv import open_kv
from josefine_tpu_torch.utils.shutdown import Shutdown
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("node")


class Node:
    """One full node: raft runtime + broker + shared durable store."""

    def __init__(self, config: JosefineConfig, shutdown: Shutdown | None = None,
                 in_memory: bool = False, pacer=None,
                 raft_sock=None, broker_sock=None,
                 intercept_send=None, intercept_recv=None,
                 conn_shim=None):
        config.validate()
        self.config = config
        # Pre-bound listening sockets (harnesses bind port 0 up front and
        # keep them open — no pick-then-rebind race) and chaos seams: raft
        # transport interceptors (FaultPlane) + broker connection shim
        # (WirePlane).
        self._broker_sock = broker_sock
        self.shutdown = shutdown or Shutdown()
        self.kv = open_kv(None if in_memory else config.broker.state_file,
                          full_sync=config.broker.durability == "power")
        self.store = Store(self.kv)
        # group_pool = engine.partitions: row 0 is the metadata group; rows
        # [1, P) are claimable by topic partitions (one consensus group per
        # partition — the P axis of the device state tensor).
        self.fsm = JosefineFsm(self.store, group_pool=config.engine.partitions)
        mesh = None
        if config.engine.mesh_shards:
            # Shard the consensus-group axis over local devices (pure data
            # parallelism — groups are independent; see RaftEngine mesh):
            # distinct cards, or shards of the host where the engine runs on
            # the CPU.
            import torch

            from josefine_tpu_torch.parallel.sharded import make_mesh

            k = config.engine.mesh_shards
            if config.engine.device == "cpu":
                devs = [torch.device("cpu")] * k
            else:
                devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if len(devs) < k:
                raise ValueError(
                    f"engine.mesh_shards={k} but only {len(devs)} devices")
            mesh = make_mesh(k, devices=devs)
        self.raft = JosefineRaft(
            config.raft,
            self.kv,
            fsms={0: self.fsm},
            groups=config.engine.partitions,
            shutdown=self.shutdown.clone(),
            backend=config.engine.backend,
            # The engine's state lives on the configured device: the card
            # unless the config says "cpu" (no card: it raises).
            device=config.engine.device,
            mesh=mesh,
            # Tick source passthrough: wall clock by default; harnesses
            # inject a LockstepPacer (raft/pacer.py) to drive the whole
            # product node on a virtual clock.
            pacer=pacer,
            intercept_send=intercept_send,
            intercept_recv=intercept_recv,
            sock=raft_sock,
        )
        self.client = RaftClient(self.raft)
        # Request-scoped spans (raft.request_spans): one recorder per
        # node, ticking on the engine's own tick axis; the broker mints a
        # trace context at each frame decode and the engine stamps the
        # consensus rungs (utils/spans.py).
        self.spans = None
        if config.raft.request_spans:
            from josefine_tpu_torch.utils.spans import SpanRecorder

            self.spans = SpanRecorder(
                clock=self.raft.engine._flight_tick)
        self.broker = JosefineBroker(
            config.broker,
            self.store,
            self.client,
            shutdown=self.shutdown.clone(),
            # Controller identity AND consumer-group coordinator anchor
            # (Broker.coordinator_for): the metadata group's Raft leader.
            leader_hint=lambda: self.raft.engine.leader_id(0),
            is_controller=lambda: self.raft.engine.is_leader(0),
            conn_shim=conn_shim,
            # Connection-plane events (slow-client evictions) land in the
            # node's consensus flight journal, tick-stamped like every
            # other recorded event, so /events and merged timelines see
            # them.
            flight_hook=self._conn_flight_event,
            span_recorder=self.spans,
        )
        # WARNING+ josefine log records also journal as tick-stamped
        # log_event flight entries (utils/tracing.attach_flight_journal),
        # so merged timelines capture broker-side errors; detached at
        # stop().
        from josefine_tpu_torch.utils.tracing import attach_flight_journal

        self._flight_log_handler = attach_flight_journal(
            self.raft.engine.flight.emit, self.raft.engine._flight_tick)
        # Health plane (raft.health): feed the engine-owned monitor the
        # broker's backpressure tally — merged into every per-tick sample
        # so the backpressure_sat detector sees produce-plane saturation
        # alongside the consensus-plane signals.
        if self.raft.engine.health is not None:
            self.raft.engine.health.extra_fn = self.broker.health_counters
        # Committed DeleteTopic reaches every node through the FSM; each
        # drops its own on-disk replica logs. Deregistration is synchronous
        # (later requests must see the topic gone); the rmtree runs in an
        # executor so FSM apply never stalls the raft event loop.
        self.fsm.on_delete_topic = self._drop_topic_local
        # P-axis wiring (deliberately attached AFTER engine construction so
        # the engine's own group-0 restart replay cannot fire them): when an
        # EnsurePartition with a consensus group commits, every node claims
        # the group row's member columns, and nodes hosting a replica attach
        # the data-plane PartitionFsm. Startup re-wires from the store scan.
        self.fsm.on_partition_assigned = self._wire_partition
        self.fsm.on_partition_released = self._release_partition
        # Membership changes prune row-drain entries pinned to removed
        # brokers (a removed broker can never ack its drain; the row would
        # otherwise be wedged out of the claimable pool forever).
        self.raft.engine.on_conf_applied = self._on_conf_applied
        # Released-row ack lane (consensus-group recycling): after resetting
        # local state for a released row, the broker proposes GroupReleased
        # through Raft; the row re-enters the claimable pool once every
        # replica host's ack commits.
        self._pending_acks: list[int] = []
        self._ack_task: asyncio.Task | None = None
        # Live migration (Kafka-style reassignment through the metadata
        # FSM): begin freezes the source row and arms the fence; the fence
        # commit hands the carried prefix to the target row; the last
        # host ack cuts over (source purged + drained back to the pool).
        self.fsm.on_migration_begin = self._migration_begin
        self.fsm.on_migration_cutover = self._migration_cutover
        self.fsm.on_migration_abort = self._migration_abort
        self._mig_fences: list = []   # migrations whose fence we drive
        self._mig_acks: list = []     # migrations whose handoff we must ack
        self._mig_task: asyncio.Task | None = None
        self._rewire_partitions()
        self._register_task: asyncio.Task | None = None
        # Observability endpoint (TPU-build addition; the reference's only
        # runtime introspection is a debug file rewritten every tick).
        self.metrics_server = None
        if config.broker.metrics_port:
            from josefine_tpu_torch.utils.metrics import MetricsServer

            # Scope by the RAFT id: every node-labelled metric series
            # (engine/tcp) is labelled with engine.self_id == raft.id;
            # broker.id may legally differ at partitions=1.
            self.metrics_server = MetricsServer(
                config.broker.ip, config.broker.metrics_port,
                state_fn=lambda: self.raft.engine.debug_state(),
                node=config.raft.id,
                # /events: this node's consensus flight-recorder journal
                # (node-scoped by construction — each endpoint serves its
                # own engine's ring).
                events_fn=lambda: self.raft.engine.flight.events(),
                # /traces: retained request span trees (empty route when
                # raft.request_spans is off).
                traces_fn=(self.spans.traces if self.spans is not None
                           else None),
                # /health: current detector levels + verdicts + the
                # health_* transition journal (null when raft.health is
                # off — the route says the plane is dark rather than
                # faking "all ok").
                health_fn=(self.raft.engine.health.snapshot
                           if self.raft.engine.health is not None
                           else None),
            )

    def _conn_flight_event(self, kind: str, detail: dict) -> None:
        eng = self.raft.engine
        eng.flight.emit(eng._ticks, kind, **detail)

    def _rewire_partitions(self) -> None:
        """Restart path: rebuild every partition's consensus-group wiring
        from the replicated store — claim member columns for live groups,
        idle every unclaimed row (no elections on unused device rows), and
        re-attach data-plane FSMs for locally hosted replicas (their
        registration replays any committed-but-unapplied suffix)."""
        eng = self.raft.engine
        claims: dict[int, set[int]] = {}
        hosted: list = []
        for p in self.store.get_all_partitions():
            if p.group < 1 or p.group >= eng.P:
                continue
            slots = {eng.members.slot_of(b) for b in p.assigned_replicas}
            slots.discard(None)
            claims[p.group] = slots
            if self.config.broker.id in p.assigned_replicas:
                hosted.append(p)
        eng.configure_groups(claims)
        for g in claims:
            self._sync_group_incarnation(g)
        for p in hosted:
            rep = self.broker.broker.replicas.ensure(p)
            eng.register_fsm(p.group, PartitionFsm(
                self.kv, p.group, rep.log,
                on_append=self.broker.broker.signal_append,
                fsync=self.config.broker.durability == "power"))
        # Rows released while we were down (the drain entry still lists us):
        # reset the leftover local state and ack so the row can be reused.
        for g in self.store.groups_pending_release(self.config.broker.id):
            if 0 < g < eng.P:
                self._reset_released_row(g)
        # Drains pinned to brokers that left the cluster while we were down
        # (their conf-REMOVE prune may predate our durable state).
        self.store.prune_drains(
            m.node_id for m in eng.members.by_id.values() if m.active)
        # Migrations still in flight while we were down roll FORWARD: the
        # begin hook is idempotent (re-freeze, re-arm the fence, re-attach
        # an already-adopted target row and re-ack). A fence that committed
        # before the crash but whose adoption did not is re-proposed — the
        # duplicate fence is a no-op on the source FSM and its apply
        # re-fires the adoption at the same carried prefix.
        for m in self.store.get_migrations():
            p = self.store.get_partition(m.topic, m.idx)
            if p is not None:
                self._migration_begin(m, p)

    def _on_conf_applied(self, change) -> None:
        from josefine_tpu_torch.raft.membership import REMOVE

        if change.op == REMOVE:
            freed = self.store.prune_drains(
                m.node_id for m in self.raft.engine.members.by_id.values()
                if m.active)
            if freed:
                log.info("membership remove freed wedged drain rows %s", freed)

    def _sync_group_incarnation(self, g: int) -> None:
        """Align local row state with the store's incarnation for row g:
        a mismatch means the row was recycled (or first claimed) and any
        local leftovers belong to its previous life — reset them before
        serving. Idempotent; a match is a no-op beyond stamping the engine
        (live rows must never be wiped by a re-fired hook)."""
        eng = self.raft.engine
        inc = self.store.group_incarnation(g)
        key = b"ginc:%d" % g
        local = int(self.kv.get(key) or 0)
        if local != inc:
            self._wipe_local_row(g)
            self.kv.put(key, b"%d" % inc)
        eng.set_group_incarnation(g, inc)

    def _wipe_local_row(self, g: int) -> None:
        """THE local-row reset (incarnation sync and release share it so
        the recycle barrier can never diverge from the sync path)."""
        self.raft.engine.recycle_group(g)
        self.kv.delete(b"pfsm:%d" % g)
        self.kv.delete(b"pfsm:r:%d" % g)

    def _wire_partition(self, p) -> None:
        """Commit-time hook: an EnsurePartition with a group claim applied.
        Idempotent (snapshot restore re-fires it for every partition)."""
        eng = self.raft.engine
        if p.group < 1 or p.group >= eng.P:
            return
        self._sync_group_incarnation(p.group)
        slots = {eng.members.slot_of(b) for b in p.assigned_replicas}
        slots.discard(None)
        eng.set_group_members(p.group, slots)
        if self.config.broker.id in p.assigned_replicas:
            rep = self.broker.broker.replicas.ensure(p)
            if p.group not in eng.drivers:
                eng.register_fsm(p.group, PartitionFsm(
                    self.kv, p.group, rep.log,
                    on_append=self.broker.broker.signal_append,
                    fsync=self.config.broker.durability == "power"))

    def _release_partition(self, p) -> None:
        """Commit-time hook: the partition's topic was deleted — idle the
        group row, and (replica hosts only) reset local row state and ack
        through Raft so the row can be recycled once every host has."""
        eng = self.raft.engine
        if p.group < 1 or p.group >= eng.P:
            return
        eng.unregister_fsm(p.group)
        eng.set_group_members(p.group, set())
        if self.config.broker.id in p.assigned_replicas:
            self._reset_released_row(p.group)

    def _reset_released_row(self, g: int) -> None:
        self._wipe_local_row(g)
        self.kv.delete(b"ginc:%d" % g)
        if g not in self._pending_acks:
            self._pending_acks.append(g)
        self._kick_acks()

    def _kick_acks(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # constructed outside the loop: start() kicks
        if self._ack_task is None or self._ack_task.done():
            self._ack_task = loop.create_task(self._drain_acks())

    async def _drain_acks(self) -> None:
        while self._pending_acks and not self.shutdown.is_shutdown:
            g = self._pending_acks[0]
            # Pin the ack to the drained incarnation: the barrier guarantees
            # the row cannot be re-claimed before our ack commits, so the
            # store still reports the released claim's incarnation here; a
            # straggler duplicate from this cycle can then never satisfy a
            # LATER drain of the same row.
            payload = Transition.group_released(
                g, self.config.broker.id, self.store.group_incarnation(g))
            try:
                await self.client.propose(payload, timeout=5.0)
                self._pending_acks.pop(0)
                log.info("released consensus row %d acked", g)
            except asyncio.CancelledError:
                return
            except (ProposalTimeout, asyncio.TimeoutError):
                continue
            except Exception:
                log.exception("release ack for row %d failed; retrying", g)
                await asyncio.sleep(0.5)

    # ------------------------------------------------------ live migration

    def _hosts_partition(self, p) -> bool:
        return self.config.broker.id in p.assigned_replicas

    def _replica_slots(self, p) -> set[int]:
        eng = self.raft.engine
        slots = {eng.members.slot_of(b) for b in p.assigned_replicas}
        slots.discard(None)
        return slots

    def _migration_begin(self, m, p) -> None:
        """Commit-time hook (MigrationBegin applied) and restart re-arm:
        freeze the source row (new proposals fail with retryable NotLeader
        — the dual-ownership window), wire the fence trigger on the local
        source FSM, and start driving the fence proposal. Idempotent."""
        eng = self.raft.engine
        src, dst = m.src_group, m.dst_group
        if not (0 < src < eng.P and 0 < dst < eng.P):
            return
        eng.freeze_group(src)
        if self._hosts_partition(p):
            drv = eng.drivers.get(src)
            if drv is not None:
                drv.fsm.on_fence = (
                    lambda _bid, m=m, p=p: self._adopt_migration(m, p))
            if int(self.kv.get(b"ginc:%d" % dst) or -1) == m.inc:
                # Crash after handoff, before cutover: the adoption is
                # durable (target chain + position record) — re-attach
                # the target FSM and re-ack.
                self._reattach_dst(m, p)
            elif m not in self._mig_fences:
                self._mig_fences.append(m)
                self._kick_migs()

    def _adopt_migration(self, m, p) -> None:
        """The handoff, fired at fence commit on the source row: move the
        partition's consensus state into the target row. The seglog
        belongs to the PARTITION and stays in place — a header-only export
        at the log end adopts position + producer-dedup state without
        rewriting a byte of log; only chain/device/term state moves rows
        (migrate_adopt_row). Runs inside commit-apply like the release
        hooks (the established cross-row mutation point)."""
        from josefine_tpu_torch.broker.state import Migration  # noqa: F401

        eng = self.raft.engine
        src, dst = m.src_group, m.dst_group
        cur = self.store.get_migration(m.topic, m.idx)
        if cur is None or cur.dst_group != dst:
            return  # resolved (cutover/abort) while the fence was in flight
        if int(self.kv.get(b"ginc:%d" % dst) or -1) == m.inc \
                and dst in eng.drivers:
            return  # duplicate fence: already adopted
        drv = eng.drivers.get(src)
        if drv is None:
            return
        src_fsm = drv.fsm
        record = src_fsm.snapshot()
        export = src_fsm.snapshot_export(
            record, start=src_fsm.snapshot_resume_offset())
        rep = self.broker.broker.replicas.ensure(p)
        # The target position record must exist BEFORE binding a
        # PartitionFsm over the (non-empty) shared log — the foreign-log
        # guard would wipe it otherwise.
        self.kv.put(b"pfsm:%d" % dst, record)
        dst_fsm = PartitionFsm(
            self.kv, dst, rep.log,
            on_append=self.broker.broker.signal_append,
            fsync=self.config.broker.durability == "power")
        eng.register_fsm(dst, dst_fsm)
        eng.migrate_adopt_row(dst, src_fsm.applied_id(), export, m.inc)
        # Adoption reverts the row to full membership; restrict it to the
        # partition's replica hosts so quorum is over the hosts that ack.
        eng.set_group_members(dst, self._replica_slots(p))
        self.kv.put(b"ginc:%d" % dst, b"%d" % m.inc)
        if m not in self._mig_acks:
            self._mig_acks.append(m)
        self._kick_migs()

    def _reattach_dst(self, m, p) -> None:
        """Restart path for a host that adopted before crashing: re-bind
        the target FSM over the shared log (register replays the durable
        chain's committed suffix exactly) and re-propose the ack."""
        eng = self.raft.engine
        dst = m.dst_group
        if dst not in eng.drivers:
            rep = self.broker.broker.replicas.ensure(p)
            eng.register_fsm(dst, PartitionFsm(
                self.kv, dst, rep.log,
                on_append=self.broker.broker.signal_append,
                fsync=self.config.broker.durability == "power"))
        eng.set_group_members(dst, self._replica_slots(p))
        eng.set_group_incarnation(dst, m.inc)
        if m not in self._mig_acks:
            self._mig_acks.append(m)
        self._kick_migs()

    def _migration_cutover(self, m, p) -> None:
        """Commit-time hook (last handoff ack applied): the partition now
        points at the target row. Purge the source exactly like a recycle
        (pending queues, route/ring planes, pipelined dispatches — the
        dead owner's in-flight traffic dies at intake), queue the drain
        ack, and re-wire the partition at its new row."""
        eng = self.raft.engine
        src = m.src_group
        self._mig_fences = [f for f in self._mig_fences
                            if f.dst_group != m.dst_group]
        if 0 < src < eng.P:
            drv = eng.drivers.get(src)
            if drv is not None:
                drv.fsm.on_fence = None
            eng.unregister_fsm(src)
            eng.migrate_purge_source(src, self.store.group_incarnation(src))
            if self._hosts_partition(p):
                self.kv.delete(b"pfsm:%d" % src)
                self.kv.delete(b"pfsm:r:%d" % src)
                self.kv.delete(b"ginc:%d" % src)
                if src not in self._pending_acks:
                    self._pending_acks.append(src)
                self._kick_acks()
        self._wire_partition(p)

    def _migration_abort(self, m, p) -> None:
        """Commit-time hook (MigrationAbort applied): the source row is
        the single owner again; the claimed target row drains back to the
        pool (hosts that already adopted reset it like a released row)."""
        eng = self.raft.engine
        src, dst = m.src_group, m.dst_group
        self._mig_fences = [f for f in self._mig_fences if f.dst_group != dst]
        self._mig_acks = [a for a in self._mig_acks if a.dst_group != dst]
        if 0 < src < eng.P:
            drv = eng.drivers.get(src)
            if drv is not None:
                drv.fsm.on_fence = None
            eng.unfreeze_group(src)
        if 0 < dst < eng.P and self._hosts_partition(p):
            eng.unregister_fsm(dst)
            eng.set_group_members(dst, set())
            self._reset_released_row(dst)

    def _kick_migs(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # constructed outside the loop: start() kicks
        if self._mig_task is None or self._mig_task.done():
            if self._mig_fences or self._mig_acks:
                self._mig_task = loop.create_task(self._drain_migrations())

    async def _drain_migrations(self) -> None:
        """Migration proposal lane (the _drain_acks pattern): handoff acks
        first (they resolve migrations), then fence proposals for
        migrations still waiting on their handoff point. Entries retire
        when the replicated record shows them done or superseded."""
        from josefine_tpu_torch.raft.migration import migration_fence

        while ((self._mig_fences or self._mig_acks)
               and not self.shutdown.is_shutdown):
            for m in list(self._mig_acks):
                cur = self.store.get_migration(m.topic, m.idx)
                if (cur is None or cur.dst_group != m.dst_group
                        or self.config.broker.id in cur.acks):
                    if m in self._mig_acks:
                        self._mig_acks.remove(m)
                    continue
                payload = Transition.migration_ack(
                    m.topic, m.idx, m.dst_group, self.config.broker.id)
                try:
                    await self.client.propose(payload, timeout=5.0)
                    if m in self._mig_acks:
                        self._mig_acks.remove(m)
                except asyncio.CancelledError:
                    return
                except Exception:  # noqa: BLE001 - retried below
                    pass
            for m in list(self._mig_fences):
                cur = self.store.get_migration(m.topic, m.idx)
                adopted = (int(self.kv.get(b"ginc:%d" % m.dst_group) or -1)
                           == m.inc)
                if cur is None or cur.dst_group != m.dst_group or adopted:
                    if m in self._mig_fences:
                        self._mig_fences.remove(m)
                    continue
                payload = migration_fence(m.src_group, m.dst_group)
                try:
                    await self.client.propose(payload, group=m.src_group,
                                              timeout=5.0)
                except asyncio.CancelledError:
                    return
                except Exception:  # noqa: BLE001 - retried below
                    pass
            if self._mig_fences or self._mig_acks:
                await asyncio.sleep(0.5)

    def _drop_topic_local(self, name: str) -> None:
        replicas = self.broker.broker.replicas
        dirs = replicas.release_topic(name)
        if not dirs:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            replicas.purge_dirs(dirs)
            return
        loop.run_in_executor(None, replicas.purge_dirs, dirs)

    async def start(self) -> None:
        await self.raft.start()
        await self.broker.start(sock=self._broker_sock)
        if self.metrics_server is not None:
            await self.metrics_server.start()
        self._register_task = asyncio.create_task(self._register_self())
        self._kick_acks()
        self._kick_migs()

    async def _register_self(self) -> None:
        """Propose EnsureBroker(self) until the cluster has a leader."""
        b = BrokerInfo(id=self.config.broker.id, ip=self.config.broker.ip,
                       port=self.config.broker.port)
        payload = Transition.ensure_broker(b)
        while not self.shutdown.is_shutdown:
            try:
                await self.client.propose(payload, timeout=5.0)
                log.info("broker %d registered in cluster metadata", b.id)
                return
            except (ProposalTimeout, asyncio.TimeoutError):
                continue
            except asyncio.CancelledError:
                return
            except Exception:
                log.exception("broker self-registration failed; retrying")
                await asyncio.sleep(0.5)

    async def run(self) -> None:
        """Start and block until shutdown (reference lib.rs try_join!)."""
        await self.start()
        try:
            await self.shutdown.wait()
        finally:
            await self.stop()

    async def stop(self) -> None:
        self.shutdown.shutdown()
        if self._register_task:
            self._register_task.cancel()
            await asyncio.gather(self._register_task, return_exceptions=True)
        if self._ack_task:
            self._ack_task.cancel()
            await asyncio.gather(self._ack_task, return_exceptions=True)
        if self._mig_task:
            self._mig_task.cancel()
            await asyncio.gather(self._mig_task, return_exceptions=True)
        # Raft first: broker.stop() closes the replica logs, and the engine
        # must not tick or receive (commit-apply, snapshot restore) after
        # that — a restore interrupted by a closed log orphans its intent
        # marker and forces a replica reset at next boot (the round-2
        # acked-loss trigger, tests/test_reset_safety.py).
        await self.raft.stop()
        await self.broker.stop()
        if self.metrics_server is not None:
            await self.metrics_server.stop()
        from josefine_tpu_torch.utils.tracing import detach_flight_journal

        detach_flight_journal(self._flight_log_handler)
        self.kv.close()


async def run_node(config: JosefineConfig, shutdown: Shutdown | None = None) -> None:
    """Run one full node (raft + broker) until shutdown."""
    await Node(config, shutdown).run()
