"""Wire chaos soak: nemesis schedules against REAL Kafka connections.

``run_soak`` (chaos/soak.py) drives the in-process consensus harness;
this module is its twin for the layer real clients touch. A
:func:`run_wire_soak` boots N full product nodes (raft + broker + Kafka
TCP surface) on a :class:`~josefine_tpu.raft.pacer.LockstepPacer` virtual
clock, fronts them with the :class:`~josefine_tpu.workload.wire.WireDriver`
whose sockets (and the brokers' accepted pairs) are wrapped by a
:class:`~josefine_tpu.chaos.wire.WirePlane`, and replays a nemesis
schedule that may stack BOTH planes: raft-link partitions/isolates (via
the fault plane's transport interceptors) and socket fates
(``conn_reset`` / ``conn_stall`` / ``torn_frames`` / ``accept_refuse``).

One virtual clock runs everything: each tick advances the fault plane
(wire windows open/close), applies due nemesis steps, and grants every
node exactly one consensus tick (lockstep + settle). The driver's
deadlines and backoffs are tick-denominated through a clock that advances
that same axis while a request is in flight — so elections, retries, and
fate firings are functions of protocol time, and a same-seed run replays
its fate sequence, wire event log, and per-connection journals
byte-identically (pinned by tests/test_wire_chaos.py, same discipline as
test_chaos_determinism.py).

Wire-level invariants enforced on every run:

* **acked-produce durability across reconnects** — after heal, every
  payload the driver was ACKED for must come back from a fetch of its
  partition (the driver's ground-truth verification);
* **consumer-group reconvergence** — every tenant's group must complete
  join → sync → fetch → commit end to end after heal (members share one
  connection: the old serialization-deadlock rule is gone);
* **commitless-window liveness** (optional) — if no produce is acked for
  more than ``commitless_limit`` consecutive ticks during chaos, the run
  is a violation (the wire twin of the in-process availability probe).

Any violation auto-dumps a JSON artifact (wire event log + journals +
schedule) like the in-process soak. The result dict carries a wire-class
coverage map (``CoverageMap.from_wire_events``) so ``chaos_search`` can
mutate and score wire schedules exactly like in-process ones.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import tempfile

from josefine_tpu_torch.chaos.faults import FaultPlane, NetFaults
from josefine_tpu_torch.chaos.invariants import InvariantViolation
from josefine_tpu_torch.chaos.nemesis import WIRE_SCHEDULES, Nemesis, Schedule
from josefine_tpu_torch.chaos.wire import NodeShim, WirePlane
from josefine_tpu_torch.models.types import resolve_device
from josefine_tpu_torch.utils.coverage import CoverageMap
from josefine_tpu_torch.utils.net import bound_sockets
from josefine_tpu_torch.utils.tracing import get_logger
from josefine_tpu_torch.workload.model import WorkloadSpec

log = get_logger("chaos.wire_soak")


def resolve_wire_schedule(name_or_schedule, n_nodes: int = 1) -> Schedule:
    """A Schedule passes through; a bundled wire name builds one; JSON
    text parses the DSL — always validated against the cluster size."""
    if isinstance(name_or_schedule, Schedule):
        return name_or_schedule.validate(n_nodes)
    if name_or_schedule in WIRE_SCHEDULES:
        return WIRE_SCHEDULES[name_or_schedule](n_nodes)
    return Schedule.from_json(name_or_schedule).validate(n_nodes)


class LockstepRequestClock:
    """The wire driver's time source inside the soak: sleeps and request
    deadlines advance the SHARED virtual clock (fault plane + nemesis +
    every node's consensus tick) instead of the wall clock, so a request
    waiting out a leader election is what drives the election forward.

    ``_advance`` is swappable: the soak's setup phase (registration,
    create_topics, first metadata) runs on a pacer-only advance so the
    schedule's chaotic window opens against a converged cluster at plane
    tick 0 — none of the horizon is spent on boot."""

    def __init__(self, advance):
        self._advance = advance

    async def sleep_ticks(self, ticks: int) -> None:
        for _ in range(max(0, int(ticks))):
            await self._advance()

    async def call(self, coro, deadline_ticks: int):
        task = asyncio.ensure_future(coro)
        try:
            for _ in range(max(1, int(deadline_ticks))):
                if task.done():
                    break
                await self._advance()
            if not task.done():
                await asyncio.sleep(0)
        except BaseException:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            raise
        if not task.done():
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            raise asyncio.TimeoutError(
                f"request deadline ({deadline_ticks} ticks)")
        return task.result()


class WireCluster:
    """N full nodes over real sockets, chaos-wired: raft transports carry
    the fault plane's interceptors, broker servers carry the wire plane's
    connection shim, ticks come from a lockstep pacer."""

    def __init__(self, n_nodes: int, partitions: int, tmpdir: str,
                 plane: FaultPlane, pacer, tick_ms: int = 20,
                 request_spans: bool = False, leases: bool = False,
                 broker_overrides: dict | None = None, device="cuda"):
        from josefine_tpu_torch.config import (
            BrokerConfig,
            EngineConfig,
            JosefineConfig,
            NodeAddr,
            RaftConfig,
        )
        from josefine_tpu_torch.node import Node

        raft_socks, raft_ports = bound_sockets(n_nodes)
        broker_socks, self.broker_ports = bound_sockets(n_nodes)
        self.plane = plane
        self.nodes = []
        # The lease lane requires election_timeout_min > heartbeat + 2
        # ticks (RaftConfig.validate's non-overlap arithmetic); the soak's
        # seed timing (3 ticks min over a 1-tick heartbeat) sits exactly
        # on that boundary, so lease-enabled clusters (the wire load rig's
        # read_mode axis) stretch the election window. Non-lease clusters
        # keep the seed timing — the wire chaos smoke's fate sequences are
        # functions of it.
        et_min = 6 * tick_ms if leases else 3 * tick_ms
        et_max = 12 * tick_ms if leases else 8 * tick_ms
        for i in range(n_nodes):
            node_id = i + 1
            peers = [NodeAddr(id=j + 1, ip="127.0.0.1", port=raft_ports[j])
                     for j in range(n_nodes) if j != i]
            cfg = JosefineConfig(
                raft=RaftConfig(id=node_id, ip="127.0.0.1",
                                port=raft_ports[i], nodes=peers,
                                tick_ms=tick_ms,
                                heartbeat_timeout_ms=tick_ms,
                                election_timeout_min_ms=et_min,
                                election_timeout_max_ms=et_max,
                                leases=leases,
                                # Wire-path request spans: each broker
                                # mints a trace context per decoded frame
                                # (utils/spans.py, Node wiring).
                                request_spans=request_spans,
                                data_directory=os.path.join(
                                    tmpdir, f"node-{node_id}/raft")),
                broker=BrokerConfig(id=node_id, ip="127.0.0.1",
                                    port=self.broker_ports[i],
                                    state_file=os.path.join(
                                        tmpdir, f"node-{node_id}/state.db"),
                                    data_directory=os.path.join(
                                        tmpdir, f"node-{node_id}/data"),
                                    **(broker_overrides or {})),
                engine=EngineConfig(partitions=partitions, device=device),
            )
            self.nodes.append(Node(
                cfg, in_memory=True, pacer=pacer,
                raft_sock=raft_socks[i], broker_sock=broker_socks[i],
                intercept_send=plane.transport_send_interceptor(i),
                intercept_recv=plane.transport_recv_interceptor(i),
                conn_shim=NodeShim(plane.wire, node_id),
            ))

    async def start(self) -> None:
        for n in self.nodes:
            await n.start()
        # Full-mesh gate before any tick is granted. NOT a correctness
        # crutch (the windowed nack-repair wedge is fixed — a lost first
        # block replication repairs through the NACK path, pinned by
        # tests/test_raft_server.py): it exists so the soak's reported
        # fault history is a pure function of the schedule + seed. Startup
        # dials race the wall clock, and traffic lost to a dial still in
        # its reconnect backoff would vary run to run, breaking the
        # byte-identical event-log contract the wire smoke cmp's.
        if len(self.nodes) > 1:
            deadline = asyncio.get_event_loop().time() + 10.0
            ids = {n.config.raft.id for n in self.nodes}
            while asyncio.get_event_loop().time() < deadline:
                if all(n.raft.transport.connected >= (ids - {n.config.raft.id})
                       for n in self.nodes):
                    return
                await asyncio.sleep(0.02)
            raise TimeoutError(
                "wire soak transport mesh never fully connected; an "
                "un-meshed run would mis-report mesh failures as "
                "invariant violations")

    async def stop(self) -> None:
        await asyncio.gather(*(n.stop() for n in self.nodes),
                             return_exceptions=True)

    # ------------------------------------------------- nemesis resolution

    def live_nodes(self) -> list[int]:
        return [i for i in range(len(self.nodes))
                if not self.plane.is_down(i)]

    def leader_node(self, group: int = 0) -> int | None:
        for i in self.live_nodes():
            if self.nodes[i].raft.engine.is_leader(group):
                return i
        return None

    def registered(self) -> bool:
        n = len(self.nodes)
        return all(len(node.store.get_brokers()) >= n for node in self.nodes)


async def run_wire_soak_async(seed: int, schedule, n_nodes: int = 1,
                              tenants: int = 2,
                              partitions_per_topic: int = 1,
                              consumers_per_tenant: int = 2,
                              produce_every: int = 4,
                              commitless_limit: int | None = None,
                              tick_ms: int = 20,
                              settle_s: float = 0.015,
                              request_ticks: int = 30,
                              join_ticks: int = 120,
                              artifact_path: str | None = None,
                              request_spans: bool = False,
                              health: bool = True,
                              device="cuda") -> dict:
    """One wire chaos soak (see module docstring). Produces one offered
    batch every ``produce_every`` virtual ticks across the schedule's
    horizon, heals, then runs the full consumer-group verification."""
    from josefine_tpu_torch.raft.pacer import LockstepPacer
    from josefine_tpu_torch.workload.wire import WireDriver

    resolve_device(device)  # no card: raise before any socket or directory
    sched = resolve_wire_schedule(schedule, n_nodes)
    plane = FaultPlane(seed, n_nodes, net=NetFaults.quiet())
    plane.wire = WirePlane(seed)
    pacer = LockstepPacer(settle_s=settle_s)
    spec = WorkloadSpec(tenants=tenants,
                        partitions_per_topic=partitions_per_topic,
                        consumers_per_tenant=consumers_per_tenant,
                        produce_per_tick=1.0, payload_bytes=40,
                        records_per_batch=2).validate()
    # Engine rows: metadata group 0 + one consensus group per partition.
    partitions = 1 + spec.total_partitions
    tmpdir = tempfile.mkdtemp(prefix="wire_soak_")
    cluster = WireCluster(n_nodes, partitions, tmpdir, plane, pacer,
                          tick_ms=tick_ms, request_spans=request_spans,
                          device=device)
    nemesis = Nemesis(sched, plane, cluster)

    async def advance() -> None:
        plane.advance(1)
        nemesis.apply()
        await pacer.advance(1)

    async def setup_advance() -> None:
        await pacer.advance(1)

    clock = LockstepRequestClock(setup_advance)
    driver = WireDriver(
        spec, seed,
        bootstrap=[("127.0.0.1", p) for p in cluster.broker_ports],
        clock=clock, conn_wrap=plane.wire.client_wrap, shared_conn=True,
        request_ticks=request_ticks, join_ticks=join_ticks)

    violation = None
    consumed = 0
    offered = 0
    max_stall = 0
    span_summaries = None
    span_dumps = None
    monitor = None
    if health:
        from josefine_tpu_torch.utils.health import HealthMonitor, HealthThresholds

        # One scope (the wire rig drives one produce stream); wire-tuned
        # thresholds — the lockstep rig acks within a produce_every
        # cadence, so its clean stall ceiling sits far below the chaos
        # harness's noise-driven one.
        monitor = HealthMonitor(groups=1, thresholds=HealthThresholds.wire(),
                                publish=False)

    def _set_fault_windows(active: bool) -> None:
        # Broker-side span recorders: the chaotic phase is one armed-fault
        # window, so every request served under the schedule is retained
        # (the sampling rule's fault arm), not just the per-window tail.
        for n in cluster.nodes:
            if n.spans is not None:
                n.spans.fault_active = active
    try:
        await cluster.start()
        for _ in range(600):
            if cluster.registered():
                break
            await pacer.advance(1)
        else:
            raise InvariantViolation(
                "wire: brokers never registered within 600 ticks")
        await driver.create_topics()
        # Prime the pump off-schedule: one produce per partition leader so
        # metadata is warm and the first chaotic round faults a WORKING
        # path, then open the chaotic window at plane tick 0.
        await driver.produce_batches(1)
        clock._advance = advance

        # ---- chaotic phase: offered load under the schedule ----
        _set_fault_windows(bool(sched.steps))
        last_ack_tick = plane.tick
        prev_acked = driver.n_produced
        while plane.tick < sched.horizon:
            await advance()
            if plane.tick % max(1, produce_every) == 0:
                offered += 1
                await driver.produce_batches(1, raise_on_fail=False)
            if driver.n_produced > prev_acked:
                prev_acked = driver.n_produced
                last_ack_tick = plane.tick
            if monitor is not None:
                # The wire health plane observes the driver's own
                # counters: produce progress against the open-loop
                # offered stream (pending=1 — the rig is always
                # offering), and the connection-level fault tally for
                # the wire-storm detector. Reconnects + group restarts
                # only: plain retries/reroutes carry the driver's
                # routine NotLeader re-routing (measured: a steady ~2
                # per produce round on a clean 3-broker rig), while a
                # clean rig's reconnect count is exactly zero — any
                # reconnect is fate-induced. Zero extra wire traffic.
                monitor.observe(plane.tick, {
                    "progress": [driver.n_produced],
                    "pending": [1],
                    "wire_retries": (driver.n_reconnects
                                     + driver.n_group_restarts),
                })
            stall = plane.tick - last_ack_tick
            if stall > max_stall:
                max_stall = stall
            if commitless_limit is not None and stall > commitless_limit:
                raise InvariantViolation(
                    f"availability: no wire produce acked for {stall} "
                    f"ticks (> commitless_limit {commitless_limit}) at "
                    f"tick {plane.tick}")

        # ---- heal + settle ----
        # The epilogue runs off the fate clock: every wire window is
        # cleared, and the broker's group machinery paces rebalances on
        # the wall clock, so the number of VIRTUAL ticks a post-heal join
        # takes is scheduling noise — freezing plane.tick here keeps the
        # epilogue's journal stamps (conn_open of the verification
        # consumers) byte-identical across same-seed runs.
        plane.heal_all()
        _set_fault_windows(False)
        clock._advance = setup_advance
        for _ in range(sched.heal_ticks):
            await setup_advance()

        # ---- wire invariants: durability + group reconvergence ----
        consumed = await driver.consume_verify()
        if consumed != driver.n_produced:
            raise InvariantViolation(
                f"wire durability: acked {driver.n_produced} produces but "
                f"consumers verified only {consumed}")
    except InvariantViolation as e:
        violation = str(e)
    except (RuntimeError, ConnectionError, TimeoutError,
            asyncio.TimeoutError) as e:
        # A driver that exhausted its retry budget mid-verification IS an
        # invariant failure: acked data unreadable or a group that never
        # reconverged.
        violation = f"wire: {e}"
    finally:
        try:
            await driver.close()
        except Exception:
            pass
        if request_spans:
            # Harvest before stop() — the recorders live on the nodes.
            span_summaries, span_dumps = {}, {}
            for n in cluster.nodes:
                if n.spans is not None:
                    nid = str(n.config.raft.id)
                    n.spans.seal()  # summary and dump must agree
                    span_summaries[nid] = n.spans.summary(table=True)
                    span_dumps[nid] = n.spans.dump_jsonl()
        await cluster.stop()
        await asyncio.to_thread(shutil.rmtree, tmpdir, ignore_errors=True)

    wire = plane.wire
    coverage = CoverageMap.from_wire_events(
        wire.events(), retries=driver.n_retries,
        group_restarts=driver.n_group_restarts)
    artifact = None
    if violation is not None:
        artifact = artifact_path or os.path.abspath(
            f"wire_chaos_artifact_{sched.name}_{seed}.json")
        payload = {
            "schedule": sched.name, "seed": seed,
            "tick": plane.tick, "violation": violation,
            "event_log": wire.event_log_jsonl(),
            "journals": wire.journals(),
            "fault_event_log": plane.event_log_jsonl(),
            "schedule_json": sched.to_json(),
            "driver": driver.summary(),
            # Replayable per-node span trees (request_spans on): the
            # violation's request-phase story beside the wire journals.
            "spans": span_dumps,
            "span_summary": span_summaries,
            "health": (None if monitor is None else
                       {"verdicts": monitor.verdicts(),
                        "events": monitor.events()}),
        }

        def dump_artifact(path: str) -> bool:
            try:
                with open(path, "w") as fh:
                    json.dump(payload, fh, indent=1)
                return True
            except OSError:
                return False

        if not await asyncio.to_thread(dump_artifact, artifact):
            artifact = None

    return {
        "schedule": sched.name,
        "seed": seed,
        "nodes": n_nodes,
        "ticks": plane.tick,
        "offered": offered,
        "produced": driver.n_produced,
        "consumed": consumed,
        "driver": driver.summary(),
        "fate_log": wire.fate_log(),
        "event_log": wire.event_log_jsonl(),
        "journals": wire.journals(),
        "fault_event_log": plane.event_log_jsonl(),
        "nemesis_skipped": len(nemesis.skipped),
        "nemesis_skipped_steps": list(nemesis.skipped),
        "max_commitless_window": max_stall,
        "commitless_limit": commitless_limit,
        # Online health plane over the wire driver's counters (None with
        # health off): detector verdicts + the health_* transition stream,
        # byte-identical across same-seed runs like every other plane.
        "health": (None if monitor is None else
                   {"verdicts": monitor.verdicts(),
                    "events": monitor.events()}),
        "invariants": "ok" if violation is None else "VIOLATED",
        "violation": violation,
        "artifact": artifact,
        "coverage": coverage.to_dict(),
        "coverage_signature": coverage.signature(),
        # Broker-side request spans (request_spans on): per-node request
        # counts + phase attribution, and the retained span logs.
        "request_spans": request_spans,
        "span_summary": span_summaries,
        "spans": span_dumps,
        "schedule_json": sched.to_json(),
    }


def run_wire_soak(*args, **kwargs) -> dict:
    return asyncio.run(run_wire_soak_async(*args, **kwargs))
