"""In-process chaos cluster harnesses.

:class:`ChaosCluster` drives N :class:`~josefine_tpu.raft.engine.RaftEngine`
nodes through a :class:`~josefine_tpu.chaos.faults.FaultPlane`-mediated
network on the plane's virtual clock. Every message fate, crash, partition
and proposal draw comes from the plane's single seeded RNG, so one seed
reproduces one run exactly. The safety invariants
(:mod:`josefine_tpu.chaos.invariants`) are enforced throughout — election
safety every tick, log matching every 10, the full convergence +
durability + linearizability epilogue after healing.

This is the library form of what used to be the test-private ``Chaos``
class in ``tests/test_chaos.py``; the chaos suites, the windowed-dispatch
suite, and ``tools/chaos_soak.py`` all drive this one fault model.

:class:`MembershipChaosCluster` adds runtime membership churn (a 4th node
ADDed/REMOVEd through conf blocks mid-chaos) — the library form of the old
``MemberChaos``.
"""

from __future__ import annotations

import json
from collections import deque

from josefine_tpu_torch.chaos import invariants
from josefine_tpu_torch.chaos.faults import FaultPlane, NetFaults
from josefine_tpu_torch.models.types import step_params
from josefine_tpu_torch.raft.engine import RaftEngine
from josefine_tpu_torch.raft.membership import ADD, REMOVE, ConfChange
from josefine_tpu_torch.utils.kv import MemKV

DEFAULT_PARAMS = step_params(timeout_min=3, timeout_max=8, hb_ticks=1,
                             device="cpu")

# Lease soaks need timeout_min > hb_ticks + 2 (raft.lease.check_lease_params:
# the non-overlap margin) — DEFAULT_PARAMS sits exactly on the boundary, so
# lease runs bump timeout_min by one. Everything else matches DEFAULT_PARAMS;
# a leases-off control run at these params is the digest-identity twin.
LEASE_PARAMS = step_params(timeout_min=4, timeout_max=8, hb_ticks=1,
                           device="cpu")

# Per-node flight-journal archive cap (events): a few engine rings deep —
# restart churn keeps the newest history instead of growing without bound.
_ARCHIVE_CAP = 16384


class SnapFsm:
    """List FSM with snapshot/restore — the chaos suites' replicated state."""

    def __init__(self):
        self.applied = []

    def transition(self, data: bytes) -> bytes:
        self.applied.append(data)
        return b"ok:" + data

    def snapshot(self) -> bytes:
        return json.dumps([a.decode() for a in self.applied]).encode()

    def restore(self, data: bytes) -> None:
        self.applied = [x.encode() for x in json.loads(data)] if data else []


def expand_outbound(outbound):
    """Flatten TickResult.outbound to per-message WireMsgs so the fault
    plane decides each message's fate individually (columnar MsgBatches
    expand via .messages())."""
    from josefine_tpu_torch.raft import rpc

    out = []
    for m in outbound:
        if isinstance(m, rpc.MsgBatch):
            out.extend(m.messages())
        else:
            out.append(m)
    return out


class _PlaneDrivenCluster:
    """Driver scaffolding shared by the plane-mediated harnesses: virtual-
    clock accessors, delayed-message maturation, fault-plane routing of
    engine outboxes, ack harvesting, and flight-journal collection.
    Subclasses own engine lifecycle (``self.engines`` slots may be None for
    removed members) and the fault-drawing policy."""

    @property
    def tick_no(self) -> int:
        return self.plane.tick

    def _archive_flight(self, i: int) -> None:
        """Carry a to-be-replaced engine's flight journal into the per-node
        archive (with a boot boundary marker), so crash/restart churn does
        not erase the structured history the journal exists to provide.
        Purely tick-indexed — same-seed runs archive identically."""
        prev = getattr(self, "engines", None)
        arch = getattr(self, "flight_archive", None)
        if arch is None or prev is None or i >= len(prev) or prev[i] is None:
            return
        self.flight_dropped += prev[i].flight.dropped
        arch[i].extend(prev[i].flight.events())
        arch[i].append({"seq": -1, "tick": self.tick_no, "kind": "boot",
                        "group": -1, "term": -1, "leader": -1})

    def flight_journals(self) -> dict[str, list[dict]]:
        """Per-node flight journals: archived (pre-restart) events plus the
        live engine's ring, oldest first."""
        arch = getattr(self, "flight_archive", None) or {}
        out: dict[str, list[dict]] = {}
        for i, e in enumerate(self.engines):
            evs = list(arch[i]) if arch else []
            if e is not None:
                evs.extend(e.flight.events())
            out[str(i)] = evs
        return out

    def flight_journals_jsonl(self) -> dict[str, str]:
        """JSONL form of :meth:`flight_journals` (sorted keys, compact) —
        the byte-identical-across-same-seed-runs artifact."""
        return {
            node: "".join(json.dumps(e, sort_keys=True,
                                     separators=(",", ":")) + "\n"
                          for e in evs)
            for node, evs in self.flight_journals().items()
        }

    @property
    def down(self) -> set[int]:
        return set(self.plane.crashed)

    # Host-path delivery counter (per cluster, unlike the process-global
    # metrics registry): every message actually handed to an engine's
    # receive() — the complement of the fabric's routed count, so a soak
    # summary's routed/host split stays correct across multiple runs in
    # one process.
    host_delivered = 0

    # Flight-ring wraparound ledger: events evicted from DEAD engines'
    # rings (banked at archive time; live engines' drops are read off
    # their recorders directly). See flight_ring_dropped().
    flight_dropped = 0

    def flight_ring_dropped(self) -> int:
        """Total journal events lost to ring wraparound across the run —
        archived incarnations plus every live engine. Nonzero means the
        merged timeline (and hence the coverage signature) was computed
        over a truncated history."""
        return self.flight_dropped + sum(
            e.flight.dropped for e in self.engines if e is not None)

    def _deliver_matured(self) -> None:
        """Deliver delayed messages whose virtual delivery tick arrived;
        traffic to a down or removed node is lost (as on a real network)."""
        still = []
        for when, dst, m in self.delayed:
            if when <= self.tick_no:
                e = self.engines[dst]
                if e is not None and not self.plane.is_down(dst):
                    e.receive(m)
                    self.host_delivered += 1
            else:
                still.append((when, dst, m))
        self.delayed = still

    def _route_outbound(self, src: int, outbound) -> None:
        """Route one engine's outbox through the fault plane: deliver now,
        schedule a delayed copy, or lose it — the plane decides."""
        for m in expand_outbound(outbound):
            if self.engines[m.dst] is None:
                continue
            for when, msg in self.plane.route(src, m.dst, m):
                if when <= self.tick_no:
                    self.engines[msg.dst].receive(msg)
                    self.host_delivered += 1
                else:
                    self.delayed.append((when, msg.dst, msg))

    def harvest_acks(self) -> None:
        still = []
        for g, payload, fut in self.pending:
            if fut.done():
                if not fut.cancelled() and fut.exception() is None:
                    self.acked[g].append(payload)
                    self.ack_tick[payload] = self.tick_no
            else:
                still.append((g, payload, fut))
        self.pending = still


class ChaosCluster(_PlaneDrivenCluster):
    """One chaotic cluster run with deterministic randomness.

    ``window``/``params`` let the windowed-dispatch suite reuse this harness
    instead of growing a second fault model: live engines then step
    ``suggest_window(window)`` fused ticks per dispatch (params must allow
    it — the window clamps to hb_ticks). ``sparse``/``k_out`` force the
    sparse packed-IO bridge with a tiny compaction capacity, so chaos
    bursts exercise overflow growth, the dense fallback fetch, and the
    quiet-run shrink — under crashes, not just fault-free equality.

    ``auto_crash``/``auto_links`` enable the background random crash and
    directed-partition generators (the classic fuzz mode); nemesis-driven
    runs usually disable them so the schedule is the only structured fault
    source (probabilistic drop/dup/delay noise stays on via ``net``).
    """

    def __init__(self, seed: int, n_nodes: int = 3, groups: int = 2,
                 window: int = 1, params=DEFAULT_PARAMS,
                 sparse: bool = False, k_out: int | None = None,
                 plane: FaultPlane | None = None, net: NetFaults | None = None,
                 auto_crash: bool = True, auto_links: bool = True,
                 propose_rate: float = 0.15, max_proposals: int = 40,
                 active_set: bool = False, device_route: bool = False,
                 payload_ring: bool = False,
                 flight_wire: bool = False, workload=None,
                 flight_ring: int = 4096, request_spans: bool = False,
                 migration: bool = False, leases: bool = False,
                 health: bool = True, device="cuda"):
        # The engines' device: the card unless the caller says "cpu".
        self.device = device
        self.plane = plane or FaultPlane(seed, n_nodes, net=net)
        self.rng = self.plane.rng  # one RNG: the whole run replays from seed
        self.N = n_nodes
        self.G = groups
        # Live migration (raft.migration): engines carry one SPARE row
        # beyond the logical streams, and the stream -> row mapping is
        # indirect — a cutover flips it and the freed source row becomes
        # the new spare. Without the flag R == G, the mapping is the
        # identity forever, and every artifact is byte-identical to the
        # pre-migration harness.
        self.migration = bool(migration)
        # Tick-denominated leader leases (raft.leases): engines derive the
        # host-side lease plane and the harness checks lease non-overlap +
        # leader exclusion every tick, plus the stale-read probe (a node
        # that believes it leads must REFUSE leased serves once its lease
        # expires). Leases demand timeout_min > hb_ticks + 2, so the
        # default params are silently upgraded to LEASE_PARAMS; explicit
        # params must satisfy the constraint themselves (the engine
        # raises). NOTE: lease soundness is scoped to a non-duplicating
        # transport — run with dup_p=0 (soak.py enforces this); dup faults
        # can replay an APPEND_RESP that is byte-identical to the next
        # idle-heartbeat ack and over-credit the evidence window.
        self.leases = bool(leases)
        if leases and params is DEFAULT_PARAMS:
            params = LEASE_PARAMS
        self.R = groups + (1 if migration else 0)  # engine rows
        self.stream_row = list(range(groups))
        self.spare_row = groups if migration else -1
        self.window = window
        self.params = params
        self.sparse = sparse
        self.k_out = k_out
        self.auto_crash = auto_crash
        self.auto_links = auto_links
        # Engines run the active-set compacted scheduler: chaos schedules
        # (partition heals = mass wake-ups, crash/restart churn) are the
        # hostile environment for its wake predicate, so nemesis runs can
        # pin the invariants under it, not just fault-free equality.
        self.active_set = active_set
        # Wire-level trace events (raft.flight_wire): journals grow
        # msg_sent/msg_delivered so the soak's merged timeline carries the
        # message path, not just state transitions — the substrate of the
        # coverage signatures (utils/coverage.py) and trace_report.
        self.flight_wire = flight_wire
        # Per-engine flight-recorder ring capacity: a searched soak with
        # wire tracing at scale overflows the 4096 default and silently
        # truncates the timeline the coverage scorer depends on — the soak
        # sizes it (run_soak flight_ring=) and warns on wraparound.
        self.flight_ring = int(flight_ring)
        # Request-scoped spans under chaos (raft.request_spans): engines
        # accept the ambient trace context at propose(); the workload
        # adapter mints one span per produce request, clocked on the
        # cluster's virtual tick so driver-side marks stay deterministic
        # through crash/restart engine rebuilds (engine-side rungs are
        # clamped into [begin, end] by the span ladder either way).
        self.request_spans = bool(request_spans)
        self.propose_rate = propose_rate
        self.max_proposals = max_proposals
        # Product-load source (workload.chaos_traffic.ChaosTraffic): when
        # set, drive_traffic() offers ITS schedule instead of the synthetic
        # maybe_propose trickle; acks land in self.acked either way, so
        # every safety checker covers the workload's writes unchanged.
        self.workload = workload
        self.ids = list(range(1, n_nodes + 1))
        self.kvs = [MemKV() for _ in range(n_nodes)]
        # One FSM per (node, row): apply order is only defined per row.
        self.fsms = [[SnapFsm() for _ in range(self.R)]
                     for _ in range(n_nodes)]
        # Per-node flight-journal archive: restart churn rebuilds engines,
        # and each rebuild banks the dead engine's journal here. Bounded
        # (a few rings deep) so a crash-loop soak's memory and artifact
        # size do not grow linearly with restart count.
        self.flight_archive = [deque(maxlen=_ARCHIVE_CAP)
                               for _ in range(n_nodes)]
        # Device-resident delivery under chaos: the fabric's link gate IS
        # the fault plane — a partitioned/crashed/noisy link refuses to
        # route, so its traffic rides the host path where the plane applies
        # its fates. With the default probabilistic noise the gate never
        # opens (per-message fates must not be dodged); the pairing that
        # exercises routing is a directive-only schedule + NetFaults.quiet
        # (chaos_soak --device-route --quiet-net).
        self.fabric = None
        if device_route:
            from josefine_tpu_torch.raft.route import RouteFabric

            # payload_ring additionally routes AppendEntries with
            # ring-resident spans on-chip (spills and per-link gating
            # unchanged: a faulted link's payload AEs ride the host path
            # where the plane applies its fates, exactly like payload-free kinds).
            self.fabric = RouteFabric(link_filter=self.plane.link_routable,
                                      payload_ring=payload_ring)
        self.engines = [self._make(i) for i in range(n_nodes)]
        # The migration controller is cluster-held host state (it models
        # the reliable reassignment driver; the product plane's controller
        # is the replicated metadata FSM) — created AFTER the engines so
        # the rebuild hook in _make sees it only on actual restarts.
        self.migrator = None
        if migration:
            from josefine_tpu_torch.raft.migration import MigrationCoordinator

            self.migrator = MigrationCoordinator(self)
        self.delayed: list[tuple[int, int, object]] = []  # (deliver_tick, dst, msg)
        self.ledger = invariants.ElectionSafetyLedger()
        self.lease_ledger = (invariants.LeaseSafetyLedger()
                             if self.leases else None)
        # Stale-read probe tallies (see _check_leases).
        self.leased_reads = 0
        self.lease_refusals = 0
        # The online health plane (utils.health.HealthMonitor): evaluated
        # once per tick off state this harness already maintains — acked
        # counters, pending futures / workload backlog, leader mirrors,
        # chain head/commit — zero extra fetches, and it writes only to
        # its OWN flight ring, so a health-on run stays byte-identical to
        # its health-off twin on every other telemetry plane. Gauges stay
        # unpublished here: the process-global registry lands in soak
        # artifacts, and cross-run series bleed would break same-seed
        # byte-identity when several soaks share one process.
        self.health = None
        if health:
            from josefine_tpu_torch.utils.health import HealthMonitor

            self.health = HealthMonitor(groups=groups, publish=False)
        self.acked: dict[int, list[bytes]] = {g: [] for g in range(groups)}
        self.pending: list[tuple[int, bytes, object]] = []
        self.proposed = 0
        self.submit_tick: dict[bytes, int] = {}
        self.ack_tick: dict[bytes, int] = {}

    def _make(self, i: int) -> RaftEngine:
        self._archive_flight(i)
        self.fsms[i] = [SnapFsm() for _ in range(self.R)]
        e = RaftEngine(
            self.kvs[i], self.ids, self.ids[i], groups=self.R,
            fsms={g: self.fsms[i][g] for g in range(self.R)},
            params=self.params, base_seed=100 + i,
            snapshot_threshold=6,
            sparse_io=True if self.sparse else None,
            active_set=self.active_set,
            flight_wire=self.flight_wire,
            flight_ring=self.flight_ring,
            request_spans=self.request_spans,
            leases=self.leases,
            flight_lease=self.leases,
            device=self.device,
        )
        if self.k_out is not None:
            e._k_out = self.k_out
        if self.fabric is not None:
            # (Re-)register the slot: a restarted engine joins the fabric
            # fresh — staged routed traffic for the dead incarnation is
            # dropped, like the pending queues inside the dead process.
            self.fabric.register(e)
        mig = getattr(self, "migrator", None)
        if mig is not None:
            # Revived engines come back with volatile migration state
            # reset (incarnations at 0, freeze lifted): re-anchor to the
            # controller's ledger, purging rows whose durable life is
            # stale — engines list first, the hook reads through it.
            self.engines[i] = e
            mig.on_engine_rebuilt(i)
        return e

    # ------------------------------------------------------ nemesis queries

    def row_of(self, stream: int) -> int:
        """The engine row currently owning a logical stream (identity
        unless a migration cut over)."""
        return self.stream_row[stream]

    def live_nodes(self) -> list[int]:
        return [i for i in range(self.N) if not self.plane.is_down(i)]

    def leader_node(self, group: int = 0) -> int | None:
        # Nemesis dynamic targets name STREAMS, so "shoot the leader of
        # group 1" keeps tracking a stream across its migrations (identity
        # mapping when the migration plane is off).
        row = self.row_of(group) if group < self.G else group
        for i in self.live_nodes():
            if self.engines[i].is_leader(row):
                return i
        return None

    # ----------------------------------------------------------- invariants

    def _live_engines(self):
        return [(i, self.engines[i]) for i in self.live_nodes()]

    def check_election_safety(self):
        # All R rows, not just stream-owned ones: a spare row's elections
        # still must never produce two leaders in one term.
        self.ledger.check(self._live_engines(), self.R)

    def _check_leases(self):
        """Per-tick lease safety + the stale-read probe. The ledger pins
        non-overlap and term-qualified leader exclusion; the probe then
        attempts one leased serve per (group, self-believed leader) — a
        holder serves (counted, and must still be lease-valid), while a
        partitioned ex-leader whose lease expired must REFUSE: an ok there
        would be exactly the stale read leases exist to prevent."""
        if self.lease_ledger is None:
            return
        live = self._live_engines()
        self.lease_ledger.check(live, self.G, self.tick_no,
                                row_of=self.row_of)
        for g in range(self.G):
            row = self.row_of(g)
            for i, e in live:
                if not e.is_leader(row):
                    continue
                ok, reason = e.lease_serve(row)
                if ok:
                    invariants._require(
                        e.lease_valid(row),
                        f"node {i} served a leased read on group {g} "
                        f"(row {row}) at tick {self.tick_no} without a "
                        f"valid lease")
                    self.leased_reads += 1
                else:
                    self.lease_refusals += 1

    def check_log_matching(self):
        # Keyed by STREAM through the row mapping: during a handoff the
        # target row's adopters carry the source prefix (truncated at the
        # first fence), so prefix-compatibility must hold on whichever row
        # currently owns the stream.
        invariants.check_log_matching({
            g: [self.fsms[i][self.row_of(g)].applied for i in range(self.N)]
            for g in range(self.G)
        })

    # ---------------------------------------------------------------- chaos

    def step(self, nemesis=None):
        """One virtual tick: advance the plane (revivals), apply nemesis
        steps, optionally draw background crash/link faults, deliver matured
        delayed messages, tick live engines through the chaotic network,
        check safety."""
        for i in self.plane.advance(1):
            # Durable restart: fresh engine over the same KV (FSM rebuilt
            # via snapshot restore + replay).
            self.engines[i] = self._make(i)
        if nemesis is not None:
            nemesis.apply()
        if self.migrator is not None:
            # The controller round runs right after faults land: re-arm
            # freezes, drive the fence, adopt fenced nodes, cut over at
            # quorum (raft.migration.MigrationCoordinator.step).
            self.migrator.step()

        # Background faults (the fuzz mode): maybe crash one node (only if
        # everyone else is up — keep quorum), maybe block one directed link
        # (at most one at a time, never while a node is down, so some
        # quorum path stays alive and the write path keeps being exercised).
        if self.auto_crash and not self.plane.crashed and self.rng.random() < 0.02:
            i = self.rng.randrange(self.N)
            self.plane.crash(i, until=self.tick_no + self.rng.randint(10, 40))
        if (self.auto_links and not self.plane.blocked
                and not self.plane.crashed and self.rng.random() < 0.015):
            src = self.rng.randrange(self.N)
            dst = self.rng.choice([j for j in range(self.N) if j != src])
            self.plane.block_link(src, dst,
                                  until=self.tick_no + self.rng.randint(15, 40))

        self._deliver_matured()

        # Tick live engines, route outbound through the fault plane.
        for i in self.live_nodes():
            if not self.plane.should_tick(i):
                continue  # pacer skew: this node is slow
            e = self.engines[i]
            res = e.tick(window=e.suggest_window(self.window))
            self._route_outbound(i, res.outbound)
            if self.fabric is not None:
                # This harness delivers immediately per engine, so the
                # fabric's barrier sits at the same point — routed and
                # host-path traffic stay same-tick consumable.
                self.fabric.flush()

        self.check_election_safety()
        self._check_leases()
        if self.migrator is not None:
            invariants.check_migration_state(self)
        if self.tick_no % 10 == 0:
            self.check_log_matching()
        self._health_tick()

    def drive_traffic(self):
        """One tick's proposal source: the workload schedule when wired,
        the synthetic trickle otherwise."""
        if self.workload is not None:
            self.workload.drive(self)
        else:
            self.maybe_propose()

    def harvest_traffic(self):
        self.harvest_acks()
        if self.workload is not None:
            self.workload.harvest(self)

    def maybe_propose(self):
        if self.rng.random() > self.propose_rate or self.proposed >= self.max_proposals:
            return
        g = self.rng.randrange(self.G)
        row = self.row_of(g)
        # Propose on the node that believes it leads (if any); chaos means
        # it may be deposed — failures are fine, only acks must be durable.
        # Acks are keyed by STREAM, proposals target the owning ROW (a
        # frozen source refuses with NotLeader, exactly like a deposed
        # leader — the retry lands after the cutover re-route).
        for i in self.live_nodes():
            e = self.engines[i]
            if e.is_leader(row):
                payload = b"p%d" % self.proposed
                self.proposed += 1
                self.submit_tick[payload] = self.tick_no
                self.pending.append((g, payload, e.propose(row, payload)))
                return

    def heal(self, ticks: int = 120):
        """Everyone up, clean network (no drops/dups/partitions/skew), run
        to convergence — the shared epilogue of every chaos run."""
        self.plane.heal_all()
        for i in list(self.plane.crashed):
            self.plane.crashed.pop(i)
            self.engines[i] = self._make(i)
            self.plane._event("node_restarted", node=i)
        # Heal-phase delivery is direct (no plane routing): the epilogue is
        # a clean network by definition, and keeping it off the RNG keeps
        # the fault-event log a pure record of the chaotic phase.
        for _ in range(ticks):
            self.plane.advance(1)
            if self.migrator is not None:
                # An in-flight migration ROLLS FORWARD through healing:
                # the fence commits on the clean network, adoption
                # completes, and the cutover resolves to a single owner
                # before the convergence epilogue checks it.
                self.migrator.step()
            for _, dst, m in self.delayed:
                self.engines[dst].receive(m)
                self.host_delivered += 1
            self.delayed = []
            for e in self.engines:
                res = e.tick(window=e.suggest_window(self.window))
                for m in res.outbound:
                    self.engines[m.dst].receive(m)
                    # Per-ENTRY, like the chaotic phase (there messages
                    # arrive pre-expanded): a columnar MsgBatch is many.
                    self.host_delivered += (len(m) if hasattr(m, "__len__")
                                            else 1)
                if self.fabric is not None:
                    self.fabric.flush()
            self.check_election_safety()
            self._check_leases()
            if self.migrator is not None:
                invariants.check_migration_state(self)

    def assert_converged_and_linearizable(self):
        """Single agreed leader per group; identical chains and FSM logs;
        every acked write durable, exactly-once, in real-time order."""
        if self.migrator is not None:
            # A migration must have resolved (cutover or abort) before the
            # epilogue checks ownership — heal() drives the coordinator, so
            # an unresolved one here is a roll-forward bug, not a timeout.
            invariants.check_migration_resolved(self.migrator)
        for g in range(self.G):
            r = self.row_of(g)
            invariants.check_converged(
                [(i, self.engines[i]) for i in range(self.N)],
                [self.fsms[i][r].applied for i in range(self.N)],
                self.acked[g], self.submit_tick, self.ack_tick, r)
        self.check_log_matching()

    def state_digest(self) -> dict:
        """A JSON-safe fingerprint of the converged cluster: per-group
        (head, committed, term) plus every node's applied FSM sequence.
        Two same-seed runs must produce identical digests. Streams are
        read through their OWNING row, so a digest is placement-invariant
        modulo the explicit ``migration`` block (present only when the
        migration plane is armed, keeping legacy digests byte-identical)."""
        digest = {
            "groups": {
                str(g): {
                    "head": int(self.engines[0].chains[self.row_of(g)].head),
                    "committed": int(
                        self.engines[0].chains[self.row_of(g)].committed),
                    "terms": [int(self.engines[i].term(self.row_of(g)))
                              for i in range(self.N)],
                    "logs": [[p.decode("latin1")
                              for p in self.fsms[i][self.row_of(g)].applied]
                             for i in range(self.N)],
                }
                for g in range(self.G)
            },
            "acked": {str(g): [p.decode("latin1") for p in self.acked[g]]
                      for g in range(self.G)},
        }
        if self.migration:
            digest["migration"] = {
                "stream_row": list(self.stream_row),
                "spare_row": self.spare_row,
                "row_inc": {str(r): self.migrator.row_inc[r]
                            for r in sorted(self.migrator.row_inc)},
            }
        return digest

    def migration_summary(self) -> dict | None:
        """Coordinator outcome telemetry for the soak result (None when
        the migration plane is off, keeping legacy artifacts unchanged)."""
        if self.migrator is None:
            return None
        return {**self.migrator.summary(),
                "stream_row": list(self.stream_row),
                "spare_row": self.spare_row}

    def lease_summary(self) -> dict | None:
        """Lease-lane outcome telemetry for the soak result (None when the
        lease plane is off, keeping legacy artifacts unchanged). The held/
        handover counts come from the safety ledger, the read tallies from
        the stale-read probe, and the per-node blocks from each engine's
        own lane (credits, refused queue pushes, armed group count)."""
        if self.lease_ledger is None:
            return None
        return {
            "held_ticks": self.lease_ledger.held_ticks,
            "handovers": self.lease_ledger.handovers,
            "leased_reads": self.leased_reads,
            "refusals": self.lease_refusals,
            "nodes": {str(i): e.lease_summary()
                      for i, e in enumerate(self.engines) if e is not None},
        }

    # ---------------------------------------------------------------- health

    def health_sample(self) -> dict:
        """One tick's detector inputs, read off state the harness already
        maintains. Keys for unarmed planes are omitted so their detectors
        never evaluate (and legacy-shaped runs stay legacy-shaped)."""
        from josefine_tpu_torch.raft.chain import id_seq

        pending = [0] * self.G
        if self.workload is not None:
            # Outstanding INCLUDING queued retries: during a leaderless
            # window the workload parks work in its retry backlog without
            # a live future, and that backlog is exactly the "work is
            # waiting" signal the commit-stall detector gates on.
            for g, n in enumerate(self.workload.outstanding_by_group(self.G)):
                pending[g] = n
        else:
            for g, _, _ in self.pending:
                pending[g] += 1
        leaders = []
        for g in range(self.G):
            ln = self.leader_node(g)
            leaders.append(-1 if ln is None else ln)
        lag = []
        live = self.live_nodes()
        for g in range(self.G):
            row = self.row_of(g)
            # Commit SPREAD, not head-commit depth: the gap between the
            # most- and least-advanced live commit frontier. Pipeline
            # depth under load is healthy; one replica trailing is not.
            commits = [id_seq(self.engines[i].chains[row].committed)
                       for i in live]
            lag.append((max(commits) - min(commits)) if commits else 0)
        s = {
            "progress": [len(self.acked[g]) for g in range(self.G)],
            "pending": pending,
            "leaders": leaders,
            "lag": lag,
        }
        if self.leases:
            s["lease_refused"] = self.lease_refusals
        if self.migrator is not None:
            m = self.migrator.mig
            s["migration"] = (None if m is None else {
                "active": True, "started": m["started"],
                "progress": len(m["adopted"])})
        return s

    def _health_tick(self) -> None:
        # Called from step() only — the health plane observes the DRIVEN
        # (chaotic) phase. heal() is the convergence epilogue with the
        # traffic source disengaged and harvest deferred to its end, so
        # resolved-but-unharvested futures would read as phantom stalled
        # work there (measured: clean-seed false positives in the first
        # heal ticks, from proposals that raced the horizon).
        if self.health is not None:
            self.health.observe(self.tick_no, self.health_sample())

    def health_summary(self) -> dict | None:
        """Detector verdicts + the full ``health_*`` transition stream for
        the soak result (None when the health plane is off, keeping the
        twin's artifact shape explicit)."""
        if self.health is None:
            return None
        return {"verdicts": self.health.verdicts(),
                "events": self.health.events()}


class MembershipChaosCluster(_PlaneDrivenCluster):
    """Chaos + runtime membership churn: a 4th node is ADDed and REMOVEd
    through group-0 conf blocks WHILE the fault plane drops/dups/delays
    messages and crashes nodes, and snapshots install (threshold 5 keeps
    conf blocks falling below truncation floors, so joiners exercise the
    member-table-over-snapshot path)."""

    MAX = 4  # node slots; ids 1..4, node 4 churns

    def __init__(self, seed: int, groups: int = 2, device="cuda"):
        self.device = device
        self.plane = FaultPlane(seed, self.MAX)
        self.rng = self.plane.rng
        self.G = groups
        self.ids = [1, 2, 3, 4]
        self.kvs = [MemKV() for _ in range(self.MAX)]
        self.fsms = [[SnapFsm() for _ in range(groups)] for _ in range(self.MAX)]
        self.flight_archive = [deque(maxlen=_ARCHIVE_CAP)
                               for _ in range(self.MAX)]
        self.engines: list[RaftEngine | None] = [
            self._make(i, [1, 2, 3]) for i in range(3)] + [None]
        self.delayed: list[tuple[int, int, object]] = []
        self.ledger = invariants.ElectionSafetyLedger()
        self.acked: dict[int, list[bytes]] = {g: [] for g in range(groups)}
        self.pending: list[tuple[int, bytes, object]] = []
        self.proposed = 0
        self.submit_tick: dict[bytes, int] = {}
        self.ack_tick: dict[bytes, int] = {}
        self.conf_fut = None
        self.adds_committed = 0
        self.removes_committed = 0

    def _make(self, i: int, member_ids) -> RaftEngine:
        self._archive_flight(i)
        self.fsms[i] = [SnapFsm() for _ in range(self.G)]
        return RaftEngine(
            self.kvs[i], list(member_ids), self.ids[i], groups=self.G,
            fsms={g: self.fsms[i][g] for g in range(self.G)},
            params=DEFAULT_PARAMS, base_seed=200 + i,
            snapshot_threshold=5, max_nodes=self.MAX, device=self.device,
        )

    def _boot_ids(self, i: int) -> list[int]:
        """Restart bootstrap list: the node's original config (the durable
        member table overrides it when present)."""
        return [1, 2, 3] if i < 3 else [1, 2, 3, 4]

    # ------------------------------------------------------------- helpers

    def live(self):
        return [(i, e) for i, e in enumerate(self.engines)
                if e is not None and not self.plane.is_down(i)]

    def leader_engine(self, g=0):
        for _i, e in self.live():
            if e.is_leader(g):
                return e
        return None

    def node4_is_member(self) -> bool:
        """The cluster's view: does any live engine's committed member table
        have node 4 active? (Conf futures can be lost to leader churn, so
        the driver watches the tables, not the futures.)"""
        e = self.leader_engine() or (self.live()[0][1] if self.live() else None)
        return e is not None and any(
            m.node_id == 4 and m.active for m in e.members.by_id.values())

    # ------------------------------------------------------------- checks

    def check_election_safety(self):
        self.ledger.check(self.live(), self.G)

    def check_log_matching(self):
        invariants.check_log_matching({
            g: [self.fsms[i][g].applied
                for i in range(self.MAX) if self.engines[i] is not None]
            for g in range(self.G)
        })

    # -------------------------------------------------------------- chaos

    def step(self):
        for i in self.plane.advance(1):
            # Durable restart over the same KV (exercises replay of conf
            # blocks + snapshot restore mid-chaos). Core nodes restart with
            # their ORIGINAL bootstrap list — only the durable member table
            # (i.e. a committed ADD) may introduce node 4; restarting with
            # [1,2,3,4] would fabricate membership on a node that crashed
            # before the table was ever persisted.
            self.engines[i] = self._make(i, self._boot_ids(i))
        if not self.plane.crashed and self.rng.random() < 0.02:
            cands = [i for i, _ in self.live()]
            if len(cands) > 2:  # keep a quorum of the 3 core nodes possible
                i = self.rng.choice(cands)
                self.plane.crash(i, until=self.tick_no + self.rng.randint(10, 40))

        self._deliver_matured()

        for i, e in self.live():
            res = e.tick()
            self._route_outbound(i, res.outbound)

        self.check_election_safety()
        if self.tick_no % 10 == 0:
            self.check_log_matching()

    def drive_membership(self):
        """The churn driver: converge the engine-4 process toward the
        cluster's committed membership, and randomly flip that membership
        through conf proposals."""
        member = self.node4_is_member()
        if member and self.engines[3] is None:
            # Cluster says node 4 is in; boot it with a FRESH disk (worst
            # case: must catch up purely by replay or snapshot install).
            self.kvs[3] = MemKV()
            self.engines[3] = self._make(3, [1, 2, 3, 4])
            self.adds_committed += 1
        elif (not member and self.engines[3] is not None
                and not self.plane.is_down(3)):
            # Committed removal: stop the process — banking the removed
            # incarnation's journal first (the archive's whole contract).
            self._archive_flight(3)
            self.engines[3] = None
            self.removes_committed += 1

        if self.conf_fut is not None and not self.conf_fut.done():
            return  # one change in flight
        self.conf_fut = None
        if self.rng.random() > 0.04:
            return
        lead = self.leader_engine(0)
        if lead is None:
            return
        try:
            if member:
                self.conf_fut = lead.propose_conf(
                    ConfChange(op=REMOVE, node_id=4))
            else:
                self.conf_fut = lead.propose_conf(
                    ConfChange(op=ADD, node_id=4, ip="x", port=4))
        except Exception:
            self.conf_fut = None

    def drive_membership_settled(self):
        """Heal-phase driver: no new conf proposals, but still converge the
        engine-4 process with whatever membership committed (an ADD/REMOVE
        may land during healing)."""
        member = self.node4_is_member()
        if member and self.engines[3] is None:
            self.kvs[3] = MemKV()
            self.engines[3] = self._make(3, [1, 2, 3, 4])
            self.adds_committed += 1
        elif not member and self.engines[3] is not None:
            self._archive_flight(3)
            self.engines[3] = None
            self.removes_committed += 1

    def maybe_propose(self):
        if self.rng.random() > 0.15 or self.proposed >= 40:
            return
        g = self.rng.randrange(self.G)
        for _i, e in self.live():
            if e.is_leader(g):
                payload = b"m%d" % self.proposed
                self.proposed += 1
                self.submit_tick[payload] = self.tick_no
                self.pending.append((g, payload, e.propose(g, payload)))
                return

    def heal(self, ticks: int = 150):
        """Settle: revive crashes, stop driving conf changes, clean network
        to convergence (membership still converges to whatever committed)."""
        self.plane.heal_all()
        for i in list(self.plane.crashed):
            self.plane.crashed.pop(i)
            self.engines[i] = self._make(i, self._boot_ids(i))
        for _ in range(ticks):
            self.plane.advance(1)
            for _, dst, m in self.delayed:
                if self.engines[dst] is not None:
                    self.engines[dst].receive(m)
            self.delayed = []
            for _i, e in self.live():
                res = e.tick()
                for m in res.outbound:
                    if self.engines[m.dst] is not None:
                        self.engines[m.dst].receive(m)
            self.drive_membership_settled()
            self.check_election_safety()

    def assert_converged_and_linearizable(self):
        active = [(i, e) for i, e in enumerate(self.engines) if e is not None]
        for g in range(self.G):
            invariants.check_converged(
                active,
                [self.fsms[i][g].applied for i, _ in active],
                self.acked[g], self.submit_tick, self.ack_tick, g)
        self.check_log_matching()
