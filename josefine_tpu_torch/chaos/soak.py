"""The programmatic soak runner behind ``tools/chaos_soak.py``.

``run_soak(seed, schedule)`` drives a :class:`ChaosCluster` through a
nemesis schedule on the virtual clock, heals, enforces every safety
invariant, and returns a result dict carrying the byte-stable fault-event
log. Reproducibility is the contract: two runs with the same (seed,
schedule) produce identical event logs and identical final cluster state
— pinned by ``tests/test_chaos_determinism.py`` and relied on whenever a
soak finding needs a deterministic reproducer.
"""

from __future__ import annotations

import asyncio
import json
import os

from josefine_tpu_torch.chaos.faults import FaultPlane, NetFaults
from josefine_tpu_torch.chaos.harness import DEFAULT_PARAMS, ChaosCluster
from josefine_tpu_torch.chaos.invariants import (InvariantViolation,
                                           duplicate_acked_count)
from josefine_tpu_torch.chaos.nemesis import (LEASE_SCHEDULES, MIGRATION_SCHEDULES,
                                        SCHEDULES, Nemesis, Schedule)
from josefine_tpu_torch.models.types import step_params
from josefine_tpu_torch.utils.coverage import CoverageMap
from josefine_tpu_torch.utils.flight import merge_journals, timeline_jsonl
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("chaos.soak")


def resolve_schedule(name_or_schedule, n_nodes: int = 3) -> Schedule:
    """A Schedule passes through; a bundled name builds one; a string of
    JSON (or anything with a ``read``) parses the DSL. Every path ends in
    :meth:`Schedule.validate` against the cluster size — a mutated or
    hand-edited schedule with garbage steps fails HERE, naming the step,
    not deep inside ``Nemesis.apply`` mid-soak."""
    if isinstance(name_or_schedule, Schedule):
        return name_or_schedule.validate(n_nodes)
    if name_or_schedule in SCHEDULES:
        return SCHEDULES[name_or_schedule](n_nodes)
    if name_or_schedule in MIGRATION_SCHEDULES:
        # Bundled migration nemeses resolve by name too; they only DO
        # anything on a soak with the migration plane armed (elsewhere
        # their migrate steps skip-and-record, by the nemesis contract).
        return MIGRATION_SCHEDULES[name_or_schedule](n_nodes)
    if name_or_schedule in LEASE_SCHEDULES:
        # Lease nemeses are ordinary partition schedules — they resolve
        # anywhere, but only a soak with leases armed checks the lease
        # ledger and probe against them.
        return LEASE_SCHEDULES[name_or_schedule](n_nodes)
    return Schedule.from_json(name_or_schedule).validate(n_nodes)


async def run_soak_async(seed: int, schedule, n_nodes: int = 3,
                         groups: int = 2, window: int = 1,
                         net: NetFaults | None = None,
                         auto_faults: bool = False,
                         horizon: int | None = None,
                         active_set: bool = False,
                         hb_ticks: int | None = None,
                         device_route: bool = False,
                         payload_ring: bool = False,
                         flight_wire: bool = False,
                         workload: dict | None = None,
                         artifact_path: str | None = None,
                         flight_ring: int | None = None,
                         commitless_limit: int | None = None,
                         request_spans: bool = False,
                         migration: bool = False,
                         leases: bool = False,
                         health: bool = True, device="cuda") -> dict:
    """One soak run. ``auto_faults`` additionally layers the background
    random crash/partition generators over the schedule (hostile mode);
    default is schedule + probabilistic message noise only, which is what
    the bundled schedules' invariant guarantees are stated against.

    ``hb_ticks`` overrides the harness default of 1: per-tick heartbeats
    wake every row every tick, so an --active-set soak at the default
    spends nearly all its ticks in the dense fallback. Raising it opens
    quiescent gaps between heartbeats and makes the soak exercise the
    compacted gather/step/scatter/decay path the flag asks for (the
    summary's active_set_stats shows which path actually ran).

    ``device_route`` joins the engines to a RouteFabric gated on the
    fault plane: clean links deliver payload-free rows device-resident;
    partitioned/crashed/skewed links — and ALL links while probabilistic
    noise is armed — fall back to the host path, where the plane applies
    its fates. Pair it with ``net=NetFaults.quiet()`` so a directive
    schedule (partitions) is the only fault source and routing actually
    runs (the summary's device_route_stats shows the split).

    ``payload_ring`` (with device_route) additionally stages minted/
    adopted block payloads in each engine's bounded device payload ring,
    so AppendEntries with ring-resident spans route on-chip too — under
    workload traffic this is the produce path itself leaving the host
    (device_route_stats.ring shows staged/routed/spill counts).

    ``flight_wire`` turns on the engines' wire-level trace events
    (msg_sent/msg_delivered, path-tagged routed vs host), so the per-node
    journals — and the merged cluster ``timeline`` the result carries —
    record the message path itself, and the coverage signature gains the
    path-mix and wire-k-gram classes. Every result embeds
    ``coverage`` / ``coverage_signature``, the journal-derived fingerprint
    a nemesis search driver scores runs by (utils/coverage.py).

    ``flight_ring`` sizes each engine's flight-recorder ring (default
    4096). Searched soaks with wire tracing overflow the default and
    silently truncate the timeline the coverage scorer depends on; the
    result's ``flight_ring`` block reports how many events wraparound
    discarded, and a nonzero count logs a warning.

    ``commitless_limit`` arms the availability probe: if no proposal is
    acked for more than this many consecutive virtual ticks during the
    chaotic phase, the run raises an :class:`InvariantViolation`
    ("availability: ..."). Off by default — the bundled schedules' safety
    guarantees are stated without it; the chaos search aims it at
    schedules that starve commit progress entirely (full quorum loss),
    and the result's ``max_commitless_window`` lets a scorer see
    near-misses either way.

    ``leases`` arms tick-denominated leader leases on every engine and
    turns on the per-tick lease-safety checks (non-overlap, term-qualified
    leader exclusion) plus the stale-read probe — a partitioned ex-leader
    must refuse leased serves once its lease expires. Lease soundness is
    stated for the lockstep pacer on a non-duplicating transport, so a
    lease soak REFUSES schedules with skew ops and net profiles with
    ``dup_p > 0`` (a duplicated APPEND_RESP is byte-identical to the next
    idle-heartbeat ack and would over-credit the evidence window); with
    ``net=None`` it defaults to the standard noise profile minus dup.
    Election params get timeout_min = hb_ticks + 3 (the lease margin
    constraint); the result gains a ``lease`` block.

    ``health`` (default ON) arms the online health plane
    (utils/health.py): a HealthMonitor evaluated once per tick off state
    the harness already maintains, journaling ``health_*`` FSM
    transitions into its own flight ring. The result gains a ``health``
    block (detector verdicts + transition events) and the chaos search
    scores it beside the invariants. Turning it off is the
    zero-perturbation twin: a health-off run is byte-identical on
    event_log / journals / state_digest.

    On an invariant violation the run auto-dumps a JSON repro artifact —
    the per-node flight-recorder journals, the metrics-registry dump, the
    fault-event log, and the violation — to ``artifact_path`` (default
    ``chaos_artifact_<schedule>_<seed>.json`` in the working directory);
    the result carries the path as ``artifact``."""
    sched = resolve_schedule(schedule, n_nodes)
    if leases:
        if any(s.op == "skew" for s in sched.steps):
            raise ValueError(
                f"schedule {sched.name!r} has pacer-skew steps: lease "
                "soundness is stated for the lockstep pacer (raft/lease.py)"
                " — run it without --leases")
        if net is not None and net.dup_p > 0:
            raise ValueError(
                f"lease soak needs a dup-free net profile (dup_p="
                f"{net.dup_p}): duplicated APPEND_RESPs over-credit the "
                "lease evidence window")
        if net is None:
            net = NetFaults(dup_p=0.0)
    plane = FaultPlane(seed, n_nodes, net=net)
    if leases:
        hb = 1 if hb_ticks is None else hb_ticks
        params = step_params(timeout_min=hb + 3, timeout_max=hb + 7,
                             hb_ticks=hb, device="cpu")
    else:
        params = DEFAULT_PARAMS if hb_ticks is None else step_params(
            timeout_min=3, timeout_max=8, hb_ticks=hb_ticks, device="cpu")
    spans_rec = None
    if request_spans and workload:
        # Request spans under chaos (utils/spans.py): one recorder on the
        # soak's virtual clock; the workload adapter mints/finishes the
        # spans and the span-enabled engines stamp the consensus rungs.
        # The clock closure late-binds `cluster` (created below) — it is
        # only ever read from drive/harvest, after construction.
        from josefine_tpu_torch.utils.spans import SpanRecorder

        spans_rec = SpanRecorder(clock=lambda: cluster.tick_no)
    traffic = None
    if workload:
        # Product load under the nemesis (workload.chaos_traffic): the
        # tenant/topic model's arrivals replace the synthetic proposal
        # trickle; acks flow into the same checkers. Seeded from the soak
        # seed, so the determinism contract is unchanged.
        from josefine_tpu_torch.workload.chaos_traffic import ChaosTraffic
        from josefine_tpu_torch.workload.model import WorkloadSpec

        spec = WorkloadSpec(**workload).validate()
        traffic = ChaosTraffic(spec, seed, groups, spans=spans_rec)
    cluster = ChaosCluster(seed, n_nodes=n_nodes, groups=groups,
                           window=window, plane=plane, params=params,
                           auto_crash=auto_faults, auto_links=auto_faults,
                           active_set=active_set, device_route=device_route,
                           payload_ring=payload_ring and device_route,
                           flight_wire=flight_wire, workload=traffic,
                           flight_ring=flight_ring or 4096,
                           request_spans=request_spans,
                           migration=migration, leases=leases,
                           health=health, device=device)
    nemesis = Nemesis(sched, plane, cluster)
    ticks = sched.horizon if horizon is None else horizon

    # The whole drive sits inside the violation net: election safety and
    # log matching are checked every tick DURING chaos, and a mid-run
    # violation must still yield the summary + the event log (the repro
    # artifact is the entire point of catching one).
    violation = None
    last_progress = 0   # last chaotic tick where the acked total grew
    max_stall = 0       # longest commitless window seen (search telemetry)
    prev_acked = 0
    if spans_rec is not None:
        # The whole chaotic phase counts as an armed-fault window: every
        # request in flight under the schedule is retained, not just the
        # tail sample (the sampling rule's fault arm).
        spans_rec.fault_active = bool(sched.steps)
    try:
        for _ in range(ticks):
            cluster.step(nemesis=nemesis)
            cluster.drive_traffic()
            cluster.harvest_traffic()
            await asyncio.sleep(0)  # let engine futures resolve
            now_acked = sum(len(v) for v in cluster.acked.values())
            if now_acked > prev_acked:
                prev_acked, last_progress = now_acked, cluster.tick_no
            elif (traffic is None and not cluster.pending
                    and cluster.proposed >= cluster.max_proposals):
                # Nothing is being offered: the synthetic trickle's budget
                # is spent and no proposal is in flight. A commitless
                # window here is absence of LOAD, not of availability —
                # freeze the stall clock instead of false-tripping the
                # probe on a healthy, merely-idle cluster. (The workload
                # source is open-loop and always offering.)
                last_progress = cluster.tick_no
            stall = cluster.tick_no - last_progress
            if stall > max_stall:
                max_stall = stall
            if commitless_limit is not None and stall > commitless_limit:
                raise InvariantViolation(
                    f"availability: no ack committed for {stall} ticks "
                    f"(> commitless_limit {commitless_limit}) at tick "
                    f"{cluster.tick_no}")
        if spans_rec is not None:
            # A migration still unresolved at the horizon keeps the fault
            # arm up through heal: requests straddling the cutover retain
            # their spans unconditionally, so request_report can name the
            # migration stall as a dominant phase (the dual-ownership
            # window is a fault window for attribution purposes).
            spans_rec.fault_active = (cluster.migrator is not None
                                      and cluster.migrator.mig is not None)
        cluster.heal(sched.heal_ticks)
        if spans_rec is not None:
            spans_rec.fault_active = False
        cluster.harvest_traffic()
        cluster.assert_converged_and_linearizable()
    except InvariantViolation as e:
        violation = str(e)
    span_dump = None
    span_summary = None
    if spans_rec is not None:
        # Requests the faults stranded (unresolved futures, retries still
        # delayed at the horizon) close as "aborted" so the artifact
        # carries them — they are the fault arm's whole point. Serialize
        # ONCE; the artifact and the result share the strings.
        traffic.close_spans()
        spans_rec.seal()
        span_dump = spans_rec.dump_jsonl()
        span_summary = spans_rec.summary(table=True)

    journals = cluster.flight_journals_jsonl()
    # Cluster-scope observability: merge the per-node journals into ONE
    # deterministically ordered timeline and distill its coverage
    # signature — the scoring substrate for coverage-guided chaos search.
    journal_events = cluster.flight_journals()
    timeline = merge_journals(journal_events)
    coverage = CoverageMap.from_timeline(timeline, fault_events=plane.events)
    coverage.publish()  # chaos_coverage_features{class=...} on /metrics
    artifact = None
    if violation is not None:
        # Auto-dump the repro artifact: what the consensus state DID
        # (per-node journals), what the counters say (registry dump), and
        # what the nemesis injected (event log) — the structured history a
        # tripped invariant is otherwise missing.
        artifact = artifact_path or os.path.abspath(
            f"chaos_artifact_{sched.name}_{seed}.json")
        try:
            with open(artifact, "w") as fh:
                json.dump({
                    "schedule": sched.name,
                    "seed": seed,
                    "tick": cluster.tick_no,
                    "violation": violation,
                    "journals": journals,
                    "timeline": timeline_jsonl(timeline),
                    "coverage": coverage.to_dict(),
                    "registry": REGISTRY.dump(),
                    "event_log": plane.event_log_jsonl(),
                    "schedule_json": sched.to_json(),
                    # Replayable request-span trees (request_spans on):
                    # the violation's per-request phase story, next to
                    # the journals it joins against on (tick, group).
                    "spans": span_dump,
                    "span_summary": span_summary,
                    # Detector verdicts beside the tripped invariant: the
                    # doctor diagnoses artifacts, so the health story
                    # rides in the repro itself.
                    "health": cluster.health_summary(),
                }, fh, indent=1)
        except OSError:
            artifact = None

    ring_dropped = cluster.flight_ring_dropped()
    if ring_dropped:
        log.warning(
            "flight ring wraparound discarded %d journal events "
            "(capacity %d per engine) — the merged timeline and coverage "
            "signature cover a TRUNCATED history; raise flight_ring "
            "(chaos_soak --flight-ring)", ring_dropped, cluster.flight_ring)

    acked_total = sum(len(v) for v in cluster.acked.values())
    # Idempotent-produce verdict: acked payloads applied more than once in
    # the final owner-row logs. Expected 0 — the retry machinery re-proposes
    # under FRESH payloads, and migration carries the applied prefix exactly
    # once — recorded (not just asserted) so a regression shows up as a
    # nonzero number in every soak summary, not only when a checker trips.
    dup_acked = sum(
        duplicate_acked_count(cluster.acked[g],
                              cluster.fsms[0][cluster.row_of(g)].applied)
        for g in range(groups))
    return {
        "schedule": sched.name,
        "seed": seed,
        "nodes": n_nodes,
        "groups": groups,
        "window": window,
        "active_set": active_set,
        "device_route": device_route,
        "flight_wire": flight_wire,
        "ticks": cluster.tick_no,
        "proposed": cluster.proposed,
        "acked": acked_total,
        "fault_events": len(plane.events),
        "chaos_counters": {
            name: m.values.get((), sum(m.values.values()))
            for name, m in sorted(REGISTRY._metrics.items())
            if name.startswith("chaos_")
        },
        "active_set_stats": {
            "compacted_ticks": sum(e.active_sched_ticks
                                   for e in cluster.engines),
            "fallback_ticks": sum(e.active_fallback_ticks
                                  for e in cluster.engines),
        } if active_set else None,
        # Delivery split under chaos: routed device-resident vs host-path
        # residual (partitions/noise force the latter — a run whose routed
        # count is zero routed nothing, e.g. default probabilistic noise).
        # Both counts are per-CLUSTER (the metrics registry is
        # process-global and would accumulate across soaks in one process).
        "payload_ring": payload_ring and device_route,
        "device_route_stats": {
            "routed_msgs": sum(e.routed_msgs for e in cluster.engines),
            "host_msgs": cluster.host_delivered,
            # Payload-ring split (None with the ring off): blocks staged,
            # payload AEs served on-chip, spills back to the host path —
            # printed beside the routed/host/plane-blocked numbers so a
            # soak line says how much of the PRODUCE path left the host.
            "ring": cluster.fabric.ring_stats(),
        } if device_route else None,
        # Product-load epilogue: offered/acked/retry counters and the
        # per-tenant latency view of THIS run (the registry histogram
        # accumulates across soaks in one process; these are run-local).
        "workload_stats": traffic.stats() if traffic is not None else None,
        # Request-span epilogue (request_spans on, workload-driven):
        # request counts, sampling stats, aggregate phase attribution,
        # and the retained span log (byte-identical across same-seed
        # runs — the flight-journal contract).
        "request_spans": request_spans,
        "span_summary": span_summary,
        "spans": span_dump,
        # Dynamic-target steps that resolved to nothing (e.g. "leader"
        # during a leaderless window): skipped-and-recorded per the
        # nemesis contract; a search scorer reads this as wasted genome.
        "nemesis_skipped": len(nemesis.skipped),
        "nemesis_skipped_steps": list(nemesis.skipped),
        # Longest commitless window of the chaotic phase, and the armed
        # limit (None = probe off): the availability axis of the run.
        "max_commitless_window": max_stall,
        "commitless_limit": commitless_limit,
        # Journal-truncation honesty: nonzero dropped means the timeline
        # (and so the coverage signature) was computed over a truncated
        # history — size the ring up for searched soaks at scale.
        "flight_ring": {"capacity": cluster.flight_ring,
                        "dropped": ring_dropped},
        # Live-migration epilogue (None with the plane off): coordinator
        # outcomes, pause ticks (the refused-traffic window), final
        # stream->row placement, and per-row incarnations.
        "migration": cluster.migration_summary(),
        # Leader-lease epilogue (None with the plane off): ledger coverage
        # (held ticks, holder handovers), stale-read probe tallies, and
        # per-node lane state — nonzero leased_reads is the CI smoke's
        # proof the lane actually served, not just stayed silent.
        "lease": cluster.lease_summary(),
        # Idempotent-produce duplicate scan: acked payloads seen >1x in
        # the owner-row applied logs (expected clean; see above).
        # Online health plane (None with health off): per-detector
        # verdicts (worst level, first-degraded/critical ticks) and the
        # full health_* FSM transition stream — byte-identical across
        # same-seed runs, scored against the chaos corpus by
        # tools/doctor.py.
        "health": cluster.health_summary(),
        "dup_check": {"dup_acked": dup_acked,
                      "verdict": "clean" if dup_acked == 0 else "DUPLICATES"},
        "invariants": "ok" if violation is None else "VIOLATED",
        "violation": violation,
        "artifact": artifact,
        "event_log": plane.event_log_jsonl(),
        # Per-node flight journals (JSONL): byte-identical across same-seed
        # runs — the flight-recorder half of the determinism contract.
        "journals": journals,
        # The merged cluster timeline (JSONL, (tick, node, seq) ordered) and
        # its journal-derived coverage fingerprint — byte-identical /
        # signature-equal across same-seed runs.
        "timeline": timeline_jsonl(timeline),
        "coverage": coverage.to_dict(),
        "coverage_signature": coverage.signature(),
        "registry_dump": REGISTRY.dump(),
        "schedule_json": sched.to_json(),
        "state_digest": cluster.state_digest(),
    }


def run_soak(*args, **kwargs) -> dict:
    return asyncio.run(run_soak_async(*args, **kwargs))
