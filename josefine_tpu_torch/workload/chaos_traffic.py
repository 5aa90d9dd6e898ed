"""Workload traffic inside the chaos harness: nemesis under product load.

The chaos cluster's built-in ``maybe_propose`` mints a thin synthetic
trickle — enough to prove durability, nothing like a workload. This
adapter drives the SAME tenant/topic model as the product drivers through
a :class:`~josefine_tpu.chaos.harness.ChaosCluster`: Zipf-skewed arrivals
mapped onto the cluster's consensus groups, bounded per-tenant inflight,
seeded backoff when a group is leaderless or a proposal fails, and
per-tenant commit-latency attribution into the same
``workload_commit_latency_ticks`` histogram the in-process driver
publishes — so a leader-partition nemesis runs against real produce load
and the summary can show which tenants' latency it hurt.

Acked payloads are appended to ``cluster.acked``/``ack_tick``, so every
existing safety checker (durability, exactly-once, linearizable order)
applies to the workload's writes unchanged.

Retry semantics: a failed proposal is retried with a FRESH payload
(``:r<attempt>`` suffix). A future that fails with NotLeader may describe
a block that was never minted — safe to resend verbatim — but one whose
leader was deposed after minting can still commit under a successor, and
re-sending the identical payload would then be a duplicate the
exactly-once checker rightly flags. A fresh payload models what a real
client does: re-send with a new idempotency key; the abandoned original
is simply never acked, which the checkers allow.
"""

from __future__ import annotations

from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.spans import SpanLedger, bind_span, unbind_span
from josefine_tpu_torch.workload.model import TenantModel, WorkloadSpec
from josefine_tpu_torch.workload.schedule import (
    AdmissionState,
    ArrivalSchedule,
    ProduceArrival,
)

# Shared with workload.driver by registry get-or-create (same series).
_m_lat = REGISTRY.histogram("workload_commit_latency_ticks", max_series=256)
_m_retries = REGISTRY.counter("workload_retries_total")


class ChaosTraffic:
    """Drives workload arrivals as proposals inside a ChaosCluster."""

    def __init__(self, spec: WorkloadSpec, seed: int, groups: int,
                 spans=None):
        self.spec = spec.validate()
        self.model = TenantModel(spec)
        self.sched = ArrivalSchedule(spec, seed)
        self.groups = groups
        # Request-span recorder (utils/spans.py), chaos flavor: one span
        # per produce REQUEST (not per attempt), minted at first enqueue,
        # bound around the leader's propose() so the engine stamps the
        # consensus rungs, finished at harvest. The soak holds
        # spans.fault_active True for the chaotic phase, so every request
        # the nemesis touched is retained alongside the tail sample. The
        # bookkeeping is the shared SpanLedger — the same one-span-per-
        # (tenant, seq) invariant the in-process driver maintains.
        self.spans = spans
        self._ledger = SpanLedger(spans)
        # Partition -> chaos group: global partition index modulo G (the
        # harness's groups are all data groups; no metadata row here).
        self._ppt = spec.partitions_per_topic
        # Bounded admission: the same shared policy object as the
        # in-process driver (one implementation of queue cap / inflight /
        # retry ledger — the planes cannot silently diverge).
        self._adm = AdmissionState(spec)
        # (arr, attempt, first_tick, group, payload, fut)
        self.pending: list[tuple] = []
        # Per-group outstanding REQUESTS (not attempts): incremented at
        # first successful enqueue, decremented on ack/shed/gave_up. This
        # deliberately includes work parked in the retry backlog — during
        # a leaderless window no future exists (``_admit`` re-queues
        # without submitting), yet the work is still waiting, which is
        # exactly the signal the health plane's commit-stall detector
        # gates on (see ChaosCluster.health_sample).
        self.outstanding = [0] * groups
        self.latencies: list[tuple[int, int]] = []  # (tenant, lat_ticks)
        self.n_offered = 0
        self.n_admitted = 0
        self.n_acked = 0
        self.n_failed = 0
        self.n_retries = 0
        self.n_no_leader = 0
        self.n_shed = 0
        self.n_gave_up = 0

    def group_of(self, arr: ProduceArrival) -> int:
        topic_index = (arr.tenant * self.spec.topics_per_tenant
                       + int(arr.topic.rsplit(".", 1)[1]))
        return (topic_index * self._ppt + arr.partition) % self.groups

    def _payload(self, arr: ProduceArrival, attempt: int) -> bytes:
        p = arr.payload(self.spec)
        return p if attempt == 0 else p + b":r%d" % attempt

    # ------------------------------------------------------------- drive

    def drive(self, cluster) -> None:
        """One tick's worth of offered load into the cluster (called from
        the soak loop in place of maybe_propose)."""
        t = cluster.tick_no
        for arr, attempt, first in self._adm.mature(t):
            self._enqueue(arr, attempt, first)
        for arr in self.sched.produce_arrivals(t):
            self.n_offered += 1
            self._enqueue(arr, 0, t)
        for tenant in range(self.spec.tenants):
            for arr, attempt, first in self._adm.admit_ready(tenant):
                self._admit(cluster, t, arr, attempt, first)

    def _enqueue(self, arr: ProduceArrival, attempt: int,
                 first: int) -> None:
        if self._ledger and attempt == 0:
            self._ledger.open(
                (arr.tenant, arr.seq), "produce",
                tenant=TenantModel.tenant_label(arr.tenant),
                topic=arr.topic, partition=arr.partition)
        if not self._adm.enqueue(arr, attempt, first):
            self.n_shed += 1
            self._ledger.finish((arr.tenant, arr.seq), "shed")
            if attempt > 0:
                # A matured retry shed at the queue is terminal for a
                # request counted outstanding at its first enqueue.
                self.outstanding[self.group_of(arr)] -= 1
            return
        if attempt == 0:
            self.outstanding[self.group_of(arr)] += 1

    def _admit(self, cluster, t: int, arr: ProduceArrival, attempt: int,
               first: int) -> None:
        g = self.group_of(arr)
        # Streams ride their OWNING engine row (identity unless a live
        # migration cut over) — the re-route half of the client machinery:
        # a retry that raced a cutover re-resolves to the new row here.
        row = cluster.row_of(g) if hasattr(cluster, "row_of") else g
        leader = None
        for i in cluster.live_nodes():
            if cluster.engines[i].is_leader(row):
                leader = cluster.engines[i]
                break
        if leader is None:
            # No submit happened: release the slot admit_ready claimed.
            self._adm.done(arr.tenant)
            self.n_no_leader += 1
            self._retry(t, arr, attempt, first)
            return
        payload = self._payload(arr, attempt)
        span = self._ledger.get((arr.tenant, arr.seq))
        if span is not None:
            # Synchronous bind/unbind around the propose — the adapter
            # runs on the soak loop, not in a per-request task.
            tok = bind_span(span)
            try:
                fut = leader.propose(row, payload)
            finally:
                unbind_span(tok)
        else:
            fut = leader.propose(row, payload)
        cluster.submit_tick[payload] = t
        cluster.proposed += 1
        self.n_admitted += 1
        self.pending.append((arr, attempt, first, g, payload, fut))

    def _retry(self, t: int, arr: ProduceArrival, attempt: int,
               first: int) -> None:
        if not self._adm.schedule_retry(t, arr, attempt, first,
                                        self.sched.retry_delay):
            self.n_gave_up += 1
            self._ledger.finish((arr.tenant, arr.seq), "gave_up")
            self.outstanding[self.group_of(arr)] -= 1
            return
        self.n_retries += 1
        _m_retries.inc()

    # ----------------------------------------------------------- harvest

    def harvest(self, cluster) -> None:
        t = cluster.tick_no
        still = []
        for entry in self.pending:
            arr, attempt, first, g, payload, fut = entry
            if not fut.done():
                still.append(entry)
                continue
            self._adm.done(arr.tenant)
            if fut.cancelled() or fut.exception() is not None:
                self.n_failed += 1
                self._retry(t, arr, attempt, first)
                continue
            cluster.acked[g].append(payload)
            cluster.ack_tick[payload] = t
            self.n_acked += 1
            self.outstanding[g] -= 1
            lat = t - first
            self.latencies.append((arr.tenant, lat))
            self._ledger.finish((arr.tenant, arr.seq), "ok")
            _m_lat.observe(lat,
                           tenant=TenantModel.tenant_label(arr.tenant))
        self.pending = still

    def outstanding_by_group(self, groups: int) -> list[int]:
        """Outstanding request counts, padded/clipped to `groups` entries
        (the health plane's per-group pending signal)."""
        out = list(self.outstanding[:groups])
        out.extend(0 for _ in range(groups - len(out)))
        return out

    def close_spans(self, status: str = "aborted") -> None:
        """End-of-soak epilogue: finish every span still open — requests
        the fault plane stranded (futures that never resolve) or retries
        still delayed when the horizon ran out. These are exactly the
        requests the fault-arm sampling exists to retain, so they must
        land in the artifact, not leak as open entries."""
        self._ledger.close_all(status)

    # ----------------------------------------------------------- summary

    def stats(self) -> dict:
        lats = sorted(lat for _, lat in self.latencies)

        def q(p: float) -> float:
            if not lats:
                return 0.0
            return float(lats[min(len(lats) - 1, int(p * len(lats)))])

        return {
            "tenants": self.spec.tenants,
            "offered": self.n_offered,
            "admitted": self.n_admitted,
            "acked": self.n_acked,
            "failed": self.n_failed,
            "retries": self.n_retries,
            "no_leader": self.n_no_leader,
            "shed": self.n_shed,
            "gave_up": self.n_gave_up,
            "latency_ticks": {"n": len(lats), "p50": q(0.5),
                              "p99": q(0.99)},
            "tenants_with_latency":
                len({tenant for tenant, _ in self.latencies}),
        }
