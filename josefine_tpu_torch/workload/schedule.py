"""Open-loop arrival schedule on the virtual tick axis.

The schedule is the workload's clock-free heart: given (spec, seed) it
emits the same arrival sequence forever — no wall clock, no unseeded
randomness (graftlint's determinism family checks this package). Offered
load is OPEN loop: arrivals keep coming at the configured rate whether or
not earlier produces completed; admission control (bounded per-tenant
inflight, broker backpressure) is the driver's job, which is exactly what
makes backpressure measurable instead of self-hiding.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass

from josefine_tpu_torch.workload.model import TenantModel, WorkloadSpec


@dataclass(frozen=True)
class ProduceArrival:
    """One offered produce: a batch for (topic, partition), minted at
    ``tick`` with a workload-unique ``seq`` (payloads embed it, so
    cross-tenant delivery is detectable and linearizability checkers can
    key on the payload)."""

    tick: int
    seq: int
    tenant: int
    topic: str
    partition: int

    def payload(self, spec: WorkloadSpec) -> bytes:
        # '=' padding: illegal in Kafka topic names, so a verifier can
        # split the header off unambiguously (topics may contain '.').
        base = b"w:%d:%d:%s:%d" % (self.tenant, self.seq,
                                   self.topic.encode(), self.partition)
        pad = spec.payload_bytes - len(base)
        return base + (b"=" * pad if pad > 0 else b"")


@dataclass(frozen=True)
class ChurnEvent:
    """Consumer-group membership churn: one tenant's group loses
    (``kind='leave'``) or regains (``'join'``) a consumer session."""

    tick: int
    tenant: int
    kind: str  # 'join' | 'leave'


class Backoff:
    """Seeded exponential backoff in virtual ticks: attempt k waits
    ``min(min_t * 2**k, max_t)`` plus jitter in [0, base) drawn from the
    caller's RNG — retries de-synchronize deterministically."""

    def __init__(self, min_ticks: int, max_ticks: int):
        self.min_ticks = int(min_ticks)
        self.max_ticks = int(max_ticks)

    def delay(self, attempt: int, rng: random.Random) -> int:
        base = min(self.min_ticks << min(attempt, 16), self.max_ticks)
        return base + rng.randrange(max(1, base))


class AdmissionState:
    """Bounded-admission bookkeeping shared by the in-process driver and
    the chaos traffic adapter (ONE copy of the policy, so the two planes
    cannot silently diverge): per-tenant pending queues with a bounded
    cap, per-tenant inflight counts, and the delayed-retry ledger with
    deterministic maturation order. Side effects (tracing, metrics, the
    actual submit) stay with the caller — this class only answers
    admit/shed/retry questions."""

    def __init__(self, spec: WorkloadSpec):
        self.spec = spec
        self.queue_cap = max(8, 4 * spec.max_inflight_per_tenant)
        self.queues: list[deque] = [deque() for _ in range(spec.tenants)]
        self.inflight = [0] * spec.tenants
        # (due_tick, arrival, attempt, first_tick)
        self.delayed: list[tuple[int, ProduceArrival, int, int]] = []

    def enqueue(self, arr: ProduceArrival, attempt: int,
                first_tick: int) -> bool:
        """Queue one (re)arrival; False = queue full, the caller sheds."""
        q = self.queues[arr.tenant]
        if len(q) >= self.queue_cap:
            return False
        q.append((arr, attempt, first_tick))
        return True

    def mature(self, tick: int) -> list[tuple[ProduceArrival, int, int]]:
        """Due retries in deterministic (due, seq, attempt) order; they do
        NOT re-enter the queues here — the caller enqueues (and sheds)."""
        if not self.delayed:
            return []
        due = sorted((d for d in self.delayed if d[0] <= tick),
                     key=lambda d: (d[0], d[1].seq, d[2]))
        if due:
            self.delayed = [d for d in self.delayed if d[0] > tick]
        return [(arr, attempt, first) for _, arr, attempt, first in due]

    def admit_ready(self, tenant: int):
        """Pop queued work for ``tenant`` while its inflight bound allows;
        the caller submits each and MUST later call :meth:`done`."""
        q = self.queues[tenant]
        while q and self.inflight[tenant] < self.spec.max_inflight_per_tenant:
            self.inflight[tenant] += 1
            yield q.popleft()

    def done(self, tenant: int) -> None:
        self.inflight[tenant] -= 1

    def schedule_retry(self, tick: int, arr: ProduceArrival, attempt: int,
                       first_tick: int, delay_fn) -> bool:
        """Record a retry; False = the attempt budget is spent (gave up).
        ``delay_fn(attempt)`` is only consulted when the budget allows, so
        a refused retry never consumes a draw from the retry RNG stream
        (keeps the trace identical to the pre-refactor drivers)."""
        if attempt + 1 > self.spec.max_retries:
            return False
        self.delayed.append((tick + int(delay_fn(attempt)), arr,
                             attempt + 1, first_tick))
        return True

    def pending(self) -> int:
        return len(self.delayed) + sum(len(q) for q in self.queues)

    def clear(self) -> None:
        self.delayed = []
        for q in self.queues:
            q.clear()
        self.inflight = [0] * self.spec.tenants


class ArrivalSchedule:
    """The per-tick event source. One seeded RNG stream drives every draw
    (topic choice, partition choice, churn victim), so the sequence of
    events is a pure function of (spec, seed) regardless of how the driver
    consumes them."""

    def __init__(self, spec: WorkloadSpec, seed: int):
        self.spec = spec.validate()
        self.model = TenantModel(spec)
        self.rng = random.Random((seed << 16) ^ 0x70AD)
        # Separate stream for retry jitter: retries depend on engine
        # outcomes, and coupling them into the arrival stream would make
        # the OFFERED sequence depend on served behavior. Both streams are
        # seeded, so the full trace is still a pure function of the seed.
        self._retry_rng = random.Random((seed << 16) ^ 0x0FF5)
        self.backoff = Backoff(spec.retry_backoff_min, spec.retry_backoff_max)
        self._credit = 0.0
        self._seq = 0
        # Per-tenant live consumer count for churn bookkeeping (sessions
        # are identified by index; churn toggles the highest index).
        self._live_consumers = [spec.consumers_per_tenant] * spec.tenants

    def produce_arrivals(self, tick: int) -> list[ProduceArrival]:
        """Open-loop arrivals for one tick (credit accumulator: fractional
        rates land exactly, with no RNG spent on the count)."""
        self._credit += self.spec.produce_per_tick
        n = int(self._credit)
        self._credit -= n
        out = []
        for _ in range(n):
            ti = self.model.draw_topic(self.rng)
            out.append(ProduceArrival(
                tick=tick, seq=self._seq,
                tenant=self.model.topic_tenant[ti],
                topic=self.model.topic_names[ti],
                partition=self.model.draw_partition(self.rng)))
            self._seq += 1
        return out

    def churn_events(self, tick: int) -> list[ChurnEvent]:
        """At the churn cadence, toggle one seeded tenant's consumer
        count: a tenant at full strength loses a session, a depleted one
        regains it — sustained churn without ever emptying a group."""
        every = self.spec.churn_every_ticks
        if not every or tick == 0 or tick % every:
            return []
        tenant = self.rng.randrange(self.spec.tenants)
        full = self.spec.consumers_per_tenant
        if self._live_consumers[tenant] >= full and full > 0:
            self._live_consumers[tenant] -= 1
            return [ChurnEvent(tick=tick, tenant=tenant, kind="leave")]
        if self._live_consumers[tenant] < full:
            self._live_consumers[tenant] += 1
            return [ChurnEvent(tick=tick, tenant=tenant, kind="join")]
        return []

    def retry_delay(self, attempt: int) -> int:
        """Backoff draw for a failed produce (NotLeader / backpressure),
        from the dedicated retry stream."""
        return self.backoff.delay(attempt, self._retry_rng)
