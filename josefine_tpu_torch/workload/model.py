"""Tenant/topic model: the deterministic universe product load runs over.

A workload is (tenants × topics-per-tenant) topics, each with a fixed
partition count, and a Zipfian popularity law over the GLOBAL topic list —
the classic multi-tenant shape: a few hot tenants take most of the
traffic, a long tail idles. Everything here is a pure function of the spec
(plus the caller's seeded RNG for draws), so two runs with the same
(spec, seed) see the same universe and the same draw sequence.

Topic naming is positional (``t0007.2`` = tenant 7's topic 2): names are
legal Kafka topic names, sort stably, and parse back to their tenant
without a lookup table — the trace and the per-tenant metrics key on them.
"""

from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass, field, replace


def zipf_weights(n: int, s: float) -> list[float]:
    """Normalized Zipf(s) probabilities over ranks 0..n-1 (rank 0 hottest).
    ``s = 0`` degenerates to uniform; larger s concentrates the head."""
    if n <= 0:
        raise ValueError("zipf_weights needs n >= 1")
    raw = [1.0 / float(i + 1) ** s for i in range(n)]
    total = sum(raw)
    return [w / total for w in raw]


@dataclass(frozen=True)
class WorkloadSpec:
    """One workload's axes. The bench rows are keyed on
    (tenants, total partitions, skew, offered load)."""

    tenants: int = 8
    topics_per_tenant: int = 1
    partitions_per_topic: int = 2
    # Zipf exponent over the global topic list (0 = uniform).
    skew: float = 1.1
    # Open-loop offered load: produced batches per virtual tick across the
    # whole cluster (fractional rates accumulate credit).
    produce_per_tick: float = 8.0
    records_per_batch: int = 4
    payload_bytes: int = 48
    # Consumer plane: sessions per tenant, fetch/commit cadence in ticks.
    consumers_per_tenant: int = 1
    fetch_every_ticks: int = 4
    commit_every_ticks: int = 16
    # Bounded per-tenant produce inflight; arrivals beyond it queue, and
    # the queue itself is bounded (see driver) — open loop, closed memory.
    max_inflight_per_tenant: int = 4
    # Consumer-group churn: every this many ticks one seeded tenant's
    # consumer group loses or regains a member (0 = no churn).
    churn_every_ticks: int = 0
    # Seeded retry/backoff on NotLeader / backpressure, in virtual ticks.
    retry_backoff_min: int = 2
    retry_backoff_max: int = 16
    max_retries: int = 8

    def validate(self) -> "WorkloadSpec":
        if self.tenants < 1 or self.topics_per_tenant < 1:
            raise ValueError("workload needs >= 1 tenant and topic each")
        if self.partitions_per_topic < 1:
            raise ValueError("partitions_per_topic must be >= 1")
        if self.skew < 0:
            raise ValueError("skew must be >= 0")
        if self.produce_per_tick < 0:
            raise ValueError("produce_per_tick must be >= 0")
        if self.retry_backoff_min < 1 \
                or self.retry_backoff_max < self.retry_backoff_min:
            raise ValueError("retry backoff bounds must satisfy "
                             "1 <= min <= max")
        return self

    @property
    def total_topics(self) -> int:
        return self.tenants * self.topics_per_tenant

    @property
    def total_partitions(self) -> int:
        return self.total_topics * self.partitions_per_topic

    @classmethod
    def from_axes(cls, tenants: int, partitions: int, skew: float,
                  load: float, **overrides) -> "WorkloadSpec":
        """Build a spec from the bench axes: ``partitions`` is the TOTAL
        partition count, split evenly over one topic per tenant (remainders
        round down; at least 1 partition per topic)."""
        per_topic = max(1, partitions // max(1, tenants))
        spec = cls(tenants=tenants, topics_per_tenant=1,
                   partitions_per_topic=per_topic, skew=skew,
                   produce_per_tick=load)
        return replace(spec, **overrides).validate()


@dataclass
class TenantModel:
    """The materialized universe: global topic list + Zipf CDF over it."""

    spec: WorkloadSpec
    topic_names: list[str] = field(init=False)
    topic_tenant: list[int] = field(init=False)
    _cdf: list[float] = field(init=False)

    def __post_init__(self):
        self.spec.validate()
        self.topic_names = [
            f"t{tenant:04d}.{t}"
            for tenant in range(self.spec.tenants)
            for t in range(self.spec.topics_per_tenant)
        ]
        self.topic_tenant = [
            tenant
            for tenant in range(self.spec.tenants)
            for _ in range(self.spec.topics_per_tenant)
        ]
        w = zipf_weights(len(self.topic_names), self.spec.skew)
        self._cdf = list(itertools.accumulate(w))

    @staticmethod
    def tenant_of(topic: str) -> int:
        """``t0007.2`` -> 7 (inverse of the positional naming)."""
        if not topic.startswith("t") or "." not in topic:
            raise ValueError(f"not a workload topic name: {topic!r}")
        return int(topic[1:topic.index(".")])

    @staticmethod
    def tenant_label(tenant: int) -> str:
        """The metric/trace label for a tenant (fixed-width, sortable)."""
        return f"t{tenant:04d}"

    def draw_topic(self, rng) -> int:
        """Zipf-weighted topic index from the caller's seeded RNG. Clamped:
        float rounding can leave the last CDF entry a few ulp below 1.0,
        and a draw landing in that sliver must not index past the end."""
        return min(bisect.bisect_left(self._cdf, rng.random()),
                   len(self.topic_names) - 1)

    def draw_partition(self, rng) -> int:
        return rng.randrange(self.spec.partitions_per_topic)

    def topics_of_tenant(self, tenant: int) -> list[str]:
        k = self.spec.topics_per_tenant
        return self.topic_names[tenant * k:(tenant + 1) * k]
