"""Deterministic multi-tenant Kafka traffic engine (the product-load plane).

The chaos subsystem answers "does consensus survive a hostile network";
this package answers the complementary product question: "what does the
broker→engine path DO under sustained multi-tenant client load at the
batched-P scale". Same discipline as ``chaos/``: one seed reproduces one
run exactly — virtual ticks only, every draw from seeded RNG streams, and
a byte-stable workload event trace (same seed ⇒ identical JSONL).

Pieces:

* :mod:`~josefine_tpu.workload.model` — the tenant/topic universe with
  Zipfian topic popularity;
* :mod:`~josefine_tpu.workload.schedule` — open-loop arrivals on the
  virtual tick axis, consumer-group join/leave churn, seeded retry
  backoff;
* :mod:`~josefine_tpu.workload.trace` — the byte-stable event trace;
* :mod:`~josefine_tpu.workload.driver` — the in-process driver: a live
  single-node :class:`~josefine_tpu.raft.engine.RaftEngine` at
  P = 10k–100k with the REAL broker handlers in front of it (the scale
  path — ``tools/traffic_soak.py``);
* :mod:`~josefine_tpu.workload.wire` — the wire driver: real Kafka
  protocol through ``broker/server.py`` at smaller P (end-to-end truth);
* :mod:`~josefine_tpu.workload.chaos_traffic` — the adapter that runs the
  same tenant model as proposal traffic inside a
  :class:`~josefine_tpu.chaos.harness.ChaosCluster`, so nemesis schedules
  execute under real produce load with per-tenant latency attribution;
* :mod:`~josefine_tpu.workload.genome` — the knob catalog (bounds +
  seeded mutation) the coverage-guided chaos search treats as the
  traffic half of a candidate's genome.
"""

from josefine_tpu_torch.workload.model import TenantModel, WorkloadSpec, zipf_weights
from josefine_tpu_torch.workload.schedule import ArrivalSchedule, Backoff
from josefine_tpu_torch.workload.trace import WorkloadTrace

__all__ = [
    "ArrivalSchedule",
    "Backoff",
    "TenantModel",
    "WorkloadSpec",
    "WorkloadTrace",
    "zipf_weights",
]
