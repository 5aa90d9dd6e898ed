"""Byte-stable workload event trace.

Same contract as the chaos fault-event log and the flight-recorder
journal: tick-indexed, wall-clock-free, emitted in a deterministic order,
serialized as sorted-key compact JSONL — two runs with the same (spec,
seed) produce byte-identical traces, and the soak summary quotes the
trace's sha256 so CI can assert it with one string compare.

Event vocabulary (kind / detail):

* ``topic_create`` / ``topic_ready`` / ``topic_delete`` — lifecycle;
* ``produce`` — an arrival admitted to the broker (tenant, topic, part,
  seq, attempt);
* ``produce_ok`` — commit acked (adds ``base`` offset and ``lat`` in
  virtual ticks from the FIRST attempt's admission);
* ``backpressure`` — refused by the admission gate
  (THROTTLING_QUOTA_EXCEEDED), will retry;
* ``produce_rejected`` — NotLeader/unknown-topic refusal (clean failure;
  retried while the topic exists);
* ``produce_err`` — non-retryable error code (dropped);
* ``retry`` / ``gave_up`` / ``shed`` — backoff scheduling, retry budget
  exhausted, per-tenant queue overflow;
* ``fetch`` — one consumer's fetch round (bytes, records, parts);
* ``offset_commit`` — a consumer session committed its positions;
* ``consumer_join`` / ``consumer_leave`` / ``rebalance`` — churn and the
  resulting assignment change;
* ``recycle_ack`` — a released consensus row's reset ack committed.
"""

from __future__ import annotations

import hashlib
import json


class WorkloadTrace:
    """Append-only structured event list with canonical serialization."""

    def __init__(self):
        self.events: list[dict] = []
        self.seq = 0

    def emit(self, tick: int, kind: str, **detail) -> None:
        ev = {"seq": self.seq, "tick": int(tick), "kind": kind}
        ev.update(detail)
        self.events.append(ev)
        self.seq += 1

    def jsonl(self) -> str:
        return "".join(
            json.dumps(e, sort_keys=True, separators=(",", ":")) + "\n"
            for e in self.events)

    def sha256(self) -> str:
        return hashlib.sha256(self.jsonl().encode()).hexdigest()

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(self.jsonl())
