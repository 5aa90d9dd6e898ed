"""Consensus flight recorder: a bounded, deterministic journal of engine
transitions.

Counters say *how much*; the flight recorder says *what happened, in what
order*. Each entry is a structured event ``{seq, tick, kind, group, term,
leader, detail}`` appended by :class:`~josefine_tpu.raft.engine.RaftEngine`
at host-visible consensus transitions:

* ``election_won`` / ``election_lost`` — device role transitions observed
  by the tick-finish mirror diff (won = the mint-authority grant; lost = a
  candidacy that collapsed back to follower);
* ``leader_change`` / ``term_bump`` — the same diff on the leader/term
  mirrors (every node records the change, not just the winner);
* ``snapshot_install`` — a leader snapshot adopted over the local chain;
* ``group_reset`` / ``group_recycled`` / ``parole_lifted`` — group
  lifecycle (reset carries the vote-parole watermark when one was set);
* ``active_mode_flip`` — the active-set scheduler crossing between the
  compacted path and the dense fallback;
* ``pipeline_defer`` — a host-side message (snapshot chunk/ack) deferred
  because a pipelined dispatch was in flight;
* ``backlog_drop`` — the per-src intake backlog cap discarding a stale
  batch;
* ``msg_sent`` / ``msg_delivered`` — wire-level trace events (config-gated,
  ``raft.flight_wire``, default off): one event per consensus message at
  the sender's outbox decision point (host decode or the RouteFabric's
  device-resident scatter, ``detail.path`` tagging which) and at the
  receiver's inbox consumption, carrying ``{kind, src, dst}`` in detail
  and (group, term) in the event header — enough to resolve a send to its
  delivery across node journals (:func:`merge_journals`,
  tools/trace_report.py).

Design constraints, in order:

1. **Deterministic.** Events are indexed by the engine's device tick and a
   per-recorder sequence number; nothing wall-clock-derived is ever
   recorded, so two same-seed chaos runs yield byte-identical journals
   (``dump_jsonl`` — sorted keys, compact separators; pinned by
   tests/test_flight.py).
2. **Near-free.** Emission sites are transitions the engine's tick-finish
   already detects by diffing the host mirrors (the active-set scheduler
   maintains them anyway); steady-state ticks emit nothing.
3. **Bounded.** A ring (default 4096 events) — a week-long soak journals
   the same memory as a 30-tick test. ``seq`` keeps counting past
   evictions, so a reader can tell how much history scrolled off.
"""

from __future__ import annotations

import json
from collections import deque

__all__ = ["FlightRecorder", "filter_events", "merge_journals",
           "timeline_jsonl"]


def filter_events(events, group: int | None = None, kind: str | None = None,
                  limit: int | None = None, since: int | None = None) -> list:
    """Shared journal filter (the recorder's ``events()`` and the
    MetricsServer ``/events`` query params are the same semantics, defined
    once): optional group/kind match plus a ``since`` sequence cursor
    (events STRICTLY after that seq — a poller resumes from the last seq it
    saw instead of re-downloading the ring; a cursor that already scrolled
    off the ring simply yields everything still held, and the seq gap tells
    the poller how much it missed), then keep the newest ``limit``
    (``limit=0`` returns nothing, not everything)."""
    if since is not None:
        since = int(since)
        events = (e for e in events if e.get("seq", 0) > since)
    if group is not None:
        events = (e for e in events if e.get("group") == group)
    if kind is not None:
        events = (e for e in events if e.get("kind") == kind)
    out = list(events)
    if limit is not None:
        out = out[-int(limit):] if int(limit) > 0 else []
    return out


def _js(v):
    """JSON-safe, determinism-safe coercion for detail values (numpy
    scalars flatten to Python ints/floats; everything else must already be
    a plain str/int/float/bool)."""
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, float):
        return float(v)
    try:
        return int(v)
    except (TypeError, ValueError):
        return str(v)


class FlightRecorder:
    """Bounded ring of structured consensus events (see module docstring)."""

    __slots__ = ("_ring", "seq", "capacity")

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self.seq = 0  # events ever emitted (monotone past ring eviction)

    def emit(self, tick: int, kind: str, group: int = -1, term: int = -1,
             leader: int = -1, **detail) -> None:
        ev = {
            "seq": self.seq,
            "tick": int(tick),
            "kind": kind,
            "group": int(group),
            "term": int(term),
            "leader": int(leader),
        }
        if detail:
            ev["detail"] = {k: _js(v) for k, v in sorted(detail.items())}
        self.seq += 1
        self._ring.append(ev)

    def emit_many(self, tick: int, kind: str, groups, terms, msg_kinds,
                  srcs, dsts, path: str) -> None:
        """Bulk wire-trace append (``msg_sent`` / ``msg_delivered``): one
        event per entry of the position-aligned columns — the caller's
        ALREADY-computed nonzero pass over an outbox/inbox plane, so the
        emission adds no scan of its own. ``srcs``/``dsts`` may be scalars
        (one endpoint is always "me"). Detail carries the message
        ``{dst, kind, path, src}``; the event header carries (group, term)
        so a send resolves to its delivery by (group, src, dst, kind,
        term) across node journals."""
        n = len(groups)
        if not n:
            return
        src_col = srcs if hasattr(srcs, "__len__") else None
        dst_col = dsts if hasattr(dsts, "__len__") else None
        src_s = None if src_col is not None else int(srcs)
        dst_s = None if dst_col is not None else int(dsts)
        t = int(tick)
        seq = self.seq
        ring = self._ring
        for i in range(n):
            ring.append({
                "seq": seq,
                "tick": t,
                "kind": kind,
                "group": int(groups[i]),
                "term": int(terms[i]),
                "leader": -1,
                "detail": {
                    "dst": dst_s if dst_col is None else int(dst_col[i]),
                    "kind": int(msg_kinds[i]),
                    "path": path,
                    "src": src_s if src_col is None else int(src_col[i]),
                },
            })
            seq += 1
        self.seq = seq

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        """Events evicted by ring wraparound (``seq`` counts every emit;
        the ring holds at most ``capacity``) — nonzero means the journal a
        reader sees is a TRUNCATED suffix of the run's history, which a
        coverage scorer must know about (run_soak warns on it)."""
        return self.seq - len(self._ring)

    def events(self, limit: int | None = None, group: int | None = None,
               kind: str | None = None,
               since: int | None = None) -> list[dict]:
        """The journal (oldest first), optionally filtered; ``limit`` keeps
        the newest N after filtering, ``since`` drops events at or before
        that seq (the poller cursor). Returns copies — callers may mutate."""
        return [dict(e) for e in
                filter_events(self._ring, group=group, kind=kind,
                              limit=limit, since=since)]

    def tail(self, n: int = 32) -> list[dict]:
        return self.events(limit=n)

    def dump_jsonl(self) -> str:
        """One compact JSON object per line, sorted keys — byte-identical
        across same-seed runs (the chaos determinism contract)."""
        return "\n".join(
            json.dumps(e, sort_keys=True, separators=(",", ":"))
            for e in self._ring
        ) + ("\n" if self._ring else "")

    def clear(self) -> None:
        self._ring.clear()
        self.seq = 0


def _node_order(node):
    """Numeric node names sort numerically (node "10" after node "2");
    non-numeric names sort lexically after every numeric one."""
    s = str(node)
    try:
        return (0, int(s), s)
    except ValueError:
        return (1, 0, s)


def merge_journals(journals) -> list[dict]:
    """Merge per-node flight journals into ONE cluster timeline.

    ``journals`` maps a node name to that node's events — a list of event
    dicts (``FlightRecorder.events()`` / ``ChaosCluster.flight_journals()``)
    or a JSONL string (the soak artifact / ``--journals`` form). Each event
    is copied with two annotations:

    * ``node`` — the journal key it came from (str);
    * ``epoch`` — how many ``boot`` markers (restart boundaries, the chaos
      harness archives them with ``seq == -1``) precede it in its own
      journal, so a crash/restart's tick-counter reset is visible to
      readers.

    Ordering is the deterministic merge rule: sort by ``(tick, node, seq)``
    with a STABLE sort, nodes in numeric order. Ticks are each engine's own
    device-tick clock — in lockstep drivers (the chaos harness) they
    advance together, so the order is causally consistent: a message's
    ``msg_sent`` (stamped at the sending tick's finish) always precedes its
    ``msg_delivered`` (stamped at the consuming dispatch), and both precede
    the state transitions that dispatch journals. Restart epochs fold back
    to low ticks (an engine's clock restarts at 0); the ``epoch`` column is
    how a reader keeps them apart. Two same-seed chaos runs merge to
    byte-identical timelines (tests/test_chaos_determinism.py).
    """
    rows: list[tuple] = []
    for node in sorted(journals, key=_node_order):
        evs = journals[node]
        if isinstance(evs, (str, bytes)):
            if isinstance(evs, bytes):
                evs = evs.decode()
            evs = [json.loads(line) for line in evs.splitlines() if line]
        epoch = 0
        for ev in evs:
            e = dict(ev)
            e["node"] = str(node)
            e["epoch"] = epoch
            rows.append((e.get("tick", 0), _node_order(node),
                         e.get("seq", 0), e))
            if e.get("kind") == "boot":
                epoch += 1
    rows.sort(key=lambda r: r[:3])
    return [r[3] for r in rows]


def timeline_jsonl(timeline: list[dict]) -> str:
    """JSONL form of a merged timeline (sorted keys, compact separators) —
    byte-identical across same-seed runs, same contract as
    :meth:`FlightRecorder.dump_jsonl`."""
    return "\n".join(
        json.dumps(e, sort_keys=True, separators=(",", ":"))
        for e in timeline
    ) + ("\n" if timeline else "")
