"""Request-scoped causal tracing: tick-denominated spans from wire byte
to commit and back.

The flight recorder (utils/flight.py) journals what the CLUSTER did —
elections, wire edges, lifecycle. Nothing it records explains a single
request: when a tenant's produce sits at p99 7.8 ticks, the journal
cannot say whether the time went to admission backpressure, the propose
queue, consensus rounds, FSM apply, or response serving. This module is
that instrument: a :class:`SpanRecorder` (bounded, wall-clock-free,
same-seed byte-identical — the FlightRecorder discipline) holding
:class:`RequestSpan` trees, one per request, each a ladder of named tick
marks that derive the five phase spans:

========== =====================================================
phase      boundary (mark ladder)
========== =====================================================
admission  ``begin`` → ``admitted``   (frame decode / first enqueue up
                                      to proposal submit: backpressure
                                      waits, tenant-queue waits, retry
                                      backoff all land here)
queue      ``admitted`` → ``minted``  (proposal queue → device mint)
consensus  ``minted`` → ``committed`` (replication rounds to quorum)
apply      ``committed`` → ``applied``(commit advancement → FSM apply;
                                      0 on this engine — apply runs in
                                      the same tick_finish — kept so the
                                      vocabulary survives an async-apply
                                      future)
serve      ``applied`` → ``end``      (response build + write-out)
========== =====================================================

Read-path requests (fetch, metadata, offset fetch) never call
``propose`` and so never mark the middle rungs; the ladder carries each
missing mark forward, collapsing the untraversed phases to zero. The
carry also CLAMPS every mark into ``[begin, end]``, so the five phases
always telescope to exactly ``end - begin`` — a span tree's phases sum
to the request's observed tick latency by construction, and
``tools/request_report.py`` re-checks it per tree.

Every mark is a tick on the engine's existing tick axis (the recorder's
``clock`` callable — the workload driver wires
``engine._flight_tick``, the product node the same): no wall clock
anywhere, so two same-seed runs retain byte-identical span logs
(``dump_jsonl`` — sorted keys, compact separators, same contract as the
flight journal).

**Trace context.** A span is minted at the broker's frame decode (wire
path, ``broker/server.py``) or the driver's submit (in-process path,
``workload/driver.py``) and travels to the engine through a
``contextvars`` context variable (:func:`bind_span` /
:func:`current_span`) instead of threading an argument through every
handler signature. The engine reads it ONCE per ``propose`` — gated on
``raft.request_spans`` so the off path is a single bool — and carries
the span object inside its existing ``(payload, fut, submit_tick)``
proposal triple (now a 4-tuple) to the mint/commit/apply sites in
``tick_finish``, which stamp the middle rungs.

**Deterministic tail sampling.** Retaining every tree at 10k+ requests
per window would dwarf the flight ring, and uniform sampling keeps the
boring median. Finished spans buffer per tick *window*
(``window_ticks``); when a window seals (the first finish whose end
tick crossed the boundary), the slowest ``sample_top_k`` trees — ties
broken by rid, so the choice is a pure function of the run — are
retained, PLUS every span flagged by an armed fault
(``fault_active``, toggled by the chaos soaks for the chaotic phase)
and every span that finished with a FAILURE status (not in
:attr:`SpanRecorder.BENIGN` — routine acks=0 ``no_response`` outcomes
must not flood the ring). Everything else contributes
only to the per-tenant phase-attribution aggregate (bounded,
``_other``-folded past ``agg_series`` keys) and is dropped. The
retained ring is itself bounded (``capacity``).

Served at the MetricsServer ``/traces`` route
(``?tenant=`` / ``?phase=`` (dominant phase) / ``?since=<rid>`` /
``?limit=``), rendered by ``tools/request_report.py`` (which joins the
flight journal on (tick, group) to recover the routed-vs-host hops
under a span's consensus phase), and embedded as summaries in the
chaos / wire / traffic soak artifacts.
"""

from __future__ import annotations

import contextvars
import json
from collections import deque

__all__ = ["RequestSpan", "SpanRecorder", "SpanLedger", "PHASES",
           "filter_traces", "dominant_phase", "current_span", "bind_span",
           "unbind_span"]

#: Phase vocabulary, in request order (see module docstring).
PHASES = ("admission", "queue", "consensus", "apply", "serve")

#: Mark ladder: begin, then the named rungs, then end. ``PHASES[i]`` is
#: the interval between ladder step i and i+1 (serve closes at ``end``).
_LADDER = ("admitted", "minted", "committed", "applied")

#: The ambient request span (None = no request in flight on this task).
#: Tasks copy their creation context, so a span bound before (or inside)
#: ``asyncio.ensure_future`` rides the whole request coroutine without
#: touching any handler signature.
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "josefine_request_span", default=None)


def current_span():
    """The request span bound to the current task context (or None)."""
    return _CURRENT.get()


def bind_span(span):
    """Bind ``span`` as the ambient request span; returns a token for
    :func:`unbind_span`. Inside a task the binding is task-local."""
    return _CURRENT.set(span)


def unbind_span(token) -> None:
    _CURRENT.reset(token)


class RequestSpan:
    """One request's tick-mark ladder (see module docstring).

    Mutable while the request is in flight: the minting site re-marks on
    retries (last write wins — the phases describe the attempt that
    finally succeeded, while ``admission`` stretches over every earlier
    refusal), and the engine fills ``group`` / ``leader`` at submit and
    mint so a reader can join the span against the flight journal.
    """

    __slots__ = ("rid", "kind", "tenant", "topic", "partition", "group",
                 "leader", "begin", "end", "marks", "status", "fault",
                 "sampled")

    def __init__(self, rid: int, kind: str, begin: int, tenant: str = "",
                 topic: str | None = None, partition: int = -1):
        self.rid = rid
        self.kind = kind
        self.tenant = tenant
        self.topic = topic
        self.partition = int(partition)
        self.group = -1
        self.leader = -1
        self.begin = int(begin)
        self.end: int | None = None
        self.marks: dict[str, int] = {}
        self.status = "open"
        self.fault = False
        self.sampled: str | None = None

    def mark(self, name: str, tick) -> None:
        self.marks[name] = int(tick)

    @property
    def latency(self) -> int:
        return (self.end if self.end is not None else self.begin) - self.begin

    def phases(self) -> dict[str, int]:
        """The five phase durations, derived from the mark ladder with
        carry + clamp so they always sum to ``end - begin`` (missing
        rungs collapse to zero at the previous boundary; a rung outside
        ``[begin, end]`` — e.g. a mark from an engine whose tick counter
        restarted mid-request under chaos — is clamped, never allowed to
        produce a negative phase)."""
        end = self.end if self.end is not None else self.begin
        out = {}
        prev = self.begin
        for i, rung in enumerate(_LADDER):
            v = self.marks.get(rung)
            v = prev if v is None else max(prev, min(int(v), end))
            out[PHASES[i]] = v - prev
            prev = v
        out["serve"] = end - prev
        return out

    def dominant_phase(self) -> str:
        return dominant_phase(self.phases())

    def to_event(self) -> dict:
        """Canonical dict form (json.dumps(sort_keys=True) serializable;
        every value a plain str/int/bool/None)."""
        return {
            "rid": self.rid,
            "kind": self.kind,
            "tenant": self.tenant,
            "topic": self.topic,
            "part": self.partition,
            "group": self.group,
            "leader": self.leader,
            "begin": self.begin,
            "end": self.end if self.end is not None else self.begin,
            "lat": self.latency,
            "status": self.status,
            "fault": bool(self.fault),
            "sampled": self.sampled,
            "marks": dict(self.marks),
            "phases": self.phases(),
        }


def dominant_phase(phases: dict) -> str:
    """The phase holding the largest share of a request's latency (first
    in PHASES order on ties — deterministic). The ONE implementation of
    the dominance rule: RequestSpan and the /traces ``?phase=`` filter
    both delegate here, so they can never drift apart."""
    best = PHASES[0]
    for p in PHASES:
        if phases.get(p, 0) > phases.get(best, 0):
            best = p
    return best


def filter_traces(traces, tenant: str | None = None,
                  phase: str | None = None, since: int | None = None,
                  limit: int | None = None) -> list:
    """Shared trace filter (the recorder's ``traces()`` and the
    MetricsServer ``/traces`` query params — one implementation, the
    filter_events discipline): optional tenant match, ``phase`` keeps
    traces whose DOMINANT phase is the given name (the "where did the
    tail go" query), ``since`` is a rid cursor (strictly after), and
    ``limit`` keeps the newest N (``limit=0`` returns nothing)."""
    if since is not None:
        since = int(since)
        traces = (t for t in traces if t.get("rid", 0) > since)
    if tenant is not None:
        traces = (t for t in traces if t.get("tenant") == tenant)
    if phase is not None:
        traces = (t for t in traces
                  if dominant_phase(t.get("phases") or {}) == phase)
    out = list(traces)
    if limit is not None:
        out = out[-int(limit):] if int(limit) > 0 else []
    return out


class SpanRecorder:
    """Bounded, deterministic store of finished request span trees plus
    the always-on per-tenant phase-attribution aggregate (module
    docstring has the sampling rule)."""

    #: Aggregate fold key past the series cap (the metrics plane's
    #: ``_other`` discipline — totals stay exact, cardinality bounded).
    OVERFLOW = "_other"

    #: Statuses that do NOT trigger failure retention: a routine outcome
    #: (acks=0 ``no_response``, a client that asked for a close) at a
    #: sustained rate must not flood the retained ring and evict the
    #: tail/fault samples the recorder exists to keep. Benign spans still
    #: count in the aggregate and still compete for the tail slots.
    BENIGN = frozenset(("ok", "no_response", "closed"))

    def __init__(self, capacity: int = 2048, clock=None,
                 sample_top_k: int = 4, window_ticks: int = 64,
                 agg_series: int = 4096):
        if capacity < 1:
            raise ValueError("spans capacity must be >= 1")
        if window_ticks < 1:
            raise ValueError("spans window_ticks must be >= 1")
        self.capacity = int(capacity)
        self.sample_top_k = int(sample_top_k)
        self.window_ticks = int(window_ticks)
        self.agg_series = int(agg_series)
        self._clock = clock if clock is not None else (lambda: 0)
        self._retained: deque[dict] = deque(maxlen=self.capacity)
        self._win: list[RequestSpan] = []   # finished, window not sealed
        self._win_idx: int | None = None    # current window index
        self.seq = 0          # rids minted (monotone)
        self.finished = 0     # spans finished (any status)
        self.retained_total = 0
        self.open = 0         # begun but not yet finished
        #: Armed-fault flag: while True, every span that BEGINS or
        #: FINISHES is fault-flagged and retained unconditionally (the
        #: chaos soaks hold it True for the chaotic phase).
        self.fault_active = False
        # (tenant, kind) -> {count, lat_sum, phase sums...}; bounded.
        self._agg: dict[tuple[str, str], dict] = {}

    # ------------------------------------------------------------ lifecycle

    def now(self) -> int:
        return int(self._clock())

    def begin(self, kind: str, tenant: str = "", topic: str | None = None,
              partition: int = -1, tick: int | None = None) -> RequestSpan:
        """Mint a request span (the trace context). ``tick`` defaults to
        the recorder clock — the engine tick at frame decode / submit."""
        span = RequestSpan(self.seq, kind,
                           self.now() if tick is None else int(tick),
                           tenant=tenant, topic=topic, partition=partition)
        self.seq += 1
        self.open += 1
        if self.fault_active:
            span.fault = True
        return span

    def finish(self, span: RequestSpan, tick: int | None = None,
               status: str = "ok") -> None:
        """Close the span and run it through tail-sampling admission."""
        if span.end is not None:
            return  # idempotent: a double-finish must not double-count
        span.end = max(span.begin,
                       self.now() if tick is None else int(tick))
        span.status = status
        if self.fault_active:
            span.fault = True
        self.finished += 1
        self.open -= 1
        self._aggregate(span)
        win = span.end // self.window_ticks
        if self._win_idx is None:
            self._win_idx = win
        elif win > self._win_idx:
            self._seal_window()
            self._win_idx = win
        self._win.append(span)

    def _aggregate(self, span: RequestSpan) -> None:
        key = (span.tenant, span.kind)
        row = self._agg.get(key)
        if row is None:
            # The metrics-plane fold rule: new keys past cap-1 fold into
            # per-kind overflow rows. The KIND is client-controlled too
            # (the broker labels unknown api keys "api_<n>"), so past the
            # cap even overflow rows stop minting and everything folds
            # into ONE (_other, _other) row — the table stays bounded no
            # matter what the wire sends.
            if len(self._agg) >= self.agg_series - 1:
                key = (self.OVERFLOW, span.kind)
                row = self._agg.get(key)
                if row is None and len(self._agg) >= self.agg_series:
                    key = (self.OVERFLOW, self.OVERFLOW)
                    row = self._agg.get(key)
            if row is None:
                row = self._agg[key] = {
                    "count": 0, "lat_sum": 0, "lat_max": 0,
                    **{p: 0 for p in PHASES}}
        row["count"] += 1
        row["lat_sum"] += span.latency
        if span.latency > row["lat_max"]:
            row["lat_max"] = span.latency
        for p, v in span.phases().items():
            row[p] += v

    def _seal_window(self) -> None:
        """Window admission: slowest K by (latency desc, rid asc) tagged
        ``tail``; fault-flagged and non-ok spans tagged ``fault`` /
        ``error`` and kept regardless; the rest dropped. Retained spans
        append in rid order so the log stays deterministic."""
        if not self._win:
            return
        k = max(0, self.sample_top_k)
        winners = set()
        for s in sorted(self._win, key=lambda s: (-s.latency, s.rid))[:k]:
            winners.add(s.rid)
            s.sampled = "tail"
        for s in self._win:
            if s.rid in winners:
                continue
            if s.fault:
                s.sampled = "fault"
            elif s.status not in self.BENIGN:
                s.sampled = "error"
        for s in sorted(self._win, key=lambda s: s.rid):
            if s.sampled is not None:
                self._retained.append(s.to_event())
                self.retained_total += 1
        self._win.clear()

    def seal(self) -> None:
        """Flush the open window (end of run / before a dump)."""
        self._seal_window()
        self._win_idx = None

    # ------------------------------------------------------------- reading

    def traces(self, tenant: str | None = None, phase: str | None = None,
               since: int | None = None,
               limit: int | None = None) -> list[dict]:
        """Retained span trees (oldest first), filtered; the CURRENT
        window's finished-but-unsealed spans are included so a live
        ``/traces`` poll never hides the last few requests. Returns
        copies — callers may mutate."""
        live = list(self._retained)
        live.extend(s.to_event() for s in sorted(self._win,
                                                 key=lambda s: s.rid))
        # filter_traces never mutates its input: copy only the filtered
        # output, not the whole ring per poll.
        return [dict(t) for t in filter_traces(
            live, tenant=tenant, phase=phase, since=since, limit=limit)]

    @property
    def dropped(self) -> int:
        """Retained events evicted by ring wraparound (the flight-ring
        accounting twin: nonzero means the span log is a truncated
        suffix of what sampling admitted)."""
        return self.retained_total - len(self._retained)

    def phase_table(self) -> dict:
        """Per-(tenant, kind) phase attribution: counts, total/mean
        latency, and the tick share of each phase — the soak report's
        table. Keys render ``tenant/kind`` sorted for determinism."""
        out = {}
        for (tenant, kind), row in sorted(self._agg.items()):
            out[f"{tenant}/{kind}"] = dict(row)
        return out

    def phase_totals(self) -> dict:
        """Aggregate phase attribution across every tenant and kind —
        the one-line answer to "where did the ticks go"."""
        out = {"count": 0, "lat_sum": 0, **{p: 0 for p in PHASES}}
        for row in self._agg.values():
            out["count"] += row["count"]
            out["lat_sum"] += row["lat_sum"]
            for p in PHASES:
                out[p] += row[p]
        return out

    def summary(self, table: bool = False) -> dict:
        """Embeddable run summary (soak results, bench rows). ``table``
        additionally includes the full per-tenant phase table — the soak
        artifact / report form; bench rows keep the compact shape."""
        out = {
            "requests": self.finished,
            "open": self.open,
            "retained": len(self._retained),
            "retained_total": self.retained_total,
            "pending_window": len(self._win),
            "dropped": self.dropped,
            "windows": {"ticks": self.window_ticks,
                        "top_k": self.sample_top_k},
            "phase_totals": self.phase_totals(),
        }
        if table:
            out["phase_attribution"] = self.phase_table()
        return out

    def dump_jsonl(self, seal: bool = True) -> str:
        """Span log: one compact sorted-key JSON object per retained
        trace — byte-identical across same-seed runs (the flight-journal
        contract). ``seal`` flushes the open sampling window first so an
        end-of-run dump covers every finished request."""
        if seal:
            self.seal()
        rows = list(self._retained)
        return "\n".join(
            json.dumps(e, sort_keys=True, separators=(",", ":"))
            for e in rows
        ) + ("\n" if rows else "")

    def clear(self) -> None:
        self._retained.clear()
        self._win.clear()
        self._win_idx = None
        self._agg.clear()
        self.seq = 0
        self.finished = 0
        self.retained_total = 0
        self.open = 0


class SpanLedger:
    """One-open-span-per-request bookkeeping, shared by the workload
    drivers (the in-process TrafficEngine and the chaos traffic adapter
    maintain the same invariant: one span per request keyed by
    ``(tenant, seq)``, minted at first enqueue, re-looked-up on retries,
    finished exactly once, and closed ``aborted`` for whatever a drain or
    horizon stranded). A ledger over a ``None`` recorder is inert, so
    call sites stay unconditional."""

    __slots__ = ("rec", "_by")

    def __init__(self, recorder: SpanRecorder | None):
        self.rec = recorder
        self._by: dict = {}

    def __bool__(self) -> bool:
        return self.rec is not None

    def open(self, key, kind: str, **begin_kwargs):
        """Mint and track a span for ``key`` (call on attempt 0 only)."""
        if self.rec is None:
            return None
        span = self.rec.begin(kind, **begin_kwargs)
        self._by[key] = span
        return span

    def get(self, key):
        return self._by.get(key)

    def finish(self, key, status: str) -> None:
        span = self._by.pop(key, None)
        if span is not None:
            self.rec.finish(span, status=status)

    def close_all(self, status: str = "aborted") -> None:
        """Finish every still-open span — requests a drain epilogue or
        the soak horizon stranded must land in the artifact, not leak as
        open entries. Sorted order keeps the dump deterministic."""
        if self.rec is None:
            return
        for key in sorted(self._by):
            self.rec.finish(self._by[key], status=status)
        self._by.clear()
