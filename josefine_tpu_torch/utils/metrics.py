"""Metrics: counters/gauges/histograms + a Prometheus-style exposition endpoint.

The reference has no metrics at all — observability is tracing logs plus a
debug JSON file the leader rewrites synchronously every 100 ms tick
(``src/raft/leader.rs:101-121``, SURVEY.md quirk 7). Here: a process-local
registry the hot paths bump (plain int adds; no locks — all writers run on
the asyncio event loop), read out on demand over a tiny HTTP endpoint
(``/metrics`` Prometheus text, ``/state`` the debug-state JSON the
reference's tick file carried, ``/events`` the consensus flight-recorder
journal, ``/healthz``).

Three metric types:

* :class:`Counter` — monotone, optionally labelled;
* :class:`Gauge` — point-in-time; ``set()`` replaces, or ``set_fn`` wires a
  sampled-at-scrape callback **per label set** (callback series go through
  the same node-scope filter as stored series — a multi-node process must
  not leak one node's callback value onto every endpoint);
* :class:`Histogram` — power-of-two buckets with Prometheus
  ``_bucket``/``_sum``/``_count`` exposition and a host-side
  :meth:`~Histogram.quantile` (linear interpolation inside the bucket), so
  the engine itself can quote p50/p99 commit latency without a scraper.

Label cardinality is bounded per metric: a metric constructed with
``max_series=N`` folds every label set beyond its first N distinct ones
into ONE explicit overflow series (label values replaced by
:data:`OVERFLOW`, the ``node`` label preserved so per-endpoint scoping
survives). The workload plane labels series by tenant, and 10k tenants
must not explode the registry or the Prometheus exposition — the overflow
bucket keeps totals honest (nothing is silently dropped) while the series
count stays O(cap). Unlabelled observations are never folded.

Scrape-time collection: components whose interesting numbers live on live
objects (the engine's scheduler stats, the phase profiler) register a
*collect hook* (:meth:`Registry.add_collect_hook`) that refreshes gauges
just before ``dump()``/``render_prometheus()`` read them. Hooks are held
via a weakref to their owner, so a chaos soak that rebuilds engines
hundreds of times never accumulates dead publishers.
"""

from __future__ import annotations

import asyncio
import json
import weakref
from typing import Callable

from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("metrics")


OVERFLOW = "_other"


def _esc_label(v) -> str:
    """Prometheus label-value escaping: ``\\`` → ``\\\\``, ``"`` → ``\\"``,
    newline → ``\\n`` (the text-exposition rules). Tenant/topic labels are
    CLIENT-DRIVEN strings — an unescaped quote or newline in one label
    value corrupts the whole exposition for every scraper."""
    s = str(v)
    if "\\" in s or '"' in s or "\n" in s:
        s = (s.replace("\\", "\\\\").replace('"', '\\"')
             .replace("\n", "\\n"))
    return s


def _capped_key(labels: dict, values: dict, max_series: int | None) -> tuple:
    """THE cardinality-cap rule, shared by every metric type: a new label
    set that would overrun ``max_series`` folds into the overflow series
    (values replaced by :data:`OVERFLOW`, the ``node`` label preserved so
    per-endpoint scoping survives). One slot is reserved for the overflow
    series itself, so the TOTAL stays <= max_series. Unlabelled
    observations and already-tracked sets pass through untouched.

    Deliberate boundary: a label set consisting SOLELY of ``node`` folds
    to itself and is therefore never capped — node cardinality is bounded
    by the cluster the operator deployed, not by client behavior, and
    folding it away would break the per-endpoint scoping the exemption
    exists for. The cap bounds CLIENT-driven labels (tenants, topics)."""
    key = tuple(sorted(labels.items()))
    if (not key or max_series is None or key in values
            or len(values) < max_series - 1):
        return key
    return tuple((k, v if k == "node" else OVERFLOW) for k, v in key)


class Counter:
    """Monotone counter, optionally labelled. ``inc(n, label=value, ...)``.

    ``max_series`` bounds distinct label sets: once the metric holds that
    many, any NEW label set folds into the overflow series (values replaced
    by :data:`OVERFLOW`; a ``node`` label keeps its value so node-scoped
    exposition stays correct). Existing series keep accumulating."""

    def __init__(self, name: str, help_: str, registry: "Registry | None" = None,
                 max_series: int | None = None):
        self.name = name
        self.help = help_
        self.max_series = max_series
        self.values: dict[tuple, float] = {}
        (registry or REGISTRY)._add(self)

    def _key(self, labels: dict) -> tuple:
        return _capped_key(labels, self.values, self.max_series)

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        self.values[key] = self.values.get(key, 0) + n

    def get(self, **labels) -> float:
        return self.values.get(tuple(sorted(labels.items())), 0)

    def bind(self, **labels) -> "BoundCounter":
        """Pre-resolve the label key for hot paths (one dict op per inc
        instead of kwargs + sort per call). The cardinality cap is applied
        at bind time (a bound handle IS its series)."""
        key = self._key(labels)
        self.values.setdefault(key, 0)
        return BoundCounter(self, key)

    _TYPE = "counter"


class BoundCounter:
    __slots__ = ("_c", "_k")

    def __init__(self, counter: "Counter", key: tuple):
        self._c = counter
        self._k = key

    def inc(self, n: float = 1) -> None:
        v = self._c.values
        v[self._k] = v.get(self._k, 0) + n


class Gauge(Counter):
    """Point-in-time value; ``set()`` replaces, ``inc()`` adjusts. May also
    wrap callbacks via ``set_fn`` for sampled-at-scrape values — one
    callback per label set, so callback series can be node-scoped like any
    stored series (``set_fn(fn)`` with no labels keeps the legacy shared,
    every-endpoint behavior)."""

    _TYPE = "gauge"

    def __init__(self, name: str, help_: str, registry: "Registry | None" = None,
                 max_series: int | None = None):
        super().__init__(name, help_, registry, max_series=max_series)
        self._fns: dict[tuple, Callable[[], float]] = {}

    def set(self, v: float, **labels) -> None:
        self.values[self._key(labels)] = v

    def set_fn(self, fn: Callable[[], float], **labels) -> None:
        """Register a sampled-at-scrape callback for this label set. A
        node-labelled callback (``set_fn(fn, node=i)``) is visible only on
        node i's endpoint — the fix for the callback-gauges-bypass-the-
        node-filter hole."""
        self._fns[tuple(sorted(labels.items()))] = fn

    def get(self, **labels) -> float:
        fn = self._fns.get(tuple(sorted(labels.items())))
        if fn is not None:
            return fn()
        return super().get(**labels)

    def _series(self) -> list[tuple[tuple, float]]:
        """Stored + callback series, callbacks winning on key collision."""
        out = {key: val for key, val in self.values.items()}
        for key, fn in self._fns.items():
            try:
                out[key] = fn()
            except Exception:
                log.exception("gauge %s callback failed", self.name)
        return sorted(out.items())


class _HistSeries:
    """One label set's bucket counts + sum/count."""

    __slots__ = ("buckets", "inf", "total", "count")

    def __init__(self, levels: int):
        self.buckets = [0] * levels  # cumulative-at-render; stored per-bucket
        self.inf = 0
        self.total = 0.0
        self.count = 0

    def observe(self, v: float, levels: int) -> None:
        self.total += v
        self.count += 1
        if v <= 1:
            self.buckets[0] += 1
            return
        # Power-of-two upper bounds 1, 2, 4, ... 2^(levels-1): bucket index
        # is ceil(log2(v)) for integral v, computed via bit_length.
        idx = (int(v) - 1).bit_length() if v == int(v) else None
        if idx is None:
            idx = 0
            while (1 << idx) < v and idx < levels:
                idx += 1
        if idx < levels:
            self.buckets[idx] += 1
        else:
            self.inf += 1


class Histogram:
    """Power-of-two-bucket histogram (upper bounds 1, 2, 4, …, 2^(levels-1),
    +Inf), labelled like a Counter. Values are expected non-negative and
    usually integral (the engine records device-tick latencies).

    Exposition follows the Prometheus histogram convention:
    ``name_bucket{le="2"}`` cumulative counts, ``name_sum``, ``name_count``.
    """

    _TYPE = "histogram"

    def __init__(self, name: str, help_: str,
                 registry: "Registry | None" = None, levels: int = 16,
                 max_series: int | None = None):
        self.name = name
        self.help = help_
        self.levels = levels
        self.max_series = max_series
        self.values: dict[tuple, _HistSeries] = {}
        (registry or REGISTRY)._add(self)

    def _key(self, labels: dict) -> tuple:
        return _capped_key(labels, self.values, self.max_series)

    def observe(self, v: float, **labels) -> None:
        key = self._key(labels)
        s = self.values.get(key)
        if s is None:
            s = self.values[key] = _HistSeries(self.levels)
        s.observe(v, self.levels)

    def bind(self, **labels) -> "BoundHistogram":
        key = self._key(labels)
        self.values.setdefault(key, _HistSeries(self.levels))
        return BoundHistogram(self, key)

    def count(self, **labels) -> int:
        """Observation count. With no labels: summed over every series."""
        if labels:
            s = self.values.get(tuple(sorted(labels.items())))
            return s.count if s else 0
        return sum(s.count for s in self.values.values())

    def _merged(self, labels: dict) -> _HistSeries | None:
        """One series, or (no labels) the bucket-wise sum of all series."""
        if labels:
            return self.values.get(tuple(sorted(labels.items())))
        if not self.values:
            return None
        m = _HistSeries(self.levels)
        for s in self.values.values():
            m.inf += s.inf
            m.total += s.total
            m.count += s.count
            for i, c in enumerate(s.buckets):
                m.buckets[i] += c
        return m

    def quantile(self, q: float, **labels) -> float:
        """Approximate quantile from the buckets (linear interpolation
        between the bucket's lower and upper bound — histogram_quantile
        semantics). No labels aggregates every series, which is how the
        bench quotes a cluster-wide p50/p99 across the three engines'
        node-labelled series. Returns 0.0 on an empty histogram; +Inf-
        bucket hits return the largest finite bound."""
        s = self._merged(labels)
        if s is None or s.count == 0:
            return 0.0
        rank = q * s.count
        cum = 0.0
        lower = 0.0
        for i, c in enumerate(s.buckets):
            upper = float(1 << i)
            if c and cum + c >= rank:
                return lower + (upper - lower) * (rank - cum) / c
            cum += c
            lower = upper
        return float(1 << (self.levels - 1))

    def summary(self, **labels) -> dict:
        """{n, p50, p99, sum} for one series (or the aggregate)."""
        s = self._merged(labels)
        n = s.count if s else 0
        return {
            "n": n,
            "p50": round(self.quantile(0.5, **labels), 3),
            "p99": round(self.quantile(0.99, **labels), 3),
            "sum": round(s.total, 3) if s else 0.0,
        }

    def _render(self, lines: list[str], node) -> None:
        emitted = False
        for key, s in sorted(self.values.items()):
            if not Registry._visible(key, node):
                continue
            emitted = True
            base = ",".join(f'{k}="{_esc_label(v)}"' for k, v in key)
            sep = "," if base else ""
            cum = 0
            for i, c in enumerate(s.buckets):
                cum += c
                lines.append(
                    f'{self.name}_bucket{{{base}{sep}le="{1 << i}"}} {cum}')
            lines.append(
                f'{self.name}_bucket{{{base}{sep}le="+Inf"}} {cum + s.inf}')
            if base:
                lines.append(f"{self.name}_sum{{{base}}} {s.total}")
                lines.append(f"{self.name}_count{{{base}}} {s.count}")
            else:
                lines.append(f"{self.name}_sum {s.total}")
                lines.append(f"{self.name}_count {s.count}")
        if not emitted:
            lines.append(f'{self.name}_bucket{{le="+Inf"}} 0')
            lines.append(f"{self.name}_sum 0")
            lines.append(f"{self.name}_count 0")

    def _dump(self, node) -> dict:
        out = {}
        for key, s in sorted(self.values.items()):
            if not Registry._visible(key, node):
                continue
            out[",".join(f"{k}={v}" for k, v in key)] = {
                "count": s.count,
                "sum": s.total,
                "buckets": {str(1 << i): c for i, c in enumerate(s.buckets)
                            if c},
                "inf": s.inf,
            }
        return out


class BoundHistogram:
    __slots__ = ("_h", "_k")

    def __init__(self, hist: Histogram, key: tuple):
        self._h = hist
        self._k = key

    def observe(self, v: float) -> None:
        h = self._h
        s = h.values.get(self._k)
        if s is None:
            s = h.values[self._k] = _HistSeries(h.levels)
        s.observe(v, h.levels)


class Registry:
    def __init__(self):
        self._metrics: dict[str, Counter] = {}
        # (owner weakref, fn) collect hooks, run before every dump/render.
        self._hooks: list[tuple[weakref.ref, Callable]] = []

    def _add(self, m) -> None:
        if m.name in self._metrics:
            raise ValueError(f"duplicate metric {m.name}")
        self._metrics[m.name] = m

    def counter(self, name: str, help_: str = "",
                max_series: int | None = None) -> Counter:
        """Get-or-create (idempotent across node restarts in one process).
        On the create path ``max_series`` caps label cardinality (see the
        module docstring); an existing metric keeps its original cap."""
        m = self._metrics.get(name)
        if m is None:
            m = Counter(name, help_, self, max_series=max_series)
        return m

    def gauge(self, name: str, help_: str = "",
              max_series: int | None = None) -> Gauge:
        m = self._metrics.get(name)
        if m is None:
            m = Gauge(name, help_, self, max_series=max_series)
        if not isinstance(m, Gauge):
            raise ValueError(f"{name} is not a gauge")
        return m

    def histogram(self, name: str, help_: str = "", levels: int = 16,
                  max_series: int | None = None) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = Histogram(name, help_, self, levels=levels,
                          max_series=max_series)
        if not isinstance(m, Histogram):
            raise ValueError(f"{name} is not a histogram")
        return m

    # -------------------------------------------------------- collect hooks

    def add_collect_hook(self, owner, fn: Callable) -> None:
        """Register ``fn(owner)`` to run just before every scrape while
        ``owner`` is alive. The registry holds only a weakref to the owner,
        so components that are rebuilt (chaos-soak engines) retire their
        publishers automatically; the sweep on add keeps the list bounded
        even in a scrape-free soak."""
        self._hooks = [(r, f) for r, f in self._hooks if r() is not None]
        self._hooks.append((weakref.ref(owner), fn))

    def _run_hooks(self) -> None:
        live = []
        for ref, fn in self._hooks:
            owner = ref()
            if owner is None:
                continue
            try:
                fn(owner)
            except Exception:
                log.exception("metrics collect hook failed")
            live.append((ref, fn))
        self._hooks = live

    # ----------------------------------------------------------- exposition

    @staticmethod
    def _visible(key: tuple, node) -> bool:
        """Series visibility under a node scope: unlabelled series and
        series without a ``node`` label are shared; node-labelled series
        belong to that node's endpoint only."""
        if node is None:
            return True
        for k, v in key:
            if k == "node":
                return v == node
        return True

    def dump(self, node=None) -> dict:
        self._run_hooks()
        out = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = m._dump(node)
                continue
            series = (m._series() if isinstance(m, Gauge)
                      else sorted(m.values.items()))
            if len(series) == 1 and series[0][0] == ():
                out[name] = series[0][1]
            else:
                out[name] = {
                    ",".join(f"{k}={v}" for k, v in key): val
                    for key, val in series
                    if self._visible(key, node)
                }
        return out

    def render_prometheus(self, node=None) -> str:
        """Prometheus text exposition, optionally scoped to one node's
        series. The registry is process-global (metric objects are
        module-level), so a process hosting several Nodes — the multi-node
        example does — must filter each endpoint to its own node label or
        every /metrics answer reports every node's series."""
        self._run_hooks()
        lines = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m._TYPE}")
            if isinstance(m, Histogram):
                m._render(lines, node)
                continue
            series = (m._series() if isinstance(m, Gauge)
                      else sorted(m.values.items()))
            emitted = False
            for key, val in series:
                if not self._visible(key, node):
                    continue
                emitted = True
                if key:
                    lbl = ",".join(f'{k}="{_esc_label(v)}"' for k, v in key)
                    lines.append(f"{name}{{{lbl}}} {val}")
                else:
                    lines.append(f"{name} {val}")
            if not emitted:
                lines.append(f"{name} 0")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every metric IN PLACE — metric objects stay registered.
        Clearing the registration map instead (the old behavior) orphaned
        every module-level metric handle created at import: their later
        ``inc()``s mutated objects no endpoint could see, forever."""
        for m in self._metrics.values():
            m.values.clear()


REGISTRY = Registry()


class MetricsServer:
    """Minimal asyncio HTTP/1.0 exposition server (no framework deps).

    Routes: ``/metrics`` (Prometheus text), ``/state`` (JSON from the
    supplied callback — the engine's per-group leader/term/commit view,
    replacing the reference's per-tick debug file), ``/events`` (the
    consensus flight-recorder journal from ``events_fn``; supports
    ``?limit=N``, ``?kind=K``, ``?group=G`` filters and a ``?since=SEQ``
    cursor — events strictly after that seq, so pollers resume instead of
    re-downloading the ring), ``/traces`` (retained request span trees
    from ``traces_fn`` — utils/spans.py, ``raft.request_spans``; supports
    ``?tenant=T``, ``?phase=P`` (dominant phase), ``?limit=N`` and a
    ``?since=RID`` cursor), ``/health`` (the health plane's current
    detector levels + verdicts from ``health_fn`` — utils/health.py,
    ``raft.health`` — with its ``health_*`` transition journal filtered
    by the SAME parser and cursor semantics as ``/events``),
    ``/healthz``.
    """

    def __init__(self, host: str, port: int,
                 state_fn: Callable[[], dict] | None = None,
                 registry: Registry | None = None,
                 node: int | None = None,
                 events_fn: Callable[[], list] | None = None,
                 traces_fn: Callable[[], list] | None = None,
                 health_fn: Callable[[], dict | None] | None = None):
        self.host = host
        self.port = port
        self.state_fn = state_fn
        self.events_fn = events_fn
        self.traces_fn = traces_fn
        self.health_fn = health_fn
        self.registry = registry or REGISTRY
        # Scope the exposition to this node's series (multi-node-per-process
        # deployments share the module-global registry).
        self.node = node
        self._server: asyncio.AbstractServer | None = None
        self.bound_port: int | None = None

    async def start(self) -> int:
        self._server = await asyncio.start_server(self._serve, self.host, self.port)
        self.bound_port = self._server.sockets[0].getsockname()[1]
        log.info("metrics endpoint on %s:%d", self.host, self.bound_port)
        return self.bound_port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    @staticmethod
    def _query_params(query: str) -> dict:
        """One parser for every filtered route (/events, /traces)."""
        params = {}
        for part in query.split("&"):
            if "=" in part:
                k, _, v = part.partition("=")
                params[k] = v
        return params

    @staticmethod
    def _qint(v):
        """Malformed numeric params (e.g. group=--5) ignore the filter
        instead of unwinding through _serve with no response bytes — the
        shared rule for every filtered route."""
        try:
            return int(v)
        except (TypeError, ValueError):
            return None

    def _filtered_events(self, events: list, query: str) -> list:
        """THE filter implementation behind /events and /health: one
        parser (`_query_params`/`_qint`), one cursor rule (?since=SEQ is
        strict-after; malformed numeric params ignore the filter). Both
        routes call this — regression-pinned by tests/test_health.py so
        a third copy never appears."""
        from josefine_tpu_torch.utils.flight import filter_events

        params = self._query_params(query)
        limit = self._qint(params.get("limit"))
        return filter_events(
            events,
            kind=params.get("kind") or None,
            group=self._qint(params.get("group")),
            limit=limit if limit is not None and limit >= 0 else None,
            since=self._qint(params.get("since")),
        )

    def _events_body(self, query: str) -> bytes:
        events = list(self.events_fn()) if self.events_fn else []
        return json.dumps({"node": self.node,
                           "events": self._filtered_events(events, query)
                           }).encode()

    def _health_body(self, query: str) -> bytes:
        snap = self.health_fn() if self.health_fn else None
        if not snap:
            # Health plane off (raft.health = false): explicit null, so a
            # doctor pointed at a plain node learns the plane is dark
            # instead of mistaking it for "all ok, no events yet".
            return json.dumps({"node": self.node, "health": None}).encode()
        return json.dumps({
            "node": self.node,
            "health": {"status": snap.get("status"),
                       "verdicts": snap.get("verdicts")},
            "events": self._filtered_events(list(snap.get("events") or []),
                                            query),
        }).encode()

    def _traces_body(self, query: str) -> bytes:
        from josefine_tpu_torch.utils.spans import filter_traces

        traces = list(self.traces_fn()) if self.traces_fn else []
        params = self._query_params(query)
        limit = self._qint(params.get("limit"))
        traces = filter_traces(
            traces,
            tenant=params.get("tenant") or None,
            phase=params.get("phase") or None,
            since=self._qint(params.get("since")),
            limit=limit if limit is not None and limit >= 0 else None,
        )
        return json.dumps({"node": self.node, "traces": traces}).encode()

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            req = await asyncio.wait_for(reader.readline(), 5)
            parts = req.decode("latin1").split()
            path = parts[1] if len(parts) >= 2 else "/"
            path, _, query = path.partition("?")
            while True:  # drain headers
                line = await asyncio.wait_for(reader.readline(), 5)
                if line in (b"\r\n", b"\n", b""):
                    break
            if path == "/metrics":
                body = self.registry.render_prometheus(node=self.node).encode()
                ctype = "text/plain; version=0.0.4"
                status = "200 OK"
            elif path == "/state":
                state = self.state_fn() if self.state_fn else {}
                body = json.dumps(state).encode()
                ctype = "application/json"
                status = "200 OK"
            elif path == "/events":
                body = self._events_body(query)
                ctype = "application/json"
                status = "200 OK"
            elif path == "/traces":
                body = self._traces_body(query)
                ctype = "application/json"
                status = "200 OK"
            elif path == "/health":
                body = self._health_body(query)
                ctype = "application/json"
                status = "200 OK"
            elif path == "/healthz":
                body = b'{"ok":true}'
                ctype = "application/json"
                status = "200 OK"
            else:
                body = b"not found"
                ctype = "text/plain"
                status = "404 Not Found"
            writer.write(
                f"HTTP/1.0 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
                + body
            )
            await writer.drain()
        except Exception:
            pass
        finally:
            writer.close()
