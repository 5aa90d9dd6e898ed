"""Per-tick phase profiler: nestable monotonic timers with near-zero
disabled overhead.

The host bridge's tick is a fixed pipeline of phases (inbox build, proposal
staging, device dispatch, fetch, outbox decode, chain/driver apply — see
ARCHITECTURE.md "Host bridge performance"). BENCH_engine.json showed the
bridge collapsing 150x from P=1k to P=100k with no way to say WHERE the
1.7 s/tick went; this module makes the per-phase breakdown a recorded
artifact instead of a guess.

Phases register on first use, so the set is open: active-set compacted
stepping (PR 4, ARCHITECTURE.md "Active-set scheduling") adds ``compact``
(wake-predicate scheduling + the device gather), ``scatter`` (compact
results back into the full state fused with the device decay), and
``decay`` (the host timer-mirror twin) alongside the six PR 2 phases above
— which keep their names and meanings exactly, so perf-floor comparisons
across PRs stay valid (a dense-path engine records only the original six).

Design constraints, in order:

1. **Disabled is (almost) free.** The engine calls ``profiler.phase(name)``
   six-plus times per tick on the product hot path; the disabled profiler
   must cost two trivial method calls and no allocation. ``NULL_PROFILER``
   returns one shared no-op context manager, so ``with prof.phase("x"):``
   compiles down to two C-level calls.
2. **Nestable.** Phases may contain phases (``decode`` inside ``finish``);
   an enabled profiler keeps a stack and records nested phases under a
   ``parent/child`` path, so self-time vs child-time is recoverable from
   the dump without double counting at any one level.
3. **Rolling, bounded memory.** Each phase keeps O(ring) samples (default
   512) for percentiles plus constant-size aggregates (count/total/max) —
   a week-long soak profiles the same as a 30-tick bench.

Typical use::

    prof = PhaseProfiler()
    with prof.phase("tick"):
        with prof.phase("inbox"):
            ...
    prof.snapshot()   # {"tick": {...}, "tick/inbox": {...}}
    prof.dump_json()  # JSON string of the same

Timers are ``time.perf_counter_ns`` (monotonic); re-entrancy is per
instance, not per thread — the engine tick loop is single-threaded, like
every other engine structure.
"""

from __future__ import annotations

import json
import time
from collections import deque


class _NullPhase:
    """Shared no-op context manager (the whole disabled fast path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


class _PhaseStats:
    """Aggregates + rolling sample ring for one phase path."""

    __slots__ = ("count", "total_ns", "max_ns", "ring")

    def __init__(self, ring: int):
        self.count = 0
        self.total_ns = 0
        self.max_ns = 0
        self.ring: deque[int] = deque(maxlen=ring)

    def add(self, ns: int) -> None:
        self.count += 1
        self.total_ns += ns
        if ns > self.max_ns:
            self.max_ns = ns
        self.ring.append(ns)

    def summary(self) -> dict:
        samples = sorted(self.ring)
        n = len(samples)

        def pct(q: float) -> float:
            if not n:
                return 0.0
            return samples[min(n - 1, int(q * (n - 1) + 0.5))] / 1e6

        return {
            "count": self.count,
            "total_ms": round(self.total_ns / 1e6, 3),
            "mean_ms": round(self.total_ns / 1e6 / self.count, 4)
            if self.count else 0.0,
            "p50_ms": round(pct(0.50), 4),
            "p99_ms": round(pct(0.99), 4),
            "max_ms": round(self.max_ns / 1e6, 3),
        }


class _Phase:
    """Enabled-path context manager; one is reused per profiler (phases on
    one profiler cannot overlap non-hierarchically — the engine tick is a
    straight-line pipeline — so a small pool indexed by depth suffices)."""

    __slots__ = ("prof", "name", "t0")

    def __init__(self, prof: "PhaseProfiler"):
        self.prof = prof
        self.name = ""
        self.t0 = 0

    def __enter__(self):
        self.prof._stack.append(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        prof = self.prof
        path = "/".join(prof._stack)
        prof._stack.pop()
        stats = prof._stats.get(path)
        if stats is None:
            stats = prof._stats[path] = _PhaseStats(prof._ring)
        stats.add(ns)
        prof._pool.append(self)
        return False


class PhaseProfiler:
    """Nestable monotonic phase timers with per-phase rolling stats.

    ``enabled=False`` (or the module-level :data:`NULL_PROFILER`) is the
    hot-path default: ``phase()`` returns a shared no-op context manager.
    """

    def __init__(self, enabled: bool = True, ring: int = 512):
        self.enabled = enabled
        self._ring = ring
        self._stats: dict[str, _PhaseStats] = {}
        self._stack: list[str] = []
        self._pool: list[_Phase] = []

    def phase(self, name: str):
        """Context manager timing one phase; nested phases record under
        ``outer/inner`` paths."""
        if not self.enabled:
            return _NULL_PHASE
        p = self._pool.pop() if self._pool else _Phase(self)
        p.name = name
        return p

    def add_ns(self, name: str, ns: int) -> None:
        """Record an externally measured duration (e.g. a callback-timed
        async span that cannot be a ``with`` block)."""
        if not self.enabled:
            return
        stats = self._stats.get(name)
        if stats is None:
            stats = self._stats[name] = _PhaseStats(self._ring)
        stats.add(int(ns))

    def reset(self) -> None:
        self._stats.clear()

    def snapshot(self) -> dict[str, dict]:
        """Per-phase summary dict: count, total/mean/p50/p99/max ms."""
        return {path: s.summary() for path, s in sorted(self._stats.items())}

    def dump_json(self, path: str | None = None, indent: int | None = 1) -> str:
        """JSON form of :meth:`snapshot`; optionally written to ``path``."""
        out = json.dumps(self.snapshot(), indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(out)
        return out


NULL_PROFILER = PhaseProfiler(enabled=False)
