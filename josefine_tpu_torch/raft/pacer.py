"""Tick pacing: who decides when a node's next consensus tick runs.

The reference hard-codes a 100 ms wall-clock tick in its event loop
(``src/raft/server.rs:25``); time and the protocol are inseparable there,
which is why its integration tests must sleep against real seconds. Here
the tick source is injected: the production server uses
:class:`WallClockPacer` (same semantics as the reference — one window of
ticks per ``tick_ms * window`` of wall time), while tests and
deterministic simulation use :class:`LockstepPacer`, a virtual clock that
releases ticks only when the harness grants them.

Why it matters: with a virtual clock, every node in a multi-node harness
advances the SAME number of ticks regardless of how starved the host is.
Election timeouts, heartbeats, and keepalive freshness are all tick-
denominated, so a slow CI box merely runs the test slower — it can no
longer fire spurious elections or blow wall-clock deadlines (the r3/r4
flake class: each round widened sleeps instead of removing them).
"""

from __future__ import annotations

import asyncio


class WallClockPacer:
    """Production pacing: a w-tick window covers ``w * tick_s`` of wall time."""

    def attach(self, key) -> None:  # noqa: D401 — trivial protocol hooks
        pass

    def detach(self, key) -> None:
        pass

    async def acquire(self, key, want: int) -> int:
        return want

    def release(self, key, n: int) -> None:
        """Return unused ticks (wall clock mints them freely — no-op)."""

    async def pace(self, key, executed: int, tick_s: float, elapsed_s: float) -> None:
        await asyncio.sleep(max(0.0, tick_s * executed - elapsed_s))


class LockstepPacer:
    """Virtual clock: nodes block until the harness grants ticks.

    Each attached node's tick loop calls ``acquire(key, want)`` before
    stepping and consumes up to ``want`` granted ticks; with none granted
    it parks. :meth:`advance` grants ``ticks`` to every attached node,
    then waits until all of them have drained their grants and parked
    again, then sleeps ``settle_s`` so in-flight socket frames deliver.
    The result: across an ``advance(k)`` every live node executed exactly
    ``k`` ticks — zero tick skew, independent of host load.
    """

    def __init__(self, settle_s: float = 0.003):
        self.settle_s = settle_s
        self._nodes: dict[object, dict] = {}

    def attach(self, key) -> None:
        self._nodes[key] = {
            "permits": 0,
            "wake": asyncio.Event(),
            "idle": asyncio.Event(),
        }
        self._nodes[key]["idle"].set()

    def detach(self, key) -> None:
        self._nodes.pop(key, None)

    async def acquire(self, key, want: int) -> int:
        st = self._nodes[key]
        while st["permits"] <= 0:
            st["idle"].set()
            st["wake"].clear()
            await st["wake"].wait()
        st["idle"].clear()
        got = min(st["permits"], max(1, want))
        st["permits"] -= got
        return got

    def release(self, key, n: int) -> None:
        """Return surplus granted ticks (the driver clamped its window after
        acquiring — see server._tick_loop). The permits go back to the pool
        so an ``advance(k)`` still executes exactly k ticks on this node,
        just in smaller windows; without this, clamping would silently eat
        granted ticks and skew the virtual clock across nodes."""
        st = self._nodes.get(key)
        if st is not None and n > 0:
            st["permits"] += n

    async def pace(self, key, executed: int, tick_s: float, elapsed_s: float) -> None:
        st = self._nodes.get(key)
        if st is not None and st["permits"] <= 0:
            st["idle"].set()

    async def advance(self, ticks: int = 1, settle_s: float | None = None) -> None:
        for st in self._nodes.values():
            st["permits"] += ticks
            st["wake"].set()
        for key, st in list(self._nodes.items()):
            # A node detached mid-advance (crash tests) stops counting.
            while key in self._nodes and (st["permits"] > 0 or not st["idle"].is_set()):
                await asyncio.sleep(0.001)
        await asyncio.sleep(self.settle_s if settle_s is None else settle_s)

    async def run_ticks(self, n: int, stop=None) -> None:
        """Advance ``n`` ticks one at a time; bail early if ``stop()``."""
        for _ in range(n):
            if stop is not None and stop():
                return
            await self.advance(1)
