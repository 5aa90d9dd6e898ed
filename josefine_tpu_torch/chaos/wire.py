"""WirePlane: seed-deterministic socket faults for the Kafka wire plane.

The :class:`~josefine_tpu.chaos.faults.FaultPlane` injects faults into
the in-process message plane; this module extends the same discipline to
the layer real clients touch — TCP connections speaking the Kafka
protocol. A :class:`WirePlane` wraps the broker's accepted reader/writer
pairs and the wire driver's client sockets in fate shims; the nemesis DSL
arms fate *windows* on it (``conn_reset`` / ``conn_stall`` /
``torn_frames`` / ``accept_refuse``, see :mod:`~josefine_tpu.chaos.nemesis`)
and every fate decision is a pure function of ``(seed, connection label,
fault kind, window id, I/O index)`` — no draw order, no wall clock — so a
run's fate sequence replays from its seed even though the bytes ride real
sockets.

Fate vocabulary (per connection, inside an armed window):

* **reset** — the transport is aborted and the I/O raises
  ``ConnectionResetError`` (fires once per window per connection);
* **stall** — reads and writes black-hole until the window's virtual-tick
  end (the model for a hung peer: the other side's deadline machinery has
  to save it);
* **torn write** — a drained write is split at a seeded cut point and the
  halves are flushed separately, so the peer observes a partial Kafka
  frame (split inside the 4-byte length prefix or the body) before the
  rest arrives;
* **accept refuse** — the broker's accept path refuses new connections
  for the window (the client sees a clean close and must back off).

Determinism mechanism: connections carry operator-chosen labels (the wire
driver labels its sockets by broker slot and reconnect attempt; the broker
labels an accepted connection by its peer's ``client_id`` plus a
per-client ordinal). Each fate decision seeds its own one-shot
``random.Random`` from the tuple above, so shims may *check* fates as
often as scheduling happens to call them without perturbing any stream.
Every fired fate lands in the owning connection's journal with a
per-connection sequence number; :meth:`WirePlane.event_log_jsonl` emits
the journals in sorted (label, seq) order — byte-identical across
same-seed runs whenever the per-connection I/O sequences are (the wire
soak's lockstep driver arranges exactly that).

The virtual clock is shared with the fault plane:
``FaultPlane.advance`` calls :meth:`sync` when a wire plane is attached,
so wire windows open and close on the same tick axis as partitions and
crashes — one schedule stacks both planes.
"""

from __future__ import annotations

import asyncio
import json
import random

from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("chaos.wire")

_m_resets = REGISTRY.counter("chaos_wire_resets_total",
                             "Connection resets injected by the wire plane")
_m_torn = REGISTRY.counter("chaos_wire_torn_writes_total",
                           "Writes torn at seeded split points")
_m_stalls = REGISTRY.counter("chaos_wire_stalls_total",
                             "Connection stall windows entered")
_m_refused = REGISTRY.counter("chaos_wire_accepts_refused_total",
                              "Accepts refused by an accept_refuse window")

#: Fault kinds arm() accepts (mirrors nemesis.WIRE_OPS).
WIRE_FAULTS = ("conn_reset", "conn_stall", "torn_frames", "accept_refuse")


class _Window:
    """One armed fate window: [armed_tick, until) on the virtual clock."""

    __slots__ = ("wid", "kind", "role", "p", "start", "until")

    def __init__(self, wid: int, kind: str, role: str, p: float,
                 start: int, until: int):
        self.wid = wid
        self.kind = kind
        self.role = role
        self.p = p
        self.start = start
        self.until = until


class _Conn:
    """Per-connection shim state: label, side, journal, fired windows."""

    def __init__(self, plane: "WirePlane", label: str | None, side: str):
        self.plane = plane
        self.label = label
        self.side = side  # "client" | "broker"
        self.seq = 0
        self.events: list[dict] = []
        self.fired: set[tuple[str, int]] = set()
        self.write_index = 0

    def event(self, kind: str, **detail) -> None:
        if self.label is None:
            return  # pre-label broker I/O is unfaulted and unjournaled
        self.events.append({"conn": self.label, "seq": self.seq,
                            "tick": self.plane.tick, "kind": kind, **detail})
        self.seq += 1


class WirePlane:
    """The deterministic wire-fault engine (see module docstring)."""

    def __init__(self, seed: int):
        self.seed = seed
        self.tick = 0
        self.windows: list[_Window] = []
        self._wid = 0
        self.conns: dict[str, _Conn] = {}
        self._label_counts: dict[str, int] = {}
        self._tick_event = asyncio.Event()

    # ------------------------------------------------------------- clock

    def sync(self, tick: int) -> None:
        """Advance to the fault plane's tick: expire windows, wake stall
        waiters. Called by ``FaultPlane.advance`` when attached."""
        self.tick = tick
        self.windows = [w for w in self.windows if w.until > tick]
        ev, self._tick_event = self._tick_event, asyncio.Event()
        ev.set()

    def heal(self) -> None:
        """Drop every armed window and release stalled I/O."""
        self.windows = []
        ev, self._tick_event = self._tick_event, asyncio.Event()
        ev.set()

    async def _wait_past(self, until: int) -> None:
        while self.tick < until and any(w.until > self.tick
                                        for w in self.windows
                                        if w.kind == "conn_stall"):
            await self._tick_event.wait()

    # ---------------------------------------------------------- directives

    def arm(self, kind: str, role: str = "any", p: float = 1.0,
            until: int | None = None) -> None:
        assert kind in WIRE_FAULTS, kind
        self._wid += 1
        self.windows.append(_Window(self._wid, kind, role, p, self.tick,
                                    self.tick + 1 if until is None
                                    else until))
        log.debug("tick %d: wire %s armed role=%s p=%.2f until=%s",
                  self.tick, kind, role, p, until)

    def _active(self, kind: str, side: str) -> list[_Window]:
        return [w for w in self.windows
                if w.kind == kind and w.until > self.tick
                and w.role in ("any", side)]

    # ------------------------------------------------------- registration

    def _register(self, label: str, side: str) -> _Conn:
        # Reconnects reuse driver labels with attempt counters, but a
        # duplicate is still possible (two sockets to one broker slot);
        # suffix an ordinal so journals never interleave.
        n = self._label_counts.get(label, 0)
        self._label_counts[label] = n + 1
        full = label if n == 0 else f"{label}#{n}"
        conn = _Conn(self, full, side)
        self.conns[full] = conn
        conn.event("conn_open", side=side)
        return conn

    def client_wrap(self, label: str):
        """Shim factory for the wire driver: returns a ``(reader, writer)
        -> (reader, writer)`` wrapper registering a labeled client-side
        connection."""
        def wrap(reader, writer):
            conn = self._register(f"c:{label}", "client")
            return FaultyReader(self, conn, reader), \
                FaultyWriter(self, conn, writer)
        return wrap

    def wrap_server(self, reader, writer):
        """Broker-side shim: wraps an accepted pair with an UNLABELED
        connection (fates and journaling start once the first decoded
        request names the peer via :meth:`label_server`)."""
        conn = _Conn(self, None, "broker")
        return FaultyReader(self, conn, reader), \
            FaultyWriter(self, conn, writer)

    def label_server(self, writer, client_id: str | None,
                     prefix: str = "s") -> None:
        """Name a broker-side connection after its peer's ``client_id``
        (per-client ordinals keep labels unique and deterministic when the
        driver connects sequentially; multi-broker harnesses pass a
        per-node ``prefix`` so two brokers' accept orders never share a
        counter)."""
        conn = getattr(writer, "conn", None)
        if conn is None or conn.label is not None:
            return
        base = f"{prefix}:{client_id or '?'}"
        n = self._label_counts.get(base, 0)
        self._label_counts[base] = n + 1
        conn.label = base if n == 0 else f"{base}#{n}"
        self.conns[conn.label] = conn
        conn.event("conn_open", side="broker")

    def accept_allowed(self, label: str = "accept") -> bool:
        """Accept gate for the broker server; a refusal is journaled on a
        per-broker ``accept`` pseudo-connection."""
        if self._active("accept_refuse", "broker"):
            conn = self.conns.get(label)
            if conn is None:
                conn = _Conn(self, label, "broker")
                self.conns[label] = conn
            _m_refused.inc()
            conn.event("conn_refused")
            return False
        return True


    # ------------------------------------------------------------- fates

    def _decide(self, conn: _Conn, kind: str, wid: int, extra=None) -> float:
        """One-shot seeded draw in [0,1) for a fate decision — keyed, not
        streamed, so shims may check fates any number of times."""
        key = f"{self.seed}|{conn.label}|{kind}|{wid}"
        if extra is not None:
            key += f"|{extra}"
        return random.Random(key).random()

    async def gate(self, conn: _Conn, op: str) -> None:
        """Pre-I/O fate gate: stalls first (the window must be survivable),
        then resets. Resets fire on the WRITE side only: a reset on a
        header read is indistinguishable from a clean peer close (the
        frame readers deliberately fold it into EOF), so firing there
        would silently consume the window's one roll — the next write is
        where a reset is observable on both ends."""
        if conn.label is None:
            return
        stalls = self._active("conn_stall", conn.side)
        if stalls:
            until = max(w.until for w in stalls)
            for w in stalls:
                if ("conn_stall", w.wid) not in conn.fired:
                    conn.fired.add(("conn_stall", w.wid))
                    _m_stalls.inc()
                    conn.event("conn_stall", op=op, until=until)
            await self._wait_past(until)
        if op != "write":
            return
        for w in self._active("conn_reset", conn.side):
            if ("conn_reset", w.wid) in conn.fired:
                continue
            conn.fired.add(("conn_reset", w.wid))
            if self._decide(conn, "conn_reset", w.wid) < w.p:
                _m_resets.inc()
                conn.event("conn_reset", op=op)
                raise ConnectionResetError(
                    f"injected wire reset ({conn.label})")

    def tear(self, conn: _Conn, data: bytes) -> list[bytes]:
        """Torn-frames fate for one drained write: returns the pieces to
        flush separately (one piece = no tear)."""
        if conn.label is None or len(data) < 2:
            return [data]
        idx = conn.write_index
        conn.write_index += 1
        for w in self._active("torn_frames", conn.side):
            r = self._decide(conn, "torn_frames", w.wid, extra=idx)
            if r < w.p:
                # Cut point from the same keyed draw family, biased toward
                # the interesting low offsets (the 4-byte length prefix).
                cut_r = self._decide(conn, "torn_cut", w.wid, extra=idx)
                if cut_r < 0.5:
                    cut = 1 + int(cut_r * 2 * 3.999)     # 1..4: prefix tears
                else:
                    cut = 1 + int((cut_r - 0.5) * 2 * (len(data) - 1))
                cut = max(1, min(len(data) - 1, cut))
                _m_torn.inc()
                conn.event("torn_write", cut=cut, size=len(data))
                return [data[:cut], data[cut:]]
        return [data]

    # -------------------------------------------------------- exposition

    def event_log_jsonl(self) -> str:
        """Every connection journal, (label, seq)-ordered, one JSON object
        per line — the byte-identical-across-same-seed-runs artifact."""
        lines = []
        for label in sorted(self.conns):
            for ev in self.conns[label].events:
                lines.append(json.dumps(ev, sort_keys=True,
                                        separators=(",", ":")))
        return "\n".join(lines) + ("\n" if lines else "")

    def journals(self) -> dict[str, str]:
        """Per-connection journals as JSONL (the merged-journal artifact:
        merging = concatenating in sorted label order, which is exactly
        what :meth:`event_log_jsonl` emits)."""
        return {
            label: "".join(json.dumps(e, sort_keys=True,
                                      separators=(",", ":")) + "\n"
                           for e in conn.events)
            for label, conn in sorted(self.conns.items())
            if conn.events
        }

    def fate_log(self) -> dict[str, list[str]]:
        """The fate sequence per connection (event kinds, fates only)."""
        return {
            label: [e["kind"] for e in conn.events if e["kind"] != "conn_open"]
            for label, conn in sorted(self.conns.items())
            if any(e["kind"] != "conn_open" for e in conn.events)
        }

    def events(self) -> list[dict]:
        """All journal events in (label, seq) order (coverage substrate)."""
        out = []
        for label in sorted(self.conns):
            out.extend(self.conns[label].events)
        return out


class NodeShim:
    """Per-broker adapter handed to ``JosefineBroker.conn_shim``. Accept
    refusals journal per node (which broker refused is part of the fate
    history); server-side connection labels stay node-NEUTRAL — the
    client's own label (carried in client_id) names the connection, so a
    multi-node run whose post-heal re-election lands on a different
    coordinator still journals byte-identically (which physical broker
    served a group is an election outcome, not wire-fate behavior)."""

    def __init__(self, plane: WirePlane, node_id: int):
        self.plane = plane
        self.node_id = node_id

    def accept_allowed(self) -> bool:
        return self.plane.accept_allowed(label=f"accept:n{self.node_id}")

    def wrap_server(self, reader, writer):
        return self.plane.wrap_server(reader, writer)

    def label_server(self, writer, client_id: str | None) -> None:
        self.plane.label_server(writer, client_id, prefix="s")


class FaultyReader:
    """StreamReader proxy applying the plane's pre-I/O fate gate."""

    def __init__(self, plane: WirePlane, conn: _Conn, reader):
        self.plane = plane
        self.conn = conn
        self._reader = reader

    async def readexactly(self, n: int) -> bytes:
        await self.plane.gate(self.conn, "read")
        return await self._reader.readexactly(n)

    async def read(self, n: int = -1) -> bytes:
        await self.plane.gate(self.conn, "read")
        return await self._reader.read(n)

    async def readline(self) -> bytes:
        await self.plane.gate(self.conn, "read")
        return await self._reader.readline()

    def at_eof(self) -> bool:
        return self._reader.at_eof()


class FaultyWriter:
    """StreamWriter proxy: buffers writes and applies reset/stall/torn
    fates at drain time (the frame boundary, where a tear is observable
    as a partial Kafka frame on the peer)."""

    def __init__(self, plane: WirePlane, conn: _Conn, writer):
        self.plane = plane
        self.conn = conn
        self._writer = writer
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data

    async def drain(self) -> None:
        await self.plane.gate(self.conn, "write")
        data = bytes(self._buf)
        self._buf.clear()
        if not data:
            await self._writer.drain()
            return
        pieces = self.plane.tear(self.conn, data)
        for i, piece in enumerate(pieces):
            self._writer.write(piece)
            await self._writer.drain()
            if i + 1 < len(pieces):
                # Flush the torn prefix as its own segment so the peer's
                # frame reader observes the partial frame before the rest.
                await asyncio.sleep(0.002)

    def close(self) -> None:
        self._writer.close()

    async def wait_closed(self) -> None:
        await self._writer.wait_closed()

    def is_closing(self) -> bool:
        return self._writer.is_closing()

    def get_extra_info(self, name, default=None):
        return self._writer.get_extra_info(name, default)

    @property
    def transport(self):
        return self._writer.transport
