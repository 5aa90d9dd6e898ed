"""Structured tracing.

Parity: reference tracing setup (``src/main.rs:41-52``: env-filtered DEBUG,
compact stdout) and the command-class log levels of
``src/raft/mod.rs:367-388`` (Tick/Heartbeat/Append at TRACE, the rest DEBUG).

Python's logging has no TRACE level; we register one at 5 so the hot-path
commands can be silenced independently of DEBUG, exactly as the reference
separates per-tick noise from state transitions.

Relationship to the other causal planes: the TRACE-level shim is the
*human* log — free-text, wall-clock-timestamped on stdout, never part of
any determinism contract. Request spans (``utils/spans.py``) are the
*request* plane — tick-denominated phase trees minted per request; the
flight recorder (``utils/flight.py``) is the *cluster* plane — structured
consensus events. :func:`attach_flight_journal` bridges the first into
the third: WARNING+ records on the ``josefine`` logger also land in a
flight journal as ``log_event`` entries (tick-stamped via the supplied
clock, bounded by the journal's own ring), so a merged cluster timeline
captures broker-side errors — a slow-client eviction's WARNING sits in
tick order next to the consensus transitions that surrounded it. The
bridge is explicitly attached (the product Node wires it to its own
engine's journal); it is NOT installed by default, because log text may
carry nondeterministic detail (peer ports, OS error strings) that must
not silently enter journals whose byte-identity a harness asserts.
"""

from __future__ import annotations

import logging
import os
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def _trace(self, msg, *args, **kwargs):
    if self.isEnabledFor(TRACE):
        self._log(TRACE, msg, args, **kwargs)


logging.Logger.trace = _trace  # type: ignore[attr-defined]


def setup_tracing(level: str | None = None) -> None:
    """Install a compact stdout handler, env-filtered via JOSEFINE_LOG."""
    level_name = (level or os.environ.get("JOSEFINE_LOG", "INFO")).upper()
    lvl = TRACE if level_name == "TRACE" else getattr(logging, level_name, logging.INFO)
    root = logging.getLogger("josefine")
    root.setLevel(lvl)
    if not root.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s", "%H:%M:%S"))
        root.addHandler(h)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"josefine.{name}")


class FlightLogHandler(logging.Handler):
    """Bridges WARNING+ ``josefine`` log records into a flight journal.

    Each record becomes a ``log_event`` flight entry stamped with the
    supplied tick clock (wall-clock-free — the journal's ordering
    contract), carrying ``{logger, level, msg}`` in detail. Ring-bounded
    by construction: entries land in the target :class:`FlightRecorder`'s
    own ring. A journal emit must never recurse into logging or take the
    process down with it, so emission failures are swallowed via
    :meth:`handleError`.

    In a multi-node process every attached handler sees the shared
    ``josefine`` logger's records, so each node's journal records every
    node's warnings — acceptable for merged timelines (the ``node``
    column still says whose journal carried it), and production runs one
    node per process.
    """

    def __init__(self, emit_fn, clock, level: int = logging.WARNING):
        super().__init__(level=level)
        self._emit = emit_fn
        self._clock = clock

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._emit(int(self._clock()), "log_event",
                       logger=record.name, level=record.levelname,
                       msg=record.getMessage())
        except Exception:
            self.handleError(record)


def attach_flight_journal(emit_fn, clock,
                          level: int = logging.WARNING) -> FlightLogHandler:
    """Attach a :class:`FlightLogHandler` to the ``josefine`` root logger.

    ``emit_fn(tick, kind, **detail)`` is a journal emit (typically
    ``FlightRecorder.emit``); ``clock()`` returns the current engine tick
    (typically ``engine._flight_tick``). Returns the handler — pass it to
    :func:`detach_flight_journal` at shutdown.
    """
    handler = FlightLogHandler(emit_fn, clock, level=level)
    logging.getLogger("josefine").addHandler(handler)
    return handler


def detach_flight_journal(handler: FlightLogHandler) -> None:
    logging.getLogger("josefine").removeHandler(handler)
