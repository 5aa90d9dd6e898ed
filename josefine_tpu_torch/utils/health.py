"""Deterministic, tick-denominated cluster health plane.

The :class:`HealthMonitor` is the online half of the cluster doctor
(`tools/doctor.py` is the offline half).  It is evaluated once per tick
off state the caller already maintains — host mirrors, workload
counters, flight aggregates — and performs **zero device fetches, zero
wall-clock reads, zero RNG draws**.  Same seed ⇒ byte-identical
``health_*`` event streams, and a health-on run is byte-identical to
its health-off twin on every other telemetry plane (the monitor owns a
*private* :class:`~josefine_tpu.utils.flight.FlightRecorder`; nothing
it does feeds back into the system under observation).

Detector catalog (all thresholds tick-denominated, see
:class:`HealthThresholds`):

``commit_stall``
    Per group: ticks since commit progress while work is outstanding —
    the chaos ``commitless_limit`` availability probe generalized and
    always-on.  Idle groups (no pending work) never accrue stall.
``leader_flap``
    Per group: leader-identity changes inside a sliding window.  Only
    transitions between two *known* leaders count; the initial
    election is not a flap.
``replication_lag``
    Per group: consecutive ticks with the commit *spread* — the gap in
    entries between the most- and least-advanced live commit frontier
    — at or above a floor.  Spread, not head−commit depth: pipeline
    depth under load is healthy; one replica trailing the pack is not.
``lease_storm``
    Cluster: lease refusals + expiries inside a sliding window.
``migration_wedge``
    Cluster: an active migration whose fence has been armed longer
    than N ticks with no ack/adoption progress.
``backpressure_sat``
    Cluster: produce backpressure/refusal events inside a window.
``wire_retry_storm``
    Cluster: client wire retries + reconnects inside a window.
``phase_regime``
    Cluster: the dominant span phase (by windowed ticks) flips away
    from an established baseline, e.g. ``admission`` → ``consensus``.

Each detector drives a per-scope three-state FSM ``ok → degraded →
critical``.  Escalation is immediate; de-escalation requires
``recover_ticks`` consecutive ticks below the current level and steps
down to the worst level seen during that streak (no flapping straight
to ``ok`` through a single quiet tick).  Every transition journals as
a ``health_ok`` / ``health_degraded`` / ``health_critical`` flight
event and exports as the ``cluster_health{scope,detector}`` gauge.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, fields

import numpy as np

from josefine_tpu_torch.utils.flight import FlightRecorder
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.spans import PHASES

OK, DEGRADED, CRITICAL = 0, 1, 2
LEVELS = ("ok", "degraded", "critical")

#: detector name -> one-line description (mirrored in ARCHITECTURE.md).
DETECTORS = {
    "commit_stall": "no commit progress on a group while work is outstanding",
    "leader_flap": "leader identity churning inside a sliding window",
    "replication_lag": "sustained head-commit divergence on a group",
    "lease_storm": "lease refusals/expiries bursting inside a window",
    "migration_wedge": "armed migration fence with no ack progress",
    "backpressure_sat": "produce backpressure/refusals saturating a window",
    "wire_retry_storm": "client wire retries/reconnects bursting",
    "phase_regime": "dominant span phase flipped from its baseline",
}

_m_health = REGISTRY.gauge(
    "cluster_health",
    "Health FSM level per scope/detector: 0 ok, 1 degraded, 2 critical",
    max_series=4096,
)


@dataclass(frozen=True)
class HealthThresholds:
    """Tick-denominated detector thresholds (all deterministic ints)."""

    #: detectors report ok unconditionally for the first `warmup` ticks
    #: (boot elections and first commits are not incidents).
    warmup: int = 20
    #: consecutive below-level ticks required before the FSM steps down.
    recover_ticks: int = 10
    # commit_stall: ticks without progress while work is pending.
    # Calibrated on the chaos corpus: clean-seed max 17 (workload under
    # default message noise), faulted schedules 32-75.
    stall_degraded: int = 24
    stall_critical: int = 45
    # leader_flap: leader changes within flap_window ticks. Clean runs
    # measure ZERO post-boot changes, so two in a window is already
    # pathological.
    flap_window: int = 150
    flap_degraded: int = 2
    flap_critical: int = 4
    # replication_lag: commit spread (most- minus least-advanced live
    # commit frontier, in entries) >= lag_entries, sustained N ticks.
    # Calibrated: clean-seed max sustained run 8 at floor 12; faulted
    # schedules 18-72.
    lag_entries: int = 12
    lag_sustain: int = 15
    lag_critical_sustain: int = 45
    # lease_storm: refusals+expiries within lease_window ticks.
    # Calibrated against the stale-read probe on the 2-group harness
    # shape: a clean lease soak's refusal rate is hard-ceilinged at 2
    # per tick (one probe per group), so 60/window is the clean maximum
    # by construction; sustained rates above it mean MULTIPLE concurrent
    # believers refusing — the split-brain expiry signature (measured
    # 80-86 under lease-expiry-under-partition).
    lease_window: int = 30
    lease_degraded: int = 70
    lease_critical: int = 110
    # migration_wedge: ticks with an armed fence and no progress.
    wedge_degraded: int = 20
    wedge_critical: int = 60
    # backpressure_sat: backpressure events within bp_window ticks.
    bp_window: int = 30
    bp_degraded: int = 25
    bp_critical: int = 120
    # wire_retry_storm: retries+reconnects within retry_window ticks.
    retry_window: int = 30
    retry_degraded: int = 12
    retry_critical: int = 48
    # phase_regime: dominant-phase shift detection.
    regime_window: int = 40
    regime_floor: int = 16
    regime_confirm: int = 6
    regime_hold: int = 40

    def as_dict(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def wire(cls) -> "HealthThresholds":
        """Wire-soak tuning: the lockstep rig produces every few ticks
        and acks in-cadence, so its clean stall ceiling (measured 3)
        sits far below the chaos harness's noise-driven one, and its
        clean reconnect count is exactly zero — a single fate-induced
        reconnect is already anomalous. Wire schedules are short
        (horizon 110-140, faults from tick ~15), so warmup shrinks to
        the mesh-warming prelude."""
        return cls(warmup=10, stall_degraded=14, stall_critical=28,
                   retry_window=30, retry_degraded=1, retry_critical=4)


def _as_i64(x):
    return np.asarray(x, dtype=np.int64).reshape(-1)


class HealthMonitor:
    """Online detector bank + per-scope health FSMs.

    Strictly read-only over the system it observes: ``observe`` takes a
    plain sample dict (every key optional — a detector without its
    inputs simply never fires) and all output goes to a private flight
    ring plus the ``cluster_health`` gauge.

    Sample keys::

        progress       per-group cumulative commit/ack counter
        pending        per-group outstanding work (incl. queued retries)
        leaders        per-group leader node id (-1 unknown)
        lag            per-group commit spread in entries (max-min
                       live commit frontier)
        lease_refused  cumulative lease refusals      (cluster scalar)
        lease_expired  cumulative lease expiries      (cluster scalar)
        migration      None | {"active","started","progress"}
        backpressure   cumulative backpressure events (cluster scalar)
        wire_retries   cumulative wire retries        (cluster scalar)
        phases         cumulative span phase totals {phase: ticks,
                       "count": finished spans}
    """

    def __init__(self, groups=1, thresholds=None, ring=4096, node=None,
                 publish=True, extra_fn=None):
        self.groups = int(groups)
        self.th = thresholds or HealthThresholds()
        self.node = node
        self.publish = bool(publish)
        self.extra_fn = extra_fn
        self.flight = FlightRecorder(capacity=ring)
        self.tick = -1
        self._det = {}       # name -> FSM arrays
        self._first = {}     # name -> {"degraded": tick, ...}
        self._transitions = 0
        # detector-private memory
        self._stall_prog = None
        self._stall_tick = None
        self._flap_last = None
        self._flap_hist = deque()
        self._lag_run = None
        self._win = {}       # name -> deque[(tick, cumulative)]
        self._mig_prog = -1
        self._mig_prog_tick = -1
        self._regime_hist = deque()
        self._regime_base = None
        self._regime_cand = None
        self._regime_streak = 0

    # ---------------------------------------------------------------- FSM

    def _ensure(self, det, n, cluster):
        d = self._det.get(det)
        if d is None or d["state"].shape[0] != n:
            d = {
                "state": np.zeros(n, np.int8),
                "below": np.zeros(n, np.int32),
                "pend": np.zeros(n, np.int8),
                "worst": np.zeros(n, np.int8),
                "cluster": cluster,
            }
            self._det[det] = d
        return d

    def _transition(self, det, idx, prev, new, value, tick, cluster, extra):
        scope = "cluster" if cluster else "g%d" % idx
        detail = {"detector": det, "scope": scope, "value": int(value),
                  "prev": LEVELS[prev]}
        if extra:
            detail.update(extra)
        self.flight.emit(tick, "health_" + LEVELS[new],
                         group=(-1 if cluster else idx), **detail)
        self._transitions += 1
        first = self._first.setdefault(det, {})
        if new >= DEGRADED and "degraded" not in first:
            first["degraded"] = tick
            first["degraded_scope"] = scope
        if new >= CRITICAL and "critical" not in first:
            first["critical"] = tick
            first["critical_scope"] = scope
        if self.publish:
            labels = {"scope": scope, "detector": det}
            if self.node is not None:
                labels["node"] = self.node
            _m_health.set(new, **labels)

    def _fsm(self, det, raw, value, tick, cluster=False, extra=None):
        raw = np.asarray(raw, dtype=np.int8).reshape(-1)
        value = _as_i64(value)
        d = self._ensure(det, raw.shape[0], cluster)
        st, below, pend = d["state"], d["below"], d["pend"]
        up = raw > st
        if up.any():
            for g in np.nonzero(up)[0].tolist():
                self._transition(det, g, int(st[g]), int(raw[g]),
                                 int(value[g]), tick, cluster, extra)
            st[up] = raw[up]
            below[up] = 0
            pend[up] = 0
        down = raw < st
        hold = ~up & ~down
        below[hold] = 0
        pend[hold] = 0
        if down.any():
            np.maximum(pend, raw, out=pend, where=down)
            below[down] += 1
            rec = down & (below >= self.th.recover_ticks)
            if rec.any():
                for g in np.nonzero(rec)[0].tolist():
                    self._transition(det, g, int(st[g]), int(pend[g]),
                                     int(value[g]), tick, cluster, extra)
                st[rec] = pend[rec]
                below[rec] = 0
                pend[rec] = 0
        np.maximum(d["worst"], st, out=d["worst"])

    def _fsm_scalar(self, det, raw, value, tick, extra=None):
        self._fsm(det, np.array([raw], np.int8), np.array([value], np.int64),
                  tick, cluster=True, extra=extra)

    @staticmethod
    def _lvl(v, deg, crit):
        return (2 if v >= crit else (1 if v >= deg else 0))

    def _window_rate(self, name, tick, cum, window):
        hist = self._win.setdefault(name, deque())
        if tick < self.th.warmup:
            # Boot grace for cumulative counters too: keep only the
            # latest pre-warmup point, so the first post-warmup window's
            # baseline already includes every boot-phase increment.
            hist.clear()
        hist.append((tick, cum))
        while hist and hist[0][0] < tick - window:
            hist.popleft()
        return cum - hist[0][1]

    # ------------------------------------------------------------ observe

    def observe(self, tick, sample=None):
        """Evaluate every detector whose inputs are present in `sample`."""
        tick = int(tick)
        self.tick = tick
        s = dict(sample) if sample else {}
        if self.extra_fn is not None:
            extra = self.extra_fn()
            if extra:
                s.update(extra)
        th = self.th
        warm = tick >= th.warmup

        # -- commit_stall: per group, progress vs outstanding work.
        if "progress" in s:
            prog = _as_i64(s["progress"])
            n = prog.shape[0]
            pend = s.get("pending")
            pend = (np.zeros(n, np.int64) if pend is None else _as_i64(pend))
            if self._stall_prog is None or self._stall_prog.shape[0] != n:
                self._stall_prog = prog.copy()
                self._stall_tick = np.full(n, tick, np.int64)
            grew = prog > self._stall_prog
            idle = (~grew) & (pend <= 0)
            self._stall_tick[grew | idle] = tick
            np.maximum(self._stall_prog, prog, out=self._stall_prog)
            if not warm:
                # Boot grace: the stall clock starts at warmup's end, so
                # a slow first election can never leak into the first
                # post-warmup evaluations.
                self._stall_tick[:] = tick
            stall = tick - self._stall_tick
            raw = ((stall >= th.stall_degraded).astype(np.int8)
                   + (stall >= th.stall_critical).astype(np.int8))
            self._fsm("commit_stall", raw, stall, tick)

        # -- leader_flap: per group, known-leader identity changes.
        if "leaders" in s:
            lead = _as_i64(s["leaders"])
            n = lead.shape[0]
            if self._flap_last is None or self._flap_last.shape[0] != n:
                self._flap_last = np.full(n, -1, np.int64)
            known = lead >= 0
            changed = known & (self._flap_last >= 0) & (lead != self._flap_last)
            for g in np.nonzero(changed)[0].tolist():
                self._flap_hist.append((tick, g))
            self._flap_last[known] = lead[known]
            while self._flap_hist and self._flap_hist[0][0] <= tick - th.flap_window:
                self._flap_hist.popleft()
            cnt = np.zeros(n, np.int64)
            for _, g in self._flap_hist:
                if g < n:
                    cnt[g] += 1
            raw = ((cnt >= th.flap_degraded).astype(np.int8)
                   + (cnt >= th.flap_critical).astype(np.int8))
            if not warm:
                raw[:] = 0
            self._fsm("leader_flap", raw, cnt, tick)

        # -- replication_lag: per group, sustained head-commit divergence.
        if "lag" in s:
            lag = _as_i64(s["lag"])
            n = lag.shape[0]
            if self._lag_run is None or self._lag_run.shape[0] != n:
                self._lag_run = np.zeros(n, np.int64)
            over = lag >= th.lag_entries
            self._lag_run[over] += 1
            self._lag_run[~over] = 0
            if not warm:
                self._lag_run[:] = 0
            raw = ((self._lag_run >= th.lag_sustain).astype(np.int8)
                   + (self._lag_run >= th.lag_critical_sustain).astype(np.int8))
            self._fsm("replication_lag", raw, lag, tick)

        # -- lease_storm: windowed refusals + expiries.
        if "lease_refused" in s or "lease_expired" in s:
            cum = int(s.get("lease_refused", 0)) + int(s.get("lease_expired", 0))
            rate = self._window_rate("lease_storm", tick, cum, th.lease_window)
            raw = self._lvl(rate, th.lease_degraded, th.lease_critical)
            self._fsm_scalar("lease_storm", raw if warm else 0, rate, tick)

        # -- migration_wedge: armed fence with no ack/adoption progress.
        if "migration" in s:
            m = s["migration"]
            wedge = 0
            if m and m.get("active"):
                pr = int(m.get("progress", 0))
                if pr != self._mig_prog:
                    self._mig_prog = pr
                    self._mig_prog_tick = tick
                start = int(m.get("started", tick))
                wedge = tick - max(start, self._mig_prog_tick)
            else:
                self._mig_prog = -1
                self._mig_prog_tick = -1
            raw = self._lvl(wedge, th.wedge_degraded, th.wedge_critical)
            self._fsm_scalar("migration_wedge", raw if warm else 0, wedge, tick)

        # -- backpressure_sat: windowed produce backpressure/refusals.
        if "backpressure" in s:
            rate = self._window_rate("backpressure_sat", tick,
                                     int(s["backpressure"]), th.bp_window)
            raw = self._lvl(rate, th.bp_degraded, th.bp_critical)
            self._fsm_scalar("backpressure_sat", raw if warm else 0, rate, tick)

        # -- wire_retry_storm: windowed client retries/reconnects.
        if "wire_retries" in s:
            rate = self._window_rate("wire_retry_storm", tick,
                                     int(s["wire_retries"]), th.retry_window)
            raw = self._lvl(rate, th.retry_degraded, th.retry_critical)
            self._fsm_scalar("wire_retry_storm", raw if warm else 0, rate, tick)

        # -- phase_regime: dominant span phase vs established baseline.
        if "phases" in s:
            cur = {k: int(v) for k, v in s["phases"].items()}
            hist = self._regime_hist
            hist.append((tick, cur))
            while hist and hist[0][0] < tick - th.regime_window:
                hist.popleft()
            base = hist[0][1]
            dcount = cur.get("count", 0) - base.get("count", 0)
            dom = None
            if dcount >= th.regime_floor:
                best = -1
                for p in PHASES:
                    dv = cur.get(p, 0) - base.get(p, 0)
                    if dv > best:
                        best = dv
                        dom = p
            raw = 0
            shifted_from = self._regime_base
            if dom is None or dom == self._regime_base:
                self._regime_cand = None
                self._regime_streak = 0
            else:
                if dom == self._regime_cand:
                    self._regime_streak += 1
                else:
                    self._regime_cand = dom
                    self._regime_streak = 1
                if self._regime_base is None:
                    if self._regime_streak >= th.regime_confirm:
                        self._regime_base = dom
                        self._regime_cand = None
                        self._regime_streak = 0
                else:
                    if self._regime_streak >= th.regime_confirm:
                        raw = 1
                    if self._regime_streak >= th.regime_hold:
                        self._regime_base = dom
                        self._regime_cand = None
                        self._regime_streak = 0
            extra = None
            if raw:
                extra = {"from": shifted_from or "", "to": self._regime_cand or ""}
            self._fsm_scalar("phase_regime", raw if warm else 0,
                             self._regime_streak, tick, extra=extra)

    # ------------------------------------------------------------- output

    def status(self):
        """Current FSM levels, sorted and JSON-ready (the /health body)."""
        worst = 0
        dets = {}
        for det in sorted(self._det):
            d = self._det[det]
            st = d["state"]
            if st.shape[0]:
                worst = max(worst, int(st.max()))
            scopes = {}
            for g in np.nonzero(st)[0].tolist():
                scope = "cluster" if d["cluster"] else "g%d" % g
                scopes[scope] = LEVELS[int(st[g])]
            dets[det] = scopes
        return {"tick": self.tick, "overall": LEVELS[worst],
                "detectors": dets, "transitions": self._transitions}

    def verdicts(self):
        """Whole-run verdicts: worst level ever + first-fire ticks."""
        overall = 0
        dets = {}
        for det in sorted(self._det):
            d = self._det[det]
            w = int(d["worst"].max()) if d["worst"].shape[0] else 0
            cur = int(d["state"].max()) if d["state"].shape[0] else 0
            overall = max(overall, w)
            v = {"level": LEVELS[cur], "worst": LEVELS[w]}
            first = self._first.get(det)
            if first:
                for k in sorted(first):
                    v["first_" + k] = first[k]
            dets[det] = v
        return {"overall": LEVELS[overall], "detectors": dets,
                "transitions": self._transitions}

    def first_fire(self, det, level="degraded"):
        """Tick of the first transition to >= `level` for `det`, or None."""
        return self._first.get(det, {}).get(level)

    def snapshot(self):
        """Full /health payload: status + verdicts + event ring."""
        return {"status": self.status(), "verdicts": self.verdicts(),
                "events": self.flight.events()}

    def events(self, limit=None, group=None, kind=None, since=None):
        return self.flight.events(limit=limit, group=group, kind=kind,
                                  since=since)

    def dump_jsonl(self):
        return self.flight.dump_jsonl()
