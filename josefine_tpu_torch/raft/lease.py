"""Tick-denominated leader leases: serve reads without a consensus round.

Every fetch/metadata today either reads whatever the local replica has
(no leadership guarantee at all) or would need a full consensus round
trip to be linearizable. The classic fix is the leader lease (the
Paxos/Raft porting survey, arxiv 1905.10786): a leader that knows a
quorum acknowledged its authority within the last election-timeout may
serve reads locally, because no rival can be elected while that quorum's
sticky-leader windows are open. Wall-clock leases import a clock-skew
hazard; THIS engine's lockstep tick substrate removes it — every lease
quantity below is denominated in device ticks, the same clock the
election timeout itself runs on, so the safety argument is exact
arithmetic, not bounded-drift hand-waving.

The lane is **observation-only**: nothing in the packed step reads any
lease state, so an engine with leases on emits byte-identical wire
traffic to its leases-off twin by construction (pinned by
tests/test_lease_safety.py's differentials). All lease state derives
host-side from evidence the tick-finish already fetches — the compact
outbox (which AppendEntries were shipped when) and delivered
APPEND_RESP acks — plus the role/term mirrors the scheduler maintains.
A (P, 3) device mirror plane [holder, expiry, term] is scatter-updated
for changed rows (packed_step._lease_plane_scatter_fn, co-sharded on the
'p' mesh by parallel.sharded.place_lease_plane) so device-side consumers
can read lease occupancy without a host round trip.

Evidence accounting — per-(group, peer) FIFO ship queues
--------------------------------------------------------

``evidence[g, s]`` is a lower bound on the latest tick at which peer
``s`` processed an AppendEntries from this leader (and therefore reset
its sticky-leader election window). It is maintained by:

* **record**: at tick_finish, every shipped AE cell (kind MSG_APPEND,
  any destination, not skip-suppressed) pushes ``(ship_tick, y)`` onto
  the (g, dst) queue, where ``y`` is the PRE-CAP send top from the
  compact outbox. A full queue REFUSES the push (drop-newest): dropping
  the oldest instead could match a later ack against a younger ship and
  over-credit.
* **credit**: an ``ok=1`` APPEND_RESP from peer ``s`` at the armed term
  carries ``x`` = the follower's post-accept head. Within one term the
  leader's send top is non-decreasing and links are FIFO (the lockstep
  fabric and per-connection TCP both preserve order), so every queued
  entry with ``y < x`` was shipped strictly before the acked frame —
  pop them all — and the OLDEST entry with ``y == x`` is the latest
  ship this ack can safely vouch for — pop it too. The credited tick is
  the newest popped ship tick. Acks for ``max_append_entries``-capped
  frames carry a capped head below the queued pre-cap ``y``; they match
  nothing and the entry drains under a later, higher ack — a
  conservative miss, never an over-credit. Message loss only
  under-credits.

Expiry: with ``m`` members (self included), a rival quorum that
excludes this leader has ``m - 1`` candidates and needs
``q = m//2 + 1`` grants, so it must intersect this leader's freshest
``n_need = m - m//2 - 1`` peers whenever ``n_need > m - 1 - q``.
Let ``Q`` be the ``n_need``-th largest peer evidence tick: every rival
quorum contains a peer whose sticky window was reset at or after ``Q``,
and that peer grants nothing (votes OR pre-votes OR term bumps) before
its local tick ``Q + 1 + timeout_min`` (delivery happens at least one
tick after the ship). Hence

    ``expiry = Q + timeout_min``  (exclusive; serve while now < expiry)

leaves a >= 1 tick margin below the earliest possible rival election.
``n_need == 0`` (m <= 2: every quorum contains this leader, who never
grants while leading — grants require the FOLLOWER role) degenerates to
a rolling ``now + timeout_min`` lease. Any in-kernel step-down (vote
granted at a higher term) lands in the role mirror within the same
tick_finish, so the serve gate (which checks the mirror) can never
serve past it.

**Substrate scope**: the argument needs the LOCKSTEP tick substrate —
every engine's tick counter advancing together (the in-process drivers,
the chaos harness, the sharded mesh). Pacer stride skew would let one
node's "tick" outrun another's and is out of scope: leases must stay
off under skewed pacing, and the bundled lease chaos schedules exclude
``skew`` ops. Renewal liveness additionally needs
``timeout_min > 2 * window + hb_ticks`` (a heartbeat round trip must
complete before the lease runs out); :func:`check_lease_params`
enforces it at engine construction.

Read modes built on the lane (``broker.read_mode``):

========== ==========================================================
local      today's behavior — serve the local replica, no guarantee
           (default; leases not consulted)
lease      serve leader-local iff the lease is valid; otherwise fall
           back to a read barrier, or retryable NotLeader
consensus  always pay the barrier (ReadIndex-style: resolve when a
           full quorum of peers acked ships from >= the read's tick)
========== ==========================================================

The barrier appends NOTHING to the log — it resolves off the same ack
evidence — so switching read modes never perturbs the write plane.
"""

from __future__ import annotations

import numpy as np

from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("raft.lease")

__all__ = ["LeaseLane", "NEG_TICK", "check_lease_params"]

#: "No evidence" sentinel: far enough below any real tick that
#: ``NEG_TICK + timeout_min`` still compares below tick 0.
NEG_TICK = np.int64(-(1 << 62))

#: Per-(group, peer) outstanding-ship queue depth. Acks normally drain
#: a queue within one round trip; 16 covers deep pipelined windows, and
#: overflow merely refuses new pushes (renewal pauses, never unsound).
QUEUE_DEPTH = 16

m_reads_leased = REGISTRY.counter(
    "raft_reads_leased_total",
    "Reads served leader-local under a valid tick lease "
    "(no consensus round trip)")
m_reads_fallback = REGISTRY.counter(
    "raft_reads_fallback_total",
    "Leased-read attempts that could not be served locally, by reason "
    "(not_leader / expired / frozen / off)")


def check_lease_params(params) -> None:
    """Validate the step params a lease lane depends on. Leases need the
    sticky-leader window (prevote) for the non-overlap argument and an
    election timeout wide enough for a heartbeat round trip to renew
    before expiry (ship tick t -> ack processed ~t+2 with hb every
    ``hb_ticks``)."""
    if int(getattr(params, "prevote", 0)) != 1:
        raise ValueError(
            "leases require params.prevote=1: the sticky-leader window "
            "is what makes the tick lease non-overlapping")
    t_min = int(params.timeout_min)
    hb = int(getattr(params, "hb_ticks", 1))
    if t_min <= 2 + hb:
        raise ValueError(
            f"leases need timeout_min > hb_ticks + 2 for renewal "
            f"liveness (timeout_min={t_min}, hb_ticks={hb}): a "
            f"heartbeat round trip must land before the lease expires")


class LeaseLane:
    """Host-side lease state for one engine (see module docstring).

    All arrays are dense over ``P`` — the lane is pure numpy bookkeeping
    over data tick_finish fetches anyway, and every per-tick operation
    is vectorized (no per-group Python in the steady state beyond the
    rows that actually changed)."""

    def __init__(self, P: int, N: int, me: int, timeout_min: int,
                 depth: int = QUEUE_DEPTH):
        self.P = int(P)
        self.N = int(N)
        self.me = int(me)
        self.timeout_min = int(timeout_min)
        self.depth = int(depth)
        i64 = np.int64
        # FIFO ship queues, ring-buffered per (group, peer).
        self._q_y = np.zeros((P, N, self.depth), i64)
        self._q_t = np.zeros((P, N, self.depth), i64)
        self._q_head = np.zeros((P, N), np.int32)
        self._q_len = np.zeros((P, N), np.int32)
        # Latest quorum-evidence tick per (group, peer); NEG_TICK = none.
        self.ev = np.full((P, N), NEG_TICK, i64)
        # Term the row's evidence is armed for (-1 = disarmed).
        self.ev_term = np.full(P, -1, i64)
        # Exclusive expiry tick (serve while now < expiry) + validity as
        # of the last recompute, for event diffing.
        self.expiry = np.full(P, NEG_TICK, i64)
        self.valid = np.zeros(P, bool)
        # Host mirror of the (P, 3) device plane [holder, expiry, term].
        self.plane_np = np.full((P, 3), -1, i64)
        self.plane_np[:, 1] = 0
        # Read-barrier waiters: group -> [(t0, future), ...].
        self.waiters: dict[int, list] = {}
        # Telemetry (summaries / tests).
        self.refused_pushes = 0   # queue-overflow push refusals
        self.credits = 0          # acks that advanced evidence

    # ------------------------------------------------------------ lifecycle

    def _clear_rows(self, rows) -> None:
        self._q_len[rows] = 0
        self._q_head[rows] = 0
        self.ev[rows] = NEG_TICK
        self.expiry[rows] = NEG_TICK

    def reset_rows(self, rows) -> None:
        """Disarm rows entirely (group reset/recycle/membership change):
        queued ships and evidence from the old incarnation or member set
        must never credit the new one."""
        rows = np.atleast_1d(np.asarray(rows, np.int64))
        if not len(rows):
            return
        self._clear_rows(rows)
        self.ev_term[rows] = -1
        self.valid[rows] = False

    def reset_all(self) -> None:
        """Cluster membership changed: every row's quorum arithmetic is
        suspect — disarm everything and re-earn evidence."""
        self.reset_rows(np.arange(self.P, dtype=np.int64))

    def resync(self, lead: np.ndarray, term: np.ndarray) -> None:
        """Align armed terms with the post-adoption role/term mirrors:
        rows that stopped leading (or changed term) disarm; rows leading
        at a term they are not armed for arm fresh (evidence cleared —
        a new term's lease is earned from that term's own acks)."""
        armed = self.ev_term != -1
        stale = armed & (~lead | (self.ev_term != term))
        if stale.any():
            rows = np.nonzero(stale)[0]
            self._clear_rows(rows)
            self.ev_term[rows] = -1
        fresh = lead & (self.ev_term != term)
        if fresh.any():
            rows = np.nonzero(fresh)[0]
            self._clear_rows(rows)
            self.ev_term[rows] = term[rows]

    # -------------------------------------------------------------- evidence

    def record(self, gs: np.ndarray, dsts: np.ndarray, y64: np.ndarray,
               t_now: int) -> None:
        """Push this tick's shipped AEs onto their (group, dst) queues
        (vectorized: one AE per (g, dst) per tick, so the index pairs are
        unique). Full queues refuse the push — see module docstring."""
        if not len(gs):
            return
        room = self._q_len[gs, dsts] < self.depth
        if not room.all():
            self.refused_pushes += int((~room).sum())
            gs, dsts, y64 = gs[room], dsts[room], y64[room]
            if not len(gs):
                return
        slot = (self._q_head[gs, dsts] + self._q_len[gs, dsts]) % self.depth
        self._q_y[gs, dsts, slot] = y64
        self._q_t[gs, dsts, slot] = t_now
        self._q_len[gs, dsts] += 1

    def credit(self, g: int, s: int, x: int, term: int) -> None:
        """Drain the (g, s) queue against an ok APPEND_RESP carrying
        post-accept head ``x`` at ``term`` (the monotone-y pop rule from
        the module docstring) and advance ``evidence[g, s]``."""
        g = int(g)
        if term != self.ev_term[g]:
            return
        n = int(self._q_len[g, s])
        if n == 0:
            return
        h = int(self._q_head[g, s])
        idx = (h + np.arange(n)) % self.depth
        ys = self._q_y[g, s, idx]
        # ys is non-decreasing (send top is monotone within a term):
        # pop everything below x, plus the oldest entry equal to x.
        npop = int(np.searchsorted(ys, x, side="left"))
        if npop < n and ys[npop] == x:
            npop += 1
        if npop == 0:
            return
        t = self._q_t[g, s, idx[npop - 1]]
        self._q_head[g, s] = (h + npop) % self.depth
        self._q_len[g, s] = n - npop
        if t > self.ev[g, s]:
            self.ev[g, s] = t
        self.credits += 1

    def credit_many(self, gs, srcs, xs, terms) -> None:
        """Column form of :meth:`credit` (batch intake / routed-fabric
        hook). ``srcs`` may be a scalar (routed: one sender per push)."""
        scalar_src = not hasattr(srcs, "__len__")
        for i in range(len(gs)):
            self.credit(int(gs[i]), int(srcs) if scalar_src
                        else int(srcs[i]), int(xs[i]), int(terms[i]))

    # -------------------------------------------------------------- recompute

    @staticmethod
    def _n_need(m: np.ndarray) -> np.ndarray:
        """Freshest-peer count whose sticky windows block every rival
        quorum that excludes this leader (module docstring)."""
        return np.maximum(m - m // 2 - 1, 0)

    def _quorum_tick(self, rows: np.ndarray, mask: np.ndarray,
                     need: np.ndarray) -> np.ndarray:
        """Per row: the ``need``-th largest peer evidence tick (NEG_TICK
        when fewer than ``need`` peers have any). ``need`` must be >= 1
        for every row passed."""
        evl = np.where(mask[rows], self.ev[rows], NEG_TICK)
        evl[:, self.me] = NEG_TICK
        srt = np.sort(evl, axis=1)  # ascending; k-th largest at N - k
        col = np.clip(self.N - need, 0, self.N - 1)
        return srt[np.arange(len(rows)), col]

    def recompute(self, now: int, lead: np.ndarray, term: np.ndarray,
                  mask: np.ndarray) -> dict:
        """Recompute every led row's expiry from current evidence and
        diff validity for flight events. ``lead``/``term`` are the
        post-adoption role/term mirrors, ``mask`` the (P, N) member
        mask (self included). Returns index arrays for acquired /
        renewed / expired transitions plus the changed device-plane rows
        and their [holder, expiry, term] values."""
        old_exp = self.expiry.copy()
        was = self.valid
        new_exp = np.full(self.P, NEG_TICK, np.int64)
        led = np.nonzero(lead & (self.ev_term == term))[0]
        n_need = None
        if len(led):
            m = mask[led].sum(axis=1).astype(np.int64)
            n_need = self._n_need(m)
            exp_led = np.full(len(led), np.int64(now), np.int64)
            pos = n_need > 0
            if pos.any():
                exp_led[pos] = self._quorum_tick(led[pos], mask,
                                                 n_need[pos])
            new_exp[led] = exp_led + self.timeout_min
        valid = np.zeros(self.P, bool)
        valid[led] = now < new_exp[led]
        self.expiry = new_exp
        self.valid = valid
        acquired = np.nonzero(valid & ~was)[0]
        expired = np.nonzero(was & ~valid)[0]
        renewed = np.zeros(0, np.int64)
        if len(led):
            # Renewal events only where fresh acks moved the quorum tick
            # (n_need > 0); rolling n_need==0 rows advance every tick and
            # would flood the journal with no information.
            grew = np.zeros(self.P, bool)
            grew[led] = (new_exp[led] > old_exp[led]) & (n_need > 0)
            renewed = np.nonzero(valid & was & grew)[0]
        # Device mirror plane: [holder, expiry, term] per row.
        holder = np.where(valid, np.int64(self.me), np.int64(-1))
        exp_col = np.where(valid, new_exp, 0)
        term_col = np.where(valid, self.ev_term, np.int64(-1))
        plane_new = np.stack([holder, exp_col, term_col], axis=1)
        changed = np.nonzero((plane_new != self.plane_np).any(axis=1))[0]
        self.plane_np = plane_new
        return {"acquired": acquired, "renewed": renewed,
                "expired": expired, "changed": changed,
                "plane_vals": plane_new[changed]}

    # --------------------------------------------------------- read barriers

    def add_waiter(self, g: int, t0: int, fut) -> None:
        self.waiters.setdefault(int(g), []).append((int(t0), fut))

    def resolve_waiters(self, lead: np.ndarray, term: np.ndarray,
                        mask: np.ndarray) -> None:
        """Settle read barriers: a waiter (g, t0) resolves True once a
        full quorum of peers (``m//2`` of them — quorum minus self) has
        acked ships recorded at tick >= t0, proving this node was still
        the leader when the read arrived; it resolves False (NotLeader —
        the caller surfaces a retryable error) the moment the row stops
        leading at its armed term."""
        if not self.waiters:
            return
        for g in list(self.waiters):
            if not (lead[g] and self.ev_term[g] == term[g]):
                for _, fut in self.waiters.pop(g):
                    if not fut.done():
                        fut.set_result(False)
                continue
            m = int(mask[g].sum())
            need = m // 2  # quorum size minus self
            if need > 0:
                peers = np.where(mask[g], self.ev[g], NEG_TICK).copy()
                peers[self.me] = NEG_TICK
                qtick = np.sort(peers)[self.N - need]
            pend = self.waiters[g]
            keep = []
            for t0, fut in pend:
                if need == 0 or qtick >= t0:
                    if not fut.done():
                        fut.set_result(True)
                else:
                    keep.append((t0, fut))
            if keep:
                self.waiters[g] = keep
            else:
                del self.waiters[g]

    def fail_all_waiters(self) -> None:
        """Engine teardown / full reset: nothing will resolve these."""
        for g in list(self.waiters):
            for _, fut in self.waiters.pop(g):
                if not fut.done():
                    fut.set_result(False)

    # ------------------------------------------------------------- telemetry

    def valid_count(self) -> int:
        return int(self.valid.sum())

    def summary(self) -> dict:
        return {
            "held": self.valid_count(),
            "credits": int(self.credits),
            "refused_pushes": int(self.refused_pushes),
            "armed": int((self.ev_term != -1).sum()),
        }
