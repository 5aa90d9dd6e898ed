"""PyTorch port, consensus engine: a twin in-process cluster.

Three JAX engines and three port engines (``device="cpu"``) get the same
``receive``/``propose`` sequence. On every tick the port's engines must
equal the JAX engines exactly: every ``_h_*`` host mirror, the device state
leaves, every chain's head/commit/floor, every FSM's applied payloads, the
flight journal, and the encoded bytes of every outbound wire message.

Scenarios: split-phase single ticks, adaptive window 4, a 15-tick partition
of engine 2 healed through a snapshot install and ``max_append_entries=2``
capped catch-up (the send-pointer fixup path), ``recycle_group`` mid-run,
``tick_pipelined`` (with the wire journal, request spans and the health
monitor on), and the port's ``backend="python"`` engine; then the scale
path: sparse packed IO with a compaction capacity of 8 (every burst
overflows), and the active-set scheduler through a partition heal (mass
wake-up) and a recycle, pipelined windows, forced fallback re-entries (also
over sparse IO) and the python backend. With the active set on, the
scheduler's counts and the sparse capacity are compared too.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from josefine_tpu.models.types import step_params as jax_step_params
from josefine_tpu.raft.engine import RaftEngine as JaxEngine
from josefine_tpu.utils.kv import MemKV as JaxKV
from josefine_tpu_torch import bench_engine, interop
from josefine_tpu_torch.models.types import step_params
from josefine_tpu_torch.parallel.sharded import Mesh, make_mesh
from josefine_tpu_torch.raft.engine import RaftEngine
from josefine_tpu_torch.raft.route import RouteFabric
from josefine_tpu_torch.utils.kv import MemKV

from torch_parity import STATE_NAMES, assert_leaves_equal

IDS = [1, 2, 3]


class ListFsm:
    """Records every applied payload."""

    def __init__(self):
        self.applied = []

    def transition(self, data):
        self.applied.append(bytes(data))
        return b"ok:" + data


class SnapFsm(ListFsm):
    """ListFsm with the snapshot pair: snapshot-capable groups compact their
    chains and catch followers up by snapshot install."""

    def snapshot(self):
        return json.dumps([a.hex() for a in self.applied]).encode()

    def restore(self, data):
        self.applied = [bytes.fromhex(a) for a in json.loads(data)] if data else []


def encode_all(outbound) -> list[bytes]:
    return [m.encode() for m in outbound]


def h_mirrors(engine) -> dict[str, np.ndarray]:
    return {k: v for k, v in vars(engine).items()
            if k.startswith("_h_") and isinstance(v, np.ndarray)}


class Twin:
    """JAX engines and port engines (three by default), stepped and fed
    alike. Slot i holds node id ``ids[i]``; the first ``started`` slots
    start at once, the others (``None``) with :meth:`start` later."""

    def __init__(self, groups=8, hb_ticks=8, port_backend="torch", snap_groups=(),
                 sparse_io=False, k_out=None, fallback_frac=None, timeouts=(3, 8),
                 jax_kw=None, port_kw=None, ids=IDS, started=None, fsm_groups=2,
                 **engine_kw):
        """``engine_kw`` goes to every engine, ``jax_kw`` / ``port_kw`` to
        one side only."""
        fsm = lambda g: SnapFsm() if g in snap_groups else ListFsm()
        self.new_fsms = lambda: {g: fsm(g) for g in range(fsm_groups)}
        n = len(ids)
        self.jfsms = [self.new_fsms() for _ in range(n)]
        self.tfsms = [self.new_fsms() for _ in range(n)]
        self.jkvs = [JaxKV() for _ in range(n)]
        self.tkvs = [MemKV() for _ in range(n)]
        kw = dict(timeout_min=timeouts[0], timeout_max=timeouts[1], hb_ticks=hb_ticks)
        self._jax_args = dict(groups=groups, params=jax_step_params(**kw), backend="jax",
                              sparse_io=sparse_io, **engine_kw, **(jax_kw or {}))
        self._port_args = dict(groups=groups, params=step_params(**kw, device="cpu"),
                               backend=port_backend, sparse_io=sparse_io, device="cpu",
                               **engine_kw, **(port_kw or {}))
        self._tune = dict(k_out=k_out, fallback_frac=fallback_frac)
        self.jx: list = [None] * n
        self.pt: list = [None] * n
        for i in range(n if started is None else started):
            self.start(i, ids)
        self.cut: set[int] = set()   # engines partitioned away
        self.tick_no = 0

    def start(self, i, node_ids):
        """(Re)build slot i on both sides from its KV with ``node_ids`` as
        the configured members (a restart keeps what the KV holds)."""
        ej = JaxEngine(self.jkvs[i], node_ids, node_ids[i], fsms=self.jfsms[i],
                       base_seed=i, **self._jax_args)
        et = RaftEngine(self.tkvs[i], node_ids, node_ids[i], fsms=self.tfsms[i],
                        base_seed=i, **self._port_args)
        for e in (ej, et):
            if self._tune["k_out"] is not None:
                e._k_out = self._tune["k_out"]
            if self._tune["fallback_frac"] is not None:
                e.active_fallback_frac = self._tune["fallback_frac"]
        self.jx[i], self.pt[i] = ej, et

    def restart(self, i):
        """Slot i crashes and comes back from its KV with fresh FSMs."""
        self.jfsms[i], self.tfsms[i] = self.new_fsms(), self.new_fsms()
        self.start(i, self.jx[i].node_ids[:len(self.jx)])
        self.compare(f"tick {self.tick_no} after restarting engine {i}")

    def pairs(self):
        return [(i, ej, et) for i, (ej, et) in enumerate(zip(self.jx, self.pt))
                if ej is not None]

    def each(self, fn):
        """Call ``fn(engine)`` on every started engine of both sides."""
        for _, ej, et in self.pairs():
            fn(ej)
            fn(et)

    def _round(self, engines, window, mode):
        engines = [e for e in engines if e is not None]
        if mode == "split":
            hs = [e.tick_begin(e.suggest_window(window)) for e in engines]
            return [e.tick_finish(h) for e, h in zip(engines, hs)]
        if mode == "pipelined":
            return [e.tick_pipelined(e.suggest_window(window)) for e in engines]
        return [e.tick(e.suggest_window(window)) for e in engines]

    def step(self, window=1, mode="split"):
        jres = self._round(self.jx, window, mode)
        tres = self._round(self.pt, window, mode)
        what = f"tick {self.tick_no}"
        for i, (a, b) in enumerate(zip(jres, tres)):
            assert encode_all(b.outbound) == encode_all(a.outbound), f"{what} engine {i} outbound"
            assert (b.committed, b.became_leader, b.lost_leadership) == \
                   (a.committed, a.became_leader, a.lost_leadership), f"{what} engine {i}"
            assert [(c.op, c.node_id) for c in b.conf_changes] == \
                   [(c.op, c.node_id) for c in a.conf_changes], f"{what} engine {i}"
        for side, res in ((self.jx, jres), (self.pt, tres)):
            for r in res:
                for m in r.outbound:
                    if m.src not in self.cut and m.dst not in self.cut and \
                            m.dst < len(side) and side[m.dst] is not None:
                        side[m.dst].receive(m)
        self.barrier()
        self.compare(what)
        self.tick_no += 1

    def barrier(self):
        """The driver's delivery barrier after the host messages are handed
        over (a route fabric's flush in ``test_torch_route.py``)."""

    def leader(self, g):
        """The slot leading group ``g`` outside the cut, if any."""
        for i, ej, et in self.pairs():
            assert ej.is_leader(g) == et.is_leader(g)
            if ej.is_leader(g) and ej.me not in self.cut:
                return i
        return None

    def propose(self, g, payload):
        i = self.leader(g)
        if i is None:
            return False
        self.jx[i].propose(g, payload).add_done_callback(_retrieve)
        self.pt[i].propose(g, payload).add_done_callback(_retrieve)
        return True

    def compare(self, what):
        for i, ej, et in self.pairs():
            w = f"{what} engine {i}"
            tm, jm = h_mirrors(et), vars(ej)
            assert tm, w
            for k, a in tm.items():
                np.testing.assert_array_equal(a, jm[k], err_msg=f"{w} {k}")
            assert_leaves_equal(interop.state_to_numpy(et.state),
                                [np.asarray(x) for x in jax.tree.leaves(ej.state)],
                                STATE_NAMES, w)
            assert [(c.head, c.committed, c.floor) for c in et.chains] == \
                   [(c.head, c.committed, c.floor) for c in ej.chains], w
            assert [f.applied for f in self.tfsms[i].values()] == \
                   [f.applied for f in self.jfsms[i].values()], w
            assert et.flight.events() == ej.flight.events(), w
            assert et._nxt_fixups == ej._nxt_fixups, w
            assert sched(et) == sched(ej), w
            if et.lease_summary() is not None and ej.lease_summary() is not None:
                assert et.lease_summary() == ej.lease_summary(), w
            np.testing.assert_array_equal(np.asarray(et.member), np.asarray(ej.member),
                                          err_msg=w)
            assert et.node_ids == ej.node_ids, w

    def compare_queries(self):
        """The status queries, including the ISR view's device fetch."""
        for _, ej, et in self.pairs():
            groups = range(et.P)
            assert et.in_sync_map(groups) == ej.in_sync_map(groups)
            assert et.in_sync_ids_map(groups) == ej.in_sync_ids_map(groups)
            assert et.debug_state() == ej.debug_state()
            assert [et.leader_id(g) for g in groups] == [ej.leader_id(g) for g in groups]
            for k, a in et.health_sample().items():
                np.testing.assert_array_equal(a, ej.health_sample()[k])


def sched(engine):
    """The sparse capacity and the active-set scheduler's state and counts."""
    return (engine._sparse, engine._k_out, engine._k_out_quiet, engine._active_set,
            engine.active_sched_ticks, engine.active_sched_rows,
            engine.active_fallback_ticks, engine._timers_stale,
            sorted(engine._force_active), [g.tolist() for g in engine._sched_pending])


def _retrieve(fut):
    fut.cancelled() or fut.exception()


def drizzle(twin, t):
    """Deterministic proposals: groups 0 and 1 every third tick."""
    if t % 3 == 0:
        for g in (0, 1):
            twin.propose(g, b"t%d-g%d" % (t, g))


async def _run_plain(window, mode, port_backend="torch", ticks=60, **engine_kw):
    twin = Twin(port_backend=port_backend, **engine_kw)
    for t in range(ticks):
        if t >= 20:
            drizzle(twin, t)
        twin.step(window, mode)
    for e in twin.jx + twin.pt:
        if e.pipeline_window:
            e.tick_drain()
    twin.compare("drained")
    applied = [f.applied for f in twin.tfsms[0].values()]
    assert any(applied), "nothing committed"
    for e in twin.pt:
        assert e.active_sched_ticks > 0 or not e._active_set, "nothing ran compacted"
    twin.compare_queries()
    return twin


async def _run_sparse_overflow():
    """32 groups against a compaction capacity of 8: the cold-start
    election burst overflows it, and it grows x8, clamped to P."""
    twin = await _run_plain(1, "split", groups=32, sparse_io=True, k_out=8)
    assert all(e._k_out == 32 for e in twin.pt), [e._k_out for e in twin.pt]


async def _run_partition_snapshot_cap():
    """Engine 2 is cut off for 15 ticks while groups 0 (snapshot FSM,
    threshold 4) and 1 (plain FSM, AE frames capped at 2 blocks) keep
    committing. On heal, engine 2 catches group 0 up by snapshot install
    and group 1 by capped AppendEntries with send-pointer fixups."""
    twin = Twin(snap_groups=(0,), snapshot_threshold=4, max_append_entries=2)
    fixup_ticks = 0
    for t in range(110):
        if t == 30:
            twin.cut = {2}
        if t == 45:
            twin.cut = set()
        if t >= 20:
            for g in (0, 1):
                twin.propose(g, b"t%d-g%d" % (t, g))
        twin.step(4)
        fixup_ticks += any(e._nxt_fixups for e in twin.pt)
    twin.compare_queries()
    kinds = [ev["kind"] for ev in twin.pt[2].flight.events()]
    assert "snapshot_install" in kinds, "engine 2 installed no snapshot"
    assert fixup_ticks > 0, "no capped catch-up frame re-rooted a send pointer"
    for g in (0, 1):
        lead, lagged = twin.tfsms[0][g].applied, twin.tfsms[2][g].applied
        assert lagged == lead[:len(lagged)] and len(lagged) > 60, (g, len(lagged))


async def _run_recycle():
    twin = Twin()
    for t in range(70):
        if t >= 20:
            drizzle(twin, t)
            twin.propose(3, b"row3-t%d" % t)
        if t == 40:
            for ej, et in zip(twin.jx, twin.pt):
                for e in (ej, et):
                    e.recycle_group(3)
                    e.set_group_incarnation(3, 1)
            twin.compare("after recycle")
        twin.step(1)
    assert all(e.chains[3].head != 0 for e in twin.pt), "row 3 did not restart"


async def _run_active_partition_recycle():
    """Active set, window 1: engine 2 cut off for 15 ticks while groups 0
    (snapshot FSM, threshold 4) and 1 (AE frames capped at 2 blocks) keep
    committing. The heal is a mass wake-up (queued elections, catch-up);
    the snapshot install and the capped catch-up's send-pointer fixups are
    out-of-tick writes that force their rows awake. Then ``recycle_group``
    of row 3 mid-run."""
    twin = Twin(active_set=True, snap_groups=(0,), snapshot_threshold=4,
                max_append_entries=2)
    fixup_ticks = 0
    for t in range(100):
        twin.cut = {2} if 30 <= t < 45 else set()
        if t >= 20:
            for g in (0, 1):
                twin.propose(g, b"t%d-g%d" % (t, g))
        if t == 70:
            for ej, et in zip(twin.jx, twin.pt):
                for e in (ej, et):
                    e.recycle_group(3)
                    e.set_group_incarnation(3, 1)
            twin.compare("after recycle")
        twin.step(1)
        fixup_ticks += any(e._nxt_fixups for e in twin.pt)
    e = twin.pt[0]
    assert e.active_sched_ticks > 0 and e.active_fallback_ticks > 0, sched(e)
    assert "snapshot_install" in [ev["kind"] for ev in twin.pt[2].flight.events()]
    assert fixup_ticks > 0, "no capped catch-up re-rooted a send pointer"
    assert all(e.chains[3].head != 0 for e in twin.pt), "row 3 did not restart"
    twin.compare_queries()


async def _run_fallback_reentry(**kw):
    """A fallback threshold of a third: the election storms run as dense
    (or sparse) fallback ticks, the quiet stretches compacted, so the timer
    mirrors are refetched on every re-entry."""
    twin = await _run_plain(1, "split", active_set=True, fallback_frac=0.34, **kw)
    for e in twin.pt:
        assert e.active_refetches > 0 and e.active_sched_ticks > 0, sched(e)


IDS5 = [1, 2, 3, 4, 5]


async def _run_five_leader_cut():
    """5 engines: group 0's leader cut off for 20 ticks from tick 40, the
    other four re-elect and commit, then the old leader rejoins."""
    twin = Twin(ids=IDS5)
    cut_slot = None
    for t in range(90):
        if t == 40:
            cut_slot = twin.leader(0)
            assert cut_slot is not None, "no leader of group 0 by tick 40"
        twin.cut = {cut_slot} if cut_slot is not None and t < 60 else set()
        if t >= 20:
            drizzle(twin, t)
        twin.step(1)
    assert twin.leader(0) is not None
    lead = twin.tfsms[twin.leader(0)][0].applied
    assert lead and twin.tfsms[cut_slot][0].applied == lead[:len(twin.tfsms[cut_slot][0].applied)]
    twin.compare_queries()


async def _run_restart_from_kv():
    """Engine 2 crashes at tick 50 and comes back from its KV (fresh FSMs,
    replay from the chain)."""
    twin = Twin()
    for t in range(90):
        if t == 50:
            twin.restart(2)
        if t >= 20:
            drizzle(twin, t)
        twin.step(1)
    # The restarted engine resumes applying after its last applied block (a
    # follower learns the newest commit a heartbeat later than the leader).
    back, lead = twin.tfsms[2][0].applied, twin.tfsms[twin.leader(0)][0].applied
    assert back and back[0] in lead, (back, lead)
    i = lead.index(back[0])
    assert lead[i:i + len(back)] == back, (back, lead)
    twin.compare_queries()


async def _run_restart_after_compaction():
    """Snapshot FSMs on group 0 (threshold 4) and AppendEntries capped at 2
    blocks: engine 2 cut off for ticks 40-59 and rebuilt from its KV at 60
    (its own chain compacted: restore from its snapshot), engine 0 rebuilt
    at 80."""
    twin = Twin(snap_groups=(0,), snapshot_threshold=4, max_append_entries=2)
    for t in range(110):
        twin.cut = {2} if 40 <= t < 60 else set()
        if t == 60:
            twin.restart(2)
        if t == 80:
            twin.restart(0)
        if t >= 20:
            for g in (0, 1):
                twin.propose(g, b"t%d-g%d" % (t, g))
        twin.step(1)
    assert any(e.chains[0].floor > 0 for e in twin.pt), "no chain was compacted"
    twin.compare_queries()


async def _run_conf_add_remove():
    """``max_nodes=4``: ``propose_conf`` ADD of node 4 on group 0's leader;
    once committed node 4 starts with the full member list and catches up;
    then REMOVE of a follower."""
    from josefine_tpu.raft.membership import ADD as JADD, REMOVE as JREMOVE
    from josefine_tpu.raft.membership import ConfChange as JaxConfChange
    from josefine_tpu_torch.raft.membership import ADD, REMOVE, ConfChange

    twin = Twin(ids=IDS + [4], started=3, max_nodes=4)
    futs = []

    def conf(jchange, tchange):
        lead = twin.leader(0)
        assert lead is not None
        futs.append((twin.jx[lead].propose_conf(jchange), twin.pt[lead].propose_conf(tchange)))

    for t in range(130):
        if t == 25:
            conf(JaxConfChange(op=JADD, node_id=4, ip="x", port=1),
                 ConfChange(op=ADD, node_id=4, ip="x", port=1))
        if t == 40:
            assert all(f.done() for pair in futs for f in pair), "the ADD did not commit"
            twin.start(3, IDS + [4])
        if t == 80:
            lead = twin.leader(0)
            victim = next(i for i in range(4) if i != lead)
            conf(JaxConfChange(op=JREMOVE, node_id=victim + 1),
                 ConfChange(op=REMOVE, node_id=victim + 1))
        if t >= 15:
            drizzle(twin, t)
        twin.step(1)
    for fj, ft in futs:
        assert fj.done() and ft.done() and fj.exception() is None and ft.exception() is None
    assert twin.pt[0].members.active_slots() == twin.jx[0].members.active_slots()
    assert len(twin.pt[0].members.active_slots()) == 3 and 3 in twin.pt[0].members.active_slots()
    assert twin.tfsms[3][0].applied, "node 4 applied nothing"
    twin.compare_queries()


async def _run_set_group_members():
    """5 engines; groups 1 and 2 claimed by slots {0, 1, 2} and {1, 3, 4}
    before the first tick: each elects and commits among its own members."""
    twin = Twin(ids=IDS5, fsm_groups=3)
    twin.each(lambda e: e.set_group_members(1, {0, 1, 2}))
    twin.each(lambda e: e.set_group_members(2, {1, 3, 4}))
    for t in range(80):
        if t >= 20 and t % 3 == 0:
            for g in (0, 1, 2):
                twin.propose(g, b"t%d-g%d" % (t, g))
        twin.step(1)
    assert twin.leader(1) in (0, 1, 2) and twin.leader(2) in (1, 3, 4)
    for g, members in ((1, (0, 1, 2)), (2, (1, 3, 4))):
        assert all(twin.tfsms[i][g].applied for i in members), g
        assert not any(twin.tfsms[i][g].applied for i in range(5) if i not in members), g
    twin.compare_queries()


async def _run_active_migration():
    """Active set: row 1 frozen, its fence committed, its applied prefix
    adopted into row 5 on every engine and row 1 purged; then proposals on
    row 5."""
    from josefine_tpu.raft.migration import migration_fence as jax_fence
    from josefine_tpu_torch.raft.migration import migration_fence

    twin = Twin(active_set=True, snap_groups=(1,), fsm_groups=2)
    fence = []
    for t in range(110):
        if t >= 20 and t < 40 and t % 2 == 0:
            twin.propose(1, b"w%d" % t)
        if t == 40:
            twin.each(lambda e: e.freeze_group(1))
            lead = twin.leader(1)
            fence = [twin.jx[lead].propose(1, jax_fence(1, 5)),
                     twin.pt[lead].propose(1, migration_fence(1, 5))]
        if t == 55:
            assert all(f.done() and f.exception() is None for f in fence)
            lead = twin.leader(1)
            for side, fsms in ((twin.jx, twin.jfsms), (twin.pt, twin.tfsms)):
                snap_id = side[lead].chains[1].committed
                snap = side[lead].drivers[1].fsm.snapshot()
                for e, f in zip(side, fsms):
                    f[5] = SnapFsm()
                    e.register_fsm(5, f[5])
                    e.migrate_adopt_row(5, snap_id, snap, inc=1)
                    e.migrate_purge_source(1, inc=1)
            twin.compare("after the migration")
        if t >= 70 and t % 3 == 0:
            twin.propose(5, b"row5-t%d" % t)
        twin.step(1)
    lead = twin.leader(5)
    assert lead is not None and twin.leader(1) is None
    applied = twin.tfsms[lead][5].applied
    assert b"w20" in applied and applied[-1].startswith(b"row5-"), applied
    e = twin.pt[0]
    assert e.active_sched_ticks > 0, sched(e)
    twin.compare_queries()


async def _run_five_sparse_active_leases(window):
    """5 engines, 40 groups: sparse IO with a compaction capacity of 8, the
    active set and leases (``hb_ticks=1``, timeouts 4-8), group 0's leader
    cut off for ticks 40-59, at ``window``."""
    twin = Twin(ids=IDS5, groups=40, hb_ticks=1, timeouts=(4, 8), sparse_io=True,
                k_out=8, active_set=True, leases=True)
    cut_slot = None
    for t in range(100):
        if t == 40:
            cut_slot = twin.leader(0)
        twin.cut = {cut_slot} if cut_slot is not None and 40 <= t < 60 else set()
        if t >= 20:
            drizzle(twin, t)
        twin.step(window)
    summaries = [e.lease_summary() for e in twin.pt]
    assert all(s["credits"] for s in summaries), summaries
    assert any(e.active_sched_ticks for e in twin.pt)
    twin.compare_queries()


SCENARIOS = {
    "split-window1": lambda: _run_plain(1, "split"),
    "adaptive-window4": lambda: _run_plain(4, "split"),
    "tick-window4": lambda: _run_plain(4, "tick"),
    # With the host-only planes on: wire events journaled, request spans
    # and the health monitor running.
    "pipelined-window1": lambda: _run_plain(1, "pipelined", flight_wire=True,
                                            request_spans=True, health=True),
    "pipelined-window4": lambda: _run_plain(4, "pipelined"),
    "python-backend-window4": lambda: _run_plain(4, "split", port_backend="python", ticks=50),
    "partition-snapshot-cap": _run_partition_snapshot_cap,
    "recycle": _run_recycle,
    # The scale path.
    "sparse-overflow-window1": _run_sparse_overflow,
    "active-partition-recycle": _run_active_partition_recycle,
    "active-pipelined-window4": lambda: _run_plain(4, "pipelined", active_set=True),
    "active-fallback-reentry": _run_fallback_reentry,
    "sparse-active-fallback-reentry": lambda: _run_fallback_reentry(
        groups=32, sparse_io=True, k_out=8),
    "python-backend-active-window4": lambda: _run_plain(
        4, "split", port_backend="python", ticks=50, active_set=True),
    # Membership, restarts and migration, with more engines.
    "five-engines-leader-cut": _run_five_leader_cut,
    "restart-from-kv": _run_restart_from_kv,
    "restart-after-compaction": _run_restart_after_compaction,
    "conf-add-remove": _run_conf_add_remove,
    "set-group-members": _run_set_group_members,
    "active-freeze-adopt-purge": _run_active_migration,
    "five-sparse-active-leases-kout8-window1": lambda: _run_five_sparse_active_leases(1),
    "five-sparse-active-leases-kout8-window4": lambda: _run_five_sparse_active_leases(4),
}
TIER1 = {"adaptive-window4", "pipelined-window1", "python-backend-window4",
         "partition-snapshot-cap", "sparse-overflow-window1", "active-partition-recycle",
         "active-pipelined-window4", "sparse-active-fallback-reentry",
         "python-backend-active-window4", "five-engines-leader-cut"}


@pytest.mark.parametrize("name", [
    n if n in TIER1 else pytest.param(n, marks=pytest.mark.slow) for n in SCENARIOS])
async def test_twin_cluster_matches_jax_every_tick(name):
    await SCENARIOS[name]()


def test_unported_options_raise():
    """Every option is ported; what raises is what the JAX engine refuses.
    A mesh needs the torch backend and must divide the groups (an active
    set needs its 'p' axis). The route fabric, the payload ring and leases
    are accepted (with the JAX engine's own lease-parameter check), as are
    sparse IO and the active set."""
    kw = dict(kv=MemKV(), node_ids=IDS, self_id=1, device="cpu")
    mesh = make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="torch backend"):
        RaftEngine(**kw, groups=8, mesh=mesh, backend="python")
    with pytest.raises(ValueError, match="not divisible by mesh devices 2"):
        RaftEngine(**kw, groups=7, mesh=mesh)
    with pytest.raises(ValueError, match="'p' mesh axis"):
        RaftEngine(**kw, groups=8, mesh=Mesh(["cpu"] * 2, ("x",)), active_set=True)
    meshed = RaftEngine(**kw, groups=8, mesh=mesh, active_set=True)
    assert (meshed._shards, meshed._shard_rows) == (2, 4)
    lease_params = step_params(timeout_min=4, timeout_max=8, hb_ticks=1, device="cpu")
    leased = RaftEngine(**kw, groups=8, leases=True, params=lease_params)
    assert leased.lease_summary() == {"held": 0, "credits": 0, "refused_pushes": 0,
                                      "armed": 0}
    with pytest.raises(ValueError, match="timeout_min"):
        RaftEngine(**kw, groups=8, leases=True,
                   params=step_params(timeout_min=3, timeout_max=8, hb_ticks=1,
                                      device="cpu"))
    e = RaftEngine(**kw, groups=8)
    assert e._fabric is None and e.lease_summary() is None
    fab = RouteFabric(payload_ring=True)
    fab.register(e)
    assert e._fabric is fab and set(fab.rings) == {e.me}
    with pytest.raises(ValueError, match="backend"):
        RaftEngine(**kw, groups=8, backend="jax")
    # Sparse IO and the active set are ported: sparse is the default above
    # 4096 groups, as in the JAX engine.
    assert not e._sparse and not e._active_set
    assert RaftEngine(**kw, groups=4097)._sparse
    assert RaftEngine(**kw, groups=8, sparse_io=True, active_set=True)._active_set


def test_bench_engine_runs_on_the_host():
    row = bench_engine.run(16, ticks=6, warmup=30, window=4, device="cpu")
    assert row["leaders_per_group"] == {"min": 1, "max": 1}
    assert row["committed_blocks"] > 0
    assert set(row["profile_phases"]) >= {"inbox", "dispatch", "fetch", "decode", "apply"}
    assert row["device"] == "cpu" and row["card"] is None


@pytest.mark.parametrize("mode", [dict(sparse_io=True), dict(active_set=True, active_frac=0.25)])
def test_bench_engine_scale_path_runs_on_the_host(mode):
    """The bench's sparse and active-set arguments at a toy size."""
    row = bench_engine.run(64, ticks=6, warmup=30, device="cpu", **mode)
    assert row["leaders_per_group"] == {"min": 1, "max": 1}
    assert row["committed_blocks"] > 0
    assert row["sparse_io"] == mode.get("sparse_io", False)
    if mode.get("active_set"):
        stats = row["active_set_stats"]
        assert row["proposals_per_tick"] == 16
        assert stats["sched_ticks"] + stats["fallback_ticks"] == 3 * 6
        assert stats["sched_ticks"] > 0 and stats["buckets"]
        assert set(row["profile_phases"]) >= {"compact", "scatter", "decay"}
    else:
        assert row["k_out_history"] == [[[0, 64]]] * 3


def test_bench_engine_device_route_runs_on_the_host():
    """The bench's route fabric and payload ring at a toy size: every
    payload AE rides the ring, so no wire entry is decoded on the host in
    the timed rounds, and the row carries the route phase."""
    row = bench_engine.run(64, ticks=6, warmup=30, device="cpu", active_frac=0.25,
                           device_route=True, payload_ring=True)
    assert row["leaders_per_group"] == {"min": 1, "max": 1}
    assert row["committed_blocks"] > 0 and row["device_route"] and row["payload_ring"]
    stats = row["device_route_stats"]
    assert stats["routed_msgs"] > 0 and stats["routed_frac"] == 1.0, stats
    assert stats["ring"]["payload_aes_routed"] > 0 and stats["ring"]["spills"] == 0
    assert "route" in row["profile_phases"]


@pytest.mark.parametrize("active", [False, True])
def test_nxt_fixups_force_wake_their_rows(active):
    """Draining the AE-cap send-pointer re-roots writes the same nxt leaves
    as the JAX engine (a repeated (group, dst) keeps its last top) and, with
    the active set on, forces the re-rooted rows into the next schedule."""
    twin = Twin(active_set=active)
    fixups = [(3, 1, (2 << 32) | 7), (5, 2, (1 << 32) | 4), (3, 1, (2 << 32) | 9)]
    for e in twin.jx + twin.pt:
        e._nxt_fixups.extend(fixups)
        e._drain_nxt_fixups()
    twin.compare("after drain")
    assert twin.pt[0]._force_active == ({3, 5} if active else set())
    assert int(twin.pt[0].state.nxt.s[3, 1]) == 9
