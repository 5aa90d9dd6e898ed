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
from josefine_tpu_torch.raft.engine import RaftEngine
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
    """Three JAX engines and three port engines, stepped and fed alike."""

    def __init__(self, groups=8, hb_ticks=8, port_backend="torch", snap_groups=(),
                 sparse_io=False, k_out=None, fallback_frac=None, **engine_kw):
        fsm = lambda g: SnapFsm() if g in snap_groups else ListFsm()
        self.jfsms = [{g: fsm(g) for g in range(2)} for _ in IDS]
        self.tfsms = [{g: fsm(g) for g in range(2)} for _ in IDS]
        kw = dict(timeout_min=3, timeout_max=8, hb_ticks=hb_ticks)
        self.jx = [JaxEngine(JaxKV(), IDS, IDS[i], groups=groups, fsms=self.jfsms[i],
                             params=jax_step_params(**kw), base_seed=i, backend="jax",
                             sparse_io=sparse_io, **engine_kw) for i in range(3)]
        self.pt = [RaftEngine(MemKV(), IDS, IDS[i], groups=groups, fsms=self.tfsms[i],
                              params=step_params(**kw, device="cpu"), base_seed=i,
                              backend=port_backend, sparse_io=sparse_io, device="cpu",
                              **engine_kw)
                   for i in range(3)]
        for e in self.jx + self.pt:
            if k_out is not None:
                e._k_out = k_out
            if fallback_frac is not None:
                e.active_fallback_frac = fallback_frac
        self.cut: set[int] = set()   # engines partitioned away
        self.tick_no = 0

    def _round(self, engines, window, mode):
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
        for side, res in ((self.jx, jres), (self.pt, tres)):
            for r in res:
                for m in r.outbound:
                    if m.src not in self.cut and m.dst not in self.cut:
                        side[m.dst].receive(m)
        self.compare(what)
        self.tick_no += 1

    def propose(self, g, payload):
        for ej, et in zip(self.jx, self.pt):
            assert ej.is_leader(g) == et.is_leader(g)
            if ej.is_leader(g) and ej.me not in self.cut:
                ej.propose(g, payload).add_done_callback(_retrieve)
                et.propose(g, payload).add_done_callback(_retrieve)
                return True
        return False

    def compare(self, what):
        for i, (ej, et) in enumerate(zip(self.jx, self.pt)):
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

    def compare_queries(self):
        """The status queries, including the ISR view's device fetch."""
        for ej, et in zip(self.jx, self.pt):
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
}
TIER1 = {"adaptive-window4", "pipelined-window1", "python-backend-window4",
         "partition-snapshot-cap", "sparse-overflow-window1", "active-partition-recycle",
         "active-pipelined-window4", "sparse-active-fallback-reentry",
         "python-backend-active-window4"}


@pytest.mark.parametrize("name", [
    n if n in TIER1 else pytest.param(n, marks=pytest.mark.slow) for n in SCENARIOS])
async def test_twin_cluster_matches_jax_every_tick(name):
    await SCENARIOS[name]()


def test_unported_options_raise():
    kw = dict(kv=MemKV(), node_ids=IDS, self_id=1, device="cpu")
    for extra, item in ((dict(groups=8, mesh=object()), "item 10"),
                        (dict(groups=8, leases=True), "lease plane")):
        with pytest.raises(NotImplementedError, match=item):
            RaftEngine(**kw, **extra)
    e = RaftEngine(**kw, groups=8)
    with pytest.raises(NotImplementedError, match="item 7"):
        e._fabric = object()
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
