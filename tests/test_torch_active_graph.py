"""PyTorch port, the active set's captured graphs (``raft/step_runner.py``
:class:`GraphCache`) on the host.

On a card an active-set engine replays its compacted tick (gather, compact
window step, decay-scatter) from one CUDA graph per ``(bucket, window)``.
Here the stand-in for the card's capture of ``test_torch_step_graph.py``
(:func:`host_capture`: a replay runs the captured function again over the
same input buffers into outputs first filled with junk) stands in for it. A
cluster of three active-set engines whose compacted dispatches go through it
must equal the same cluster run eager, byte for byte on every tick: the
encoded outbound messages, every host mirror, every state leaf, the chains,
the FSMs' applies and the scheduler's counts. The runs cross the bucket
rungs 64, 128 and 256, fall back at the cold election and when most groups
are idled or woken again (each fallback followed by its re-entry refetch),
change a group's members and reset a group between ticks, and run
split-phase ticks, pipelined ticks at window 4 and a route fabric's routed
planes (which run eager); the single-tick runs hold all-quiescent ticks
while most groups are idle. The counters follow the key rule: a key's first dispatch eager, its
second a capture, every later one a replay. Every captured graph of an
engine, of the sparse step (its fallback ticks) and of the compacted tick,
reads the one set of full-size input buffers.
"""

from __future__ import annotations

import asyncio

import pytest
from test_torch_step_graph import (
    IDS,
    P,
    _assert_equal,
    _Cluster,
    _counter,
    _expected_counts,
)

_NAMES = ("raft_active_graph_eager_total", "raft_active_graph_captures_total",
          "raft_active_graph_replays_total")
_SCHED = ("active_sched_ticks", "active_fallback_ticks", "active_sched_rows",
          "active_bucket_rows", "active_refetches")
# Groups 8 and above are idled (an empty claim) for the ticks [idle, wake),
# and nothing is proposed then.
_BUSY = 8


class _ActiveCluster(_Cluster):
    """:class:`_Cluster` with the active set on; with graphs, each engine's
    compacted dispatch keys are logged as ``(k, window, routed)``."""

    def __init__(self, graphs: bool, monkeypatch, fabric: bool):
        super().__init__(graphs, monkeypatch, fabric, active_set=True)
        self.active_keys = [runs.setdefault("compacted", []) for runs in self.runs]

    def claim_busy_only(self, idle: bool):
        for e in self.engines:
            for g in range(_BUSY, P):
                e.set_group_members(g, set() if idle else None)


# Pipelined, every group has a leader (so window 4 runs) only after some
# 60 ticks.
_RUNS = {
    "split": dict(window=1, pipelined=False, fabric=False, ticks=100, members=30, reset=40,
                  idle=60, wake=80),
    "pipelined-window4": dict(window=4, pipelined=True, fabric=False, ticks=140, members=70,
                              reset=80, idle=95, wake=115),
    "routed": dict(window=1, pipelined=False, fabric=True, ticks=100, members=30, reset=40,
                   idle=60, wake=80),
}


@pytest.mark.parametrize("run", list(_RUNS))
def test_active_graph_engines_equal_eager_engines_every_tick(run, monkeypatch):
    kw = _RUNS[run]
    before = {(n, i): _counter(n, i) for n in _NAMES for i in IDS}

    async def main():
        eager = _ActiveCluster(False, monkeypatch, kw["fabric"])
        graph = _ActiveCluster(True, monkeypatch, kw["fabric"])
        for t in range(kw["ticks"]):
            idle = kw["idle"] <= t < kw["wake"]
            if t >= 16 and t % 2 == 0 and not idle:
                for g in (0, 1, 2 + t % 40):
                    for c in (eager, graph):
                        c.propose(g, b"t%d-g%d" % (t, g))
            if t == kw["members"]:
                for c in (eager, graph):
                    for e in c.engines:
                        e.set_group_members(7, {0, 1})
            if t == kw["reset"]:
                for c in (eager, graph):
                    for e in c.engines:
                        e.recycle_group(3)
                        e.set_group_incarnation(3, 1)
            if t in (kw["idle"], kw["wake"]):
                for c in (eager, graph):
                    c.claim_busy_only(idle)
            res_e = eager.round(kw["window"], kw["pipelined"])
            res_g = graph.round(kw["window"], kw["pipelined"])
            _assert_equal(f"{run} tick {t}", eager, graph, res_e, res_g)
            for i, (ea, eg) in enumerate(zip(eager.engines, graph.engines)):
                assert [getattr(ea, a) for a in _SCHED] == [getattr(eg, a) for a in _SCHED], \
                    f"{run} tick {t} engine {i} scheduler counts"
            await asyncio.sleep(0)
        if kw["pipelined"]:
            for c in (eager, graph):
                for e in c.engines:
                    e.tick_drain()
        assert any(f.applied for fs in graph.fsms for f in fs.values()), "nothing committed"
        return graph

    graph = asyncio.run(main())
    for i, (e, keys) in enumerate(zip(graph.engines, graph.active_keys)):
        ag = e._runner.graphs.counts["compacted"]
        got = (ag.eager, ag.captures, ag.replays)
        assert got == _expected_counts(keys), (i, got)
        assert ag.captures and ag.replays, (i, got)
        assert tuple(_counter(n, e.self_id) - before[n, e.self_id] for n in _NAMES) == got
        assert {k[0] for k in keys} >= {64, 128, 256}, "fewer than three bucket rungs"
        assert e.active_fallback_ticks >= 3 and e.active_refetches >= 3, \
            (e.active_fallback_ticks, e.active_refetches)
        if not kw["pipelined"]:
            # A compacted tick that gathers no row runs the decay alone and
            # never reaches the graphs. (Pipelined, the rows of the tick in
            # flight wake for the next, so the set never empties.)
            assert e.active_sched_ticks > len(keys), "no all-quiescent tick"
        if kw["window"] > 1:
            assert {k[1] for k in keys} >= {1, kw["window"]}
        if kw["fabric"]:
            assert any(k[2] for k in keys), "no routed plane"
        # One set of full-size inputs (state leaves, member, peer_fresh)
        # for every captured key of both programs.
        captured = [(key[0], g) for key, g in e._runner.graphs._graphs.items() if g is not None]
        assert {p for p, _ in captured} == {"sparse", "compacted"}, (i, [p for p, _ in captured])
        assert len({tuple(t.data_ptr() for t in g.ins) for _, g in captured}) == 1, i
