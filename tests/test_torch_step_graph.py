"""PyTorch port, the sparse step's captured graphs (``raft/step_runner.py``
:class:`GraphCache`) on the host.

An engine replays its single-card sparse step from CUDA graphs only on a
card. Here a stand-in for the card's capture (:func:`host_capture`) keeps
the captured function and, at each replay, runs it again over the same
input buffers and writes its results into the outputs the capture returned,
which it first overwrites with junk: a capture computes nothing. A cluster
of three sparse engines whose dispatches go through it must equal the same
cluster run eager, byte for byte on every tick: the encoded outbound
messages, every host mirror, every state leaf, the chains and the FSMs'
applies. The runs cross the upload bucket's rungs, overflow a compaction
capacity started at 4 (so it regrows x8), reset groups and change a
group's members between ticks, and run split-phase ticks, pipelined ticks
at window 4 and a route fabric's routed planes (which run eager). The
counters follow the key rule: a key's first dispatch eager, its second a
capture, every later one a replay.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

from josefine_tpu_torch import interop
from josefine_tpu_torch.models.types import NodeState, step_params
from josefine_tpu_torch.raft import step_runner
from josefine_tpu_torch.raft.engine import RaftEngine
from josefine_tpu_torch.raft.route import RouteFabric
from josefine_tpu_torch.utils.kv import MemKV
from josefine_tpu_torch.utils.metrics import REGISTRY

IDS = [1, 2, 3]
P = 512


def _tensors(out):
    """A captured function's outputs as tensors: a state's leaves in place
    of the state."""
    return [t for o in out for t in (o.leaves() if isinstance(o, NodeState) else (o,))]


class _HostGraph:
    """A captured graph's stand-in: a replay writes the captured function's
    results into the outputs of the capture."""

    def __init__(self, fn, outs):
        self.fn, self.outs = fn, outs

    def replay(self):
        for dst, src in zip(self.outs, _tensors(self.fn())):
            dst.copy_(src)


def host_capture(fn):
    out = fn()
    outs = _tensors(out)
    for t in outs:
        t.fill_(-7)
    return _HostGraph(fn, outs), out


class _ListFsm:
    def __init__(self):
        self.applied = []

    def transition(self, data):
        self.applied.append(bytes(data))
        return b"ok:" + data


def _retrieve(fut):
    fut.cancelled() or fut.exception()


class _Cluster:
    """Three sparse-IO engines on the CPU (``engine_kw`` to each), fed and
    delivered alike; with ``graphs`` their captures go through
    :func:`host_capture`, and each engine's runs of its graph cache are
    logged per program as ``(*shape key, routed)``: the sparse step's
    ``(K, k_out, window, routed)``."""

    def __init__(self, graphs: bool, monkeypatch, fabric: bool, **engine_kw):
        self.fsms = [{g: _ListFsm() for g in (0, 1)} for _ in IDS]
        with monkeypatch.context() as m:
            if graphs:
                m.setattr(step_runner, "capture_for", lambda device: host_capture)
            self.engines = [
                RaftEngine(MemKV(), IDS, IDS[i], groups=P, fsms=self.fsms[i], base_seed=i,
                           params=step_params(timeout_min=3, timeout_max=8, hb_ticks=8,
                                              device="cpu"),
                           sparse_io=True, device="cpu", **engine_kw)
                for i in range(len(IDS))]
        self.fabric = None
        if fabric:
            self.fabric = RouteFabric()
            for e in self.engines:
                self.fabric.register(e)
        for e in self.engines:
            e._k_out = 4
        self.runs = [{} for _ in IDS]
        for i, e in enumerate(self.engines):
            assert (e._runner.graphs is not None) == graphs
            if graphs:
                self._log(e._runner.graphs, self.runs[i])
        self.keys = [runs.setdefault("sparse", []) for runs in self.runs]

    @staticmethod
    def _log(graphs, runs):
        inner = graphs.run

        def run(key, body, inputs, plane, prof):
            runs.setdefault(key[0], []).append((*key[1:], plane is not None))
            return inner(key, body, inputs, plane, prof)

        graphs.run = run

    def round(self, window, pipelined):
        es = self.engines
        if pipelined:
            res = [e.tick_pipelined(e.suggest_window(window)) for e in es]
        else:
            hs = [e.tick_begin(e.suggest_window(window)) for e in es]
            res = [e.tick_finish(h) for e, h in zip(es, hs)]
        for r in res:
            for m in r.outbound:
                es[m.dst].receive(m)
        if self.fabric is not None:
            self.fabric.flush()
        return res

    def propose(self, g, payload):
        for e in self.engines:
            if e.is_leader(g):
                e.propose(g, payload).add_done_callback(_retrieve)
                return


def _assert_equal(what, a: _Cluster, b: _Cluster, res_a, res_b):
    for i, (ea, eb, ra, rb) in enumerate(zip(a.engines, b.engines, res_a, res_b)):
        w = f"{what} engine {i}"
        assert [m.encode() for m in ra.outbound] == [m.encode() for m in rb.outbound], w
        assert (ra.committed, ra.became_leader, ra.lost_leadership) == \
               (rb.committed, rb.became_leader, rb.lost_leadership), w
        for k, v in vars(ea).items():
            if k.startswith("_h_") and isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, vars(eb)[k], err_msg=f"{w} {k}")
        for j, (x, y) in enumerate(zip(interop.state_to_numpy(ea.state),
                                       interop.state_to_numpy(eb.state))):
            np.testing.assert_array_equal(x, y, err_msg=f"{w} state leaf {j}")
        assert [(c.head, c.committed) for c in ea.chains] == \
               [(c.head, c.committed) for c in eb.chains], w
        assert (ea._k_out, ea._routed_plane is None) == (eb._k_out, eb._routed_plane is None), w
    assert [[f.applied for f in fs.values()] for fs in a.fsms] == \
           [[f.applied for f in fs.values()] for fs in b.fsms], what


def _expected_counts(keys):
    """(eager, captures, replays) by the key rule."""
    seen: dict[tuple, int] = {}
    eager = captures = replays = 0
    for *key, routed in keys:
        key = tuple(key)
        if routed or key not in seen:
            eager += 1
            if not routed:
                seen[key] = 1
        elif seen[key] == 1:
            captures += 1
            seen[key] = 2
        else:
            replays += 1
    return eager, captures, replays


def _counter(name, node):
    return REGISTRY._metrics[name].get(node=node)


# Pipelined, a message lands a tick later, and every group has a leader
# (so window 4 runs) only after some 60 ticks.
_RUNS = {
    "split": dict(window=1, pipelined=False, fabric=False, ticks=64, members=30, reset=40),
    "pipelined-window4": dict(window=4, pipelined=True, fabric=False, ticks=100, members=70,
                              reset=80),
    "routed": dict(window=1, pipelined=False, fabric=True, ticks=64, members=30, reset=40),
}


@pytest.mark.parametrize("run", list(_RUNS))
def test_graph_engines_equal_eager_engines_every_tick(run, monkeypatch):
    kw = _RUNS[run]
    names = ("raft_step_graph_eager_total", "raft_step_graph_captures_total",
             "raft_step_graph_replays_total")
    before = {(n, i): _counter(n, i) for n in names for i in IDS}

    async def main():
        eager = _Cluster(False, monkeypatch, kw["fabric"])
        graph = _Cluster(True, monkeypatch, kw["fabric"])
        for t in range(kw["ticks"]):
            if t >= 16 and t % 2 == 0:
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
            res_e = eager.round(kw["window"], kw["pipelined"])
            res_g = graph.round(kw["window"], kw["pipelined"])
            _assert_equal(f"{run} tick {t}", eager, graph, res_e, res_g)
            await asyncio.sleep(0)
        if kw["pipelined"]:
            for c in (eager, graph):
                for e in c.engines:
                    e.tick_drain()
        assert any(f.applied for fs in graph.fsms for f in fs.values()), "nothing committed"
        return graph

    graph = asyncio.run(main())
    for i, (e, keys) in enumerate(zip(graph.engines, graph.keys)):
        sg = e._runner.graphs.counts["sparse"]
        got = (sg.eager, sg.captures, sg.replays)
        assert got == _expected_counts(keys), (i, got)
        assert sg.captures and sg.replays, (i, got)
        assert tuple(_counter(n, e.self_id) - before[n, e.self_id] for n in names) == got
        assert len({k[1] for k in keys}) >= 3, "the capacity did not regrow"
        if kw["window"] > 1:
            assert {k[2] for k in keys} >= {1, kw["window"]}
        if kw["fabric"]:
            assert any(k[3] for k in keys), "no routed plane"
        else:  # routed rows never join the upload: there K stays 256
            assert sg.replays > sg.eager, (i, got)
            assert len({k[0] for k in keys}) >= 2, "one upload rung only"
