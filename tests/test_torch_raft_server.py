"""PyTorch port, the raft runtime (``raft/server.py``, ``JosefineRaft``).

First the cases of ``tests/test_raft_server.py``, run against the port's
server on the host (``device="cpu"``): clusters over real localhost sockets
on the lockstep clock, forwarding through a follower, a leader crash, the
wall-clock pacer, the dedup cache's bounds, windowed tick loops and the
window hint read after the pacer's grant.

Then the twin: three JAX servers (``backend="jax"``) and three port servers
(``backend="torch"``, ``device="cpu"``) with the same configuration, driven
by one script (``josefine_tpu_torch.raft.lockstep.run_script``) on a
virtual clock, their sockets replaced by the fixed-order hop: proposals to
random groups through random nodes (most forwarded to another node's
leader), the leader of group 0 stopped from tick 30 and the other two
re-electing. On every tick the two clusters must be equal in every engine
state leaf, every ``_h_*`` mirror, every chain, every FSM's applies and
every frame on the wire, the client request ids aside.

Last, the port's two differences from the JAX server: its dedup eviction
(which visits only what it evicts, and drops finished entries before live
ones) against the JAX server's on random maps, and the forward and serve
waits, which stretch by the tick loop's measured slowdown.
"""

from __future__ import annotations

import asyncio
import functools
import types

import jax
import numpy as np
import pytest

from josefine_tpu.config import NodeAddr as JaxNodeAddr, RaftConfig as JaxRaftConfig
from josefine_tpu.raft import rpc as jax_rpc
from josefine_tpu.raft import server as jax_server
from josefine_tpu.raft.server import JosefineRaft as JaxRaft
from josefine_tpu.utils.kv import MemKV as JaxKV
from josefine_tpu_torch import interop
from josefine_tpu_torch.config import NodeAddr, RaftConfig
from josefine_tpu_torch.raft import lockstep, rpc, server
from josefine_tpu_torch.raft.pacer import LockstepPacer
from josefine_tpu_torch.raft.server import JosefineRaft
from josefine_tpu_torch.utils.kv import MemKV
from josefine_tpu_torch.utils.net import bound_sockets

from torch_parity import STATE_NAMES, assert_leaves_equal, repointed

# The dedup-cache case builds a server's map by hand: the port's server also
# keeps the set of failed entries, which its done-callbacks fill as they fail.
globals().update(repointed("test_raft_server", edits=[
    ("sock=socks[i],", 'sock=socks[i], device="cpu",'),
    ("ns = types.SimpleNamespace(_served={})",
     "ns = types.SimpleNamespace(_served={}, _served_dead=set())"),
    ('ns._served["failed"] = (bad, now)',
     'ns._served["failed"] = (bad, now)\n        ns._served_dead.add("failed")'),
]))


class ListFsm:
    def __init__(self):
        self.applied = []

    def transition(self, data: bytes) -> bytes:
        self.applied.append(bytes(data))
        return b"ok:" + data


def build_side(pacer, hop, groups, port_side: bool, **cfg_extra) -> lockstep.Side:
    socks, ports = bound_sockets(3)
    if port_side:
        cfgs = lockstep.mesh_configs(ports, RaftConfig, NodeAddr, **cfg_extra)
    else:
        cfgs = lockstep.mesh_configs(ports, JaxRaftConfig, JaxNodeAddr, **cfg_extra)
    fsms = [{g: ListFsm() for g in range(groups)} for _ in cfgs]
    servers = []
    for cfg, sock, f in zip(cfgs, socks, fsms):
        if port_side:
            servers.append(JosefineRaft(cfg, MemKV(), f, groups=groups, pacer=pacer,
                                        intercept_send=hop.intercept(cfg.id), sock=sock,
                                        backend="torch", device="cpu"))
        else:
            servers.append(JaxRaft(cfg, JaxKV(), f, groups=groups, pacer=pacer,
                                   intercept_send=hop.intercept(cfg.id), sock=sock,
                                   backend="jax"))
    return lockstep.Side(servers, hop, fsms)


def mirrors(engine) -> dict[str, np.ndarray]:
    return {k: v for k, v in vars(engine).items()
            if k.startswith("_h_") and isinstance(v, np.ndarray)}


def compare(t, jside, tside, wires):
    jwire, twire = wires
    assert twire == jwire, f"tick {t}: the wire differs"
    for j, p in zip(jside.servers, tside.servers):
        w = f"tick {t} node {p.config.id}"
        je, te = j.engine, p.engine
        tm = mirrors(te)
        assert tm, w
        for k, a in tm.items():
            np.testing.assert_array_equal(a, vars(je)[k], err_msg=f"{w} {k}")
        assert_leaves_equal(interop.state_to_numpy(te.state),
                            [np.asarray(x) for x in jax.tree.leaves(je.state)],
                            STATE_NAMES, w)
        assert [(c.head, c.committed, c.floor) for c in te.chains] == \
               [(c.head, c.committed, c.floor) for c in je.chains], w
    assert [[f.applied for f in node.values()] for node in tside.fsms] == \
           [[f.applied for f in node.values()] for node in jside.fsms], f"tick {t} applies"


def run_twin(groups=8, ticks=60, step=1, **cfg_extra):
    """The twin clusters through ``lockstep.run_script``; returns its
    counts."""
    async def main():
        pacer = LockstepPacer(settle_s=0)
        jside = build_side(pacer, lockstep.Hop(jax_rpc.decode_frame), groups, False,
                           **cfg_extra)
        tside = build_side(pacer, lockstep.Hop(rpc.decode_frame), groups, True, **cfg_extra)
        frames = [0]

        def on_tick(t, wires):
            frames[0] += len(wires[0])
            compare(t, jside, tside, wires)

        stats = await lockstep.run_script([jside, tside], pacer, ticks=ticks, seed=5,
                                          per_tick=2, step=step, on_tick=on_tick)
        return stats, frames[0], jside, tside

    stats, frames, jside, tside = lockstep.run(main())
    assert stats["stopped"] is not None and stats["forwarded"] >= 10, stats
    assert frames > 0
    live = [i for i in range(3) if i + 1 != stats["stopped"]]
    # The survivors re-elected group 0.
    assert sum(tside.servers[i].engine.is_leader(0) for i in live) == 1
    # No proposal was in flight at the stop: each answered one was applied
    # exactly once on each survivor.
    for i in live:
        applied = [p for f in tside.fsms[i].values() for p in f.applied]
        assert len(applied) == len(set(applied)) == stats["proposed"], (i, stats)
    return stats


def test_twin_servers_match_jax_every_tick():
    run_twin()


@pytest.mark.slow
def test_twin_servers_windowed_pipelined_match_jax_every_tick():
    stats = run_twin(ticks=120, step=4, window_ticks=4, pipeline_ticks=True)
    assert stats["strided"] > 0, stats


@pytest.mark.parametrize("seed", range(3))
def test_dedup_eviction_leaves_what_the_jax_server_leaves(seed):
    """Dedup maps as a leader builds them (in age order; futures pending,
    answered, failed or cancelled, some failures not yet seen by their
    done-callback; some past the TTL; up to 1,500 over the cap): the port
    keeps every live entry the JAX server keeps, drops a live entry only
    when it keeps no finished one, and otherwise leaves what the JAX server
    leaves; with every failure recorded, as many entries as it."""
    assert (server.SERVED_SOFT_CAP, server.SERVED_TTL_S) == \
        (jax_server.SERVED_SOFT_CAP, jax_server.SERVED_TTL_S)

    async def main():
        loop = asyncio.get_running_loop()
        rng = np.random.default_rng(seed)
        now = 1000.0
        spared = 0  # live entries the JAX server dropped and the port kept
        for rep in range(6):
            n = server.SERVED_SOFT_CAP + int(rng.integers(1, 1500))
            span = (2.0, 1.05)[rep % 2 if rep < 4 else 1] * server.SERVED_TTL_S
            borns = np.sort(rng.uniform(now - span, now, n))
            port = types.SimpleNamespace(_served={}, _served_dead=set())
            ref = types.SimpleNamespace(_served={})
            p_live = (0.8, 0.97)[rep // 2 % 2]  # most live, or nearly all
            kinds = rng.choice(4, n, p=[p_live, (1 - p_live) / 2, (1 - p_live) / 3,
                                        (1 - p_live) / 6])
            unseen = rep >= 4 and rng.random(n) < 0.5
            for i, (born, kind) in enumerate(zip(borns.tolist(), kinds.tolist())):
                f = loop.create_future()
                key = f"r{i}"
                port._served[key] = ref._served[key] = (f, born)
                if kind == 1:
                    f.set_result(b"ok")
                elif kind == 2:
                    f.set_exception(RuntimeError("lost leadership"))
                elif kind == 3:
                    f.cancel()
                if kind >= 2 and not (rep >= 4 and unseen[i]):
                    JosefineRaft._served_done(port, key, f)
            order = list(port._served)
            live_before = {k for k, (f, b) in port._served.items()
                           if not f.done() and now - b <= server.SERVED_TTL_S}
            JaxRaft._evict_served(ref, now)
            JosefineRaft._evict_served(port, now)
            kept = list(port._served)
            assert kept == [k for k in order if k in port._served]  # age order
            assert len(kept) <= server.SERVED_SOFT_CAP and not port._served_dead
            assert all(now - b <= server.SERVED_TTL_S for _, b in port._served.values())
            live = {k for k, (f, _) in port._served.items() if not f.done()}
            ref_live = {k for k, (f, _) in ref._served.items() if not f.done()}
            assert ref_live <= live
            spared += len(live - ref_live)
            if live != live_before:  # a live entry went: no finished one stayed
                assert len(live) == len(kept) == server.SERVED_SOFT_CAP
            if rep < 4:
                assert len(kept) == len(ref._served)
                # Where the JAX server dropped no live entry, the same map.
                if live == ref_live:
                    assert kept == list(ref._served)
        assert spared > 0

    asyncio.run(main())


def test_dedup_eviction_keeps_live_entries_past_a_failure_not_yet_seen():
    """A future that fails in the same loop turn as an eviction, before its
    done-callback runs: the port drops it (as the JAX server's scan does)
    and keeps every live entry."""
    async def main():
        loop = asyncio.get_running_loop()
        now = 1000.0
        port = types.SimpleNamespace(_served={}, _served_dead=set())
        ref = types.SimpleNamespace(_served={})
        for i in range(server.SERVED_SOFT_CAP):
            port._served[f"r{i}"] = ref._served[f"r{i}"] = (loop.create_future(), now)
        bad = loop.create_future()
        bad.add_done_callback(functools.partial(JosefineRaft._served_done, port, "bad"))
        port._served["bad"] = ref._served["bad"] = (bad, now)
        bad.set_exception(RuntimeError("lost leadership"))  # callback not yet run
        JaxRaft._evict_served(ref, now)
        JosefineRaft._evict_served(port, now)
        assert list(port._served) == list(ref._served) == [
            f"r{i}" for i in range(server.SERVED_SOFT_CAP)]
        # One past the cap with a finished entry younger than the live ones:
        # the JAX server drops the oldest live entry, the port the finished one.
        done = loop.create_future()
        done.set_result(b"ok")
        port._served["done"] = ref._served["done"] = (done, now)
        JaxRaft._evict_served(ref, now)
        JosefineRaft._evict_served(port, now)
        assert list(port._served) == [f"r{i}" for i in range(server.SERVED_SOFT_CAP)]
        assert "r0" not in ref._served and "done" in ref._served

    asyncio.run(main())


def _lone_server(n_nodes: int, pacer, **kw) -> JosefineRaft:
    """Node 1 of an ``n_nodes`` cluster, on the host, not started."""
    socks, ports = bound_sockets(n_nodes)
    cfg = RaftConfig(id=1, ip="127.0.0.1", port=ports[0],
                     nodes=[NodeAddr(id=j + 1, ip="127.0.0.1", port=ports[j])
                            for j in range(1, n_nodes)], tick_ms=100)
    return JosefineRaft(cfg, MemKV(), {0: ListFsm()}, groups=1, pacer=pacer,
                        sock=socks[0], device="cpu", **kw)


def test_forward_and_serve_waits_stretch_with_slow_ticks():
    """A forward waits ``FORWARD_TIMEOUT_S`` for its answer and the leader
    ``SERVE_TIMEOUT_S`` for the commit (the JAX server's 2 s and 5 s), each
    times the largest ``slowdown`` seen while waiting; the leader then
    answers a failure."""
    async def main():
        sent = []
        srv = _lone_server(2, LockstepPacer(),
                           intercept_send=lambda peer, msg: sent.append((peer, msg)) and False)
        loop = asyncio.get_running_loop()
        srv.engine.propose = lambda group, payload: loop.create_future()  # never commits
        assert srv.slowdown == 1.0
        for slowdown in (1.0, 7.5):
            srv.slowdown = slowdown
            t = loop.time()
            with pytest.raises(asyncio.TimeoutError):
                await srv._forward(0, b"x", 2, 1000.0, f"f{slowdown}")
            assert loop.time() - t == pytest.approx(server.FORWARD_TIMEOUT_S * slowdown)
            assert sent[-1][0] == 2 and sent[-1][1].kind == rpc.MSG_CLIENT_REQ
            t = loop.time()
            await srv._serve_forwarded(rpc.WireMsg(kind=rpc.MSG_CLIENT_REQ, group=0, src=1,
                                                   dst=0, req_id=f"s{slowdown}", payload=b"y"))
            assert loop.time() - t == pytest.approx(server.SERVE_TIMEOUT_S * slowdown)
            peer, resp = sent[-1]
            assert (peer, resp.kind, resp.ok, resp.req_id) == \
                (2, rpc.MSG_CLIENT_RESP, 0, f"s{slowdown}")
        # The ticks slow down while a forward waits: it waits 2 s times the
        # larger slowdown; and never past the caller's own deadline.
        srv.slowdown = 1.0
        t = loop.time()
        late = asyncio.ensure_future(srv._forward(0, b"x", 2, 1000.0, "late"))
        await asyncio.sleep(1.5)
        srv.slowdown = 4.0
        with pytest.raises(asyncio.TimeoutError):
            await late
        assert loop.time() - t == pytest.approx(server.FORWARD_TIMEOUT_S * 4.0)
        t = loop.time()
        with pytest.raises(asyncio.TimeoutError):
            await srv._forward(0, b"x", 2, 3.0, "capped")
        assert loop.time() - t == pytest.approx(3.0)
        assert (server.FORWARD_TIMEOUT_S, server.SERVE_TIMEOUT_S) == (2.0, 5.0)

    lockstep.run(main())


def test_tick_loop_measures_its_slowdown():
    """``slowdown`` is the wall time of the tick loop's last cycle over
    ``tick_ms`` times its ticks, at least 1: 1 while the pacer grants ticks
    faster than configured, about 5 when each 100 ms tick waits 0.5 s for
    its grant, and 1 again once the grants come fast."""
    async def main():
        pacer = LockstepPacer(settle_s=0)
        srv = _lone_server(1, pacer)
        await srv.start()
        try:
            for _ in range(3):
                await pacer.advance(1)
            assert srv.slowdown == 1.0
            for _ in range(3):
                await asyncio.sleep(0.5)
                await pacer.advance(1)
                assert 5.0 <= srv.slowdown < 5.5
            await pacer.advance(1)
            assert srv.slowdown == 1.0
            assert not srv.shutdown.is_shutdown
        finally:
            await srv.stop()

    lockstep.run(main())
