"""Runtime benchmark of the PyTorch port: three ``JosefineRaft`` servers
over loopback TCP.

Where ``josefine_tpu_torch.bench_engine`` hands messages engine to engine in
one loop, this drives the runtime a node runs: each server's tick loop steps
its ``RaftEngine`` on the card under one ``LockstepPacer`` (its default
settle), the TCP transport carries every frame over loopback sockets
(``utils.net.bound_sockets``), and client proposals go through
``RaftClient(node 1).propose``, which forwards a proposal to its group's
leader on another node (``CLIENT_REQ`` / ``CLIENT_RESP``) when node 1 does
not lead it. All three servers share one asyncio loop and one thread, as
in-process clusters of the JAX package do.

After each tick the bench waits until every frame the transports wrote has
been read and decoded on the other side and every send queue is empty (the
delivery barrier), as a 100 ms wall-clock tick allows when the host keeps
up. The barrier is the bench's, not the runtime's: with the pacer's 3 ms
settle alone, a node's multi-megabyte batches at 100,000 groups are still
in flight at the next grant, the transport's newest-wins mailbox replaces
them, and no group elects (an open fault of the runtime, ROADMAP Queue 3).
The barrier's wait is part of each tick's wall time, a wait a deployed
node does not have.

Configuration: the engine cells of ``bench_engine`` (``timeout_min=3,
timeout_max=8, hb_ticks=16`` from ``tick_ms=100``, elections 300-800 ms and
heartbeats 1600 ms), MemKV, one constant-work FSM per node on every group
(it records what it applies). Each round offers 1,000 distinct random
groups one 64-byte payload each (``PROPOSALS_PER_ROUND``, the load of
``bench_engine --active-frac 0.01`` at 100,000 groups), then advances the
clock one tick. After the leaders are up and ``warmup`` rounds, ``rounds``
rounds are timed; then the cluster runs on until every proposal is answered
and applied on all three nodes.

The row also reports the margins of the gates: how many forwards were sent
again (a forward waits ``FORWARD_TIMEOUT_S`` times the server's measured
``slowdown`` before it does), the servers' largest ``slowdown``, and the
most messages one per-peer send queue held (it drops past
``SEND_QUEUE_DEPTH``).

Gates (any failure raises): every group has exactly one leader among the
three nodes; every acknowledged proposal appears exactly once in the
applies of all three nodes for its group, in the same order on each; no
proposal failed or timed out, no tick loop crashed, no server shut down on
its own; the transports dropped nothing, neither on a full queue nor by
replacing a consensus batch still waiting in the mailbox.

Run on the card::

    python -m josefine_tpu_torch.bench_server [--partitions 100000] [--rounds 20]

``--device cpu`` runs on the host at small sizes; its numbers are host
numbers and are labeled so. Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np
import torch

from josefine_tpu_torch.bench import card_label
from josefine_tpu_torch.bench_engine import _busy_ms
from josefine_tpu_torch.config import NodeAddr, RaftConfig
from josefine_tpu_torch.models.types import LEADER, resolve_device
from josefine_tpu_torch.raft import rpc
from josefine_tpu_torch.raft.client import RaftClient
from josefine_tpu_torch.raft.lockstep import CrashWatch
from josefine_tpu_torch.raft.pacer import LockstepPacer
from josefine_tpu_torch.raft.server import JosefineRaft
from josefine_tpu_torch.utils.kv import MemKV
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.net import bound_sockets
from josefine_tpu_torch.utils.shutdown import Shutdown

N = 3
PARTITIONS = 100_000
PROPOSALS_PER_ROUND = 1000
ROUNDS = 20
WARMUP = 10
ELECTION_TICKS = 100  # most ticks allowed until every group has its leader
DRAIN_TICKS = 100     # most ticks allowed until every proposal is answered and applied
BARRIER_S = 60.0      # most wall seconds one tick's frames may take to arrive
CPU_MAX_PARTITIONS = 1024


class _RecordFsm:
    """Constant-work apply target shared by every group of one node: it
    appends what it applies (the payload names its group)."""

    __slots__ = ("applied",)

    def __init__(self):
        self.applied: list[bytes] = []

    def transition(self, data: bytes) -> bytes:
        self.applied.append(data)
        return b""


def _payload(r: int, g: int) -> bytes:
    return (b"%06d:%06d:" % (r, g)).ljust(64, b"x")


def _config(i: int, ports: list[int]) -> RaftConfig:
    return RaftConfig(
        id=i + 1, ip="127.0.0.1", port=ports[i],
        nodes=[NodeAddr(id=j + 1, ip="127.0.0.1", port=ports[j])
               for j in range(N) if j != i],
        tick_ms=100, heartbeat_timeout_ms=1600,
        election_timeout_min_ms=300, election_timeout_max_ms=800)


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) else 0.0


async def _bench(P: int, rounds: int, warmup: int, dev: torch.device) -> dict:
    proposals = min(PROPOSALS_PER_ROUND, P)
    socks, ports = bound_sockets(N)
    pacer = LockstepPacer()
    fsms = [_RecordFsm() for _ in range(N)]
    t0 = time.perf_counter()
    servers = [JosefineRaft(_config(i, ports), MemKV(), {g: fsms[i] for g in range(P)},
                            groups=P, shutdown=Shutdown(), pacer=pacer, sock=socks[i],
                            device=dev)
               for i in range(N)]
    init_s = time.perf_counter() - t0
    engines = [s.engine for s in servers]
    for e in engines:
        e.enable_profiling()
    # Frames and bytes the transports write (length prefix included), the
    # frames they read, and the consensus batches replaced in a mailbox
    # before they were sent.
    wire = {"frames": 0, "bytes": 0, "received": 0, "coalesced": 0, "client_req": 0,
            "client_resp": 0, "req_ids": set(), "drops_at": [], "queue_peak": 0}

    def counted(inner):
        def materialize(peer_id, msg):
            body = inner(peer_id, msg)
            if body is not None:
                wire["frames"] += 1
                wire["bytes"] += len(body) + 4
            return body
        return materialize

    def counted_send(transport):
        inner = transport.send

        def send(peer_id, msg):
            if msg.kind == rpc.MSG_BATCH and transport._latest_batch.get(peer_id) is not None:
                wire["coalesced"] += 1
            elif msg.kind == rpc.MSG_CLIENT_REQ:
                wire["client_req"] += 1
                wire["req_ids"].add(msg.req_id)
            elif msg.kind == rpc.MSG_CLIENT_RESP:
                wire["client_resp"] += 1
            inner(peer_id, msg)
            q = transport._queues.get(peer_id)
            if q is not None and q.qsize() > wire["queue_peak"]:
                wire["queue_peak"] = q.qsize()
        return send

    def received(msg) -> bool:
        wire["received"] += 1
        return True

    for s in servers:
        s.transport._materialize = counted(s.transport._materialize)
        s.transport.send = counted_send(s.transport)
        s.transport._intercept_recv = received

    rng = np.random.default_rng(0)
    client = RaftClient(servers[0])
    calls: list[asyncio.Task] = []
    sub: dict[asyncio.Task, tuple[float, int]] = {}   # call -> (wall s, tick) at submit
    done: dict[asyncio.Task, tuple[float, int]] = {}  # call -> (wall s, tick) at answer
    acked: list[bytes] = []
    tick = [0]
    forwarded = [0]
    slowdown = []  # the servers' largest slowdown after each timed round

    def leaders() -> np.ndarray:
        return np.sum([e._h_role == LEADER for e in engines], axis=0)

    def offer(r: int) -> None:
        for g in rng.permutation(P)[:proposals].tolist():
            payload = _payload(r, g)
            forwarded[0] += not engines[0].is_leader(g)
            call = asyncio.ensure_future(client.propose(payload, group=g, timeout=600.0))

            def answered(c, payload=payload):
                done[c] = (time.perf_counter(), tick[0])
                if not c.cancelled() and c.exception() is None:
                    acked.append(payload)

            call.add_done_callback(answered)
            sub[call] = (time.perf_counter(), tick[0])
            calls.append(call)

    def in_flight() -> bool:
        return wire["frames"] != wire["received"] or any(
            s.transport._latest_batch or not all(q.empty() for q in s.transport._queues.values())
            for s in servers)

    async def advance() -> float:
        """One tick, then the delivery barrier; returns its wall ms."""
        t = time.perf_counter()
        await pacer.advance(1)
        while in_flight():
            if time.perf_counter() - t > BARRIER_S:
                raise AssertionError(f"tick {tick[0]}: frames undelivered after {BARRIER_S} s: "
                                     f"{wire}")
            await asyncio.sleep(0.0005)
        tick[0] += 1
        dropped = sum(s.transport.dropped for s in servers)
        if dropped and (not wire["drops_at"] or wire["drops_at"][-1][1] != dropped):
            wire["drops_at"].append((tick[0], dropped))
        return (time.perf_counter() - t) * 1e3

    def check_alive():
        for s in servers:
            if s.shutdown.is_shutdown:
                raise AssertionError(f"server {s.config.id} shut down on its own")

    with CrashWatch() as watch:
        for s in servers:
            await s.start()
        try:
            # Leaders up: one per group, and node 1 knows each group's leader,
            # so no proposal waits out a leaderless retry.
            t_elect = time.perf_counter()
            while not ((leaders() == 1).all()
                       and (engines[0]._h_leader >= 0).all()):
                if tick[0] >= ELECTION_TICKS:
                    raise AssertionError(
                        f"leaders per group {np.bincount(leaders())} after {tick[0]} ticks")
                await advance()
                check_alive()
            elect = {"ticks": tick[0], "s": time.perf_counter() - t_elect}
            for r in range(warmup):
                offer(r)
                await advance()
            check_alive()
            # Timed rounds: drop the warmup's observations first.
            lat_hist = REGISTRY.histogram("raft_commit_latency_ticks")
            lat_hist.values.clear()
            for e in engines:
                e._lat_open.clear()
                e.profiler.reset()
            sent0, bytes0 = wire["frames"], wire["bytes"]
            forwarded[0] = 0
            first = len(calls)
            advance_ms = []
            t_start = time.perf_counter()
            tick_start = tick[0]
            for r in range(warmup, warmup + rounds):
                offer(r)
                advance_ms.append(await advance())
                slowdown.append(max(s.slowdown for s in servers))
            t_end = time.perf_counter()
            timed_ticks = tick[0] - tick_start
            frames, nbytes = wire["frames"] - sent0, wire["bytes"] - bytes0
            acked_in_time = sum(1 for c in calls[first:] if c in done and done[c][0] <= t_end)
            phases = {}
            for e in engines:
                for phase, st in e.profiler.snapshot().items():
                    agg = phases.setdefault(phase, {"count": 0, "total_ms": 0.0})
                    agg["count"] += st["count"]
                    agg["total_ms"] += st["total_ms"]
            for agg in phases.values():
                agg["ms_per_round"] = agg["total_ms"] / rounds
            engine_lat = {**lat_hist.summary(), "source": "raft_commit_latency_ticks histogram"}
            check_alive()

            # Drain: every proposal answered, and every acknowledged one
            # applied on all three nodes (a payload applied twice does not
            # stand in for one not yet applied). The bench pauses its ticks
            # (the profiler's start, its trace's processing) only once
            # nothing is in flight, so no pause of its own outlasts a
            # forward's wait.
            applied_all = lambda: all(set(acked) <= set(f.applied) for f in fsms)

            async def drain(applied: bool = True) -> int:
                extra = 0
                while not (all(c.done() for c in calls) and (not applied or applied_all())):
                    if extra >= DRAIN_TICKS:
                        raise AssertionError(
                            f"{sum(not c.done() for c in calls)} proposals unanswered, applies "
                            f"{[len(f.applied) for f in fsms]} of {len(acked)} after the drain")
                    await advance()
                    extra += 1
                return extra

            await drain()
            busy = None
            if dev.type == "cuda":
                # The card's busy and idle share over 3 more rounds under the
                # same load and the ticks until they are answered (a trace
                # of the card alone).
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize(dev)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    for r in range(3):
                        offer(warmup + rounds + r)
                        await advance()
                    traced = 3 + await drain(applied=False)
                    torch.cuda.synchronize(dev)
                    wall_ms = (time.perf_counter() - t) * 1e3
                busy_ms = _busy_ms(prof.events())
                busy = {"rounds": 3, "ticks": traced, "wall_ms": wall_ms, "busy_ms": busy_ms,
                        "idle_share": 1 - busy_ms / wall_ms}
                await drain()
            check_alive()
            per_group = leaders()
        finally:
            for s in servers:
                await s.stop()
        if watch.crashes:
            raise AssertionError(f"a tick loop crashed: {watch.crashes[0]}")

    timed = calls[first:first + rounds * proposals]
    wall_lat = [(done[c][0] - sub[c][0]) * 1e3 for c in timed if c in done]
    tick_lat = [done[c][1] - sub[c][1] for c in timed if c in done]
    dt = t_end - t_start
    on_card = dev.type == "cuda"
    dropped = [s.transport.dropped for s in servers]
    row = {
        "P": P,
        "nodes": N,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card_label() if on_card else None,
        "sparse_io": engines[0]._sparse,
        "init_s": init_s,
        "election": elect,
        "rounds": rounds,
        "proposals_per_round": proposals,
        "forwarded_frac": forwarded[0] / (rounds * proposals),
        "ms_per_tick": 1000 * dt / timed_ticks,
        "advance_ms": {"mean": float(np.mean(advance_ms)), "p50": _pct(advance_ms, 50),
                       "max": float(np.max(advance_ms)), "rounds": advance_ms},
        "committed_proposals_per_sec": acked_in_time / dt,
        "acked_in_timed_rounds": acked_in_time,
        "commit_latency_ticks": engine_lat,
        "client_latency_ticks": {"p50": _pct(tick_lat, 50), "p99": _pct(tick_lat, 99)},
        "client_latency_ms": {"p50": _pct(wall_lat, 50), "p99": _pct(wall_lat, 99)},
        "profile_phases": dict(sorted(phases.items())),
        "frames_per_tick": frames / timed_ticks,
        "bytes_per_tick": nbytes / timed_ticks,
        "client_requests": {"sent": wire["client_req"], "distinct": len(wire["req_ids"]),
                            "resent": wire["client_req"] - len(wire["req_ids"]),
                            "responses": wire["client_resp"]},
        "slowdown": {"mean": float(np.mean(slowdown)), "max": float(np.max(slowdown))},
        "queue_peak": wire["queue_peak"],
        "acked": len(acked),
        "dropped": sum(dropped),
        "drops_at_ticks": wire["drops_at"],
        "coalesced": wire["coalesced"],
        "leaders_per_group": {"min": int(per_group.min()), "max": int(per_group.max())},
        "device_busy": busy,
    }

    def fail(why: str):
        brief = {k: row[k] for k in ("P", "ms_per_tick", "client_latency_ms",
                                      "client_latency_ticks", "client_requests", "slowdown",
                                      "queue_peak", "acked", "dropped", "drops_at_ticks",
                                      "coalesced")}
        raise AssertionError(f"{why}; {json.dumps(brief)}")

    failed = [c.exception() for c in calls if c.cancelled() or c.exception() is not None]
    if failed:
        fail(f"{len(failed)} proposals failed: {failed[0]!r}")
    if any(dropped) or wire["coalesced"]:
        fail(f"the transports dropped {dropped} messages on full queues and replaced "
             f"{wire['coalesced']} batches in their mailboxes")
    if not (per_group == 1).all():
        fail(f"leaders per group {np.bincount(per_group).tolist()}")
    # Every acknowledged proposal exactly once on every node, in one order.
    want = sorted(acked)
    orders = []
    for i, f in enumerate(fsms):
        if sorted(f.applied) != want:
            fail(f"node {i + 1} applied {len(f.applied)} payloads, "
                 f"{len(set(f.applied))} distinct, of {len(want)} acked")
            continue
        by_group: dict[bytes, list[bytes]] = {}
        for p in f.applied:
            by_group.setdefault(p[7:13], []).append(p)
        orders.append(by_group)
    if any(o != orders[0] for o in orders):
        fail("the nodes applied a group's proposals in different orders")
    return row


def run(P: int = PARTITIONS, rounds: int = ROUNDS, warmup: int = WARMUP,
        device="cuda") -> dict:
    """Start the three servers, elect, warm up ``warmup`` rounds, time
    ``rounds`` rounds and return the result row: wall ms per tick over the
    sockets (and per tick with its delivery barrier, each round), committed proposals/s (answered
    within the timed rounds over their wall time), commit latency p50/p99 in
    ticks (the engine histogram, leader side) and at the client in ticks and
    wall ms, host ms per engine phase per round (three engines), transport
    frames and bytes per tick, re-sent forwards, the servers' slowdown and
    the fullest send queue, and on the card its busy/idle share over 3 more
    rounds and the ticks until they are answered. Raises if a gate fails
    (see the module docstring)."""
    dev = resolve_device(device)
    if dev.type == "cpu" and P > CPU_MAX_PARTITIONS:
        raise ValueError(f"on the host this runs at most {CPU_MAX_PARTITIONS} groups")
    return asyncio.run(_bench(P, rounds, warmup, dev))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--partitions", type=int, default=PARTITIONS)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.partitions, args.rounds, args.warmup, device=args.device)))


if __name__ == "__main__":
    main()
