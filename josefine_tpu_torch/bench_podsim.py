"""Pod-scale sharded runs of the PyTorch port: BASELINE config 5 on the card.

The twin of the repository's ``bench_podsim.py``, with its flags and row
fields. BASELINE.md config 5 asks for 1M partitions across many devices;
``--devices`` counts the 'p' shards, and each row runs ``--per-device``
groups per shard (131,072 by default, so the 8-shard row is 1,048,576
groups):

* **simulation mode** (default): :func:`make_sharded_cluster_step`, the
  whole N = 5 cluster over a ('p', 'n') mesh, 'p'-axis data parallelism;
  15 warmup and 10 timed ticks, every tick's accepted-message sum read to
  the host (so each timed tick has finished).
* **engine mode** (``--engine``): the product path, ``RaftEngine(mesh=...,
  active_set=True)`` serving seeded Zipfian multi-tenant traffic
  (``--tenants`` topics, ``--skew``, ``--offered`` produce batches per tick
  over the tenant universe), heartbeats staggered wide (``--hb-ticks``) so
  the steady state wakes about P / hb_ticks rows, windows of ``--window``
  ticks; ``--cluster`` engines in the cluster (1: single-member groups, the
  megascale shape), ``--device-route`` / ``--payload-ring`` join them to a
  ``RouteFabric``. The cold-start settle (every group elects once, dense
  ticks) is reported apart from the timed rounds. Every group is elected in
  the same few ticks, so the leaders' heartbeats stay in phase: the round
  whose window holds a multiple of ``hb_ticks`` wakes every row and runs the
  dense fallback (the JAX engine does the same; ``fallback_at_ticks``).

Shards go on distinct cards when there are enough (``cuda:0..7``), else
every shard on ``cuda:0``; every row names them (``mesh``, as ``"cuda:0
x8"`` or ``"cuda:0..7"``) beside the card's name and power limit. One card
cannot show transfer between cards: its shards share one HBM and one
stream. ``--device cpu`` runs the shards on the host at small sizes (host
numbers, labeled so).

Run on the card::

    python -m josefine_tpu_torch.bench_podsim --devices 8
    python -m josefine_tpu_torch.bench_podsim --engine --devices 8 --ticks 20

Prints one JSON line per row; ``--out PATH`` also writes the rows there.
It writes no repository file.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np
import torch

from josefine_tpu_torch.bench import card_label
from josefine_tpu_torch.models import chained_raft as cr
from josefine_tpu_torch.models.types import LEADER, resolve_device, step_params
from josefine_tpu_torch.parallel.sharded import (
    Shards,
    describe_devices,
    make_mesh,
    make_sharded_cluster_step,
    place,
)


def mesh_devices(n: int, device="cuda") -> list[torch.device]:
    """The devices of ``n`` shards: n distinct cards when there are that
    many, else n shards of ``cuda:0``; on ``"cpu"`` n shards of the host.
    There is no fallback from the card to the host."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def _labels(devs) -> dict:
    on_card = devs[0].type == "cuda"
    return {"mesh": describe_devices(devs),
            "device": torch.cuda.get_device_name(devs[0]) if on_card else "cpu",
            "card": card_label() if on_card else None}


def _sync(devs) -> None:
    for d in {str(d): d for d in devs}.values():
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def tree_bytes(tree) -> int:
    """Bytes of a struct of :class:`Grid` or :class:`Shards` leaves."""
    n = 0
    for leaf in tree.leaves():
        blocks = leaf.parts if isinstance(leaf, Shards) else [b for row in leaf.blocks
                                                              for b in row]
        n += sum(b.numel() * b.element_size() for b in blocks)
    return n


def bench_row(per_device: int, devices: int, ticks: int, warmup: int, N: int = 5,
              device="cuda") -> dict:
    """One simulation row: P = per_device * devices groups of N nodes on a
    (devices, 1) mesh."""
    P = per_device * devices
    devs = mesh_devices(devices, device)
    params = step_params(timeout_min=3, timeout_max=8, hb_ticks=1, auto_proposals=2,
                         device=devs[0])
    mesh = make_mesh(devices, 1, devices=devs)
    step = make_sharded_cluster_step(mesh, N)

    t0 = time.perf_counter()
    state, member = cr.init_state(P, N, base_seed=0, params=params, device=devs[0])
    inbox = cr.empty_inbox(P, N, device=devs[0])
    proposals = torch.zeros((P, N), dtype=torch.int32, device=devs[0])
    state, inbox = place(state, mesh), place(inbox, mesh)
    # member rides 'p'-sharded with the node axis whole (the step's spec).
    member, proposals = place(member, mesh, ("p", None)), place(proposals, mesh)
    state_b, inbox_b = tree_bytes(state), tree_bytes(inbox)
    _sync(devs)
    init_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(warmup):
        state, inbox, met = step(params, member, state, inbox, proposals)
    _sync(devs)
    warm_s = time.perf_counter() - t0

    accepted = 0
    t0 = time.perf_counter()
    for _ in range(ticks):
        state, inbox, met = step(params, member, state, inbox, proposals)
        # A host int each tick: the tick has finished when it is read, and
        # it is the progress metric.
        accepted += sum(int(b.sum(dtype=torch.int64)) for row in met.accepted_msgs.blocks
                        for b in row)
    dt = time.perf_counter() - t0

    roles = np.asarray(state.role)
    led = int(((roles == LEADER).sum(axis=1) == 1).sum())
    commits = int((np.asarray(state.commit.s).max(axis=1) > 0).sum())
    return {
        "devices": devices,
        "P": P,
        "per_device": per_device,
        "nodes_per_group": N,
        "ticks": ticks,
        "ticks_per_sec": ticks / dt,
        "ms_per_tick": 1000 * dt / ticks,
        "group_ticks_per_sec": P * ticks / dt,
        "accepted_msgs_per_sec": accepted / dt,
        "groups_with_one_leader": led,
        "leader_fraction": led / P,
        "groups_committed": commits,
        "state_bytes_per_shard": state_b // devices,
        "inbox_bytes_per_shard": inbox_b // devices,
        "bytes_per_group": (state_b + inbox_b) // P,
        "compile_plus_warmup_s": warm_s,
        "init_s": init_s,
        "mesh_devices": devices,
        **_labels(devs),
    }


async def bench_engine_row(per_device: int, devices: int, ticks: int, warmup: int,
                           cluster: int = 1, tenants: int = 1000, skew: float = 1.2,
                           offered: int = 2048, hb_ticks: int = 256, window: int = 8,
                           device_route: bool = False, payload_ring: bool = False,
                           seed: int = 0, device="cuda") -> dict:
    """One engine-path row: a ``cluster``-engine RaftEngine cluster at P =
    per_device * devices groups on a 'p' mesh, active set on, serving
    seeded Zipfian tenant traffic; ``ticks`` timed dispatch rounds after
    the settle and ``warmup`` rounds."""
    from josefine_tpu_torch.raft.engine import RaftEngine
    from josefine_tpu_torch.utils.kv import MemKV
    from josefine_tpu_torch.utils.metrics import REGISTRY
    from josefine_tpu_torch.workload.model import WorkloadSpec
    from josefine_tpu_torch.workload.schedule import ArrivalSchedule

    P = per_device * devices
    devs = mesh_devices(devices, device)
    mesh = make_mesh(devices, 1, devices=devs)
    params = step_params(timeout_min=3, timeout_max=8, hb_ticks=hb_ticks, device=devs[0])
    spec = WorkloadSpec.from_axes(tenants, P, skew, float(offered))
    sched = ArrivalSchedule(spec, seed)
    # Topic-partition -> group row: topics own contiguous row runs in
    # name order (the mapping workload/driver.py's scale path uses).
    topic_row = {name: i * spec.partitions_per_topic
                 for i, name in enumerate(sched.model.topic_names)}

    class _Fsm:
        __slots__ = ()

        def transition(self, data):
            return b""

    fsm = _Fsm()
    ids_ = list(range(cluster))
    t0 = time.perf_counter()
    engines = [RaftEngine(MemKV(), ids_, i, groups=P, params=params,
                          fsms={g: fsm for g in range(P)}, base_seed=i,
                          active_set=True, mesh=mesh, device=devs[0])
               for i in ids_]
    fabric = None
    if device_route or payload_ring:
        from josefine_tpu_torch.raft.route import RouteFabric

        fabric = RouteFabric(payload_ring=payload_ring)
        for e in engines:
            fabric.register(e)
    _sync(devs)
    init_s = time.perf_counter() - t0

    committed = 0
    executed = [0] * cluster
    split_ok = [True]
    fallback_at: list[int] = []

    def _retrieve(fut):
        fut.cancelled() or fut.exception()

    async def one_tick(arrivals):
        nonlocal committed
        outs = []
        for i, e in enumerate(engines):
            w = e.suggest_window(window)
            fell = e.active_fallback_ticks
            res = e.tick(w)
            if e.active_fallback_ticks != fell:
                fallback_at.append(e._ticks - w)  # the round's first device tick
            executed[i] += w
            committed += len(res.committed)
            outs.extend(res.outbound)
            if e._last_wake_shard is not None and \
                    int(e._last_wake_shard.sum()) != e._last_wake_rows:
                split_ok[0] = False
        for m in outs:
            engines[m.dst].receive(m)
        if fabric is not None:
            fabric.flush()
        for arr in arrivals:
            g = topic_row[arr.topic] + arr.partition
            for e in engines:
                if e.is_leader(g):
                    e.propose(g, b"podsim").add_done_callback(_retrieve)
                    break
        # One loop turn so commit-resolved futures run their callbacks.
        await asyncio.sleep(0)

    # Cold-start settle: every group elects once. Leaderless rows are always
    # awake, so these ticks run the dense fallback: the one-time cost of
    # bringing P rows live, reported apart from the timed rounds.
    t0 = time.perf_counter()
    settle = 0
    while settle < 40 * max(1, cluster):
        await one_tick(())
        settle += 1
        if sum(int((e._h_role == LEADER).sum()) for e in engines) == P:
            break
    settle_s = time.perf_counter() - t0
    leaders = sum(int((e._h_role == LEADER).sum()) for e in engines)

    tick_no = 0
    for _ in range(warmup):
        await one_tick(sched.produce_arrivals(tick_no))
        tick_no += 1

    committed = 0
    executed = [0] * cluster
    wake_rows = n_scheds = 0
    shard_wake = np.zeros(devices, np.int64)
    buckets: set[int] = set()
    for e in engines:
        e.active_sched_ticks = e.active_sched_rows = 0
        e.active_fallback_ticks = 0
        e.routed_msgs = 0
    fallback_at.clear()
    _sync(devs)
    t0 = time.perf_counter()
    for _ in range(ticks):
        await one_tick(sched.produce_arrivals(tick_no))
        tick_no += 1
        for e in engines:
            wake_rows += e._last_wake_rows
            if e._last_wake_shard is not None:
                shard_wake += np.asarray(e._last_wake_shard, np.int64)
                n_scheds += 1
            buckets.add(int(e._last_bucket_k))
    dt = time.perf_counter() - t0
    dev_ticks = min(executed) if min(executed) else ticks

    # Per-shard wake fractions: the schedule's own split averaged over the
    # timed rounds, the numbers the raft_active_wake_fraction{shard=}
    # gauges publish at scrape time (one scrape proves the exposition).
    shard_rows = P // devices
    shard_frac = [float(c) / max(1, n_scheds * shard_rows) for c in shard_wake]
    prom = REGISTRY.render_prometheus()
    gauge_ok = "raft_active_wake_fraction" in prom and 'shard="0"' in prom
    e0 = engines[0]
    row = {
        "devices": devices,
        "P": P,
        "per_device": per_device,
        "engine": True,
        "mesh_devices": devices,
        "cluster_nodes": cluster,
        "active_set": True,
        "device_route": fabric is not None,
        "payload_ring": payload_ring,
        "window": window,
        "pipeline": False,
        "proposals_per_tick": offered,
        "hb_ticks": hb_ticks,
        "workload": {"tenants": tenants, "skew": skew, "offered_per_tick": offered,
                     "seed": seed},
        "init_s": init_s,
        "settle_ticks": settle,
        "settle_s": settle_s,
        "leaders_after_settle": leaders,
        "ticks": dev_ticks,
        "dispatch_rounds": ticks,
        "ticks_per_sec": dev_ticks / dt,
        "ms_per_tick": 1000 * dt / dev_ticks,
        "committed_group_advances": committed,
        "avg_wake_rows": wake_rows / max(1, n_scheds),
        "avg_wake_frac": wake_rows / max(1, n_scheds) / P,
        "shard_wake_frac": shard_frac,
        "wake_split_sums_to_scheduled": split_ok[0],
        "wake_frac_gauge_exposed": gauge_ok,
        "bucket_levels": sorted(buckets),
        "sched_ticks": sum(e.active_sched_ticks for e in engines),
        "fallback_ticks": sum(e.active_fallback_ticks for e in engines),
        # The first device tick of each timed round that fell back to the
        # dense dispatch.
        "fallback_at_ticks": fallback_at,
        "state_bytes_per_shard": tree_bytes(e0.state) // devices,
        **_labels(devs),
    }
    if fabric is not None:
        row["routed_msgs"] = sum(e.routed_msgs for e in engines)
        if fabric.rings:
            row["ring"] = fabric.ring_stats()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-device", type=int, default=131072)
    ap.add_argument("--devices", default="1,2,4,8",
                    help="'p' shard counts, one row each")
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=15)
    ap.add_argument("--engine", action="store_true",
                    help="measure the product engine path (active set and the "
                         "sharded scheduler under Zipfian tenant traffic) instead "
                         "of the device-resident simulation")
    ap.add_argument("--cluster", type=int, default=1)
    ap.add_argument("--tenants", type=int, default=1000)
    ap.add_argument("--skew", type=float, default=1.2)
    ap.add_argument("--offered", type=int, default=2048)
    ap.add_argument("--hb-ticks", type=int, default=256)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--device-route", action="store_true")
    ap.add_argument("--payload-ring", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="also write the rows to this path")
    args = ap.parse_args(argv)

    rows = []
    for d in (int(x) for x in args.devices.split(",")):
        if args.engine:
            r = asyncio.run(bench_engine_row(
                args.per_device, d, args.ticks, args.warmup, cluster=args.cluster,
                tenants=args.tenants, skew=args.skew, offered=args.offered,
                hb_ticks=args.hb_ticks, window=args.window,
                device_route=args.device_route, payload_ring=args.payload_ring,
                device=args.device))
        else:
            r = bench_row(args.per_device, d, args.ticks, args.warmup, device=args.device)
        print(json.dumps(r), flush=True)
        rows.append(r)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"bench": "pod_podsim", "results": rows}, f, indent=1)


if __name__ == "__main__":
    main()
