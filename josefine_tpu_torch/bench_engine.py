"""Host-bridge benchmark of the PyTorch port: a 3-engine in-process cluster.

The twin of the repository's ``bench_engine.py`` (its ``bench_one``,
split-phase path, with its ``--active-set`` / ``--active-frac`` and
``--device-route`` / ``--payload-ring`` options).
Where ``josefine_tpu_torch.bench`` drives the bare fused-window kernel, this
drives the path the product runs: inbox packing, the packed window step on
the card, one device→host fetch per engine tick, chain append/commit, FSM
apply, outbox decode and in-process wire routing.

Topology: three RaftEngine instances in one process (slot i = node i), P
groups each spanning all three, messages routed engine→engine every round,
and a proposal lane offering one 64-byte payload to each of 256 distinct
random groups per round (sent to the group's leader). Configuration as in
``bench_engine.py``: ``timeout_min=3, timeout_max=8, hb_ticks=16``, MemKV, a
constant-work FSM on every group. Each round is split-phase: ``tick_begin``
on all three engines, then ``tick_finish`` on each, then delivery. The
engines pick their IO as the product does: dense up to 4096 groups, sparse
above. ``--active-set`` turns the active-set scheduler on; ``--active-frac
F`` offers one payload to exactly round(F * P) distinct groups per round (a
permutation slice) instead of the 256 random ones. ``--device-route``
registers the three engines on a ``RouteFabric``: payload-free consensus
rows go engine to engine on the card, flushed at the round's delivery
barrier; ``--payload-ring`` adds the fabric's payload ring, so AppendEntries
whose blocks are resident route on the card too.

Run on the card::

    python -m josefine_tpu_torch.bench_engine [--partitions 4096] [--ticks 20]
    python -m josefine_tpu_torch.bench_engine --partitions 100000 --active-set --active-frac 0.01
    python -m josefine_tpu_torch.bench_engine --partitions 100000 --active-frac 0.01 --device-route --payload-ring

There is no CPU fallback: with no card it raises. ``--device cpu`` runs on
the host at small sizes; its numbers are host numbers and are labeled so.
Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import time

import numpy as np
import torch

from josefine_tpu_torch.bench import card_label
from josefine_tpu_torch.models.types import LEADER, resolve_device, step_params
from josefine_tpu_torch.raft import rpc
from josefine_tpu_torch.raft.engine import RaftEngine
from josefine_tpu_torch.raft.hostio import host_to
from josefine_tpu_torch.raft.route import RouteFabric
from josefine_tpu_torch.raft.packed_step import (
    _active_window_fn,
    _decay_scatter_fn,
    _gather_active,
    _sparse_window_fn,
    _window_step_fn,
    active_bucket,
)
from josefine_tpu_torch.utils.kv import MemKV
from josefine_tpu_torch.utils.metrics import REGISTRY

N = 3
PARTITIONS = 4096
PROPOSALS_PER_TICK = 256  # distinct groups offered one payload each round
PAYLOAD = b"x" * 64
WARMUP = 40
TICKS = 20
CPU_MAX_PARTITIONS = 1024


class _BenchFsm:
    """Constant-work apply target, so the engines run the full commit path
    (chain commit -> FSM apply -> future resolution at commit)."""

    __slots__ = ()

    def transition(self, data: bytes) -> bytes:
        return b""


def _retrieve(fut):
    """Done-callback retrieving a discarded proposal future's exception
    (NotLeader during churn)."""
    fut.cancelled() or fut.exception()


def _traced(fn, dev, host: bool = True) -> tuple[list, float]:
    """Run ``fn`` under ``torch.profiler``: the trace's events, and the host
    wall ms of the run, which ends with the card idle. ``host=False`` traces
    the card alone (kernels, copies and CUDA runtime calls), which slows the
    run far less than recording every host op as well."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof.events(), wall_ms


def _busy_ms(events) -> float:
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA) / 1e3


def _kernel_kind(name: str) -> str:
    """A short name for a PyTorch kernel: its functor, or its kernel
    family where it has none."""
    m = (re.search(r"\w+Functor<[\w, ]*>", name)
         or re.search(r"\w+_kernel_impl(?=\()|\w+Kernel\w*", name))
    return m.group(0) if m else name[:60]


def _step_program(engine: RaftEngine, window: int):
    """The window step the engine runs now, as a no-argument callable on
    its current state with an empty inbox, and its name: the dense step,
    the sparse step at the current capacity (touched-row bucket of 256,
    all padding), or the active-set trio (gather, compact window,
    decay-scatter) over a bucket of as many rows as its last schedule woke,
    drawn at random. An engine on a route fabric merges an empty routed
    plane, as its routed ticks do."""
    dev, P, N = engine._device, engine.P, engine.N
    base = (engine.params, engine.member, engine._me_dev, engine.state)
    pf = host_to(np.zeros(N, np.int32), dev)
    plane = (None if engine._fabric is None
             else torch.zeros((9, P, N), dtype=torch.int32, device=dev))
    routed = "" if plane is None else ", routed"
    if engine._active_set and engine._sched_mode == "compacted":
        A = max(1, engine._last_wake_rows)
        k = active_bucket(A, P)
        idx = np.full(k, P, np.int64)
        idx[:A] = np.sort(np.random.default_rng(0).choice(P, A, replace=False))
        idx = host_to(idx, dev)
        vals = host_to(np.zeros((10, k, N), np.int32), dev)

        def active():
            st_c, mem_c = _gather_active(engine.state, engine.member, idx)
            rows, flat = _active_window_fn(window)(engine.params, mem_c, engine._me_dev,
                                                   st_c, vals, pf, plane, idx)
            return _decay_scatter_fn(window)(engine.params, engine.state, pf, idx, rows), flat

        return active, f"active (bucket {k} for {A} rows{routed})"
    if engine._sparse:
        fn = _sparse_window_fn(engine._k_out, window)
        idx = host_to(np.full(min(256, P), P, np.int64), dev)
        vals = host_to(np.zeros((10, min(256, P), N), np.int32), dev)
        return (lambda: fn(*base, pf, idx, vals, plane)), f"sparse (k_out {engine._k_out}{routed})"
    fn = _window_step_fn(window)
    in10 = host_to(np.zeros((10, P, N), np.int32), dev)
    return (lambda: fn(*base, in10, pf, plane)), "dense" + (" (routed)" if routed else "")


def window_step_profile(engine: RaftEngine, window: int, reps: int = 20) -> dict:
    """The step the engine runs (see :func:`_step_program`) alone, on the
    card: ``events_ms``, the time CUDA events see per step over ``reps``
    back-to-back steps (device work plus the gaps the host leaves between
    launches); from one ``torch.profiler`` trace of one step, ``kernels``
    (device kernels and copies it ran), ``launch_calls``
    (``cudaLaunchKernel`` calls on the host), ``busy_ms`` (the device time
    of those kernels) and ``top`` (the most frequent kernel names)."""
    from collections import Counter

    from torch.autograd import DeviceType

    dev = engine._device
    fn, name = _step_program(engine, window)
    fn()
    torch.cuda.synchronize(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize(dev)
    events_ms = a.elapsed_time(b) / reps
    evs, _ = _traced(fn, dev)
    gpu = [e for e in evs if e.device_type == DeviceType.CUDA]
    return {
        "step": name,
        "ticks": window,
        "events_ms": events_ms,
        "kernels": len(gpu),
        "launch_calls": sum(e.name == "cudaLaunchKernel" for e in evs),
        "busy_ms": _busy_ms(evs),
        "top": Counter(_kernel_kind(e.name) for e in gpu).most_common(6),
    }


async def _bench(P: int, ticks: int, warmup: int, window: int, device: torch.device,
                 sparse_io: bool | None, active_set: bool,
                 active_frac: float | None, device_route: bool,
                 payload_ring: bool) -> dict:
    params = step_params(timeout_min=3, timeout_max=8, hb_ticks=16, device=device)
    # Offered load as an activity fraction: exactly round(frac * P) distinct
    # groups get one payload per round (a permutation slice; sampling with
    # replacement would touch fewer).
    offered = PROPOSALS_PER_TICK if active_frac is None else max(1, round(active_frac * P))
    t0 = time.perf_counter()
    fsm = _BenchFsm()  # stateless: one instance can serve every group
    engines = [RaftEngine(MemKV(), [0, 1, 2], i, groups=P, params=params,
                          fsms={g: fsm for g in range(P)}, sparse_io=sparse_io,
                          active_set=active_set, device=device)
               for i in range(N)]
    fabric = None
    if device_route or payload_ring:
        fabric = RouteFabric(payload_ring=payload_ring)
        for e in engines:
            fabric.register(e)
    init_s = time.perf_counter() - t0
    for e in engines:
        e.enable_profiling()

    rng = np.random.default_rng(0)
    proposed = 0
    rounds = 0
    executed = [0] * N  # device ticks actually run per engine
    wake_rows = [0, 0]  # summed woken rows, rounds x engines (active set)
    buckets: dict[int, int] = {}  # compact bucket size -> engine-ticks
    k_out_history = [[[0, e._k_out]] for e in engines]
    lat_hist = REGISTRY.histogram("raft_commit_latency_ticks")
    host_msgs = 0  # host-decoded wire entries (a batch counts its entries)
    flush_ms = 0.0  # host ms of the fabric's delivery barrier

    def one_tick(live: bool):
        nonlocal proposed, rounds, host_msgs, flush_ms
        # Split-phase: dispatch all three engines' device steps before
        # fetching any result. Each engine applies the adaptive window
        # policy (single ticks until leaders exist, then the full window).
        handles = [e.tick_begin(e.suggest_window(window)) for e in engines]
        outbound = []
        for i, (e, h) in enumerate(zip(engines, handles)):
            executed[i] += h["window"]
            if h["mode"] == "active":
                buckets[h["k"]] = buckets.get(h["k"], 0) + 1
            outbound.extend(e.tick_finish(h).outbound)
            if e._k_out != k_out_history[i][-1][1]:
                k_out_history[i].append([rounds + 1, e._k_out])
            wake_rows[0] += e._last_wake_rows
            wake_rows[1] += 1
        rounds += 1
        for m in outbound:
            host_msgs += len(m) if isinstance(m, rpc.MsgBatch) else 1
            engines[m.dst].receive(m)
        if fabric is not None:
            # The delivery barrier: routed rows land with the host ones.
            # With the payload ring its gather waits for the card.
            t_flush = time.perf_counter()
            fabric.flush()
            flush_ms += (time.perf_counter() - t_flush) * 1e3
        if live:
            if active_frac is None:
                groups = rng.integers(0, P, offered)
            else:
                groups = rng.permutation(P)[:offered]
            for g in set(groups.tolist()):
                for e in engines:
                    if e.is_leader(g):
                        e.propose(g, PAYLOAD).add_done_callback(_retrieve)
                        proposed += 1
                        break

    def commit_seqs() -> np.ndarray:
        return np.max([e._h_commit & 0xFFFFFFFF for e in engines], axis=0)

    # Warm up UNDER the offered load: steady state includes the client lane,
    # and for the active set the load sets the bucket sizes it runs in.
    for _ in range(warmup):
        one_tick(live=True)

    proposed = 0
    executed = [0] * N
    wake_rows[:] = [0, 0]
    buckets.clear()
    host_msgs, flush_ms = 0, 0.0
    if fabric is not None:
        fabric.ring_routed = fabric.ring_capped = 0
        for r in fabric.rings.values():
            r.staged_total = r.spills = r.oversize = r.pin_skips = 0
    # Measure the timed loop only: drop the warmup's latency observations
    # and the engines' open entries for warmup-minted blocks.
    lat_hist.values.clear()
    for e in engines:
        e._lat_open.clear()
        e.profiler.reset()
        e.active_sched_ticks = e.active_sched_rows = 0
        e.active_fallback_ticks = e.active_refetches = 0
        e.routed_msgs = 0
    c0 = commit_seqs()
    t0 = time.perf_counter()
    for _ in range(ticks):
        one_tick(live=True)
    dt = time.perf_counter() - t0
    committed = int((commit_seqs() - c0).sum())
    routed_msgs = sum(e.routed_msgs for e in engines)
    timed_host_msgs, timed_flush_ms = host_msgs, flush_ms
    ring = fabric.ring_stats() if fabric is not None else None
    dev_ticks = min(executed) or ticks
    phases = {}
    for e in engines:
        for phase, s in e.profiler.snapshot().items():
            agg = phases.setdefault(phase, {"count": 0, "total_ms": 0.0, "p99_ms": 0.0})
            agg["count"] += s["count"]
            agg["total_ms"] += s["total_ms"]
            agg["p99_ms"] = max(agg["p99_ms"], s["p99_ms"])
    for agg in phases.values():
        agg["ms_per_round"] = agg["total_ms"] / ticks
    leaders = np.sum([e._h_role == LEADER for e in engines], axis=0)

    on_card = device.type == "cuda"
    row = {
        "P": P,
        "nodes": N,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "card": card_label() if on_card else None,
        "sparse_io": engines[0]._sparse,
        "active_set": active_set,
        "active_frac": active_frac,
        "device_route": fabric is not None,
        "payload_ring": payload_ring,
        "init_s": init_s,
        "ticks": dev_ticks,
        "dispatch_rounds": ticks,
        "window": window,
        "window_executed_avg": sum(executed) / (N * ticks),
        "proposals_per_tick": offered,
        "ms_per_tick": 1000 * dt / dev_ticks,
        "ms_per_dispatch_round": 1000 * dt / ticks,
        "ticks_per_sec": dev_ticks / dt,
        "proposed": proposed,
        "committed_blocks": committed,
        "committed_blocks_per_sec": committed / dt,
        "commit_latency_ticks": {**lat_hist.summary(),
                                 "source": "raft_commit_latency_ticks histogram"},
        "profile_phases": dict(sorted(phases.items())),
        "leaders_per_group": {"min": int(leaders.min()), "max": int(leaders.max())},
        # [round, capacity] at the start and at every change, per engine,
        # counted from the first warmup round.
        "k_out_history": k_out_history,
    }
    if active_set:
        # The scheduler over the timed loop, cluster totals: how often
        # compaction ran, the wake fraction (every tick, fallbacks
        # included), the bucket sizes it ran in, and the refetches.
        s_ticks = sum(e.active_sched_ticks for e in engines)
        row["active_set_stats"] = {
            "sched_ticks": s_ticks,
            "fallback_ticks": sum(e.active_fallback_ticks for e in engines),
            "refetches": sum(e.active_refetches for e in engines),
            "avg_active_rows": sum(e.active_sched_rows for e in engines) / max(1, s_ticks),
            "mean_wake_frac": wake_rows[0] / max(1, wake_rows[1]) / P,
            "buckets": dict(sorted(buckets.items())),
        }
    if fabric is not None:
        # Timed-loop delivery split: rows routed on the card against wire
        # entries decoded on the host, the payload ring's counters, and the
        # host ms of the delivery barrier per round (not an engine phase:
        # the driver calls it).
        total = routed_msgs + timed_host_msgs
        row["device_route_stats"] = {
            "routed_msgs": routed_msgs,
            "host_msgs": timed_host_msgs,
            "routed_frac": routed_msgs / total if total else 0.0,
            "ring": ring,
            "flush_ms_per_round": timed_flush_ms / ticks,
        }
    if on_card:
        # The card's busy and idle share over 3 more rounds under the same
        # load, from a trace of the card alone; the 3 rounds before it, not
        # traced, show what the trace itself costs in wall time.
        t0 = time.perf_counter()
        for _ in range(3):
            one_tick(live=True)
        torch.cuda.synchronize(device)
        untraced_ms = (time.perf_counter() - t0) * 1e3
        evs, wall_ms = _traced(lambda: [one_tick(live=True) for _ in range(3)], device,
                               host=False)
        busy = _busy_ms(evs)
        from torch.autograd import DeviceType

        row["device_busy"] = {"rounds": 3, "wall_ms": wall_ms, "untraced_wall_ms": untraced_ms,
                              "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
                              "device_ops": sum(e.device_type == DeviceType.CUDA
                                                for e in evs)}
        row["window_step"] = {str(w): window_step_profile(engines[0], w)
                              for w in sorted({1, window})}
    return row


def run(P: int = PARTITIONS, ticks: int = TICKS, warmup: int = WARMUP, window: int = 1,
        device="cuda", sparse_io: bool | None = None, active_set: bool = False,
        active_frac: float | None = None, device_route: bool = False,
        payload_ring: bool = False) -> dict:
    """Build the cluster, warm up ``warmup`` rounds, time ``ticks`` rounds
    and return the result row: ms per device tick, committed blocks/s,
    commit latency p50/p99 in device ticks, host ms per engine phase per
    round (cluster sum), leaders per group, the sparse capacity's history,
    the active-set scheduler's counts, with a fabric the routed/host split
    (``device_route_stats``), and on the card the card's busy/idle share and
    device ops over 3 more rounds and the window step's own profile at
    window 1 and at ``window``. ``sparse_io=None`` lets the engines choose (sparse above
    4096 groups); ``payload_ring`` implies ``device_route``."""
    dev = resolve_device(device)
    if dev.type == "cpu" and P > CPU_MAX_PARTITIONS:
        raise ValueError(f"on the host this runs at most {CPU_MAX_PARTITIONS} groups")
    return asyncio.run(_bench(P, ticks, warmup, window, dev, sparse_io, active_set,
                              active_frac, device_route, payload_ring))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--partitions", type=int, default=PARTITIONS)
    ap.add_argument("--ticks", type=int, default=TICKS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--window", type=int, default=1)
    ap.add_argument("--active-set", action="store_true")
    ap.add_argument("--active-frac", type=float, default=None)
    ap.add_argument("--device-route", action="store_true")
    ap.add_argument("--payload-ring", action="store_true")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.partitions, args.ticks, args.warmup, args.window,
                         device=args.device, active_set=args.active_set,
                         active_frac=args.active_frac, device_route=args.device_route,
                         payload_ring=args.payload_ring)))


if __name__ == "__main__":
    main()
