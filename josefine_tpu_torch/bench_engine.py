"""Host-bridge benchmark of the PyTorch port: a 3-engine in-process cluster.

The twin of the repository's ``bench_engine.py`` (its ``bench_one``, with
its ``--active-set`` / ``--active-frac``, ``--device-route`` /
``--payload-ring``, ``--pipeline`` and ``--flight-wire`` options).
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
whose blocks are resident route on the card too. ``--pipeline`` runs each
round through ``tick_pipelined`` instead (each call fetches the previous
tick and dispatches the next, so the host work of tick t runs under the
card's compute of t+1). ``--flight-wire`` journals wire-level trace events
during the timed loop, and times the same loop with tracing off just
before it on the same warmed engines (``flight_wire_overhead``). After the
timed loop, 20 rounds with no new proposal let the blocks still in flight
commit, so their latencies count, as in ``bench_engine.py``. ``--proposals
K`` offers K groups a payload per round (256 by default). Every row carries
the engines' host ms per phase (``profile_phases``): the reference's
``--profile`` is always on here.

``--kernel`` is the reference's packed-step mode (its ``bench_kernel``): no
cluster and no wire, one engine's exact per-tick device step alone. Per
size it times the dense packed step (``_window_step_fn(1)``, no
``peer_fresh``) on the state of a 3-node engine with an all-zero (10, P, 3)
inbox: with the tick's one upload and one fetch (``ms_per_step``), and
with the inbox already on the device, waiting on the card without a fetch
(``ms_per_step_compute_only``). Then a sparse single-node engine ticks 80
times to settle past the election burst and the capacity's shrink
hysteresis, and ``max(10, iters // 2)`` idle ticks give the sparse
bridge's floor: the bytes uploaded and fetched per tick and the capacity
``k_out``. Beside them, the dense tick's upload and fetch bytes.
``--ticks`` sets the iterations (default ``max(10, 2_000_000 // P)``).

``--sizes A,B,C`` runs one row per size (``--partitions P`` is the one-size
form; ``--kernel`` defaults to 1,000, 10,000 and 100,000). ``--xprof DIR``
runs the timed loop under ``torch.profiler`` (host and card activity) and
writes its Chrome trace into DIR: in the host-bridge mode, the timed
rounds; with ``--kernel``, the loop with the transfers. ``--out PATH``
writes ``{"bench", "device", "results"}``; without it nothing is written.

Run on the card::

    python -m josefine_tpu_torch.bench_engine [--partitions 4096] [--ticks 20]
    python -m josefine_tpu_torch.bench_engine --partitions 100000 --active-set --active-frac 0.01
    python -m josefine_tpu_torch.bench_engine --partitions 100000 --active-frac 0.01 --device-route --payload-ring
    python -m josefine_tpu_torch.bench_engine --pipeline
    python -m josefine_tpu_torch.bench_engine --flight-wire
    python -m josefine_tpu_torch.bench_engine --kernel --sizes 1000,10000,100000 --ticks 60

There is no CPU fallback: with no card it raises. ``--device cpu`` runs on
the host at small sizes; its numbers are host numbers and are labeled so.
Prints one JSON line per row.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import platform
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
from josefine_tpu_torch.raft.packed_step import _window_step_fn
from josefine_tpu_torch.utils.kv import MemKV
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.profiling import NULL_PROFILER

N = 3
PARTITIONS = 4096
PROPOSALS_PER_TICK = 256  # distinct groups offered one payload each round
PAYLOAD = b"x" * 64
WARMUP = 40
TICKS = 20
DRAIN = 20  # rounds with no new proposal after the timed loop
CPU_MAX_PARTITIONS = 1024
KERNEL_SIZES = (1_000, 10_000, 100_000)


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


def device_label(dev: torch.device) -> str:
    """What a row's numbers were measured on: the card's name and power
    limit, or the host's architecture and CPU count."""
    if dev.type == "cuda":
        return card_label()
    return f"host {platform.machine()}, {os.cpu_count()} CPUs"


def xprof_path(xprof: str, bench: str, P: int) -> str:
    """The Chrome trace ``--xprof`` writes for one row."""
    return os.path.join(xprof, f"{bench}_P{P}.json")


@contextlib.contextmanager
def _xprof(path: str | None, dev: torch.device):
    """Run the block under ``torch.profiler`` (host activity, and the
    card's on a card) and write its Chrome trace to ``path``; nothing when
    ``path`` is None."""
    if path is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


def _busy_ms(events) -> float:
    """Ms the card was busy: the union of the intervals of its kernels,
    copies and fills, so overlapping streams count once. A host range's
    twin on the card's timeline (a ``gpu_user_annotation``) is no work."""
    from torch.autograd import DeviceType

    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and not e.is_user_annotation):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def _kernel_kind(name: str) -> str:
    """A short name for a PyTorch kernel: its functor, or its kernel
    family where it has none."""
    m = (re.search(r"\w+Functor<[\w, ]*>", name)
         or re.search(r"\w+_kernel_impl(?=\()|\w+Kernel\w*", name))
    return m.group(0) if m else name[:60]


def _step_program(engine: RaftEngine, window: int):
    """The program the engine's step runner runs now, as a no-argument
    callable on the engine's current state with an empty inbox, and its
    name: the dense step, the sparse step at the current capacity
    (touched-row bucket of 256, all padding), or the compacted tick over a
    bucket of as many rows as its last schedule woke, drawn at random. An
    engine on a route fabric merges an empty routed plane, as its routed
    ticks do. On a card the sparse and compacted programs go through the
    engine's graph cache, as its ticks do."""
    r, P, N = engine._runner, engine.P, engine.N
    pf = np.zeros(N, np.int32)
    plane = (None if engine._fabric is None
             else torch.zeros((9, P, N), dtype=torch.int32, device=engine._device))
    routed = "" if plane is None else ", routed"
    if engine._active_set and engine._sched_mode == "compacted":
        A = max(1, engine._last_wake_rows)
        G = np.sort(np.random.default_rng(0).choice(P, A, replace=False))
        k, build_k, plan = r.bucket(G)
        vals = np.zeros((10, build_k, N), np.int32)
        return (lambda: r.compacted(engine.state, engine.member, G, k, plan, vals, pf, window,
                                    plane, NULL_PROFILER),
                f"active (bucket {k} for {A} rows{routed})")
    if engine._sparse:
        idx = np.full(min(256, P), P, np.int32)
        vals = np.zeros((10, len(idx), N), np.int32)
        return (lambda: r.sparse(engine.state, engine.member, engine._k_out, idx, vals, pf,
                                 window, plane, NULL_PROFILER),
                f"sparse (k_out {engine._k_out}{routed})")
    in10 = np.zeros((10, P, N), np.int32)
    return (lambda: r.dense(engine.state, engine.member, in10, pf, window, plane,
                            NULL_PROFILER),
            "dense" + (" (routed)" if routed else ""))


def window_step_profile(engine: RaftEngine, window: int, reps: int = 20) -> dict:
    """The step the engine runs (see :func:`_step_program`) alone, on the
    card, after two warm-up runs (a graph key's eager run and its capture):
    ``events_ms``, the time CUDA events see per step over ``reps``
    back-to-back steps (device work plus the gaps the host leaves between
    launches); from one ``torch.profiler`` trace of one step, ``kernels``
    (device kernels and copies it ran), ``launch_calls``
    (``cudaLaunchKernel`` calls on the host; a graph replay launches its
    kernels in one ``cudaGraphLaunch``), ``busy_ms`` (the device time of
    those kernels) and ``top`` (the most frequent kernel names)."""
    from collections import Counter

    from torch.autograd import DeviceType

    dev = engine._device
    fn, name = _step_program(engine, window)
    fn()
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
                 payload_ring: bool, pipeline: bool = False,
                 flight_wire: bool = False, proposals: int = PROPOSALS_PER_TICK,
                 xprof: str | None = None) -> dict:
    params = step_params(timeout_min=3, timeout_max=8, hb_ticks=16, device=device)
    # Offered load as an activity fraction: exactly round(frac * P) distinct
    # groups get one payload per round (a permutation slice; sampling with
    # replacement would touch fewer).
    offered = proposals if active_frac is None else max(1, round(active_frac * P))
    t0 = time.perf_counter()
    fsm = _BenchFsm()  # stateless: one instance can serve every group
    engines = [RaftEngine(MemKV(), [0, 1, 2], i, groups=P, params=params,
                          fsms={g: fsm for g in range(P)}, sparse_io=sparse_io,
                          active_set=active_set, flight_wire=flight_wire,
                          device=device)
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
        outbound = []
        if pipeline:
            # Double-buffered: each call fetches tick t and dispatches t+1.
            # Credit the tick that completes inside this round, not the
            # one still running on the card when the timer is read.
            results = []
            for i, e in enumerate(engines):
                executed[i] += e.pipeline_window
                results.append(e.tick_pipelined(e.suggest_window(window)))
        else:
            # Split-phase: dispatch all three engines' device steps before
            # fetching any result. Each engine applies the adaptive window
            # policy (single ticks until leaders exist, then the full window).
            handles = [e.tick_begin(e.suggest_window(window)) for e in engines]
            results = []
            for i, (e, h) in enumerate(zip(engines, handles)):
                executed[i] += h["window"]
                if h["mode"] == "active":
                    buckets[h["k"]] = buckets.get(h["k"], 0) + 1
                results.append(e.tick_finish(h))
        for i, (e, res) in enumerate(zip(engines, results)):
            outbound.extend(res.outbound)
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

    flight_off_ms = None
    if flight_wire:
        # The same loop with tracing off on the same warmed engines (the
        # flag is host gating only), so the cost of tracing is a measured
        # delta. The fabric's trace mirrors follow the engines' flags.
        for e in engines:
            e._flight_wire = False
        if fabric is not None:
            fabric._refresh_trace()
        ex0 = list(executed)
        t0 = time.perf_counter()
        for _ in range(ticks):
            one_tick(live=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt_off = time.perf_counter() - t0
        flight_off_ms = 1000 * dt_off / (min(a - b for a, b in zip(executed, ex0)) or ticks)
        for e in engines:
            e._flight_wire = True
        if fabric is not None:
            fabric._refresh_trace()
    events0 = sum(e.flight.seq for e in engines)

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
    trace = None if xprof is None else xprof_path(xprof, "engine_host_bridge", P)
    with _xprof(trace, device):
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
        "pipeline": pipeline,
        "flight_wire": flight_wire,
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
            "avg_active_frac": sum(e.active_sched_rows for e in engines) / max(1, s_ticks) / P,
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
    if flight_off_ms is not None:
        # The wire-trace cost in this run: the timed loop ran with tracing,
        # the same loop just before it without.
        row["flight_wire_overhead"] = {
            "ms_per_tick_off": flight_off_ms,
            "ms_per_tick_on": row["ms_per_tick"],
            "delta_ms_per_tick": row["ms_per_tick"] - flight_off_ms,
            "journal_events": sum(e.flight.seq for e in engines) - events0,
        }
    # Let the commits in flight drain, with no new proposal, so the blocks
    # minted late in the timed loop land their latencies in the histogram
    # (the reference bench's 20 rounds); every timed number is taken above.
    for _ in range(DRAIN):
        one_tick(live=False)
    if pipeline:
        # Adopt the ticks still in flight, so what follows starts from
        # settled engines.
        for e in engines:
            e.tick_drain()
    row["commit_latency_ticks"] = {**lat_hist.summary(),
                                   "source": "raft_commit_latency_ticks histogram"}
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
        payload_ring: bool = False, pipeline: bool = False,
        flight_wire: bool = False, proposals: int = PROPOSALS_PER_TICK,
        xprof: str | None = None) -> dict:
    """Build the cluster, warm up ``warmup`` rounds, time ``ticks`` rounds
    and return the result row: ms per device tick, committed blocks/s,
    commit latency p50/p99 in device ticks, host ms per engine phase per
    round (cluster sum), leaders per group, the sparse capacity's history,
    the active-set scheduler's counts, with a fabric the routed/host split
    (``device_route_stats``), and on the card the card's busy/idle share and
    device ops over 3 more rounds and the window step's own profile at
    window 1 and at ``window``. ``sparse_io=None`` lets the engines choose (sparse above
    4096 groups); ``payload_ring`` implies ``device_route``. ``pipeline`` runs
    the rounds through ``tick_pipelined``; ``flight_wire`` journals wire
    trace events and adds ``flight_wire_overhead`` (the timed loop with
    tracing against the same loop without). The commit latency also counts
    the blocks of the timed loop that commit in the ``DRAIN`` rounds after
    it, which offer no proposal. ``proposals`` groups are offered a payload
    per round unless ``active_frac`` says otherwise; ``xprof`` (a
    directory) traces the timed rounds (:func:`xprof_path`), whose numbers
    then carry the profiler's cost."""
    dev = resolve_device(device)
    if dev.type == "cpu" and P > CPU_MAX_PARTITIONS:
        raise ValueError(f"on the host this runs at most {CPU_MAX_PARTITIONS} groups")
    return asyncio.run(_bench(P, ticks, warmup, window, dev, sparse_io, active_set,
                              active_frac, device_route, payload_ring, pipeline,
                              flight_wire, proposals, xprof))


def bench_kernel(P: int, iters: int, device="cuda", xprof: str | None = None) -> dict:
    """The engine's exact per-tick device step alone at P groups (the
    reference's ``bench_kernel``): the dense packed step with the tick's
    one upload and one fetch, and without them; then the sparse bridge's
    idle floor on a single-node engine, and the dense tick's bytes. With
    ``xprof`` (a directory) the loop with the transfers runs under
    ``torch.profiler``, so its ``ms_per_step`` carries the profiler's cost."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def wait():
        if on_card:
            torch.cuda.synchronize(dev)

    e = RaftEngine(MemKV(), [0, 1, 2], 0, groups=P,
                   params=step_params(timeout_min=3, timeout_max=8, hb_ticks=1, device=dev),
                   device=dev)
    step = _window_step_fn(1)  # the dense packed step, whatever IO the engine picked
    in10 = np.zeros((10, P, e.N), np.int32)
    st, flat = step(e.params, e.member, e._me_dev, e.state, host_to(in10, dev), None)
    flat.cpu().numpy()
    trace = None if xprof is None else xprof_path(xprof, "engine_packed_step", P)
    with _xprof(trace, dev):
        t0 = time.perf_counter()
        for _ in range(iters):
            st, flat = step(e.params, e.member, e._me_dev, st, host_to(in10, dev), None)
            flat_np = flat.cpu().numpy()  # the tick's one device->host fetch
        dt = time.perf_counter() - t0

    # Compute only: the inbox stays on the device, and each step is waited
    # for on the card without a fetch.
    in10_dev = host_to(in10, dev)
    st, flat = step(e.params, e.member, e._me_dev, st, in10_dev, None)
    wait()
    t0 = time.perf_counter()
    for _ in range(iters):
        st, flat = step(e.params, e.member, e._me_dev, st, in10_dev, None)
        wait()
    dt_c = time.perf_counter() - t0

    # The sparse product tick at idle: single-member groups elect themselves
    # and then exchange nothing. 80 ticks pass the cold-start burst and the
    # capacity's 64-tick shrink hysteresis; the bytes are read after
    # tick_finish, where an overflow adds its dense fetch.
    es = RaftEngine(MemKV(), [0], 0, groups=P,
                    params=step_params(timeout_min=3, timeout_max=8, hb_ticks=16, device=dev),
                    sparse_io=True, device=dev)
    for _ in range(80):
        es.tick()
    it2 = max(10, iters // 2)
    up = fetch = 0
    t0 = time.perf_counter()
    for _ in range(it2):
        h = es.tick_begin()
        up += h["upload_bytes"]
        es.tick_finish(h)
        fetch += h["fetch_bytes"]
    dt_s = time.perf_counter() - t0

    return {
        "P": P,
        "iters": iters,
        "ms_per_step": 1000 * dt / iters,
        "ms_per_step_compute_only": 1000 * dt_c / iters,
        "steps_per_sec": iters / dt,
        "sparse_idle_ms_per_tick": 1000 * dt_s / it2,
        "sparse_idle_upload_bytes_per_tick": up // it2,
        "sparse_idle_fetch_bytes_per_tick": fetch // it2,
        "sparse_idle_k_out": es._k_out,
        "dense_upload_bytes_per_tick": int(in10.nbytes),
        "dense_fetch_bytes_per_tick": int(flat_np.size) * 4,
        "device": device_label(dev),
    }


def kernel_iters(P: int) -> int:
    """The packed-step mode's default iterations at P groups."""
    return max(10, 2_000_000 // P)


def run_kernel(sizes=KERNEL_SIZES, iters: int | None = None, device="cuda",
               xprof: str | None = None) -> list[dict]:
    """:func:`bench_kernel` at each size (``iters`` each, or
    :func:`kernel_iters`); one row per size."""
    return [bench_kernel(P, kernel_iters(P) if iters is None else iters, device, xprof)
            for P in sizes]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--partitions", type=int, default=None,
                      help=f"one size (default {PARTITIONS}; with --kernel, --sizes' default)")
    size.add_argument("--sizes", default=None,
                      help="comma-separated group counts, one row each (default with "
                           "--kernel: " + ",".join(map(str, KERNEL_SIZES)) + ")")
    ap.add_argument("--ticks", type=int, default=None,
                    help=f"timed rounds (default {TICKS}); with --kernel, iterations "
                         "(default max(10, 2000000 // P))")
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--window", type=int, default=1)
    ap.add_argument("--proposals", type=int, default=PROPOSALS_PER_TICK,
                    help="distinct groups offered one payload per round")
    ap.add_argument("--active-set", action="store_true")
    ap.add_argument("--active-frac", type=float, default=None)
    ap.add_argument("--device-route", action="store_true")
    ap.add_argument("--payload-ring", action="store_true")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--flight-wire", action="store_true")
    ap.add_argument("--kernel", action="store_true",
                    help="time the engine's packed device step alone (no cluster, no wire)")
    ap.add_argument("--xprof", default=None, metavar="DIR",
                    help="trace the timed loop with torch.profiler; a Chrome trace per "
                         "row goes into DIR")
    ap.add_argument("--out", default=None,
                    help="also write the rows to this file; without it nothing is written")
    args = ap.parse_args(argv)
    if args.sizes is not None:
        sizes = [int(x) for x in args.sizes.split(",")]
    elif args.partitions is not None:
        sizes = [args.partitions]
    else:
        sizes = list(KERNEL_SIZES) if args.kernel else [PARTITIONS]
    rows = []
    for P in sizes:
        if args.kernel:
            row = bench_kernel(P, kernel_iters(P) if args.ticks is None else args.ticks,
                               device=args.device, xprof=args.xprof)
        else:
            row = run(P, TICKS if args.ticks is None else args.ticks, args.warmup,
                      args.window, device=args.device, active_set=args.active_set,
                      active_frac=args.active_frac, device_route=args.device_route,
                      payload_ring=args.payload_ring, pipeline=args.pipeline,
                      flight_wire=args.flight_wire, proposals=args.proposals,
                      xprof=args.xprof)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"bench": "engine_packed_step" if args.kernel else "engine_host_bridge",
                       "device": device_label(resolve_device(args.device)),
                       "results": rows}, f, indent=1)


if __name__ == "__main__":
    main()
