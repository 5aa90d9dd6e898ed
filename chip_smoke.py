#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a result):

1. the card's name and power limit;
2. build the fused-window kernel from ``josefine_tpu_torch/ops/csrc`` with
   nvcc (timed); print ``ptxas -v``'s registers, spills and shared memory
   and the occupancy calculator's resident warps per SM for every group size
   the run uses;
3. parity on the card: the kernel against its plain PyTorch version on the
   same CUDA tensors, every state and inbox leaf and all five window totals
   exactly equal, over (4096, 5) and (4096, 3) with pre-vote on and off,
   partial membership with crashes and restarts, ``peer_fresh`` (1, 0, 1) at
   ``hb_ticks=32``, window chaining (2 x 10 ticks == 20 ticks), P that leave
   the last warp partly empty (1003 and 100,003 at N = 5), and N = 1, 4, 7
   and 16, the edges of the kernel's ``32 // N`` groups per warp;
4. the main path at full size: the headline benchmark
   (``josefine_tpu_torch.bench``, P = 100,000 groups of N = 5, 500-tick
   windows) with the launch count set to 0 just before and read just after.
   It must have launched the kernel, leave exactly one live leader per group
   and commit blocks. Then one more 500-tick window from the final state
   through the kernel and through the plain version: exact equality, the
   kernel's own time (CUDA events around the launch alone) and the whole
   wrapper call's, median of 3 each, the host time of building the launch's
   arguments, and the plain version's time. The kernel's bound counts the
   instructions of a compiled tick loop (``cuobjdump -sass``): pipe by pipe,
   the lesser of this kernel's count and the first kernel's. Last, the same
   window at other block shapes (``tile``): each must give the same result,
   with its residency, waves and time.
5. the consensus engine on the card (``josefine_tpu_torch.raft.engine``,
   dense packed IO; PyTorch ops only, no hand kernel). First, the engine's
   upload of its (10, 4096, 3) inbox (``hostio.host_to``, through pinned
   memory) must return while the stream still has ~100 ms of work queued;
   the same upload straight from pageable memory is timed beside it, and
   both once more on an idle card. 5a: a 3-engine in-process cluster on the
   card and the same cluster on the CPU, P = 512,
   40 single ticks then 30 adaptive window-4 ticks under a proposal drizzle,
   engine 2 partitioned for 10 of them and caught up by AppendEntries capped
   at 2 blocks: on every tick the encoded bytes of every outbound message,
   every host mirror and every device state leaf must be equal, and no card
   engine's ``tick_begin`` may wait for the device (CUDA's sync debug mode
   set to error around it). 5b: ``josefine_tpu_torch.bench_engine.run`` at P = 4096
   (40 warmup rounds, 20 timed): exactly one leader per group across the
   three engines, and blocks committed in the timed rounds. It prints ms per
   tick, committed blocks/s, commit latency, host ms per engine phase, and
   the window step's own time (CUDA events) and kernel count
   (``torch.profiler``). 5c: ``bench_engine --kernel`` (``run_kernel``) at
   1,000, 10,000 and 100,000 groups, 60 steps each: the engine's dense
   packed step alone with its upload and fetch and without them, the
   sparse bridge's idle floor (bytes per tick, ``k_out``) and the dense
   tick's bytes, every integer equal to the JAX package's run of the same
   mode (``KERNEL_JAX``), printed beside 5b's window step; then one
   ``--xprof`` trace of the 1,000-group loop, which must hold CUDA kernels.
6. the engine's scale path on the card (sparse packed IO and the active-set
   scheduler; PyTorch ops only, no hand kernel). 6a: a 3-engine cluster on
   the card and the same cluster on the CPU at P = 8192, 50 single ticks
   under a proposal drizzle, once with sparse IO and once with sparse IO
   plus the active set, every engine's compaction capacity set to 64 at the
   start: on every tick the encoded bytes of every outbound message, every
   host mirror, every state leaf and the scheduler's counts must be equal,
   and no card engine's ``tick_begin`` may wait for the device except the
   active set's counted refetch on re-entry after a fallback tick. The
   sparse run must overflow the capacity at least once (its shrinks are
   printed); the active run must show fallback ticks, compacted ticks and a
   refetch. 6b: ``tools/headline_latency``'s row at P = 100,000
   (``bench_engine.run``: sparse IO, the engines' default there; 256
   proposals per round; 40 warmup and 20 timed rounds, then the 20 drain
   rounds of the reference bench): its commit latency ``{n, p50, p99,
   sum}`` must equal the JAX tool's run of the same arguments on the CPU
   (``HEADLINE_LAT_JAX``). 6c: ``bench_engine.run`` with the active set and
   ``active_frac=0.01`` (1,000 proposals per round, 20 warmup rounds, as
   7b: enough for every group to elect at this size and load, and half
   of 5b's, to keep the script within its time limit). Each must leave
   exactly one leader per group and commit blocks in the timed rounds, and
   prints the numbers of 5b plus the active set's counts. Every
   ``bench_engine`` row now runs the 20 drain rounds; its timed numbers are
   taken before them.
7. device-resident delivery on the card (``raft/route.py``, the payload
   ring, leases; PyTorch ops only, no hand kernel). 7a: clusters on a
   ``RouteFabric`` (payload ring of 8 slots x 512 bytes), 80 single ticks,
   two payloads per proposal: dense IO at P = 4096 with AppendEntries capped
   at 2 blocks, engine 2 cut off for 10 ticks and leases on, then sparse IO
   and sparse IO plus the active set at P = 8192. On every tick a card
   cluster on a card fabric must equal a CPU cluster on a CPU fabric in
   everything: outbound bytes, mirrors, state leaves, chains, journal,
   routed counts, ready planes, pending rows, ring statistics and lease
   lanes. In the dense run a card cluster with no fabric must equal the
   routed one in state, mirrors and chains, its wire entries being the
   routed cluster's host entries plus its routed rows, and a card cluster
   with leases off must equal that one on the wire. Every route scatter
   must read the sender step's own device output, and no card engine's
   ``tick_begin`` may wait for the device. 7b: ``bench_engine.run`` at
   P = 100,000 (sparse IO, 1,000 proposals per round, 20 warmup and 20
   timed rounds) in the order A B C:
   A host delivery, B ``device_route``, C ``device_route`` and
   ``payload_ring``; each prints the numbers of 5b plus the routed/host
   split, the ring's statistics and the delivery barrier's host ms.

8. the raft runtime on the card (``raft/server.py``, ``JosefineRaft``; the
   TCP transport; PyTorch ops only, no hand kernel). 8a: three servers on
   the card and three on the CPU at P = 4096, the sockets replaced by the
   fixed-order hop of ``raft/lockstep.py`` on a virtual clock, one script
   (proposals through random nodes, most forwarded; group 0's leader stopped
   from tick 30): on every advance the wire (but for client request ids),
   mirrors, state leaves, chains and FSM applies must be equal, at window 1
   and at window 4 with pipelined ticks; no tick loop may crash, no server
   shut down on its own, no proposal fail. 8b:
   ``josefine_tpu_torch.bench_server.run``, three servers over loopback TCP,
   1,000 proposals per round through node 1 (7b's load), 10 warmup and 10
   timed rounds, at P = 100,000 (sparse IO) and P = 4096: one leader per
   group, every acknowledged proposal applied once on all three nodes in
   one order, nothing dropped;
   it prints ms per tick, committed proposals/s, commit latency in ticks and
   at the client in ms, host ms per engine phase, frames and bytes per tick,
   re-sent forwards, the servers' slowdown, the fullest send queue and the
   card's idle share, beside phases 5b, 6b and 7b.
9. the node on the card (``node.py``: the broker, the metadata and partition
   group FSMs, the segment logs, the Kafka surface; PyTorch ops only, no
   hand kernel). 9a: three port nodes on the card and three on the CPU, KV
   in memory, on the lockstep hop and virtual clock of
   ``josefine_tpu_torch/node_lockstep.py``, given one Kafka script through
   ``Broker.handle_request``: CreateTopics (replication factor 3), Produce
   with ``acks=-1`` to each partition's leader, the metadata leader stopped
   partway, Fetch from every live replica, Metadata, ListOffsets,
   FindCoordinator, OffsetCommit and OffsetFetch. On every advance the
   Kafka answers, the raft wire, every node's KV, partition logs, chains,
   mirrors and state leaves must be equal, at window 1 and at window 4 with pipelined
   ticks, and no card engine's ``tick_begin`` may wait for the device. 9b:
   ``josefine_tpu_torch.bench_node.run``, the shape of the OpenMessaging
   Benchmark's ``1-topic-100-partitions-1kb`` Kafka workload under its Kafka
   driver's replication factor 3 and ``acks=all``: three nodes started
   through ``josefine_with_config`` (wall clock, loopback TCP, durable logs,
   128 engine rows), one idempotent closed-loop producer, 10 batches of 16
   x 1 KB records per partition (half the bench's default, to keep the
   script within its time limit); every acknowledged batch must be read back
   from all three logs at its offset, byte for byte, none missing or
   duplicated, no error logged, one leader per partition. It prints
   acknowledged records/s and MB/s, produce and fetch latency at the client,
   each node's ms per tick, host ms per engine phase, raft frames and bytes
   per tick and the card's idle share.
10. chaos and traffic on the card (``chaos/``, ``workload/``; PyTorch ops
   only, no hand kernel). 10a: the wire soak (``run_wire_soak``, seed
   7, ``wire-leader-partition``, three nodes over loopback TCP), card
   against CPU on a quiet host: equal fate logs, wire event logs, journals
   and coverage, every acknowledged produce consumed back. Among the
   untimed checks, the chaos soak (``run_soak``, seed 7,
   ``leader-partition``, horizon 200: the JAX package's three CI chaos
   smokes, with ``flight_wire``; with the active set at 8 groups and
   ``hb_ticks=4``; with ``device_route``, ``payload_ring``, a quiet net, 4
   groups and 4 workload tenants at 2 produces per tick) with its engines on
   the card and on the CPU: every field of the two results equal (event
   log, journals, timeline, coverage, state digest, acked and proposed,
   health, route and active-set statistics, registry), invariants ok.
   Every card engine begins its ticks under sync debug "error" (only the
   active set's counted refetch may wait). 10b: the traffic driver
   (``TrafficEngine``, replication 3: the broker engine and two replicas,
   skew 1.1, 64 produces per tick, seed 7): at 100 tenants x 1,000
   partitions for 120 ticks the card and the CPU give the same workload
   trace and summary; then, alone again, ``tools/traffic_soak.py``'s
   documented ``--tenants 1000 --partitions 10000`` (P = 10,001, sparse IO)
   for 100 ticks (half the tool's 200, to keep the script within its time
   limit) and the ``TrafficEngine``'s drain: no error, every commit replicated
   and timed, one leader per claimed row; it prints the boot time, ms per
   tick, committed batches/s, commit latency in ticks, host ms per engine
   phase, the card's idle share over 5 traced ticks and the trace sha256.
11. the sharded programs on the card (``parallel/sharded.py``,
   ``RaftEngine(mesh=)``; PyTorch ops only, no hand kernel). The mesh takes
   8 distinct cards when the machine has them, else 8 shards of ``cuda:0``,
   and every line names it. 11a: the sharded cluster step on a (8, 1) mesh
   (N = 5) and a (2, 4) mesh (N = 4, the nodes of each group over 4 shards,
   delivery by the all_to_all over 'n') equals the unsharded
   ``cluster_step`` on the card every tick for 40 ticks at P = 8192; three
   engines on an 8-shard card mesh equal three on an 8-shard host mesh
   every tick for 40 ticks at P = 8192 (active set, a ``RouteFabric`` with
   the payload ring, engine 2 cut for 10 ticks), every card ``tick_begin``
   under sync debug "error", the per-shard wake split equal to the
   schedule; then the same twin with the card side's shards alternating
   ``cuda:0`` and ``cpu``, where a read of another shard's tensor mixes
   devices and raises. 11b: ``josefine_tpu_torch.bench_podsim`` at
   1,048,576 groups over 8 shards: the simulation (N = 5, 30 warmup and
   10 timed ticks; every group one leader and committed) and the engine
   row (cluster 1, active set, 1,000 tenants, Zipf 1.2, 2,048 offered per
   tick, ``hb_ticks=256``, window 8, 15 warmup and 20 timed rounds; every
   group elects, commits advance, the wake split sums to the schedule, no
   fallback round but at the heartbeat horizon). It prints init, settle
   and ms per tick, the wake fraction per shard, the committed advances
   and the state bytes per shard.
12. leader churn and the port's tools on the card (``bench_churn.py``,
   ``tools/``; PyTorch ops only, no hand kernel: the churn round needs a
   per-tick leader test, which the fused window does not return). 12a:
   ``bench_churn.churn_round`` on the card and on the CPU at P = 4096 x 5,
   seed 0, 60 warmup ticks then 2 rounds: every partition's convergence
   tick and every state and inbox leaf equal after each round. 12b:
   ``josefine_tpu_torch.bench_churn`` at BASELINE config 4's spec, not cut
   (P = 100,000 x 5, 100 warmup ticks, 20 rounds of 64 ticks, 50
   post-churn ticks): 0 unconverged, 100,000 single-leader partitions,
   commits advancing, then every integer of the result (p50, p90, p99,
   p99.9, mean, unconverged, single-leader partitions, post-churn commits
   and the digest of all 2,000,000 convergence ticks) equal to the JAX
   package's own run of the same spec (``CHURN_JAX``); it prints the churn
   wall time and ms per churn tick. 12c: the port's CLIs as processes of
   their own, each required to exit 0: ``chaos_soak`` (seed 7,
   ``leader-partition``, horizon 200, ``--flight-wire``) on the card and
   on the CPU with results equal in every field, ``podsim_smoke`` (8
   shards of ``cuda:0``) and ``obs_smoke``, which run beside the untimed
   checks to keep the script within its time limit; then ``wire_load`` in
   lockstep (16
   connections, 4 tenants, 4 partitions, ``--smoke``) on the card and on
   the CPU, the two alone on the host, with byte-equal artifacts.
13. the port's last entry points on the card. 13a, alone on the card:
   ``python -m josefine_tpu_torch.bench_tune --device cuda --out <tmp>``,
   the fused-window kernel's operating-point sweep at the headline shape
   (stage 1: 500-, 1,000- and 2,000-tick windows at tile 24; stage 2: tiles
   6, 12, 18, 30, 36 and 48 at the stage-1 winner; the winner again with 2
   dependent reps): every point's state after each window equal to the
   stage-1 point's with the same window length (sha256 of every leaf and
   the totals), accepted messages in every point, every line tagged with
   the card's name and power limit; it prints each point's rate and kernel
   time and the winner, and its launches join the kernel's count. 13b and
   13c run beside the untimed checks: the single-node and then the multi-node example (their shipped
   TOMLs, data moved to a work directory) as a process, each with the
   client demo against node 1: CreateTopics and Produce error 0, Fetch's
   high watermark at least 1 with the records ending in ``hello, tpu``,
   exit 0 on SIGINT; and ``debug_parole_election --device cuda`` and
   ``repro_chaos --device cuda 11`` (``compact=True``), each exiting 0.

Order: the untimed checks of phases 5 to 12 (5a, 6a, 7a, 8a, 9a, 10a's
chaos smokes, 10b's twin, 11a and 12a; ``CHECKS``) run side by side, each in
a process of its own with one PyTorch host thread, together with 12c's first
CLIs, 13b, 13c and 10b's boot (in a process of its own that then waits),
while phases 2 and 3 run; each check's output is printed when it ends, with
its seconds. Every timed part (4, 5b, 5c, 6b, 6c, 7b, 8b, 9b, 10a's wire
soak, 10b's ticks, 11b, 12b, 12c's ``wire_load``, 13a) then runs alone, in
phase order. Each phase prints the seconds since the start when it ends.
The line before the last is a JSON object describing each kernel (launches,
error, times, bound); the last line is the JSON device record.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

# Peak rates of one H100 SXM at its 1.98 GHz boost clock, per SM and cycle:
# 64 lanes of the integer ALU pipe (half the 128 FP32 lanes behind the data
# sheet's 67 TFLOP/s), 64 lanes of the pipe that runs IMAD, and 4 warp
# instructions issued (128 thread instructions).
SMS, CLOCK_HZ = 132, 1.98e9
ALU_LANES, IMAD_LANES, ISSUE_LANES = 64, 64, 128
HBM_BYTES_PER_S = 3.35e12

# Per node-tick on the shortest path through the tick loop at N = 5, counted
# by tick_loop_sass on the first kernel (one thread per node, delivery
# through the block with two block barriers per tick, 195 registers; run on
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, section 6). The bound takes, pipe
# by pipe, the lesser of this and the count of the kernel under test: the
# least work any version has needed for the same window. It moves only when a
# version needs less work than every one before it, and never above either.
FIRST_KERNEL_PATH = {"alu": 1025, "imad": 108, "issued": 1282}
# The group sizes phase 3 runs, and the block shapes (groups per block)
# phase 4 compares at N = 5: 1 to 8 warps of 6 groups.
RUN_SIZES = (1, 3, 4, 5, 7, 16)
TILES = (6, 12, 18, 24, 30, 36, 48)

# SASS opcodes by where they run. Memory, control, moves, conversions and the
# special-function unit are off the integer ALU pipe; uniform-datapath
# opcodes (U...) run once per warp. Every instruction takes an issue slot.
_NOT_ALU = {"LDS", "STS", "LDG", "STG", "LDL", "STL", "LD", "ST", "LDC", "ATOMS", "ATOMG",
            "ATOM", "RED", "BRA", "BAR", "BSSY", "BSYNC", "WARPSYNC", "EXIT", "NOP", "YIELD",
            "CALL", "RET", "BREAK", "DEPBAR", "S2R", "CS2R", "MOV", "SHFL", "MUFU", "I2F",
            "F2I", "I2I", "F2F"}
_IMAD = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD"}
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\(?(\.L_x_\d+)\)?|0x([0-9a-f]+)")


def tick_loop_sass(so_path: str, n: int) -> dict:
    """Per-thread instruction counts of one tick of ``fused_window_kernel<n>``,
    read from the SASS that ``cuobjdump`` prints for the built library.

    The tick loop is the largest backward branch whose body stores to
    shared memory: the delivery, which every tick makes. A kernel that
    delivers through the block holds two block barriers per tick (2k for a
    loop unrolled to k ticks). One that delivers within the warp holds no
    barrier instruction (nvcc makes its ``__syncwarp`` a NOP where the warp
    has reconverged) and keeps one tick per body (``#pragma unroll 1``).
    Inside the loop, the outermost forward branches are the kernel's
    ``active`` guards, which every thread of a full warp passes; the forward
    branches nested in them skip data-dependent parts of the tick body.
    ``issued``, ``alu`` and ``imad`` count the shortest path, with every such
    part skipped, so they are at most what any tick runs; ``issued_all`` and
    ``alu_all`` count every instruction of the body, what a warp whose
    threads take every part between them runs."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    sym = f"fused_window_kernelILi{n}EE"
    body = next(part for part in sass.split("Function : ")[1:]
                if sym in part.split("\n", 1)[0])
    instrs, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSTR.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        text = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2))
        instrs.append((addr, text.split()[0].split(".")[0], text))

    def target(text):
        t = _TARGET.search(text.split(None, 1)[1])
        return labels[t.group(1)] if t.group(1) else int(t.group(2), 16)

    branches = [(addr, target(text)) for addr, op, text in instrs if op == "BRA"]
    best = None
    for head, tail in ((t, a) for a, t in branches if t <= a):
        loop = [x for x in instrs if head <= x[0] <= tail]
        if not any(op == "STS" for _, op, _ in loop):
            continue
        fwd = [(a, t) for a, t in branches if head <= a < t <= tail]
        nested = [(a, t) for a, t in fwd
                  if any(a2 < a and t <= t2 for a2, t2 in fwd if (a2, t2) != (a, t))]
        path = [x for x in loop if not any(a < x[0] < t for a, t in nested)]
        bars = sum(op == "BAR" for _, op, _ in loop)
        k = bars / 2 if bars else 1.0
        per_tick = {
            "ticks_per_body": k,
            "issued": len(path) / k,
            "alu": sum(o not in _NOT_ALU and o not in _IMAD and not o.startswith("U")
                       for _, o, _ in path) / k,
            "imad": sum(o in _IMAD for _, o, _ in path) / k,
            "issued_all": len(loop) / k,
            "alu_all": sum(o not in _NOT_ALU and o not in _IMAD and not o.startswith("U")
                           for _, o, _ in loop) / k,
            "skippable_parts": len(nested),
        }
        if best is None or per_tick["issued_all"] > best["issued_all"]:
            best = per_tick
    if best is None:
        raise AssertionError(f"no tick loop found in the SASS of fused_window_kernel<{n}>")
    return best


class _ListFsm:
    def __init__(self):
        self.applied = []

    def transition(self, data):
        self.applied.append(bytes(data))
        return b""


def _sched(e) -> tuple:
    """The sparse capacity and the active-set scheduler's state and counts."""
    return (e._k_out, e._k_out_quiet, e.active_sched_ticks, e.active_sched_rows,
            e.active_fallback_ticks, e.active_refetches, e._timers_stale,
            sorted(e._force_active))


def _entries(outbound) -> int:
    """Consensus entries in a tick's outbound: a batch counts its entries,
    a keepalive ping none."""
    from josefine_tpu_torch.raft import rpc

    return sum(len(m) if isinstance(m, rpc.MsgBatch) else int(m.kind != rpc.MSG_PING)
               for m in outbound)


def _fabric_view(fab) -> dict:
    """What routing decided on one side, comparable across devices: the
    fabric's counters, pending rows, ring statistics and ready kind mirrors
    and planes."""
    import numpy as np

    arr = lambda a: np.asarray(a.cpu() if hasattr(a, "cpu") else a).tobytes()
    return {"routed_total": fab.routed_total, "pending": fab.pending_counts(),
            "ring_stats": fab.ring_stats(),
            "ready_kinds": {s: arr(k) for s, k in sorted(fab._ready_kinds.items())},
            "ready": {s: arr(p) for s, p in sorted(fab._ready.items())}}


def _on_card(e) -> bool:
    """A card engine: its state is on the card, every shard of it on a mesh
    (a mesh with host shards copies between the host and the card, and such
    a copy waits by nature)."""
    if e._mesh is not None:
        return all(d.type == "cuda" for d in e._shard_devs)
    return e._device.type == "cuda"


def _picked(only, names) -> tuple:
    """The runs of ``names`` that ``only`` names (all when None); a name
    that is not among them raises."""
    if only is None:
        return tuple(names)
    unknown = sorted(set(only) - set(names))
    if unknown:
        raise ValueError(f"no run named {unknown}; the runs are {list(names)}")
    return tuple(only)


class _StrictCardTicks:
    """While active, every card engine's ``tick_begin`` (:func:`_on_card`)
    runs under CUDA's sync debug mode set to error, so a host wait inside it
    raises, but for the active set's counted refetch
    (``_refetch_wake_inputs``). Patched on the class, so it reaches engines
    the harnesses build and rebuild themselves (restarts, nodes, replicas).
    Counts the card ticks begun."""

    def __enter__(self):
        import torch

        from josefine_tpu_torch.raft.engine import RaftEngine

        self.begun = 0
        self._saved = (RaftEngine.tick_begin, RaftEngine._refetch_wake_inputs)
        begin, refetch = self._saved
        outer = self

        def strict_begin(e, *args, **kw):
            if not _on_card(e):
                return begin(e, *args, **kw)
            outer.begun += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return begin(e, *args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        def counted_refetch(e, *args, **kw):
            if not _on_card(e):
                return refetch(e, *args, **kw)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("default")
            try:
                return refetch(e, *args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        RaftEngine.tick_begin = strict_begin
        RaftEngine._refetch_wake_inputs = counted_refetch
        return self

    def __exit__(self, *exc):
        from josefine_tpu_torch.raft.engine import RaftEngine

        RaftEngine.tick_begin, RaftEngine._refetch_wake_inputs = self._saved
        return False


def _run_sides(P: int, ticks: int, seed: int, sides, window=lambda t: 1,
               cut=lambda t: (), setup=None, on_tick=None, params_kw=None, bursts=1,
               pipelined=False):
    """Clusters of 3 engines fed the same traffic for ``ticks`` split-phase
    rounds (``tick_pipelined`` rounds with ``pipelined``, drained and
    compared once more at the end): from tick 20, every second tick,
    ``bursts`` payloads each for group 0 and 16 random groups, to whichever
    engine leads; messages are delivered unless an end is in ``cut(t)``.

    ``sides`` lists ``(device, engine options, RouteFabric options or None,
    relation)``; a side with fabric options registers its engines on a
    fabric of its own (its link filter follows ``cut``), flushed after each
    round's delivery. ``relation`` is None for side 0, else ``(kind, i)``:
    on every tick this side's host mirrors, state leaves, chains and
    scheduler (:func:`_sched`) must equal side ``i``'s, and besides, by
    kind: ``"exact"`` — every outbound message's bytes, the journal, the
    routed counts, the fabric (:func:`_fabric_view`) and the lease lane and
    plane; ``"wire"`` — the outbound bytes and the journal; ``"host_only"``
    (this side has no fabric, side ``i`` does) — each engine's consensus
    entries equal side ``i``'s host entries plus its routed rows. A card
    engine's ``tick_begin`` runs under CUDA's sync debug mode set to error,
    so a host wait inside it raises, except the active set's counted
    refetch (:class:`_StrictCardTicks`). On every fabric the route
    scatter's source must be the sender step's own output, on the fabric's
    device.
    ``setup(engine)`` runs on every engine before the first tick,
    ``on_tick(t, side-0 engines)`` after every tick. Group 0's FSMs must
    apply the same non-empty sequence on every side. Returns the sides as
    ``(engines, fabric)``, side 0's group-0 applies, the messages compared
    and the checks of the scatter source."""
    import asyncio

    import numpy as np

    from josefine_tpu_torch import interop
    from josefine_tpu_torch.models.types import step_params
    from josefine_tpu_torch.raft.engine import RaftEngine
    from josefine_tpu_torch.raft.route import RouteFabric
    from josefine_tpu_torch.utils.kv import MemKV

    pkw = params_kw or dict(timeout_min=3, timeout_max=8, hb_ticks=16)
    now = [0]
    src_checks = [0]

    def cluster(device, engine_kw, fabric_kw):
        fsms = [_ListFsm() for _ in range(3)]
        engines = [RaftEngine(MemKV(), [1, 2, 3], i + 1, groups=P, fsms={0: fsms[i]},
                              params=step_params(**pkw, device=device),
                              base_seed=i, device=device, **engine_kw)
                   for i in range(3)]
        fab = None
        if fabric_kw is not None:
            fab = RouteFabric(link_filter=lambda s, d: not ({s, d} & set(cut(now[0]))),
                              **fabric_kw)
            for e in engines:
                fab.register(e)
            check_source(fab)
        return engines, fsms, fab

    def check_source(fab):
        inner = fab._src_ov

        def src_ov(h):
            src = inner(h)
            own = h["ov"]
            if not (src.device == fab.device and src.untyped_storage().data_ptr()
                    == own.untyped_storage().data_ptr()):
                raise AssertionError("route parity: the scatter source is not the "
                                     "sender step's device output")
            src_checks[0] += 1
            return src

        fab._src_ov = src_ov

    def mirrors(e):
        return {k: v for k, v in vars(e).items()
                if k.startswith("_h_") and isinstance(v, np.ndarray)}

    def lane(e):
        plane = e._lease_plane
        return e.lease_summary(), None if plane is None else np.asarray(
            plane.cpu() if hasattr(plane, "cpu") else plane).tolist()

    def check(t, kind, a, b, res_a, res_b, routed_a):
        (ea_all, _, fab_a), (eb_all, _, fab_b) = a, b
        for i, (ea, eb, ra, rb) in enumerate(zip(ea_all, eb_all, res_a, res_b)):
            w = f"tick {t} engine {i}"
            ma, mb = mirrors(ea), mirrors(eb)
            for k in ma:
                if not np.array_equal(ma[k], mb[k]):
                    raise AssertionError(f"{kind} parity: {w}: {k} differs")
            if _sched(ea) != _sched(eb):
                raise AssertionError(f"{kind} parity: {w}: scheduler {_sched(ea)} != "
                                     f"{_sched(eb)}")
            for j, (x, y) in enumerate(zip(interop.state_to_numpy(ea.state),
                                           interop.state_to_numpy(eb.state))):
                if not np.array_equal(x, y):
                    raise AssertionError(f"{kind} parity: {w}: state leaf {j} differs")
            if [(c.head, c.committed) for c in ea.chains] != \
                    [(c.head, c.committed) for c in eb.chains]:
                raise AssertionError(f"{kind} parity: {w}: chains differ")
            if kind in ("exact", "wire"):
                if [m.encode() for m in ra.outbound] != [m.encode() for m in rb.outbound]:
                    raise AssertionError(f"{kind} parity: {w}: outbound differs")
                if ea.flight.events() != eb.flight.events():
                    raise AssertionError(f"{kind} parity: {w}: journal differs")
            if kind == "exact":
                if (ea.routed_msgs, ea._route_dirty, lane(ea)) != \
                        (eb.routed_msgs, eb._route_dirty, lane(eb)):
                    raise AssertionError(f"exact parity: {w}: routed counts or lease "
                                         "lane differ")
            if kind == "host_only" and _entries(rb.outbound) != \
                    _entries(ra.outbound) + routed_a[i]:
                raise AssertionError(f"routed == host-only: {w}: entries not conserved")
        if kind == "exact" and fab_a is not None and \
                _fabric_view(fab_a) != _fabric_view(fab_b):
            raise AssertionError(f"exact parity: tick {t}: the fabrics differ")

    async def run():
        built = [cluster(dev, kw, fkw) for dev, kw, fkw, _ in sides]
        if setup is not None:
            for engines, _, _ in built:
                for e in engines:
                    setup(e)
        rng = np.random.default_rng(seed)
        sent = 0
        for t in range(ticks):
            now[0] = t
            before = [[e.routed_msgs for e in engines] for engines, _, _ in built]
            results = []
            for engines, _, _ in built:
                if pipelined:
                    results.append([e.tick_pipelined(e.suggest_window(window(t)))
                                    for e in engines])
                    continue
                hs = [e.tick_begin(e.suggest_window(window(t))) for e in engines]
                results.append([e.tick_finish(h) for e, h in zip(engines, hs)])
            sent += sum(len(r.outbound) for r in results[0])
            for (engines, _, fab), res in zip(built, results):
                for r in res:
                    for m in r.outbound:
                        if m.src not in cut(t) and m.dst not in cut(t):
                            engines[m.dst].receive(m)
                if fab is not None:
                    fab.flush()
            for j, (_, _, _, rel) in enumerate(sides):
                if rel is not None:
                    kind, i = rel
                    routed = [e.routed_msgs - b for e, b in zip(built[i][0], before[i])]
                    check(t, kind, built[i], built[j], results[i], results[j], routed)
            if on_tick is not None:
                on_tick(t, built[0][0])
            if t >= 20 and t % 2 == 0:
                for g in sorted(set(rng.integers(0, P, 16).tolist()) | {0}):
                    lead = next((i for i, e in enumerate(built[0][0])
                                 if e.is_leader(g) and e.me not in cut(t)), None)
                    if lead is None:
                        continue
                    for engines, _, _ in built:
                        for k in range(bursts):
                            engines[lead].propose(g, b"t%d-g%d-%d" % (t, g, k)
                                                  ).add_done_callback(_retrieve)
        if pipelined:
            drained = [[e.tick_drain() for e in engines] for engines, _, _ in built]
            sent += sum(len(r.outbound) for r in drained[0])
            for j, (_, _, _, rel) in enumerate(sides):
                if rel is not None:
                    kind, i = rel
                    check(ticks, kind, built[i], built[j], drained[i], drained[j], [0] * 3)
        applied = [[f.applied for f in fsms] for _, fsms, _ in built]
        if any(a != applied[0] for a in applied) or not applied[0][0]:
            raise AssertionError("engine parity: group 0's FSMs differ or applied nothing")
        return [(engines, fab) for engines, _, fab in built], applied[0], sent, src_checks[0]

    with _StrictCardTicks():
        return asyncio.run(run())


def _twin_run(dev, P: int, ticks: int, seed: int, window=lambda t: 1, cut=lambda t: (),
              setup=None, on_tick=None, pipelined=False, **engine_kw):
    """The same 3-engine cluster on the card (``dev``) and on the CPU
    (:func:`_run_sides`, relation ``"exact"``). Returns the card engines,
    their group-0 FSMs' applies and the number of messages compared."""
    sides, applied, sent, _ = _run_sides(
        P, ticks, seed, [(dev, engine_kw, None, None), ("cpu", engine_kw, None, ("exact", 0))],
        window=window, cut=cut, setup=setup, on_tick=on_tick, pipelined=pipelined)
    return sides[0][0], applied, sent


def engine_parity(dev, P: int = 512) -> None:
    """Phase 5a: the twin clusters (:func:`_twin_run`) with dense IO, 40
    single ticks then 30 adaptive window-4 ticks, engine 2 cut off for ticks
    45-54. AppendEntries carry at most 2 blocks, so the partitioned engine
    catches up through capped frames and send-pointer fixups."""
    fixups = [0]

    def count_fixups(t, engines):
        fixups[0] += sum(bool(e._nxt_fixups) for e in engines)

    card, applied, sent = _twin_run(
        dev, P, 70, seed=11, window=lambda t: 1 if t < 40 else 4,
        cut=lambda t: (2,) if 45 <= t < 55 else (), on_tick=count_fixups,
        max_append_entries=2)
    if not fixups[0]:
        raise AssertionError("engine parity: no capped catch-up re-rooted a send pointer")
    leaders = sum(int((e._h_role == 2).sum()) for e in card)
    print(f"engine parity ok: P={P}, 3 engines on the card == 3 on the CPU for 70 "
          f"ticks (40 single, 30 adaptive window 4, engine 2 cut for 10): {sent} "
          f"outbound messages byte-equal, every mirror and state leaf equal; "
          f"{len(applied[0])} blocks applied on group 0, {leaders} leaders, "
          f"send-pointer fixups on {fixups[0]} engine-ticks, no host wait in any "
          f"card tick_begin", flush=True)


def upload_no_wait(dev, card: str, P: int = 4096) -> None:
    """Phase 5: the host ms of three uploads of the engine's (10, P, 3)
    inbox, made while the stream is still busy with a spin kernel queued just
    before them; through ``host_to`` (pinned staging) they must return in
    under a fifth of the spin. From pageable memory they are timed only.
    Beside each, the host ms of one upload on an idle card (median of 21):
    what the pinned staging costs a tick."""
    import numpy as np
    import torch

    from josefine_tpu_torch.raft.hostio import host_to

    a = np.arange(10 * P * 3, dtype=np.int32).reshape(10, P, 3)
    ways = {"host_to": lambda: host_to(a, dev),
            "pageable": lambda: torch.from_numpy(a).to(dev, non_blocking=True)}
    spin = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    busy, spin_ms, idle = {}, {}, {}
    for name, up in ways.items():
        times = []
        for _ in range(21):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            up()
            times.append((time.perf_counter() - t0) * 1e3)
        idle[name] = sorted(times)[10]
        torch.cuda.synchronize(dev)
        spin[0].record()
        torch.cuda._sleep(200_000_000)  # ~100 ms at the card's clock
        spin[1].record()
        t0 = time.perf_counter()
        got = [up() for _ in range(3)]
        busy[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize(dev)
        spin_ms[name] = spin[0].elapsed_time(spin[1])
        if any(not np.array_equal(g.cpu().numpy(), a) for g in got):
            raise AssertionError(f"upload through {name} changed the bytes")
    print(f"inbox upload (10, {P}, 3) int32 x 3 behind a queued spin of "
          f"{spin_ms['host_to']:.1f} ms: host_to returns in {busy['host_to']:.3f} ms of host "
          f"time; from pageable memory {busy['pageable']:.3f} ms (behind "
          f"{spin_ms['pageable']:.1f} ms). One upload on an idle card: host_to "
          f"{idle['host_to']:.3f} ms, pageable {idle['pageable']:.3f} ms (median of 21) "
          f"[{card}]", flush=True)
    if busy["host_to"] > spin_ms["host_to"] / 5:
        raise AssertionError(f"host_to waited for the queued work: {busy}, spin {spin_ms}")


def _retrieve(fut):
    fut.cancelled() or fut.exception()


def engine_parity_scale(dev, P: int = 8192, ticks: int = 50) -> None:
    """Phase 6a: the twin clusters (:func:`_twin_run`) at the sparse-IO
    scale, single ticks, once with sparse IO and once with sparse IO plus
    the active set. Every engine's compaction capacity starts at 64, so the
    cold-start election burst overflows it and it regrows x8 up to P."""
    for active in (False, True):
        k_out = []

        def track(t, engines):
            if t == 0:  # the capacity each engine started this run with
                k_out.append([64] * len(engines))
            k_out.append([e._k_out for e in engines])

        def small_capacity(e):
            e._k_out = 64

        t0 = time.perf_counter()
        card, applied, sent = _twin_run(dev, P, ticks, seed=13, on_tick=track,
                                        sparse_io=True, active_set=active,
                                        setup=small_capacity)
        seconds = time.perf_counter() - t0
        steps = list(zip(k_out, k_out[1:]))
        overflows = sum(b > a for ka, kb in steps for a, b in zip(ka, kb))
        shrinks = sum(b < a for ka, kb in steps for a, b in zip(ka, kb))
        if not overflows:
            raise AssertionError("scale parity: the compaction capacity never overflowed")
        leaders = sum(int((e._h_role == 2).sum()) for e in card)
        what = "sparse IO + active set" if active else "sparse IO"
        line = (f"scale parity ok ({what}): P={P}, 3 engines on the card == 3 on the CPU "
                f"for {ticks} ticks: {sent} outbound messages byte-equal, every mirror, "
                f"state leaf and scheduler count equal; {len(applied[0])} blocks applied "
                f"on group 0, {leaders} leaders; capacity 64 -> {[e._k_out for e in card]}, "
                f"{overflows} overflow and {shrinks} shrink engine-ticks")
        if active:
            compacted = sum(e.active_sched_ticks for e in card)
            fallback = sum(e.active_fallback_ticks for e in card)
            refetches = sum(e.active_refetches for e in card)
            if not (compacted and fallback and refetches):
                raise AssertionError(f"scale parity: compacted {compacted}, fallback "
                                     f"{fallback}, refetches {refetches}")
            line += (f"; {compacted} compacted and {fallback} fallback engine-ticks, "
                     f"{refetches} refetches (the only host waits in any card tick_begin)")
        else:
            line += "; no host wait in any card tick_begin"
        line += _graph_counts(card, required=not active)
        if active:
            line += _graph_counts(card, required=True, kind="compacted")
        print(f"{line}; {seconds:.1f} s", flush=True)


def _graph_counts(card, required: bool, kind: str = "sparse") -> str:
    """The card engines' sparse dispatches (``kind`` "sparse") or compacted
    active-set ticks ("compacted") by kind (``raft/step_runner.py``'s graph
    cache), for a check's line; with ``required`` at least one must have
    been captured and one replayed on a card. Engines on the host replay
    nothing."""
    graphs = [e._runner.graphs.counts[kind] for e in card if e._runner.graphs is not None]
    if not graphs:
        return f"; no {kind} graphs (host engines)"
    eager, captures, replays = (sum(getattr(g, k) for g in graphs)
                                for k in ("eager", "captures", "replays"))
    if required and not (captures and replays):
        raise AssertionError(f"no {kind} graph replayed: {eager} eager, {captures} "
                             f"captures, {replays} replays")
    return (f"; {kind} graphs: {captures} captures, {replays} replays, {eager} eager "
            f"dispatches")


def _active_graph_totals() -> tuple:
    """The process's compacted active-set ticks so far, summed over the
    nodes: (eager, captured, replayed) (``raft/step_runner.py``'s counters)."""
    from josefine_tpu_torch.raft import step_runner  # noqa: F401 (registers the counters)
    from josefine_tpu_torch.utils.metrics import REGISTRY

    return tuple(sum(REGISTRY._metrics[f"raft_active_graph_{k}_total"].values.values())
                 for k in ("eager", "captures", "replays"))


def engine_parity_pipelined(dev, P: int = 8192, ticks: int = 160) -> None:
    """Phase 6a, pipelined: the twin clusters (:func:`_twin_run`) with
    sparse IO in ``tick_pipelined`` rounds at window 4 (1 while an engine
    has a leaderless group), exact against the CPU every tick and after the
    drain. On the card the sparse step replays from captured graphs, which
    must begin tick n+1 before tick n's finish reads its outputs."""
    windows = []
    t0 = time.perf_counter()
    card, applied, sent = _twin_run(
        dev, P, ticks, seed=13, window=lambda t: 4, pipelined=True, sparse_io=True,
        on_tick=lambda t, engines: windows.append(max(e.pipeline_window for e in engines)))
    seconds = time.perf_counter() - t0
    wide = sum(w == 4 for w in windows)
    if not wide:
        raise AssertionError("pipelined parity: no window-4 dispatch")
    leaders = sum(int((e._h_role == 2).sum()) for e in card)
    print(f"pipelined parity ok: P={P}, 3 sparse-IO engines on the card == 3 on the CPU for "
          f"{ticks} pipelined ticks ({wide} of them at window 4) and the drain: {sent} "
          f"outbound messages byte-equal, every mirror and state leaf equal; "
          f"{len(applied[0])} blocks applied on group 0, {leaders} leaders"
          f"{_graph_counts(card, required=True)}; {seconds:.1f} s", flush=True)


def route_parity(dev, P_dense: int = 4096, P_scale: int = 8192, ticks: int = 80,
                 only=None) -> None:
    """Phase 7a: device-resident delivery (``raft/route.py``, the payload
    ring on: 8 slots of 512 bytes) through :func:`_run_sides`, two payloads
    per proposal so AppendEntries carry spans of several blocks.

    Dense IO at ``P_dense``, AppendEntries capped at 2 blocks and engine 2
    cut off for ticks 45-54 (capped catch-up routed from the ring), with
    leases on (hence ``hb_ticks=1``, ``timeout_min=4``): the card cluster on
    a card fabric against the CPU cluster on a CPU fabric (exact), a card
    cluster with no fabric against the routed one (routed == host-only),
    and a card cluster with no fabric and leases off against that one
    (leases-on == leases-off on the wire). Then sparse IO, and sparse IO
    with the active set, at ``P_scale`` (card fabric against CPU fabric).
    ``only`` names the runs to make (all when None)."""
    ring = dict(payload_ring=True, ring_slots=8, ring_bytes=512)
    capped = dict(max_append_entries=2)
    runs = [
        ("dense, leases", P_dense, dict(
            sides=[(dev, dict(capped, leases=True), ring, None),
                   ("cpu", dict(capped, leases=True), ring, ("exact", 0)),
                   (dev, dict(capped, leases=True), None, ("host_only", 0)),
                   (dev, capped, None, ("wire", 2))],
            params_kw=dict(timeout_min=4, timeout_max=8, hb_ticks=1),
            cut=lambda t: (2,) if 45 <= t < 55 else ())),
        ("sparse", P_scale, dict(sides=[(dev, dict(sparse_io=True), ring, None),
                                        ("cpu", dict(sparse_io=True), ring, ("exact", 0))])),
        ("sparse + active set", P_scale, dict(
            sides=[(dev, dict(sparse_io=True, active_set=True), ring, None),
                   ("cpu", dict(sparse_io=True, active_set=True), ring, ("exact", 0))])),
    ]
    picked = _picked(only, [r[0] for r in runs])
    for what, P, kw in runs:
        if what not in picked:
            continue
        t0 = time.perf_counter()
        sides, applied, sent, src_checks = _run_sides(P, ticks, seed=17, bursts=2, **kw)
        seconds = time.perf_counter() - t0
        card, fab = sides[0]
        ring_stats = fab.ring_stats()
        if not (fab.routed_total and ring_stats["payload_aes_routed"] and src_checks):
            raise AssertionError(f"route parity ({what}): routed {fab.routed_total}, ring "
                                 f"{ring_stats}, source checks {src_checks}")
        line = (f"route parity ok ({what}): P={P}, 3 engines on a card fabric == 3 on a "
                f"CPU fabric for {ticks} ticks: {sent} outbound messages byte-equal, every "
                f"mirror, state leaf, journal, routed count and fabric plane equal; "
                f"{fab.routed_total} rows routed on the card ({src_checks} scatters "
                f"checked to read the step's device output), ring {ring_stats}; "
                f"{len(applied[0])} blocks applied on group 0")
        if len(sides) > 2:
            leases = [e.lease_summary() for e in card]
            if not all(s["credits"] for s in leases):
                raise AssertionError(f"route parity: a lease lane earned no credit: {leases}")
            line += (f"; the routed cluster == a host-only one (state, mirrors, chains, "
                     f"entries conserved) and leases on == leases off on the wire, lease "
                     f"lanes {leases}")
        if "active" in what:
            line += (f"; {sum(e.active_sched_ticks for e in card)} compacted, "
                     f"{sum(e.active_fallback_ticks for e in card)} fallback engine-ticks")
        print(f"{line}; no host wait in any card tick_begin but the counted refetches; "
              f"{seconds:.1f} s", flush=True)


def route_bench(card: str, P: int = 100_000) -> list[tuple[str, dict]]:
    """Phase 7b: ``bench_engine.run`` at P = 100,000 (sparse IO), 1,000
    proposals per round (``active_frac=0.01``), 20 warmup and 20 timed
    rounds, in the order A B C (one pass, not a mirrored A B C C B A, and
    half the other rows' warmup, to keep the script within its time limit;
    some of the 100,000 groups have no leader yet after 30 rounds, whether
    10 warmup and 20 timed or 20 warmup and 10 timed):
    A the host path, B
    ``device_route``,
    C ``device_route`` with ``payload_ring``. Each must leave one leader per
    group and commit blocks; B and C must route. Returns the rows by name,
    in run order."""
    modes = {"A host": {}, "B route": dict(device_route=True),
             "C route+ring": dict(device_route=True, payload_ring=True)}
    rows = []
    for name in ("A host", "B route", "C route+ring"):
        row = engine_bench(card, P=P, warmup=20, active_frac=0.01, **modes[name])
        rows.append((name, row))
        stats = row.get("device_route_stats")
        if stats is not None and not stats["routed_msgs"]:
            raise AssertionError(f"route bench {name}: nothing routed")
        busy = row["device_busy"]
        print(f"route bench {name}: {row['ms_per_tick']:.3f} ms/tick, "
              f"{row['committed_blocks_per_sec']:.6g} blocks/s, commit latency p50 "
              f"{row['commit_latency_ticks']['p50']} p99 {row['commit_latency_ticks']['p99']}, "
              f"idle share {busy['idle_share']:.3f}, {busy['device_ops'] / busy['rounds']:.0f} "
              f"device ops per round, step launches "
              f"{row['window_step']['1']['launch_calls']}; route stats "
              f"{json.dumps(stats)} [{card}]", flush=True)
    return rows


def _server_side(dev, pacer, P: int, **cfg_extra):
    """Three port servers on ``dev`` for the lockstep script: their sockets
    replaced by a hop, a recording FSM on every group."""
    from josefine_tpu_torch.config import NodeAddr, RaftConfig
    from josefine_tpu_torch.raft import lockstep, rpc
    from josefine_tpu_torch.raft.server import JosefineRaft
    from josefine_tpu_torch.utils.kv import MemKV
    from josefine_tpu_torch.utils.net import bound_sockets

    socks, ports = bound_sockets(3)
    hop = lockstep.Hop(rpc.decode_frame)
    cfgs = lockstep.mesh_configs(ports, RaftConfig, NodeAddr, **cfg_extra)
    fsms = [{g: _ListFsm() for g in range(P)} for _ in cfgs]
    servers = [JosefineRaft(cfg, MemKV(), f, groups=P, pacer=pacer,
                            intercept_send=hop.intercept(cfg.id), sock=sock, device=dev)
               for cfg, sock, f in zip(cfgs, socks, fsms)]
    return lockstep.Side(servers, hop, fsms)


def server_parity(dev, P: int = 4096, only=None) -> None:
    """Phase 8a: three port ``JosefineRaft`` servers on the card and three
    on the CPU, same configuration and seeds, one ``LockstepPacer``, the
    sockets replaced by the fixed-order hop of ``raft/lockstep.py`` and the
    loop on its virtual clock; ``lockstep.run_script`` drives both:
    proposals through random nodes (most forwarded to another node's
    leader), group 0's leader stopped from tick 30. On every advance the
    card servers must equal the CPU servers in every frame on the wire (the
    client request ids aside), every ``_h_*`` mirror, every state leaf,
    every chain and every FSM's applies. Run 1: window 1, 60 ticks. Run 2:
    ``window_ticks=4, pipeline_ticks=True``, 180 ticks, 4 per advance while
    every group has a leader (at P = 4096 the pipelined re-elections after
    the stop end near tick 140), so windows fold. Each must forward at
    least 64 proposals, and only run 2 may advance 4 ticks at once. ``only``
    names the runs to make (all when None)."""
    import numpy as np
    import torch

    from josefine_tpu_torch import interop
    from josefine_tpu_torch.raft import lockstep
    from josefine_tpu_torch.raft.pacer import LockstepPacer

    def mirrors(e):
        return {k: v for k, v in vars(e).items()
                if k.startswith("_h_") and isinstance(v, np.ndarray)}

    def compare(t, card, cpu, wires):
        if wires[0] != wires[1]:
            raise AssertionError(f"server parity: tick {t}: the wire differs")
        for a, b in zip(card.servers, cpu.servers):
            w = f"tick {t} node {a.config.id}"
            ma, mb = mirrors(a.engine), mirrors(b.engine)
            for k in ma:
                if not np.array_equal(ma[k], mb[k]):
                    raise AssertionError(f"server parity: {w}: {k} differs")
            for j, (x, y) in enumerate(zip(interop.state_to_numpy(a.engine.state),
                                           interop.state_to_numpy(b.engine.state))):
                if not np.array_equal(x, y):
                    raise AssertionError(f"server parity: {w}: state leaf {j} differs")
            if [(c.head, c.committed, c.floor) for c in a.engine.chains] != \
                    [(c.head, c.committed, c.floor) for c in b.engine.chains]:
                raise AssertionError(f"server parity: {w}: chains differ")
        if [[f.applied for f in n.values()] for n in card.fsms] != \
                [[f.applied for f in n.values()] for n in cpu.fsms]:
            raise AssertionError(f"server parity: tick {t}: FSM applies differ")

    runs = (("window 1", 60, 1, {}),
            ("window 4, pipelined", 180, 4, dict(window_ticks=4, pipeline_ticks=True)))
    picked = _picked(only, [r[0] for r in runs])
    for what, ticks, step, extra in runs:
        if what not in picked:
            continue
        t0 = time.perf_counter()

        async def main():
            pacer = LockstepPacer(settle_s=0)
            card = _server_side(dev, pacer, P, **extra)
            cpu = _server_side(torch.device("cpu"), pacer, P, **extra)
            frames = [0]

            def on_tick(t, wires):
                frames[0] += len(wires[0])
                compare(t, card, cpu, wires)

            stats = await lockstep.run_script([card, cpu], pacer, ticks=ticks, seed=23,
                                              per_tick=8, step=step, on_tick=on_tick)
            return stats, frames[0], card

        stats, frames, card = lockstep.run(main())
        if stats["forwarded"] < 64 or stats["stopped"] is None or (step > 1) != bool(
                stats["strided"]):
            raise AssertionError(f"server parity ({what}): {stats}")
        live = [s for s in card.servers if s.config.id != stats["stopped"]]
        print(f"server parity ok ({what}): P={P}, 3 servers on the card == 3 on the CPU "
              f"on every advance for {stats['ticks']} ticks ({stats['strided']} advances of "
              f"{step} ticks): {frames} frames byte-equal but for the client request ids, "
              f"every mirror, state leaf, chain and FSM apply equal; {stats['proposed']} "
              f"proposals answered, {stats['forwarded']} of them forwarded; node "
              f"{stats['stopped']} (group 0's leader) stopped, group 0 re-elected on node "
              f"{next(s.config.id for s in live if s.engine.is_leader(0))}; no tick loop "
              f"crashed, no server shut down on its own, no proposal failed; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def server_bench(card: str, beside) -> None:
    """Phase 8b: ``bench_server.run`` (three port servers over loopback TCP,
    1,000 proposals per round through node 1, 10 timed rounds: half the
    bench's default, to keep the script within its time limit) with its
    gates, at P = 100,000 and 4096. Prints its numbers beside the
    in-process engine rows of this call in ``beside`` (name -> row; 7b's A
    carries the same load at P = 100,000, 5b and 6b a quarter of it)."""
    from josefine_tpu_torch import bench_server
    from josefine_tpu_torch.raft.tcp import SEND_QUEUE_DEPTH

    for P in (100_000, 4096):
        t0 = time.perf_counter()
        row = bench_server.run(P=P, rounds=10)
        seconds = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        lat, cl, cms = (row["commit_latency_ticks"], row["client_latency_ticks"],
                        row["client_latency_ms"])
        phases = ", ".join(f"{k} {v['ms_per_round']:.3f}"
                           for k, v in row["profile_phases"].items())
        print(f"server path (TCP): P={P} x 3 servers, {row['proposals_per_round']} proposals "
              f"per round through node 1 ({row['forwarded_frac']:.3f} forwarded), "
              f"{row['ms_per_tick']:.3f} ms/tick over the sockets (pacer.advance mean "
              f"{row['advance_ms']['mean']:.3f}, max {row['advance_ms']['max']:.3f}), "
              f"{row['committed_proposals_per_sec']:.6g} committed proposals/s, commit "
              f"latency p50 {lat['p50']} p99 {lat['p99']} ticks (engine, n {lat['n']}), at the "
              f"client p50 {cl['p50']} p99 {cl['p99']} ticks and p50 {cms['p50']:.3f} p99 "
              f"{cms['p99']:.3f} ms; host ms per round (3 engines): {phases}; "
              f"{row['frames_per_tick']:.1f} frames and {row['bytes_per_tick']:.0f} bytes per "
              f"tick; client requests {json.dumps(row['client_requests'])}; server slowdown "
              f"mean {row['slowdown']['mean']:.3f} max {row['slowdown']['max']:.3f}; fullest "
              f"send queue {row['queue_peak']} of {SEND_QUEUE_DEPTH}; elected in "
              f"{row['election']['ticks']} ticks; dropped {row['dropped']}; "
              f"init {row['init_s']:.2f} s; {seconds:.1f} s in all [{card}]", flush=True)
        if row["device_busy"] is not None:
            busy = row["device_busy"]
            print(f"server path (TCP), card over {busy['rounds']} rounds and the ticks until "
                  f"they were answered ({busy['ticks']} ticks): "
                  f"{busy['busy_ms']:.3f} ms busy of {busy['wall_ms']:.3f} ms, idle share "
                  f"{busy['idle_share']:.3f} [{card}]", flush=True)
        for name, other in beside.items():
            if other["P"] == P:
                print(f"server path (TCP) at P={P} against the in-process engine path "
                      f"{name} in this call ({other['proposals_per_tick']} proposals per "
                      f"round, {other['ms_per_tick']:.3f} ms/tick): "
                      f"{row['ms_per_tick'] / other['ms_per_tick']:.3f}x [{card}]", flush=True)


def node_parity(dev, P: int = 32, partitions: int = 8, only=None) -> None:
    """Phase 9a: three port nodes on ``dev`` and three on the CPU (``P``
    engine rows, KV in memory) given ``node_lockstep.run_kafka_script``
    with ``partitions`` topic partitions: on every advance equal Kafka
    answers, raft wires, KVs, partition logs, chains, mirrors and state
    leaves; every
    acknowledged batch read back from every live replica. Run 1: window 1.
    Run 2: ``window_ticks=4, pipeline_ticks=True``, 4 ticks per advance
    while every claimed group has a leader. A card engine's ``tick_begin``
    runs under sync debug "error". ``only`` names the runs to make (all when
    None)."""
    import pathlib
    import tempfile

    from josefine_tpu_torch import config, interop, node_lockstep
    from josefine_tpu_torch.broker import handlers
    from josefine_tpu_torch.node import Node
    from josefine_tpu_torch.raft import lockstep, rpc
    from josefine_tpu_torch.raft.pacer import LockstepPacer

    kit = node_lockstep.Kit(Node, config, handlers, rpc.decode_frame,
                            lambda e: interop.state_to_numpy(e.state))
    runs = (("window 1", 1, {}),
            ("window 4, pipelined", 4, dict(window_ticks=4, pipeline_ticks=True)))
    picked = _picked(only, [r[0] for r in runs])
    for what, step, extra in runs:
        if what not in picked:
            continue
        t0 = time.perf_counter()

        async def main(root):
            pacer = LockstepPacer(settle_s=0)
            sides = node_lockstep.build_sides(
                [kit, kit], pacer, root, partitions=P, seed=11, raft_extra=extra,
                engine_kws=[{"device": str(dev)}, {"device": "cpu"}])
            with node_lockstep.seeded([kit, kit]):
                return await node_lockstep.run_kafka_script(
                    sides, pacer, seed=7, step=step, partitions=partitions)

        with tempfile.TemporaryDirectory(prefix="node_parity_") as td, _StrictCardTicks():
            stats = lockstep.run(main(pathlib.Path(td)))
        if stats["stopped"] is None or stats["acked"] != 4 * partitions or (step > 1) != bool(
                stats["strided"]):
            raise AssertionError(f"node parity ({what}): {stats}")
        print(f"node parity ok ({what}): P={P}, 3 nodes on the card == 3 on the CPU on "
              f"every advance ({stats['compared']} advances, {stats['ticks']} ticks, "
              f"{stats['strided']} of {step} ticks): {stats['requests']} Kafka requests "
              f"answered alike, {stats['frames']} raft frames byte-equal but for the client "
              f"request ids, every KV, partition log, chain, mirror and state leaf equal; "
              f"{stats['acked']} batches acknowledged on {partitions} partitions "
              f"(replication factor 3), {stats['retried']} sent again; node "
              f"{stats['stopped']} (the metadata leader) stopped; every acknowledged batch "
              f"read back from every live replica; "
              f"{'tick_begin under sync debug error; ' if dev.type == 'cuda' else ''}"
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def node_bench(card: str, **kw) -> dict:
    """Phase 9b: ``bench_node.run`` (three nodes over loopback TCP, the
    OpenMessaging Benchmark 1-topic-100-partitions-1kb shape) with its
    gates; prints its numbers."""
    from josefine_tpu_torch import bench_node

    t0 = time.perf_counter()
    row = bench_node.run(**kw)
    seconds = time.perf_counter() - t0
    print(json.dumps(row), flush=True)
    pl, fl = row["produce_latency_ms"], row["fetch_latency_ms"]
    phases = ", ".join(f"{k} {v['ms_per_tick']:.3f}"
                       for k, v in row["profile_phases"].items())
    print(f"node path (Kafka over TCP): {row['partitions']} partitions x RF 3, acks=all, "
          f"{row['batches_acked']} batches ({row['records_acked']} records of "
          f"{row['record_bytes']} B) acknowledged and read back from all 3 nodes byte for "
          f"byte; over the {row['timed_batches']} timed batches "
          f"{row['records_per_sec']:.6g} records/s, {row['mb_per_sec']:.6g} MB/s; produce "
          f"latency at the client p50 {pl['p50']:.3f} p99 {pl['p99']:.3f} ms (n {pl['n']}); "
          f"fetch latency p50 {fl['p50']:.3f} p99 {fl['p99']:.3f} ms (n {fl['n']}); ms per "
          f"tick per node {[round(x, 3) for x in row['ms_per_tick']]} (tick_ms "
          f"{row['tick_ms_configured']}); host ms per tick (3 engines): {phases}; "
          f"{row['frames_per_tick']:.1f} raft frames and {row['bytes_per_tick']:.0f} bytes "
          f"per tick; {row['retried']} produces sent again; ready in {row['ready_s']:.2f} s; "
          f"{seconds:.1f} s in all [{card}]", flush=True)
    busy = row["device_busy"]
    if busy is not None:
        print(f"node path, card over the {busy['batches']} traced batches "
              f"({busy['ticks']} ticks per node): {busy['busy_ms']:.3f} ms busy of "
              f"{busy['wall_ms']:.3f} ms, idle share {busy['idle_share']:.6f} [{card}]",
              flush=True)
    return row


def engine_bench(card: str, P: int = 4096, warmup: int = 40, row: dict | None = None,
                 **kw) -> dict:
    """Phases 5b, 6b, 6c and 7b's rows: the engine path at full size on the
    card (``bench_engine.run``, ``warmup`` and 20 timed rounds; ``kw``
    picks the active set), with its gates. A given ``row`` (6b's, from
    ``headline_latency``) is gated and printed as it is."""
    from josefine_tpu_torch import bench_engine
    from josefine_tpu_torch.ops import fused_step

    launches0 = fused_step.launches
    graphs0 = _active_graph_totals()
    if row is None:
        row = bench_engine.run(P=P, warmup=warmup, ticks=20, **kw)
    print(json.dumps(row), flush=True)
    if row["leaders_per_group"] != {"min": 1, "max": 1}:
        raise AssertionError(f"engine path: leaders per group {row['leaders_per_group']}")
    if row["committed_blocks"] <= 0:
        raise AssertionError("engine path: no block committed in the timed rounds")
    mode = ("sparse IO" if row["sparse_io"] else "dense IO") + (
        f" + active set at {row['active_frac']}" if row["active_set"] else "") + (
        " + device route" if row["device_route"] else "") + (
        " + payload ring" if row["payload_ring"] else "")
    lat = row["commit_latency_ticks"]
    phases = ", ".join(f"{k} {v['ms_per_round']:.3f}"
                       for k, v in row["profile_phases"].items())
    print(f"engine path ({mode}): P={row['P']} x 3 engines, {row['proposals_per_tick']} "
          f"proposals per round, {row['ms_per_tick']:.3f} ms/tick, "
          f"{row['committed_blocks_per_sec']:.6g} committed blocks/s, commit latency "
          f"p50 {lat['p50']} p99 {lat['p99']} ticks (n {lat['n']}); host ms per round "
          f"(3 engines): {phases}; init {row['init_s']:.2f} s; hand-kernel launches "
          f"{fused_step.launches - launches0} [{card}]", flush=True)
    busy = row.get("device_busy")  # taken on the card only
    if busy:
        print(f"engine path ({mode}), card over {busy['rounds']} rounds: {busy['busy_ms']:.3f} "
              f"ms busy of {busy['wall_ms']:.3f} ms, idle share {busy['idle_share']:.3f} "
              f"[{card}]", flush=True)
    for w, s in row.get("window_step", {}).items():
        print(f"engine window step ({w} tick{'s' if w != '1' else ''}, one engine, "
              f"P={row['P']}, {s['step']}): {s['events_ms']:.3f} ms by CUDA events, "
              f"{s['kernels']} device kernels and copies, {s['launch_calls']} "
              f"cudaLaunchKernel calls, {s['busy_ms']:.3f} ms of kernel time; most "
              f"launched: {s['top']} [{card}]", flush=True)
    if row["active_set"]:
        eager, captures, replays = (b - a for a, b in zip(graphs0, _active_graph_totals()))
        print(f"engine path ({mode}), scheduler over the timed rounds: "
              f"{json.dumps(row['active_set_stats'])}; capacity history "
              f"{row['k_out_history']}; compacted ticks over the run (warm-up "
              f"included): {captures} captured, {replays} replayed, {eager} eager "
              f"[{card}]", flush=True)
    elif row["sparse_io"]:
        print(f"engine path ({mode}), capacity history [round, k_out] per engine: "
              f"{row['k_out_history']} [{card}]", flush=True)
    return row


# Phase 5c's integers: the JAX package's own run of its packed-step mode
# (``bench_engine.py --kernel``, ``BENCH_engine_kernel_cpu.json``); the
# sparse idle floor and the dense tick's bytes at each size.
KERNEL_SIZES = (1_000, 10_000, 100_000)
KERNEL_JAX = {
    P: {"sparse_idle_upload_bytes_per_tick": 11_264,
        "sparse_idle_fetch_bytes_per_tick": fetch,
        "sparse_idle_k_out": k_out,
        "dense_upload_bytes_per_tick": 120 * P,
        "dense_fetch_bytes_per_tick": 148 * P}
    for P, fetch, k_out in ((1_000, 80_004, 1_000), (10_000, 327_684, 4_096),
                            (100_000, 327_684, 4_096))}
TRACE_STEPS = 10  # steps of 5c's traced loop: ~2,600 host ops each


def check_kernel_row(row: dict) -> bool:
    """5c's gate: at a size of ``KERNEL_JAX`` every integer of the row
    equals the JAX package's; returns whether the size had constants."""
    want = KERNEL_JAX.get(row["P"])
    if want is None:
        return False
    got = {k: row[k] for k in want}
    if got != want:
        raise AssertionError(f"packed step P={row['P']}: the port's {got} != the JAX "
                             f"package's {want}")
    return True


def engine_kernel_bench(card: str, beside: dict | None = None, sizes=KERNEL_SIZES,
                        iters: int = 60, device="cuda") -> list[dict]:
    """Phase 5c: ``bench_engine --kernel`` (``run_kernel``) at ``sizes``,
    ``iters`` steps each, gated by :func:`check_kernel_row`; each line shows
    5b's window step (``beside``, the 4096-group row) for comparison. Then
    one ``--xprof`` trace of the first size's loop (``TRACE_STEPS`` steps),
    which must hold the device's kernels (host ops on the host)."""
    import os
    import tempfile

    from josefine_tpu_torch import bench_engine

    rows = bench_engine.run_kernel(sizes, iters=iters, device=device)
    step = (beside or {}).get("window_step", {}).get("1")
    step_note = ("not measured" if step is None else
                 f"{step['events_ms']:.3f} ms by CUDA events at P={beside['P']}")
    for row in rows:
        print(json.dumps(row), flush=True)
        if row["device"] != card:
            raise AssertionError(f"packed step: row tagged {row['device']!r}, not {card!r}")
        exact = check_kernel_row(row)
        print(f"engine packed step: P={row['P']}, {row['iters']} steps: "
              f"{row['ms_per_step']:.3f} ms/step with the upload and fetch, "
              f"{row['ms_per_step_compute_only']:.3f} compute only; sparse idle "
              f"{row['sparse_idle_ms_per_tick']:.3f} ms/tick, "
              f"{row['sparse_idle_upload_bytes_per_tick']} B up and "
              f"{row['sparse_idle_fetch_bytes_per_tick']} B down, k_out "
              f"{row['sparse_idle_k_out']}; dense {row['dense_upload_bytes_per_tick']} B up "
              f"and {row['dense_fetch_bytes_per_tick']} B down"
              + ("; every integer == the JAX package's" if exact else "")
              + f"; 5b's window step (1 tick): {step_note} [{card}]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        bench_engine.run_kernel(sizes[:1], iters=TRACE_STEPS, device=device, xprof=tmp)
        path = bench_engine.xprof_path(tmp, "engine_packed_step", sizes[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    cat = "kernel" if str(device).startswith("cuda") else "cpu_op"
    n = sum(ev.get("cat") == cat for ev in events)
    if not n:
        raise AssertionError(f"packed step trace: no {cat!r} event in {len(events)}")
    print(f"engine packed step trace (P={sizes[0]}, {TRACE_STEPS} steps with transfers): "
          f"{len(events)} events, {n} {cat} events, {size} bytes, "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return rows


def _fresh_registry() -> None:
    """Zero the process-global metrics registry and collect the engines of
    earlier runs (their scrape hooks would publish into the next dump)."""
    import gc

    from josefine_tpu_torch.utils.metrics import REGISTRY

    gc.collect()
    REGISTRY.reset()


def _first_difference(got: dict, want: dict, keys=None) -> str | None:
    for key in keys or sorted(set(got) | set(want)):
        if got.get(key) != want.get(key):
            return (f"{key}: card {str(got.get(key))[:300]!r} cpu "
                    f"{str(want.get(key))[:300]!r}")
    return None


# Phase 10a's soaks: the JAX package's CI chaos smokes (tools/ci.sh), seed 7.
CHAOS_SMOKES = (
    ("chaos smoke", dict(horizon=200, flight_wire=True)),
    ("chaos smoke (active-set)", dict(horizon=200, active_set=True, groups=8, hb_ticks=4)),
    ("chaos smoke (device-route)", dict(
        horizon=200, device_route=True, payload_ring=True, quiet_net=True, groups=4,
        workload={"tenants": 4, "produce_per_tick": 2.0, "skew": 1.1})),
)
# The wire soak's artifacts that must be equal (its driver counters pace
# consumer-group rebalances on the wall clock).
WIRE_ARTIFACTS = ("invariants", "violation", "fate_log", "event_log", "journals",
                  "fault_event_log", "coverage_signature", "offered", "produced", "consumed",
                  "health")


def chaos_parity(dev, smokes=CHAOS_SMOKES, wire: bool = True, only=None) -> None:
    """Phase 10a: the port's chaos soak (``chaos/soak.py run_soak``, seed 7,
    ``leader-partition``) with its engines on ``dev`` and on the CPU, in each
    configuration of ``smokes``: every field of the two results must be
    equal (event log, journals, timeline, coverage, state digest, acked and
    proposed, health, the route and active-set statistics, the registry
    dump, ...), invariants "ok". Then the wire soak (``run_wire_soak``,
    ``wire-leader-partition``, three nodes over loopback TCP): equal
    ``WIRE_ARTIFACTS``. Card engines begin every tick under sync debug
    "error" (:class:`_StrictCardTicks`). ``only`` names the smokes to run
    (all when None)."""
    from josefine_tpu_torch.chaos.faults import NetFaults
    from josefine_tpu_torch.chaos.soak import run_soak
    from josefine_tpu_torch.chaos.wire_soak import run_wire_soak

    def soak(device, kw):
        kw = dict(kw)
        net = NetFaults.quiet() if kw.pop("quiet_net", False) else None
        _fresh_registry()
        return run_soak(7, "leader-partition", net=net, device=str(device), **kw)

    picked = _picked(only, [m[0] for m in smokes])
    for name, kw in smokes:
        if name not in picked:
            continue
        t0 = time.perf_counter()
        with _StrictCardTicks() as strict:
            card = soak(dev, kw)
        t_card = time.perf_counter() - t0
        cpu = soak("cpu", kw)
        diff = _first_difference(card, cpu)
        if diff:
            raise AssertionError(f"chaos parity ({name}): {diff}")
        if card["invariants"] != "ok":
            raise AssertionError(f"chaos parity ({name}): {card['violation']}")
        if card["acked"] <= 0 or card["fault_events"] <= 0:
            raise AssertionError(f"chaos parity ({name}): {card['acked']} acked, "
                                 f"{card['fault_events']} fault events")
        extra = ""
        if kw.get("active_set"):
            st = card["active_set_stats"]
            if st["compacted_ticks"] <= 0:
                raise AssertionError(f"chaos parity ({name}): no compacted tick {st}")
            extra = f"; active set {json.dumps(st)}"
        if kw.get("device_route"):
            st = card["device_route_stats"]
            if st["routed_msgs"] <= 0 or card["workload_stats"]["acked"] <= 0:
                raise AssertionError(f"chaos parity ({name}): {st}")
            extra = (f"; routed {st['routed_msgs']} host {st['host_msgs']}, ring "
                     f"{json.dumps(st['ring'])}; workload acked "
                     f"{card['workload_stats']['acked']}")
        if kw.get("flight_wire") and not card["coverage"]["class_counts"].get("path_mix"):
            raise AssertionError(f"chaos parity ({name}): no path_mix coverage")
        print(f"chaos parity ok ({name}): seed 7, leader-partition, {card['ticks']} ticks, "
              f"3 nodes x {card['groups']} groups: the soak on the {dev.type} == the soak on "
              f"the CPU in every field ({len(card)} fields: event log, journals, timeline, "
              f"coverage signature {card['coverage_signature'][:16]}, state digest "
              f"{str(card['state_digest'])[:16]}, health, registry, ...); invariants ok; "
              f"{card['proposed']} proposed, {card['acked']} acked, {card['fault_events']} "
              f"fault events{extra}; {strict.begun} card ticks begun under sync debug error; "
              f"{t_card:.1f} s on the {dev.type}, {time.perf_counter() - t0 - t_card:.1f} s "
              f"on the CPU", flush=True)
    if not wire:
        return
    t0 = time.perf_counter()
    with _StrictCardTicks() as strict:
        card = run_wire_soak(7, "wire-leader-partition", n_nodes=3, device=str(dev))
    t_card = time.perf_counter() - t0
    cpu = run_wire_soak(7, "wire-leader-partition", n_nodes=3, device="cpu")
    diff = _first_difference(card, cpu, WIRE_ARTIFACTS)
    if diff:
        raise AssertionError(f"wire chaos parity: {diff}")
    if card["invariants"] != "ok" or not 0 < card["produced"] == card["consumed"]:
        raise AssertionError(f"wire chaos parity: {card['violation']}, produced "
                             f"{card['produced']}, consumed {card['consumed']}")
    fates = sorted({k for v in card["fate_log"].values() for k in v})
    print(f"wire chaos parity ok: seed 7, wire-leader-partition, 3 nodes over loopback TCP, "
          f"{card['ticks']} ticks: the soak on the {dev.type} == the soak on the CPU in "
          f"{', '.join(WIRE_ARTIFACTS)}; invariants ok; {card['produced']} produces acked and "
          f"consumed back; fates {fates}; {strict.begun} card ticks begun under sync debug "
          f"error; {t_card:.1f} s on the {dev.type}, "
          f"{time.perf_counter() - t0 - t_card:.1f} s on the CPU", flush=True)


def _traffic_engine(device, tenants: int, partitions: int):
    from josefine_tpu_torch.workload.driver import TrafficEngine
    from josefine_tpu_torch.workload.model import WorkloadSpec

    spec = WorkloadSpec.from_axes(tenants, partitions, skew=1.1, load=64)
    return TrafficEngine(spec, seed=7, replication=3, device=str(device))


def _traffic_gates(drv, s: dict, what: str) -> None:
    """10b's gates: no error, every commit replicated and timed, one leader
    per claimed row (and the metadata row) across the three engines."""
    if s["backpressure"]["errors"] != 0:
        raise AssertionError(f"{what}: errors {s['backpressure']}")
    if not 0 < s["committed"] == s["path_stats"]["replicated"]:
        raise AssertionError(f"{what}: committed {s['committed']}, {s['path_stats']}")
    if s["latency_ticks"]["n"] != s["committed"]:
        raise AssertionError(f"{what}: {s['latency_ticks']['n']} latencies for "
                             f"{s['committed']} commits")
    rows = [0, *sorted(drv._boot_claims)]
    bad = [g for g in rows if sum(e.is_leader(g) for e in drv.engines) != 1]
    if bad:
        raise AssertionError(f"{what}: rows without exactly one leader: {bad[:10]}")


def traffic_parity(dev, tenants: int = 100, partitions: int = 1000, ticks: int = 120) -> None:
    """Phase 10b, first part: the traffic driver (``workload/driver.py``
    ``TrafficEngine``, replication 3, seed 7) with its engines on ``dev``
    and on the CPU: the same workload trace (sha256) and the same summary;
    10b's gates on both."""
    import asyncio

    out = []
    for device in (dev, "cpu"):
        _fresh_registry()  # the summary reads the engine's registry histogram
        t0 = time.perf_counter()
        with _StrictCardTicks() as strict:
            drv = _traffic_engine(device, tenants, partitions)
            s = asyncio.run(drv.run(ticks))
        _traffic_gates(drv, s, f"traffic parity ({device})")
        out.append((drv, s, time.perf_counter() - t0, strict.begun))
    (card, s, t_card, begun), (cpu, s_cpu, t_cpu, _) = out
    if card.trace.jsonl() != cpu.trace.jsonl():
        raise AssertionError(f"traffic parity: trace {s['trace_sha256']} on the {dev.type}, "
                             f"{s_cpu['trace_sha256']} on the CPU")
    diff = _first_difference(s, s_cpu)
    if diff:
        raise AssertionError(f"traffic parity: summary {diff}")
    print(f"traffic parity ok: {tenants} tenants x {partitions} partitions, replication 3, "
          f"skew 1.1, 64 produces per tick, {ticks} ticks (+ drain, {s['ticks']} in all): the "
          f"driver on the {dev.type} == on the CPU, trace sha256 {s['trace_sha256']} "
          f"({s['trace_events']} events) and every summary field; {s['committed']} batches "
          f"committed of {s['offered']} offered; {begun} card ticks begun under sync debug "
          f"error; {t_card:.1f} s on the {dev.type}, {t_cpu:.1f} s on the CPU", flush=True)


def traffic_bench(card: str, tenants: int = 1000, partitions: int = 10_000, ticks: int = 100,
                  device="cuda", booted=None) -> dict:
    """Phase 10b at ``tools/traffic_soak.py``'s documented scale
    (``--tenants 1000 --partitions 10000``: skew 1.1, 64 produces per tick,
    seed 7) with replication 3: the broker engine and two replicas at
    P = 10,001 (sparse IO). Boot (topic creation, every row elected), then
    5 ticks under ``torch.profiler`` (the card's idle share), then
    the rest of the ``ticks`` and the driver's drain timed, with 10b's
    gates. Prints ms per tick, committed batches/s, commit latency, host ms
    per engine phase, the idle share and the trace sha256. ``booted``, when
    given, is called after the boot and before the traced ticks (see
    :func:`traffic_bench_start`)."""
    import asyncio

    import torch

    dev = torch.device(device)
    drv = _traffic_engine(dev, tenants, partitions)
    traced, busy = 5, None

    async def soak():
        nonlocal busy
        t0 = time.perf_counter()
        await drv.start()
        boot_s = time.perf_counter() - t0
        if booted is not None:
            booted()
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            from josefine_tpu_torch.bench_engine import _busy_ms

            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for _ in range(traced):
                    await drv._tick_once()
                torch.cuda.synchronize(dev)
                wall_ms = (time.perf_counter() - t) * 1e3
            busy_ms = _busy_ms(prof.events())
            busy = {"ticks": traced, "wall_ms": wall_ms, "busy_ms": busy_ms,
                    "idle_share": 1 - busy_ms / wall_ms}
        else:
            for _ in range(traced):
                await drv._tick_once()
        for e in drv.engines:
            e.enable_profiling().reset()
        tick0, committed0, t1 = drv.tick, drv.n_committed, time.perf_counter()
        await drv.run_ticks(ticks - traced)
        return boot_s, drv.tick - tick0, drv.n_committed - committed0, time.perf_counter() - t1

    with _StrictCardTicks() as strict:
        boot_s, timed_ticks, timed_committed, wall_s = asyncio.run(soak())
    s = drv.summary()
    _traffic_gates(drv, s, "traffic bench")
    phases: dict = {}
    for e in drv.engines:
        for phase, st in e.profiler.snapshot().items():
            phases[phase] = phases.get(phase, 0.0) + st["total_ms"] / timed_ticks
    lat = s["latency_ticks"]
    row = {"tenants": tenants, "partitions": partitions, "engine_rows": drv.engine.P,
           "replication": 3, "seed": 7, "ticks": s["ticks"], "timed_ticks": timed_ticks,
           "sparse_io": drv.engine._sparse, "boot_s": boot_s,
           "ms_per_tick": wall_s * 1e3 / timed_ticks,
           "committed": s["committed"], "offered": s["offered"],
           "committed_batches_per_sec": timed_committed / wall_s,
           "latency_ticks": lat, "backpressure": s["backpressure"],
           "profile_ms_per_tick": dict(sorted(phases.items())), "device_busy": busy,
           "trace_sha256": s["trace_sha256"], "card_ticks_begun": strict.begun,
           "device": card}
    print(json.dumps(row), flush=True)
    print(f"traffic path (in-process driver, real broker handlers): {tenants} tenants x "
          f"{partitions} partitions, replication 3 (P = {drv.engine.P} x 3 engines, "
          f"{'sparse' if drv.engine._sparse else 'dense'} IO), skew 1.1, 64 produces per "
          f"tick, seed 7: boot {boot_s:.1f} s"
          + (" (beside the untimed checks)" if booted is not None else "") + "; "
          f"{timed_ticks} timed ticks ({ticks - traced} offered + drain) at "
          f"{row['ms_per_tick']:.3f} ms/tick; {s['committed']} batches committed of "
          f"{s['offered']} offered ({row['committed_batches_per_sec']:.6g} committed "
          f"batches/s over the timed ticks), commit latency p50 {lat['p50']} p99 {lat['p99']} "
          f"ticks (n {lat['n']}); backpressure {json.dumps(s['backpressure'])}; host ms per "
          f"tick (3 engines): " + ", ".join(f"{k} {v:.3f}" for k, v in row[
              "profile_ms_per_tick"].items()) + f"; trace sha256 {s['trace_sha256']} [{card}]",
          flush=True)
    if busy is not None:
        print(f"traffic path, card over {traced} traced ticks: {busy['busy_ms']:.3f} ms busy "
              f"of {busy['wall_ms']:.3f} ms, idle share {busy['idle_share']:.6f} [{card}]",
              flush=True)
    return row


def sharded_step_parity(dev, P: int = 8192, ticks: int = 40,
                        shapes=((8, 1, 5), (2, 4, 4))) -> None:
    """Phase 11a, the simulation: the port's sharded cluster step
    (``parallel/sharded.py make_sharded_cluster_step``) on a (p, n) mesh
    equals the unsharded ``cluster_step`` on ``dev`` every tick, every state,
    inbox and metrics leaf, for each (p, n, N) of ``shapes``; (2, 4) splits
    the nodes of every group over 4 shards, so its delivery is the
    all_to_all over 'n' (N = 4 there: the node shards must divide N)."""
    import numpy as np
    import torch

    from josefine_tpu_torch.bench_podsim import mesh_devices
    from josefine_tpu_torch.models import chained_raft as cr
    from josefine_tpu_torch.models.types import LEADER, step_params
    from josefine_tpu_torch.parallel.sharded import (
        describe_devices,
        make_mesh,
        make_sharded_cluster_step,
        place,
    )

    params = step_params(timeout_min=3, timeout_max=8, hb_ticks=1, auto_proposals=2,
                         device=dev)
    for n_p, n_n, N in shapes:
        devs = mesh_devices(n_p * n_n, dev)
        mesh = make_mesh(n_p, n_n, devices=devs)
        step = make_sharded_cluster_step(mesh, N)
        state, member = cr.init_state(P, N, base_seed=7, params=params, device=dev)
        inbox = cr.empty_inbox(P, N, device=dev)
        props = torch.zeros((P, N), dtype=torch.int32, device=dev)
        gs, gi = place(state, mesh), place(inbox, mesh)
        gm, gp = place(member, mesh, ("p", None)), place(props, mesh)
        t0 = time.perf_counter()
        for t in range(ticks):
            state, inbox, met = cr.cluster_step(params, member, state, inbox, props)
            gs, gi, gmet = step(params, gm, gs, gi, gp)
            for what, a, b in (("state", state, gs), ("inbox", inbox, gi),
                               ("metrics", met, gmet)):
                for j, (x, y) in enumerate(zip(a.leaves(), b.leaves())):
                    if not np.array_equal(x.cpu().numpy(), np.asarray(y)):
                        raise AssertionError(f"sharded step ({n_p}, {n_n}): tick {t} "
                                             f"{what} leaf {j} differs")
        seconds = time.perf_counter() - t0
        leaders = int(((state.role == LEADER).sum(dim=1) == 1).sum())
        if leaders != P or int(state.commit.s.max()) <= 0:
            raise AssertionError(f"sharded step ({n_p}, {n_n}): {leaders} of {P} groups "
                                 "with one leader, or nothing committed")
        print(f"sharded step parity ok: mesh ({n_p}, {n_n}) on {describe_devices(devs)}, "
              f"P={P} x N={N}: the sharded cluster step == the unsharded one on "
              f"{dev} for {ticks} ticks (state, inbox, metrics); {leaders} groups with "
              f"one leader; {seconds:.1f} s", flush=True)


def engine_mesh_parity(dev, P: int = 8192, ticks: int = 40, S: int = 8, only=None) -> None:
    """Phase 11a, the engine: three engines on an ``S``-shard mesh of the
    card (``bench_podsim.mesh_devices``: distinct cards when there are
    ``S``, else ``S`` shards of ``cuda:0``) and three on an ``S``-shard mesh of the
    host, active set on, each side on a ``RouteFabric`` with the payload
    ring (:func:`_run_sides`, relation ``"exact"``: outbound bytes, mirrors,
    state, chains, journal, routed counts, the fabric, the lease lane),
    every card ``tick_begin`` under sync debug "error". Then the isolation
    check: the same twin with the card side's shards alternating ``cuda:0``
    and ``cpu``, where any read of another shard's tensor outside the two
    named exchanges mixes devices and raises. Engine 2 is cut for ticks
    10-19: 40 ticks then hold the election, the cut, the heal and one
    leader per group again, in two thirds of the 60 the twins once ran (to
    keep the script within its time limit). ``only`` names the meshes to run
    ("card", "isolation"; both when None)."""
    import numpy as np
    import torch

    from josefine_tpu_torch.bench_podsim import mesh_devices
    from josefine_tpu_torch.parallel.sharded import Mesh, describe_devices

    cpu = torch.device("cpu")
    host_mesh = Mesh(np.array([cpu] * S), ("p",))
    card_devs = mesh_devices(S, dev)
    meshes = (("card", card_devs),
              ("isolation", [dev if s % 2 == 0 else cpu for s in range(S)]))
    picked = _picked(only, [m[0] for m in meshes])
    for label, devs in meshes:
        if label not in picked:
            continue
        wake = [0, 0]

        def split(t, engines):
            for e in engines:
                if e._last_wake_shard is not None and not e._sched_pending:
                    wake[0] += int(e._last_wake_shard.sum())
                    wake[1] += e._last_wake_rows

        t0 = time.perf_counter()
        side_kw = dict(active_set=True)
        sides, applied, sent, _ = _run_sides(
            P, ticks, 17,
            [(dev, dict(side_kw, mesh=Mesh(np.array(devs), ("p",))),
              dict(payload_ring=True), None),
             ("cpu", dict(side_kw, mesh=host_mesh), dict(payload_ring=True), ("exact", 0))],
            cut=lambda t: (2,) if 10 <= t < 20 else (), on_tick=split, bursts=2)
        seconds = time.perf_counter() - t0
        card, fab = sides[0]
        if wake[0] != wake[1]:
            raise AssertionError(f"engine mesh parity ({label}): the per-shard wake split "
                                 f"sums to {wake[0]}, the schedules to {wake[1]}")
        compacted = sum(e.active_sched_ticks for e in card)
        leaders = sum(int((e._h_role == 2).sum()) for e in card)
        if not (compacted and fab.routed_total and leaders == P):
            raise AssertionError(f"engine mesh parity ({label}): compacted {compacted}, "
                                 f"routed {fab.routed_total}, leaders {leaders}")
        print(f"engine mesh parity ok ({label}): P={P}, 3 engines on {S} shards of "
              f"{describe_devices(devs)} == 3 on {S} shards of the host for {ticks} "
              f"ticks (active set, route fabric + payload ring, engine 2 cut for 10): "
              f"{sent} outbound messages byte-equal, every mirror, state leaf, chain, "
              f"journal, routed count and fabric equal; {compacted} compacted "
              f"engine-ticks, {fab.routed_total} rows routed, {len(applied[0])} blocks "
              f"applied on group 0, {leaders} leaders, per-shard wake split == "
              f"schedule ({wake[0]} rows); {seconds:.1f} s", flush=True)


def podsim_bench(card: str, per_device: int = 131_072, devices: int = 8,
                 engine_per_device: int = 131_072, device="cuda", tenants: int = 1000,
                 offered: int = 2048) -> dict:
    """Phase 11b: ``josefine_tpu_torch.bench_podsim`` at BASELINE config 5's
    size on the card. The simulation row: ``per_device * devices`` groups
    of N = 5 over ``devices`` 'p' shards, 30 warmup and 10 timed ticks (the
    40 ticks in which the JAX package's 1M-group pod-sim test has every
    group elected: randomized timeouts still split a few votes in a million
    groups after 25); every group must have one leader and commit. The engine row (the JAX
    ``MULTICHIP_podsim.json`` engine row's spec): ``engine_per_device *
    devices`` groups over ``devices`` shards, cluster 1, active set, 1,000
    tenants, Zipf 1.2, 2,048 offered per tick, ``hb_ticks=256``, window 8,
    15 warmup and 20 timed rounds (160 ticks); gates: every group elects,
    commits advance, the per-shard wake split sums to the scheduled rows
    every tick, and no timed round falls back to the dense dispatch but the
    one whose window holds a multiple of ``hb_ticks``: the cold start
    elects every group within a few ticks, so their heartbeats fall due
    together there (the JAX engine's schedule is the same)."""
    import asyncio

    from josefine_tpu_torch import bench_podsim

    row = bench_podsim.bench_row(per_device, devices, ticks=10, warmup=30, device=device)
    print(json.dumps(row), flush=True)
    if row["groups_with_one_leader"] != row["P"] or row["groups_committed"] != row["P"]:
        raise AssertionError(f"podsim simulation: {row['groups_with_one_leader']} groups "
                             f"with one leader, {row['groups_committed']} committed, of "
                             f"{row['P']}")
    print(f"podsim simulation: P={row['P']} x N=5 over {devices} shards of {row['mesh']}: "
          f"init {row['init_s']:.2f} s, warmup {row['compile_plus_warmup_s']:.2f} s, "
          f"{row['ms_per_tick']:.3f} ms/tick, {row['group_ticks_per_sec']:.6g} group-ticks/s, "
          f"{row['accepted_msgs_per_sec']:.6g} accepted msgs/s; state "
          f"{row['state_bytes_per_shard']} + inbox {row['inbox_bytes_per_shard']} bytes per "
          f"shard; every group one leader and committed [{card}]", flush=True)
    erow = asyncio.run(bench_podsim.bench_engine_row(engine_per_device, devices, ticks=20,
                                                     warmup=15, tenants=tenants,
                                                     offered=offered, device=device))
    print(json.dumps(erow), flush=True)
    hb, w = erow["hb_ticks"], erow["window"]
    off_horizon = [t for t in erow["fallback_at_ticks"] if (t + w - 1) // hb * hb < max(t, 1)]
    if (erow["leaders_after_settle"] != erow["P"] or erow["committed_group_advances"] <= 0
            or off_horizon or not erow["wake_split_sums_to_scheduled"]
            or not erow["wake_frac_gauge_exposed"]):
        raise AssertionError(f"podsim engine: a gate failed: {json.dumps(erow)}")
    print(f"podsim engine: P={erow['P']} over {devices} shards of {erow['mesh']}, cluster "
          f"1, active set, {erow['workload']['tenants']} tenants, skew "
          f"{erow['workload']['skew']}, {erow['proposals_per_tick']} offered per tick, "
          f"hb_ticks {erow['hb_ticks']}, window {erow['window']}: init "
          f"{erow['init_s']:.2f} s, settle {erow['settle_ticks']} ticks in "
          f"{erow['settle_s']:.2f} s, {erow['ticks']} timed ticks at "
          f"{erow['ms_per_tick']:.3f} ms/tick, {erow['committed_group_advances']} committed "
          f"advances, wake fraction {erow['avg_wake_frac']:.6f} (per shard "
          f"{[round(f, 6) for f in erow['shard_wake_frac']]}), buckets "
          f"{erow['bucket_levels']}, fallback rounds at ticks {erow['fallback_at_ticks']} "
          f"(heartbeat horizons only); state {erow['state_bytes_per_shard']} "
          f"bytes per shard [{card}]", flush=True)
    return {"simulation": row, "engine": erow}


# BASELINE config 4 through the JAX package (``bench_churn.churn_round``
# plus ``run_ticks``) on the CPU at the full spec: P = 100,000 x 5, seed 0,
# 100 warmup ticks, 20 rounds of 64 ticks, then 50 ticks (PERF.md, section 5).
# The TPU row of BENCH_churn.json (p50 10, p90 13, p99 20, mean 10.55, 0
# unconverged, 60,467,748 commits) agrees.
CHURN_JAX = {
    "value": 10.0, "p90_ticks": 13.0, "p99_ticks": 20.0, "p99_9_ticks": 26.0,
    "mean_ticks": 10.55, "unconverged": 0, "post_churn_single_leader_partitions": 100_000,
    "post_churn_commits": 60_467_748,
    "conv_sha256": "d261e99d353c2753479e6262365958430a68b98205e104eea2f80d83d336653c",
}


def churn_parity(dev, P: int = 4096, warmup: int = 60, rounds: int = 2) -> None:
    """Phase 12a: the churn round on ``dev`` and on the CPU from the same
    seed: every partition's convergence tick and every state and inbox leaf
    equal after the warmup and after each round."""
    import torch

    from josefine_tpu_torch import bench_churn
    from josefine_tpu_torch.models import chained_raft as cr

    t0 = time.perf_counter()
    sides = []
    for d in (dev, torch.device("cpu")):
        params = bench_churn.churn_params(d)
        st, member = cr.init_state(P, bench_churn.N, base_seed=0, params=params, device=d)
        inbox = cr.empty_inbox(P, bench_churn.N, device=d)
        props = torch.zeros((P, bench_churn.N), dtype=torch.int32, device=d)
        st, inbox, _ = cr.run_ticks(params, member, st, inbox, props, warmup)
        sides.append([params, member, st, inbox])

    def same(label, a, b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"churn parity: {label}: leaf {i} differs")

    same("warmup state", sides[0][2].leaves(), sides[1][2].leaves())
    convs = []
    for r in range(rounds):
        convs = []
        for side in sides:
            params, member, st, inbox = side
            side[2], side[3], conv = bench_churn.churn_round(params, member, st, inbox)
            convs.append(conv)
        same(f"round {r} conv", [convs[0]], [convs[1]])
        same(f"round {r} state", sides[0][2].leaves(), sides[1][2].leaves())
        same(f"round {r} inbox", sides[0][3].leaves(), sides[1][3].leaves())
    conv = convs[1]
    print(f"churn parity ok: P={P} x {bench_churn.N} on {dev} == on the CPU: "
          f"{warmup} warmup ticks, {rounds} rounds of {bench_churn.MAX_TICKS} ticks, "
          f"conv, every state and inbox leaf equal; {int((conv > 0).sum())} of {P} "
          f"re-elected in the last round, median {float(conv.float().median()):.0f} ticks; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def churn_bench(card: str, P: int | None = None, rounds: int | None = None,
                device="cuda") -> dict:
    """Phase 12b: ``josefine_tpu_torch.bench_churn`` (BASELINE config 4).
    Gates: 0 unconverged, one leader per partition after the churn, commits
    advancing; at the full spec every integer equals ``CHURN_JAX``."""
    from josefine_tpu_torch import bench_churn

    P = bench_churn.P if P is None else P
    rounds = bench_churn.ROUNDS if rounds is None else rounds
    row = bench_churn.run(P, rounds, device=device)
    print(json.dumps(row), flush=True)
    ex = row["extra"]
    if (ex["unconverged"] or ex["post_churn_single_leader_partitions"] != P
            or ex["post_churn_commits"] <= 0):
        raise AssertionError(f"churn: a gate failed: {json.dumps(row)}")
    exact = (P, rounds) == (bench_churn.P, bench_churn.ROUNDS)
    if exact:
        got = {k: row[k] if k == "value" else ex[k] for k in CHURN_JAX}
        if got != CHURN_JAX:
            raise AssertionError(f"churn: the port's result {got} != the JAX package's "
                                 f"{CHURN_JAX}")
    print(f"churn: P={P} x {ex['nodes_per_partition']}, {rounds} rounds, "
          f"{ex['elections_measured']} elections: p50 {row['value']} / p90 "
          f"{ex['p90_ticks']} / p99 {ex['p99_ticks']} / p99.9 {ex['p99_9_ticks']} ticks, "
          f"mean {ex['mean_ticks']}, {ex['unconverged']} unconverged, "
          f"{ex['post_churn_single_leader_partitions']} single-leader partitions, "
          f"{ex['post_churn_commits']} post-churn commits"
          + ("; every integer == the JAX package's" if exact else "")
          + f"; churn_wall_s {ex['churn_wall_s']:.4f}, {ex['ms_per_churn_tick']:.4f} ms "
          f"per churn tick [{card}]", flush=True)
    return row


def _tool(name: str, *args) -> list[str]:
    return [sys.executable, "-m", f"josefine_tpu_torch.tools.{name}", *args]


def _popen(runs: dict) -> dict:
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    return {name: subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
            for name, cmd in runs.items()}


def _join(procs: dict, t0: float, seconds: dict, timeout: float = 600) -> None:
    """Wait for every process; each must exit 0 (all are stopped either way)."""
    failed = []
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=timeout)
            seconds[name] = time.perf_counter() - t0
            if p.returncode != 0:
                failed.append(f"{name} exited {p.returncode}:\n{out[-1500:]}\n{err[-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError("CLI smokes failed:\n" + "\n".join(failed))


def cli_smokes_start(device="cuda") -> dict:
    """Start the part of phase 12c that a busy host does not disturb, each
    CLI a process of its own with ``--device``: ``chaos_soak`` on ``device``
    and on the CPU (``--result-out`` each), ``podsim_smoke`` and
    ``obs_smoke``. ``main`` starts them beside the untimed checks
    (``CHECKS``) and joins them (:func:`cli_smokes_join`) before the first
    timed part; :func:`cli_smokes` checks what they wrote."""
    import os
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")

    def chaos(i, d):
        return _tool("chaos_soak", "--device", d, "--seed", "7", "--schedule",
                     "leader-partition", "--horizon", "200", "--flight-wire",
                     "--result-out", os.path.join(work, f"soak_{i}.json"))

    runs = {f"chaos_soak 0 ({device})": chaos(0, device), "chaos_soak 1 (cpu)": chaos(1, "cpu"),
            "podsim_smoke": _tool("podsim_smoke", "--device", device),
            "obs_smoke": _tool("obs_smoke", "--device", device)}
    return {"device": device, "work": work, "t0": time.perf_counter(), "procs": _popen(runs),
            "seconds": {}}


def cli_smokes_join(started: dict) -> None:
    """Wait for the runs of :func:`cli_smokes_start` (once)."""
    _join(started["procs"], started["t0"], started["seconds"])
    started["procs"] = {}


def cli_smokes(device="cuda", started: dict | None = None) -> dict:
    """Phase 12c: the port's CLIs, each a process of its own with
    ``--device``; each must exit 0. Joins the runs of
    :func:`cli_smokes_start` (started now when ``started`` is None): the
    chaos soak on ``device`` and on the CPU must give equal results in every
    field (event log, journals, coverage, health, registry, ...), with
    invariants ok and wire paths in its coverage. Then the lockstep wire rig
    on ``device`` and on the CPU, the two alone on the host: byte-equal
    artifacts. Returns each run's wall seconds."""
    import os

    started = started or cli_smokes_start(device)
    cli_smokes_join(started)
    device, work, seconds = started["device"], started["work"], dict(started["seconds"])
    soaks = []
    for i in (0, 1):
        with open(os.path.join(work, f"soak_{i}.json")) as fh:
            soaks.append(json.load(fh))
    diff = _first_difference(*soaks)
    if diff:
        raise AssertionError(f"chaos_soak on {device} != on the CPU: {diff}")
    soak = soaks[0]
    if (soak["invariants"] != "ok" or not soak["coverage_signature"]
            or not soak["coverage"]["class_counts"].get("path_mix")):
        raise AssertionError(f"chaos_soak: invariants {soak['invariants']}, coverage "
                             f"{soak['coverage']['class_counts']}")

    def wire(i, d):
        return _tool("wire_load", "--device", d, "--connections", "16", "--tenants", "4",
                     "--partitions", "4", "--mode", "lockstep", "--smoke",
                     "--artifact", os.path.join(work, f"wire_{i}.txt"))

    # The lockstep wire pair runs alone: its clock settles each tick's
    # socket frames in wall time before it drains the loop.
    t0 = time.perf_counter()
    _join(_popen({f"wire_load 0 ({device})": wire(0, device),
                  "wire_load 1 (cpu)": wire(1, "cpu")}), t0, seconds)
    arts = []
    for i in (0, 1):
        with open(os.path.join(work, f"wire_{i}.txt"), "rb") as fh:
            arts.append(fh.read().splitlines())
    if not arts[0] or arts[0] != arts[1]:
        at = next((k for k, (a, b) in enumerate(zip(*arts)) if a != b), min(map(len, arts)))
        raise AssertionError(f"wire_load artifacts differ from line {at}: "
                             f"{arts[0][at:at + 1]} vs {arts[1][at:at + 1]}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"CLI smokes ok: {', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())}; "
          f"chaos_soak on {device} == on the CPU in every field ({len(soak)} fields, "
          f"coverage signature {soak['coverage_signature'][:16]}); wire artifact "
          f"{len(arts[0])} lines, {device} == CPU", flush=True)
    return seconds


# The commit-latency row of the JAX package's ``tools/headline_latency.py``
# at 6b's arguments (P = 100,000, 40 warmup and 20 timed rounds, the
# engines' bench on the CPU; PERF.md, section 6). It equals the row
# BENCH_headline.json records, and the port's own CPU run of the same
# arguments.
HEADLINE_LAT_JAX = {"n": 5365, "p50": 3.0, "p99": 3.98, "sum": 16095.0}


def check_headline_latency(lat: dict) -> None:
    """6b's exact gate: the latency row's ``{n, p50, p99, sum}`` equal
    ``HEADLINE_LAT_JAX``."""
    got = {k: lat[k] for k in HEADLINE_LAT_JAX}
    if got != HEADLINE_LAT_JAX:
        raise AssertionError(f"headline latency: the port's {got} != the JAX package's "
                             f"{HEADLINE_LAT_JAX}")


def headline_latency_bench(card: str, P: int = 100_000, warmup: int = 40, ticks: int = 20,
                           device="cuda") -> dict:
    """Phase 6b: the P = 100,000 sparse row through ``tools/headline_latency``
    (``bench_engine.run`` with its drain rounds), gated and printed as 5b's;
    at 6b's arguments its commit latency must equal ``HEADLINE_LAT_JAX``.
    Returns the bench row."""
    from josefine_tpu_torch.tools import headline_latency

    lat, row = headline_latency.measure(P, ticks=ticks, warmup=warmup, device=device)
    engine_bench(card, row=row)
    if lat is None:
        raise AssertionError("headline latency: no commit in the timed rounds")
    exact = (P, warmup, ticks) == (100_000, 40, 20)
    if exact:
        check_headline_latency(lat)
    print(f"headline latency: P={P}, {warmup} warmup and {ticks} timed rounds: n {lat['n']}, "
          f"p50 {lat['p50']}, p99 {lat['p99']}, sum {lat['sum']} device ticks"
          + ("; == the JAX package's" if exact else "") + f" [{card}]", flush=True)
    return row


def check_tune(data: dict, card: str) -> None:
    """13a's gates on ``bench_tune``'s ``--out`` file: stage 1, stage 2 and
    the final point present; every point's state after each window equal to
    the stage-1 point's with the same window length (its digests); accepted
    messages in every point; every point, the file and the summary tagged
    with ``card``."""
    points = data["points"]
    stages = [p["stage"] for p in points]
    if not ("window" in stages and "tile" in stages and stages[-1] == "final"):
        raise AssertionError(f"tune: stages {stages}")
    from josefine_tpu_torch import bench_tune

    bench_tune.check_points(points)
    for p in points:
        if p["accepted_msgs"] <= 0:
            raise AssertionError(f"tune: tile {p['tile']} accepted no message")
    tags = {p["card"] for p in points} | {data["card"], data["summary"]["extra"]["card"]}
    if tags != {card}:
        raise AssertionError(f"tune: lines tagged {sorted(tags)}, not {card!r}")


def tune_sweep(card: str, device="cuda", args=()) -> dict:
    """Phase 13a: ``python -m josefine_tpu_torch.bench_tune --device
    <device> --out <tmp>`` (the full headline shape unless ``args`` says
    otherwise), alone on the card; :func:`check_tune`. Prints each point's
    rate and kernel time and the winner; returns the summary."""
    import os
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    out = os.path.join(work, "tune.json")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "josefine_tpu_torch.bench_tune", "--device",
                          device, "--out", out, *args], cwd=os.path.dirname(os.path.abspath(
                              __file__)), capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"bench_tune exited {res.returncode}:\n{res.stderr[-3000:]}")
    with open(out) as fh:
        data = json.load(fh)
    shutil.rmtree(work, ignore_errors=True)
    check_tune(data, card)
    for p in data["points"]:
        kernel = "" if p["kernel_ms"] is None else f", kernel alone {p['kernel_ms']:.3f} ms"
        print(f"tune {p['stage']}: tile {p['tile']} ({p['warps_per_block']} warps/block), "
              f"{p['window_ticks']}-tick windows x {p['reps']}: {p['accepted_msgs_per_sec']:.6g} "
              f"accepted AE/s, {p['ticks_per_sec']:.6g} ticks/s{kernel} [{p['card']}]",
              flush=True)
    ex = data["summary"]["extra"]
    print(f"tune: winner tile {ex['best_tile']} x {ex['best_window_ticks']}-tick windows, "
          f"{data['summary']['value']:.6g} accepted AE/s under bench.py's protocol; every "
          f"point equal to stage 1's state; {ex['launches']} launches; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return data["summary"]


_EXAMPLE_NODES = {"single-node": 1, "multi-node": 3}
_EXAMPLE_DATA = "/tmp/josefine-tpu-torch"


def example_configs(kind: str, work: str, device=None, ports=None) -> list[str]:
    """The port's shipped TOMLs of example ``kind``, written into ``work``
    with their data directories moved under it; ``device`` replaces the
    engine's device and ``ports`` ({shipped: new}) the ports."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    paths = []
    for i in range(1, _EXAMPLE_NODES[kind] + 1):
        with open(os.path.join(here, "josefine_tpu_torch", "examples", kind,
                               f"node-{i}.toml")) as fh:
            text = fh.read().replace(_EXAMPLE_DATA, os.path.join(work, "data"))
        if device is not None:
            text = text.replace('device = "cuda"', f'device = "{device}"')
        if ports:
            text = re.sub(r"^port = (\d+)$",
                          lambda m: f"port = {ports.get(int(m.group(1)), int(m.group(1)))}",
                          text, flags=re.M)
        paths.append(os.path.join(work, f"{kind}-node-{i}.toml"))
        with open(paths[-1], "w") as fh:
            fh.write(text)
    return paths


def parse_demo(out: str) -> dict:
    """The client demo's printed create, produce and fetch results."""
    import ast

    got = {}
    for line in out.splitlines():
        if line.startswith("create: "):
            got["create"] = ast.literal_eval(line[len("create: "):])
        elif line.startswith("produce: "):
            got["produce"] = ast.literal_eval(line[len("produce: "):])
        elif line.startswith("fetch hw: "):
            hw, tail = line[len("fetch hw: "):].split(" records tail: ", 1)
            got["hw"], got["tail"] = int(hw), ast.literal_eval(tail)
    return got


def check_demo(demo: dict, what: str) -> None:
    """13b/13c's gates on the demo: CreateTopics and Produce error 0, the
    high watermark at least 1, the fetched records ending in the payload."""
    if not {"create", "produce", "hw", "tail"} <= set(demo):
        raise AssertionError(f"{what}: the demo printed {sorted(demo)}")
    if demo["create"][0]["error_code"] != 0 or demo["produce"][0]["error_code"] != 0:
        raise AssertionError(f"{what}: create {demo['create']}, produce {demo['produce']}")
    if demo["hw"] < 1 or not demo["tail"].endswith(b"hello, tpu"):
        raise AssertionError(f"{what}: fetch hw {demo['hw']}, records tail {demo['tail']!r}")


def run_example(kind: str, device=None, ports=None, timeout: float = 240) -> dict:
    """Phase 13b (``single-node``) and 13c (``multi-node``): the port's
    example main as a process, from the shipped TOMLs (data moved to a work
    directory; ``device``/``ports`` replaced when given), then the client
    demo against node 1 once every node has registered. The demo must pass
    :func:`check_demo`, and the example exit 0 on SIGINT. Returns the demo's
    results, and its printed lines as ``out``."""
    import os
    import signal
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    examples = os.path.join(here, "josefine_tpu_torch", "examples")
    work = tempfile.mkdtemp(prefix=f"chip_smoke_{kind}_")
    cfgs = example_configs(kind, work, device, ports)
    broker = (ports or {}).get(8844, 8844)
    log_path = os.path.join(work, "node.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        node = subprocess.Popen([sys.executable, os.path.join(examples, kind, "main.py"),
                                 *cfgs], cwd=work, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.perf_counter() + timeout
        while True:
            with open(log_path) as fh:
                text = fh.read()
            if text.count("registered in cluster metadata") >= _EXAMPLE_NODES[kind]:
                break
            if node.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"{kind}: the nodes never registered:\n{text[-3000:]}")
            time.sleep(0.2)
        res = subprocess.run([sys.executable, os.path.join(examples, "client_demo.py"),
                              str(broker)], cwd=work, capture_output=True, text=True,
                             timeout=timeout)
        if res.returncode != 0:
            raise AssertionError(f"{kind}: the demo exited {res.returncode}:\n"
                                 f"{res.stdout[-1500:]}\n{res.stderr[-3000:]}")
        node.send_signal(signal.SIGINT)
        rc = node.wait(timeout=60)
        if rc != 0:
            with open(log_path) as fh:
                raise AssertionError(f"{kind}: the example exited {rc} on SIGINT:\n"
                                     f"{fh.read()[-3000:]}")
    finally:
        if node.poll() is None:
            node.kill()
            node.wait()
    demo = {**parse_demo(res.stdout), "out": res.stdout}
    check_demo(demo, kind)
    shutil.rmtree(work, ignore_errors=True)
    print(f"example {kind}: {_EXAMPLE_NODES[kind]} node(s) on {device or 'the TOMLs device'}, "
          f"the demo created, produced (base offset {demo['produce'][0]['base_offset']}) and "
          f"fetched back (hw {demo['hw']}, tail {demo['tail']!r}); exit 0 on SIGINT; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return demo


def examples_start(device="cuda", ports=None) -> dict:
    """Start phase 13b and 13c's untimed gates beside the untimed checks: a thread
    runs the single-node and then the multi-node example with the demo (the
    two share the shipped ports), and the parole and chaos drivers run as
    processes with ``--device`` (``repro_chaos`` seed 11, ``compact=True``,
    keeping a failing run's state in a work directory). ``ports`` replaces
    the examples' shipped ports ({shipped: new})."""
    import os
    import tempfile
    import threading

    dev = None if device == "cuda" else device
    done: dict = {}

    def examples():
        try:
            done["single-node"] = run_example("single-node", dev, ports)
            done["multi-node"] = run_example("multi-node", dev, ports)
        except BaseException as e:  # noqa: BLE001 - re-raised by examples_join
            done["error"] = e

    thread = threading.Thread(target=examples, name="chip_smoke examples")
    thread.start()
    keep = tempfile.mkdtemp(prefix="chip_smoke_chaos_keep_")
    runs = {f"debug_parole_election ({device})": _tool("debug_parole_election", "--device",
                                                       device),
            f"repro_chaos 11 ({device})": _tool("repro_chaos", "--device", device, "--keep",
                                                os.path.join(keep, "kept"), "11")}
    return {"thread": thread, "done": done, "keep": keep, "t0": time.perf_counter(),
            "procs": _popen(runs), "seconds": {}}


def examples_join(started: dict) -> dict:
    """Wait for :func:`examples_start`'s runs: each driver must exit 0, and
    the examples' gates hold. Returns the drivers' wall seconds."""
    try:
        _join(started["procs"], started["t0"], started["seconds"])
    finally:
        started["thread"].join()
        shutil.rmtree(started["keep"], ignore_errors=True)
    if "error" in started["done"]:
        raise started["done"]["error"]
    print(f"debug drivers ok: {', '.join(f'{k} {v:.1f} s' for k, v in started['seconds'].items())}",
          flush=True)
    return started["seconds"]


# The untimed checks of phases 5a-12a: (label, [(function, keyword
# arguments), ...]), each entry a process of its own that makes its calls in
# turn (``chip_smoke.py --check``). ``main`` runs them side by side,
# ``CHECK_WORKERS`` at a time in this order (longest first, by the seconds
# each took alone on the card), while the kernel builds and phase 3 runs;
# every timed part runs after them, alone.
CHECKS = (
    ("9a", [("node_parity", {})]),
    ("7a dense", [("route_parity", {"only": ["dense, leases"]})]),
    ("11a engine (card), 11a step", [("engine_mesh_parity", {"only": ["card"]}),
                                     ("sharded_step_parity", {})]),
    ("10a chaos smokes", [("chaos_parity", {"wire": False, "only": [
        "chaos smoke", "chaos smoke (active-set)"]})]),
    ("11a engine (isolation), 12a", [("engine_mesh_parity", {"only": ["isolation"]}),
                                     ("churn_parity", {})]),
    ("10a device route, 10b parity", [("chaos_parity", {"wire": False, "only": [
        "chaos smoke (device-route)"]}), ("traffic_parity", {})]),
    ("8a", [("server_parity", {})]),
    ("7a sparse", [("route_parity", {"only": ["sparse", "sparse + active set"]})]),
    ("6a, 5a", [("engine_parity_scale", {}), ("engine_parity", {})]),
    ("6a pipelined", [("engine_parity_pipelined", {})]),
)
CHECK_WORKERS = 5
CHECK_TIMEOUT_S = 600  # a check's process is stopped, and fails, after this
_CHECK_FUNCTIONS = frozenset({"engine_parity", "engine_parity_scale",
                              "engine_parity_pipelined", "route_parity",
                              "server_parity", "node_parity", "chaos_parity", "traffic_parity",
                              "sharded_step_parity", "engine_mesh_parity", "churn_parity"})


def run_check(device: str, calls: str) -> int:
    """The body of ``chip_smoke.py --check DEVICE CALLS``: each call of the
    JSON list ``CALLS`` (``[function, keyword arguments]``, a function of
    ``_CHECK_FUNCTIONS``) made in turn on ``DEVICE`` ("cuda" is card 0). One
    host thread for PyTorch, since the checks share the host's cores."""
    import torch

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    for fn, kw in json.loads(calls):
        if fn not in _CHECK_FUNCTIONS:
            raise ValueError(f"{fn} is not a check")
        globals()[fn](dev, **kw)
    return 0


class SideBySide:
    """Run entries of ``CHECKS`` side by side on a thread of their own, each
    ``chip_smoke.py --check`` in a process of its own, at most ``workers``
    at a time in the given order, each given ``CHECK_TIMEOUT_S``. The first
    failure stops the rest. :meth:`join` prints each one's output in the
    order they ended and raises if one failed; :meth:`stop` kills what still
    runs."""

    def __init__(self, checks=CHECKS, device="cuda", workers: int = CHECK_WORKERS):
        import threading

        self.done: list = []  # (label, seconds, returncode, stdout, stderr)
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._run, name="chip_smoke checks",
                                        args=(list(checks), device, workers))
        self._thread.start()

    def _run(self, pending, device, workers) -> None:
        import os
        import tempfile

        script = os.path.abspath(__file__)
        running: dict = {}
        try:
            while (pending or running) and not self._halt.is_set():
                while pending and len(running) < workers:
                    label, calls = pending.pop(0)
                    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
                    proc = subprocess.Popen(
                        [sys.executable, script, "--check", device, json.dumps(calls)],
                        cwd=os.path.dirname(script), stdout=out, stderr=err, text=True)
                    running[label] = (proc, out, err, time.perf_counter())
                time.sleep(0.1)
                for label, (proc, out, err, t0) in list(running.items()):
                    rc = proc.poll()
                    if rc is None:
                        if time.perf_counter() - t0 <= CHECK_TIMEOUT_S:
                            continue
                        proc.kill()
                        proc.wait()
                        rc = "timed out"
                    del running[label]
                    out.seek(0)
                    err.seek(0)
                    self.done.append((label, time.perf_counter() - t0, rc, out.read(),
                                      err.read()))
                    out.close()
                    err.close()
                    if self.done[-1][2] != 0:
                        self._halt.set()
        finally:
            for proc, out, err, _ in running.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
                err.close()

    def stop(self) -> None:
        self._halt.set()
        self._thread.join()

    def join(self) -> dict:
        """Wait for every check; each must exit 0. Returns the seconds each took."""
        self._thread.join()
        failed = []
        for label, seconds, rc, out, err in self.done:
            sys.stdout.write(out)
            if rc != 0:
                failed.append(f"{label} exited {rc}:\n{out[-1500:]}\n{err[-4000:]}")
            else:
                print(f"check {label} ok in {seconds:.1f} s", flush=True)
        if failed:
            raise AssertionError("checks failed:\n" + "\n".join(failed))
        return {label: seconds for label, seconds, *_ in self.done}


def traffic_bench_start(card: str, **kw) -> subprocess.Popen:
    """Start 10b (:func:`traffic_bench` with ``kw``) in a process of its own
    (``chip_smoke.py --traffic-bench``): it boots the driver, says
    ``booted`` and waits for ``go`` on its standard input before the traced
    and timed ticks. ``main`` starts it beside the untimed checks, waits
    for the boot (:func:`traffic_bench_booted`) before the first timed part,
    and lets it run alone in phase 10 (:func:`traffic_bench_finish`)."""
    import os
    import tempfile

    script = os.path.abspath(__file__)
    err = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, script, "--traffic-bench",
                             json.dumps({"card": card, **kw})],
                            cwd=os.path.dirname(script), stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    proc.err_file = err
    return proc


def _child_failed(proc: subprocess.Popen, what: str, out: str) -> AssertionError:
    proc.wait()
    proc.err_file.seek(0)
    return AssertionError(f"{what} exited {proc.returncode}:\n{out[-1500:]}\n"
                          f"{proc.err_file.read()[-4000:]}")


def traffic_bench_booted(proc: subprocess.Popen) -> None:
    """Wait until the 10b process has booted; echo what it printed so far."""
    seen = []
    for line in proc.stdout:
        if line.strip() == "booted":
            sys.stdout.write("".join(seen))
            return
        seen.append(line)
    raise _child_failed(proc, "10b before its boot ended", "".join(seen))


def traffic_bench_finish(proc: subprocess.Popen) -> dict:
    """Let the booted 10b process run its ticks; echo its output and return
    its row."""
    proc.stdin.write("go\n")
    proc.stdin.close()
    out = proc.stdout.read()
    if proc.wait() != 0:
        raise _child_failed(proc, "10b", out)
    sys.stdout.write(out)
    sys.stdout.flush()
    return next(json.loads(line) for line in out.splitlines() if line.startswith("{"))


def _traffic_bench_child(kw: str) -> int:
    """The body of ``chip_smoke.py --traffic-bench KW``."""
    def booted():
        print("booted", flush=True)
        if sys.stdin.readline().strip() != "go":
            raise RuntimeError("10b: no go after the boot")

    kw = json.loads(kw)
    traffic_bench(kw.pop("card"), booted=booted, **kw)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 1

    from josefine_tpu_torch import bench

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase_done(n: int) -> None:
        print(f"phase {n} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 1. the card ----
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (count {torch.cuda.device_count()}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    card = bench.card_label()
    print(card, flush=True)

    # The untimed checks of phases 5-12 run side by side, each in a process
    # of its own, with 12c's first CLIs, 13b and 13c and 10b's boot, while
    # the kernel builds and phase 3 runs; every timed part runs after them,
    # alone.
    started, examples = cli_smokes_start(), examples_start()
    checks, traffic = SideBySide(), traffic_bench_start(card)
    try:
        return _main(dev, kind, card, t_start, phase_done, started, examples, checks,
                     traffic)
    finally:
        checks.stop()
        for proc in [*started["procs"].values(), *examples["procs"].values(), traffic]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        examples["thread"].join()


def _main(dev, kind, card, t_start, phase_done, started, examples, checks, traffic) -> int:
    import numpy as np
    import torch

    from josefine_tpu_torch import bench
    from josefine_tpu_torch.models import chained_raft as cr
    from josefine_tpu_torch.models.types import LEADER, step_params
    from josefine_tpu_torch.ops import _build, fused_step

    # ---- 2. build ----
    t0 = time.perf_counter()
    so = _build.build_cuda()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})",
          flush=True)
    for n in RUN_SIZES:
        rep = _build.ptxas_report(n)
        info = fused_step.kernel_info(n)
        print(f"kernel N={n}: ptxas {rep}; {info} [{card}]", flush=True)
        if rep["spill_store_bytes"] or rep["spill_load_bytes"] or info["local_bytes"]:
            raise AssertionError(f"fused_window_kernel<{n}> spills: {rep}, {info}")

    # ---- 3. parity: kernel == plain version on the same CUDA tensors ----
    def setup(P, N, member=None, **kw):
        params = step_params(**{"timeout_min": 5, "timeout_max": 10, "hb_ticks": 1,
                                "auto_proposals": 4, **kw}, device=dev)
        st, mem = cr.init_state(P, N, member=member, base_seed=P * 31 + N, params=params,
                                device=dev)
        props = torch.zeros((P, N), dtype=torch.int32, device=dev)
        return params, mem, st, cr.empty_inbox(P, N, device=dev), props

    def require_equal(label, got, want) -> int:
        """Exact equality of every leaf and total; returns the max abs error."""
        err = 0
        for i, (a, b) in enumerate(zip(got[0].leaves() + got[1].leaves(),
                                       want[0].leaves() + want[1].leaves())):
            e = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() if a.numel() else 0
            if a.dtype != b.dtype or e != 0:
                raise AssertionError(f"{label}: leaf {i} differs ({a.dtype} vs {b.dtype}, "
                                     f"max abs error {e})")
            err = max(err, e)
        if got[2] != want[2]:
            raise AssertionError(f"{label}: totals differ: {got[2]} != {want[2]}")
        print(f"parity ok: {label}: {got[2]}", flush=True)
        return err

    def check(label, params, member, st, ib, props, ticks, **kw):
        got = fused_step.run_ticks_fused(params, member, st, ib, props, ticks, **kw)
        want = fused_step.run_ticks_fused_ref(params, member, st, ib, props, ticks,
                                              peer_fresh=kw.get("peer_fresh"))
        require_equal(label, got, want)
        return got

    check("P=4096 N=5 prevote=1, 50 ticks", *setup(4096, 5), 50)
    check("P=4096 N=3 prevote=1, 50 ticks", *setup(4096, 3), 50)
    check("P=4096 N=3 prevote=0, 50 ticks", *setup(4096, 3, prevote=0), 50)

    rng = np.random.default_rng(7)
    member = torch.ones((4096, 5), dtype=torch.bool, device=dev)
    member[:, 4] = False
    params, member, st, ib, props = setup(4096, 5, member=member)
    crashed = torch.from_numpy(rng.random((4096, 5)) < 0.05).to(dev) & member
    st = cr.crash(st, crashed)
    st, ib, _ = check("N=5, slot 4 off, 5% crashed, 25 ticks", params, member, st, ib,
                      props, 25)
    st = cr.restart(st, crashed & torch.from_numpy(rng.random((4096, 5)) < 0.5).to(dev))
    check("N=5, slot 4 off, half restarted, 25 ticks", params, member, st, ib, props, 25)

    pf = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    params, member, st, ib, props = setup(4096, 3, hb_ticks=32, auto_proposals=0)
    st, ib, _ = fused_step.run_ticks_fused(params, member, st, ib, props, 30)
    check("N=3 hb_ticks=32 peer_fresh=(1,0,1), 40 ticks", params, member, st, ib, props,
          40, peer_fresh=pf)

    params, member, st, ib, props = setup(4096, 3)
    a = fused_step.run_ticks_fused(params, member, st, ib, props, 10)
    b = fused_step.run_ticks_fused(params, member, a[0], a[1], props, 10)
    whole = check("P=4096 N=3, 20 ticks", params, member, st, ib, props, 20)
    require_equal("window chaining: 2 x 10 ticks == 20 ticks",
                  (b[0], b[1], {k: a[2][k] + b[2][k] for k in a[2]}), whole)

    for P in (1003, 100_003):
        check(f"P={P} N=5 (last warp holds {P % fused_step.groups_per_warp(5)} of "
              f"{fused_step.groups_per_warp(5)} groups), 50 ticks", *setup(P, 5), 50)
    for N in (1, 4, 7, 16):
        check(f"P=4096 N={N} ({fused_step.groups_per_warp(N)} groups per warp), 50 ticks",
              *setup(4096, N), 50)

    phase_done(3)

    checks.join()
    cli_smokes_join(started)
    examples_join(examples)
    traffic_bench_booted(traffic)
    print(f"untimed checks done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 4. the main path at full size ----
    fused_step.launches = 0
    result, state, inbox = bench.run()
    launches = fused_step.launches
    extra = result["extra"]
    print(json.dumps(result), flush=True)
    if launches < 1 or launches != extra["launches"]:
        raise AssertionError(f"the main path launched the kernel {launches} times")
    live_leaders = ((state.role == LEADER) & state.alive).sum(1)
    if not bool((live_leaders == 1).all()):
        raise AssertionError(f"{int((live_leaders != 1).sum())} groups do not have "
                             "exactly one live leader")
    if extra["committed_blocks"] <= 0:
        raise AssertionError("the main path committed no blocks")
    for leaf in state.leaves():
        if tuple(leaf.shape[:2]) != (bench.PARTITIONS, bench.NODES):
            raise AssertionError(f"state leaf of shape {tuple(leaf.shape)}")
    print(f"main path: {extra['partitions']} groups x {extra['nodes_per_partition']} nodes, "
          f"{launches} launches, window ms {extra['window_ms']}, "
          f"{result['value']:.4g} accepted AppendEntries/s, "
          f"{extra['ticks_per_sec']:.4g} ticks/s, "
          f"{extra['committed_blocks_per_sec']:.4g} committed blocks/s [{card}]", flush=True)

    # One more window from the main path's final state, through the kernel and
    # through the plain version: same inputs, exact equality, and both times.
    P, N, ticks = bench.PARTITIONS, bench.NODES, bench.TICKS
    params = step_params(timeout_min=5, timeout_max=10, hb_ticks=1,
                         auto_proposals=bench.PROPOSALS_PER_TICK, device=dev)
    member = torch.ones((P, N), dtype=torch.bool, device=dev)
    props = torch.zeros((P, N), dtype=torch.int32, device=dev)

    def timed(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn(params, member, state, inbox, props, ticks)
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    # The whole wrapper call and the kernel alone (events around the launch
    # only), median of 3 each, then the plain version.
    call_ms = sorted(timed(fused_step.run_ticks_fused)[1] for _ in range(3))[1]
    runs = [fused_step.run_ticks_fused_timed(params, member, state, inbox, props, ticks)
            for _ in range(3)]
    ms = sorted(r[3] for r in runs)[1]
    marshal_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        fused_step._marshal(params, member, state, inbox, props, ticks, None,
                            fused_step.warps_per_block(N, fused_step.DEFAULT_TILE))
        marshal_ms.append((time.perf_counter() - t0) * 1e3)
    want, plain_ms = timed(fused_step.run_ticks_fused_ref)
    max_err = require_equal(f"P={P} N={N}, {ticks} ticks from the main path's state",
                            runs[0][:3], want)
    print(f"kernel alone {ms:.3f} ms (3 runs: {sorted(r[3] for r in runs)}); whole wrapper "
          f"call {call_ms:.3f} ms, so the wrapper adds {call_ms - ms:.3f} ms, of which "
          f"building the launch's arguments takes {sorted(marshal_ms)[1]:.3f} ms of host time "
          f"(median of 3); plain version {plain_ms:.1f} ms per {ticks}-tick window [{card}]",
          flush=True)
    info = fused_step.kernel_info(N)
    warps = -(-P // fused_step.groups_per_warp(N))
    blocks = -(-warps // info["warps_per_block"])
    print(f"launch shape at P={P} N={N}: {warps} warps of {fused_step.groups_per_warp(N)} "
          f"groups in {blocks} blocks of {info['warps_per_block']} warps; "
          f"{info['resident_warps_per_sm']} resident warps/SM, so "
          f"{blocks / (SMS * info['resident_blocks_per_sm']):.3f} waves on {SMS} SMs",
          flush=True)

    # Bound: the larger of the bytes the window must move (every input leaf
    # read once, every output leaf written once) over HBM bandwidth, and the
    # least instruction count per node-tick (pipe by pipe, this kernel's or
    # the first kernel's) over the rate of the busiest of the integer ALU
    # pipe, the IMAD pipe and instruction issue.
    ins = state.leaves() + inbox.leaves() + [member, props]
    outs = want[0].leaves() + want[1].leaves()
    nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    loop = tick_loop_sass(so, N)
    least = {k: min(loop[k], FIRST_KERNEL_PATH[k]) for k in FIRST_KERNEL_PATH}
    node_ticks = ticks * P * N
    pipe_ms = {name: node_ticks * least[name] / (lanes * SMS * CLOCK_HZ) * 1e3
               for name, lanes in (("alu", ALU_LANES), ("imad", IMAD_LANES),
                                   ("issued", ISSUE_LANES))}
    ops_ms = max(pipe_ms.values())
    bound_ms = max(bytes_ms, ops_ms)
    print(f"tick loop SASS at N={N}, per node-tick: this kernel {loop}; first kernel "
          f"{FIRST_KERNEL_PATH}; least {least}; over {node_ticks:.4g} node-ticks: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in pipe_ms.items())
          + f"; bytes {nbytes} -> {bytes_ms:.4f} ms; bound {bound_ms:.3f} ms; "
          f"the kernel at {bound_ms / ms:.1%} of it [{card}]", flush=True)
    # Not a bound: the ALU pipe's time if every warp ran every part of the
    # tick body, idle lanes included (a warp's instruction costs its 32 lanes).
    alu_all_ms = warps * ticks * loop["alu_all"] * 32 / (ALU_LANES * SMS * CLOCK_HZ) * 1e3
    print(f"every part taken by every warp: ALU pipe {alu_all_ms:.3f} ms per window, "
          f"the kernel at {ms / alu_all_ms:.1%} of that [{card}]", flush=True)

    # The same window at other block shapes: the result must not move.
    for tile in TILES:
        shape = fused_step.kernel_info(N, tile)
        got = [fused_step.run_ticks_fused_timed(params, member, state, inbox, props, ticks,
                                                tile=tile) for _ in range(3)]
        require_equal(f"tile {tile}", got[0][:3], want)
        blocks_t = -(-warps // shape["warps_per_block"])
        print(f"tile {tile}: {shape['warps_per_block']} warps/block, "
              f"{shape['resident_warps_per_sm']} resident warps/SM, "
              f"{blocks_t / (SMS * shape['resident_blocks_per_sm']):.3f} waves, kernel alone "
              f"{sorted(r[3] for r in got)[1]:.3f} ms (median of 3) [{card}]", flush=True)

    phase_done(4)

    # ---- 5. the consensus engine on the card ----
    upload_no_wait(dev, card)
    dense_row = engine_bench(card)
    engine_kernel_bench(card, dense_row)

    phase_done(5)

    # ---- 6. the engine's scale path: sparse IO and the active set ----
    sparse_row = headline_latency_bench(card)
    engine_bench(card, P=100_000, warmup=20, active_set=True, active_frac=0.01)

    phase_done(6)

    # ---- 7. device-resident delivery: the route fabric, the payload ring, leases ----
    host_rows = route_bench(card)
    phase_done(7)

    # ---- 8. the raft runtime: JosefineRaft servers, forwarding, TCP ----
    beside = {"5b": dense_row, "6b": sparse_row,
              **{f"7b {name} ({i + 1})": row for i, (name, row) in enumerate(host_rows)
                 if name == "A host"}}
    server_bench(card, beside)
    phase_done(8)

    # ---- 9. the node: the broker, partition groups and Kafka over the engine ----
    node_bench(card, batches=10)
    phase_done(9)

    # ---- 10. chaos and traffic: the wire soak (on a quiet host), the traffic driver ----
    chaos_parity(dev, smokes=())
    traffic_bench_finish(traffic)
    phase_done(10)

    # ---- 11. the sharded programs: the mesh simulation and the mesh engine ----
    podsim_bench(card)
    phase_done(11)

    # ---- 12. leader churn (BASELINE config 4) and the port's tools ----
    churn_bench(card)
    cli_smokes(started=started)
    phase_done(12)

    # ---- 13. the operating-point sweep (13b, 13c ran beside the checks) ----
    tune = tune_sweep(card)
    launches += tune["extra"]["launches"]
    phase_done(13)

    print(json.dumps({"kernels": [{
        "name": "fused_window",
        "route": "cuda",
        "source": "josefine_tpu_torch/ops/csrc/fused_step.cu",
        "replaces": "josefine_tpu/ops/pallas_step.py:394",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "registers": info["registers"],
        "resident_warps_per_sm": info["resident_warps_per_sm"],
        "ticks_per_body": loop["ticks_per_body"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--check"]:
        sys.exit(run_check(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--traffic-bench"]:
        sys.exit(_traffic_bench_child(sys.argv[2]))
    sys.exit(main())
