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
   (``torch.profiler``).
6. the engine's scale path on the card (sparse packed IO and the active-set
   scheduler; PyTorch ops only, no hand kernel). 6a: a 3-engine cluster on
   the card and the same cluster on the CPU at P = 8192, 110 single ticks
   under a proposal drizzle, once with sparse IO and once with sparse IO
   plus the active set, every engine's compaction capacity set to 64 at the
   start: on every tick the encoded bytes of every outbound message, every
   host mirror, every state leaf and the scheduler's counts must be equal,
   and no card engine's ``tick_begin`` may wait for the device except the
   active set's counted refetch on re-entry after a fallback tick. The
   sparse run must overflow the capacity at least once (its shrinks are
   printed); the active run must show fallback ticks, compacted ticks and a
   refetch. 6b: ``bench_engine.run`` at P = 100,000 (sparse IO, the
   engines' default there; 256 proposals per round). 6c: the same with the
   active set and ``active_frac=0.01`` (1,000 proposals per round). Each
   must leave exactly one leader per group and commit blocks in the timed
   rounds, and prints the numbers of 5b plus the active set's counts.

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


def _twin_run(dev, P: int, ticks: int, seed: int, window=lambda t: 1, cut=lambda t: (),
              setup=None, on_tick=None, **engine_kw):
    """The same 3-engine cluster on the card (``dev``) and on the CPU, fed
    the same traffic for ``ticks`` split-phase rounds: from tick 20, every
    second tick, one payload each for group 0 and 16 random groups, to
    whichever engine leads; messages are delivered unless an end is in
    ``cut(t)``. Raises on the first tick where an outbound message's bytes,
    a host mirror, a state leaf or the scheduler's state (:func:`_sched`)
    differ. A card engine's ``tick_begin`` runs under CUDA's sync debug
    mode set to error, so a host wait inside it raises, except the active
    set's counted refetch (``_refetch_wake_inputs``). ``setup(engine)`` runs
    on every engine before the first tick, ``on_tick(t, card engines)``
    after every tick. Returns the card engines, both sides' group-0 FSMs and
    the number of messages compared."""
    import asyncio

    import numpy as np
    import torch

    from josefine_tpu_torch import interop
    from josefine_tpu_torch.models.types import step_params
    from josefine_tpu_torch.raft.engine import RaftEngine
    from josefine_tpu_torch.utils.kv import MemKV

    def cluster(device):
        fsms = [_ListFsm() for _ in range(3)]
        engines = [RaftEngine(MemKV(), [1, 2, 3], i + 1, groups=P, fsms={0: fsms[i]},
                              params=step_params(timeout_min=3, timeout_max=8, hb_ticks=16,
                                                 device=device),
                              base_seed=i, device=device, **engine_kw)
                   for i in range(3)]
        return engines, fsms

    def allow_refetch(e):
        inner = e._refetch_wake_inputs

        def refetch():
            torch.cuda.set_sync_debug_mode("default")
            try:
                return inner()
            finally:
                torch.cuda.set_sync_debug_mode("error")

        e._refetch_wake_inputs = refetch

    def begin(e, w):
        if not e.state.term.is_cuda:
            return e.tick_begin(w)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return e.tick_begin(w)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def mirrors(e):
        return {k: v for k, v in vars(e).items()
                if k.startswith("_h_") and isinstance(v, np.ndarray)}

    async def run():
        sides = [cluster(dev), cluster("cpu")]
        for e in sides[0][0] + sides[1][0]:
            if setup is not None:
                setup(e)
            if e.state.term.is_cuda:
                allow_refetch(e)
        rng = np.random.default_rng(seed)
        sent = 0
        for t in range(ticks):
            results = []
            for engines, _ in sides:
                hs = [begin(e, e.suggest_window(window(t))) for e in engines]
                results.append([e.tick_finish(h) for e, h in zip(engines, hs)])
            for i, (a, b) in enumerate(zip(*results)):
                wa, wb = [m.encode() for m in a.outbound], [m.encode() for m in b.outbound]
                if wa != wb:
                    raise AssertionError(f"engine parity: tick {t} engine {i}: outbound differs")
                sent += len(wa)
            for (engines, _), res in zip(sides, results):
                for r in res:
                    for m in r.outbound:
                        if m.src not in cut(t) and m.dst not in cut(t):
                            engines[m.dst].receive(m)
            for i, (ea, eb) in enumerate(zip(sides[0][0], sides[1][0])):
                ma, mb = mirrors(ea), mirrors(eb)
                for k in ma:
                    if not np.array_equal(ma[k], mb[k]):
                        raise AssertionError(f"engine parity: tick {t} engine {i}: {k} differs")
                if _sched(ea) != _sched(eb):
                    raise AssertionError(f"engine parity: tick {t} engine {i}: scheduler "
                                         f"{_sched(ea)} != {_sched(eb)}")
                for j, (x, y) in enumerate(zip(interop.state_to_numpy(ea.state),
                                               interop.state_to_numpy(eb.state))):
                    if not np.array_equal(x, y):
                        raise AssertionError(
                            f"engine parity: tick {t} engine {i}: state leaf {j} differs")
            if on_tick is not None:
                on_tick(t, sides[0][0])
            if t >= 20 and t % 2 == 0:
                for g in sorted(set(rng.integers(0, P, 16).tolist()) | {0}):
                    for ea, eb in zip(sides[0][0], sides[1][0]):
                        if ea.is_leader(g) and ea.me not in cut(t):
                            ea.propose(g, b"t%d-g%d" % (t, g)).add_done_callback(_retrieve)
                            eb.propose(g, b"t%d-g%d" % (t, g)).add_done_callback(_retrieve)
                            break
        fsms = [f.applied for f in sides[0][1]], [f.applied for f in sides[1][1]]
        if fsms[0] != fsms[1] or not fsms[0][0]:
            raise AssertionError("engine parity: group 0's FSMs differ or applied nothing")
        return sides[0][0], fsms[0], sent

    return asyncio.run(run())


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


def engine_parity_scale(dev, P: int = 8192, ticks: int = 110) -> None:
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
        print(f"{line}; {seconds:.1f} s", flush=True)


def engine_bench(card: str, P: int = 4096, **kw) -> dict:
    """Phases 5b, 6b and 6c: the engine path at full size on the card
    (``bench_engine.run``; ``kw`` picks the active set), with its gates."""
    from josefine_tpu_torch import bench_engine
    from josefine_tpu_torch.ops import fused_step

    launches0 = fused_step.launches
    row = bench_engine.run(P=P, warmup=40, ticks=20, **kw)
    print(json.dumps(row), flush=True)
    if row["leaders_per_group"] != {"min": 1, "max": 1}:
        raise AssertionError(f"engine path: leaders per group {row['leaders_per_group']}")
    if row["committed_blocks"] <= 0:
        raise AssertionError("engine path: no block committed in the timed rounds")
    mode = ("sparse IO" if row["sparse_io"] else "dense IO") + (
        f" + active set at {row['active_frac']}" if row["active_set"] else "")
    lat = row["commit_latency_ticks"]
    phases = ", ".join(f"{k} {v['ms_per_round']:.3f}"
                       for k, v in row["profile_phases"].items())
    print(f"engine path ({mode}): P={row['P']} x 3 engines, {row['proposals_per_tick']} "
          f"proposals per round, {row['ms_per_tick']:.3f} ms/tick, "
          f"{row['committed_blocks_per_sec']:.6g} committed blocks/s, commit latency "
          f"p50 {lat['p50']} p99 {lat['p99']} ticks (n {lat['n']}); host ms per round "
          f"(3 engines): {phases}; init {row['init_s']:.2f} s; hand-kernel launches "
          f"{fused_step.launches - launches0} [{card}]", flush=True)
    busy = row["device_busy"]
    print(f"engine path ({mode}), card over {busy['rounds']} rounds: {busy['busy_ms']:.3f} ms "
          f"busy of {busy['wall_ms']:.3f} ms, idle share {busy['idle_share']:.3f} [{card}]",
          flush=True)
    for w, s in row["window_step"].items():
        print(f"engine window step ({w} tick{'s' if w != '1' else ''}, one engine, "
              f"P={row['P']}, {s['step']}): {s['events_ms']:.3f} ms by CUDA events, "
              f"{s['kernels']} device kernels and copies, {s['launch_calls']} "
              f"cudaLaunchKernel calls, {s['busy_ms']:.3f} ms of kernel time; most "
              f"launched: {s['top']} [{card}]", flush=True)
    if row["active_set"]:
        print(f"engine path ({mode}), scheduler over the timed rounds: "
              f"{json.dumps(row['active_set_stats'])}; capacity history "
              f"{row['k_out_history']} [{card}]", flush=True)
    elif row["sparse_io"]:
        print(f"engine path ({mode}), capacity history [round, k_out] per engine: "
              f"{row['k_out_history']} [{card}]", flush=True)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 1

    import numpy as np

    from josefine_tpu_torch import bench
    from josefine_tpu_torch.models import chained_raft as cr
    from josefine_tpu_torch.models.types import LEADER, step_params
    from josefine_tpu_torch.ops import _build, fused_step

    dev = torch.device("cuda", 0)

    # ---- 1. the card ----
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (count {torch.cuda.device_count()}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    card = bench.card_label()
    print(card, flush=True)

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

    # ---- 5. the consensus engine on the card ----
    upload_no_wait(dev, card)
    engine_parity(dev)
    engine_bench(card)

    # ---- 6. the engine's scale path: sparse IO and the active set ----
    engine_parity_scale(dev)
    engine_bench(card, P=100_000)
    engine_bench(card, P=100_000, active_set=True, active_frac=0.01)

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
    sys.exit(main())
