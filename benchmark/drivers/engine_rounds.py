"""Driver: one cluster of ``RaftEngine``s in one process, in closed rounds.

A frozen copy of the round of ``josefine_tpu_torch/bench_engine.py``
``_bench`` (commit 2a01ac5): every round offers payloads to the groups'
leaders, dispatches every engine's device step (``tick_begin``), then
finishes each (``tick_finish``) and hands their messages to the receiving
engines. The next round starts when the last has finished. Unlike the
bench, each ``propose`` future is stamped on the host clock when it is
sent and when a round returns it resolved, so latency is in time, not in
ticks.

Configuration keys: ``groups``, ``replication_factor`` (engines),
``timeout_min``, ``timeout_max``, ``hb_ticks``, ``sparse_io`` (null: the
engine's own choice). Traffic keys: ``topic_partitions``, the groups of
one topic, drawn from the seed among the data groups (group 0 is the
cluster's metadata group); every round offers one message of
``message_bytes`` to each of them, its head the reference's
``PAYLOAD_HEAD``; ``warmup_rounds`` under load after the election,
``trace_rounds`` traced after the window, ``answer_wait_s`` (how long
after the window a proposal may take to be answered).

The control (``Run.control``) claims every data group for the first
engine alone: a replication factor of 1 where the configuration states
more.

``obs`` keys: ``setup_s``, ``window_s``, ``acked`` (proposals answered
without error inside the window: made in it, or in flight when it opened),
``window_proposals``, ``in_flight_at_start``, ``latencies_ms`` (every
proposal made in the window), ``rounds``; traced: ``phases`` (host ms per engine phase over
the window, summed over the engines), ``traced_engine_ticks``,
``step_bytes`` (:func:`benchmark.roofline.step_bytes` over them).
"""

from __future__ import annotations

import asyncio
import gc
import time

import numpy as np
import torch

from benchmark import roofline
from benchmark.harness import Outcome, Run
from benchmark.reference import replicated_log as ref
from benchmark.trace import DeviceTrace, label


class _Recorder:
    """The state machine of every group of one engine: it keeps what it
    applied, in order, so the reference can judge it."""

    __slots__ = ("applied",)

    def __init__(self):
        self.applied: list[bytes] = []

    def transition(self, data: bytes) -> bytes:
        self.applied.append(data)
        return b""


class Book:
    """Every proposal made, in flat lists: no object per proposal, so the
    record gives the collector nothing more to walk than the program does."""

    def __init__(self):
        self.group: list[int] = []
        self.payload: list[bytes] = []
        self.t_sent: list[float] = []
        self.t_done: list[float] = []
        self.status: list[str] = []   # open, acked or failed
        self.timed: list[bool] = []
        self.pending: list[tuple[int, object]] = []  # (index, future) not yet answered

    def add(self, g: int, payload: bytes, fut, t: float, timed: bool) -> None:
        self.pending.append((len(self.group), fut))
        self.group.append(g)
        self.payload.append(payload)
        self.t_sent.append(t)
        self.t_done.append(0.0)
        self.status.append("open")
        self.timed.append(timed)

    def settle(self) -> float:
        """Stamp the proposals answered by now."""
        now = time.perf_counter()
        still = []
        for i, fut in self.pending:
            if fut.done():
                self.t_done[i] = now
                bad = fut.cancelled() or fut.exception() is not None
                self.status[i] = "failed" if bad else "acked"
            else:
                still.append((i, fut))
        self.pending = still
        return now


class Cluster:
    """The system under test: ``replication_factor`` engines, each holding
    its row of every group on the device."""

    def __init__(self, cfg: dict, seed: int, device: torch.device, control: bool):
        from josefine_tpu_torch.models.types import step_params
        from josefine_tpu_torch.raft.engine import RaftEngine
        from josefine_tpu_torch.utils.kv import MemKV

        self.P, self.N = cfg["groups"], cfg["replication_factor"]
        params = step_params(timeout_min=cfg["timeout_min"], timeout_max=cfg["timeout_max"],
                             hb_ticks=cfg["hb_ticks"], device=device)
        self.fsms = [_Recorder() for _ in range(self.N)]
        self.engines = [
            RaftEngine(MemKV(), list(range(self.N)), i, groups=self.P, params=params,
                       fsms=dict.fromkeys(range(self.P), self.fsms[i]),
                       sparse_io=cfg["sparse_io"], base_seed=seed % (2 ** 31 - 1),
                       device=device)
            for i in range(self.N)]
        if control:
            claim = {g: {0} for g in range(1, self.P)}
            for e in self.engines:
                e.configure_groups(claim)
        self.rows = [0] * self.N  # rows each engine's next tick touches

    def leaders_per_group(self) -> np.ndarray:
        from josefine_tpu_torch.models.types import LEADER

        return np.sum([e._h_role == LEADER for e in self.engines], axis=0)

    def leader(self, g: int):
        for i, e in enumerate(self.engines):
            if e.is_leader(g):
                return i, e
        return None, None

    def round(self) -> None:
        """One closed round: dispatch every engine, finish each, deliver."""
        with label("tick_begin"):
            handles = [e.tick_begin(e.suggest_window(1)) for e in self.engines]
        outbound = []
        with label("tick_finish"):
            for e, h in zip(self.engines, handles):
                outbound.extend(e.tick_finish(h).outbound)
        self.rows = [0] * self.N
        with label("deliver"):
            for m in outbound:
                self.rows[m.dst] += len(m) if hasattr(m, "__len__") else 1
                self.engines[m.dst].receive(m)

    def outputs(self, groups) -> list[dict]:
        """Every replica's committed chain of ``groups`` and its applies."""
        from josefine_tpu_torch.raft.chain import GENESIS

        out = []
        for e, fsm in zip(self.engines, self.fsms):
            chains = {}
            for g in groups:
                ch = e.chains[g]
                chains[g] = [(b.id, b.parent, b.data) for b in ch.range(GENESIS, ch.committed)]
            out.append({"chains": chains, "applied": list(fsm.applied)})
        return out


async def _drive(run: Run) -> Outcome:
    cfg, tr, dev = run.config, run.traffic, run.device
    rng = np.random.default_rng(run.seed & (2 ** 64 - 1))
    cl = Cluster(cfg, run.seed, dev, run.control)
    t_built = time.perf_counter()
    k = tr["topic_partitions"]
    topic = (1 + rng.choice(cl.P - 1, size=k, replace=False)).tolist()
    rest = tr["message_bytes"] - ref.PAYLOAD_HEAD.size
    book = Book()
    settle = book.settle

    def offer(timed: bool) -> None:
        blob = rng.bytes(rest * k)
        t = time.perf_counter()
        for j, g in enumerate(topic):
            i, e = cl.leader(g)
            if e is None:
                continue
            payload = ref.make_payload(g, len(book.group), blob[j * rest:(j + 1) * rest])
            book.add(g, payload, e.propose(g, payload), t, timed)
            cl.rows[i] += 1

    # Elect, then warm up under the offered load (it settles the sparse
    # outbox capacity the window runs at).
    for r in range(400):
        cl.round()
        if r % 4 == 3 and (cl.leaders_per_group() == 1).all():
            break
    else:
        raise AssertionError("not every group elected one leader")
    t_elected = time.perf_counter()
    for _ in range(tr["warmup_rounds"]):
        with label("propose"):
            offer(False)
        cl.round()
        settle()
    if run.trace:
        for e in cl.engines:
            e.enable_profiling().reset()
    # Set-up ends with a full collection, so every run's window starts
    # from the same collector state.
    gc.collect()
    if run.fault is not None:
        run.fault(cl)

    # The window: closed rounds until --seconds have passed.
    in_flight = len(book.pending)
    first = len(book.group)
    t_start = time.perf_counter()
    rounds = 0
    while True:
        offer(True)
        cl.round()
        t_end = settle()
        rounds += 1
        if t_end - t_start >= run.seconds:
            break
    obs = {"setup_s": t_start - run.t0, "window_s": t_end - t_start, "rounds": rounds}
    obs["diagnostics"] = {"setup_to_engines_s": t_built - run.t0,
                          "setup_to_elected_s": t_elected - run.t0,
                          "round_ms": 1e3 * (t_end - t_start) / rounds}
    obs["acked"] = sum(s == "acked" and t_start <= t <= t_end
                       for s, t in zip(book.status, book.t_done))
    obs["window_proposals"] = len(book.group) - first
    obs["in_flight_at_start"] = in_flight

    def answer() -> None:
        """Rounds with no new proposal until every one is answered (a
        minute at most)."""
        deadline = time.perf_counter() + tr["answer_wait_s"]
        while book.pending and time.perf_counter() < deadline:
            cl.round()
            settle()

    answer()
    timed = [i for i, t in enumerate(book.timed) if t]
    obs["latencies_ms"] = [(book.t_done[i] - book.t_sent[i]) * 1e3 for i in timed
                           if book.status[i] == "acked"]
    if obs["latencies_ms"]:
        obs["diagnostics"]["commit_latency_ms_p50_p90_p95_p99_p999_max"] = np.percentile(
            obs["latencies_ms"], [50, 90, 95, 99, 99.9, 100]).round(1).tolist()
    traced = None
    if run.trace:
        phases: dict[str, float] = {}
        for e in cl.engines:
            for name, s in e.profiler.snapshot().items():
                phases[name] = phases.get(name, 0.0) + s["total_ms"]
        obs["phases"] = phases
        for _ in range(tr["warmup_rounds"] // 4):  # back under load before tracing
            offer(False)
            cl.round()
            settle()
        step_bytes = 0
        with DeviceTrace(dev) as t:
            for _ in range(tr["trace_rounds"]):
                with label("propose"):
                    offer(False)
                step_bytes += sum(roofline.step_bytes(cl.P, cl.N, r) for r in cl.rows)
                cl.round()
                with label("settle"):
                    settle()
        traced = t.reduce()
        obs["traced_engine_ticks"] = tr["trace_rounds"] * cl.N
        obs["step_bytes"] = step_bytes
        answer()
    # The followers learn the last commits within a heartbeat interval.
    for _ in range(cfg["hb_ticks"] + 4):
        cl.round()
    settle()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    replicas = cl.outputs(sorted(set(book.group)))
    proposals = list(zip(book.group, book.payload, book.status))
    del cl, book
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    counts = ref.compare(proposals, replicas)
    return Outcome(obs=obs, attempted=len(timed),
                   failed=sum(proposals[i][2] != "acked" for i in timed),
                   checks={name: (v, 0) for name, v in counts.items()},
                   memory_peak_bytes=peak, traced=traced)


def run(run: Run) -> Outcome:
    return asyncio.run(_drive(run))
