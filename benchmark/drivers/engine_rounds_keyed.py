"""Driver: keyed Kafka produce on the engine's active-set scheduler, in
closed rounds.

The cluster, its closed round, ``Book`` and ``_Recorder`` are
``engine_rounds``'s, imported; the engines are built with
``active_set=cfg["active_set"]``. Each round offers ``messages_per_round``
records of ``message_bytes`` from one producer. Keys are YCSB's core
workload with ``requestdistribution=zipfian``: record numbers from
``ScrambledZipfianGenerator(0, recordcount - 1)`` (Zipfian 0.99 over 10^10
items, FNV-64 hashed, reduced mod ``recordcount``), uniform draws from a
generator seeded with ``--seed``; the key of record ``n`` is ``"user" +
fnvhash64(n)`` (``CoreWorkload.buildKeyName``). A key's partition is
Kafka's ``DefaultPartitioner`` for keyed records, ``toPositive(murmur2(key))
% partitions`` over a topic of ``groups - 1`` partitions on groups 1 ..
``groups - 1``. A record is ``PAYLOAD_HEAD`` (group, serial), the key's
number (``reference.keyed_log.KEY``) and bytes from the seed; a record
whose partition has no leader when it is offered is not sent.

Configuration keys: ``engine_rounds``'s and ``active_set``. Traffic keys:
``messages_per_round``, ``message_bytes``, ``recordcount``,
``warmup_rounds``, ``trace_rounds``, ``answer_wait_s`` (as
``engine_rounds``). The control (``Run.control``) claims every data group
for the first engine alone.

``obs`` keys: ``engine_rounds``'s, and ``scheduler``, the window's deltas
summed over the engines of ``active_sched_ticks`` (compacted ticks),
``active_fallback_ticks``, ``active_sched_rows`` (active rows),
``active_bucket_rows`` and ``active_refetches``; a counter the program
lacks reads None. Traced: ``traced_ticks`` (each traced engine tick's mode
and bucket ``K``, 0 where nothing was gathered) and ``step_bytes``, the
frozen bytes of those ticks (:func:`benchmark.roofline_active.compacted_bytes`
for a compacted tick, :func:`benchmark.roofline.step_bytes` for a fallback
tick), which ``raft.step_roofline`` reads. ``diagnostics`` split set-up into
building the engines, the election (and its rounds), the warm-up and the
closing collection.
"""

from __future__ import annotations

import asyncio
import gc
import math
import time

import numpy as np
import torch

from benchmark import roofline, roofline_active
from benchmark.drivers import engine_rounds as base
from benchmark.harness import Outcome, Run
from benchmark.reference import keyed_log as ref
from benchmark.reference import replicated_log as rl
from benchmark.trace import DeviceTrace, label

COUNTERS = ("active_sched_ticks", "active_fallback_ticks", "active_sched_rows",
            "active_bucket_rows", "active_refetches")


def fnvhash64(v: np.ndarray) -> np.ndarray:
    """YCSB's ``Utils.fnvhash64`` over an array (as int64)."""
    v = v.astype(np.uint64)
    h = np.full(v.shape, 0xCBF29CE484222325, np.uint64)
    for _ in range(8):
        h ^= v & np.uint64(0xFF)
        v >>= np.uint64(8)
        h *= np.uint64(1099511628211)
    return np.abs(h.view(np.int64))


class ScrambledZipfian:
    """YCSB's ``ScrambledZipfianGenerator(0, count - 1)`` at 0.99, a draw
    per uniform in ``u``. The power goes through ``math.pow``, as one draw
    at a time does: numpy's ``power`` differs from it in the last bit of
    some results, and the truncated item number with it."""

    ZETAN = 26.46902820178302
    ITEMS = 10_000_000_000 + 1
    THETA = 0.99

    def __init__(self, count: int):
        self.count = count
        self.alpha = 1.0 / (1.0 - self.THETA)
        zeta2 = 1.0 + 1.0 / math.pow(2.0, self.THETA)
        self.eta = ((1 - math.pow(2.0 / self.ITEMS, 1 - self.THETA))
                    / (1 - zeta2 / self.ZETAN))
        self.second = 1.0 + math.pow(0.5, self.THETA)

    def draw(self, u: np.ndarray) -> np.ndarray:
        """Record numbers in ``[0, count)``."""
        x = (self.eta * u - self.eta + 1).tolist()
        pw = np.fromiter((math.pow(b, self.alpha) for b in x), np.float64, len(x))
        item = (self.ITEMS * pw).astype(np.int64)
        uz = u * self.ZETAN
        item = np.where(uz < 1.0, 0, np.where(uz < self.second, 1, item))
        return np.fmod(fnvhash64(item), self.count)


def key_bytes(numbers) -> list[bytes]:
    return [b"user%d" % n for n in numbers]


def murmur2(keys: list[bytes]) -> np.ndarray:
    """Kafka's ``Utils.murmur2`` of each key, as uint32, a length at a
    time."""
    m = np.uint32(0x5BD1E995)
    out = np.zeros(len(keys), np.uint32)
    lengths = np.fromiter(map(len, keys), np.int64, len(keys))
    for n in np.unique(lengths).tolist():
        at = np.nonzero(lengths == n)[0]
        data = np.frombuffer(b"".join(keys[i] for i in at), np.uint8).reshape(len(at), n)
        h = np.full(len(at), 0x9747B28C ^ n, np.uint32)
        words = np.ascontiguousarray(data[:, :n & ~3]).view("<u4")
        for w in range(n // 4):
            k = words[:, w] * m
            k ^= k >> np.uint32(24)
            h = (h * m) ^ (k * m)
        tail = data[:, n & ~3:].astype(np.uint32)
        if n & 3:
            for j in range((n & 3) - 1, -1, -1):
                h ^= tail[:, j] << np.uint32(8 * j)
            h = h * m
        h ^= h >> np.uint32(13)
        h = h * m
        h ^= h >> np.uint32(15)
        out[at] = h
    return out


class KeyedCluster(base.Cluster):
    """``engine_rounds.Cluster`` with the active-set scheduler as the
    configuration states, and the topic's partitioner."""

    def __init__(self, cfg: dict, seed: int, device: torch.device, control: bool):
        from josefine_tpu_torch.models.types import step_params
        from josefine_tpu_torch.raft.engine import RaftEngine
        from josefine_tpu_torch.utils.kv import MemKV

        self.P, self.N = cfg["groups"], cfg["replication_factor"]
        params = step_params(timeout_min=cfg["timeout_min"], timeout_max=cfg["timeout_max"],
                             hb_ticks=cfg["hb_ticks"], device=device)
        self.fsms = [base._Recorder() for _ in range(self.N)]
        self.engines = [
            RaftEngine(MemKV(), list(range(self.N)), i, groups=self.P, params=params,
                       fsms=dict.fromkeys(range(self.P), self.fsms[i]),
                       sparse_io=cfg["sparse_io"], active_set=cfg["active_set"],
                       base_seed=seed % (2 ** 31 - 1), device=device)
            for i in range(self.N)]
        if control:
            claim = {g: {0} for g in range(1, self.P)}
            for e in self.engines:
                e.configure_groups(claim)
        self.rows = [0] * self.N

    def partition(self, numbers: np.ndarray) -> np.ndarray:
        """The group of each key: ``DefaultPartitioner`` over the topic."""
        h = murmur2(key_bytes(numbers.tolist())) & np.uint32(0x7FFFFFFF)
        return 1 + (h.astype(np.int64) % (self.P - 1))


class Producer:
    """One producer: every round ``messages_per_round`` keyed records,
    offered to their partitions' leaders."""

    def __init__(self, traffic: dict, seed: int):
        self.rng = np.random.default_rng(seed & (2 ** 64 - 1))
        self.keys = ScrambledZipfian(traffic["recordcount"])
        self.n = traffic["messages_per_round"]
        self.rest = traffic["message_bytes"] - rl.PAYLOAD_HEAD.size - ref.KEY.size

    def offer(self, cl: KeyedCluster, book: base.Book, timed: bool) -> None:
        numbers = fnvhash64(self.keys.draw(self.rng.random(self.n)))
        groups = cl.partition(numbers)
        rest = self.rest
        blob = self.rng.bytes(rest * self.n)
        t = time.perf_counter()
        for j, (g, k) in enumerate(zip(groups.tolist(), numbers.tolist())):
            i, e = cl.leader(g)
            if e is None:
                continue
            payload = rl.make_payload(g, len(book.group),
                                      ref.KEY.pack(k) + blob[j * rest:(j + 1) * rest])
            book.add(g, payload, e.propose(g, payload), t, timed)
            cl.rows[i] += 1


def counters(engines) -> dict:
    """The scheduler's counters summed over the engines (None where the
    program has no such counter)."""
    out = {}
    for name in COUNTERS:
        vals = [getattr(e, name, None) for e in engines]
        out[name] = None if None in vals else sum(vals)
    return out


def _delta(a: dict, b: dict) -> dict:
    return {k: None if a[k] is None else b[k] - a[k] for k in a}


async def _drive(run: Run) -> Outcome:
    cfg, tr, dev = run.config, run.traffic, run.device
    cl = KeyedCluster(cfg, run.seed, dev, run.control)
    t_built = time.perf_counter()
    producer = Producer(tr, run.seed)
    book = base.Book()
    settle = book.settle

    def offer(timed: bool) -> None:
        producer.offer(cl, book, timed)

    for r in range(400):
        cl.round()
        if r % 4 == 3 and (cl.leaders_per_group() == 1).all():
            break
    else:
        raise AssertionError("not every group elected one leader")
    t_elected = time.perf_counter()
    warm = counters(cl.engines)
    for _ in range(tr["warmup_rounds"]):
        with label("propose"):
            offer(False)
        cl.round()
        settle()
    warm = _delta(warm, counters(cl.engines))
    if run.trace:
        for e in cl.engines:
            e.enable_profiling().reset()
    t_warm = time.perf_counter()
    gc.collect()
    if run.fault is not None:
        run.fault(cl)

    in_flight = len(book.pending)
    first = len(book.group)
    before = counters(cl.engines)
    t_start = time.perf_counter()
    rounds = 0
    while True:
        offer(True)
        cl.round()
        t_end = settle()
        rounds += 1
        if t_end - t_start >= run.seconds:
            break
    sched = _delta(before, counters(cl.engines))
    obs = {"setup_s": t_start - run.t0, "window_s": t_end - t_start, "rounds": rounds,
           "scheduler": sched}
    obs["diagnostics"] = {"setup_to_engines_s": t_built - run.t0,
                          "setup_to_elected_s": t_elected - run.t0,
                          "election_rounds": r + 1,
                          "warmup_s": t_warm - t_elected,
                          "collect_s": t_start - t_warm,
                          "warmup_scheduler": warm,
                          "round_ms": 1e3 * (t_end - t_start) / rounds,
                          "scheduler": sched}
    obs["acked"] = sum(s == "acked" and t_start <= t <= t_end
                       for s, t in zip(book.status, book.t_done))
    obs["window_proposals"] = len(book.group) - first
    obs["in_flight_at_start"] = in_flight

    def answer() -> None:
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
        for _ in range(tr["warmup_rounds"] // 4):
            offer(False)
            cl.round()
            settle()
        ticks, step_bytes = [], 0
        with DeviceTrace(dev) as t:
            for _ in range(tr["trace_rounds"]):
                with label("propose"):
                    offer(False)
                rows = list(cl.rows)
                seen = [(e.active_sched_ticks, e.active_sched_rows) for e in cl.engines]
                cl.round()
                for e, (n0, a0), r in zip(cl.engines, seen, rows):
                    if e.active_sched_ticks > n0:
                        a = e.active_sched_rows - a0
                        k = e._last_bucket_k if a else 0
                        ticks.append(["compacted", k])
                        step_bytes += roofline_active.compacted_bytes(cl.P, cl.N, k, a)
                    else:
                        ticks.append(["fallback", 0])
                        step_bytes += roofline.step_bytes(cl.P, cl.N, r)
                with label("settle"):
                    settle()
        traced = t.reduce()
        obs["traced_engine_ticks"] = len(ticks)
        obs["traced_ticks"] = ticks
        obs["step_bytes"] = step_bytes
        answer()
    for _ in range(cfg["hb_ticks"] + 4):
        cl.round()
    settle()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    replicas = cl.outputs(sorted(set(book.group)))
    proposals = list(zip(book.group, book.payload, book.status))
    P = cl.P
    del cl, book
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    counts = ref.compare(proposals, replicas, P)
    return Outcome(obs=obs, attempted=len(timed),
                   failed=sum(proposals[i][2] != "acked" for i in timed),
                   checks={name: (v, 0) for name, v in counts.items()},
                   memory_peak_bytes=peak, traced=traced)


def run(run: Run) -> Outcome:
    return asyncio.run(_drive(run))
