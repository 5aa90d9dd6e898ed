"""The keyed YCSB-Zipfian benchmark cell and the active-set scheduler's
counters, on the CPU at toy size.

The cell (``benchmark/drivers/engine_rounds_keyed.py``) produces keyed
records from YCSB's scrambled Zipfian onto Kafka's murmur2 partitions of a
cluster whose engines run the active-set scheduler; its reference
(``benchmark/reference/keyed_log.py``) adds Kafka's per-key guarantee to
the replicated log's. Held here: a sound run reads 0 everywhere, with more
compacted ticks than fallbacks; the same seed with the scheduler off
commits and applies the same bytes on every replica; the driver's
vectorised generator and partitioner equal the reference's plain ones; a
misrouted key, two swapped records of one key and the RF-1 control are
caught; the engine's ``active_bucket_rows`` and refetch span count what
they say; the readers of the cell's new metrics, and ``raft.step_roofline``
over the frozen bytes this driver counts.
"""

import asyncio
import copy
import importlib.util
import json
import pathlib
import shutil
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import harness, roofline_active  # noqa: E402
from benchmark.drivers import engine_rounds as base  # noqa: E402
from benchmark.drivers import engine_rounds_keyed as keyed  # noqa: E402
from benchmark.reference import keyed_log as kl  # noqa: E402
from benchmark.reference import replicated_log as rl  # noqa: E402
from josefine_tpu_torch.raft.packed_step import active_bucket  # noqa: E402

CPU = torch.device("cpu")
CELL = "raft100k5-active.ycsb_zipf099"
CONFIG = json.loads((REPO / "benchmark/configs/raft100k-rf5-active.json").read_text())
TRAFFIC = json.loads((REPO / "benchmark/traffic/ycsb_zipf099_1kb.json").read_text())
P = 257
SEED = 2 ** 33 + 20
# Toy sizes of the cell for whole runs through the harness.
TOY_CONFIG = {"groups": P}
TOY_TRAFFIC = {"messages_per_round": 32, "warmup_rounds": 4, "trace_rounds": 2,
               "answer_wait_s": 5}


# ------------------------------------------------- rounds driven directly


def _drive(active: bool, rounds: int = 30) -> dict:
    """30 keyed rounds of 32 records on 5 engines at P = 257, then rounds
    until every proposal is answered and a heartbeat interval more."""
    cfg = dict(CONFIG, groups=P, active_set=active)
    cl = keyed.KeyedCluster(cfg, SEED, CPU, False)
    sizes = [[] for _ in cl.engines]
    for e, log in zip(cl.engines, sizes):
        real = e._schedule_active

        def schedule(window, pf, real=real, log=log):
            G = real(window, pf)
            log.append(None if G is None else len(G))
            return G

        e._schedule_active = schedule
        e.enable_profiling()
    producer = keyed.Producer(dict(TRAFFIC, messages_per_round=32), SEED)
    book = base.Book()

    async def go():
        for r in range(400):
            cl.round()
            if r % 4 == 3 and (cl.leaders_per_group() == 1).all():
                break
        for _ in range(rounds):
            producer.offer(cl, book, True)
            cl.round()
            book.settle()
        for _ in range(200):
            if not book.pending:
                break
            cl.round()
            book.settle()
        for _ in range(cfg["hb_ticks"] + 4):
            cl.round()
        book.settle()

    asyncio.run(go())
    for e in cl.engines:
        e._publish_telemetry()
    proposals = list(zip(book.group, book.payload, book.status))
    return {"outputs": cl.outputs(sorted(set(book.group))), "proposals": proposals,
            "counters": keyed.counters(cl.engines), "sizes": sizes,
            "per_engine": [(e.active_bucket_rows, e.active_refetches,
                            e.profiler.snapshot().get("compact/refetch", {}).get("count", 0))
                           for e in cl.engines]}


@pytest.fixture(scope="module")
def runs():
    return {"active": _drive(True), "plain": _drive(False)}


def test_a_sound_keyed_run_reads_zero_with_more_compacted_ticks(runs):
    r = runs["active"]
    counts = kl.compare(r["proposals"], r["outputs"], P)
    assert set(counts) == set(kl.CHECKS)
    assert set(counts.values()) == {0}, counts
    assert all(s == "acked" for _, _, s in r["proposals"])
    c = r["counters"]
    assert c["active_sched_ticks"] > c["active_fallback_ticks"] > 0, c
    # Hot keys: some group took several records in one round.
    per_round = [g for g, _, _ in r["proposals"][:32]]
    assert max(np.bincount(per_round)) > 1


def test_the_scheduler_off_commits_and_applies_the_same_bytes(runs):
    a, b = runs["active"], runs["plain"]
    assert [p for _, p, _ in a["proposals"]] == [p for _, p, _ in b["proposals"]]
    assert a["outputs"] == b["outputs"]
    assert b["counters"]["active_sched_ticks"] == 0
    assert b["counters"]["active_fallback_ticks"] == 0


def test_bucket_rows_sum_the_buckets_of_the_compacted_ticks(runs):
    r = runs["active"]
    for sizes, (bucket_rows, refetches, spans) in zip(r["sizes"], r["per_engine"]):
        # An all-quiescent tick (no active row) gathers no bucket.
        assert bucket_rows == sum(active_bucket(n, P) for n in sizes if n)
        # One refetch, and one compact/refetch span, per schedule that
        # follows a fallback tick.
        after_fallback = sum(prev is None for prev in sizes[:-1])
        assert refetches == spans == after_fallback > 0


def test_the_engines_count_no_bucket_rows_with_the_scheduler_off(runs):
    assert all(row == (0, 0, 0) for row in runs["plain"]["per_engine"])


def test_the_round_breakdown_tool_names_every_round():
    spec = importlib.util.spec_from_file_location("keyed_rounds", REPO / "tools" / "keyed_rounds.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    lines = tool.rounds(SEED, 20, CPU, groups=P)
    kinds = [json.loads(line) for line in lines if line.startswith("{")]
    assert sum(k["n"] for k in kinds) == 20
    # 512 records a round wake most of 257 groups: rounds fall back.
    assert {k["kind"] for k in kinds} <= {"normal", "heartbeat", "fallback", "re-entry"}
    assert all(any(m.startswith("F") for m in k["modes"])
               for k in kinds if k["kind"] == "fallback")
    sequence = next(line for line in lines if line.startswith("sequence "))
    assert len(sequence.split()[1]) == 20


# ------------------------------------------- generator and partitioner


def test_the_vectorised_generator_and_partitioner_equal_the_plain_ones():
    u = np.random.default_rng(20260418).random(100_000)
    records = keyed.ScrambledZipfian(10_000_000).draw(u)
    plain = kl.ScrambledZipfianGenerator(0, 10_000_000 - 1)
    assert records.tolist() == [plain.next_value(x) for x in u.tolist()]
    numbers = keyed.fnvhash64(records)
    assert numbers.tolist() == [kl.fnvhash64(n) for n in records.tolist()]
    keys = keyed.key_bytes(numbers.tolist())
    assert keys[:2] == [kl.key_bytes(n) for n in numbers[:2].tolist()]
    assert keyed.murmur2(keys).tolist() == [kl.murmur2(k) & 0xFFFFFFFF for k in keys]

    class Topic:
        P = 100_000

    groups = keyed.KeyedCluster.partition(Topic, numbers)
    assert groups.tolist() == [kl.group_of(n, 100_000) for n in numbers.tolist()]
    assert groups.min() >= 1 and groups.max() <= 99_999
    # The skew the cell is sized by: a round of 1,000 keys touches
    # ~840 partitions, the hottest taking tens.
    _, per = np.unique(groups[:1000], return_counts=True)
    assert 700 < len(per) < 950 and per.max() >= 10


@pytest.mark.parametrize("data,want", [
    (b"21", -973932308), (b"foobar", -790332482),
    (b"a-little-bit-long-string", -985981536),
    (b"a-little-bit-longer-string", -1486304829),
    (b"lkjh234lh9fiuh90y23oiuhsafujhadof229phr9h19h89h8", -58897971),
    (b"abc", 479470107)])
def test_murmur2_equals_kafkas(data, want):
    """Kafka's own cases for ``Utils.murmur2`` (its ``UtilsTest``)."""
    assert kl.murmur2(data) == want
    assert int(keyed.murmur2([data])[0]) == want & 0xFFFFFFFF


def test_fnvhash64_and_the_zipfian_head():
    h = 0xCBF29CE484222325
    for _ in range(8):
        h = h * 1099511628211 % (1 << 64)
    assert kl.fnvhash64(0) == abs(h - (1 << 64) if h >> 63 else h)
    z = kl.ZipfianGenerator(0, 10 ** 10, 0.99, 26.46902820178302)
    assert z.next_long(0.0) == 0 and z.next_long(0.03) == 0
    assert z.next_long(1.5 / z.zetan) == 1
    assert z.next_long(0.999999) > 10 ** 6
    assert keyed.fnvhash64(np.array([0, 1, 10 ** 10])).tolist() == [
        kl.fnvhash64(0), kl.fnvhash64(1), kl.fnvhash64(10 ** 10)]


# ------------------------------------------------- the reference alone


def _payload(g, serial, key):
    return rl.make_payload(g, serial, kl.KEY.pack(key) + b"x" * 8)


GROUPS = 97


def _keyed(moved: int | None = None):
    """Two keys of one partition and one of another, three replicas, every
    record acknowledged; the records of key ``moved``, if given, made for
    and committed on the next group instead of the key's own."""
    home = {k: kl.group_of(k, GROUPS) for k in range(1, 400)}
    first = 1
    same = next(k for k in range(2, 400) if home[k] == home[first])
    other = next(k for k in range(2, 400) if home[k] != home[first])
    if moved is not None:
        home[moved] = home[moved] % (GROUPS - 1) + 1
    proposals, chains = [], {}
    for k in (first, same, first, other, same, first):
        g = home[k]
        p = _payload(g, len(proposals), k)
        proposals.append((g, p, "acked"))
        chain = chains.setdefault(g, [])
        bid = (1 << 32) | (len(chain) + 1)
        chain.append((bid, chain[-1][0] if chain else 0, p))
    applied = [p for _, p, _ in proposals]
    replicas = [{"chains": copy.deepcopy(chains), "applied": list(applied)} for _ in range(3)]
    return proposals, replicas, other


def test_keyed_reference_sound_reads_zero():
    proposals, replicas, _ = _keyed()
    assert set(kl.compare(proposals, replicas, GROUPS).values()) == {0}


def test_keyed_reference_catches_a_misplaced_key():
    """A key's record on another partition, consistent everywhere: the
    replicated log reads 0, the keyed guarantee does not."""
    other = _keyed()[2]
    proposals, replicas, _ = _keyed(moved=other)
    n = kl.compare(proposals, replicas, GROUPS)
    assert n["misplaced"] == 3 and sum(n.values()) == 3, n


def test_keyed_reference_catches_two_records_of_a_key_swapped():
    proposals, replicas, _ = _keyed()
    a, b = proposals[0][1], proposals[2][1]
    for r in replicas[:1]:
        i, j = r["applied"].index(a), r["applied"].index(b)
        r["applied"][i], r["applied"][j] = b, a
    assert kl.compare(proposals, replicas, GROUPS)["key_out_of_order"] == 1


# ---------------------------------------------- whole runs, with faults


@pytest.fixture
def toy_root(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    for rel, edits in (("benchmark/configs/raft100k-rf5-active.json", TOY_CONFIG),
                       ("benchmark/traffic/ycsb_zipf099_1kb.json", TOY_TRAFFIC)):
        path = tmp_path / rel
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **edits)))
    return tmp_path


def _run(root, fault=None, control=False, trace=False):
    return harness.execute(CELL, SEED + 1, 1.0, trace, CPU, time.perf_counter(),
                           root=root, control=control, fault=fault)


def test_a_traced_toy_run_of_the_cell(toy_root):
    line, out = _run(toy_root, trace=True)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert set(line["checks"]) == set(kl.CHECKS)
    m = line["metrics"]
    assert {"raft.active_host_ms", "raft.active_fallback_pct",
            "raft.active_fill_pct"} <= set(m), m
    assert 0 < m["raft.active_fill_pct"]["value"] <= 100
    assert 0 <= m["raft.active_fallback_pct"]["value"] < 50
    modes = [mode for mode, _ in out.obs["traced_ticks"]]
    assert len(modes) == 5 * TOY_TRAFFIC["trace_rounds"] and "compacted" in modes
    assert out.obs["step_bytes"] > 0


def test_the_control_misses_records(toy_root):
    line, _ = _run(toy_root, control=True)
    assert not line["correct"] and line["checks"]["missing"]["value"] > 0


def test_a_misrouted_key_is_caught(toy_root, monkeypatch):
    """From the window on, every even key number goes to the next group:
    the replicated log is sound there, so only the keyed counts read it
    (a key that moved mid-stream may also apply out of produce order)."""

    def fault(cl):
        real = cl.partition

        def wrong(numbers):
            g = real(numbers)
            return np.where(numbers % 2 == 0, g % (cl.P - 1) + 1, g)

        monkeypatch.setattr(cl, "partition", wrong)

    line, _ = _run(toy_root, fault=fault)
    checks = {k: c["value"] for k, c in line["checks"].items()}
    assert checks["misplaced"] > 0
    assert all(checks[k] == 0 for k in rl.CHECKS), sorted(checks.items())


class _Later:
    """A proposal's answer once it is proposed (``Book.settle`` reads it)."""

    fut = None

    def done(self):
        return self.fut is not None and self.fut.done()

    def cancelled(self):
        return self.fut.cancelled()

    def exception(self):
        return self.fut.exception()


def test_two_records_of_a_key_swapped_are_caught(toy_root, monkeypatch):
    """One record is held back and proposed right after the next record
    of its key."""

    def fault(cl):
        held = {}

        for e in cl.engines:
            real = e.propose

            def propose(g, payload, real=real):
                k = kl.key_number(payload)
                if "done" not in held:
                    if k not in held:
                        held[k] = (payload, _Later())
                        return held[k][1]
                    first, later = held.pop(k)
                    held["done"] = True
                    fut = real(g, payload)
                    later.fut = real(g, first)
                    return fut
                return real(g, payload)

            monkeypatch.setattr(e, "propose", propose)

    line, _ = _run(toy_root, fault=fault)
    assert line["checks"]["key_out_of_order"]["value"] > 0, line["checks"]


# ------------------------------------------------------------ readers


def _reader(name: str):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


SCHED = {"active_sched_ticks": 180, "active_fallback_ticks": 20, "active_sched_rows": 360_000,
         "active_bucket_rows": 720_000, "active_refetches": 40}
OBS = {"phases": {"compact": 300.0, "compact/refetch": 40.0, "scatter": 60.0, "decay": 40.0,
                  "dispatch": 900.0},
       "rounds": 40, "scheduler": SCHED}
TRACE = {"busy_s": 0.5, "window_s": 2.0, "kernels": 100, "kernel_s": 0.25,
         "device_ops": [], "idle_gaps": []}


@pytest.mark.parametrize("name,obs,want", [
    ("raft.active_host_ms", OBS, 10.0),
    ("raft.active_host_ms", {"phases": {"dispatch": 1.0}, "rounds": 4}, None),
    ("raft.active_host_ms", dict(OBS, rounds=0), None),
    ("raft.active_fallback_pct", OBS, 10.0),
    ("raft.active_fallback_pct", {"scheduler": dict(SCHED, active_sched_ticks=0,
                                                    active_fallback_ticks=0)}, None),
    ("raft.active_fallback_pct", {"scheduler": dict(SCHED, active_fallback_ticks=None)}, None),
    ("raft.active_fill_pct", OBS, 50.0),
    ("raft.active_fill_pct", {"scheduler": dict(SCHED, active_bucket_rows=None)}, None),
    ("raft.active_fill_pct", {"scheduler": dict(SCHED, active_bucket_rows=0)}, None),
    ("raft.step_roofline",
     {"device_trace": TRACE, "device_kind": "NVIDIA H100 80GB HBM3",
      "step_bytes": 3.35e9}, 0.4),
    ("raft.step_roofline",
     {"device_trace": TRACE, "device_kind": "cpu", "step_bytes": 3.35e9}, None),
    ("raft.step_roofline",
     {"device_trace": dict(TRACE, kernel_s=0.0), "device_kind": "NVIDIA H100 80GB HBM3",
      "step_bytes": 1}, None),
])
def test_reader(name, obs, want):
    got = _reader(name)(obs)
    assert got == (pytest.approx(want) if want is not None else None)


def test_the_frozen_bytes_of_an_active_tick():
    # 100,000 groups x 5: a 4,096-row bucket with 2,500 active rows.
    row = 12 * 4 + 1 + 5 * (1 + 4 * 4)
    want = (2 * 4096 * row + 100_000 * 25 + 4096 * 5
            + 2500 * ((4 + 10 * 5 * 4) + (13 + 9 * 5) * 4))
    assert roofline_active.compacted_bytes(100_000, 5, 4096, 2500) == want
    # An all-quiescent tick is the decay alone.
    assert roofline_active.compacted_bytes(100_000, 5, 0, 0) == 100_000 * 25
