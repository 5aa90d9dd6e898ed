"""Node benchmark of the PyTorch port: three full nodes over loopback TCP
serving one Kafka producer.

The deployment is the shape of the OpenMessaging Benchmark's Kafka
workload ``workloads/1-topic-100-partitions-1kb.yaml`` (1 topic, 100
partitions, 1 KB messages, 1 producer) under its Kafka driver's settings
``driver-kafka/kafka.yaml`` (replication factor 3, producer ``acks=all``).

* **Nodes.** Three port nodes, each started through
  ``josefine_with_config`` from the port's multi-node example TOMLs
  (``josefine_tpu_torch/examples/multi-node/node-{1,2,3}.toml``) with their
  ports and directories rewritten, ``engine.device`` set and
  ``engine.partitions = 128``: row 0 for the metadata group, 100 partition
  rows, spare rows (dense IO). Each node ticks on the wall clock
  (``tick_ms`` of the TOML: 100 ms), speaks raft and Kafka over loopback
  TCP, and keeps its state (SQLite) and segment logs in a temporary
  directory.
* **Traffic.** One idempotent producer (``InitProducerId``, one sequence
  per partition, as a Kafka producer with ``enable.idempotence``, its
  default since Kafka 3.0) over the port's ``kafka.client``. Closed loop:
  each partition has one batch in flight, sent to the leader the last
  Metadata answer named, and sent again after a Metadata refresh on
  ``NOT_LEADER_OR_FOLLOWER``. Each partition has a connection of its own to
  its leader: the broker serves one connection's requests one at a time,
  and one Produce request's partitions one after another (each waits for
  its commit), so a Kafka producer's one request per broker would hold
  every partition to one commit at a time. A batch is 16 records of 1,024 bytes made
  from ``seed`` (16 KB, Kafka's default ``batch.size``); 20 batches per
  partition. The last ``traced`` batches of every partition run under
  ``torch.profiler`` for the card's idle share; throughput and latency
  come from the batches before them.
* **Read back.** Then every partition is fetched from all three nodes.

Gates (any failure raises): every acknowledged batch is read back from all
three nodes' logs at its offset, byte for byte, with no record missing or
duplicated; no handler or tick loop logged an error and no node stopped on
its own; each partition's group has exactly one leader among the nodes.

Run on the card::

    python -m josefine_tpu_torch.bench_node

``--device cpu --partitions 8 --batches 4`` runs it on the host at a toy
size; its numbers are host numbers. Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import pathlib
import tempfile
import time

import numpy as np
import torch

from josefine_tpu_torch import josefine_with_config, load_config
from josefine_tpu_torch import node as node_mod
from josefine_tpu_torch.bench_engine import _busy_ms
from josefine_tpu_torch.broker import records
from josefine_tpu_torch.kafka import client as kafka_client
from josefine_tpu_torch.kafka.codec import ApiKey, ErrorCode
from josefine_tpu_torch.models.types import resolve_device
from josefine_tpu_torch.utils.net import bound_sockets
from josefine_tpu_torch.utils.shutdown import Shutdown

EXAMPLES = pathlib.Path(__file__).resolve().parent / "examples" / "multi-node"
TOPIC = "omb-1-topic-100-partitions-1kb"
PARTITIONS = 100
ENGINE_PARTITIONS = 128
BATCHES = 20
RECORDS = 16
RECORD_BYTES = 1024
TRACED = 2
READY_S = 180.0      # most wall seconds for the brokers and the partition leaders
REQUEST_S = 60.0     # most wall seconds for one request


class _ErrorWatch(logging.Handler):
    """Every ERROR record of the ``josefine`` loggers: a crashed handler or
    tick loop logs one."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list[str] = []

    def emit(self, record) -> None:
        self.records.append(f"{record.name}: {record.getMessage()}")


@contextlib.contextmanager
def _watching_errors():
    watch = _ErrorWatch()
    logging.getLogger("josefine").addHandler(watch)
    try:
        yield watch
    finally:
        logging.getLogger("josefine").removeHandler(watch)


@contextlib.contextmanager
def _recording_nodes(into: list):
    """Within: every ``Node`` built is appended to ``into`` (the bench
    starts nodes through ``josefine_with_config``, which keeps them)."""
    init = node_mod.Node.__init__

    def record(self, *args, **kw):
        init(self, *args, **kw)
        into.append(self)

    node_mod.Node.__init__ = record
    try:
        yield
    finally:
        node_mod.Node.__init__ = init


def _configs(root: pathlib.Path, device: str, engine_partitions: int) -> list:
    """The multi-node example TOMLs with free ports, directories under
    ``root``, ``device`` and ``engine_partitions``, loaded."""
    socks, ports = bound_sockets(6)
    for s in socks:
        s.close()
    subs = {"port = 6669": f"port = {ports[0]}", "port = 6670": f"port = {ports[1]}",
            "port = 6671": f"port = {ports[2]}", "port = 8844": f"port = {ports[3]}",
            "port = 8845": f"port = {ports[4]}", "port = 8846": f"port = {ports[5]}",
            '"/tmp/josefine-tpu-torch/multi': f'"{root}',
            'device = "cuda"': f'device = "{device}"',
            "partitions = 1\n": f"partitions = {engine_partitions}\n"}
    cfgs = []
    for i in (1, 2, 3):
        toml = (EXAMPLES / f"node-{i}.toml").read_text()
        for old, new in subs.items():
            toml = toml.replace(old, new)
        path = root / f"node-{i}.toml"
        path.write_text(toml)
        cfgs.append(load_config(path))
    return cfgs


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else float("nan")


async def _bench(root: pathlib.Path, dev: torch.device, seed: int, partitions: int,
                 batches: int, traced: int) -> dict:
    cfgs = _configs(root, str(dev), ENGINE_PARTITIONS)
    nodes: list = []
    shutdown = Shutdown()
    t0 = time.perf_counter()
    with _recording_nodes(nodes):
        tasks = [asyncio.create_task(josefine_with_config(c, shutdown.clone())) for c in cfgs]
        while len(nodes) < len(cfgs):
            await asyncio.sleep(0.01)
            for t in tasks:
                if t.done():
                    t.result()
    nodes.sort(key=lambda n: n.config.raft.id)
    engines = [n.raft.engine for n in nodes]
    ports = [c.broker.port for c in cfgs]
    conns: dict[tuple[int, int], kafka_client.KafkaClient] = {}

    def alive() -> None:
        for t in tasks:
            if t.done():
                t.result()
                raise AssertionError("a node stopped on its own")

    async def conn(node_id: int, lane: int = -1) -> kafka_client.KafkaClient:
        """The connection of ``lane`` (a partition, or -1 for metadata and
        reads) to node ``node_id``."""
        if (node_id, lane) not in conns:
            conns[node_id, lane] = await kafka_client.connect("127.0.0.1",
                                                              ports[node_id - 1])
        return conns[node_id, lane]

    async def metadata() -> dict:
        c = await conn(1)
        return await c.send(ApiKey.METADATA, 4, {"topics": [{"name": TOPIC}],
                                                 "allow_auto_topic_creation": False},
                            timeout=REQUEST_S)

    # Frames and bytes the raft transports write (length prefix included).
    wire = {"frames": 0, "bytes": 0}

    def counted(inner):
        def materialize(peer_id, msg):
            body = inner(peer_id, msg)
            if body is not None:
                wire["frames"] += 1
                wire["bytes"] += len(body) + 4
            return body
        return materialize

    try:
        # ---- the brokers register, the topic is created, every partition elects
        deadline = time.perf_counter() + READY_S
        while True:
            alive()
            try:
                md = await metadata()
                if len(md["brokers"]) == 3:
                    break
            except OSError:
                pass
            if time.perf_counter() > deadline:
                raise AssertionError("the three brokers never registered")
            await asyncio.sleep(0.1)
        c = await conn(1)
        r = await c.send(ApiKey.CREATE_TOPICS, 1, {
            "topics": [{"name": TOPIC, "num_partitions": partitions, "replication_factor": 3,
                        "assignments": [], "configs": []}],
            "timeout_ms": 60_000, "validate_only": False}, timeout=REQUEST_S)
        if r["topics"][0]["error_code"] != ErrorCode.NONE:
            raise AssertionError(f"CreateTopics: {r}")
        while True:
            alive()
            md = await metadata()
            parts = md["topics"][0]["partitions"]
            if len(parts) == partitions and all(p["leader_id"] > 0 for p in parts):
                break
            if time.perf_counter() > deadline:
                raise AssertionError("not every partition elected a leader")
            await asyncio.sleep(0.1)
        ready_s = time.perf_counter() - t0
        leader = {p["partition_index"]: p["leader_id"] for p in parts}
        pid = (await c.send(ApiKey.INIT_PRODUCER_ID, 0, {
            "transactional_id": None, "transaction_timeout_ms": 60_000},
            timeout=REQUEST_S))["producer_id"]
        for n in nodes:
            n.raft.transport._materialize = counted(n.raft.transport._materialize)

        # ---- the producer: one batch in flight per partition
        rng = np.random.default_rng(seed)
        payloads = rng.integers(0, 256, (partitions, batches, RECORDS * RECORD_BYTES),
                                dtype=np.uint8)
        acked: dict[int, list[tuple[int, bytes]]] = {p: [] for p in range(partitions)}
        lat_ms: list[float] = []
        stats = {"retried": 0, "refreshes": 0}
        refresh = asyncio.Lock()

        async def refresh_leaders() -> None:
            async with refresh:
                stats["refreshes"] += 1
                md = await metadata()
                leader.update({p["partition_index"]: p["leader_id"]
                               for p in md["topics"][0]["partitions"]})

        async def producer(p: int, first: int, last: int, timed: bool) -> None:
            for b in range(first, last):
                batch = records.build_batch(payloads[p, b].tobytes(), RECORDS, pid=pid,
                                            epoch=0, base_seq=b * RECORDS)
                t = time.perf_counter()
                while True:
                    if leader.get(p, -1) < 1:
                        await asyncio.sleep(0.05)
                        await refresh_leaders()
                        continue
                    c = await conn(leader[p], p)
                    r = await c.send(ApiKey.PRODUCE, 3, {
                        "transactional_id": None, "acks": -1, "timeout_ms": 30_000,
                        "topics": [{"name": TOPIC, "partitions": [
                            {"index": p, "records": batch}]}]}, timeout=REQUEST_S)
                    got = r["responses"][0]["partitions"][0]
                    if got["error_code"] == ErrorCode.NONE:
                        break
                    if got["error_code"] != ErrorCode.NOT_LEADER_OR_FOLLOWER:
                        raise AssertionError(f"produce to partition {p}: {got}")
                    stats["retried"] += 1
                    await refresh_leaders()
                acked[p].append((got["base_offset"], batch))
                if timed:
                    lat_ms.append((time.perf_counter() - t) * 1e3)

        def ticks() -> list[int]:
            return [e._ticks for e in engines]

        for e in engines:
            e.enable_profiling().reset()
        timed_batches = batches - traced
        ticks0, wire0 = ticks(), dict(wire)
        t_start = time.perf_counter()
        await asyncio.gather(*(producer(p, 0, timed_batches, True) for p in range(partitions)))
        wall_s = time.perf_counter() - t_start
        alive()
        node_ticks = [b - a for a, b in zip(ticks0, ticks())]
        frames, nbytes = wire["frames"] - wire0["frames"], wire["bytes"] - wire0["bytes"]
        phases: dict = {}
        for e in engines:
            for phase, st in e.profiler.snapshot().items():
                agg = phases.setdefault(phase, {"count": 0, "total_ms": 0.0})
                agg["count"] += st["count"]
                agg["total_ms"] += st["total_ms"]
        mean_ticks = sum(node_ticks) / len(node_ticks)
        for agg in phases.values():
            agg["ms_per_tick"] = agg["total_ms"] / mean_ticks

        busy = None
        if traced:
            if dev.type == "cuda":
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize(dev)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    traced_ticks0 = ticks()
                    await asyncio.gather(*(producer(p, timed_batches, batches, False)
                                           for p in range(partitions)))
                    torch.cuda.synchronize(dev)
                    traced_wall_ms = (time.perf_counter() - t) * 1e3
                    traced_ticks = [b - a for a, b in zip(traced_ticks0, ticks())]
                busy_ms = _busy_ms(prof.events())
                busy = {"batches": traced * partitions, "ticks": traced_ticks,
                        "wall_ms": traced_wall_ms, "busy_ms": busy_ms,
                        "idle_share": 1 - busy_ms / traced_wall_ms}
            else:
                await asyncio.gather(*(producer(p, timed_batches, batches, False)
                                       for p in range(partitions)))
        alive()

        # ---- read back from every node
        fetch_ms: list[float] = []
        want = {p: b"".join(records.set_base_offset(batch, o) for o, batch in acked[p])
                for p in range(partitions)}
        end = batches * RECORDS
        bad = []

        async def read_node(node_id: int) -> None:
            c = await conn(node_id)
            for p in range(partitions):
                t = time.perf_counter()
                r = await c.send(ApiKey.FETCH, 4, {
                    "replica_id": -1, "max_wait_ms": 0, "min_bytes": 1, "max_bytes": 1 << 24,
                    "isolation_level": 0, "topics": [{"topic": TOPIC, "partitions": [
                        {"partition": p, "fetch_offset": 0,
                         "partition_max_bytes": 1 << 23}]}]}, timeout=REQUEST_S)
                fetch_ms.append((time.perf_counter() - t) * 1e3)
                got = r["responses"][0]["partitions"][0]
                if got["error_code"] != ErrorCode.NONE or got["high_watermark"] != end \
                        or (got["records"] or b"") != want[p]:
                    bad.append((node_id, p, got["error_code"], got["high_watermark"]))

        # A follower may apply the last commit a tick after the leader
        # answered: read until every log holds every batch, for a while.
        deadline = time.perf_counter() + REQUEST_S
        while True:
            bad.clear()
            fetch_ms.clear()
            await asyncio.gather(*(read_node(n.config.raft.id) for n in nodes))
            if not bad or time.perf_counter() > deadline:
                break
            await asyncio.sleep(0.2)
        if bad:
            raise AssertionError(f"{len(bad)} partition logs are not the acknowledged "
                                 f"batches, e.g. (node, partition, error, hw) {bad[:4]}")
        led = np.sum([[e.is_leader(p.group) for p in nodes[0].store.get_partitions(TOPIC)]
                      for e in engines], axis=0)
        if not (led == 1).all():
            raise AssertionError(f"leaders per partition group: {np.bincount(led)}")
        alive()
    finally:
        for c in conns.values():
            await c.close()
        shutdown.shutdown()
        await asyncio.gather(*tasks, return_exceptions=True)

    n_timed = partitions * (batches - traced)
    return {
        "metric": "node_kafka_acked",
        "workload": "OpenMessaging Benchmark workloads/1-topic-100-partitions-1kb.yaml "
                    "shape, driver-kafka/kafka.yaml settings",
        "device": str(dev),
        "card": None,
        "nodes": 3,
        "partitions": partitions,
        "engine_partitions": engines[0].P,
        "replication_factor": 3,
        "acks": "all",
        "batch_records": RECORDS,
        "record_bytes": RECORD_BYTES,
        "batches_per_partition": batches,
        "batches_acked": sum(len(v) for v in acked.values()),
        "records_acked": sum(len(v) for v in acked.values()) * RECORDS,
        "timed_batches": n_timed,
        "records_per_sec": n_timed * RECORDS / wall_s,
        "mb_per_sec": n_timed * RECORDS * RECORD_BYTES / wall_s / 1e6,
        "timed_wall_s": wall_s,
        "produce_latency_ms": {"p50": _pct(lat_ms, 50), "p99": _pct(lat_ms, 99),
                               "n": len(lat_ms)},
        "fetch_latency_ms": {"p50": _pct(fetch_ms, 50), "p99": _pct(fetch_ms, 99),
                             "n": len(fetch_ms)},
        "ms_per_tick": [wall_s * 1e3 / t for t in node_ticks],
        "ticks": node_ticks,
        "tick_ms_configured": cfgs[0].raft.tick_ms,
        "profile_phases": dict(sorted(phases.items())),
        "frames_per_tick": frames / mean_ticks,
        "bytes_per_tick": nbytes / mean_ticks,
        "retried": stats["retried"],
        "metadata_refreshes": stats["refreshes"],
        "ready_s": ready_s,
        "device_busy": busy,
    }


def run(partitions: int = PARTITIONS, batches: int = BATCHES, traced: int = TRACED,
        seed: int = 0, device="cuda") -> dict:
    """The benchmark of the module docstring; returns its row: acknowledged
    records/s and MB/s, produce and fetch latency at the client (p50/p99
    ms), each node's ms per tick, the engines' host ms per phase per tick,
    raft frames and bytes per tick, and on the card its busy and idle share
    over the traced batches."""
    dev = resolve_device(device)
    if traced >= batches:
        raise ValueError("traced must leave timed batches")
    with tempfile.TemporaryDirectory(prefix="bench_node_") as td, _watching_errors() as errors:
        row = asyncio.run(_bench(pathlib.Path(td), dev, seed, partitions, batches, traced))
    if errors.records:
        raise AssertionError(f"{len(errors.records)} errors logged, e.g. {errors.records[:3]}")
    if dev.type == "cuda":
        from josefine_tpu_torch.bench import card_label

        row["card"] = card_label()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--partitions", type=int, default=PARTITIONS)
    ap.add_argument("--batches", type=int, default=BATCHES)
    ap.add_argument("--traced", type=int, default=TRACED)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.partitions, args.batches, args.traced, args.seed,
                         args.device)), flush=True)


if __name__ == "__main__":
    main()
