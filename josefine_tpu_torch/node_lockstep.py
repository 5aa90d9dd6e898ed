"""A deterministic harness for in-process clusters of full nodes
(``Node``: raft runtime, broker and partition groups), and the Kafka script
two such clusters are given side by side.

It stands on ``raft/lockstep.py``: the asyncio loop runs on its
:class:`~josefine_tpu_torch.raft.lockstep.VirtualClockLoop`, every node
ticks on one shared ``LockstepPacer``, and each side's raft sockets are
replaced by a fixed-order :class:`~josefine_tpu_torch.raft.lockstep.Hop`.
Three more things would make two runs of a node cluster differ, and the
harness takes each away:

* **Topic and partition ids.** The broker mints them with ``uuid4``
  (``broker/handlers.py``). Inside :func:`seeded`, a script call on a side
  draws them from that side's own generator, seeded alike on every side,
  so nothing is masked.
* **The LeaderAndIsr fan-out.** After CreateTopics the controller dials
  every peer's Kafka port. Inside :func:`seeded` that call reaches the
  peer's ``handle_request`` in process, on the caller's side, and a
  stopped peer refuses the connection as its closed port would.
* **Ports.** Every side's configs name side 0's ports, so brokers register
  the same addresses and Metadata and FindCoordinator answer alike. Each
  side's nodes listen on sockets of their own; nothing dials them.

:func:`run_kafka_script` drives the sides: the brokers register,
CreateTopics (replication factor 3) goes to the metadata leader, record
batches made from a numpy seed are produced (``acks=-1``) to each
partition's leader, the metadata leader stops, the survivors re-elect and a
second round is produced, then Fetch from every live replica, Metadata,
ListOffsets, FindCoordinator, OffsetCommit and OffsetFetch. Every request
goes to each side's ``Broker.handle_request``. On every advance the sides
must agree on which requests are answered, and then on every answer, on
every frame of the raft wire (client request ids aside), on every
node's KV (the metadata store and every durable record), every hosted
partition log (bytes, offsets and counts), the chains, the ``_h_*``
mirrors and the engine state. At the end every acknowledged batch must be
in every live replica's log at its offset, byte for byte, with nothing
missing or duplicated.

The harness imports nothing of the nodes it drives: each side is built from
a :class:`Kit` of its own package's pieces.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import copy
import dataclasses
import random
import uuid as _uuid
from typing import Callable

import numpy as np

from josefine_tpu_torch.broker import records
from josefine_tpu_torch.kafka.codec import ApiKey, ErrorCode
from josefine_tpu_torch.models.types import LEADER
from josefine_tpu_torch.raft.lockstep import TIMING, CrashWatch, Hop
from josefine_tpu_torch.utils.net import bound_sockets

TOPIC = "twin"
GROUP_ID = "twin-readers"


@dataclasses.dataclass
class Kit:
    """What a side is built from, all of one package: its ``Node`` class,
    its ``config`` module, its ``broker.handlers`` module, its
    ``rpc.decode_frame``, and ``state_leaves(engine)``, the engine's device
    state as a list of numpy arrays."""

    node: type
    config: object
    handlers: object
    decode_frame: Callable
    state_leaves: Callable


@dataclasses.dataclass
class NodeSide:
    """One cluster of a script: its nodes (index i holds node id i + 1),
    their hop, and the generator its topic and partition ids come from."""

    kit: Kit
    nodes: list
    hop: Hop
    ids: random.Random
    stopped: set = dataclasses.field(default_factory=set)

    def live(self) -> list:
        return [n for n in self.nodes if n.config.raft.id not in self.stopped]


def build_sides(kits: list[Kit], pacer, root, partitions: int, seed: int = 0,
                raft_extra: dict | None = None, engine_kws: list[dict] | None = None
                ) -> list[NodeSide]:
    """Three nodes per kit, all on ``pacer``, data under ``root/side-<i>``,
    the KV in memory. Side 0's sockets give every side's configured ports.
    ``raft_extra`` goes to every ``RaftConfig``, ``engine_kws[i]`` to side
    i's ``EngineConfig`` (with ``partitions``)."""
    sides = []
    ports = None
    for s, kit in enumerate(kits):
        raft_socks, raft_ports = bound_sockets(3)
        broker_socks, broker_ports = bound_sockets(3)
        ports = ports or (raft_ports, broker_ports)
        c = kit.config
        hop = Hop(kit.decode_frame)
        nodes = []
        for i in range(3):
            nid = i + 1
            base = root / f"side-{s}" / f"node-{nid}"
            cfg = c.JosefineConfig(
                raft=c.RaftConfig(id=nid, ip="127.0.0.1", port=ports[0][i],
                                  nodes=[c.NodeAddr(id=o + 1, ip="127.0.0.1", port=ports[0][o])
                                         for o in range(3) if o != i],
                                  data_directory=str(base / "raft"),
                                  **TIMING, **(raft_extra or {})),
                broker=c.BrokerConfig(id=nid, ip="127.0.0.1", port=ports[1][i],
                                      state_file=str(base / "state.db"),
                                      data_directory=str(base / "data")),
                engine=c.EngineConfig(partitions=partitions,
                                      **(engine_kws[s] if engine_kws else {})))
            nodes.append(kit.node(cfg, in_memory=True, pacer=pacer,
                                  raft_sock=raft_socks[i], broker_sock=broker_socks[i],
                                  intercept_send=hop.intercept(nid)))
        sides.append(NodeSide(kit, nodes, hop, random.Random(seed)))
    return sides


# The side whose script call is running (copied into each request's task).
_SIDE: contextvars.ContextVar[NodeSide | None] = contextvars.ContextVar(
    "node_lockstep_side", default=None)


class _SeededUuid:
    """The ``uuid`` module as a package's broker handlers see it inside
    :func:`seeded`: ``uuid4`` draws from the running side's generator."""

    def __getattr__(self, name):
        return getattr(_uuid, name)

    @staticmethod
    def uuid4():
        side = _SIDE.get()
        if side is None:
            return _uuid.uuid4()
        return _uuid.UUID(int=side.ids.getrandbits(128), version=4)


class _InProcessConn:
    def __init__(self, broker):
        self._broker = broker

    async def send(self, api_key, api_version, body, timeout=None):
        return await self._broker.handle_request(int(api_key), api_version,
                                                 copy.deepcopy(body))

    async def close(self) -> None:
        pass


class _InProcessKafka:
    """The Kafka client as a package's broker handlers see it inside
    :func:`seeded`: on a side's script call, ``connect`` reaches that
    side's live node with the configured broker port."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    async def connect(self, host, port, *args, **kw):
        side = _SIDE.get()
        if side is None:
            return await self._real.connect(host, port, *args, **kw)
        for n in side.live():
            if n.config.broker.port == port:
                return _InProcessConn(n.broker.broker)
        raise ConnectionRefusedError(f"broker port {port} is closed")


@contextlib.contextmanager
def seeded(kits: list[Kit]):
    """Within: each kit's broker handlers mint ids from the calling side's
    generator and reach peers in process (see the module docstring)."""
    saved = []
    for mod in {id(k.handlers): k.handlers for k in kits}.values():
        saved.append((mod, mod.uuid, mod.kafka_client))
        mod.uuid = _SeededUuid()
        mod.kafka_client = _InProcessKafka(mod.kafka_client)
    try:
        yield
    finally:
        for mod, u, kc in saved:
            mod.uuid, mod.kafka_client = u, kc


def _difference(a, b, path: str = "") -> str | None:
    """The path of the first difference between two views, or None. A
    zero-copy Fetch answer's ``RecordsSpan`` counts as the bytes it joins."""
    a, b = (x.join() if type(x).__name__ == "RecordsSpan" else x for x in (a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return None if np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype \
            else path
    if isinstance(a, dict) and isinstance(b, dict):
        if list(a) != list(b):
            return f"{path} keys"
        for k in a:
            d = _difference(a[k], b[k], f"{path}/{k}")
            if d is not None:
                return d
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{path} length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = _difference(x, y, f"{path}[{i}]")
            if d is not None:
                return d
        return None
    return None if a == b else path


def _logs(node) -> dict:
    out = {}
    for p in node.store.get_partitions(TOPIC):
        rep = node.broker.broker.replicas.get(TOPIC, p.idx)
        if rep is not None:
            out[p.idx] = (rep.log.next_offset(),
                          [(o, c, bytes(b)) for o, c, b in rep.log.read_from(0, 1 << 62)])
    return out


def node_view(node) -> dict:
    """What the sides compare of a node besides its engine's device state:
    its KV, its partition logs, its chains and its engine's host mirrors."""
    e = node.raft.engine
    return {
        "kv": list(node.kv.scan_prefix(b"")),
        "logs": _logs(node),
        "chains": [(c.head, c.committed, c.floor) for c in e.chains],
        "mirrors": {k: v for k, v in sorted(vars(e).items())
                    if k.startswith("_h_") and isinstance(v, np.ndarray)},
    }


def compare(t: int, sides: list[NodeSide]) -> None:
    """Every live node of every side equals side 0's (see
    :func:`node_view`), its device state included."""
    base = sides[0]
    for s, side in enumerate(sides[1:], 1):
        if side.stopped != base.stopped:
            raise AssertionError(f"tick {t}: side {s} stopped {side.stopped}")
        for a, b in zip(base.live(), side.live()):
            w = f"tick {t} side {s} node {b.config.raft.id}"
            d = _difference(node_view(a), node_view(b))
            if d is not None:
                raise AssertionError(f"{w}: {d} differs")
            for j, (x, y) in enumerate(zip(base.kit.state_leaves(a.raft.engine),
                                           side.kit.state_leaves(b.raft.engine))):
                if not np.array_equal(x, y):
                    raise AssertionError(f"{w}: state leaf {j} differs")


def _leader_of(side: NodeSide, g: int) -> int | None:
    ids = [n.config.raft.id for n in side.live() if n.raft.engine.is_leader(g)]
    return ids[0] if len(ids) == 1 else None


async def run_kafka_script(sides: list[NodeSide], pacer, seed: int, step: int = 1,
                           partitions: int = 4, batches: int = 4, records_per_batch: int = 4,
                           record_bytes: int = 64, limit: int = 600) -> dict:
    """Start every side's nodes and give them the script of the module
    docstring: ``partitions`` partitions, ``batches`` batches of
    ``records_per_batch`` records of ``record_bytes`` bytes per partition
    (half before the metadata leader stops), from ``seed``. An advance is
    ``step`` ticks while every claimed group has one live leader on side 0,
    else one; the hops deliver between advances. After each advance the
    sides' raft wires (client request ids canonicalized by the hop) must be
    equal, and the sides are compared (:func:`compare`). A wait that takes more than ``limit`` ticks fails. Raises on any
    difference, on a failed request, on a crashed tick loop or a node that
    shut down on its own, and if an acknowledged batch is not read back.
    Returns the counts."""
    rng = np.random.default_rng(seed)
    base = sides[0]
    stats = {"ticks": 0, "strided": 0, "requests": 0, "acked": 0, "retried": 0,
             "stopped": None, "compared": 0, "frames": 0}
    acked: dict[int, list[tuple[int, bytes]]] = {p: [] for p in range(partitions)}

    def groups() -> list[int]:
        return [0] + [p.group for p in base.live()[0].store.get_partitions(TOPIC)]

    def led() -> bool:
        return all(_leader_of(base, g) is not None for g in groups())

    def stride() -> int:
        if step == 1:
            return 1
        roles = np.stack([n.raft.engine._h_role for n in base.live()])
        return step if ((roles[:, groups()] == LEADER).sum(axis=0) == 1).all() else 1

    async def advance() -> None:
        n = stride()
        await pacer.advance(n)
        stats["ticks"] += n
        stats["strided"] += n > 1
        wires = [side.hop.deliver() for side in sides]
        if any(w != wires[0] for w in wires):
            raise AssertionError(f"tick {stats['ticks']}: the raft wire differs")
        stats["frames"] += len(wires[0])
        # Let delivered client requests reach their engines.
        await asyncio.sleep(0)
        for side in sides:
            for node in side.live():
                if node.shutdown.is_shutdown:
                    raise AssertionError(f"node {node.config.raft.id} shut down on its own")
        compare(stats["ticks"], sides)
        stats["compared"] += 1

    async def until(cond, what: str, tasks=None) -> None:
        start = stats["ticks"]
        while not cond():
            if stats["ticks"] - start > limit:
                raise AssertionError(f"{what}: not within {limit} ticks")
            await advance()
            if tasks is not None:
                done = [[t.done() for t in ts] for ts in tasks]
                if any(d != done[0] for d in done):
                    raise AssertionError(f"tick {stats['ticks']}: {what}: the sides "
                                         "answered different requests")

    async def call(reqs: list[tuple[int, int, int, dict]]) -> list[dict]:
        """``(node id, api key, version, body)`` requests, issued at once
        on every side; returns side 0's answers once every side answered
        alike."""
        loop = asyncio.get_running_loop()
        tasks = []
        for side in sides:
            ctx = contextvars.copy_context()
            ctx.run(_SIDE.set, side)
            tasks.append([loop.create_task(side.nodes[nid - 1].broker.broker.handle_request(
                k, v, copy.deepcopy(body)), context=ctx) for nid, k, v, body in reqs])
        await asyncio.sleep(0)
        await until(lambda: all(t.done() for ts in tasks for t in ts), "requests answered",
                    tasks)
        answers = [[t.result() for t in ts] for ts in tasks]
        for s, a in enumerate(answers[1:], 1):
            d = _difference(answers[0], a)
            if d is not None:
                raise AssertionError(f"tick {stats['ticks']}: side {s}: the Kafka answers "
                                     f"differ at {d}")
        stats["requests"] += len(reqs)
        return answers[0]

    def any_live() -> int:
        return base.live()[0].config.raft.id

    async def leaders() -> dict[int, int]:
        (md,) = await call([(any_live(), ApiKey.METADATA, 1, {"topics": [{"name": TOPIC}]})])
        return {p["partition_index"]: p["leader_id"] for p in md["topics"][0]["partitions"]}

    async def produce(n: int) -> None:
        """``n`` batches to every partition, one in flight per partition,
        each to the leader the last Metadata named; a refused batch is
        sent again, as a Kafka producer does."""
        todo = {p: n for p in range(partitions)}
        pending: dict[int, bytes] = {}
        rounds = 0
        while any(todo.values()):
            rounds += 1
            if rounds > limit:
                raise AssertionError("produce: too many rounds")
            lead = await leaders()
            live = {x.config.raft.id for x in base.live()}
            reqs, parts = [], []
            for p in sorted(todo):
                if not todo[p] or lead.get(p, -1) not in live:
                    continue
                if p not in pending:
                    payload = rng.integers(0, 256, records_per_batch * record_bytes,
                                           dtype=np.uint8).tobytes()
                    pending[p] = records.build_batch(payload, records_per_batch)
                reqs.append((lead[p], ApiKey.PRODUCE, 3, {
                    "transactional_id": None, "acks": -1, "timeout_ms": 30_000,
                    "topics": [{"name": TOPIC, "partitions": [
                        {"index": p, "records": pending[p]}]}]}))
                parts.append(p)
            if not reqs:
                await advance()
                continue
            for p, r in zip(parts, await call(reqs)):
                got = r["responses"][0]["partitions"][0]
                if got["error_code"] == ErrorCode.NONE:
                    acked[p].append((got["base_offset"], pending.pop(p)))
                    todo[p] -= 1
                    stats["acked"] += 1
                elif got["error_code"] in (ErrorCode.NOT_LEADER_OR_FOLLOWER,
                                           ErrorCode.THROTTLING_QUOTA_EXCEEDED):
                    stats["retried"] += 1
                else:
                    raise AssertionError(f"produce to partition {p}: {got}")

    def read_back() -> bool:
        """Every live replica's log holds exactly the acknowledged batches,
        in order, each at its offset."""
        for side in sides:
            for node in side.live():
                logs = _logs(node)
                for p, want in acked.items():
                    if p not in logs:
                        return False
                    blobs = logs[p][1]
                    if [(o, b) for o, _, b in blobs] != [
                            (o, records.set_base_offset(batch, o)) for o, batch in want]:
                        return False
        return True

    with CrashWatch() as watch:
        for side in sides:
            for n in side.nodes:
                side.hop.add(n.raft)
                await n.start()
        try:
            await until(lambda: all(len(n.store.get_brokers()) == 3
                                    for side in sides for n in side.live()),
                        "brokers registered")
            await until(lambda: _leader_of(base, 0) is not None, "metadata leader")
            meta = _leader_of(base, 0)
            (r,) = await call([(meta, ApiKey.CREATE_TOPICS, 1, {
                "topics": [{"name": TOPIC, "num_partitions": partitions,
                            "replication_factor": 3, "assignments": [], "configs": []}],
                "timeout_ms": 30_000, "validate_only": False})])
            if r["topics"][0]["error_code"] != ErrorCode.NONE:
                raise AssertionError(f"CreateTopics: {r}")
            await until(lambda: all(len(n.store.get_partitions(TOPIC)) == partitions
                                    for side in sides for n in side.live()) and led(),
                        "partition leaders")
            await produce(batches // 2)
            stop = _leader_of(base, 0)
            for side in sides:
                side.stopped.add(stop)
                side.hop.remove(stop)
                await side.nodes[stop - 1].stop()
            stats["stopped"] = stop
            await until(led, "re-election after the stop")
            await produce(batches - batches // 2)
            await until(read_back, "every acknowledged batch on every live replica")
            live = [n.config.raft.id for n in base.live()]
            fetch = {"replica_id": -1, "max_wait_ms": 0, "min_bytes": 1, "max_bytes": 1 << 24,
                     "isolation_level": 0, "topics": [{"topic": TOPIC, "partitions": [
                         {"partition": p, "fetch_offset": 0, "partition_max_bytes": 1 << 22}
                         for p in range(partitions)]}]}
            for i, r in zip(live, await call([(i, ApiKey.FETCH, 4, fetch) for i in live])):
                for part in r["responses"][0]["partitions"]:
                    want = b"".join(records.set_base_offset(batch, o)
                                    for o, batch in acked[part["partition"]])
                    if part["error_code"] != ErrorCode.NONE or part["records"].join() != want:
                        raise AssertionError(f"Fetch from node {i}, partition "
                                             f"{part['partition']}: not the acknowledged "
                                             "batches")
            await call([(i, ApiKey.METADATA, 4, {"topics": [{"name": TOPIC}],
                                                 "allow_auto_topic_creation": False})
                        for i in live])
            await call([(i, ApiKey.LIST_OFFSETS, 1, {"replica_id": -1, "topics": [
                {"name": TOPIC, "partitions": [{"partition_index": p, "timestamp": ts}
                                               for p in range(partitions)]}]})
                for i in live for ts in (-1, -2)])
            (co,) = await call([(live[0], ApiKey.FIND_COORDINATOR, 1,
                                 {"key": GROUP_ID, "key_type": 0})])
            if co["error_code"] != ErrorCode.NONE:
                raise AssertionError(f"FindCoordinator: {co}")
            offsets = {p: len(acked[p]) * records_per_batch for p in range(partitions)}
            (oc,) = await call([(co["node_id"], ApiKey.OFFSET_COMMIT, 2, {
                "group_id": GROUP_ID, "generation_id": -1, "member_id": "",
                "retention_time_ms": -1, "topics": [{"name": TOPIC, "partitions": [
                    {"partition_index": p, "committed_offset": o,
                     "committed_metadata": None} for p, o in offsets.items()]}]})])
            if any(p["error_code"] != ErrorCode.NONE for p in oc["topics"][0]["partitions"]):
                raise AssertionError(f"OffsetCommit: {oc}")
            (of,) = await call([(co["node_id"], ApiKey.OFFSET_FETCH, 1, {
                "group_id": GROUP_ID, "topics": [{"name": TOPIC,
                                                  "partition_indexes": list(offsets)}]})])
            got = {p["partition_index"]: p["committed_offset"]
                   for p in of["topics"][0]["partitions"]}
            if got != offsets:
                raise AssertionError(f"OffsetFetch: {got} != {offsets}")
        finally:
            for side in sides:
                for n in side.live():
                    await n.stop()
        if watch.crashes:
            raise AssertionError(f"a tick loop crashed: {watch.crashes[0]}")
    return stats
