"""Replica: binds a partition to an on-disk log.

Parity: reference ``src/broker/replica.rs:6-21`` (Replica::new creates the
log dir under ``data_dir/data/{partition}``) and the registry at
``src/broker/mod.rs:45-65``. Upgrade: the replica tracks the partition's
leader (from LeaderAndIsr) so the Produce/Fetch handlers can answer
NOT_LEADER_OR_FOLLOWER correctly.
"""

from __future__ import annotations

import os
import shutil
import uuid

from josefine_tpu_torch.broker.fetch_frame import FetchSpanCache
from josefine_tpu_torch.broker.log import Log, MemLog
from josefine_tpu_torch.broker.state import Partition


class Replica:
    def __init__(self, data_dir: str | os.PathLike, partition: Partition,
                 in_memory: bool = False):
        self.partition = partition
        # Hot-tail fetch span cache: lives on the Replica so recycle and
        # migration (which re-create the Replica) drop it wholesale; within
        # one Replica lifetime, entries self-invalidate on append (the
        # next_offset check) and wipe/truncate (the log incarnation).
        self.fetch_cache = FetchSpanCache()
        if in_memory:
            # Workload scale driver: 10k+ partitions in one process — no
            # per-partition directory or index mmap (see log.MemLog).
            self.path = None
            self.log = MemLog()
        else:
            self.path = os.path.join(os.fspath(data_dir), "data", f"{partition.topic}-{partition.idx}")
            self.log = Log(self.path)

    @property
    def leader(self) -> int:
        return self.partition.leader

    def close(self) -> None:
        self.log.close()


class ReplicaRegistry:
    """(topic, idx) -> Replica, created on LeaderAndIsr."""

    def __init__(self, data_dir: str | os.PathLike, in_memory: bool = False):
        self._data_dir = os.fspath(data_dir)
        self._in_memory = in_memory
        self._replicas: dict[tuple[str, int], Replica] = {}

    def ensure(self, partition: Partition) -> Replica:
        key = (partition.topic, partition.idx)
        rep = self._replicas.get(key)
        if rep is None:
            rep = Replica(self._data_dir, partition,
                          in_memory=self._in_memory)
            self._replicas[key] = rep
        else:
            # Refresh leader/isr on re-announce — but never let a groupless
            # announcement (LeaderAndIsr carries no group field) stomp the
            # consensus-group binding established by the replicated store.
            if partition.group < 0 and rep.partition.group >= 0:
                partition.group = rep.partition.group
            rep.partition = partition
        return rep

    def get(self, topic: str, idx: int) -> Replica | None:
        return self._replicas.get((topic, idx))

    def release_topic(self, topic: str) -> list[str]:
        """Close and deregister every local replica of a topic (DeleteTopics)
        and return tombstone dirs to purge — including dirs left by
        partitions not currently materialized in memory (e.g. after a
        restart). Each log dir is atomically renamed to a ``.deleted``
        tombstone here, so a re-created topic can never race the deferred
        rmtree; file deletion is split out so callers on an event loop can
        push it to an executor (rmtree of a large partition would stall the
        loop)."""
        for key in [k for k in self._replicas if k[0] == topic]:
            rep = self._replicas.pop(key)
            try:
                rep.close()
            except OSError:
                pass  # the dir is about to be purged anyway
        dirs = []
        data = os.path.join(self._data_dir, "data")
        if os.path.isdir(data):
            prefix = f"{topic}-"
            for entry in os.listdir(data):
                if entry.startswith(prefix) and entry[len(prefix):].isdigit():
                    src = os.path.join(data, entry)
                    # graftlint: allow(det-uuid) — tombstone rename suffix; uniqueness only, never read back or journaled
                    dst = f"{src}.deleted.{uuid.uuid4().hex}"
                    try:
                        os.rename(src, dst)
                        dirs.append(dst)
                    except OSError:
                        dirs.append(src)  # rename failed: purge in place
        return dirs

    @staticmethod
    def purge_dirs(dirs: list[str]) -> None:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)

    def drop_topic(self, topic: str) -> None:
        """release_topic + synchronous purge (non-event-loop callers)."""
        self.purge_dirs(self.release_topic(topic))

    def close(self) -> None:
        for rep in self._replicas.values():
            rep.close()
        self._replicas.clear()
