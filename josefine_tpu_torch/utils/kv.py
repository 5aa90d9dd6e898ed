"""Embedded durable key-value store.

The reference leans on ``sled`` (an embedded KV) for both the Raft chain and
the broker metadata store (``src/raft/chain.rs``, ``src/broker/state/
mod.rs``). Python has no sled; the equivalent embedded, durable,
native-performance store in this image is sqlite3 (C library, WAL mode).
The interface is deliberately sled-shaped: get/put/delete/scan-prefix.

``MemKV`` backs unit tests (the reference uses tempdir sled instances;
in-memory is the same seam with less I/O).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Iterable, Iterator


class DiskFault(OSError):
    """An injected storage failure (chaos testing).

    Raised by :class:`InterceptedKV` / :class:`josefine_tpu.broker.log.Log`
    when an armed fault hook decides an operation fails. Subclasses OSError
    so code written for real disk errors handles injected ones identically.
    """


class KV:
    """Interface: bytes -> bytes with prefix scans."""

    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def put_many(self, items: Iterable[tuple[bytes, bytes]]) -> None:
        """Write a batch of (key, value) pairs as one transaction where the
        backend supports it (SqliteKV: one commit instead of one per put —
        the chain's per-tick block writes ride this). Default: put() loop,
        so every KV stays correct even without a native batch path."""
        for k, v in items:
            self.put(k, v)

    def scan_prefix(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemKV(KV):
    def __init__(self):
        self._d: dict[bytes, bytes] = {}

    def get(self, key):
        return self._d.get(key)

    def put(self, key, value):
        self._d[key] = bytes(value)

    def delete(self, key):
        self._d.pop(key, None)

    def put_many(self, items):
        self._d.update((k, bytes(v)) for k, v in items)

    def scan_prefix(self, prefix):
        for k in sorted(self._d):
            if k.startswith(prefix):
                yield k, self._d[k]


class SqliteKV(KV):
    """Durable store: one table, WAL journaling, safe for one writer thread
    per connection (the engine's tick loop is single-threaded, like the
    reference's actor-owned sled handles)."""

    def __init__(self, path: str | os.PathLike, full_sync: bool = False):
        path = os.fspath(path)
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._db.execute("PRAGMA journal_mode=WAL")
        # Crash model (see ARCHITECTURE.md "Durability"): NORMAL survives
        # process crash (every chaos suite's model — WAL commits are
        # ordered and atomic) but the last commits can be lost on OS/power
        # failure; FULL fsyncs the WAL per commit for power-loss
        # durability, at a measured per-put cost (bench_log.py --fsync).
        self._db.execute("PRAGMA synchronous=%s"
                         % ("FULL" if full_sync else "NORMAL"))
        self._db.execute("CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)")
        self._db.commit()

    def get(self, key):
        with self._lock:
            row = self._db.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return None if row is None else row[0]

    def put(self, key, value):
        with self._lock:
            self._db.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (key, bytes(value)),
            )
            self._db.commit()

    def delete(self, key):
        with self._lock:
            self._db.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._db.commit()

    def put_many(self, items):
        # One executemany + one commit: a tick's staged blocks across all
        # groups land in a single WAL transaction (crash-atomic as a set,
        # which is strictly safer than the per-put schedule — a partial
        # tick can never persist a head pointer without its blocks when
        # the caller orders blocks before pointers in the batch).
        with self._lock:
            self._db.executemany(
                "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                [(k, bytes(v)) for k, v in items],
            )
            self._db.commit()

    def scan_prefix(self, prefix):
        # True prefix upper bound: increment the last non-0xff byte and
        # truncate (an all-0xff prefix has no upper bound -> scan to end).
        hi = None
        for i in range(len(prefix) - 1, -1, -1):
            if prefix[i] != 0xFF:
                hi = prefix[:i] + bytes([prefix[i] + 1])
                break
        with self._lock:
            if hi is None:
                rows = self._db.execute(
                    "SELECT k, v FROM kv WHERE k >= ? ORDER BY k", (prefix,)
                ).fetchall()
            else:
                rows = self._db.execute(
                    "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                    (prefix, hi),
                ).fetchall()
        yield from rows

    def flush(self):
        with self._lock:
            self._db.commit()

    def close(self):
        with self._lock:
            self._db.close()


class InterceptedKV(KV):
    """Fault-wrapping decorator: consult ``hook(op, key)`` before every
    operation, then delegate to the wrapped store.

    The chaos hook point for storage (see ``josefine_tpu/chaos/faults.py``,
    which builds the hooks): the hook may raise :class:`DiskFault` to fail
    the op with nothing written (a write error), or raise it on ``"flush"``
    to model a failed fsync. This wrapper is only ever constructed when
    fault injection is explicitly enabled — the default path keeps the
    bare KV, so chaos-off costs nothing.
    """

    def __init__(self, inner: KV, hook):
        self.inner = inner
        self._hook = hook

    def get(self, key):
        self._hook("get", key)
        return self.inner.get(key)

    def put(self, key, value):
        self._hook("put", key)
        self.inner.put(key, value)

    def delete(self, key):
        self._hook("delete", key)
        self.inner.delete(key)

    def put_many(self, items):
        # Consult the hook per key (fault injection stays per-operation)
        # and, on a fault, persist the prefix that already passed before
        # re-raising — the same torn-write shape the per-put schedule this
        # batch replaced would have produced (callers order blocks before
        # pointers precisely so a persisted prefix is always safe).
        items = list(items)
        for n, (k, _) in enumerate(items):
            try:
                self._hook("put", k)
            except Exception:
                if n:
                    self.inner.put_many(items[:n])
                raise
        self.inner.put_many(items)

    def scan_prefix(self, prefix):
        self._hook("scan", prefix)
        return self.inner.scan_prefix(prefix)

    def flush(self):
        self._hook("flush", b"")
        self.inner.flush()

    def close(self):
        self.inner.close()


def open_kv(path: str | None, full_sync: bool = False) -> KV:
    """None -> in-memory (tests); path -> durable sqlite."""
    return MemKV() if path is None else SqliteKV(path, full_sync=full_sync)
