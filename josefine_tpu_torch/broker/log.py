"""Partition log: Python face of the native segmented storage engine.

Parity: reference ``src/broker/log/`` (``Log`` rolling 1 GiB segments,
``mod.rs:42-59``; ``Segment`` = <base>.log + index, ``segment.rs:11-53``;
10 MiB mmap ``Index``, ``index.rs:9-70``). The engine itself is C++
(``native/src/seglog.cpp``) — see that file's header for the deliberate
upgrades (assigned offsets, binary-search index, CRC, a real read path).
"""

from __future__ import annotations

import bisect
import os

from josefine_tpu_torch import native
from josefine_tpu_torch.utils.kv import DiskFault

MAX_SEGMENT_BYTES = 1 << 30  # reference segment.rs:11
INDEX_BYTES = 10 << 20       # reference index.rs:9


class Log:
    """Append-only offset-addressed record-blob log for one partition.

    ``io_hook`` is the chaos seam (``josefine_tpu/chaos/faults.py``): a
    callable ``hook(op, data) -> bytes | None`` consulted before ``append``
    and ``flush``. Returning ``None`` proceeds normally; raising
    :class:`DiskFault` fails the op with nothing written; returning a bytes
    prefix from an ``"append"`` call simulates a TORN write — the prefix
    lands in the segment, then the caller still sees the error. Default is
    ``None``: the hot path pays nothing when chaos is off.
    """

    def __init__(
        self,
        directory: str | os.PathLike,
        max_segment_bytes: int = MAX_SEGMENT_BYTES,
        index_bytes: int = INDEX_BYTES,
        io_hook=None,
    ):
        os.makedirs(directory, exist_ok=True)
        self._dir = str(directory)
        self._max_segment_bytes = max_segment_bytes
        self._index_bytes = index_bytes
        self._io_hook = io_hook
        #: Bumped on every destructive reset (wipe / snapshot restore):
        #: half of the fetch span-cache key, so cached hot-tail spans can
        #: never survive a log whose history was rewritten underneath them
        #: (append-only growth is covered by the next_offset check).
        self.incarnation = 0
        self._open()

    def _open(self) -> None:
        self._log = native.load("seglog").open(
            self._dir,
            max_segment_bytes=self._max_segment_bytes,
            index_bytes=self._index_bytes,
        )

    def append(self, data: bytes, count: int = 1) -> int:
        """Append one blob spanning ``count`` offsets; returns its base
        offset (a Kafka record batch claims one offset per record)."""
        if self._io_hook is not None:
            torn = self._io_hook("append", data)
            if torn is not None:
                self._log.append(torn, count=count)
                raise DiskFault(
                    f"torn append: {len(torn)}/{len(data)} bytes written")
        return self._log.append(data, count=count)

    def read(self, offset: int):
        """(base_offset, count, payload) of the blob containing ``offset``,
        or None past the log end."""
        return self._log.read(offset)

    def read_from(self, offset: int, max_bytes: int = 1 << 20):
        """Blobs from ``offset`` onward, up to ``max_bytes`` of payload.
        The first blob is ALWAYS returned even when it alone exceeds
        ``max_bytes`` (Kafka KIP-74: an oversized batch must not wedge the
        consumer); subsequent blobs stop before crossing the budget —
        identical semantics to :meth:`MemLog.read_from`."""
        return self._log.read_from(offset, max_bytes)

    def next_offset(self) -> int:
        return self._log.next_offset()

    def segment_count(self) -> int:
        return self._log.segment_count()

    def wipe(self) -> None:
        """Reset to an empty log: close, delete every segment + index file,
        reopen at offset 0. Used by snapshot restore (follower log sync) —
        the restored prefix replaces whatever divergent local tail existed."""
        self._log.close()
        for f in os.listdir(self._dir):
            if f.endswith(".log") or f.endswith(".index"):
                os.remove(os.path.join(self._dir, f))
        self.incarnation += 1
        self._open()

    def flush(self) -> None:
        if self._io_hook is not None:
            self._io_hook("flush", b"")
        self._log.flush()

    def close(self) -> None:
        self._log.close()


class MemLog:
    """In-memory partition log with the same surface as :class:`Log`.

    The workload scale driver (``josefine_tpu/workload/driver.py``) hosts
    10k–100k partitions in ONE process to measure the product path at the
    batched-P scale; 10k native seglogs would cost 10k directories and a
    10 MiB index mmap each, none of which the measurement needs. Durability
    suites and the wire path keep using the native :class:`Log`.
    """

    def __init__(self):
        # (base_offset, count, payload) blobs in append order; bases are
        # strictly increasing and spans contiguous from 0, so lookups are
        # one bisect (a linear scan would make every fetch O(appends) on
        # exactly the serve path the workload driver measures).
        self._blobs: list[tuple[int, int, bytes]] = []
        self._bases: list[int] = []
        self._next = 0
        #: See Log.incarnation — same span-cache invalidation contract.
        self.incarnation = 0

    def append(self, data: bytes, count: int = 1) -> int:
        if count < 1:
            raise ValueError(f"blob count must be >= 1, got {count}")
        base = self._next
        self._blobs.append((base, count, data))
        self._bases.append(base)
        self._next = base + count
        return base

    def _index_of(self, offset: int) -> int | None:
        """Index of the blob containing ``offset``, or None past the end."""
        i = bisect.bisect_right(self._bases, offset) - 1
        if i < 0 or offset >= self._blobs[i][0] + self._blobs[i][1]:
            return None
        return i

    def read(self, offset: int):
        i = self._index_of(offset)
        return None if i is None else self._blobs[i]

    def read_from(self, offset: int, max_bytes: int = 1 << 20):
        i = self._index_of(offset)
        if i is None:
            return []
        out, size = [], 0
        for blob in self._blobs[i:]:
            if size and size + len(blob[2]) > max_bytes:
                break
            out.append(blob)
            size += len(blob[2])
        return out

    def next_offset(self) -> int:
        return self._next

    def segment_count(self) -> int:
        return 1

    def wipe(self) -> None:
        self._blobs = []
        self._bases = []
        self._next = 0
        self.incarnation += 1

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
