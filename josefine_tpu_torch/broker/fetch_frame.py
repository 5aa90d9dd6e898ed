"""Zero-copy fetch serving: record spans, chunked frame assembly, and the
per-partition hot-tail span cache.

The legacy serve path copies a fetch response three times between the log
and the socket: ``b"".join`` of the per-blob reads, the native
``encode_response`` re-framing, and the length-prefix ``frame`` copy. This
module removes all three for the FETCH hot path:

- :class:`RecordsSpan` carries the log's per-blob buffers as a chunk list
  (MemLog blobs are the stored ``bytes`` objects themselves — stable views
  into the log; seglog blobs are one read each, shared via the cache).
- :func:`encode_fetch_frame` assembles the complete response frame as a
  list of chunks — fixed header fields accumulate into small scratch
  buffers, record spans are spliced in by reference — which the server
  hands to the transport writev-style (``writer.write`` per chunk, one
  drain). The chunk list joined is byte-identical to
  ``codec.frame(codec.encode_response(FETCH, ...))`` over the materialized
  body; ``tests/test_wire_fetch.py`` pins this differentially.
- :class:`FetchSpanCache` is the per-partition hot-tail cache keyed on
  ``(log incarnation, base offset, max_bytes bucket)``: N consumers
  tailing the same hot partition share ONE log walk and one span. An
  entry is valid only while the log's ``next_offset`` still matches the
  value captured at fill time, so *append* invalidates implicitly;
  *truncate/wipe* bumps the log incarnation; *recycle/migration* replace
  the Replica (and its cache) wholesale.

Fetch ``max_bytes`` budgets are quantized UP to the next power of two
(the cache bucket) before the log read, on both the zero-copy and legacy
paths, so the two encoders see identical blobs and cache entries are
shared across clients with near-identical configs. Kafka's ``max_bytes``
is a soft limit (KIP-74) — responses may exceed it, and must whenever the
first batch alone does — so a ≤2× quantization is within contract.
"""

from __future__ import annotations

import struct
from collections import OrderedDict

__all__ = [
    "RecordsSpan", "FetchSpanCache", "max_bytes_bucket",
    "encode_fetch_frame", "materialize", "body_has_spans",
]

_DEFAULT_FETCH_BYTES = 1 << 20


class RecordsSpan:
    """A partition's fetched record batches as a list of stable buffers.

    Sits in the fetch response body where the joined ``bytes`` used to be.
    The server-side encoder splices ``chunks`` into the outgoing frame by
    reference; in-process callers (tests, the workload driver) receive the
    legacy joined ``bytes`` instead — handlers materialize unless asked
    for spans — because a Python object cannot impersonate a buffer for
    ``struct``/slicing consumers on this interpreter.
    """

    __slots__ = ("chunks", "size")

    def __init__(self, chunks: list):
        self.chunks = chunks
        self.size = sum(len(c) for c in chunks)

    def __len__(self) -> int:
        return self.size

    def __bool__(self) -> bool:
        return self.size > 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"RecordsSpan({len(self.chunks)} chunks, {self.size}B)"

    def join(self) -> bytes:
        """Materialize to the legacy contiguous representation."""
        if len(self.chunks) == 1 and type(self.chunks[0]) is bytes:
            return self.chunks[0]
        return b"".join(self.chunks)


def max_bytes_bucket(max_bytes: int) -> int:
    """Quantize a fetch budget up to the next power of two (the cache
    bucket AND the effective read budget — both paths use the bucket so
    cached spans are exact for every request that lands in it)."""
    if max_bytes <= 0:
        return _DEFAULT_FETCH_BYTES
    return 1 << (max_bytes - 1).bit_length()


class FetchSpanCache:
    """Tiny per-replica LRU of hot-tail record spans.

    Entries self-invalidate: validity requires the log's CURRENT
    ``(incarnation, next_offset)`` to match the fill-time capture, so any
    append moves ``next_offset`` past the entry and any wipe/truncate
    bumps the incarnation. The cache object itself lives on the Replica,
    which recycle and migration replace."""

    __slots__ = ("cap", "hits", "misses", "_entries")

    def __init__(self, cap: int = 8):
        self.cap = cap
        self.hits = 0
        self.misses = 0
        self._entries: OrderedDict = OrderedDict()

    def get(self, log, offset: int, bucket: int) -> RecordsSpan | None:
        key = (getattr(log, "incarnation", 0), offset, bucket)
        ent = self._entries.get(key)
        if ent is not None:
            if ent[0] == log.next_offset():
                self._entries.move_to_end(key)
                self.hits += 1
                return ent[1]
            del self._entries[key]  # stale: appended past the fill point
        self.misses += 1
        return None

    def put(self, log, offset: int, bucket: int, span: RecordsSpan) -> None:
        key = (getattr(log, "incarnation", 0), offset, bucket)
        self._entries[key] = (log.next_offset(), span)
        self._entries.move_to_end(key)
        while len(self._entries) > self.cap:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()


def materialize(responses: list) -> list:
    """Replace every RecordsSpan in fetch responses with joined bytes —
    the legacy in-process representation (and the legacy encode input)."""
    for t in responses:
        for p in t.get("partitions") or ():
            r = p.get("records")
            if isinstance(r, RecordsSpan):
                p["records"] = r.join() or None
    return responses


def body_has_spans(body: dict) -> bool:
    """True when a fetch response body carries RecordsSpan chunks (the
    zero-copy serve path); plain-bytes/error bodies take the native
    encoder unchanged."""
    for t in body.get("responses") or ():
        for p in t.get("partitions") or ():
            if isinstance(p.get("records"), RecordsSpan):
                return True
    return False


def encode_fetch_frame(api_version: int, correlation_id: int,
                       body: dict) -> list:
    """Assemble a complete FETCH response frame as a chunk list.

    Fixed fields accumulate into scratch ``bytearray`` segments; each
    partition's records land as their own chunks (RecordsSpan by
    reference, bytes/memoryview as-is). The first chunk is the i32 frame
    length. ``b"".join(chunks)`` is byte-identical to the native
    ``codec.frame(codec.encode_response(...))`` over the same body with
    spans materialized — FETCH responses are never flexible (v4-v6
    here), so the layout is the classic fixed one mirrored from
    ``native/src/kafka_codec.cpp`` FETCH_RESP."""
    pk = struct.pack
    chunks: list = []
    head = bytearray()

    def flush() -> None:
        if head:
            chunks.append(bytes(head))
            head.clear()

    head += pk(">i", correlation_id)
    if api_version >= 1:
        head += pk(">i", body.get("throttle_time_ms") or 0)
    topics = body.get("responses") or []
    head += pk(">i", len(topics))
    for t in topics:
        name = (t.get("topic") or "").encode("utf-8")
        head += pk(">h", len(name))
        head += name
        parts = t.get("partitions") or []
        head += pk(">i", len(parts))
        for p in parts:
            head += pk(">ihq", p["partition"], int(p["error_code"]),
                       p["high_watermark"])
            if api_version >= 4:
                head += pk(">q", p["last_stable_offset"])
            if api_version >= 5:
                head += pk(">q", p["log_start_offset"])
            if api_version >= 4:
                txns = p.get("aborted_transactions")
                if txns is None:
                    head += pk(">i", -1)
                else:
                    head += pk(">i", len(txns))
                    for txn in txns:
                        head += pk(">qq", txn["producer_id"],
                                   txn["first_offset"])
            rec = p.get("records")
            if rec is None:
                head += pk(">i", -1)
            elif isinstance(rec, RecordsSpan):
                head += pk(">i", rec.size)
                flush()
                chunks.extend(rec.chunks)
            else:
                head += pk(">i", len(rec))
                flush()
                chunks.append(rec)
    flush()
    total = sum(len(c) for c in chunks)
    chunks.insert(0, pk(">i", total))
    return chunks
