"""Kafka record-batch (v2) header helpers for the broker data plane.

The broker treats record batches as opaque payloads (like the reference,
``src/broker/handler/produce.rs:29-30``) EXCEPT for the two header fields
it must own: the record count (to claim an offset span) and the base
offset (assigned at append, rewritten in place). The batch CRC covers
bytes from ``attributes`` onward, so rewriting the base offset does not
invalidate it. The reference assigns no offsets at all (SURVEY.md quirk 8).

Record batch v2 layout (bytes): base_offset 0-7, batch_length 8-11,
partition_leader_epoch 12-15, magic 16, crc 17-20, attributes 21-22,
last_offset_delta 23-26, ... records_count 57-60, records 61+.
"""

from __future__ import annotations

import struct

from josefine_tpu_torch import native

BATCH_OVERHEAD = 61
_MAGIC_OFFSET = 16
_CRC_OFFSET = 17
_ATTRIBUTES_OFFSET = 21
_LAST_OFFSET_DELTA = 23

_crc32c_fn = None
_PY_CRC_TABLE: list[int] | None = None


def _crc32c_py(data) -> int:
    """Pure-Python Castagnoli fallback: keeps client-side batch building
    (examples, demos) free of the native toolchain; the broker normally
    gets the slice-by-8 C implementation."""
    global _PY_CRC_TABLE
    if _PY_CRC_TABLE is None:
        t = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            t.append(c)
        _PY_CRC_TABLE = t
    c = 0xFFFFFFFF
    for b in bytes(data):
        c = _PY_CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _crc32c(data) -> int:
    global _crc32c_fn
    if _crc32c_fn is None:  # cache: native.load stats the .so per call
        try:
            _crc32c_fn = native.load("seglog").crc32c
        except Exception:
            _crc32c_fn = _crc32c_py
    return _crc32c_fn(data)


def _scan(blob: bytes) -> tuple[list[tuple[int, int, int]], str | None]:
    """THE v2 framing walk (single source of truth for every helper here):
    ``([(start, total_len, last_offset_delta), ...], reason)`` where reason
    is None for a clean walk to end-of-field and a string describing the
    first framing violation otherwise (spans up to that point are still
    returned for lenient callers)."""
    spans: list[tuple[int, int, int]] = []
    pos = 0
    while pos < len(blob):
        if pos + BATCH_OVERHEAD > len(blob):
            return spans, (f"batch {len(spans)} shorter than v2 header "
                           f"({len(blob) - pos} bytes at {pos})")
        if blob[pos + _MAGIC_OFFSET] != 2:
            return spans, (f"unsupported batch magic "
                           f"{blob[pos + _MAGIC_OFFSET]} at {pos}")
        (blen,) = struct.unpack_from(">i", blob, pos + 8)
        total = blen + 12
        if blen < BATCH_OVERHEAD - 12 or pos + total > len(blob):
            return spans, (f"batch_length {blen} at {pos} overruns field "
                           f"({len(blob)})")
        (delta,) = struct.unpack_from(">i", blob, pos + _LAST_OFFSET_DELTA)
        spans.append((pos, total, delta))
        pos += total
    return spans, None


def _batch_spans(blob: bytes):
    """(start, length, count) of each well-framed v2 batch in a records
    field — a produce request may carry SEVERAL concatenated batches (a
    real client accumulates per-partition batches into one request).
    Lenient: stops at the first framing violation; yields nothing for
    non-v2/opaque blobs."""
    for start, total, delta in _scan(blob)[0]:
        yield start, total, max(1, delta + 1)


def record_count(blob: bytes) -> int:
    """Offsets claimed by this records field: the sum over its concatenated
    v2 batches (1 for short/legacy/opaque blobs)."""
    total = sum(count for _, _, count in _batch_spans(blob))
    return total if total else 1


def validate_batch(blob: bytes) -> str | None:
    """Produce-ingress validation: None if the records field is a
    well-formed concatenation of v2 record batches, else a reason string.
    Real brokers refuse corrupt batches with CORRUPT_MESSAGE — without
    this gate a corrupt client batch would replicate cluster-wide and
    permanently poison the partition for every CRC-checking consumer.
    (The reference validates nothing; its Produce path is unreachable over
    the wire, SURVEY.md quirk 8. Legacy magic-0/1 batches are refused —
    the data plane is v2-only by design.)"""
    spans, reason = _scan(blob)
    if reason is not None:
        return reason
    if not spans:
        return "no record batch"
    view = memoryview(blob)  # zero-copy CRC input on the produce hot path
    for pos, total, delta in spans:
        if delta < 0:
            return f"negative last_offset_delta {delta} at {pos}"
        (crc,) = struct.unpack_from(">I", blob, pos + _CRC_OFFSET)
        actual = _crc32c(view[pos + _ATTRIBUTES_OFFSET:pos + total])
        if crc != actual:
            return f"crc {crc:#010x} != computed {actual:#010x} at {pos}"
    return None


def set_base_offset(blob: bytes, base: int) -> bytes:
    """Rewrite base offsets across the records field: each concatenated
    batch gets the running base (batch i starts where batch i-1's offset
    span ended). No-op for non-v2 blobs. The batch CRC covers attributes
    onward, so this never invalidates it."""
    spans = list(_batch_spans(blob))
    if not spans:
        return blob
    out = bytearray(blob)
    for start, _total, count in spans:
        struct.pack_into(">q", out, start, base)
        base += count
    return bytes(out)


_PRODUCER_ID = 43      # i64
_PRODUCER_EPOCH = 51   # i16
_BASE_SEQUENCE = 53    # i32
_RECORDS_COUNT = 57


def build_batch(payload: bytes, n_records: int = 1, pid: int = -1,
                epoch: int = 0, base_seq: int = -1) -> bytes:
    """A minimal v2 record batch wrapping opaque record bytes (test/demo
    producer; the broker itself never builds batches). Carries a real
    CRC-32C so it passes produce-ingress validation; pid/epoch/base_seq
    populate the idempotent-producer header fields (all inside the CRC'd
    region)."""
    header = bytearray(BATCH_OVERHEAD)
    struct.pack_into(">i", header, 8, BATCH_OVERHEAD - 12 + len(payload))
    header[_MAGIC_OFFSET] = 2
    struct.pack_into(">i", header, _LAST_OFFSET_DELTA, n_records - 1)
    struct.pack_into(">q", header, _PRODUCER_ID, pid)
    struct.pack_into(">h", header, _PRODUCER_EPOCH, epoch)
    struct.pack_into(">i", header, _BASE_SEQUENCE, base_seq)
    struct.pack_into(">i", header, _RECORDS_COUNT, n_records)
    crc = _crc32c(bytes(header[_ATTRIBUTES_OFFSET:]) + payload)
    struct.pack_into(">I", header, _CRC_OFFSET, crc)
    return bytes(header) + payload


def blob_producer_info(blob: bytes):
    """Idempotence view of a records field: (pid, epoch, base_seq,
    total_count) where pid/epoch/base_seq come from the FIRST batch and
    total_count spans the whole concatenation. A producer's batches within
    one request carry consecutive sequences, so the blob is deduplicated
    as one unit (matching its one-block-one-log-append replication) —
    ``validate_producer_coherence`` at produce ingress guarantees every
    batch in the field actually shares that (pid, epoch) with consecutive
    sequences, so the first-batch view cannot mis-attribute records.
    pid == -1 means non-idempotent."""
    spans = list(_batch_spans(blob))
    if not spans:
        return -1, 0, -1, 1
    start = spans[0][0]
    (pid,) = struct.unpack_from(">q", blob, start + _PRODUCER_ID)
    (epoch,) = struct.unpack_from(">h", blob, start + _PRODUCER_EPOCH)
    (base_seq,) = struct.unpack_from(">i", blob, start + _BASE_SEQUENCE)
    total = sum(c for _, _, c in spans)
    return pid, epoch, base_seq, total


def validate_producer_coherence(blob: bytes) -> str | None:
    """Produce-ingress gate for multi-batch fields: the partition FSM
    attributes the whole field to the FIRST batch's (pid, epoch, base_seq)
    and counts records across the concatenation, so a field mixing
    producers — different pids, different epochs, idempotent plus
    non-idempotent, or non-consecutive sequences — would be mis-tracked
    (spurious OUT_OF_ORDER/DUPLICATE verdicts, missed dedup). Real Kafka
    refuses such fields with INVALID_RECORD; so do we. Returns a reason
    string, or None for a coherent field."""
    spans = list(_batch_spans(blob))
    if len(spans) <= 1:
        return None
    first = None
    expect_seq = None
    for i, (start, _total, count) in enumerate(spans):
        (pid,) = struct.unpack_from(">q", blob, start + _PRODUCER_ID)
        (epoch,) = struct.unpack_from(">h", blob, start + _PRODUCER_EPOCH)
        (seq,) = struct.unpack_from(">i", blob, start + _BASE_SEQUENCE)
        if first is None:
            first = (pid, epoch)
            expect_seq = seq + count if pid >= 0 and seq >= 0 else None
            continue
        if (pid, epoch) != first:
            return (f"batch {i} producer ({pid}, {epoch}) differs from "
                    f"batch 0 {first}")
        if expect_seq is not None:
            if seq != expect_seq:
                return (f"batch {i} base_sequence {seq} not consecutive "
                        f"(expected {expect_seq})")
            expect_seq += count
        elif seq >= 0:
            return f"batch {i} carries a sequence but batch 0 does not"
    return None
