"""PartitionFsm: the data-plane replicated state machine for one partition.

This is the piece the reference never has: its Produce path writes record
batches to the *leader's* local log only — follower replica logs stay empty
forever and a fetch routed to a follower would serve nothing
(``/root/reference/src/broker/handler/produce.rs:11-36``; its ISR is set
once at creation and never maintained). Here a produced record batch is a
Raft proposal on the partition's own consensus group (one device tensor row
per partition — the P axis), and THIS FSM applies committed batches to the
local segmented log on every replica:

* offsets are assigned at apply time (``base = log.next_offset()``): every
  replica applies the same committed sequence to an initially-empty log, so
  bases are identical cluster-wide without any offset negotiation;
* the applied position (last applied block id + the log end offset it
  produced) is persisted in one KV record per apply, making recovery exact:
  restart replay resumes at ``applied_id()``, and a crash *between* the log
  append and the position record (the one torn window) is detected by
  comparing the recorded log end with the actual one — the first replayed
  block is then skipped instead of double-appended.

The FSM implements ``transition_block`` (not plain ``transition``) because
idempotence needs the block id; the Driver prefers it when present.

Log compaction (chain side): the segmented log IS this FSM's durable state,
so its "snapshot" needs no second copy of the data — ``snapshot()`` returns
a 16-byte manifest ``(applied_id, log_end_offset)`` that the engine stores
as the group's snapshot record and uses to truncate the chain (the record
batches below the floor already live in the seglog). When a follower falls
below the truncation floor, the engine materializes the wire payload
lazily via ``snapshot_export`` — header + framed log span — and the
follower's ``restore`` rebuilds its log byte-for-byte (Kafka-style replica
log sync, which the reference has no analog of: its followers hold empty
logs forever, ``src/broker/handler/produce.rs:11-36``). Sync is
incremental: the engine probes ``snapshot_resume_offset`` first and ships
only the suffix the follower is missing — both logs are the same
deterministic fold of the committed block sequence, so the prefix below
the follower's log end is already identical.
"""

from __future__ import annotations

import struct

from josefine_tpu_torch.broker import records
from josefine_tpu_torch.broker.log import Log
from josefine_tpu_torch.raft.fsm import ReplicaDiverged
from josefine_tpu_torch.raft.migration import is_migration_fence
from josefine_tpu_torch.utils.kv import KV
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("broker.partition_fsm")

# Producer-dedup map bound per partition (deterministic LRU by last-seen
# block id). A producer idle long enough to be evicted loses dedup
# protection for its next retry — the same trade real brokers make with
# producer.id.expiration.ms.
_MAX_PIDS = 256
# Recent-batch window per producer: Kafka retains the last 5 batch
# metadata entries so idempotent clients may pipeline
# max.in.flight.requests.per.connection=5 — a retry of any batch in the
# window re-acks its original base offset instead of erroring.
_DEDUP_WINDOW = 5


class PartitionFsm:
    """Applies committed record batches of one consensus group to a Log."""

    def __init__(self, kv: KV, group: int, plog: Log, on_append=None,
                 fsync: bool = False):
        self.kv = kv
        self.group = group
        self.log = plog
        # Power-loss durability (broker.durability = "power"): fsync the
        # seglog before each position record, so an acked record can never
        # be lost to an OS crash between the page-cache write and the KV
        # commit. Off by default — the "process" crash model (every chaos
        # suite's model) needs no per-append fsync.
        self._fsync = fsync
        # Fired after each applied batch: the broker's fetch long-poll
        # wakeup (consumers blocked in Fetch re-check instead of sleeping
        # out their max_wait_ms).
        self.on_append = on_append
        # Fired when a migration fence commits on this row (the handoff
        # point of a live reassignment — raft/migration.py). Wired by the
        # migration driver on source-row FSMs only; None everywhere else.
        self.on_fence = None
        self._key = b"pfsm:%d" % group
        self._rkey = b"pfsm:r:%d" % group
        self._applied = 0
        self._skip_torn = False
        self._stream = None  # in-flight streaming restore (restore_begin)
        # Idempotent-producer dedup: pid -> [epoch, last_seen_block_id,
        # [[base_seq, count, base_offset], ...]] holding the last
        # _DEDUP_WINDOW applied blobs from that producer — Kafka brokers
        # keep 5 so clients may run max.in.flight.requests.per.connection=5
        # with idempotence (a retry of any recent in-flight batch re-acks
        # its original offsets). Part of the replicated state (persisted
        # per apply, rides snapshots): every replica must make identical
        # dedup decisions at apply time.
        self._pids: dict[int, list] = {}
        if kv.get(self._rkey) is not None:
            # Crash mid-restore: the log was wiped/partially rebuilt while
            # the position record still describes the pre-restore state.
            # Neither is trustworthy — reset to empty (a far-behind replica)
            # and let the leader re-send the snapshot.
            log.warning("g=%d interrupted snapshot restore detected; "
                        "resetting replica log", group)
            self._reset_replica()
            return
        raw = kv.get(self._key)
        if raw is None and self.log.next_offset() > 0:
            # First binding over a NON-empty log: nothing this FSM applied
            # put those bytes there (there is no position record), so the
            # content is foreign — e.g. an un-replicated append from a
            # legacy path. Folding committed records on top would diverge
            # from every other replica; start from a verifiably virgin log.
            log.warning("g=%d first binding over non-empty log (end %d); "
                        "resetting replica log", group, self.log.next_offset())
            self._reset_replica()
            return
        if raw is not None:
            try:
                self._applied, recorded_end = struct.unpack_from(">QQ", raw)
                self._pids = _decode_pids(raw[16:])
            except (ValueError, struct.error):
                # Unreadable position record (corrupt, or an incompatible
                # on-disk format from another build): degrade to the same
                # empty-replica reset as every other unrecoverable-state
                # path instead of refusing to boot.
                log.warning("g=%d unreadable position record; "
                            "resetting replica log", group)
                self._reset_replica()
                return
            actual_end = self.log.next_offset()
            if actual_end < recorded_end:
                # The log is SHORTER than the position record claims — e.g.
                # a restore's wipe hit disk but the restore-intent marker's
                # KV commit was lost to power failure. The missing prefix is
                # unrecoverable locally; reset like the marker path.
                log.warning(
                    "g=%d log end %d < recorded %d (lost prefix); "
                    "resetting replica log", group, actual_end, recorded_end)
                self._reset_replica()
            elif actual_end > recorded_end:
                # Crash after log.append but before the position record: the
                # block right after _applied is already in the log. Exactly
                # one append can be torn (appends are sequential), so one
                # skip flag suffices.
                self._skip_torn = True
                log.warning(
                    "g=%d torn append detected (log end %d > recorded %d); "
                    "first replayed block will be skipped",
                    group, actual_end, recorded_end)

    def reset(self) -> None:
        """Public reset for the engine's ReplicaDiverged handling: wipe the
        replica back to empty so a fresh leader sync rebuilds it."""
        self._reset_replica()

    def _reset_replica(self) -> None:
        """The ONE wipe-and-reset sequence (crash-recovery paths share it so
        their ordering can never diverge): empty log, zero position record,
        cleared producer-dedup state, no restore-intent marker."""
        self.log.wipe()
        self._applied = 0
        self._skip_torn = False
        self._pids = {}
        self.kv.put(self._key, self._record())
        self.kv.delete(self._rkey)

    def _record(self) -> bytes:
        return (struct.pack(">QQ", self._applied, self.log.next_offset())
                + _encode_pids(self._pids))

    # Engine replay contract: blocks in (applied_id(), committed] are
    # re-applied through transition_block at registration time.
    def applied_id(self) -> int:
        return self._applied

    def transition_block(self, blk) -> bytes:
        if blk.id <= self._applied:
            return b""  # duplicate delivery (defensive; replay is exact)
        batch = blk.data
        if is_migration_fence(batch):
            # Migration fence: a consensus marker, not a record batch —
            # it must never reach the seglog. Advancing the position
            # record IS the handoff point: with the source row frozen,
            # nothing but fences can mint after it, so applied == this
            # block id bounds exactly the prefix the target row adopts.
            self._applied = blk.id
            self.kv.put(self._key, self._record())
            if self.on_fence is not None:
                self.on_fence(blk.id)
            return b""
        pid, epoch, base_seq, count = records.blob_producer_info(batch)
        # Idempotent-producer dedup, decided deterministically at APPLY time
        # (every replica holds the same pid state at the same commit point,
        # so all make the same call). A retried produce whose original DID
        # commit re-acks the original base offset instead of appending a
        # second copy — the guarantee real Kafka gives with enable.idempotence
        # and the reference cannot (its Produce is unreachable; SURVEY.md
        # quirk 8).
        err = 0
        append = True
        if pid >= 0 and base_seq >= 0:
            last = self._pids.get(pid)
            if last is not None and epoch > last[0]:
                last = None  # new producer session — accept and re-track
            if last is not None and epoch < last[0]:
                # Stale epoch (Kafka INVALID_PRODUCER_EPOCH).
                append = False
                err, base = 47, -1
            elif last is not None:
                window = last[2]  # [[base_seq, count, base_offset], ...]
                hit = next((e for e in window if e[0] == base_seq), None)
                tail = window[-1]
                expected = tail[0] + tail[1]
                if hit is not None and hit[1] == count:
                    # Retry of a batch still in the window (Kafka keeps 5
                    # for max.in.flight=5): re-ack its original base.
                    append = False
                    base = hit[2]
                elif base_seq < expected:
                    # Behind the window (or an overlapping mismatch):
                    # refuse rather than double-append
                    # (Kafka DUPLICATE_SEQUENCE_NUMBER).
                    append = False
                    err, base = 46, -1
                elif base_seq != expected:
                    # Sequence gap (Kafka OUT_OF_ORDER_SEQUENCE_NUMBER).
                    append = False
                    err, base = 45, -1
        if append:
            if self._skip_torn:
                # Torn-append recovery: the boot-time detector saw the log
                # one append AHEAD of the position record and assumes that
                # unrecorded tail IS this (first replayed) block's record.
                # VERIFY it: if the tail bytes differ, something else wrote
                # the log (e.g. an un-replicated append from a foreign
                # code path) and skipping would drop a committed record
                # from this replica forever — unrecoverable locally.
                self._skip_torn = False
                base = self.log.next_offset() - count
                tail = self.log.read(base) if base >= 0 else None
                expected = records.set_base_offset(batch, base)
                if (tail is None or tail[0] != base or tail[1] != count
                        or tail[2] != expected):
                    raise ReplicaDiverged(
                        f"g={self.group} torn-tail mismatch at base {base}: "
                        f"log tail is not block {blk.id:#x}'s record")
            else:
                base = self.log.next_offset()
                self.log.append(records.set_base_offset(batch, base),
                                count=count)
            if pid >= 0 and base_seq >= 0:
                ent = self._pids.get(pid)
                if ent is None or epoch > ent[0]:
                    ent = [epoch, blk.id, []]
                    self._pids[pid] = ent
                ent[1] = blk.id
                ent[2].append([base_seq, count, base])
                del ent[2][:-_DEDUP_WINDOW]
                if len(self._pids) > _MAX_PIDS:
                    # Deterministic eviction (every replica applies the same
                    # sequence, so last-seen block ids agree): drop the
                    # longest-idle producer — the analog of Kafka's
                    # producer.id.expiration, bounding both the map and the
                    # per-apply record rewrite.
                    oldest = min(self._pids, key=lambda k: self._pids[k][1])
                    del self._pids[oldest]
        self._applied = blk.id
        if append and self._fsync:
            self.log.flush()
        self.kv.put(self._key, self._record())
        if append and self.on_append is not None:
            self.on_append()
        return struct.pack(">hq", err, base)

    # ------------------------------------------------- snapshot / log sync

    def snapshot(self) -> bytes:
        """Small manifest: the data already sits in the seglog; a snapshot
        pins (applied block id, log end) plus the producer-dedup map so the
        chain below it can be truncated and a restored replica keeps making
        identical dedup decisions."""
        return self._record()

    def snapshot_resume_offset(self) -> int:
        """Where an incremental log sync may resume: everything below our
        log end is byte-identical to the leader's (both logs are the same
        deterministic fold of the committed block sequence), so a transfer
        only needs the suffix from here."""
        return self.log.next_offset()

    def snapshot_export_header(self, record: bytes, start: int = 0) -> bytes:
        """The wire header of an export: ``(applied, end, start, pid_len)``
        + the producer-dedup map bytes (validated). ``start > 0`` is the
        incremental form (the receiver reported its resume position)."""
        if len(record) < 16:
            raise ValueError(
                f"g={self.group} snapshot record is {len(record)} bytes, "
                "expected a manifest of at least 16")
        applied, end = struct.unpack_from(">QQ", record)
        pid_bytes = record[16:]
        _decode_pids(pid_bytes)  # validate before shipping
        start = min(max(0, start), end)
        return struct.pack(">QQQI", applied, end, start,
                           len(pid_bytes)) + pid_bytes

    def snapshot_export_frames(self, record: bytes, start: int,
                               max_bytes: int) -> tuple[bytes, int, bool]:
        """One bounded WINDOW of ``(base, count, len, bytes)`` frames from
        log offset ``start``: ``(frames, next_offset, done)``. The engine's
        transfer stream calls this per window so a multi-GB partition is
        never materialized in memory on the sender (ADVICE r2 medium) —
        only ~max_bytes is live per in-flight transfer."""
        applied, end = struct.unpack_from(">QQ", record)
        out = []
        off = start
        size = 0
        while off < end and size < max_bytes:
            blobs = self.log.read_from(off, min(max_bytes, 4 << 20))
            if not blobs:
                raise ValueError(
                    f"g={self.group} log hole at offset {off} "
                    f"(manifest end {end}) exporting snapshot")
            for base, count, payload in blobs:
                if base >= end:
                    off = end
                    break
                if base != off:
                    # A resume hint that is not one of OUR blob boundaries
                    # cannot be served (the receiver's log diverges).
                    raise ValueError(
                        f"g={self.group} resume offset {off} is not a blob "
                        f"boundary (nearest base {base})")
                out.append(struct.pack(">QII", base, count, len(payload)))
                out.append(payload)
                size += 16 + len(payload)
                off = base + (count or 1)
                if size >= max_bytes:
                    break
        return b"".join(out), off, off >= end

    def snapshot_export(self, record: bytes, start: int = 0) -> bytes:
        """Full single-shot export (header + all frames). Small states and
        tests; the engine's chunked transfer path streams windows via
        snapshot_export_header/snapshot_export_frames instead."""
        header = self.snapshot_export_header(record, start)
        _, end = struct.unpack_from(">QQ", record)
        start = min(max(0, start), end)
        out = [header]
        off = start
        done = off >= end
        while not done:
            frames, off, done = self.snapshot_export_frames(
                record, off, 4 << 20)
            out.append(frames)
        return b"".join(out)

    # Streaming restore (the engine's chunked-transfer receive path): the
    # peer's export arrives as bounded chunks and is appended to the log
    # frame by frame — the receiver never holds the whole export either.
    # A crash anywhere inside the stream leaves the restore-intent marker,
    # and boot-time recovery resets the replica (exactly the single-shot
    # path's guarantee). An aborted stream's partial log is a VALID prefix
    # of the source's log (frames applied in order), so a follow-up
    # incremental sync resumes from its end without waste.

    def restore_begin(self, header: bytes) -> None:
        """Start adopting a snapshot stream. ``header`` is the export
        header: (applied, end, start, pid_len) + pid map. start == 0 wipes
        and rebuilds; start > 0 appends from exactly our log end."""
        if len(header) < 28:
            raise ValueError("snapshot header shorter than 28 bytes")
        applied, end, start, pid_len = struct.unpack_from(">QQQI", header)
        if start > end:
            raise ValueError(f"snapshot start {start} beyond end {end}")
        if 28 + pid_len != len(header):
            raise ValueError("snapshot header/pid-map length mismatch")
        pids = _decode_pids(header[28:])
        if start > 0 and start != self.log.next_offset():
            raise ValueError(
                f"incremental snapshot starts at {start}, local log end is "
                f"{self.log.next_offset()}")
        self.kv.put(self._rkey, b"1")
        if start == 0:
            self.log.wipe()
        self._stream = [applied, end, start, pids]

    def restore_chunk(self, frames: bytes) -> None:
        """Apply whole frames (the engine's stream layer reassembles frame
        boundaries from byte chunks)."""
        if getattr(self, "_stream", None) is None:
            raise ValueError("restore_chunk without restore_begin")
        applied, end, off, pids = self._stream
        pos = 0
        while pos < len(frames):
            if pos + 16 > len(frames):
                raise ValueError("truncated snapshot frame header")
            base, count, ln = struct.unpack_from(">QII", frames, pos)
            pos += 16
            if pos + ln > len(frames):
                raise ValueError("truncated snapshot frame payload")
            if count < 1:
                raise ValueError(f"snapshot frame at {base} has count 0")
            if base != off:
                raise ValueError(
                    f"non-contiguous snapshot frame base {base} != {off}")
            if base + (count or 1) > end:
                raise ValueError(
                    f"snapshot frame at {base} overruns manifest end {end}")
            self.log.append(frames[pos:pos + ln], count=count)
            pos += ln
            off = base + (count or 1)
        self._stream[2] = off

    def restore_end(self) -> None:
        """Finish the stream: frames must cover exactly [start, end)."""
        if getattr(self, "_stream", None) is None:
            raise ValueError("restore_end without restore_begin")
        applied, end, off, pids = self._stream
        if off != end:
            raise ValueError(
                f"snapshot stream ends at {off}, header claims {end}")
        if self._fsync:
            self.log.flush()
        self._applied = applied
        self._skip_torn = False
        self._pids = pids
        self._stream = None
        self.kv.put(self._key, self._record())
        self.kv.delete(self._rkey)
        if self.on_append is not None:
            self.on_append()

    def restore_abort(self) -> None:
        """Drop an in-flight stream. The partial log is a valid prefix of
        the source's (kept — a follow-up incremental sync resumes from its
        end); the intent marker stays until some restore completes, so a
        crash still degrades to the boot-time reset."""
        self._stream = None

    def restore(self, data: bytes) -> None:
        """Adopt a snapshot payload: ``start == 0`` replaces the whole log;
        ``start > 0`` is an incremental sync appending the missing suffix
        (only valid when it begins exactly at our log end — both logs are
        the same deterministic fold, so the prefix is already identical).
        Frames are fully validated BEFORE any mutation so a malformed
        payload from the wire rejects without touching durable state —
        including the empty payload: restore() is wire-reachable, so an
        empty-means-reset branch would let a degenerate MSG_SNAPSHOT wipe a
        healthy replica (internal resets use _reset_replica)."""
        self._stream = None  # a single-shot restore supersedes any stream
        if len(data) < 28:
            raise ValueError("partition snapshot shorter than its header")
        applied, end, start, pid_len = struct.unpack_from(">QQQI", data)
        if start > end:
            raise ValueError(f"snapshot start {start} beyond end {end}")
        if start > 0 and start != self.log.next_offset():
            raise ValueError(
                f"incremental snapshot starts at {start}, local log end is "
                f"{self.log.next_offset()}")
        if 28 + pid_len > len(data):
            raise ValueError("truncated producer-dedup map")
        pids = _decode_pids(data[28:28 + pid_len])  # validate before mutate
        frames: list[tuple[int, bytes]] = []
        pos, off = 28 + pid_len, start
        while pos < len(data):
            if pos + 16 > len(data):
                raise ValueError("truncated snapshot frame header")
            base, count, ln = struct.unpack_from(">QII", data, pos)
            pos += 16
            if pos + ln > len(data):
                raise ValueError("truncated snapshot frame payload")
            if count < 1:
                # The seglog rejects count < 1 at append time; catching it
                # here keeps the validate-before-mutate contract honest.
                raise ValueError(f"snapshot frame at {base} has count 0")
            if base != off:
                raise ValueError(
                    f"non-contiguous snapshot frame base {base} != {off}")
            frames.append((count, data[pos:pos + ln]))
            pos += ln
            off = base + (count or 1)
        if off != end:
            raise ValueError(
                f"snapshot frames end at {off}, header claims {end}")
        # Restore-intent marker: neither the wipe-and-rebuild nor the
        # multi-frame suffix append is crash-atomic (the torn-append
        # detector covers exactly one trailing append). A crash inside the
        # window is detected at boot and degrades to an empty replica the
        # leader re-syncs.
        self.kv.put(self._rkey, b"1")
        if start == 0:
            self.log.wipe()
        for count, payload in frames:
            self.log.append(payload, count=count)
        if self._fsync:
            self.log.flush()
        self._applied = applied
        self._skip_torn = False
        self._pids = pids
        self.kv.put(self._key, self._record())
        self.kv.delete(self._rkey)
        if self.on_append is not None:
            self.on_append()

    def close(self) -> None:
        pass  # the Log is owned by the Replica registry


def _encode_pids(pids: dict[int, list]) -> bytes:
    """Deterministic (sorted-key) serialization — the map is replicated
    state and snapshots of it must be byte-identical across replicas.
    Value shape: [epoch, last_seen_block_id, [[base_seq, count, base], ...]]
    (window capped at _DEDUP_WINDOW entries)."""
    if not pids:
        return b""
    import json

    return json.dumps({str(k): v for k, v in sorted(pids.items())},
                      separators=(",", ":")).encode()


def _decode_pids(raw: bytes) -> dict[int, list]:
    if not raw:
        return {}
    import json

    try:
        d = json.loads(raw)
        out: dict[int, list] = {}
        for k, v in d.items():
            if len(v) == 5 and not isinstance(v[2], list):
                # Pre-window on-disk shape ([epoch, seq, count, base, blk],
                # one flat record per pid): accept as a one-entry window so
                # a cross-version restart upgrades in place instead of
                # silently wiping the replica for a full re-sync.
                epoch, seq, count, base, blk = (int(x) for x in v)
                out[int(k)] = [epoch, blk, [[seq, count, base]]]
                continue
            epoch, blk, window = int(v[0]), int(v[1]), v[2]
            if not window or len(window) > _DEDUP_WINDOW:
                raise ValueError(f"window size {len(window)} for pid {k}")
            out[int(k)] = [
                epoch, blk, [[int(s), int(c), int(b)] for s, c, b in window]]
        return out
    except (ValueError, TypeError, AttributeError, IndexError, KeyError) as e:
        raise ValueError(f"bad producer-dedup map: {e}") from None


def decode_produce_result(result: bytes) -> tuple[int, int]:
    """(error_code, base_offset) from a committed produce proposal's FSM
    result. error_code is a Kafka code (45 out-of-order sequence, 46
    duplicate sequence, 47 invalid producer epoch) or 0."""
    err, base = struct.unpack(">hq", result)
    return err, base


def decode_base_offset(result: bytes) -> int:
    """Base offset only (legacy callers/tests)."""
    return decode_produce_result(result)[1]
