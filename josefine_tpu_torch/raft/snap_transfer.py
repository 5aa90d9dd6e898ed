"""Snapshot capture, chunked transfer, and install for RaftEngine.

Mixin half of :class:`josefine_tpu_torch.raft.engine.RaftEngine` (state
is initialized there), ported from the JAX package's
``raft/snap_transfer.py``: the host logic is the same, and the device-row
re-point at install builds new leaves instead of writing the live state.
Covers the full lifecycle:

* **capture** — :meth:`take_snapshot` / :meth:`_maybe_snapshot`: FSM
  snapshot + chain truncation below the commit point (real log compaction;
  the reference's snapshotting knobs are vestigial — SURVEY.md aux notes);
* **send** — :meth:`_snapshot_msg` / :meth:`_probe_msg` /
  :meth:`_handle_snap_ack`: position-probed incremental log sync for
  export-style FSMs, bounded chunks, ack-advanced pointers, lazily
  materialized windows (:class:`_SnapStream` — at most ~window_bytes of
  export live per transfer);
* **receive** — :meth:`_stage_snapshot` / :class:`_SnapSink` /
  :meth:`_install_snapshot` / :meth:`_adopt_snapshot`: streaming or
  buffer-staged reassembly, install, and chain/device/term adoption;
* **hygiene** — GC of transfers to dead peers, purge on group reset.
"""

from __future__ import annotations

import struct as _struct

from josefine_tpu_torch.ops import ids
from josefine_tpu_torch.raft import rpc
from josefine_tpu_torch.raft.chain import id_seq, id_term
from josefine_tpu_torch.raft.fsm import supports_snapshot
from josefine_tpu_torch.raft.group_admin import set_row
from josefine_tpu_torch.raft.membership import ADD, REMOVE, ConfChange, MemberTable
from josefine_tpu_torch.raft.result import NotLeader
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("raft.engine")

_m_snapshots = REGISTRY.counter(
    "raft_snapshots_total", "Snapshots taken (log compactions)")
_m_installs = REGISTRY.counter(
    "raft_snapshot_installs_total", "Snapshots installed from a leader")


class _SnapStream:
    """Sender side of one snapshot transfer, materialized lazily: at most
    ~window_bytes of export is live per in-flight transfer (pinning the
    whole export would be a per-follower multi-GB allocation exactly when
    a replica is being rebuilt). The byte stream is header + frames;
    windows advance as acks consume the prefix. Total length is unknown
    until the log walk completes — the final chunk carries it in z
    (non-final chunks ship z=0)."""

    __slots__ = ("fsm", "record", "base", "win", "next_log", "log_done")

    def __init__(self, fsm, record: bytes, start_log: int):
        self.fsm = fsm
        self.record = record
        self.base = 0
        self.win = fsm.snapshot_export_header(record, start_log)
        self.next_log = start_log
        self.log_done = False

    def read_at(self, off: int, n: int, window_bytes: int) -> tuple[bytes, int]:
        """(chunk at byte offset ``off``, total_or_0). total > 0 only when
        this chunk is final. ``off`` must not regress below the consumed
        prefix (regressed receivers drop the transfer and re-probe)."""
        if off < self.base:
            raise ValueError(f"stream regression: {off} < {self.base}")
        cut = off - self.base
        if cut:
            self.win = self.win[cut:]
            self.base = off
        while len(self.win) < n and not self.log_done:
            frames, self.next_log, self.log_done = (
                self.fsm.snapshot_export_frames(
                    self.record, self.next_log, max(window_bytes, n)))
            self.win += frames
        chunk = self.win[:n]
        final = self.log_done and len(self.win) <= n
        return chunk, (off + len(chunk)) if final else 0


class _SnapSink:
    """Receiver side of one streaming snapshot transfer: reassembles frame
    boundaries from byte chunks and feeds whole frames to the FSM's
    restore_begin/chunk/end — memory bound is one partial frame plus the
    header, never the export."""

    __slots__ = ("fsm", "snap_id", "src", "consumed", "buf", "started")

    def __init__(self, fsm, snap_id: int, src: int):
        self.fsm = fsm
        self.snap_id = snap_id
        self.src = src
        self.consumed = 0      # byte offset acked back to the sender
        self.buf = bytearray()  # header-in-progress or partial frame tail
        self.started = False

    def feed(self, chunk: bytes) -> None:
        self.buf += chunk
        self.consumed += len(chunk)
        if not self.started:
            if len(self.buf) < 28:
                return
            (pid_len,) = _struct.unpack_from(">I", self.buf, 24)
            if len(self.buf) < 28 + pid_len:
                return
            self.fsm.restore_begin(bytes(self.buf[:28 + pid_len]))
            del self.buf[:28 + pid_len]
            self.started = True
        # Feed every COMPLETE frame; keep the partial tail.
        pos = 0
        while pos + 16 <= len(self.buf):
            _base, _cnt, ln = _struct.unpack_from(">QII", self.buf, pos)
            if pos + 16 + ln > len(self.buf):
                break
            pos += 16 + ln
        if pos:
            self.fsm.restore_chunk(bytes(self.buf[:pos]))
            del self.buf[:pos]

    def finish(self) -> None:
        if not self.started or self.buf:
            raise ValueError("snapshot stream ended mid-frame")
        self.fsm.restore_end()

    def abort(self) -> None:
        ab = getattr(self.fsm, "restore_abort", None)
        if callable(ab):
            ab()


class SnapshotTransfer:
    """Snapshot methods of RaftEngine (see module docstring)."""

    # ---------------------------------------------------------- capture

    def _load_snapshot(self, g: int) -> tuple[int | None, bytes]:
        cached = self._snap_cache.get(g)
        if cached is not None:
            return cached
        # Single record (8-byte id || data): one KV put is one transaction,
        # so a crash can never pair an old id with a new image (which would
        # double-apply (old, new] on restart recovery).
        raw = self.kv.get(b"g%d:snap" % g)
        if raw is None:
            return None, b""
        snap = (int.from_bytes(raw[:8], "big"), raw[8:])
        self._snap_cache[g] = snap
        return snap

    def _store_snapshot(self, g: int, snap_id: int, data: bytes) -> None:
        self.kv.put(b"g%d:snap" % g, snap_id.to_bytes(8, "big") + data)
        self._snap_cache[g] = (snap_id, data)

    def take_snapshot(self, g: int) -> int | None:
        """Snapshot group ``g`` at its current commit point and truncate the
        chain below it. Returns the snapshot block id, or None if the group's
        FSM cannot snapshot or there is nothing new to capture."""
        drv = self.drivers.get(g)
        if drv is None or not supports_snapshot(drv.fsm):
            return None
        ch = self.chains[g]
        if ch.committed <= ch.floor:
            return None
        applied = getattr(drv.fsm, "applied_id", None)
        if callable(applied) and applied() < ch.committed:
            # The FSM has not applied up to the commit point (cannot happen
            # on the synchronous tick path; defensive for direct callers) —
            # snapshotting here would truncate blocks the FSM still needs.
            return None
        data = drv.fsm.snapshot()
        self._store_snapshot(g, ch.committed, data)
        snap_id = ch.committed
        removed = ch.truncate(snap_id)
        # Piggyback dead-branch GC (reference chain.rs:239-253) on the
        # snapshot cadence: truncation only removes blocks below the floor;
        # abandoned fork blocks above it are collected here.
        removed += ch.compact()
        self._last_snap_tick[g] = self._ticks
        _m_snapshots.inc(node=self.self_id)
        log.info("snapshot g=%d at %#x (%d bytes, %d blocks truncated)",
                 g, snap_id, len(data), removed)
        return snap_id

    def _maybe_snapshot(self) -> None:
        if self.snapshot_threshold is None and self.snapshot_interval_ticks is None:
            return
        for g, drv in self.drivers.items():
            if not supports_snapshot(drv.fsm):
                # Skipping here avoids a no-op take_snapshot retry every
                # tick once the backlog crosses the threshold. (All in-tree
                # FSMs snapshot — PartitionFsm via its manifest + log-sync
                # export; this covers user FSMs without the pair.)
                continue
            ch = self.chains[g]
            backlog = id_seq(ch.committed) - id_seq(ch.floor)
            if backlog <= 0:
                continue
            due = (
                self.snapshot_threshold is not None
                and backlog >= self.snapshot_threshold
            ) or (
                self.snapshot_interval_ticks is not None
                and self._ticks - self._last_snap_tick.get(g, 0)
                >= self.snapshot_interval_ticks
            )
            if due:
                self.take_snapshot(g)

    # ---------------------------------------------------------- receive

    def _stage_snapshot(self, msg: rpc.WireMsg) -> None:
        """Receiver side of the chunked snapshot transfer: accumulate
        in-order chunks per group, ack progress back to the sender, and
        install once the buffer covers the advertised total. Out-of-order
        or duplicate chunks are ignored (the re-ack re-synchronizes the
        sender's pointer); a sender restart with a NEWER snapshot id resets
        the staging buffer."""
        g = msg.group
        if not (0 <= g < self.P) or not (0 <= msg.src < self.N):
            return
        if self.drivers.get(g) is None and g != 0:
            # No FSM wired for this data group yet (restart re-wiring races
            # the leader's send): don't stage and don't ack — an ack here
            # would make the sender tear down its transfer state and
            # re-stream the whole export from offset 0 every tick until
            # register_fsm happens. Silence keeps the sender's resend
            # throttle pacing it at one chunk per window.
            log.warning("deferring snapshot g=%d: no FSM registered yet", g)
            return
        ch = self.chains[g]
        if msg.x <= ch.committed:
            # Stale: we already hold this prefix — tell the sender to stop.
            self._drop_staging(g)
            self._snap_acks.append(rpc.WireMsg(
                kind=rpc.MSG_SNAPSHOT_ACK, group=g, src=self.me, dst=msg.src,
                x=msg.x, y=msg.z, ok=1, inc=int(self._h_ginc[g])))
            return
        if msg.ok:
            # Position probe: reply with where an incremental sync may
            # resume (export-style FSMs — everything below our log end is
            # already identical to the sender's); nothing is staged.
            drv = self.drivers.get(g)
            hint = (getattr(drv.fsm, "snapshot_resume_offset", None)
                    if (drv and self.snap_incremental) else None)
            resume = int(hint()) if callable(hint) else 0
            self._drop_staging(g)
            self._snap_acks.append(rpc.WireMsg(
                kind=rpc.MSG_SNAPSHOT_ACK, group=g, src=self.me, dst=msg.src,
                x=msg.x, y=0, z=resume, ok=0, inc=int(self._h_ginc[g])))
            return
        if msg.y == 0 and msg.z and len(msg.payload) >= msg.z:
            # Single-frame transfer (small snapshots): install directly.
            # ok=1 only on a successful install — acking a failed one would
            # tear down the sender's state and trigger a full re-stream.
            self._drop_staging(g)
            if self._install_snapshot(msg, msg.payload):
                self._snap_acks.append(rpc.WireMsg(
                    kind=rpc.MSG_SNAPSHOT_ACK, group=g, src=self.me,
                    dst=msg.src, x=msg.x, y=msg.z, ok=1,
                    inc=int(self._h_ginc[g])))
            return
        drv = self.drivers.get(g)
        streaming = (drv is not None
                     and callable(getattr(drv.fsm, "restore_begin", None)))
        self._snap_stage_tick[g] = self._ticks
        if streaming:
            # Streaming restore: frames land in the FSM (and its log) as
            # they arrive — the receiver never buffers the export either.
            # Total length arrives with the FINAL chunk (z).
            sink = self._snap_staging.get(g)
            if not isinstance(sink, _SnapSink) or sink.snap_id != msg.x:
                self._drop_staging(g)
                sink = _SnapSink(drv.fsm, msg.x, msg.src)
                self._snap_staging[g] = sink
                # _drop_staging popped the freshness stamp set above; a
                # sink without one reads as infinitely stale to the GC.
                self._snap_stage_tick[g] = self._ticks
            if msg.y == sink.consumed and msg.payload:
                if sink.consumed == 0:
                    # First chunk may begin a stream over an older aborted
                    # one — fail proposals like the install path does.
                    drv.drop_waiters(NotLeader(g, msg.src))
                try:
                    sink.feed(msg.payload)
                except (ValueError, OSError) as e:
                    log.error("rejecting snapshot stream g=%d from %d: %s",
                              g, msg.src, e)
                    sink.abort()
                    self._drop_staging(g)
                    return
            if msg.z and sink.consumed >= msg.z:
                # Plain pop — _drop_staging would ABORT the FSM stream we
                # are about to finish.
                self._snap_staging.pop(g, None)
                self._snap_stage_tick.pop(g, None)
                try:
                    sink.finish()
                except (ValueError, OSError) as e:
                    log.error("snapshot stream g=%d failed to finish: %s",
                              g, e)
                    sink.abort()
                    return
                self._adopt_snapshot(g, msg)
                self._snap_acks.append(rpc.WireMsg(
                    kind=rpc.MSG_SNAPSHOT_ACK, group=g, src=self.me,
                    dst=msg.src, x=msg.x, y=sink.consumed, ok=1,
                    inc=int(self._h_ginc[g])))
                return
            self._snap_acks.append(rpc.WireMsg(
                kind=rpc.MSG_SNAPSHOT_ACK, group=g, src=self.me, dst=msg.src,
                x=msg.x, y=sink.consumed, ok=0, inc=int(self._h_ginc[g])))
            return
        # Single-shot FSMs (e.g. the metadata manifest): buffer-stage. The
        # total may only arrive with the final chunk (z) under the
        # streaming sender, so completion is checked against msg.z.
        st = self._snap_staging.get(g)
        if not isinstance(st, list) or st[0] != msg.x:
            st = [msg.x, bytearray()]
            self._snap_staging[g] = st
        buf = st[1]
        if msg.y == len(buf) and msg.payload:
            buf += msg.payload
        if msg.z and len(buf) >= msg.z:
            self._drop_staging(g)
            if self._install_snapshot(msg, bytes(buf)):
                self._snap_acks.append(rpc.WireMsg(
                    kind=rpc.MSG_SNAPSHOT_ACK, group=g, src=self.me,
                    dst=msg.src, x=msg.x, y=len(buf), ok=1,
                    inc=int(self._h_ginc[g])))
            return
        self._snap_acks.append(rpc.WireMsg(
            kind=rpc.MSG_SNAPSHOT_ACK, group=g, src=self.me, dst=msg.src,
            x=msg.x, y=len(buf), ok=0, inc=int(self._h_ginc[g])))

    def _drop_staging(self, g: int) -> None:
        st = self._snap_staging.pop(g, None)
        if isinstance(st, _SnapSink):
            st.abort()
        self._snap_stage_tick.pop(g, None)

    # ------------------------------------------------------------- send

    def _handle_snap_ack(self, msg: rpc.WireMsg) -> None:
        """Sender side: an ack advances the per-(group, dst) transfer
        pointer and lifts the resend throttle so the next chunk ships on
        the next tick; ok=1 (installed / already-current) ends the
        transfer. An equal-offset ack is a duplicate (resent chunk) and is
        ignored; a REGRESSED ack means the receiver's staging restarted, so
        the transfer is dropped and re-probed (a pinned suffix may no
        longer be servable there)."""
        key = (msg.group, msg.src)
        ptr = self._snap_send_off.get(key)
        if ptr is None or ptr[0] != msg.x:
            return
        self._snap_ack_tick[key] = self._ticks
        if msg.ok:
            self._drop_transfer(key)
            return
        if ptr[1] == -1:
            # Position-probe reply: the follower's resume offset rides in
            # z. Open a lazy stream over the (suffix) export — the whole
            # point of the probe is that a follower that already holds a
            # log prefix only receives the missing suffix, and the stream
            # materializes at most a window of it at a time.
            g = msg.group
            drv = self.drivers.get(g)
            exp = getattr(drv.fsm, "snapshot_export_header", None) if drv else None
            if not callable(exp):
                self._drop_transfer(key)
                return
            snap_id, record = self._load_snapshot(g)
            if snap_id != ptr[0]:
                # The snapshot moved while probing; restart next round.
                self._drop_transfer(key)
                return
            try:
                self._snap_payload[key] = _SnapStream(
                    drv.fsm, record, int(msg.z))
            except (ValueError, OSError) as e:
                log.error("cannot export snapshot g=%d from %d: %s",
                          g, int(msg.z), e)
                self._drop_transfer(key)
                return
            self._snap_send_off[key] = (ptr[0], 0)
            self._snap_sent_tick.pop(key, None)  # first chunk next tick
            return
        if msg.y == ptr[1]:
            # Duplicate of the ack that advanced us here (the receiver
            # re-acks an ignored resent chunk). Not a regression — dropping
            # the transfer on it would livelock catch-up whenever ack
            # latency exceeds the resend window.
            return
        if msg.y < ptr[1]:
            # True regression: the receiver's staging restarted (it
            # crashed/reset mid-transfer). A pinned suffix export may now be
            # unservable there (its start no longer matches the replica's
            # log end), so rolling the pointer back would loop forever —
            # drop the transfer and re-probe the resume position fresh.
            self._drop_transfer(key)
            return
        self._snap_send_off[key] = (msg.x, msg.y)
        self._snap_sent_tick.pop(key, None)

    def _drop_transfer(self, key: tuple[int, int]) -> None:
        self._snap_send_off.pop(key, None)
        self._snap_payload.pop(key, None)
        self._snap_sent_tick.pop(key, None)
        self._snap_ack_tick.pop(key, None)

    def _gc_snap_transfers(self) -> None:
        """Age out transfers whose peer has gone quiet (crashed or
        removed): sender state would otherwise pin exported payloads
        forever, and receiver staging buffers (up to export-sized) would
        leak when the sending leader dies mid-transfer. A returning peer
        restarts its transfer with a fresh probe."""
        for k in [k for k in self._snap_send_off
                  if self._ticks - self._snap_ack_tick.get(k, 0)
                  > self.snap_transfer_stale_ticks]:
            self._drop_transfer(k)
        for g in [g for g in self._snap_staging
                  if self._ticks - self._snap_stage_tick.get(g, 0)
                  > self.snap_transfer_stale_ticks]:
            self._drop_staging(g)

    def _drop_group_transfers(self, g: int) -> None:
        """Purge ALL transfer state touching group ``g`` (both sides): a
        group being unregistered or reset must not leak a previous
        incarnation's export into a future topic claiming the same row."""
        for k in [k for k in self._snap_send_off if k[0] == g]:
            self._drop_transfer(k)
        self._drop_staging(g)

    # ---------------------------------------------------------- install

    def _install_snapshot(self, msg: rpc.WireMsg, payload: bytes | None = None) -> bool:
        """Follower side: adopt a leader snapshot we cannot reach by log
        replay (our head fell below the leader's truncation floor).
        ``payload`` is the assembled transfer (defaults to the message's own
        payload for single-frame installs). Returns True only when the
        snapshot actually installed (the receiver acks ok=1 on that alone).
        """
        if payload is None:
            payload = msg.payload
        g = msg.group
        if not (0 <= g < self.P):
            return False
        ch = self.chains[g]
        if msg.x <= ch.committed:
            return False  # stale: we already have this prefix
        drv = self.drivers.get(g)
        if drv is None and g != 0:
            # No FSM wired for a data group yet (restart re-wiring races the
            # leader's send): installing now would advance the chain past
            # state the FSM never restored — the gap would be silently
            # skipped at register_fsm time and this replica's log would stay
            # empty forever. Drop; the leader re-sends past its throttle.
            log.warning("deferring snapshot g=%d: no FSM registered yet", g)
            return False
        snap_record = payload
        if drv is not None:
            if not supports_snapshot(drv.fsm):
                log.warning(
                    "cannot install snapshot g=%d: FSM has no restore()", g)
                return False
            # Fail (not cancel) outstanding proposals so clients re-route,
            # same as the tick() leadership-loss path; msg.src is the leader.
            drv.drop_waiters(NotLeader(g, msg.src))
            try:
                drv.fsm.restore(payload)
            except (ValueError, OSError) as e:
                # ValueError: malformed payload (restore validates before
                # mutating its own state) — reject without touching the
                # chain, same degrade-not-crash rule as poison conf blocks.
                # OSError: the log is closed or unwritable (e.g. a snapshot
                # chunk arriving inside the shutdown window) — the restore
                # may have begun mutating, so its intent marker stays put
                # and boot-time recovery resets the replica; what must NOT
                # happen is this exception unwinding through the transport
                # task with the chain untouched either way.
                log.error("rejecting snapshot g=%d from %d: %s", g, msg.src, e)
                return False
            if callable(getattr(drv.fsm, "snapshot_export", None)):
                # Export-style FSMs (PartitionFsm): the wire payload was
                # materialized from the sender's log; durably record only
                # the small manifest — the restored log IS the state.
                snap_record = drv.fsm.snapshot()
        self._adopt_snapshot(g, msg, snap_record)
        log.info("installed snapshot g=%d at %#x (%d bytes)", g, msg.x, len(payload))
        return True

    def _adopt_snapshot(self, g: int, msg: rpc.WireMsg,
                        snap_record: bytes | None = None) -> None:
        """Chain/device/term adoption after a snapshot's FSM state landed
        (single-shot restore or a completed stream): persist the snapshot
        record, reset the chain to the anchor, re-point the device row, and
        adopt the member table the final chunk carried."""
        ch = self.chains[g]
        if snap_record is None:
            drv = self.drivers.get(g)
            snap_record = drv.fsm.snapshot() if drv is not None else b""
        # Persist the snapshot record BEFORE mutating the chain (same order
        # as take_snapshot): a crash in between must leave a state the
        # restart recovery can boot from — floor > GENESIS with no matching
        # snapshot record is unrecoverable.
        self._store_snapshot(g, msg.x, snap_record)
        ch.install_snapshot(msg.x)
        # INVARIANT: every out-of-tick chain mutation must refresh the
        # _h_head/_h_commit mirrors itself — tick_finish's need-mask skips
        # quiet rows, so it will NOT heal a mirror this site leaves stale
        # (a drifted mirror misroutes the active-row diff forever).
        self._h_head[g] = ch.head
        self._h_commit[g] = ch.committed
        # Adopt the snapshot's mint term if it is ahead of ours: the
        # term >= id_term(head) invariant must hold or a later election won
        # at a lower term would mint a non-advancing block id.
        snap_term = id_term(msg.x)
        if snap_term > int(self._h_term[g]):
            # Same rule as every other higher-term adoption: voted_for resets
            # with the term (a stale vote carried into the adopted term could
            # wrongly deny votes there). One atomic (term, voted) record.
            self._store_vol(g, snap_term, -1)
            self._h_term[g] = snap_term
            self._h_voted[g] = -1
            self.state = self.state.replace(
                term=set_row(self.state.term, g, snap_term),
                voted_for=set_row(self.state.voted_for, g, -1))
        # Re-point this node's device row at the snapshot: head = commit =
        # snap id. The next AE probe not rooted here is rejected with our
        # commit as the hint, re-rooting the leader in 2 ticks.
        t, s = snap_term, id_seq(msg.x)
        self.state = self.state.replace(
            head=ids.Bid(set_row(self.state.head.t, g, t), set_row(self.state.head.s, g, s)),
            commit=ids.Bid(set_row(self.state.commit.t, g, t), set_row(self.state.commit.s, g, s)),
        )
        # Adopt the leader's member table (conf blocks below its floor are
        # not replayable); my own slot must be unchanged.
        if msg.aux:
            kv_mt = self.kv.get(MemberTable.KEY)
            if kv_mt != msg.aux:
                self.kv.put(MemberTable.KEY, msg.aux)
                new_members = MemberTable.load(self.kv, self.N)
                my_slot = new_members.slot_of(self.self_id)
                if my_slot != self.me or new_members.max_slots != self.N:
                    # Do not adopt a table that reassigns our slot or a
                    # different slot count — the device row identity /
                    # tensor shapes would silently change.
                    self.kv.put(MemberTable.KEY, kv_mt or b"")
                    log.error("snapshot member table incompatible (my slot "
                              "%d -> %s, slots %d -> %d); refusing",
                              self.me, my_slot, self.N, new_members.max_slots)
                else:
                    self.members = new_members
                    self.node_ids = [self.members.id_of(s) for s in range(self.N)]
                    self.member = self._member_mask()
                    self._conf_notify.extend(
                        ConfChange(op=ADD if m.active else REMOVE,
                                   node_id=m.node_id, ip=m.ip, port=m.port,
                                   slot=m.slot)
                        for m in self.members.by_id.values())
        _m_installs.inc(node=self.self_id)
        self.flight.emit(self._flight_tick(), "snapshot_install", group=g,
                         term=snap_term, snap_id=int(msg.x), src=msg.src)

    def _probe_msg(self, g: int, dst: int, term: int, snap_id: int) -> rpc.WireMsg:
        """Position probe (ok=1, empty payload): asks the follower where an
        incremental log sync may resume; its ack carries the offset in z."""
        self._snap_send_off[(g, dst)] = (snap_id, -1)
        self._snap_payload.pop((g, dst), None)
        self._snap_ack_tick.setdefault((g, dst), self._ticks)
        self._snap_sent_tick[(g, dst)] = self._ticks
        return rpc.WireMsg(kind=rpc.MSG_SNAPSHOT, group=g, src=self.me,
                           dst=dst, term=term, x=snap_id, ok=1,
                           inc=int(self._h_ginc[g]))

    def _snapshot_msg(self, g: int, dst: int, term: int) -> rpc.WireMsg | None:
        """Next message of the snapshot transfer to ``dst`` (or None).

        Export-style FSMs (the partition data plane) get incremental log
        sync: a position probe first, then ONLY the suffix the follower is
        missing, in bounded chunks (snap_chunk_bytes — a single frame would
        hit the transport's frame cap and could never sync a big
        partition). The per-(g, dst) pointer advances on acks — an acked
        chunk ships its successor on the very next tick; an unacked one
        re-sends after the throttle window. An in-flight transfer keeps
        shipping its own pinned payload even if a newer snapshot lands
        mid-transfer (restarting at 0 on every floor advance would never
        converge under sustained writes); the next transfer then starts
        from the follower's new, higher resume offset."""
        key = (g, dst)
        last = self._snap_sent_tick.get(key)
        if last is not None and self._ticks - last < 5:
            return None  # message in flight; wait for its ack or the window
        snap_id, data = self._load_snapshot(g)
        if snap_id is None or snap_id != self.chains[g].floor:
            log.warning("no usable snapshot for floor %#x g=%d",
                        self.chains[g].floor, g)
            return None
        drv = self.drivers.get(g)
        if drv is None and g != 0:
            # Data-group snapshot with no FSM wired (restart race, mirror of
            # the receive-side deferral): the record may be an export-style
            # manifest we cannot materialize — shipping it raw would be
            # rejected by every receiver. Defer until re-wiring.
            log.warning("deferring snapshot send g=%d: no FSM registered", g)
            return None
        exp = getattr(drv.fsm, "snapshot_export_header", None) if drv else None
        ptr = self._snap_send_off.get(key)
        if callable(exp):
            stream = self._snap_payload.get(key)
            if ptr is None or ptr[1] == -1 or stream is None:
                # No transfer (or probe outstanding with its ack lost):
                # (re-)probe the follower's resume position.
                return self._probe_msg(g, dst, term, snap_id)
            # In-flight transfer: keep shipping ITS stream (ptr[0] may be
            # an older, pinned snapshot id).
            snap_id = ptr[0]
            off = ptr[1]
            try:
                chunk, total = stream.read_at(off, self.snap_chunk_bytes,
                                              self.snap_window_bytes)
            except (ValueError, OSError) as e:
                log.error("snapshot stream g=%d->%d failed: %s", g, dst, e)
                self._drop_transfer(key)
                return None
            # An exhausted stream still (re-)sends its empty FINAL chunk:
            # the total in z is what lets the receiver finish, and a lost
            # final ack just means re-sending it after the throttle window
            # (a restarted follower's regressed ack drops the transfer via
            # _handle_snap_ack and re-probes fresh).
            final = total > 0
        else:
            # Single-shot record (e.g. the metadata manifest): the bytes
            # ARE the payload; chunk by byte offset.
            off = ptr[1] if ptr is not None and ptr[0] == snap_id and ptr[1] >= 0 else 0
            if off >= len(data) and len(data) > 0:
                off = 0  # restart (final ack lost / follower restarted)
            chunk = data[off:off + self.snap_chunk_bytes]
            final = off + len(chunk) >= len(data)
            total = len(data) if final else 0
        self._snap_send_off[key] = (snap_id, off)
        self._snap_ack_tick.setdefault(key, self._ticks)
        self._snap_sent_tick[key] = self._ticks
        # Group 0 snapshots carry the member table on the installing chunk:
        # the receiver may have missed conf blocks now below our floor.
        aux = (self.kv.get(MemberTable.KEY) or b"") if (g == 0 and final) else b""
        return rpc.WireMsg(
            kind=rpc.MSG_SNAPSHOT, group=g, src=self.me, dst=dst,
            term=term, x=snap_id, y=off, z=total, payload=chunk, aux=aux,
            inc=int(self._h_ginc[g]),
        )
