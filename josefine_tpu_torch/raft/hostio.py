"""Host-side wire<->device packing for RaftEngine: inbox build, outbox decode.

Mixin half of :class:`josefine_tpu_torch.raft.engine.RaftEngine` (state is
initialized there). The ``_build_inbox*`` methods pack queued wire
messages/columnar batches into the device step's packed (10, P, N) input
contract (dense), its touched-rows bucket (sparse) or the active set's
compact rows; the outbox
decoder turns the fetched packed outbox back into columnar per-peer
MsgBatches, attaching chain payload spans to AppendEntries (with
max_append_entries flow control) and snapshot messages where the span bottom
fell below the truncation floor.

The port of the JAX package's ``raft/hostio.py``. The host code is the
same; the one device write, the send-pointer fixup scatter, builds new
tensors instead of writing the live state.

Per-peer bounded send queue with carry-over: one message per (group, src)
slot per tick; extras carry over to the next tick instead of being dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from josefine_tpu_torch.ops import ids
from josefine_tpu_torch.parallel.sharded import Shards
from josefine_tpu_torch.raft import rpc
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("raft.engine")


def host_to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``, without waiting for the
    device. For a card the bytes are first copied into pinned memory: a copy
    from pageable memory may wait for the work already queued on the stream.
    ``a`` may be reused at once. The pinned block comes from PyTorch's
    caching host allocator, which reuses it only after the copy that read
    it has finished on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def host_into(dst: torch.Tensor, a: np.ndarray) -> None:
    """:func:`host_to` into the existing tensor ``dst``, of ``a``'s shape
    and dtype: one copy, with the same pinned staging and no wait."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dst.is_cuda:
        t = t.pin_memory()
    dst.copy_(t, non_blocking=True)


def _put_fixups(nxt: ids.Bid, fx: np.ndarray, dev: torch.device) -> ids.Bid:
    """``nxt[g, dst] = top`` for the (g, dst, top) rows of ``fx`` (unique
    (g, dst) pairs), as new tensors."""
    idx = (host_to(fx[:, 0], dev), host_to(fx[:, 1], dev))
    t = host_to((fx[:, 2] >> 32).astype(np.int32), dev)
    s = host_to((fx[:, 2] & 0xFFFFFFFF).astype(np.uint32).view(np.int32), dev)
    return ids.Bid(nxt.t.index_put(idx, t), nxt.s.index_put(idx, s))


class HostIO:
    """Inbox/outbox packing methods of RaftEngine (see module docstring)."""

    def _build_inbox(self) -> tuple[
            np.ndarray, dict[int, list], list[rpc.WireMsg], list[rpc.MsgBatch]]:
        """Pack queued batches + stray wire messages into the persistent
        (10, P, N_src) input buffer: rows 0-8 are message fields, row 9 is
        the proposal-count lane written by tick_begin after this returns.
        One message per (group, src) slot per tick. Returns (input buffer,
        staged blocks, deferred msgs, deferred batches); the buffer reaches
        the device in ONE copy."""
        in10 = self._in10
        in10.fill(0)
        staged: dict[int, list] = {}
        deferred: list[rpc.WireMsg] = []
        deferred_b: list[rpc.MsgBatch] = []
        # Routed occupancy: slots already claimed by the device-resident
        # routing plane this tick (raft/route.py). A colliding host claim
        # defers exactly like a host-built slot conflict — the routed row
        # merges under the residual inbox on the device, and no later host
        # writer overwrites it.
        occ = self._routed_kinds
        # Columnar batches first (the product hot path): nine vectorized
        # scatters per peer frame; slot conflicts split the batch and carry
        # the remainder to the next tick.
        for b in self._pending_batches:
            g, src = b.group, b.src
            free = in10[0, g, src] == 0
            if occ is not None:
                free &= occ[g, src] == 0
            if not free.all():
                deferred_b.append(b.take(~free))
                b = b.take(free)
                g = b.group
                if not len(b):
                    continue
            in10[0, g, src] = b.kind_col
            in10[1, g, src] = b.term
            in10[2, g, src] = b.x >> 32
            in10[3, g, src] = b.x & 0xFFFFFFFF
            in10[4, g, src] = b.y >> 32
            in10[5, g, src] = b.y & 0xFFFFFFFF
            in10[6, g, src] = b.z >> 32
            in10[7, g, src] = b.z & 0xFFFFFFFF
            in10[8, g, src] = b.ok
            for grp, blks in b.blocks.items():
                staged.setdefault(grp, []).extend(blks)
        msgs = self._pending_msgs
        if not msgs:
            return in10, staged, deferred, deferred_b
        # First message per (group, src) slot wins; extras carry over. The
        # slot scan runs on a Python set, the field writes as nine
        # vectorized scatters.
        keep: list[rpc.WireMsg] = []
        seen: set[tuple[int, int]] = set()
        for m in msgs:
            key = (m.group, m.src)
            if (key in seen or in10[0, m.group, m.src] != rpc.MSG_NONE
                    or (occ is not None and occ[m.group, m.src])):
                deferred.append(m)
                continue
            seen.add(key)
            keep.append(m)
            if m.kind == rpc.MSG_APPEND and m.blocks:
                staged.setdefault(m.group, []).extend(m.blocks)
        k = len(keep)
        gi = np.fromiter((m.group for m in keep), np.intp, k)
        si = np.fromiter((m.src for m in keep), np.intp, k)
        x = np.fromiter((m.x for m in keep), np.int64, k)
        y = np.fromiter((m.y for m in keep), np.int64, k)
        z = np.fromiter((m.z for m in keep), np.int64, k)
        in10[0, gi, si] = np.fromiter((m.kind for m in keep), np.int32, k)
        in10[1, gi, si] = np.fromiter((m.term for m in keep), np.int32, k)
        in10[2, gi, si] = x >> 32
        in10[3, gi, si] = x & 0xFFFFFFFF
        in10[4, gi, si] = y >> 32
        in10[5, gi, si] = y & 0xFFFFFFFF
        in10[6, gi, si] = z >> 32
        in10[7, gi, si] = z & 0xFFFFFFFF
        in10[8, gi, si] = np.fromiter((m.ok for m in keep), np.int32, k)
        return in10, staged, deferred, deferred_b

    def _build_inbox_sparse(self) -> tuple[
            np.ndarray, np.ndarray, dict[int, list],
            list[rpc.WireMsg], list[rpc.MsgBatch]]:
        """Compact twin of :meth:`_build_inbox`: instead of filling a dense
        (10, P, N) buffer, collect the touched groups (messages, batches,
        proposal queues) into a sorted id vector and pack their rows into a
        (10, K, N) bucket (K = the smallest power-of-8 step from 256 that
        fits). Padding rows carry group id P — the device scatter sends them
        to its dump row. Slot-conflict carry-over semantics are identical
        to :meth:`_build_inbox`."""
        parts = []
        if self._pending_batches:
            parts.extend(b.group.astype(np.int64)
                         for b in self._pending_batches)
        if self._pending_msgs:
            parts.append(np.fromiter((m.group for m in self._pending_msgs),
                                     np.int64, len(self._pending_msgs)))
        prop_groups = list(self._prop_groups)
        if prop_groups:
            parts.append(np.asarray(prop_groups, np.int64))
        G = (np.unique(np.concatenate(parts)) if parts
             else np.empty(0, np.int64))
        K = 256
        while K < len(G):
            K *= 8
        K = min(K, self.P) if self.P >= 256 else self.P
        if K < len(G):  # P < 256 and all groups touched
            K = len(G)
        idx = np.full(K, self.P, np.int32)
        idx[:len(G)] = G
        vals, staged, deferred, deferred_b = self._pack_inbox_rows(G, K)
        return idx, vals, staged, deferred, deferred_b

    def _build_inbox_active(self, G: np.ndarray, K: int) -> tuple[
            np.ndarray, dict[int, list],
            list[rpc.WireMsg], list[rpc.MsgBatch]]:
        """Active-set twin of :meth:`_build_inbox_sparse`: the compact
        domain is the scheduler's active set ``G`` (sorted global ids,
        guaranteed a superset of every pending message/batch/proposal
        group) padded to bucket ``K``, so the packed rows line up with the
        gathered state rows."""
        return self._pack_inbox_rows(G, K)

    def _pack_inbox_rows(self, G: np.ndarray, K: int) -> tuple[
            np.ndarray, dict[int, list],
            list[rpc.WireMsg], list[rpc.MsgBatch]]:
        """Shared compact inbox-packing core (sparse + active-set inboxes):
        pack queued batches/messages into a (10, K, N) bucket at rows
        ``searchsorted(G, group)`` (every pending group must be in ``G``),
        update the per-(group, src) delivery stamps, and scatter proposal
        counts into row 9. Slot-conflict carry-over semantics are identical
        to :meth:`_build_inbox`."""
        vals = np.zeros((10, K, self.N), np.int32)
        staged: dict[int, list] = {}
        deferred: list[rpc.WireMsg] = []
        deferred_b: list[rpc.MsgBatch] = []
        # Routed occupancy: same deferral rule as the dense builder, keyed
        # by GLOBAL group ids.
        occ = self._routed_kinds
        for b in self._pending_batches:
            rows = np.searchsorted(G, b.group)
            free = vals[0, rows, b.src] == 0
            if occ is not None:
                free &= occ[b.group, b.src] == 0
            if not free.all():
                deferred_b.append(b.take(~free))
                b = b.take(free)
                if not len(b):
                    continue
                rows = np.searchsorted(G, b.group)
            vals[0, rows, b.src] = b.kind_col
            vals[1, rows, b.src] = b.term
            vals[2, rows, b.src] = b.x >> 32
            vals[3, rows, b.src] = b.x & 0xFFFFFFFF
            vals[4, rows, b.src] = b.y >> 32
            vals[5, rows, b.src] = b.y & 0xFFFFFFFF
            vals[6, rows, b.src] = b.z >> 32
            vals[7, rows, b.src] = b.z & 0xFFFFFFFF
            vals[8, rows, b.src] = b.ok
            for grp, blks in b.blocks.items():
                staged.setdefault(grp, []).extend(blks)
        msgs = self._pending_msgs
        if msgs:
            keep: list[rpc.WireMsg] = []
            seen: set[tuple[int, int]] = set()
            rows_kept: list[int] = []
            for m in msgs:
                row = int(np.searchsorted(G, m.group))
                key = (m.group, m.src)
                if (key in seen or vals[0, row, m.src] != rpc.MSG_NONE
                        or (occ is not None and occ[m.group, m.src])):
                    deferred.append(m)
                    continue
                seen.add(key)
                keep.append(m)
                rows_kept.append(row)
                if m.kind == rpc.MSG_APPEND and m.blocks:
                    staged.setdefault(m.group, []).extend(m.blocks)
            if keep:
                k = len(keep)
                gi = np.asarray(rows_kept, np.intp)
                si = np.fromiter((m.src for m in keep), np.intp, k)
                x = np.fromiter((m.x for m in keep), np.int64, k)
                y = np.fromiter((m.y for m in keep), np.int64, k)
                z = np.fromiter((m.z for m in keep), np.int64, k)
                vals[0, gi, si] = np.fromiter((m.kind for m in keep), np.int32, k)
                vals[1, gi, si] = np.fromiter((m.term for m in keep), np.int32, k)
                vals[2, gi, si] = x >> 32
                vals[3, gi, si] = x & 0xFFFFFFFF
                vals[4, gi, si] = y >> 32
                vals[5, gi, si] = y & 0xFFFFFFFF
                vals[6, gi, si] = z >> 32
                vals[7, gi, si] = z & 0xFFFFFFFF
                vals[8, gi, si] = np.fromiter((m.ok for m in keep), np.int32, k)
        # Per-(group, src) delivery stamp (ISR liveness), sparse form of the
        # dense path's full-array mask. Packed rows always index the real
        # prefix of the bucket, so G (not the padded idx) maps them back.
        gi_loc, si_loc = np.nonzero(vals[0])
        if len(gi_loc):
            self._h_last_seen[G[gi_loc], si_loc] = self._ticks
            if self._flight_wire:
                # Wire trace (raft.flight_wire): inbox consumption — the
                # same occupancy pass that stamped the liveness mirror.
                self.flight.emit_many(
                    self._wire_tick, "msg_delivered", G[gi_loc],
                    vals[1][gi_loc, si_loc], vals[0][gi_loc, si_loc],
                    si_loc, self.me, "host")
        prop_groups = list(self._prop_groups)
        if prop_groups:
            pg = np.asarray(prop_groups, np.int64)
            self._scatter_proposal_counts(
                vals[9], np.searchsorted(G, pg), prop_groups)
        return vals, staged, deferred, deferred_b

    def _scatter_proposal_counts(self, plane, rows, groups) -> None:
        """Row-9 proposal-depth lane: one scatter over the pending groups'
        target rows (identity for the dense inbox, the searchsorted
        compaction index for the sparse and active ones)."""
        plane[rows, 0] = np.fromiter(
            (len(self._proposals[g]) for g in groups), np.int32, len(groups))

    def _decode_outbox(self, ov, groups, skip: set[int] | None = None,
                       routed: np.ndarray | None = None) -> list:
        """Decode the packed outbox into ONE columnar MsgBatch per peer (plus
        any InstallSnapshot WireMsgs). The batch IS the wire form: per-tick
        consensus traffic to a peer is a single binary frame end to end.

        ``ov`` is COMPACT: (9, R, N) covering only the processed rows, with
        ``groups`` (R,) mapping each row to its group id.

        One ``np.nonzero`` over the whole outbox, per-entry 64-bit id
        combines on the selected entries only, AE payload spans grouped per
        chain and served by one :meth:`Chain.range_many` bulk read per
        group, and send-pointer fixups recorded for the next tick_begin's
        single scatter (``_drain_nxt_fixups``) instead of a device write
        here, which would race the in-flight dispatch under
        ``tick_pipelined``.

        ``routed`` is the device-routing mask (same (R, N) shape as the
        outbox cells): rows the RouteFabric already delivered on the device
        this tick. They are masked out BEFORE the nonzero pass, so routed
        traffic is never re-materialized host-side — the residual this
        decoder emits is exactly the payload-bearing / off-fabric share."""
        kind = ov[0]
        copied = False
        if skip:
            smask = np.isin(np.asarray(groups),
                            np.fromiter(skip, np.int64, len(skip)))
            if smask.any():
                # Mid-tick-recycled rows: their outbox was computed by the
                # dead incarnation but would be stamped with the new one.
                kind, copied = kind.copy(), True
                kind[smask] = 0
        if routed is not None and routed.any():
            if not copied:
                kind = kind.copy()
            kind[routed] = 0
        ri, di = np.nonzero(kind)
        if not len(ri):
            return []
        i64 = np.int64
        # Columnar gather: every field once, entries only.
        k_all = kind[ri, di].astype(np.int32)
        t_all = ov[1][ri, di].astype(i64)
        ok_all = ov[8][ri, di].astype(np.int32)
        x_all = (ov[2][ri, di].astype(i64) << 32) | ov[3][ri, di].astype(i64)
        y_all = (ov[4][ri, di].astype(i64) << 32) | ov[5][ri, di].astype(i64)
        z_all = (ov[6][ri, di].astype(i64) << 32) | ov[7][ri, di].astype(i64)
        g_all = np.asarray(groups)[ri].astype(np.intp)
        inc_all = self._h_ginc[g_all]
        if self._flight_wire:
            # Wire trace (raft.flight_wire): every decoded entry is a
            # msg_sent on the host path (routed rows were masked out above,
            # so the journal's routed/host split is the delivery split).
            self.flight.emit_many(self._flight_tick(), "msg_sent",
                                  g_all, t_all, k_all, self.me, di, "host")

        # AE entries with a non-empty span need chain payloads attached.
        # Group them per chain so each group's spans come from ONE bulk
        # read; snapshot-floor probes and span errors keep per-entry
        # semantics.
        blocks_by_dst: dict[int, dict[int, list]] = {}
        snaps_by_dst: dict[int, list] = {}
        ae = np.nonzero((k_all == rpc.MSG_APPEND) & (y_all != x_all))[0]
        if len(ae):
            cap = self.max_append_entries
            # Payload-ring re-stage: blocks a capped catch-up frame just
            # read from the chain are worth ring residency — the SAME span
            # is re-sent next tick under tick_pipelined (the fixup lands one
            # dispatch late), and the follow-on catch-up frames walk the
            # suffix right above it; resident, those route on the device.
            # Deferred one tick via _ring_stage_decode: staging here would
            # fall between this tick's route and its flush barrier, where a
            # scatter could tear a slot the barrier's gather is about to
            # read.
            ring = (self._fabric.rings.get(self.me)
                    if self._fabric is not None else None)
            order = ae[np.argsort(g_all[ae], kind="stable")]
            edges = np.nonzero(np.diff(g_all[order]))[0] + 1
            for run in np.split(order, edges):
                grp = int(g_all[run[0]])
                ch = self.chains[grp]
                floor = ch.floor
                pend: list[int] = []   # entries whose span we will read
                for i in run.tolist():
                    mx = int(x_all[i])
                    if mx < floor:
                        # Span bottom below our truncation floor: log replay
                        # cannot reach this follower. Ship the snapshot
                        # (throttled) plus a heartbeat probe, which keeps the
                        # reject/re-root loop alive until the install lands.
                        snap = self._snapshot_msg(grp, int(di[i]), int(t_all[i]))
                        if snap is not None:
                            snaps_by_dst.setdefault(int(di[i]), []).append(snap)
                        y_all[i] = mx
                        z_all[i] = min(int(z_all[i]), mx)
                    else:
                        pend.append(i)
                if not pend:
                    continue
                try:
                    many = ch.range_many(
                        [(int(x_all[i]), int(y_all[i])) for i in pend])
                except Exception:
                    # A span this tick cannot materialize (e.g. probe
                    # pointer on a branch we no longer hold): fall back to
                    # per-span reads so ONLY the broken span degrades to a
                    # heartbeat probe.
                    many = []
                    for i in pend:
                        mx, my = int(x_all[i]), int(y_all[i])
                        try:
                            many.append(ch.range(mx, my))
                        except Exception:
                            log.warning(
                                "span (%#x, %#x] unavailable g=%d; "
                                "heartbeat only", mx, my, grp)
                            y_all[i] = mx
                            z_all[i] = min(int(z_all[i]), mx)
                            many.append(None)
                for i, blks in zip(pend, many):
                    if blks is None:
                        continue
                    # Flow control: cap the frame at max_append_entries
                    # blocks. The device's optimistic send pointer is
                    # re-rooted at the capped top so the NEXT tick continues
                    # from there.
                    if cap is not None and len(blks) > cap:
                        blks = blks[:cap]
                        top = blks[-1].id
                        y_all[i] = top
                        z_all[i] = min(int(z_all[i]), top)
                        self._nxt_fixups.append((grp, int(di[i]), top))
                        if ring is not None and len(blks) <= ring.S:
                            # Fits the per-group ring: next tick's re-send
                            # of this exact span routes on the device
                            # (stage() dedups already-resident ids).
                            self._ring_stage_decode.extend(
                                (grp, b) for b in blks)
                    blocks_by_dst.setdefault(int(di[i]), {})[grp] = blks

        out: list = []
        for dst in range(self.N):
            sel = np.nonzero(di == dst)[0]
            if not len(sel):
                continue
            out.extend(snaps_by_dst.get(dst, ()))
            out.append(rpc.MsgBatch(
                self.me, dst, g_all[sel], k_all[sel], t_all[sel], x_all[sel],
                y_all[sel], z_all[sel], ok_all[sel],
                blocks=blocks_by_dst.get(dst) or {}, inc=inc_all[sel]))
        return out

    def _decode_outbox_reference(self, ov, groups,
                                 skip: set[int] | None = None,
                                 routed: np.ndarray | None = None) -> list:
        """Retained scalar reference for :meth:`_decode_outbox` — the per-dst
        loop with per-entry ``ch.range()`` reads, as in the JAX package. The
        differential test (tests/test_torch_decode_differential.py) pins the
        columnar path
        byte-identical to this across dense/sparse modes, snapshot-floor
        spans, max_append_entries capping, mid-tick-recycled skip rows, and
        device-routed cell masks. Never called on the product hot path."""
        kind = ov[0]
        copied = False
        if skip:
            rows = [i for i, g in enumerate(groups) if int(g) in skip]
            if rows:
                kind, copied = kind.copy(), True
                kind[rows] = 0
        if routed is not None and routed.any():
            if not copied:
                kind = kind.copy()
            kind[routed] = 0
        if not kind.any():
            return []
        ri, di = np.nonzero(kind)
        i64 = np.int64
        xcol = (ov[2].astype(i64) << 32) | ov[3].astype(i64)
        ycol = (ov[4].astype(i64) << 32) | ov[5].astype(i64)
        zcol = (ov[6].astype(i64) << 32) | ov[7].astype(i64)
        out: list = []
        for dst in range(self.N):
            sel = di == dst
            if not sel.any():
                continue
            r = ri[sel].astype(np.intp)
            g = groups[r].astype(np.intp)
            kcol = kind[r, dst].astype(np.int32)
            tcol = ov[1][r, dst].astype(i64)
            okcol = ov[8][r, dst].astype(np.int32)
            bx = xcol[r, dst]
            by = ycol[r, dst]
            bz = zcol[r, dst]
            batch = rpc.MsgBatch(self.me, dst, g, kcol, tcol, bx, by, bz,
                                 okcol, inc=self._h_ginc[g])
            ae = np.nonzero((kcol == rpc.MSG_APPEND) & (by != bx))[0]
            for i in ae.tolist():
                grp = int(g[i])
                ch = self.chains[grp]
                mx, my, mz = int(bx[i]), int(by[i]), int(bz[i])
                if mx < ch.floor:
                    snap = self._snapshot_msg(grp, dst, int(tcol[i]))
                    if snap is not None:
                        out.append(snap)
                    by[i] = mx
                    bz[i] = min(mz, mx)
                    continue
                try:
                    blks = ch.range(mx, my)
                except Exception:
                    log.warning("span (%#x, %#x] unavailable g=%d; heartbeat only",
                                mx, my, grp)
                    by[i] = mx
                    bz[i] = min(mz, mx)
                else:
                    cap = self.max_append_entries
                    if cap is not None and len(blks) > cap:
                        blks = blks[:cap]
                        top = blks[-1].id
                        by[i] = top
                        bz[i] = min(mz, top)
                        self._nxt_fixups.append((grp, dst, top))
                    batch.blocks[grp] = blks
            out.append(batch)
        return out

    def _drain_nxt_fixups(self) -> None:
        """Apply the outbox decoder's recorded send-pointer re-roots as ONE
        scatter, just before the next dispatch reads ``state.nxt``. The
        scatter builds new leaves (``index_put``, not ``index_put_``) from
        indices uploaded without a host sync: the old leaves may still be
        read by an in-flight pipelined finish, and a device read of
        ``state.nxt`` here would wait for the in-flight step.

        Where one (group, dst) was re-rooted twice, the later fixup wins,
        as in the reference's sequential numpy assignment (a device scatter
        with repeated indices picks an arbitrary one)."""
        last: dict[tuple[int, int], int] = {}
        for g, dst, top in self._nxt_fixups:
            last[(g, dst)] = top
        self._nxt_fixups.clear()
        fx = np.asarray([(g, d, top) for (g, d), top in last.items()],
                        np.int64).reshape(-1, 3)
        # The re-rooted rows now have nxt < head — the leader must keep
        # streaming the capped catch-up, so the active-set scheduler may
        # not leave them quiescent this tick. (Dense engines never drain
        # _force_active; don't let it grow there.)
        if self._active_set:
            self._force_active.update(int(g) for g in fx[:, 0])
        nxt = self.state.nxt
        if getattr(self, "_mesh", None) is None:
            self.state = self.state.replace(nxt=_put_fixups(nxt, fx, self._device))
            return
        # Mesh engine: each shard takes its own rows' fixups, with local
        # ids, on its device; the other shards keep their blocks.
        L = self._shard_rows
        shard = fx[:, 0] // L
        tp, sp = list(nxt.t.parts), list(nxt.s.parts)
        for s in np.unique(shard).tolist():
            f = fx[shard == s].copy()
            f[:, 0] -= s * L
            b = _put_fixups(ids.Bid(tp[s], sp[s]), f, tp[s].device)
            tp[s], sp[s] = b.t, b.s
        self.state = self.state.replace(nxt=ids.Bid(Shards(tp), Shards(sp)))
