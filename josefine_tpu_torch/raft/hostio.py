"""Host-side wire<->device packing for RaftEngine: inbox build, outbox decode.

Mixin half of :class:`josefine_tpu_torch.raft.engine.RaftEngine` (state is
initialized there). The inbox builder packs queued wire messages/columnar
batches into the device step's packed (10, P, N) input contract; the outbox
decoder turns the fetched packed outbox back into columnar per-peer
MsgBatches, attaching chain payload spans to AppendEntries (with
max_append_entries flow control) and snapshot messages where the span bottom
fell below the truncation floor.

The port of the JAX package's ``raft/hostio.py``, dense IO only (its sparse
and active-set builders and the device-routing masks are not ported yet).
The host code is the same; the one device write, the send-pointer fixup
scatter, builds new tensors instead of writing the live state.

Per-peer bounded send queue with carry-over: one message per (group, src)
slot per tick; extras carry over to the next tick instead of being dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from josefine_tpu_torch.ops import ids
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
        # Columnar batches first (the product hot path): nine vectorized
        # scatters per peer frame; slot conflicts split the batch and carry
        # the remainder to the next tick.
        for b in self._pending_batches:
            g, src = b.group, b.src
            free = in10[0, g, src] == 0
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
            if key in seen or in10[0, m.group, m.src] != rpc.MSG_NONE:
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

    def _scatter_proposal_counts(self, plane, rows, groups) -> None:
        """Row-9 proposal-depth lane: one scatter over the pending groups'
        target rows."""
        plane[rows, 0] = np.fromiter(
            (len(self._proposals[g]) for g in groups), np.int32, len(groups))

    def _decode_outbox(self, ov, groups, skip: set[int] | None = None) -> list:
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
        ``tick_pipelined``."""
        kind = ov[0]
        if skip:
            smask = np.isin(np.asarray(groups),
                            np.fromiter(skip, np.int64, len(skip)))
            if smask.any():
                # Mid-tick-recycled rows: their outbox was computed by the
                # dead incarnation but would be stamped with the new one.
                kind = kind.copy()
                kind[smask] = 0
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
            # msg_sent on the host path.
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
        dev = self._device
        idx = (host_to(fx[:, 0], dev), host_to(fx[:, 1], dev))
        t = host_to((fx[:, 2] >> 32).astype(np.int32), dev)
        s = host_to((fx[:, 2] & 0xFFFFFFFF).astype(np.uint32).view(np.int32), dev)
        nxt = self.state.nxt
        self.state = self.state.replace(
            nxt=ids.Bid(nxt.t.index_put(idx, t), nxt.s.index_put(idx, s)))
