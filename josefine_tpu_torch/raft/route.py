"""Device-resident message delivery between co-located engines.

Co-located engines (the in-process cluster: one device, one RaftEngine per
node slot — the bench cluster, the twin test rigs) exchange almost all of
their steady-state consensus traffic as payload-free packed rows: votes,
pre-votes, heartbeats (AppendEntries with an empty span), and append/vote
responses. Without the fabric the host decodes every one of them out of the
sender's outbox into a columnar MsgBatch and encodes it back into the
receiver's inbox each tick.

:class:`RouteFabric` closes that loop on the device. Per sender tick:

* the sender's ``tick_finish`` computes a **routed mask** over its fetched
  compact outbox — host-cheap columnar numpy over data it fetched anyway —
  using the delivery decision table: kind payload-free × peer on-fabric ×
  link clean × receiver not carrying deferred inbox claims × row
  incarnation match × not parole-dropped × not mid-tick-recycled;
* the routed rows are scattered **on the device** from the step's own
  output into the receiver's staged ``(9, P, N)`` inbox plane
  (:func:`packed_step._route_scatter` — the outbox's nine packed rows ARE
  the inbox's rows 0-8, so no transform is needed, only placement); only
  the row indices cross from the host;
* the mask is handed to ``_decode_outbox`` so routed rows are never
  re-materialized host-side — the host decodes only the residual: snapshot
  transfers, off-fabric peers, faulted links, and (ring off or span not
  resident) payload-bearing AppendEntries. With the payload ring on
  (raft/payload_ring.py), an AE whose span is resident in the sender's
  bounded device payload ring routes like a heartbeat: the packed row
  scatters on the device and the payload words cross at the flush barrier
  in one gather — no chain read, no encode/decode;
* the driver calls :meth:`flush` at its delivery barrier (wherever it hands
  host-path messages to ``receive()``), promoting staged planes to
  consumable ones — so routed and host-path delivery become visible at the
  SAME ``tick_begin``, which is what makes routing equal to host decoding;
* the receiver's next ``tick_begin`` consumes its ready plane: the routed
  rows join the wake predicate, the host builders treat routed-occupied
  slots as claimed (colliding claims defer, exactly like a host-built slot
  conflict), and the plane merges under the residual inbox inside the
  window step — never leaving the device.

Slot-conflict identity: a routed slot may only collide with a host claim
that was *deferred* from an earlier tick (same (group, src) key —
impossible within one clean tick, since a sender's outbox holds one row per
(group, dst)). The fabric therefore refuses to route toward a receiver whose
last ``tick_begin`` deferred anything (``engine._route_dirty``) — that
tick's traffic rides the host path, where the ordinary carry-over rules
apply.

In-place writes: a staged plane is allocated by the first push of a round
and written in place by the later ones; at the barrier it becomes the ready
plane, which ``consume`` hands to exactly one dispatch and forgets. So a
plane is written only before any dispatch has read it, and the stream
orders every write before the read.

The fabric is host-driver infrastructure, not wire transport: engines
reached over TCP are simply never registered and keep the host path.

Sharded engines (``RaftEngine(mesh=...)``) all share ONE 'p' mesh, and the
fabric's planes and rings co-shard with their state: a plane is a
:class:`~josefine_tpu_torch.parallel.sharded.Shards` of (9, L, N) blocks
along the group axis, and a routed row goes into the shard that owns its
group (a routed row's source group and destination plane row are one group
id, so nothing crosses shards). Mesh pushes always take the host-vals form:
the engine's tick_finish fetched the compact outbox anyway, and a 36-byte
row beats reading another shard's device output.

The port of the JAX package's ``raft/route.py``. Planes and rings live on
the engines' device (on each shard's, on a mesh); for the python backend
they are numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from josefine_tpu_torch.parallel.sharded import (
    Shards,
    make_sharded_route_scatter,
    mesh_shards,
    purge_plane_row_masked,
    split_shard_rows,
)
from josefine_tpu_torch.raft import rpc
from josefine_tpu_torch.raft.group_admin import _PAROLE_DROP_ARR
from josefine_tpu_torch.raft.hostio import host_to
from josefine_tpu_torch.raft.packed_step import (
    _MIRROR13_ROWS,
    _merge_planes_fn,
    _purge_plane_row_fn,
    _route_scatter,
    _route_scatter_vals,
)
from josefine_tpu_torch.raft.payload_ring import PayloadRing
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("raft.route")

_m_ring_spills = REGISTRY.counter(
    "raft_route_ring_spills_total",
    "Payload AEs that could not route from the device payload ring "
    "(span not resident) and fell back to the host encode/decode path")

# Kinds routable without host involvement: always payload-free on the wire.
# MSG_APPEND joins conditionally: x == y (a pure heartbeat/commit probe)
# always routes; x != y routes when the payload ring is on and the span is
# ring-resident; otherwise the AE needs chain payload attached host-side
# and rides the residual path.
_ROUTED_ALWAYS = np.asarray(sorted((
    rpc.MSG_VOTE_REQ, rpc.MSG_VOTE_RESP,
    rpc.MSG_PREVOTE_REQ, rpc.MSG_PREVOTE_RESP,
    rpc.MSG_APPEND_RESP,
)), np.int32)


def _unique(gs: np.ndarray) -> None:
    """A scatter's destination rows must be unique: on the card a scatter
    with repeated indices has no defined winner."""
    if len(np.unique(gs)) != len(gs):
        raise RuntimeError(f"routed scatter with repeated group rows: {gs}")


class RouteFabric:
    """Shared device-resident delivery plane for co-located engines
    (see module docstring). One instance per in-process cluster; engines
    join via :meth:`register`, drivers call :meth:`flush` at their
    delivery barrier."""

    def __init__(self, link_filter=None, payload_ring: bool = False,
                 ring_slots: int = 8, ring_bytes: int = 512):
        # slot -> engine. A slot may be re-registered (restart churn):
        # the dead engine's staged/ready traffic dies with it, like the
        # pending queues inside the dead process.
        self.engines: dict[int, object] = {}
        # Device-resident payload ring (raft/payload_ring.py): when on,
        # each registered slot owns a bounded (P, ring_slots, ring_bytes)
        # payload buffer, and MSG_APPEND with a real span routes on the
        # device whenever the span is ring-resident (host spill otherwise).
        # Off by default — the buffers cost P * slots * bytes per engine.
        self.payload_ring = bool(payload_ring)
        self.ring_slots = int(ring_slots)
        self.ring_bytes = int(ring_bytes)
        self.rings: dict[int, PayloadRing] = {}
        # Routed payload handoff between a sender's route (tick_finish)
        # and the receivers' adoption: _staged_blocks accumulates the
        # routed spans' ring entries per receiver until the flush barrier,
        # where ONE device gather per sender materializes them as Blocks
        # into _ready_blocks; consume() hands them to the receiver's next
        # dispatch as pre-staged blocks.
        self._staged_blocks: dict[int, dict[int, dict[int, tuple]]] = {}
        self._ready_blocks: dict[int, dict[int, dict[int, object]]] = {}
        self.ring_routed = 0  # payload AEs delivered from the ring
        self.ring_capped = 0  # of those, capped catch-up prefixes
        # Optional (src_slot, dst_slot) -> bool gate: partitions and faulted
        # links force traffic back through the host residual path (where
        # the driver applies its fates); None = all registered links clean.
        self.link_filter = link_filter
        self.P: int | None = None
        self.N: int | None = None
        self.backend: str | None = None
        self.device: torch.device | None = None
        self.mesh = None
        # Per-receiver staged (accumulating this round) and ready
        # (consumable at the next tick_begin) planes, plus the host-side
        # kind mirrors that back occupancy checks, wake scheduling,
        # last-seen stamps, and selective purges without a device read.
        self._staging: dict[int, object] = {}
        self._staging_kinds: dict[int, np.ndarray] = {}
        self._staging_srcs: dict[int, dict[int, int]] = {}
        self._ready: dict[int, object] = {}
        self._ready_kinds: dict[int, np.ndarray] = {}
        # Host (P, N) TERM mirrors beside the kind mirrors, maintained only
        # while wire tracing is live (any registered engine has flight_wire
        # on — see _refresh_trace): the receiver's msg_delivered events
        # need the routed rows' terms without a device read.
        self._staging_terms: dict[int, np.ndarray] = {}
        self._ready_terms: dict[int, np.ndarray] = {}
        self.trace = False
        self.routed_total = 0

    # ------------------------------------------------------------- lifecycle

    def register(self, engine) -> None:
        """Join an engine to the fabric (idempotent per slot; re-register
        on restart — staged traffic for the dead incarnation is dropped,
        matching the loss of its in-process pending queues). Every engine
        must share the fabric's P, N, backend and device. Sharded engines
        are welcome: they must all share ONE 'p' mesh, and the fabric's
        planes and rings co-shard with their state."""
        if engine._mesh is not None and "p" not in engine._mesh.shape:
            # Validate BEFORE adopting any engine attribute: a rejected
            # first registration must not poison the fabric's shape/mesh
            # for a later valid one.
            raise ValueError("RouteFabric on a sharded engine needs a 'p' mesh axis")
        if self.P is None:
            self.P, self.N = engine.P, engine.N
            self.backend = engine._backend
            self.device = engine._device
            self.mesh = engine._mesh
        elif engine._mesh is not self.mesh and engine._mesh != self.mesh:
            raise ValueError(
                "fabric mesh mismatch: every registered engine must share the "
                "fabric's mesh (mixing sharded and unsharded engines would "
                "scatter across incompatible plane layouts)")
        if (engine.P, engine.N, engine._backend, engine._device) != (
                self.P, self.N, self.backend, self.device):
            raise ValueError(
                f"fabric shape mismatch: engine (P={engine.P}, N={engine.N}, "
                f"backend={engine._backend!r}, device={engine._device}) vs "
                f"fabric (P={self.P}, N={self.N}, backend={self.backend!r}, "
                f"device={self.device})")
        slot = engine.me
        self.engines[slot] = engine
        engine._fabric = self
        for store in (self._staging, self._staging_kinds, self._staging_srcs,
                      self._ready, self._ready_kinds, self._staging_terms,
                      self._ready_terms, self._staged_blocks,
                      self._ready_blocks):
            store.pop(slot, None)
        if self.payload_ring:
            # Fresh ring per registration: a restarted engine's resident
            # payloads died with the process (same rule as the planes).
            self.rings[slot] = PayloadRing(
                self.P, slots=self.ring_slots, slot_bytes=self.ring_bytes,
                backend=self.backend, device=self.device, mesh=self.mesh)
        self._refresh_trace()

    def _refresh_trace(self) -> None:
        self.trace = any(getattr(e, "_flight_wire", False)
                         for e in self.engines.values())

    def unregister(self, slot: int) -> None:
        """Remove a slot (membership removal / process stop): its pending
        routed traffic is dropped and peers stop routing toward it."""
        e = self.engines.pop(slot, None)
        if e is not None and getattr(e, "_fabric", None) is self:
            e._fabric = None
        for store in (self._staging, self._staging_kinds, self._staging_srcs,
                      self._ready, self._ready_kinds,
                      self._staging_terms, self._ready_terms,
                      self._staged_blocks, self._ready_blocks, self.rings):
            store.pop(slot, None)
        self._refresh_trace()

    def link_ok(self, src: int, dst: int) -> bool:
        return self.link_filter is None or bool(self.link_filter(src, dst))

    # ------------------------------------------------------------ sender side

    def route_from(self, engine, proc, ov, h, skip=None):
        """Compute the sender's routed mask for this tick's compact outbox
        and scatter the routed rows into each receiver's staged plane.
        Returns the (R, N) bool mask (None when nothing routed) — the
        caller hands it to ``_decode_outbox`` so routed rows skip the host
        decode entirely.

        With the payload ring on, MSG_APPEND with a real span (x != y)
        joins the decision table: the span is resolved against the
        sender's ring metadata (parent-linked walk, incarnation match,
        above the truncation floor), and a resident span routes exactly
        like a heartbeat. A span longer than ``max_append_entries`` routes
        its capped prefix with the same y/z rewrite + nxt re-root the host
        decode applies; a span the ring cannot serve spills to the host
        path (counted, and journaled as ``ring_spill`` when the engine's
        flight_ring_spill is on)."""
        me = engine.me
        dsts = [d for d, peer in self.engines.items()
                if d != me and not peer._route_dirty and self.link_ok(me, d)]
        if not dsts or not len(proc):
            return None
        kind = ov[0]
        gids = np.asarray(proc, np.int64)
        base = np.isin(kind, _ROUTED_ALWAYS)
        is_ae = kind == rpc.MSG_APPEND
        ring = self.rings.get(me)
        ae_span = None
        x = y = None
        i64 = np.int64
        if is_ae.any():
            x = (ov[2].astype(i64) << 32) | ov[3].astype(i64)
            y = (ov[4].astype(i64) << 32) | ov[5].astype(i64)
            base |= is_ae & (x == y)  # payload-free heartbeat/commit probe
            if ring is not None:
                ae_span = is_ae & (x != y)  # ring candidates, per cell
        if skip:
            smask = np.isin(gids, np.fromiter(skip, np.int64, len(skip)))
            if smask.any():
                base = base & ~smask[:, None]
                if ae_span is not None:
                    ae_span = ae_span & ~smask[:, None]
        if not base.any() and (ae_span is None or not ae_span.any()):
            return None
        routed = np.zeros_like(base)
        my_inc = engine._h_ginc[gids]
        src_ov = None
        cap = engine.max_append_entries
        # Span resolutions memoized per (group, x, y): the same claim
        # toward several followers walks the ring once.
        memo: dict[tuple[int, int, int], object] = {}
        for d in dsts:
            peer = self.engines[d]
            # Receiver-side intake rules, applied at route time so a
            # routed row lands iff the host path would have accepted it:
            # incarnation match (stale frames for a recycled row), and the
            # vote-parole drop (an abstaining group refuses election
            # traffic). Rows failing either fall back to the host path,
            # where the receiver's intake applies the same rule.
            inc_ok = my_inc == peer._h_ginc[gids]
            col = base[:, d] & inc_ok
            if peer._parole:
                par = np.fromiter(peer._parole, np.int64, len(peer._parole))
                col &= ~(np.isin(kind[:, d], _PAROLE_DROP_ARR)
                         & np.isin(gids, par))
            capped: list[tuple[int, int]] = []  # (row, capped top id)
            if ae_span is not None:
                blkmap_d = None
                for r in np.nonzero(ae_span[:, d] & inc_ok)[0].tolist():
                    g = int(gids[r])
                    key = (g, int(x[r, d]), int(y[r, d]))
                    if key in memo:
                        res = memo[key]
                    else:
                        res = (ring.resolve(g, int(my_inc[r]), key[1],
                                            key[2], cap)
                               if key[1] >= engine.chains[g].floor else None)
                        memo[key] = res
                    if res is None:
                        # Not ring-servable: the row rides the host path
                        # (chain read + encode).
                        ring.spills += 1
                        _m_ring_spills.inc(node=engine.self_id)
                        if engine._flight_ring_spill:
                            engine.flight.emit(
                                engine._flight_tick(), "ring_spill",
                                group=g, dst=d,
                                span=int(key[2] - key[1]) & 0xFFFFFFFF)
                        continue
                    entries, top = res
                    # Payload handoff: the receiver adopts these blocks
                    # from ONE device gather at the flush barrier; pin
                    # their slots until then.
                    ring.pin(g, entries)
                    if blkmap_d is None:
                        blkmap_d = self._staged_blocks.setdefault(d, {})
                    gm = blkmap_d.setdefault(g, {})
                    for e in entries:
                        gm[e.bid] = (me, e)
                    self.ring_routed += 1
                    if top is None:
                        col[r] = True  # full span: the device row is exact
                    else:
                        # Capped: the routed row's y/z rewrite to the cap
                        # top and the send pointer re-roots — the same
                        # fixup protocol as the host decode's cap.
                        capped.append((r, top))
                        self.ring_capped += 1
                        engine._nxt_fixups.append((g, d, top))
            rs = np.nonzero(col)[0]
            if not len(rs) and not capped:
                continue
            if src_ov is None and len(rs) and self.mesh is None:
                src_ov = self._src_ov(h)
            if len(rs):
                routed[rs, d] = True
                terms_col = ov[1][rs, d]
                peer_lease = getattr(peer, "_lease", None)
                if peer_lease is not None:
                    # Routed APPEND_RESP frames never reach the receiver's
                    # host decode, so the lease lane's ack credit
                    # (raft/lease.py) hooks the route decision instead:
                    # the ack column composition matches hostio's bit for
                    # bit. Pure host observation — the scatter below is
                    # untouched.
                    ak = (kind[rs, d] == rpc.MSG_APPEND_RESP) \
                        & (ov[8][rs, d] != 0)
                    if ak.any():
                        ar = rs[ak]
                        x64 = ((ov[2][ar, d].astype(i64) << 32)
                               | ov[3][ar, d].astype(i64))
                        peer_lease.credit_many(
                            gids[ar], me, x64, ov[1][ar, d].astype(i64))
                if engine._flight_wire:
                    # Wire trace: routed msg_sent, off the routed rows the
                    # decision table just selected (terms from the
                    # host-fetched compact outbox — no device read).
                    engine.flight.emit_many(
                        engine._flight_tick(), "msg_sent", gids[rs],
                        terms_col, kind[rs, d], engine.me, d, "routed")
                if self.mesh is not None:
                    # Sharded fabric: push the host-fetched value columns
                    # through the shard-local scatter (see module
                    # docstring).
                    self._push_vals(
                        engine, d,
                        np.stack([ov[i][rs, d] for i in range(9)]).astype(np.int32),
                        gids[rs])
                else:
                    # Source row indexing: the active-compact outbox is
                    # indexed by bucket position (rs); dense and sparse
                    # sources are the dense (9, P, N) device outbox, indexed
                    # by group id.
                    srows = rs if h["mode"] == "active" else gids[rs]
                    self._push(engine, d, src_ov, srows, gids[rs],
                               kind[rs, d], terms_col, d)
            if capped:
                crs = np.asarray([r for r, _ in capped], np.intp)
                routed[crs, d] = True
                tops = np.asarray([t for _, t in capped], i64)
                vals = np.stack([ov[i][crs, d] for i in range(9)]
                                ).astype(np.int32)
                z_cap = np.minimum(
                    (ov[6][crs, d].astype(i64) << 32)
                    | ov[7][crs, d].astype(i64), tops)
                vals[4] = (tops >> 32).astype(np.int32)
                vals[5] = (tops & 0xFFFFFFFF).astype(np.int32)
                vals[6] = (z_cap >> 32).astype(np.int32)
                vals[7] = (z_cap & 0xFFFFFFFF).astype(np.int32)
                if engine._flight_wire:
                    engine.flight.emit_many(
                        engine._flight_tick(), "msg_sent", gids[crs],
                        vals[1], vals[0], engine.me, d, "routed")
                self._push_vals(engine, d, vals, gids[crs])
        if not routed.any():
            return None
        self.routed_total += int(routed.sum())
        return routed

    def _src_ov(self, h):
        """The (9, R, N) outbox the step left on the device for this tick
        handle — a view of the step's own output (never the host copy), or
        for the python backend the host arrays — cached on the handle so
        every receiver shares it."""
        src = h.get("_route_src")
        if src is not None:
            return src
        mode = h["mode"]
        if mode == "sparse":
            src = h["ov"]  # the sparse step's dense (9, P, N) outbox
        else:
            # Dense: the (10, P) mirror then the (9, P, N) outbox; active:
            # the (13, k) mirror then the compact (9, k, N) outbox, rows
            # aligned with h["G"].
            rows, cut = ((self.P, 10 * self.P) if mode == "dense"
                         else (h["k"], _MIRROR13_ROWS * h["k"]))
            src = h["dev_flat"][cut:].reshape(9, rows, self.N)
        if self.backend == "python":
            src = src.cpu().numpy()
        h["_route_src"] = src
        return src

    def _stage_kinds(self, sender, slot, gs, kinds_col, terms_col):
        """Host mirrors of one push: the receiver's staged (P, N) kind
        mirror (and term mirror while tracing) at the sender's column."""
        km = self._staging_kinds.get(slot)
        if km is None:
            km = self._staging_kinds[slot] = np.zeros(
                (self.P, self.N), np.int8)
        km[gs, sender.me] = kinds_col.astype(np.int8)
        if self.trace:
            tm = self._staging_terms.get(slot)
            if tm is None:
                tm = self._staging_terms[slot] = np.zeros(
                    (self.P, self.N), np.int32)
            tm[gs, sender.me] = terms_col.astype(np.int32)
        srcs = self._staging_srcs.setdefault(slot, {})
        srcs[sender.me] = srcs.get(sender.me, 0) + len(gs)

    def _plane(self, slot):
        """The receiver's staged plane, allocated zero by the round's first
        push (a device memset, never an upload)."""
        plane = self._staging.get(slot)
        if plane is None:
            shape = (9, self.P, self.N)
            plane = (np.zeros(shape, np.int32) if self.backend == "python"
                     else torch.zeros(shape, dtype=torch.int32,
                                      device=self.device))
            self._staging[slot] = plane
        return plane

    def _push(self, sender, slot, src_ov, srows, gs, kinds_col, terms_col,
              dst) -> None:
        """Scatter one sender→receiver routed row set from the sender's
        step output into the receiver's staged plane, and update the host
        kind mirror + per-src delivery counts. Only the row indices are
        uploaded."""
        _unique(gs)
        self._stage_kinds(sender, slot, gs, kinds_col, terms_col)
        plane = self._plane(slot)
        if self.backend != "python":
            srows, gs = host_to(srows, self.device), host_to(gs, self.device)
        _route_scatter(plane, src_ov, srows, gs, int(dst), int(sender.me))

    def _push_vals(self, sender, slot, vals, gs) -> None:
        """Host-vals twin of :meth:`_push`, for rows whose wire fields
        differ from the device outbox (``max_append_entries``-capped
        payload AEs: y/z rewritten to the capped top). ``vals`` is the
        (9, k) int32 column block; the 36-byte-per-row upload replaces the
        chain read + wire round trip the host path would have paid."""
        _unique(gs)
        self._stage_kinds(sender, slot, gs, vals[0], vals[1])
        if self.mesh is not None:
            # Shard-local scatter into the co-sharded plane: per-shard local
            # ids (padding L, dropped) and value columns, laid out on the
            # per-shard power-of-8 ladder as the JAX fabric lays them out.
            S = mesh_shards(self.mesh)
            B, lids, shard, pos = split_shard_rows(gs, S, self.P // S)
            vals_sh = np.zeros((S, 9, B), np.int32)
            vals_sh[shard, :, pos] = vals.T
            plane = self._staging.get(slot)
            fn = make_sharded_route_scatter(self.mesh, B, self.P, self.N, plane is None)
            me = int(sender.me)
            self._staging[slot] = (fn(vals_sh, lids, me) if plane is None
                                   else fn(plane, vals_sh, lids, me))
            return
        plane = self._plane(slot)
        if self.backend != "python":
            vals, gs = host_to(vals, self.device), host_to(gs, self.device)
        _route_scatter_vals(plane, vals, gs, int(sender.me))

    # ----------------------------------------------------------- driver barrier

    def _gather_payloads(self) -> None:
        """Materialize this round's routed payload spans: flush every
        ring's pending device scatter, then ONE gather per sender covering
        the union of entries its receivers will adopt; the resulting
        Blocks land in ``_ready_blocks`` for :meth:`consume`. Runs at the
        flush barrier — between a route and its barrier nothing stages
        into that sender's ring, so a gathered slot is never torn (and the
        ring's pin guard enforces it against hostile schedules)."""
        for r in self.rings.values():
            r.flush_device()
        if not self._staged_blocks:
            return
        # Dedup key is (group, bid) — block ids are only unique per chain,
        # so two groups at the same (term, seq) collide on the bare id.
        needs: dict[int, dict[tuple[int, int], tuple[int, object]]] = {}
        for groups in self._staged_blocks.values():
            for g, gm in groups.items():
                for bid, (src, e) in gm.items():
                    needs.setdefault(src, {})[(g, bid)] = (g, e)
        got: dict[int, dict[tuple[int, int], object]] = {}
        for src, m in needs.items():
            r = self.rings.get(src)
            if r is not None:
                got[src] = r.gather(list(m.values()))
        for slot, groups in self._staged_blocks.items():
            if self.engines.get(slot) is None:
                continue  # removed/stopped receiver: payloads die with it
            tgt = self._ready_blocks.setdefault(slot, {})
            for g, gm in groups.items():
                dst = tgt.setdefault(g, {})
                for bid, (src, _e) in gm.items():
                    blk = got.get(src, {}).get((g, bid))
                    if blk is not None:
                        dst[bid] = blk
        self._staged_blocks.clear()
        for r in self.rings.values():
            r._pinned.clear()  # the barrier: every in-flight span gathered

    def flush(self) -> None:
        """Promote staged planes to consumable ones. Drivers call this at
        their delivery barrier — the exact point they hand host-path
        messages to ``receive()`` — so routed and host-delivered traffic
        become visible at the same ``tick_begin``. Also performs the
        receiver-side intake bookkeeping the host path does in
        ``receive()``: the per-src transport-liveness stamp and the
        accepted-message counter. With the payload ring on, the gather
        here waits for the device."""
        if self.rings:
            # Payload plane first: pending ring scatters land and this
            # round's routed spans materialize as receiver-ready Blocks
            # (one gather per sender) before the kind planes promote.
            self._gather_payloads()
        for slot in list(self._staging):
            stg = self._staging.pop(slot, None)
            skm = self._staging_kinds.pop(slot, None)
            stm = self._staging_terms.pop(slot, None)
            srcs = self._staging_srcs.pop(slot, None) or {}
            if stg is None or skm is None:
                continue
            peer = self.engines.get(slot)
            if peer is None:
                continue  # removed/stopped: in-flight traffic is lost
            rdy = self._ready.get(slot)
            if rdy is None:
                self._ready[slot] = stg
                self._ready_kinds[slot] = skm
                if stm is not None:
                    self._ready_terms[slot] = stm
            else:
                # Two flushes without a consuming begin (skewed/stalled
                # receiver): first writer keeps the slot, the later claim
                # is dropped — pure FIFO message loss, Raft-tolerated.
                rkm = self._ready_kinds[slot]
                free = rkm == 0
                if self.backend == "python":
                    rdy[:, free] = stg[:, free]
                elif self.mesh is not None:
                    self._ready[slot] = Shards(
                        [_merge_planes_fn(r, t) for r, t in zip(rdy.parts, stg.parts)],
                        axis=1)
                else:
                    self._ready[slot] = _merge_planes_fn(rdy, stg)
                rtm = self._ready_terms.get(slot)
                if rtm is not None and stm is not None:
                    rtm[free] = stm[free]
                rkm[free] = skm[free]
            for s, cnt in srcs.items():
                peer._h_src_seen[s] = peer._ticks
                peer._c_in.inc(cnt)

    # ---------------------------------------------------------- receiver side

    def consume(self, slot: int):
        """Take the receiver's ready plane for this tick_begin: returns
        (plane, kinds, terms, blocks) — the device plane the window step
        merges, the host (P, N) kind mirror backing occupancy/wake/
        stamping, the term mirror when wire tracing is live (None
        otherwise), and the ring-fed payload blocks (group -> [Block],
        already materialized at the flush barrier) the receiver's chain
        adoption will walk — or all-None when nothing was routed. The
        fabric keeps no reference to the plane it hands out."""
        plane = self._ready.pop(slot, None)
        kinds = self._ready_kinds.pop(slot, None)
        terms = self._ready_terms.pop(slot, None)
        rb = self._ready_blocks.pop(slot, None)
        blocks = ({g: list(m.values()) for g, m in rb.items()}
                  if rb else None)
        return plane, kinds, terms, blocks

    def purge_group(self, slot: int, g: int, kinds=None) -> None:
        """Drop pending routed traffic for group ``g`` toward ``slot`` —
        the fabric half of the engine's pending-queue purge on group
        recycle (all kinds) and parole entry (election kinds only)."""
        sel_kinds = None if kinds is None else np.asarray(sorted(kinds),
                                                         np.int8)
        if kinds is None:
            # Full purge (recycle/reset): the slot's OWN ring row — a dead
            # incarnation's payloads must never resolve for the successor
            # — and any in-flight ring-fed blocks toward it. The
            # kind-selective parole purge keeps both: AE is not an
            # election kind.
            ring = self.rings.get(slot)
            if ring is not None:
                ring.purge(g)
            for store in (self._staged_blocks, self._ready_blocks):
                m = store.get(slot)
                if m:
                    m.pop(g, None)
        for planes, mirrors, terms in (
                (self._staging, self._staging_kinds, self._staging_terms),
                (self._ready, self._ready_kinds, self._ready_terms)):
            km = mirrors.get(slot)
            if km is None:
                continue
            row = km[g]
            sel = (row != 0) if sel_kinds is None else np.isin(row, sel_kinds)
            if not sel.any():
                continue
            if self.mesh is not None:
                # The owning shard alone purges its row.
                planes[slot] = purge_plane_row_masked(planes[slot], g, ~sel)
            else:
                cols = np.nonzero(sel)[0]
                if self.backend != "python":
                    cols = host_to(cols, self.device)
                _purge_plane_row_fn(planes[slot], g, cols)
            row[sel] = 0
            tm = terms.get(slot)
            if tm is not None:
                tm[g][sel] = 0

    # ------------------------------------------------------------------ stats

    def pending_counts(self) -> dict[int, int]:
        """Per-receiver staged+ready routed rows (debug/tests)."""
        out: dict[int, int] = {}
        for store in (self._staging_kinds, self._ready_kinds):
            for slot, km in store.items():
                if km is not None:
                    out[slot] = out.get(slot, 0) + int((km != 0).sum())
        return out

    def ring_stats(self) -> dict | None:
        """Fabric-aggregate payload-ring telemetry (bench rows): blocks
        staged, payload AEs served from the ring, spills back to the host
        path, and current occupancy. None when the ring is off."""
        if not self.rings:
            return None
        rings = self.rings.values()
        return {
            "staged_blocks": sum(r.staged_total for r in rings),
            "payload_aes_routed": self.ring_routed,
            "capped": self.ring_capped,
            "spills": sum(r.spills for r in rings),
            "oversize": sum(r.oversize for r in rings),
            "pin_skips": sum(r.pin_skips for r in rings),
            "occupancy": sum(r.occupancy() for r in rings),
        }
