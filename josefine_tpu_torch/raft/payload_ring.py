"""Device-resident payload ring: block payloads for on-device AppendEntries.

RouteFabric (raft/route.py) delivers payload-free consensus rows device to
device but stops at AppendEntries with a real span: without the ring the
sender re-reads the span from its chain and encodes it into a wire batch the
receiver decodes back. The payload ring closes that gap.

One :class:`PayloadRing` per registered fabric slot (the ring is
per-SENDER: residency is a pure function of that engine's own history, so
the twin tests can predict routing without cross-engine races):

* **stage** — when the engine mints or adopts blocks (``tick_finish``
  already holds them on their way into ``Chain.append``/``extend_many``),
  their payloads are packed into int32 words and queued for the bounded
  per-group ring: S slots per group, W words per slot, FIFO overwrite. The
  device scatter (:func:`packed_step._ring_scatter`) runs once per flush
  barrier, off the tick's critical path. Host-side metadata (block id,
  parent, incarnation, length) backs every residency decision without a
  device read.
* **resolve** — the sender's route decision: walk the claimed span
  ``(x, y]`` down the parent pointers through the metadata. Fully resident
  -> the AE routes like a heartbeat; longer than ``max_append_entries`` ->
  the resident prefix routes with the capped top (the same cap and send-
  pointer re-root the host decode would apply); any miss -> the row spills
  to the host path, counted and (config-gated) journaled.
* **gather** — at the fabric's flush barrier the routed spans' payload
  words come back in ONE device gather per sender
  (:func:`packed_step._ring_gather`, a blocking read) and materialize as the
  receiver's staged blocks: the receiver's chain extension adopts them
  without ever seeing a wire frame.

Entries referenced by an unfetched route are **pinned** until that gather
runs: staging that would overwrite a pinned slot skips the new block instead
(it simply isn't resident -> its AE rides the host path), so no driver
schedule can make a receiver adopt a torn slot.

The port of the JAX package's ``raft/payload_ring.py``: the host metadata is
the same; the buffer is a (P, S, W) int32 tensor on the engines' device
(numpy for the python backend). On a fabric of sharded engines the buffer
co-shards its group axis with their state (a
:class:`~josefine_tpu_torch.parallel.sharded.Shards` of (L, S, W) blocks),
and stage scatters and gathers run shard-local: a block's ring row IS its
group row, so residency never crosses a shard.
"""

from __future__ import annotations

import numpy as np
import torch

from josefine_tpu_torch.parallel.sharded import (
    Shards,
    make_sharded_ring_gather,
    make_sharded_ring_scatter,
    mesh_shards,
    shard_devices,
    split_shard_rows,
)
from josefine_tpu_torch.raft.chain import Block
from josefine_tpu_torch.raft.hostio import host_to
from josefine_tpu_torch.raft.packed_step import _ring_gather, _ring_scatter
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("raft.payload_ring")


class _Entry:
    """One resident block's host metadata (the payload bytes live ONLY in
    the device buffer)."""

    __slots__ = ("bid", "parent", "inc", "length", "slot")

    def __init__(self, bid: int, parent: int, inc: int, length: int,
                 slot: int):
        self.bid = bid
        self.parent = parent
        self.inc = inc
        self.length = length
        self.slot = slot


class PayloadRing:
    """Bounded per-group device payload slots for one fabric sender slot
    (see module docstring)."""

    def __init__(self, P: int, slots: int = 8, slot_bytes: int = 512,
                 backend: str = "torch", device="cpu", mesh=None):
        if slots < 1:
            raise ValueError("payload ring needs >= 1 slot per group")
        self.P = int(P)
        self.S = int(slots)
        self.W = max(1, (int(slot_bytes) + 3) // 4)
        self.backend = backend
        self.device = torch.device(device)
        # The sharded engines' 'p' mesh, or None (see module docstring).
        self.mesh = mesh
        # (P, S, W) int32 device buffer (numpy for the scalar twin),
        # allocated on first stage so a ring-enabled but idle fabric costs
        # nothing.
        self.buf = None
        self._ptr: dict[int, int] = {}            # g -> monotone write ctr
        self._ents: dict[int, dict[int, _Entry]] = {}   # g -> slot -> entry
        self._by_id: dict[int, dict[int, _Entry]] = {}  # g -> bid -> entry
        # Blocks staged but not yet scattered to the device (one scatter
        # per flush barrier): (g, slot, words).
        self._pend: list[tuple[int, int, np.ndarray]] = []
        # Slots referenced by a routed-but-not-yet-gathered span: staging
        # must not overwrite them (see module docstring).
        self._pinned: set[tuple[int, int]] = set()
        # Occupancy / spill telemetry (the fabric aggregates these into
        # ring_stats and the raft_route_ring_* metrics).
        self.staged_total = 0
        self.spills = 0       # route-time residency misses (per would-be AE)
        self.oversize = 0     # payloads wider than a slot — never resident
        self.pin_skips = 0    # staging skipped to protect a pinned slot

    # ------------------------------------------------------------- staging

    def stage(self, g: int, inc: int, blocks) -> None:
        """Queue freshly minted/adopted blocks for group ``g``'s ring.
        Id-deduplicated (re-adopting a resident block is a no-op, so ring
        state stays a pure function of the chain history, not of how many
        paths staged it); FIFO slot overwrite past S live blocks."""
        ents = self._ents.setdefault(g, {})
        by_id = self._by_id.setdefault(g, {})
        for b in blocks:
            data = b.data
            if len(data) > self.W * 4:
                self.oversize += 1
                continue
            prev = by_id.get(b.id)
            if prev is not None and prev.inc == inc:
                continue  # already resident
            slot = self._ptr.get(g, 0) % self.S
            if (g, slot) in self._pinned:
                # An unfetched routed span references this slot: the new
                # block simply is not resident (its AE spills host-side).
                self.pin_skips += 1
                continue
            old = ents.pop(slot, None)
            if old is not None:
                by_id.pop(old.bid, None)
            e = _Entry(b.id, b.parent, inc, len(data), slot)
            ents[slot] = e
            by_id[b.id] = e
            self._ptr[g] = self._ptr.get(g, 0) + 1
            pad = (-len(data)) % 4
            words = np.zeros(self.W, np.int32)
            if data:
                w = np.frombuffer(data + b"\x00" * pad, "<i4")
                words[:len(w)] = w
            self._pend.append((g, slot, words))
            self.staged_total += 1

    def flush_device(self) -> None:
        """One scatter of everything staged since the last flush barrier.
        Last-writer-wins per (group, slot): a busy group can cycle one slot
        several times between barriers and only the final occupant is
        resident, which also makes the scatter's indices unique."""
        if not self._pend:
            return
        final = {(g, slot): w for g, slot, w in self._pend}
        self._pend.clear()
        n = len(final)
        gids = np.fromiter((g for g, _ in final), np.int64, n)
        slots = np.fromiter((s for _, s in final), np.int64, n)
        words = np.stack(list(final.values()))
        if self.backend == "python":
            if self.buf is None:
                self.buf = np.zeros((self.P, self.S, self.W), np.int32)
            _ring_scatter(self.buf, gids, slots, words)
            return
        if self.mesh is not None:
            # Shard-local stage scatter, laid out per shard on the
            # power-of-8 ladder as in the JAX ring.
            Sh = mesh_shards(self.mesh)
            L = self.P // Sh
            if self.buf is None:
                self.buf = Shards([torch.zeros((L, self.S, self.W), dtype=torch.int32,
                                               device=d) for d in shard_devices(self.mesh)])
            B, lgids, shard, pos = split_shard_rows(gids, Sh, L, cap=L * self.S)
            sl = np.zeros((Sh, B), np.int32)
            wd = np.zeros((Sh, B, self.W), np.int32)
            sl[shard, pos] = slots
            wd[shard, pos] = words
            make_sharded_ring_scatter(self.mesh, B)(self.buf, lgids, sl, wd)
            return
        if self.buf is None:
            self.buf = torch.zeros((self.P, self.S, self.W), dtype=torch.int32,
                                   device=self.device)
        dev = self.device
        _ring_scatter(self.buf, host_to(gids, dev), host_to(slots, dev),
                      host_to(words, dev))

    # ----------------------------------------------------------- residency

    def resolve(self, g: int, inc: int, x: int, y: int,
                cap: int | None):
        """Route decision for an AE claiming span ``(x, y]``: walk ``y``
        down the parent pointers through the resident metadata. Returns
        ``(entries ascending, capped_top)`` — ``capped_top`` is ``None``
        when the full span routes as-is, else the ``cap``-th block's id
        (the routed row's y/z are rewritten to it and the sender's nxt is
        re-rooted, exactly like the host decode's cap) — or ``None`` when
        any block is missing (the row spills to the host path)."""
        if x == y:
            return None
        by_id = self._by_id.get(g)
        if not by_id:
            return None
        chain: list[_Entry] = []
        cur = y
        while cur != x:
            if len(chain) >= self.S:
                return None  # longer than the ring can ever hold
            e = by_id.get(cur)
            if e is None or e.inc != inc:
                return None
            chain.append(e)
            cur = e.parent
        chain.reverse()
        if cap is not None and len(chain) > cap:
            chain = chain[:cap]
            return chain, chain[-1].bid
        return chain, None

    def pin(self, g: int, entries) -> None:
        """Protect a routed span's slots until :meth:`gather` reads them."""
        for e in entries:
            self._pinned.add((g, e.slot))

    # ------------------------------------------------------------- gather

    def gather(self, needs) -> dict[tuple[int, int], Block]:
        """Materialize routed blocks in ONE device gather: ``needs`` is a
        list of ``(g, entry)`` pairs; returns ``(g, bid) -> Block`` —
        keyed WITH the group, because block ids are only unique per chain.
        The fabric flushes pending stages first and clears pins once every
        sender's gather has run (the barrier). On the card this read waits
        for the device."""
        out: dict[tuple[int, int], Block] = {}
        if not needs:
            return out
        n = len(needs)
        gids = np.fromiter((g for g, _ in needs), np.int64, n)
        slots = np.fromiter((e.slot for _, e in needs), np.int64, n)
        if self.backend == "python":
            rows = _ring_gather(self.buf, gids, slots)
        elif self.mesh is not None:
            # Shard-local gather: per-shard slot reads come back (B, W) each
            # and the host picks each entry by its (shard, pos) coordinates.
            Sh = mesh_shards(self.mesh)
            L = self.P // Sh
            B, lgids, shard, pos = split_shard_rows(gids, Sh, L, cap=L * self.S)
            sl = np.zeros((Sh, B), np.int32)
            sl[shard, pos] = slots
            got = make_sharded_ring_gather(self.mesh, B)(self.buf, lgids, sl)
            rows = np.stack([t.cpu().numpy() for t in got])[shard, pos]
        else:
            dev = self.device
            rows = _ring_gather(self.buf, host_to(gids, dev),
                                host_to(slots, dev)).cpu().numpy()
        for (g, e), row in zip(needs, rows):
            data = np.ascontiguousarray(row, dtype="<i4").tobytes()[:e.length]
            out[(g, e.bid)] = Block(id=e.bid, parent=e.parent, data=data)
        return out

    # -------------------------------------------------------------- admin

    def purge(self, g: int) -> None:
        """Drop group ``g``'s resident entries and queued stages (group
        recycle/reset: a dead incarnation's payloads must never resolve).
        Device words are left as garbage — every read is metadata-gated."""
        self._ents.pop(g, None)
        self._by_id.pop(g, None)
        self._ptr.pop(g, None)
        if self._pend:
            self._pend = [p for p in self._pend if p[0] != g]
        if self._pinned:
            self._pinned = {p for p in self._pinned if p[0] != g}

    def occupancy(self) -> int:
        """Resident entries across all groups (the occupancy gauge)."""
        return sum(len(e) for e in self._ents.values())
