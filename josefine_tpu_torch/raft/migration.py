"""Live group migration: fence protocol and the chaos-harness coordinator.

A live consensus group moves from its SOURCE engine row to a TARGET row
(possibly on another engine, possibly in another ``('p',)`` mesh shard —
row index determines the shard, so a cross-region target row IS a
cross-shard move) without losing a single acknowledged write:

1. **freeze** — every engine marks the source row frozen: new proposals
   fail with a retryable :class:`~josefine_tpu.raft.result.NotLeader`
   (the dual-ownership window; the client retry/reroute machinery carries
   traffic across), and queued-but-unminted proposals are failed the same
   way so nothing can mint after the fence;
2. **fence** — the coordinator proposes a fence payload
   (:data:`FENCE_PREFIX`-tagged, exempt from the freeze) on the current
   source leader, re-proposing on leader change. The fence's position in
   the applied sequence IS the handoff point: everything acked on the
   source is at or before it;
3. **adopt** — each node whose source FSM applied the fence installs the
   applied prefix *truncated at the FIRST fence* (duplicate fences from
   re-proposals are tolerated — every adopter carries the identical
   prefix) into the target row as a synthetic snapshot
   (:meth:`~josefine_tpu.raft.group_admin.GroupAdmin.migrate_adopt_row`:
   recycle + install + incarnation stamp, the same purge inventory as a
   row reuse);
4. **cutover** — once a quorum adopted, ownership flips: the source row
   is purged on every live engine exactly like a recycle (pending queues,
   route/ring planes, pipelined dispatches) under a bumped incarnation so
   its in-flight traffic dies at intake, live stragglers get the target
   incarnation and catch up through the ordinary snapshot-install path,
   and the freed source row becomes the new spare;
5. **abort** (any time before cutover) — the freeze lifts, adopted target
   rows are recycled under a fresh incarnation, and the source remains
   the single owner. The target never took traffic, so zero acked-write
   loss holds on both resolution paths.

Election safety across the handoff: only adopters carry the full fenced
prefix, and cutover requires a quorum of them — an empty straggler can
never assemble a majority that excludes every adopter, so the committed
prefix survives any post-cutover election (standard log-completeness
voting). Source-side safety is the existing recycle contract (durable
terms survive, incarnation isolates stale frames).

:class:`MigrationCoordinator` is the chaos-harness controller (the
product plane's controller is the metadata FSM — see
``broker/fsm.py``'s Migration transitions); it models the reliable
reassignment driver and is deliberately host-side state on the cluster,
not a node, so nemesis crashes exercise the *engines'* interruptibility,
which is what the invariant checker gates.
"""

from __future__ import annotations

import json

from josefine_tpu_torch.raft.chain import pack_id
from josefine_tpu_torch.utils.metrics import REGISTRY

#: Fence payload tag. Same convention as membership.CONF_PREFIX: a NUL
#: lead byte no client payload starts with, then an ASCII magic. Fence
#: payloads commit through a FROZEN source row (propose() exempts them)
#: and are never acked into any client-visible log, so the exactly-once
#: checkers ignore them; the PartitionFsm applies them as no-ops.
FENCE_PREFIX = b"\x00MIG"

_m_migrations = REGISTRY.counter(
    "raft_migrations_total",
    "Live group migrations resolved, by outcome (cutover/aborted)")


def migration_fence(stream: int, mig_id: int) -> bytes:
    """The unique fence payload for one migration attempt."""
    return FENCE_PREFIX + b":fence:%d:%d" % (stream, mig_id)


def is_migration_fence(payload: bytes) -> bool:
    return payload.startswith(FENCE_PREFIX)


class MigrationCoordinator:
    """Drives the freeze/fence/adopt/cutover phase machine against a
    :class:`~josefine_tpu.chaos.harness.ChaosCluster` (duck-typed: needs
    ``engines``, ``fsms``, ``live_nodes()``, ``plane``, ``stream_row``,
    ``spare_row``, ``tick_no``, ``N``, ``G``). One migration in flight at
    a time (the single-server rule, like conf changes); ``begin``/
    ``abort`` are the nemesis DSL entry points and skip-and-record when
    not applicable, so a mutated schedule stays runnable."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.mig: dict | None = None
        self.next_id = 0
        # Authoritative per-row incarnation (the controller's ledger; the
        # product plane keeps this in the replicated Store). Re-applied to
        # revived engines, whose volatile incarnation resets to 0.
        self.row_inc: dict[int, int] = {}
        # Which incarnation each NODE's durable row state belongs to: a
        # node down across a bump revives with the old life's chain, which
        # must be purged before restamping (the harness twin of the
        # product plane's _sync_group_incarnation wipe). A node whose
        # durable state matches the live incarnation keeps its chain — a
        # blind recycle would forget acks it granted (the reset-voter
        # quorum-intersection hazard _reset_group's parole exists for).
        self._node_inc: list[dict[int, int]] = [
            {} for _ in range(cluster.N)]
        self.pause_ticks = 0  # ticks with the freeze armed (refused traffic)
        self.outcomes = {"cutover": 0, "aborted": 0, "skipped": 0}
        self.history: list[dict] = []
        self._fence_prop = None  # (engine, fut) of the live fence proposal
        # The spare row starts IDLE everywhere (empty claim: no elections).
        # An electable empty spare would win the row at term t and later —
        # when adopters install a snapshot whose mint term is also t — keep
        # believing it leads, committing off their acks blocks it never
        # carried. Adoption is what activates the row (migrate_adopt_row),
        # under the snapshot it just installed.
        for i in range(cluster.N):
            cluster.engines[i].set_group_members(cluster.spare_row,
                                                 frozenset())

    # ------------------------------------------------------ nemesis entry

    def begin(self, stream: int) -> bool:
        """Start migrating ``stream`` out of its current row into the
        spare. Returns False (skip-and-record at the caller) if a
        migration is already in flight or the stream is out of range."""
        c = self.cluster
        if self.mig is not None or not (0 < stream < c.G):
            # One migration in flight at a time; stream 0 is pinned to row
            # 0 (the product plane's metadata group — recycle/adopt refuse
            # row 0 by the same rule, so it can never be a source or a
            # spare).
            self.outcomes["skipped"] += 1
            return False
        src, dst = c.stream_row[stream], c.spare_row
        mig_id = self.next_id
        self.next_id += 1
        dst_inc = self.row_inc.get(dst, 0) + 1
        self.row_inc[dst] = dst_inc
        self.mig = {
            "id": mig_id, "stream": stream, "src": src, "dst": dst,
            "dst_inc": dst_inc, "fence": migration_fence(stream, mig_id),
            "adopted": set(), "started": c.tick_no,
        }
        self._fence_prop = None
        for i in c.live_nodes():
            c.engines[i].freeze_group(src)
        c.plane._event("migration_started", stream=stream, src=src,
                       dst=dst, inc=dst_inc)
        return True

    def abort(self) -> bool:
        """Roll back to the single pre-migration owner: lift the freeze,
        recycle every adopted target row under a fresh incarnation (it
        never took traffic — zero acked loss), return the target to the
        spare pool."""
        c, m = self.cluster, self.mig
        if m is None:
            self.outcomes["skipped"] += 1
            return False
        dst_inc = self.row_inc[m["dst"]] + 1
        self.row_inc[m["dst"]] = dst_inc
        for i in c.live_nodes():
            e = c.engines[i]
            e.unfreeze_group(m["src"])
            e.recycle_group(m["dst"])
            # Back to an idle spare: adoption activated the row on the
            # nodes that got that far; the empty claim re-idles it on all.
            e.set_group_members(m["dst"], frozenset())
            e.set_group_incarnation(m["dst"], dst_inc)
            self._node_inc[i][m["dst"]] = dst_inc
        self._resolve("aborted")
        return True

    # ----------------------------------------------------------- driving

    def step(self) -> None:
        """One controller round per harness tick (after nemesis faults and
        revivals, before engines tick): keep the freeze armed, drive the
        fence, adopt fenced nodes, cut over at quorum. Runs through heal
        too, so an interrupted migration always rolls forward."""
        c, m = self.cluster, self.mig
        if m is None:
            return
        self.pause_ticks += 1
        src, dst = m["src"], m["dst"]
        live = c.live_nodes()
        for i in live:
            c.engines[i].freeze_group(src)
        # (Re-)propose the fence on the current source leader. Duplicates
        # are tolerated: adoption truncates at the FIRST fence, so every
        # adopter carries the identical prefix regardless of how many
        # re-proposals a leader churn produced.
        leader = None
        for i in live:
            if c.engines[i].is_leader(src):
                leader = c.engines[i]
                break
        if leader is not None:
            prop = self._fence_prop
            if (prop is None or prop[0] is not leader
                    or (prop[1].done()
                        and (prop[1].cancelled()
                             or prop[1].exception() is not None))):
                self._fence_prop = (leader, leader.propose(src, m["fence"]))
        # Per-node adoption: the fence's arrival in a node's applied
        # sequence proves the node holds the complete handoff prefix.
        for i in live:
            if i in m["adopted"]:
                continue
            applied = c.fsms[i][src].applied
            if m["fence"] not in applied:
                continue
            carried = applied[:applied.index(m["fence"]) + 1]
            # Synthetic deterministic snapshot anchor: term 1, seq = prefix
            # length. The fence guarantees len >= 1, so the id clears
            # GENESIS; post-adoption mints happen at election terms >= 2
            # and dominate it, preserving id monotonicity.
            snap_id = pack_id(1, len(carried))
            snap_data = json.dumps([p.decode() for p in carried]).encode()
            c.engines[i].migrate_adopt_row(dst, snap_id, snap_data,
                                           m["dst_inc"])
            self._node_inc[i][dst] = m["dst_inc"]
            m["adopted"].add(i)
            c.plane._event("migration_handoff", stream=m["stream"],
                           node=i, src=src, dst=dst, carried=len(carried))
        if len(m["adopted"]) * 2 > c.N:
            self._cutover()

    def _cutover(self) -> None:
        c, m = self.cluster, self.mig
        src, dst = m["src"], m["dst"]
        src_inc = self.row_inc.get(src, 0) + 1
        self.row_inc[src] = src_inc
        for i in c.live_nodes():
            e = c.engines[i]
            if i not in m["adopted"]:
                # Live straggler: joins the new owner row empty and catches
                # up through the ordinary snapshot-install path (genesis
                # follower below the target leader's floor). Activate the
                # claim-idled row and flip the incarnation so target
                # frames reach it; empty, it can neither win an election
                # against the adopter majority (log-completeness voting)
                # nor regress their quorum.
                e.set_group_members(dst, None)
                e.set_group_incarnation(dst, m["dst_inc"])
            self._node_inc[i][dst] = m["dst_inc"]
            e.migrate_purge_source(src, src_inc)
            self._node_inc[i][src] = src_inc
        c.stream_row[m["stream"]] = dst
        c.spare_row = src
        self._resolve("cutover")

    def _resolve(self, outcome: str) -> None:
        c, m = self.cluster, self.mig
        _m_migrations.inc(outcome=outcome)
        kind = "migration_cutover" if outcome == "cutover" \
            else "migration_aborted"
        c.plane._event(kind, stream=m["stream"], src=m["src"], dst=m["dst"],
                       ticks=c.tick_no - m["started"])
        self.outcomes[outcome] += 1
        self.history.append({
            "stream": m["stream"], "src": m["src"], "dst": m["dst"],
            "outcome": outcome, "started": m["started"],
            "resolved": c.tick_no, "adopted": sorted(m["adopted"]),
        })
        self.mig = None
        self._fence_prop = None

    # ----------------------------------------------------------- rebuild

    def on_engine_rebuilt(self, i: int) -> None:
        """Re-anchor a freshly (re)built engine: purge rows whose durable
        state predates the live incarnation, restamp incarnations (the
        engine's reset to 0 with the process), and re-arm the freeze if a
        migration is in flight (the freeze is volatile by design)."""
        e = self.cluster.engines[i]
        for r in sorted(self.row_inc):
            inc = self.row_inc[r]
            if self._node_inc[i].get(r, 0) != inc:
                e.recycle_group(r)
                self._node_inc[i][r] = inc
            e.set_group_incarnation(r, inc)
        # Claims are volatile too: a fresh engine boots every row fully
        # electable. Re-idle the row(s) that must not elect on this node —
        # the spare between migrations; during one, the target on every
        # node that has not adopted yet (an adopter's target row is live
        # by rights: its durable snapshot survived with it).
        if self.mig is not None:
            if i not in self.mig["adopted"]:
                e.set_group_members(self.mig["dst"], frozenset())
            e.freeze_group(self.mig["src"])
        else:
            e.set_group_members(self.cluster.spare_row, frozenset())

    # ----------------------------------------------------------- summary

    def summary(self) -> dict:
        return {
            "migrations": self.next_id,
            "outcomes": dict(self.outcomes),
            "history": list(self.history),
            "pause_ticks": self.pause_ticks,
            "row_inc": {str(r): self.row_inc[r]
                        for r in sorted(self.row_inc)},
        }
