"""Group administration: membership claims, lifecycle, and vote parole.

Mixin half of :class:`josefine_tpu_torch.raft.engine.RaftEngine` (state is
initialized there; these methods own the membership mask, per-group claim
sets, group reset/recycle, conf-change application, and the vote-parole
safety mechanism). The port of the JAX package's ``raft/group_admin.py``:
the host logic is the same; the device-row writes build new leaves
(:func:`set_row`) instead of writing the live state, and the route-fabric,
payload-ring and lease hooks are not ported yet.

The node-axis columns are pre-allocated slots a cluster can grow into
(runtime ADD/REMOVE via replicated conf blocks), and the P axis hosts
recyclable data-group rows.
"""

from __future__ import annotations

import numpy as np
import torch

from josefine_tpu_torch.ops import ids
from josefine_tpu_torch.raft import rpc
from josefine_tpu_torch.raft.chain import GENESIS, id_seq, id_term
from josefine_tpu_torch.raft.fsm import Driver, Fsm, ReplicaDiverged, supports_snapshot
from josefine_tpu_torch.raft.hostio import host_to
from josefine_tpu_torch.raft.membership import ConfChange, is_conf
from josefine_tpu_torch.raft.result import NotLeader, TickResult
from josefine_tpu_torch.utils.metrics import REGISTRY
from josefine_tpu_torch.utils.tracing import get_logger

log = get_logger("raft.engine")


def set_row(t: torch.Tensor, g: int, v) -> torch.Tensor:
    """``t[g] = v`` on a copy: the engine's state leaves are never written in
    place (an in-flight pipelined dispatch may still read them)."""
    y = t.clone()
    y[g] = v
    return y

_m_paroled = REGISTRY.gauge(
    "raft_groups_paroled",
    "Groups abstaining from elections until re-replicated past their "
    "pre-reset ack watermark (vote parole)")

# Kinds a group on vote parole refuses to process (see _reset_group): an
# election request processed by a voter that forgot its acked log breaks
# quorum intersection — dropping the request IS the abstention.
_PAROLE_DROP_KINDS = frozenset((rpc.MSG_VOTE_REQ, rpc.MSG_PREVOTE_REQ))
_PAROLE_DROP_ARR = np.asarray(sorted(_PAROLE_DROP_KINDS), np.int32)


class GroupAdmin:
    """Membership/lifecycle methods of RaftEngine (see module docstring)."""

    def _active_vec(self) -> np.ndarray:
        active = np.zeros(self.N, bool)
        for s in self.members.active_slots():
            active[s] = True
        return active

    def _claim_row(self, g: int, active: np.ndarray) -> np.ndarray:
        """One group's member columns: its claim set (if any) intersected
        with the active cluster members. The single source of truth for both
        the full rebuild and the incremental row update."""
        slots = self._group_claims.get(g)
        if slots is None:
            return active
        row = np.zeros(self.N, bool)
        for s in slots:
            if 0 <= s < self.N:
                row[s] = True
        return row & active

    def _member_mask(self) -> torch.Tensor:
        """(P, N) membership: active-member columns, restricted per group by
        its claim set (see _group_claims). Full rebuild — called at init and
        on (rare) cluster-membership changes; per-partition claims use the
        incremental row update in set_group_members."""
        active = self._active_vec()
        m = np.broadcast_to(active[None, :], (self.P, self.N)).copy()
        for g in self._group_claims:
            m[g] = self._claim_row(g, active)
        self._mask_np = m
        return self._place_member(m)

    def _place_member(self, m) -> torch.Tensor:
        """Device-place a (P, N) membership mask (a new tensor: the one an
        in-flight dispatch reads is never written)."""
        return host_to(np.asarray(m, bool), self._device)

    def set_group_members(self, g: int, slots) -> None:
        """Claim (or idle, with an empty set) a data group's member columns.
        ``slots=None`` reverts the group to default full membership."""
        if g == 0 or not (0 < g < self.P):
            raise ValueError(f"group {g} not a claimable data group (P={self.P})")
        if slots is None:
            self._group_claims.pop(g, None)
        else:
            self._group_claims[g] = frozenset(int(s) for s in slots)
        # Incremental: rewrite only row g of the host mask, re-upload.
        self._mask_np[g] = self._claim_row(g, self._active_vec())
        self.member = self._place_member(self._mask_np)
        # A claim change moves quorum/membership for the row — wake it so
        # the full step (not the decay closed form) sees the new mask.
        # (Dense engines never drain _force_active, so only track it when
        # the active-set scheduler is on.)
        if self._active_set:
            self._force_active.add(g)

    def group_members(self, g: int) -> frozenset[int] | None:
        return self._group_claims.get(g)

    def set_group_incarnation(self, g: int, inc: int) -> None:
        if not (0 < g < self.P):
            raise ValueError(f"group {g} not a data group (P={self.P})")
        self._h_ginc[g] = int(inc)

    def group_incarnation(self, g: int) -> int:
        return int(self._h_ginc[g])

    def recycle_group(self, g: int) -> None:
        """Reset a data-group row for reuse by a NEW topic partition: chain
        back to genesis, snapshot record gone, transfer state purged, and
        the device row fully demoted (role/leader/progress/votes cleared —
        a row that was leading its previous incarnation must not keep
        broadcasting). The durable (term, voted_for) record is deliberately
        KEPT: term monotonicity across incarnations means any straggler
        frame from the old life carries a term the new life has already
        seen. Callers then bump the row incarnation (set_group_incarnation)
        so stale frames are dropped at intake."""
        if not (0 < g < self.P):
            raise ValueError(f"group {g} not a data group (P={self.P})")
        # No vote parole on recycling: the row's history is discarded by
        # design (topic deleted through a replicated barrier) and the new
        # incarnation starts at genesis — a parole watermark from the old
        # life would wedge the fresh topic's row forever. The incarnation
        # stamp isolates stale frames instead.
        self._reset_group(g, parole=False)
        self._lift_parole(g)
        self._h_last_seen[g] = 0
        # Queued-but-unminted proposals belong to the dead incarnation:
        # fail their futures (NotLeader — the client re-routes/retries)
        # instead of dropping them silently, which left produce awaits
        # hanging until their transport timeout.
        for _payload, fut, _t_sub, _span in self._proposals.pop(g, ()):
            if fut is not None and not fut.done():
                fut.set_exception(NotLeader(g, -1))
        self._prop_groups.discard(g)
        # Tenant attribution dies with the incarnation — the next claimant
        # re-tags (a reused row must not bill latency to the dead tenant).
        self._group_tags.pop(g, None)
        # Already-admitted intake for the old incarnation (the receive-time
        # filter passed it against the OLD local incarnation) must not reach
        # the device next tick.
        self._pending_msgs = [m for m in self._pending_msgs if m.group != g]
        self._pending_batches = [
            pb for pb in (b.take(b.group != g) for b in self._pending_batches)
            if len(pb)]
        self._recycled_this_tick.add(g)
        self.flight.emit(self._flight_tick(), "group_recycled", group=g,
                         inc=int(self._h_ginc[g]))

    # ---------------------------------------------------- live migration

    def freeze_group(self, g: int) -> None:
        """Arm the migration dual-ownership window on a SOURCE row: new
        proposals fail with a retryable NotLeader (see engine.propose —
        the migration fence payload is exempt), and queued-but-unminted
        proposals are failed the same way, so nothing can mint after the
        fence. Volatile by design: a restarted engine revives unfrozen and
        the migration controller re-arms it. Idempotent."""
        if not (0 < g < self.P):
            raise ValueError(f"group {g} not a data group (P={self.P})")
        if g in self._frozen_groups:
            return
        self._frozen_groups.add(g)
        for _payload, fut, _t_sub, _span in self._proposals.pop(g, ()):
            if fut is not None and not fut.done():
                fut.set_exception(NotLeader(g, -1))
        self._prop_groups.discard(g)
        self.flight.emit(self._flight_tick(), "migration_started", group=g,
                         inc=int(self._h_ginc[g]))

    def unfreeze_group(self, g: int) -> None:
        """Lift the freeze without a cutover (migration aborted): the
        source row is the single owner again."""
        if g in self._frozen_groups:
            self._frozen_groups.discard(g)
            self.flight.emit(self._flight_tick(), "migration_aborted",
                             group=g, inc=int(self._h_ginc[g]))

    def group_frozen(self, g: int) -> bool:
        return g in self._frozen_groups

    def migrate_adopt_row(self, g: int, snap_id: int, snap_data: bytes,
                          inc: int) -> None:
        """Install a migrating group's carried prefix into TARGET row
        ``g`` as a synthetic snapshot: recycle the row first (it may hold
        a previous life — an aborted earlier attempt revived from durable
        state — and ``install_snapshot`` requires ``snap_id`` above the
        committed id; the purge inventory is exactly a reuse), restore the
        FSM, then adopt chain/device/term per the ``_adopt_snapshot``
        recipe and stamp the target incarnation so source-life frames die
        at intake."""
        if not (0 < g < self.P):
            raise ValueError(f"group {g} not a data group (P={self.P})")
        drv = self.drivers.get(g)
        if drv is None or not supports_snapshot(drv.fsm):
            raise ValueError(f"group {g} has no snapshot-capable FSM")
        self.recycle_group(g)
        drv.drop_waiters(NotLeader(g, -1))
        drv.fsm.restore(snap_data)
        snap_record = drv.fsm.snapshot()
        ch = self.chains[g]
        # Persist the snapshot record BEFORE mutating the chain (the
        # take_snapshot/_adopt_snapshot crash-ordering rule: a floor above
        # GENESIS with no matching record is unrecoverable).
        self._store_snapshot(g, snap_id, snap_record)
        ch.install_snapshot(snap_id)
        # INVARIANT: every out-of-tick chain mutation must refresh the
        # _h_head/_h_commit mirrors itself — tick_finish's need-mask skips
        # quiet rows, so it will NOT heal a mirror this site leaves stale.
        self._h_head[g] = ch.head
        self._h_commit[g] = ch.committed
        if self._active_set:
            self._force_active.add(g)
        snap_term = id_term(snap_id)
        if snap_term > int(self._h_term[g]):
            # term >= id_term(head) must hold or a later election won at a
            # lower term would mint a non-advancing id; voted_for resets
            # with the term, one atomic (term, voted) record.
            self._store_vol(g, snap_term, -1)
            self._h_term[g] = snap_term
            self._h_voted[g] = -1
            self.state = self.state.replace(
                term=set_row(self.state.term, g, snap_term),
                voted_for=set_row(self.state.voted_for, g, -1))
        t, s = snap_term, id_seq(snap_id)
        self.state = self.state.replace(
            head=ids.Bid(set_row(self.state.head.t, g, t),
                         set_row(self.state.head.s, g, s)),
            commit=ids.Bid(set_row(self.state.commit.t, g, t),
                           set_row(self.state.commit.s, g, s)),
        )
        # Activate the row (spare rows are claim-idled — no elections; see
        # migrate_purge_source). CRITICAL that this happens only WITH the
        # snapshot in place: an electable empty spare could win the row at
        # the snapshot's own term and then commit, off adopters' acks,
        # blocks it never carried.
        self.set_group_members(g, None)
        self.set_group_incarnation(g, inc)
        self.flight.emit(self._flight_tick(), "migration_handoff", group=g,
                         snap_id=int(snap_id), inc=inc)

    def migrate_purge_source(self, g: int, inc: int) -> None:
        """Cutover purge of the SOURCE row: exactly a recycle (chain to
        genesis, pending queues and pipelined dispatches all purged — see
        recycle_group) under the new incarnation so the
        dead owner's in-flight traffic is dropped at intake; the freeze
        dies with the row (the dual-ownership window is over) and the
        freed row is the caller's new spare."""
        self.recycle_group(g)
        # Idle the freed row (empty claim: no elections, no traffic) until
        # a future migration adopts into it — a recycled-but-electable
        # spare would mint leader blocks that poison the next adoption.
        self.set_group_members(g, frozenset())
        self.set_group_incarnation(g, inc)
        self._frozen_groups.discard(g)
        self.flight.emit(self._flight_tick(), "migration_cutover", group=g,
                         inc=inc)

    def configure_groups(self, claims: dict[int, frozenset[int] | set[int]]) -> None:
        """Replace ALL data-group claims at once (startup re-wiring from the
        replicated store): groups in ``claims`` get their slot sets, every
        other data row is idled (empty claim — no elections, no traffic).
        One mask rebuild instead of P incremental updates."""
        self._group_claims = {
            g: frozenset(int(s) for s in slots)
            for g, slots in claims.items() if 0 < g < self.P
        }
        for g in range(1, self.P):
            self._group_claims.setdefault(g, frozenset())
        self.member = self._member_mask()

    def register_fsm(self, g: int, fsm: Fsm) -> None:
        """Attach an FSM to a data group at runtime (a topic partition
        claiming its consensus row after EnsurePartition commits, or at
        restart re-wiring). Replays the committed suffix the FSM has not yet
        applied: positioned FSMs (``applied_id()``) resume exactly there;
        snapshot FSMs restore + replay as in __init__; plain FSMs get no
        replay (assumed durable in their own right)."""
        if g == 0:
            raise ValueError("group 0 is the metadata group (constructor-wired)")
        drv = Driver(fsm)
        self.drivers[g] = drv
        ch = self.chains[g]
        applied = getattr(fsm, "applied_id", None)
        if callable(applied):
            if applied() < ch.floor:
                # The FSM lost state below the chain's truncation floor
                # (e.g. an interrupted snapshot restore reset the replica
                # log) — blocks below the floor are gone, so the gap cannot
                # be replayed, and replaying only (floor, committed] would
                # apply batches at wrong base offsets (cluster-divergent
                # data). Reset the whole group to a brand-new replica; the
                # leader re-syncs it from scratch via snapshot install.
                log.warning("g=%d FSM applied %#x below chain floor %#x; "
                            "resetting group for full re-sync",
                            g, applied(), ch.floor)
                self._reset_group(g)
                return
            start = max(applied(), ch.floor)
            if ch.committed > start:
                try:
                    drv.apply(ch.range(start, ch.committed))
                except ReplicaDiverged as e:
                    log.error("g=%d replica diverged during restart replay "
                              "(%s); resetting for full re-sync", g, e)
                    reset_fsm = getattr(fsm, "reset", None)
                    if callable(reset_fsm):
                        # Wipe the replica too: a polluted log left behind
                        # would poison an incremental sync's resume hint.
                        reset_fsm()
                    self._reset_group(g)
                    return
        elif supports_snapshot(fsm) and ch.committed != GENESIS:
            snap_id, snap_data = self._load_snapshot(g)
            start = GENESIS
            if snap_id is not None:
                fsm.restore(snap_data)
                start = snap_id
            else:
                fsm.restore(b"")
            if ch.committed > start:
                drv.apply(ch.range(start, ch.committed))

    def _reset_group(self, g: int, parole: bool = True) -> None:
        """Regress group ``g`` to genesis, chain + device row + snapshot
        record: the node presents as an empty replica and the leader's probe
        (head below its floor) triggers a fresh snapshot install.

        With ``parole=True`` (every path except row recycling, where the
        history is discarded by design), the pre-reset head id is persisted
        as a vote-parole watermark: this node may have ACKED blocks up to
        that head that counted toward a commit quorum, so until its head
        catches back up through legitimate leader replication it must
        abstain from elections entirely — no vote/pre-vote grants (requests
        are dropped at intake) and no candidacy (the election timer is held
        at zero each tick). Without this, a reset voter B plus a behind
        voter C form a quorum that elects an empty leader and erases
        committed history (the Raft-thesis §11.2 disk-loss rule,
        reproduced for the JAX engine by tests/test_reset_safety.py).
        Single-voter groups skip parole: with quorum 1 there is no other
        ack holder to protect, and abstaining would wedge the row forever.
        """
        ch = self.chains[g]
        old_head = ch.head
        voters = self._group_claims.get(g)
        n_voters = (len(voters) if voters is not None
                    else len(self.members.active_slots()))
        if parole and old_head > GENESIS and n_voters > 1:
            # Liveness note: if a MAJORITY of a group's voters end up
            # paroled (multiple independent local-state losses), the group
            # halts — nobody can campaign and parole can only lift through
            # leader replication. That is the deliberate trade: without
            # parole the same scenario silently loses acknowledged records
            # cluster-wide. Operator escape hatch (accepting
            # unclean election): delete the durable ``parole:<g>`` keys.
            self.kv.put(b"parole:%d" % g, old_head.to_bytes(8, "big"))
            self._parole[g] = old_head
            self._pending_msgs = [
                m for m in self._pending_msgs
                if not (m.group == g and m.kind in _PAROLE_DROP_KINDS)]
            # Already-admitted batched election requests must not reach the
            # emptied row either (they passed intake before parole was set).
            self._pending_batches = [
                pb for pb in (
                    b.take(~((b.group == g)
                             & np.isin(b.kind_col, _PAROLE_DROP_ARR)))
                    for b in self._pending_batches)
                if len(pb)]
            _m_paroled.set(len(self._parole), node=self.self_id)
            log.warning("g=%d entering vote parole until head >= %#x",
                        g, old_head)
        self.flight.emit(self._flight_tick(), "group_reset", group=g,
                         term=int(self._h_term[g]), parole=int(bool(
                             parole and old_head > GENESIS and n_voters > 1)),
                         old_head=old_head)
        ch.reset()
        self.kv.delete(b"g%d:snap" % g)
        self._snap_cache.pop(g, None)
        self._drop_group_transfers(g)
        # Open commit-latency entries describe blocks the reset discarded.
        self._lat_open.pop(g, None)
        if self._nxt_fixups:
            # Deferred send-pointer re-roots recorded for this row predate
            # the reset — the reset zeroes the row's nxt below, and a later
            # _drain_nxt_fixups scatter must not resurrect the old pointer.
            self._nxt_fixups = [f for f in self._nxt_fixups if f[0] != g]
        if self._pipeline_h is not None:
            # A dispatch is in flight (pipelined driver): its fetched
            # values for this row were computed from pre-reset state —
            # record the row on the handle so its finish discards them
            # (tick_finish folds skip_rows into _recycled_this_tick).
            self._pipeline_h.setdefault("skip_rows", set()).add(g)
        # INVARIANT: every out-of-tick chain mutation must refresh the
        # _h_head/_h_commit mirrors itself — tick_finish's need-mask skips
        # quiet rows, so it will NOT heal a mirror this site leaves stale
        # (a drifted mirror misroutes the active-row diff forever).
        self._h_head[g] = GENESIS
        self._h_commit[g] = GENESIS
        self._h_role[g] = 0
        self._h_leader[g] = -1
        # Timer mirrors follow the device-row demotion below (elapsed and
        # hb_elapsed zeroed; timeout keeps its old draw), and the recycled
        # row is forced into the next active set — its next step must run
        # through the full step under the new incarnation, not decay.
        self._h_elapsed[g] = 0
        self._h_hb[g] = 0
        if self._active_set:
            self._force_active.add(g)
        # Full device-row demotion, not just head/commit: a row that was
        # leading (or campaigning) before the reset must not keep its role,
        # ballot box, or progress rows — they describe state the chain no
        # longer backs.
        st = self.state
        self.state = st.replace(
            head=ids.Bid(set_row(st.head.t, g, 0), set_row(st.head.s, g, 0)),
            commit=ids.Bid(set_row(st.commit.t, g, 0), set_row(st.commit.s, g, 0)),
            role=set_row(st.role, g, 0),
            leader=set_row(st.leader, g, -1),
            elapsed=set_row(st.elapsed, g, 0),
            hb_elapsed=set_row(st.hb_elapsed, g, 0),
            votes=set_row(st.votes, g, False),
            match=ids.Bid(set_row(st.match.t, g, 0), set_row(st.match.s, g, 0)),
            nxt=ids.Bid(set_row(st.nxt.t, g, 0), set_row(st.nxt.s, g, 0)),
        )

    def _lift_parole(self, g: int) -> None:
        if g in self._parole:
            self.flight.emit(self._flight_tick(), "parole_lifted", group=g)
        self._parole.pop(g, None)
        self.kv.delete(b"parole:%d" % g)
        _m_paroled.set(len(self._parole), node=self.self_id)

    def unregister_fsm(self, g: int) -> None:
        drv = self.drivers.pop(g, None)
        if drv is not None:
            drv.drop_waiters(NotLeader(g, -1))
        self._drop_group_transfers(g)

    # ------------------------------------------------------- conf changes

    def _safe_conf_apply(self, blk) -> ConfChange | None:
        """Decode + apply one committed conf block to the member table.
        Any malformed or invalid payload degrades to a logged no-op — a bad
        *committed* block would otherwise crash every node on every restart
        forever (a poison block)."""
        try:
            change = ConfChange.decode(blk.data)
            self.members.apply(change)
        except (ValueError, KeyError, TypeError) as e:
            log.error("ignoring bad committed conf block %#x: %s", blk.id, e)
            return None
        self.members.store(self.kv)
        return change

    def _scan_conf_pending(self) -> int | None:
        """Find an in-flight (appended, uncommitted) conf block on group 0's
        live branch. Block ids strictly decrease walking parent pointers, so
        the walk is bounded by the commit/floor ids even across forks."""
        ch = self.chains[0]
        pending = None
        cur = ch.head
        while cur > ch.committed and cur > ch.floor:
            blk = ch.get(cur)
            if blk is None:
                break
            if is_conf(blk.data):
                pending = blk.id
            cur = blk.parent
        return pending

    def _apply_conf_block(self, g: int, blk, res: TickResult | None) -> None:
        """Commit-time application of a membership change (deterministic on
        every node: same committed block -> same member table)."""
        if g != 0:
            log.error("conf block committed on group %d ignored (group 0 only)", g)
            return
        change = self._safe_conf_apply(blk)
        if self._conf_pending == blk.id:
            self._conf_pending = None
        fut = self._conf_waiters.pop(blk.id, None)
        if change is None:
            if fut is not None and not fut.done():
                fut.set_exception(ValueError("invalid membership change"))
            return
        self.node_ids = [self.members.id_of(s) for s in range(self.N)]
        self.member = self._member_mask()
        if self.on_conf_applied is not None:
            # App-layer hook (wired by the node, like the partition hooks):
            # e.g. pruning row-drain entries pinned to a removed broker.
            # Runs at commit time on every node — deterministic.
            try:
                self.on_conf_applied(change)
            except Exception:
                log.exception("on_conf_applied hook failed for %s", change)
        if fut is not None and not fut.done():
            fut.set_result(blk.data)
        if res is not None:
            res.conf_changes.append(change)
        else:
            self._conf_notify.append(change)
        log.info("membership: %s node %d (slot %d); active slots now %s",
                 change.op, change.node_id,
                 self.members.slot_of(change.node_id),
                 sorted(self.members.active_slots()))
