"""Packed-IO step functions behind the engine's tick dispatch.

The engine steps ONE node (``me``) of every group. Its step takes one
packed (10, P, N) int32 input (nine message rows plus a proposal-count row)
and returns one flat int32 output holding the (10, P) scalar mirror
(term/voted/role/leader/head/commit/minted/became) followed by the
(9, P, N) outbox, so a tick moves one buffer each way between host and
device. Packed message row order (both directions):
  0=kind 1=term 2=x.t 3=x.s 4=y.t 5=y.s 6=z.t 7=z.s 8=ok
Input row 9: proposal counts in column 0 (the (P,) lane, node-axis-padded).

Two backends share the contract, and the tests hold them and the JAX
package's programs equal byte for byte (``tests/test_torch_packed_step.py``,
``tests/test_torch_sparse_active.py``):

* the batched torch step (``models/chained_raft.node_step`` over one node
  slot, M = 1), on whatever device the engine's state lives;
* the scalar Python oracle (``models/py_step``).

Three IO forms share the step: dense (above), sparse (touched inbox rows
up, changed rows down, compacted on the device into a fixed capacity) and
the active set (only the rows that can change are gathered and stepped;
every other row advances by the closed form of an idle tick).

Multi-tick windows (``ticks > 1``) fold consecutive ticks into one
dispatch: the uploaded inbox applies at tick 1, ticks 2..K run with an
empty inbox, and the outbox is merged last-writer-wins per (group, dst)
slot with replies and span-carrying AEs frozen (see :func:`_merge_outbox`).
The single-tick step IS the window of length 1.

Each window step takes an optional routed inbox plane (9, P, N), merged
under the host-built inbox (:func:`_merge_routed`); the plane programs of
the route fabric, the payload ring and the lease plane follow the window
steps.

This is the JAX package's ``raft/packed_step.py``. Where JAX drops an
out-of-range scatter index (``mode="drop"``) or clamps a gather, the port
sends the index to a dump row that is sliced off, or clamps it: an
out-of-range index never reaches a torch kernel, and no program here makes
the host wait for the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from josefine_tpu_torch.models import chained_raft as cr
from josefine_tpu_torch.models.py_step import _host, decay_idle_np
from josefine_tpu_torch.models.types import (
    CANDIDATE,
    LEADER,
    MSG_APPEND,
    MSG_APPEND_RESP,
    MSG_NONE,
    MSG_PREVOTE_RESP,
    MSG_VOTE_RESP,
    PRECANDIDATE,
    Metrics,
    Msgs,
    NodeState,
)
from josefine_tpu_torch.ops import ids

_I32 = torch.int32


def _node_view(state: NodeState, me: int) -> NodeState:
    """One node's rows out of a (P, N) cluster state: leaves (P,) and (P, N)."""
    return NodeState.from_leaves([a[:, me].clone() for a in state.leaves()])


def _msgs_from_packed(m9) -> Msgs:
    return Msgs(
        kind=m9[0], term=m9[1],
        x=ids.Bid(m9[2], m9[3]), y=ids.Bid(m9[4], m9[5]),
        z=ids.Bid(m9[6], m9[7]), ok=m9[8],
    )


def _flat_outputs(st: NodeState, out: Msgs, met: Metrics) -> torch.Tensor:
    """The single definition of the flat-output row order (both backends):
    the (10, P) scalar mirror followed by the (9, P, N) outbox, int32."""
    sv = torch.stack([
        st.term, st.voted_for, st.role, st.leader,
        st.head.t, st.head.s, st.commit.t, st.commit.s,
        met.minted, met.became_leader.to(_I32),
    ])
    ov = torch.stack([
        out.kind, out.term, out.x.t, out.x.s, out.y.t, out.y.s,
        out.z.t, out.z.s, out.ok,
    ])
    return torch.cat([sv.reshape(-1), ov.reshape(-1)])


def _step_node(params, member, me, state: NodeState, inbox: Msgs, props,
               peer_fresh):
    """``node_step`` over one node slot of every group: the (P,) / (P, N)
    node view gains a slot axis of length 1 for the step and loses it
    after. ``me`` is an int64 (1,) tensor on the state's device."""
    st, out, met = cr.node_step(
        params, member,
        NodeState.from_leaves([a.unsqueeze(1) for a in state.leaves()]),
        Msgs.from_leaves([a.unsqueeze(1) for a in inbox.leaves()]),
        props.unsqueeze(1), peer_fresh, me=me)
    sq = lambda a: a.squeeze(1)
    return (NodeState.from_leaves([sq(a) for a in st.leaves()]),
            Msgs.from_leaves([sq(a) for a in out.leaves()]),
            Metrics.from_leaves([sq(a) for a in met.leaves()]))


def _torch_packed_step(params, member, me, state, in10, peer_fresh=None):
    inbox = _msgs_from_packed(in10)
    st, out, met = _step_node(params, member, me, state, inbox, in10[9, :, 0],
                              peer_fresh)
    return st, _flat_outputs(st, out, met)


def _py_packed_step(params, member, me, state, in10, peer_fresh=None):
    """The scalar host engine behind the same packed-IO contract."""
    return _py_packed_window(params, member, me, state, in10, peer_fresh, 1)


# Multi-tick window. One dispatch folds ``window`` consecutive ticks: the
# uploaded inbox (and queued proposals) applies at tick 1, ticks 2..K run
# with an empty inbox, and the outbox is merged last-writer-wins per
# (group, dst) slot. Dropping the earlier of two same-slot messages is
# message loss in FIFO order, which Raft tolerates; for K <= hb_ticks a
# quiet window produces at most one message per slot, so the merge is also
# lossless in steady state (tick_begin clamps the window to hb_ticks).
# became_leader can only fire at tick 1 (votes arrive only in the uploaded
# inbox); ``minted`` is summed and ``became_leader`` OR-ed across the window.


def _merge_outbox(acc: Msgs, out: Msgs) -> Msgs:
    """Overlay ``out`` on ``acc``, except that a slot already holding a
    REPLY or a SPAN-CARRYING AppendEntries is frozen for the rest of the
    window.

    Replies outrank later broadcasts (the priority node_step applies within
    one tick): without it a follower's tick-1 grant is erased by its own
    later timer broadcast and cold-start elections livelock. Span AEs
    (x != y) freeze against the leader's own later heartbeat, which would
    otherwise erase a NACK repair span every round. Both kinds are only
    generated at tick 1, so a frozen slot loses at most one heartbeat."""
    resp = ((acc.kind == MSG_VOTE_RESP) | (acc.kind == MSG_PREVOTE_RESP)
            | (acc.kind == MSG_APPEND_RESP))
    span_ae = (acc.kind == MSG_APPEND) & ~ids.eq(acc.x, acc.y)
    sel = (out.kind != MSG_NONE) & ~resp & ~span_ae
    return Msgs.from_leaves([torch.where(sel, n, o)
                             for n, o in zip(out.leaves(), acc.leaves())])


def _scan_quiet_ticks(params, member, me, st, out, met, inbox, props,
                      peer_fresh, ticks):
    """Ticks 2..K of a window: empty inbox, zero proposals, outbox merged
    with reply priority, minted summed / became_leader OR-ed. A no-op for
    ticks == 1."""
    zero_inbox = Msgs.from_leaves([torch.zeros_like(a) for a in inbox.leaves()])
    zero_props = torch.zeros_like(props)
    minted, became = met.minted, met.became_leader
    for _ in range(ticks - 1):
        st, o2, m2 = _step_node(params, member, me, st, zero_inbox, zero_props,
                                peer_fresh)
        out = _merge_outbox(out, o2)
        minted = minted + m2.minted
        became = became | m2.became_leader
    return st, out, met.replace(minted=minted, became_leader=became)


@functools.lru_cache(maxsize=None)
def _window_step_fn(ticks: int):
    """Dense-IO window of ``ticks`` ticks (ticks=1 == the packed step).
    Reads its inputs and never writes them: the engine's state leaves may
    still be referenced by an in-flight pipelined finish."""

    def fn(params, member, me, state, in10, peer_fresh, plane=None):
        if plane is not None:
            in10 = _merge_routed(torch, in10, plane)
        inbox = _msgs_from_packed(in10)
        props = in10[9, :, 0]
        st, out, met = _step_node(params, member, me, state, inbox, props,
                                  peer_fresh)
        st, out, met = _scan_quiet_ticks(params, member, me, st, out, met,
                                         inbox, props, peer_fresh, ticks)
        return st, _flat_outputs(st, out, met)

    return fn


def _py_window(params, member, me, state, inbox, props, peer_fresh, ticks):
    """Python-backend window loop: the scalar twin of tick 1 +
    _scan_quiet_ticks, with the same merge semantics."""
    from josefine_tpu_torch.models.py_step import py_node_over_groups

    st, out, met = py_node_over_groups(params, member, me, state, inbox,
                                       props, peer_fresh)
    minted, became = met.minted, met.became_leader
    zero_inbox = Msgs.from_leaves([np.zeros_like(a) for a in inbox.leaves()])
    zero_props = np.zeros_like(props)
    for _ in range(ticks - 1):
        st, o2, m2 = py_node_over_groups(params, member, me, st, zero_inbox,
                                         zero_props, peer_fresh)
        out = _merge_outbox(out, o2)
        minted = minted + m2.minted
        became = became | m2.became_leader
    return st, out, met.replace(minted=minted, became_leader=became)


def _py_packed_window(params, member, me, state, in10, peer_fresh, ticks):
    """Scalar-engine twin of the dense window (ticks=1 == packed step).
    ``in10`` is a numpy (10, P, N) array."""
    in10 = np.asarray(in10)
    st, out, met = _py_window(params, member, me, state,
                              _msgs_from_packed(in10), in10[9, :, 0],
                              peer_fresh, ticks)
    return st, _flat_outputs(st, out, met)


# Sparse packed IO. The dense (10, P, N) inbox upload and (10, P) +
# (9, P, N) outbox fetch scale with P even when almost every group is idle.
# The sparse contract uploads only the touched inbox rows (idx + values,
# padded to a bucket with id P) and fetches only the CHANGED rows,
# compacted on the device into a fixed-capacity buffer: count + row ids +
# row data in one flat int32 array of 1 + k_out + k_out * (10 + 9N). On an
# overflow tick the engine fetches the dense outputs instead (correct, just
# bigger) and grows the capacity.


def _sparse_changed(state: NodeState, st: NodeState, out: Msgs,
                    met: Metrics) -> torch.Tensor:
    """Rows the host must process: any durable/mirrored field moved, a
    block was minted, leadership changed hands, or the outbox has traffic."""
    return ((st.term != state.term) | (st.voted_for != state.voted_for)
            | (st.role != state.role) | (st.leader != state.leader)
            | (st.head.t != state.head.t) | (st.head.s != state.head.s)
            | (st.commit.t != state.commit.t)
            | (st.commit.s != state.commit.s)
            | (met.minted != 0) | met.became_leader
            | (out.kind != MSG_NONE).any(dim=-1))


def _sparse_compact(changed: torch.Tensor, sv: torch.Tensor, ov: torch.Tensor,
                    k_out: int) -> torch.Tensor:
    """Compact the changed rows into the flat ``[total, ids(k_out),
    rows(k_out, 10 + 9N)]`` buffer, in row order. Unchanged rows, and
    changed rows past the capacity on an overflow tick, are written to dump
    row ``k_out``, which is sliced off: the sizes are fixed, so nothing
    here waits for the device."""
    P, N = sv.shape[1], ov.shape[2]
    dev = sv.device
    cnt = torch.cumsum(changed, 0, dtype=_I32)
    pos = torch.where(changed & (cnt <= k_out), cnt - 1, k_out).long()
    rows = torch.cat([sv.T, ov.permute(1, 0, 2).reshape(P, 9 * N)], dim=1)
    buf = torch.zeros((k_out + 1, 10 + 9 * N), dtype=_I32, device=dev).index_put(
        (pos,), rows)
    idx_out = torch.zeros(k_out + 1, dtype=_I32, device=dev).index_put(
        (pos,), torch.arange(P, dtype=_I32, device=dev))
    return torch.cat([cnt[-1:], idx_out[:k_out], buf[:k_out].reshape(-1)])


def _sparse_outputs(state, st, out, met, k_out):
    """Shared sparse epilogue (both backends): scalar-mirror + outbox
    stacks, the changed-row predicate, and the fixed-capacity compaction.
    Returns (flat, sv, ov), sv/ov dense for the overflow fetch."""
    sv = torch.stack([
        st.term, st.voted_for, st.role, st.leader,
        st.head.t, st.head.s, st.commit.t, st.commit.s,
        met.minted, met.became_leader.to(_I32),
    ])
    ov = torch.stack([
        out.kind, out.term, out.x.t, out.x.s, out.y.t, out.y.s,
        out.z.t, out.z.s, out.ok,
    ])
    changed = _sparse_changed(state, st, out, met)
    return _sparse_compact(changed, sv, ov, k_out), sv, ov


@functools.lru_cache(maxsize=None)
def _sparse_window_fn(k_out: int, ticks: int):
    """Sparse-IO window (ticks=1 == the sparse packed step). ``idx`` (K,)
    are the touched group rows, padded with P; ``vals`` their (10, K, N)
    packed inbox rows. The scatter writes a fresh (10, P + 1, N) buffer
    whose last row takes the padding. A routed ``plane`` is dense-addressed,
    so routed rows never join the upload."""

    def fn(params, member, me, state, peer_fresh, idx, vals, plane=None):
        P, N = member.shape
        in10 = torch.zeros((10, P + 1, N), dtype=_I32, device=member.device)
        in10[:, idx.long(), :] = vals
        in10 = in10[:, :P]
        if plane is not None:
            in10 = _merge_routed(torch, in10, plane)
        inbox = _msgs_from_packed(in10)
        props = in10[9, :, 0]
        st, out, met = _step_node(params, member, me, state, inbox, props,
                                  peer_fresh)
        st, out, met = _scan_quiet_ticks(params, member, me, st, out, met,
                                         inbox, props, peer_fresh, ticks)
        flat, sv, ov = _sparse_outputs(state, st, out, met, k_out)
        return st, flat, sv, ov

    return fn


def _py_sparse_window(k_out, params, member, me, state, peer_fresh, idx, vals,
                      ticks, routed=None):
    """Scalar-engine twin of the sparse window (ticks=1 == sparse step).
    ``peer_fresh``, ``idx``, ``vals`` and the routed plane ``routed`` are
    numpy arrays (the python backend's fabric scatters on the host)."""
    P, N = member.shape
    in10 = np.zeros((10, P, N), np.int32)
    idx = np.asarray(idx)
    sel = idx < P
    in10[:, idx[sel], :] = np.asarray(vals)[:, sel, :]
    if routed is not None:
        in10 = _merge_routed(np, in10, routed)
    st, out, met = _py_window(params, member, me, state,
                              _msgs_from_packed(in10), in10[9, :, 0],
                              peer_fresh, ticks)
    flat, sv, ov = _sparse_outputs(state, st, out, met, k_out)
    return st, flat, sv, ov


# Device-resident delivery between co-located engines (the in-process
# cluster: one device, one engine per node slot). The sender's outbox row
# (nine fields) IS the receiver's inbox row, so the RouteFabric
# (raft/route.py) scatters payload-free rows straight from the sender's
# device step output into the receiver's staged (9, P, N) inbox plane, and
# the receiver's next dispatch merges the plane under its host-built
# residual inbox (the ``plane`` argument of the window steps). A routed slot
# wins its (group, src) cell: the host builders defer any colliding claim.
# Row 9 (proposal counts) is host-only. The payload ring (raft/payload_ring
# .py) is each sender's bounded (P, S, W) int32 buffer of recent block
# payloads, written at the fabric's flush barrier and read there once per
# routed span set. The lease plane is a (P, 3) int64 mirror that no step
# reads.
#
# The JAX programs pad their index vectors to a bucket ladder
# (``route_bucket``, ``ring_bucket``) so that XLA compiles a bounded number
# of shapes, and drop the padding ids. Eager torch compiles nothing, so the
# port uploads exactly the rows it writes: every index is in range. Each
# scatter's indices are unique (one row per group per sender and receiver,
# the ring's last-writer dedup, changed lease rows): a scatter with repeated
# indices has no defined winner on the card. These programs write in place,
# only into planes and buffers that no dispatch has read yet (see route.py).
# Every one takes numpy arrays as well, for the python backend.


def _merge_routed(xp, in10, plane):
    """Overlay a routed inbox plane (9, ..., N) under a host-built packed
    input (10, ..., N): routed-claimed slots take the routed row, every
    other slot keeps the host value, proposal row 9 is host-only. ``xp`` is
    ``torch`` or ``numpy``."""
    merged = xp.where(plane[0:1] != 0, plane, in10[:9])
    return xp.concatenate([merged, in10[9:10]], axis=0)


def _gather_routed(plane, idx):
    """Compact a dense routed plane onto the active-set bucket rows:
    padding entries (id P) clamp for the gather and are masked to zero, so
    a padding row never steps a phantom copy of row P-1's inbox."""
    P = plane.shape[1]
    rows = plane[:, idx.clip(max=P - 1), :]
    return rows * (idx < P)[None, :, None]


def _route_scatter(plane, src_ov, srows, gids, dst: int, me: int):
    """``plane[:, gids, me] = src_ov[:, srows, dst]`` in place: routed
    outbox rows of one sender toward one receiver, device to device.
    ``src_ov`` is the sender's (9, R, N) step outbox (dense, sparse or
    active-compact), ``srows`` its rows, ``gids`` the groups (unique),
    ``dst`` the receiver's outbox column and ``me`` the sender's inbox
    column in the receiver's plane."""
    plane[:, gids, me] = src_ov[:, srows, dst]
    return plane


def _route_scatter_vals(plane, vals, gids, me: int):
    """``plane[:, gids, me] = vals`` in place, for host-built (9, k) rows:
    AppendEntries capped at ``max_append_entries``, whose y/z carry the
    capped top instead of the device outbox's claim."""
    plane[:, gids, me] = vals
    return plane


def _merge_planes_fn(ready, staging):
    """First-writer-wins overlay of a not-yet-consumed ready plane over a
    newly staged one (two flushes without a consuming tick_begin): the
    earlier claim keeps its slot, the later one is dropped (message loss in
    FIFO order, which Raft tolerates)."""
    return torch.where(ready[0:1] != 0, ready, staging)


def _purge_plane_row_fn(plane, g: int, cols):
    """Zero group ``g``'s routed slots in the source columns ``cols``, in
    place: the device half of the host's pending-queue purge on group reset
    or recycle (route.py keeps the kind mirror in lockstep)."""
    plane[:, g, cols] = 0
    return plane


def _ring_scatter(buf, gids, slots, words):
    """Write staged block payloads into a sender's (P, S, W) payload ring in
    place: ``words`` (n, W) into slot ``slots`` of group ``gids``, every
    (group, slot) pair unique."""
    buf[gids, slots] = words
    return buf


def _ring_gather(buf, gids, slots):
    """Read the (n, W) payload words of a routed span set out of a sender's
    payload ring."""
    return buf[gids, slots]


def _lease_plane_scatter_fn(plane, idx, vals):
    """Refresh changed rows of the (P, 3) device lease mirror [holder,
    expiry tick, granted term] (raft/lease.py) in place: ``idx`` the
    changed rows (unique), ``vals`` their (n, 3) int64 values. No step
    reads this plane, which keeps leases-on step programs identical to
    leases-off."""
    plane[idx] = vals
    return plane


# Active-set stepping. Sparse IO shrinks the transfers but still steps all
# P rows. The active set moves the frontier into the step: the host
# scheduler (engine._schedule_active, predicate host_wake_mask below)
# proves which rows can change this window, gathers exactly those into a
# power-of-two bucket, steps the bucket through the SAME window step as the
# dense path, and scatters the results back while every quiescent row
# advances through chained_raft.decay_idle, the closed form of an idle
# tick. The compact mirror carries 13 rows (the dense 10 plus
# elapsed/timeout/hb_elapsed) so the host's timer mirrors stay exact
# without extra fetches.

# Compact-mirror row order: the dense _flat_outputs 10 plus the three
# timer rows the scheduler mirrors host-side.
_MIRROR13_ROWS = 13


def active_bucket(n: int, P: int) -> int:
    """Smallest power-of-two bucket >= n (floor 64, clamped to P). The
    bucket sets the compact step's shape and the flat output's layout."""
    b = 64
    while b < n:
        b *= 2
    return min(b, P) if P >= 64 else P


def host_wake_mask(hb_ticks: int, role, leader, elapsed, timeout, hb_elapsed,
                   alive, my_member, peer_fresh, window: int) -> np.ndarray:
    """The active-set wake predicate over the engine's host mirrors: rows
    where a ``window``-tick dispatch could do anything beyond
    :func:`chained_raft.decay_idle`'s timer arithmetic. Everything here is
    host data — no device sync on the scheduling path.

    * election-timer horizon (alive member non-leaders): with the
      aggregate keepalive holding (``ka`` — leader known, its node fresh
      this dispatch, hb-staleness bound not reachable within the window)
      the timer is pinned at 0 and cannot fire, but the row must wake if
      the hold could LAPSE mid-window (``hb_elapsed + window - 1`` crosses
      ``hb_ticks * 8``); without the hold it wakes when
      ``elapsed + window >= timeout`` — i.e. exactly the tick(s) the dense
      step would reach candidacy, never later (tick-exact elections);
    * heartbeat horizon (alive leaders, member or not — a non-member
      leader's hb cadence still cycles on device): wakes when
      ``hb_elapsed + window - 1 >= hb_ticks``, the first tick hb_due can
      fire;
    * role: candidates/pre-candidates (awaiting responses/redraws) and
      leaderless member rows (campaign pressure) are always awake — the
      cheap, conservative half of the predicate family.

    The engine unions in the host-known sources on top of this mask:
    pending inbox rows, queued proposals, force-woken rows (recycle/reset,
    snapshot install, nxt fixups, membership-mask changes), and — under
    tick_pipelined — rows dispatched but not yet adopted
    (``_sched_pending``). There is deliberately NO "changed last tick"
    carry: a quiescent leader's send pointers already equal its head
    (node_step advances nxt optimistically on every AE send), and the one
    case that breaks that — an AE-cap re-root putting nxt < head — is
    force-woken via ``_drain_nxt_fixups``. Changing either mechanism
    (AE resend policy, optimistic nxt advance) invalidates the predicate's
    never-later-than-dense guarantee and needs a new wake source here.
    """
    N = len(peer_fresh)
    nonlead = role != LEADER
    hb8 = hb_ticks * 8
    ka = ((leader >= 0)
          & (np.asarray(peer_fresh)[np.clip(leader, 0, N - 1)] != 0)
          & (hb_elapsed < hb8))
    wake_e = alive & my_member & nonlead & np.where(
        ka, hb_elapsed + window - 1 >= hb8, elapsed + window >= timeout)
    wake_hb = alive & ~nonlead & (hb_elapsed + window - 1 >= hb_ticks)
    wake_role = alive & ((role == CANDIDATE) | (role == PRECANDIDATE)
                         | ((leader < 0) & my_member))
    return wake_e | wake_hb | wake_role


def _active_outputs(st: NodeState, out: Msgs, met: Metrics) -> torch.Tensor:
    """Compact-step flat output: the (13, A) mirror (dense 10 + elapsed/
    timeout/hb_elapsed) followed by the (9, A, N) outbox, one fetch."""
    sv = torch.stack([
        st.term, st.voted_for, st.role, st.leader,
        st.head.t, st.head.s, st.commit.t, st.commit.s,
        met.minted, met.became_leader.to(_I32),
        st.elapsed, st.timeout, st.hb_elapsed,
    ])
    ov = torch.stack([
        out.kind, out.term, out.x.t, out.x.s, out.y.t, out.y.s,
        out.z.t, out.z.s, out.ok,
    ])
    return torch.cat([sv.reshape(-1), ov.reshape(-1)])


def _gather_active(state: NodeState, member: torch.Tensor, idx: torch.Tensor):
    """Gather the active rows (bucketed ``idx``; padding entries carry id P
    and clamp to row P-1 — their stepped results are dropped at scatter)."""
    cidx = idx.long().clamp(max=member.shape[0] - 1)
    return NodeState.from_leaves([a[cidx] for a in state.leaves()]), member[cidx]


@functools.lru_cache(maxsize=None)
def _active_window_fn(ticks: int):
    """Compact-domain window step: the SAME tick-1 + quiet-ticks pipeline
    as _window_step_fn, over the gathered (A, ...) rows, returning the
    13-row mirror + outbox flat. A routed ``plane`` is gathered onto the
    bucket rows ``idx`` and merged under the compact inbox (the scheduler
    wakes every routed row, so the gather loses no routed slot)."""

    def fn(params, member_c, me, state_c, in10_c, peer_fresh, plane=None,
           idx=None):
        if plane is not None:
            in10_c = _merge_routed(torch, in10_c, _gather_routed(plane, idx))
        inbox = _msgs_from_packed(in10_c)
        props = in10_c[9, :, 0]
        st, out, met = _step_node(params, member_c, me, state_c, inbox,
                                  props, peer_fresh)
        st, out, met = _scan_quiet_ticks(params, member_c, me, st, out, met,
                                         inbox, props, peer_fresh, ticks)
        return st, _active_outputs(st, out, met)

    return fn


def _scatter_rows(full: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """``full[idx] = rows`` on a new tensor, where ids equal to P (the
    bucket's padding) land in a dump row that is sliced off."""
    P = full.shape[0]
    return torch.cat([full, full[:1]]).index_put((idx,), rows)[:P]


@functools.lru_cache(maxsize=None)
def _decay_scatter_fn(ticks: int):
    """Quiescent-row decay + active-row scatter-back: advance every row's
    timers by the idle closed form (garbage for active rows — overwritten
    by the scatter, which drops the bucket's padding ids)."""

    def fn(params, state, peer_fresh, idx, new_rows):
        st = cr.decay_idle(params, state, peer_fresh, ticks)
        idx = idx.long()
        return NodeState.from_leaves([_scatter_rows(f, idx, r) for f, r in
                                      zip(st.leaves(), new_rows.leaves())])

    return fn


@functools.lru_cache(maxsize=None)
def _decay_only_fn(ticks: int):
    """Fully idle tick (empty active set): decay is the whole device step."""

    def fn(params, state, peer_fresh):
        return cr.decay_idle(params, state, peer_fresh, ticks)

    return fn


def _py_gather_active(state: NodeState, member, idx):
    """Scalar-engine twin of _gather_active: numpy leaves, padding clamped."""
    member_np = _host(member)
    cidx = np.minimum(np.asarray(idx), member_np.shape[0] - 1)
    return (NodeState.from_leaves([_host(a)[cidx] for a in state.leaves()]),
            member_np[cidx])


def _py_active_window(params, member_c, me, state_c, in10_c, peer_fresh,
                      ticks):
    """Scalar-engine twin of the compact window step."""
    in10_c = np.asarray(in10_c)
    st, out, met = _py_window(params, member_c, me, state_c,
                              _msgs_from_packed(in10_c), in10_c[9, :, 0],
                              peer_fresh, ticks)
    return st, _active_outputs(st, out, met)


def _py_decay_scatter(params, state: NodeState, peer_fresh, idx, new_rows,
                      ticks) -> NodeState:
    """Scalar-engine twin of _decay_scatter_fn (``idx`` None: of
    _decay_only_fn). The decay runs in numpy (``decay_idle_np``); the
    result's tensors are built on the device of ``state``."""
    hb_ticks = params.ints()[2]
    leaves = [_host(a) for a in state.leaves()]
    st = decay_idle_np(hb_ticks, NodeState.from_leaves(leaves),
                       None if peer_fresh is None else np.asarray(peer_fresh),
                       ticks)
    out = st.leaves()
    if idx is not None:
        idx = np.asarray(idx)
        sel = idx < len(leaves[0])
        for full, rows in zip(out, new_rows.leaves()):
            full[idx[sel]] = _host(rows)[sel]
    dev = state.term.device
    return NodeState.from_leaves([torch.as_tensor(a, device=dev) for a in out])
