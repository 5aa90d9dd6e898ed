"""Packed-IO step functions behind the engine's tick dispatch (dense IO).

The engine steps ONE node (``me``) of every group. Its step takes one
packed (10, P, N) int32 input (nine message rows plus a proposal-count row)
and returns one flat int32 output holding the (10, P) scalar mirror
(term/voted/role/leader/head/commit/minted/became) followed by the
(9, P, N) outbox, so a tick moves one buffer each way between host and
device. Packed message row order (both directions):
  0=kind 1=term 2=x.t 3=x.s 4=y.t 5=y.s 6=z.t 7=z.s 8=ok
Input row 9: proposal counts in column 0 (the (P,) lane, node-axis-padded).

Two backends share the contract, and the tests hold them and the JAX
package's programs equal byte for byte (``tests/test_torch_packed_step.py``):

* the batched torch step (``models/chained_raft.node_step`` over one node
  slot, M = 1), on whatever device the engine's state lives;
* the scalar Python oracle (``models/py_step``).

Multi-tick windows (``ticks > 1``) fold consecutive ticks into one
dispatch: the uploaded inbox applies at tick 1, ticks 2..K run with an
empty inbox, and the outbox is merged last-writer-wins per (group, dst)
slot with replies and span-carrying AEs frozen (see :func:`_merge_outbox`).
The single-tick step IS the window of length 1.

This is the dense half of the JAX package's ``raft/packed_step.py``. Its
sparse-IO, routed and active-set programs are not ported yet (ROADMAP
Queue 1 item 5).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from josefine_tpu_torch.models import chained_raft as cr
from josefine_tpu_torch.models.types import (
    MSG_APPEND,
    MSG_APPEND_RESP,
    MSG_NONE,
    MSG_PREVOTE_RESP,
    MSG_VOTE_RESP,
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

    def fn(params, member, me, state, in10, peer_fresh):
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
