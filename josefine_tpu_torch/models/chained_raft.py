"""Batched Chained-Raft in plain PyTorch: the consensus step over (P, N).

One call to :func:`cluster_step` advances every node of every partition's
Raft group by one tick, in lockstep. Messages produced at tick t are
delivered at tick t+1: the inbox/outbox tensors are the network and delivery
is the (dst, src) transpose.

:func:`node_step` is the JAX package's ``node_step`` (and its hand-vectorized
Pallas twin ``_tile_step``) written out over the (P, N) batch by hand, in
``_tile_step``'s statement order: scalar-per-node state is a (P, N) plane,
per-peer rows are (P, N, N) bricks ``[p, me, peer]``, and the inbox is
``[p, dst, src]``. The inbox fold is sequential over src: src k reads state
already updated by srcs < k. This module is also the plain version of the
fused-window CUDA kernel (``ops/fused_step.py``), and it is held integer for
integer against the JAX package by ``tests/test_torch_chained_raft.py``.
"""

from __future__ import annotations

import torch

from josefine_tpu_torch.models.types import (
    CANDIDATE,
    FOLLOWER,
    LEADER,
    MSG_APPEND,
    MSG_APPEND_RESP,
    MSG_NONE,
    MSG_PREVOTE_REQ,
    MSG_PREVOTE_RESP,
    MSG_VOTE_REQ,
    MSG_VOTE_RESP,
    PRECANDIDATE,
    METRIC_FIELDS,
    Metrics,
    Msgs,
    NodeState,
    StepParams,
    empty_msgs,
    resolve_device,
    step_params,
)
from josefine_tpu_torch.ops import ids

_I32 = torch.int32


def _draw_timeout(seed, term, params: StepParams) -> torch.Tensor:
    """Randomized election timeout in ticks, decorrelated per (node, term).

    ``seed`` and ``term`` are read as their uint32 bit patterns (an int64
    ``term`` carries an already-wrapped 32-bit mix)."""
    h = ids.hash32(ids.u32(seed) ^ ids.mul32(ids.u32(term), 0x9E3779B9))
    span = ids.u32(params.timeout_max - params.timeout_min + 1)
    return ids.to_i32(params.timeout_min.to(torch.int64) + h % span)


def _redraw_mix(term: torch.Tensor, timeout: torch.Tensor) -> torch.Tensor:
    """``(term + 1) ^ (timeout << 8)`` wrapped as jnp int32 wraps, as its
    uint32 bit pattern in int64: the term fed to a timed-out node's redraw."""
    return ((ids.u32(term) + 1) ^ (ids.u32(timeout) << 8)) & ids.U32_MASK


def _i32(x) -> torch.Tensor:
    return x.to(_I32)


def _set_col(x: torch.Tensor, k: int, v: torch.Tensor) -> torch.Tensor:
    """``x[..., k] = v`` on a copy (the caller's tensors are never written)."""
    y = x.clone()
    y[..., k] = v
    return y


def _set_col_bid(b: ids.Bid, k: int, v: ids.Bid) -> ids.Bid:
    return ids.Bid(t=_set_col(b.t, k, v.t), s=_set_col(b.s, k, v.s))


def _freeze(alive: torch.Tensor, new: NodeState, old: NodeState) -> NodeState:
    """Per-leaf ``where(alive, new, old)``; (P, N, N) leaves broadcast alive
    over the peer axis."""
    leaves = [torch.where(alive if a.dim() == alive.dim() else alive[..., None], a, b)
              for a, b in zip(new.leaves(), old.leaves())]
    return NodeState.from_leaves(leaves)


def _peer_fresh(peer_fresh, N: int, device) -> torch.Tensor:
    return torch.as_tensor(peer_fresh, device=device).reshape(N).to(_I32)


def node_step(params: StepParams, member: torch.Tensor, state: NodeState,
              inbox: Msgs, proposals: torch.Tensor, peer_fresh=None, me=None):
    """One tick of M node slots of P groups: inbox fold -> timers -> election
    tally -> proposal minting -> quorum commit -> outbox.

    ``member`` bool (P, N). ``me`` is an optional int64 (M,) tensor of the
    node slots being stepped; None steps every slot (M = N, ``me`` =
    ``arange(N)``), which is the whole-cluster step. State leaves are
    (P, M) / (P, M, N); ``inbox`` leaves (P, M, N_src); ``proposals`` int32
    (P, M); ``peer_fresh`` an optional [N] 0/1 vector of node-slot transport
    liveness (the aggregate keepalive), broadcast over P. Returns (state',
    outbox, metrics) with the outbox indexed ``[p, me, dst]`` (the sender's
    row). The engine steps one node of every group: M = 1.
    """
    P, N = member.shape
    dev = member.device
    st_in = st = state
    M = st.role.shape[1]
    commit_s0 = st.commit.s
    slots = torch.arange(N, dtype=_I32, device=dev)     # (N,) over the node axis
    if me is None:
        me_i, my_member = slots, member
    else:
        me_i, my_member = me.to(_I32), member[:, me]    # (M,) slot ids, (P, M)
    eye = me_i[:, None] == slots[None, :]               # (M, N) [me, peer]
    alive = st.alive
    member3 = member[:, None, :]                        # (P, 1, N_peer)

    # ---- 1. inbox fold (sequential over srcs) ----
    rep_kind, rep_term, rep_xt, rep_xs, rep_ok = [], [], [], [], []
    acc_blocks = torch.zeros((P, M), dtype=_I32, device=dev)
    acc_msgs = torch.zeros((P, M), dtype=_I32, device=dev)
    for src in range(N):
        kind = inbox.kind[:, :, src]
        mterm = inbox.term[:, :, src]
        mx = ids.Bid(inbox.x.t[:, :, src], inbox.x.s[:, :, src])
        my = ids.Bid(inbox.y.t[:, :, src], inbox.y.s[:, :, src])
        mz = ids.Bid(inbox.z.t[:, :, src], inbox.z.s[:, :, src])
        mok = inbox.ok[:, :, src]

        # Messages from non-member slots are masked out (runtime membership).
        valid = (kind != MSG_NONE) & alive & member[:, src:src + 1]
        # Leader-lease stickiness (pre-vote mode), from pre-adoption state.
        sticky = ((params.prevote == 1) & (st.leader != -1)
                  & (st.elapsed < params.timeout_min))
        # Universal term catch-up, strictly greater only. PREVOTE_REQ never
        # adopts; leased voters ignore VOTE_REQ terms.
        higher = (valid & (mterm > st.term) & (kind != MSG_PREVOTE_REQ)
                  & ~(sticky & (kind == MSG_VOTE_REQ)))
        new_term = torch.where(higher, mterm, st.term)
        st = st.replace(
            term=new_term,
            role=torch.where(higher, FOLLOWER, st.role),
            voted_for=torch.where(higher, -1, st.voted_for),
            leader=torch.where(higher, -1, st.leader),
            elapsed=torch.where(higher, 0, st.elapsed),
            timeout=torch.where(higher, _draw_timeout(st.seed, new_term, params),
                                st.timeout),
            votes=torch.where(higher[..., None], False, st.votes),
        )
        cur = valid & (mterm == st.term)

        # VoteRequest (with the log up-to-dateness check).
        is_vr = valid & (kind == MSG_VOTE_REQ)
        grant = (cur & (kind == MSG_VOTE_REQ) & (st.role == FOLLOWER)
                 & ((st.voted_for == -1) | (st.voted_for == src))
                 & ids.ge(mx, st.head) & ~sticky)
        st = st.replace(
            voted_for=torch.where(grant, src, st.voted_for),
            elapsed=torch.where(grant, 0, st.elapsed),
        )

        # PreVoteRequest: would we grant at the proposed term? No state moves.
        is_pvr = valid & (kind == MSG_PREVOTE_REQ)
        pv_grant = is_pvr & (mterm > st.term) & ids.ge(mx, st.head) & ~sticky

        # VoteResponse / PreVoteResponse tally into the same ballot row.
        is_vresp = cur & (kind == MSG_VOTE_RESP) & (st.role == CANDIDATE)
        is_pvresp = valid & (kind == MSG_PREVOTE_RESP) & (st.role == PRECANDIDATE)
        got_vote = (is_vresp | is_pvresp) & (mok == 1)
        st = st.replace(votes=_set_col(st.votes, src, st.votes[..., src] | got_vote))

        # AppendEntries / heartbeat.
        is_ae_kind = valid & (kind == MSG_APPEND)
        is_ae = is_ae_kind & cur
        st = st.replace(
            role=torch.where(is_ae, FOLLOWER, st.role),
            leader=torch.where(is_ae, src, st.leader),
            elapsed=torch.where(is_ae, 0, st.elapsed),
            hb_elapsed=torch.where(is_ae, 0, st.hb_elapsed),
        )
        # Accept a span rooted at our head, or at our commit pointer when the
        # offered head is at least ours (dead-branch abandonment).
        accept = is_ae & (ids.eq(mx, st.head)
                          | (ids.eq(mx, st.commit) & ids.ge(my, st.head)))
        old_head_s = st.head.s
        new_head = ids.where(accept, my, st.head)
        new_commit = ids.where(accept, ids.max_(st.commit, ids.min_(mz, new_head)),
                               st.commit)
        span = torch.where(accept, torch.clamp_min(my.s - old_head_s, 0), 0)
        st = st.replace(head=new_head, commit=new_commit)

        # AppendResponse -> progress advance (reject re-roots nxt at the hint).
        is_ar = cur & (kind == MSG_APPEND_RESP) & (st.role == LEADER)
        ok = mok == 1
        mi = ids.index(st.match, src)
        ni = ids.index(st.nxt, src)
        st = st.replace(
            match=_set_col_bid(st.match, src,
                               ids.where(is_ar & ok, ids.max_(mi, mx), mi)),
            nxt=_set_col_bid(st.nxt, src,
                             ids.where(is_ar, ids.where(ok, ids.max_(ni, mx), mx), ni)),
        )

        # Reply to src (responses only; y and z stay zero).
        rep_kind.append(torch.where(is_vr, MSG_VOTE_RESP,
                                    torch.where(is_ae_kind, MSG_APPEND_RESP,
                                                torch.where(is_pvr, MSG_PREVOTE_RESP,
                                                            MSG_NONE))))
        rep_term.append(st.term)
        rep_x = ids.where(accept, st.head, st.commit)
        rep_xt.append(rep_x.t)
        rep_xs.append(rep_x.s)
        rep_ok.append(grant | accept | pv_grant)
        acc_blocks = acc_blocks + span
        acc_msgs = acc_msgs + accept.to(_I32)

    # Replies as (P, M, N_dst) bricks: the reply to src rides lane dst=src.
    r_kind = _i32(torch.stack(rep_kind, -1))
    r_term = torch.stack(rep_term, -1)
    r_x = ids.Bid(torch.stack(rep_xt, -1), torch.stack(rep_xs, -1))
    r_ok = _i32(torch.stack(rep_ok, -1))

    # ---- 2. timers: election timeout -> (pre-)candidacy ----
    pv = params.prevote == 1
    is_leader = st.role == LEADER
    elapsed = torch.where(is_leader, 0, st.elapsed + 1)
    if peer_fresh is not None:
        # Aggregate keepalive: a fresh leader NODE stands in for a per-group
        # heartbeat while its last AE for this group is within 8 intervals.
        pf = _peer_fresh(peer_fresh, N, dev)
        pf_l = pf[st.leader.clamp(0, N - 1).long()]
        ka = ((st.leader >= 0) & (pf_l != 0)
              & (st.hb_elapsed < params.hb_ticks * 8))
        elapsed = torch.where(ka, 0, elapsed)
    timed_out = alive & my_member & ~is_leader & (elapsed >= st.timeout)
    # The redraw folds in the previous timeout (decorrelates stalled pre-vote
    # rounds).
    mix = _redraw_mix(st.term, st.timeout)
    st = st.replace(
        term=torch.where(timed_out & ~pv, st.term + 1, st.term),
        elapsed=torch.where(timed_out, 0, elapsed),
        role=torch.where(timed_out, _i32(torch.where(pv, PRECANDIDATE, CANDIDATE)),
                         st.role),
        voted_for=torch.where(timed_out & ~pv, me_i, st.voted_for),
        leader=torch.where(timed_out, -1, st.leader),
        votes=torch.where(timed_out[..., None], eye, st.votes),
        timeout=torch.where(timed_out, _draw_timeout(st.seed, mix, params), st.timeout),
    )
    just_cand = timed_out & ~pv
    just_precand = timed_out & pv

    # ---- 3. election tally (pre-vote promotion first) ----
    quorum = member.sum(-1, keepdim=True) // 2 + 1           # (P, 1)
    nvotes = (st.votes & member3).sum(-1)
    pre_elected = alive & (st.role == PRECANDIDATE) & (nvotes >= quorum)
    st = st.replace(
        role=torch.where(pre_elected, CANDIDATE, st.role),
        term=torch.where(pre_elected, st.term + 1, st.term),
        voted_for=torch.where(pre_elected, me_i, st.voted_for),
        votes=torch.where(pre_elected[..., None], eye, st.votes),
        elapsed=torch.where(pre_elected, 0, st.elapsed),
        timeout=torch.where(pre_elected, _draw_timeout(st.seed, st.term + 1, params),
                            st.timeout),
    )
    nvotes = (st.votes & member3).sum(-1)
    elected = alive & (st.role == CANDIDATE) & (nvotes >= quorum)
    # Mint a no-op block at the new term (commit-liveness fix).
    head_after = ids.where(elected, ids.Bid(st.term, st.head.s + 1), st.head)
    head3 = ids.Bid(head_after.t[..., None], head_after.s[..., None])
    commit3 = ids.Bid(st.commit.t[..., None], st.commit.s[..., None])
    PMN = (P, M, N)
    zero3 = ids.full(PMN, device=dev)
    # Fresh progress rows: match = genesis for peers, nxt = our commit; the
    # self entries track our own head.
    fresh_match = ids.where(eye, ids.broadcast_to(head3, PMN), zero3)
    fresh_nxt = ids.where(eye, ids.broadcast_to(head3, PMN),
                          ids.broadcast_to(commit3, PMN))
    el3 = elected[..., None]
    st = st.replace(
        role=torch.where(elected, LEADER, st.role),
        leader=torch.where(elected, me_i, st.leader),
        head=head_after,
        match=ids.where(el3, fresh_match, st.match),
        nxt=ids.where(el3, fresh_nxt, st.nxt),
        hb_elapsed=torch.where(elected, params.hb_ticks, st.hb_elapsed),
    )

    # ---- 4. proposal minting + self progress row ----
    is_leader = st.role == LEADER
    minted = torch.where(is_leader & alive, proposals + params.auto_proposals, 0)
    st = st.replace(head=ids.Bid(t=torch.where(minted > 0, st.term, st.head.t),
                                 s=st.head.s + minted))
    head3 = ids.broadcast_to(ids.Bid(st.head.t[..., None], st.head.s[..., None]), PMN)
    sv_lead = eye & is_leader[..., None]
    st = st.replace(match=ids.where(sv_lead, head3, st.match),
                    nxt=ids.where(sv_lead, head3, st.nxt))

    # ---- 5. quorum commit: k-th largest match (k = quorum) ----
    mt, ms = st.match.t, st.match.s                           # (P, M, N_i)
    ge_mat = ((mt[..., None, :] > mt[..., :, None])
              | ((mt[..., None, :] == mt[..., :, None])
                 & (ms[..., None, :] >= ms[..., :, None])))  # [p, me, i, j]: match[j] >= match[i]
    support = (ge_mat & member[:, None, None, :]).sum(-1)    # (P, M, N_i)
    eligible = member3 & (support >= quorum[..., None])
    best = ids.full((P, M), -1, -1, device=dev)
    for i in range(N):
        cand = ids.index(st.match, i)
        take = eligible[..., i] & ids.gt(cand, best)
        best = ids.where(take, cand, best)
    advance = is_leader & alive & (best.t == st.term) & ids.gt(best, st.commit)
    st = st.replace(commit=ids.where(advance, best, st.commit))

    # ---- 6. outbox ----
    is_peer = member3 & ~eye                                  # (P, M, N_dst)
    hb_due = st.hb_elapsed >= params.hb_ticks
    send_ae = ((is_leader & alive & my_member)[..., None] & is_peer
               & (hb_due[..., None] | ids.lt(st.nxt, head3)))
    st = st.replace(hb_elapsed=torch.where(
        is_leader, torch.where(hb_due, 1, st.hb_elapsed + 1), st.hb_elapsed + 1))
    bc_vr = ((just_cand | pre_elected) & alive & ~is_leader)[..., None] & is_peer
    # A pending reply outranks our own pre-vote broadcast on that lane.
    bc_pvr = ((just_precand & alive & ~is_leader)[..., None] & is_peer & ~bc_vr
              & (r_kind == MSG_NONE))

    commit3 = ids.broadcast_to(ids.Bid(st.commit.t[..., None], st.commit.s[..., None]), PMN)
    term3 = st.term[..., None].expand(PMN)
    kind = torch.where(send_ae, MSG_APPEND,
                       torch.where(bc_vr, MSG_VOTE_REQ,
                                   torch.where(bc_pvr, MSG_PREVOTE_REQ, r_kind)))
    out = Msgs(
        kind=_i32(torch.where(alive[..., None], kind, MSG_NONE)),
        # PREVOTE_REQ carries the PROPOSED term (current + 1).
        term=torch.where(send_ae | bc_vr, term3,
                         torch.where(bc_pvr, term3 + 1, r_term)),
        x=ids.where(send_ae, st.nxt, ids.where(bc_vr | bc_pvr, head3, r_x)),
        y=ids.where(send_ae, head3, zero3),
        z=ids.where(send_ae, commit3, zero3),
        ok=r_ok,
    )
    # Optimistically advance the send pointer to what we just shipped.
    st = st.replace(nxt=ids.where(send_ae, head3, st.nxt))

    # ---- crashed nodes are frozen entirely ----
    st = _freeze(st_in.alive, st, st_in)
    metrics = Metrics(
        accepted_blocks=acc_blocks,
        accepted_msgs=acc_msgs,
        minted=minted,
        commit_delta=st.commit.s - commit_s0,
        became_leader=elected & st_in.alive,
    )
    return st, out, metrics


def cluster_step(params: StepParams, member: torch.Tensor, state: NodeState,
                 inbox: Msgs, proposals: torch.Tensor, peer_fresh=None):
    """One lockstep tick of P independent Raft groups of N nodes.

    Returns (state', next_inbox, metrics). Delivery of the produced outbox
    is the (dst, src) transpose: messages sent at tick t arrive at t+1.
    """
    st, out, met = node_step(params, member, state, inbox, proposals, peer_fresh)
    next_inbox = Msgs.from_leaves([a.transpose(1, 2).contiguous() for a in out.leaves()])
    return st, next_inbox, met


def run_ticks(params: StepParams, member: torch.Tensor, state: NodeState,
              inbox: Msgs, proposals: torch.Tensor, ticks: int, peer_fresh=None):
    """Run ``ticks`` lockstep ticks. The same ``proposals`` are re-offered
    every tick. Returns (state', inbox', metrics) where each metrics leaf is
    a [ticks] int32 vector of per-tick cluster-wide sums."""
    sums = {f: [] for f in METRIC_FIELDS}
    for _ in range(int(ticks)):
        state, inbox, met = cluster_step(params, member, state, inbox, proposals,
                                         peer_fresh)
        for f in METRIC_FIELDS:
            sums[f].append(getattr(met, f).sum(dtype=_I32))
    dev = member.device
    return state, inbox, Metrics(**{
        f: torch.stack(v) if v else torch.zeros(0, dtype=_I32, device=dev)
        for f, v in sums.items()})


def decay_idle(params: StepParams, state: NodeState, peer_fresh, ticks) -> NodeState:
    """Advance ``ticks`` ticks of :func:`node_step` for rows that are
    provably idle (empty inbox, zero proposals, no election or heartbeat
    due within the window): only ``elapsed`` and ``hb_elapsed`` move.
    Non-leaders ``elapsed += ticks`` unless the aggregate keepalive holds
    it at 0; leaders hold 0; crashed rows are frozen."""
    N = state.votes.shape[-1]
    is_leader = state.role == LEADER
    if peer_fresh is None:
        ka = torch.zeros_like(state.alive)
    else:
        pf = _peer_fresh(peer_fresh, N, state.role.device)
        ka = ((state.leader >= 0) & (pf[state.leader.clamp(0, N - 1).long()] != 0)
              & (state.hb_elapsed < params.hb_ticks * 8))
    elapsed = torch.where(is_leader | ka, 0, state.elapsed + ticks)
    hb = state.hb_elapsed + ticks
    return state.replace(
        elapsed=_i32(torch.where(state.alive, elapsed, state.elapsed)),
        hb_elapsed=_i32(torch.where(state.alive, hb, state.hb_elapsed)),
    )


def init_state(P: int, N: int, member: torch.Tensor | None = None, base_seed: int = 0,
               params: StepParams | None = None, device="cuda"):
    """Fresh (P, N) follower state + membership mask (bool (P, N)); every
    member node starts alive."""
    dev = resolve_device(device)
    params = params or step_params(device=dev)
    if member is None:
        member = torch.ones((P, N), dtype=torch.bool, device=dev)
    member = member.to(device=dev, dtype=torch.bool)
    pp = torch.arange(P, dtype=torch.int64, device=dev)[:, None]
    nn = torch.arange(N, dtype=torch.int64, device=dev)[None, :]
    seed = ids.hash32((int(base_seed) & ids.U32_MASK)
                      ^ ids.mul32(pp, 0x9E3779B1) ^ ids.mul32(nn, 0x85EBCA77))
    zeros = lambda: torch.zeros((P, N), dtype=_I32, device=dev)
    neg = lambda: torch.full((P, N), -1, dtype=_I32, device=dev)
    st = NodeState(
        term=zeros(),
        voted_for=neg(),
        role=zeros(),
        leader=neg(),
        head=ids.full((P, N), device=dev),
        commit=ids.full((P, N), device=dev),
        elapsed=zeros(),
        timeout=_draw_timeout(seed, torch.zeros_like(seed), params),
        hb_elapsed=zeros(),
        alive=member.clone(),
        seed=ids.to_i32(seed),
        votes=torch.zeros((P, N, N), dtype=torch.bool, device=dev),
        match=ids.full((P, N, N), device=dev),
        nxt=ids.full((P, N, N), device=dev),
    )
    return st, member


def empty_inbox(P: int, N: int, device="cuda") -> Msgs:
    return empty_msgs((P, N, N), device=device)


def restart(state: NodeState, mask: torch.Tensor, keep_term: bool = True) -> NodeState:
    """Revive crashed nodes selected by ``mask`` (bool (P, N)). Chain state
    (head/commit) survives; ``keep_term`` persists the term across restart
    (False resets it to 0 as the original implementation did)."""
    sel = lambda new, old: torch.where(mask, new, old)
    m3 = mask[..., None]
    zero3 = ids.full(state.match.t.shape, device=mask.device)
    return state.replace(
        alive=state.alive | mask,
        role=sel(0, state.role),
        voted_for=sel(-1, state.voted_for),
        leader=sel(-1, state.leader),
        elapsed=sel(0, state.elapsed),
        hb_elapsed=sel(0, state.hb_elapsed),
        term=state.term if keep_term else sel(0, state.term),
        votes=torch.where(m3, False, state.votes),
        match=ids.where(m3, zero3, state.match),
        nxt=ids.where(m3, zero3, state.nxt),
    )


def crash(state: NodeState, mask: torch.Tensor) -> NodeState:
    """Kill nodes selected by ``mask`` (fault injection)."""
    return state.replace(alive=state.alive & ~mask)
