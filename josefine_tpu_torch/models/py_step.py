"""Pure-Python reference implementation of the consensus step (the scalar
oracle of the PyTorch port).

The same ``step(state, inbox) -> (state', outbox, metrics)`` contract as the
batched step (``chained_raft.node_step``), written as plain scalar Python in
the shape of a Raft role machine: one node, one message at a time, ordinary
ints and lists. It is the JAX package's ``models/py_step.py`` with its
imports pointed at this package, and it serves two purposes:

* **differential testing**: ``tests/test_torch_py_step.py`` holds it, the
  port's ``node_step`` and the JAX package's oracle equal to each other,
  integer for integer;
* **``RaftEngine(backend="python")``**: :func:`py_node_over_groups` adapts
  this scalar engine to the engine's batched tensor contract, so a node can
  run consensus without a device (debugging, tiny deployments).

Block ids are (term, seq) tuples: Python tuple comparison IS the
term-major order the batched step encodes in two int32 planes.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from josefine_tpu_torch.models.types import (
    CANDIDATE,
    FOLLOWER,
    LEADER,
    PRECANDIDATE,
    MSG_APPEND,
    MSG_APPEND_RESP,
    MSG_NONE,
    MSG_PREVOTE_REQ,
    MSG_PREVOTE_RESP,
    MSG_VOTE_REQ,
    MSG_VOTE_RESP,
)

_U32 = 0xFFFFFFFF
GENESIS = (0, 0)


def hash32(x: int) -> int:
    """Exact twin of ops.ids.hash32 (same avalanche constants, u32 wrap)."""
    x &= _U32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _U32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _U32
    x ^= x >> 16
    return x


def draw_timeout(seed: int, term: int, tmin: int, tmax: int) -> int:
    h = hash32(seed ^ ((term * 0x9E3779B9) & _U32))
    return tmin + h % (tmax - tmin + 1)


@dataclass
class PyMsg:
    kind: int = MSG_NONE
    term: int = 0
    x: tuple = GENESIS
    y: tuple = GENESIS
    z: tuple = GENESIS
    ok: int = 0


@dataclass
class PyNode:
    """One node's consensus state (the reference ``State`` struct,
    ``src/raft/mod.rs:270-322``, as plain fields)."""

    n: int
    me: int
    seed: int
    term: int = 0
    voted_for: int = -1
    role: int = FOLLOWER
    leader: int = -1
    head: tuple = GENESIS
    commit: tuple = GENESIS
    elapsed: int = 0
    timeout: int = 0
    hb_elapsed: int = 0
    alive: bool = True
    votes: list = field(default_factory=list)   # bool[N]
    match: list = field(default_factory=list)   # (t, s)[N]
    nxt: list = field(default_factory=list)     # (t, s)[N]

    def __post_init__(self):
        if not self.votes:
            self.votes = [False] * self.n
        if not self.match:
            self.match = [GENESIS] * self.n
        if not self.nxt:
            self.nxt = [GENESIS] * self.n


@dataclass
class PyMetrics:
    accepted_blocks: int = 0
    accepted_msgs: int = 0
    minted: int = 0
    commit_delta: int = 0
    became_leader: bool = False


def _process_msg(st: PyNode, m: PyMsg, src: int, src_member: bool,
                 tmin: int, tmax: int, prevote: int) -> tuple[PyMsg, int, bool]:
    """One inbox message against scalar state (mutates ``st``). Returns
    (reply, accepted_span, accepted). Mirrors ``node_step._process_msg``."""
    valid = m.kind != MSG_NONE and st.alive and src_member
    if not valid:
        return PyMsg(), 0, False

    # Leader-lease stickiness (pre-vote mode): see the kernel twin.
    sticky = prevote == 1 and st.leader != -1 and st.elapsed < tmin

    # Universal term catch-up (strictly greater only — quirk 1 fixed).
    # PREVOTE_REQ carries a proposed term and never adopts; leased voters
    # ignore VOTE_REQ terms entirely.
    if (m.term > st.term and m.kind != MSG_PREVOTE_REQ
            and not (sticky and m.kind == MSG_VOTE_REQ)):
        st.term = m.term
        st.role = FOLLOWER
        st.voted_for = -1
        st.leader = -1
        st.elapsed = 0
        st.timeout = draw_timeout(st.seed, st.term, tmin, tmax)
        st.votes = [False] * st.n
    cur = m.term == st.term

    # VoteRequest (+ the up-to-dateness check the reference omits).
    is_vr = m.kind == MSG_VOTE_REQ
    grant = (cur and is_vr and st.role == FOLLOWER
             and st.voted_for in (-1, src) and m.x >= st.head
             and not sticky)
    if grant:
        st.voted_for = src
        st.elapsed = 0

    # PreVoteRequest: would-grant at the proposed term; no state moves.
    is_pvr = m.kind == MSG_PREVOTE_REQ
    pv_grant = (is_pvr and m.term > st.term and m.x >= st.head
                and not sticky)

    # VoteResponse / PreVoteResponse.
    if cur and m.kind == MSG_VOTE_RESP and st.role == CANDIDATE:
        st.votes[src] = st.votes[src] or m.ok == 1
    if m.kind == MSG_PREVOTE_RESP and st.role == PRECANDIDATE:
        st.votes[src] = st.votes[src] or m.ok == 1

    # AppendEntries / heartbeat (unified).
    is_ae_kind = m.kind == MSG_APPEND
    is_ae = is_ae_kind and cur
    accept = False
    span = 0
    if is_ae:
        st.role = FOLLOWER
        st.leader = src
        st.elapsed = 0
        st.hb_elapsed = 0  # follower AE-staleness counter (node_step twin)
        accept = (m.x == st.head
                  or (m.x == st.commit and m.y >= st.head))
        if accept:
            span = max(0, m.y[1] - st.head[1])
            st.head = m.y
            st.commit = max(st.commit, min(m.z, st.head))

    # AppendResponse -> progress advance.
    if cur and m.kind == MSG_APPEND_RESP and st.role == LEADER:
        if m.ok == 1:
            st.match[src] = max(st.match[src], m.x)
            st.nxt[src] = max(st.nxt[src], m.x)
        else:
            st.nxt[src] = m.x

    rep_kind = (MSG_VOTE_RESP if is_vr
                else MSG_APPEND_RESP if is_ae_kind
                else MSG_PREVOTE_RESP if is_pvr else MSG_NONE)
    rep = PyMsg(kind=rep_kind, term=st.term,
                x=st.head if accept else st.commit,
                ok=1 if (grant or accept or pv_grant) else 0)
    return rep, span, accept


def py_node_step(st: PyNode, member: list[bool], inbox: list[PyMsg],
                 proposals: int, tmin: int, tmax: int, hb_ticks: int,
                 auto_proposals: int = 0,
                 prevote: int = 1,
                 peer_fresh: list | None = None,
                 ) -> tuple[PyNode, list[PyMsg], PyMetrics]:
    """One tick of one node — the exact contract of ``node_step`` in plain
    Python. ``inbox[src]`` is the message from each src (kind 0 = none);
    returns the outbox addressed per dst."""
    N = st.n
    me = st.me
    if not st.alive:
        # Crashed nodes are frozen entirely (kernel's final _tree_select);
        # their inbox is consumed and their outbox is silent.
        return st, [PyMsg() for _ in range(N)], PyMetrics()
    st = replace(st, votes=list(st.votes), match=list(st.match), nxt=list(st.nxt))
    commit_s0 = st.commit[1]
    my_member = member[me]

    # ---- 1. inbox fold ----
    reply = [PyMsg() for _ in range(N)]
    met = PyMetrics()
    for src in range(N):
        rep, span, acc = _process_msg(st, inbox[src], src, member[src],
                                      tmin, tmax, prevote)
        reply[src] = rep
        met.accepted_blocks += span
        met.accepted_msgs += 1 if acc else 0

    # ---- 2. timers -> (pre-)candidacy ----
    if st.role == LEADER:
        st.elapsed = 0
    else:
        st.elapsed += 1
    if (peer_fresh is not None and st.leader >= 0
            and peer_fresh[min(max(st.leader, 0), N - 1)]
            and st.hb_elapsed < hb_ticks * 8):
        # Aggregate keepalive — exact twin of node_step's peer_fresh reset
        # (bounded by the follower's per-group AE-staleness counter).
        st.elapsed = 0
    timed_out = (my_member and st.role != LEADER and st.elapsed >= st.timeout)
    just_cand = timed_out and not prevote
    just_precand = timed_out and bool(prevote)
    if timed_out:
        # Fold the previous draw into the hash (decorrelates stalled
        # pre-vote rounds — exact twin of node_step's timed_out redraw).
        st.timeout = draw_timeout(st.seed, (st.term + 1) ^ (st.timeout << 8),
                                  tmin, tmax)
        st.elapsed = 0
        st.leader = -1
        st.votes = [i == me for i in range(N)]
        if prevote:
            st.role = PRECANDIDATE     # no term bump, no vote cast yet
        else:
            st.term += 1
            st.role = CANDIDATE
            st.voted_for = me

    # ---- 3. election tally (pre-vote promotion first) ----
    nvotes = sum(1 for i in range(N) if st.votes[i] and member[i])
    quorum = sum(1 for i in range(N) if member[i]) // 2 + 1
    pre_elected = st.role == PRECANDIDATE and nvotes >= quorum
    if pre_elected:
        st.role = CANDIDATE
        st.timeout = draw_timeout(st.seed, st.term + 1, tmin, tmax)
        st.term += 1
        st.voted_for = me
        st.votes = [i == me for i in range(N)]
        st.elapsed = 0
        nvotes = sum(1 for i in range(N) if st.votes[i] and member[i])
    elected = st.role == CANDIDATE and nvotes >= quorum
    if elected:
        st.head = (st.term, st.head[1] + 1)        # no-op liveness block
        st.role = LEADER
        st.leader = me
        st.match = [st.head if i == me else GENESIS for i in range(N)]
        st.nxt = [st.head if i == me else st.commit for i in range(N)]
        st.hb_elapsed = hb_ticks
        met.became_leader = True

    # ---- 4. proposal minting + self progress row ----
    is_leader = st.role == LEADER
    minted = proposals + auto_proposals if is_leader else 0
    if minted > 0:
        st.head = (st.term, st.head[1] + minted)
    met.minted = minted
    if is_leader:
        st.match[me] = st.head
        st.nxt[me] = st.head

    # ---- 5. quorum commit (k-th largest match, current-term rule) ----
    best = (-1, -1)
    for i in range(N):
        support = sum(1 for j in range(N)
                      if member[j] and st.match[j] >= st.match[i])
        if member[i] and support >= quorum and st.match[i] > best:
            best = st.match[i]
    if is_leader and best[0] == st.term and best > st.commit:
        st.commit = best
    met.commit_delta = st.commit[1] - commit_s0

    # ---- 6. outbox ----
    hb_due = st.hb_elapsed >= hb_ticks
    out = []
    for dst in range(N):
        is_peer = member[dst] and dst != me
        send_ae = (is_leader and my_member and is_peer
                   and (hb_due or st.nxt[dst] < st.head))
        bc_vr = (just_cand or pre_elected) and is_peer and not is_leader
        # Pending replies outrank our own pre-vote broadcast (node_step twin).
        bc_pvr = (just_precand and is_peer and not is_leader and not bc_vr
                  and reply[dst].kind == MSG_NONE)
        if send_ae:
            out.append(PyMsg(kind=MSG_APPEND, term=st.term, x=st.nxt[dst],
                             y=st.head, z=st.commit, ok=reply[dst].ok))
            st.nxt[dst] = st.head
        elif bc_vr:
            out.append(PyMsg(kind=MSG_VOTE_REQ, term=st.term, x=st.head,
                             y=reply[dst].y, z=reply[dst].z, ok=reply[dst].ok))
        elif bc_pvr:
            out.append(PyMsg(kind=MSG_PREVOTE_REQ, term=st.term + 1, x=st.head,
                             y=reply[dst].y, z=reply[dst].z, ok=reply[dst].ok))
        else:
            out.append(reply[dst])
    st.hb_elapsed = ((1 if hb_due else st.hb_elapsed + 1) if is_leader
                     else st.hb_elapsed + 1)
    return st, out, met


def py_decay_idle(st: PyNode, ticks: int, hb_ticks: int,
                  peer_fresh: list | None = None) -> PyNode:
    """Scalar oracle of ``chained_raft.decay_idle``: ``ticks`` idle
    :func:`py_node_step` ticks (empty inbox, zero proposals) collapsed to
    the closed-form timer update. Valid only for rows the active-set wake
    predicate left quiescent (no election fire, no heartbeat due, no
    lagging peer, keepalive hold window-stable — see decay_idle's
    docstring); the JAX package's tests/test_active_set.py checks its
    original equals the full step on exactly those rows."""
    if not st.alive:
        return st
    st = replace(st)
    is_leader = st.role == LEADER
    ka = (peer_fresh is not None and st.leader >= 0
          and peer_fresh[min(max(st.leader, 0), st.n - 1)]
          and st.hb_elapsed < hb_ticks * 8)
    st.elapsed = 0 if (is_leader or ka) else st.elapsed + ticks
    st.hb_elapsed = st.hb_elapsed + ticks
    return st


def decay_idle_np(hb_ticks: int, state, peer_fresh, ticks: int):
    """``chained_raft.decay_idle`` over a NodeState of numpy leaves (the
    JAX package's ``decay_idle(..., xp=np)``, the python backend's decay).
    Returns a NodeState whose elapsed/hb_elapsed are new arrays; the other
    leaves are the input's."""
    N = state.votes.shape[-1]
    is_leader = state.role == LEADER
    if peer_fresh is None:
        ka = np.zeros(state.role.shape, bool)
    else:
        lead = np.clip(state.leader, 0, N - 1)
        ka = ((state.leader >= 0) & (np.asarray(peer_fresh)[lead] != 0)
              & (state.hb_elapsed < hb_ticks * 8))
    elapsed = np.where(is_leader | ka, 0, state.elapsed + ticks)
    hb = state.hb_elapsed + ticks
    alive = state.alive
    return state.replace(
        elapsed=np.where(alive, elapsed, state.elapsed).astype(state.elapsed.dtype),
        hb_elapsed=np.where(alive, hb, state.hb_elapsed).astype(state.hb_elapsed.dtype),
    )


# --------------------------------------------------------------- clusters


class PyCluster:
    """P independent groups x N nodes in lockstep, with transpose delivery —
    the scalar twin of ``chained_raft.cluster_step`` for differential tests
    and device-free simulation."""

    def __init__(self, P: int, N: int, member=None, base_seed: int = 0,
                 tmin: int = 5, tmax: int = 10, hb_ticks: int = 1,
                 auto_proposals: int = 0, prevote: int = 1):
        self.P, self.N = P, N
        self.tmin, self.tmax, self.hb_ticks = tmin, tmax, hb_ticks
        self.auto_proposals = auto_proposals
        self.prevote = prevote
        self.member = (member if member is not None
                       else [[True] * N for _ in range(P)])
        self.nodes: list[list[PyNode]] = []
        for p in range(P):
            row = []
            for n in range(N):
                seed = hash32((base_seed ^ ((p * 0x9E3779B1) & _U32)
                               ^ ((n * 0x85EBCA77) & _U32)) & _U32)
                node = PyNode(n=N, me=n, seed=seed,
                              alive=bool(self.member[p][n]))
                node.timeout = draw_timeout(seed, 0, tmin, tmax)
                row.append(node)
            self.nodes.append(row)
        self.inbox = [[[PyMsg() for _ in range(N)] for _ in range(N)]
                      for _ in range(P)]  # [p][dst][src]

    def step(self, proposals=None) -> list[list[PyMetrics]]:
        """One lockstep tick; messages sent at tick t arrive at t+1."""
        P, N = self.P, self.N
        mets = []
        next_inbox = [[[PyMsg() for _ in range(N)] for _ in range(N)]
                      for _ in range(P)]
        for p in range(P):
            row_m = []
            for n in range(N):
                st, out, met = py_node_step(
                    self.nodes[p][n], self.member[p], self.inbox[p][n],
                    proposals[p][n] if proposals is not None else 0,
                    self.tmin, self.tmax, self.hb_ticks, self.auto_proposals,
                    self.prevote)
                self.nodes[p][n] = st
                for dst in range(N):
                    next_inbox[p][dst][n] = out[dst]
                row_m.append(met)
            mets.append(row_m)
        self.inbox = next_inbox
        return mets

    def crash(self, p: int, n: int) -> None:
        self.nodes[p][n].alive = False

    def restart(self, p: int, n: int, keep_term: bool = True) -> None:
        """Mirror of ``chained_raft.restart`` for one node."""
        st = self.nodes[p][n]
        if st.alive:
            return
        st.alive = True
        st.role = FOLLOWER
        st.voted_for = -1
        st.leader = -1
        st.elapsed = 0
        st.hb_elapsed = 0
        if not keep_term:
            st.term = 0
        st.votes = [False] * self.N
        st.match = [GENESIS] * self.N
        st.nxt = [GENESIS] * self.N


# ------------------------------------------------ RaftEngine array adapter


def _host(a) -> np.ndarray:
    """A writable numpy copy of a tensor (any device) or array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.array(a)


def py_node_over_groups(params, member, me, state, inbox, prop_counts,
                        peer_fresh=None):
    """Drop-in replacement for the engine's batched step over one node's
    rows of all P groups, executed by the scalar engine. Used by
    ``RaftEngine(backend="python")``. Inputs may be tensors (on any device)
    or numpy arrays; the result's tensors are built on the device of
    ``state`` (the CPU for numpy leaves)."""
    from josefine_tpu_torch.models.types import Metrics, Msgs, NodeState
    from josefine_tpu_torch.ops import ids

    tmin, tmax, hb, auto, prevote = params.ints()
    me = int(me.reshape(-1)[0]) if isinstance(me, torch.Tensor) else int(me)
    mem = _host(member)
    P, N = mem.shape
    h = _host
    s_term = h(state.term); s_voted = h(state.voted_for); s_role = h(state.role)
    s_leader = h(state.leader); s_elapsed = h(state.elapsed)
    s_timeout = h(state.timeout); s_hb = h(state.hb_elapsed)
    s_alive = h(state.alive); s_seed = h(state.seed)
    s_votes = h(state.votes)
    s_ht, s_hs = h(state.head.t), h(state.head.s)
    s_ct, s_cs = h(state.commit.t), h(state.commit.s)
    s_mt, s_ms = h(state.match.t), h(state.match.s)
    s_nt, s_ns = h(state.nxt.t), h(state.nxt.s)
    i_kind = h(inbox.kind); i_term = h(inbox.term); i_ok = h(inbox.ok)
    i_xt, i_xs = h(inbox.x.t), h(inbox.x.s)
    i_yt, i_ys = h(inbox.y.t), h(inbox.y.s)
    i_zt, i_zs = h(inbox.z.t), h(inbox.z.s)
    props = h(prop_counts)

    pf_list = (None if peer_fresh is None
               else [bool(x) for x in h(peer_fresh)])
    o_kind = np.zeros((P, N), np.int32); o_term = np.zeros((P, N), np.int32)
    o_ok = np.zeros((P, N), np.int32)
    o_xt = np.zeros((P, N), np.int32); o_xs = np.zeros((P, N), np.int32)
    o_yt = np.zeros((P, N), np.int32); o_ys = np.zeros((P, N), np.int32)
    o_zt = np.zeros((P, N), np.int32); o_zs = np.zeros((P, N), np.int32)
    m_minted = np.zeros(P, np.int32); m_became = np.zeros(P, bool)
    m_acc_b = np.zeros(P, np.int32); m_acc_m = np.zeros(P, np.int32)
    m_delta = np.zeros(P, np.int32)

    for g in range(P):
        node = PyNode(
            n=N, me=me, seed=int(s_seed[g]) & _U32, term=int(s_term[g]),
            voted_for=int(s_voted[g]), role=int(s_role[g]),
            leader=int(s_leader[g]), head=(int(s_ht[g]), int(s_hs[g])),
            commit=(int(s_ct[g]), int(s_cs[g])), elapsed=int(s_elapsed[g]),
            timeout=int(s_timeout[g]), hb_elapsed=int(s_hb[g]),
            alive=bool(s_alive[g]),
            votes=[bool(v) for v in s_votes[g]],
            match=[(int(s_mt[g, i]), int(s_ms[g, i])) for i in range(N)],
            nxt=[(int(s_nt[g, i]), int(s_ns[g, i])) for i in range(N)],
        )
        msgs = [PyMsg(kind=int(i_kind[g, s]), term=int(i_term[g, s]),
                      x=(int(i_xt[g, s]), int(i_xs[g, s])),
                      y=(int(i_yt[g, s]), int(i_ys[g, s])),
                      z=(int(i_zt[g, s]), int(i_zs[g, s])),
                      ok=int(i_ok[g, s])) for s in range(N)]
        node, out, met = py_node_step(
            node, [bool(b) for b in mem[g]], msgs, int(props[g]),
            tmin, tmax, hb, auto, prevote, peer_fresh=pf_list)
        s_term[g] = node.term; s_voted[g] = node.voted_for
        s_role[g] = node.role; s_leader[g] = node.leader
        s_elapsed[g] = node.elapsed; s_timeout[g] = node.timeout
        s_hb[g] = node.hb_elapsed
        s_ht[g], s_hs[g] = node.head
        s_ct[g], s_cs[g] = node.commit
        for i in range(N):
            s_votes[g, i] = node.votes[i]
            s_mt[g, i], s_ms[g, i] = node.match[i]
            s_nt[g, i], s_ns[g, i] = node.nxt[i]
        for dst in range(N):
            o_kind[g, dst] = out[dst].kind; o_term[g, dst] = out[dst].term
            o_ok[g, dst] = out[dst].ok
            o_xt[g, dst], o_xs[g, dst] = out[dst].x
            o_yt[g, dst], o_ys[g, dst] = out[dst].y
            o_zt[g, dst], o_zs[g, dst] = out[dst].z
        m_minted[g] = met.minted; m_became[g] = met.became_leader
        m_acc_b[g] = met.accepted_blocks; m_acc_m[g] = met.accepted_msgs
        m_delta[g] = met.commit_delta

    dev = state.term.device if isinstance(state.term, torch.Tensor) else "cpu"
    j = lambda a: torch.as_tensor(a, device=dev)
    new_state = NodeState(
        term=j(s_term), voted_for=j(s_voted), role=j(s_role),
        leader=j(s_leader), head=ids.Bid(j(s_ht), j(s_hs)),
        commit=ids.Bid(j(s_ct), j(s_cs)), elapsed=j(s_elapsed),
        timeout=j(s_timeout), hb_elapsed=j(s_hb), alive=j(s_alive),
        seed=j(s_seed), votes=j(s_votes),
        match=ids.Bid(j(s_mt), j(s_ms)), nxt=ids.Bid(j(s_nt), j(s_ns)),
    )
    outbox = Msgs(kind=j(o_kind), term=j(o_term),
                  x=ids.Bid(j(o_xt), j(o_xs)), y=ids.Bid(j(o_yt), j(o_ys)),
                  z=ids.Bid(j(o_zt), j(o_zs)), ok=j(o_ok))
    metrics = Metrics(accepted_blocks=j(m_acc_b), accepted_msgs=j(m_acc_m),
                      minted=j(m_minted), commit_delta=j(m_delta),
                      became_leader=j(m_became))
    return new_state, outbox, metrics
