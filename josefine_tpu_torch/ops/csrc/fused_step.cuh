// One Chained-Raft node tick, written once for nvcc (the Hopper kernel in
// fused_step.cu) and for g++ (the host emulation in fused_step_host.cpp that
// the CPU test suite holds against the JAX package).
//
// node_tick<N> is the per-node form of the JAX package's node_step
// (josefine_tpu/models/chained_raft.py:221) and of the Pallas tick body
// _tile_step (josefine_tpu/ops/pallas_step.py:110), statement for statement.
// One call advances ONE node of one group by one tick: it folds the node's
// inbox row (one message from each src, in src order), runs the timers, the
// election tally, minting and the quorum commit, and fills the node's outbox
// row (one message to each dst). Messages are read from and written to the
// group's mailbox through a MailRow, which the kernel points at shared
// memory and the host emulation at a host array.
//
// Integer rules: the id, term and timer arithmetic wraps as jnp int32 does,
// so additions that can wrap go through uint32 (signed overflow is undefined
// in C++); hash32 and the timeout draw are uint32 throughout.
//
// Every loop runs over a compile-time N and is unrolled, so the per-peer
// rows stay in registers; the node's own index `me` is a runtime value and
// is only ever compared against, never used to index a register array.
// Per-peer booleans (votes, membership, pending replies) are N-bit masks.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define JF_HD __host__ __device__ __forceinline__

namespace josefine {

constexpr int MSG_NONE = 0, MSG_VOTE_REQ = 1, MSG_VOTE_RESP = 2, MSG_APPEND = 3,
              MSG_APPEND_RESP = 4, MSG_PREVOTE_REQ = 5, MSG_PREVOTE_RESP = 6;
constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2, PRECANDIDATE = 3;

constexpr int N_STATE = 18;   // NodeState leaves, in jax.tree.leaves order
constexpr int N_INBOX = 9;    // Msgs leaves: kind term x.t x.s y.t y.s z.t z.s ok
constexpr int N_METRICS = 5;  // accepted_blocks accepted_msgs minted commit_delta became_leader
constexpr int N_PARAMS = 5;   // timeout_min timeout_max hb_ticks auto_proposals prevote
constexpr int LEAF_ALIVE = 11, LEAF_VOTES = 13;  // the bool (one byte) state leaves

// Message lanes, in Msgs leaf order.
enum { F_KIND, F_TERM, F_XT, F_XS, F_YT, F_YS, F_ZT, F_ZS, F_OK };

// Whole groups per warp: no group's nodes straddle two warps.
template <int N>
__host__ __device__ constexpr int groups_per_warp() { return 32 / N; }

struct Params {
  int timeout_min, timeout_max, hb_ticks, auto_proposals, prevote;
  // Bit j set: node slot j's transport is fresh (peer_fresh[j] != 0). Zero
  // when the caller passed no peer_fresh, so the keepalive never fires. A
  // mask, not a per-slot array: on the card (nvcc 12.8, sm_90a) an unrolled
  // select over an int array in this struct read the last slot for every
  // leader, where the g++ build read the right one.
  uint32_t peer_fresh;
};

// What a node knows of its group for a whole window: membership is fixed
// while the window runs.
struct Group {
  uint32_t member;  // bit j: slot j is a member
  uint32_t peers;   // member slots other than me
  int quorum;       // popcount(member) / 2 + 1
  bool my_member;
};

template <int N>
struct Node {
  int term, voted_for, role, leader, head_t, head_s, commit_t, commit_s;
  int elapsed, timeout, hb_elapsed, alive;
  uint32_t seed;
  uint32_t votes;  // bit j: slot j granted us its (pre-)vote
  int match_t[N], match_s[N], nxt_t[N], nxt_s[N];
};

// One node's window onto its warp's mailbox. A mailbox buffer is laid out
// [N_INBOX][G * N (dst lane)][N (src)], so field f of the message from src
// is rd[f * FS + src], and the message to dst goes to wr[f * FS + dst * N].
template <int N>
struct MailRow {
  static constexpr int FS = groups_per_warp<N>() * N * N;  // one field of one buffer
  const int* rd;  // this node's inbox row in the buffer being read
  int* wr;        // column `me` of its group in the buffer being written
  JF_HD int get(int f, int src) const { return rd[f * FS + src]; }
  JF_HD void put(int f, int dst, int v) const { wr[f * FS + dst * N] = v; }
};

JF_HD int wadd(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
JF_HD int wsub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }
JF_HD uint32_t bit(uint32_t mask, int j) { return (mask >> j) & 1u; }

JF_HD int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Block-id order: term-major (t, s) compares, both signed, as pairs of 32-bit
// compares. Packing (t, s) into one order-preserving 64-bit key gave more
// instructions in the tick loop at N = 5, not fewer (fused_step.cu's note).
JF_HD bool bid_eq(int at, int as, int bt, int bs) { return (at == bt) & (as == bs); }
JF_HD bool bid_lt(int at, int as, int bt, int bs) { return (at < bt) | ((at == bt) & (as < bs)); }
JF_HD bool bid_le(int at, int as, int bt, int bs) { return (at < bt) | ((at == bt) & (as <= bs)); }

JF_HD uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Randomized election timeout, decorrelated per (node, term).
JF_HD int draw_timeout(uint32_t seed, uint32_t term, const Params& p) {
  uint32_t h = hash32(seed ^ (term * 0x9E3779B9u));
  uint32_t span = (uint32_t)p.timeout_max - (uint32_t)p.timeout_min + 1u;
  return (int)((uint32_t)p.timeout_min + h % span);
}

template <int N>
JF_HD Group make_group(uint32_t member, int me) {
  Group g;
  g.member = member;
  g.peers = member & ~(1u << me);
  g.quorum = popc(member) / 2 + 1;
  g.my_member = bit(member, me) != 0;
  return g;
}

// The quorum-th largest match among members (the largest id that a quorum
// of members has reached), floored at (-1, -1); non-members count as the
// lowest id. rank[i] counts the ids ranked above slot i's (larger, or equal
// at a lower slot), so ranks are 0..N-1 and the id of rank quorum - 1 is the
// one. Each pair is compared once, N(N-1)/2 compares, where counting each
// id's support compares all N² pairs. The pick is a select per slot on its
// rank: a pick by position (kt[quorum - 1]) is an indexed read, which nvcc
// serves from local memory.
template <int N>
JF_HD void quorum_match(const Node<N>& st, const Group& grp, int& best_t, int& best_s) {
  constexpr int LOW = (int)0x80000000;
  int kt[N], ks[N], rank[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool m = bit(grp.member, i) != 0;
    kt[i] = m ? st.match_t[i] : LOW;
    ks[i] = m ? st.match_s[i] : LOW;
    rank[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      const bool up = bid_lt(kt[i], ks[i], kt[j], ks[j]);  // j ranks above i
      rank[i] += (int)up;
      rank[j] += (int)!up;
    }
  }
  int qt = LOW, qs = LOW;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (rank[i] == grp.quorum - 1) {
      qt = kt[i];
      qs = ks[i];
    }
  }
  const bool above = bid_lt(-1, -1, qt, qs);
  best_t = above ? qt : -1;
  best_s = above ? qs : -1;
}

// One tick of node `me`. box.get(f, src): the message from src in lane f;
// box.put(f, dst, v): the message to dst. met accumulates the five window
// metrics. A crashed node (alive == 0) changes none of its state.
template <int N>
JF_HD void node_tick(const Params& P, const Group& grp, int me, int props, Node<N>& st,
                     const MailRow<N>& box, int (&met)[N_METRICS]) {
  const int commit_s0 = st.commit_s;
  const bool alive = st.alive != 0;
  const bool pv = P.prevote == 1;

  // ---- 1. inbox fold (sequential over srcs); each reply goes straight to
  // the outbox, and rep_mask remembers which lanes hold one ----
  uint32_t rep_mask = 0;
  int acc_blocks = 0, acc_msgs = 0;
#pragma unroll
  for (int src = 0; src < N; ++src) {
    const int kind = box.get(F_KIND, src), mterm = box.get(F_TERM, src);
    const int xt = box.get(F_XT, src), xs = box.get(F_XS, src);
    const int yt = box.get(F_YT, src), ys = box.get(F_YS, src);
    const int zt = box.get(F_ZT, src), zs = box.get(F_ZS, src);
    const int mok = box.get(F_OK, src);

    // Messages from non-member slots are masked out (runtime membership).
    const bool valid = (kind != MSG_NONE) & alive & (bit(grp.member, src) != 0);
    // Leader-lease stickiness (pre-vote mode), from pre-adoption state.
    const bool sticky = pv & (st.leader != -1) & (st.elapsed < P.timeout_min);
    // Universal term catch-up, strictly greater only.
    const bool higher = valid & (mterm > st.term) & (kind != MSG_PREVOTE_REQ) &
                        !(sticky & (kind == MSG_VOTE_REQ));
    if (higher) {
      st.term = mterm;
      st.role = FOLLOWER;
      st.voted_for = -1;
      st.leader = -1;
      st.elapsed = 0;
      st.timeout = draw_timeout(st.seed, (uint32_t)mterm, P);
      st.votes = 0;
    }
    const bool cur = valid & (mterm == st.term);

    // VoteRequest, with the log up-to-dateness check.
    const bool is_vr = valid & (kind == MSG_VOTE_REQ);
    const bool grant = cur & (kind == MSG_VOTE_REQ) & (st.role == FOLLOWER) &
                       ((st.voted_for == -1) | (st.voted_for == src)) &
                       bid_le(st.head_t, st.head_s, xt, xs) & !sticky;
    if (grant) {
      st.voted_for = src;
      st.elapsed = 0;
    }

    // PreVoteRequest: would we grant at the proposed term? No state moves.
    const bool is_pvr = valid & (kind == MSG_PREVOTE_REQ);
    const bool pv_grant = is_pvr & (mterm > st.term) & bid_le(st.head_t, st.head_s, xt, xs) & !sticky;

    // VoteResponse / PreVoteResponse tally into the same ballot.
    const bool is_vresp = cur & (kind == MSG_VOTE_RESP) & (st.role == CANDIDATE);
    const bool is_pvresp = valid & (kind == MSG_PREVOTE_RESP) & (st.role == PRECANDIDATE);
    st.votes |= (uint32_t)((is_vresp | is_pvresp) & (mok == 1)) << src;

    // AppendEntries / heartbeat.
    const bool is_ae_kind = valid & (kind == MSG_APPEND);
    const bool is_ae = is_ae_kind & cur;
    if (is_ae) {
      st.role = FOLLOWER;
      st.leader = src;
      st.elapsed = 0;
      st.hb_elapsed = 0;
    }
    // Accept a span rooted at our head, or at our commit pointer when the
    // offered head is at least ours (dead-branch abandonment).
    const bool accept = is_ae & (bid_eq(xt, xs, st.head_t, st.head_s) |
                                 (bid_eq(xt, xs, st.commit_t, st.commit_s) &
                                  bid_le(st.head_t, st.head_s, yt, ys)));
    const int old_head_s = st.head_s;
    if (accept) {
      st.head_t = yt;
      st.head_s = ys;
      // commit = max(commit, min(z, new_head))
      int mt = zt, ms = zs;
      if (!bid_le(zt, zs, yt, ys)) { mt = yt; ms = ys; }
      if (!bid_le(mt, ms, st.commit_t, st.commit_s)) { st.commit_t = mt; st.commit_s = ms; }
    }
    const int d = wsub(ys, old_head_s);
    const int span = accept ? (d > 0 ? d : 0) : 0;

    // AppendResponse -> progress advance (a reject re-roots nxt at the hint).
    const bool is_ar = cur & (kind == MSG_APPEND_RESP) & (st.role == LEADER);
    const bool ok = mok == 1;
    if (is_ar & ok & !bid_le(xt, xs, st.match_t[src], st.match_s[src])) {
      st.match_t[src] = xt;
      st.match_s[src] = xs;
    }
    if (is_ar) {
      if (!ok | !bid_le(xt, xs, st.nxt_t[src], st.nxt_s[src])) {
        st.nxt_t[src] = xt;
        st.nxt_s[src] = xs;
      }
    }

    // Reply to src (responses only; y and z stay zero). A send in step 6
    // may overwrite it.
    const int rep_kind = is_vr ? MSG_VOTE_RESP
                         : is_ae_kind ? MSG_APPEND_RESP
                         : is_pvr ? MSG_PREVOTE_RESP : MSG_NONE;
    rep_mask |= (uint32_t)(rep_kind != MSG_NONE) << src;
    box.put(F_KIND, src, rep_kind);
    box.put(F_TERM, src, st.term);
    box.put(F_XT, src, accept ? st.head_t : st.commit_t);
    box.put(F_XS, src, accept ? st.head_s : st.commit_s);
    box.put(F_YT, src, 0);
    box.put(F_YS, src, 0);
    box.put(F_ZT, src, 0);
    box.put(F_ZS, src, 0);
    box.put(F_OK, src, (int)(grant | accept | pv_grant));
    acc_blocks = wadd(acc_blocks, span);
    acc_msgs += (int)accept;
  }

  // ---- 2. timers: election timeout -> (pre-)candidacy ----
  bool is_leader = st.role == LEADER;
  int elapsed = is_leader ? 0 : wadd(st.elapsed, 1);
  {
    // Aggregate keepalive: peer_fresh[clip(leader, 0, N-1)] != 0.
    const int lc = st.leader < 0 ? 0 : (st.leader > N - 1 ? N - 1 : st.leader);
    const bool ka = (st.leader >= 0) & (bit(P.peer_fresh, lc) != 0) &
                    (st.hb_elapsed < (int)((uint32_t)P.hb_ticks * 8u));
    if (ka) elapsed = 0;
  }
  const bool timed_out = alive & grp.my_member & !is_leader & (elapsed >= st.timeout);
  if (alive) st.elapsed = timed_out ? 0 : elapsed;
  if (timed_out) {
    // Redraw folding in the previous timeout (decorrelates stalled pre-vote
    // rounds): (term + 1) ^ (timeout << 8), wrapped to 32 bits.
    const uint32_t mix = ((uint32_t)st.term + 1u) ^ ((uint32_t)st.timeout << 8);
    st.timeout = draw_timeout(st.seed, mix, P);
    st.role = pv ? PRECANDIDATE : CANDIDATE;
    st.leader = -1;
    if (!pv) {
      st.term = wadd(st.term, 1);
      st.voted_for = me;
    }
    st.votes = 1u << me;
  }
  const bool just_cand = timed_out & !pv;
  const bool just_precand = timed_out & pv;

  // ---- 3. election tally (pre-vote promotion first) ----
  const bool pre_elected = alive & (st.role == PRECANDIDATE) &
                           (popc(st.votes & grp.member) >= grp.quorum);
  if (pre_elected) {
    st.role = CANDIDATE;
    st.timeout = draw_timeout(st.seed, (uint32_t)st.term + 1u, P);
    st.term = wadd(st.term, 1);
    st.voted_for = me;
    st.elapsed = 0;
    st.votes = 1u << me;
  }
  const bool elected = alive & (st.role == CANDIDATE) &
                       (popc(st.votes & grp.member) >= grp.quorum);
  if (elected) {
    // Mint a no-op block at the new term; fresh progress rows: match =
    // genesis for peers, nxt = our commit, self entries = our head.
    st.head_t = st.term;
    st.head_s = wadd(st.head_s, 1);
    st.role = LEADER;
    st.leader = me;
    st.hb_elapsed = P.hb_ticks;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const bool self = k == me;
      st.match_t[k] = self ? st.head_t : 0;
      st.match_s[k] = self ? st.head_s : 0;
      st.nxt_t[k] = self ? st.head_t : st.commit_t;
      st.nxt_s[k] = self ? st.head_s : st.commit_s;
    }
  }

  // ---- 4. proposal minting + self progress row ----
  is_leader = st.role == LEADER;
  const bool live_leader = is_leader & alive;
  const int minted = live_leader ? wadd(props, P.auto_proposals) : 0;
  if (minted > 0) st.head_t = st.term;
  st.head_s = wadd(st.head_s, minted);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if ((k == me) & live_leader) {
      st.match_t[k] = st.head_t;
      st.match_s[k] = st.head_s;
      st.nxt_t[k] = st.head_t;
      st.nxt_s[k] = st.head_s;
    }
  }

  // ---- 5. quorum commit: k-th largest match (k = quorum) ----
  if (live_leader) {
    int best_t, best_s;
    quorum_match<N>(st, grp, best_t, best_s);
    if ((best_t == st.term) & bid_lt(st.commit_t, st.commit_s, best_t, best_s)) {
      st.commit_t = best_t;
      st.commit_s = best_s;
    }
  }

  // ---- 6. outbox: sends overwrite the replies step 1 wrote ----
  const bool hb_due = st.hb_elapsed >= P.hb_ticks;
  const bool lead_send = live_leader & grp.my_member;
  const bool vr_now = (just_cand | pre_elected) & alive & !is_leader;
  const bool pvr_now = just_precand & alive & !is_leader;
#pragma unroll
  for (int dst = 0; dst < N; ++dst) {
    const bool is_peer = bit(grp.peers, dst) != 0;
    const bool send_ae = lead_send & is_peer &
                         (hb_due | bid_lt(st.nxt_t[dst], st.nxt_s[dst], st.head_t, st.head_s));
    const bool bc_vr = vr_now & is_peer;
    // A pending reply outranks our own pre-vote broadcast on that lane.
    const bool bc_pvr = pvr_now & is_peer & !bc_vr & (bit(rep_mask, dst) == 0);
    if (send_ae | bc_vr | bc_pvr) {
      box.put(F_KIND, dst, send_ae ? MSG_APPEND : bc_vr ? MSG_VOTE_REQ : MSG_PREVOTE_REQ);
      // PREVOTE_REQ carries the PROPOSED term (current + 1).
      box.put(F_TERM, dst, bc_pvr ? wadd(st.term, 1) : st.term);
      box.put(F_XT, dst, send_ae ? st.nxt_t[dst] : st.head_t);
      box.put(F_XS, dst, send_ae ? st.nxt_s[dst] : st.head_s);
    }
    if (send_ae) {
      box.put(F_YT, dst, st.head_t);
      box.put(F_YS, dst, st.head_s);
      box.put(F_ZT, dst, st.commit_t);
      box.put(F_ZS, dst, st.commit_s);
      // Optimistically advance the send pointer to what we just shipped.
      st.nxt_t[dst] = st.head_t;
      st.nxt_s[dst] = st.head_s;
    }
  }
  // Leaders: broadcast cadence. Followers: ticks since their leader's AE.
  if (alive) st.hb_elapsed = (is_leader & hb_due) ? 1 : wadd(st.hb_elapsed, 1);

  met[0] = wadd(met[0], acc_blocks);
  met[1] = wadd(met[1], acc_msgs);
  met[2] = wadd(met[2], minted);
  met[3] = wadd(met[3], wsub(st.commit_s, commit_s0));
  met[4] = wadd(met[4], (int)elected);
}

// The arguments of one window, shared by the kernel and the host emulation.
// Leaves are contiguous in the (P, ...) layout, each in its own dtype: int32,
// except alive and votes (bool, one byte). State leaves (P, N) or (P, N, N)
// [p, me, peer]; inbox leaves (P, N_dst, N_src). The step params stay where
// the caller keeps them (the card, for the kernel), read by load_params, so
// a launch needs no copy to the host.
struct WindowArgs {
  const void* in[N_STATE + N_INBOX];
  void* out[N_STATE + N_INBOX];
  const uint8_t* member;  // (P, N) bool
  const int32_t* props;   // (P, N)
  int32_t* partials;      // (ceil(P / G), N_METRICS): one row per warp of G groups
  const int32_t* param[N_PARAMS];  // one int32 each, in StepParams field order
  const int32_t* peer_fresh;       // (N,) int32, or null: the keepalive never fires
  long long num_parts;
  int ticks;
};

template <int N>
JF_HD Params load_params(const WindowArgs& a) {
  Params p;
  p.timeout_min = *a.param[0];
  p.timeout_max = *a.param[1];
  p.hb_ticks = *a.param[2];
  p.auto_proposals = *a.param[3];
  p.prevote = *a.param[4];
  p.peer_fresh = 0;
  if (a.peer_fresh != nullptr) {
#pragma unroll
    for (int j = 0; j < N; ++j) p.peer_fresh |= (uint32_t)(a.peer_fresh[j] != 0) << j;
  }
  return p;
}

JF_HD const int32_t* in_i32(const WindowArgs& a, int leaf) {
  return static_cast<const int32_t*>(a.in[leaf]);
}
JF_HD int32_t* out_i32(const WindowArgs& a, int leaf) { return static_cast<int32_t*>(a.out[leaf]); }

template <int N>
JF_HD void load_node(const WindowArgs& a, long long p, int me, Node<N>& st, Group& grp,
                     int& props) {
  const long long pn = p * N + me;
  st.term = in_i32(a, 0)[pn];
  st.voted_for = in_i32(a, 1)[pn];
  st.role = in_i32(a, 2)[pn];
  st.leader = in_i32(a, 3)[pn];
  st.head_t = in_i32(a, 4)[pn];
  st.head_s = in_i32(a, 5)[pn];
  st.commit_t = in_i32(a, 6)[pn];
  st.commit_s = in_i32(a, 7)[pn];
  st.elapsed = in_i32(a, 8)[pn];
  st.timeout = in_i32(a, 9)[pn];
  st.hb_elapsed = in_i32(a, 10)[pn];
  st.alive = static_cast<const uint8_t*>(a.in[LEAF_ALIVE])[pn] != 0;
  st.seed = (uint32_t)in_i32(a, 12)[pn];
  const uint8_t* votes = static_cast<const uint8_t*>(a.in[LEAF_VOTES]) + pn * N;
  const uint8_t* member = a.member + p * N;
  uint32_t vmask = 0, mmask = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const long long r = pn * N + k;
    vmask |= (uint32_t)(votes[k] != 0) << k;
    mmask |= (uint32_t)(member[k] != 0) << k;
    st.match_t[k] = in_i32(a, 14)[r];
    st.match_s[k] = in_i32(a, 15)[r];
    st.nxt_t[k] = in_i32(a, 16)[r];
    st.nxt_s[k] = in_i32(a, 17)[r];
  }
  st.votes = vmask;
  grp = make_group<N>(mmask, me);
  props = a.props[pn];
}

template <int N>
JF_HD void store_node(const WindowArgs& a, long long p, int me, const Node<N>& st) {
  const long long pn = p * N + me;
  out_i32(a, 0)[pn] = st.term;
  out_i32(a, 1)[pn] = st.voted_for;
  out_i32(a, 2)[pn] = st.role;
  out_i32(a, 3)[pn] = st.leader;
  out_i32(a, 4)[pn] = st.head_t;
  out_i32(a, 5)[pn] = st.head_s;
  out_i32(a, 6)[pn] = st.commit_t;
  out_i32(a, 7)[pn] = st.commit_s;
  out_i32(a, 8)[pn] = st.elapsed;
  out_i32(a, 9)[pn] = st.timeout;
  out_i32(a, 10)[pn] = st.hb_elapsed;
  static_cast<uint8_t*>(a.out[LEAF_ALIVE])[pn] = (uint8_t)(st.alive != 0);
  out_i32(a, 12)[pn] = (int32_t)st.seed;
  uint8_t* votes = static_cast<uint8_t*>(a.out[LEAF_VOTES]) + pn * N;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const long long r = pn * N + k;
    votes[k] = (uint8_t)bit(st.votes, k);
    out_i32(a, 14)[r] = st.match_t[k];
    out_i32(a, 15)[r] = st.match_s[k];
    out_i32(a, 16)[r] = st.nxt_t[k];
    out_i32(a, 17)[r] = st.nxt_s[k];
  }
}

// Node me's in-flight inbox row between device memory and a mailbox buffer
// (`row` = the buffer + its row offset, fields MailRow<N>::FS apart).
template <int N>
JF_HD void load_inbox(const WindowArgs& a, long long p, int me, int* row) {
  const long long r = (p * N + me) * N;
#pragma unroll
  for (int f = 0; f < N_INBOX; ++f)
#pragma unroll
    for (int src = 0; src < N; ++src) row[f * MailRow<N>::FS + src] = in_i32(a, N_STATE + f)[r + src];
}

template <int N>
JF_HD void store_inbox(const WindowArgs& a, long long p, int me, const int* row) {
  const long long r = (p * N + me) * N;
#pragma unroll
  for (int f = 0; f < N_INBOX; ++f)
#pragma unroll
    for (int src = 0; src < N; ++src) out_i32(a, N_STATE + f)[r + src] = row[f * MailRow<N>::FS + src];
}

// Fill WindowArgs from the C interface's arguments (host side).
inline WindowArgs make_args(long long num_parts, int ticks, const void* const* params,
                            const void* peer_fresh, const void* const* in_leaves,
                            void* const* out_leaves, const void* member, const void* props,
                            void* partials) {
  WindowArgs a;
  for (int i = 0; i < N_STATE + N_INBOX; ++i) {
    a.in[i] = in_leaves[i];
    a.out[i] = out_leaves[i];
  }
  for (int i = 0; i < N_PARAMS; ++i) a.param[i] = static_cast<const int32_t*>(params[i]);
  a.peer_fresh = static_cast<const int32_t*>(peer_fresh);
  a.member = static_cast<const uint8_t*>(member);
  a.props = static_cast<const int32_t*>(props);
  a.partials = static_cast<int32_t*>(partials);
  a.num_parts = num_parts;
  a.ticks = ticks;
  return a;
}

}  // namespace josefine
