"""PyTorch port, the engine's scale path: sparse packed IO and the active set.

Function level, against the JAX package on the same numpy-seeded inputs:

* the sparse window (``_sparse_window_fn``) at 1 and 8 ticks, byte-equal in
  ``flat``, ``sv``, ``ov`` and the state, with a padded touched-row bucket,
  both when the compaction capacity fits and when it overflows;
* the active-set trio ``_gather_active`` + ``_active_window_fn`` +
  ``_decay_scatter_fn``, and ``_decay_only_fn``, over a bucket whose active
  count is not a power of two;
* ``host_wake_mask`` and ``active_bucket`` on random mirrors and sizes;
* the python backend's twins (``_py_sparse_window``, ``_py_gather_active``,
  ``_py_active_window``, ``_py_decay_scatter``, ``decay_idle_np``).

Then the decay oracles (``decay_idle`` over the rows the wake predicate
leaves quiescent equals K idle ``node_step`` ticks, scalar and batched), the
sparse capacity's x8 growth, 64-tick shrink hysteresis and its reset by a
burst on the port's engine, and an engine of 100,000 groups ticking on both
backends.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from josefine_tpu.models import chained_raft as jcr
from josefine_tpu.raft import packed_step as jps
from josefine_tpu_torch import interop
from josefine_tpu_torch.models import chained_raft as tcr
from josefine_tpu_torch.models.py_step import (
    PyMsg,
    PyNode,
    decay_idle_np,
    py_decay_idle,
    py_node_step,
)
from josefine_tpu_torch.models.types import FOLLOWER, LEADER, Msgs, NodeState, step_params
from josefine_tpu_torch.raft import packed_step as tps
from josefine_tpu_torch.raft.engine import RaftEngine
from josefine_tpu_torch.utils.kv import MemKV

from torch_parity import (
    STATE_NAMES,
    assert_leaves_equal,
    jax_view_template,
    np_leaves,
    random_case,
    random_inbox_leaves,
    random_params,
    to_jax,
    torch_params,
)

# The JAX programs as the engine builds them, recompiled without donation
# (the tests reuse their inputs) and with XLA's fusion pass off (see
# ``torch_parity.jax_step_unfused``: integer results do not depend on it).
_NOFUSE = {"xla_disable_hlo_passes": "fusion"}


def _jit(program):
    return jax.jit(program.__wrapped__, compiler_options=_NOFUSE)


def _touched(rng, P, N, S, K):
    """A sorted touched-row set of S groups padded to K with id P, and its
    (10, K, N) packed rows (message soup, proposal counts), padding rows
    filled with junk the scatter must drop."""
    idx = np.full(K, P, np.int32)
    idx[:S] = np.sort(rng.choice(P, S, replace=False))
    vals = np.zeros((10, K, N), np.int32)
    vals[:9] = np.stack([a[:K, 0] for a in random_inbox_leaves(rng, max(P, K), N)])
    vals[9, :, 0] = rng.integers(0, 3, K)
    return idx, vals


def _t(a, dtype=None):
    return None if a is None else torch.from_numpy(np.asarray(a, dtype))


def _state_np(state: NodeState) -> list[np.ndarray]:
    return interop.state_to_numpy(state)


@pytest.mark.parametrize("ticks", [1, 8])
@pytest.mark.parametrize("k_out", [40, 4], ids=["fits", "overflows"])
def test_sparse_window_matches_jax(ticks, k_out):
    rng = np.random.default_rng(10 * ticks + k_out)
    P, N = 40, 3
    jfn = _jit(jps._sparse_window_fn(k_out, ticks))
    overflowed = 0
    for trial in range(4):
        me = int(rng.integers(0, N))
        params = random_params(rng)
        view, _, member, pf = random_case(rng, P, N, me)
        idx, vals = _touched(rng, P, N, S=11 + trial, K=16)
        jst, jflat, jsv, jov = jfn(params, jnp.asarray(member), jnp.asarray(me, jnp.int32),
                                   to_jax(jax_view_template(P, N, me), view),
                                   None if pf is None else jnp.asarray(pf),
                                   jnp.asarray(idx), jnp.asarray(vals))
        tst, tflat, tsv, tov = tps._sparse_window_fn(k_out, ticks)(
            torch_params(params), _t(member), torch.tensor([me]),
            interop.state_from_numpy(view, device="cpu"), _t(pf), _t(idx, np.int64),
            _t(vals))
        what = f"k_out={k_out} ticks={ticks} trial {trial}"
        assert_leaves_equal(_state_np(tst), np_leaves(jst), STATE_NAMES, what)
        assert tflat.dtype == torch.int32 and tflat.shape == (1 + k_out + k_out * (10 + 9 * N),)
        assert tflat.numpy().tobytes() == np.asarray(jflat).tobytes(), what
        assert tsv.numpy().tobytes() == np.asarray(jsv).tobytes(), what
        assert tov.numpy().tobytes() == np.asarray(jov).tobytes(), what
        overflowed += int(tflat[0]) > k_out
    assert overflowed == (4 if k_out == 4 else 0), overflowed


def test_py_sparse_window_matches_jax():
    """The python backend's sparse window == the JAX package's, byte for
    byte (both scalar oracles write zeros in cells that carry no message)."""
    rng = np.random.default_rng(3)
    P, N = 12, 3
    for trial, (k_out, ticks) in enumerate(((12, 1), (3, 1), (12, 4), (3, 4))):
        me = trial % N
        params = random_params(rng)
        view, _, member, pf = random_case(rng, P, N, me)
        idx, vals = _touched(rng, P, N, S=5, K=8)
        jst, jflat, jsv, jov = jps._py_sparse_window(
            k_out, params, member, me, to_jax(jax_view_template(P, N, me), view),
            pf, idx, vals, ticks)
        tst, tflat, tsv, tov = tps._py_sparse_window(
            k_out, torch_params(params), _t(member), torch.tensor([me]),
            interop.state_from_numpy(view, device="cpu"), pf, idx, vals, ticks)
        what = f"k_out={k_out} ticks={ticks}"
        assert_leaves_equal(_state_np(tst), np_leaves(jst), STATE_NAMES, what)
        assert tflat.numpy().tobytes() == np.asarray(jflat).tobytes(), what
        assert tsv.numpy().tobytes() == np.asarray(jsv).tobytes(), what
        assert tov.numpy().tobytes() == np.asarray(jov).tobytes(), what


def _bucket(rng, P, A):
    k = tps.active_bucket(A, P)
    idx = np.full(k, P, np.int32)
    idx[:A] = np.sort(rng.choice(P, A, replace=False))
    return idx, k


@pytest.mark.parametrize("ticks", [1, 8])
def test_active_path_matches_jax(ticks):
    """Gather -> compact window -> decay-scatter, and decay alone: the
    gathered rows, the 13-row mirror + outbox flat, the scattered-back
    state and the decayed state all byte-equal to JAX. A = 37 active rows
    in a bucket of 64, so 27 padding ids (P) clamp at the gather and are
    dropped at the scatter."""
    rng = np.random.default_rng(200 + ticks)
    P, N = 100, 3
    jwin = _jit(jps._active_window_fn(ticks))
    jdecay_scatter = _jit(jps._decay_scatter_fn(ticks))
    jdecay_only = _jit(jps._decay_only_fn(ticks))
    for trial in range(3):
        me = int(rng.integers(0, N))
        params = random_params(rng)
        view, _, member, pf = random_case(rng, P, N, me)
        idx, k = _bucket(rng, P, 37)
        assert k == 64
        _, vals = _touched(rng, k, N, S=k, K=k)
        jstate = to_jax(jax_view_template(P, N, me), view)
        jpf = None if pf is None else jnp.asarray(pf)
        jst_c, jmem_c = jps._gather_active(jstate, jnp.asarray(member), jnp.asarray(idx))
        jrows, jflat = jwin(params, jmem_c, jnp.asarray(me, jnp.int32), jst_c,
                            jnp.asarray(vals), jpf)
        jfull = jdecay_scatter(params, jstate, jpf, jnp.asarray(idx), jrows)
        jidle = jdecay_only(params, jstate, jpf)

        tp, tstate, tpf = (torch_params(params), interop.state_from_numpy(view, device="cpu"),
                           _t(pf))
        tidx = _t(idx, np.int64)
        tst_c, tmem_c = tps._gather_active(tstate, _t(member), tidx)
        trows, tflat = tps._active_window_fn(ticks)(tp, tmem_c, torch.tensor([me]), tst_c,
                                                    _t(vals), tpf)
        tfull = tps._decay_scatter_fn(ticks)(tp, tstate, tpf, tidx, trows)
        tidle = tps._decay_only_fn(ticks)(tp, tstate, tpf)

        what = f"ticks={ticks} trial {trial}"
        assert_leaves_equal(_state_np(tst_c), np_leaves(jst_c), STATE_NAMES, what + " gather")
        assert np.array_equal(tmem_c.numpy(), np.asarray(jmem_c)), what
        assert tflat.numpy().tobytes() == np.asarray(jflat).tobytes(), what + " flat"
        assert tflat.shape == (13 * k + 9 * k * N,)
        assert_leaves_equal(_state_np(trows), np_leaves(jrows), STATE_NAMES, what + " rows")
        assert_leaves_equal(_state_np(tfull), np_leaves(jfull), STATE_NAMES, what + " scatter")
        assert_leaves_equal(_state_np(tidle), np_leaves(jidle), STATE_NAMES, what + " decay")
        # The inputs were not written.
        assert_leaves_equal(_state_np(tstate), view, STATE_NAMES, what + " input")


@pytest.mark.parametrize("ticks", [1, 4])
def test_py_active_twins_match_jax(ticks):
    """The python backend's gather, compact window and decay-scatter (and
    decay alone) == the JAX package's scalar twins."""
    rng = np.random.default_rng(300 + ticks)
    P, N = 70, 3
    me = 1
    params = random_params(rng)
    view, _, member, pf = random_case(rng, P, N, me)
    pf = np.asarray([1, 0, 1], np.int32)
    idx, k = _bucket(rng, P, 9)
    _, vals = _touched(rng, k, N, S=k, K=k)
    jstate = to_jax(jax_view_template(P, N, me), view)
    jst_c, jmem_c = jps._py_gather_active(jstate, member, idx)
    jrows, jflat = jps._py_active_window(params, jmem_c, me, jst_c, vals, pf, ticks)
    jfull = jps._py_decay_scatter(params, jstate, pf, idx, jrows, ticks)
    jidle = jcr.decay_idle(params, jax.tree.map(np.array, jstate), pf, ticks, xp=np)

    tp, tstate = torch_params(params), interop.state_from_numpy(view, device="cpu")
    tst_c, tmem_c = tps._py_gather_active(tstate, _t(member), idx)
    trows, tflat = tps._py_active_window(tp, tmem_c, torch.tensor([me]), tst_c, vals, pf, ticks)
    tfull = tps._py_decay_scatter(tp, tstate, pf, idx, trows, ticks)
    tidle = tps._py_decay_scatter(tp, tstate, pf, None, None, ticks)

    view_j = lambda s: [np.asarray(a) for a in jax.tree.leaves(s)]
    assert_leaves_equal(
        [a.view(np.uint32) if i == 12 else a for i, a in enumerate(tst_c.leaves())],
        view_j(jst_c), STATE_NAMES, "gather")
    assert np.array_equal(tmem_c, np.asarray(jmem_c))
    assert tflat.numpy().tobytes() == np.asarray(jflat).tobytes(), "flat"
    assert_leaves_equal(_state_np(trows), view_j(jrows), STATE_NAMES, "rows")
    assert_leaves_equal(_state_np(tfull), view_j(jfull), STATE_NAMES, "scatter")
    assert_leaves_equal(_state_np(tidle), view_j(jidle), STATE_NAMES, "decay")


def test_decay_idle_np_matches_jax():
    rng = np.random.default_rng(17)
    P, N = 300, 5
    for trial in range(6):
        params = random_params(rng)
        view, _, _, pf = random_case(rng, P, N, trial % N)
        ticks = int(rng.integers(1, 9))
        want = jcr.decay_idle(params, to_jax(jax_view_template(P, N, 0), view), pf, ticks, xp=np)
        got = decay_idle_np(int(params.hb_ticks), NodeState.from_leaves(
            [a.copy() for a in view]), pf, ticks)
        assert_leaves_equal(got.leaves(), np_leaves(want), STATE_NAMES, f"trial {trial}")


def test_host_wake_mask_and_bucket_match_jax():
    rng = np.random.default_rng(23)
    for trial in range(40):
        P, N = int(rng.integers(1, 400)), int(rng.integers(1, 8))
        hb = int(rng.integers(1, 20))
        window = int(rng.integers(1, 9))
        args = (hb, rng.integers(0, 4, P), rng.integers(-1, N, P),
                rng.integers(0, 30, P).astype(np.int32), rng.integers(3, 12, P).astype(np.int32),
                rng.integers(0, hb * 10, P).astype(np.int32), rng.random(P) < 0.9,
                rng.random(P) < 0.8, rng.integers(0, 2, N).astype(np.int32), window)
        got, want = tps.host_wake_mask(*args), jps.host_wake_mask(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want), trial
    for P in (1, 50, 63, 64, 65, 1000, 4096, 100_000):
        for n in list(range(0, 300)) + [1000, 4095, 4096, 4097, 70_000, 100_000]:
            assert tps.active_bucket(n, P) == jps.active_bucket(n, P), (n, P)


# ---------------------------------------------------------------- decay oracles


def _settled_nodes(rng, n_rows, N=3, hb_ticks=8):
    """Random scalar states run through ONE idle step so non-timer fields
    sit at their idle fixed point (an idle leader's nxt rows equal its head,
    commit is quorum-stable): the invariant the engine maintains for every
    row the scheduler can leave quiescent."""
    nodes = []
    for _ in range(n_rows):
        role = int(rng.choice([FOLLOWER, FOLLOWER, LEADER]))
        head = (int(rng.integers(0, 4)), int(rng.integers(0, 50)))
        me = int(rng.integers(0, N))
        st = PyNode(
            n=N, me=me, seed=int(rng.integers(0, 2**32)),
            term=max(head[0], int(rng.integers(0, 5))),
            voted_for=int(rng.choice([-1, 0, 1, 2])), role=role,
            leader=me if role == LEADER else int(rng.choice([-1, 0, 1, 2])),
            head=head, commit=(0, 0), elapsed=int(rng.integers(0, 6)),
            timeout=int(rng.integers(3, 9)), hb_elapsed=int(rng.integers(0, hb_ticks * 9)),
            alive=bool(rng.random() > 0.1),
        )
        if role == LEADER:
            st.match = [head if j == me else (0, int(rng.integers(0, head[1] + 1)))
                        for j in range(N)]
            st.nxt = [head] * N
            st.hb_elapsed = int(rng.integers(1, hb_ticks))
        member = [True] * N
        pf = [bool(rng.random() > 0.3) for _ in range(N)]
        st, _, _ = py_node_step(st, member, [PyMsg() for _ in range(N)], 0, 3, 8, hb_ticks,
                                peer_fresh=pf)
        nodes.append((st, member, pf))
    return nodes


def _wake(st: PyNode, member, pf, window, hb_ticks=8) -> bool:
    m = tps.host_wake_mask(
        hb_ticks, np.asarray([st.role]), np.asarray([st.leader]), np.asarray([st.elapsed]),
        np.asarray([st.timeout]), np.asarray([st.hb_elapsed]), np.asarray([st.alive]),
        np.asarray([member[st.me]]), np.asarray(pf, np.int32), window)
    return bool(m[0])


def test_decay_oracle_scalar():
    """py_decay_idle == K idle py_node_step ticks on every row the port's
    wake predicate leaves quiescent, and those ticks send nothing."""
    rng = np.random.default_rng(7)
    checked = 0
    for st, member, pf in _settled_nodes(rng, 400):
        for K in (1, 2, 4, 8):
            if _wake(st, member, pf, K):
                continue
            full = st
            for _ in range(K):
                full, out, met = py_node_step(full, member, [PyMsg() for _ in range(st.n)],
                                              0, 3, 8, 8, peer_fresh=pf)
                assert all(m.kind == 0 for m in out), "quiescent row emitted a message"
                assert not met.became_leader and met.minted == 0
            assert full == py_decay_idle(st, K, 8, peer_fresh=pf), f"K={K}"
            checked += 1
    assert checked > 200  # the filter must leave a real population


def test_decay_oracle_torch():
    """The port's decay_idle (and decay_idle_np) == K idle node_step ticks
    on the rows the wake predicate leaves quiescent, over the batched step
    (each row's own node slot)."""
    rng = np.random.default_rng(11)
    N, hb = 3, 8
    nodes = _settled_nodes(rng, 128, N=N, hb_ticks=hb)
    pf = np.asarray([1, 0, 1], np.int32)
    P = len(nodes)
    params = step_params(timeout_min=3, timeout_max=8, hb_ticks=hb, device="cpu")
    col = lambda f, dt=np.int32: np.asarray([f(s) for s, _, _ in nodes], dt)
    ids2 = lambda f: (np.asarray([[t for t, _ in f(s)] for s, _, _ in nodes], np.int32),
                      np.asarray([[x for _, x in f(s)] for s, _, _ in nodes], np.int32))
    leaves = [col(lambda s: s.term), col(lambda s: s.voted_for), col(lambda s: s.role),
              col(lambda s: s.leader), col(lambda s: s.head[0]), col(lambda s: s.head[1]),
              col(lambda s: s.commit[0]), col(lambda s: s.commit[1]),
              col(lambda s: s.elapsed), col(lambda s: s.timeout), col(lambda s: s.hb_elapsed),
              col(lambda s: s.alive, bool), col(lambda s: s.seed & 0xFFFFFFFF, np.int64)
              .astype(np.uint32).view(np.int32), np.zeros((P, N), bool),
              *ids2(lambda s: s.match), *ids2(lambda s: s.nxt)]
    state = NodeState.from_leaves([torch.from_numpy(a) for a in leaves])
    mes = col(lambda s: s.me)
    member = torch.ones((P, N), dtype=torch.bool)
    empty = Msgs.from_leaves([torch.zeros((P, N), dtype=torch.int32)] * 9)
    props = torch.zeros(P, dtype=torch.int32)
    for K in (1, 3, 8):
        wake = tps.host_wake_mask(hb, leaves[2], leaves[3], leaves[8], leaves[9], leaves[10],
                                  leaves[11], np.ones(P, bool), pf, K)
        quiet = ~wake
        assert quiet.sum() > 20
        fast = tcr.decay_idle(params, state, torch.from_numpy(pf), K)
        fast_np = decay_idle_np(hb, NodeState.from_leaves(leaves), pf, K)
        for me in range(N):
            rows = np.nonzero(quiet & (mes == me))[0]
            sub = NodeState.from_leaves([a[rows] for a in state.leaves()])
            full, sent = sub, torch.zeros(len(rows), dtype=torch.bool)
            for _ in range(K):
                full, out, _ = tps._step_node(params, member[rows], torch.tensor([me]), full,
                                              Msgs.from_leaves([a[rows] for a in empty.leaves()]),
                                              props[rows], torch.from_numpy(pf))
                sent |= (out.kind != 0).any(-1)
            assert not sent.any()
            for i, name in enumerate(STATE_NAMES):
                assert torch.equal(full.leaves()[i], fast.leaves()[i][rows]), (K, me, name)
                assert np.array_equal(fast_np.leaves()[i][rows], full.leaves()[i].numpy())


# ------------------------------------------------------- sparse capacity


def _single_node(P=8192):
    # timeout_min == timeout_max: every group's election timer fires on the
    # SAME tick — one clean burst bigger than the 4096 capacity floor.
    return RaftEngine(MemKV(), [0], 0, groups=P,
                      params=step_params(timeout_min=3, timeout_max=3, hb_ticks=16,
                                         device="cpu"),
                      sparse_io=True, device="cpu")


def test_sparse_outbox_capacity_shrinks_after_quiet_run():
    """The compaction capacity grows x8 on a burst and comes back down a
    level after 64 quiet ticks (the per-tick fetch is the FULL capacity
    buffer, so it must not stay burst-sized)."""

    async def main():
        e = _single_node()
        assert e._k_out == 4096
        for _ in range(10):  # cold start: every group elects itself at tick 3
            e.tick()
        assert e._k_out == 8192, e._k_out
        for _ in range(80):
            e.tick()
        assert e._k_out == 4096, e._k_out
        # The resized program still carries live work.
        fut = e.propose(7, b"after-shrink")
        for _ in range(4):
            e.tick()
            await asyncio.sleep(0)
        assert fut.done() and not fut.exception()
        assert (await fut) == b""  # no FSM: bare commit ack

    asyncio.run(main())


def test_sparse_outbox_shrink_hysteresis_resets_on_burst():
    """The 64-tick hysteresis counts CONSECUTIVE quiet ticks: a burst
    (total * 2 > the shrink target) restarts it."""

    async def main():
        e = _single_node()
        for _ in range(10):
            e.tick()
        assert e._k_out == 8192
        for _ in range(40):
            e.tick()
        assert e._k_out == 8192 and e._k_out_quiet > 10
        for g in range(2500):  # more changed rows than half the 4096 target
            e.propose(g, b"x")
        e.tick()
        await asyncio.sleep(0)
        assert e._k_out_quiet == 0 and e._k_out == 8192
        for _ in range(30):
            e.tick()
        assert e._k_out == 8192, "shrink fired before the restarted hysteresis"
        for _ in range(80):
            e.tick()
        assert e._k_out == 4096, e._k_out

    asyncio.run(main())


@pytest.mark.parametrize("backend,active", [("torch", False), ("torch", True),
                                            ("python", True)])
def test_engine_runs_100k_groups_on_the_host(backend, active):
    """The scale the system is built for: 100,000 groups pick sparse IO by
    default, with or without the active set, and tick on either backend."""
    e = RaftEngine(MemKV(), [0, 1, 2], 0, groups=100_000,
                   params=step_params(timeout_min=3, timeout_max=8, hb_ticks=16,
                                      device="cpu"),
                   backend=backend, active_set=active, device="cpu")
    assert e._sparse and e._active_set == active and e._k_out == 4096
    res = e.tick()
    assert e._ticks == 1 and len(res.outbound) == 2  # a keepalive ping per peer
    assert e.active_fallback_ticks == int(active)  # every row is leaderless
