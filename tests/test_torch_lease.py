"""PyTorch port, the leader-lease plane: ``RaftEngine(leases=True)``.

The lane itself (``raft/lease.py``) is a copy of the JAX package's module,
held source-equal by ``test_torch_copies.py``. What the port adds around it
is the engine's side: the ack credit at intake (and, with a route fabric, at
the route decision), ``_lease_finish`` with the device lease plane, the
serve gate, read barriers and the invalidation on reset, recycle, claim and
membership changes. Held here two ways:

* **twin-for-twin** against the JAX engine: the lifecycle cases of the JAX
  package's lease suite (grant and serve, expiry under isolation with no
  overlap, recycle, migration freeze, read barriers) run on a JAX cluster
  and a port cluster side by side, and after every tick the port's holders,
  expiries, lane summaries, lease planes, host mirrors and journals (lease
  events included) must equal the JAX cluster's;
* **observation-only**: a port cluster with leases on equals a JAX cluster
  with leases off on the wire, in state and in the journal, every tick.
"""

from __future__ import annotations


import numpy as np
import pytest

from josefine_tpu.models.types import step_params as jax_step_params
from josefine_tpu.raft.engine import RaftEngine as JaxEngine
from josefine_tpu.utils.kv import MemKV as JaxKV
from josefine_tpu_torch.models.types import step_params
from josefine_tpu_torch.raft.engine import RaftEngine
from josefine_tpu_torch.utils.kv import MemKV

from test_torch_engine import ListFsm, Twin, drizzle, h_mirrors
from test_torch_route import _run_routed

# check_lease_params needs timeout_min > hb_ticks + 2.
TIMEOUTS, HB = (4, 8), 1


class LeaseTwin:
    """``n`` JAX and ``n`` port engines with leases on (and lease events
    journaled), ticked in lockstep with next-tick delivery and a symmetric
    isolation set: traffic crossing it is dropped both ways, while the
    isolated engines keep ticking (the partition the lease argument is
    about)."""

    def __init__(self, n=3, groups=1):
        ids_ = [10 * (i + 1) for i in range(n)]
        kw = dict(timeout_min=TIMEOUTS[0], timeout_max=TIMEOUTS[1], hb_ticks=HB)
        common = dict(groups=groups, base_seed=7, leases=True, flight_lease=True)
        self.jx = [JaxEngine(JaxKV(), ids_, ids_[i], fsms={0: ListFsm()},
                             params=jax_step_params(**kw), **common) for i in range(n)]
        self.pt = [RaftEngine(MemKV(), ids_, ids_[i], fsms={0: ListFsm()},
                              params=step_params(**kw, device="cpu"), device="cpu",
                              **common) for i in range(n)]
        self.groups = groups
        self.tick_no = 0

    def run(self, n, isolated=()):
        for _ in range(n):
            for side in (self.jx, self.pt):
                results = [(i, e.tick()) for i, e in enumerate(side)]
                for _i, res in results:
                    for m in res.outbound:
                        if m.dst < len(side) and (m.src in isolated) == (m.dst in isolated):
                            side[m.dst].receive(m)
            self.compare(f"tick {self.tick_no}")
            self.tick_no += 1

    def compare(self, what):
        for i, (et, ej) in enumerate(zip(self.pt, self.jx)):
            w = f"{what} engine {i}"
            for k, a in h_mirrors(et).items():
                np.testing.assert_array_equal(a, vars(ej)[k], err_msg=f"{w} {k}")
            for g in range(self.groups):
                assert et.lease_valid(g) == ej.lease_valid(g), w
                assert et.lease_expiry(g) == ej.lease_expiry(g), w
            assert et.lease_summary() == ej.lease_summary(), w
            assert (et._lease_plane is None) == (ej._lease_plane is None), w
            if et._lease_plane is not None:
                assert np.array_equal(et._lease_plane.numpy(), np.asarray(ej._lease_plane)), w
            assert et.flight.events() == ej.flight.events(), w

    def serve(self, i, g=0):
        """``lease_serve`` on both sides (it journals a refusal)."""
        got = self.pt[i].lease_serve(g)
        assert got == self.jx[i].lease_serve(g)
        return got

    def holders(self, g=0):
        return [i for i, e in enumerate(self.pt) if e.lease_valid(g)]

    def wait_leader(self, g=0, isolated=(), max_ticks=120):
        """Tick until the non-isolated majority agrees on one leader."""
        for _ in range(max_ticks):
            self.run(1, isolated=isolated)
            live = [i for i in range(len(self.pt)) if i not in isolated]
            leaders = [i for i in live if self.pt[i].is_leader(g)]
            if len(leaders) == 1 and all(self.pt[i].leader_index(g) == leaders[0]
                                         for i in live):
                return leaders[0]
        raise AssertionError("no leader elected")

    def wait_lease(self, lead, g=0, max_ticks=20, **kw):
        for _ in range(max_ticks):
            if self.pt[lead].lease_valid(g):
                return
            self.run(1, **kw)
        raise AssertionError(f"node {lead} never acquired a lease on {g}")


def test_lease_grant_serve_and_follower_refusal():
    twin = LeaseTwin()
    lead = twin.wait_leader()
    twin.wait_lease(lead)
    assert twin.holders() == [lead]
    assert twin.serve(lead) == (True, "ok")
    exp = twin.pt[lead].lease_expiry(0)
    assert twin.pt[lead]._ticks < exp <= twin.pt[lead]._ticks + TIMEOUTS[0]
    for i in range(3):
        if i != lead:
            assert twin.serve(i) == (False, "not_leader")
            assert twin.pt[i].lease_expiry(0) is None
    twin.compare("after serves")
    # Leases off: the gate reports "off" and never serves.
    off = RaftEngine(MemKV(), [10, 20, 30], 10, groups=1, device="cpu",
                     params=step_params(timeout_min=4, timeout_max=8, hb_ticks=1,
                                        device="cpu"))
    assert off.lease_serve(0) == (False, "off") and off.lease_summary() is None


def test_lease_expires_under_isolation_and_never_overlaps():
    """The holder is cut off symmetrically but keeps ticking (pre-vote
    keeps its belief that it leads); its lease must expire within
    timeout_min ticks, and at no tick do two engines hold one. The new
    holder's term exceeds the old; on heal one holder remains."""
    twin = LeaseTwin()
    lead = twin.wait_leader()
    twin.wait_lease(lead)
    old_term = twin.pt[lead].term(0)
    for _ in range(TIMEOUTS[0] + 2):
        twin.run(1, isolated=(lead,))
        assert len(twin.holders()) <= 1
    assert not twin.pt[lead].lease_valid(0) and twin.pt[lead].is_leader(0)
    assert twin.serve(lead) == (False, "expired")
    new = twin.wait_leader(isolated=(lead,))
    assert new != lead
    twin.wait_lease(new, isolated=(lead,))
    assert twin.holders() == [new] and twin.pt[new].term(0) > old_term
    for _ in range(2 * TIMEOUTS[1]):
        twin.run(1)
        assert len(twin.holders()) <= 1
    assert not twin.pt[lead].is_leader(0)
    assert twin.serve(lead) == (False, "not_leader")
    assert twin.holders() == [twin.wait_leader()]


def test_recycle_invalidates_lease_and_queues():
    twin = LeaseTwin(groups=2)
    lead = twin.wait_leader(g=1)
    twin.wait_lease(lead, g=1)
    for e in twin.jx + twin.pt:
        e.recycle_group(1)
        e.set_group_incarnation(1, 1)
    twin.compare("after recycle")
    # Immediate: a straggler ack of the dead incarnation finds disarmed
    # queues.
    lane = twin.pt[lead]._lease
    assert not twin.pt[lead].lease_valid(1)
    assert lane.ev_term[1] == -1 and lane._q_len[1].sum() == 0
    lead2 = twin.wait_leader(g=1)
    twin.wait_lease(lead2, g=1)


def test_migration_freeze_refuses_then_unfreeze_restores():
    twin = LeaseTwin(groups=2)
    lead = twin.wait_leader(g=1)
    twin.wait_lease(lead, g=1)
    for side in (twin.jx, twin.pt):
        side[lead].freeze_group(1)
    assert not twin.pt[lead].lease_valid(1)
    assert twin.serve(lead, 1) == (False, "frozen")
    # The freeze keeps the evidence (the handoff may abort), so unfreeze
    # restores the lease at once.
    for side in (twin.jx, twin.pt):
        side[lead].unfreeze_group(1)
    assert twin.serve(lead, 1) == (True, "ok")
    twin.compare("after unfreeze")


async def test_read_barrier_semantics():
    """A leader's barrier resolves True once a quorum acks ships made after
    it; a follower's resolves False at once; a single-node group is its own
    quorum and resolves True inline."""
    twin = LeaseTwin()
    lead = twin.wait_leader()
    futs = [side[lead].read_barrier(0) for side in (twin.jx, twin.pt)]
    assert not any(f.done() for f in futs)
    twin.run(2 * HB + 3)
    assert all(f.done() for f in futs) and [await f for f in futs] == [True, True]
    follower = next(i for i in range(3) if i != lead)
    futs = [side[follower].read_barrier(0) for side in (twin.jx, twin.pt)]
    assert all(f.done() for f in futs) and [await f for f in futs] == [False, False]
    solo = LeaseTwin(n=1)
    solo.wait_leader()
    assert solo.pt[0].lease_valid(0), "n=1 lease rolls with no peers"
    fut = solo.pt[0].read_barrier(0)
    assert fut.done() and (await fut) is True


async def test_read_barrier_fails_on_leadership_loss():
    twin = LeaseTwin()
    lead = twin.wait_leader()
    futs = [side[lead].read_barrier(0) for side in (twin.jx, twin.pt)]
    for _ in range(3 * TIMEOUTS[1]):
        twin.run(1, isolated=(lead,))
        if futs[1].done():
            break
    new = twin.wait_leader(isolated=(lead,))
    assert new != lead
    for _ in range(3 * TIMEOUTS[1]):
        if futs[1].done():
            break
        twin.run(1)
    assert [f.done() for f in futs] == [True, True]
    assert [await f for f in futs] == [False, False]


# ------------------------------------------------ observation-only


async def _leases_vs_off(window=1, mode="split", **kw):
    """The port with leases on against the JAX engine with leases off,
    through elections, a proposal drizzle, engine 2 cut off for ticks 30-44
    and a recycle of group 3 at tick 50: ``Twin`` holds wire bytes, state,
    mirrors, chains and journals equal every tick, so the lane changes
    nothing the step or the wire sees. The port must actually hold leases
    along the way."""
    twin = Twin(hb_ticks=HB, timeouts=TIMEOUTS, port_kw=dict(leases=True), **kw)
    held = 0
    for t in range(75):
        twin.cut = {2} if 30 <= t < 45 else set()
        if t >= 20:
            drizzle(twin, t)
        if t == 50:
            for e in twin.jx + twin.pt:
                e.recycle_group(3)
                e.set_group_incarnation(3, 1)
        twin.step(window, mode)
        held += sum(e.lease_valid(g) for e in twin.pt for g in (0, 1))
    for e in twin.jx + twin.pt:
        if e.pipeline_window:
            e.tick_drain()
    twin.compare("drained")
    assert held > 0, "the port never held a lease"
    assert all(e.lease_summary() is None for e in twin.jx)
    assert sum(e.lease_summary()["credits"] for e in twin.pt) > 0


@pytest.mark.parametrize("kw", [
    {},
    pytest.param(dict(active_set=True), marks=pytest.mark.slow),
    pytest.param(dict(mode="pipelined"), marks=pytest.mark.slow),
    pytest.param(dict(sparse_io=True), marks=pytest.mark.slow),
], ids=["dense", "active", "pipelined", "sparse"])
async def test_twin_differential_leases_vs_off(kw):
    await _leases_vs_off(**kw)


@pytest.mark.slow
async def test_twin_differential_leases_routed_fabric():
    """Leases on both sides of the routed twin (the JAX cluster on its
    fabric, the port's on its own): the lane's credit for routed
    APPEND_RESP rows comes from the route decision, and every lease event,
    summary and plane equals the JAX engine's."""
    twin = await _run_routed(hb_ticks=HB, timeouts=TIMEOUTS, leases=True, flight_lease=True)
    assert sum(e.lease_summary()["credits"] for e in twin.pt) > 0
    assert any(ev["kind"] == "lease_acquired" for e in twin.pt for ev in e.flight.events())
