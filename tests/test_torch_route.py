"""PyTorch port, device-resident delivery: the route fabric and payload ring.

Function level, against the JAX package on numpy-seeded inputs: the window
steps with a routed inbox plane merged (dense, sparse, active; the python
backend's sparse twin) and the plane programs (route scatters, plane merge
and purge, ring scatter and gather, the lease-plane scatter). The JAX
programs take bucket-padded index vectors; the port's take exactly the rows
they write, so both are fed the same rows and compared.

Cluster level, the twin cluster of ``test_torch_engine.py`` with a fabric on
each side: three JAX engines on the JAX ``RouteFabric`` and three port
engines on the port's, fed the same ``receive``/``propose`` schedule and the
same ``flush`` barrier. On every tick they must agree on everything
``Twin.compare`` checks (mirrors, state, chains, FSM applies, wire bytes,
the journal) and on the fabric itself: the routed/host split, the ready
planes and kind mirrors, ``pending_counts``, ``ring_stats``, the ring-fed
blocks and the ring buffers. The port alone must also keep the fabric's own
invariant: a routed cluster equals a host-only cluster, and its wire traffic
is the host-only traffic less exactly the rows the decision table routes.
Then the inbox builders' routed occupancy and the router's units.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from josefine_tpu.raft import packed_step as jps
from josefine_tpu.raft import rpc as jrpc
from josefine_tpu.raft.chain import Block as JaxBlock
from josefine_tpu.raft.engine import RaftEngine as JaxEngine
from josefine_tpu.raft.route import RouteFabric as JaxFabric
from josefine_tpu.utils.kv import MemKV as JaxKV
from josefine_tpu.models.types import step_params as jax_step_params
from josefine_tpu_torch import interop
from josefine_tpu_torch.models.types import step_params
from josefine_tpu_torch.raft import packed_step as tps
from josefine_tpu_torch.raft import route as troute
from josefine_tpu_torch.raft import rpc
from josefine_tpu_torch.raft.chain import GENESIS, Block, pack_id
from josefine_tpu_torch.raft.engine import RaftEngine
from josefine_tpu_torch.raft.group_admin import _PAROLE_DROP_ARR
from josefine_tpu_torch.raft.route import _ROUTED_ALWAYS, RouteFabric
from josefine_tpu_torch.utils.kv import MemKV

from test_torch_engine import IDS, ListFsm, Twin, _retrieve, h_mirrors
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

_NOFUSE = {"xla_disable_hlo_passes": "fusion"}


def _jit(program):
    return jax.jit(program.__wrapped__, compiler_options=_NOFUSE)


def _t(a, dtype=None):
    return None if a is None else torch.from_numpy(np.asarray(a, dtype))


def _random_plane(rng, P, N):
    """A routed inbox plane: about half the (group, src) slots claimed with
    a nonzero kind and random fields, the rest zero."""
    plane = np.stack([a[:, 0] for a in random_inbox_leaves(rng, P, N)]).astype(np.int32)
    plane[0] = np.where(rng.random((P, N)) < 0.5, rng.integers(1, 7, (P, N)), 0)
    return np.where(plane[0:1] != 0, plane, 0).astype(np.int32)


# ------------------------------------------------------- function level


@pytest.mark.parametrize("ticks", [1, 8])
def test_routed_windows_match_jax(ticks):
    """Dense, sparse and active window steps with a routed plane merged
    under the host inbox == the JAX ``*_routed_fn`` programs, byte for
    byte (the sparse compaction fits in one trial and overflows in the
    other)."""
    rng = np.random.default_rng(40 + ticks)
    P, N = 40, 3
    jdense = _jit(jps._window_step_routed_fn(ticks))
    jactive = _jit(jps._active_window_routed_fn(ticks))
    for trial, k_out in enumerate((40, 4)):
        me = int(rng.integers(0, N))
        params = random_params(rng)
        view, in10, member, pf = random_case(rng, P, N, me)
        plane = _random_plane(rng, P, N)
        jstate = to_jax(jax_view_template(P, N, me), view)
        jpf = None if pf is None else jnp.asarray(pf)
        jme = jnp.asarray(me, jnp.int32)
        tp, tstate, tme = (torch_params(params), interop.state_from_numpy(view, device="cpu"),
                           torch.tensor([me]))
        what = f"ticks={ticks} trial {trial}"

        jst, jflat = jdense(params, jnp.asarray(member), jme, jstate, jnp.asarray(in10),
                            jnp.asarray(plane), jpf)
        tst, tflat = tps._window_step_fn(ticks)(tp, _t(member), tme, tstate, _t(in10),
                                                _t(pf), _t(plane))
        assert_leaves_equal(interop.state_to_numpy(tst), np_leaves(jst), STATE_NAMES,
                            what + " dense")
        assert tflat.numpy().tobytes() == np.asarray(jflat).tobytes(), what + " dense"

        idx = np.full(16, P, np.int32)
        idx[:9] = np.sort(rng.choice(P, 9, replace=False))
        vals = np.zeros((10, 16, N), np.int32)
        vals[:9] = np.stack([a[:16, 0] for a in random_inbox_leaves(rng, P, N)])
        vals[9, :, 0] = rng.integers(0, 3, 16)
        jsp = _jit(jps._sparse_window_routed_fn(k_out, ticks))(
            params, jnp.asarray(member), jme, jstate, jpf, jnp.asarray(idx),
            jnp.asarray(vals), jnp.asarray(plane))
        tsp = tps._sparse_window_fn(k_out, ticks)(tp, _t(member), tme, tstate, _t(pf),
                                                  _t(idx, np.int64), _t(vals), _t(plane))
        assert_leaves_equal(interop.state_to_numpy(tsp[0]), np_leaves(jsp[0]),
                            STATE_NAMES, what + " sparse")
        for a, b in zip(tsp[1:], jsp[1:]):
            assert a.numpy().tobytes() == np.asarray(b).tobytes(), what + " sparse"

        # Active: 21 rows in a bucket of 32, the 11 padding ids (P) masked.
        aidx = np.full(32, P, np.int32)
        aidx[:21] = np.sort(rng.choice(P, 21, replace=False))
        cvals = np.zeros((10, 32, N), np.int32)
        cvals[:9] = np.stack([a[:32, 0] for a in random_inbox_leaves(rng, P, N)])
        jst_c, jmem_c = jps._gather_active(jstate, jnp.asarray(member), jnp.asarray(aidx))
        jrows, jaflat = jactive(params, jmem_c, jme, jst_c, jnp.asarray(cvals),
                                jnp.asarray(plane), jnp.asarray(aidx), jpf)
        tst_c, tmem_c = tps._gather_active(tstate, _t(member), _t(aidx, np.int64))
        trows, taflat = tps._active_window_fn(ticks)(tp, tmem_c, tme, tst_c, _t(cvals),
                                                     _t(pf), _t(plane), _t(aidx, np.int64))
        assert_leaves_equal(interop.state_to_numpy(trows), np_leaves(jrows), STATE_NAMES,
                            what + " active")
        assert taflat.numpy().tobytes() == np.asarray(jaflat).tobytes(), what + " active"
        # The numpy gather the python backend runs == the JAX gather.
        assert np.array_equal(tps._gather_routed(plane, aidx),
                              np.asarray(jps._gather_routed(np, plane, aidx)))


def test_py_sparse_window_routed_matches_jax():
    rng = np.random.default_rng(5)
    P, N = 12, 3
    for trial, (k_out, ticks) in enumerate(((12, 1), (3, 4))):
        me = trial % N
        params = random_params(rng)
        view, _, member, pf = random_case(rng, P, N, me)
        plane = _random_plane(rng, P, N)
        idx = np.full(8, P, np.int32)
        idx[:5] = np.sort(rng.choice(P, 5, replace=False))
        vals = np.zeros((10, 8, N), np.int32)
        vals[:9] = np.stack([a[:8, 0] for a in random_inbox_leaves(rng, P, N)])
        jout = jps._py_sparse_window(k_out, params, member, me,
                                     to_jax(jax_view_template(P, N, me), view), pf, idx,
                                     vals, ticks, routed=plane)
        tout = tps._py_sparse_window(k_out, torch_params(params), _t(member),
                                     torch.tensor([me]),
                                     interop.state_from_numpy(view, device="cpu"), pf, idx,
                                     vals, ticks, routed=plane)
        assert_leaves_equal(interop.state_to_numpy(tout[0]), np_leaves(jout[0]),
                            STATE_NAMES, f"trial {trial}")
        for a, b in zip(tout[1:], jout[1:]):
            assert a.numpy().tobytes() == np.asarray(b).tobytes(), f"trial {trial}"


def test_plane_programs_match_jax():
    """The route scatters (device source and host values), the first-
    writer plane merge, the row purge, the payload ring's scatter and
    gather and the lease-plane scatter == the JAX programs, on torch
    tensors and on the python backend's numpy arrays."""
    rng = np.random.default_rng(77)
    P, N, S, W = 50, 3, 4, 6
    for trial in range(3):
        src = _random_plane(rng, P, N)
        n = int(rng.integers(1, 30))
        gids = np.sort(rng.choice(P, n, replace=False)).astype(np.int64)
        srows = rng.choice(P, n).astype(np.int64)
        dst, me = int(rng.integers(0, N)), int(rng.integers(0, N))
        B = jps.route_bucket(n, P)
        srows_b, gids_b = np.zeros(B, np.int32), np.full(B, P, np.int32)
        srows_b[:n], gids_b[:n] = srows, gids
        jplane = jps._route_scatter_new_fn(B, P, N)(
            jnp.asarray(src), jnp.asarray(srows_b), jnp.asarray(gids_b),
            jnp.asarray(dst, jnp.int32), jnp.asarray(me, jnp.int32))
        vals = rng.integers(-5, 9, (9, n)).astype(np.int32)
        vals_b = np.zeros((9, B), np.int32)
        vals_b[:, :n] = vals
        me2 = (me + 1) % N
        jplane = jps._route_scatter_vals_fn(B)(jplane, jnp.asarray(vals_b),
                                               jnp.asarray(gids_b), jnp.asarray(me2, jnp.int32))
        for xp in (torch, np):
            conv = (lambda a: torch.from_numpy(np.asarray(a))) if xp is torch else np.asarray
            plane = conv(np.zeros((9, P, N), np.int32))
            tps._route_scatter(plane, conv(src), conv(srows), conv(gids), dst, me)
            tps._route_scatter_vals(plane, conv(vals), conv(gids), me2)
            assert np.array_equal(np.asarray(plane), np.asarray(jplane)), (trial, xp)

        ready, staging = _random_plane(rng, P, N), _random_plane(rng, P, N)
        assert np.array_equal(tps._merge_planes_fn(_t(ready), _t(staging)).numpy(),
                              np.asarray(jps._merge_planes_fn(ready, staging)))
        g = int(rng.integers(0, P))
        keep = rng.random(N) < 0.5
        want = np.asarray(jps._purge_plane_row_fn(jnp.asarray(ready), g, jnp.asarray(keep)))
        for conv in (torch.from_numpy, np.array):
            got = conv(ready.copy())
            tps._purge_plane_row_fn(got, g, conv(np.nonzero(~keep)[0]))
            assert np.array_equal(np.asarray(got), want), trial

        buf = rng.integers(-9, 9, (P, S, W)).astype(np.int32)
        k = int(rng.integers(1, 40))
        pairs = rng.choice(P * S, k, replace=False)
        rg, rs = (pairs // S).astype(np.int64), (pairs % S).astype(np.int64)
        words = rng.integers(-2**31, 2**31 - 1, (k, W)).astype(np.int32)
        RB = jps.ring_bucket(k, P * S)
        rg_b, rs_b = np.full(RB, P, np.int32), np.zeros(RB, np.int32)
        rg_b[:k], rs_b[:k] = rg, rs
        words_b = np.zeros((RB, W), np.int32)
        words_b[:k] = words
        jbuf = jps._ring_scatter_fn(RB)(jnp.asarray(buf), jnp.asarray(rg_b),
                                        jnp.asarray(rs_b), jnp.asarray(words_b))
        jread = np.asarray(jps._ring_gather_fn(RB)(jbuf, jnp.asarray(rg_b),
                                                   jnp.asarray(rs_b)))[:k]
        for conv in (torch.from_numpy, np.array):
            tbuf = conv(buf.copy())
            tps._ring_scatter(tbuf, conv(rg), conv(rs), conv(words))
            assert np.array_equal(np.asarray(tbuf), np.asarray(jbuf)), trial
            assert np.array_equal(np.asarray(tps._ring_gather(tbuf, conv(rg), conv(rs))),
                                  jread)

        lease = rng.integers(-3, 100, (P, 3)).astype(np.int64)
        rows = np.sort(rng.choice(P, 7, replace=False)).astype(np.int64)
        lvals = rng.integers(-3, 100, (7, 3)).astype(np.int64)
        LB = jps.route_bucket(7, P)
        rows_b, lvals_b = np.full(LB, P, np.int32), np.zeros((LB, 3), np.int64)
        rows_b[:7], lvals_b[:7] = rows, lvals
        # The JAX package runs without 64-bit mode, so its plane holds the
        # same values as int32.
        jlease = np.asarray(jps._lease_plane_scatter_fn(
            jnp.asarray(lease.astype(np.int32)), jnp.asarray(rows_b),
            jnp.asarray(lvals_b.astype(np.int32))))
        tlease = torch.from_numpy(lease.copy())
        tps._lease_plane_scatter_fn(tlease, torch.from_numpy(rows), torch.from_numpy(lvals))
        assert np.array_equal(tlease.numpy(), jlease), trial


# ------------------------------------------------------- the routed twin


def fabric_view(fab) -> dict:
    """Everything a fabric holds that routing decides: its counters, the
    ready planes and mirrors, the ring-fed blocks, the staged rows and the
    payload rings (metadata and buffers)."""
    arr = lambda a: None if a is None else np.asarray(a).tobytes()
    blocks = lambda store: {s: {g: sorted((b, v.parent, v.data) for b, v in m.items())
                                for g, m in gm.items()} for s, gm in store.items()}
    return {
        "routed_total": fab.routed_total,
        "pending": fab.pending_counts(),
        "ring_stats": fab.ring_stats(),
        "ready": {s: arr(p) for s, p in sorted(fab._ready.items())},
        "ready_kinds": {s: arr(k) for s, k in sorted(fab._ready_kinds.items())},
        "ready_terms": {s: arr(k) for s, k in sorted(fab._ready_terms.items())},
        "staging_kinds": {s: arr(k) for s, k in sorted(fab._staging_kinds.items())},
        "staged_blocks": {s: {g: sorted(m) for g, m in gm.items()}
                          for s, gm in fab._staged_blocks.items()},
        "ready_blocks": blocks(fab._ready_blocks),
        "rings": {s: (arr(r.buf), r._ptr, r.staged_total, r.spills, r.oversize,
                      r.pin_skips, sorted(r._pinned),
                      {g: sorted((b, e.parent, e.inc, e.length, e.slot)
                                 for b, e in m.items()) for g, m in r._by_id.items()})
                  for s, r in sorted(fab.rings.items())},
    }


class RoutedTwin(Twin):
    """The twin cluster with a route fabric per side; the fabric's link
    filter drops routed rows across the twin's partition (``cut``) as the
    driver drops host messages."""

    def __init__(self, payload_ring=False, ring_slots=8, **kw):
        super().__init__(**kw)
        fk = dict(link_filter=self.link_ok, payload_ring=payload_ring,
                  ring_slots=ring_slots)
        self.jfab, self.tfab = JaxFabric(**fk), RouteFabric(**fk)
        for e in self.jx:
            self.jfab.register(e)
        for e in self.pt:
            self.tfab.register(e)

    def link_ok(self, src, dst):
        return src not in self.cut and dst not in self.cut

    def barrier(self):
        self.jfab.flush()
        self.tfab.flush()

    def compare(self, what):
        super().compare(what)
        assert [e.routed_msgs for e in self.pt] == [e.routed_msgs for e in self.jx], what
        assert [e._route_dirty for e in self.pt] == [e._route_dirty for e in self.jx], what
        assert fabric_view(self.tfab) == fabric_view(self.jfab), what
        for et, ej in zip(self.pt, self.jx):
            assert et.lease_summary() == ej.lease_summary(), what
            if et._lease_plane is not None or ej._lease_plane is not None:
                assert np.array_equal(np.asarray(et._lease_plane),
                                      np.asarray(ej._lease_plane)), what


async def _run_routed(window=1, mode="split", ticks=75, bursts=1, **kw):
    """The schedule of the JAX package's routed twin: cold-start elections,
    proposals to groups 0, 1 and 3 every fifth tick (``bursts`` payloads
    each, so spans carry several blocks), engine 2 cut off for ticks 15-29
    (routed traffic across the cut falls back to the host path, where the
    driver drops it; the heal is a mass catch-up), and group 3 recycled at
    tick 40 (under the pipelined driver a dispatch is in flight)."""
    twin = RoutedTwin(**kw)
    for t in range(ticks):
        twin.cut = {2} if 15 <= t < 30 else set()
        if t % 5 == 0 and t > 10:
            for g in (0, 1, 3):
                for k in range(bursts):
                    twin.propose(g, b"t%d-g%d-%d" % (t, g, k))
        if t == 40:
            for e in twin.jx + twin.pt:
                e.recycle_group(3)
                e.set_group_incarnation(3, 1)
            twin.compare("after recycle")
        twin.step(window, mode)
    for e in twin.jx + twin.pt:
        if e.pipeline_window:
            e.tick_drain()
    twin.compare("drained")
    assert any(f.applied for f in twin.tfsms[0].values()), "nothing committed"
    assert twin.tfab.routed_total > 0, "nothing routed"
    if twin.tfab.payload_ring:
        assert twin.tfab.ring_routed > 0, "no payload AE rode the ring"
    if kw.get("active_set"):
        assert sum(e.active_sched_ticks for e in twin.pt) > 0
    return twin


async def _run_ring_spill():
    """A 2-slot ring: 3-block spans never fit, so they spill to the host
    path (counted and journaled)."""
    twin = await _run_routed(payload_ring=True, ring_slots=2, bursts=3,
                             flight_ring_spill=True)
    assert twin.tfab.ring_stats()["spills"] > 0
    assert any(ev["kind"] == "ring_spill" for e in twin.pt for ev in e.flight.events())


async def _run_ring_capped():
    """AppendEntries capped at 2 blocks under the pipelined driver: capped
    catch-up frames route from the ring with the host decode's y/z rewrite
    and send-pointer fixup."""
    twin = await _run_routed(mode="pipelined", payload_ring=True, bursts=3,
                             max_append_entries=2)
    assert twin.tfab.ring_capped > 0, "no capped catch-up routed from the ring"


ROUTED = {
    "dense-split-window1": lambda: _run_routed(),
    "dense-pipelined-window1": lambda: _run_routed(mode="pipelined"),
    "dense-window8": lambda: _run_routed(8),
    "sparse-split-window1": lambda: _run_routed(sparse_io=True),
    "sparse-window8": lambda: _run_routed(8, sparse_io=True),
    "sparse-pipelined-window1": lambda: _run_routed(mode="pipelined", sparse_io=True),
    "active-split-window1": lambda: _run_routed(active_set=True),
    "active-sparse-pipelined-window1": lambda: _run_routed(
        mode="pipelined", sparse_io=True, active_set=True),
    "python-backend": lambda: _run_routed(port_backend="python", ticks=45),
    "ring-dense": lambda: _run_routed(payload_ring=True, bursts=3),
    "ring-spill-2-slots": _run_ring_spill,
    "ring-pipelined-capped": _run_ring_capped,
    "ring-sparse": lambda: _run_routed(payload_ring=True, bursts=3, sparse_io=True),
    "ring-window8": lambda: _run_routed(8, payload_ring=True, bursts=3),
    "ring-active": lambda: _run_routed(payload_ring=True, bursts=3, active_set=True),
    "ring-sparse-active-pipelined-capped": lambda: _run_routed(
        mode="pipelined", payload_ring=True, bursts=3, sparse_io=True, active_set=True,
        max_append_entries=2),
    "ring-python-backend": lambda: _run_routed(port_backend="python", ticks=45,
                                               payload_ring=True, bursts=2),
}
# One case per family in tier-1: routed delivery (the pipelined dense
# driver; the sparse, active-set driver), the python backend, the payload
# ring (with the capped catch-up), the ring on the python backend.
TIER1 = {"dense-pipelined-window1", "active-sparse-pipelined-window1", "python-backend",
         "ring-pipelined-capped", "ring-python-backend"}


@pytest.mark.parametrize("name", [
    n if n in TIER1 else pytest.param(n, marks=pytest.mark.slow) for n in ROUTED])
async def test_routed_twin_matches_jax_every_tick(name):
    await ROUTED[name]()


# ------------------------------- the port alone: routed == host-only


def _would_route(cluster, link_ok, m, ring_fab=None):
    """The delivery decision table applied to an already-decoded wire
    message of the host-only cluster: (routed entry count, host residual
    message or None). ``ring_fab`` is that cluster's shadow fabric (links
    closed, payload ring on): its rings stage the same mint/adopt history as
    the routed cluster's, so payload-AE routability is predicted from the
    host-only cluster alone."""
    if not isinstance(m, rpc.MsgBatch):
        return 0, m  # WireMsgs here are snapshots/pings — host-side kinds
    recv = cluster[m.dst]
    if not link_ok(m.src, m.dst) or recv._route_dirty:
        return 0, m
    k = m.kind_col
    base = np.isin(k, _ROUTED_ALWAYS)
    hb = np.asarray([not m.blocks.get(int(g)) for g in m.group])
    base |= (k == rpc.MSG_APPEND) & (m.x == m.y) & hb
    ring = ring_fab.rings.get(m.src) if ring_fab is not None else None
    if ring is not None and m.blocks:
        sender = cluster[m.src]
        for i in range(len(m.group)):
            g = int(m.group[i])
            if (int(k[i]) != rpc.MSG_APPEND or m.x[i] == m.y[i]
                    or not m.blocks.get(g)):
                continue
            x = int(m.x[i])
            if x < sender.chains[g].floor:
                continue
            # The routed cluster resolves from the device outbox claim
            # (x, sender head]; a capped wire y is the resolve's own rewrite.
            if ring.resolve(g, int(m.inc[i]), x, int(sender._h_head[g]),
                            sender.max_append_entries) is not None:
                base[i] = True
    base &= recv._h_ginc[m.group] == m.inc
    if recv._parole:
        par = np.fromiter(recv._parole, np.int64, len(recv._parole))
        base &= ~(np.isin(k, _PAROLE_DROP_ARR) & np.isin(m.group, par))
    if not base.any():
        return 0, m
    resid = m.take(~base)
    return int(base.sum()), (resid if len(resid) else None)


def _port_cluster(route, ring=False, groups=6, **kw):
    cl = [RaftEngine(MemKV(), IDS, IDS[i], groups=groups, fsms={0: ListFsm(), 3: ListFsm()},
                     params=step_params(timeout_min=3, timeout_max=8, hb_ticks=8, device="cpu"),
                     base_seed=i, device="cpu", **kw)
          for i in range(3)]
    fab = None
    if route or ring:
        # The host-only cluster of a ring run gets a shadow fabric: links
        # closed, so nothing routes, but its rings stage the same history.
        fab = RouteFabric(link_filter=None if route else (lambda s, d: False),
                          payload_ring=ring)
        for e in cl:
            fab.register(e)
    return cl, fab


@pytest.mark.parametrize("ring,kw", [
    (False, {}),
    (True, {}),
    pytest.param(True, dict(sparse_io=True, active_set=True), marks=pytest.mark.slow),
    pytest.param(False, dict(backend="python"), marks=pytest.mark.slow),
])
async def test_routed_cluster_equals_host_only(ring, kw):
    """Routed and host-decoded delivery give the same cluster: the routed
    cluster's state, mirrors and chains equal the host-only cluster's every
    tick, and its wire traffic is the host-only traffic less exactly the
    rows the decision table routes."""
    act, fab = _port_cluster(True, ring, **kw)
    ref, shadow = _port_cluster(False, ring, **kw)
    routed_ref = 0
    for t in range(60):
        cut = 15 <= t < 30
        link_ok = lambda s, d, cut=cut: not (cut and (s == 2 or d == 2))
        fab.link_filter = link_ok
        outs = [[], []]
        for ci, cl in enumerate((act, ref)):
            if t % 5 == 0 and t > 10:
                for g in (0, 3):
                    lead = next((e for e in cl if e.is_leader(g)), None)
                    for k in range(3 if ring else 1):
                        if lead is not None:
                            lead.propose(g, b"t%d-g%d-%d" % (t, g, k)).add_done_callback(
                                _retrieve)
            if t == 40:
                for e in cl:
                    e.recycle_group(2)
                    e.set_group_incarnation(2, 1)
            for e in cl:
                outs[ci].extend(e.tick().outbound)
        for ci, cl in enumerate((act, ref)):
            for m in outs[ci]:
                if not (cut and (m.dst == 2 or m.src == 2)):
                    cl[m.dst].receive(m)
        fab.flush()
        if shadow is not None:
            shadow.flush()
        resid = []
        for m in outs[1]:
            n, r = _would_route(ref, link_ok, m, ring_fab=shadow)
            routed_ref += n
            if r is not None:
                resid.append(r)
        assert [m.encode() for m in outs[0]] == [m.encode() for m in resid], f"tick {t}"
        for ea, er in zip(act, ref):
            for k, a in h_mirrors(ea).items():
                np.testing.assert_array_equal(a, getattr(er, k), err_msg=f"tick {t} {k}")
            for a, b in zip(interop.state_to_numpy(ea.state), interop.state_to_numpy(er.state)):
                assert np.array_equal(a, b), f"tick {t}"
            assert [(c.head, c.committed) for c in ea.chains] == \
                   [(c.head, c.committed) for c in er.chains], f"tick {t}"
        await asyncio.sleep(0)
    assert fab.routed_total == routed_ref > 0
    if ring:
        assert fab.ring_routed > 0


def test_route_scatter_reads_the_step_output(monkeypatch):
    """The route scatter's source is the sender step's own outbox (the
    handle's ``ov``, on the device), and during the route only index
    vectors (and the capped rows' values) cross from the host: the outbox is
    never uploaded."""
    seen, uploads = [], []

    def spy_scatter(plane, src_ov, srows, gids, dst, me):
        seen.append(src_ov)
        return tps._route_scatter(plane, src_ov, srows, gids, dst, me)

    def spy_host_to(a, device):
        uploads.append(np.asarray(a).shape)
        return torch.from_numpy(np.ascontiguousarray(a))

    monkeypatch.setattr(troute, "_route_scatter", spy_scatter)
    monkeypatch.setattr(troute, "host_to", spy_host_to)
    for kw in ({}, dict(sparse_io=True), dict(active_set=True)):
        cl, fab = _port_cluster(True, **kw)
        outputs = []
        for e in cl:
            inner = e.tick_finish

            def finish(h, inner=inner):
                outputs.append(h["ov"])
                return inner(h)
            e.tick_finish = finish
        for _ in range(20):
            seen.clear()
            outputs.clear()
            uploads.clear()
            outs = []
            for e in cl:
                outs.extend(e.tick().outbound)
            ptrs = {o.untyped_storage().data_ptr() for o in outputs if o is not None}
            assert all(s.untyped_storage().data_ptr() in ptrs for s in seen), kw
            assert all(len(shape) == 1 for shape in uploads), (kw, uploads)
            for m in outs:
                cl[m.dst].receive(m)
            fab.flush()
        assert fab.routed_total > 0, kw


# ------------------------------------------- inbox builders: occupancy


def _builder_pair(sparse):
    kw = dict(groups=8, sparse_io=sparse)
    return (JaxEngine(JaxKV(), [0, 1, 2], 0, params=jax_step_params(
                timeout_min=3, timeout_max=8, hb_ticks=8), **kw),
            RaftEngine(MemKV(), [0, 1, 2], 0, params=step_params(
                timeout_min=3, timeout_max=8, hb_ticks=8, device="cpu"), device="cpu", **kw))


def _msgs(mod, spec):
    return [mod.WireMsg(kind=k, group=g, src=s, dst=0, term=term, x=0)
            for g, s, k, term in spec]


def _batch(mod, src, groups, kinds, blocks=None, x=None, y=None):
    n = len(groups)
    return mod.MsgBatch(
        src, 0, np.asarray(groups, np.intp), np.asarray(kinds, np.int32),
        np.full(n, 5, np.int64),
        np.zeros(n, np.int64) if x is None else np.asarray(x, np.int64),
        np.zeros(n, np.int64) if y is None else np.asarray(y, np.int64),
        np.zeros(n, np.int64), np.zeros(n, np.int32), blocks=blocks or {},
        inc=np.zeros(n, np.int64))


def _build(e, sparse):
    if sparse:
        idx, plane, staged, deferred, deferred_b = e._build_inbox_sparse()
        return idx, plane, staged, deferred, deferred_b
    plane, staged, deferred, deferred_b = e._build_inbox()
    return None, plane, staged, deferred, deferred_b


def _same_build(a, b):
    """Both builders' outputs: packed rows, staged blocks (id, parent,
    data), deferred messages and batches (encoded)."""
    ja, ta = a, b
    assert np.array_equal(np.asarray(ta[1]), np.asarray(ja[1]))
    if ja[0] is not None:
        assert np.array_equal(np.asarray(ta[0]), np.asarray(ja[0]))
    key = lambda st: {g: [(x.id, x.parent, x.data) for x in v] for g, v in st.items()}
    assert key(ta[2]) == key(ja[2])
    assert [m.encode() for m in ta[3]] == [m.encode() for m in ja[3]]
    assert [m.encode() for m in ta[4]] == [m.encode() for m in ja[4]]


@pytest.mark.parametrize("sparse", [False, True])
def test_builders_slot_rules_match_jax(sparse):
    """The slot rules the router must never invert, on the dense and the
    compact builder, equal to the JAX builders: two messages for one
    (group, src) slot keep the first and carry the second; a batch entry
    colliding with a claimed slot defers alone (the batch splits); a
    routed claim defers every colliding host claim, an APPEND with blocks
    included (blocks kept for the next tick), and the free entries pack."""
    jb1 = JaxBlock(id=pack_id(5, 1), parent=GENESIS, data=b"x")
    tb1 = Block(id=pack_id(5, 1), parent=GENESIS, data=b"x")
    occ = np.zeros((8, 3), np.int8)
    occ[3, 1] = rpc.MSG_APPEND_RESP  # a routed claim on (g=3, src=1)
    cases = [
        (None, lambda m: ([], _msgs(m, [(3, 1, m.MSG_VOTE_REQ, 5), (3, 1, m.MSG_VOTE_REQ, 9)]))),
        (None, lambda m: ([_batch(m, 1, [2, 4], [m.MSG_VOTE_RESP] * 2),
                           _batch(m, 1, [4, 6], [m.MSG_APPEND_RESP] * 2)], [])),
        (occ, lambda m: ([_batch(m, 1, [3], [m.MSG_APPEND],
                                 blocks={3: [jb1 if m is jrpc else tb1]},
                                 x=[GENESIS], y=[tb1.id]),
                          _batch(m, 1, [5], [m.MSG_VOTE_RESP])],
                         _msgs(m, [(3, 1, m.MSG_VOTE_REQ, 5)]))),
    ]
    for occupancy, make in cases:
        je, te = _builder_pair(sparse)
        for e, mod in ((je, jrpc), (te, rpc)):
            e._pending_batches, e._pending_msgs = make(mod)
            e._routed_kinds = occupancy
        got, want = _build(te, sparse), _build(je, sparse)
        _same_build(want, got)
        if occupancy is not None:
            assert not got[2] and len(got[3]) == 1 and got[4][0].blocks[3] == [tb1]


# ------------------------------------------------------------ router units


def _cluster(groups, **kw):
    fab = RouteFabric(**{k: kw.pop(k) for k in ("payload_ring", "ring_slots") if k in kw})
    engines = [RaftEngine(MemKV(), IDS, IDS[i], groups=groups,
                          params=step_params(timeout_min=3, timeout_max=8, hb_ticks=8,
                                             device="cpu"),
                          base_seed=i, device="cpu", **kw) for i in range(3)]
    for e in engines:
        fab.register(e)
    return engines, fab


def _round(engines, fab):
    outs = []
    for e in engines:
        outs.extend(e.tick().outbound)
    for m in outs:
        engines[m.dst].receive(m)
    fab.flush()
    return outs


async def test_payload_stays_host_side_without_the_ring():
    """The decision table's payload axis: with the ring off, AppendEntries
    carrying blocks ride the host path while the payload-free majority
    routes."""
    engines, fab = _cluster(2, fsms={0: ListFsm()})
    for _ in range(45):
        _round(engines, fab)
    lead = next(e for e in engines if e.is_leader(0))
    lead.propose(0, b"payload").add_done_callback(_retrieve)
    saw_blocks = 0
    for _ in range(6):
        outs = _round(engines, fab)
        saw_blocks += sum(1 for m in outs if isinstance(m, rpc.MsgBatch) and m.blocks)
        await asyncio.sleep(0)
    assert saw_blocks > 0 and fab.routed_total > 0


def test_incarnation_mismatch_not_routed():
    """A row whose incarnation differs between sender and receiver is not
    routed: it rides the host path, where the receiver's intake drops it."""
    engines, fab = _cluster(3)
    for _ in range(45):
        _round(engines, fab)
    engines[2].set_group_incarnation(1, 7)
    before = fab.routed_total
    for _ in range(20):
        _round(engines, fab)
    assert fab.routed_total > before
    km = fab._ready_kinds.get(2)
    assert km is None or not km[1].any()


def test_recycle_purges_routed_plane():
    """Group recycle drops the group's staged and ready routed slots, in
    the kind mirror and in the plane."""
    engines, fab = _cluster(4)
    for _ in range(45):
        _round(engines, fab)
    for _ in range(12):  # stage rounds without a flush until rows are pending
        for e in engines:
            e.tick()
        if any(km.any() for km in fab._staging_kinds.values()):
            break
    target = next(s for s, km in fab._staging_kinds.items() if km.any())
    g = int(np.nonzero(fab._staging_kinds[target].any(axis=1))[0][0])
    assert np.asarray(fab._staging[target])[:, g, :].any()
    if g > 0:
        engines[target].recycle_group(g)
    else:
        fab.purge_group(target, 0)  # group 0 never recycles
    assert not fab._staging_kinds[target][g].any()
    assert not fab._staging[target][:, g, :].any(), "the plane row must be zero"


def test_fabric_register_guards():
    """Shape, backend and device mismatches are refused; re-registering a
    slot drops its pending routed traffic (restart semantics)."""
    params = step_params(timeout_min=3, timeout_max=8, hb_ticks=8, device="cpu")
    mk = lambda slot, **kw: RaftEngine(MemKV(), [0, 1, 2], slot, params=params,
                                       device="cpu", **{"groups": 8, **kw})
    fab = RouteFabric()
    fab.register(mk(0))
    with pytest.raises(ValueError, match="shape"):
        fab.register(mk(1, groups=4))
    with pytest.raises(ValueError, match="shape"):
        fab.register(mk(1, backend="python"))
    meta = mk(1)
    meta._device = torch.device("meta")
    with pytest.raises(ValueError, match="shape"):
        fab.register(meta)
    fab.register(mk(1))
    fab._ready_kinds[1] = np.ones((8, 3), np.int8)
    fab.register(mk(1))
    assert 1 not in fab._ready_kinds, "restart must drop pending traffic"


async def test_ring_spill_event_config_gated():
    """A payload AE the ring cannot serve journals ring_spill only when the
    engine's flight_ring_spill is on; the spill counter counts either way."""
    for gated in (False, True):
        engines, fab = _cluster(2, fsms={0: ListFsm()}, payload_ring=True, ring_slots=2,
                                flight_ring_spill=gated)
        for _ in range(45):
            _round(engines, fab)
        lead = next(e for e in engines if e.is_leader(0))
        for k in range(5):  # a burst longer than the 2-slot ring
            lead.propose(0, b"spill-%d" % k).add_done_callback(_retrieve)
        for _ in range(6):
            _round(engines, fab)
            await asyncio.sleep(0)
        assert sum(r.spills for r in fab.rings.values()) > 0
        events = [ev for e in engines for ev in e.flight.events(kind="ring_spill")]
        assert bool(events) == gated
        if gated:
            assert events[0]["detail"]["span"] >= 1
