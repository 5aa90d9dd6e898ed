"""PyTorch port, the sharded programs (``josefine_tpu_torch/parallel``).

The JAX package's ``test_sharded`` and ``test_sharded_active`` run against
the port on meshes of CPU shards (``["cpu"] * 8``: several shards of one
device, as the JAX suites run on the conftest's 8 virtual devices): the
sharded cluster step equal to the unsharded one at every factorization of
8, the node-sharded ones in tier-1 here (torch compiles nothing, so the
compile time that keeps them ``slow`` in the JAX suite, and the XLA hang
that leaves out (1, 8, 8) there, do not apply), and the sharded engine's
twin against the unsharded engine, the bucket ladder, the plan layout and
the co-sharded member mask. The JAX suite's 1M-group pod-sim runs the JAX
package in a subprocess and is left out: the port's full-size pod-sim is
``josefine_tpu_torch.bench_podsim`` (``chip_smoke.py`` phase 11b).

Then against the JAX package itself, on the same numpy-seeded inputs,
integer for integer: the cluster step on an (8, 1) mesh for 40 ticks, the
host helpers (``shard_bucket``, ``ShardPlan``, ``split_shard_rows``) and
the engine programs (the shard-local active window, routed and not, the
decay-only tick, the route and ring scatters, the ring gather, the plane
purge and the lease-plane select).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from josefine_tpu.models import chained_raft as jcr
from josefine_tpu.models.types import step_params as jax_step_params
from josefine_tpu.parallel import sharded as jsh
from josefine_tpu_torch import interop
from josefine_tpu_torch.models import chained_raft as cr
from josefine_tpu_torch.parallel import sharded as sh
from torch_parity import (
    HOST,
    MSG_NAMES,
    STATE_NAMES,
    assert_leaves_equal,
    jax_view_template,
    np_leaves,
    random_case,
    random_inbox_leaves,
    random_params,
    repointed,
    to_jax,
    torch_params,
)

CPU8 = ["cpu"] * 8

_cases = [
    repointed("test_sharded", edits=[
        ("import jax\nimport jax.numpy as jnp\n",
         "import jax\nimport jax.numpy as jnp\nimport torch\n\nCPU8 = [\"cpu\"] * 8  # eight shards of the host\n"),
        ("    return jax.tree.map(np.asarray, tree)\n",
         "    return type(tree).from_leaves([np.asarray(a) for a in tree.leaves()])\n"),
        ("    la = jax.tree.leaves(a)\n    lb = jax.tree.leaves(b)\n",
         "    la = a.leaves()\n    lb = b.leaves()\n"),
        ("        pytest.param(4, 2, 4, marks=pytest.mark.slow),  # groups split 2-way\n"
         "        pytest.param(2, 4, 4, marks=pytest.mark.slow),  # one node per chip\n",
         "        (4, 2, 4),  # groups split 2-way\n"
         "        (2, 4, 4),  # one node per chip\n"),
        ("        # node shardings above.\n    ],\n",
         "        # node shardings above. The port runs it.\n        (1, 8, 8),\n    ],\n"),
        ("jax.device_put(\n                proposals, NamedSharding(mesh, PS(\"p\", \"n\")))",
         "place(proposals, mesh)"),
        ("proposals = jnp.ones((P, N), jnp.int32) * 3",
         "proposals = torch.ones((P, N), dtype=torch.int32) * 3"),
    ], everywhere=[
        ("from josefine_tpu_torch.models.types import LEADER, step_params\n",
         "from josefine_tpu_torch.models.types import LEADER\n"
         "from torch_parity import host_step_params as step_params\n"),
        ("params=params)", 'params=params, device="cpu")'),
        ("cr.empty_inbox(P, N)", 'cr.empty_inbox(P, N, device="cpu")'),
        ("jnp.zeros((P, N), jnp.int32)", "torch.zeros((P, N), dtype=torch.int32)"),
        ("jax.jit(cr.cluster_step_impl)", "cr.cluster_step"),
        ("make_mesh(p_shards, n_shards)", "make_mesh(p_shards, n_shards, devices=CPU8)"),
        ('jax.device_put(member, NamedSharding(mesh, PS("p", None)))',
         'place(member, mesh, ("p", None))'),
        ('jax.device_put(proposals, NamedSharding(mesh, PS("p", "n")))',
         "place(proposals, mesh)"),
    ], leave_out={
        "test_podsim_1m_partitions_64dev":
            "runs the JAX package's pod-sim in a subprocess on 64 virtual XLA devices; "
            "the port's full-size pod-sim is josefine_tpu_torch.bench_podsim "
            "(chip_smoke.py phase 11b)",
    }),
    repointed("test_sharded_active", edits=[
        ("from jax.sharding import Mesh\n",
         "from josefine_tpu_torch.parallel.sharded import Mesh\n"),
        ("from josefine_tpu_torch.models.types import LEADER, step_params\n",
         "from josefine_tpu_torch.models.types import LEADER\n"
         "from torch_parity import host_step_params as step_params\n"),
        HOST["RaftEngine"],
        ("    for la, lr in zip(jax.tree.leaves(ea.state), jax.tree.leaves(er.state)):\n",
         "    for la, lr in zip(ea.state.leaves(), er.state.leaves()):\n"),
        ("            for la, lr in zip(jax.tree.leaves(e.state),\n"
         "                              jax.tree.leaves(ref.state)):\n",
         "            for la, lr in zip(e.state.leaves(), ref.state.leaves()):\n"),
        # The port's co-sharded member mask is one block per 'p' shard.
        ('        spec = getattr(arr.sharding, "spec", None)\n'
         '        return spec is not None and spec[0] == "p"\n',
         "        return isinstance(arr, sh.Shards) and len(arr.parts) == 8\n"),
    ], everywhere=[("devs = jax.devices()", 'devs = ["cpu"] * 8')]),
]
_names = [set(c) for c in _cases]
assert sum(map(len, _names)) == len(set().union(*_names)), "two suites share a case name"
for _c in _cases:
    globals().update(_c)


# ------------------------------------------------ against the JAX package


def test_cluster_step_matches_jax_on_an_8_by_1_mesh():
    """JAX ``make_sharded_cluster_step`` on an (8, 1) mesh of the conftest's
    virtual devices against the port's on an (8, 1) mesh of CPU shards:
    state, delivered inbox and metrics equal every tick for 40 ticks, with
    a proposal lane on."""
    P, N, ticks = 32, 3, 40
    jparams = jax_step_params(timeout_min=3, timeout_max=8, hb_ticks=1, auto_proposals=1)
    jstate, jmember = jcr.init_state(P, N, base_seed=5, params=jparams)
    jmesh = jsh.make_mesh(8, 1)
    jstep = jsh.make_sharded_cluster_step(jmesh, N)
    js, ji = jsh.place(jstate, jmesh), jsh.place(jcr.empty_inbox(P, N), jmesh)
    jm = jax.device_put(jmember, jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec("p", None)))
    jp = jsh.place(jnp.zeros((P, N), jnp.int32), jmesh)

    mesh = sh.make_mesh(8, 1, devices=CPU8)
    step = sh.make_sharded_cluster_step(mesh, N)
    params = torch_params(jparams)
    tstate, tmember = cr.init_state(P, N, base_seed=5, params=params, device="cpu")
    ts, ti = sh.place(tstate, mesh), sh.place(cr.empty_inbox(P, N, device="cpu"), mesh)
    tm = sh.place(tmember, mesh, ("p", None))
    tp = sh.place(torch.zeros((P, N), dtype=torch.int32), mesh)
    for t in range(ticks):
        js, ji, jmet = jstep(jparams, jm, js, ji, jp)
        ts, ti, tmet = step(params, tm, ts, ti, tp)
        assert_leaves_equal(interop.state_to_numpy(ts), np_leaves(js), STATE_NAMES, f"tick {t}")
        assert_leaves_equal([np.asarray(a) for a in ti.leaves()], np_leaves(ji), MSG_NAMES,
                            f"tick {t} inbox")
        for a, b in zip(tmet.leaves(), jax.tree.leaves(jmet)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), f"tick {t} metrics"
    roles = np.asarray(ts.role)
    assert ((roles == 2).sum(axis=1) == 1).all() and np.asarray(ts.commit.s).max() > 0


def test_host_helpers_match_jax():
    """``shard_bucket``, ``mesh_shards``, ``ShardPlan`` (layout,
    ``scatter_vals``, ``gather_flat``) and ``split_shard_rows`` (with and
    without the ring's cap) == the JAX package's on seeded inputs."""
    rng = np.random.default_rng(9)
    for n in list(range(0, 600, 7)) + [4096, 4097, 40000]:
        for L in (1, 6, 63, 64, 512, 4096, 131072):
            assert sh.shard_bucket(n, L) == jsh.shard_bucket(n, L), (n, L)
    jm = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("p", "x"))
    assert sh.mesh_shards(sh.Mesh(np.array(CPU8).reshape(4, 2), ("p", "x"))) == \
        jsh.mesh_shards(jm) == 4
    for trial in range(6):
        S = int(rng.choice([1, 2, 4, 8]))
        L = int(rng.choice([6, 64, 100]))
        P = S * L
        A = int(rng.integers(0, P + 1))
        G = np.sort(rng.choice(P, A, replace=False))
        tp, jp = sh.ShardPlan(G, P, S), jsh.ShardPlan(G, P, S)
        for name in ("k", "idx", "shard", "pos", "counts"):
            assert np.array_equal(getattr(tp, name), getattr(jp, name)), (trial, name)
        N = 3
        vals = rng.integers(-9, 9, (10, A, N)).astype(np.int32)
        assert np.array_equal(tp.scatter_vals(vals), jp.scatter_vals(vals)), trial
        flat = rng.integers(-9, 9, (S, 13 * tp.k + 9 * tp.k * N + 1)).astype(np.int32)
        flat[:, -1] = A
        for a, b in zip(tp.gather_flat(flat, N), jp.gather_flat(flat, N)):
            assert np.array_equal(a, b), trial
        gids = rng.choice(P, int(rng.integers(0, P + 1)), replace=False)
        for cap in (None, L * 4):
            for a, b in zip(sh.split_shard_rows(gids, S, L, cap),
                            jsh.split_shard_rows(gids, S, L, cap)):
                assert np.array_equal(a, b), (trial, cap)


def _engine_case(rng, S, L, N):
    """One node's random engine-layout state, member mask, step params and
    keepalive flags, on both sides: JAX arrays, and the port's blocks on a
    mesh of S CPU shards."""
    P = S * L
    me = int(rng.integers(0, N))
    params = random_params(rng)
    view, _, member, pf = random_case(rng, P, N, me)
    pf = rng.integers(0, 2, N).astype(np.int32) if pf is None else pf
    mesh = sh.Mesh(np.array(["cpu"] * S), ("p",))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:S]), ("p",))
    port = dict(
        params=[torch_params(params)] * S, me=[torch.tensor([me])] * S, pf=[torch.from_numpy(pf)] * S,
        state=sh.place_engine_state(interop.state_from_numpy(view, device="cpu"), mesh),
        member=sh.Shards.split(member, sh.shard_devices(mesh)))
    # The JAX programs donate their state: each call takes a fresh copy.
    jax_side = dict(params=params, me=jnp.asarray(me, jnp.int32), pf=jnp.asarray(pf),
                    state=lambda: jsh.place_engine_state(
                        to_jax(jax_view_template(P, N, me), view), jmesh),
                    member=jnp.asarray(member))
    return mesh, jmesh, port, jax_side


@pytest.mark.parametrize("ticks", [1, 4])
def test_engine_programs_match_jax(ticks):
    """The shard-local active window (with and without a routed plane) and
    the decay-only tick on an 8-shard mesh == the JAX shard_map programs on
    the same rows: the new state and every shard's flat output (13-row
    mirror, outbox and the psum lane), byte for byte."""
    rng = np.random.default_rng(20 + ticks)
    S, L, N = 8, 12, 3
    mesh, jmesh, port, jx = _engine_case(rng, S, L, N)
    P = S * L
    G = np.sort(rng.choice(P, 37, replace=False))
    plan = sh.ShardPlan(G, P, S)
    vals = np.zeros((10, len(G), N), np.int32)
    vals[:9] = np.stack([a[:len(G), 0] for a in random_inbox_leaves(rng, len(G), N)])
    vals[9, :, 0] = rng.integers(0, 3, len(G))
    vals_sh = plan.scatter_vals(vals)
    plane = np.stack([a[:, 0] for a in random_inbox_leaves(rng, P, N)]).astype(np.int32)
    plane = np.where(rng.random((1, P, N)) < 0.4, plane, 0).astype(np.int32)
    for routed in (False, True):
        jfn = jsh.make_sharded_active_window(jmesh, plan.k, ticks, N, routed)
        jargs = (jx["params"], jx["member"], jx["me"],
                 jx["state"](), jnp.asarray(vals_sh), jx["pf"],
                 jnp.asarray(plan.idx))
        jst, jflat = jfn(*jargs, jnp.asarray(plane)) if routed else jfn(*jargs)
        tfn = sh.make_sharded_active_window(mesh, plan.k, ticks, N, routed)
        tst, tflats = tfn(port["params"], port["member"], port["me"], port["state"],
                          [torch.from_numpy(vals_sh[s]) for s in range(S)], port["pf"],
                          [torch.from_numpy(plan.idx[s].astype(np.int64)) for s in range(S)],
                          sh.Shards.split(plane, sh.shard_devices(mesh), axis=1)
                          if routed else None)
        what = f"ticks={ticks} routed={routed}"
        assert_leaves_equal(interop.state_to_numpy(tst), np_leaves(jst), STATE_NAMES, what)
        got = np.stack([f.numpy() for f in tflats])
        assert got.tobytes() == np.asarray(jflat).tobytes(), what
        assert (got[:, -1] == len(G)).all(), "the psum lane counts the whole schedule"
    jdec = jsh.make_sharded_decay_only(jmesh, ticks)(
        jx["params"], jx["state"](), jx["pf"])
    tdec = sh.make_sharded_decay_only(mesh, ticks)(port["params"], port["state"], port["pf"])
    assert_leaves_equal(interop.state_to_numpy(tdec), np_leaves(jdec), STATE_NAMES,
                        f"ticks={ticks} decay")


def test_plane_programs_match_jax_sharded():
    """The fabric's shard-local route scatter (fresh plane and in place),
    the plane purge, the ring's scatter and gather and the lease-plane
    select on a 4-shard mesh == the JAX programs on the same padded
    layouts (``split_shard_rows``); padding ids never reach a device."""
    rng = np.random.default_rng(31)
    S, L, N, SL, W = 4, 10, 3, 4, 5
    P = S * L
    mesh = sh.Mesh(np.array(["cpu"] * S), ("p",))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:S]), ("p",))
    devs = sh.shard_devices(mesh)
    for trial in range(3):
        gids = rng.choice(P, int(rng.integers(1, P)), replace=False)
        B, lids, shard, pos = sh.split_shard_rows(gids, S, L)
        vals = rng.integers(-9, 9, (9, len(gids))).astype(np.int32)
        vals_sh = np.zeros((S, 9, B), np.int32)
        vals_sh[shard, :, pos] = vals.T
        me = int(rng.integers(0, N))
        jplane = jsh.make_sharded_route_scatter(jmesh, B, P, N, True)(
            jnp.asarray(vals_sh), jnp.asarray(lids), jnp.asarray(me, jnp.int32))
        tplane = sh.make_sharded_route_scatter(mesh, B, P, N, True)(vals_sh, lids, me)
        assert np.array_equal(np.asarray(tplane), np.asarray(jplane)), trial
        vals2 = rng.integers(-9, 9, (S, 9, B)).astype(np.int32)
        jplane = jsh.make_sharded_route_scatter(jmesh, B, P, N, False)(
            jplane, jnp.asarray(vals2), jnp.asarray(lids), jnp.asarray((me + 1) % N, jnp.int32))
        sh.make_sharded_route_scatter(mesh, B, P, N, False)(tplane, vals2, lids, (me + 1) % N)
        assert np.array_equal(np.asarray(tplane), np.asarray(jplane)), trial
        g = int(rng.choice(gids))
        keep = rng.random(N) < 0.5
        jplane = jsh.purge_plane_row_masked(jplane, jnp.asarray(g, jnp.int32),
                                            jnp.asarray(keep))
        sh.purge_plane_row_masked(tplane, g, keep)
        assert np.array_equal(np.asarray(tplane), np.asarray(jplane)), trial

        buf = rng.integers(-9, 9, (P, SL, W)).astype(np.int32)
        pairs = rng.choice(P * SL, int(rng.integers(1, 30)), replace=False)
        rg, rs = pairs // SL, pairs % SL
        RB, lg, rshard, rpos = sh.split_shard_rows(rg, S, L, cap=L * SL)
        slots = np.zeros((S, RB), np.int32)
        slots[rshard, rpos] = rs
        words = np.zeros((S, RB, W), np.int32)
        words[rshard, rpos] = rng.integers(-2**31, 2**31 - 1, (len(rg), W))
        jbuf = jsh.make_sharded_ring_scatter(jmesh, RB)(
            jnp.asarray(buf),
            jnp.asarray(lg), jnp.asarray(slots), jnp.asarray(words))
        tbuf = sh.Shards.split(buf, devs)
        sh.make_sharded_ring_scatter(mesh, RB)(tbuf, lg, slots, words)
        assert np.array_equal(np.asarray(tbuf), np.asarray(jbuf)), trial
        jread = np.asarray(jsh.make_sharded_ring_gather(jmesh, RB)(
            jbuf, jnp.asarray(lg), jnp.asarray(slots)))
        tread = np.stack([t.numpy() for t in
                          sh.make_sharded_ring_gather(mesh, RB)(tbuf, lg, slots)])
        assert np.array_equal(tread[rshard, rpos], jread[rshard, rpos]), trial

        lease = rng.integers(-3, 100, (P, 3)).astype(np.int64)
        changed = rng.random(P) < 0.3
        new = rng.integers(-3, 100, (P, 3)).astype(np.int64)
        # The JAX package runs without 64-bit mode: its plane holds the same
        # values as int32.
        jlease = jsh.lease_plane_select(
            jsh.place_lease_plane(jmesh, lease.astype(np.int32)), jnp.asarray(changed),
            jnp.asarray(new.astype(np.int32)))
        tlease = sh.lease_plane_select(sh.place_lease_plane(mesh, lease), changed, new)
        assert np.array_equal(np.asarray(tlease), np.asarray(jlease)), trial


def test_mesh_and_blocks():
    """``make_mesh`` takes distinct cards by default and raises when there
    are too few; an explicit device list may repeat a device. ``Mesh`` is
    hashable and equal by value; ``describe_devices`` names a repeated
    device and a run of cards; ``Shards.set_row`` copies the owning block
    only and ``np.asarray`` assembles the global array."""
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="need 2 devices, have"):
            sh.make_mesh(2)
    m = sh.make_mesh(4, 2, devices=CPU8)
    assert m.shape == {"p": 4, "n": 2} and m == sh.make_mesh(4, 2, devices=CPU8)
    assert hash(m) == hash(sh.make_mesh(4, 2, devices=CPU8))
    assert m != sh.make_mesh(8, 1, devices=CPU8)
    assert sh.describe_devices(m.devices.flat) == "cpu x8"
    assert sh.describe_devices([torch.device("cuda", i) for i in range(8)]) == "cuda:0..7"
    assert sh.shard_devices(m) == [torch.device("cpu")] * 4
    a = np.arange(24, dtype=np.int32).reshape(12, 2)
    s = sh.Shards.split(a, [torch.device("cpu")] * 3)
    t = s.set_row(5, -1)
    assert t.parts[0] is s.parts[0] and t.parts[2] is s.parts[2]
    want = a.copy()
    want[5] = -1
    assert np.array_equal(np.asarray(t), want) and np.array_equal(np.asarray(s), a)
    assert s.rows == 4


async def test_sparse_mesh_cluster_equals_unsharded():
    """Sparse IO on an 8-shard mesh of the host against the unsharded
    port engine, 3 engines, 40 ticks: each shard compacts its own changed
    rows, the join puts them back in group order, and a tick whose changed
    rows overflow the capacity (8, then grown) fetches every shard's dense
    outputs. State, mirrors, chains and wire bytes equal every tick."""
    import asyncio

    from josefine_tpu_torch.models.types import step_params
    from josefine_tpu_torch.raft.engine import RaftEngine
    from josefine_tpu_torch.utils.kv import MemKV

    def cluster(mesh):
        cl = [RaftEngine(MemKV(), [1, 2, 3], i + 1, groups=48, base_seed=i, sparse_io=True,
                         params=step_params(timeout_min=3, timeout_max=8, hb_ticks=8,
                                            device="cpu"),
                         device="cpu", mesh=mesh) for i in range(3)]
        for e in cl:
            e._k_out = 8
        return cl

    meshed, ref = cluster(sh.make_mesh(8, devices=CPU8)), cluster(None)
    overflowed = False
    for t in range(40):
        outs = []
        for cl in (meshed, ref):
            if t % 4 == 0 and t > 10:
                for g in (0, 5, 47):
                    lead = next((e for e in cl if e.is_leader(g)), None)
                    if lead is not None:
                        lead.propose(g, b"t%d" % t)
            k0 = [e._k_out for e in cl]
            res = [e.tick() for e in cl]
            overflowed |= [e._k_out for e in cl] != k0
            outs.append([m for r in res for m in r.outbound])
            for m in outs[-1]:
                cl[m.dst].receive(m)
        assert [m.encode() for m in outs[0]] == [m.encode() for m in outs[1]], t
        for a, b in zip(meshed, ref):
            for x, y in zip(interop.state_to_numpy(a.state), interop.state_to_numpy(b.state)):
                assert np.array_equal(x, y), t
            for name in ("_h_term", "_h_voted", "_h_role", "_h_leader", "_h_head",
                         "_h_commit"):
                assert np.array_equal(getattr(a, name), getattr(b, name)), (t, name)
            assert [c.committed for c in a.chains] == [c.committed for c in b.chains], t
        await asyncio.sleep(0)
    assert overflowed and all(e._k_out > 8 for e in meshed)
